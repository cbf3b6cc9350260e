"""PyTorch port vs JAX package: the level-1 3-D wavelet transform (CPU).

``realpdebench_tpu_torch.ops.wavelet`` against ``realpdebench_tpu.ops.
wavelet`` on the same seeded numpy inputs, for both banks the shipped WDNO
configs use (bior1.1 and bior1.3), at odd and even lengths on every axis:
the packed coefficients (subband order [aaa, aad, ..., ddd]) and the
inverse; the inverse of the forward gives the input back (perfect
reconstruction); the length helpers agree. Tolerance: both sides sum two
or six f32 products per axis in another order, 1e-6 of max|ref|; the
reconstruction 2e-5, as the JAX package's own test.
"""

import numpy as np
import pytest
import torch

from realpdebench_tpu.ops import wavelet as jw
from realpdebench_tpu_torch.ops import wavelet as tw

SHAPES = [(2, 8, 12, 10), (3, 7, 9, 11)]        # even, odd lengths


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while these small runs go: with the suite's
    workers on every core, a full pool of spinning threads slows them a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("name", ["bior1.1", "bior1.3"])
@pytest.mark.parametrize("shape", SHAPES, ids=["even", "odd"])
def test_forward_and_inverse_match_jax(name, shape):
    r = np.random.default_rng(sum(shape))
    x = r.normal(size=shape).astype(np.float32)
    coefs = tw.wavedec3_level1(torch.from_numpy(x), name)
    want = np.asarray(jw.wavedec3_level1(x, name))
    assert coefs.shape == (shape[0], 8, *(tw.coef_len(n, name) for n in shape[1:]))
    _close(coefs.numpy(), want)
    c = r.normal(size=want.shape).astype(np.float32)
    rec = tw.waverec3_level1(torch.from_numpy(c), name)
    assert rec.shape[1:] == tuple(tw.rec_len(n, name) for n in c.shape[2:])
    _close(rec.numpy(), jw.waverec3_level1(c, name))


@pytest.mark.parametrize("name", ["bior1.1", "bior1.3"])
@pytest.mark.parametrize("shape", SHAPES, ids=["even", "odd"])
def test_perfect_reconstruction(name, shape):
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    rec = tw.waverec3_level1(tw.wavedec3_level1(torch.from_numpy(x), name), name)
    n = shape[1:]
    np.testing.assert_allclose(rec[..., :n[0], :n[1], :n[2]].numpy(), x, atol=2e-5)


def test_banks_and_lengths_equal_jax():
    assert tw.WAVELETS == jw.WAVELETS and tw.SUBBAND_KEYS == jw.SUBBAND_KEYS
    for name in tw.WAVELETS:
        for n in range(1, 40):
            assert tw.coef_len(n, name) == jw.coef_len(n, name)
            assert tw.rec_len(n, name) == jw.rec_len(n, name)
