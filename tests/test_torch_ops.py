"""PyTorch port vs JAX package: activations and spectral ops (CPU, f32).

The same numpy inputs go through both packages. Tolerance: rtol 2e-4 with
atol 2e-4·max|ref| (the f32 bar of COVERAGE.md), unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.ops import spectral as jspec
from realpdebench_tpu.utils import misc as jmisc
from realpdebench_tpu_torch.ops import spectral as tspec
from realpdebench_tpu_torch.ops.activations import gelu, gelu_variant
from realpdebench_tpu_torch.utils import misc as tmisc


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_gelu_matches_jax(variant):
    x = np.random.default_rng(0).normal(scale=3.0, size=4096).astype(np.float32)
    ref = jax.nn.gelu(jnp.asarray(x), approximate=variant == "tanh")
    got = gelu(torch.from_numpy(x), variant)
    _close(got.numpy(), ref)


def test_gelu_variant_follows_env(monkeypatch):
    monkeypatch.delenv("REALPDEBENCH_GELU", raising=False)
    assert gelu_variant() == "exact"          # the JAX choice on CPU and GPU
    monkeypatch.setenv("REALPDEBENCH_GELU", "tanh")
    assert gelu_variant() == "tanh"
    x = torch.linspace(-4, 4, 101)
    torch.testing.assert_close(gelu(x), gelu(x, "tanh"), rtol=0, atol=0)
    monkeypatch.setenv("REALPDEBENCH_GELU", "bogus")   # warns, keeps default
    assert gelu_variant() == "exact"


@pytest.mark.parametrize("raw", [None, "1", " On ", "false", "", "ture",
                                 "MXU ", "vpu", "auto"])
def test_env_switches_match_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("RPDB_TEST_SWITCH", raising=False)
    else:
        monkeypatch.setenv("RPDB_TEST_SWITCH", raw)
    for default in (False, True):
        assert (tmisc.env_flag("RPDB_TEST_SWITCH", default)
                == jmisc.env_flag("RPDB_TEST_SWITCH", default))
    choices = ("mxu", "vpu")
    assert (tmisc.env_choice("RPDB_TEST_SWITCH", choices, "auto")
            == jmisc.env_choice("RPDB_TEST_SWITCH", choices, "auto"))


@pytest.mark.parametrize("dims", [
    (26, 70, 134, 4, 12, 16),   # the cylinder bench width
    (6, 10, 12, 2, 3, 7),       # m3 reaches the Nyquist mode of W=12
    (7, 9, 11, 2, 3, 5),        # odd sizes
])
def test_dft_factors_equal_jax(dims):
    for got, ref in zip(tspec._dft_factors(*dims), jspec._dft_factors(*dims)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_grid_features_match_jax():
    shape = (5, 7, 9)
    for got, ref in zip(tspec.grid_features(shape), jspec.grid_features(shape)):
        assert tuple(got.shape) == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-7)


@pytest.mark.parametrize("jax_fn", ["truncated_spectral_conv3d_dft",
                                    "truncated_spectral_conv3d_fft"])
def test_truncated_spectral_conv_matches_jax(jax_fn):
    r = np.random.default_rng(1)
    B, T, H, W, Ci, Co, m1, m2, m3 = 2, 8, 10, 12, 3, 5, 2, 3, 4
    x = r.normal(size=(B, T, H, W, Ci)).astype(np.float32)
    wr = r.normal(size=(4, m1, m2, m3, Ci, Co)).astype(np.float32)
    wi = r.normal(size=(4, m1, m2, m3, Ci, Co)).astype(np.float32)
    ref = getattr(jspec, jax_fn)(jnp.asarray(x), jnp.asarray(wr),
                                 jnp.asarray(wi))
    got = tspec.truncated_spectral_conv3d_dft(
        torch.from_numpy(x), torch.from_numpy(wr), torch.from_numpy(wi))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    _close(got.numpy(), ref)
