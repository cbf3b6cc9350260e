"""PyTorch port vs JAX package: the filtered leaky ReLU (CPU, f32).

``ops/filtered_lrelu``'s ``upfirdn2d`` at the up/down/padding cases of the
JAX package's own ``tests/test_filtered_lrelu.py`` (a negative pad crops),
``filtered_lrelu_2d`` with a bias, ``lrelu_geometry`` (the same factors,
filters and padding) and ``filtered_lrelu_3d`` at the CNO geometries
16 → 8, 8 → 16 and 16 → 16, forward and gradients (input and bias), held
to rtol 2e-4 with atol 2e-4·max|ref|. Inputs from numpy with a seed; the
port's ops take channels-first tensors, JAX's channels-last.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.ops import filtered_lrelu as J
from realpdebench_tpu_torch.ops import filtered_lrelu as P


def _close(got, ref, rtol=2e-4, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()), err_msg=msg)


def _first(x):          # channels-last numpy → channels-first torch
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.mark.parametrize("up,down,padding", [
    (1, 1, (0, 0, 0, 0)), (2, 1, (3, 2, 3, 2)), (1, 2, (2, 2, 2, 2)),
    (2, 2, (5, 4, 5, 4)), (2, 1, (-1, 3, 2, -2))])
@pytest.mark.parametrize("flip", [False, True])
def test_upfirdn2d_matches_jax(up, down, padding, flip):
    x = np.random.default_rng(0).normal(size=(2, 12, 14, 3)).astype(np.float32)
    f = J.design_lowpass_filter(6, 0.35, 0.2, 2.0)
    ref = J.upfirdn2d(jnp.asarray(x), f, up=up, down=down, padding=padding, gain=up ** 2,
                      flip_filter=flip)
    got = P.upfirdn2d(_first(x), P.design_lowpass_filter(6, 0.35, 0.2, 2.0), up=up,
                      down=down, padding=padding, gain=up ** 2, flip_filter=flip)
    _close(_last(got), ref, msg=str((up, down, padding)))


def test_filtered_lrelu_2d_matches_jax():
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 8, 8, 4)).astype(np.float32)
    b = r.normal(size=(4,)).astype(np.float32)
    fu = fd = J.design_lowpass_filter(12, 0.4, 0.3, 4.0)
    ref = J.filtered_lrelu_2d(jnp.asarray(x), fu, fd, jnp.asarray(b), 2, 2, (11, 11, 11, 11))
    got = P.filtered_lrelu_2d(_first(x), fu, fd, torch.from_numpy(b), 2, 2, (11, 11, 11, 11))
    _close(_last(got), ref)


def _geometry(i, o):
    c = lambda s: s / 2.0001
    return dict(in_size=i, out_size=o, in_cutoff=c(i), out_cutoff=c(o),
                in_half_width=0.8 * i - c(i), out_half_width=0.8 * o - c(o))


@pytest.mark.parametrize("sizes", [(16, 8), (8, 16), (16, 16)], ids=str)
def test_lrelu_geometry_equals_jax(sizes):
    got = P.lrelu_geometry(*_geometry(*sizes).values())
    ref = J.lrelu_geometry(*_geometry(*sizes).values())
    assert got[0] == ref[0] and got[1] == ref[1] and got[4] == ref[4]
    for a, b in zip(got[2:4], ref[2:4]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sizes", [(16, 8), (8, 16), (16, 16)], ids=str)
def test_filtered_lrelu_3d_forward_and_gradients_match_jax(sizes):
    i, o = sizes
    r = np.random.default_rng(2)
    x = r.normal(size=(2, 3, i, i, 4)).astype(np.float32)
    b = r.normal(size=(4,)).astype(np.float32)
    g = r.normal(size=(2, 3, o, o, 4)).astype(np.float32)
    kw = _geometry(i, o)

    def jf(x, b):
        return jnp.sum(J.filtered_lrelu_3d(x, bias=b, **kw) * g)

    ref = J.filtered_lrelu_3d(jnp.asarray(x), bias=jnp.asarray(b), **kw)
    jdx, jdb = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = P.filtered_lrelu_3d(xt, bias=bt, **kw)
    assert out.shape == (2, 4, 3, o, o)
    (out * torch.from_numpy(np.moveaxis(g, -1, 1).copy())).sum().backward()
    _close(_last(out), ref, msg="forward")
    _close(_last(xt.grad), jdx, msg="dx")
    _close(bt.grad.numpy(), jdb, msg="dbias")
