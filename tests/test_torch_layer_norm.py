"""The port's flax-semantics LayerNorm (``models/base.layer_norm``), one
autograd node (CPU).

1. The forward equals, bit for bit, the elementwise chain it replaces
   (float32 statistics, E[x²] − E[x]² clamped at 0, output in the compute
   dtype), in float32, bfloat16 and float64, rows with a clamped variance
   included.
2. The gradients of x, weight and bias against flax's ``nn.LayerNorm``
   (rtol 2e-4, atol 2e-4·max|ref|) and against autograd through the chain
   (the same bound; they differ by rounding only), a clamped row included.
3. What autograd keeps for the backward: the saved tensors of one
   Transolver block at the shipped width (256, 8 heads, 16 slices,
   mlp_ratio 4) on a 8×8×4 grid, counted through ``saved_tensors_hooks``
   in float32 values a token, stay under SAVED_PER_TOKEN, the line the
   one-node LayerNorm reached (5749; 7288 with the chain). 80 GB hold
   about 6500 a token at the shipped f32 batch 16 (2.62 M tokens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from realpdebench_tpu_torch.models import base
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.utils.misc import make_generator

SAVED_PER_TOKEN = 5800


def chain(m, x, dt):
    """The elementwise chain the one-node LayerNorm replaces."""
    xf = x.to(base.stats_dtype(dt))
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + m.eps) * m.weight + m.bias).to(dt)


def _inputs(dtype, seed=0, C=32):
    r = np.random.default_rng(seed)
    m = torch.nn.LayerNorm(C, eps=1e-5)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(1 + 0.3 * r.normal(size=C).astype(np.float32)))
        m.bias.copy_(torch.from_numpy(0.3 * r.normal(size=C).astype(np.float32)))
    x = r.normal(loc=2.0, size=(3, 5, C)).astype(np.float32)
    x[0, 0] = 1.5                               # a constant row: the variance clamps
    if dtype == torch.float64:
        m.double()
    return m, torch.from_numpy(x).to(dtype), r.normal(size=(3, 5, C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_forward_bit_equal_to_the_chain(dtype):
    m, x, _ = _inputs(dtype)
    got = base.layer_norm(m, x, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, chain(m, x, dtype))


def _close(got, ref, msg=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max(), err_msg=msg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gradients_match_flax_and_the_chain(dtype):
    m, x, g = _inputs(dtype)
    g = torch.from_numpy(g).to(dtype)
    grads = []
    for fn in (base.layer_norm, chain):
        m.zero_grad()
        xx = x.clone().requires_grad_()
        fn(m, xx, dtype).backward(g)
        grads.append([xx.grad.clone(), m.weight.grad.clone(), m.bias.grad.clone()])
    for a, b, name in zip(*grads, ("x", "weight", "bias")):
        _close(a, b, name)

    flax = nn.LayerNorm(epsilon=1e-5, dtype=jnp.float32)
    p = {"scale": jnp.asarray(m.weight.detach().float().numpy()),
         "bias": jnp.asarray(m.bias.detach().float().numpy())}
    _, vjp = jax.vjp(lambda pp, xx: flax.apply({"params": pp}, xx), p,
                     jnp.asarray(x.float().numpy()))
    jp, jx = vjp(jnp.asarray(g.float().numpy()))
    for a, ref, name in zip(grads[0], (jx, jp["scale"], jp["bias"]), ("x", "weight", "bias")):
        _close(a.float().numpy(), ref, name)


def test_bf16_gradient_follows_the_chain():
    m, x, g = _inputs(torch.bfloat16)
    g = torch.from_numpy(g).to(torch.bfloat16)
    out = []
    for fn in (base.layer_norm, chain):
        xx = x.clone().requires_grad_()
        fn(m, xx, torch.bfloat16).backward(g)
        out.append(xx.grad)
    assert out[0].dtype == torch.bfloat16
    assert ((out[0].float() - out[1].float()).norm() / out[1].float().norm()) < 1e-2


def saved_per_token(model, x, y) -> float:
    """float32 values a token that autograd keeps for the backward of
    ``model(x, y=y)``: the distinct storages of its saved tensors,
    parameters left out."""
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in params:
            seen[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x, y=y)
    return sum(seen.values()) / 4 / (x[..., 0].numel())


def test_transolver_block_saves_under_the_line():
    si = (4, 8, 8, 3)
    kw = dict(model_name="transolver", space_dim=3, n_layers=1, n_hidden=256, n_head=8,
              H=8, W=8, D=4, fun_dim=0, out_dim=3, ref=8, mlp_ratio=4, slice_num=16)
    m = build_model(shapes=(si, si), device="cpu", generator=make_generator(0), **kw)
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(2, *si, generator=g), torch.randn(2, *si, generator=g)
    got = saved_per_token(m, x, y)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("realpdebench_tpu_torch.models.transolver.layer_norm", chain)
        before = saved_per_token(m, x, y)
    assert got < SAVED_PER_TOKEN < before, (got, before)
    assert before - got >= 3 * 2 * 256       # two tensors of x's size in each of three
