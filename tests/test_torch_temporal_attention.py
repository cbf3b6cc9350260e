"""PyTorch port vs JAX package: temporal attention over T per site (CPU).

The port's plain twin ``temporal_attention_tokens_plain`` and its public
``temporal_attention_tokens`` (which runs the twin, differentiated by
autograd, on a CPU tensor) against the JAX Pallas kernel in interpret mode
and its pure-jnp oracle ``reference_temporal_attention_tokens``: the output
and all four gradients (q, k, v, pos_bias) at S = 256, and at S = 300 (not
a multiple of the TPU kernel's 128 sites) against the oracle. Inputs from a
seeded numpy generator; f32; tolerance rtol 2e-4 with atol 2e-4·max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.ops.pallas.temporal_attention import (
    reference_temporal_attention_tokens,
    temporal_attention_tokens as jax_ta,
)
from realpdebench_tpu_torch.ops.temporal_attention import (
    temporal_attention_tokens,
    temporal_attention_tokens_plain,
)

B, T, H_, D = 2, 5, 3, 8
F = H_ * D


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _inputs(S, seed):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.normal(size=(B, S, T, F)).astype(np.float32) for _ in range(4))
    pb = (0.3 * r.normal(size=(H_, T, T))).astype(np.float32)
    return q, k, v, pb, do


def _jax_vjp(fn, q, k, v, pb, do):
    out, vjp = jax.vjp(lambda *a: fn(*a), *map(jnp.asarray, (q, k, v, pb)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_vjp(fn, q, k, v, pb, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, pb)]
    out = fn(*leaves, H_)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("port", [temporal_attention_tokens_plain,
                                  temporal_attention_tokens], ids=["twin", "public"])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "reference"])
def test_matches_jax_at_256_sites(port, oracle):
    args = _inputs(256, seed=0)
    jfn = ((lambda *a: jax_ta(*a, H_, interpret=True)) if oracle == "pallas_interpret"
           else (lambda *a: reference_temporal_attention_tokens(*a, H_)))
    ref, ref_grads = _jax_vjp(jfn, *args)
    got, grads = _port_vjp(port, *args)
    _close(got, ref)
    for name, g, r in zip(("dq", "dk", "dv", "dpb"), grads, ref_grads):
        assert g.shape == r.shape, name
        _close(g, r)


def test_ragged_site_count_matches_reference():
    """S = 300: the port takes any S (the TPU kernel needs S % 128 == 0)."""
    args = _inputs(300, seed=1)
    ref, ref_grads = _jax_vjp(lambda *a: reference_temporal_attention_tokens(*a, H_),
                              *args)
    got, grads = _port_vjp(temporal_attention_tokens, *args)
    _close(got, ref)
    for g, r in zip(grads, ref_grads):
        _close(g, r)


def test_output_keeps_the_input_dtype_and_refuses_mismatched_shapes():
    q, k, v, pb, _ = (torch.from_numpy(a) for a in _inputs(7, seed=2))
    out = temporal_attention_tokens(q.bfloat16(), k.bfloat16(), v.bfloat16(), pb, H_)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    with pytest.raises(ValueError, match="heads"):
        temporal_attention_tokens(q, k[:, :3], v, pb, H_)
    with pytest.raises(ValueError, match="heads"):
        temporal_attention_tokens(q, k, v, pb, 5)
