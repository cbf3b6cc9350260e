"""The fused Galerkin scores: a Hopper kernel and its plain twin.

Counterpart of ``realpdebench_tpu/ops/pallas/galerkin.py``. Galerkin
attention is ``Q · (LN(K)ᵀ · LN(V)) / N`` with per-head affine LayerNorms on
K and V; this module computes the scores ``LN(K)ᵀ · LN(V) / N`` per (batch,
head), in the q/k/v Dense's own token layout:

  k, v           [B, N, h·d]   (float32 or bfloat16)
  scales, biases [h, d]        (per-head LayerNorm affine)
  scores         [B, h, d, d]  float32

The LayerNorm runs over the d features of each (token, head) in float32,
with the population variance and ``eps`` inside the square root; the
products accumulate in float32 and the sum is scaled by 1/N, as the Pallas
kernel's ``o_ref = acc / n_total``. ``n_total`` replaces N as the divisor
on a token shard (sequence parallelism): the shards' scores, summed over
the mp group, are those of the whole token axis.

``galerkin_scores`` is one autograd function. Its forward is
``kernels.gk_scores`` (csrc/galerkin_scores.cu) on a CUDA tensor and the
plain twin on a CPU tensor. Its backward, on either device, recomputes the
scores in plain ops with the JAX ``custom_vjp`` backward's dtypes and
differentiates them (``galerkin.py:153-164``; the JAX package has no
backward kernel here): in bfloat16 the LayerNorm's mean and variance are
taken in float32 and rounded to bfloat16, the centring, the rsqrt and the
normalised rows stay in bfloat16, and the affine and the product run in
float32, because the float32 scale promotes them (``_ln_as_jax``). In
float32 the recompute is the twin itself. There is no fallback from one to
the other, and
the JAX package's opt-in switch ``REALPDEBENCH_GALERKIN`` is not carried
over: on the card the kernel always runs. Any N is taken: the Pallas
kernel's N % tile == 0 is a TPU constraint the CUDA kernel does not have.
"""

from __future__ import annotations

import torch

from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.fno_layer import _use_kernel


def _ln(x, scale, bias, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def galerkin_scores_plain(k, v, k_scale, k_bias, v_scale, v_bias, heads: int,
                          eps: float, n_total: int | None = None):
    """Plain twin, the semantics of JAX ``_scores_ref`` and
    ``galerkin_scores(..., force_ref=True)``, computed in float32 from
    inputs of either dtype; the sum divided by ``n_total`` (default: the
    tensor's N)."""
    B, N, F = k.shape
    split = lambda z: z.float().reshape(B, N, heads, F // heads)
    kn = _ln(split(k), k_scale.float(), k_bias.float(), eps)
    vn = _ln(split(v), v_scale.float(), v_bias.float(), eps)
    return torch.einsum("bnhd,bnhe->bhde", kn, vn) / (N if n_total is None else n_total)


def _ln_as_jax(x, scale, bias, eps: float):
    """JAX ``_ln`` (``ops/pallas/galerkin.py:30-33``) at its own rounding
    points for an input x of any float dtype and f32 affine parameters:
    mean and variance reduced in f32 and rounded to x's dtype, x − mean,
    rsqrt(var + eps) (eps rounded to x's dtype) and their product in x's
    dtype, then the f32 scale and bias."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True).to(x.dtype)
    var = xf.var(dim=-1, unbiased=False, keepdim=True).to(x.dtype)
    eps = torch.tensor(eps, dtype=x.dtype).item()
    return ((x - mean) * torch.rsqrt(var + eps)).float() * scale + bias


def galerkin_scores_as_jax(k, v, k_scale, k_bias, v_scale, v_bias, heads: int,
                           eps: float, n_total: int | None = None):
    """The scores as the JAX backward recomputes them (``_scores_bwd``'s
    ``fwd``): ``_ln_as_jax`` on k and v in their dtype, the product and
    1/``n_total`` (default: the tensor's N) in f32. Autograd through it runs
    the backward in the same dtypes as JAX's vjp. In f32 it is
    ``galerkin_scores_plain``."""
    B, N, F = k.shape
    split = lambda z: z.reshape(B, N, heads, F // heads)
    kn = _ln_as_jax(split(k), k_scale.float(), k_bias.float(), eps)
    vn = _ln_as_jax(split(v), v_scale.float(), v_bias.float(), eps)
    return torch.einsum("bnhd,bnhe->bhde", kn, vn) / (N if n_total is None else n_total)


class _GalerkinScores(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the twin (CPU); backward: autograd
    through ``galerkin_scores_as_jax``, recomputed."""

    @staticmethod
    def forward(ctx, k, v, k_scale, k_bias, v_scale, v_bias, heads, eps, n_total=None):
        ctx.heads, ctx.eps, ctx.n_total = heads, eps, n_total
        ctx.save_for_backward(k, v, k_scale, k_bias, v_scale, v_bias)
        if not _use_kernel(k):
            return galerkin_scores_plain(k, v, k_scale, k_bias, v_scale, v_bias,
                                         heads, eps, n_total)
        return kernels.gk_scores(k, v, *(t.float().contiguous() for t in (
            k_scale, k_bias, v_scale, v_bias)), heads=heads, eps=eps, n_total=n_total)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = galerkin_scores_as_jax(*leaves, ctx.heads, ctx.eps, ctx.n_total)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def galerkin_scores(k, v, k_scale, k_bias, v_scale, v_bias, heads: int,
                    eps: float = 1e-5, n_total: int | None = None):
    """LN(k)ᵀ·LN(v)/N per (batch, head); differentiable in k, v and the
    affine parameters.

    Args:
      k, v: [B, N, h·d], one dtype (float32 or bfloat16).
      k_scale, k_bias, v_scale, v_bias: [h, d] per-head LayerNorm affine.
      heads: the number of heads h.
      eps: the LayerNorm's epsilon.
      n_total: the divisor, at least N (default N). On a token shard the
        global token count: the shards' results then sum to the scores of
        the whole (``core/partitioning.py``).
    Returns: [B, h, d, d] float32.
    """
    if k.dim() != 3 or k.shape != v.shape or k.shape[-1] % heads:
        raise ValueError(f"galerkin scores: k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} with {heads} heads")
    if n_total is not None and n_total < k.shape[1]:
        raise ValueError(f"galerkin scores: n_total {n_total} < N {k.shape[1]}")
    return _GalerkinScores.apply(k.contiguous(), v.contiguous(), k_scale,
                                 k_bias, v_scale, v_bias, heads, eps, n_total)
