"""Temporal attention over T per spatial site: two Hopper kernels and their
plain twin.

Counterpart of ``realpdebench_tpu/ops/pallas/temporal_attention.py``. The
video U-Net attends over the T axis independently at every spatial site,
in the qkv Dense's native token layout:

  q, k, v, o  [B, S, T, h·d]   (S = H·W sites; q pre-scaled and rotary)
  pos_bias    [h, T, T] f32    (relative-position bias)

  o = softmax(q·kᵀ + pos_bias)·v per (site, head), in f32, with the row
  maximum subtracted; o comes back in q's dtype.

``temporal_attention_tokens`` is one autograd function. On a CUDA tensor
its forward is ``kernels.ta_fwd`` and its backward ``kernels.ta_bwd``
(csrc/temporal_attention.cu; bf16: on the tensor cores, the variant
``kernels.ta_bwd_variant`` chooses), which recomputes the weights from q, k
and pos_bias, as the JAX ``custom_vjp`` does
(``temporal_attention.py:163-179``), and returns dq, dk, dv and d(pos_bias)
summed over all sites. On a CPU
tensor it is the plain twin, differentiated by autograd. There is no
fallback from one to the other. Any S is taken: the JAX kernel's
``S % 128 == 0`` is a TPU lane constraint the CUDA kernels do not have.
"""

from __future__ import annotations

import torch

from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.fno_layer import _use_kernel


def temporal_attention_tokens_plain(q, k, v, pos_bias, heads: int):
    """Plain twin, the semantics of JAX
    ``reference_temporal_attention_tokens`` (``temporal_attention.py:217``)."""
    B, S, T, F = q.shape
    h, d = heads, F // heads
    # f32 (float64 for a float64 reference copy)
    st = torch.promote_types(q.dtype, torch.float32)
    spl = lambda z: z.reshape(B, S, T, h, d).to(st)
    sim = torch.einsum("bsihd,bsjhd->bshij", spl(q), spl(k)) + pos_bias.to(st)
    sim = sim - sim.amax(dim=-1, keepdim=True).detach()
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bshij,bsjhd->bsihd", attn, spl(v))
    return out.reshape(B, S, T, F).to(q.dtype)


class _TemporalAttention(torch.autograd.Function):
    """TA forward kernel; backward = TA backward kernel (JAX ``_make_op``)."""

    @staticmethod
    def forward(ctx, q, k, v, pos_bias, heads):
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, pos_bias)
        return kernels.ta_fwd(q, k, v, pos_bias, heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_bias = ctx.saved_tensors
        dq, dk, dv, dpb = kernels.ta_bwd(q, k, v, pos_bias, do.contiguous(),
                                         ctx.heads)
        return dq, dk, dv, dpb, None


def temporal_attention_tokens(q, k, v, pos_bias, heads: int):
    """Softmax attention over T per site; differentiable in q, k, v and
    pos_bias.

    Args:
      q, k, v: [B, S, T, h·d], one dtype (float32 or bfloat16); q arrives
        pre-scaled and rotary-embedded.
      pos_bias: [h, T, T] relative-position bias (float32 on the kernels).
      heads: the number of heads h.
    Returns: [B, S, T, h·d] in q's dtype.
    """
    if q.dim() != 4 or q.shape[-1] % heads or any(
            t.shape != q.shape for t in (k, v)):
        raise ValueError(f"temporal attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} with {heads} "
                         "heads")
    if _use_kernel(q):
        return _TemporalAttention.apply(q.contiguous(), k.contiguous(),
                                        v.contiguous(), pos_bias.float().contiguous(),
                                        heads)
    return temporal_attention_tokens_plain(q, k, v, pos_bias, heads)
