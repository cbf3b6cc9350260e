"""The fused FNO tail + loss: two Hopper kernels, each beside its plain twin.

Counterpart of ``realpdebench_tpu/ops/pallas/fno_tail.py``. In training the
FNO3d's tail and loss, ``SSE = Σ (fc2(gelu(fc1(crop(s)))) − target)²``, run
as one autograd function:

  K3F  crop, fc1 (the last BatchNorm folded in), GELU, fc2, SSE
       (csrc/fno_tail.cu; on the tensor cores: bf16 as mma, f32 as tf32)
  K3B  the same forward recomputed, then ds, dk1, db1, dk2, db2
       (csrc/fno_tail.cu; on the tensor cores: bf16 as mma, f32 as tf32)

so the fc1 activation [positions, 128] and the prediction never exist in
device memory. ``s`` is the last layer's pre-BN output in the layers' layout
[B·Tp, Hp·(Wp/2), 2C]; the crop keeps t < T, h < H, w < W. The target is in
the natural layout [B, T, H, W, F] (F = c_out·mult, the fc2 width: FNO3d
un-interleaves its time-interleaved target into it). ``ds`` is exactly zero
outside the crop. On a CUDA tensor the wrappers launch the kernels, on a CPU
tensor they run the twins.
"""

from __future__ import annotations

import torch

from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.activations import gelu, gelu_grad
from realpdebench_tpu_torch.ops.fno_layer import _use_kernel


def _crop(s, dims, tail_dims):
    B, Tp, Hp, Wp, C = dims
    T, H, W = tail_dims
    return s.float().view(B, Tp, Hp, Wp, C)[:, :T, :H, :W]


def k3f_plain(s, target, k1, b1, k2, b2, *, dims, tail_dims, act: str):
    """Plain twin of K3F: the SSE (f32 scalar) of
    gelu(crop(s) @ k1 + b1) @ k2 + b2 against target. k1 [C, H1], b1 [H1],
    k2 [H1, F], b2 [F] f32."""
    o = gelu(_crop(s, dims, tail_dims) @ k1 + b1, act) @ k2 + b2
    return ((o - target.float()) ** 2).sum()


def k3b_plain(s, target, k1, b1, k2, b2, g, *, dims, tail_dims, act: str):
    """Plain twin of K3B: with g = dL/dSSE (a 0-d tensor), returns
    (ds like s, zero outside the crop; dk1, db1, dk2, db2 f32)."""
    z = _crop(s, dims, tail_dims)
    u1 = z @ k1 + b1
    h1 = gelu(u1, act)
    do = 2.0 * g * (h1 @ k2 + b2 - target.float())
    du = (do @ k2.t()) * gelu_grad(u1, act)
    B, Tp, Hp, Wp, C = dims
    T, H, W = tail_dims
    ds = torch.zeros((B, Tp, Hp, Wp, C), dtype=s.dtype, device=s.device)
    ds[:, :T, :H, :W] = (du @ k1.t()).to(s.dtype)
    rows = lambda t: t.reshape(-1, t.shape[-1])
    return (ds.view(s.shape), rows(z).t() @ rows(du), rows(du).sum(0),
            rows(h1).t() @ rows(do), rows(do).sum(0))


def k3f(s, target, k1, b1, k2, b2, *, dims, tail_dims, act: str, variant=None):
    """On the card, the variant ``kernels.k3f_variant`` chooses from dtype,
    width and alignment (or the one named)."""
    if _use_kernel(s):
        return kernels.k3f(s, target, k1, b1, k2, b2, dims=dims,
                           tail_dims=tail_dims, act=act, variant=variant)
    return k3f_plain(s, target, k1, b1, k2, b2, dims=dims,
                     tail_dims=tail_dims, act=act)


def k3b(s, target, k1, b1, k2, b2, g, *, dims, tail_dims, act: str,
        variant=None):
    """On the card, the variant ``kernels.k3b_variant`` chooses from dtype,
    width and alignment (or the one named)."""
    if _use_kernel(s):
        return kernels.k3b(s, target, k1, b1, k2, b2, g, dims=dims,
                           tail_dims=tail_dims, act=act, variant=variant)
    return k3b_plain(s, target, k1, b1, k2, b2, g, dims=dims,
                     tail_dims=tail_dims, act=act)


class _TailLoss(torch.autograd.Function):
    """SSE = K3F(s, target, weights); backward = K3B (JAX ``_make_tail``,
    ``ops/pallas/fno_tail.py:176-238``). The target gets no gradient."""

    @staticmethod
    def forward(ctx, s, target, k1, b1, k2, b2, dims, tail_dims, act):
        ctx.meta = dict(dims=dims, tail_dims=tail_dims, act=act)
        ctx.save_for_backward(s, target, k1, b1, k2, b2)
        return k3f(s, target, k1, b1, k2, b2, **ctx.meta)

    @staticmethod
    def backward(ctx, g):
        s, target, k1, b1, k2, b2 = ctx.saved_tensors
        ds, dk1, db1, dk2, db2 = k3b(s, target, k1, b1, k2, b2,
                                     g.float().contiguous(), **ctx.meta)
        return ds, None, dk1, db1, dk2, db2, None, None, None


def fused_tail_loss(s, target, k1, b1, k2, b2, *, dims, tail_dims, act: str):
    """Fused crop + fc1 + GELU + fc2 + SSE, differentiable in s and the
    four weights.

    Args:
      s: [B·Tp, Hp·(Wp/2), 2C] the last fused layer's pre-BN output (its
        BN affine folded into k1 and b1 already).
      target: [B, T, H, W, F] f32.
      k1 [C, H1], b1 [H1], k2 [H1, F], b2 [F]: f32 fc1 and fc2 as
        (in, out) matrices.
      dims: (B, Tp, Hp, Wp, C); tail_dims: (T, H, W), the crop.
      act: the GELU variant after fc1.
    Returns the f32 SSE over the crop; divide by target.numel() for the MSE.
    """
    B, Tp, Hp, Wp, C = dims
    T, H, W = tail_dims
    F = k2.shape[1]
    if (tuple(s.shape) != (B * Tp, Hp * (Wp // 2), 2 * C)
            or tuple(target.shape) != (B, T, H, W, F)):
        raise ValueError(f"fused tail: s {tuple(s.shape)} or target "
                         f"{tuple(target.shape)} do not fit dims {dims}, "
                         f"crop {tail_dims} and F={F}")
    return _TailLoss.apply(s, target, k1, b1, k2, b2, tuple(dims),
                           tuple(tail_dims), act)
