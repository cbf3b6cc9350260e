"""Unet3d — the video-diffusion-style 3-D U-Net, on the TA kernels.

Counterpart of ``realpdebench_tpu/models/unet.py``: init Conv k7 → temporal
attention (rotary q/k, T5-style relative position bias) → down path of
[2× ResnetBlock (GroupNorm + SiLU, time-conditioned scale/shift) + spatial
linear attention + temporal attention + (1,4,4)/(1,2,2) spatial-only
downsampling] → mid blocks with full spatial attention → symmetric up path
with skip concatenations → final block + 1×1 conv. The conditioning time
is always zero (reference ``unet.py:513``) but still flows through the time
MLP, whose biases make a constant scale/shift. The input is tiled along T
when out_time > in_time.

Layout: the public tensors are channels-last ``[B, T, H, W, C]``, as in the
JAX package. Inside, activations are PyTorch's default NCDHW
``[B, C, T, H, W]`` (contiguous), the layout ``F.conv3d``,
``F.conv_transpose3d`` and ``F.group_norm`` take without a conversion. The
temporal attention regroups them into per-site tokens ``[B, H·W, T, C]``
(``TemporalTokens``), the mid spatial attention into per-frame tokens
``[B, T, H·W, C]`` (``FrameTokens``).

Precision: ``compute_dtype`` (float32 or bfloat16) is the dtype of the
activations, convolutions, norms' outputs and attention I/O; parameters stay
float32 and are cast at use, as flax's ``dtype=`` does. The norms take their
statistics in float32; the time MLP runs in float32 and is cast after. The
temporal attention runs ``ops.temporal_attention`` (the TA kernels on a CUDA
tensor); ``forward(..., reference=True)`` runs its plain twin instead.

Parameters carry the names the JAX exporter writes
(``realpdebench_tpu/interop/torch_export.py::export_unet``), e.g.
``init_temporal_attn.fn.fn.fn.to_qkv``, ``downs.i.0..4``, ``ups.i.*``,
``final_conv.0/1``, ``time_rel_pos_bias.relative_attention_bias``, so
``load_state_dict(strict=True)`` takes an exported checkpoint as it is.

Memory: ``remat`` (on by default, as the JAX registry has it) runs every
ResnetBlock (15 at dim_mults 1/2/4: two a level down and up, two mid, the
final block) through ``torch.utils.checkpoint``, as the JAX package wraps
them in ``nn.remat``: the backward recomputes a block's activations from
its input instead of keeping them. The attention blocks and the
convolutions outside the blocks keep theirs (JAX's ``remat_attention``
false). The blocks hold no randomness, so the recompute changes no number.
On an H100 80GB HBM3 the f32 step at the cylinder's batch 12 peaks at 79.0
GB (max_memory_allocated, 10^9 bytes) without it and at 58.6 GB with it
(chip_smoke.py, unet_train_f32).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from realpdebench_tpu_torch.models.base import Model, lecun_normal_, mse
from realpdebench_tpu_torch.ops.activations import gelu
from realpdebench_tpu_torch.ops.temporal_attention import (
    temporal_attention_tokens,
    temporal_attention_tokens_plain,
)


def relative_position_bucket(rel_pos, num_buckets=32, max_distance=128):
    """T5 relative-position bucketing (reference unet.py:90-108), numpy."""
    ret = 0
    n = -rel_pos
    num_buckets //= 2
    ret += (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret


@lru_cache(maxsize=16)
def _bucket_onehot(n: int, num_buckets: int, max_distance: int,
                   device: torch.device) -> torch.Tensor:
    """[n·n, num_buckets] f32 one-hot of each (q, k) pair's bucket."""
    pos = np.arange(n)
    rel = pos[None, :] - pos[:, None]  # k - q
    buckets = relative_position_bucket(rel, num_buckets, max_distance).reshape(-1)
    onehot = np.eye(num_buckets, dtype=np.float32)[buckets]
    with torch.inference_mode(False):   # cached: autograd may use it later
        return torch.from_numpy(onehot).to(device)


class RelativePositionBias(nn.Module):
    """[h, n, n] f32 bias from a learned [num_buckets, h] table; the bucket
    table is a host-side constant. The lookup is a product with the one-hot
    bucket matrix (exact in f32), whose backward is a product too: an index
    lookup's backward adds into the table with atomics, in no fixed order."""

    def __init__(self, heads: int = 8, num_buckets: int = 32,
                 max_distance: int = 128):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, n: int) -> torch.Tensor:
        table = self.relative_attention_bias.weight
        onehot = _bucket_onehot(n, self.num_buckets, self.max_distance, table.device)
        return (onehot @ table).t().reshape(-1, n, n)


@lru_cache(maxsize=16)
def rotary_freqs(n: int, dim: int, device: torch.device,
                 theta: float = 10000.0) -> torch.Tensor:
    """[n, dim] f32 interleaved rotary angles (rotary_embedding_torch):
    each pair's frequency repeated twice."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2) / dim))
    f = np.repeat(np.einsum("i,j->ij", np.arange(n), inv), 2, axis=-1)
    with torch.inference_mode(False):   # cached: autograd may use it later
        return torch.from_numpy(f.astype(np.float32)).to(device)


def apply_rotary(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate the first freqs.shape[-1] features of x by pairs (x0, x1) →
    (x0 cos − x1 sin, x1 cos + x0 sin); the f32 angles promote x."""
    rot = freqs.shape[-1]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    rotated = torch.stack([-x_rot[..., 1::2], x_rot[..., 0::2]], dim=-1)
    out = x_rot * torch.cos(freqs) + rotated.reshape(x_rot.shape) * torch.sin(freqs)
    return torch.cat([out, x_pass.to(out.dtype)], dim=-1)


class ChannelLayerNorm(nn.Module):
    """Gamma-only LayerNorm over the channels of [B, C, ...] (reference
    unet.py:169-178): biased variance, eps 1e-5, statistics in f32, output
    in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(1, dim, 1, 1, 1))

    def forward(self, x):
        xf = x.float()
        var = xf.var(dim=1, unbiased=False, keepdim=True)
        mean = xf.mean(dim=1, keepdim=True)
        g = self.gamma.view(1, -1, *([1] * (x.dim() - 2)))
        return ((xf - mean) / torch.sqrt(var + self.eps) * g).to(x.dtype)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *args, **kwargs):
        return x + self.fn(x, *args, **kwargs)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.fn = fn

    def forward(self, x, *args, **kwargs):
        return self.fn(self.norm(x), *args, **kwargs)


class TemporalTokens(nn.Module):
    """[B, C, T, H, W] ↔ per-site tokens [B, H·W, T, C] around ``fn`` (the
    reference's EinopsToAndFrom('b c f h w', 'b (h w) f c'))."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *args, **kwargs):
        B, C, T, H, W = x.shape
        t = x.permute(0, 3, 4, 2, 1).reshape(B, H * W, T, C)
        out = self.fn(t, *args, **kwargs)
        return out.reshape(B, H, W, T, C).permute(0, 4, 3, 1, 2)


class FrameTokens(nn.Module):
    """[B, C, T, H, W] ↔ per-frame tokens [B, T, H·W, C] around ``fn``."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        B, C, T, H, W = x.shape
        out = self.fn(x.permute(0, 2, 3, 4, 1).reshape(B, T, H * W, C))
        return out.reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)


def _linear(m: nn.Linear, x, dt):
    b = None if m.bias is None else m.bias.to(dt)
    return F.linear(x.to(dt), m.weight.to(dt), b)


def _conv(m: nn.Module, x, dt):
    """``m`` (Conv2d 1×1 used on 5-D input, Conv3d or ConvTranspose3d)
    applied in ``dt``."""
    w = m.weight.to(dt)
    b = None if m.bias is None else m.bias.to(dt)
    if isinstance(m, nn.ConvTranspose3d):
        return F.conv_transpose3d(x.to(dt), w, b, m.stride, m.padding)
    if w.dim() == 4:                      # a 1×1 Conv2d over every frame
        return F.conv3d(x.to(dt), w[..., None], b)
    return F.conv3d(x.to(dt), w, b, m.stride, m.padding)


class TemporalAttention(nn.Module):
    """Attention over T per site on tokens [B, S, T, C], with rotary q/k and
    the relative-position bias (JAX ``TemporalAttention``, its kernel path:
    q scaled then rotated, q and k cast back to the compute dtype)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        hidden = heads * dim_head
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, t, pos_bias, reference: bool = False):
        B, S, T, _ = t.shape
        h, d, dt = self.heads, self.dim_head, self.dtype
        q, k, v = _linear(self.to_qkv, t, dt).chunk(3, dim=-1)
        freqs = rotary_freqs(T, min(32, d), t.device)[:, None, :]
        rope = lambda z: apply_rotary(z.reshape(B, S, T, h, d), freqs).reshape(
            B, S, T, h * d).to(dt)
        q, k = rope(q * d ** -0.5), rope(k)
        attend = (temporal_attention_tokens_plain if reference
                  else temporal_attention_tokens)
        out = attend(q, k, v, pos_bias, h)
        return _linear(self.to_out, out, dt)


class SpatialAttention(nn.Module):
    """Full softmax attention over the H·W tokens of each frame, on
    [B, T, N, C] (mid block; plain torch, as JAX leaves it to XLA)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        hidden = heads * dim_head
        self.to_qkv = nn.Linear(dim, hidden * 3, bias=False)
        self.to_out = nn.Linear(hidden, dim, bias=False)

    def forward(self, t):
        B, T, N, _ = t.shape
        h, d, dt = self.heads, self.dim_head, self.dtype
        split = lambda z: z.reshape(B, T, N, h, d).transpose(2, 3)
        q, k, v = map(split, _linear(self.to_qkv, t, dt).chunk(3, dim=-1))
        sim = torch.einsum("bthid,bthjd->bthij", q * d ** -0.5, k)
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        out = torch.einsum("bthij,bthjd->bthid", torch.softmax(sim, dim=-1), v)
        return _linear(self.to_out, out.transpose(2, 3).reshape(B, T, N, h * d), dt)


class SpatialLinearAttention(nn.Module):
    """Linear attention per frame (reference unet.py:236-261) on
    [B, C, T, H, W]: softmax(q over d) · [softmax(k over n) Kᵀ V], with
    1×1 convolutions in and out (``to_out`` has a bias)."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x):
        B, _, T, H, W = x.shape
        h, d, dt = self.heads, self.dim_head, self.dtype
        q, k, v = _conv(self.to_qkv, x, dt).view(B, 3, h, d, T, H * W).unbind(1)
        q = torch.softmax(q, dim=2) * d ** -0.5          # over d
        k = torch.softmax(k, dim=-1)                     # over n
        context = torch.einsum("bhdtn,bhetn->bhtde", k, v)
        out = torch.einsum("bhtde,bhdtn->bhetn", context, q)
        return _conv(self.to_out, out.reshape(B, h * d, T, H, W), dt)


class Block(nn.Module):
    """Conv k3 'SAME' → GroupNorm → optional (scale + 1)·x + shift → SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv3d(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, scale_shift=None):
        dt = self.dtype
        x = _conv(self.proj, x, dt)
        x = F.group_norm(x, self.norm.num_groups, self.norm.weight.to(dt),
                         self.norm.bias.to(dt), self.norm.eps)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return F.silu(x)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: int | None = None,
                 groups: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = (nn.Sequential(nn.SiLU(), nn.Linear(time_emb_dim, dim_out * 2))
                    if time_emb_dim is not None else None)
        self.block1 = Block(dim, dim_out, groups, dtype)
        self.block2 = Block(dim_out, dim_out, groups, dtype)
        self.res_conv = nn.Conv3d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, time_emb=None):
        scale_shift = None
        if self.mlp is not None:
            # the Dense stays f32 and is cast after, as in JAX
            h = self.mlp(time_emb).to(self.dtype)[:, :, None, None, None]
            scale_shift = h.chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        if isinstance(self.res_conv, nn.Conv3d):
            x = _conv(self.res_conv, x, self.dtype)
        return h + x.to(self.dtype)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    emb = torch.exp(torch.arange(half, device=t.device) * -emb)
    emb = t[:, None] * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_pos_emb(t, self.dim)


class GELU(nn.Module):
    """ops.activations.gelu (the JAX package's variant selection)."""

    def forward(self, x):
        return gelu(x)


def _temporal(dim, heads, dim_head, dtype):
    return Residual(PreNorm(dim, TemporalTokens(
        TemporalAttention(dim, heads, dim_head, dtype))))


class Unet3d(Model):
    """The U-Net at base width ``dim`` with ``len(dim_mults)`` levels.

    ``generator`` draws the initial weights (on the CPU, then moved to
    ``device``) from the JAX init's distributions; None uses PyTorch's
    global generator. ``remat`` rematerialises the ResnetBlocks in the
    backward (the module docstring).
    """

    def __init__(self, dim: int, out_channels: int,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 6,
                 attn_heads: int = 4, attn_dim_head: int = 32,
                 init_kernel_size: int = 7, resnet_groups: int = 8,
                 in_time: int = 10, out_time: int = 10,
                 compute_dtype: torch.dtype = torch.float32, remat: bool = True,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.in_time, self.out_time = in_time, out_time
        self.remat = remat
        self.compute_dtype = dt = compute_dtype
        heads, groups = attn_heads, resnet_groups
        self.time_rel_pos_bias = RelativePositionBias(heads=heads, max_distance=32)
        self.init_conv = nn.Conv3d(channels, dim, init_kernel_size,
                                   padding=init_kernel_size // 2)
        self.init_temporal_attn = _temporal(dim, heads, attn_dim_head, dt)
        time_dim = dim * 4
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), nn.Linear(dim, time_dim),
                                      GELU(), nn.Linear(time_dim, time_dim))

        dims = [dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        n = len(in_out)

        def spatial_linear(c):
            return Residual(PreNorm(c, SpatialLinearAttention(c, heads, dtype=dt)))

        self.downs = nn.ModuleList(nn.ModuleList([
            ResnetBlock(di, do, time_dim, groups, dt),
            ResnetBlock(do, do, time_dim, groups, dt),
            spatial_linear(do),
            _temporal(do, heads, attn_dim_head, dt),
            (nn.Conv3d(do, do, (1, 4, 4), (1, 2, 2), (0, 1, 1)) if ind < n - 1
             else nn.Identity()),
        ]) for ind, (di, do) in enumerate(in_out))

        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, groups, dt)
        self.mid_spatial_attn = Residual(PreNorm(mid, FrameTokens(
            SpatialAttention(mid, heads, dtype=dt))))
        self.mid_temporal_attn = _temporal(mid, heads, attn_dim_head, dt)
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, groups, dt)

        # the transposed conv's flax padding (2, 2) is torch padding 1
        self.ups = nn.ModuleList(nn.ModuleList([
            ResnetBlock(do * 2, di, time_dim, groups, dt),
            ResnetBlock(di, di, time_dim, groups, dt),
            spatial_linear(di),
            _temporal(di, heads, attn_dim_head, dt),
            (nn.ConvTranspose3d(di, di, (1, 4, 4), (1, 2, 2), (0, 1, 1))
             if ind < n - 1 else nn.Identity()),
        ]) for ind, (di, do) in enumerate(reversed(in_out)))

        self.final_conv = nn.Sequential(
            ResnetBlock(dim * 2, dim, None, groups, dt),
            nn.Conv3d(dim, out_channels, 1))
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator=None) -> None:
        """The JAX init's distributions: lecun-normal kernels (fan-in over the
        kernel window and the input channels; for the transposed conv, flax's
        (*K, O, I) kernel puts O on the fan-in axis), zero biases, unit norm
        scales, N(0, 1) bias table."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, ChannelLayerNorm):
                nn.init.ones_(m.gamma)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, generator=generator)

    def _resnet(self, block: ResnetBlock, h, t, reference: bool):
        """``block(h, t)``; with ``remat``, while autograd records and off
        the plain path, through a non-reentrant checkpoint (JAX
        ``nn.remat(ResnetBlock)``). No RNG state is kept: the block draws
        none."""
        if self.remat and not reference and torch.is_grad_enabled():
            return checkpoint(block, h, t, use_reentrant=False, preserve_rng_state=False)
        return block(h, t)

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """x [B, T_in, H, W, C] → [B, T_out, H, W, C_out] float32, or, given
        the target y, the scalar MSE. ``reference=True`` runs the temporal
        attention through its plain twin and keeps every activation: the
        check a kernel run is compared against."""
        dt = self.compute_dtype
        rb = lambda block, h, t=None: self._resnet(block, h, t, reference)
        if self.out_time > x.shape[1]:
            x = x.repeat(1, self.out_time // x.shape[1], 1, 1, 1)
        pos_bias = self.time_rel_pos_bias(self.out_time)
        h = _conv(self.init_conv, x.permute(0, 4, 1, 2, 3), dt)   # NCDHW
        h = self.init_temporal_attn(h, pos_bias, reference=reference)
        r = h
        t = self.time_mlp(torch.zeros(x.shape[0], device=x.device))

        skips = []
        for block1, block2, spatial, temporal, down in self.downs:
            h = rb(block2, rb(block1, h, t), t)
            h = spatial(h)
            h = temporal(h, pos_bias, reference=reference)
            skips.append(h)
            if not isinstance(down, nn.Identity):
                h = _conv(down, h, dt)

        h = rb(self.mid_block1, h, t)
        h = self.mid_spatial_attn(h)
        h = self.mid_temporal_attn(h, pos_bias, reference=reference)
        h = rb(self.mid_block2, h, t)

        for block1, block2, spatial, temporal, up in self.ups:
            h = torch.cat([h, skips.pop()], dim=1)
            h = rb(block2, rb(block1, h, t), t)
            h = spatial(h)
            h = temporal(h, pos_bias, reference=reference)
            if not isinstance(up, nn.Identity):
                h = _conv(up, h, dt)

        h = rb(self.final_conv[0], torch.cat([h, r], dim=1))
        pred = _conv(self.final_conv[1], h, dt).float().permute(0, 2, 3, 4, 1)
        return pred if y is None else mse(pred, y.float())
