"""DPOT — the Denoising Pre-trained Operator Transformer and its wrapper.

Counterpart of ``realpdebench_tpu/models/dpot.py`` (the reference's
``model/dpot.py`` wrapper and ``dpot_libs/models/dpot.py`` backbone):

* ``fft_resize_2d`` / ``fft_resize_3d``: the spectral resize of a grid to
  the model's resolution and back: the real FFT's spectrum truncated or
  zero-padded (two-sided budgets on the full axes, one-sided on the
  half-spectrum axis) and scaled by the area (volume) ratio;
* ``AFNO2D``: the spectral mixer, a block-diagonal two-layer MLP on the
  kept modes' real and imaginary planes (``w1[0]``, ``b1[0]`` real,
  ``w1[1]``, ``b1[1]`` imaginary), with its internal residual;
* ``DPOTBlock``: GroupNorm(8) → AFNO2D → GroupNorm(8) → 1×1 MLP → skip;
* ``DPOTNet``: per-frame patch embedding of the channels plus three grid
  channels, a learned position embedding, the exp-MLP time aggregation
  over the input window, ``depth`` blocks, the classification head (its
  output is discarded by the wrapper, as in JAX), and the transposed-
  convolution output layer that emits every output frame at once;
* ``DPOT``: the wrapper: channels padded with ones to 4, the resize to
  ``img_size`` and back, and the sliding window when the data's output
  window exceeds the model's.

Layout: the blocks and the output layer run channels-last, their 1×1
convolutions and the stride-p transposed convolution as matrix products
(cuBLAS); the patch embedding is a stride-p Conv2d (cuDNN). The FFTs are
``torch.fft`` (cuFFT on the card). JAX's default route computes them as
dense DFT products, a TPU sharding concern; the functions are the same,
the inverse ones taken as that route defines them (``ops/spectral.irfftn``).

Precision: ``compute_dtype`` is the dtype of AFNO's mode products and of
the blocks' MLPs, as in JAX; the embedding, the time aggregation, the
GroupNorms (flax semantics: float32 statistics, E[x²] − E[x]² clamped at
0), the residual stream, the head and the output layer run in float32
(float64 in a float64 copy: ``.double()`` plus ``compute_dtype =
torch.float64``).

``remat`` (default false, as in the JAX registry) runs each block through
``torch.utils.checkpoint`` while autograd records, as JAX wraps them in
``nn.remat``; the numbers do not change.

Parameters carry the names of the JAX exporter
(``realpdebench_tpu/interop/torch_export.py::export_dpot``):
``dpot_model.{pos_embed, patch_embed.proj.{0,2}, time_agg_layer.{w,gamma},
blocks.i.{norm1, norm2, filter.{w1,b1,w2,b2}, mlp.{0,2}}, cls_head.{0,2,4},
out_layer.{0,2,4}}`` (plus ``scale_feats_{mu,sigma}`` with ``normalize``),
so ``load_state_dict(strict=True)`` takes an exported checkpoint as it is.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from realpdebench_tpu_torch.models.base import Model, lecun_normal_, linear, mse, stats_dtype
from realpdebench_tpu_torch.ops.activations import gelu
from realpdebench_tpu_torch.ops.spectral import irfftn

ACT = {
    "gelu": gelu,
    "tanh": torch.tanh,
    "relu": F.relu,
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.1),
}


def fft_resize_2d(x: torch.Tensor, out_size) -> torch.Tensor:
    """Spectral resize x [B, H, W, F] → [B, H', W', F] (reference
    ``utilities.resize``): the rfft2 spectrum truncated or zero-padded with
    separate top and bottom row budgets, scaled by the area ratio."""
    H, W = x.shape[1], x.shape[2]
    Ho, Wo = out_size
    f = torch.fft.rfft2(x.movedim(-1, 1))                       # [B, F, H, Wr]
    top1 = min((H + 1) // 2, (Ho + 1) // 2)
    top2 = min(f.shape[-1], Wo // 2 + 1)
    bot1 = min(H // 2, Ho // 2)
    z = f.new_zeros((*f.shape[:-2], Ho, Wo // 2 + 1))
    z[..., :top1, :top2] = f[..., :top1, :top2]
    if bot1:        # a degenerate axis has no negative frequencies
        z[..., -bot1:, :top2] = f[..., -bot1:, :top2]
    out = irfftn(z, (Ho, Wo), (-2, -1)) * (Ho / H) * (Wo / W)
    return out.movedim(1, -1)


def fft_resize_3d(x: torch.Tensor, out_size) -> torch.Tensor:
    """Spectral resize x [B, H, W, D, F] → [B, H', W', D', F]: the 3-D form
    of :func:`fft_resize_2d`, scaled by the volume ratio."""
    H, W, D = x.shape[1], x.shape[2], x.shape[3]
    Ho, Wo, Do = out_size
    f = torch.fft.rfftn(x.movedim(-1, 1), dim=(2, 3, 4))        # [B, F, H, W, Dr]
    h1, h2 = min((H + 1) // 2, (Ho + 1) // 2), min(H // 2, Ho // 2)
    w1, w2 = min((W + 1) // 2, (Wo + 1) // 2), min(W // 2, Wo // 2)
    d1 = min(f.shape[-1], Do // 2 + 1)
    z = f.new_zeros((*f.shape[:2], Ho, Wo, Do // 2 + 1))
    hs = [slice(None, h1)] + ([slice(-h2, None)] if h2 else [])
    ws = [slice(None, w1)] + ([slice(-w2, None)] if w2 else [])
    for sh in hs:
        for sw in ws:
            z[..., sh, sw, :d1] = f[..., sh, sw, :d1]
    out = irfftn(z, (Ho, Wo, Do), (2, 3, 4))
    out = out * (Ho / H) * (Wo / W) * (Do / D)
    return out.movedim(1, -1)


def group_norm(m: nn.GroupNorm, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """flax GroupNorm on channels-last x [B, *S, C]: float32 (at least)
    statistics over the spatial axes and each group's channels, the
    variance as E[x²] − E[x]² clamped at 0; output in ``out_dtype`` (None:
    the statistics' dtype)."""
    st = stats_dtype(x.dtype)
    xf = x.to(st)
    shape = xf.shape
    g = xf.reshape(shape[0], -1, m.num_groups, shape[-1] // m.num_groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g * g).mean(dim=(1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    scale = m.weight.to(st).view(m.num_groups, -1)
    mul = torch.rsqrt(var + m.eps) * scale
    y = ((g - mean) * mul + m.bias.to(st).view(m.num_groups, -1)).reshape(shape)
    return y if out_dtype is None else y.to(out_dtype)


def pointwise(conv: nn.Module, x: torch.Tensor, dt) -> torch.Tensor:
    """A 1×1 (×1) convolution on channels-last x, computed in ``dt`` (flax
    Conv with ``dtype=dt``): a matrix product over the channels."""
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return F.linear(x.to(dt), w.to(dt), conv.bias.to(dt))


def _uniform_(p: torch.Tensor, scale: float, generator=None) -> None:
    with torch.no_grad():
        p.copy_(scale * torch.rand(p.shape, generator=generator))


def _mix(xr, xi, w1, b1, w2, b2, act, dt, st):
    """AFNO's block-diagonal two-layer complex MLP on (real, imag) planes
    [..., nb, bs]: w[0], b[0] the real parts, w[1], b[1] the imaginary."""
    def mm(a, w):
        return torch.einsum("...bi,bio->...bo", a.to(dt), w.to(dt)).to(st)

    o1r = act(mm(xr, w1[0]) - mm(xi, w1[1]) + b1[0])
    o1i = act(mm(xi, w1[0]) + mm(xr, w1[1]) + b1[1])
    o2r = mm(o1r, w2[0]) - mm(o1i, w2[1]) + b2[0]
    o2i = mm(o1i, w2[0]) + mm(o1r, w2[1]) + b2[1]
    return o2r, o2i


class AFNO2D(nn.Module):
    """Adaptive Fourier mixer on x [B, H, W, C] (reference
    ``dpot_libs/models/dpot.py:22-110``), its residual included."""

    def __init__(self, width: int, num_blocks: int = 8, modes: int = 32,
                 hidden_size_factor: int = 1, act: str = "gelu"):
        super().__init__()
        self.num_blocks, self.modes, self.act = num_blocks, modes, act
        bs, hf = width // num_blocks, hidden_size_factor
        self.scale = 1.0 / (bs * bs * hf)
        self.w1 = nn.Parameter(torch.empty(2, num_blocks, bs, bs * hf))
        self.b1 = nn.Parameter(torch.empty(2, num_blocks, bs * hf))
        self.w2 = nn.Parameter(torch.empty(2, num_blocks, bs * hf, bs))
        self.b2 = nn.Parameter(torch.empty(2, num_blocks, bs))

    def reset_parameters(self, generator=None) -> None:
        for p in (self.w1, self.b1, self.w2, self.b2):
            _uniform_(p, self.scale, generator)

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        B, H, W, C = x.shape
        nb = self.num_blocks
        st = stats_dtype(x.dtype)
        xf = torch.fft.rfft2(x.to(st), dim=(1, 2), norm="ortho")
        Wr = xf.shape[2]
        k1, k2 = min(self.modes, H), min(self.modes, Wr)
        kept = xf[:, :k1, :k2].reshape(B, k1, k2, nb, C // nb)
        o2r, o2i = _mix(kept.real, kept.imag, self.w1, self.b1, self.w2, self.b2,
                        ACT[self.act], dt, st)
        out = xf.new_zeros((B, H, Wr, C))
        out[:, :k1, :k2] = torch.complex(o2r, o2i).reshape(B, k1, k2, C)
        return irfftn(out, (H, W), (1, 2), norm="ortho") + x


class DPOTBlock(nn.Module):
    """GroupNorm → AFNO2D → GroupNorm → 1×1 MLP → skip, on [B, H, W, C]."""

    def __init__(self, width: int, n_blocks: int, modes: int, mlp_ratio: float = 1.0,
                 act: str = "gelu"):
        super().__init__()
        hid = int(width * mlp_ratio)
        self.act = act
        self.norm1 = nn.GroupNorm(8, width, eps=1e-5)
        self.filter = AFNO2D(width, n_blocks, modes, act=act)
        self.norm2 = nn.GroupNorm(8, width, eps=1e-5)
        # the reference's Sequential(conv, act, conv): the activation's slot
        # has no parameters
        self.mlp = nn.Sequential(nn.Conv2d(width, hid, 1), nn.Identity(),
                                 nn.Conv2d(hid, width, 1))

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        h = self.filter(group_norm(self.norm1, x), dt)
        h = group_norm(self.norm2, h)
        h = ACT[self.act](pointwise(self.mlp[0], h, dt))
        return pointwise(self.mlp[2], h, dt).to(x.dtype) + x


class TimeAggregator(nn.Module):
    """The exp-MLP (or plain MLP) aggregation of the input window's T frames
    into one: Σ_t (h_t · cos(t·γ)) W_t."""

    def __init__(self, in_timesteps: int, embed_dim: int, time_agg: str):
        super().__init__()
        if time_agg not in ("exp_mlp", "mlp"):
            raise ValueError(f"time_agg {time_agg} not supported")
        self.in_timesteps, self.embed_dim = in_timesteps, embed_dim
        self.w = nn.Parameter(torch.empty(in_timesteps, embed_dim, embed_dim))
        if time_agg == "exp_mlp":
            self.gamma = nn.Parameter(torch.empty(1, embed_dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.w.copy_(torch.randn(self.w.shape, generator=generator)
                         / (self.in_timesteps * self.embed_dim ** 0.5))
            if hasattr(self, "gamma"):
                self.gamma.copy_(torch.from_numpy(
                    2.0 ** np.linspace(-10, 10, self.embed_dim, dtype=np.float32))[None])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h [..., T, E] → [..., E]."""
        T, E = h.shape[-2], h.shape[-1]
        if hasattr(self, "gamma"):
            t = _linspace(T, h)[:, None]
            h = h * torch.cos(t @ self.gamma.to(h.dtype))
        return h.reshape(*h.shape[:-2], T * E) @ self.w.to(h.dtype).reshape(T * E, E)


def _linspace(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.linspace(0, 1, n)).to(device=like.device, dtype=like.dtype)


class DPOTNet(nn.Module):
    """The 2-D backbone on x [B, X, Y, T, C] → ([B, X, Y, T_out, C_out],
    class logits [B, n_cls])."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_channels: int = 1,
                 out_channels: int = 4, in_timesteps: int = 1, out_timesteps: int = 1,
                 n_blocks: int = 4, embed_dim: int = 768, out_layer_dim: int = 32,
                 depth: int = 12, modes: int = 32, mlp_ratio: float = 1.0, n_cls: int = 12,
                 normalize: bool = False, act: str = "gelu", time_agg: str = "exp_mlp",
                 compute_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        p, E = patch_size, embed_dim
        self.patch_size, self.out_channels, self.out_timesteps = p, out_channels, out_timesteps
        self.normalize, self.act = normalize, act
        self.compute_dtype, self.remat = compute_dtype, remat
        hx = img_size // p
        hidden = out_channels * p + 3
        self.pos_embed = nn.Parameter(torch.empty(1, E, hx, hx))
        self.patch_embed = nn.Module()
        # the reference's Sequential(conv, act, conv)
        self.patch_embed.proj = nn.Sequential(
            nn.Conv2d(in_channels + 3, hidden, p, stride=p), nn.Identity(),
            nn.Conv2d(hidden, E, 1))
        self.time_agg_layer = TimeAggregator(in_timesteps, E, time_agg)
        if normalize:
            self.scale_feats_mu = nn.Linear(2 * in_channels, E)
            self.scale_feats_sigma = nn.Linear(2 * in_channels, E)
        self.blocks = nn.ModuleList(DPOTBlock(E, n_blocks, modes, mlp_ratio, act)
                                    for _ in range(depth))
        self.cls_head = nn.Sequential(nn.Linear(E, E), nn.Identity(), nn.Linear(E, E),
                                      nn.Identity(), nn.Linear(E, n_cls))
        self.out_layer = nn.Sequential(
            nn.ConvTranspose2d(E, out_layer_dim, p, stride=p), nn.Identity(),
            nn.Conv2d(out_layer_dim, out_layer_dim, 1), nn.Identity(),
            nn.Conv2d(out_layer_dim, out_channels * out_timesteps, 1))

    def reset_parameters(self, generator=None) -> None:
        """flax's initialisers: lecun-normal kernels with zero biases, the
        position embedding a normal of std 0.02 truncated at ±2 std, AFNO's
        weights U[0, scale), unit GroupNorms."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.ConvTranspose2d):
                lecun_normal_(m.weight.data, m.weight.shape[0] * m.weight[0, 0].numel(),
                              generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                m.reset_parameters()
            elif isinstance(m, (AFNO2D, TimeAggregator)):
                m.reset_parameters(generator)

    def _block(self, block, h):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, h, self.compute_dtype, use_reentrant=False,
                              preserve_rng_state=False)
        return block(h, self.compute_dtype)

    def forward(self, x: torch.Tensor):
        B, X, Y, T, C = x.shape
        act, dt, p = ACT[self.act], self.compute_dtype, self.patch_size
        st = stats_dtype(x.dtype)
        x = x.to(st)
        if self.normalize:
            mu = x.mean(dim=(1, 2, 3), keepdim=True)
            sigma = x.std(dim=(1, 2, 3), keepdim=True, correction=0) + 1e-6
            x = (x - mu) / sigma
            ms = torch.cat([mu, sigma], dim=-1)[:, 0, 0, 0]          # [B, 2C]
            scale_mu = linear(self.scale_feats_mu, ms, st)
            scale_sigma = linear(self.scale_feats_sigma, ms, st)
        grid = torch.stack(torch.meshgrid(_linspace(X, x), _linspace(Y, x), _linspace(T, x),
                                          indexing="ij"), dim=-1)
        x = torch.cat([x, grid[None].expand(B, X, Y, T, 3)], dim=-1)

        # per-frame patch embedding: [(B T), C+3, X, Y]
        proj = self.patch_embed.proj
        h = x.permute(0, 3, 4, 1, 2).reshape(B * T, C + 3, X, Y)
        h = act(F.conv2d(h, proj[0].weight.to(st), proj[0].bias.to(st), stride=p))
        h = pointwise(proj[2], h.permute(0, 2, 3, 1), st)            # [(B T), hx, wx, E]
        h = h + self.pos_embed.to(st).permute(0, 2, 3, 1)
        hx, wx, E = h.shape[1], h.shape[2], h.shape[3]
        h = h.reshape(B, T, hx, wx, E).permute(0, 2, 3, 1, 4)         # [B, hx, wx, T, E]
        h = self.time_agg_layer(h)                                     # [B, hx, wx, E]
        if self.normalize:
            h = scale_sigma[:, None, None] * h + scale_mu[:, None, None]

        for block in self.blocks:
            h = self._block(block, h)

        # the classification head of the pretrained checkpoints
        cls = h.mean(dim=(1, 2))
        cls = act(linear(self.cls_head[0], cls, st))
        cls = act(linear(self.cls_head[2], cls, st))
        cls = linear(self.cls_head[4], cls, st)

        # the stride-p transposed convolution as one product per token:
        # [B, hx, wx, E] → [B, hx, wx, O, p, p] → [B, X, Y, O]
        out_l = self.out_layer
        w = out_l[0].weight.to(st)                                     # [E, O, p, p]
        O = w.shape[1]
        out = (h.reshape(-1, E) @ w.reshape(E, O * p * p)).reshape(B, hx, wx, O, p, p)
        out = out.permute(0, 1, 4, 2, 5, 3).reshape(B, hx * p, wx * p, O)
        out = act(out + out_l[0].bias.to(st))
        out = act(pointwise(out_l[2], out, st))
        out = pointwise(out_l[4], out, st)
        out = out.reshape(B, X, Y, self.out_timesteps, self.out_channels)
        if self.normalize:
            out = out * sigma + mu
        return out, cls


class DPOT(Model):
    """The benchmark wrapper on windows [B, T_in, H, W, C] (``model_type``
    dpot) or [B, T_in, H, W, D, C] (dpot3d) → the output window.

    ``generator`` draws the initial weights (on the CPU, then moved to
    ``device``); without one they are drawn on ``device`` from its default
    generator (a model whose weights a state dict replaces). On the
    ``meta`` device the model is built without memory or initialisation
    (shapes only).
    """

    def __init__(self, shape_in: Sequence[int], shape_out: Sequence[int],
                 model_type: str = "dpot", img_size: int = 128, in_channels: int = 4,
                 out_channels: int = 4, in_timesteps: int = 1, out_timesteps: int = 1,
                 patch_size: int = 8, embed_dim: int = 512, depth: int = 12,
                 n_blocks: int = 8, modes: int = 32, mlp_ratio: float = 4,
                 out_layer_dim: int = 32, normalize: bool = False, act: str = "gelu",
                 time_agg: str = "exp_mlp", n_cls: int = 1,
                 compute_dtype: torch.dtype = torch.float32, remat: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.shape_in, self.shape_out = tuple(shape_in), tuple(shape_out)
        self.model_type, self.img_size = model_type, img_size
        self.in_timesteps, self.out_timesteps = in_timesteps, out_timesteps
        common = dict(img_size=img_size, patch_size=patch_size, in_channels=in_channels,
                      out_channels=out_channels, in_timesteps=in_timesteps,
                      out_timesteps=out_timesteps, n_blocks=n_blocks, embed_dim=embed_dim,
                      out_layer_dim=out_layer_dim, depth=depth, modes=modes,
                      mlp_ratio=mlp_ratio, n_cls=n_cls, normalize=normalize, act=act,
                      time_agg=time_agg, compute_dtype=compute_dtype, remat=remat)
        device = torch.device("cpu" if device is None else device)
        build_on = device if device.type == "meta" or generator is None else torch.device("cpu")
        with build_on:
            if model_type == "dpot3d":
                from realpdebench_tpu_torch.models.dpot3d import DPOTNet3D

                self.dpot_model = DPOTNet3D(**common)
            elif model_type == "dpot":
                self.dpot_model = DPOTNet(**common)
            else:
                raise ValueError(f"Unknown model type: {model_type}")
        if device.type != "meta":
            self.dpot_model.reset_parameters(generator)
            self.to(device)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dpot_model.compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, dt: torch.dtype) -> None:
        self.dpot_model.compute_dtype = dt

    def _single_window(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T_in, *S, C] → [B, out_timesteps, *S, C_out] (reference
        ``model/dpot.py:181-240``)."""
        nd = x.dim() - 3                                   # 2 or 3 spatial axes
        B, T, C, S = x.shape[0], x.shape[1], x.shape[-1], tuple(x.shape[2:-1])
        resize = fft_resize_3d if nd == 3 else fft_resize_2d
        x = x.permute(0, *range(2, 2 + nd), 1, nd + 2)    # [B, *S, T, C]
        model_res = (self.img_size,) * nd
        if S != model_res:
            x = resize(x.reshape(B, *S, T * C), model_res).reshape(B, *model_res, T, C)
        if C < 4:
            x = torch.cat([x, x.new_ones((*x.shape[:-1], 4 - C))], dim=-1)
        out, _ = self.dpot_model(x)
        out = out[..., :self.shape_out[-1]]
        if S != model_res:
            To, Co = out.shape[-2], out.shape[-1]
            out = resize(out.reshape(B, *model_res, To * Co), S).reshape(B, *S, To, Co)
        return out.permute(0, nd + 1, *range(1, nd + 1), nd + 2)

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """x → the prediction [B, T_out, *S, C_out] in float32 (float64 for
        a float64 copy), or, given the target y, the scalar MSE. When the
        data's T_out exceeds the model's output window, windows slide over
        the model's own predictions (reference ``model/dpot.py:150-179``).
        ``reference`` is accepted for the callers that hold a kernel path
        against the plain one; this family runs no kernel of its own."""
        T_out = self.shape_out[0]
        if self.out_timesteps == T_out:
            pred = self._single_window(x)
        else:
            current, outputs = x, []
            for t in range(0, T_out, self.out_timesteps):
                p = self._single_window(current[:, -self.in_timesteps:])
                if t + self.out_timesteps > T_out:
                    remaining = T_out - t
                    if remaining < self.out_timesteps // 2:
                        break
                    outputs.append(p[:, :remaining])
                else:
                    current = torch.cat([current, p.to(current.dtype)], dim=1)
                    outputs.append(p)
            pred = torch.cat(outputs, dim=1)
        return pred if y is None else mse(pred, y.to(pred.dtype))
