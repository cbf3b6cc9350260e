"""DPOTNet3D / AFNO3D — the volumetric DPOT backbone (``model_type: dpot3d``).

Counterpart of ``realpdebench_tpu/models/dpot3d.py`` (reference
``dpot_libs/models/dpot3d.py:22-461``): the 2-D DPOTNet with cubic patches,
the real FFT over (X, Y, Z) with separate spatial and temporal mode budgets
in the mixer, and four grid channels. No shipped config uses it, and the
JAX exporter refuses it, so its checkpoints are the port's own; the
parameter names follow the 2-D model's (``pos_embed`` [1, E, hx, wy, lz],
``patch_embed.proj.{0,2}``, ``blocks.i.{norm1, norm2, filter, mlp.{0,2}}``,
``cls_head.{0,2,4}``, ``out_layer.{0,2,4}``).

Precision, as in JAX: the embedding's convolutions, the blocks' GroupNorm
outputs and MLPs and the output layer compute in ``compute_dtype``; the
mixer's FFTs and mode products and the residual stream in float32 (float64
in a float64 copy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from realpdebench_tpu_torch.models.base import lecun_normal_, linear, stats_dtype
from realpdebench_tpu_torch.models.dpot import (
    ACT,
    AFNO2D,
    TimeAggregator,
    _linspace,
    _mix,
    group_norm,
    irfftn,
    pointwise,
)


class AFNO3D(AFNO2D):
    """Adaptive Fourier mixer on x [B, X, Y, Z, C], its residual included;
    kept modes (modes, modes, temporal_modes); AFNO2D's parameters."""

    def __init__(self, width: int, num_blocks: int = 8, modes: int = 32,
                 temporal_modes: int = 8, hidden_size_factor: int = 1, act: str = "gelu"):
        super().__init__(width, num_blocks, modes, hidden_size_factor, act)
        self.temporal_modes = temporal_modes

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # no dtype in JAX
        B, H, W, L, C = x.shape
        nb = self.num_blocks
        st = stats_dtype(x.dtype)
        xf = torch.fft.rfftn(x.to(st), dim=(1, 2, 3), norm="ortho")
        S1, S2, S3 = xf.shape[1:4]
        k1, k2, k3 = min(self.modes, S1), min(self.modes, S2), min(self.temporal_modes, S3)
        kept = xf[:, :k1, :k2, :k3].reshape(B, k1, k2, k3, nb, C // nb)
        # no dtype in JAX: the products in the planes' own dtype
        o2r, o2i = _mix(kept.real, kept.imag, self.w1, self.b1, self.w2, self.b2,
                        ACT[self.act], st, st)
        out = xf.new_zeros((B, S1, S2, S3, C))
        out[:, :k1, :k2, :k3] = torch.complex(o2r, o2i).reshape(B, k1, k2, k3, C)
        return irfftn(out, (H, W, L), (1, 2, 3), norm="ortho") + x


class DPOT3DBlock(nn.Module):
    def __init__(self, width: int, n_blocks: int, modes: int, temporal_modes: int = 8,
                 mlp_ratio: float = 1.0, act: str = "gelu"):
        super().__init__()
        hid = int(width * mlp_ratio)
        self.act = act
        self.norm1 = nn.GroupNorm(8, width, eps=1e-5)
        self.filter = AFNO3D(width, n_blocks, modes, temporal_modes, act=act)
        self.norm2 = nn.GroupNorm(8, width, eps=1e-5)
        self.mlp = nn.Sequential(nn.Conv3d(width, hid, 1), nn.Identity(),
                                 nn.Conv3d(hid, width, 1))

    def forward(self, x: torch.Tensor, dt) -> torch.Tensor:
        h = self.filter(group_norm(self.norm1, x, dt))
        h = group_norm(self.norm2, h, dt)
        h = ACT[self.act](pointwise(self.mlp[0], h, dt))
        # the residual stream stays float32
        return pointwise(self.mlp[2], h, dt).to(x.dtype) + x


class DPOTNet3D(nn.Module):
    """The 3-D backbone on x [B, X, Y, Z, T, C] → ([B, X, Y, Z, T_out,
    C_out], class logits [B, n_cls])."""

    def __init__(self, img_size: int = 224, patch_size: int = 16, in_channels: int = 1,
                 out_channels: int = 3, in_timesteps: int = 1, out_timesteps: int = 1,
                 n_blocks: int = 4, embed_dim: int = 768, out_layer_dim: int = 32,
                 depth: int = 12, modes: int = 32, temporal_modes: int = 8,
                 mlp_ratio: float = 1.0, n_cls: int = 1, normalize: bool = False,
                 act: str = "gelu", time_agg: str = "exp_mlp",
                 compute_dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        p, E = patch_size, embed_dim
        self.patch_size, self.out_channels, self.out_timesteps = p, out_channels, out_timesteps
        self.normalize, self.act, self.compute_dtype = normalize, act, compute_dtype
        hx = img_size // p
        hidden = out_channels * p + 4
        self.pos_embed = nn.Parameter(torch.empty(1, E, hx, hx, hx))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Sequential(
            nn.Conv3d(in_channels + 4, hidden, p, stride=p), nn.Identity(),
            nn.Conv3d(hidden, E, 1))
        self.time_agg_layer = TimeAggregator(in_timesteps, E, time_agg)
        if normalize:
            self.scale_feats_mu = nn.Linear(2 * in_channels, E)
            self.scale_feats_sigma = nn.Linear(2 * in_channels, E)
        self.blocks = nn.ModuleList(DPOT3DBlock(E, n_blocks, modes, temporal_modes,
                                                mlp_ratio, act) for _ in range(depth))
        self.cls_head = nn.Sequential(nn.Linear(E, E), nn.Identity(), nn.Linear(E, E),
                                      nn.Identity(), nn.Linear(E, n_cls))
        self.out_layer = nn.Sequential(
            nn.ConvTranspose3d(E, out_layer_dim, p, stride=p), nn.Identity(),
            nn.Conv3d(out_layer_dim, out_layer_dim, 1), nn.Identity(),
            nn.Conv3d(out_layer_dim, out_channels * out_timesteps, 1))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.Linear)):
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.ConvTranspose3d):
                lecun_normal_(m.weight.data, m.weight.shape[0] * m.weight[0, 0].numel(),
                              generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                m.reset_parameters()
            elif isinstance(m, (AFNO3D, TimeAggregator)):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        B, X, Y, Z, T, C = x.shape
        act, dt, p = ACT[self.act], self.compute_dtype, self.patch_size
        st = stats_dtype(x.dtype)
        x = x.to(st)
        if self.normalize:
            mu = x.mean(dim=(1, 2, 3, 4), keepdim=True)
            sigma = x.std(dim=(1, 2, 3, 4), keepdim=True, correction=0) + 1e-6
            x = (x - mu) / sigma
            ms = torch.cat([mu, sigma], dim=-1)[:, 0, 0, 0, 0]
            scale_mu = linear(self.scale_feats_mu, ms, st)
            scale_sigma = linear(self.scale_feats_sigma, ms, st)
        grid = torch.stack(torch.meshgrid(*(_linspace(n, x) for n in (X, Y, Z, T)),
                                          indexing="ij"), dim=-1)
        x = torch.cat([x, grid[None].expand(B, X, Y, Z, T, 4)], dim=-1)

        proj = self.patch_embed.proj
        h = x.permute(0, 4, 5, 1, 2, 3).reshape(B * T, C + 4, X, Y, Z)
        h = act(F.conv3d(h.to(dt), proj[0].weight.to(dt), proj[0].bias.to(dt), stride=p))
        h = pointwise(proj[2], h.permute(0, 2, 3, 4, 1), dt).to(st)
        h = h + self.pos_embed.to(st).permute(0, 2, 3, 4, 1)
        hx, wy, lz, E = h.shape[1:]
        h = h.reshape(B, T, hx, wy, lz, E).permute(0, 2, 3, 4, 1, 5)
        h = self.time_agg_layer(h)                                  # [B, hx, wy, lz, E]
        if self.normalize:
            h = scale_sigma[:, None, None, None] * h + scale_mu[:, None, None, None]

        for block in self.blocks:
            h = block(h, dt)

        cls = h.mean(dim=(1, 2, 3))
        cls = act(linear(self.cls_head[0], cls, st))
        cls = act(linear(self.cls_head[2], cls, st))
        cls = linear(self.cls_head[4], cls, st)

        out_l = self.out_layer
        w = out_l[0].weight.to(dt)                                  # [E, O, p, p, p]
        O = w.shape[1]
        out = (h.to(dt).reshape(-1, E) @ w.reshape(E, O * p ** 3)).reshape(
            B, hx, wy, lz, O, p, p, p)
        out = out.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(B, hx * p, wy * p, lz * p, O)
        out = act(out + out_l[0].bias.to(dt))
        out = act(pointwise(out_l[2], out, dt))
        out = pointwise(out_l[4], out, dt).to(st)
        out = out.reshape(B, X, Y, Z, self.out_timesteps, self.out_channels)
        if self.normalize:
            out = out * sigma + mu
        return out, cls
