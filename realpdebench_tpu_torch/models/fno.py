"""FNO3d — the 3-D Fourier Neural Operator, on the fused-layer kernels.

Counterpart of ``realpdebench_tpu/models/fno.py`` (its fused path,
``FNO3d._fused_forward``). The forward:

  grid features (t, y, x) appended → fc0 → zero end-pad of (T, H, W) by
  ``padding`` → ``n_layers`` fused layers (ops/fno_layer.py), each taking the
  previous layer's BatchNorm and GELU folded in as z = act(a*s + b) → the
  last BatchNorm folded into fc1 → crop → GELU → fc2 → the time-interleaved
  output permutation.

In train mode the BatchNorms normalise with the batch statistics of the
padded grid (biased variance) and move their running statistics by
0.1·(batch − running); in eval mode they use the running statistics. With
a target ``y`` the forward returns the MSE instead of the prediction,
through the fused tail + loss kernels (ops/fno_tail.py), in either mode.

Parameters carry the names the JAX exporter writes
(``realpdebench_tpu/interop/torch_export.py::export_fno``): ``fc0/fc1/fc2``
(``nn.Linear``), ``spectral_convs.i.weights1..4`` (complex
[C_in, C_out, m1, m2, m3]), ``convs.i`` (1x1x1 ``nn.Conv3d``) and ``bns.i``
(``nn.BatchNorm3d``), so ``load_state_dict(strict=True)`` takes an exported
checkpoint as it is. The forward reads these tensors; it never calls the
Conv3d or BatchNorm modules, whose math lives in the kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from realpdebench_tpu_torch.core.mesh import global_rows, global_sum
from realpdebench_tpu_torch.models.base import BN_MOMENTUM, Model, lecun_normal_, mse
from realpdebench_tpu_torch.ops.activations import gelu, gelu_variant
from realpdebench_tpu_torch.ops.fno_layer import (
    fused_fno_layer,
    reference_fused_fno_layer,
)
from realpdebench_tpu_torch.ops.fno_tail import fused_tail_loss
from realpdebench_tpu_torch.ops.spectral import grid_features


class SpectralConv3d(nn.Module):
    """Holder of the four corner weights, complex [C_in, C_out, m1, m2, m3]
    in the reference corner order (+T+H, -T+H, +T-H, -T-H)."""

    def __init__(self, in_channels: int, out_channels: int, modes1: int,
                 modes2: int, modes3: int):
        super().__init__()
        shape = (in_channels, out_channels, modes1, modes2, modes3)
        for k in range(1, 5):
            setattr(self, f"weights{k}", nn.Parameter(
                torch.empty(shape, dtype=torch.complex64)))

    def reset_parameters(self, generator=None) -> None:
        """U[0,1) real and imaginary parts, scaled by 1/(C_in*C_out)."""
        for k in range(1, 5):
            w = getattr(self, f"weights{k}")
            ci, co = w.shape[:2]
            re = torch.rand(w.shape, generator=generator)
            im = torch.rand(w.shape, generator=generator)
            with torch.no_grad():
                w.copy_(torch.complex(re, im) / (ci * co))

    def corner_weights(self):
        """(w_real, w_imag) f32 [4, m1, m2, m3, C_in, C_out]: channels minor,
        the layout of the JAX package and of the corner GEMM."""
        w = torch.stack([getattr(self, f"weights{k}") for k in range(1, 5)])
        w = w.permute(0, 3, 4, 5, 1, 2)
        return w.real.contiguous(), w.imag.contiguous()


class FNO3d(Model):
    """FNO3d at ``width`` with ``n_layers`` fused layers.

    ``compute_dtype`` (float32 or bfloat16) is the dtype of the activations
    between the layers and of the dense layers; parameters and BatchNorm
    statistics stay float32, and the kernels compute in float32.
    ``generator`` draws the initial weights (on the CPU, then moved to
    ``device``); None uses PyTorch's global generator.
    """

    def __init__(self, modes1: int, modes2: int, modes3: int, n_layers: int,
                 width: int, shape_in: Sequence[int], shape_out: Sequence[int],
                 padding: int = 6, compute_dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.modes = (modes1, modes2, modes3)
        self.n_layers, self.width, self.padding = n_layers, width, padding
        self.shape_in, self.shape_out = tuple(shape_in), tuple(shape_out)
        self.compute_dtype = compute_dtype
        t_in, c_out, t_out = shape_in[0], shape_out[-1], shape_out[0]
        self.mult = t_out // t_in
        lin = lambda i, o: nn.utils.skip_init(nn.Linear, i, o)
        self.fc0 = lin(shape_in[-1] + 3, width)
        self.spectral_convs = nn.ModuleList(
            SpectralConv3d(width, width, modes1, modes2, modes3)
            for _ in range(n_layers))
        self.convs = nn.ModuleList(
            nn.utils.skip_init(nn.Conv3d, width, width, 1)
            for _ in range(n_layers))
        self.bns = nn.ModuleList(nn.BatchNorm3d(width) for _ in range(n_layers))
        self.fc1 = lin(width, 128)
        self.fc2 = lin(128, c_out * self.mult)
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator=None) -> None:
        """The JAX init's distributions: lecun-normal kernels and zero biases
        for the dense and pointwise layers, U[0,1)/(C_in*C_out) spectral
        weights, BatchNorm scale 1, bias 0, running mean 0 and var 1."""
        for lin in (self.fc0, self.fc1, self.fc2, *self.convs):
            lecun_normal_(lin.weight.data, lin.weight[0].numel(), generator)
            nn.init.zeros_(lin.bias)
        for sc in self.spectral_convs:
            sc.reset_parameters(generator)
        for bn in self.bns:
            bn.reset_parameters()

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """x [B, T_in, H, W, C_in] → [B, T_out, H, W, C_out] float32, or,
        given the target y [B, T_out, H, W, C_out], the scalar MSE.

        ``reference=True`` runs every layer through the plain oracle
        ``reference_fused_fno_layer`` and the tail in plain ops (autograd
        through them is the backward): the check that a kernel run is
        compared against."""
        B, T, H, W, _ = x.shape
        p, C, dt = self.padding, self.width, self.compute_dtype
        if W % 2 or (W + p) % 2:
            raise ValueError(f"FNO3d needs even W and even W+padding, got "
                             f"W={W}, padding={p}")
        Tp, Hp, Wp = T + p, H + p, W + p
        dims = (B, Tp, Hp, Wp, C)
        n_pos = global_rows(B) * Tp * Hp * Wp    # the BatchNorm statistics' count

        grid = torch.cat(grid_features((T, H, W), device=x.device), dim=-1)
        xg = torch.cat([x.float(), grid.expand(B, T, H, W, 3)], dim=-1)
        h = F.linear(xg.to(dt), self.fc0.weight.to(dt), self.fc0.bias.to(dt))
        h = F.pad(h, (0, 0, 0, p, 0, p, 0, p))          # end-pad W, H, T
        xf = h.reshape(B * Tp, Hp * (Wp // 2), 2 * C)

        layer = reference_fused_fno_layer if reference else fused_fno_layer
        a = torch.ones(C, device=x.device)
        b = torch.zeros(C, device=x.device)
        act = "none"
        for i in range(self.n_layers):
            w_real, w_imag = self.spectral_convs[i].corner_weights()
            conv, bn = self.convs[i], self.bns[i]
            wp = conv.weight[:, :, 0, 0, 0].t().contiguous()
            xf, stats = layer(xf, a, b, w_real, w_imag, wp, conv.bias,
                              dims=dims, act=act)
            if self.training:
                # under data parallelism the global batch's sums (core/mesh)
                stats = global_sum(stats)
                mean = stats[0] / n_pos
                var = stats[1] / n_pos - mean * mean       # biased, as flax
                with torch.no_grad():
                    for run, new in ((bn.running_mean, mean), (bn.running_var, var)):
                        run.mul_(BN_MOMENTUM).add_(new, alpha=1 - BN_MOMENTUM)
            else:
                mean, var = bn.running_mean, bn.running_var
            a = bn.weight / torch.sqrt(var + bn.eps)
            b = bn.bias - mean * a
            act = gelu_variant()

        # the last BatchNorm folds into fc1: (s*a + b) @ K = s @ (a⊙K) + b@K
        w1 = self.fc1.weight * a[None, :]
        b1 = self.fc1.bias + self.fc1.weight @ b
        t_out, c_out = self.shape_out[0], self.shape_out[-1]
        if y is not None and not reference:
            # [B,T,mult,H,W,c_out] -> [B,T,H,W,c_out,mult]: fc2's lane order
            target = y.float().reshape(B, T, self.mult, H, W, c_out).permute(
                0, 1, 3, 4, 5, 2).reshape(B, T, H, W, c_out * self.mult)
            sse = fused_tail_loss(
                xf, target.contiguous(), w1.t().contiguous(), b1,
                self.fc2.weight.t().contiguous(), self.fc2.bias, dims=dims,
                tail_dims=(T, H, W), act=gelu_variant())
            return sse / target.numel()
        z = xf.view(B, Tp, Hp, Wp, C)[:, :T, :H, :W]
        h1 = gelu(F.linear(z.to(dt), w1.to(dt), b1.to(dt)))
        o = F.linear(h1, self.fc2.weight.to(dt), self.fc2.bias.to(dt)).float()

        # [B,T,H,W,c_out*mult] -> [B,T,H,W,c_out,mult] -> [B,T,mult,H,W,c_out]
        o = o.reshape(B, T, H, W, c_out, self.mult).permute(0, 1, 5, 2, 3, 4)
        pred = o.reshape(B, t_out, H, W, c_out)
        return pred if y is None else mse(pred, y.float())
