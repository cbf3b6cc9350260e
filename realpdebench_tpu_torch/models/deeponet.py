"""DeepONet — the branch-trunk operator network.

Counterpart of ``realpdebench_tpu/models/deeponet.py`` (the reference's
``model/deeponet.py``): the branch is a 3-D CNN over the input window, four
stages of a k3 'same' Conv3d, BatchNorm and ReLU, the first three followed
by a 2×2×2 max-pool (its window clamped to each axis's size, as in JAX, so
that tiny shapes stay defined), the last by an adaptive average pool to
(1, 4, 4); then a Dense to 512, ReLU, dropout and a Dense to ``p``. The
trunk is an MLP (64, 128, ``p``) on the normalised (t, y, x) coordinates of
the output grid, evaluated once a forward, independent of the batch. The
output is an MLP (512, 128, C_out; ReLU and dropout after the first two) on
``branch ⊙ trunk`` at every output point, reshaped to
[B, T_out, H, W, C_out] in float32.

The branch runs channels-first, [B, C, T, H, W], as cuDNN's Conv3d takes
it; its flatten is channels-first too, so ``branch.fc.0.weight`` holds the
reference's (C, spatial) column order, which the JAX exporter writes
(JAX flattens channels-last and its exporter permutes the columns).

Precision: ``compute_dtype`` (float32 or bfloat16) is the dtype of the
activations, the convolutions and the Denses; parameters stay float32 and
are cast at use, as flax's ``dtype=`` does. The BatchNorms take float32
statistics (``models/base.batch_norm``). A float64 copy of the model
(``.double()`` and ``compute_dtype = torch.float64``) computes everything in
float64: the reference the card holds this kernel-free family against.

Dropout (rate ``dropout_rate``, three sites in the JAX call order: the
branch after its first Dense, then after the output MLP's first and second
Denses) runs in train mode only and draws through
``models/base.dropout_mask`` from the model's generator, seeded by
``dropout_seed``.

Parameters carry the names the JAX exporter writes
(``realpdebench_tpu/interop/torch_export.py::export_deeponet``):
``branch.conv{1..4}.{0,1}`` (Conv3d, BatchNorm3d), ``branch.fc.{0,3}``,
``trunk.fc.{0,2,4}``, ``output_net.{0,3,6}``, so
``load_state_dict(strict=True)`` takes an exported checkpoint as it is.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from realpdebench_tpu_torch.models.base import (
    Model,
    batch_norm,
    dropout,
    lecun_normal_,
    linear,
    mse,
    stats_dtype,
)
from realpdebench_tpu_torch.ops.spectral import grid_features

_BRANCH_WIDTHS = (32, 64, 128, 256)
_POOL_OUT = (1, 4, 4)


def _stage(c_in: int, c_out: int) -> nn.Sequential:
    """A branch stage's parameters: a k3 Conv3d and its BatchNorm (the
    reference's ReLU and pool hold none)."""
    return nn.Sequential(nn.Conv3d(c_in, c_out, 3, padding=1),
                         nn.BatchNorm3d(c_out, eps=1e-5))


class BranchNet(nn.Module):
    """The branch's parameters (``conv1..4``, ``fc``); ``DeepONet`` runs it."""

    def __init__(self, c_in: int, p: int):
        super().__init__()
        widths = (c_in, *_BRANCH_WIDTHS)
        for i in range(4):
            setattr(self, f"conv{i + 1}", _stage(widths[i], widths[i + 1]))
        flat = _BRANCH_WIDTHS[-1] * _POOL_OUT[0] * _POOL_OUT[1] * _POOL_OUT[2]
        # Linear, ReLU, Dropout, Linear as in the reference: slots 1 and 2
        # hold no parameters (the dropout draws through base.dropout)
        self.fc = nn.Sequential(nn.Linear(flat, 512), nn.ReLU(), nn.Identity(),
                                nn.Linear(512, p))


class TrunkNet(nn.Module):
    """The trunk's parameters: ``fc.{0,2,4}``, Denses of 64, 128 and ``p``."""

    def __init__(self, p: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(3, 64), nn.ReLU(), nn.Linear(64, 128),
                                nn.ReLU(), nn.Linear(128, p))


class DeepONet(Model):
    """DeepONet on windows [B, T_in, H, W, C_in] → [B, T_out, H, W, C_out].

    ``generator`` draws the initial weights (on the CPU, then moved to
    ``device``) from the JAX init's distributions: lecun-normal kernels,
    zero biases, unit BatchNorm scales and running variances; None uses
    PyTorch's global generator. ``dropout_seed`` seeds the dropout stream.
    """

    def __init__(self, shape_in: Sequence[int], shape_out: Sequence[int], p: int,
                 dropout_rate: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None, dropout_seed: int = 0):
        super().__init__()
        self.shape_in, self.shape_out = tuple(shape_in), tuple(shape_out)
        self.p, self.dropout_rate = p, float(dropout_rate)
        self.compute_dtype = compute_dtype
        self.branch = BranchNet(shape_in[-1], p)
        self.trunk = TrunkNet(p)
        # Linear, ReLU, Dropout, Linear, ReLU, Dropout, Linear
        self.output_net = nn.Sequential(
            nn.Linear(p, 512), nn.ReLU(), nn.Identity(), nn.Linear(512, 128),
            nn.ReLU(), nn.Identity(), nn.Linear(128, shape_out[-1]))
        self.reset_parameters(generator)
        self.to(device)
        self.reseed_dropout(dropout_seed)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()

    def _branch(self, x, dt, drop):
        """x [B, T, H, W, C] → [B, p]."""
        br = self.branch
        h = x.permute(0, 4, 1, 2, 3)                     # [B, C, T, H, W]
        for i in range(4):
            conv, bn = getattr(br, f"conv{i + 1}")
            h = F.conv3d(h.to(dt), conv.weight.to(dt), conv.bias.to(dt), padding=1)
            h = F.relu(batch_norm(bn, h, self.training, dt, channel_dim=1))
            if i < 3:
                ws = tuple(min(2, s) for s in h.shape[2:])
                h = F.max_pool3d(h, ws, ws)
        # torch's floor/ceil bins, as JAX's adaptive_avg_pool3d; flattened
        # channels-first
        h = F.adaptive_avg_pool3d(h, _POOL_OUT).reshape(h.shape[0], -1)
        h = drop(F.relu(linear(br.fc[0], h, dt)))
        return linear(br.fc[3], h, dt)

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """x [B, T_in, H, W, C_in] → [B, T_out, H, W, C_out] float32 (float64
        for a float64 copy), or, given the target y, the scalar MSE.
        ``reference`` is accepted for the callers that hold a kernel path
        against the plain one; this family runs no kernel of its own."""
        B, _, H, W, _ = x.shape
        T_out = self.shape_out[0]
        dt = self.compute_dtype
        if self.training and self.dropout_rate > 0.0:
            gen = self.dropout_generator(x.device)
            drop = lambda z: dropout(z, self.dropout_rate, gen)
        else:
            drop = lambda z: z
        b = self._branch(x, dt, drop)                    # [B, p]
        coords = torch.cat(grid_features((T_out, H, W), dtype=stats_dtype(dt),
                                         device=x.device), dim=-1).reshape(-1, 3)
        tr = self.trunk.fc
        t = F.relu(linear(tr[0], coords, dt))
        t = linear(tr[4], F.relu(linear(tr[2], t, dt)), dt)        # [N, p]
        feat = b[:, None, :] * t[None, :, :]              # [B, N, p]
        on = self.output_net
        out = drop(F.relu(linear(on[0], feat, dt)))
        out = drop(F.relu(linear(on[3], out, dt)))
        out = linear(on[6], out, dt).to(stats_dtype(dt))
        pred = out.reshape(B, T_out, H, W, -1)
        return pred if y is None else mse(pred, y.to(pred.dtype))
