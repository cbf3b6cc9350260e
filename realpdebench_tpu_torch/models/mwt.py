"""MWT3d — the Multiwavelet Transform operator.

Counterpart of ``realpdebench_tpu/models/mwt.py`` (the reference's
``MWT_libs/models.py:498-785``): the input lifted to c·k² features, then
``nCZ`` multiwavelet CZ cells with ReLU between. Each cell decomposes the
(H, W) plane level by level with the 2×2 Kronecker filters (ec_s, ec_d of
``ops/multiwavelet.cz_matrices``), applies a Fourier kernel A to the detail
coefficients plus conv kernels B and C, transforms the coarsest scale (T0)
and reconstructs by even/odd interleaving (the rc matrices).

Layout, as the JAX code keeps it: grid-major [B, Nx, Ny, T, c, k²] (Nx = H,
Ny = W), T the rfft axis of the Fourier kernel; the even/odd split in the
order ee, eo, oe, oo; the coarsest level folding the leftover W (a
rectangular grid's W/H) into T0's input; the reconstruction interleaving
out[2i + p, 2j + q] = x_pq[i, j]. The conv kernels run channels-first
(cuDNN), their weights in the same (Nx, Ny, T) axis order as JAX's.

The Fourier kernel keeps min(alpha, n//2 + 1) modes an axis. Where both
grid axes hold twice their modes, it is the shared truncated spectral conv
(``ops/spectral.truncated_spectral_conv3d``: DFT products in the compute
dtype, float32 sums). On the deep levels, where 2·l exceeds an axis (at
alpha 5, every level with Nx ≤ 8), the four corners overlap and the later
one wins, and the half spectrum they leave is not Hermitian on the zero T
plane: it is assembled explicitly and inverted by ``ops/spectral.irfftn``,
the inverse as the JAX package defines it (cuFFT's leaves such spectra
undefined). That branch computes in float32 whatever the compute dtype,
its ``Lo`` included (JAX's ``Lo`` there has no dtype).

Precision: ``compute_dtype`` is the dtype of the Denses, the convolutions,
the wavelet matmuls and the truncated Fourier kernel's products; where JAX
promotes (the float32 deep-level branch meeting bfloat16 activations), the
port promotes the same way. A float64 copy (``.double()`` and
``compute_dtype = torch.float64``) computes everything in float64.

Parameters carry the names the JAX exporter writes
(``realpdebench_tpu/interop/torch_export.py::export_mwt``): ``Lk``,
``Lc0``, ``Lc1``; ``MWT_CZ.i.{A.weights1..4, A.Lo, B.conv.0, B.Lo,
C.conv.0, C.Lo, T0}`` (``A``'s weights complex [c·k², c·k², α, α, α]), so
``load_state_dict(strict=True)`` takes an exported checkpoint as it is.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from realpdebench_tpu_torch.models.base import Model, lecun_normal_, linear, mse, stats_dtype
from realpdebench_tpu_torch.ops.multiwavelet import cz_matrices
from realpdebench_tpu_torch.ops.spectral import irfftn, rfftn, truncated_spectral_conv3d


def _mm(x, m):
    """x @ m at the dtype JAX promotes the two to."""
    dt = torch.promote_types(x.dtype, m.dtype)
    return torch.matmul(x.to(dt), m.to(dt))


def _dense(m: nn.Linear, x, dt=None):
    """flax Dense with ``dtype=dt``; with no dtype, at the promotion of the
    input's and the float32 parameters' dtypes."""
    return linear(m, x, torch.promote_types(x.dtype, m.weight.dtype) if dt is None else dt)


class SparseKernelFT3d(nn.Module):
    """The Fourier kernel on wavelet coefficients (``models.py:535-585``):
    the corner weights complex [c·k², c·k², α, α, α], ``Lo`` a Dense."""

    def __init__(self, ck2: int, alpha: int):
        super().__init__()
        shape = (ck2, ck2, alpha, alpha, alpha)
        for k in range(1, 5):
            setattr(self, f"weights{k}", nn.Parameter(torch.empty(shape, dtype=torch.complex64)))
        self.Lo = nn.Linear(ck2, ck2)

    def reset_parameters(self, generator=None) -> None:
        """Real and imaginary parts N(0, std²/2), std = sqrt(2 / (2·c·k²)):
        the JAX init's xavier-normal over the two leading axes."""
        for k in range(1, 5):
            w = getattr(self, f"weights{k}")
            std = math.sqrt(2.0 / (w.shape[0] + w.shape[1])) / math.sqrt(2.0)
            re, im = (torch.randn(w.shape, generator=generator) * std for _ in range(2))
            with torch.no_grad():
                w.copy_(torch.complex(re, im))

    def corner_weights(self):
        """(w_real, w_imag) [4, α, α, α, C_in, C_out], channels minor."""
        w = torch.stack([getattr(self, f"weights{k}") for k in range(1, 5)])
        w = w.permute(0, 3, 4, 5, 1, 2)
        return w.real, w.imag

    def forward(self, x, dt):
        B, Nx, Ny, T, c, ich = x.shape
        acc = stats_dtype(dt)
        xf = x.reshape(B, Nx, Ny, T, c * ich).to(acc)
        alpha = self.weights1.shape[-1]
        l1, l2, l3 = (min(alpha, n // 2 + 1) for n in (Nx, Ny, T))
        wr, wi = self.corner_weights()
        wr, wi = wr[:, :l1, :l2, :l3].to(acc), wi[:, :l1, :l2, :l3].to(acc)

        if 2 * l1 <= Nx and 2 * l2 <= Ny:
            # no corner overlaps: the shared truncated spectral conv, its
            # (T, H, W = rfft) axes on MWT's (Nx, Ny, T = rfft)
            out = truncated_spectral_conv3d(xf, wr, wi, compute_dtype=dt)
            out = _dense(self.Lo, F.relu(out), dt)
            return out.reshape(B, Nx, Ny, T, c, ich)

        # the deep levels: overlapping corners, the later one wins
        x_ft = rfftn(xf, dim=(1, 2, 3))
        corners = torch.stack([x_ft[:, :l1, :l2, :l3], x_ft[:, -l1:, :l2, :l3],
                               x_ft[:, :l1, -l2:, :l3], x_ft[:, -l1:, -l2:, :l3]], dim=1)
        out_c = torch.einsum("bkxyzi,kxyzio->bkxyzo", corners, torch.complex(wr, wi))
        ft = x_ft.new_zeros((B, Nx, Ny, T // 2 + 1, out_c.shape[-1]))
        ft[:, :l1, :l2, :l3] = out_c[:, 0]
        ft[:, -l1:, :l2, :l3] = out_c[:, 1]
        ft[:, :l1, -l2:, :l3] = out_c[:, 2]
        ft[:, -l1:, -l2:, :l3] = out_c[:, 3]
        out = F.relu(irfftn(ft, (Nx, Ny, T), (1, 2, 3)))
        return _dense(self.Lo, out).reshape(B, Nx, Ny, T, c, ich)


class SparseKernel3d(nn.Module):
    """The conv kernel on wavelet coefficients (``models.py:498-527``): a k3
    'same' Conv3d, ReLU and a Dense."""

    def __init__(self, ck2: int):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv3d(ck2, ck2, 3, padding=1)])
        self.Lo = nn.Linear(ck2, ck2)

    def forward(self, x, dt):
        B, Nx, Ny, T, c, ich = x.shape
        conv = self.conv[0]
        h = x.reshape(B, Nx, Ny, T, c * ich).permute(0, 4, 1, 2, 3).to(dt)
        h = F.conv3d(h, conv.weight.to(dt), conv.bias.to(dt), padding=1)
        h = F.relu(h).permute(0, 2, 3, 4, 1)
        return _dense(self.Lo, h, dt).reshape(B, Nx, Ny, T, c, ich)


_CZ_NAMES = ("ec_s", "ec_d", "rc_ee", "rc_eo", "rc_oe", "rc_oo")


class MWTCZ3d(nn.Module):
    """One multiwavelet CZ cell (``models.py:600-700``). The six matrices of
    ``cz_matrices`` are buffers that the state dict leaves out: they move
    with the model, so a forward copies nothing from the host."""

    def __init__(self, k: int, alpha: int, L: int, c: int, base: str, t0_in: int):
        super().__init__()
        ck2 = c * k * k
        self.k, self.L, self.base = k, L, base
        self.A = SparseKernelFT3d(ck2, alpha)
        self.B = SparseKernel3d(ck2)
        self.C = SparseKernel3d(ck2)
        self.T0 = nn.Linear(t0_in, ck2)
        for name, m in zip(_CZ_NAMES, cz_matrices(base, k), strict=True):
            self.register_buffer(name, torch.tensor(m), persistent=False)

    def forward(self, x, dt):
        B, Nx, Ny, T, c, ich = x.shape
        ns = math.floor(np.log2(Nx))
        ec_s, ec_d, rc_ee, rc_eo, rc_oe, rc_oo = (getattr(self, n).to(x.dtype)
                                                  for n in _CZ_NAMES)

        Ud, Us = [], []
        for _ in range(ns - self.L):
            # even/odd split, ee, eo, oe, oo concatenated on the last axis
            b, nx, ny = x.shape[:3]
            z2 = x.reshape(b, nx // 2, 2, ny // 2, 2, *x.shape[3:])
            za = torch.cat([z2[:, :, 0, :, 0], z2[:, :, 0, :, 1],
                            z2[:, :, 1, :, 0], z2[:, :, 1, :, 1]], dim=-1)
            d, x = _mm(za, ec_d), _mm(za, ec_s)
            Ud.append(self.A(d, dt) + self.B(x, dt))
            Us.append(self.C(d, dt))

        # the coarsest scale; a rectangular grid's leftover folds into T0's input
        n0 = 2 ** self.L
        x = _dense(self.T0, x.reshape(B, n0, n0, T, -1), dt).reshape(B, n0, n0, T, c, ich)

        for i in range(ns - 1 - self.L, -1, -1):
            x = x + Us[i]                  # broadcasts over the leftover Ny axis
            x = torch.cat([x.expand(*Ud[i].shape[:-1], ich), Ud[i]], dim=-1)
            x_ee, x_eo, x_oe, x_oo = (_mm(x, m) for m in (rc_ee, rc_eo, rc_oe, rc_oo))
            b, nx, ny = x.shape[:3]
            tail = x_ee.shape[3:]
            even = torch.stack([x_ee, x_eo], dim=3).reshape(b, nx, ny * 2, *tail)
            odd = torch.stack([x_oe, x_oo], dim=3).reshape(b, nx, ny * 2, *tail)
            x = torch.stack([even, odd], dim=2).reshape(b, nx * 2, ny * 2, *tail)
        return x


class MWT3d(Model):
    """MWT3d on windows [B, T_in, H, W, C_in] → [B, T_out, H, W, C_out].

    ``generator`` draws the initial weights (on the CPU, then moved to
    ``device``): lecun-normal Dense and conv kernels, zero biases, and the
    Fourier kernels' xavier-normal complex weights; None uses PyTorch's
    global generator.
    """

    def __init__(self, ich: int, shape_in: Sequence[int], shape_out: Sequence[int],
                 k: int = 3, alpha: int = 2, c: int = 1, nCZ: int = 3, L: int = 0,
                 base: str = "legendre", compute_dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.shape_in, self.shape_out = tuple(shape_in), tuple(shape_out)
        self.c, self.k, self.compute_dtype = c, k, compute_dtype
        ck2 = c * k * k
        H, W = self.shape_in[1], self.shape_in[2]
        # what is left of the (H, W) plane after the decomposition, folded
        # into T0's input over the coarsest 2^L × 2^L grid
        levels = math.floor(np.log2(H)) - L
        t0_in = ck2 * (H >> levels) * (W >> levels) // 4 ** L
        self.Lk = nn.Linear(ich, ck2)
        self.MWT_CZ = nn.ModuleList(MWTCZ3d(k, alpha, L, c, base, t0_in) for _ in range(nCZ))
        self.Lc0 = nn.Linear(ck2, 128)
        self.Lc1 = nn.Linear(128, self.shape_out[-1] * (self.shape_out[0] // self.shape_in[0]))
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)):
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, SparseKernelFT3d):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """x [B, T_in, H, W, C_in] → [B, T_out, H, W, C_out] float32 (float64
        for a float64 copy), or, given the target y, the scalar MSE.
        ``reference`` is accepted for the callers that hold a kernel path
        against the plain one; this family runs no kernel of its own."""
        dt = self.compute_dtype
        x = x.permute(0, 2, 3, 1, 4)                         # [B, Nx, Ny, T, C]
        B, Nx, Ny, T, _ = x.shape
        t_out, c_out = self.shape_out[0], self.shape_out[-1]
        mult = t_out // self.shape_in[0]
        x = _dense(self.Lk, x, dt).reshape(B, Nx, Ny, T, self.c, self.k ** 2)
        for i, cz in enumerate(self.MWT_CZ):
            x = cz(x, dt)
            if i < len(self.MWT_CZ) - 1:
                x = F.relu(x)
        x = F.relu(_dense(self.Lc0, x.reshape(B, Nx, Ny, T, -1), dt))
        x = _dense(self.Lc1, x, dt).to(stats_dtype(dt))
        # (B, Nx, Ny, T, C_out·mult) → (B, T_out, H, W, C_out)
        x = x.reshape(B, Nx, Ny, T, c_out, mult).permute(0, 3, 5, 1, 2, 4)
        pred = x.reshape(B, t_out, Nx, Ny, c_out)
        return pred if y is None else mse(pred, y.to(pred.dtype))
