"""Spectral (Fourier-domain) ops of the FNO.

Counterpart of ``realpdebench_tpu/ops/spectral.py``: the truncated DFT
factors that the fused kernels contract against, the grid-coordinate
features, and the plain truncated spectral convolution that serves as the
reference for the fused layer. Activations are channels-last
``[B, T, H, W, C]``; corner weights are channels-minor
``[4, m1, m2, m3, C_in, C_out]`` in the reference corner order
(+T+H, -T+H, +T-H, -T-H).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _dft_factors(T: int, H: int, W: int, m1: int, m2: int, m3: int):
    """Forward DFT matrices restricted to the kept corner modes.

    Ew: [W, m3]   — rfft axis, modes 0..m3-1
    Eh: [H, 2m2]  — modes [0..m2-1] ++ [H-m2..H-1]
    Et: [T, 2m1]  — modes [0..m1-1] ++ [T-m1..T-1]
    and the inverse-pass matrices: It [2m1, T] and Ih [2m2, H] are the
    conjugate transposes over n; Iw_re/Iw_im [m3, W] are the irfft rows with
    the Hermitian weights (1 for mode 0 and for the Nyquist mode of an even
    W, 2 otherwise) over W. Numpy arrays, the same values as the JAX package.
    """
    def fwd(n, ks):
        idx = np.arange(n)[:, None]
        return np.exp(-2j * np.pi * idx * np.asarray(ks)[None, :] / n)

    kw = np.arange(m3)
    kh = np.concatenate([np.arange(m2), np.arange(H - m2, H)])
    kt = np.concatenate([np.arange(m1), np.arange(T - m1, T)])
    Ew = fwd(W, kw).astype(np.complex64)
    Eh = fwd(H, kh).astype(np.complex64)
    Et = fwd(T, kt).astype(np.complex64)

    It = np.conj(Et).T / T
    Ih = np.conj(Eh).T / H
    nyq = (W % 2 == 0) & (kw == W // 2)
    c = np.where((kw == 0) | nyq, 1.0, 2.0) / W
    theta = 2 * np.pi * np.outer(kw, np.arange(W)) / W
    Iw_re = (c[:, None] * np.cos(theta)).astype(np.float32)
    Iw_im = (-c[:, None] * np.sin(theta)).astype(np.float32)
    return Ew, Eh, Et, It, Ih, Iw_re, Iw_im


def grid_features(shape, dtype=torch.float32, device=None):
    """Normalized (t, y, x) coordinate channels for one sample of shape
    [T, H, W]: three [T, H, W, 1] tensors, ``linspace(0, 1, n)`` along each
    of the three leading axes."""
    T, H, W = shape
    lin = lambda n: torch.linspace(0, 1, n, dtype=dtype, device=device)
    gt = lin(T)[:, None, None, None].expand(T, H, W, 1)
    gy = lin(H)[None, :, None, None].expand(T, H, W, 1)
    gx = lin(W)[None, None, :, None].expand(T, H, W, 1)
    return gt, gy, gx


def truncated_spectral_conv3d_dft(x, w_real, w_imag):
    """Mode-truncated spectral conv as complex DFT matmuls (plain reference).

    x: [B, T, H, W, C_in] real; w_real/w_imag: [4, m1, m2, m3, C_in, C_out].
    Forward W → H → T on the kept modes, per-corner complex channel mixing,
    inverse T → H → W with the irfft weights. Returns [B, T, H, W, C_out]
    float32 (exact to float rounding against rfftn/irfftn).
    """
    B, T, H, W, Cin = x.shape
    _, m1, m2, m3, _, Cout = w_real.shape
    dev = x.device
    Ew, Eh, Et, It, Ih, Iw_re, Iw_im = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in _dft_factors(T, H, W, m1, m2, m3))

    xc = x.float().to(torch.complex64)
    fw = torch.einsum("bthwc,wi->bthic", xc, Ew)
    fh = torch.einsum("bthic,hj->btjic", fw, Eh)
    ft = torch.einsum("btjic,tk->bkjic", fh, Et)        # [B,2m1,2m2,m3,C]

    corners = torch.stack(
        [ft[:, :m1, :m2], ft[:, m1:, :m2], ft[:, :m1, m2:], ft[:, m1:, m2:]],
        dim=1)                                           # [B,4,m1,m2,m3,Ci]
    wc = torch.complex(w_real.float(), w_imag.float())
    out_c = torch.einsum("bkxyzi,kxyzio->bkxyzo", corners, wc)

    top = torch.cat([out_c[:, 0], out_c[:, 2]], dim=2)   # +T rows
    bot = torch.cat([out_c[:, 1], out_c[:, 3]], dim=2)   # -T rows
    g = torch.cat([top, bot], dim=1)                     # [B,2m1,2m2,m3,Co]

    it = torch.einsum("bkjic,kt->btjic", g, It)
    ih = torch.einsum("btjic,jh->bthic", it, Ih)
    return (torch.einsum("bthic,iw->bthwc", ih.real, Iw_re)
            + torch.einsum("bthic,iw->bthwc", ih.imag, Iw_im))
