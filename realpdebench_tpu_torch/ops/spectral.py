"""Spectral (Fourier-domain) ops of the FNO and the Galerkin decoder.

Counterpart of ``realpdebench_tpu/ops/spectral.py``: the truncated DFT
factors that the fused kernels contract against, the grid-coordinate
features, the truncated spectral convolution in its three forms: the
complex DFT matmuls (``dft_c64``, the reference of the fused FNO layer), the
low-precision DFT with the complex arithmetic unrolled into real matmuls
(``dft``, the Galerkin decoder's and MWT's), and rfftn/irfftn (``fft``); and
``rfftn``/``irfftn``, the real transforms as the JAX package defines them
(DPOT's and MWT's, the counterpart of its ``rfftn_planes`` /
``irfftn_planes``). Activations
are channels-last ``[B, T, H, W, C]``; corner weights are channels-minor
``[4, m1, m2, m3, C_in, C_out]`` in the reference corner order
(+T+H, -T+H, +T-H, -T-H).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def rfftn(x: torch.Tensor, dim, norm=None) -> torch.Tensor:
    """The real forward transform over ``dim`` (the last the half-spectrum
    axis), complex in the precision of ``x`` (at least float32): the JAX
    package's ``rfftn_planes`` as one complex tensor."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    return torch.fft.rfftn(x, dim=dim, norm=norm)


def irfftn(z: torch.Tensor, s, dim, norm=None) -> torch.Tensor:
    """``torch.fft.irfftn(z, s, dim, norm)`` as the JAX package defines it
    for any half spectrum (``irfftn_planes``, its dense-DFT route): a
    complex inverse transform over every axis but the last, then the real
    one over the last, where the imaginary parts of the zero and (even
    length) Nyquist frequencies drop out. cuFFT's multi-axis inverse leaves
    a spectrum that is not Hermitian on those frequencies undefined (its
    f32 and f64 plans disagree by 1e-2 relative on DPOT's resize), and the
    spectra here are not: DPOT's resize copies and zero-pads them, its
    mixer's MLP writes them, and MWT's deep levels write overlapping
    corners."""
    dim = [d % z.dim() for d in dim]
    y = torch.fft.ifftn(z, s=s[:-1], dim=dim[:-1], norm=norm)
    d, n = dim[-1], s[-1]
    keep = torch.ones(y.shape[d], dtype=y.real.dtype, device=y.device)
    keep[0] = 0
    if n % 2 == 0 and n // 2 < y.shape[d]:
        keep[n // 2] = 0
    keep = keep.view(-1, *([1] * (y.dim() - d - 1)))
    return torch.fft.irfft(torch.complex(y.real, y.imag * keep), n=n, dim=d, norm=norm)


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


def truncated_spectral_conv3d_fft(x, w_real, w_imag):
    """Mode-truncated spectral conv through rfftn/irfftn over (T, H, W), in
    float32/complex64 whatever the input dtype. Returns [B, T, H, W, C_out]
    float32."""
    B, T, H, W, Cin = x.shape
    _, m1, m2, m3, _, Cout = w_real.shape
    x_ft = torch.fft.rfftn(x.float(), dim=(1, 2, 3))     # [B,T,H,W//2+1,Ci]
    corners = torch.stack(
        [x_ft[:, :m1, :m2, :m3], x_ft[:, -m1:, :m2, :m3],
         x_ft[:, :m1, -m2:, :m3], x_ft[:, -m1:, -m2:, :m3]], dim=1)
    wc = torch.complex(w_real.float(), w_imag.float())
    out_c = torch.einsum("bkxyzi,kxyzio->bkxyzo", corners, wc)
    out_ft = torch.zeros((B, T, H, W // 2 + 1, Cout), dtype=torch.complex64,
                         device=x.device)
    out_ft[:, :m1, :m2, :m3] = out_c[:, 0]
    out_ft[:, -m1:, :m2, :m3] = out_c[:, 1]
    out_ft[:, :m1, -m2:, :m3] = out_c[:, 2]
    out_ft[:, -m1:, -m2:, :m3] = out_c[:, 3]
    return torch.fft.irfftn(out_ft, s=(T, H, W), dim=(1, 2, 3))


@lru_cache(maxsize=16)
def _lowp_factors(T: int, H: int, W: int, m1: int, m2: int, m3: int,
                  dtype: torch.dtype, device: torch.device) -> dict:
    """The DFT factors of ``truncated_spectral_conv3d_dft_lowp`` as real
    planes in ``dtype`` on ``device``, transposed to multiply from the left:
      w   [2m3, W]   forward W, cos rows then -sin rows
      hr, hi [2m2, H], tr, ti [2m1, T]   forward H and T
      itr, iti [T, 2m1], ihr, ihi [H, 2m2]   inverse T and H
      iw  [W, 2m3]   inverse W (irfft weights), real rows then imaginary
    """
    Ew, Eh, Et, It, Ih, Iw_re, Iw_im = _dft_factors(T, H, W, m1, m2, m3)
    planes = dict(
        w=np.concatenate([Ew.real, Ew.imag], axis=1).T,
        hr=Eh.real.T, hi=Eh.imag.T, tr=Et.real.T, ti=Et.imag.T,
        itr=It.real.T, iti=It.imag.T, ihr=Ih.real.T, ihi=Ih.imag.T,
        iw=np.concatenate([Iw_re, Iw_im], axis=0).T)
    with torch.inference_mode(False):   # cached: autograd may use it later
        return {k: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
            device=device, dtype=dtype) for k, a in planes.items()}


def truncated_spectral_conv3d_dft_lowp(x, w_real, w_imag,
                                       compute_dtype=torch.bfloat16):
    """The truncated spectral conv with the complex arithmetic unrolled into
    real matmuls (complex bf16 does not exist), operands in
    ``compute_dtype`` and float32 accumulation (JAX
    ``truncated_spectral_conv3d_dft_lowp``, ``spectral.py:223-295``).

    Each stage contracts a non-minor axis of [B, T, H, W, C] by multiplying
    the DFT plane from the left, so every product is a batched matmul on
    the activation as it lies in memory, without permute copies. The
    stages' complex combinations add float32 products; the output is the
    last product rounded once to ``compute_dtype`` (JAX returns that
    product in float32 and its caller casts it to the compute dtype).
    """
    B, T, H, W, Cin = x.shape
    _, m1, m2, m3, _, Cout = w_real.shape
    dt = compute_dtype
    acc = torch.promote_types(dt, torch.float32)   # float64 in a float64 copy
    f = _lowp_factors(T, H, W, m1, m2, m3, dt, x.device)
    mm = lambda a, b: torch.matmul(a, b.to(dt)).to(acc)

    # W stage (real input): one product against [cos | -sin]
    x2 = mm(f["w"], x)                                   # [B,T,H,2m3,Ci]
    xr = x2[..., :m3, :].reshape(B, T, H, m3 * Cin)
    xi = x2[..., m3:, :].reshape(B, T, H, m3 * Cin)
    # H stage, then T stage
    yr = (mm(f["hr"], xr) - mm(f["hi"], xi)).reshape(B, T, -1)
    yi = (mm(f["hi"], xr) + mm(f["hr"], xi)).reshape(B, T, -1)
    zr = (mm(f["tr"], yr) - mm(f["ti"], yi)).reshape(B, 2 * m1, 2 * m2, m3, Cin)
    zi = (mm(f["ti"], yr) + mm(f["tr"], yi)).reshape(B, 2 * m1, 2 * m2, m3, Cin)

    def corners(z):      # [4, m1, m2, m3, B, Ci]: modes lead, per-mode GEMM
        c = torch.stack([z[:, :m1, :m2], z[:, m1:, :m2], z[:, :m1, m2:],
                         z[:, m1:, m2:]], dim=1)
        return c.permute(1, 2, 3, 4, 0, 5).to(dt)

    cr, ci = corners(zr), corners(zi)
    wr, wi = w_real.to(dt), w_imag.to(dt)
    wmm = lambda a, w: torch.matmul(a, w).to(acc)
    outr = wmm(cr, wr) - wmm(ci, wi)                     # [4,m1,m2,m3,B,Co]
    outi = wmm(cr, wi) + wmm(ci, wr)

    def regrid(o):       # [B, 2m1, 2m2·m3·Co]
        o = o.permute(4, 0, 1, 2, 3, 5)
        top = torch.cat([o[:, 0], o[:, 2]], dim=2)       # +T rows
        bot = torch.cat([o[:, 1], o[:, 3]], dim=2)       # -T rows
        return torch.cat([top, bot], dim=1).reshape(B, 2 * m1, -1)

    gr, gi = regrid(outr), regrid(outi)
    # inverse T, then inverse H
    tr = (mm(f["itr"], gr) - mm(f["iti"], gi)).reshape(B, T, 2 * m2, -1)
    ti = (mm(f["iti"], gr) + mm(f["itr"], gi)).reshape(B, T, 2 * m2, -1)
    hr = (mm(f["ihr"], tr) - mm(f["ihi"], ti)).reshape(B, T, H, m3, Cout)
    hi = (mm(f["ihi"], tr) + mm(f["ihr"], ti)).reshape(B, T, H, m3, Cout)
    # inverse W (real output): one product against [real | imaginary] rows
    return torch.matmul(f["iw"], torch.cat([hr, hi], dim=3).to(dt))


def truncated_spectral_conv3d(x, w_real, w_imag, impl: str = "dft",
                              compute_dtype=torch.float32):
    """Public entry (JAX ``truncated_spectral_conv3d``, ``spectral.py:201-220``;
    its ``REALPDEBENCH_SPECTRAL`` switch is not carried over). ``impl``:
      * 'dft'     — ``truncated_spectral_conv3d_dft_lowp`` in
        ``compute_dtype``;
      * 'fft'     — ``truncated_spectral_conv3d_fft``;
      * 'dft_c64' — ``truncated_spectral_conv3d_dft``, the complex-matmul
        form."""
    if impl == "fft":
        return truncated_spectral_conv3d_fft(x, w_real, w_imag)
    if impl == "dft_c64":
        return truncated_spectral_conv3d_dft(x, w_real, w_imag)
    if impl == "dft":
        return truncated_spectral_conv3d_dft_lowp(x, w_real, w_imag,
                                                  compute_dtype=compute_dtype)
    raise ValueError(f"unknown spectral conv form {impl!r}")
