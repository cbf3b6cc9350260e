"""Level-1 3-D discrete wavelet transform (zero mode), in plain PyTorch.

Counterpart of ``realpdebench_tpu/ops/wavelet.py`` (the functional spec of
``ptwt.wavedec3`` / ``waverec3`` with ``mode='zero'``, ``level=1``, as WDNO
uses them). Per axis, with a length-L filter pair:

    forward : y = full_conv(x, dec_filter)[1::2]           (len ⌊(n+L−1)/2⌋)
    inverse : z = full_conv(upsample2(a), rec_lo)
                + full_conv(upsample2(d), rec_hi),
              trimmed by (L−2) on each side                (len 2·la−L+2)

The packed tensor's subbands come in the order [aaa, aad, ada, add, daa,
dad, dda, ddd] over the axis triple (-3, -2, -1), the approximation first.

No TPU kernel stands behind this: the JAX package leaves it to XLA as
plain convolutions. Here each 1-D pass is a sum of L shifted, strided
slices (L is 2 or 6), so it runs on any device in the input's dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_SQ2 = 1.0 / np.sqrt(2.0)

# filter banks (dec_lo, dec_hi, rec_lo, rec_hi), pywt coefficient conventions
WAVELETS: Dict[str, Tuple[list, list, list, list]] = {
    # bior1.1 == haar (up to naming)
    "bior1.1": ([_SQ2, _SQ2], [-_SQ2, _SQ2], [_SQ2, _SQ2], [_SQ2, -_SQ2]),
    "haar": ([_SQ2, _SQ2], [-_SQ2, _SQ2], [_SQ2, _SQ2], [_SQ2, -_SQ2]),
    "db1": ([_SQ2, _SQ2], [-_SQ2, _SQ2], [_SQ2, _SQ2], [_SQ2, -_SQ2]),
    "bior1.3": (
        [-0.08838834764831845, 0.08838834764831845, _SQ2, _SQ2,
         0.08838834764831845, -0.08838834764831845],
        [0.0, 0.0, -_SQ2, _SQ2, 0.0, 0.0],
        [0.0, 0.0, _SQ2, _SQ2, 0.0, 0.0],
        [-0.08838834764831845, -0.08838834764831845, _SQ2, -_SQ2,
         0.08838834764831845, 0.08838834764831845],
    ),
}

SUBBAND_KEYS = ("aad", "ada", "add", "daa", "dad", "dda", "ddd")
ORDER = ("aaa",) + SUBBAND_KEYS


def dec_len(name: str) -> int:
    return len(WAVELETS[name][0])


def coef_len(n: int, name: str) -> int:
    return (n + dec_len(name) - 1) // 2


def rec_len(la: int, name: str) -> int:
    return 2 * la - dec_len(name) + 2


def _filters(name: str, which: slice):
    """The bank's filters as float32 host values (the JAX package casts
    them to float32 before use)."""
    return [np.asarray(f, np.float32) for f in WAVELETS[name][which]]


def _correlate(xp: torch.Tensor, f: np.ndarray, n_out: int, start: int = 0,
               step: int = 1) -> torch.Tensor:
    """Σ_l f[l]·xp[..., start + step·i + l] for i < n_out: a correlation of
    the last axis with ``f``, every ``step``-th output from ``start``."""
    out = None
    for l, w in enumerate(f.tolist()):
        s = start + l
        term = xp[..., s:s + step * (n_out - 1) + 1:step] * w
        out = term if out is None else out + term
    return out


def _dwt_axis(x: torch.Tensor, lo: np.ndarray, hi: np.ndarray, axis: int):
    """One axis's DWT: full convolution, then the odd outputs."""
    x = x.movedim(axis, -1)
    L, n = lo.shape[0], x.shape[-1]
    xp = F.pad(x, (L - 1, L - 1))
    n_c = (n + L - 1) // 2
    # full convolution == correlation with the reversed filter; [1::2]
    a = _correlate(xp, lo[::-1], n_c, start=1, step=2)
    d = _correlate(xp, hi[::-1], n_c, start=1, step=2)
    return a.movedim(-1, axis), d.movedim(-1, axis)


def _idwt_axis(a: torch.Tensor, d: torch.Tensor, lo: np.ndarray, hi: np.ndarray,
               axis: int) -> torch.Tensor:
    """One axis's inverse DWT (zero mode)."""
    a, d = a.movedim(axis, -1), d.movedim(axis, -1)
    L, la = lo.shape[0], a.shape[-1]

    def fullconv(z, f):
        up = z.new_zeros(*z.shape[:-1], 2 * la - 1)     # [..., la] → [..., 2·la−1]
        up[..., ::2] = z
        return _correlate(F.pad(up, (L - 1, L - 1)), f[::-1], 2 * la + L - 2)

    y = fullconv(a, lo) + fullconv(d, hi)
    trim = L - 2
    if trim > 0:
        y = y[..., trim:-trim]
    return y.movedim(-1, axis)


def wavedec3_level1(x: torch.Tensor, name: str) -> torch.Tensor:
    """x: [..., D, H, W] → packed coefficients [..., 8, D', H', W'].

    Band 0 is the approximation; bands 1..7 follow SUBBAND_KEYS order."""
    lo, hi = _filters(name, slice(0, 2))
    aD, dD = _dwt_axis(x, lo, hi, -3)
    bands = {}
    for nm, zD in (("a", aD), ("d", dD)):
        aH, dH = _dwt_axis(zD, lo, hi, -2)
        for nm2, zH in (("a", aH), ("d", dH)):
            aW, dW = _dwt_axis(zH, lo, hi, -1)
            bands[nm + nm2 + "a"] = aW
            bands[nm + nm2 + "d"] = dW
    return torch.stack([bands[k] for k in ORDER], dim=-4)


def waverec3_level1(coefs: torch.Tensor, name: str) -> torch.Tensor:
    """Inverse of wavedec3_level1. coefs: [..., 8, D', H', W'] →
    [..., D'', H'', W''] with D'' = 2·D'−L+2 (may exceed the original n;
    callers slice). Inverts W, then H, then D."""
    lo, hi = _filters(name, slice(2, 4))
    bands = {k: coefs[..., i, :, :, :] for i, k in enumerate(ORDER)}
    lvl2 = {p: _idwt_axis(bands[p + "a"], bands[p + "d"], lo, hi, -1)
            for p in ("aa", "ad", "da", "dd")}
    lvl1 = {p: _idwt_axis(lvl2[p + "a"], lvl2[p + "d"], lo, hi, -2) for p in ("a", "d")}
    return _idwt_axis(lvl1["a"], lvl1["d"], lo, hi, -3)
