"""The fused FNO layer: three Hopper kernels, each beside its plain twin.

Counterpart of ``realpdebench_tpu/ops/pallas/fno_layer.py``. One FNO layer
is ``s = SpectralConv3d(z) + Conv1x1(z)`` with ``z = act(a*x + b)``, where
(a, b, act) are the previous layer's folded BatchNorm and GELU; the stored
tensor between layers is always the pre-BN ``s``. Forward:

  K1       z, then the truncated forward DFT over W and H   (csrc/fno_k1.cu)
  T-stage  forward DFT over T (Tp → 2·m1 modes)             (csrc/fno_tstage.cu)
  corner   4-corner complex channel mixing                  (torch.einsum)
  T-stage  inverse DFT over T (2·m1 → Tp)                   (csrc/fno_tstage.cu)
  K2       inverse H and W DFTs + z @ Wp + bp, BN stats     (csrc/fno_k2.cu)

Layouts (no TPU 8-row alignment; the packing is only a reshape):
  activations  [B·Tp, Hp·(Wp/2), 2C] = contiguous [B, Tp, Hp, Wp, C]
  spectra      [B·T', 2·m2·m3, 2C]: rows (j2, m), lanes (re | im, c)

``k1``, ``t_stage`` and ``k2`` route on the device of their input: a CUDA
tensor goes to the kernel (which raises on what it does not take), a CPU
tensor to the plain twin ``*_plain``. There is no fallback from one to the
other. The kernels' launch counters are ``ops.kernels.LAUNCHES``.

Source notes (what each kernel replaces, what bounds it, what its design
does about it) head each ``csrc/*.cu`` file; in short:

* K1 replaces ``_k1_kernel`` (pallas fno_layer.py:331). ~250 MB read and
  ~11 GFLOP per layer at rollout width: bound by FP32 issue on CUDA cores;
  x is read once and the H accumulators stay in registers.
* T-stage replaces ``t_stage`` (:1161; ``_tstage_mxu_kernel`` :1072,
  ``_tstage_vpu_kernel`` :1083). ~10 M elements, bandwidth bound; one pass,
  MR/MI are inputs so the adjoint kinds reuse the kernel.
* K2 replaces ``_k2_kernel`` (:393). ~270 MB read, ~250 MB written,
  ~27 GFLOP per layer: bound by shared-memory operand loads feeding FP32
  FMAs; z is recomputed from x (never stored), and the BN statistics take
  per-block partials plus a fixed-order second pass (deterministic).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.activations import gelu
from realpdebench_tpu_torch.ops.spectral import (
    _dft_factors,
    truncated_spectral_conv3d_dft,
)


def _act(u: torch.Tensor, act: str) -> torch.Tensor:
    """The activation folded at a layer's input: identity for the first
    layer, else the GELU variant (erf or tanh form)."""
    return u if act == "none" else gelu(u, act)


def _use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain twin)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no route for a tensor on {t.device}")


# ---------------------------------------------------------------------------
# DFT constants (numpy, f32), and their per-device copies
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def _ct_consts(Hp: int, Wp: int, m2: int, m3: int) -> dict:
    """Spatial DFT factors of K1 and K2 (f32 numpy):
      ewr/ewi [Wp, m3]   forward W (rfft modes), cos | -sin
      ehr/ehi [Hp, 2m2]  forward H on the kept modes
      ihr/ihi [2m2, Hp]  inverse H (1/Hp included)
      iwr/iwi [m3, Wp]   inverse W with the Hermitian weights (1/Wp included)
    """
    Ew, Eh, _Et, _It, Ih, Iw_re, Iw_im = _dft_factors(8, Hp, Wp, 2, m2, m3)
    f32 = lambda v: np.ascontiguousarray(np.asarray(v, np.float32))
    return dict(ewr=f32(Ew.real), ewi=f32(Ew.imag), ehr=f32(Eh.real),
                ehi=f32(Eh.imag), ihr=f32(Ih.real), ihi=f32(Ih.imag),
                iwr=f32(Iw_re), iwi=f32(Iw_im))


@lru_cache(maxsize=32)
def _t_consts(Tp: int, m1: int):
    """(EtR, EtI [Tp, 2m1], ItR, ItI [2m1, Tp]) f32 numpy."""
    _Ew, _Eh, Et, It, _Ih, _IwR, _IwI = _dft_factors(Tp, 8, 8, m1, 2, 2)
    f32 = lambda v: np.ascontiguousarray(v.astype(np.float32))
    return f32(Et.real), f32(Et.imag), f32(It.real), f32(It.imag)


def tstage_mats(kind: str, Tp: int, m1: int):
    """(MR, MI) [Tin, Tout] of a T-stage map: 'et' is the forward T-DFT
    (Tp → 2m1 modes), 'it' the inverse (2m1 → Tp)."""
    EtR, EtI, ItR, ItI = _t_consts(Tp, m1)
    if kind == "et":
        return EtR, EtI
    if kind == "it":
        return ItR, ItI
    raise ValueError(f"unknown T-stage kind {kind!r}")


@lru_cache(maxsize=64)
def _ct_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in _ct_consts(Hp, Wp, m2, m3).items()}


@lru_cache(maxsize=64)
def _tmats_on(device: torch.device, kind: str, Tp: int, m1: int):
    return tuple(torch.from_numpy(m).to(device)
                 for m in tstage_mats(kind, Tp, m1))


# ---------------------------------------------------------------------------
# K1: z = act(a*x + b), truncated forward (W, H) DFT
# ---------------------------------------------------------------------------


def k1_plain(x, a, b, cst, *, Hp: int, Wp: int, act: str):
    """Plain twin of K1. x [BT, Hp*Wp/2, 2C] → y [BT, 2m2*m3, 2C], f32
    math, output in x's dtype."""
    BT, C = x.shape[0], x.shape[-1] // 2
    z = _act(x.float().view(BT, Hp, Wp, C) * a + b, act)
    Xr = torch.einsum("bhwc,wm->bhmc", z, cst["ewr"])
    Xi = torch.einsum("bhwc,wm->bhmc", z, cst["ewi"])
    er, ei = cst["ehr"], cst["ehi"]
    yR = (torch.einsum("bhmc,hj->bjmc", Xr, er)
          - torch.einsum("bhmc,hj->bjmc", Xi, ei))
    yI = (torch.einsum("bhmc,hj->bjmc", Xr, ei)
          + torch.einsum("bhmc,hj->bjmc", Xi, er))
    y = torch.cat([yR, yI], dim=-1)                    # [BT, 2m2, m3, 2C]
    return y.reshape(BT, -1, 2 * C).to(x.dtype)


def k1(x, a, b, *, Hp: int, Wp: int, m2: int, m3: int, act: str):
    cst = _ct_on(x.device, Hp, Wp, m2, m3)
    if _use_kernel(x):
        return kernels.k1(x, a, b, cst["ewr"], cst["ewi"], cst["ehr"],
                          cst["ehi"], Hp=Hp, Wp=Wp, act=act)
    return k1_plain(x, a, b, cst, Hp=Hp, Wp=Wp, act=act)


# ---------------------------------------------------------------------------
# T-stage: out = MR·y + MI·swap(y) along T, swap([yr | yi]) = [-yi | yr]
# ---------------------------------------------------------------------------


def t_stage_plain(y, mr, mi):
    """Plain twin of the T-stage. y [B*Tin, Y, 2C] → [B*Tout, Y, 2C]."""
    Tin, Tout = mr.shape
    BT, Y, C2 = y.shape
    y5 = y.float().view(BT // Tin, Tin, Y, 2, C2 // 2)
    yr, yi = y5[..., 0, :], y5[..., 1, :]
    e = lambda v, M: torch.einsum("btyc,tk->bkyc", v, M)
    out_r = e(yr, mr) - e(yi, mi)
    out_i = e(yi, mr) + e(yr, mi)
    out = torch.stack([out_r, out_i], dim=3)           # [B, Tout, Y, 2, C]
    return out.reshape(-1, Y, C2).to(y.dtype)


def t_stage(y, kind: str, Tp: int, m1: int):
    mr, mi = _tmats_on(y.device, kind, Tp, m1)
    if _use_kernel(y):
        return kernels.t_stage(y, mr, mi)
    return t_stage_plain(y, mr, mi)


# ---------------------------------------------------------------------------
# K2: inverse (H, W) DFT + pointwise + bias, BN statistics
# ---------------------------------------------------------------------------


def k2_plain(g, x, a, b, wp, bp, cst, *, Hp: int, Wp: int, act: str):
    """Plain twin of K2. (g [BT, 2m2*m3, 2C], x [BT, Hp*Wp/2, 2C]) →
    (s like x, stats [2, C] f32 = per-channel (sum, sum of squares) of s
    over every padded position). f32 math, s in x's dtype."""
    BT, C = x.shape[0], x.shape[-1] // 2
    m2x2, m3 = cst["ihr"].shape[0], cst["iwr"].shape[0]
    g5 = g.float().view(BT, m2x2, m3, 2, C)
    gR, gI = g5[..., 0, :], g5[..., 1, :]
    e = lambda v, M: torch.einsum("bjmc,jh->bhmc", v, M)
    ihR = e(gR, cst["ihr"]) - e(gI, cst["ihi"])
    ihI = e(gR, cst["ihi"]) + e(gI, cst["ihr"])
    spec = (torch.einsum("bhmc,mw->bhwc", ihR, cst["iwr"])
            + torch.einsum("bhmc,mw->bhwc", ihI, cst["iwi"]))
    z = _act(x.float().view(BT, Hp, Wp, C) * a + b, act)
    s = spec + z @ wp + bp
    stats = torch.stack([s.sum(dim=(0, 1, 2)), (s * s).sum(dim=(0, 1, 2))])
    return s.reshape(x.shape).to(x.dtype), stats


def k2(g, x, a, b, wp, bp, *, Hp: int, Wp: int, m2: int, m3: int, act: str):
    cst = _ct_on(x.device, Hp, Wp, m2, m3)
    if _use_kernel(x):
        return kernels.k2(g, x, a, b, wp, bp, cst["ihr"], cst["ihi"],
                          cst["iwr"], cst["iwi"], Hp=Hp, Wp=Wp, act=act)
    return k2_plain(g, x, a, b, wp, bp, cst, Hp=Hp, Wp=Wp, act=act)


# ---------------------------------------------------------------------------
# Mid-section and the whole layer
# ---------------------------------------------------------------------------


def _pack_w2(w_real, w_imag):
    """2x2 block-complex corner weight [[wr, wi], [-wi, wr]]
    ([4, m1, m2, m3, 2Ci, 2Co]): mixes [re | im] input lanes to
    [re | im] output lanes in one product."""
    top = torch.cat([w_real, w_imag], dim=-1)
    bot = torch.cat([-w_imag, w_real], dim=-1)
    return torch.cat([top, bot], dim=-2)


def mid_spectral(y, w_real, w_imag, B: int, Tp: int):
    """Packed spectra [B*Tp, Y, 2C] → T-DFT (T-stage 'et') → corner-block
    channel mixing in the reference corner order → inverse T (T-stage 'it')
    → [B*Tp, Y, 2C]. The corner GEMM is a plain einsum in y's dtype (f32
    accumulation on the card), as JAX leaves it to XLA."""
    _, m1, m2, m3, Ci, Co = w_real.shape
    Y, C2 = y.shape[1], y.shape[2]
    z = t_stage(y, "et", Tp, m1)                       # [B*2m1, Y, 2C]
    z5 = z.view(B, 2 * m1, 2 * m2, m3, C2)
    x2 = torch.stack(
        [z5[:, :m1, :m2], z5[:, m1:, :m2], z5[:, :m1, m2:], z5[:, m1:, m2:]],
        dim=1)                                         # [B, 4, m1, m2, m3, 2C]
    w2 = _pack_w2(w_real, w_imag).to(y.dtype)
    out2 = torch.einsum("bkxyzi,kxyzio->bkxyzo", x2, w2)
    gtop = torch.cat([out2[:, 0], out2[:, 2]], dim=2)
    gbot = torch.cat([out2[:, 1], out2[:, 3]], dim=2)
    g = torch.cat([gtop, gbot], dim=1)                 # [B, 2m1, 2m2, m3, 2Co]
    return t_stage(g.reshape(B * 2 * m1, Y, 2 * Co), "it", Tp, m1)


def _check_layer_args(x, dims):
    B, Tp, Hp, Wp, C = dims
    if Wp % 2 or tuple(x.shape) != (B * Tp, Hp * (Wp // 2), 2 * C):
        raise ValueError(f"fused FNO layer: x has shape {tuple(x.shape)}, "
                         f"expected [B*Tp, Hp*(Wp/2), 2C] for dims {dims} "
                         "with an even Wp")


def fused_fno_layer(x, a, b, w_real, w_imag, wp, bp, *, dims, act: str):
    """One FNO layer on packed activations: K1 → mid_spectral → K2.

    Args:
      x: [B*Tp, Hp*(Wp/2), 2C] the previous layer's pre-BN output (or the
        zero-padded fc0 output for the first layer).
      a, b: [C] f32, the previous layer's folded BN (ones/zeros and
        act='none' for the first layer).
      w_real, w_imag: [4, m1, m2, m3, C, C] f32 corner weights.
      wp: [C, C] f32 pointwise kernel ([in, out]); bp: [C] f32.
      dims: (B, Tp, Hp, Wp, C). act: 'none' | 'exact' | 'tanh'.
    Returns (s like x, stats [2, C] f32 per-channel sum and sum of squares).
    """
    _check_layer_args(x, dims)
    B, Tp, Hp, Wp, C = dims
    m2, m3 = w_real.shape[2], w_real.shape[3]
    y = k1(x, a, b, Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    g = mid_spectral(y, w_real, w_imag, B, Tp)
    return k2(g, x, a, b, wp, bp, Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)


def reference_fused_fno_layer(x, a, b, w_real, w_imag, wp, bp, *, dims,
                              act: str):
    """Plain oracle of the fused layer, independent of the kernels' DFT
    factorisation: ``truncated_spectral_conv3d_dft`` on the unpacked
    [B, Tp, Hp, Wp, C] layout, all in f32. Same signature and returns as
    ``fused_fno_layer``."""
    _check_layer_args(x, dims)
    B, Tp, Hp, Wp, C = dims
    z5 = _act(x.float().view(B, Tp, Hp, Wp, C) * a + b, act)
    s5 = (truncated_spectral_conv3d_dft(z5, w_real, w_imag)
          + z5 @ wp.float() + bp)
    stats = torch.stack([s5.sum(dim=(0, 1, 2, 3)),
                         (s5 * s5).sum(dim=(0, 1, 2, 3))])
    return s5.reshape(x.shape).to(x.dtype), stats
