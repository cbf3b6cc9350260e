"""The fused FNO layer: Hopper kernels, each beside its plain twin.

Counterpart of ``realpdebench_tpu/ops/pallas/fno_layer.py``. One FNO layer
is ``s = SpectralConv3d(z) + Conv1x1(z)`` with ``z = act(a*x + b)``, where
(a, b, act) are the previous layer's folded BatchNorm and GELU; the stored
tensor between layers is always the pre-BN ``s``. Forward:

  K1       z, then the truncated forward DFT over W and H   (csrc/fno_k1.cu;
           bf16: on the tensor cores, csrc/fno_dft_mma.cuh; f32: as
           3xTF32, csrc/fno_dft_tf32.cuh)
  T-stage  forward DFT over T (Tp → 2·m1 modes)             (csrc/fno_tstage.cu)
  corner   4-corner complex channel mixing                  (torch.einsum)
  T-stage  inverse DFT over T (2·m1 → Tp)                   (csrc/fno_tstage.cu)
  K2       inverse H and W DFTs + z @ Wp + bp, BN stats     (csrc/fno_k2.cu;
           bf16: on the tensor cores, csrc/mma.cuh; f32: on the
           tensor cores as 3xTF32, csrc/fno_tf32.cuh)

Backward (``fused_fno_layer`` is one autograd function):

  K2A-lite dg = A(ds) + ds1·A1 + 2·ds2·A(s), A(s) from g, y (csrc/fno_k2a.cu;
           bf16 and f32: K1's tensor-core bodies, csrc/fno_dft_mma.cuh
           and csrc/fno_dft_tf32.cuh)
           (K2A, the full-read form, for a geometry the lite fit rejects)
  T-stage  adjoint of the inverse T (it_adj)                (csrc/fno_tstage.cu)
  corner   dx2, dwr, dwi                                    (torch.einsum)
  T-stage  adjoint of the forward T (et_adj)                (csrc/fno_tstage.cu)
  K12B     dx through both consumers of z; dWp, da, db, dbp (csrc/fno_k12b.cu;
           bf16: on the tensor cores; f32: as 3xTF32)

Layouts (no TPU 8-row alignment; the packing is only a reshape):
  activations  [B·Tp, Hp·(Wp/2), 2C] = contiguous [B, Tp, Hp, Wp, C]
  spectra      [B·T', 2·m2·m3, 2C]: rows (j2, m), lanes (re | im, c)

Each kernel routes on the device of its input: a CUDA tensor goes to the
kernel (which raises on what it does not take), a CPU tensor to the plain
twin ``*_plain``. There is no fallback from one to the other. The kernels'
launch counters are ``ops.kernels.LAUNCHES``. Source notes (what each kernel
replaces, what bounds it, what its design does about it) head each
``csrc/*.cu`` file.
"""

from __future__ import annotations

import warnings
from functools import lru_cache

import numpy as np
import torch

from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.activations import gelu, gelu_grad
from realpdebench_tpu_torch.ops.spectral import (
    _dft_factors,
    truncated_spectral_conv3d_dft,
)


def _act(u: torch.Tensor, act: str) -> torch.Tensor:
    """The activation folded at a layer's input: identity for the first
    layer, else the GELU variant (erf or tanh form)."""
    return u if act == "none" else gelu(u, act)


def _act_grad(u: torch.Tensor, act: str) -> torch.Tensor:
    return torch.ones_like(u) if act == "none" else gelu_grad(u, act)


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
    K2A contracts against the inverse factors (the adjoint of K2's map),
    K12B against the forward ones (the adjoint of K1's map).
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


# the T-stage map whose matrices are the adjoint of each kind's
_TSTAGE_ADJ = {"et": "et_adj", "it": "it_adj", "et_adj": "et", "it_adj": "it"}


def tstage_mats(kind: str, Tp: int, m1: int):
    """(MR, MI) [Tin, Tout] of a T-stage map: 'et' is the forward T-DFT
    (Tp → 2m1 modes), 'it' the inverse (2m1 → Tp), and '*_adj' their
    adjoints (MRᵀ, −MIᵀ): the lane swap S has Sᵀ = −S, so the adjoint of
    MR·y + MI·S(y) is MRᵀ·u − MIᵀ·S(u)."""
    EtR, EtI, ItR, ItI = _t_consts(Tp, m1)
    mats = {"et": (EtR, EtI), "it": (ItR, ItI),
            "et_adj": (EtR.T, -EtI.T), "it_adj": (ItR.T, -ItI.T)}
    if kind not in mats:
        raise ValueError(f"unknown T-stage kind {kind!r}")
    return tuple(np.ascontiguousarray(m) for m in mats[kind])


@lru_cache(maxsize=64)
def _ct_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int) -> dict:
    return {k: torch.from_numpy(v).to(device)
            for k, v in _ct_consts(Hp, Wp, m2, m3).items()}


def _h_table(re, im, rows: int, kmult: int = 16):
    """The A operand of a tensor-core H stage for blocks of ``rows`` rows of
    H, from the rows' coefficients re, im [Hp, K]: [ceil(Hp/R), 16, Kpad]
    f32, row r of a block gives the real part of row h = R·ch + r, row 8 + r
    its imaginary part, K padded with zeros to a multiple of ``kmult`` (16,
    the bf16 MMA's depth; 8, the tf32 MMA's); rows r ≥ R and rows of h ≥ Hp
    zero."""
    Hp, K = re.shape
    nch, kpad = -(-Hp // rows), -(-K // kmult) * kmult
    ah = torch.zeros(nch * rows, 2, kpad)
    ah[:Hp, 0, :K], ah[:Hp, 1, :K] = re, im
    return torch.nn.functional.pad(ah.view(nch, rows, 2, kpad).transpose(1, 2),
                                   (0, 0, 0, 8 - rows)).reshape(nch, 16, kpad)


def _w_table(wr, wi):
    """The A operand of a tensor-core W product, from wr, wi [Wp, m3]:
    [ceil(Wp/16)·16, 2·m3] f32, row w = [wr[w] | wi[w]], rows ≥ Wp zero."""
    Wp, m3 = wr.shape
    w = torch.zeros(-(-Wp // 16) * 16, 2 * m3)
    w[:Wp, :m3], w[:Wp, m3:] = wr, wi
    return w


def _k2_mma_tables(Hp: int, Wp: int, m2: int, m3: int, rows: int):
    """The DFT constants of K2's tensor-core variant in the layout its MMA
    A operands want, each as a bfloat16 (hi, lo) pair on axis 0
    (``kernels.split_bf16``), CPU tensors:

      ah [2, ceil(Hp/R), 16, Kpad]  inverse H for a block of R = ``rows`` (the
          kernel's rows per block at this width, kernels.K2_MMA_ROWS) rows
          h = R·ch + r, k = (re | im, j) padded with zeros to a multiple
          of 16: row r gives Re ih[h] = Σ_j gr·ihr − gi·ihi
          ([ihr[:, h] | −ihi[:, h]]), row 8 + r gives Im ih[h]
          ([ihi[:, h] | ihr[:, h]]); rows r ≥ R and rows of h ≥ Hp are zero.
      iw [2, ceil(Wp/16)·16, 2·m3]  inverse W: row w is [iwr[:, w] | iwi[:, w]],
          rows w ≥ Wp zero.
    """
    c = {k: torch.from_numpy(v) for k, v in _ct_consts(Hp, Wp, m2, m3).items()}
    ihr, ihi = c["ihr"].t(), c["ihi"].t()
    ah = _h_table(torch.cat([ihr, -ihi], 1), torch.cat([ihi, ihr], 1), rows)
    iw = _w_table(c["iwr"].t(), c["iwi"].t())
    return tuple(torch.stack(kernels.split_bf16(t)).contiguous() for t in (ah, iw))


def _k2_tf32_tables(Hp: int, Wp: int, m2: int, m3: int, rows: int):
    """The DFT constants of K2's tf32 variant, f32 CPU tensors in the layouts
    of ``_k2_mma_tables`` (unsplit: the kernel splits each fragment into its
    tf32 pair in registers), ah's k padded to a multiple of 8:

      ah [ceil(Hp/R), 16, Kpad]   inverse H for blocks of R = ``rows`` rows.
      iw [ceil(Wp/16)·16, 2·m3]   inverse W: row w is [iwr[:, w] | iwi[:, w]].
    """
    c = {k: torch.from_numpy(v) for k, v in _ct_consts(Hp, Wp, m2, m3).items()}
    ihr, ihi = c["ihr"].t(), c["ihi"].t()
    return (_h_table(torch.cat([ihr, -ihi], 1), torch.cat([ihi, ihr], 1), rows, 8).contiguous(),
            _w_table(c["iwr"].t(), c["iwi"].t()).contiguous())


def _k12b_tf32_tables(Hp: int, Wp: int, m2: int, m3: int, rows: int):
    """The DFT constants of K12B's tf32 variant, f32 CPU tensors in the
    layouts of ``_k12b_mma_tables`` (unsplit), ah's k padded to a multiple
    of 8: ah the adjoint of K1's forward H DFT, ew that of its forward W
    DFT (row w is [ewr[w] | ewi[w]])."""
    c = {k: torch.from_numpy(v) for k, v in _ct_consts(Hp, Wp, m2, m3).items()}
    ehr, ehi = c["ehr"], c["ehi"]
    return (_h_table(torch.cat([ehr, ehi], 1), torch.cat([-ehi, ehr], 1), rows, 8).contiguous(),
            _w_table(c["ewr"], c["ewi"]).contiguous())


@lru_cache(maxsize=64)
def _k2_tf32_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int, rows: int):
    return tuple(t.to(device) for t in _k2_tf32_tables(Hp, Wp, m2, m3, rows))


@lru_cache(maxsize=64)
def _k12b_tf32_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int, rows: int):
    return tuple(t.to(device) for t in _k12b_tf32_tables(Hp, Wp, m2, m3, rows))


def _k12b_mma_tables(Hp: int, Wp: int, m2: int, m3: int, rows: int):
    """The DFT constants of K12B's tensor-core variant, as bfloat16 (hi, lo)
    pairs on axis 0, CPU tensors, in the layouts of ``_k2_mma_tables``:

      ah [2, ceil(Hp/R), 16, Kpad]  the adjoint of K1's forward H DFT: row r
          gives Re dX[h] = Σ_j dyR·ehr + dyI·ehi ([ehr[h] | ehi[h]]), row
          8 + r gives Im dX[h] = Σ_j dyI·ehr − dyR·ehi ([−ehi[h] | ehr[h]]).
      ew [2, ceil(Wp/16)·16, 2·m3]  the adjoint of K1's forward W DFT: row w
          is [ewr[w] | ewi[w]].
    """
    c = {k: torch.from_numpy(v) for k, v in _ct_consts(Hp, Wp, m2, m3).items()}
    ehr, ehi = c["ehr"], c["ehi"]
    ah = _h_table(torch.cat([ehr, ehi], 1), torch.cat([-ehi, ehr], 1), rows)
    ew = _w_table(c["ewr"], c["ewi"])
    return tuple(torch.stack(kernels.split_bf16(t)).contiguous() for t in (ah, ew))


@lru_cache(maxsize=64)
def _k2_mma_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int, rows: int):
    return tuple(t.to(device) for t in _k2_mma_tables(Hp, Wp, m2, m3, rows))


def _wh_mma_tables(wr, wi, hr, hi, dtype):
    """The two tables of the tensor-core (W, H) DFT body (csrc/fno_dft_mma.cuh)
    for the map X[h, m] = Σ_w (wr | wi)[w, m]·v[h, w], then
    Y_j = Σ_h (hr + i·hi)[h, j]·(X_re + i·X_im)[h], from wr, wi [Wp, m3] and
    hr, hi [Hp, 2m2], in ``dtype``, CPU tensors:

      ew [2·m3, KW]  KW = Wp rounded up to 16: row m is wr[:, m], row m3 + m
          is wi[:, m]; columns w ≥ Wp zero.
      eh [ceil(Hp/8), R, 16]  for a chunk of 8 rows h = 8·ch + r,
          R = 2·(2m2) rounded up to 16: row j gives Re Y_j from
          k = (re | im, r) as [hr[h, j] | −hi[h, j]], row 2m2 + j gives
          Im Y_j as [hi[h, j] | hr[h, j]]; rows ≥ 2·(2m2) and rows of
          h ≥ Hp zero.
    """
    (Wp, m3), (Hp, m2x2), rows = wr.shape, hr.shape, kernels.K1_MMA_ROWS
    ew = torch.zeros(2 * m3, -(-Wp // 16) * 16)
    ew[:m3, :Wp], ew[m3:, :Wp] = wr.t(), wi.t()
    nch = -(-Hp // rows)
    ehr = torch.zeros(nch * rows, m2x2)
    ehi = torch.zeros(nch * rows, m2x2)
    ehr[:Hp], ehi[:Hp] = hr, hi
    ehr, ehi = (t.view(nch, rows, m2x2).transpose(1, 2) for t in (ehr, ehi))  # [nch, j, r]
    eh = torch.zeros(nch, -(-2 * m2x2 // 16) * 16, 2 * rows)
    eh[:, :m2x2, :rows], eh[:, :m2x2, rows:] = ehr, -ehi
    eh[:, m2x2:2 * m2x2, :rows], eh[:, m2x2:2 * m2x2, rows:] = ehi, ehr
    return ew.to(dtype).contiguous(), eh.to(dtype).contiguous()


def _k1_mma_tables(Hp: int, Wp: int, m2: int, m3: int, dtype=torch.bfloat16):
    """The DFT constants of K1's tensor-core variants in the layout of their
    MMA A operands (``_wh_mma_tables`` of the forward factors ewr, ewi, ehr,
    ehi), bfloat16 for the mma variant (one rounding, as JAX's ``_dot``
    rounds its operands); float32, unrounded, for the tf32 variant, which
    splits them into tf32 pairs itself."""
    c = {k: torch.from_numpy(v) for k, v in _ct_consts(Hp, Wp, m2, m3).items()}
    return _wh_mma_tables(c["ewr"], c["ewi"], c["ehr"], c["ehi"], dtype)


def _k2a_mma_tables(Hp: int, Wp: int, m2: int, m3: int, dtype=torch.bfloat16):
    """The DFT constants of K2A-lite's tensor-core variants: the adjoint A of
    K2's inverse DFT in K1's layout (``_wh_mma_tables``), bfloat16 for the
    mma variant, float32 for the tf32 one. Its W product reads the inverse
    factors (row m of iw is iwr[m], row m3 + m is iwi[m]); its H fold
    carries the adjoint's signs,
    Re dg_j = Σ_h ihr[j, h]·dR + ihi[j, h]·dI and
    Im dg_j = Σ_h ihr[j, h]·dI − ihi[j, h]·dR, which is K1's fold with
    hr = ihrᵀ and hi = −ihiᵀ."""
    c = {k: torch.from_numpy(v) for k, v in _ct_consts(Hp, Wp, m2, m3).items()}
    return _wh_mma_tables(c["iwr"].t(), c["iwi"].t(), c["ihr"].t(), -c["ihi"].t(), dtype)


@lru_cache(maxsize=64)
def _k1_tables_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int, variant: str):
    return tuple(t.to(device) for t in _k1_mma_tables(Hp, Wp, m2, m3,
                                                           kernels._TC_DTYPES[variant]))


@lru_cache(maxsize=64)
def _k2a_tables_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int, variant: str):
    return tuple(t.to(device) for t in _k2a_mma_tables(Hp, Wp, m2, m3,
                                                            kernels._TC_DTYPES[variant]))


@lru_cache(maxsize=64)
def _k12b_mma_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int, rows: int):
    return tuple(t.to(device) for t in _k12b_mma_tables(Hp, Wp, m2, m3, rows))


@lru_cache(maxsize=64)
def _tmats_on(device: torch.device, kind: str, Tp: int, m1: int):
    return tuple(torch.from_numpy(m).to(device)
                 for m in tstage_mats(kind, Tp, m1))


# ---------------------------------------------------------------------------
# K2A-lite statics: A(s) from the mode-space residuals g and y
# ---------------------------------------------------------------------------


def _np_mirrors(Hp: int, Wp: int, m2: int, m3: int):
    """Numpy (f64) mirrors of the three spatial <-> mode maps, channel-wise
    with a trailing batch axis n: spatial fields [Hp, Wp, n], mode fields
    [Y, 2, n] (rows (j2, m), then re | im).

      F  K1's truncated forward (W, H) DFT
      V  K2's inverse (H, W) DFT
      A  K2A's map, the adjoint of V
    """
    c = {k: v.astype(np.float64) for k, v in _ct_consts(Hp, Wp, m2, m3).items()}
    Y = 2 * m2 * m3
    e = np.einsum

    def F(z):
        Xr, Xi = e("hwn,wm->hmn", z, c["ewr"]), e("hwn,wm->hmn", z, c["ewi"])
        yR = e("hmn,hj->jmn", Xr, c["ehr"]) - e("hmn,hj->jmn", Xi, c["ehi"])
        yI = e("hmn,hj->jmn", Xr, c["ehi"]) + e("hmn,hj->jmn", Xi, c["ehr"])
        return np.stack([yR, yI], axis=2).reshape(Y, 2, -1)

    def V(g):
        g4 = g.reshape(2 * m2, m3, 2, -1)
        gR, gI = g4[:, :, 0], g4[:, :, 1]
        ihR = e("jmn,jh->hmn", gR, c["ihr"]) - e("jmn,jh->hmn", gI, c["ihi"])
        ihI = e("jmn,jh->hmn", gR, c["ihi"]) + e("jmn,jh->hmn", gI, c["ihr"])
        return e("hmn,mw->hwn", ihR, c["iwr"]) + e("hmn,mw->hwn", ihI, c["iwi"])

    def A(d):
        dR, dI = e("hwn,mw->hmn", d, c["iwr"]), e("hwn,mw->hmn", d, c["iwi"])
        gR = e("hmn,jh->jmn", dR, c["ihr"]) + e("hmn,jh->jmn", dI, c["ihi"])
        gI = e("hmn,jh->jmn", dI, c["ihr"]) - e("hmn,jh->jmn", dR, c["ihi"])
        return np.stack([gR, gI], axis=2).reshape(Y, 2, -1)

    return F, V, A


def _kh_mirror(m2: int, m3: int) -> np.ndarray:
    """Row index of each mode row's kh mirror: j2 ↦ (2m2 − j2) mod 2m2 at
    the same m (the kept kh list is 0..m2−1, Hp−m2..Hp−1)."""
    j2 = np.arange(2 * m2)
    mir = (2 * m2 - j2) % (2 * m2)
    return (mir[:, None] * m3 + np.arange(m3)[None, :]).reshape(-1)


@lru_cache(maxsize=32)
def _lite_consts(Hp: int, Wp: int, m2: int, m3: int) -> dict:
    """K2A-lite statics from the port's own DFT factors (JAX
    ``_lite_consts``, ``ops/pallas/fno_layer.py:221-289``). With
    s = V g + z @ Wp + bp and A the channel-wise adjoint of V,

        A(s) = M g + D * (F z) @ Wp + bp * A1 = M g + D * y @ Wp + bp * A1

    (y is K1's saved output), so dg = A(ds + ds1 + 2 ds2 s) becomes
    A(ds) + ds1·A1 + 2 ds2·A(s) with no read of s. M = A·V couples only
    kh-mirror pairs at the same (m, re|im): M g = alpha·g + beta·g[mirror].
    Returns f32 [Y, 2] arrays alpha, beta, D, A1. Raises AssertionError
    when A ≠ diag(D)·F or M is not of that form (residual checks)."""
    F, V, A = _np_mirrors(Hp, Wp, m2, m3)
    Y = 2 * m2 * m3
    rng = np.random.default_rng(12345)
    p = rng.normal(size=(Hp, Wp, 3))
    u, v = A(p), F(p)
    den = v[..., 0] ** 2 + v[..., 1] ** 2
    num = u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1]
    D = np.where(den > 1e-20, num / np.maximum(den, 1e-20), 0.0)
    resid = np.abs(u[..., 2] - D * v[..., 2]).max() / (np.abs(u[..., 2]).max()
                                                       + 1e-30)
    if resid > 1e-4:
        raise AssertionError(
            f"K2A-lite: A != diag(D) F at (Hp={Hp}, Wp={Wp}, m2={m2}, "
            f"m3={m3}); residual {resid:.2e}")
    M4 = A(V(np.eye(2 * Y).reshape(Y, 2, 2 * Y))).reshape(Y, 2, Y, 2)
    A1 = A(np.ones((Hp, Wp, 1)))[..., 0]
    rows, mir = np.arange(Y), _kh_mirror(m2, m3)
    alpha = np.stack([M4[rows, r, rows, r] for r in range(2)], axis=1)
    beta = np.stack([np.where(mir != rows, M4[rows, r, mir, r], 0.0)
                     for r in range(2)], axis=1)
    M_rec = np.zeros_like(M4)
    for r in range(2):
        M_rec[rows, r, rows, r] += alpha[:, r]
        M_rec[rows, r, mir, r] += beta[:, r]
    mres = np.abs(M_rec - M4).max() / (np.abs(M4).max() + 1e-30)
    if mres > 1e-5:
        raise AssertionError(
            f"K2A-lite: M is not (alpha, beta, kh-mirror)-structured at "
            f"(Hp={Hp}, Wp={Wp}, m2={m2}, m3={m3}); residual {mres:.2e}")
    f32 = lambda a: np.ascontiguousarray(a.astype(np.float32))
    return dict(alpha=f32(alpha), beta=f32(beta), D=f32(D), A1=f32(A1))


@lru_cache(maxsize=32)
def _lite_or_none(Hp: int, Wp: int, m2: int, m3: int):
    """The lite statics, or None (with one UserWarning per geometry) when
    the structure fit rejects the geometry: the layer then runs the
    full-read K2A, as JAX does (``ops/pallas/fno_layer.py:914-924``)."""
    try:
        return _lite_consts(Hp, Wp, m2, m3)
    except AssertionError as e:
        warnings.warn(f"K2A-lite disabled for this geometry: {e}")
        return None


@lru_cache(maxsize=64)
def _lite_on(device: torch.device, Hp: int, Wp: int, m2: int, m3: int):
    lite = _lite_or_none(Hp, Wp, m2, m3)
    if lite is None:
        return None
    return {k: torch.from_numpy(v).to(device) for k, v in lite.items()}


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


def k1(x, a, b, *, Hp: int, Wp: int, m2: int, m3: int, act: str,
       variant=None):
    """On the card, the variant ``kernels.k1_variant`` chooses from dtype,
    shape and alignment (or the one named): the DFT tables go with the mma
    (bfloat16) and tf32 (float32) variants."""
    cst = _ct_on(x.device, Hp, Wp, m2, m3)
    if _use_kernel(x):
        name = variant or kernels.k1_variant(x.dtype, x.shape[-1] // 2, 2 * m2, m3,
                                             Wp, kernels.aligned(x))
        tables = (_k1_tables_on(x.device, Hp, Wp, m2, m3, name) if name in kernels._TC_DTYPES
                  else None)
        return kernels.k1(x, a, b, cst["ewr"], cst["ewi"], cst["ehr"],
                          cst["ehi"], Hp=Hp, Wp=Wp, act=act, tables=tables,
                          variant=variant)
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


def _t_stage_apply(y, kind: str, Tp: int, m1: int):
    mr, mi = _tmats_on(y.device, kind, Tp, m1)
    if _use_kernel(y):
        return kernels.t_stage(y, mr, mi)
    return t_stage_plain(y, mr, mi)


class _TStage(torch.autograd.Function):
    """The T-stage as a linear map: its backward is the same kernel with
    the adjoint matrices (JAX ``_t_stage_bwd``, ``fno_layer.py:1177``)."""

    @staticmethod
    def forward(ctx, y, kind, Tp, m1):
        ctx.meta = (kind, Tp, m1)
        return _t_stage_apply(y, kind, Tp, m1)

    @staticmethod
    def backward(ctx, dout):
        kind, Tp, m1 = ctx.meta
        return (_t_stage_apply(dout.contiguous(), _TSTAGE_ADJ[kind], Tp, m1),
                None, None, None)


def t_stage(y, kind: str, Tp: int, m1: int):
    """y [B*Tin, Y, 2C] → [B*Tout, Y, 2C] by the map ``kind`` (see
    ``tstage_mats``); differentiable."""
    return _TStage.apply(y, kind, Tp, m1)


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


_K2_TABLES = {"mma": _k2_mma_on, "tf32": _k2_tf32_on}
_K12B_TABLES = {"mma": _k12b_mma_on, "tf32": _k12b_tf32_on}


def k2(g, x, a, b, wp, bp, *, Hp: int, Wp: int, m2: int, m3: int, act: str,
       variant=None):
    """On the card, the variant ``kernels.k2_variant`` chooses from dtype and
    shape (or the one named): the packed tables go with the mma and tf32
    variants."""
    cst = _ct_on(x.device, Hp, Wp, m2, m3)
    if _use_kernel(x):
        C = x.shape[-1] // 2
        name = variant or kernels.k2_variant(x.dtype, C, m3, Wp, 2 * m2,
                                             kernels.aligned(g, x, wp))
        tables = (_K2_TABLES[name](x.device, Hp, Wp, m2, m3, kernels.K2_MMA_ROWS[C])
                  if name in _K2_TABLES and C in kernels.K2_MMA_ROWS else None)
        return kernels.k2(g, x, a, b, wp, bp, cst["ihr"], cst["ihi"],
                          cst["iwr"], cst["iwi"], Hp=Hp, Wp=Wp, act=act,
                          tables=tables, variant=variant)
    return k2_plain(g, x, a, b, wp, bp, cst, Hp=Hp, Wp=Wp, act=act)


# ---------------------------------------------------------------------------
# K2A / K2A-lite: the spectral cotangent dg
# ---------------------------------------------------------------------------


def _adjoint_inverse(d, cst):
    """A, the adjoint of K2's inverse (H, W) DFT, channel-wise:
    d [BT, Hp, Wp, C] f32 → [BT, 2m2*m3, 2C] f32."""
    BT, C = d.shape[0], d.shape[-1]
    dR = torch.einsum("bhwc,mw->bhmc", d, cst["iwr"])
    dI = torch.einsum("bhwc,mw->bhmc", d, cst["iwi"])
    e = lambda v, M: torch.einsum("bhmc,jh->bjmc", v, M)
    gR = e(dR, cst["ihr"]) + e(dI, cst["ihi"])
    gI = e(dI, cst["ihr"]) - e(dR, cst["ihi"])
    return torch.cat([gR, gI], dim=-1).reshape(BT, -1, 2 * C)


def k2a_plain(s, ds, ds1, ds2, cst, *, Hp: int, Wp: int):
    """Plain twin of K2A: dg = A(ds + ds1 + 2·ds2·s), reading s and ds
    [BT, Hp*Wp/2, 2C]; ds1, ds2 [C] f32 are the cotangents of the BN
    statistics (sum, sum of squares). dg [BT, 2m2*m3, 2C] in ds's dtype."""
    BT, C = ds.shape[0], ds.shape[-1] // 2
    v = lambda t: t.float().view(BT, Hp, Wp, C)
    d = v(ds) + ds1 + 2.0 * ds2 * v(s)
    return _adjoint_inverse(d, cst).to(ds.dtype)


def k2a_lite_plain(ds, g, y, ds1, ds2, wp, bp, lite, cst, *, Hp: int,
                   Wp: int):
    """Plain twin of K2A-lite: the same dg as K2A without reading s,
    dg = A(ds) + ds1·A1 + 2·ds2·(M g + D·y @ Wp + bp·A1), from the saved
    spectra g (the layer's mode-space output) and y (K1's output).
    ``lite`` holds the [Y, 2] statics of ``_lite_consts``."""
    BT, C = ds.shape[0], ds.shape[-1] // 2
    Y = g.shape[1]
    m3 = cst["iwr"].shape[0]
    dg = _adjoint_inverse(ds.float().view(BT, Hp, Wp, C), cst).view(BT, Y, 2, C)
    g4 = g.float().view(BT, Y, 2, C)
    mir = torch.from_numpy(_kh_mirror(Y // (2 * m3), m3)).to(g.device)
    col = lambda k: lite[k][..., None]                  # [Y, 2, 1]
    As = (col("alpha") * g4 + col("beta") * g4[:, mir]
          + (col("D") * y.float().view(BT, Y, 2, C)) @ wp + bp * col("A1"))
    dg = dg + ds1 * col("A1") + 2.0 * ds2 * As
    return dg.reshape(BT, Y, 2 * C).to(ds.dtype)


def k2a(s, ds, ds1, ds2, *, Hp: int, Wp: int, m2: int, m3: int):
    cst = _ct_on(ds.device, Hp, Wp, m2, m3)
    if _use_kernel(ds):
        return kernels.k2a(s, ds, ds1, ds2, cst["ihr"], cst["ihi"], cst["iwr"],
                           cst["iwi"], Hp=Hp, Wp=Wp)
    return k2a_plain(s, ds, ds1, ds2, cst, Hp=Hp, Wp=Wp)


def k2a_lite(ds, g, y, ds1, ds2, wp, bp, *, Hp: int, Wp: int, m2: int,
             m3: int, variant=None):
    """Raises ValueError for a geometry without lite statics. On the card,
    the variant ``kernels.k2a_lite_variant`` chooses from dtype, shape and
    alignment (or the one named): the DFT tables go with the mma (bfloat16)
    and tf32 (float32) variants."""
    cst = _ct_on(ds.device, Hp, Wp, m2, m3)
    lite = _lite_on(ds.device, Hp, Wp, m2, m3)
    if lite is None:
        raise ValueError(f"no K2A-lite statics for (Hp={Hp}, Wp={Wp}, "
                         f"m2={m2}, m3={m3}); use k2a")
    if _use_kernel(ds):
        name = variant or kernels.k2a_lite_variant(ds.dtype, ds.shape[-1] // 2, 2 * m2, m3,
                                                   Wp, kernels.aligned(ds, g, y))
        tables = (_k2a_tables_on(ds.device, Hp, Wp, m2, m3, name) if name in kernels._TC_DTYPES
                  else None)
        return kernels.k2a_lite(ds, g, y, ds1, ds2, wp, bp, lite["alpha"],
                                lite["beta"], lite["D"], lite["A1"],
                                cst["ihr"], cst["ihi"], cst["iwr"], cst["iwi"],
                                Hp=Hp, Wp=Wp, tables=tables, variant=variant)
    return k2a_lite_plain(ds, g, y, ds1, ds2, wp, bp, lite, cst, Hp=Hp, Wp=Wp)


# ---------------------------------------------------------------------------
# K12B: dx through both consumers of z, and the weight accumulators
# ---------------------------------------------------------------------------


def k12b_plain(x, a, b, wp, s, ds, ds1, ds2, dy, cst, *, Hp: int, Wp: int,
               act: str):
    """Plain twin of K12B. With u = a·x + b, z = act(u) and
    ds_eff = ds + ds1 + 2·ds2·s:

      dz  = F^T(dy) + ds_eff @ Wpᵀ   (spectral branch: the adjoint of K1's
                                      forward (H, W) DFT; pointwise branch)
      dx  = dz · act'(u) · a
      dWp = zᵀ ds_eff, dbp = Σ ds_eff, da = Σ du·x, db = Σ du  (du = dx/a)

    x, s, ds [BT, Hp*Wp/2, 2C]; dy [BT, 2m2*m3, 2C]. Returns dx in x's
    dtype and (dWp [C, C], da, db, dbp [C]) in f32."""
    BT, C = x.shape[0], x.shape[-1] // 2
    m2x2, m3 = cst["ehr"].shape[1], cst["ewr"].shape[1]
    v = lambda t: t.float().view(BT, Hp, Wp, C)
    x4 = v(x)
    u = x4 * a + b
    z = _act(u, act)
    dse = v(ds) + ds1 + 2.0 * ds2 * v(s)
    dy5 = dy.float().view(BT, m2x2, m3, 2, C)
    dyR, dyI = dy5[..., 0, :], dy5[..., 1, :]
    e = lambda t, M: torch.einsum("bjmc,hj->bhmc", t, M)
    dXr = e(dyR, cst["ehr"]) + e(dyI, cst["ehi"])
    dXi = e(dyI, cst["ehr"]) - e(dyR, cst["ehi"])
    dzW = (torch.einsum("bhmc,wm->bhwc", dXr, cst["ewr"])
           + torch.einsum("bhmc,wm->bhwc", dXi, cst["ewi"]))
    du = (dzW + dse @ wp.t()) * _act_grad(u, act)
    dx = (du * a).reshape(x.shape).to(x.dtype)
    dims = (0, 1, 2)
    dwp = torch.einsum("bhwc,bhwd->cd", z, dse)
    return dx, dwp, (du * x4).sum(dims), du.sum(dims), dse.sum(dims)


def k12b(x, a, b, wp, s, ds, ds1, ds2, dy, *, Hp: int, Wp: int, m2: int,
         m3: int, act: str, variant=None):
    """On the card, the variant ``kernels.k12b_variant`` chooses from dtype,
    shape and alignment (or the one named): the packed tables go with the
    mma and tf32 variants."""
    cst = _ct_on(x.device, Hp, Wp, m2, m3)
    if _use_kernel(x):
        C = x.shape[-1] // 2
        name = variant or kernels.k12b_variant(x.dtype, C, 2 * m2, m3, Wp,
                                               kernels.aligned(x, s, ds, dy))
        tables = (_K12B_TABLES[name](x.device, Hp, Wp, m2, m3, kernels.K12B_MMA_ROWS[C])
                  if name in _K12B_TABLES and C in kernels.K12B_MMA_ROWS else None)
        return kernels.k12b(x, a, b, wp, s, ds, ds1, ds2, dy, cst["ehr"],
                            cst["ehi"], cst["ewr"], cst["ewi"], Hp=Hp, Wp=Wp,
                            act=act, tables=tables, variant=variant)
    return k12b_plain(x, a, b, wp, s, ds, ds1, ds2, dy, cst, Hp=Hp, Wp=Wp,
                      act=act)


# ---------------------------------------------------------------------------
# Mid-section: T-DFT, corner GEMM, inverse T
# ---------------------------------------------------------------------------


def _pack_w2(w_real, w_imag):
    """2x2 block-complex corner weight [[wr, wi], [-wi, wr]]
    ([4, m1, m2, m3, 2Ci, 2Co]): mixes [re | im] input lanes to
    [re | im] output lanes in one product."""
    top = torch.cat([w_real, w_imag], dim=-1)
    bot = torch.cat([-w_imag, w_real], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _corners(z5, m1: int, m2: int):
    """[B, 2m1, 2m2, m3, L] → [B, 4, m1, m2, m3, L] in the reference corner
    order (+T+H, -T+H, +T-H, -T-H); a permutation, inverted by _uncorner."""
    return torch.stack([z5[:, :m1, :m2], z5[:, m1:, :m2], z5[:, :m1, m2:],
                        z5[:, m1:, m2:]], dim=1)


def _uncorner(o):
    top = torch.cat([o[:, 0], o[:, 2]], dim=2)
    bot = torch.cat([o[:, 1], o[:, 3]], dim=2)
    return torch.cat([top, bot], dim=1)


def _corner_bwd(x2, w_real, w_imag, dout2):
    """The corner GEMM's backward (JAX ``_corner_gemm_bwd``,
    ``fno_layer.py:1250-1261``): dx2 in dout2's dtype, and dwr, dwi f32
    from the four half-lane einsums, so the packed w2's gradient is never
    formed."""
    dx2 = torch.einsum("bkxyzo,kxyzio->bkxyzi", dout2,
                       _pack_w2(w_real, w_imag).to(dout2.dtype))
    ci, co = x2.shape[-1] // 2, dout2.shape[-1] // 2
    xr, xi = x2[..., :ci].float(), x2[..., ci:].float()
    dgr, dgi = dout2[..., :co].float(), dout2[..., co:].float()
    e = lambda p, q: torch.einsum("bkxyzi,bkxyzo->kxyzio", p, q)
    # out_r = xr wr - xi wi ; out_i = xr wi + xi wr  (per corner)
    return dx2, e(xr, dgr) + e(xi, dgi), e(xr, dgi) - e(xi, dgr)


def _mid_after_et(z, w_real, w_imag, B: int, Tp: int):
    """From the forward T-DFT z [B*2m1, Y, 2C]: corner-block channel mixing
    out2 = x2 @ [[wr, wi], [-wi, wr]] in the reference corner order, then
    the inverse T-DFT → [B*Tp, Y, 2C]. The corner GEMM is a plain einsum in
    z's dtype (f32 accumulation on the card), as JAX leaves it to XLA."""
    _, m1, m2, m3, _, Co = w_real.shape
    x2 = _corners(z.view(B, 2 * m1, 2 * m2, m3, z.shape[-1]), m1, m2)
    out2 = torch.einsum("bkxyzi,kxyzio->bkxyzo", x2,
                        _pack_w2(w_real, w_imag).to(x2.dtype))
    g5 = _uncorner(out2)
    return t_stage(g5.reshape(B * 2 * m1, -1, 2 * Co), "it", Tp, m1)


def _mid_bwd(dg, z, w_real, w_imag, B: int, Tp: int):
    """The mid-section's backward from the saved forward T-DFT z:
    T-stage it_adj → corner GEMM backward → T-stage et_adj.
    Returns (dy like dg, dwr, dwi f32)."""
    _, m1, m2, m3, Ci, Co = w_real.shape
    dg5 = _t_stage_apply(dg, "it_adj", Tp, m1).view(B, 2 * m1, 2 * m2, m3,
                                                    2 * Co)
    x2 = _corners(z.view(B, 2 * m1, 2 * m2, m3, 2 * Ci), m1, m2)
    dx2, dwr, dwi = _corner_bwd(x2, w_real, w_imag, _corners(dg5, m1, m2))
    dz = _uncorner(dx2).reshape(B * 2 * m1, -1, 2 * Ci)
    return _t_stage_apply(dz, "et_adj", Tp, m1), dwr, dwi


# ---------------------------------------------------------------------------
# The whole layer
# ---------------------------------------------------------------------------


def _check_layer_args(x, dims):
    B, Tp, Hp, Wp, C = dims
    if Wp % 2 or tuple(x.shape) != (B * Tp, Hp * (Wp // 2), 2 * C):
        raise ValueError(f"fused FNO layer: x has shape {tuple(x.shape)}, "
                         f"expected [B*Tp, Hp*(Wp/2), 2C] for dims {dims} "
                         "with an even Wp")


class _FusedLayer(torch.autograd.Function):
    """Forward K1 → mid → K2; backward K2A-lite (or K2A) → mid backward →
    K12B (JAX ``_make_layer``'s custom VJP, ``fno_layer.py:974-1025``)."""

    @staticmethod
    def forward(ctx, x, a, b, w_real, w_imag, wp, bp, dims, act):
        B, Tp, Hp, Wp, C = dims
        m1, m2, m3 = w_real.shape[1:4]
        y = k1(x, a, b, Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
        z = t_stage(y, "et", Tp, m1)
        g = _mid_after_et(z, w_real, w_imag, B, Tp)
        s, stats = k2(g, x, a, b, wp, bp, Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
        ctx.meta = (dims, act)
        ctx.save_for_backward(x, a, b, w_real, w_imag, wp, bp, y, z, g, s)
        return s, stats

    @staticmethod
    def backward(ctx, ds, dstats):
        x, a, b, w_real, w_imag, wp, bp, y, z, g, s = ctx.saved_tensors
        (B, Tp, Hp, Wp, C), act = ctx.meta
        m2, m3 = w_real.shape[2:4]
        ds = torch.zeros_like(s) if ds is None else ds.to(s.dtype).contiguous()
        if dstats is None:
            dstats = torch.zeros((2, C), device=s.device)
        ds1, ds2 = (v.float().contiguous() for v in dstats)
        geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3)
        # the lite statics exist or not by geometry alone (one warning)
        if _lite_or_none(Hp, Wp, m2, m3) is not None:
            dg = k2a_lite(ds, g, y, ds1, ds2, wp, bp, **geo)
        else:
            dg = k2a(s, ds, ds1, ds2, **geo)
        dy, dwr, dwi = _mid_bwd(dg, z, w_real, w_imag, B, Tp)
        dx, dwp, da, db, dbp = k12b(x, a, b, wp, s, ds, ds1, ds2, dy, **geo,
                                    act=act)
        return dx, da, db, dwr, dwi, dwp, dbp, None, None


def fused_fno_layer(x, a, b, w_real, w_imag, wp, bp, *, dims, act: str):
    """One FNO layer on packed activations: K1 → mid-section → K2, and its
    backward through K2A-lite (or K2A), the mid-section adjoints and K12B.

    Args:
      x: [B*Tp, Hp*(Wp/2), 2C] the previous layer's pre-BN output (or the
        zero-padded fc0 output for the first layer).
      a, b: [C] f32, the previous layer's folded BN (ones/zeros and
        act='none' for the first layer).
      w_real, w_imag: [4, m1, m2, m3, C, C] f32 corner weights.
      wp: [C, C] f32 pointwise kernel ([in, out]); bp: [C] f32.
      dims: (B, Tp, Hp, Wp, C). act: 'none' | 'exact' | 'tanh'.
    Returns (s like x, stats [2, C] f32 per-channel sum and sum of squares).
    Gradients reach all seven inputs; those of x arrive in x's dtype.
    """
    _check_layer_args(x, dims)
    return _FusedLayer.apply(x, a, b, w_real, w_imag, wp, bp, tuple(dims), act)


def reference_fused_fno_layer(x, a, b, w_real, w_imag, wp, bp, *, dims,
                              act: str):
    """Plain oracle of the fused layer, independent of the kernels' DFT
    factorisation: ``truncated_spectral_conv3d_dft`` on the unpacked
    [B, Tp, Hp, Wp, C] layout, all in f32; autograd through it is the
    oracle of the backward. Same signature and returns as
    ``fused_fno_layer``."""
    _check_layer_args(x, dims)
    B, Tp, Hp, Wp, C = dims
    z5 = _act(x.float().view(B, Tp, Hp, Wp, C) * a + b, act)
    s5 = (truncated_spectral_conv3d_dft(z5, w_real, w_imag)
          + z5 @ wp.float() + bp)
    stats = torch.stack([s5.sum(dim=(0, 1, 2, 3)),
                         (s5 * s5).sum(dim=(0, 1, 2, 3))])
    return s5.reshape(x.shape).to(x.dtype), stats
