"""Build and bind the hand-written CUDA kernels in ``csrc/``.

``build()`` compiles every ``csrc/*.cu`` with nvcc for ``sm_90a`` (Hopper),
one nvcc per source, all started together, and links the objects into one
shared library with a plain C interface, at first use, into
``build_dir()``: ``build/kernels/`` at the repository root of a source
checkout (git ignores it), a per-user cache directory for an installed
copy. The library's name carries a hash of the sources and flags, so an
edited source is rebuilt and a stale library is never loaded. ``library()`` loads it with ctypes.

One wrapper per kernel (``k1``, ``t_stage``, ``k2``, ``k2a``, ``k2a_lite``,
``k12b``, ``k3f``, ``k3b``, ``ta_fwd``, ``ta_bwd``, ``gk_scores``): each checks its
tensors, allocates the outputs and scratch, launches on PyTorch's current
stream (the kernels allocate nothing and do not synchronise), raises if the
launch returned an error, and adds one to its entry in ``LAUNCHES``.

K1, the T-stage, K2, K2A-lite, K12B, K3F, K3B, the TA forward and backward
and the Galerkin scores have two variants each, chosen from dtype, shape
and the 16-byte alignment of the data before the launch by the pure
functions ``k1_variant``, ``t_stage_variant``, ``k2_variant``,
``k2a_lite_variant``, ``k12b_variant``, ``k3f_variant``, ``k3b_variant``,
``ta_fwd_variant``, ``ta_bwd_variant`` and ``gk_scores_variant``
(``VARIANTS`` counts the launches of each): the T-stage's ``registers`` (a thread
produces every output of its column) or ``generic``; the others' ``mma``
(bf16, their products on the tensor cores) or ``fma`` (exact f32
arithmetic); K1, K2, K2A-lite, K12B, K3F, K3B and the TA forward and
backward also ``tf32`` (f32 tensors, every product on the tensor cores as
3xTF32). A caller may name
the variant; one that does not take the input raises before anything is
built. No variant gives way to another after a failure.
Nothing here runs at import: this module is imported on machines with no
GPU and no nvcc, where only the plain twins in ``ops/fno_layer.py``,
``ops/fno_tail.py``, ``ops/temporal_attention.py`` and ``ops/galerkin.py``
run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from functools import lru_cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def build_dir(package: Path = CSRC.parent) -> Path:
    """Where the library is built: ``build/kernels`` at the repository root
    in a source checkout (the package beside a ``pyproject.toml``, a
    directory git ignores); in an installed copy, a per-user cache
    (``$XDG_CACHE_HOME``, else ``~/.cache``, then
    ``realpdebench_tpu_torch/kernels``)."""
    root = package.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / package.name / "kernels"


BUILD_DIR = build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset_launches(): the proof that a run
# went through the kernels and not through the plain twins.
LAUNCHES = {"k1": 0, "t_stage": 0, "k2": 0, "k2a": 0, "k2a_lite": 0, "k12b": 0,
            "k3f": 0, "k3b": 0, "ta_fwd": 0, "ta_bwd": 0, "gk_scores": 0}

# Launches per variant of the kernels that have more than one; the keys'
# order is the variant code of the csrc/ entry point.
VARIANTS = {"k1": {"fma": 0, "mma": 0, "tf32": 0}, "t_stage": {"generic": 0, "registers": 0},
            "k2": {"fma": 0, "mma": 0, "tf32": 0}, "k2a_lite": {"fma": 0, "mma": 0, "tf32": 0},
            "k12b": {"fma": 0, "mma": 0, "tf32": 0}, "k3f": {"fma": 0, "mma": 0, "tf32": 0},
            "k3b": {"fma": 0, "mma": 0, "tf32": 0}, "ta_fwd": {"fma": 0, "mma": 0, "tf32": 0},
            "ta_bwd": {"fma": 0, "mma": 0, "tf32": 0}, "gk_scores": {"fma": 0, "mma": 0}}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc: fno::DType
ACT_CODES = {"none": 0, "exact": 1, "tanh": 2}         # csrc: fno::Act

# csrc/fno_tstage.cu: the register-resident side's largest instantiation,
# and the channels a thread takes
TSTAGE_MAX_REGISTERS, TSTAGE_VEC = 16, 4
# csrc/fno_k2.cu, the mma variant: instantiated widths and W modes, H rows
# a block by width (mma_rows), row padding in elements (kPad), warps
# (kMaxWarps), and the shared memory a block may take on Hopper
K2_MMA_WIDTHS, K2_MMA_M3 = (32, 64, 128), (8, 16)
K2_MMA_ROWS = {32: 8, 64: 5, 128: 3}
K2_MMA_PAD = 8
K2_MMA_MAX_WARPS = {32: 16, 64: 16, 128: 9}
K2_MMA_MAX_H_MODES = 32   # 2*m2: four k-steps of the inverse-H product (kMaxKH)
MAX_SMEM_BYTES = 232448
# csrc/fno_tf32.cuh, K2's and K12B's tf32 variants: f32 padding of a row read by
# ldmatrix (kTPad), the channels of a g / dy piece (kGC); csrc/fno_k2.cu: the
# channels of an x ring stage (kXC); csrc/fno_k12b.cu: the positions of a dWp
# tile (kTilePosT)
TF32_PAD, TF32_GC, K2_TF32_XC, K12B_TF32_TILE = 4, 8, 16, 32
# csrc/fno_k1.cu, the mma variant: W modes, the channels a block takes, the
# rows of H a chunk takes (one a warp), the widest W
K1_MMA_M3, K1_MMA_SLICE, K1_MMA_ROWS, K1_MMA_MAX_WP = (8, 16), 16, 8, 256
# csrc/fno_dft_tf32.cuh, the tf32 variants of K1 and K2A-lite: the rows of W a
# ring stage holds (kPiece), the f32 padding of EW's rows (kEPad) and of an X
# tile's (kXPad); csrc/fno_k2a.cu: the f32 row stride of the wps slice
# (kWpsStrideF)
DFT_TF32_PIECE, DFT_TF32_EPAD, DFT_TF32_XPAD, K2A_LITE_TF32_WPS_STRIDE = 32, 4, 8, 18


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counts in VARIANTS.values():
        for k in counts:
            counts[k] = 0


def aligned(*tensors) -> bool:
    """True when every tensor's data starts on a 16-byte boundary, as the
    16-byte vector loads of the registers and mma variants need (a view at
    an odd storage offset may not)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def t_stage_variant(dtype, C: int, Tin: int, Tout: int, aligned: bool = True) -> str:
    """'registers' where the shorter side of T fits the instantiated
    register counts, the channels split into vectors and the input is
    16-byte aligned, else 'generic'."""
    del dtype   # both variants take float32 and bfloat16
    if min(Tin, Tout) <= TSTAGE_MAX_REGISTERS and C % TSTAGE_VEC == 0 and aligned:
        return "registers"
    return "generic"


def k2_mma_smem_bytes(Wp: int, C: int, m2x2: int, m3: int) -> int:
    """Shared memory of a block of K2's mma variant (csrc/fno_k2.cu::
    mma_layout): Wp hi and lo, the block's inverse-H rows hi and lo, the
    larger of the warps' x rings and their rings over g, a/b/bp, the warps'
    statistics."""
    warps = -(-Wp // 16)
    row = (C + K2_MMA_PAD) * 2
    slabs = warps * 2 * 16 * row
    gring = warps * 2 * (2 * m2x2) * 16 * 2   # the warps' rings over g ([k][16] tiles)
    return (2 * C * row + 2 * K2_MMA_ROWS[C] * 2 * m3 * row + max(slabs, gring)
            + 3 * C * 4 + warps * 2 * C * 4)


def k2_tf32_smem_bytes(Wp: int, C: int, m2x2: int, m3: int) -> int:
    """Shared memory of a block of K2's tf32 variant (csrc/fno_k2.cu::
    tf32_layout), all f32: the block's inverse-H rows as [c][k]; the larger
    of the warps' rings over g (the H stage) and Wpᵀ's tf32 hi and lo with
    the warps' x rings (two 16-channel stages; the main loop); a/b/bp; the
    warps' statistics."""
    warps = -(-Wp // 16)
    main = 2 * C * (C + TF32_PAD) * 4 + warps * 2 * 16 * (K2_TF32_XC + TF32_PAD) * 4
    gring = warps * 2 * (2 * m2x2) * TF32_GC * 4
    return (K2_MMA_ROWS[C] * C * (2 * m3 + TF32_PAD) * 4 + max(main, gring)
            + 3 * C * 4 + warps * 2 * C * 4)


def _tc_choice(dtype, mma_bytes: int, tf32_bytes: int) -> str:
    """The tensor-core variant of dtype whose block fits, else 'fma'."""
    if dtype == torch.bfloat16 and mma_bytes <= MAX_SMEM_BYTES:
        return "mma"
    if dtype == torch.float32 and tf32_bytes <= MAX_SMEM_BYTES:
        return "tf32"
    return "fma"


def k2_variant(dtype, C: int, m3: int, Wp: int = 16, m2x2: int = 2,
               aligned: bool = True) -> str:
    """At an instantiated (C, m3) whose block fits (one warp per 16 columns
    of W, its tiles in shared memory, at most 32 H modes) on 16-byte aligned
    g, x and wp: 'mma' for bfloat16, 'tf32' for float32; else 'fma'."""
    if (aligned and C in K2_MMA_WIDTHS and m3 in K2_MMA_M3
            and m2x2 <= K2_MMA_MAX_H_MODES and -(-Wp // 16) <= K2_MMA_MAX_WARPS[C]):
        return _tc_choice(dtype, k2_mma_smem_bytes(Wp, C, m2x2, m3),
                          k2_tf32_smem_bytes(Wp, C, m2x2, m3))
    return "fma"


def k1_mma_smem_bytes(Wp: int, m3: int) -> int:
    """Shared memory of a block of K1's mma variant (csrc/fno_k1.cu::
    k1_mma_smem): the W factors, two X tiles, the warps' two-stage rings
    over x, a and b."""
    kw = -(-Wp // 16) * 16
    return (2 * m3 * (kw + 8) * 2 + 2 * 16 * (m3 * K1_MMA_SLICE + 8) * 2
            + K1_MMA_ROWS * 2 * kw * K1_MMA_SLICE * 2 + 2 * K1_MMA_SLICE * 4)


def k1_tf32_smem_bytes(Wp: int, m3: int) -> int:
    """Shared memory of a block of K1's tf32 variant (csrc/fno_dft_tf32.cuh::
    body_smem), all f32: EW's tf32 hi and lo (rows padded), two X tiles,
    the warps' two-stage rings of 32-row pieces of x, a and b."""
    kw = -(-Wp // 8) * 8
    return (2 * 2 * m3 * (kw + DFT_TF32_EPAD) * 4
            + 2 * 16 * (m3 * K1_MMA_SLICE + DFT_TF32_XPAD) * 4
            + K1_MMA_ROWS * 2 * DFT_TF32_PIECE * K1_MMA_SLICE * 4 + 2 * K1_MMA_SLICE * 4)


def k1_variant(dtype, C: int, m2x2: int, m3: int, Wp: int = 16,
               aligned: bool = True) -> str:
    """With C a multiple of 16, an instantiated m3, at most 32 H modes,
    Wp <= 256 and 16-byte aligned x, a block that fits: 'mma' for bfloat16,
    'tf32' for float32; else 'fma'."""
    if (aligned and C % K1_MMA_SLICE == 0 and m3 in K1_MMA_M3 and m2x2 <= 32
            and Wp <= K1_MMA_MAX_WP):
        return _tc_choice(dtype, k1_mma_smem_bytes(Wp, m3), k1_tf32_smem_bytes(Wp, m3))
    return "fma"


# csrc/fno_k2a.cu, K2A-lite's mma variant: K1's body (fno_dft_mma.cuh) and
# the slice of wps [C][K2A_LITE_WPS_STRIDE] in bf16; widths up to 128
K2A_LITE_WPS_STRIDE, K2A_LITE_MMA_MAX_C = 24, 128


def k2a_lite_mma_smem_bytes(Wp: int, m3: int, C: int) -> int:
    """Shared memory of a block of K2A-lite's mma variant (csrc/fno_k2a.cu::
    k2a_lite_mma_smem): K1's mma body, then the slice of wps in bf16."""
    return k1_mma_smem_bytes(Wp, m3) + C * K2A_LITE_WPS_STRIDE * 2


def k2a_lite_tf32_smem_bytes(Wp: int, m3: int, C: int) -> int:
    """Shared memory of a block of K2A-lite's tf32 variant (csrc/fno_k2a.cu::
    k2a_lite_tf32_smem): K1's tf32 body, then the slice of wps in f32."""
    return k1_tf32_smem_bytes(Wp, m3) + C * K2A_LITE_TF32_WPS_STRIDE * 4


def k2a_lite_variant(dtype, C: int, m2x2: int, m3: int, Wp: int = 16,
                     aligned: bool = True) -> str:
    """With C a multiple of 16 up to 128, an instantiated m3, at most 32 H
    modes, Wp <= 256 and 16-byte aligned ds, g and y, a block that fits:
    'mma' for bfloat16, 'tf32' for float32; else 'fma'."""
    if (aligned and C % K1_MMA_SLICE == 0 and C <= K2A_LITE_MMA_MAX_C and m3 in K1_MMA_M3
            and m2x2 <= 32 and Wp <= K1_MMA_MAX_WP):
        return _tc_choice(dtype, k2a_lite_mma_smem_bytes(Wp, m3, C),
                          k2a_lite_tf32_smem_bytes(Wp, m3, C))
    return "fma"


# csrc/fno_tail.cu, K3B's mma variant: widths, positions a tile takes, the
# padded row strides of its [.][128] tiles and of its do tile; the tf32
# variants' f32 row strides of k1 and k2ᵀ (kTfKS), of the h1 / du tile
# (kTfHS) and of doᵀ (kTfDS); the widest fc2 (kMaxF)
K3B_MMA_WIDTHS, K3B_MMA_TILE, K3B_MMA_KS, K3B_MMA_DOS = (32, 64, 128), 128, 136, 24
K3_TF32_KS, K3_TF32_HS, K3_TF32_DS = 136, 132, 136
TAIL_MAX_F = 16
# the (width, activation) pairs whose tensor-core variants are also built at
# fc2 width 16 (csrc/fno_tail.cu::with_mma_instance): the combustion
# scenario's; every pair of K3B_MMA_WIDTHS and the two GELUs is built at 8
K3_WIDE_F_INSTANCES = ((64, "exact"),)


def fc2_width(F: int) -> int:
    """fc2's width as the tail's tensor-core variants pad it
    (csrc/fno_tail.cu::fc2_width): one n-tile of 8 columns for F <= 8, two
    for 9 <= F <= 16."""
    return 8 if F <= 8 else 16


def k3f_mma_smem_bytes(C: int, F: int = 3) -> int:
    """Shared memory of a block of K3F's mma variant (csrc/fno_tail.cu::
    k3f_mma_smem): k1 hi and lo, two z stages, k2ᵀ hi and lo [NF][136]
    (bf16); b1, b2 (f32); the warps' sums (f64)."""
    P, KS, NF = K3B_MMA_TILE, K3B_MMA_KS, fc2_width(F)
    return 2 * (2 * C * KS + 2 * P * (C + 8) + 2 * NF * KS) + 4 * (128 + NF) + 8 * 8


def k3f_tf32_smem_bytes(C: int, F: int = 3) -> int:
    """Shared memory of a block of K3F's tf32 variant (csrc/fno_tail.cu::
    k3f_tf32_smem), all f32: two z stages [128][C + 4], k1 [C][136], k2ᵀ
    [NF][136], b1, b2; the warps' sums (f64)."""
    NF = fc2_width(F)
    return 4 * (2 * K3B_MMA_TILE * (C + 4) + (C + NF) * K3_TF32_KS + 128 + NF) + 8 * 8


def tail_tc_instance(C: int, F: int, act: str = "exact") -> bool:
    """Whether the tail's tensor-core variants are built at (C, F, act):
    every width of K3B_MMA_WIDTHS at F <= 8, K3_WIDE_F_INSTANCES up to
    TAIL_MAX_F."""
    return C in K3B_MMA_WIDTHS and (F <= 8 or (F <= TAIL_MAX_F
                                               and (C, act) in K3_WIDE_F_INSTANCES))


def k3f_variant(dtype, C: int, F: int = 3, aligned: bool = True, act: str = "exact") -> str:
    """At an instantiated (C, F, act) (``tail_tc_instance``) and 16-byte
    aligned s (K3B's conditions: the two share one forward): 'mma' for
    bfloat16, 'tf32' for float32; else 'fma'."""
    if aligned and tail_tc_instance(C, F, act):
        return _tc_choice(dtype, k3f_mma_smem_bytes(C, F), k3f_tf32_smem_bytes(C, F))
    return "fma"


def k3b_mma_smem_bytes(C: int, F: int = 3) -> int:
    """Shared memory of a block of K3B's mma variant (csrc/fno_tail.cu::
    k3b_mma_smem): k1 hi and lo, two z stages, h1/du hi and lo, do hi and
    lo, k2ᵀ hi and lo [NF][136] (bf16); k2 [128][NF], b1, b2 and the warps'
    db2 [8][NF] (f32)."""
    P, KS, DOS, NF = K3B_MMA_TILE, K3B_MMA_KS, K3B_MMA_DOS, fc2_width(F)
    return (2 * (2 * C * KS + 2 * P * (C + 8) + 2 * P * KS + 2 * P * DOS
                 + 2 * NF * KS)
            + 4 * (128 * NF + 128 + NF + 8 * NF))


def k3b_tf32_stages(C: int) -> int:
    """z stages of a block of K3B's tf32 variant (csrc/fno_tail.cu::
    k3b_tf32_stages): two up to C 64, one at C 128."""
    return 2 if C <= 64 else 1


def k3b_tf32_smem_bytes(C: int, F: int = 3) -> int:
    """Shared memory of a block of K3B's tf32 variant (csrc/fno_tail.cu::
    k3b_tf32_smem), all f32: its z stages [128][C + 4], k1 [C][136], the h1
    / du tile [128][132], doᵀ [NF][136], k2ᵀ [NF][136], k2 [128][NF], b1,
    b2, the warps' db2 [8][NF]."""
    P, NF = K3B_MMA_TILE, fc2_width(F)
    return 4 * (k3b_tf32_stages(C) * P * (C + 4) + (C + NF) * K3_TF32_KS + P * K3_TF32_HS
                + NF * K3_TF32_DS + 128 * NF + 128 + NF + 8 * NF)


def k3b_variant(dtype, C: int, F: int = 3, aligned: bool = True, act: str = "exact") -> str:
    """At an instantiated (C, F, act) (``tail_tc_instance``) and 16-byte
    aligned s: 'mma' for bfloat16, 'tf32' for float32; else 'fma'."""
    if aligned and tail_tc_instance(C, F, act):
        return _tc_choice(dtype, k3b_mma_smem_bytes(C, F), k3b_tf32_smem_bytes(C, F))
    return "fma"


# csrc/fno_k12b.cu, the mma variant: widths, W modes, H rows a dz block
# takes by width (dz_rows), warps by width, the blocks of the dWp pass
K12B_MMA_WIDTHS, K12B_MMA_M3 = (32, 64, 128), (8, 16)
K12B_MMA_ROWS = {32: 8, 64: 5, 128: 4}
K12B_MMA_MAX_WARPS = {32: 16, 64: 16, 128: 9}


def k12b_mma_smem_bytes(Wp: int, C: int, m2x2: int, m3: int) -> int:
    """Shared memory of a dz block of K12B's mma variant (csrc/fno_k12b.cu::
    dz_layout): Wp^T hi and lo, dX of the block's rows hi and lo, the warps'
    rings over dy, a/b/ds1/ds2, the warps' sums."""
    warps = -(-Wp // 16)
    row = (C + K2_MMA_PAD) * 2
    return (2 * C * row + 2 * K12B_MMA_ROWS[C] * 2 * m3 * row
            + warps * 2 * (2 * m2x2) * 16 * 2 + 4 * C * 4 + warps * 2 * C * 4)


def k12b_tf32_smem_bytes(Wp: int, C: int, m2x2: int, m3: int) -> int:
    """Shared memory of a dz block of K12B's tf32 variant (csrc/fno_k12b.cu::
    dz_tf32_layout), all f32: dX of the block's rows as [c][k]; the larger
    of the warps' rings over dy (the H stage) and wp's tf32 hi and lo (the
    main loop); a/b/ds1/ds2; the warps' sums."""
    warps = -(-Wp // 16)
    return (K12B_MMA_ROWS[C] * C * (2 * m3 + TF32_PAD) * 4
            + max(warps * 2 * (2 * m2x2) * TF32_GC * 4, 2 * C * (C + TF32_PAD) * 4)
            + 4 * C * 4 + warps * 2 * C * 4)


def k12b_tf32_dwp_smem_bytes(C: int) -> int:
    """Shared memory of a dWp block of K12B's tf32 variant (csrc/fno_k12b.cu::
    dwp_tf32_smem): x, s and ds two stages each and ds_eff hi and lo, tiles
    of 32 positions in rows of C + 8 floats; a/b/ds1/ds2; four dbp shares."""
    return 8 * K12B_TF32_TILE * (C + 8) * 4 + 8 * C * 4


def k12b_variant(dtype, C: int, m2x2: int, m3: int, Wp: int = 16,
                 aligned: bool = True) -> str:
    """At an instantiated (C, m3) whose dz block fits (one warp per 16
    columns of W, at most 32 H modes) on 16-byte aligned x, s, ds and dy:
    'mma' for bfloat16, 'tf32' for float32; else 'fma'."""
    if (aligned and C in K12B_MMA_WIDTHS and m3 in K12B_MMA_M3 and m2x2 <= 32
            and -(-Wp // 16) <= K12B_MMA_MAX_WARPS[C]):
        return _tc_choice(dtype, k12b_mma_smem_bytes(Wp, C, m2x2, m3),
                          max(k12b_tf32_smem_bytes(Wp, C, m2x2, m3), k12b_tf32_dwp_smem_bytes(C)))
    return "fma"


def split_bf16(t: torch.Tensor):
    """(hi, lo) bfloat16 with hi + lo = t to 2^-17 relative: hi = rn(t),
    lo = rn(t - hi). Host twin of csrc/mma.cuh::split_bf16."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """t (float32) rounded to tf32, to nearest with ties away from zero, as
    float32 whose low 13 mantissa bits are zero: the half unit of the last
    kept bit added to the bits, the rest cut (cvt.rna.tf32.f32 on finite
    values; a NaN whose top mantissa bits are set comes out as ±0). Host
    twin of csrc/mma.cuh::to_tf32."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor):
    """(hi, lo) float32 tensors of tf32 values with hi + lo = t to 2^-22
    relative: hi = rna(t) by ``to_tf32``, lo = rna(t - hi) as
    cvt.rna.tf32.f32 rounds (``to_tf32`` on finite values, Inf and NaN
    kept), so lo is NaN where t is Inf or NaN. Host twin of
    csrc/mma.cuh::split_tf32."""
    t = t.float()
    hi = to_tf32(t)
    d = t - hi
    return hi, torch.where(torch.isfinite(d), to_tf32(d), d)


def _variant_code(kernel: str, name: str) -> int:
    """The variant's code for the C entry point."""
    names = list(VARIANTS[kernel])
    if name not in names:
        raise ValueError(f"{kernel}: no variant {name!r} (has {names})")
    return names.index(name)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of realpdebench_tpu_torch need the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfno_kernels_{h.hexdigest()[:16]}.so"


def build(nice: int = 0) -> tuple[Path, float]:
    """Compile csrc/*.cu into the library unless it is built already: one
    nvcc per source, all at once, then one link; ``nice`` > 0 runs them at
    that niceness (through ``nice``, where the host has it), so that work
    meanwhile in the calling process keeps its core. Returns (path, seconds
    spent; 0.0 when it was there). The compiler's per-kernel register and
    shared-memory report goes to stderr."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    niced = shutil.which("nice") if nice > 0 else None
    prefix = [niced, "-n", str(nice)] if niced else []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmpdir) / f"{src.stem}.o"
            cmd = [*prefix, nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            sys.stderr.write(stderr)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                              f"{stdout}\n{stderr}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out, time.perf_counter() - t0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (argument types, result type) of each entry point of the library, in the
# order of its C signature in csrc/ (the stream is the last pointer);
# tests/test_torch_kernel_variants.py holds them against the sources
SIGNATURES = {
    "fno_k1": ([_P] * 10 + [_I] * 9 + [_P], _I),
    "fno_k1_mma_smem_bytes": ([_I] * 2, _I),
    "fno_k1_tf32_smem_bytes": ([_I] * 2, _I),
    "fno_tstage": ([_P] * 4 + [_I] * 7 + [_P], _I),
    "fno_k2": ([_P] * 15 + [_I] * 9 + [_P], _I),
    "fno_k2_num_partials": ([_I] * 4, _I),
    "fno_k2_mma_smem_bytes": ([_I] * 4, _I),
    "fno_k2_tf32_smem_bytes": ([_I] * 4, _I),
    "fno_k2a": ([_P] * 18 + [_I] * 9 + [_P], _I),
    "fno_k2a_lite_mma_smem_bytes": ([_I] * 3, _I),
    "fno_k2a_lite_tf32_smem_bytes": ([_I] * 3, _I),
    "fno_k12b": ([_P] * 18 + [_I] * 9 + [_P], _I),
    "fno_k12b_partial_floats": ([_I] * 5, ctypes.c_longlong),
    "fno_k12b_mma_smem_bytes": ([_I] * 4, _I),
    "fno_k12b_tf32_smem_bytes": ([_I] * 4, _I),
    "fno_k3f": ([_P] * 8 + [_I] * 13 + [_P], _I),
    "fno_k3f_num_partials": ([_I] * 8, _I),
    "fno_k3f_mma_smem_bytes": ([_I] * 2, _I),
    "fno_k3f_tf32_smem_bytes": ([_I] * 2, _I),
    "fno_k3b": ([_P] * 10 + [_I] * 13 + [_P], _I),
    "fno_k3b_num_partials": ([_I] * 9, _I),
    "fno_k3b_mma_smem_bytes": ([_I] * 2, _I),
    "fno_k3b_tf32_smem_bytes": ([_I] * 2, _I),
    "fno_tail_blocks_per_sm": ([_I] * 5, _I),
    "ta_fwd": ([_P] * 5 + [_I] * 6 + [_P], _I),
    "ta_fwd_mma_smem_bytes": ([_I] * 3, _I),
    "ta_fwd_tf32_smem_bytes": ([_I] * 3, _I),
    "ta_bwd_num_partials": ([_I] * 6, _I),
    "ta_bwd_mma_smem_bytes": ([_I] * 3, _I),
    "ta_bwd_tf32_smem_bytes": ([_I] * 3, _I),
    "ta_bwd": ([_P] * 10 + [_I] * 6 + [_P], _I),
    "gk_scores_num_partials": ([_I] * 6, _I),
    "gk_scores_mma_smem_bytes": ([_I] * 2, _I),
    "gk_scores": ([_P] * 8 + [_I] * 5 + [_F, _I, _I, _P], _I),
    "fno_error_string": ([_I], ctypes.c_char_p),
}


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


@lru_cache(maxsize=64)
def _layouts_agree(kernel: str, variant: str, *shape: int) -> bool:
    """The shared-memory size of a block of a tensor-core variant (K1,
    K2A-lite, K2, K12B, K3F, K3B) as its source lays it out
    (``fno_<kernel>_<variant>_smem_bytes``) against this module's, on which
    the variant functions decide; ``shape`` is both functions' arguments."""
    mine = globals()[f"{kernel}_{variant}_smem_bytes"](*shape)
    return getattr(library(), f"fno_{kernel}_{variant}_smem_bytes")(*shape) == mine


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _io_dtype(t: torch.Tensor) -> int:
    if not t.is_cuda:
        raise ValueError(f"CUDA kernel given a tensor on {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"CUDA kernels take float32 or bfloat16, not {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def _check_k1_shape(name: str, C: int, m2x2: int, m3: int) -> None:
    """The shape bounds of K1 and K2A: one block per 16 channels, one thread
    per (channel, W mode), the 2*m2 H modes in registers."""
    if m2x2 > 32 or C % min(C, 16) or min(C, 16) * m3 > 1024:
        raise ValueError(f"{name} takes 2*m2 <= 32, C a multiple of 16 (or < 16) "
                         f"and min(C,16)*m3 <= 1024; got 2*m2={m2x2}, C={C}, m3={m3}")


def _launch(name: str, fn, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = library().fno_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


_TC_DTYPES = {"mma": torch.bfloat16, "tf32": torch.float32}


def _tc_variant(kernel: str, chosen: str, variant: str | None, dtype, takes: str,
                got: str) -> tuple:
    """(name, code) of the variant of K1, K2, K2A-lite, K12B, K3F or K3B that
    runs: the one named, or ``chosen``. A named tensor-core variant (mma,
    tf32) that the input does not take raises here, before anything is
    built or launched."""
    name = chosen if variant is None else variant
    code = _variant_code(kernel, name)
    if name in _TC_DTYPES and chosen != name:
        kind = "bfloat16" if name == "mma" else "float32"
        raise ValueError(f"{kernel}: the {name} variant takes {kind}, {takes}; got {dtype}, "
                         f"{got}")
    return name, code


def _check_tables(kernel: str, name: str, tables, dev, shapes: dict) -> tuple:
    """The DFT tables a tensor-core variant reads: present, on dev, of the
    variant's dtype, shapes and 16-byte alignment; their pointers."""
    if tables is None:
        raise ValueError(f"{kernel}: the {name} variant needs the packed tables")
    for (n, shape), t in zip(shapes.items(), tables):
        _check(n, t, dev, _TC_DTYPES[name], shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{n}: not 16-byte aligned")
    return tuple(_p(t) for t in tables)


def _k1_variant(x, C: int, m2x2: int, m3: int, Wp: int, variant: str | None) -> tuple:
    """(name, code) of the K1 variant that runs on x; see ``_tc_variant``."""
    ok = aligned(x)
    return _tc_variant(
        "k1", k1_variant(x.dtype, C, m2x2, m3, Wp, ok), variant, x.dtype,
        f"C a multiple of {K1_MMA_SLICE}, m3 in {K1_MMA_M3}, 2*m2 <= 32, Wp <= "
        f"{K1_MMA_MAX_WP}, a block within {MAX_SMEM_BYTES} bytes of shared memory and "
        "16-byte aligned x", f"C={C}, m3={m3}, 2*m2={m2x2}, Wp={Wp}, aligned={ok}")


def _wh_tables(kernel: str, name: str, tables, dev, Hp: int, Wp: int, m2x2: int,
               m3: int) -> tuple:
    """The pointers of the (W, H) DFT tables (fno_layer._wh_mma_tables) that
    K1's and K2A-lite's tensor-core variants read, checked: [2*m3, Wp
    rounded up to 16] and [ceil(Hp/8), 2*(2*m2) rounded up to 16, 16]."""
    nch = -(-Hp // K1_MMA_ROWS)
    return _check_tables(kernel, name, tables, dev, {
        "ew" if kernel == "k1" else "iw": (2 * m3, -(-Wp // 16) * 16),
        "eh" if kernel == "k1" else "ih": (nch, -(-2 * m2x2 // 16) * 16, 16)})


def k1(x, a, b, ewr, ewi, ehr, ehi, *, Hp: int, Wp: int, act: str,
       tables=None, variant: str | None = None):
    """x [BT, Hp*Wp/2, 2C] → y [BT, 2m2*m3, 2C]; see csrc/fno_k1.cu.
    ``variant`` names one of VARIANTS['k1']; by default ``k1_variant``
    chooses. The mma and tf32 variants need ``tables`` = (ew, eh), the DFT
    tables of ``ops/fno_layer._k1_mma_tables`` in bfloat16 (mma) or float32
    (tf32)."""
    dt = _io_dtype(x)
    dev, f32 = x.device, torch.float32
    BT, C = x.shape[0], x.shape[-1] // 2
    m3, m2x2 = ewr.shape[1], ehr.shape[1]
    _check("x", x, dev, x.dtype, (BT, Hp * Wp // 2, 2 * C))
    for n, t, s in (("a", a, (C,)), ("b", b, (C,)), ("ewr", ewr, (Wp, m3)),
                    ("ewi", ewi, (Wp, m3)), ("ehr", ehr, (Hp, m2x2)),
                    ("ehi", ehi, (Hp, m2x2))):
        _check(n, t, dev, f32, s)
    name, code = _k1_variant(x, C, m2x2, m3, Wp, variant)
    ew = eh = ctypes.c_void_p(None)
    if name in _TC_DTYPES:
        ew, eh = _wh_tables("k1", name, tables, dev, Hp, Wp, m2x2, m3)
        if not _layouts_agree("k1", name, Wp, m3):
            raise RuntimeError("k1: the shared-memory layouts of kernels.py and "
                               "fno_k1.cu differ")
    else:
        _check_k1_shape("k1", C, m2x2, m3)
    y = torch.empty((BT, m2x2 * m3, 2 * C), dtype=x.dtype, device=dev)
    _launch("k1", library().fno_k1, dev, _p(x), _p(a), _p(b), _p(ewr), _p(ewi),
            _p(ehr), _p(ehi), ew, eh, _p(y), BT, Hp, Wp, C, m2x2, m3,
            ACT_CODES[act], code, dt)
    VARIANTS["k1"][name] += 1
    return y


def t_stage(y, mr, mi, *, variant: str | None = None):
    """y [B*Tin, Y, 2C] → [B*Tout, Y, 2C] with (MR + i MI) [Tin, Tout]; see
    csrc/fno_tstage.cu. ``variant`` names one of VARIANTS['t_stage'];
    by default ``t_stage_variant`` chooses."""
    dt = _io_dtype(y)
    dev = y.device
    Tin, Tout = mr.shape
    BT, Y, C2 = y.shape
    if BT % Tin or C2 % 2:
        raise ValueError(f"t_stage: {BT} rows are not a multiple of Tin={Tin}, "
                         f"or {C2} lanes are odd")
    _check("y", y, dev, y.dtype, (BT, Y, C2))
    _check("mr", mr, dev, torch.float32, (Tin, Tout))
    _check("mi", mi, dev, torch.float32, (Tin, Tout))
    B = BT // Tin
    chosen = t_stage_variant(y.dtype, C2 // 2, Tin, Tout, aligned(y))
    name = chosen if variant is None else variant
    code = _variant_code("t_stage", name)
    if name == "registers" and chosen != name:
        raise ValueError(f"t_stage: the registers variant takes min(Tin, Tout) <= "
                         f"{TSTAGE_MAX_REGISTERS}, C a multiple of {TSTAGE_VEC} and "
                         f"16-byte aligned data; got Tin={Tin}, Tout={Tout}, C={C2 // 2}, "
                         f"aligned={aligned(y)}")
    out = torch.empty((B * Tout, Y, C2), dtype=y.dtype, device=dev)
    _launch("t_stage", library().fno_tstage, dev, _p(y), _p(mr), _p(mi), _p(out),
            B, Tin, Tout, Y, C2 // 2, code, dt)
    VARIANTS["t_stage"][name] += 1
    return out


def _k2_variant(g, x, wp, C: int, m3: int, Wp: int, m2x2: int, variant: str | None) -> tuple:
    """(name, code) of the K2 variant that runs on (g, x, wp); see
    ``_tc_variant``."""
    ok = aligned(g, x, wp)
    return _tc_variant(
        "k2", k2_variant(x.dtype, C, m3, Wp, m2x2, ok), variant, x.dtype,
        f"C in {K2_MMA_WIDTHS}, m3 in {K2_MMA_M3}, 2*m2 <= {K2_MMA_MAX_H_MODES}, at most "
        f"{K2_MMA_MAX_WARPS} warps of 16 columns of W, a block within {MAX_SMEM_BYTES} bytes "
        "of shared memory and 16-byte aligned g, x and wp",
        f"C={C}, m3={m3}, 2*m2={m2x2}, Wp={Wp}, aligned={ok}")


def k2(g, x, a, b, wp, bp, ihr, ihi, iwr, iwi, *, Hp: int, Wp: int, act: str,
       tables=None, variant: str | None = None):
    """(g [BT, 2m2*m3, 2C], x like s) → (s like x, stats [2, C] f32); see
    csrc/fno_k2.cu. ``variant`` names one of VARIANTS['k2']; by default
    ``k2_variant`` chooses. The mma variant needs ``tables`` = (ah, iw), the
    packed bf16 hi/lo DFT tables of ``ops/fno_layer._k2_mma_tables``; the
    tf32 variant the f32 tables of ``ops/fno_layer._k2_tf32_tables``."""
    dt = _io_dtype(x)
    dev, f32 = x.device, torch.float32
    BT, C = x.shape[0], x.shape[-1] // 2
    m2x2, m3 = ihr.shape[0], iwr.shape[0]
    _check("x", x, dev, x.dtype, (BT, Hp * Wp // 2, 2 * C))
    _check("g", g, dev, x.dtype, (BT, m2x2 * m3, 2 * C))
    for n, t, s in (("a", a, (C,)), ("b", b, (C,)), ("wp", wp, (C, C)),
                    ("bp", bp, (C,)), ("ihr", ihr, (m2x2, Hp)),
                    ("ihi", ihi, (m2x2, Hp)), ("iwr", iwr, (m3, Wp)),
                    ("iwi", iwi, (m3, Wp))):
        _check(n, t, dev, f32, s)
    name, code = _k2_variant(g, x, wp, C, m3, Wp, m2x2, variant)
    ah = iw = ctypes.c_void_p(None)
    if name in _TC_DTYPES:
        nch, wpad = -(-Hp // K2_MMA_ROWS[C]), -(-Wp // 16) * 16
        kmult = 16 if name == "mma" else 8
        kpad = -(-2 * m2x2 // kmult) * kmult
        pair = (2,) if name == "mma" else ()
        ah, iw = _check_tables("k2", name, tables, dev, {
            "ah": (*pair, nch, 16, kpad), "iw": (*pair, wpad, 2 * m3)})
        if not _layouts_agree("k2", name, Wp, C, m2x2, m3):
            raise RuntimeError("k2: the shared-memory layouts of kernels.py and "
                               "fno_k2.cu differ")
    elif C > 128 or 256 % C:
        raise ValueError(f"k2 takes C dividing 256, up to 128; got C={C}")
    lib = library()
    s = torch.empty_like(x)
    partial = torch.empty((lib.fno_k2_num_partials(BT, Hp, C, code), 2, C), dtype=f32,
                          device=dev)
    stats = torch.empty((2, C), dtype=f32, device=dev)
    _launch("k2", lib.fno_k2, dev, _p(g), _p(x), _p(a), _p(b), _p(wp), _p(bp),
            _p(ihr), _p(ihi), _p(iwr), _p(iwi), ah, iw, _p(s), _p(partial), _p(stats),
            BT, Hp, Wp, C, m2x2, m3, ACT_CODES[act], code, dt)
    VARIANTS["k2"][name] += 1
    return s, stats


def _vecs(dev, C, **vs):
    for n, t in vs.items():
        _check(n, t, dev, torch.float32, (C,))


def k2a(s, ds, ds1, ds2, ihr, ihi, iwr, iwi, *, Hp: int, Wp: int):
    """(s, ds like x; ds1, ds2 [C] f32) → dg [BT, 2m2*m3, 2C] in ds's dtype;
    the full-read mode of csrc/fno_k2a.cu."""
    dt = _io_dtype(ds)
    dev, f32 = ds.device, torch.float32
    BT, C = ds.shape[0], ds.shape[-1] // 2
    m2x2, m3 = ihr.shape[0], iwr.shape[0]
    for n, t in (("s", s), ("ds", ds)):
        _check(n, t, dev, ds.dtype, (BT, Hp * Wp // 2, 2 * C))
    _vecs(dev, C, ds1=ds1, ds2=ds2)
    for n, t, sh in (("ihr", ihr, (m2x2, Hp)), ("ihi", ihi, (m2x2, Hp)),
                     ("iwr", iwr, (m3, Wp)), ("iwi", iwi, (m3, Wp))):
        _check(n, t, dev, f32, sh)
    _check_k1_shape("k2a", C, m2x2, m3)
    two = (2.0 * ds2).contiguous()
    dg = torch.empty((BT, m2x2 * m3, 2 * C), dtype=ds.dtype, device=dev)
    null = ctypes.c_void_p(None)
    _launch("k2a", library().fno_k2a, dev, _p(ds), _p(s), null, null, _p(ds1),
            _p(two), null, null, null, null, null, _p(ihr),
            _p(ihi), _p(iwr), _p(iwi), null, null, _p(dg), BT, Hp, Wp, C, m2x2, m3,
            0, 0, dt)
    return dg


def _k2a_lite_variant(ds, g, y, C: int, m2x2: int, m3: int, Wp: int,
                      variant: str | None) -> tuple:
    """(name, code) of the K2A-lite variant that runs on (ds, g, y); see
    ``_tc_variant``."""
    ok = aligned(ds, g, y)
    return _tc_variant(
        "k2a_lite", k2a_lite_variant(ds.dtype, C, m2x2, m3, Wp, ok), variant, ds.dtype,
        f"C a multiple of {K1_MMA_SLICE} up to {K2A_LITE_MMA_MAX_C}, m3 in {K1_MMA_M3}, "
        f"2*m2 <= 32, Wp <= {K1_MMA_MAX_WP}, a block within {MAX_SMEM_BYTES} bytes of "
        "shared memory and 16-byte aligned ds, g and y",
        f"C={C}, m3={m3}, 2*m2={m2x2}, Wp={Wp}, aligned={ok}")


def k2a_lite(ds, g, y, ds1, ds2, wp, bp, alpha, beta, D, A1, ihr, ihi, iwr,
             iwi, *, Hp: int, Wp: int, tables=None, variant: str | None = None):
    """(ds like x; g, y [BT, 2m2*m3, 2C]; ds1, ds2, bp [C], wp [C, C] f32;
    the [Y, 2] lite statics) → dg; the lite mode of csrc/fno_k2a.cu. The
    [C]- and [C, C]-sized folds of ds1, ds2 and bp are made here.
    ``variant`` names one of VARIANTS['k2a_lite']; by default
    ``k2a_lite_variant`` chooses. The mma and tf32 variants need ``tables`` =
    (iw, ih), the DFT tables of ``ops/fno_layer._k2a_mma_tables`` in
    bfloat16 (mma) or float32 (tf32)."""
    dt = _io_dtype(ds)
    dev, f32 = ds.device, torch.float32
    BT, C = ds.shape[0], ds.shape[-1] // 2
    m2x2, m3 = ihr.shape[0], iwr.shape[0]
    Y = m2x2 * m3
    _check("ds", ds, dev, ds.dtype, (BT, Hp * Wp // 2, 2 * C))
    for n, t in (("g", g), ("y", y)):
        _check(n, t, dev, ds.dtype, (BT, Y, 2 * C))
    _vecs(dev, C, ds1=ds1, ds2=ds2, bp=bp)
    for n, t, sh in (("wp", wp, (C, C)), ("alpha", alpha, (Y, 2)),
                     ("beta", beta, (Y, 2)), ("D", D, (Y, 2)), ("A1", A1, (Y, 2)),
                     ("ihr", ihr, (m2x2, Hp)), ("ihi", ihi, (m2x2, Hp)),
                     ("iwr", iwr, (m3, Wp)), ("iwi", iwi, (m3, Wp))):
        _check(n, t, dev, f32, sh)
    name, code = _k2a_lite_variant(ds, g, y, C, m2x2, m3, Wp, variant)
    iw = ih = ctypes.c_void_p(None)
    if name in _TC_DTYPES:
        iw, ih = _wh_tables("k2a_lite", name, tables, dev, Hp, Wp, m2x2, m3)
        if not _layouts_agree("k2a_lite", name, Wp, m3, C):
            raise RuntimeError("k2a_lite: the shared-memory layouts of kernels.py and "
                               "fno_k2a.cu differ")
    else:
        _check_k1_shape("k2a_lite", C, m2x2, m3)
    two = (2.0 * ds2).contiguous()
    dsc = (ds1 + two * bp).contiguous()
    wps = (wp * two[None, :]).contiguous()
    dg = torch.empty((BT, Y, 2 * C), dtype=ds.dtype, device=dev)
    _launch("k2a_lite", library().fno_k2a, dev, _p(ds), ctypes.c_void_p(None),
            _p(g), _p(y), _p(dsc), _p(two), _p(wps), _p(alpha), _p(beta), _p(D),
            _p(A1), _p(ihr), _p(ihi), _p(iwr), _p(iwi), iw, ih, _p(dg), BT, Hp, Wp, C,
            m2x2, m3, 1, code, dt)
    VARIANTS["k2a_lite"][name] += 1
    return dg


def _k12b_variant(x, s, ds, dy, C: int, m2x2: int, m3: int, Wp: int,
                  variant: str | None) -> tuple:
    """(name, code) of the K12B variant that runs on (x, s, ds, dy); see
    ``_tc_variant``."""
    ok = aligned(x, s, ds, dy)
    return _tc_variant(
        "k12b", k12b_variant(x.dtype, C, m2x2, m3, Wp, ok), variant, x.dtype,
        f"C in {K12B_MMA_WIDTHS}, m3 in {K12B_MMA_M3}, 2*m2 <= 32, at most "
        f"{K12B_MMA_MAX_WARPS} warps of 16 columns of W, a block within {MAX_SMEM_BYTES} "
        "bytes of shared memory and 16-byte aligned x, s, ds and dy",
        f"C={C}, m3={m3}, 2*m2={m2x2}, Wp={Wp}, aligned={ok}")


def k12b(x, a, b, wp, s, ds, ds1, ds2, dy, ehr, ehi, ewr, ewi, *, Hp: int,
         Wp: int, act: str, tables=None, variant: str | None = None):
    """(x, s, ds like x; dy [BT, 2m2*m3, 2C]) → (dx like x, dWp [C, C],
    da, db, dbp [C] f32); see csrc/fno_k12b.cu. ``variant`` names one of
    VARIANTS['k12b']; by default ``k12b_variant`` chooses. The mma variant
    needs ``tables`` = (ah, ew), the packed bf16 hi/lo DFT tables of
    ``ops/fno_layer._k12b_mma_tables``; the tf32 variant the f32 tables of
    ``ops/fno_layer._k12b_tf32_tables``."""
    dt = _io_dtype(x)
    dev, f32 = x.device, torch.float32
    BT, C = x.shape[0], x.shape[-1] // 2
    m2x2, m3 = ehr.shape[1], ewr.shape[1]
    for n, t in (("x", x), ("s", s), ("ds", ds)):
        _check(n, t, dev, x.dtype, (BT, Hp * Wp // 2, 2 * C))
    _check("dy", dy, dev, x.dtype, (BT, m2x2 * m3, 2 * C))
    _vecs(dev, C, a=a, b=b, ds1=ds1, ds2=ds2)
    for n, t, sh in (("wp", wp, (C, C)), ("ehr", ehr, (Hp, m2x2)),
                     ("ehi", ehi, (Hp, m2x2)), ("ewr", ewr, (Wp, m3)),
                     ("ewi", ewi, (Wp, m3))):
        _check(n, t, dev, f32, sh)
    name, code = _k12b_variant(x, s, ds, dy, C, m2x2, m3, Wp, variant)
    ah = ew = ctypes.c_void_p(None)
    if name in _TC_DTYPES:
        nch, wpad = -(-Hp // K12B_MMA_ROWS[C]), -(-Wp // 16) * 16
        kmult = 16 if name == "mma" else 8
        pair = (2,) if name == "mma" else ()
        ah, ew = _check_tables("k12b", name, tables, dev, {
            "ah": (*pair, nch, 16, -(-2 * m2x2 // kmult) * kmult), "ew": (*pair, wpad, 2 * m3)})
        if not _layouts_agree("k12b", name, Wp, C, m2x2, m3):
            raise RuntimeError("k12b: the shared-memory layouts of kernels.py and "
                               "fno_k12b.cu differ")
    elif C > 128 or 256 % C:
        raise ValueError(f"k12b takes C <= 128 dividing 256; got C={C}")
    lib = library()
    n = C * C + 3 * C
    dx = torch.empty_like(x)
    partial = torch.empty(lib.fno_k12b_partial_floats(BT, Hp, Wp, C, code), dtype=f32,
                          device=dev)
    out = torch.empty(n, dtype=f32, device=dev)
    _launch("k12b", lib.fno_k12b, dev, _p(x), _p(a), _p(b), _p(wp), _p(s),
            _p(ds), _p(ds1), _p(ds2), _p(dy), _p(ehr), _p(ehi), _p(ewr), _p(ewi),
            ah, ew, _p(dx), _p(partial), _p(out), BT, Hp, Wp, C, m2x2, m3,
            ACT_CODES[act], code, dt)
    VARIANTS["k12b"][name] += 1
    dwp = out[:C * C].view(C, C)
    if name != "fma":   # mma, tf32: (dWp, dbp, da, db)
        dbp, da, db = out[C * C:].view(3, C)
    else:               # (dWp, da, db, dbp)
        da, db, dbp = out[C * C:].view(3, C)
    return dx, dwp, da, db, dbp


def _tail_checks(s, target, k1, b1, k2, b2, dims, tail_dims, act):
    if act not in ("exact", "tanh"):
        raise ValueError(f"the tail kernels take act 'exact' or 'tanh'; got {act!r}")
    dev, f32 = s.device, torch.float32
    B, Tp, Hp, Wp, C = dims
    T, H, W = tail_dims
    H1, F = k2.shape
    _check("s", s, dev, s.dtype, (B * Tp, Hp * Wp // 2, 2 * C))
    for n, t, sh in (("target", target, (B, T, H, W, F)), ("k1", k1, (C, H1)),
                     ("b1", b1, (H1,)), ("k2", k2, (H1, F)), ("b2", b2, (F,))):
        _check(n, t, dev, f32, sh)
    if H1 != 128 or F > TAIL_MAX_F or C % 8 or C > 128:
        raise ValueError(f"the tail kernels take fc1 width 128, F <= {TAIL_MAX_F} and C "
                         f"a multiple of 8 up to 128; got {H1}, {F}, {C}")
    return (B, T, H, W, Tp, Hp, Wp, C, H1, F)


def _tail_variant(kernel: str, s, C: int, F: int, variant: str | None,
                  act: str = "exact"):
    """(name, code) of the variant of K3F or K3B that runs on s: the one
    named, or the one ``k3f_variant`` / ``k3b_variant`` chooses; see
    ``_tc_variant``."""
    ok = aligned(s)
    choose = k3f_variant if kernel == "k3f" else k3b_variant
    return _tc_variant(kernel, choose(s.dtype, C, F, ok, act), variant, s.dtype,
                       f"C in {K3B_MMA_WIDTHS} at F <= 8, (C, act) in "
                       f"{K3_WIDE_F_INSTANCES} at F <= {TAIL_MAX_F}, and 16-byte aligned s",
                       f"C={C}, F={F}, act={act!r}, aligned={ok}")


def _tail_layouts(kernel: str, name: str, C: int, F: int) -> None:
    """A tensor-core variant's shared memory as fno_tail.cu lays it out
    against this module's, on which the variant functions decide."""
    if name in _TC_DTYPES and not _layouts_agree(kernel, name, C, F):
        raise RuntimeError(f"{kernel}: the shared-memory layouts of kernels.py and "
                           "fno_tail.cu differ")


def k3f(s, target, k1, b1, k2, b2, *, dims, tail_dims, act: str,
        variant: str | None = None):
    """SSE of the fused tail (0-d f32 tensor); see csrc/fno_tail.cu.
    ``variant`` names one of VARIANTS['k3f']; by default ``k3f_variant``
    chooses."""
    ints = _tail_checks(s, target, k1, b1, k2, b2, dims, tail_dims, act)
    dt = _io_dtype(s)
    B, T, H, W, C, F = (ints[i] for i in (0, 1, 2, 3, 7, 9))
    name, code = _tail_variant("k3f", s, C, F, variant, act)
    _tail_layouts("k3f", name, C, F)
    lib = library()
    with torch.cuda.device(s.device):   # the mma grid fills this card's SMs
        nparts = lib.fno_k3f_num_partials(B, T, H, W, C, F, ACT_CODES[act], code)
    if nparts < 1:
        raise RuntimeError(f"k3f: no partial count for the {name} variant")
    partial = torch.empty(nparts, dtype=torch.float32, device=s.device)
    sse = torch.empty((), dtype=torch.float32, device=s.device)
    _launch("k3f", lib.fno_k3f, s.device, _p(s), _p(target), _p(k1),
            _p(b1), _p(k2), _p(b2), _p(partial), _p(sse), *ints, ACT_CODES[act],
            code, dt)
    VARIANTS["k3f"][name] += 1
    return sse


def k3b(s, target, k1, b1, k2, b2, g, *, dims, tail_dims, act: str,
        variant: str | None = None):
    """With g = dL/dSSE (0-d f32 on the card): (ds like s, zero outside the
    crop; dk1 [C, H1], db1 [H1], dk2 [H1, F], db2 [F] f32). ``variant`` names
    one of VARIANTS['k3b']; by default ``k3b_variant`` chooses."""
    ints = _tail_checks(s, target, k1, b1, k2, b2, dims, tail_dims, act)
    dt = _io_dtype(s)
    _check("g", g, s.device, torch.float32, ())
    B, T, H, W, Tp, C, H1, F = (ints[i] for i in (0, 1, 2, 3, 4, 7, 8, 9))
    name, code = _tail_variant("k3b", s, C, F, variant, act)
    _tail_layouts("k3b", name, C, F)
    lib = library()
    n = C * H1 + H1 + H1 * F + F
    ds = torch.empty_like(s)
    with torch.cuda.device(s.device):   # the mma grid is one block an SM of this card
        nparts = lib.fno_k3b_num_partials(B, T, H, W, Tp, C, F, ACT_CODES[act], code)
    if nparts < 1:
        raise RuntimeError(f"k3b: no partial count for the {name} variant")
    partial = torch.empty((nparts, n), dtype=torch.float32, device=s.device)
    out = torch.empty(n, dtype=torch.float32, device=s.device)
    _launch("k3b", lib.fno_k3b, s.device, _p(s), _p(target), _p(k1),
            _p(b1), _p(k2), _p(b2), _p(g), _p(ds), _p(partial), _p(out), *ints,
            ACT_CODES[act], code, dt)
    VARIANTS["k3b"][name] += 1
    dk1, db1, dk2, db2 = out.split([C * H1, H1, H1 * F, F])
    return ds, dk1.view(C, H1), db1, dk2.view(H1, F), db2


# head widths the TA kernels are instantiated for (csrc/temporal_attention.cu)
TA_HEAD_DIMS = (8, 16, 32, 64)
TA_MAX_TASKS = 256   # heads * T: one thread per (head, row) of a site
# TA backward's mma variant: head widths, the longest T (rows and columns of
# a warp's tiles padded to 32), heads (a warp each), the ring's stages, the
# row stride of a warp's P / dS tile
TA_MMA_HEAD_DIMS, TA_MMA_MAX_T, TA_MMA_MAX_HEADS = (16, 32, 64), 32, 8
TA_MMA_STAGES, TA_MMA_TILE_STRIDE = 2, 40
# the tf32 variants (the mma variants' shapes): the ring's stages, the f32
# padding of a ring row (kTaTf32Stages, kTaPadF)
TA_TF32_STAGES, TA_TF32_PAD = 2, 4


def ta_fwd_mma_smem_bytes(T: int, heads: int, d: int) -> int:
    """Shared memory of a block of TA forward's mma variant
    (csrc/temporal_attention.cu::TaFwdMmaLayout): the ring of q, k and v
    rows (bf16, rows padded by 8), a zero row, the bias with its columns
    padded to 8·ceil(T/8) (f32)."""
    rs = heads * d + 8
    return TA_MMA_STAGES * 3 * T * rs * 2 + 128 + heads * T * 8 * -(-T // 8) * 4


def ta_fwd_tf32_smem_bytes(T: int, heads: int, d: int) -> int:
    """Shared memory of a block of TA forward's tf32 variant
    (csrc/temporal_attention.cu::TaFwdTf32Layout): the ring of q, k and v
    rows (f32, rows padded by 4), a zero row of 64 floats, the bias with
    its columns padded to 8·ceil(T/8)."""
    rs = heads * d + TA_TF32_PAD
    return TA_TF32_STAGES * 3 * T * rs * 4 + 256 + heads * T * 8 * -(-T // 8) * 4


def _ta_tc_shape(T: int, heads: int, d: int, aligned: bool) -> bool:
    """The shapes both tensor-core variants of the TA kernels take: d in
    (16, 32, 64), T <= 32, at most 8 heads, heads * T <= 256, 16-byte
    aligned tensors."""
    return (aligned and d in TA_MMA_HEAD_DIMS and T <= TA_MMA_MAX_T
            and heads * T <= TA_MAX_TASKS and heads <= TA_MMA_MAX_HEADS)


def ta_fwd_variant(dtype, T: int, heads: int, d: int, aligned: bool = True) -> str:
    """At the tensor-core shapes (d in (16, 32, 64), T <= 32, heads * T <=
    256, at most 8 heads, 16-byte aligned q, k and v) with the block within
    the shared memory: 'mma' for bfloat16, 'tf32' for float32; else
    'fma'."""
    if not _ta_tc_shape(T, heads, d, aligned):
        return "fma"
    return _tc_choice(dtype, ta_fwd_mma_smem_bytes(T, heads, d),
                      ta_fwd_tf32_smem_bytes(T, heads, d))


def ta_bwd_mma_smem_bytes(T: int, heads: int, d: int) -> int:
    """Shared memory of a block of TA backward's mma variant
    (csrc/temporal_attention.cu::TaMmaLayout): the ring of q, k, v and do
    rows (bf16, rows padded by 8), a zero row, the warps' P / dS tiles
    (bf16), the block's dpb accumulator (f64), the bias with its columns
    padded to 8·ceil(T/8) (f32)."""
    rs = heads * d + 8
    return (TA_MMA_STAGES * 4 * T * rs * 2 + 128 + heads * 32 * TA_MMA_TILE_STRIDE * 2
            + heads * T * T * 8 + heads * T * 8 * -(-T // 8) * 4)


def ta_bwd_tf32_smem_bytes(T: int, heads: int, d: int) -> int:
    """Shared memory of a block of TA backward's tf32 variant
    (csrc/temporal_attention.cu::TaTf32Layout): the ring of q, k, v and do
    rows (f32, rows padded by 4), a zero row of 64 floats, the block's dpb
    accumulator (f64), the bias with its columns padded to 8·ceil(T/8) (f32);
    no P / dS tile."""
    rs = heads * d + TA_TF32_PAD
    return (TA_TF32_STAGES * 4 * T * rs * 4 + 256 + heads * T * T * 8
            + heads * T * 8 * -(-T // 8) * 4)


def ta_bwd_variant(dtype, T: int, heads: int, d: int, aligned: bool = True) -> str:
    """At the tensor-core shapes (d in (16, 32, 64), T <= 32, heads * T <=
    256, at most 8 heads, 16-byte aligned q, k, v and do) with the block
    within the shared memory: 'mma' for bfloat16, 'tf32' for float32; else
    'fma'."""
    if not _ta_tc_shape(T, heads, d, aligned):
        return "fma"
    return _tc_choice(dtype, ta_bwd_mma_smem_bytes(T, heads, d),
                      ta_bwd_tf32_smem_bytes(T, heads, d))


def _ta_checks(q, pos_bias, heads, **same):
    """(dtype code, sites, T, d) of a TA call on q [B, S, T, h*d]."""
    dt = _io_dtype(q)
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"temporal attention takes [B, S, T, h*d], got {tuple(q.shape)}")
    B, S, T, F = q.shape
    d = F // heads
    if F % heads or d not in TA_HEAD_DIMS or heads * T > TA_MAX_TASKS:
        raise ValueError(f"the TA kernels take a head width in {TA_HEAD_DIMS} and "
                         f"heads*T <= {TA_MAX_TASKS}; got F={F}, heads={heads}, T={T}")
    _check("q", q, dev, q.dtype, q.shape)
    for n, t in same.items():
        _check(n, t, dev, q.dtype, q.shape)
    _check("pos_bias", pos_bias, dev, torch.float32, (heads, T, T))
    for n, t in (("q", q), *same.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"{n}: not 16-byte aligned")
    return dt, B * S, T, d


def _ta_variant(kernel: str, tensors, T: int, heads: int, d: int, variant: str | None):
    """(name, code) of the variant of the TA forward or backward
    (``kernel``) that runs on ``tensors`` (q, k, v and, for the backward,
    do): the one named, or the one ``ta_fwd_variant`` / ``ta_bwd_variant``
    chooses; a named tensor-core variant (mma, tf32) that cannot take the
    input raises, before anything is built."""
    choose = ta_fwd_variant if kernel == "ta_fwd" else ta_bwd_variant
    q = tensors[0]
    ok = aligned(*tensors)
    chosen = choose(q.dtype, T, heads, d, ok)
    name = chosen if variant is None else variant
    code = _variant_code(kernel, name)
    if name in _TC_DTYPES:
        if chosen != name:
            what = "q, k and v" if kernel == "ta_fwd" else "q, k, v and do"
            kind = "bfloat16" if name == "mma" else "float32"
            raise ValueError(
                f"{kernel}: the {name} variant takes {kind}, d in {TA_MMA_HEAD_DIMS}, T <= "
                f"{TA_MMA_MAX_T}, heads*T <= {TA_MAX_TASKS}, at most {TA_MMA_MAX_HEADS} heads, "
                f"a block within {MAX_SMEM_BYTES} bytes of shared memory and 16-byte aligned "
                f"{what}; got {q.dtype}, d={d}, T={T}, heads={heads}, aligned={ok}")
    return name, code


def _check_ta_layout(kernel: str, name: str, T: int, heads: int, d: int) -> None:
    """A tensor-core variant's block as temporal_attention.cu lays it out
    against this module's size, on which the variant functions decide."""
    if name in _TC_DTYPES and (getattr(library(), f"{kernel}_{name}_smem_bytes")(T, heads, d)
                               != globals()[f"{kernel}_{name}_smem_bytes"](T, heads, d)):
        raise RuntimeError(f"{kernel}: the shared-memory layouts of kernels.py and "
                           "temporal_attention.cu differ")


def _ta_fwd_variant(q, k, v, T: int, heads: int, d: int, variant: str | None):
    return _ta_variant("ta_fwd", (q, k, v), T, heads, d, variant)


def _ta_bwd_variant(q, k, v, do, T: int, heads: int, d: int, variant: str | None):
    return _ta_variant("ta_bwd", (q, k, v, do), T, heads, d, variant)


def ta_fwd(q, k, v, pos_bias, heads: int, variant: str | None = None):
    """o = softmax(q k^T + pos_bias) v per (site, head) over T; q, k, v, o
    [B, S, T, h*d], pos_bias [h, T, T] f32; see csrc/temporal_attention.cu.
    ``variant`` names one of VARIANTS['ta_fwd']; by default
    ``ta_fwd_variant`` chooses."""
    dt, nsites, T, d = _ta_checks(q, pos_bias, heads, k=k, v=v)
    name, code = _ta_fwd_variant(q, k, v, T, heads, d, variant)
    _check_ta_layout("ta_fwd", name, T, heads, d)
    o = torch.empty_like(q)
    _launch("ta_fwd", library().ta_fwd, q.device, _p(q), _p(k), _p(v), _p(pos_bias), _p(o),
            nsites, T, heads, d, code, dt)
    VARIANTS["ta_fwd"][name] += 1
    return o


def ta_bwd(q, k, v, pos_bias, do, heads: int, variant: str | None = None):
    """(dq, dk, dv like q; dpb [h, T, T] f32, summed over all sites) of
    ta_fwd's output cotangent do; the weights are recomputed. ``variant``
    names one of VARIANTS['ta_bwd']; by default ``ta_bwd_variant``
    chooses."""
    dt, nsites, T, d = _ta_checks(q, pos_bias, heads, k=k, v=v, do=do)
    name, code = _ta_bwd_variant(q, k, v, do, T, heads, d, variant)
    _check_ta_layout("ta_bwd", name, T, heads, d)
    lib = library()
    with torch.cuda.device(q.device):   # a tensor-core grid fills this card's SMs
        n = lib.ta_bwd_num_partials(nsites, T, heads, d, code, dt)
    if n <= 0:
        raise ValueError(f"ta_bwd ({name}) refuses T={T}, heads={heads}, d={d}: its tile "
                         "does not fit shared memory")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    partial = torch.empty((n, heads, T, T), dtype=torch.float32, device=q.device)
    dpb = torch.empty((heads, T, T), dtype=torch.float32, device=q.device)
    _launch("ta_bwd", lib.ta_bwd, q.device, _p(q), _p(k), _p(v), _p(pos_bias),
            _p(do), _p(dq), _p(dk), _p(dv), _p(partial), _p(dpb), nsites, T,
            heads, d, code, dt)
    VARIANTS["ta_bwd"][name] += 1
    return dq, dk, dv, dpb


# head widths the scores kernel's variants are instantiated for
# (csrc/galerkin_scores.cu); the mma variant's tokens a tile, ring stages
# and padding of a staged row
GK_HEAD_DIMS = (16, 32, 64)
GK_MMA_TILE, GK_MMA_STAGES, GK_MMA_ROW_PAD = 32, 2, 8


def gk_scores_mma_smem_bytes(d: int, dtype) -> int:
    """Shared memory of a block of the scores' mma variant
    (csrc/galerkin_scores.cu::GkMmaLayout): the ring of k and v token rows
    in the input dtype, the affine parameters (f32), two buffers of the
    normalised rows of k and v as bf16 hi and lo (rows padded by 8)."""
    es = 4 if dtype == torch.float32 else 2
    return (GK_MMA_STAGES * 2 * GK_MMA_TILE * d * es + 4 * d * 4
            + 2 * 4 * GK_MMA_TILE * (d + GK_MMA_ROW_PAD) * 2)


def gk_scores_variant(dtype, d: int, aligned: bool = True) -> str:
    """'mma' for float32 or bfloat16 with d in (16, 32, 64) and 16-byte
    aligned k and v, else 'fma' (the wrapper takes no other input: the fma
    variant runs only when named)."""
    if dtype in _DTYPE_CODES and aligned and d in GK_HEAD_DIMS:
        return "mma"
    return "fma"


def _gk_scores_variant(k, v, d: int, variant: str | None):
    """(name, code) of the variant of the scores that runs on k and v: the
    one named, or the one ``gk_scores_variant`` chooses; a named mma variant
    that cannot take them raises, as do shared-memory layouts of this module
    and galerkin_scores.cu that differ."""
    ok = aligned(k, v)
    chosen = gk_scores_variant(k.dtype, d, ok)
    name = chosen if variant is None else variant
    code = _variant_code("gk_scores", name)
    if name == "mma":
        if chosen != "mma":
            raise ValueError(
                f"gk_scores: the mma variant takes float32 or bfloat16, d in {GK_HEAD_DIMS} "
                f"and 16-byte aligned k and v; got {k.dtype}, d={d}, aligned={ok}")
        if library().gk_scores_mma_smem_bytes(d, _DTYPE_CODES[k.dtype]) != \
                gk_scores_mma_smem_bytes(d, k.dtype):
            raise RuntimeError("gk_scores: the shared-memory layouts of kernels.py and "
                               "galerkin_scores.cu differ")
    return name, code


def gk_scores(k, v, k_scale, k_bias, v_scale, v_bias, heads: int, eps: float,
              variant: str | None = None, n_total: int | None = None):
    """LN(k)ᵀ·LN(v)/``n_total`` per (batch, head), with per-head affine
    LayerNorms: k, v [B, N, h·d] (float32 or bfloat16, the Dense's token
    layout), the affine [h, d] f32 → [B, h, d, d] f32; see
    csrc/galerkin_scores.cu. ``n_total`` (at least N; default N) is the
    global token count on a token shard. ``variant`` names one of
    VARIANTS['gk_scores']; by default ``gk_scores_variant`` chooses."""
    dt = _io_dtype(k)
    dev = k.device
    if k.dim() != 3:
        raise ValueError(f"gk_scores takes [B, N, h*d], got {tuple(k.shape)}")
    B, N, F = k.shape
    d = F // heads
    if F % heads or d not in GK_HEAD_DIMS or N < 1:
        raise ValueError(f"gk_scores takes a head width in {GK_HEAD_DIMS} and N >= 1; "
                         f"got F={F}, heads={heads}, N={N}")
    n_total = N if n_total is None else int(n_total)
    if n_total < N:
        raise ValueError(f"gk_scores: n_total {n_total} < N {N}")
    _check("k", k, dev, k.dtype, (B, N, F))
    _check("v", v, dev, k.dtype, (B, N, F))
    for n, t in (("k_scale", k_scale), ("k_bias", k_bias), ("v_scale", v_scale),
                 ("v_bias", v_bias)):
        _check(n, t, dev, torch.float32, (heads, d))
    for n, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{n}: not 16-byte aligned")
    name, code = _gk_scores_variant(k, v, d, variant)
    lib = library()
    with torch.cuda.device(dev):   # the mma grid fills this card's SMs
        n = lib.gk_scores_num_partials(B, N, heads, d, code, dt)
    if n < 1:
        raise RuntimeError(f"gk_scores: no partial count for the {name} variant")
    partial = torch.empty((n, B, heads, d, d), dtype=torch.float32, device=dev)
    out = torch.empty((B, heads, d, d), dtype=torch.float32, device=dev)
    _launch("gk_scores", lib.gk_scores, dev, _p(k), _p(v), _p(k_scale), _p(k_bias),
            _p(v_scale), _p(v_bias), _p(partial), _p(out), B, N, n_total, heads, d, float(eps),
            code, dt)
    VARIANTS["gk_scores"][name] += 1
    return out
