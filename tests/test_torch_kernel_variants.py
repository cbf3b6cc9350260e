"""The variants of the port's K1, T-stage, K2, K2A-lite, K12B, K3F, K3B,
TA forward and backward and Galerkin scores kernels, as far as the CPU
shows.

The kernels themselves run only on the card (tests/test_torch_kernels.py,
marker ``gpu``). Here: the host side of the tensor-core variants (the bf16
hi + lo split of the constants, the packed tables' layouts, and each
variant's arithmetic replayed in plain PyTorch from those tables, with its
rounding points, against the twin and, unrounded in f32, against the Pallas
kernel in interpret mode, rtol 2e-4 with atol 2e-4·max|ref|); the choice of
variant as a pure function of dtype, shape and alignment, at the shipped
FNO configs, at the odd shapes of the gpu tests and at a view at an odd
storage offset; and the T-stage twin against the JAX ``t_stage`` (Pallas,
interpret mode) at two more (Tp, m1), f32. K2A-lite's and K3B's replays
reach the Pallas ``_k2a_lite_kernel`` through ``_layer_calls`` and
``_k3b_kernel`` through the JAX fused tail's vjp. The replays of the TA
forward's and backward's and the Galerkin scores' tensor-core variants are
in tests/test_torch_temporal_attention.py and tests/test_torch_galerkin.py;
here their choice, the refusal of a named mma variant on input it cannot
take, and the shared-memory layouts' constants against the sources.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch.nn.functional as F
import pytest
import torch
import yaml

from realpdebench_tpu.ops.pallas import fno_layer as jfl
from realpdebench_tpu.ops.pallas import fno_tail as jft
from realpdebench_tpu_torch.ops import fno_layer as tfl
from realpdebench_tpu_torch.ops import fno_tail as ft
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.activations import gelu_grad

CONFIGS = Path(jfl.__file__).resolve().parents[2] / "configs"
GEOMETRIES = [  # (Hp, Wp, m2, m3, rows a block): the cylinder's, and two of the gpu tests'
    (70, 134, 12, 16, 5),
    (13, 22, 5, 8, 8),
    (17, 38, 4, 16, 3),
]


def _table(name):
    if name == "random":
        r = np.random.default_rng(0)
        return torch.from_numpy((r.normal(size=(64, 64)) * 10.0 ** r.integers(
            -6, 3, size=(64, 64))).astype(np.float32))
    return torch.from_numpy(tfl._ct_consts(70, 134, 12, 16)[name])


@pytest.mark.parametrize("name", ["ihr", "ihi", "iwr", "iwi", "random"])
def test_split_bf16_carries_sixteen_bits(name):
    """hi + lo equals the f32 table to 2^-16 relative; both parts are
    bfloat16 values (their f32 images survive a round trip through bf16)."""
    t = _table(name)
    hi, lo = kernels.split_bf16(t)
    assert hi.dtype == lo.dtype == torch.bfloat16 and hi.shape == lo.shape == t.shape
    for part in (hi, lo):
        assert torch.equal(part.float().to(torch.bfloat16), part)
    err = (hi.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2.0 ** -16 * t.double().abs()).all())
    # hi alone is off by up to 2^-9: the reason for the pair
    assert (hi.double() - t.double()).abs().max() > 2.0 ** -12 * t.abs().max()


@pytest.mark.parametrize("geo", GEOMETRIES)
def test_packed_tables_hold_the_dft_tables(geo):
    """ah and iw, hi + lo, against _ct_consts: every entry in its place, the
    sign of the imaginary block, zeros in the padding."""
    Hp, Wp, m2, m3, rows = geo
    assert rows in kernels.K2_MMA_ROWS.values()
    c = tfl._ct_consts(Hp, Wp, m2, m3)
    ah, iw = (t.float().sum(0).numpy() for t in tfl._k2_mma_tables(*geo))
    nch, kpad = -(-Hp // rows), -(-4 * m2 // 16) * 16
    assert ah.shape == (nch, 16, kpad) and iw.shape == (-(-Wp // 16) * 16, 2 * m3)
    assert not ah[:, rows:8].any() and not ah[:, 8 + rows:].any()
    tol = dict(rtol=2.0 ** -16, atol=0)
    for h in range(nch * rows):
        re, im = ah[h // rows, h % rows], ah[h // rows, 8 + h % rows]
        if h >= Hp:
            assert not re.any() and not im.any()
            continue
        np.testing.assert_allclose(re[:2 * m2], c["ihr"][:, h], **tol)
        np.testing.assert_allclose(re[2 * m2:4 * m2], -c["ihi"][:, h], **tol)
        np.testing.assert_allclose(im[:2 * m2], c["ihi"][:, h], **tol)
        np.testing.assert_allclose(im[2 * m2:4 * m2], c["ihr"][:, h], **tol)
        assert not re[4 * m2:].any() and not im[4 * m2:].any()
    np.testing.assert_allclose(iw[:Wp, :m3], c["iwr"].T, **tol)
    np.testing.assert_allclose(iw[:Wp, m3:], c["iwi"].T, **tol)
    assert not iw[Wp:].any()


def _replay_mma_variant(g, x, a, b, wp, bp, tables, *, Hp, Wp, m2, m3, rows, act):
    """K2's tensor-core variant in plain PyTorch from the packed tables: the
    same three products on the same operands (bf16 hi + lo constants, z and
    ih split in two, the lo·lo terms dropped), accumulated in f64."""
    BT, C = x.shape[0], x.shape[-1] // 2
    ah, iw = (t.double() for t in tables)                     # [2, ...] hi, lo
    g5 = g.double().view(BT, 2 * m2, m3, 2, C)
    G = torch.cat([g5[:, :, :, 0], g5[:, :, :, 1]], dim=1)    # [BT, (p', j), m3, C]
    AH = ah.sum(0)[..., :4 * m2]                              # [nch, 16, K]
    ih = torch.einsum("nrk,bkmc->bnrmc", AH, G)               # rows r: (part, hl)
    ih = ih.view(BT, -1, 2, 8, m3, C)[:, :, :, :rows].transpose(2, 3)
    ih = ih.reshape(BT, -1, 2 * m3, C)[:, :Hp]                # [BT, Hp, (part, m), C]
    ih_hi, ih_lo = (t.double() for t in kernels.split_bf16(ih))
    spec = (torch.einsum("wk,bhkc->bhwc", iw.sum(0)[:Wp], ih_hi)
            + torch.einsum("wk,bhkc->bhwc", iw[0, :Wp], ih_lo))
    z = tfl._act(x.float().view(BT, Hp, Wp, C) * a + b, act)
    zh = z.to(torch.bfloat16)
    zl = (z - zh.float()).to(torch.bfloat16)
    wh, wl = (t.double() for t in kernels.split_bf16(wp))
    s = spec + zh.double() @ wh + zl.double() @ wh + zh.double() @ wl + bp.double()
    return s.float(), torch.stack([s.sum((0, 1, 2)), (s * s).sum((0, 1, 2))]).float()


@pytest.mark.parametrize("act", ["none", "exact"])
@pytest.mark.parametrize("geo", GEOMETRIES[1:])
def test_packed_tables_reproduce_k2(geo, act):
    """The replay agrees with the twin to 1e-4·max|ref| in s and to 1e-5 of
    the sum of |terms| per channel in the statistics, ten times inside the
    bound the kernel is held to on the card: every operand carries 16 bits.
    (One bf16 rounding of ih alone, shared by a row's Wp columns, puts 1e-4
    on the sum of squares at a few hundred rows.)"""
    Hp, Wp, m2, m3, rows = geo
    BT, C = 6, 32
    r = np.random.default_rng(1)
    f = lambda *s, scale=1.0, loc=0.0: torch.from_numpy(
        (loc + scale * r.normal(size=s)).astype(np.float32))
    x = f(BT, Hp * Wp // 2, 2 * C).to(torch.bfloat16)
    g = f(BT, 2 * m2 * m3, 2 * C, scale=20.0).to(torch.bfloat16)   # spectral above pointwise
    a, b, wp, bp = f(C, scale=0.1, loc=1.0), f(C, scale=0.1), f(C, C, scale=0.2), f(C, scale=0.1)
    kw = dict(Hp=Hp, Wp=Wp, act=act)
    _, st_ref = tfl.k2_plain(g, x, a, b, wp, bp,
                             tfl._ct_on(torch.device("cpu"), *geo[:4]), **kw)
    s, st = _replay_mma_variant(g, x, a, b, wp, bp, tfl._k2_mma_tables(*geo), m2=m2, m3=m3,
                                rows=rows, **kw)
    # the twin's arithmetic in f64: its own s is rounded to bf16
    s64 = _twin_s64(g, x, a, b, wp, bp, geo[:4], act)
    assert (s.double() - s64).abs().max() <= 1e-4 * s64.abs().max()
    terms = torch.stack([s64.abs().sum((0, 1, 2)), (s64 * s64).sum((0, 1, 2))])
    ref = torch.stack([s64.sum((0, 1, 2)), (s64 * s64).sum((0, 1, 2))])
    assert ((st.double() - ref).abs() / terms).max() <= 1e-5
    assert ((st_ref.double() - ref).abs() / terms).max() <= 1e-5


def _twin_s64(g, x, a, b, wp, bp, geo, act):
    """k2_plain's arithmetic in f64: the unrounded s [BT, Hp, Wp, C]."""
    Hp, Wp, m2, m3 = geo
    c = {k: torch.from_numpy(v).double() for k, v in tfl._ct_consts(*geo).items()}
    BT, C = x.shape[0], x.shape[-1] // 2
    g5 = g.double().view(BT, 2 * m2, m3, 2, C)
    gR, gI = g5[..., 0, :], g5[..., 1, :]
    e = lambda v, M: torch.einsum("bjmc,jh->bhmc", v, M)
    ihR, ihI = e(gR, c["ihr"]) - e(gI, c["ihi"]), e(gR, c["ihi"]) + e(gI, c["ihr"])
    spec = (torch.einsum("bhmc,mw->bhwc", ihR, c["iwr"])
            + torch.einsum("bhmc,mw->bhwc", ihI, c["iwi"]))
    z = tfl._act(x.double().view(BT, Hp, Wp, C) * a.double() + b.double(), act)
    return spec + z @ wp.double() + bp.double()


def _fno_config(scenario):
    cfg = yaml.safe_load((CONFIGS / scenario / "fno.yaml").read_text())
    return cfg["width"], cfg["modes1"], cfg["modes2"], cfg["modes3"]


@pytest.mark.parametrize("scenario", sorted(p.parent.name for p in CONFIGS.glob("*/fno.yaml")))
def test_shipped_configs_choose_the_redesigned_variants(scenario):
    """Every shipped FNO config (cylinder 4/12/16 at width 64, combustion
    4/16/16, fsi at width 128, ...) runs K1, K2, K2A-lite, K12B, K3F and K3B
    on the tensor cores and the T-stage from registers under bf16 compute;
    under f32 all six on the tensor cores as 3xTF32 (their tf32 blocks fit at
    every shipped width, fsi's 128 included), at a 20-frame window padded to
    26 and a grid up to 134 wide; K12B's fma variant takes every width, fsi's
    128 included."""
    C, m1, m2, m3 = _fno_config(scenario)
    for Wp in (70, 134):
        assert kernels.k2_variant(torch.bfloat16, C, m3, Wp, 2 * m2) == "mma"
        assert kernels.k2_variant(torch.float32, C, m3, Wp, 2 * m2) == "tf32"
        assert kernels.k1_variant(torch.bfloat16, C, 2 * m2, m3, Wp) == "mma"
        assert kernels.k1_variant(torch.float32, C, 2 * m2, m3, Wp) == "tf32"
        assert kernels.k12b_variant(torch.bfloat16, C, 2 * m2, m3, Wp) == "mma"
        assert kernels.k12b_variant(torch.float32, C, 2 * m2, m3, Wp) == "tf32"
        assert kernels.k2a_lite_variant(torch.bfloat16, C, 2 * m2, m3, Wp) == "mma"
        assert kernels.k2a_lite_variant(torch.float32, C, 2 * m2, m3, Wp) == "tf32"
        assert C <= 128 and 256 % C == 0      # K12B fma and the tail kernels
    # fc2's widest F = c_out·mult: the combustion scenario's 16 channels; 3
    # channels over at most 2 steps in the others
    F_ = 16 if scenario == "combustion" else 3 * 2
    assert kernels.k3b_variant(torch.bfloat16, C, F_) == "mma"
    assert kernels.k3b_variant(torch.float32, C, F_) == "tf32"
    assert kernels.k3f_variant(torch.bfloat16, C, F_) == "mma"
    assert kernels.k3f_variant(torch.float32, C, F_) == "tf32"
    for dtype in (torch.bfloat16, torch.float32):
        for tin, tout in ((26, 2 * m1), (2 * m1, 26)):
            assert kernels.t_stage_variant(dtype, C, tin, tout) == "registers"


def test_a_view_at_an_odd_offset_chooses_the_unaligned_variants():
    """A contiguous view that starts 2 bytes past a 16-byte boundary is not
    aligned; every choice then falls to the variant with scalar loads."""
    base = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    view = base[1:1 + 4 * 64].view(4, 64)
    assert view.is_contiguous() and not kernels.aligned(view)
    assert kernels.aligned(base) and not kernels.aligned(base, view)
    ok = kernels.aligned(view)
    assert kernels.k1_variant(torch.bfloat16, 64, 24, 16, 134, ok) == "fma"
    assert kernels.k2_variant(torch.bfloat16, 64, 16, 134, 24, ok) == "fma"
    assert kernels.k12b_variant(torch.bfloat16, 64, 24, 16, 134, ok) == "fma"
    assert kernels.k2a_lite_variant(torch.bfloat16, 64, 24, 16, 134, ok) == "fma"
    assert kernels.k3b_variant(torch.bfloat16, 64, 3, ok) == "fma"
    assert kernels.k3f_variant(torch.bfloat16, 64, 3, ok) == "fma"
    assert kernels.ta_bwd_variant(torch.bfloat16, 20, 4, 32, ok) == "fma"
    assert kernels.t_stage_variant(torch.bfloat16, 64, 26, 8, ok) == "generic"


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 64, 24, 16, 134), "mma"),    # the cylinder
    ((torch.bfloat16, 128, 32, 16, 134), "mma"),   # fsi
    ((torch.bfloat16, 32, 10, 8, 22), "mma"),      # the gpu tests' small shapes
    ((torch.bfloat16, 16, 6, 8, 12), "mma"),       # one 16-channel slice
    ((torch.bfloat16, 8, 6, 4, 12), "fma"),        # C below a slice
    ((torch.bfloat16, 40, 6, 8, 12), "fma"),       # C no multiple of 16
    ((torch.bfloat16, 64, 24, 12, 134), "fma"),    # m3 not instantiated
    ((torch.bfloat16, 64, 34, 16, 134), "fma"),    # more than 32 H modes
    ((torch.bfloat16, 64, 24, 16, 258), "fma"),    # Wp past 256
    ((torch.float32, 64, 24, 16, 134), "tf32"),    # f32 on the tensor cores as 3xTF32
])
def test_k1_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.k1_variant(*args) == want
    if want == "mma":
        assert kernels.k1_mma_smem_bytes(args[4], args[3]) <= kernels.MAX_SMEM_BYTES
    if want == "tf32":
        assert kernels.k1_tf32_smem_bytes(args[4], args[3]) <= kernels.MAX_SMEM_BYTES


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 64, 24, 16, 134), "mma"),    # the cylinder: 9 warps
    ((torch.bfloat16, 128, 32, 16, 134), "mma"),   # fsi: 9 warps, 187 KB
    ((torch.bfloat16, 128, 32, 16, 146), "fma"),   # a 10th warp at C 128
    ((torch.bfloat16, 64, 24, 16, 256), "mma"),    # 16 warps
    ((torch.bfloat16, 64, 24, 16, 258), "fma"),    # a 17th warp
    ((torch.bfloat16, 32, 10, 8, 22), "mma"),
    ((torch.bfloat16, 16, 6, 8, 12), "fma"),       # C not instantiated
    ((torch.bfloat16, 64, 24, 4, 134), "fma"),     # 2*m3 no multiple of 16
    ((torch.bfloat16, 64, 34, 16, 134), "fma"),    # more than 32 H modes
    ((torch.float32, 128, 32, 16, 134), "tf32"),   # f32 on the tensor cores: fsi's dz block fits
])
def test_k12b_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.k12b_variant(*args) == want
    dtype, C, m2x2, m3, Wp = args
    if want == "mma":
        assert kernels.k12b_mma_smem_bytes(Wp, C, m2x2, m3) <= kernels.MAX_SMEM_BYTES
    if want == "tf32":
        assert kernels.k12b_tf32_smem_bytes(Wp, C, m2x2, m3) <= kernels.MAX_SMEM_BYTES


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 32, 8, 22, 10), "mma"),      # the gpu tests' small shapes
    ((torch.bfloat16, 128, 8, 20, 6), "mma"),
    ((torch.bfloat16, 8, 4, 12, 6), "fma"),        # C below the MMA tile
    ((torch.bfloat16, 32, 6, 22, 10), "fma"),      # 2*m3 no multiple of 16
    ((torch.bfloat16, 64, 4, 20, 6), "fma"),
    ((torch.float32, 64, 16, 134, 24), "tf32"),    # f32 on the tensor cores, the cylinder
    ((torch.bfloat16, 64, 16, 256, 24), "mma"),    # 16 warps
    ((torch.bfloat16, 64, 16, 258, 24), "fma"),    # a 17th warp
    ((torch.bfloat16, 128, 16, 134, 32), "mma"),   # fsi's width: 9 warps, 206 KB
    ((torch.bfloat16, 128, 16, 146, 32), "fma"),   # a 10th warp at C 128
    ((torch.bfloat16, 64, 16, 134, 34), "fma"),    # more than 32 H modes
])
def test_k2_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.k2_variant(*args) == want
    assert kernels.k2_variant(*args) == want       # no state
    dtype, C, m3, Wp, m2x2 = args
    if want == "mma":
        assert kernels.k2_mma_smem_bytes(Wp, C, m2x2, m3) <= kernels.MAX_SMEM_BYTES
    if want == "tf32":
        assert kernels.k2_tf32_smem_bytes(Wp, C, m2x2, m3) <= kernels.MAX_SMEM_BYTES


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 64, 26, 8), "registers"),
    ((torch.float32, 64, 8, 26), "registers"),
    ((torch.float32, 8, 6, 4), "registers"),
    ((torch.bfloat16, 12, 16, 40), "registers"),
    ((torch.bfloat16, 8, 20, 18), "generic"),      # the shorter side above 16
    ((torch.float32, 6, 9, 4), "generic"),         # channels no multiple of 4
])
def test_t_stage_variant_is_a_pure_function_of_shape(args, want):
    assert kernels.t_stage_variant(*args) == want


def test_variant_counters_start_at_zero_and_reset():
    kernels.VARIANTS["k2"]["mma"] += 3
    kernels.LAUNCHES["k2"] += 3
    kernels.reset_launches()
    assert kernels.VARIANTS == {"k1": {"fma": 0, "mma": 0, "tf32": 0},
                                "t_stage": {"generic": 0, "registers": 0},
                                "k2": {"fma": 0, "mma": 0, "tf32": 0},
                                "k2a_lite": {"fma": 0, "mma": 0, "tf32": 0},
                                "k12b": {"fma": 0, "mma": 0, "tf32": 0},
                                "k3f": {"fma": 0, "mma": 0, "tf32": 0},
                                "k3b": {"fma": 0, "mma": 0, "tf32": 0},
                                "ta_fwd": {"fma": 0, "mma": 0, "tf32": 0},
                                "ta_bwd": {"fma": 0, "mma": 0, "tf32": 0},
                                "gk_scores": {"fma": 0, "mma": 0}}
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("Tp, m1, kind", [
    (9, 3, "et"), (9, 3, "it"),        # 9 -> 6 and 6 -> 9
    (7, 2, "et"), (7, 2, "it"),        # 7 -> 4 and 4 -> 7
])
def test_t_stage_twin_matches_pallas_t_stage_at_other_lengths(Tp, m1, kind):
    B, Y, C = 2, 10, 8
    r = np.random.default_rng(3)
    tin = Tp if kind == "et" else 2 * m1
    y = r.normal(size=(B * tin, Y, 2 * C)).astype(np.float32)
    ref = np.asarray(jfl.t_stage(jnp.asarray(y), kind, Tp, m1, "mxu", True))
    got = tfl.t_stage(torch.from_numpy(y), kind, Tp, m1).numpy()
    assert got.shape == ref.shape == (B * (2 * m1 if kind == "et" else Tp), Y, 2 * C)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * float(np.abs(ref).max()))


# --------------------------------------------------------------------------
# K1 and K12B's tensor-core variants, replayed from their packed tables
# --------------------------------------------------------------------------

K1_GEOMETRIES = [  # (Hp, Wp, m2, m3): two of the gpu tests', the cylinder's, fsi's
    (13, 22, 5, 8),
    (17, 38, 4, 16),
    (70, 134, 12, 16),
    (70, 134, 16, 16),
]


def _replay_wh(v, tables, *, Hp, Wp, m2, m3, rounding=True):
    """The tensor-core (W, H) DFT body (csrc/fno_dft_mma.cuh) in plain
    PyTorch from its packed tables: v [BT, Hp, Wp, C] (rounded to bf16)
    through the W product with EW, X (rounded to bf16) into [16, m3·16]
    tiles of 8 rows, the H fold with EH chunk by chunk, accumulated in f64;
    Y [BT, 2m2·m3, 2C] unrounded. ``rounding=False``: the same products on
    unrounded operands (the tables in f32)."""
    BT, C = v.shape[0], v.shape[-1]
    rnd = (lambda t: t.to(torch.bfloat16).double()) if rounding else (lambda t: t)
    ew, eh = (t.double() for t in tables)
    z = F.pad(rnd(v.double()), (0, 0, 0, ew.shape[1] - Wp))   # rows past Wp meet zero columns
    X = rnd(torch.einsum("rw,bhwc->bhrc", ew, z))          # rows r = (re | im, m)
    nch = eh.shape[0]
    X = F.pad(X, (0, 0, 0, 0, 0, nch * 8 - Hp))            # [BT, nch*8, 2*m3, C]
    X = X.view(BT, nch, 8, 2, m3, C).transpose(2, 3).reshape(BT, nch, 16, m3, C)
    Y = torch.einsum("nRk,bnkmc->bRmc", eh, X)[:, :4 * m2]  # rows (re | im, j)
    return Y.view(BT, 2, 2 * m2, m3, C).permute(0, 2, 3, 1, 4).reshape(BT, -1, 2 * C)


def _replay_k1_mma(x, a, b, tables, *, Hp, Wp, m2, m3, act, rounding=True):
    """K1's tensor-core variant in plain PyTorch: z = act(a·x + b) through
    ``_replay_wh``; y rounded to bf16 (``rounding=False``: unrounded)."""
    BT, C = x.shape[0], x.shape[-1] // 2
    z = tfl._act(x.double().view(BT, Hp, Wp, C) * a.double() + b.double(), act)
    y = _replay_wh(z, tables, Hp=Hp, Wp=Wp, m2=m2, m3=m3, rounding=rounding)
    return y.to(torch.bfloat16) if rounding else y.float()


def test_k1_tables_hold_the_dft_tables():
    Hp, Wp, m2, m3 = 13, 22, 5, 8
    c = tfl._ct_consts(Hp, Wp, m2, m3)
    ew, eh = (t.numpy() for t in tfl._k1_mma_tables(Hp, Wp, m2, m3, torch.float32))
    assert ew.shape == (2 * m3, 32) and eh.shape == (2, 32, 16)
    np.testing.assert_array_equal(ew[:m3, :Wp], c["ewr"].T)
    np.testing.assert_array_equal(ew[m3:, :Wp], c["ewi"].T)
    assert not ew[:, Wp:].any()
    for h in range(16):
        ch, r = divmod(h, 8)
        e = eh[ch]
        want = (c["ehr"][h], c["ehi"][h]) if h < Hp else (np.zeros(2 * m2),) * 2
        np.testing.assert_array_equal(e[:2 * m2, r], want[0])
        np.testing.assert_array_equal(e[:2 * m2, 8 + r], -want[1])
        np.testing.assert_array_equal(e[2 * m2:4 * m2, r], want[1])
        np.testing.assert_array_equal(e[2 * m2:4 * m2, 8 + r], want[0])
    assert not eh[:, 4 * m2:].any()
    bf = tfl._k1_mma_tables(Hp, Wp, m2, m3)
    assert all(t.dtype == torch.bfloat16 for t in bf)


@pytest.mark.parametrize("act", ["none", "exact"])
@pytest.mark.parametrize("geo", K1_GEOMETRIES)
def test_k1_mma_replay_matches_twin(geo, act):
    """The replay, with the variant's bf16 roundings (z, the tables, X, y),
    within 1e-2·max|ref| of the twin, the bound the kernel is held to on the
    card; unrounded, within 2e-4 of it."""
    Hp, Wp, m2, m3 = geo
    BT, C = 2, 16
    r = np.random.default_rng(7)
    x = torch.from_numpy(r.normal(size=(BT, Hp * Wp // 2, 2 * C)).astype(np.float32))
    x = x.to(torch.bfloat16)
    a = torch.from_numpy((1 + 0.1 * r.normal(size=C)).astype(np.float32))
    b = torch.from_numpy((0.1 * r.normal(size=C)).astype(np.float32))
    kw = dict(Hp=Hp, Wp=Wp, act=act)
    ref = tfl.k1_plain(x.float(), a, b, tfl._ct_on(torch.device("cpu"), *geo), **kw)
    got = _replay_k1_mma(x, a, b, tfl._k1_mma_tables(*geo), m2=m2, m3=m3, **kw)
    assert got.shape == ref.shape
    assert (got.float() - ref).abs().max() <= 1e-2 * ref.abs().max()
    exact = _replay_k1_mma(x, a, b, tfl._k1_mma_tables(*geo, torch.float32), m2=m2, m3=m3,
                           rounding=False, **kw)
    assert (exact - ref).abs().max() <= 2e-4 * ref.abs().max()


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k1_mma_replay_matches_pallas_k1(act):
    """Unrounded, the replay's factorisation against the Pallas ``_k1_kernel``
    in interpret mode (f32, the dims of tests/test_pallas_fno_layer.py)."""
    B, Tp, Hp, Wp, C, m2, m3 = 2, 6, 10, 12, 8, 3, 4
    r = np.random.default_rng(8)
    x = r.normal(size=(B * Tp, Hp * Wp // 2, 2 * C)).astype(np.float32)
    a = (1 + 0.1 * r.normal(size=C)).astype(np.float32)
    b = (0.1 * r.normal(size=C)).astype(np.float32)
    cst = jfl._ct_consts(Hp, Wp, m2, m3)
    a2, b2 = jfl._pack_affine(jnp.asarray(a)[None], jnp.asarray(b)[None], C)
    k1, *_ = jfl._layer_calls(B * Tp, Hp, Wp // 2, 2 * C, m2, m3, act, True, "float32")
    ref = np.asarray(k1(jnp.asarray(x), a2, b2, cst["E67X"], cst["EhP"],
                        np.ones((Hp * Wp // 2, 1), np.float32)))
    got = _replay_k1_mma(torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b),
                         tfl._k1_mma_tables(Hp, Wp, m2, m3, torch.float32), Hp=Hp, Wp=Wp,
                         m2=m2, m3=m3, act=act, rounding=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4 * float(np.abs(ref).max()))


def _split(t):
    return (u.double() for u in kernels.split_bf16(t))


def _replay_k12b_mma(x, a, b, wp, s, ds, ds1, ds2, dy, tables, *, Hp, Wp, m2, m3, rows,
                     act):
    """K12B's tensor-core variant in plain PyTorch from the packed tables:
    the same products on the same operands (bf16 hi + lo tables; dX, ds_eff,
    z and Wp split in two, the lo·lo terms dropped), accumulated in f64.
    Returns (dx unrounded, dWp, da, db, dbp)."""
    BT, C = x.shape[0], x.shape[-1] // 2
    ah, ew = (t.double() for t in tables)
    dy5 = dy.double().view(BT, 2 * m2, m3, 2, C)
    G = torch.cat([dy5[:, :, :, 0], dy5[:, :, :, 1]], dim=1)       # [BT, (p', j), m3, C]
    dX = torch.einsum("nrk,bkmc->bnrmc", ah.sum(0)[..., :4 * m2], G)
    dX = dX.view(BT, -1, 2, 8, m3, C)[:, :, :, :rows].transpose(2, 3)
    dX = dX.reshape(BT, -1, 2 * m3, C)[:, :Hp]                     # [BT, Hp, (part, m), C]
    dXh, dXl = _split(dX)
    dz = (torch.einsum("wk,bhkc->bhwc", ew.sum(0)[:Wp], dXh)
          + torch.einsum("wk,bhkc->bhwc", ew[0, :Wp], dXl))
    v = lambda t: t.float().view(BT, Hp, Wp, C)
    dse = v(ds) + ds1 + 2.0 * ds2 * v(s)                           # f32, as the kernel
    dh, dl = _split(dse)
    th, tl = _split(wp.t())
    dz = dz + dh @ th + dl @ th + dh @ tl
    x4 = x.double().view(BT, Hp, Wp, C)
    u = x4 * a.double() + b.double()
    du = dz * (torch.ones_like(u) if act == "none" else gelu_grad(u, act))
    z = tfl._act(v(x) * a + b, act)
    zh, zl = _split(z)
    e = lambda p, q: torch.einsum("bhwc,bhwd->cd", p, q)
    dims = (0, 1, 2)
    return (du * a.double(), e(zh, dh) + e(zl, dh) + e(zh, dl), (du * x4).sum(dims),
            du.sum(dims), dse.double().sum(dims))


def _k12b_inputs(Hp, Wp, m2, m3, BT, C, seed=9):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: torch.from_numpy(
        (loc + scale * r.normal(size=s)).astype(np.float32))
    return dict(x=f(BT, Hp * Wp // 2, 2 * C), a=f(C, scale=0.1, loc=1.0), b=f(C, scale=0.1),
                wp=f(C, C, scale=0.3), s=f(BT, Hp * Wp // 2, 2 * C),
                ds=f(BT, Hp * Wp // 2, 2 * C), ds1=f(C), ds2=f(C, scale=0.1),
                dy=f(BT, 2 * m2 * m3, 2 * C))


def _k12b_f64_body(d, c, Hp, Wp, m2, m3, act):
    """k12b_plain's arithmetic in f64, and the sums of |terms| of its four
    accumulators."""
    BT, C = d["x"].shape[0], d["x"].shape[-1] // 2
    v = lambda t: t.view(BT, Hp, Wp, C)
    x4 = v(d["x"])
    u = x4 * d["a"] + d["b"]
    dse = v(d["ds"]) + d["ds1"] + 2.0 * d["ds2"] * v(d["s"])
    dy5 = d["dy"].view(BT, 2 * m2, m3, 2, C)
    dyR, dyI = dy5[..., 0, :], dy5[..., 1, :]
    e = lambda t, M: torch.einsum("bjmc,hj->bhmc", t, M)
    dXr = e(dyR, c["ehr"]) + e(dyI, c["ehi"])
    dXi = e(dyI, c["ehr"]) - e(dyR, c["ehi"])
    dz = (torch.einsum("bhmc,wm->bhwc", dXr, c["ewr"])
          + torch.einsum("bhmc,wm->bhwc", dXi, c["ewi"]) + dse @ d["wp"].t())
    du = dz * (torch.ones_like(u) if act == "none" else gelu_grad(u, act))
    z = tfl._act(u, act)
    dims = (0, 1, 2)
    terms = (torch.einsum("bhwc,bhwd->cd", z.abs(), dse.abs()), (du * x4).abs().sum(dims),
             du.abs().sum(dims), dse.abs().sum(dims))
    return (du * d["a"], torch.einsum("bhwc,bhwd->cd", z, dse), (du * x4).sum(dims),
            du.sum(dims), dse.sum(dims)), terms


@pytest.mark.parametrize("act", ["none", "exact"])
@pytest.mark.parametrize("geo", [(13, 22, 5, 8, 32), (17, 38, 4, 16, 64),
                                 (9, 20, 3, 16, 128)])
def test_k12b_mma_replay_matches_twin(geo, act):
    """The replay within 1e-4·max|ref| of dx and within 1e-5 of the sum of
    |terms| per entry of dWp, da, db and dbp, ten times inside the bounds the
    kernel is held to on the card: every operand of every product carries 16
    bits. The bf16 inputs lie on the bf16 grid on both sides."""
    Hp, Wp, m2, m3, C = geo
    d = {k: t.to(torch.bfloat16).float() if t.dim() > 1 and k != "wp" else t
         for k, t in _k12b_inputs(Hp, Wp, m2, m3, 3, C).items()}
    want, terms = _k12b_f64_body({k: t.double() for k, t in d.items()},
                                 {k: torch.from_numpy(v).double() for k, v in
                                  tfl._ct_consts(Hp, Wp, m2, m3).items()}, Hp, Wp, m2, m3, act)
    got = _replay_k12b_mma(*(d[k] for k in ("x", "a", "b", "wp", "s", "ds", "ds1", "ds2",
                                            "dy")),
                           tfl._k12b_mma_tables(Hp, Wp, m2, m3, kernels.K12B_MMA_ROWS[C]),
                           Hp=Hp, Wp=Wp, m2=m2, m3=m3, rows=kernels.K12B_MMA_ROWS[C], act=act)
    dx = got[0].reshape(want[0].shape)
    assert (dx - want[0]).abs().max() <= 1e-4 * want[0].abs().max()
    for name, g, w, t in zip(("dwp", "da", "db", "dbp"), got[1:], want[1:], terms):
        assert ((g - w).abs() / t.clamp_min(1e-30)).max() <= 1e-5, name
    twin = tfl.k12b(*(d[k] for k in ("x", "a", "b", "wp", "s", "ds", "ds1", "ds2", "dy")),
                    Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    assert (twin[0].double().view(dx.shape) - want[0]).abs().max() <= 1e-5 * want[0].abs().max()


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k12b_mma_replay_matches_pallas_k12b(act):
    """The replay against the Pallas ``_k12b_kernel`` in interpret mode (f32,
    the dims of tests/test_pallas_fno_layer.py), rtol 2e-4."""
    B, Tp, Hp, Wp, C, m2, m3 = 2, 6, 10, 12, 8, 3, 4
    d = _k12b_inputs(Hp, Wp, m2, m3, B * Tp, C, seed=10)
    n = lambda k: np.asarray(d[k].numpy())
    lanes = lambda v: jnp.asarray(np.concatenate([v, v])[None])
    cst = jfl._ct_consts(Hp, Wp, m2, m3)
    eyeC, zC = np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32)
    ones = np.ones((Hp * Wp // 2, 1), np.float32)
    a2, b2 = jfl._pack_affine(jnp.asarray(n("a"))[None], jnp.asarray(n("b"))[None], C)
    *_, k12b = jfl._layer_calls(B * Tp, Hp, Wp // 2, 2 * C, m2, m3, act, True, "float32")
    dx, dwp2, dvec = k12b(
        jnp.asarray(n("x")), a2, b2, jfl._block_diag2(jnp.asarray(n("wp"))).T,
        jnp.asarray(n("s")), jnp.asarray(n("ds")), lanes(n("ds1")), lanes(n("ds2")),
        jnp.asarray(n("dy")), cst["EhPT"], cst["E67T"], cst["E67twT"],
        np.concatenate([eyeC, zC], axis=1), np.concatenate([zC, eyeC], axis=1), ones, ones)
    dwp2, dvec = np.asarray(dwp2), np.asarray(dvec)
    fold = lambda v: v[:C] + v[C:]
    ref = (np.asarray(dx), dwp2[:C, :C] + dwp2[C:, C:], fold(dvec[1]), fold(dvec[2]),
           fold(dvec[0]))
    got = _replay_k12b_mma(*(d[k] for k in ("x", "a", "b", "wp", "s", "ds", "ds1", "ds2",
                                            "dy")),
                           tfl._k12b_mma_tables(Hp, Wp, m2, m3, 8), Hp=Hp, Wp=Wp, m2=m2,
                           m3=m3, rows=8, act=act)
    for name, g, r in zip(("dx", "dwp", "da", "db", "dbp"), got, ref):
        g = g.float().numpy().reshape(r.shape)
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4 * float(np.abs(r).max()),
                                   err_msg=name)


# --------------------------------------------------------------------------
# K2A-lite's and K3B's tensor-core variants
# --------------------------------------------------------------------------


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 64, 24, 16, 134), "mma"),    # the cylinder
    ((torch.bfloat16, 128, 32, 16, 134), "mma"),   # fsi
    ((torch.bfloat16, 32, 10, 8, 22), "mma"),      # the gpu tests' small shapes
    ((torch.bfloat16, 16, 6, 8, 12), "mma"),       # one 16-channel slice
    ((torch.bfloat16, 8, 6, 4, 12), "fma"),        # C below a slice
    ((torch.bfloat16, 40, 6, 8, 12), "fma"),       # C no multiple of 16
    ((torch.bfloat16, 256, 24, 16, 134), "fma"),   # C past 128
    ((torch.bfloat16, 64, 24, 12, 134), "fma"),    # m3 not instantiated
    ((torch.bfloat16, 64, 34, 16, 134), "fma"),    # more than 32 H modes
    ((torch.bfloat16, 64, 24, 16, 258), "fma"),    # Wp past 256
    ((torch.float32, 64, 24, 16, 134), "tf32"),    # f32 on the tensor cores as 3xTF32
])
def test_k2a_lite_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.k2a_lite_variant(*args) == want
    assert kernels.k2a_lite_variant(*args) == want   # no state
    dtype, C, m2x2, m3, Wp = args
    if want == "mma":
        assert kernels.k2a_lite_mma_smem_bytes(Wp, m3, C) <= kernels.MAX_SMEM_BYTES
    if want == "tf32":
        assert kernels.k2a_lite_tf32_smem_bytes(Wp, m3, C) <= kernels.MAX_SMEM_BYTES


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 64, 3), "mma"),      # the cylinder
    ((torch.bfloat16, 128, 6), "mma"),     # fsi's width
    ((torch.bfloat16, 32, 8), "mma"),
    ((torch.bfloat16, 16, 3), "fma"),      # C not instantiated
    ((torch.bfloat16, 96, 3), "fma"),
    ((torch.bfloat16, 8, 6), "fma"),
    ((torch.bfloat16, 64, 9), "mma"),      # F past 8: fc2 over two n-tiles
    ((torch.bfloat16, 64, 16), "mma"),     # the combustion scenario's F
    ((torch.bfloat16, 128, 16), "fma"),    # two n-tiles built at C 64 alone
    ((torch.bfloat16, 64, 17), "fma"),     # F past 16
    ((torch.float32, 64, 3), "tf32"),      # f32 on the tensor cores as 3xTF32
    ((torch.float32, 64, 16), "tf32"),
    ((torch.float32, 128, 16), "fma"),
])
def test_k3b_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.k3b_variant(*args) == want
    assert kernels.k3b_variant(*args) == want        # no state
    if want == "mma":
        assert kernels.k3b_mma_smem_bytes(*args[1:]) <= kernels.MAX_SMEM_BYTES
    if want == "tf32":
        assert kernels.k3b_tf32_smem_bytes(*args[1:]) <= kernels.MAX_SMEM_BYTES


def test_tail_tensor_cores_take_f_past_8_only_where_built():
    """fc2 over two n-tiles is built for the combustion scenario's (C 64,
    exact GELU) alone (csrc/fno_tail.cu::with_mma_instance): every other
    (C, act) past F 8 takes fma, in both kernels and both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        for choose in (kernels.k3f_variant, kernels.k3b_variant):
            assert choose(dtype, 64, 16, act="exact") != "fma"
            assert choose(dtype, 64, 8, act="tanh") != "fma"
            for C, act in ((64, "tanh"), (32, "exact"), (128, "exact"), (128, "tanh")):
                assert choose(dtype, C, 9, act=act) == "fma", (C, act)
    assert kernels.tail_tc_instance(64, 16) and not kernels.tail_tc_instance(64, 17)
    assert not kernels.tail_tc_instance(64, 9, "tanh")


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 64, 3), "mma"),      # the cylinder
    ((torch.bfloat16, 128, 6), "mma"),     # fsi's width
    ((torch.bfloat16, 32, 8), "mma"),      # F at its bound
    ((torch.bfloat16, 16, 3), "fma"),      # C not instantiated
    ((torch.bfloat16, 96, 3), "fma"),
    ((torch.bfloat16, 256, 3), "fma"),     # C past 128
    ((torch.bfloat16, 64, 9), "mma"),      # F past 8: fc2 over two n-tiles
    ((torch.bfloat16, 64, 16), "mma"),     # the combustion scenario's F
    ((torch.bfloat16, 64, 17), "fma"),     # F past 16
    ((torch.float32, 64, 3), "tf32"),      # f32 on the tensor cores as 3xTF32
    ((torch.float32, 128, 6), "tf32"),
    ((torch.float32, 64, 16), "tf32"),
])
def test_k3f_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    """K3F takes K3B's conditions (the two share one forward) and K3F's
    block fits the shared memory twice at C 64 (two blocks an SM)."""
    assert kernels.k3f_variant(*args) == want
    assert kernels.k3f_variant(*args) == want        # no state
    assert kernels.k3f_variant(*args) == kernels.k3b_variant(*args)
    assert kernels.k3f_variant(*args, aligned=False) == "fma"
    if want == "mma":
        assert kernels.k3f_mma_smem_bytes(*args[1:]) <= kernels.MAX_SMEM_BYTES
    if want == "tf32":
        assert kernels.k3f_tf32_smem_bytes(*args[1:]) <= kernels.MAX_SMEM_BYTES
    assert 2 * (kernels.k3f_mma_smem_bytes(64) + 1024) <= 228 * 1024
    assert 2 * (kernels.k3f_mma_smem_bytes(64, 16) + 1024) <= 228 * 1024
    assert 2 * (kernels.k3f_tf32_smem_bytes(64, 16) + 1024) <= 228 * 1024


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 20, 4, 32), "mma"),      # the UNet: T 20, 4 heads of 32
    ((torch.bfloat16, 32, 4, 32), "mma"),      # T at its bound
    ((torch.bfloat16, 33, 4, 32), "fma"),      # T past 32
    ((torch.bfloat16, 20, 4, 16), "mma"),
    ((torch.bfloat16, 20, 4, 64), "mma"),
    ((torch.bfloat16, 20, 4, 8), "fma"),       # d not instantiated
    ((torch.bfloat16, 5, 3, 8), "fma"),
    ((torch.bfloat16, 16, 8, 32), "mma"),      # 8 heads
    ((torch.bfloat16, 32, 8, 32), "fma"),      # 8 heads, heads*T 256: past the shared memory
    ((torch.bfloat16, 32, 8, 64), "fma"),
    ((torch.bfloat16, 16, 16, 16), "fma"),     # more than 8 heads
    ((torch.bfloat16, 9, 30, 16), "fma"),      # heads*T past 256
    ((torch.float32, 20, 4, 32), "tf32"),      # f32 on the tensor cores (3xTF32)
    ((torch.float32, 5, 3, 16), "tf32"),
])
def test_ta_bwd_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.ta_bwd_variant(*args) == want
    assert kernels.ta_bwd_variant(*args) == want     # no state
    assert kernels.ta_bwd_variant(*args, aligned=False) == "fma"
    dtype, T, heads, d = args
    fits = kernels.ta_bwd_mma_smem_bytes(T, heads, d) <= kernels.MAX_SMEM_BYTES
    assert fits or want == "fma"
    if want == "mma":
        assert heads * T <= kernels.TA_MAX_TASKS and fits
    if want == "tf32":
        assert kernels.ta_bwd_tf32_smem_bytes(T, heads, d) <= kernels.MAX_SMEM_BYTES


def test_ta_bwd_mma_block_fits_three_times_an_sm_at_the_unet_shape():
    """At T 20, 4 heads of 32 a block takes 73 KB: three blocks an SM."""
    assert 3 * (kernels.ta_bwd_mma_smem_bytes(20, 4, 32) + 1024) <= 228 * 1024


@pytest.mark.parametrize("kernel, dtype, C, F_, offset", [
    ("k3f", torch.float32, 64, 3, 0),       # f32
    ("k3f", torch.bfloat16, 16, 3, 0),      # C not instantiated
    ("k3f", torch.bfloat16, 64, 17, 0),     # F past 16
    ("k3f", torch.bfloat16, 64, 3, 1),      # s 2 bytes past a 16-byte boundary
    ("k3b", torch.bfloat16, 64, 3, 1),
])
def test_a_named_tail_mma_variant_refuses_what_it_does_not_take(kernel, dtype, C, F_, offset):
    """The choice before the launch: a named mma variant that cannot take s
    raises before anything is built or launched; the unnamed choice (tf32
    for aligned f32 at C 64, else fma) and a named fma take it."""
    base = torch.zeros(4 * C + 8, dtype=dtype)
    s = base[offset:offset + 4 * C].view(4, C)
    with pytest.raises(ValueError, match="mma variant"):
        kernels._tail_variant(kernel, s, C, F_, "mma")
    with pytest.raises(ValueError, match="no variant"):
        kernels._tail_variant(kernel, s, C, F_, "wgmma")
    chosen = "tf32" if (dtype, C, F_, offset) == (torch.float32, 64, 3, 0) else "fma"
    assert kernels._tail_variant(kernel, s, C, F_, None) == (
        chosen, list(kernels.VARIANTS[kernel]).index(chosen))
    assert kernels._tail_variant(kernel, s, C, F_, "fma") == ("fma", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["k3f", "k3b"])
def test_tail_kernels_refuse_act_none(kernel, dtype):
    """The tail kernels take the two GELUs that their twin and the JAX fused
    tail take: act 'none' raises before a variant is chosen or anything is
    built, as the twin raises on it; nothing is counted."""
    shape = K3B_SHAPES[2]
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=45)
    s = s.to(dtype)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="none")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="take act 'exact' or 'tanh'"):
        if kernel == "k3f":
            kernels.k3f(s, *tail, **kw)
        else:
            kernels.k3b(s, *tail, gl, **kw)
    with pytest.raises(ValueError, match="GELU variant"):
        (ft.k3f_plain if kernel == "k3f" else ft.k3b_plain)(
            s.float(), *tail, *(() if kernel == "k3f" else (gl,)), **kw)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("dtype, T, heads, d, offset", [
    (torch.float32, 20, 4, 32, 0),         # f32
    (torch.bfloat16, 20, 4, 8, 0),         # d not instantiated
    (torch.bfloat16, 33, 4, 32, 0),        # T past 32
    (torch.bfloat16, 16, 16, 16, 0),       # more than 8 heads
    (torch.bfloat16, 20, 4, 32, 1),        # do 2 bytes past a 16-byte boundary
])
def test_a_named_ta_bwd_mma_variant_refuses_what_it_does_not_take(dtype, T, heads, d, offset):
    n = T * heads * d
    q = torch.zeros(n, dtype=dtype)
    do = torch.zeros(n + 8, dtype=dtype)[offset:offset + n]
    with pytest.raises(ValueError, match="mma variant"):
        kernels._ta_bwd_variant(q, q, q, do, T, heads, d, "mma")
    with pytest.raises(ValueError, match="no variant"):
        kernels._ta_bwd_variant(q, q, q, do, T, heads, d, "wgmma")
    chosen = "tf32" if (dtype, offset) == (torch.float32, 0) else "fma"   # f32: 3xTF32
    assert kernels._ta_bwd_variant(q, q, q, do, T, heads, d, None) == (
        chosen, list(kernels.VARIANTS["ta_bwd"]).index(chosen))


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 20, 4, 32), "mma"),      # the UNet: T 20, 4 heads of 32
    ((torch.bfloat16, 32, 4, 32), "mma"),      # T at its bound
    ((torch.bfloat16, 33, 4, 32), "fma"),      # T past 32
    ((torch.bfloat16, 7, 4, 16), "mma"),
    ((torch.bfloat16, 20, 4, 64), "mma"),
    ((torch.bfloat16, 20, 4, 8), "fma"),       # d not instantiated
    ((torch.bfloat16, 16, 8, 64), "mma"),      # 8 heads of 64
    ((torch.bfloat16, 32, 8, 32), "mma"),      # heads*T 256: the backward's block does not fit
    ((torch.bfloat16, 32, 8, 64), "fma"),      # past the shared memory
    ((torch.bfloat16, 16, 16, 16), "fma"),     # more than 8 heads
    ((torch.bfloat16, 9, 30, 16), "fma"),      # heads*T past 256
    ((torch.float32, 20, 4, 32), "tf32"),      # f32 on the tensor cores (3xTF32)
    ((torch.float32, 5, 3, 16), "tf32"),
])
def test_ta_fwd_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    """The backward's conditions, with the forward's smaller block (no
    accumulator, no fourth slab: it takes 8 heads at T 32 where the backward
    does not)."""
    assert kernels.ta_fwd_variant(*args) == want
    assert kernels.ta_fwd_variant(*args) == want     # no state
    assert kernels.ta_fwd_variant(*args, aligned=False) == "fma"
    dtype, T, heads, d = args
    fits = kernels.ta_fwd_mma_smem_bytes(T, heads, d) <= kernels.MAX_SMEM_BYTES
    assert fits or want == "fma"
    assert kernels.ta_fwd_mma_smem_bytes(T, heads, d) < kernels.ta_bwd_mma_smem_bytes(T, heads, d)
    if kernels.ta_bwd_variant(*args) in ("mma", "tf32"):
        assert want == kernels.ta_bwd_variant(*args)


def test_ta_fwd_mma_block_fits_four_times_an_sm_at_the_unet_shape():
    """At T 20, 4 heads of 32 a block takes 40448 bytes (the ring of q, k
    and v over two sites, a zero row, the bias): four blocks, 16 warps, an
    SM (five by shared memory; 128 registers a thread make it four)."""
    assert kernels.ta_fwd_mma_smem_bytes(20, 4, 32) == 2 * 3 * 20 * 136 * 2 + 128 + 4 * 20 * 24 * 4
    assert 5 * (kernels.ta_fwd_mma_smem_bytes(20, 4, 32) + 1024) <= 228 * 1024


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 64), "mma"),      # the cylinder GK: 4 heads of 64
    ((torch.bfloat16, 32), "mma"),
    ((torch.bfloat16, 16), "mma"),
    ((torch.float32, 64), "mma"),       # f32 inputs: the same normalised f32 rows
    ((torch.float32, 16), "mma"),
    ((torch.bfloat16, 8), "fma"),       # d not instantiated
    ((torch.float16, 64), "fma"),
])
def test_gk_scores_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.gk_scores_variant(*args) == want
    assert kernels.gk_scores_variant(*args) == want     # no state
    assert kernels.gk_scores_variant(*args, aligned=False) == "fma"
    if want == "mma":
        assert kernels.gk_scores_mma_smem_bytes(args[1], args[0]) <= kernels.MAX_SMEM_BYTES


def test_gk_scores_mma_block_sizes_at_the_cylinder_width():
    """d 64: the two-stage ring of 32-token tiles of k and v, the affine,
    two buffers of the hi and lo rows of k and v (padded by 8): 54272 bytes
    in bf16, four blocks (4 warps each, 128 registers) an SM; 70656 in
    f32, three."""
    assert kernels.gk_scores_mma_smem_bytes(64, torch.bfloat16) == (
        2 * 2 * 32 * 64 * 2 + 4 * 64 * 4 + 2 * 4 * 32 * 72 * 2) == 54272
    assert kernels.gk_scores_mma_smem_bytes(64, torch.float32) == 70656
    assert 4 * (54272 + 1024) <= 228 * 1024 and 3 * (70656 + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtype, T, heads, d, offset", [
    (torch.float32, 20, 4, 32, 0),         # f32
    (torch.bfloat16, 20, 4, 8, 0),         # d not instantiated
    (torch.bfloat16, 33, 4, 32, 0),        # T past 32
    (torch.bfloat16, 16, 16, 16, 0),       # more than 8 heads
    (torch.bfloat16, 20, 4, 32, 1),        # v 2 bytes past a 16-byte boundary
])
def test_a_named_ta_fwd_mma_variant_refuses_what_it_does_not_take(dtype, T, heads, d, offset):
    n = T * heads * d
    q = torch.zeros(n, dtype=dtype)
    v = torch.zeros(n + 8, dtype=dtype)[offset:offset + n]
    with pytest.raises(ValueError, match="mma variant"):
        kernels._ta_fwd_variant(q, q, v, T, heads, d, "mma")
    with pytest.raises(ValueError, match="no variant"):
        kernels._ta_fwd_variant(q, q, v, T, heads, d, "wgmma")
    chosen = "tf32" if (dtype, offset) == (torch.float32, 0) else "fma"   # f32: 3xTF32
    assert kernels._ta_fwd_variant(q, q, v, T, heads, d, None) == (
        chosen, list(kernels.VARIANTS["ta_fwd"]).index(chosen))
    assert kernels._ta_fwd_variant(q, q, v, T, heads, d, "fma") == ("fma", 0)


@pytest.mark.parametrize("dtype, d, offset", [
    (torch.bfloat16, 8, 0),         # d not instantiated
    (torch.float16, 64, 0),         # neither f32 nor bf16
    (torch.bfloat16, 64, 1),        # v 2 bytes past a 16-byte boundary
    (torch.float32, 32, 1),         # v 4 bytes past
])
def test_a_named_gk_scores_mma_variant_refuses_what_it_does_not_take(dtype, d, offset):
    n = 4 * d
    k = torch.zeros(n, dtype=dtype)
    v = torch.zeros(n + 8, dtype=dtype)[offset:offset + n]
    with pytest.raises(ValueError, match="mma variant"):
        kernels._gk_scores_variant(k, v, d, "mma")
    with pytest.raises(ValueError, match="no variant"):
        kernels._gk_scores_variant(k, v, d, "wgmma")
    assert kernels._gk_scores_variant(k, v, d, None) == ("fma", 0)
    assert kernels._gk_scores_variant(k, v, d, "fma") == ("fma", 0)


def _constexprs(name):
    """{name: value} of the integer constexprs of csrc/<name>."""
    import re
    text = (kernels.CSRC / name).read_text()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"constexpr int (\w+) = (\d+);", text)}


@pytest.mark.parametrize("source, pairs", [
    ("temporal_attention.cu", {"kTaStages": "TA_MMA_STAGES", "kTaMaxHeads": "TA_MMA_MAX_HEADS",
                               "kTaTS": "TA_MMA_TILE_STRIDE", "kTaTf32Stages": "TA_TF32_STAGES",
                               "kTaPadF": "TA_TF32_PAD"}),
    ("galerkin_scores.cu", {"kGkTile": "GK_MMA_TILE", "kGkStages": "GK_MMA_STAGES",
                            "kGkRowPad": "GK_MMA_ROW_PAD"}),
    ("fno_tf32.cuh", {"kTPad": "TF32_PAD", "kGC": "TF32_GC"}),
    ("fno_k2.cu", {"kXC": "K2_TF32_XC", "kPad": "K2_MMA_PAD"}),
    ("fno_k12b.cu", {"kTilePosT": "K12B_TF32_TILE"}),
    ("fno_dft_mma.cuh", {"kWarps": "K1_MMA_ROWS", "kSlice": "K1_MMA_SLICE"}),
    ("fno_dft_tf32.cuh", {"kPiece": "DFT_TF32_PIECE", "kEPad": "DFT_TF32_EPAD",
                          "kXPad": "DFT_TF32_XPAD"}),
    ("fno_k2a.cu", {"kWpsStride": "K2A_LITE_WPS_STRIDE",
                    "kWpsStrideF": "K2A_LITE_TF32_WPS_STRIDE"}),
])
def test_shared_memory_layout_constants_match_the_sources(source, pairs):
    """The constants kernels.py's ta_fwd_mma_smem_bytes,
    ta_bwd_mma_smem_bytes, gk_scores_mma_smem_bytes, k2_tf32_smem_bytes,
    k12b_tf32_smem_bytes, k12b_tf32_dwp_smem_bytes, k1_tf32_smem_bytes and
    the K2A-lite sizes lay their blocks out with, against the sources' (the wrappers also hold the sizes against the
    library's own ``*_smem_bytes`` before a launch)."""
    got = _constexprs(source)
    for c, py in pairs.items():
        assert got[c] == getattr(kernels, py), (c, py)


@pytest.mark.parametrize("geo", [(13, 22, 5, 8), (70, 134, 12, 16)])
def test_k2a_lite_tables_hold_the_adjoint_dft_tables(geo):
    """iw and ih, unrounded, against K2's inverse factors: iw's rows are
    iwr and iwi; ih's rows carry the adjoint's signs, Re dg_j from
    (ihr[j, h] | ihi[j, h]) and Im dg_j from (−ihi[j, h] | ihr[j, h]);
    zeros in the padding; bf16 by default."""
    Hp, Wp, m2, m3 = geo
    c = tfl._ct_consts(*geo)
    iw, ih = (t.numpy() for t in tfl._k2a_mma_tables(*geo, torch.float32))
    nch, R = -(-Hp // 8), -(-4 * m2 // 16) * 16
    assert iw.shape == (2 * m3, -(-Wp // 16) * 16) and ih.shape == (nch, R, 16)
    np.testing.assert_array_equal(iw[:m3, :Wp], c["iwr"])
    np.testing.assert_array_equal(iw[m3:, :Wp], c["iwi"])
    assert not iw[:, Wp:].any()
    for h in range(nch * 8):
        e = ih[h // 8]
        r = h % 8
        want = (c["ihr"][:, h], c["ihi"][:, h]) if h < Hp else (np.zeros(2 * m2),) * 2
        np.testing.assert_array_equal(e[:2 * m2, r], want[0])
        np.testing.assert_array_equal(e[:2 * m2, 8 + r], want[1])
        np.testing.assert_array_equal(e[2 * m2:4 * m2, r], -want[1])
        np.testing.assert_array_equal(e[2 * m2:4 * m2, 8 + r], want[0])
    assert not ih[:, 4 * m2:].any()
    assert all(t.dtype == torch.bfloat16 for t in tfl._k2a_mma_tables(*geo))


def _replay_k2a_lite_mma(ds, g, y, ds1, ds2, wp, bp, *, Hp, Wp, m2, m3, rounding=True):
    """K2A-lite's tensor-core variant in plain PyTorch: A(ds) through
    ``_replay_wh`` on the packed adjoint tables, then the epilogue: y @ wps
    with wps = Wp·2ds2 rounded once to bf16 (y is bf16), the elementwise
    terms, all in f64; dg rounded to bf16. ``rounding=False``: unrounded
    operands (the tables in f32, wps in f32), dg unrounded."""
    BT, C = ds.shape[0], ds.shape[-1] // 2
    geo = (Hp, Wp, m2, m3)
    tables = tfl._k2a_mma_tables(*geo, torch.bfloat16 if rounding else torch.float32)
    A = _replay_wh(ds.double().view(BT, Hp, Wp, C), tables, Hp=Hp, Wp=Wp, m2=m2, m3=m3,
                   rounding=rounding)
    Y = A.shape[1]
    lite = {k: torch.from_numpy(v).double()[..., None] for k, v in
            tfl._lite_consts(*geo).items()}
    two = 2.0 * ds2.double()
    wps = (wp * (2.0 * ds2)[None, :]).float()
    wps = (wps.to(torch.bfloat16) if rounding else wps).double()
    g4 = g.double().view(BT, Y, 2, C)
    mir = torch.from_numpy(tfl._kh_mirror(m2, m3))
    dg = (A.view(BT, Y, 2, C) + two * (lite["alpha"] * g4 + lite["beta"] * g4[:, mir])
          + lite["D"] * (y.double().view(BT, Y, 2, C) @ wps)
          + (ds1.double() + two * bp.double()) * lite["A1"]).reshape(BT, Y, 2 * C)
    return dg.to(torch.bfloat16) if rounding else dg.float()


def _k2a_lite_inputs(Hp, Wp, m2, m3, BT, C, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: torch.from_numpy(
        (loc + scale * r.normal(size=s)).astype(np.float32))
    Y = 2 * m2 * m3
    return dict(ds=f(BT, Hp * Wp // 2, 2 * C), g=f(BT, Y, 2 * C), y=f(BT, Y, 2 * C, scale=3.0),
                ds1=f(C), ds2=f(C, scale=0.1), wp=f(C, C, scale=0.3), bp=f(C, scale=0.1))


@pytest.mark.parametrize("geo", [(13, 22, 5, 8, 32), (17, 38, 4, 16, 64),
                                 (70, 134, 12, 16, 16), (70, 134, 16, 16, 16)])
def test_k2a_lite_mma_replay_matches_twin(geo):
    """The replay, with the variant's bf16 roundings (the tables, X, wps,
    dg), within 1e-2·max|ref| of the twin on bf16 inputs, the bound the
    kernel is held to on the card; unrounded, within 2e-4 of it."""
    Hp, Wp, m2, m3, C = geo
    d = _k2a_lite_inputs(Hp, Wp, m2, m3, 2, C, seed=12)
    for k in ("ds", "g", "y"):
        d[k] = d[k].to(torch.bfloat16).float()
    cpu = torch.device("cpu")
    ref = tfl.k2a_lite_plain(d["ds"], d["g"], d["y"], d["ds1"], d["ds2"], d["wp"], d["bp"],
                             tfl._lite_on(cpu, Hp, Wp, m2, m3),
                             tfl._ct_on(cpu, Hp, Wp, m2, m3), Hp=Hp, Wp=Wp)
    args = [d[k] for k in ("ds", "g", "y", "ds1", "ds2", "wp", "bp")]
    got = _replay_k2a_lite_mma(*args, Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    assert got.shape == ref.shape
    assert (got.float() - ref).abs().max() <= 1e-2 * ref.abs().max()
    exact = _replay_k2a_lite_mma(*args, Hp=Hp, Wp=Wp, m2=m2, m3=m3, rounding=False)
    assert (exact - ref).abs().max() <= 2e-4 * ref.abs().max()


def test_k2a_lite_mma_replay_matches_pallas_k2a_lite():
    """Unrounded, the replay's factorisation against the Pallas
    ``_k2a_lite_kernel`` in interpret mode (f32, the dims of
    tests/test_pallas_fno_layer.py)."""
    B, Tp, Hp, Wp, C, m2, m3 = 2, 6, 10, 12, 8, 3, 4
    J, Y = Wp // 2, 2 * m2 * m3
    d = _k2a_lite_inputs(Hp, Wp, m2, m3, B * Tp, C, seed=13)
    n = lambda k: d[k].numpy()
    lanes = lambda v: jnp.asarray(np.concatenate([v, v])[None])
    cst = jfl._ct_consts(Hp, Wp, m2, m3)
    eyeC, zC = np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32)
    sel = (np.concatenate([eyeC, zC], axis=0), np.concatenate([zC, eyeC], axis=0))
    _, _, k2a_lite, _ = jfl._layer_calls(B * Tp, Hp, J, 2 * C, m2, m3, "none", True,
                                         "float32", False, (1, 1, 1, 1), None, True, True)
    alpha, beta, Dv, A1v = jfl._lite_consts(Hp, Wp, m2, m3)
    lane = lambda v: np.ascontiguousarray(np.concatenate(
        [np.broadcast_to(v[:, 0:1], (Y, C)), np.broadcast_to(v[:, 1:2], (Y, C))], axis=1),
        np.float32)
    two = 2.0 * lanes(n("ds2"))
    dsc = jnp.concatenate([lanes(n("ds1")) + two * lanes(n("bp")), two], axis=0)
    wp2s = jfl._block_diag2(jnp.asarray(n("wp"))) * two[0][None, :]
    ref = np.asarray(k2a_lite(jnp.asarray(n("ds")), jnp.asarray(n("g")), jnp.asarray(n("y")),
                              dsc, wp2s, cst["IhPT"], cst["IwET"], cst["IwOT"], *sel,
                              lane(alpha), lane(beta), lane(A1v), lane(Dv)))
    got = _replay_k2a_lite_mma(*(d[k] for k in ("ds", "g", "y", "ds1", "ds2", "wp", "bp")),
                               Hp=Hp, Wp=Wp, m2=m2, m3=m3, rounding=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4 * float(np.abs(ref).max()))


def _pair(rounding):
    """t → its (hi, lo) bf16 pair in f64, or (t, 0) unrounded."""
    if rounding:
        return lambda t: tuple(u.double() for u in kernels.split_bf16(t))
    return lambda t: (t.double(), torch.zeros_like(t, dtype=torch.float64))


def _prod(p, q):
    """The hi + lo product of two pairs, the lo·lo term dropped."""
    return p[0] @ q[0] + p[1] @ q[0] + p[0] @ q[1]


def _replay_tail_forward(s, k1, b1, k2, b2, *, dims, tail_dims, act, rounding=True):
    """The forward K3F's and K3B's tensor-core variants share, in plain
    PyTorch: u1 = z·k1 + b1 with z bf16 and k1 a bf16 hi + lo pair, h1 =
    act(u1), o = h1·k2 + b2 with h1 and k2 pairs (the lo·lo terms dropped),
    in f64. ``rounding=False``: every operand unrounded. Returns (z, u1,
    h1's pair, o), positions as rows."""
    B, Tp, Hp, Wp, C = dims
    T, H, W = tail_dims
    pair = _pair(rounding)
    z = s.double().view(B, Tp, Hp, Wp, C)[:, :T, :H, :W].reshape(-1, C)
    k1p = pair(k1)
    u1 = z @ k1p[0] + z @ k1p[1] + b1.double()
    h1p = pair(tfl._act(u1, act))
    return z, u1, h1p, _prod(h1p, pair(k2)) + b2.double()


def _replay_k3f_mma(s, target, k1, b1, k2, b2, *, dims, tail_dims, act, rounding=True):
    """K3F's tensor-core variant in plain PyTorch: the shared forward, then
    Σ (o − target)² in f64 (the kernel's per-thread sums are f64)."""
    o = _replay_tail_forward(s, k1, b1, k2, b2, dims=dims, tail_dims=tail_dims, act=act,
                             rounding=rounding)[3]
    return ((o - target.double().reshape(o.shape)) ** 2).sum()


def _replay_k3b_mma(s, target, k1, b1, k2, b2, g, *, dims, tail_dims, act, rounding=True):
    """K3B's tensor-core variant in plain PyTorch: the shared forward, then
    the products on the variant's operands (du and do as bf16 hi + lo pairs
    too; ds from du and k1 rounded once), accumulated in f64, the ones row's
    db1 from du's pair; ds rounded to bf16. ``rounding=False``: every
    operand unrounded. Returns (ds, dk1, db1, dk2, db2)."""
    B, Tp, Hp, Wp, C = dims
    T, H, W = tail_dims
    pair, prod = _pair(rounding), _prod
    once = ((lambda t: t.float().to(torch.bfloat16).double()) if rounding
            else (lambda t: t.double()))
    z, u1, h1p, o = _replay_tail_forward(s, k1, b1, k2, b2, dims=dims, tail_dims=tail_dims,
                                         act=act, rounding=rounding)
    do = 2.0 * g.double() * (o - target.double().reshape(-1, k2.shape[1]))
    du = (do @ k2.double().t()) * tfl._act_grad(u1, act)
    dsv = once(du) @ once(k1).t()
    ds = torch.zeros((B, Tp, Hp, Wp, C), dtype=torch.float64)
    ds[:, :T, :H, :W] = dsv.view(B, T, H, W, C)
    dup, dop = pair(du), pair(do)
    ds = ds.to(torch.bfloat16) if rounding else ds.float()
    return (ds.view(s.shape), z.t() @ dup[0] + z.t() @ dup[1], (dup[0] + dup[1]).sum(0),
            prod((h1p[0].t(), h1p[1].t()), dop), do.sum(0))


K3B_SHAPES = [  # (B, Tp, Hp, Wp, C, T, H, W, F)
    (1, 7, 15, 22, 128, 5, 13, 18, 6),     # fsi's width, an uneven crop
    (2, 6, 13, 16, 32, 4, 10, 12, 6),
    (1, 3, 9, 140, 64, 2, 7, 136, 3),      # two tiles a row, the second of 8 positions
]


def _k3b_inputs(shape, seed):
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy((scale * r.normal(size=s)).astype(np.float32))
    s = f(B * Tp, Hp * Wp // 2, 2 * C)
    tail = (f(B, T, H, W, F_), f(C, 128, scale=C ** -0.5), f(128, scale=0.1),
            f(128, F_, scale=128 ** -0.5), f(F_, scale=0.1))
    return s, tail, torch.tensor(1.0 / (B * T * H * W * F_))


@pytest.mark.parametrize("act", ["exact", "tanh"])
@pytest.mark.parametrize("shape", K3B_SHAPES)
def test_k3b_mma_replay_matches_twin(shape, act):
    """The replay on bf16 s: ds within 1e-2·max|ref| of the twin, dk1, db1,
    dk2 and db2 within 1e-5 of the sum of |terms| of the f64 sums, ten times
    inside the bounds the kernel is held to on the card."""
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=14)
    s = s.to(torch.bfloat16)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act)
    ref = ft.k3b_plain(s, *tail, gl, **kw)
    got = _replay_k3b_mma(s, *tail, gl, **kw)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == ref[0].shape
    assert (got[0].float() - ref[0].float()).abs().max() <= 1e-2 * ref[0].float().abs().max()
    want = _replay_k3b_mma(s, *(t.double() for t in tail), gl.double(), **kw, rounding=False)
    z = s.double().view(B, Tp, Hp, Wp, C)[:, :T, :H, :W].reshape(-1, C)
    u1 = z @ tail[1].double() + tail[2].double()
    h1 = tfl._act(u1, act)
    do = 2.0 * gl.double() * (h1 @ tail[3].double() + tail[4].double()
                              - tail[0].double().reshape(-1, F_))
    du = (do @ tail[3].double().t()) * tfl._act_grad(u1, act)
    terms = (z.abs().t() @ du.abs(), du.abs().sum(0), h1.abs().t() @ do.abs(), do.abs().sum(0))
    for name, gv, wv, tv in zip(("dk1", "db1", "dk2", "db2"), got[1:], want[1:], terms):
        assert ((gv - wv).abs() / tv.clamp_min(1e-30)).max() <= 1e-5, name


@pytest.mark.parametrize("act", ["exact", "tanh"])
@pytest.mark.parametrize("shape", K3B_SHAPES)
def test_k3f_mma_replay_matches_twin(shape, act):
    """The replay of K3F's variant on bf16 s: its SSE within 1e-5 of the
    twin's (relative; the sum of |terms| is the SSE itself), ten times
    inside STATS_TOL, the bound the kernel is held to on the card;
    unrounded, within 2e-6 of it (the twin sums in f32)."""
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, _ = _k3b_inputs(shape, seed=16)
    s = s.to(torch.bfloat16)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act)
    ref = ft.k3f_plain(s, *tail, **kw).double()
    got = _replay_k3f_mma(s, *tail, **kw)
    assert abs(got - ref) <= 1e-5 * ref
    exact = _replay_k3f_mma(s, *tail, **kw, rounding=False)
    assert abs(exact - ref) <= 2e-6 * ref


def _jax_fused_tail(s, tail, shape, act):
    """The JAX fused tail (Pallas ``_k3f_kernel`` forward, ``_k3b_kernel``
    backward, interpret mode, f32) on the port's s and weights: its loss
    function of (s, packed weights), those packed weights, and a map of the
    packed weights' gradients back to the port's. The packed weights are
    block-diagonal pairs (w parity), whose diagonal blocks' gradients add up
    to the port's; the target is packed in its lane-major layout."""
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    target, k1, b1, k2, b2 = (t.numpy() for t in tail)
    J0, J, F2p = W // 2, Wp // 2, -(-2 * F_ // 8) * 8
    y = target.reshape(B, T, H, J0, 2 * F_)                   # lanes (w parity, f)
    y = np.pad(y, ((0, 0), (0, Tp - T), (0, Hp - H), (0, J - J0), (0, F2p - 2 * F_)))
    y_lm = jnp.asarray(y.transpose(0, 1, 4, 2, 3).reshape(B * Tp, F2p, Hp * J))
    z = np.zeros_like
    k1bd = np.block([[k1, z(k1)], [z(k1), k1]])
    k2p = np.zeros((256, F2p), np.float32)
    k2p[:128, :F_], k2p[128:, F_:2 * F_] = k2, k2
    b2p = np.zeros((1, F2p), np.float32)
    b2p[0, :F_], b2p[0, F_:2 * F_] = b2, b2
    loss = lambda *a: jft.fused_tail_loss(a[0], y_lm, *a[1:], dims=(B, Tp, Hp, J, C),
                                          tail_dims=(T, H, J0), act=act, interpret=True)
    prim = (jnp.asarray(s.numpy()), jnp.asarray(k1bd), jnp.asarray(np.tile(b1, 2)[None]),
            jnp.asarray(k2p), jnp.asarray(b2p))
    unpack = lambda ds, dk1, db1, dk2, db2: (
        ds, dk1[:C, :128] + dk1[C:, 128:], db1[0, :128] + db1[0, 128:],
        dk2[:128, :F_] + dk2[128:, F_:2 * F_], db2[0, :F_] + db2[0, F_:2 * F_])
    return loss, prim, unpack


@pytest.mark.parametrize("act", ["exact", "tanh"])
def test_k3f_mma_replay_matches_pallas_k3f(act):
    """Unrounded, the replay of K3F's variant against the Pallas
    ``_k3f_kernel`` in interpret mode (f32): the JAX fused tail's loss."""
    shape = (2, 5, 8, 12, 8, 3, 6, 10, 6)
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, _ = _k3b_inputs(shape, seed=17)
    loss, prim, _ = _jax_fused_tail(s, tail, shape, act)
    ref = float(loss(*prim))
    got = _replay_k3f_mma(s, *tail, dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act,
                          rounding=False).item()
    np.testing.assert_allclose(got, ref, rtol=2e-4)


@pytest.mark.parametrize("act", ["exact", "tanh"])
def test_k3b_mma_replay_matches_pallas_k3b(act):
    """Unrounded, the replay against the Pallas ``_k3b_kernel`` in interpret
    mode (f32), reached through the JAX fused tail's vjp: s and ds share the
    port's layout; the packed weights are block-diagonal pairs, whose
    diagonal blocks' gradients add up to the port's."""
    shape = (2, 5, 8, 12, 8, 3, 6, 10, 6)
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=15)
    loss, prim, unpack = _jax_fused_tail(s, tail, shape, act)
    _, vjp = jax.vjp(loss, *prim)
    ref = unpack(*(np.asarray(t) for t in vjp(jnp.float32(gl.item()))))
    got = _replay_k3b_mma(s, *tail, gl, dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act,
                          rounding=False)
    for name, g, r in zip(("ds", "dk1", "db1", "dk2", "db2"), got, ref):
        g = g.float().numpy().reshape(r.shape)
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4 * float(np.abs(r).max()),
                                   err_msg=name)


def _replay_tail_n_tiles(replay_f, replay_b, s, tail, g, *, dims, tail_dims, act, **kw):
    """A tail replay with fc2 laid out as the tensor-core variants lay it
    out for F past 8: k2 and b2 padded with zero columns to NF =
    kernels.fc2_width(F) (16: two n-tiles of 8), the target with zeros; o,
    do, dk2 and db2 are computed an n-tile at a time (``replay_f`` and
    ``replay_b`` on one tile's columns each, the forward shared), and the
    padded columns, which must come out exactly 0 (do is 0 there, so dk2 and
    db2 are), are dropped. Returns (SSE, ds, dk1, db1, dk2, db2)."""
    target, k1, b1, k2, b2 = tail
    F_ = k2.shape[1]
    NF = kernels.fc2_width(F_)
    pad = lambda t: torch.nn.functional.pad(t, (0, NF - F_))
    k2p, b2p, tp = pad(k2), pad(b2), pad(target)
    sse, outs = 0.0, []
    for n in range(NF // 8):
        cols = slice(8 * n, 8 * n + 8)
        args = (tp[..., cols].contiguous(), k1, b1, k2p[:, cols].contiguous(), b2p[cols])
        sse = sse + replay_f(s, *args, dims=dims, tail_dims=tail_dims, act=act, **kw)
        outs.append(replay_b(s, *args, g, dims=dims, tail_dims=tail_dims, act=act, **kw))
    # du = do k2ᵀ sums over every column of fc2: the tiles' ds, dk1, db1 add
    ds = sum(o[0].double() for o in outs)
    dk2 = torch.cat([o[3] for o in outs], 1)
    db2 = torch.cat([o[4] for o in outs], 0)
    assert not dk2[:, F_:].any() and not db2[F_:].any()
    return (sse, ds, sum(o[1] for o in outs), sum(o[2] for o in outs), dk2[:, :F_],
            db2[:F_])


TAIL_F_SHAPES = [  # (B, Tp, Hp, Wp, C, T, H, W, F): fc2 past one n-tile
    (1, 3, 9, 140, 64, 2, 7, 136, 9),      # the second tile holds one column
    (2, 7, 15, 22, 64, 5, 13, 18, 16),     # two full tiles: the combustion scenario's F
]


@pytest.mark.parametrize("shape", TAIL_F_SHAPES)
def test_tail_mma_replay_over_two_n_tiles_matches_twin(shape):
    """Unrounded (ds is linear in du, so the tiles' ds add up), the mma
    variants' replay with fc2 over two n-tiles against the twin's
    arithmetic: the SSE, dk1, db1, dk2 and db2 within 1e-10 of max|ref| of
    the one-tile replay on the same inputs (f64 sums), ds within 1e-6 (each
    tile's ds is stored in f32, as the kernel stores ds), and the twin
    within STATS_TOL and KERNEL_TOL."""
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=18)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    got = _replay_tail_n_tiles(_replay_k3f_mma, _replay_k3b_mma, s, tail, gl, **kw,
                               rounding=False)
    dense = (_replay_k3f_mma(s, *tail, **kw, rounding=False),
             *_replay_k3b_mma(s, *tail, gl, **kw, rounding=False))
    for name, gv, dv in zip(("sse", "ds", "dk1", "db1", "dk2", "db2"), got, dense):
        dv = dv.double().reshape(gv.shape)
        tol = 1e-6 if name == "ds" else 1e-10
        assert (gv - dv).abs().max() <= tol * dv.abs().max(), name
    assert abs(got[0] - ft.k3f_plain(s, *tail, **kw).double()) <= 1e-4 * got[0]
    twin = ft.k3b_plain(s, *tail, gl, **kw)
    assert (got[1].float().view(s.shape) - twin[0]).abs().max() <= 1e-4 * twin[0].abs().max()
    for name, gv, tw in zip(("dk1", "db1", "dk2", "db2"), got[2:], twin[1:]):
        assert (gv - tw.double()).abs().max() <= 1e-4 * tw.abs().max(), name


@pytest.mark.parametrize("F_", [9, 16])
def test_tail_mma_replay_over_two_n_tiles_matches_pallas(F_):
    """The replay over two n-tiles, unrounded, against the Pallas
    ``_k3f_kernel`` and ``_k3b_kernel`` in interpret mode through the JAX
    fused tail (which pads fc2 to F2p = 8·ceil(2F/8)), rtol 2e-4."""
    shape = (2, 5, 8, 12, 8, 3, 6, 10, F_)
    B, Tp, Hp, Wp, C, T, H, W, _ = shape
    s, tail, gl = _k3b_inputs(shape, seed=19)
    loss, prim, unpack = _jax_fused_tail(s, tail, shape, "exact")
    _, vjp = jax.vjp(loss, *prim)
    ref = unpack(*(np.asarray(t) for t in vjp(jnp.float32(gl.item()))))
    got = _replay_tail_n_tiles(_replay_k3f_mma, _replay_k3b_mma, s, tail, gl,
                               dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact",
                               rounding=False)
    np.testing.assert_allclose(float(got[0]), float(loss(*prim)), rtol=2e-4)
    for name, g, r in zip(("ds", "dk1", "db1", "dk2", "db2"), got[1:], ref):
        g = g.float().numpy().reshape(r.shape)
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4 * float(np.abs(r).max()),
                                   err_msg=name)


def _c_signatures():
    """{name: [ctypes type per parameter]} of every extern "C" function in
    csrc/, read from the sources."""
    import ctypes
    import re
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    out = {}
    for src in kernels.CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" [\w ]+?\*?\s*(\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
                               for p in params]
    return out


def test_ctypes_signatures_match_the_c_entry_points():
    """Every binding's argument types against its C signature: ctypes passes
    a wrong count or type without complaint where the C side reads garbage."""
    c = _c_signatures()
    assert set(c) == set(kernels.SIGNATURES)
    for name, (argtypes, _) in kernels.SIGNATURES.items():
        assert argtypes == c[name], name
