"""The variants of the port's T-stage and K2 kernels, as far as the CPU shows.

The kernels themselves run only on the card (tests/test_torch_kernels.py,
marker ``gpu``). Here: the host side of K2's tensor-core variant (the bf16
hi + lo split of its constants, the packed tables' layout, and the variant's
arithmetic replayed in plain PyTorch from those tables against the twin);
the choice of variant as a pure function of dtype and shape, at the shipped
FNO configs and at the odd shapes of the gpu tests; and the T-stage twin
against the JAX ``t_stage`` (Pallas, interpret mode) at two more (Tp, m1),
rtol 2e-4 with atol 2e-4·max|ref|, f32.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realpdebench_tpu.ops.pallas import fno_layer as jfl
from realpdebench_tpu_torch.ops import fno_layer as tfl
from realpdebench_tpu_torch.ops import kernels

CONFIGS = Path(jfl.__file__).resolve().parents[2] / "configs"
GEOMETRIES = [  # (Hp, Wp, m2, m3, rows a block): the cylinder's, and two of the gpu tests'
    (70, 134, 12, 16, 5),
    (13, 22, 5, 8, 8),
    (17, 38, 4, 16, 4),
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
    4/16/16, fsi at width 128, ...) runs K2 on the tensor cores and the
    T-stage from registers under bf16 compute, and the exact-f32 K2 under
    f32, at a 20-frame window padded to 26 and a grid up to 134 wide."""
    C, m1, m2, m3 = _fno_config(scenario)
    for Wp in (70, 134):
        assert kernels.k2_variant(torch.bfloat16, C, m3, Wp, 2 * m2) == "mma"
        assert kernels.k2_variant(torch.float32, C, m3, Wp, 2 * m2) == "fma"
    for dtype in (torch.bfloat16, torch.float32):
        for tin, tout in ((26, 2 * m1), (2 * m1, 26)):
            assert kernels.t_stage_variant(dtype, C, tin, tout) == "registers"


@pytest.mark.parametrize("args, want", [
    ((torch.bfloat16, 32, 8, 22, 10), "mma"),      # the gpu tests' small shapes
    ((torch.bfloat16, 128, 8, 20, 6), "mma"),
    ((torch.bfloat16, 8, 4, 12, 6), "fma"),        # C below the MMA tile
    ((torch.bfloat16, 32, 6, 22, 10), "fma"),      # 2*m3 no multiple of 16
    ((torch.bfloat16, 64, 4, 20, 6), "fma"),
    ((torch.float32, 64, 16, 134, 24), "fma"),     # exact f32 arithmetic
    ((torch.bfloat16, 64, 16, 256, 24), "mma"),    # 16 warps
    ((torch.bfloat16, 64, 16, 258, 24), "fma"),    # a 17th warp
    ((torch.bfloat16, 128, 16, 134, 32), "mma"),   # fsi's width: 9 warps, 223 KB
    ((torch.bfloat16, 128, 16, 146, 32), "fma"),   # a 10th warp at C 128
    ((torch.bfloat16, 64, 16, 134, 34), "fma"),    # more than 32 H modes
])
def test_k2_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.k2_variant(*args) == want
    assert kernels.k2_variant(*args) == want       # no state
    dtype, C, m3, Wp, m2x2 = args
    if want == "mma":
        assert kernels.k2_mma_smem_bytes(Wp, C, m2x2, m3) <= kernels.MAX_SMEM_BYTES


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
    assert kernels.VARIANTS == {"t_stage": {"generic": 0, "registers": 0},
                                "k2": {"fma": 0, "mma": 0}}
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
