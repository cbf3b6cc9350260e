"""The tf32 variants of the port's K1, K2, K2A-lite, K12B, K3F, K3B and the
TA forward and backward, as far as the CPU shows (the TA kernels'
arithmetic is replayed in tests/test_torch_temporal_attention.py).

The kernels run only on the card (tests/test_torch_kernels.py, marker
``gpu``). Here: the host side of the variants that carry f32 tensors
through the tensor cores as 3xTF32 (each f32 operand a tf32 hi + lo pair,
hi·hi + hi·lo + lo·hi, the lo·lo term dropped): the tf32 split, the f32
DFT tables, each kernel's arithmetic replayed in plain PyTorch with its
splits, its rounding points (the f32 values it keeps in shared memory) and
its erf (Abramowitz & Stegun 7.1.26, |error| <= 3e-7), summed in f64, against
the twin's arithmetic in f64 (1e-5·max|ref| for s, dx, y, dg and ds, 1e-6
of the sum of |terms| for the statistics and for dWp, da, db and dbp, 1e-5
for the tail's SSE, dk1, db1, dk2 and db2) and against
the Pallas kernels in interpret mode (rtol 2e-4, atol 2e-4·max|ref|); the
choice of variant at the shipped geometries and at the shapes it refuses;
the blocks' shared memory; a named tf32 variant refused before anything is
built.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from realpdebench_tpu.ops.pallas import fno_layer as jfl
from realpdebench_tpu_torch.ops import fno_layer as tfl
from realpdebench_tpu_torch.ops import fno_tail as ft
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.activations import gelu, gelu_grad
from tests.test_torch_kernel_variants import (
    K3B_SHAPES,
    TAIL_F_SHAPES,
    _jax_fused_tail,
    _k3b_inputs,
    _replay_tail_n_tiles,
)

GEOMETRIES = [  # (Hp, Wp, m2, m3, C): the cylinder's, and the gpu tests' at C 32, 64, 128
    (70, 134, 12, 16, 64),
    (13, 22, 5, 8, 32),
    (17, 38, 4, 16, 64),
    (9, 20, 3, 16, 128),
]


def _table(name):
    if name == "random":
        r = np.random.default_rng(0)
        return torch.from_numpy((r.normal(size=(64, 64)) * 10.0 ** r.integers(
            -6, 3, size=(64, 64))).astype(np.float32))
    return torch.from_numpy(tfl._ct_consts(70, 134, 12, 16)[name])


@pytest.mark.parametrize("name", ["ihr", "ihi", "iwr", "iwi", "ehr", "random"])
def test_split_tf32_carries_twenty_two_bits(name):
    """Both parts are tf32 values (the low 13 mantissa bits zero), hi + lo
    is the f32 value to 2^-22 relative; hi alone is off by more than 2^-12
    relative somewhere: the reason for the pair."""
    t = _table(name)
    hi, lo = kernels.split_tf32(t)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == lo.shape == t.shape
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (hi.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2.0 ** -22 * t.double().abs()).all())
    rel = (hi.double() - t.double()).abs() / t.double().abs().clamp_min(1e-30)
    assert rel.max() > 2.0 ** -12


def test_to_tf32_rounds_to_nearest_ties_away():
    """cvt.rna.tf32.f32 on chosen bit patterns: below, at and above the
    halfway point of the 13 dropped bits, both signs, and a carry into the
    exponent."""
    bits = torch.tensor([0x3F800FFF, 0x3F801000, 0x3F801001, 0x3FFFF000, 0x3F802000],
                        dtype=torch.int32)
    want = torch.tensor([0x3F800000, 0x3F802000, 0x3F802000, 0x40000000, 0x3F802000],
                        dtype=torch.int32)
    for sign in (1.0, -1.0):
        got = kernels.to_tf32(bits.view(torch.float32) * sign)
        assert torch.equal(got, want.view(torch.float32) * sign)


def test_split_tf32_keeps_inf_and_nan_non_finite():
    """Inf and NaN (the canonical NaN, its negative, a NaN whose payload
    lies only in the 13 dropped bits, the quiet NaN): lo is NaN, so a
    3xTF32 product that takes the pair is NaN, though hi's rounding alone
    takes the canonical NaN to ±0; Inf keeps hi = Inf. On finite values lo
    is ``to_tf32`` of t - hi, bit for bit."""
    bits = torch.tensor([0x7FFFFFFF, -1, 0x7F800001, 0x7FC00000, 0x7F800000, -0x800000],
                        dtype=torch.int32)
    t = bits.view(torch.float32)
    hi, lo = kernels.split_tf32(t)
    assert torch.isnan(lo).all()
    assert torch.equal(hi[4:], t[4:])                     # +Inf, -Inf
    assert not bool(kernels.to_tf32(t[:2]).isnan().any())  # the carry into the sign
    b = _pair(torch.full((6,), 0.75))
    assert torch.isnan(hi.double() * b[0] + hi.double() * b[1] + lo.double() * b[0]).all()
    finite = _table("random").flatten()
    hi, lo = kernels.split_tf32(finite)
    fb = finite.view(torch.int32)
    assert torch.equal(hi.view(torch.int32), (fb + 0x1000) & -0x2000)
    assert torch.equal(lo.view(torch.int32), kernels.to_tf32(finite - hi).view(torch.int32))


@pytest.mark.parametrize("kernel", ["k2", "k12b"])
@pytest.mark.parametrize("geo", GEOMETRIES[:3])
def test_tf32_tables_hold_the_dft_tables(kernel, geo):
    """ah and iw (K2: the inverse factors) or ah and ew (K12B: the adjoints
    of K1's forward factors) in f32, every entry in its place, the sign of
    the imaginary block, k padded to a multiple of 8 with zeros."""
    Hp, Wp, m2, m3, C = geo
    rows = kernels.K2_MMA_ROWS[C] if kernel == "k2" else kernels.K12B_MMA_ROWS[C]
    c = tfl._ct_consts(Hp, Wp, m2, m3)
    build = tfl._k2_tf32_tables if kernel == "k2" else tfl._k12b_tf32_tables
    ah, w = (t.numpy() for t in build(Hp, Wp, m2, m3, rows))
    nch, kpad = -(-Hp // rows), -(-4 * m2 // 8) * 8
    assert ah.dtype == w.dtype == np.float32
    assert ah.shape == (nch, 16, kpad) and w.shape == (-(-Wp // 16) * 16, 2 * m3)
    assert not ah[:, rows:8].any() and not ah[:, 8 + rows:].any()
    if kernel == "k2":   # Re ih = [ihr | -ihi], Im ih = [ihi | ihr]; w = [iwr^T | iwi^T]
        blocks = lambda h: ((c["ihr"][:, h], -c["ihi"][:, h]), (c["ihi"][:, h], c["ihr"][:, h]))
        wr, wi = c["iwr"].T, c["iwi"].T
    else:                # Re dX = [ehr | ehi], Im dX = [-ehi | ehr]; w = [ewr | ewi]
        blocks = lambda h: ((c["ehr"][h], c["ehi"][h]), (-c["ehi"][h], c["ehr"][h]))
        wr, wi = c["ewr"], c["ewi"]
    for h in range(nch * rows):
        re, im = ah[h // rows, h % rows], ah[h // rows, 8 + h % rows]
        if h >= Hp:
            assert not re.any() and not im.any()
            continue
        (r0, r1), (i0, i1) = blocks(h)
        np.testing.assert_array_equal(re[:4 * m2], np.concatenate([r0, r1]))
        np.testing.assert_array_equal(im[:4 * m2], np.concatenate([i0, i1]))
        assert not re[4 * m2:].any() and not im[4 * m2:].any()
    np.testing.assert_array_equal(w[:Wp, :m3], wr)
    np.testing.assert_array_equal(w[:Wp, m3:], wi)
    assert not w[Wp:].any()


# --------------------------------------------------------------------------
# the replays
# --------------------------------------------------------------------------


def _erf_fast(v):
    """fno_common.cuh::erf_and_gauss in f32, the erf of the tf32 variants'
    exact GELU: Abramowitz & Stegun 7.1.26, |error| <= 3e-7."""
    t = v.abs()
    r = 1.0 / (0.3275911 * t + 1.0)
    p = (((1.061405429 * r - 1.453152027) * r + 1.421413741) * r - 0.284496736) * r + 0.254829592
    return torch.copysign(1.0 - p * r * torch.exp(-t * t), v)


def _act_fast(u, act):
    """fno::affine_act_fast on u = a·x + b (f32): the exact GELU through the
    kernels' erf; the tanh form as fno::affine_act computes it."""
    if act == "tanh":
        return gelu(u, "tanh")
    return u if act == "none" else 0.5 * u * (1.0 + _erf_fast(u * math.sqrt(0.5)))


def _act_grad_fast(u, act):
    """fno::act_grad_fast (f32); the tanh form as fno::act_grad computes it."""
    if act == "tanh":
        return gelu_grad(u, "tanh")
    if act == "none":
        return torch.ones_like(u)
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return 0.5 * (1.0 + _erf_fast(u * math.sqrt(0.5))) + u * phi


def test_the_kernels_erf_is_within_5e_7_of_erf():
    """The replays' erf, GELU and GELU′ against the exact ones in f64 over
    the range the activations see: erf within 5e-7 (A&S's 1.5e-7, and the
    f32 rounding of 1 − p·r·e near 0, where it cancels), GELU within
    3e-7·|u| and GELU′ within 3e-7 + 6e-8·|u|."""
    u = torch.linspace(-12.0, 12.0, 200001, dtype=torch.float64)
    u32 = u.float()
    assert (_erf_fast(u32 * math.sqrt(0.5)).double() - torch.erf(u * math.sqrt(0.5))).abs().max() \
        <= 5e-7
    assert ((_act_fast(u32, "exact").double() - gelu(u, "exact")).abs()
            <= 3e-7 * u.abs() + 1e-12).all()
    assert ((_act_grad_fast(u32, "exact").double() - gelu_grad(u, "exact")).abs()
            <= 3e-7 + 6e-8 * u.abs()).all()


def _pair(t):
    """t → its tf32 (hi, lo) pair in f64."""
    return tuple(u.double() for u in kernels.split_tf32(t))


def _x3(eq, p, q):
    """The 3xTF32 product of two pairs by ``eq``: hi·hi + hi·lo + lo·hi."""
    return (torch.einsum(eq, p[0], q[0]) + torch.einsum(eq, p[0], q[1])
            + torch.einsum(eq, p[1], q[0]))


def _h_replay(inp, ah, BT, m2, m3, C, rows, Hp):
    """The H stage (fno_tf32.cuh::h_stage): [BT, Hp, 2m3, C] in f32, as the
    kernel keeps it in shared memory, from in [BT, 2m2*m3, 2C] and the table
    [nch, 16, Kpad]."""
    i5 = inp.float().view(BT, 2 * m2, m3, 2, C)
    G = torch.cat([i5[:, :, :, 0], i5[:, :, :, 1]], dim=1)     # [BT, (p', j), m3, C]
    out = _x3("nrk,bkmc->bnrmc", _pair(ah[..., :4 * m2]), _pair(G))
    out = out.view(BT, -1, 2, 8, m3, C)[:, :, :, :rows].transpose(2, 3)
    return out.reshape(BT, -1, 2 * m3, C)[:, :Hp].float()


def _replay_k2_tf32(g, x, a, b, wp, bp, *, Hp, Wp, m2, m3, act, rows=None):
    """K2's tf32 variant in plain PyTorch: ih from the H stage (f32), then
    s = bp + z·Wp + IW·ih with z = act(a·x + b) in f32 (the kernel's erf),
    every product on tf32 pairs, summed in f64. Returns (s, stats) in f64."""
    BT, C = x.shape[0], x.shape[-1] // 2
    rows = rows or kernels.K2_MMA_ROWS[C]   # H rows a block (8 below the widths taken)
    ah, iw = tfl._k2_tf32_tables(Hp, Wp, m2, m3, rows)
    ih = _h_replay(g, ah, BT, m2, m3, C, rows, Hp)
    spec = _x3("wk,bhkc->bhwc", _pair(iw[:Wp]), _pair(ih))
    z = _act_fast(x.float().view(BT, Hp, Wp, C) * a + b, act)
    s = spec + _x3("bhwc,cd->bhwd", _pair(z), _pair(wp)) + bp.double()
    return s, torch.stack([s.sum((0, 1, 2)), (s * s).sum((0, 1, 2))])


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


def _k2_inputs(Hp, Wp, m2, m3, BT, C, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: torch.from_numpy(
        (loc + scale * r.normal(size=s)).astype(np.float32))
    return (f(BT, 2 * m2 * m3, 2 * C, scale=20.0), f(BT, Hp * Wp // 2, 2 * C),
            f(C, scale=0.1, loc=1.0), f(C, scale=0.1), f(C, C, scale=C ** -0.5),
            f(C, scale=0.1))


@pytest.mark.parametrize("act", ["none", "exact"])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_k2_tf32_replay_matches_twin(geo, act):
    """The replay against the twin's arithmetic in f64: s within 1e-5 of
    max|ref|, the statistics within 1e-6 of the sum of |terms| per channel
    (ten times inside KERNEL_TOL and STATS_TOL, the bounds the kernel is
    held to on the card): every operand carries 22 bits."""
    Hp, Wp, m2, m3, C = geo
    BT = 2 if Hp > 20 else 4
    g, x, a, b, wp, bp = _k2_inputs(Hp, Wp, m2, m3, BT, C, seed=21)
    s, st = _replay_k2_tf32(g, x, a, b, wp, bp, Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    s64 = _twin_s64(g, x, a, b, wp, bp, (Hp, Wp, m2, m3), act)
    assert (s - s64).abs().max() <= 1e-5 * s64.abs().max()
    terms = torch.stack([s64.abs().sum((0, 1, 2)), (s64 * s64).sum((0, 1, 2))])
    ref = torch.stack([s64.sum((0, 1, 2)), (s64 * s64).sum((0, 1, 2))])
    assert ((st - ref).abs() / terms).max() <= 1e-6


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k2_tf32_replay_matches_pallas_k2(act):
    """The replay against the Pallas ``_k2_kernel`` in interpret mode (f32,
    the dims of tests/test_pallas_fno_layer.py): s, and the statistics with
    the two lane parities folded, rtol 2e-4."""
    B, Tp, Hp, Wp, C, m2, m3 = 2, 6, 10, 12, 8, 3, 4
    g, x, a, b, wp, bp = _k2_inputs(Hp, Wp, m2, m3, B * Tp, C, seed=22)
    n = lambda t: jnp.asarray(t.numpy())
    cst = jfl._ct_consts(Hp, Wp, m2, m3)
    eyeC, zC = np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32)
    ones = np.ones((Hp * Wp // 2, 1), np.float32)
    a2, b2 = jfl._pack_affine(n(a)[None], n(b)[None], C)
    _, k2, *_ = jfl._layer_calls(B * Tp, Hp, Wp // 2, 2 * C, m2, m3, act, True, "float32")
    s_ref, st_ref = k2(n(g), n(x), a2, b2, jfl._block_diag2(n(wp)),
                       jnp.concatenate([n(bp)[None], n(bp)[None]], axis=1), cst["IhP"],
                       cst["IwE2"], cst["IwO2"], np.concatenate([eyeC, zC], axis=1),
                       np.concatenate([zC, eyeC], axis=1), ones, ones)
    st_ref = np.asarray(st_ref)
    # the Pallas kernel's packed lanes pair two W positions: its s is the
    # port's [BT, Hp, Wp, C] viewed as [BT, Hp·Wp/2, 2C]
    s, st = _replay_k2_tf32(g, x, a, b, wp, bp, Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act, rows=8)
    _assert_close_to_pallas("_k2_kernel / s", s.float().numpy().reshape(np.shape(s_ref)),
                            np.asarray(s_ref))
    _assert_close_to_pallas("_k2_kernel / stats", st.float().numpy(),
                            st_ref[:, :C] + st_ref[:, C:])


def _assert_close_to_pallas(name, got, ref):
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * float(np.abs(ref).max()),
                               err_msg=name)


def _replay_k12b_tf32(x, a, b, wp, s, ds, ds1, ds2, dy, *, Hp, Wp, m2, m3, act,
                      rows=None):
    """K12B's tf32 variant in plain PyTorch: dX from the H stage (f32); dz =
    EW·dX + ds_eff·Wpᵀ with ds_eff = ds + ds1 + 2·ds2·s in f32; dWp =
    zᵀ·ds_eff with z = act(a·x + b) and act′(a·x + b) in f32 (the kernel's
    erf); every product on tf32 pairs, summed in f64. Returns (dx unrounded, dWp, da, db, dbp) in f64."""
    BT, C = x.shape[0], x.shape[-1] // 2
    rows = rows or kernels.K12B_MMA_ROWS[C]   # H rows a block (8 below the widths taken)
    ah, ew = tfl._k12b_tf32_tables(Hp, Wp, m2, m3, rows)
    dX = _h_replay(dy, ah, BT, m2, m3, C, rows, Hp)
    dz = _x3("wk,bhkc->bhwc", _pair(ew[:Wp]), _pair(dX))
    v = lambda t: t.float().view(BT, Hp, Wp, C)
    dse = v(ds) + ds1 + 2.0 * ds2 * v(s)
    dz = dz + _x3("bhwd,cd->bhwc", _pair(dse), _pair(wp))
    u = v(x) * a + b
    du = dz * _act_grad_fast(u, act).double()
    z = _act_fast(u, act)
    x4 = x.double().view(BT, Hp, Wp, C)
    dims = (0, 1, 2)
    return (du * a.double(), _x3("bhwc,bhwd->cd", _pair(z), _pair(dse)), (du * x4).sum(dims),
            du.sum(dims), dse.double().sum(dims))


def _k12b_inputs(Hp, Wp, m2, m3, BT, C, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: torch.from_numpy(
        (loc + scale * r.normal(size=s)).astype(np.float32))
    return dict(x=f(BT, Hp * Wp // 2, 2 * C), a=f(C, scale=0.1, loc=1.0), b=f(C, scale=0.1),
                wp=f(C, C, scale=0.3), s=f(BT, Hp * Wp // 2, 2 * C),
                ds=f(BT, Hp * Wp // 2, 2 * C), ds1=f(C), ds2=f(C, scale=0.1),
                dy=f(BT, 2 * m2 * m3, 2 * C))


def _k12b_f64(d, Hp, Wp, m2, m3, act):
    """k12b_plain's arithmetic in f64, and the sums of |terms| of its four
    accumulators."""
    d = {k: t.double() for k, t in d.items()}
    c = {k: torch.from_numpy(v).double() for k, v in tfl._ct_consts(Hp, Wp, m2, m3).items()}
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


_K12B_ARGS = ("x", "a", "b", "wp", "s", "ds", "ds1", "ds2", "dy")


@pytest.mark.parametrize("act", ["none", "exact"])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_k12b_tf32_replay_matches_twin(geo, act):
    """The replay against the twin's arithmetic in f64: dx within 1e-5 of
    max|ref|, dWp, da, db and dbp within 1e-6 of the sum of |terms| per
    entry (ten times inside the bounds the kernel is held to on the card)."""
    Hp, Wp, m2, m3, C = geo
    d = _k12b_inputs(Hp, Wp, m2, m3, 2 if Hp > 20 else 3, C, seed=23)
    want, terms = _k12b_f64(d, Hp, Wp, m2, m3, act)
    got = _replay_k12b_tf32(*(d[k] for k in _K12B_ARGS), Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    dx = got[0].reshape(want[0].shape)
    assert (dx - want[0]).abs().max() <= 1e-5 * want[0].abs().max()
    for name, gv, wv, tv in zip(("dwp", "da", "db", "dbp"), got[1:], want[1:], terms):
        assert ((gv - wv).abs() / tv.clamp_min(1e-30)).max() <= 1e-6, name


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k12b_tf32_replay_matches_pallas_k12b(act):
    """The replay against the Pallas ``_k12b_kernel`` in interpret mode (f32,
    the dims of tests/test_pallas_fno_layer.py), rtol 2e-4."""
    B, Tp, Hp, Wp, C, m2, m3 = 2, 6, 10, 12, 8, 3, 4
    d = _k12b_inputs(Hp, Wp, m2, m3, B * Tp, C, seed=24)
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
    got = _replay_k12b_tf32(*(d[k] for k in _K12B_ARGS), Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act,
                            rows=8)
    for name, g, r in zip(("dx", "dwp", "da", "db", "dbp"), got, ref):
        _assert_close_to_pallas(f"_k12b_kernel / {name}", g.float().numpy().reshape(r.shape), r)


# --------------------------------------------------------------------------
# K1 and K2A-lite: the (W, H) DFT body of csrc/fno_dft_tf32.cuh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["k1", "k2a_lite"])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_k1_and_k2a_lite_tf32_tables_hold_the_dft_tables(kernel, geo):
    """The f32 tables the tf32 variants are handed (``_k1_tables_on``,
    ``_k2a_tables_on``): the W table's rows are K1's forward factors (ewr,
    ewi as columns of w) or K2's inverse ones (iwr, iwi); the H table's row j
    gives Re Y_j from k = (re | im, r) as [hr | −hi], row 2m2 + j gives Im Y_j
    as [hi | hr], with (hr, hi) = (ehr, ehi) for K1 and (ihrᵀ, −ihiᵀ), the
    adjoint's signs, for K2A-lite; zeros in the padding; every entry as the
    f32 factor, unrounded."""
    Hp, Wp, m2, m3, _ = geo
    c = tfl._ct_consts(Hp, Wp, m2, m3)
    build = tfl._k1_tables_on if kernel == "k1" else tfl._k2a_tables_on
    w, h = (t.numpy() for t in build(torch.device("cpu"), Hp, Wp, m2, m3, "tf32"))
    nch, R, kw = -(-Hp // 8), -(-4 * m2 // 16) * 16, -(-Wp // 16) * 16
    assert w.dtype == h.dtype == np.float32
    assert w.shape == (2 * m3, kw) and h.shape == (nch, R, 16)
    if kernel == "k1":
        wr, wi, hr, hi = c["ewr"].T, c["ewi"].T, c["ehr"], c["ehi"]
    else:
        wr, wi, hr, hi = c["iwr"], c["iwi"], c["ihr"].T, -c["ihi"].T
    np.testing.assert_array_equal(w[:m3, :Wp], wr)
    np.testing.assert_array_equal(w[m3:, :Wp], wi)
    assert not w[:, Wp:].any()
    for hh in range(nch * 8):
        e, r = h[hh // 8], hh % 8
        want = (hr[hh], hi[hh]) if hh < Hp else (np.zeros(2 * m2),) * 2
        np.testing.assert_array_equal(e[:2 * m2, r], want[0])
        np.testing.assert_array_equal(e[:2 * m2, 8 + r], -want[1])
        np.testing.assert_array_equal(e[2 * m2:4 * m2, r], want[1])
        np.testing.assert_array_equal(e[2 * m2:4 * m2, 8 + r], want[0])
    assert not h[:, 4 * m2:].any()


def _wh_replay(v, tables, *, Hp, Wp, m2, m3):
    """The tf32 (W, H) DFT body in plain PyTorch from its f32 tables: v
    [BT, Hp, Wp, C] (f32, as the kernel holds it before the split) through
    the W product with EW on tf32 pairs, X rounded to f32 (the kernel keeps
    it in shared memory) into [16, m3·16] tiles of 8 rows, the H fold with
    EH chunk by chunk on pairs, summed in f64; Y [BT, 2m2·m3, 2C] in f64."""
    BT, C = v.shape[0], v.shape[-1]
    ew, eh = tables
    X = _x3("rw,bhwc->bhrc", _pair(ew[:, :Wp]), _pair(v)).float()   # rows r = (re | im, m)
    nch = eh.shape[0]
    X = F.pad(X, (0, 0, 0, 0, 0, nch * 8 - Hp))                    # [BT, nch*8, 2*m3, C]
    X = X.view(BT, nch, 8, 2, m3, C).transpose(2, 3).reshape(BT, nch, 16, m3, C)
    Y = _x3("nRk,bnkmc->bRmc", _pair(eh), _pair(X))[:, :4 * m2]      # rows (re | im, j)
    return Y.view(BT, 2, 2 * m2, m3, C).permute(0, 2, 3, 1, 4).reshape(BT, -1, 2 * C)


def _replay_k1_tf32(x, a, b, *, Hp, Wp, m2, m3, act):
    """K1's tf32 variant: z = act(a·x + b) in f32 (the kernel's erf), then
    the body on K1's f32 tables; y in f64."""
    BT, C = x.shape[0], x.shape[-1] // 2
    z = _act_fast(x.float().view(BT, Hp, Wp, C) * a + b, act)
    tables = tfl._k1_tables_on(torch.device("cpu"), Hp, Wp, m2, m3, "tf32")
    return _wh_replay(z, tables, Hp=Hp, Wp=Wp, m2=m2, m3=m3)


def _k1_twin64(x, a, b, geo, act):
    """k1_plain's arithmetic in f64."""
    Hp, Wp, m2, m3 = geo
    c = {k: torch.from_numpy(v).double() for k, v in tfl._ct_consts(*geo).items()}
    BT, C = x.shape[0], x.shape[-1] // 2
    return tfl.k1_plain(x.double(), a.double(), b.double(), c, Hp=Hp, Wp=Wp, act=act)


def _k1_inputs(Hp, Wp, BT, C, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: torch.from_numpy(
        (loc + scale * r.normal(size=s)).astype(np.float32))
    return f(BT, Hp * Wp // 2, 2 * C), f(C, scale=0.1, loc=1.0), f(C, scale=0.1)


@pytest.mark.parametrize("act", ["none", "exact", "tanh"])
@pytest.mark.parametrize("geo", GEOMETRIES)
def test_k1_tf32_replay_matches_twin(geo, act):
    """The replay against the twin's arithmetic in f64: y within 1e-5 of
    max|ref|, ten times inside KERNEL_TOL: z, the tables and X each carry
    22 bits, X's f32 rounding 24."""
    Hp, Wp, m2, m3, C = geo
    x, a, b = _k1_inputs(Hp, Wp, 2 if Hp > 20 else 3, C, seed=31)
    got = _replay_k1_tf32(x, a, b, Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    ref = _k1_twin64(x, a, b, (Hp, Wp, m2, m3), act)
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k1_tf32_replay_matches_pallas_k1(act):
    """The replay against the Pallas ``_k1_kernel`` in interpret mode (f32,
    the dims of tests/test_pallas_fno_layer.py), rtol 2e-4."""
    B, Tp, Hp, Wp, C, m2, m3 = 2, 6, 10, 12, 8, 3, 4
    x, a, b = _k1_inputs(Hp, Wp, B * Tp, C, seed=32)
    n = lambda t: jnp.asarray(t.numpy())
    cst = jfl._ct_consts(Hp, Wp, m2, m3)
    a2, b2 = jfl._pack_affine(n(a)[None], n(b)[None], C)
    k1, *_ = jfl._layer_calls(B * Tp, Hp, Wp // 2, 2 * C, m2, m3, act, True, "float32")
    ref = np.asarray(k1(n(x), a2, b2, cst["E67X"], cst["EhP"],
                        np.ones((Hp * Wp // 2, 1), np.float32)))
    got = _replay_k1_tf32(x, a, b, Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    _assert_close_to_pallas("_k1_kernel / y", got.float().numpy(), ref)


def _k2a_lite_inputs(Hp, Wp, m2, m3, BT, C, seed):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: torch.from_numpy(
        (loc + scale * r.normal(size=s)).astype(np.float32))
    Y = 2 * m2 * m3
    return dict(ds=f(BT, Hp * Wp // 2, 2 * C), g=f(BT, Y, 2 * C), y=f(BT, Y, 2 * C, scale=3.0),
                ds1=f(C), ds2=f(C, scale=0.1), wp=f(C, C, scale=0.3), bp=f(C, scale=0.1))


_K2A_ARGS = ("ds", "g", "y", "ds1", "ds2", "wp", "bp")


def _replay_k2a_lite_tf32(ds, g, y, ds1, ds2, wp, bp, *, Hp, Wp, m2, m3):
    """K2A-lite's tf32 variant: A(ds) through the body on the adjoint's f32
    tables, then the epilogue with the wrapper's f32 folds (two = 2·ds2,
    dsc = ds1 + two·bp, wps = wp·two): y @ wps on tf32 pairs, the
    elementwise terms; dg in f64."""
    BT, C = ds.shape[0], ds.shape[-1] // 2
    geo = (Hp, Wp, m2, m3)
    tables = tfl._k2a_tables_on(torch.device("cpu"), *geo, "tf32")
    A = _wh_replay(ds.float().view(BT, Hp, Wp, C), tables, Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    Y = A.shape[1]
    lite = {k: torch.from_numpy(v).double()[..., None] for k, v in tfl._lite_consts(*geo).items()}
    two = 2.0 * ds2
    dsc, wps = ds1 + two * bp, wp * two[None, :]
    g4 = g.double().view(BT, Y, 2, C)
    mir = torch.from_numpy(tfl._kh_mirror(m2, m3))
    yw = _x3("byrk,kc->byrc", _pair(y.view(BT, Y, 2, C)), _pair(wps))
    dg = (A.view(BT, Y, 2, C) + two.double() * (lite["alpha"] * g4 + lite["beta"] * g4[:, mir])
          + lite["D"] * yw + dsc.double() * lite["A1"])
    return dg.reshape(BT, Y, 2 * C)


def _k2a_lite_twin64(d, geo):
    """k2a_lite_plain's arithmetic in f64 (the lite statics as the f32
    arrays both sides read)."""
    Hp, Wp, m2, m3 = geo
    d = {k: t.double() for k, t in d.items()}
    cst = {k: torch.from_numpy(v).double() for k, v in tfl._ct_consts(*geo).items()}
    col = {k: torch.from_numpy(v).double()[..., None] for k, v in tfl._lite_consts(*geo).items()}
    BT, C = d["ds"].shape[0], d["ds"].shape[-1] // 2
    Y = 2 * m2 * m3
    dg = tfl._adjoint_inverse(d["ds"].view(BT, Hp, Wp, C), cst).view(BT, Y, 2, C)
    g4 = d["g"].view(BT, Y, 2, C)
    mir = torch.from_numpy(tfl._kh_mirror(m2, m3))
    As = (col["alpha"] * g4 + col["beta"] * g4[:, mir]
          + (col["D"] * d["y"].view(BT, Y, 2, C)) @ d["wp"] + d["bp"] * col["A1"])
    return (dg + d["ds1"] * col["A1"] + 2.0 * d["ds2"] * As).reshape(BT, Y, 2 * C)


# GEOMETRIES with, at C 128, one that has lite statics (at Hp 9, Wp 20 the
# structure fit rejects m3 16, and the layer runs K2A)
K2A_LITE_GEOMETRIES = GEOMETRIES[:3] + [(33, 38, 16, 16, 128)]


@pytest.mark.parametrize("geo", K2A_LITE_GEOMETRIES)
def test_k2a_lite_tf32_replay_matches_twin(geo):
    """The replay against the twin's arithmetic in f64: dg within 1e-5 of
    max|ref|, ten times inside KERNEL_TOL."""
    Hp, Wp, m2, m3, C = geo
    d = _k2a_lite_inputs(Hp, Wp, m2, m3, 2 if Hp > 20 else 3, C, seed=33)
    got = _replay_k2a_lite_tf32(*(d[k] for k in _K2A_ARGS), Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    ref = _k2a_lite_twin64(d, (Hp, Wp, m2, m3))
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_k2a_lite_tf32_replay_matches_pallas_k2a_lite():
    """The replay against the Pallas ``_k2a_lite_kernel`` in interpret mode
    (f32, the dims of tests/test_pallas_fno_layer.py), rtol 2e-4."""
    B, Tp, Hp, Wp, C, m2, m3 = 2, 6, 10, 12, 8, 3, 4
    J, Y = Wp // 2, 2 * m2 * m3
    d = _k2a_lite_inputs(Hp, Wp, m2, m3, B * Tp, C, seed=34)
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
    got = _replay_k2a_lite_tf32(*(d[k] for k in _K2A_ARGS), Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    _assert_close_to_pallas("_k2a_lite_kernel / dg", got.float().numpy(), ref)


# --------------------------------------------------------------------------
# the choice
# --------------------------------------------------------------------------


@pytest.mark.parametrize("args, want", [
    ((torch.float32, 64, 16, 134, 24), "tf32"),    # the cylinder: 9 warps, 107 KB
    ((torch.float32, 64, 16, 134, 32), "tf32"),    # combustion's modes 4/16/16
    ((torch.float32, 128, 16, 134, 32), "tf32"),   # fsi: 9 warps, 219 KB
    ((torch.float32, 32, 8, 22, 10), "tf32"),      # the gpu tests' small shapes
    ((torch.float32, 64, 16, 256, 24), "tf32"),    # 16 warps
    ((torch.float32, 64, 16, 258, 24), "fma"),     # a 17th warp
    ((torch.float32, 128, 16, 146, 32), "fma"),    # a 10th warp at C 128
    ((torch.float32, 64, 12, 134, 24), "fma"),     # m3 not instantiated
    ((torch.float32, 16, 8, 22, 10), "fma"),       # C not instantiated
    ((torch.float32, 64, 16, 134, 34), "fma"),     # more than 32 H modes
    ((torch.bfloat16, 64, 16, 134, 24), "mma"),    # bf16 keeps its variant
])
def test_k2_tf32_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.k2_variant(*args) == want
    assert kernels.k2_variant(*args, aligned=False) == "fma"
    dtype, C, m3, Wp, m2x2 = args
    if want == "tf32":
        assert kernels.k2_tf32_smem_bytes(Wp, C, m2x2, m3) <= kernels.MAX_SMEM_BYTES


@pytest.mark.parametrize("args, want", [
    ((torch.float32, 64, 24, 16, 134), "tf32"),    # the cylinder: 9 warps, 85 KB
    ((torch.float32, 64, 32, 16, 134), "tf32"),    # combustion's modes 4/16/16
    ((torch.float32, 128, 32, 16, 134), "tf32"),   # fsi: 9 warps, 215 KB
    ((torch.float32, 32, 10, 8, 22), "tf32"),
    ((torch.float32, 64, 24, 16, 256), "tf32"),    # 16 warps
    ((torch.float32, 64, 24, 16, 258), "fma"),     # a 17th warp
    ((torch.float32, 128, 32, 16, 146), "fma"),    # a 10th warp at C 128
    ((torch.float32, 64, 24, 4, 134), "fma"),      # m3 not instantiated
    ((torch.float32, 8, 6, 4, 12), "fma"),         # C not instantiated
    ((torch.float32, 64, 34, 16, 134), "fma"),     # more than 32 H modes
    ((torch.bfloat16, 64, 24, 16, 134), "mma"),    # bf16 keeps its variant
])
def test_k12b_tf32_variant_is_a_pure_function_of_dtype_and_shape(args, want):
    assert kernels.k12b_variant(*args) == want
    assert kernels.k12b_variant(*args, aligned=False) == "fma"
    dtype, C, m2x2, m3, Wp = args
    if want == "tf32":
        assert kernels.k12b_tf32_smem_bytes(Wp, C, m2x2, m3) <= kernels.MAX_SMEM_BYTES
        assert kernels.k12b_tf32_dwp_smem_bytes(C) <= kernels.MAX_SMEM_BYTES


@pytest.mark.parametrize("kernel", ["k1", "k2a_lite"])
@pytest.mark.parametrize("args, want", [
    ((torch.float32, 64, 24, 16, 134), "tf32"),    # the cylinder
    ((torch.float32, 64, 32, 16, 134), "tf32"),    # combustion's modes 4/16/16
    ((torch.float32, 128, 32, 16, 134), "tf32"),   # fsi's width 128
    ((torch.float32, 32, 10, 8, 22), "tf32"),      # the gpu tests' small shapes
    ((torch.float32, 16, 6, 8, 12), "tf32"),       # one 16-channel slice
    ((torch.float32, 64, 24, 16, 256), "tf32"),    # the widest W
    ((torch.float32, 64, 24, 16, 258), "fma"),     # Wp past 256
    ((torch.float32, 8, 6, 4, 12), "fma"),         # C below a slice
    ((torch.float32, 40, 6, 8, 12), "fma"),        # C no multiple of 16
    ((torch.float32, 64, 24, 12, 134), "fma"),     # m3 not instantiated
    ((torch.float32, 64, 34, 16, 134), "fma"),     # more than 32 H modes
    ((torch.bfloat16, 64, 24, 16, 134), "mma"),    # bf16 keeps its variant
])
def test_k1_and_k2a_lite_tf32_variant_is_a_pure_function_of_dtype_and_shape(kernel, args, want):
    choose = kernels.k1_variant if kernel == "k1" else kernels.k2a_lite_variant
    assert choose(*args) == want
    assert choose(*args) == want                   # no state
    assert choose(*args, aligned=False) == "fma"
    dtype, C, m2x2, m3, Wp = args
    if want == "tf32":
        size = (kernels.k1_tf32_smem_bytes(Wp, m3) if kernel == "k1"
                else kernels.k2a_lite_tf32_smem_bytes(Wp, m3, C))
        assert size <= kernels.MAX_SMEM_BYTES


def test_k2a_lite_tf32_variant_takes_widths_up_to_128():
    """K2A-lite's slice of wps grows with C: the tf32 variant stops at 128,
    as the mma one does; K1's takes wider."""
    assert kernels.k2a_lite_variant(torch.float32, 256, 24, 16, 134) == "fma"
    assert kernels.k1_variant(torch.float32, 256, 24, 16, 134) == "tf32"


def test_k1_and_k2a_lite_tf32_blocks_fit_twice_an_sm():
    """At m3 16, Wp 134: K1's tf32 block takes 102528 bytes (EW's tf32 pair
    35840, two X tiles 33792, the rings of 32-row pieces 32768; rings of
    whole f32 rows would take 147456 alone), K2A-lite's 107136 at C 64 and
    111744 at fsi's C 128 (the wps slice in f32): two blocks (16 warps) an
    SM at both widths (228 KB, 1 KB reserved a block)."""
    assert kernels.k1_tf32_smem_bytes(134, 16) == 102528
    assert kernels.k2a_lite_tf32_smem_bytes(134, 16, 64) == 107136
    assert kernels.k2a_lite_tf32_smem_bytes(134, 16, 128) == 111744
    assert 8 * 2 * 144 * 16 * 4 == 147456
    for size in (102528, 107136, 111744):
        assert 2 * (size + 1024) <= 228 * 1024


def test_tf32_blocks_fit_twice_an_sm_at_the_cylinder_width():
    """At C 64, m3 16, 2·m2 24, Wp 134: K2's tf32 block takes 109312 bytes
    (ih; then Wpᵀ's tf32 pair and the x ring of 16-channel stages where the
    g rings were; whole-row f32 slabs alone would take 145 KB), K12B's dz
    block 86528 and its dWp block 75776: two, two and three blocks an SM
    (228 KB, 1 KB reserved a block). fsi's width 128 fits one block an SM."""
    assert kernels.k2_tf32_smem_bytes(134, 64, 24, 16) == 109312
    assert kernels.k12b_tf32_smem_bytes(134, 64, 24, 16) == 86528
    assert kernels.k12b_tf32_dwp_smem_bytes(64) == 75776
    for size, blocks in ((109312, 2), (86528, 2), (75776, 3)):
        assert blocks * (size + 1024) <= 228 * 1024
    for size in (kernels.k2_tf32_smem_bytes(134, 128, 32, 16),
                 kernels.k12b_tf32_smem_bytes(134, 128, 32, 16),
                 kernels.k12b_tf32_dwp_smem_bytes(128)):
        assert size <= kernels.MAX_SMEM_BYTES


@pytest.mark.parametrize("kernel", ["k3f", "k3b"])
@pytest.mark.parametrize("args, want", [
    ((torch.float32, 64, 3), "tf32"),      # the cylinder
    ((torch.float32, 64, 6), "tf32"),      # a two-step window of 3 channels
    ((torch.float32, 128, 6), "tf32"),     # fsi's width
    ((torch.float32, 32, 8), "tf32"),      # F at its bound
    ((torch.float32, 64, 9), "tf32"),      # F past 8: fc2 over two n-tiles
    ((torch.float32, 64, 16), "tf32"),     # the combustion scenario's F
    ((torch.float32, 128, 16), "fma"),     # two n-tiles built at C 64 alone
    ((torch.float32, 64, 17), "fma"),      # F past 16
    ((torch.float32, 16, 3), "fma"),       # C not instantiated
    ((torch.float32, 96, 3), "fma"),
    ((torch.float32, 256, 3), "fma"),      # C past 128
    ((torch.bfloat16, 64, 3), "mma"),      # bf16 keeps its variant
])
def test_tail_tf32_variant_is_a_pure_function_of_dtype_and_shape(kernel, args, want):
    """K3F and K3B choose alike (they share one forward): a pure function of
    (dtype, C, F, aligned), the tf32 block within the shared memory."""
    choose = kernels.k3f_variant if kernel == "k3f" else kernels.k3b_variant
    assert choose(*args) == want
    assert choose(*args) == want                   # no state
    assert choose(*args, aligned=False) == "fma"
    if want == "tf32":
        size = (kernels.k3f_tf32_smem_bytes if kernel == "k3f"
                else kernels.k3b_tf32_smem_bytes)(*args[1:])
        assert size <= kernels.MAX_SMEM_BYTES


def test_tail_tf32_blocks_fit_the_shared_memory():
    """K3F's tf32 block takes 109408 bytes at C 64: two an SM (228 KB, 1 KB
    reserved a block). K3B's takes 185632 at C 64 and, with one z stage,
    218400 at fsi's C 128, where a second stage (67584 more) would not fit:
    one an SM."""
    assert kernels.k3f_tf32_smem_bytes(64) == 109408
    assert 2 * (109408 + 1024) <= 228 * 1024
    assert kernels.k3b_tf32_smem_bytes(64) == 185632
    assert kernels.k3b_tf32_smem_bytes(128) == 218400 <= kernels.MAX_SMEM_BYTES
    assert [kernels.k3b_tf32_stages(C) for C in (32, 64, 128)] == [2, 2, 1]
    assert kernels.k3b_tf32_smem_bytes(128) + 4 * 128 * (128 + 4) > kernels.MAX_SMEM_BYTES


def test_tail_tensor_core_blocks_fit_the_shared_memory_at_f16():
    """At F 16 (two n-tiles of fc2, built at C 64) K3F's tf32 block takes
    113792 bytes, still two an SM; K3B's tf32 198720 and its mma 171584,
    one an SM, each with two z stages."""
    assert kernels.k3f_tf32_smem_bytes(64, 16) == 113792
    assert 2 * (113792 + 1024) <= 228 * 1024
    assert kernels.k3b_tf32_smem_bytes(64, 16) == 198720 <= kernels.MAX_SMEM_BYTES
    assert kernels.k3b_mma_smem_bytes(64, 16) == 171584 <= kernels.MAX_SMEM_BYTES
    assert 2 * (kernels.k3f_mma_smem_bytes(64, 16) + 1024) <= 228 * 1024
    for F_ in range(1, 9):   # F <= 8: the layouts of the first versions
        assert kernels.k3f_tf32_smem_bytes(64, F_) == 109408
        assert kernels.k3b_tf32_smem_bytes(64, F_) == 185632


@pytest.mark.parametrize("kernel, dtype, C, m3, offset", [
    ("k1", torch.bfloat16, 64, 16, 0),     # bf16
    ("k1", torch.float32, 8, 16, 0),       # C below a 16-channel slice
    ("k1", torch.float32, 64, 12, 0),      # m3 not instantiated
    ("k1", torch.float32, 64, 16, 1),      # x 4 bytes past a 16-byte boundary
    ("k2a_lite", torch.bfloat16, 64, 16, 0),
    ("k2a_lite", torch.float32, 256, 16, 0),   # C past 128
    ("k2a_lite", torch.float32, 64, 12, 0),
    ("k2a_lite", torch.float32, 64, 16, 1),    # ds misaligned
    ("k2", torch.bfloat16, 64, 16, 0),     # bf16
    ("k2", torch.float32, 16, 16, 0),      # C not instantiated
    ("k2", torch.float32, 64, 12, 0),      # m3 not instantiated
    ("k2", torch.float32, 64, 16, 1),      # x 4 bytes past a 16-byte boundary
    ("k12b", torch.bfloat16, 64, 16, 0),
    ("k12b", torch.float32, 8, 8, 0),
    ("k12b", torch.float32, 64, 4, 0),
    ("k12b", torch.float32, 64, 16, 1),
    ("k3f", torch.bfloat16, 64, 16, 0),    # bf16
    ("k3f", torch.float32, 16, 16, 0),     # C not instantiated
    ("k3f", torch.float32, 64, 16, 1),     # s 4 bytes past a 16-byte boundary
    ("k3b", torch.bfloat16, 64, 16, 0),
    ("k3b", torch.float32, 96, 16, 0),
    ("k3b", torch.float32, 64, 16, 1),
])
def test_a_named_tf32_variant_refuses_what_it_does_not_take(kernel, dtype, C, m3, offset):
    """The choice before the launch: a named tf32 variant that cannot take
    the input raises before anything is built or launched (the tensors lie
    on the CPU here); the unnamed choice and a named fma take it."""
    BT, Hp, Wp, m2 = 2, 17, 38, 4
    n = BT * Hp * Wp * C
    x = torch.zeros(n + 8, dtype=dtype)[offset:offset + n].view(BT, Hp * Wp // 2, 2 * C)
    dy = torch.zeros(BT, 2 * m2 * m3, 2 * C, dtype=dtype)
    wp = torch.zeros(C, C)
    pick = {"k1": lambda v: kernels._k1_variant(x, C, 2 * m2, m3, Wp, v),
            "k2a_lite": lambda v: kernels._k2a_lite_variant(x, dy, dy, C, 2 * m2, m3, Wp, v),
            "k2": lambda v: kernels._k2_variant(dy, x, wp, C, m3, Wp, 2 * m2, v),
            "k12b": lambda v: kernels._k12b_variant(x, x, x, dy, C, 2 * m2, m3, Wp, v),
            "k3f": lambda v: kernels._tail_variant("k3f", x, C, 3, v),
            "k3b": lambda v: kernels._tail_variant("k3b", x, C, 3, v)}[kernel]
    with pytest.raises(ValueError, match="tf32 variant takes float32"):
        pick("tf32")
    with pytest.raises(ValueError, match="no variant"):
        pick("wgmma")
    chosen = "mma" if dtype == torch.bfloat16 else "fma"
    assert pick(None) == (chosen, list(kernels.VARIANTS[kernel]).index(chosen))
    assert pick("fma") == ("fma", 0)


# --------------------------------------------------------------------------
# K3F and K3B: the fused tail (csrc/fno_tail.cu, forward_warp_tf32)
# --------------------------------------------------------------------------


def _tail_forward_tf32(s, k1, b1, k2, b2, *, dims, tail_dims, act):
    """The forward the tf32 variants of K3F and K3B share: u1 = z·k1 + b1 on
    the tf32 pairs of z and k1, kept in f32; h1 = act(u1) in f32 (the
    kernels' erf); o = h1·k2 + b2 on the pairs of h1 and k2, in f64. Returns
    (z, u1, h1, o), positions as rows."""
    B, Tp, Hp, Wp, C = dims
    T, H, W = tail_dims
    z = s.float().view(B, Tp, Hp, Wp, C)[:, :T, :H, :W].reshape(-1, C)
    u1 = (_x3("nc,cj->nj", _pair(z), _pair(k1)) + b1.double()).float()
    h1 = _act_fast(u1, act)
    return z, u1, h1, _x3("nj,jf->nf", _pair(h1), _pair(k2)) + b2.double()


def _replay_k3f_tf32(s, target, k1, b1, k2, b2, *, dims, tail_dims, act):
    """K3F's tf32 variant in plain PyTorch: the shared forward, then
    Σ (o − target)² in f64 (the kernel's per-thread sums are f64)."""
    o = _tail_forward_tf32(s, k1, b1, k2, b2, dims=dims, tail_dims=tail_dims, act=act)[3]
    return ((o - target.double().reshape(o.shape)) ** 2).sum()


def _replay_k3b_tf32(s, target, k1, b1, k2, b2, g, *, dims, tail_dims, act):
    """K3B's tf32 variant in plain PyTorch: the shared forward; do = 2g(o −
    target) and du = (do·k2ᵀ)·act′(u1) in f32 (exact FMAs in the kernel);
    ds = du·k1ᵀ, dk1 = zᵀ·du and dk2 = h1ᵀ·do on tf32 pairs; db1 = Σ du
    through a row of ones (exact in tf32: the sum of du's pair); db2 = Σ do;
    in f64. Returns (ds in f32 like s, zero outside the crop; dk1, db1, dk2,
    db2)."""
    B, Tp, Hp, Wp, C = dims
    T, H, W = tail_dims
    z, u1, h1, o = _tail_forward_tf32(s, k1, b1, k2, b2, dims=dims, tail_dims=tail_dims,
                                      act=act)
    do = (2.0 * g.double() * (o - target.double().reshape(o.shape))).float()
    du = ((do.double() @ k2.double().t()) * _act_grad_fast(u1, act).double()).float()
    ds = torch.zeros(B, Tp, Hp, Wp, C)
    ds[:, :T, :H, :W] = _x3("nj,cj->nc", _pair(du), _pair(k1)).float().view(B, T, H, W, C)
    dup = _pair(du)
    return (ds.view(s.shape), _x3("nc,nj->cj", _pair(z), dup), (dup[0] + dup[1]).sum(0),
            _x3("nj,nf->jf", _pair(h1), _pair(do)), do.double().sum(0))


def _tail_twin64(s, tail, g, shape, act):
    """k3f_plain's and k3b_plain's arithmetic in f64: (SSE, ds over the crop
    as rows, dk1, db1, dk2, db2) and the sums of |terms| of the four
    accumulators."""
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    target, k1, b1, k2, b2 = (t.double() for t in tail)
    z = s.double().view(B, Tp, Hp, Wp, C)[:, :T, :H, :W].reshape(-1, C)
    u1 = z @ k1 + b1
    h1 = gelu(u1, act)
    err = h1 @ k2 + b2 - target.reshape(-1, F_)
    do = 2.0 * g.double() * err
    du = (do @ k2.t()) * gelu_grad(u1, act)
    terms = (z.abs().t() @ du.abs(), du.abs().sum(0), h1.abs().t() @ do.abs(), do.abs().sum(0))
    return ((err ** 2).sum(), du @ k1.t(), z.t() @ du, du.sum(0), h1.t() @ do,
            do.sum(0)), terms


@pytest.mark.parametrize("act", ["exact", "tanh"])
@pytest.mark.parametrize("shape", K3B_SHAPES)
def test_k3f_tf32_replay_matches_twin(shape, act):
    """The replay of K3F's tf32 variant against the twin's arithmetic in
    f64: the SSE within 1e-5 of it (its own sum of |terms|), ten times
    inside STATS_TOL; and against the f32 twin within STATS_TOL."""
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=41)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act)
    got = _replay_k3f_tf32(s, *tail, **kw)
    ref = _tail_twin64(s, tail, gl, shape, act)[0][0]
    assert abs(got - ref) <= 1e-5 * ref
    assert abs(got - ft.k3f_plain(s, *tail, **kw).double()) <= 1e-4 * ref


@pytest.mark.parametrize("act", ["exact", "tanh"])
@pytest.mark.parametrize("shape", K3B_SHAPES)
def test_k3b_tf32_replay_matches_twin(shape, act):
    """The replay of K3B's tf32 variant against the twin's arithmetic in
    f64: ds within 1e-5 of max|ref| and exactly zero outside the crop; dk1,
    db1, dk2 and db2 within 1e-5 of the sum of |terms| (ten times inside
    KERNEL_TOL and STATS_TOL); and against the f32 twin within those."""
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=42)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act)
    got = _replay_k3b_tf32(s, *tail, gl, **kw)
    want, terms = _tail_twin64(s, tail, gl, shape, act)
    ds = got[0].view(B, Tp, Hp, Wp, C)
    assert got[0].dtype == torch.float32 and got[0].shape == s.shape
    assert not ds[:, T:].any() and not ds[:, :, H:].any() and not ds[:, :, :, W:].any()
    crop = ds[:, :T, :H, :W].reshape(-1, C).double()
    assert (crop - want[1]).abs().max() <= 1e-5 * want[1].abs().max()
    for name, gv, wv, tv in zip(("dk1", "db1", "dk2", "db2"), got[1:], want[2:], terms):
        assert ((gv - wv).abs() / tv.clamp_min(1e-30)).max() <= 1e-5, name
    twin = ft.k3b_plain(s, *tail, gl, **kw)
    assert (got[0] - twin[0]).abs().max() <= 1e-4 * twin[0].abs().max()
    for name, gv, tw, tv in zip(("dk1", "db1", "dk2", "db2"), got[1:], twin[1:], terms):
        assert ((gv - tw.double()).abs() / tv.clamp_min(1e-30)).max() <= 1e-4, name


@pytest.mark.parametrize("where, value", [("s", "nan"), ("s", "inf"), ("k1", "nan"),
                                          ("k1", "-inf")])
def test_tail_tf32_replays_keep_non_finite_inputs(where, value):
    """A NaN or an Inf in s (inside the crop) or in k1: the replays' SSE,
    ds, dk1, db1, dk2 and db2 are non-finite wherever the f32 twin's are,
    and the fault shows in each of the twin's outputs."""
    shape = K3B_SHAPES[1]
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=46)
    if where == "s":
        s.view(B, Tp, Hp, Wp, C)[0, 1, 2, 3, 5] = float(value)
    else:
        tail[1][5, 7] = float(value)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    got = (_replay_k3f_tf32(s, *tail, **kw), *_replay_k3b_tf32(s, *tail, gl, **kw))
    ref = (ft.k3f_plain(s, *tail, **kw), *ft.k3b_plain(s, *tail, gl, **kw))
    for name, gv, rv in zip(("sse", "ds", "dk1", "db1", "dk2", "db2"), got, ref):
        bad = ~torch.isfinite(rv)
        assert bad.any() and not torch.isfinite(gv[bad]).any(), name


@pytest.mark.parametrize("act", ["exact", "tanh"])
def test_k3f_tf32_replay_matches_pallas_k3f(act):
    """The replay against the Pallas ``_k3f_kernel`` in interpret mode (f32):
    the JAX fused tail's loss, rtol 2e-4."""
    shape = (2, 5, 8, 12, 8, 3, 6, 10, 6)
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, _ = _k3b_inputs(shape, seed=43)
    loss, prim, _ = _jax_fused_tail(s, tail, shape, act)
    got = _replay_k3f_tf32(s, *tail, dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act)
    np.testing.assert_allclose(got.item(), float(loss(*prim)), rtol=2e-4)


@pytest.mark.parametrize("act", ["exact", "tanh"])
def test_k3b_tf32_replay_matches_pallas_k3b(act):
    """The replay against the Pallas ``_k3b_kernel`` in interpret mode (f32),
    reached through the JAX fused tail's vjp: ds, dk1, db1, dk2 and db2,
    rtol 2e-4, atol 2e-4·max|ref|."""
    shape = (2, 5, 8, 12, 8, 3, 6, 10, 6)
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=44)
    loss, prim, unpack = _jax_fused_tail(s, tail, shape, act)
    _, vjp = jax.vjp(loss, *prim)
    ref = unpack(*(np.asarray(t) for t in vjp(jnp.float32(gl.item()))))
    got = _replay_k3b_tf32(s, *tail, gl, dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act)
    for name, g, r in zip(("ds", "dk1", "db1", "dk2", "db2"), got, ref):
        _assert_close_to_pallas(f"_k3b_kernel / {name}", g.float().numpy().reshape(r.shape), r)


@pytest.mark.parametrize("shape", TAIL_F_SHAPES)
def test_tail_tf32_replay_over_two_n_tiles_matches_twin(shape):
    """The tf32 variants' replay with fc2 over two n-tiles (F 9, 16: k2, b2
    and the target padded to 16 columns, an n-tile of 8 at a time, the
    padded columns exactly 0 in dk2 and db2) against the twin's arithmetic
    in f64: the SSE within 1e-5 of it, ds within 1e-5 of max|ref|, dk1,
    db1, dk2 and db2 within 1e-5 of the sum of |terms|."""
    B, Tp, Hp, Wp, C, T, H, W, F_ = shape
    s, tail, gl = _k3b_inputs(shape, seed=47)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    got = _replay_tail_n_tiles(_replay_k3f_tf32, _replay_k3b_tf32, s, tail, gl, **kw)
    want, terms = _tail_twin64(s, tail, gl, shape, "exact")
    assert abs(got[0] - want[0]) <= 1e-5 * want[0]
    ds = got[1].view(B, Tp, Hp, Wp, C)
    assert not ds[:, T:].any() and not ds[:, :, H:].any() and not ds[:, :, :, W:].any()
    crop = ds[:, :T, :H, :W].reshape(-1, C)
    assert (crop - want[1]).abs().max() <= 1e-5 * want[1].abs().max()
    for name, gv, wv, tv in zip(("dk1", "db1", "dk2", "db2"), got[2:], want[2:], terms):
        assert ((gv - wv).abs() / tv.clamp_min(1e-30)).max() <= 1e-5, name


@pytest.mark.parametrize("F_", [9, 16])
def test_tail_tf32_replay_over_two_n_tiles_matches_pallas(F_):
    """The tf32 replay over two n-tiles against the Pallas ``_k3f_kernel``
    and ``_k3b_kernel`` in interpret mode through the JAX fused tail, rtol
    2e-4, atol 2e-4·max|ref|."""
    shape = (2, 5, 8, 12, 8, 3, 6, 10, F_)
    B, Tp, Hp, Wp, C, T, H, W, _ = shape
    s, tail, gl = _k3b_inputs(shape, seed=48)
    loss, prim, unpack = _jax_fused_tail(s, tail, shape, "exact")
    _, vjp = jax.vjp(loss, *prim)
    ref = unpack(*(np.asarray(t) for t in vjp(jnp.float32(gl.item()))))
    got = _replay_tail_n_tiles(_replay_k3f_tf32, _replay_k3b_tf32, s, tail, gl,
                               dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    np.testing.assert_allclose(float(got[0]), float(loss(*prim)), rtol=2e-4)
    for name, g, r in zip(("ds", "dk1", "db1", "dk2", "db2"), got[1:], ref):
        _assert_close_to_pallas(f"_k3b_kernel / {name}", g.float().numpy().reshape(r.shape), r)


# --------------------------------------------------------------------------
# TA forward and backward (csrc/temporal_attention.cu, ta_*_tf32_kernel)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["ta_fwd", "ta_bwd"])
@pytest.mark.parametrize("args, want", [
    ((torch.float32, 20, 4, 32), "tf32"),      # the UNet: T 20, 4 heads of 32
    ((torch.float32, 32, 4, 32), "tf32"),      # T at its bound
    ((torch.float32, 7, 4, 16), "tf32"),
    ((torch.float32, 20, 2, 64), "tf32"),
    ((torch.float32, 9, 8, 16), "tf32"),       # 8 heads
    ((torch.float32, 33, 4, 32), "fma"),       # T past 32
    ((torch.float32, 20, 4, 8), "fma"),        # d not instantiated
    ((torch.float32, 16, 16, 16), "fma"),      # more than 8 heads
    ((torch.float32, 32, 8, 64), "fma"),       # past the shared memory
    ((torch.float32, 32, 8, 32), "fma"),       # 8 heads at T 32: the forward's block 256 B over
    ((torch.bfloat16, 20, 4, 32), "mma"),      # bf16 keeps its variant
])
def test_ta_tf32_variant_is_a_pure_function_of_dtype_and_shape(kernel, args, want):
    """float32 at the mma variant's shapes (d 16/32/64, T <= 32, at most 8
    heads, heads·T <= 256, 16-byte aligned) chooses tf32 where its block
    fits the shared memory; misaligned tensors and other shapes fma."""
    choose = kernels.ta_fwd_variant if kernel == "ta_fwd" else kernels.ta_bwd_variant
    smem = getattr(kernels, f"{kernel}_tf32_smem_bytes")
    assert choose(*args) == want
    assert choose(*args) == want          # no state
    assert choose(*args, aligned=False) == "fma"
    dtype, T, heads, d = args
    if want == "tf32":
        assert smem(T, heads, d) <= kernels.MAX_SMEM_BYTES
    if dtype == torch.float32 and d in kernels.TA_MMA_HEAD_DIMS and T <= 32 and heads <= 8 \
            and want == "fma":
        assert smem(T, heads, d) > kernels.MAX_SMEM_BYTES


def test_ta_tf32_blocks_fit_at_the_unet_shape():
    """At T 20, 4 heads of 32 (rows of 128 + 4 floats): the backward's block
    takes 105216 bytes (two ring stages of q, k, v and do, a zero row, the
    f64 dpb accumulator, the bias; no P / dS tile): two blocks an SM (228 KB,
    1 KB reserved a block). The forward's takes 71296: three."""
    rs, tj = 4 * 32 + 4, 24
    assert kernels.ta_bwd_tf32_smem_bytes(20, 4, 32) == (
        2 * 4 * 20 * rs * 4 + 256 + 4 * 20 * 20 * 8 + 4 * 20 * tj * 4) == 105216
    assert kernels.ta_fwd_tf32_smem_bytes(20, 4, 32) == (
        2 * 3 * 20 * rs * 4 + 256 + 4 * 20 * tj * 4) == 71296
    assert 2 * (105216 + 1024) <= 228 * 1024 < 3 * (105216 + 1024)
    assert 3 * (71296 + 1024) <= 228 * 1024 < 4 * (71296 + 1024)


@pytest.mark.parametrize("kernel", ["ta_fwd", "ta_bwd"])
@pytest.mark.parametrize("dtype, T, heads, d, offset", [
    (torch.bfloat16, 20, 4, 32, 0),        # bf16
    (torch.float32, 20, 4, 8, 0),          # d not instantiated
    (torch.float32, 33, 4, 32, 0),         # T past 32
    (torch.float32, 16, 16, 16, 0),        # more than 8 heads
    (torch.float32, 20, 4, 32, 1),         # v (do) 4 bytes past a 16-byte boundary
])
def test_a_named_ta_tf32_variant_refuses_what_it_does_not_take(kernel, dtype, T, heads, d,
                                                               offset):
    """A named tf32 variant that cannot take the input raises before
    anything is built or launched (the tensors lie on the CPU here); the
    unnamed choice and a named fma take it."""
    n = T * heads * d
    q = torch.zeros(n, dtype=dtype)
    last = torch.zeros(n + 8, dtype=dtype)[offset:offset + n]
    pick = ((lambda v: kernels._ta_fwd_variant(q, q, last, T, heads, d, v)) if kernel == "ta_fwd"
            else (lambda v: kernels._ta_bwd_variant(q, q, q, last, T, heads, d, v)))
    with pytest.raises(ValueError, match="tf32 variant takes float32"):
        pick("tf32")
    chosen = "mma" if dtype == torch.bfloat16 else "fma"
    assert pick(None) == (chosen, list(kernels.VARIANTS[kernel]).index(chosen))
    assert pick("fma") == ("fma", 0)
