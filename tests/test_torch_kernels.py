"""CUDA kernels against their plain twins, on the card (marker ``gpu``).

These need an NVIDIA Hopper GPU and nvcc, and skip elsewhere. Run them on
the GPU host with ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels.py``. They cover small and uneven shapes (C below
16, 2*m2 well below 32, H not a multiple of K2's row block, a tail crop
that is not the whole grid) that chip_smoke.py, which runs the full
benchmark width, does not; for temporal attention, T, heads and head width
below the UNet's (T 5 and 20, h 3 and 4, d 8 and 32) and site counts that
fill no whole tile (S 300, 37); for the Galerkin scores, N that fills no
whole tile (300, 37), head widths 16, 32 and 64, odd B·h and a last group
of heads narrower than the block (h 5); for the variants of the T-stage and
K2, K1, K2A-lite, K12B, K3F, K3B, the TA forward and backward and the
Galerkin scores (the f32 tf32 variants of K1, K2, K2A-lite, K12B, K3F and
K3B and the TA forward and backward beside their bf16 mma ones), shapes
on both sides of each choice
(``kernels.t_stage_variant``, ``kernels.k2_variant`` and the others),
widths 32, 64 and 128 for the tensor-core variants of the FNO kernels, head
widths 16, 32 and 64, T from 5 to 32 and the UNet step's four site counts
for the TA kernels', and for the scores' chunks long enough to flush their
accumulators. Tolerances: in f32
|Δ| <= 1e-4·max|ref| (both sides accumulate in f32, in another order); in
bf16 1e-2·max|ref| (both sides compute in f32 from the same bf16 inputs and
round once to bf16, so they differ by at most one bf16 step, 2^-8
relative). The f32 accumulators
(weight gradients, SSE) are held to 1e-4·max|ref| in both dtypes: both
sides sum the same f32 terms. The Galerkin scores are an f32 output that
both sides compute in f32 from the same inputs: 1e-4·max|ref| in both
dtypes.
"""

import pytest
import torch

from realpdebench_tpu_torch.ops import fno_layer as tfl
from realpdebench_tpu_torch.ops import fno_tail as tft
from realpdebench_tpu_torch.ops import galerkin as tga
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops import temporal_attention as tta

pytestmark = pytest.mark.gpu

SHAPES = [  # (B, Tp, Hp, Wp, C, m1, m2, m3)
    (2, 6, 10, 12, 8, 2, 3, 4),
    (1, 9, 13, 22, 32, 3, 5, 6),
    (1, 9, 13, 22, 32, 3, 5, 8),    # bf16: K2's tensor-core variant (C 32, m3 8)
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, dtype):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


def _inputs(shape, dtype, dev):
    B, Tp, Hp, Wp, C, m1, m2, m3 = shape
    g = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    return dict(x=rn(B * Tp, Hp * Wp // 2, 2 * C).to(dtype),
                a=1 + 0.1 * rn(C), b=0.1 * rn(C), wp=0.2 * rn(C, C),
                bp=0.1 * rn(C), wr=0.1 * rn(4, m1, m2, m3, C, C),
                wi=0.1 * rn(4, m1, m2, m3, C, C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["none", "exact", "tanh"])
def test_kernels_match_twins(cuda, shape, dtype, act):
    B, Tp, Hp, Wp, C, m1, m2, m3 = shape
    d = _inputs(shape, dtype, cuda)
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    kernels.reset_launches()
    y = tfl.k1(d["x"], d["a"], d["b"], Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    _close(y, tfl.k1_plain(d["x"], d["a"], d["b"], cst, Hp=Hp, Wp=Wp, act=act),
           dtype)
    for kind, inp in (("et", y), ("it", y[: B * 2 * m1])):
        mr, mi = tfl._tmats_on(cuda, kind, Tp, m1)
        _close(tfl.t_stage(inp, kind, Tp, m1), tfl.t_stage_plain(inp, mr, mi),
               dtype)
    g = y
    s, st = tfl.k2(g, d["x"], d["a"], d["b"], d["wp"], d["bp"], Hp=Hp, Wp=Wp,
                   m2=m2, m3=m3, act=act)
    s_ref, st_ref = tfl.k2_plain(g, d["x"], d["a"], d["b"], d["wp"], d["bp"],
                                 cst, Hp=Hp, Wp=Wp, act=act)
    torch.cuda.synchronize()
    _close(s, s_ref, dtype)
    _close(st, st_ref, torch.float32)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "k1": 1, "t_stage": 2, "k2": 1}


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_layer_matches_reference_on_card(cuda, shape):
    B, Tp, Hp, Wp, C, m1, m2, m3 = shape
    d = _inputs(shape, torch.float32, cuda)
    args = (d["x"], d["a"], d["b"], d["wr"], d["wi"], d["wp"], d["bp"])
    s, st = tfl.fused_fno_layer(*args, dims=(B, Tp, Hp, Wp, C), act="exact")
    s_ref, st_ref = tfl.reference_fused_fno_layer(*args, dims=(B, Tp, Hp, Wp, C),
                                                  act="exact")
    _close(s, s_ref, torch.float32)
    _close(st, st_ref, torch.float32)


K2_SHAPES = [  # (BT, Hp, Wp, C, m2, m3)
    (3, 13, 22, 32, 5, 8),     # mma in bf16: two warps, the second with 6 columns
    (2, 17, 38, 64, 4, 16),    # mma: Wp no multiple of 16, a last block of one row
    (2, 9, 20, 128, 3, 8),     # mma at C 128
    (2, 10, 12, 8, 3, 4),      # fma in both dtypes: C and m3 below the MMA tiles
    (2, 9, 20, 64, 3, 4),      # fma: 2*m3 no multiple of 16
    (1, 7, 134, 128, 3, 16),   # C 128 and the grid's Wp: mma and tf32 at 9 warps;
                               # fma, named, 2 rows a block
]


def _want_variant(dtype, tensor_cores: bool) -> str:
    """The variant K2 and K12B choose: on the tensor cores (mma in bf16, tf32
    in f32) where the shape takes them, else fma."""
    if not tensor_cores:
        return "fma"
    return "mma" if dtype == torch.bfloat16 else "tf32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K2_SHAPES)
@pytest.mark.parametrize("act", ["none", "exact"])
def test_k2_variants_match_twin(cuda, shape, dtype, act):
    """K2 in the variant its dtype and shape choose, and where that is mma or
    tf32 the fma variant named on the same inputs, against the twin; two
    calls bit-equal; the per-variant counters."""
    BT, Hp, Wp, C, m2, m3 = shape
    g = torch.Generator(device=cuda).manual_seed(6)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x = rn(BT, Hp * Wp // 2, 2 * C).to(dtype)
    gs = rn(BT, 2 * m2 * m3, 2 * C).to(dtype)
    a, b, wp, bp = 1 + 0.1 * rn(C), 0.1 * rn(C), rn(C, C) / C ** 0.5, 0.1 * rn(C)
    kw = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    chosen = kernels.k2_variant(dtype, C, m3, Wp, 2 * m2)
    assert chosen == _want_variant(dtype, C >= 32 and m3 >= 8)
    kernels.reset_launches()
    s, st = tfl.k2(gs, x, a, b, wp, bp, **kw)
    s_ref, st_ref = tfl.k2_plain(gs, x, a, b, wp, bp, tfl._ct_on(cuda, Hp, Wp, m2, m3),
                                 Hp=Hp, Wp=Wp, act=act)
    torch.cuda.synchronize()
    _close(s, s_ref, dtype)
    _close(st, st_ref, torch.float32)
    for u, v in zip((s, st), tfl.k2(gs, x, a, b, wp, bp, **kw)):
        assert torch.equal(u, v)
    want = {"fma": 0, "mma": 0, "tf32": 0, chosen: 2}
    if chosen != "fma":
        s, st = tfl.k2(gs, x, a, b, wp, bp, **kw, variant="fma")
        _close(s, s_ref, dtype)
        _close(st, st_ref, torch.float32)
        want["fma"] = 1
    assert kernels.VARIANTS["k2"] == want and kernels.LAUNCHES["k2"] == sum(want.values())


TSTAGE_SHAPES = [  # (B, Tin, Tout, Y, C)
    (2, 26, 8, 24, 64),    # registers: outputs resident, R 8
    (2, 8, 26, 24, 64),    # registers: inputs resident, R 8
    (3, 5, 3, 7, 12),      # R 4, channels no multiple of a warp's span
    (1, 12, 20, 9, 8),     # R 16, inputs resident
    (1, 20, 12, 9, 8),     # R 16, outputs resident
    (2, 6, 6, 5, 4),       # Tin == Tout
    (1, 20, 18, 9, 8),     # generic: the shorter side above 16
    (2, 9, 4, 7, 6),       # generic: channels no multiple of 4
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TSTAGE_SHAPES)
def test_t_stage_variants_match_twin(cuda, shape, dtype):
    """The T-stage in the variant its shape chooses against the twin, for
    random (MR, MI); the generic variant named on the same input gives the
    same bits; two calls bit-equal."""
    B, Tin, Tout, Y, C = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    y = rn(B * Tin, Y, 2 * C).to(dtype)
    mr, mi = rn(Tin, Tout) / Tin, rn(Tin, Tout) / Tin
    chosen = kernels.t_stage_variant(dtype, C, Tin, Tout)
    assert chosen == ("registers" if min(Tin, Tout) <= 16 and C % 4 == 0 else "generic")
    kernels.reset_launches()
    out = kernels.t_stage(y, mr, mi)
    torch.cuda.synchronize()
    _close(out, tfl.t_stage_plain(y, mr, mi), dtype)
    assert torch.equal(out, kernels.t_stage(y, mr, mi))
    assert torch.equal(out, kernels.t_stage(y, mr, mi, variant="generic"))
    want = {"generic": 1, "registers": 0}
    want[chosen] += 2
    assert kernels.VARIANTS["t_stage"] == want and kernels.LAUNCHES["t_stage"] == 3


def test_variants_refuse_what_they_do_not_take(cuda):
    """A named variant that does not take the input raises; nothing falls
    back to the other variant, and nothing is counted."""
    y = torch.zeros(9, 7, 12, device=cuda)
    m = torch.zeros(9, 4, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="registers variant"):
        kernels.t_stage(y, m, m, variant="registers")          # C 6
    with pytest.raises(ValueError, match="no variant"):
        kernels.t_stage(y, m, m, variant="fast")
    BT, Hp, Wp, C, m2, m3 = K2_SHAPES[0]
    x = torch.zeros(BT, Hp * Wp // 2, 2 * C, device=cuda)
    gs = torch.zeros(BT, 2 * m2 * m3, 2 * C, device=cuda)
    v = torch.zeros(C, device=cuda)
    wp = torch.zeros(C, C, device=cuda)
    kw = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3, act="none")
    with pytest.raises(ValueError, match="mma variant takes bfloat16"):
        tfl.k2(gs, x, v, v, wp, v, **kw, variant="mma")          # float32
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    with pytest.raises(ValueError, match="packed tables"):
        kernels.k2(gs.bfloat16(), x.bfloat16(), v, v, wp, v, cst["ihr"], cst["ihi"],
                   cst["iwr"], cst["iwi"], Hp=Hp, Wp=Wp, act="none")
    with pytest.raises(ValueError, match="no variant"):
        tfl.k2(gs, x, v, v, wp, v, **kw, variant="wgmma")
    with pytest.raises(ValueError, match="tf32 variant takes float32"):
        tfl.k2(gs.bfloat16(), x.bfloat16(), v, v, wp, v, **kw, variant="tf32")   # bfloat16
    with pytest.raises(ValueError, match="packed tables"):
        kernels.k2(gs, x, v, v, wp, v, cst["ihr"], cst["ihi"], cst["iwr"], cst["iwi"], Hp=Hp,
                   Wp=Wp, act="none")
    assert not any(kernels.LAUNCHES.values())
    assert not any(n for c in kernels.VARIANTS.values() for n in c.values())


def test_kernels_refuse_bad_input(cuda):
    x = torch.zeros(12, 60, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfl.k1(x, torch.ones(8, device=cuda), torch.zeros(8, device=cuda),
               Hp=10, Wp=12, m2=3, m3=4, act="none")
    x = torch.zeros(12, 60, 16, device=cuda)
    with pytest.raises(ValueError, match="2\\*m2 <= 32"):
        tfl.k1(x, torch.ones(8, device=cuda), torch.zeros(8, device=cuda),
               Hp=10, Wp=12, m2=17, m3=4, act="none")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["none", "exact", "tanh"])
def test_backward_kernels_match_twins(cuda, shape, dtype, act):
    B, Tp, Hp, Wp, C, m1, m2, m3 = shape
    d = _inputs(shape, dtype, cuda)
    geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    g = torch.Generator(device=cuda).manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    y = tfl.k1(d["x"], d["a"], d["b"], **geo, act=act)
    gs = rn(*y.shape).to(dtype)
    s, _ = tfl.k2(gs, d["x"], d["a"], d["b"], d["wp"], d["bp"], **geo, act=act)
    ds, dy = rn(*s.shape).to(dtype), rn(*y.shape).to(dtype)
    ds1, ds2 = rn(C), 0.1 * rn(C)
    kernels.reset_launches()
    for kind in ("et_adj", "it_adj"):
        mr, mi = tfl._tmats_on(cuda, kind, Tp, m1)
        inp = gs[: B * mr.shape[0]].contiguous()
        _close(tfl.t_stage(inp, kind, Tp, m1), tfl.t_stage_plain(inp, mr, mi), dtype)
    full = tfl.k2a(s, ds, ds1, ds2, **geo)
    _close(full, tfl.k2a_plain(s, ds, ds1, ds2, cst, Hp=Hp, Wp=Wp), dtype)
    lite = tfl.k2a_lite(ds, gs, y, ds1, ds2, d["wp"], d["bp"], **geo)
    lite_ref = tfl.k2a_lite_plain(ds, gs, y, ds1, ds2, d["wp"], d["bp"],
                                  tfl._lite_on(cuda, Hp, Wp, m2, m3), cst, Hp=Hp, Wp=Wp)
    _close(lite, lite_ref, dtype)
    _close(lite, full, dtype)
    got = tfl.k12b(d["x"], d["a"], d["b"], d["wp"], s, ds, ds1, ds2, dy, **geo, act=act)
    ref = tfl.k12b_plain(d["x"], d["a"], d["b"], d["wp"], s, ds, ds1, ds2, dy, cst,
                         Hp=Hp, Wp=Wp, act=act)
    _close(got[0], ref[0], dtype)
    for u, v in zip(got[1:], ref[1:]):
        _close(u, v, torch.float32)
    T, H, W, F = Tp - 2, Hp - 3, Wp - 4, 6
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact" if act == "none" else act)
    tail = (rn(B, T, H, W, F), 0.3 * rn(C, 128), 0.1 * rn(128), 0.1 * rn(128, F), 0.1 * rn(F))
    _close(tft.k3f(s, *tail, **kw), tft.k3f_plain(s, *tail, **kw), torch.float32)
    gl = torch.tensor(0.37, device=cuda)
    got, ref = tft.k3b(s, *tail, gl, **kw), tft.k3b_plain(s, *tail, gl, **kw)
    torch.cuda.synchronize()
    _close(got[0], ref[0], dtype)
    for u, v in zip(got[1:], ref[1:]):
        _close(u, v, torch.float32)
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "t_stage": 2, "k2a": 1, "k2a_lite": 1, "k12b": 1, "k3f": 1, "k3b": 1}


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_layer_backward_matches_reference_on_card(cuda, shape):
    """Autograd through the kernels (K2A-lite, T-stage adjoints, K12B)
    against autograd through the plain f32 oracle, and twice in a row
    bit for bit (no atomics in any reduction)."""
    B, Tp, Hp, Wp, C, m1, m2, m3 = shape
    d = _inputs(shape, torch.float32, cuda)
    keys = ("x", "a", "b", "wr", "wi", "wp", "bp")
    npos = B * Tp * Hp * Wp

    def grads(layer):
        args = [d[k].clone().requires_grad_() for k in keys]
        s, st = layer(*args, dims=(B, Tp, Hp, Wp, C), act="exact")
        var = st[1] / npos - (st[0] / npos) ** 2
        return torch.autograd.grad((s * s).sum() * 1e-3 + var.sum(), args)

    got = grads(tfl.fused_fno_layer)
    for u, v in zip(got, grads(tfl.reference_fused_fno_layer)):
        _close(u, v, torch.float32)
    for u, v in zip(got, grads(tfl.fused_fno_layer)):
        assert torch.equal(u, v)


TA_SHAPES = [  # (B, S, T, h, d)
    (2, 300, 5, 3, 8),
    (1, 37, 20, 4, 32),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TA_SHAPES)
def test_temporal_attention_kernels_match_twin(cuda, shape, dtype):
    """ta_fwd and ta_bwd against the twin and autograd through it (in f32
    from the same inputs); dpb is an f32 accumulator in both dtypes; the
    backward repeats bit for bit."""
    B, S, T, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    q, k, v, do = (rn(B, S, T, h * d).to(dtype) for _ in range(4))
    pb = 0.3 * rn(h, T, T)
    kernels.reset_launches()
    _close(kernels.ta_fwd(q, k, v, pb, h),
           tta.temporal_attention_tokens_plain(q, k, v, pb, h), dtype)
    got = kernels.ta_bwd(q, k, v, pb, do, h)
    leaves = [t.float().requires_grad_() for t in (q, k, v, pb)]
    ref = torch.autograd.grad(tta.temporal_attention_tokens_plain(*leaves, h),
                              leaves, do.float())
    torch.cuda.synchronize()
    for u, r in zip(got[:3], ref[:3]):
        _close(u, r.to(dtype), dtype)
    _close(got[3], ref[3], torch.float32)
    for u, w in zip(got, kernels.ta_bwd(q, k, v, pb, do, h)):
        assert torch.equal(u, w)
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"ta_fwd": 1, "ta_bwd": 2}


def test_temporal_attention_autograd_runs_the_kernels(cuda):
    B, S, T, h, d = TA_SHAPES[0]
    g = torch.Generator(device=cuda).manual_seed(3)
    leaves = [torch.randn(B, S, T, h * d, generator=g, device=cuda).requires_grad_()
              for _ in range(3)]
    pb = (0.3 * torch.randn(h, T, T, generator=g, device=cuda)).requires_grad_()
    kernels.reset_launches()
    out = tta.temporal_attention_tokens(*leaves, pb, h)
    got = torch.autograd.grad((out * out).sum(), [*leaves, pb])
    assert kernels.LAUNCHES["ta_fwd"] == 1 and kernels.LAUNCHES["ta_bwd"] == 1
    out = tta.temporal_attention_tokens_plain(*leaves, pb, h)
    for u, r in zip(got, torch.autograd.grad((out * out).sum(), [*leaves, pb])):
        _close(u, r, torch.float32)


def test_temporal_attention_kernels_refuse_bad_input(cuda):
    q = torch.zeros(1, 8, 5, 3 * 12, device=cuda)
    pb = torch.zeros(3, 5, 5, device=cuda)
    with pytest.raises(ValueError, match="head width"):
        kernels.ta_fwd(q, q, q, pb, 3)
    q = torch.zeros(1, 8, 5, 24, device=cuda)
    with pytest.raises(ValueError, match="pos_bias"):
        kernels.ta_fwd(q, q, q, pb[:2], 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.ta_fwd(q.half(), q.half(), q.half(), pb, 3)


GK_SHAPES = [  # (B, N, h, d)
    (3, 300, 1, 16),
    (1, 37, 3, 64),
    (2, 300, 5, 32),
    (1, 37, 4, 16),
]


def _gk_inputs(shape, dtype, dev, seed=4):
    B, N, h, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    k = 1 + 2 * rn(B, N, h * d)
    v = 0.5 * k + rn(B, N, h * d)          # correlated: scores well above noise
    aff = [1 + 0.1 * rn(h, d), 0.1 * rn(h, d), 1 + 0.1 * rn(h, d), 0.1 * rn(h, d)]
    return k.to(dtype), v.to(dtype), aff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GK_SHAPES)
def test_galerkin_scores_kernel_matches_twin(cuda, shape, dtype):
    """gk_scores against the twin, both in f32 from the same inputs; two
    calls bit-equal."""
    h = shape[2]
    k, v, aff = _gk_inputs(shape, dtype, cuda)
    kernels.reset_launches()
    got = kernels.gk_scores(k, v, *aff, heads=h, eps=1e-7)
    ref = tga.galerkin_scores_plain(k, v, *aff, h, 1e-7)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    _close(got, ref, torch.float32)
    assert torch.equal(got, kernels.gk_scores(k, v, *aff, heads=h, eps=1e-7))
    assert {n: c for n, c in kernels.LAUNCHES.items() if c} == {"gk_scores": 2}


def test_galerkin_scores_autograd_runs_the_kernel(cuda):
    shape = GK_SHAPES[2]
    h = shape[2]
    k, v, aff = _gk_inputs(shape, torch.float32, cuda, seed=5)
    leaves = [t.clone().requires_grad_() for t in (k, v, *aff)]
    ct = torch.randn(shape[0], h, shape[3], shape[3], device=cuda)
    kernels.reset_launches()
    out = tga.galerkin_scores(*leaves, h, 1e-7)
    got = torch.autograd.grad((out * ct).sum(), leaves)
    assert kernels.LAUNCHES["gk_scores"] == 1
    ref = torch.autograd.grad((tga.galerkin_scores_plain(*leaves, h, 1e-7) * ct).sum(),
                              leaves)
    for u, r in zip(got, ref):
        _close(u, r, torch.float32)


def test_galerkin_scores_kernel_refuses_bad_input(cuda):
    k = torch.zeros(1, 8, 3 * 8, device=cuda)
    aff = [torch.ones(3, 8, device=cuda)] * 4
    with pytest.raises(ValueError, match="head width"):
        kernels.gk_scores(k, k, *aff, heads=3, eps=1e-5)
    k = torch.zeros(1, 8, 32, device=cuda)
    aff = [torch.ones(2, 16, device=cuda)] * 4
    with pytest.raises(ValueError, match="v_bias"):
        kernels.gk_scores(k, k, *aff[:3], aff[3][:1], heads=2, eps=1e-5)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernels.gk_scores(k.half(), k.half(), *aff, heads=2, eps=1e-5)


K1_SHAPES = [  # (BT, Hp, Wp, C, m2, m3)
    (3, 13, 22, 32, 5, 8),     # mma in bf16, tf32 in f32: two chunks of rows, the second short
    (2, 17, 38, 64, 4, 16),    # mma, tf32 at m3 16: Wp no multiple of 16, two ring pieces
    (2, 33, 20, 128, 16, 16),  # mma, tf32 at C 128 and 2*m2 32 (fsi's widths)
    (2, 9, 70, 16, 3, 16),     # one 16-channel slice; three ring pieces, the last of 6 rows
    (2, 10, 12, 8, 3, 4),      # fma in both dtypes: C below a 16-channel slice
    (2, 9, 20, 64, 3, 12),     # fma: m3 not instantiated
]


def _sums_close(got, ref, terms, tol=1e-4):
    err = ((got.float() - ref.float()).abs() / terms.clamp_min(1e-30)).max().item()
    assert err <= tol, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("act", ["none", "exact"])
def test_k1_variants_match_twin(cuda, shape, dtype, act):
    """K1 in the variant its dtype and shape choose, and where that is mma or
    tf32 the fma variant named on the same inputs, against the twin; two
    calls bit-equal; the per-variant counters."""
    BT, Hp, Wp, C, m2, m3 = shape
    g = torch.Generator(device=cuda).manual_seed(8)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x = rn(BT, Hp * Wp // 2, 2 * C).to(dtype)
    a, b = 1 + 0.1 * rn(C), 0.1 * rn(C)
    kw = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    chosen = kernels.k1_variant(dtype, C, 2 * m2, m3, Wp)
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    assert chosen == (tc if C % 16 == 0 and m3 in (8, 16) else "fma")
    kernels.reset_launches()
    y = tfl.k1(x, a, b, **kw)
    ref = tfl.k1_plain(x, a, b, tfl._ct_on(cuda, Hp, Wp, m2, m3), Hp=Hp, Wp=Wp, act=act)
    torch.cuda.synchronize()
    _close(y, ref, dtype)
    assert torch.equal(y, tfl.k1(x, a, b, **kw))
    want = {"fma": 0, "mma": 0, "tf32": 0, chosen: 2}
    if chosen == tc:
        _close(tfl.k1(x, a, b, **kw, variant="fma"), ref, dtype)
        want["fma"] = 1
    assert kernels.VARIANTS["k1"] == want and kernels.LAUNCHES["k1"] == sum(want.values())


K12B_SHAPES = [  # (BT, Hp, Wp, C, m2, m3)
    (3, 13, 22, 32, 5, 8),     # mma in bf16: two warps, the second with 6 columns
    (2, 17, 38, 64, 4, 16),    # mma: a last block of two rows
    (2, 33, 20, 128, 16, 16),  # mma at C 128 and 2*m2 32; fma at C 128 in f32
    (2, 10, 12, 8, 3, 4),      # fma in both dtypes: C and m3 below the MMA tiles
    (2, 9, 20, 64, 3, 4),      # fma: 2*m3 no multiple of 16
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K12B_SHAPES)
@pytest.mark.parametrize("act", ["none", "exact"])
def test_k12b_variants_match_twin(cuda, shape, dtype, act):
    """K12B in the variant its dtype and shape choose (and where that is mma
    or tf32 the fma variant named) against the twin: dx to TOL, dWp, da, db
    and dbp to 1e-4 of the sum of |terms|; two calls bit-equal; the
    per-variant counters."""
    BT, Hp, Wp, C, m2, m3 = shape
    g = torch.Generator(device=cuda).manual_seed(9)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    npos = BT * Hp * Wp
    x, s = (rn(BT, Hp * Wp // 2, 2 * C).to(dtype) for _ in range(2))
    ds = (rn(BT, Hp * Wp // 2, 2 * C) / npos).to(dtype)
    dy = (rn(BT, 2 * m2 * m3, 2 * C) / npos).to(dtype)
    a, b, wp = 1 + 0.1 * rn(C), 0.1 * rn(C), rn(C, C) / C ** 0.5
    ds1, ds2 = rn(C) / npos, rn(C) / npos
    kw = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3, act=act)
    chosen = kernels.k12b_variant(dtype, C, 2 * m2, m3, Wp)
    assert chosen == _want_variant(dtype, C >= 32 and m3 >= 8)
    kernels.reset_launches()
    got = tfl.k12b(x, a, b, wp, s, ds, ds1, ds2, dy, **kw)
    ref = tfl.k12b_plain(x, a, b, wp, s, ds, ds1, ds2, dy, tfl._ct_on(cuda, Hp, Wp, m2, m3),
                         Hp=Hp, Wp=Wp, act=act)
    torch.cuda.synchronize()
    v = lambda q: q.float().view(BT, Hp, Wp, C)
    z = tfl._act(v(x) * a + b, act)
    dse = v(ds) + ds1 + 2.0 * ds2 * v(s)
    du = v(ref[0]) / a
    terms = (torch.einsum("bhwc,bhwd->cd", z.abs(), dse.abs()),
             (du * v(x)).abs().sum((0, 1, 2)), du.abs().sum((0, 1, 2)),
             dse.abs().sum((0, 1, 2)))
    runs = [got]
    if chosen != "fma":
        runs.append(tfl.k12b(x, a, b, wp, s, ds, ds1, ds2, dy, **kw, variant="fma"))
    for run in runs:
        _close(run[0], ref[0], dtype)
        for u, w, t in zip(run[1:], ref[1:], terms):
            _sums_close(u, w, t)
    assert all(torch.equal(u, w) for u, w in zip(got, tfl.k12b(x, a, b, wp, s, ds, ds1, ds2,
                                                                dy, **kw)))
    want = {"fma": 0, "mma": 0, "tf32": 0, chosen: 2}
    want["fma"] += len(runs) - 1
    assert kernels.VARIANTS["k12b"] == want and kernels.LAUNCHES["k12b"] == sum(want.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_kernels_at_width_128(cuda, dtype):
    """K3F and K3B at the fsi config's width (C 128), an uneven crop."""
    B, Tp, Hp, Wp, C, F = 2, 7, 15, 22, 128, 6
    T, H, W = 5, 13, 18
    g = torch.Generator(device=cuda).manual_seed(10)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    s = rn(B * Tp, Hp * Wp // 2, 2 * C).to(dtype)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    tail = (rn(B, T, H, W, F), 0.1 * rn(C, 128), 0.1 * rn(128), 0.1 * rn(128, F), 0.1 * rn(F))
    gl = torch.tensor(0.37, device=cuda)
    _close(tft.k3f(s, *tail, **kw), tft.k3f_plain(s, *tail, **kw), torch.float32)
    got, ref = tft.k3b(s, *tail, gl, **kw), tft.k3b_plain(s, *tail, gl, **kw)
    torch.cuda.synchronize()
    _close(got[0], ref[0], dtype)
    for u, w in zip(got[1:], ref[1:]):
        _close(u, w, torch.float32)


def test_default_calls_on_a_misaligned_view_take_the_unaligned_variants(cuda):
    """A contiguous bf16 view 2 bytes past a 16-byte boundary: by default K1,
    K2, K2A-lite, K12B, K3F and K3B run fma and the T-stage generic, each
    against its twin; the tensor-core or registers variant named on it
    raises, and nothing is counted for the refusals."""
    BT, Hp, Wp, C, m1, m2, m3, Tp = 2, 17, 38, 64, 2, 4, 16, 1
    n = BT * Hp * Wp * C
    g = torch.Generator(device=cuda).manual_seed(11)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    view = lambda t: torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)
    x = view(rn(BT, Hp * Wp // 2, 2 * C).bfloat16())
    assert x.is_contiguous() and x.data_ptr() % 16
    a, b, wp, bp = 1 + 0.1 * rn(C), 0.1 * rn(C), rn(C, C) / C ** 0.5, 0.1 * rn(C)
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    kernels.reset_launches()
    y = tfl.k1(x, a, b, **geo, act="exact")
    _close(y, tfl.k1_plain(x, a, b, cst, Hp=Hp, Wp=Wp, act="exact"), torch.bfloat16)
    gy = view(y)
    s, st = tfl.k2(gy, x, a, b, wp, bp, **geo, act="exact")
    _close(s, tfl.k2_plain(gy, x, a, b, wp, bp, cst, Hp=Hp, Wp=Wp, act="exact")[0],
           torch.bfloat16)
    mr, mi = rn(26, 8) / 26, rn(26, 8) / 26
    yt = view(rn(2 * 26, 5, 2 * C).bfloat16())
    _close(kernels.t_stage(yt, mr, mi), tfl.t_stage_plain(yt, mr, mi), torch.bfloat16)
    ds = view((rn(BT, Hp * Wp // 2, 2 * C) / n).bfloat16())
    dv = (rn(C) / n, rn(C) / n)
    got = tfl.k12b(x, a, b, wp, s, ds, *dv, gy, **geo, act="exact")
    ref = tfl.k12b_plain(x, a, b, wp, s, ds, *dv, gy, cst, Hp=Hp, Wp=Wp, act="exact")
    _close(got[0], ref[0], torch.bfloat16)
    lite = tfl.k2a_lite(ds, gy, y, *dv, wp, bp, **geo)
    _close(lite, tfl.k2a_lite_plain(ds, gy, y, *dv, wp, bp, tfl._lite_on(cuda, *geo.values()),
                                    cst, Hp=Hp, Wp=Wp), torch.bfloat16)
    T, H, W, F = Tp, Hp - 2, Wp - 4, 3
    kw = dict(dims=(BT, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    tail = (rn(BT, T, H, W, F), rn(C, 128) / 8, 0.1 * rn(128), rn(128, F) / 11, 0.1 * rn(F))
    gl = torch.tensor(0.37, device=cuda)
    _close(tft.k3b(ds, *tail, gl, **kw)[0], tft.k3b_plain(ds, *tail, gl, **kw)[0],
           torch.bfloat16)
    _close(tft.k3f(ds, *tail, **kw), tft.k3f_plain(ds, *tail, **kw), torch.float32)
    assert {k: dict(v) for k, v in kernels.VARIANTS.items()} == {
        "k1": {"fma": 1, "mma": 0, "tf32": 0}, "t_stage": {"generic": 1, "registers": 0},
        "k2": {"fma": 1, "mma": 0, "tf32": 0}, "k2a_lite": {"fma": 1, "mma": 0, "tf32": 0},
        "k12b": {"fma": 1, "mma": 0, "tf32": 0}, "k3f": {"fma": 1, "mma": 0, "tf32": 0},
        "k3b": {"fma": 1, "mma": 0, "tf32": 0}, "ta_fwd": {"fma": 0, "mma": 0, "tf32": 0},
        "ta_bwd": {"fma": 0, "mma": 0, "tf32": 0}, "gk_scores": {"fma": 0, "mma": 0}}
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k1(x, a, b, **geo, act="exact", variant="mma")
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k2(gy, x, a, b, wp, bp, **geo, act="exact", variant="mma")
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k12b(x, a, b, wp, s, ds, *dv, gy, **geo, act="exact", variant="mma")
    with pytest.raises(ValueError, match="registers variant"):
        kernels.t_stage(yt, mr, mi, variant="registers")
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k2a_lite(ds, gy, y, *dv, wp, bp, **geo, variant="mma")
    with pytest.raises(ValueError, match="mma variant"):
        tft.k3b(ds, *tail, gl, **kw, variant="mma")
    with pytest.raises(ValueError, match="mma variant"):
        tft.k3f(ds, *tail, **kw, variant="mma")
    assert sum(kernels.LAUNCHES.values()) == 7


def test_k1_and_k12b_variants_refuse_what_they_do_not_take(cuda):
    BT, Hp, Wp, C, m2, m3 = K1_SHAPES[4]
    x = torch.zeros(BT, Hp * Wp // 2, 2 * C, device=cuda, dtype=torch.bfloat16)
    v = torch.zeros(C, device=cuda)
    geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k1(x, v, v, **geo, act="none", variant="mma")              # m3 12
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k1(x.float(), v, v, **geo, act="none", variant="mma")      # float32
    with pytest.raises(ValueError, match="no variant"):
        tfl.k1(x, v, v, **geo, act="none", variant="wgmma")
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    dy = torch.zeros(BT, 2 * m2 * m3, 2 * C, device=cuda, dtype=torch.bfloat16)
    wp = torch.zeros(C, C, device=cuda)
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k12b(x, v, v, wp, x, x, v, v, dy, **geo, act="none", variant="mma")
    BT, Hp, Wp, C, m2, m3 = K12B_SHAPES[1]
    x = torch.zeros(BT, Hp * Wp // 2, 2 * C, device=cuda, dtype=torch.bfloat16)
    v, wp = torch.zeros(C, device=cuda), torch.zeros(C, C, device=cuda)
    dy = torch.zeros(BT, 2 * m2 * m3, 2 * C, device=cuda, dtype=torch.bfloat16)
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    with pytest.raises(ValueError, match="packed tables"):
        kernels.k12b(x, v, v, wp, x, x, v, v, dy, cst["ehr"], cst["ehi"], cst["ewr"],
                     cst["ewi"], Hp=Hp, Wp=Wp, act="none", variant="mma")
    with pytest.raises(ValueError, match="packed tables"):
        kernels.k1(x, v, v, cst["ewr"], cst["ewi"], cst["ehr"], cst["ehi"], Hp=Hp, Wp=Wp,
                   act="none")
    assert not any(kernels.LAUNCHES.values())


K2A_LITE_SHAPES = [  # (BT, Hp, Wp, C, m2, m3)
    (3, 13, 22, 32, 5, 8),     # mma in bf16, tf32 in f32: two chunks of rows, the second short
    (2, 17, 38, 64, 4, 16),    # mma, tf32 at m3 16: Wp no multiple of 16
    (2, 33, 38, 128, 16, 16),  # mma, tf32 at C 128 and 2*m2 32 (fsi's widths)
    (2, 10, 12, 8, 3, 4),      # fma in both dtypes: C below a 16-channel slice
    (2, 9, 26, 64, 3, 12),     # fma: m3 not instantiated
]   # each geometry passes the lite fit (fno_layer._lite_consts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K2A_LITE_SHAPES)
def test_k2a_lite_variants_match_twin(cuda, shape, dtype):
    """K2A-lite in the variant its dtype and shape choose, and where that is
    mma or tf32 the fma variant named on the same inputs, against the twin
    and against K2A on s = K2(g, x) (the identity the lite statics rest on);
    two calls bit-equal; the per-variant counters."""
    BT, Hp, Wp, C, m2, m3 = shape
    g = torch.Generator(device=cuda).manual_seed(12)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    x = rn(BT, Hp * Wp // 2, 2 * C).to(dtype)
    a, b, wp, bp = 1 + 0.1 * rn(C), 0.1 * rn(C), rn(C, C) / C ** 0.5, 0.1 * rn(C)
    y = tfl.k1(x, a, b, **geo, act="exact")
    gs = rn(*y.shape).to(dtype)
    s, _ = tfl.k2(gs, x, a, b, wp, bp, **geo, act="exact")
    ds = rn(*s.shape).to(dtype)
    ds1, ds2 = rn(C), 0.1 * rn(C)
    chosen = kernels.k2a_lite_variant(dtype, C, 2 * m2, m3, Wp)
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    assert chosen == (tc if C % 16 == 0 and m3 in (8, 16) else "fma")
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    kernels.reset_launches()
    got = tfl.k2a_lite(ds, gs, y, ds1, ds2, wp, bp, **geo)
    ref = tfl.k2a_lite_plain(ds, gs, y, ds1, ds2, wp, bp, tfl._lite_on(cuda, Hp, Wp, m2, m3),
                             cst, Hp=Hp, Wp=Wp)
    torch.cuda.synchronize()
    _close(got, ref, dtype)
    _close(got, tfl.k2a_plain(s, ds, ds1, ds2, cst, Hp=Hp, Wp=Wp), dtype)
    assert torch.equal(got, tfl.k2a_lite(ds, gs, y, ds1, ds2, wp, bp, **geo))
    want = {"fma": 0, "mma": 0, "tf32": 0, chosen: 2}
    if chosen == tc:
        _close(tfl.k2a_lite(ds, gs, y, ds1, ds2, wp, bp, **geo, variant="fma"), ref, dtype)
        want["fma"] = 1
    assert kernels.VARIANTS["k2a_lite"] == want
    assert kernels.LAUNCHES["k2a_lite"] == sum(want.values())


K3B_SHAPES = [  # (B, Tp, Hp, Wp, C, T, H, W, F)
    (2, 7, 15, 22, 128, 5, 13, 18, 6),    # fsi's width, an uneven crop
    (1, 6, 13, 16, 32, 4, 10, 12, 6),
    (1, 3, 9, 140, 64, 2, 7, 136, 3),     # two tiles a row, the second of 8 positions
    (2, 6, 10, 12, 16, 4, 7, 8, 6),       # fma in both dtypes: C 16 not instantiated
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3B_SHAPES)
def test_k3b_variants_match_twin(cuda, shape, dtype):
    """K3B in the variant its dtype and width choose (mma in bf16, tf32 in
    f32 at C 32, 64, 128) and, beside a tensor-core one, the fma variant
    named on the same inputs, against the twin: ds to TOL and zero outside
    the crop, dk1, db1, dk2 and db2 to 1e-4 of the sum of |terms|; two calls
    bit-equal; the per-variant counters."""
    B, Tp, Hp, Wp, C, T, H, W, F = shape
    g = torch.Generator(device=cuda).manual_seed(13)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    s = rn(B * Tp, Hp * Wp // 2, 2 * C).to(dtype)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    tail = (rn(B, T, H, W, F), rn(C, 128) / C ** 0.5, 0.1 * rn(128), rn(128, F) / 128 ** 0.5,
            0.1 * rn(F))
    gl = torch.tensor(1.0 / (B * T * H * W * F), device=cuda)
    chosen = kernels.k3b_variant(dtype, C, F)
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    assert chosen == (tc if C in (32, 64, 128) else "fma")
    kernels.reset_launches()
    got = tft.k3b(s, *tail, gl, **kw)
    ref = tft.k3b_plain(s, *tail, gl, **kw)
    torch.cuda.synchronize()
    z = s.float().view(B, Tp, Hp, Wp, C)[:, :T, :H, :W].reshape(-1, C)
    u1 = z @ tail[1] + tail[2]
    h1 = tfl._act(u1, "exact")
    do = 2 * gl * (h1 @ tail[3] + tail[4] - tail[0].reshape(-1, F))
    du = (do @ tail[3].t()) * tfl._act_grad(u1, "exact")
    terms = (z.abs().t() @ du.abs(), du.abs().sum(0), h1.abs().t() @ do.abs(), do.abs().sum(0))
    runs = [got]
    if chosen != "fma":
        runs.append(tft.k3b(s, *tail, gl, **kw, variant="fma"))
    for run in runs:
        _close(run[0], ref[0], dtype)
        ds = run[0].view(B, Tp, Hp, Wp, C)
        assert not ds[:, T:].any() and not ds[:, :, H:].any() and not ds[:, :, :, W:].any()
        for u, w, t in zip(run[1:], ref[1:], terms):
            _sums_close(u, w, t)
    assert all(torch.equal(u, w) for u, w in zip(got, tft.k3b(s, *tail, gl, **kw)))
    want = {"fma": 0, "mma": 0, "tf32": 0, chosen: 2}
    want["fma"] += len(runs) - 1
    assert kernels.VARIANTS["k3b"] == want and kernels.LAUNCHES["k3b"] == sum(want.values())


def test_k2a_lite_and_k3b_variants_refuse_what_they_do_not_take(cuda):
    """A named mma variant on f32 or at a width it is not built for raises;
    the mma variant of K2A-lite without its tables raises; nothing is
    counted."""
    BT, Hp, Wp, C, m2, m3 = K2A_LITE_SHAPES[4]
    geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3)
    ds = torch.zeros(BT, Hp * Wp // 2, 2 * C, device=cuda, dtype=torch.bfloat16)
    gy = torch.zeros(BT, 2 * m2 * m3, 2 * C, device=cuda, dtype=torch.bfloat16)
    v, wp = torch.zeros(C, device=cuda), torch.zeros(C, C, device=cuda)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k2a_lite(ds, gy, gy, v, v, wp, v, **geo, variant="mma")           # m3 12
    with pytest.raises(ValueError, match="mma variant"):
        tfl.k2a_lite(ds.float(), gy.float(), gy.float(), v, v, wp, v, **geo, variant="mma")
    with pytest.raises(ValueError, match="no variant"):
        tfl.k2a_lite(ds, gy, gy, v, v, wp, v, **geo, variant="wgmma")
    BT, Hp, Wp, C, m2, m3 = K2A_LITE_SHAPES[1]
    ds = torch.zeros(BT, Hp * Wp // 2, 2 * C, device=cuda, dtype=torch.bfloat16)
    gy = torch.zeros(BT, 2 * m2 * m3, 2 * C, device=cuda, dtype=torch.bfloat16)
    v, wp = torch.zeros(C, device=cuda), torch.zeros(C, C, device=cuda)
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    lite = tfl._lite_on(cuda, Hp, Wp, m2, m3)
    with pytest.raises(ValueError, match="packed tables"):
        kernels.k2a_lite(ds, gy, gy, v, v, wp, v, lite["alpha"], lite["beta"], lite["D"],
                         lite["A1"], cst["ihr"], cst["ihi"], cst["iwr"], cst["iwi"], Hp=Hp,
                         Wp=Wp, variant="mma")
    B, Tp, Hp, Wp, C, T, H, W, F = K3B_SHAPES[3]
    s = torch.zeros(B * Tp, Hp * Wp // 2, 2 * C, device=cuda, dtype=torch.bfloat16)
    tail = (torch.zeros(B, T, H, W, F, device=cuda), torch.zeros(C, 128, device=cuda),
            torch.zeros(128, device=cuda), torch.zeros(128, F, device=cuda),
            torch.zeros(F, device=cuda))
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    gl = torch.tensor(1.0, device=cuda)
    with pytest.raises(ValueError, match="mma variant"):
        tft.k3b(s, *tail, gl, **kw, variant="mma")                           # C 16
    with pytest.raises(ValueError, match="no variant"):
        tft.k3b(s, *tail, gl, **kw, variant="wgmma")
    assert not any(kernels.LAUNCHES.values())


def test_tail_tf32_variants_refuse_what_they_do_not_take(cuda):
    """A named tf32 variant of K3F or K3B on bfloat16, at a width it is not
    built for or on a misaligned f32 view raises before anything is
    launched; nothing is counted."""
    kernels.reset_launches()
    for dtype, C, F, offset in ((torch.bfloat16, 64, 3, 0), (torch.float32, 16, 3, 0),
                                (torch.float32, 96, 3, 0), (torch.float32, 64, 3, 1)):
        B, Tp, Hp, Wp, T, H, W = 1, 3, 9, 12, 2, 7, 10
        n = B * Tp * Hp * Wp * C
        s = torch.zeros(n + 8, device=cuda, dtype=dtype)[offset:offset + n].view(
            B * Tp, Hp * Wp // 2, 2 * C)
        tail = (torch.zeros(B, T, H, W, F, device=cuda), torch.zeros(C, 128, device=cuda),
                torch.zeros(128, device=cuda), torch.zeros(128, F, device=cuda),
                torch.zeros(F, device=cuda))
        kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
        with pytest.raises(ValueError, match="tf32 variant takes float32"):
            tft.k3f(s, *tail, **kw, variant="tf32")
        with pytest.raises(ValueError, match="tf32 variant takes float32"):
            tft.k3b(s, *tail, torch.tensor(1.0, device=cuda), **kw, variant="tf32")
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("where, value", [("s", "nan"), ("s", "inf"), ("k1", "nan"),
                                          ("k1", "-inf")])
@pytest.mark.parametrize("C", [64, 128])
def test_tail_tf32_variants_keep_non_finite_inputs(cuda, C, where, value):
    """A NaN or an Inf in s (inside the crop) or in k1: K3F's SSE and K3B's
    ds, dk1, db1, dk2 and db2 from the tf32 variants are non-finite wherever
    the twin's or the fma variant's are (the tf32 split keeps Inf and NaN
    non-finite in lo, csrc/mma.cuh::split_tf32), and the fault shows in each."""
    B, Tp, Hp, Wp, T, H, W, F = 1, 3, 9, 20, 2, 7, 16, 3
    g = torch.Generator(device=cuda).manual_seed(15)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    s = rn(B * Tp, Hp * Wp // 2, 2 * C)
    tail = [rn(B, T, H, W, F), rn(C, 128) / C ** 0.5, 0.1 * rn(128), rn(128, F) / 128 ** 0.5,
            0.1 * rn(F)]
    if where == "s":
        s.view(B, Tp, Hp, Wp, C)[0, 1, 2, 3, 5] = float(value)
    else:
        tail[1][5, 7] = float(value)
    gl = torch.tensor(1.0 / (B * T * H * W * F), device=cuda)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    assert kernels.k3b_variant(torch.float32, C, F) == "tf32"
    out = lambda v: (tft.k3f(s, *tail, **kw, variant=v), *tft.k3b(s, *tail, gl, **kw, variant=v))
    got, fma = out("tf32"), out("fma")
    ref = (tft.k3f_plain(s, *tail, **kw), *tft.k3b_plain(s, *tail, gl, **kw))
    for name, gv, fv, rv in zip(("sse", "ds", "dk1", "db1", "dk2", "db2"), got, fma, ref):
        bad = ~torch.isfinite(rv) | ~torch.isfinite(fv)
        assert bad.any() and not torch.isfinite(gv[bad]).any(), name


K3F_SHAPES = [  # (B, Tp, Hp, Wp, C, T, H, W, F)
    (2, 7, 15, 22, 128, 5, 13, 18, 6),    # fsi's width, an uneven crop
    (1, 6, 13, 16, 32, 4, 10, 12, 6),
    (1, 3, 9, 140, 64, 2, 7, 136, 3),     # two tiles a row, the second of 8 positions
    (2, 6, 10, 12, 16, 4, 7, 8, 6),       # fma in both dtypes: C 16 not instantiated
]


@pytest.mark.parametrize("act", ["exact", "tanh"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K3F_SHAPES)
def test_k3f_variants_match_twin(cuda, shape, dtype, act):
    """K3F in the variant its dtype and width choose (mma in bf16, tf32 in
    f32 at C 32, 64, 128) and, beside a tensor-core one, the fma variant
    named on the same inputs, against the twin and against each other: the
    SSE (an f32 sum in both dtypes) to 1e-4 of max|ref|; two calls
    bit-equal; the per-variant counters."""
    B, Tp, Hp, Wp, C, T, H, W, F = shape
    g = torch.Generator(device=cuda).manual_seed(14)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    s = rn(B * Tp, Hp * Wp // 2, 2 * C).to(dtype)
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act=act)
    tail = (rn(B, T, H, W, F), rn(C, 128) / C ** 0.5, 0.1 * rn(128), rn(128, F) / 128 ** 0.5,
            0.1 * rn(F))
    chosen = kernels.k3f_variant(dtype, C, F)
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    assert chosen == (tc if C in (32, 64, 128) else "fma")
    kernels.reset_launches()
    got = tft.k3f(s, *tail, **kw)
    ref = tft.k3f_plain(s, *tail, **kw)
    _close(got, ref, torch.float32)
    assert torch.equal(got, tft.k3f(s, *tail, **kw))
    want = {"fma": 0, "mma": 0, "tf32": 0, chosen: 2}
    if chosen != "fma":
        fma = tft.k3f(s, *tail, **kw, variant="fma")
        _close(fma, ref, torch.float32)
        _close(got, fma, torch.float32)
        want["fma"] = 1
    assert kernels.VARIANTS["k3f"] == want and kernels.LAUNCHES["k3f"] == sum(want.values())


TA_BWD_SHAPES = [  # (B, S, T, h, d)
    (2, 300, 20, 4, 16),     # T 20 at each head width
    (1, 37, 20, 4, 32),
    (1, 50, 20, 2, 64),
    (2, 64, 32, 4, 32),      # T at the mma variant's bound
    (1, 100, 5, 3, 16),      # one column tile
    (1, 40, 9, 8, 16),       # 8 heads
    (2, 30, 20, 4, 8),       # fma in both dtypes: d 8 not instantiated
    (1, 20, 40, 2, 16),      # fma in both dtypes: T past 32
]


def _ta_bwd_check(q, k, v, pb, do, h, dtype, variant=None):
    """ta_bwd against autograd through the twin in f32: dq, dk, dv to TOL,
    dpb to 1e-6 of its sum over sites of P·(|dP| + |Σ P·dP|) (the f32 sum's
    bound, TA_DPB_TOL in chip_smoke.py)."""
    got = kernels.ta_bwd(q, k, v, pb, do, h, variant=variant)
    leaves = [t.float().requires_grad_() for t in (q, k, v, pb)]
    ref = torch.autograd.grad(tta.temporal_attention_tokens_plain(*leaves, h), leaves, do.float())
    torch.cuda.synchronize()
    for u, r in zip(got[:3], ref[:3]):
        _close(u, r.to(dtype), dtype)
    B, S, T, F = q.shape
    spl = lambda z: z.float().view(B, S, T, h, F // h)
    with torch.no_grad():
        p = torch.softmax(torch.einsum("bsihd,bsjhd->bshij", spl(q), spl(k)) + pb, dim=-1)
        dp = torch.einsum("bsihd,bsjhd->bshij", spl(do), spl(v))
        terms = (p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())).sum((0, 1))
    assert ((got[3] - ref[3]).abs() / terms.clamp_min(1e-30)).max() <= 1e-6
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TA_BWD_SHAPES)
def test_ta_bwd_variants_match_twin(cuda, shape, dtype):
    """The TA backward in the variant its dtype and shape choose (mma in
    bf16, tf32 in f32 at the tensor-core shapes), and there the fma variant
    named on the same inputs, against the twin and against each other; two
    calls bit-equal; the per-variant counters."""
    B, S, T, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(6)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    q = (rn(B, S, T, h * d) * d ** -0.5).to(dtype)
    k, v, do = (rn(B, S, T, h * d).to(dtype) for _ in range(3))
    pb = rn(h, T, T)
    chosen = kernels.ta_bwd_variant(dtype, T, h, d)
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    fits = getattr(kernels, f"ta_bwd_{tc}_smem_bytes")(T, h, d) <= kernels.MAX_SMEM_BYTES
    assert chosen == (tc if d in (16, 32, 64) and T <= 32 and fits else "fma")
    kernels.reset_launches()
    got = _ta_bwd_check(q, k, v, pb, do, h, dtype)
    assert all(torch.equal(u, w) for u, w in zip(got, kernels.ta_bwd(q, k, v, pb, do, h)))
    want = {"fma": 0, "mma": 0, "tf32": 0, chosen: 2}
    if chosen == tc:
        fma = _ta_bwd_check(q, k, v, pb, do, h, dtype, variant="fma")
        for u, w in zip(got[:3], fma[:3]):
            _close(u, w, dtype)
        want["fma"] = 1
    assert kernels.VARIANTS["ta_bwd"] == want and kernels.LAUNCHES["ta_bwd"] == sum(want.values())


@pytest.mark.parametrize("level, S", [("level0", 64 * 128), ("level1", 32 * 64),
                                      ("level2", 16 * 32), ("mid", 16 * 32)])
def test_ta_bwd_mma_at_the_unet_step_site_counts(cuda, level, S):
    """The TA backward's mma variant at the site counts the UNet step
    launches it at (batch 12; T 20, 4 heads of 32): against the twin, two
    calls bit-equal."""
    B, T, h, d = 12, 20, 4, 32
    g = torch.Generator(device=cuda).manual_seed(7 + S + len(level))
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    q = (rn(B, S, T, h * d) * d ** -0.5).bfloat16()
    k, v, do = (rn(B, S, T, h * d).bfloat16() for _ in range(3))
    pb = rn(h, T, T)
    kernels.reset_launches()
    got = _ta_bwd_check(q, k, v, pb, do, h, torch.bfloat16)
    assert all(torch.equal(u, w) for u, w in zip(got, kernels.ta_bwd(q, k, v, pb, do, h)))
    assert kernels.VARIANTS["ta_bwd"] == {"fma": 0, "mma": 2, "tf32": 0}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T, S", [(12, 2048), (12, 512), (8, 512)],
                         ids=["T12_level0", "T12_level1", "T8"])
def test_ta_kernels_at_the_wdno_padded_t(cuda, T, S, dtype):
    """Both TA kernels at the T of WDNO's padded coefficient grid (12 for
    the cylinder's 10 coefficient frames, 8 for controlled_cylinder's 5), at
    its per-level site counts (4 heads of 32, batch 2), in the tensor-core
    variant each dtype chooses (tf32, mma; T not a multiple of the tiles'
    padding): against the twin, each repeat bit-equal."""
    B, h, d = 2, 4, 32
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    assert kernels.ta_fwd_variant(dtype, T, h, d) == kernels.ta_bwd_variant(dtype, T, h, d) == tc
    g = torch.Generator(device=cuda).manual_seed(8 + T + S)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    q = (rn(B, S, T, h * d) * d ** -0.5).to(dtype)
    k, v, do = (rn(B, S, T, h * d).to(dtype) for _ in range(3))
    pb = rn(h, T, T)
    kernels.reset_launches()
    o = kernels.ta_fwd(q, k, v, pb, h)
    _close(o, tta.temporal_attention_tokens_plain(q, k, v, pb, h), dtype)
    assert torch.equal(o, kernels.ta_fwd(q, k, v, pb, h))
    got = _ta_bwd_check(q, k, v, pb, do, h, dtype)
    assert all(torch.equal(u, w) for u, w in zip(got, kernels.ta_bwd(q, k, v, pb, do, h)))
    assert kernels.VARIANTS["ta_fwd"][tc] == 2 and kernels.VARIANTS["ta_bwd"][tc] == 2


def test_k3f_and_ta_bwd_variants_refuse_what_they_do_not_take(cuda):
    """A named mma variant on f32, at a width, head width or T it is not
    built for raises; an unknown name raises; TA's kernels both refuse a
    misaligned view; nothing is counted."""
    B, Tp, Hp, Wp, C, T, H, W, F = K3F_SHAPES[3]
    s = torch.zeros(B * Tp, Hp * Wp // 2, 2 * C, device=cuda, dtype=torch.bfloat16)
    tail = (torch.zeros(B, T, H, W, F, device=cuda), torch.zeros(C, 128, device=cuda),
            torch.zeros(128, device=cuda), torch.zeros(128, F, device=cuda),
            torch.zeros(F, device=cuda))
    kw = dict(dims=(B, Tp, Hp, Wp, C), tail_dims=(T, H, W), act="exact")
    kernels.reset_launches()
    with pytest.raises(ValueError, match="mma variant"):
        tft.k3f(s, *tail, **kw, variant="mma")                            # C 16
    with pytest.raises(ValueError, match="no variant"):
        tft.k3f(s, *tail, **kw, variant="wgmma")
    for (B, S, T, h, d), dtype in (((1, 8, 20, 4, 32), torch.float32),
                                   ((1, 8, 20, 4, 8), torch.bfloat16),
                                   ((1, 8, 33, 4, 16), torch.bfloat16)):
        q = torch.zeros(B, S, T, h * d, device=cuda, dtype=dtype)
        pb = torch.zeros(h, T, T, device=cuda)
        with pytest.raises(ValueError, match="mma variant"):
            kernels.ta_bwd(q, q, q, pb, q, h, variant="mma")
    q = torch.zeros(1, 8, 20, 128, device=cuda, dtype=torch.bfloat16)
    pb = torch.zeros(4, 20, 20, device=cuda)
    with pytest.raises(ValueError, match="no variant"):
        kernels.ta_bwd(q, q, q, pb, q, 4, variant="wgmma")
    view = torch.cat([q.new_zeros(1), q.reshape(-1)])[1:].view(q.shape)
    for variant in (None, "fma", "mma"):
        with pytest.raises(ValueError, match="16-byte aligned"):
            kernels.ta_bwd(q, q, q, pb, view, 4, variant=variant)
    assert not any(kernels.LAUNCHES.values())


TA_FWD_SHAPES = [  # (B, S, T, h, d)
    (2, 300, 20, 4, 16),     # T 20 at each head width
    (1, 37, 20, 4, 32),
    (1, 50, 20, 2, 64),
    (2, 64, 32, 4, 32),      # T at the mma variant's bound
    (1, 100, 5, 3, 16),      # one column tile
    (1, 40, 9, 8, 16),       # 8 heads
    (1, 33, 16, 2, 64),      # two whole column tiles
    (1, 30, 7, 4, 64),
    (1, 20, 32, 8, 32),      # 8 heads at T 32: the forward's bf16 block fits, no other
    (2, 30, 20, 4, 8),       # fma in both dtypes: d 8 not instantiated
    (1, 20, 40, 2, 16),      # fma in both dtypes: T past 32
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TA_FWD_SHAPES)
def test_ta_fwd_variants_match_twin(cuda, shape, dtype):
    """The TA forward in the variant its dtype and shape choose (mma in
    bf16, tf32 in f32 at the tensor-core shapes), and there the fma variant
    named on the same inputs, against the twin and against each other; two
    calls of each bit-equal; the per-variant counters."""
    B, S, T, h, d = shape
    g = torch.Generator(device=cuda).manual_seed(8)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    q = (rn(B, S, T, h * d) * d ** -0.5).to(dtype)
    k, v = (rn(B, S, T, h * d).to(dtype) for _ in range(2))
    pb = rn(h, T, T)
    chosen = kernels.ta_fwd_variant(dtype, T, h, d)
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    fits = getattr(kernels, f"ta_fwd_{tc}_smem_bytes")(T, h, d) <= kernels.MAX_SMEM_BYTES
    assert chosen == (tc if d in (16, 32, 64) and T <= 32 and fits else "fma")
    kernels.reset_launches()
    ref = tta.temporal_attention_tokens_plain(q, k, v, pb, h)
    got = kernels.ta_fwd(q, k, v, pb, h)
    _close(got, ref, dtype)
    assert torch.equal(got, kernels.ta_fwd(q, k, v, pb, h))
    want = {"fma": 0, "mma": 0, "tf32": 0, chosen: 2}
    if chosen == tc:
        fma = kernels.ta_fwd(q, k, v, pb, h, variant="fma")
        _close(fma, ref, dtype)
        _close(got, fma, dtype)
        assert torch.equal(fma, kernels.ta_fwd(q, k, v, pb, h, variant="fma"))
        want["fma"] = 2
    assert kernels.VARIANTS["ta_fwd"] == want and kernels.LAUNCHES["ta_fwd"] == sum(want.values())


@pytest.mark.parametrize("level, S", [("level0", 64 * 128), ("level1", 32 * 64),
                                      ("level2", 16 * 32), ("mid", 16 * 32)])
def test_ta_fwd_mma_at_the_unet_step_site_counts(cuda, level, S):
    """The TA forward's mma variant at the site counts the UNet launches it
    at (batch 12; T 20, 4 heads of 32): against the twin, two calls
    bit-equal."""
    B, T, h, d = 12, 20, 4, 32
    g = torch.Generator(device=cuda).manual_seed(9 + S + len(level))
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    q = (rn(B, S, T, h * d) * d ** -0.5).bfloat16()
    k, v = (rn(B, S, T, h * d).bfloat16() for _ in range(2))
    pb = rn(h, T, T)
    kernels.reset_launches()
    got = kernels.ta_fwd(q, k, v, pb, h)
    _close(got, tta.temporal_attention_tokens_plain(q, k, v, pb, h), torch.bfloat16)
    assert torch.equal(got, kernels.ta_fwd(q, k, v, pb, h))
    assert kernels.VARIANTS["ta_fwd"] == {"fma": 0, "mma": 2, "tf32": 0}


@pytest.mark.parametrize("level, S", [("level0", 64 * 128), ("level1", 32 * 64),
                                      ("level2", 16 * 32), ("mid", 16 * 32)])
def test_ta_tf32_at_the_unet_step_site_counts(cuda, level, S):
    """The TA forward's and backward's tf32 variants at the site counts the
    f32 UNet step launches them at (batch 12; T 20, 4 heads of 32): against
    the twin within 1e-4·max|ref| (dpb within 1e-6 of its sum of |terms|),
    two calls of each bit-equal."""
    B, T, h, d = 12, 20, 4, 32
    g = torch.Generator(device=cuda).manual_seed(11 + S + len(level))
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    q = rn(B, S, T, h * d) * d ** -0.5
    k, v, do = (rn(B, S, T, h * d) for _ in range(3))
    pb = rn(h, T, T)
    kernels.reset_launches()
    o = kernels.ta_fwd(q, k, v, pb, h)
    _close(o, tta.temporal_attention_tokens_plain(q, k, v, pb, h), torch.float32)
    assert torch.equal(o, kernels.ta_fwd(q, k, v, pb, h))
    got = _ta_bwd_check(q, k, v, pb, do, h, torch.float32)
    assert all(torch.equal(u, w) for u, w in zip(got, kernels.ta_bwd(q, k, v, pb, do, h)))
    assert kernels.VARIANTS["ta_fwd"] == {"fma": 0, "mma": 0, "tf32": 2}
    assert kernels.VARIANTS["ta_bwd"] == {"fma": 0, "mma": 0, "tf32": 2}


@pytest.mark.parametrize("where", ["q", "k", "v", "do"])
@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_ta_tf32_keeps_non_finite_inputs(cuda, where, value):
    """Inf or NaN in one entry of q, k, v or do: each output of the tf32
    variants is non-finite where the twin's is (o does not read do, dv does
    not read v), and finite where the twin's is."""
    B, S, T, h, d = 1, 37, 20, 4, 32
    g = torch.Generator(device=cuda).manual_seed(12)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    ins = dict(q=rn(B, S, T, h * d) * d ** -0.5, k=rn(B, S, T, h * d), v=rn(B, S, T, h * d),
               do=rn(B, S, T, h * d))
    pb = rn(h, T, T)
    ins[where][0, 5, 3, 40] = value
    q, k, v, do = ins["q"], ins["k"], ins["v"], ins["do"]
    kernels.reset_launches()
    got = (kernels.ta_fwd(q, k, v, pb, h), *kernels.ta_bwd(q, k, v, pb, do, h))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v, pb)]
    o = tta.temporal_attention_tokens_plain(*leaves, h)
    ref = (o.detach(), *torch.autograd.grad(o, leaves, do))
    torch.cuda.synchronize()
    for name, u, r in zip(("o", "dq", "dk", "dv", "dpb"), got, ref):
        assert bool(torch.isfinite(u).all()) == bool(torch.isfinite(r).all()), name
    assert not all(bool(torch.isfinite(u).all()) for u in got)
    assert kernels.VARIANTS["ta_fwd"]["tf32"] == 1 and kernels.VARIANTS["ta_bwd"]["tf32"] == 1


GK_MMA_SHAPES = GK_SHAPES + [
    (16, 20000, 4, 64),    # chunks of more than 32 tiles: the accumulators flush
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GK_MMA_SHAPES)
def test_gk_scores_variants_match_twin(cuda, shape, dtype):
    """The scores in the variant each dtype chooses (mma) and the fma
    variant named on the same inputs, against the twin (both in f32 from
    the same inputs) and against each other; two calls of each bit-equal;
    the per-variant counters."""
    B, N, h, d = shape
    k, v, aff = _gk_inputs(shape, dtype, cuda, seed=12)
    assert kernels.gk_scores_variant(dtype, d) == "mma"
    kernels.reset_launches()
    ref = tga.galerkin_scores_plain(k, v, *aff, h, 1e-7)
    got = kernels.gk_scores(k, v, *aff, heads=h, eps=1e-7)
    fma = kernels.gk_scores(k, v, *aff, heads=h, eps=1e-7, variant="fma")
    _close(got, ref, torch.float32)
    _close(fma, ref, torch.float32)
    _close(got, fma, torch.float32)
    assert torch.equal(got, kernels.gk_scores(k, v, *aff, heads=h, eps=1e-7))
    assert kernels.VARIANTS["gk_scores"] == {"fma": 1, "mma": 2}
    assert kernels.LAUNCHES["gk_scores"] == 3


def test_ta_fwd_and_gk_scores_variants_refuse_what_they_do_not_take(cuda):
    """A named mma variant of the TA forward on f32, at a head width or T it
    is not built for raises; an unknown name raises; both TA and the scores
    refuse a misaligned view in every variant; nothing is counted."""
    kernels.reset_launches()
    for (B, S, T, h, d), dtype in (((1, 8, 20, 4, 32), torch.float32),
                                   ((1, 8, 20, 4, 8), torch.bfloat16),
                                   ((1, 8, 33, 4, 16), torch.bfloat16)):
        q = torch.zeros(B, S, T, h * d, device=cuda, dtype=dtype)
        pb = torch.zeros(h, T, T, device=cuda)
        with pytest.raises(ValueError, match="mma variant"):
            kernels.ta_fwd(q, q, q, pb, h, variant="mma")
    q = torch.zeros(1, 8, 20, 128, device=cuda, dtype=torch.bfloat16)
    pb = torch.zeros(4, 20, 20, device=cuda)
    with pytest.raises(ValueError, match="no variant"):
        kernels.ta_fwd(q, q, q, pb, 4, variant="wgmma")
    view = torch.cat([q.new_zeros(1), q.reshape(-1)])[1:].view(q.shape)
    for variant in (None, "fma", "mma"):
        with pytest.raises(ValueError, match="16-byte aligned"):
            kernels.ta_fwd(q, q, view, pb, 4, variant=variant)
    k = torch.zeros(1, 40, 128, device=cuda, dtype=torch.bfloat16)
    aff = [torch.ones(2, 64, device=cuda)] * 4
    with pytest.raises(ValueError, match="no variant"):
        kernels.gk_scores(k, k, *aff, heads=2, eps=1e-5, variant="wgmma")
    view = torch.cat([k.new_zeros(1), k.reshape(-1)])[1:].view(k.shape)
    for variant in (None, "fma", "mma"):
        with pytest.raises(ValueError, match="16-byte aligned"):
            kernels.gk_scores(k, view, *aff, heads=2, eps=1e-5, variant=variant)
    assert not any(kernels.LAUNCHES.values())


def test_mma_shared_memory_layouts_agree_with_the_library(cuda):
    """kernels.py's block sizes of the TA, scores, K1, K2A-lite, K2 and K12B
    tensor-core variants (mma and tf32), on which the variant functions
    decide, against the sources' own."""
    lib = kernels.library()
    for Wp in (22, 70, 134, 256):
        for m3 in (8, 16):
            for v in ("mma", "tf32"):
                assert getattr(lib, f"fno_k1_{v}_smem_bytes")(Wp, m3) == \
                    getattr(kernels, f"k1_{v}_smem_bytes")(Wp, m3), v
                for C in (16, 64, 128):
                    assert getattr(lib, f"fno_k2a_lite_{v}_smem_bytes")(Wp, m3, C) == \
                        getattr(kernels, f"k2a_lite_{v}_smem_bytes")(Wp, m3, C), v
        for C in (32, 64, 128):
            for m2x2 in (6, 24, 32):
                for m3 in (8, 16):
                    for k, v in (("k2", "mma"), ("k2", "tf32"), ("k12b", "mma"),
                                 ("k12b", "tf32")):
                        assert getattr(lib, f"fno_{k}_{v}_smem_bytes")(Wp, C, m2x2, m3) == \
                            getattr(kernels, f"{k}_{v}_smem_bytes")(Wp, C, m2x2, m3), (k, v)
    for T in (5, 9, 16, 20, 32):
        for h in (1, 3, 4, 8):
            for d in (16, 32, 64):
                assert lib.ta_fwd_mma_smem_bytes(T, h, d) == kernels.ta_fwd_mma_smem_bytes(T, h, d)
                assert lib.ta_bwd_mma_smem_bytes(T, h, d) == kernels.ta_bwd_mma_smem_bytes(T, h, d)
    for d in (16, 32, 64):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            assert lib.gk_scores_mma_smem_bytes(d, code) == kernels.gk_scores_mma_smem_bytes(
                d, dtype)


def test_k2_and_k12b_tf32_variants_refuse_what_they_do_not_take(cuda):
    """A named tf32 variant on bfloat16, on a width or W mode count it is not
    instantiated for, or on a misaligned view raises before any launch."""
    BT, Hp, Wp, C, m2, m3 = K12B_SHAPES[1]
    kernels.reset_launches()
    for dtype, Cx, m3x, offset in ((torch.bfloat16, C, m3, 0), (torch.float32, 16, m3, 0),
                                   (torch.float32, C, 12, 0), (torch.float32, C, m3, 1)):
        n = BT * Hp * Wp * Cx
        x = torch.zeros(n + 8, device=cuda, dtype=dtype)[offset:offset + n].view(
            BT, Hp * Wp // 2, 2 * Cx)
        dy = torch.zeros(BT, 2 * m2 * m3x, 2 * Cx, device=cuda, dtype=dtype)
        v, wp = torch.zeros(Cx, device=cuda), torch.zeros(Cx, Cx, device=cuda)
        geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3x)
        with pytest.raises(ValueError, match="tf32 variant"):
            tfl.k12b(x, v, v, wp, x, x, v, v, dy, **geo, act="none", variant="tf32")
        with pytest.raises(ValueError, match="tf32 variant"):
            tfl.k2(dy, x, v, v, wp, v, **geo, act="none", variant="tf32")
    assert not any(kernels.LAUNCHES.values())


def test_k1_and_k2a_lite_tf32_variants_refuse_what_they_do_not_take(cuda):
    """A named tf32 variant on bfloat16, on a width or W mode count it is not
    instantiated for, or on a misaligned view raises before any launch; so
    does one without its tables."""
    BT, Hp, Wp, C, m2, m3 = K2A_LITE_SHAPES[1]
    kernels.reset_launches()
    for dtype, Cx, m3x, offset in ((torch.bfloat16, C, m3, 0), (torch.float32, 8, m3, 0),
                                   (torch.float32, C, 12, 0), (torch.float32, C, m3, 1)):
        n = BT * Hp * Wp * Cx
        x = torch.zeros(n + 8, device=cuda, dtype=dtype)[offset:offset + n].view(
            BT, Hp * Wp // 2, 2 * Cx)
        gy = torch.zeros(BT, 2 * m2 * m3x, 2 * Cx, device=cuda, dtype=dtype)
        v, wp = torch.zeros(Cx, device=cuda), torch.zeros(Cx, Cx, device=cuda)
        geo = dict(Hp=Hp, Wp=Wp, m2=m2, m3=m3x)
        with pytest.raises(ValueError, match="tf32 variant"):
            tfl.k1(x, v, v, **geo, act="none", variant="tf32")
        with pytest.raises(ValueError, match="tf32 variant"):   # lite statics exist at m3 12
            tfl.k2a_lite(x, gy, gy, v, v, wp, v, **geo, variant="tf32")
    x = torch.zeros(BT, Hp * Wp // 2, 2 * C, device=cuda)
    v = torch.zeros(C, device=cuda)
    cst = tfl._ct_on(cuda, Hp, Wp, m2, m3)
    with pytest.raises(ValueError, match="packed tables"):
        kernels.k1(x, v, v, cst["ewr"], cst["ewi"], cst["ehr"], cst["ehi"], Hp=Hp, Wp=Wp,
                   act="none", variant="tf32")
    assert not any(kernels.LAUNCHES.values())
