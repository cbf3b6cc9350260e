"""PyTorch port vs JAX package: the backward of the fused FNO layer.

On the CPU the port's T-stage, K2A, K2A-lite and K12B run their plain twins;
the JAX side runs its Pallas kernels in interpret mode (unaligned layout) at
the dims of tests/test_pallas_fno_layer.py, or is differentiated with
jax.vjp / jax.grad. All f32; tolerance rtol 2e-4 with atol 2e-4·max|ref|.
JAX's per-(parity, channel) lane vectors [2C] hold the port's per-channel
vectors [C] twice; its BN statistics fold to per channel.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.ops.pallas import fno_layer as jfl
from realpdebench_tpu_torch.ops import fno_layer as tfl

B, Tp, Hp, Wp, C = 2, 6, 10, 12, 8
M1, M2, M3 = 2, 3, 4
DIMS = (B, Tp, Hp, Wp, C)
J, Y = Wp // 2, 2 * M2 * M3
NPOS = B * Tp * Hp * Wp
GEO = dict(Hp=Hp, Wp=Wp, m2=M2, m3=M3)
NAMES = ["x", "a", "b", "w_real", "w_imag", "wp", "bp"]


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _t(v):
    return torch.from_numpy(np.asarray(v, np.float32))


def _lanes(v):
    """Per-channel [C] → JAX's per-(parity | re-im, channel) row [1, 2C]."""
    v = np.asarray(v, np.float32)
    return jnp.asarray(np.concatenate([v, v])[None])


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * r.normal(size=s)).astype(
        np.float32)
    return dict(x=f(B * Tp, Hp * J, 2 * C), a=f(C, scale=0.1, loc=1.0),
                b=f(C, scale=0.1), wr=f(4, M1, M2, M3, C, C, scale=0.2),
                wi=f(4, M1, M2, M3, C, C, scale=0.2), wp=f(C, C, scale=0.3),
                bp=f(C, scale=0.1), g=f(B * Tp, Y, 2 * C), ds=f(B * Tp, Hp * J, 2 * C),
                dy=f(B * Tp, Y, 2 * C), ds1=f(C), ds2=f(C, scale=0.1))


def _forward_residuals(d, act):
    """Consistent (y, s) for given x, g: y = K1(x), s = K2(g, x) (twins)."""
    t = {k: _t(v) for k, v in d.items()}
    y = tfl.k1(t["x"], t["a"], t["b"], **GEO, act=act)
    s, _ = tfl.k2(t["g"], t["x"], t["a"], t["b"], t["wp"], t["bp"], **GEO, act=act)
    return t, y, s


@pytest.mark.parametrize("kind", ["et", "it"])
def test_tstage_adjoint_is_the_transpose(kind):
    """<t(y), u> = <y, t_adj(u)> for the matrices of tstage_mats."""
    r = np.random.default_rng(1)
    mr, mi = tfl.tstage_mats(kind, Tp, M1)
    tin, tout = mr.shape
    y = _t(r.normal(size=(B * tin, Y, 2 * C)))
    u = _t(r.normal(size=(B * tout, Y, 2 * C)))
    lhs = (tfl.t_stage(y, kind, Tp, M1).double() * u.double()).sum()
    rhs = (y.double() * tfl.t_stage(u, kind + "_adj", Tp, M1).double()).sum()
    terms = (tfl.t_stage(y, kind, Tp, M1).double() * u.double()).abs().sum()
    assert abs((lhs - rhs).item()) <= 1e-6 * terms.item()
    ar, ai = tfl.tstage_mats(kind + "_adj", Tp, M1)
    np.testing.assert_array_equal(ar, mr.T)
    np.testing.assert_array_equal(ai, -mi.T)


@pytest.mark.parametrize("kind", ["et", "it"])
def test_tstage_backward_matches_jax_vjp(kind):
    r = np.random.default_rng(2)
    tin, tout = tfl.tstage_mats(kind, Tp, M1)[0].shape
    y = r.normal(size=(B * tin, Y, 2 * C)).astype(np.float32)
    u = r.normal(size=(B * tout, Y, 2 * C)).astype(np.float32)
    _, vjp = jax.vjp(lambda q: jfl.t_stage(q, kind, Tp, M1, "mxu", True),
                     jnp.asarray(y))
    yt = _t(y).requires_grad_()
    (got,) = torch.autograd.grad(tfl.t_stage(yt, kind, Tp, M1), yt, _t(u))
    _close(got.numpy(), vjp(jnp.asarray(u))[0])


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k2a_and_lite_twins_match_pallas(act):
    d = _inputs(3)
    t, y, s = _forward_residuals(d, act)
    full = tfl.k2a(s, t["ds"], t["ds1"], t["ds2"], **GEO)
    lite = tfl.k2a_lite(t["ds"], t["g"], y, t["ds1"], t["ds2"], t["wp"], t["bp"],
                        **GEO)
    _close(lite.numpy(), full.numpy())

    cst = jfl._ct_consts(Hp, Wp, M2, M3)
    eyeC, zC = np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32)
    sel = (np.concatenate([eyeC, zC], axis=0), np.concatenate([zC, eyeC], axis=0))
    consts = (cst["IhPT"], cst["IwET"], cst["IwOT"], *sel)
    ds1, ds2 = _lanes(d["ds1"]), _lanes(d["ds2"])
    _, _, k2a_full, _ = jfl._layer_calls(B * Tp, Hp, J, 2 * C, M2, M3, act,
                                         True, "float32")
    ref = k2a_full(jnp.asarray(s.numpy()), jnp.asarray(d["ds"]), ds1, ds2, *consts)
    _close(full.numpy(), ref)

    _, _, k2a_lite, _ = jfl._layer_calls(B * Tp, Hp, J, 2 * C, M2, M3, act, True,
                                         "float32", False, (1, 1, 1, 1), None,
                                         True, True)
    alpha, beta, Dv, A1v = jfl._lite_consts(Hp, Wp, M2, M3)
    lane = lambda v: np.ascontiguousarray(np.concatenate(
        [np.broadcast_to(v[:, 0:1], (Y, C)), np.broadcast_to(v[:, 1:2], (Y, C))],
        axis=1), np.float32)
    two = 2.0 * ds2
    dsc = jnp.concatenate([ds1 + two * _lanes(d["bp"]), two], axis=0)
    wp2s = jfl._block_diag2(jnp.asarray(d["wp"])) * two[0][None, :]
    ref_lite = k2a_lite(jnp.asarray(d["ds"]), jnp.asarray(d["g"]),
                        jnp.asarray(y.numpy()), dsc, wp2s, *consts, lane(alpha),
                        lane(beta), lane(A1v), lane(Dv))
    _close(lite.numpy(), ref_lite)


@pytest.mark.parametrize("act", ["none", "exact", "tanh"])
def test_k12b_twin_matches_pallas(act):
    d = _inputs(4)
    t, _, s = _forward_residuals(d, act)
    got = tfl.k12b(t["x"], t["a"], t["b"], t["wp"], s, t["ds"], t["ds1"],
                   t["ds2"], t["dy"], **GEO, act=act)
    cst = jfl._ct_consts(Hp, Wp, M2, M3)
    eyeC, zC = np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32)
    ones = np.ones((Hp * J, 1), np.float32)
    a2, b2 = jfl._pack_affine(jnp.asarray(d["a"])[None], jnp.asarray(d["b"])[None], C)
    *_, k12b = jfl._layer_calls(B * Tp, Hp, J, 2 * C, M2, M3, act, True, "float32")
    dx, dwp2, dvec = k12b(
        jnp.asarray(d["x"]), a2, b2, jfl._block_diag2(jnp.asarray(d["wp"])).T,
        jnp.asarray(s.numpy()), jnp.asarray(d["ds"]), _lanes(d["ds1"]),
        _lanes(d["ds2"]), jnp.asarray(d["dy"]), cst["EhPT"], cst["E67T"],
        cst["E67twT"], np.concatenate([eyeC, zC], axis=1),
        np.concatenate([zC, eyeC], axis=1), ones, ones)
    dwp2, dvec = np.asarray(dwp2), np.asarray(dvec)
    fold = lambda v: v[:C] + v[C:]
    ref = (dx, dwp2[:C, :C] + dwp2[C:, C:], fold(dvec[1]), fold(dvec[2]),
           fold(dvec[0]))
    for name, g, r in zip(["dx", "dwp", "da", "db", "dbp"], got, ref):
        _close(g.numpy(), r)


@pytest.mark.parametrize("geo", [(Hp, Wp, M2, M3), (70, 134, 12, 16)],
                         ids=["test_dims", "bench_dims"])
def test_lite_consts_pass_their_residual_checks(geo):
    """The statics come out of _lite_consts's residual checks (it raises
    otherwise); A is the adjoint of V; D is the irfft weight c_m/(Hp·Wp)."""
    h, w, m2, m3 = geo
    lite = tfl._lite_consts(h, w, m2, m3)
    assert all(v.shape == (2 * m2 * m3, 2) for v in lite.values())
    F, V, A = tfl._np_mirrors(h, w, m2, m3)
    r = np.random.default_rng(5)
    g, d = r.normal(size=(2 * m2 * m3, 2, 2)), r.normal(size=(h, w, 2))
    lhs, rhs = np.sum(V(g) * d), np.sum(g * A(d))
    assert abs(lhs - rhs) <= 1e-9 * np.sum(np.abs(V(g) * d))
    cm = np.where(np.arange(m3) == 0, 1.0, 2.0) / (h * w)
    np.testing.assert_allclose(lite["D"][:, 0].reshape(2 * m2, m3),
                               np.broadcast_to(cm, (2 * m2, m3)), rtol=1e-5)


def test_lite_fit_failure_runs_k2a_with_a_warning(monkeypatch):
    """Counterpart of tests/test_pallas_fno_layer.py::
    test_k2alite_geometry_fallback: a geometry the structure fit rejects
    runs the full-read K2A, with one UserWarning, and the same gradients."""
    d = _inputs(6)
    args = [_t(d[k]).requires_grad_() for k in ("x", "a", "b", "wr", "wi", "wp", "bp")]

    def grads():
        s, st = tfl.fused_fno_layer(*args, dims=DIMS, act="exact")
        return torch.autograd.grad((s * s).sum() + st.sum(), args)

    want = grads()
    calls = []
    real_k2a = tfl.k2a
    monkeypatch.setattr(tfl, "k2a", lambda *a, **k: calls.append(1) or real_k2a(*a, **k))

    def boom(*a, **k):
        raise AssertionError("forced structure-fit failure")

    monkeypatch.setattr(tfl, "_lite_consts", boom)
    tfl._lite_or_none.cache_clear()
    try:
        with pytest.warns(UserWarning, match="K2A-lite disabled"):
            got = grads()
        with warnings.catch_warnings():
            warnings.simplefilter("error")      # warned once per geometry
            grads()
    finally:
        tfl._lite_or_none.cache_clear()
    assert len(calls) == 2
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


def _stats_loss(s, st):
    """The JAX test's loss (test_pallas_fno_layer.py:65-86): uses s and the
    BN statistics, so every cotangent path of the layer is exercised."""
    mean = st[0] / NPOS
    var = st[1] / NPOS - mean ** 2
    return (s * s).sum() * 1e-3 + var.sum() + (mean ** 2).sum()


def _jfold(stats):
    return stats[:, :C] + stats[:, C:]


@pytest.mark.parametrize("act", ["none", "exact", "tanh"])
def test_layer_gradients_match_jax(act):
    d = _inputs(7)
    keys = ("x", "a", "b", "wr", "wi", "wp", "bp")
    targs = [_t(d[k]).requires_grad_() for k in keys]
    s, st = tfl.fused_fno_layer(*targs, dims=DIMS, act=act)
    loss = _stats_loss(s, st)
    got = torch.autograd.grad(loss, targs)

    def jloss(*a):
        s_, st_ = jfl.fused_fno_layer(*a, dims=DIMS, act=act, interpret=True)
        return _stats_loss(s_, _jfold(st_))

    jargs = [jnp.asarray(d[k]) for k in keys]
    for i in (1, 2, 6):
        jargs[i] = jargs[i][None]
    jl, jg = jax.value_and_grad(jloss, argnums=tuple(range(7)))(*jargs)
    _close(loss.item(), float(jl))
    for name, g, r in zip(NAMES, got, jg):
        _close(g.numpy(), np.asarray(r).reshape(g.shape))


def test_two_layers_with_folded_bn_match_jax():
    """Two chained layers, layer 0's BN statistics folded into layer 1's
    input affine (tests/test_pallas_fno_layer.py:89-120)."""
    d = _inputs(8)
    gamma = (1.0 + 0.1 * np.random.default_rng(9).normal(size=C)).astype(np.float32)

    def chain(layer, x, a, b, wr, wi, wp, bp, fold, lead, gam):
        s, st = layer(x, a, b, wr, wi, wp, bp, act="none")
        ch = fold(st)
        mean = ch[0] / NPOS
        var = ch[1] / NPOS - mean ** 2
        a2 = gam / (var + 1e-5) ** 0.5
        b2 = -mean * a2
        s2, _ = layer(s, lead(a2), lead(b2), wr, wi, wp, bp, act="tanh")
        return (s2 ** 2).mean(), s2

    keys = ("x", "a", "b", "wr", "wi", "wp", "bp")
    targs = [_t(d[k]) for k in keys]
    x = targs[0].requires_grad_()
    tl, ts2 = chain(lambda *q, act: tfl.fused_fno_layer(*q, dims=DIMS, act=act),
                    *targs, fold=lambda st: st, lead=lambda v: v, gam=_t(gamma))
    (tgx,) = torch.autograd.grad(tl, x)

    jargs = [jnp.asarray(d[k]) for k in keys]
    for i in (1, 2, 6):
        jargs[i] = jargs[i][None]
    jlayer = lambda *q, act: jfl.fused_fno_layer(*q, dims=DIMS, act=act,
                                                 interpret=True)
    run = lambda xx: chain(jlayer, xx, *jargs[1:], fold=_jfold,
                           lead=lambda v: v[None], gam=jnp.asarray(gamma))
    (jl, js2), jgx = jax.value_and_grad(run, has_aux=True)(jargs[0])
    _close(tl.item(), float(jl))
    _close(ts2.detach().numpy(), js2)
    _close(tgx.numpy(), jgx)


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k12b_twin_matches_pallas_at_width_128(act):
    """K12B's twin at the fsi config's width (C 128) against the Pallas
    ``_k12b_kernel`` in interpret mode."""
    C2, Hp2, Wp2, BT = 128, 7, 10, 2
    r = np.random.default_rng(11)
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * r.normal(size=s)).astype(np.float32)
    d = dict(x=f(BT, Hp2 * Wp2 // 2, 2 * C2), a=f(C2, scale=0.1, loc=1.0),
             b=f(C2, scale=0.1), wp=f(C2, C2, scale=0.1), s=f(BT, Hp2 * Wp2 // 2, 2 * C2),
             ds=f(BT, Hp2 * Wp2 // 2, 2 * C2), ds1=f(C2), ds2=f(C2, scale=0.1),
             dy=f(BT, 2 * M2 * M3, 2 * C2))
    t = {k: _t(v) for k, v in d.items()}
    geo = dict(Hp=Hp2, Wp=Wp2, m2=M2, m3=M3)
    got = tfl.k12b(t["x"], t["a"], t["b"], t["wp"], t["s"], t["ds"], t["ds1"], t["ds2"],
                   t["dy"], **geo, act=act)
    cst = jfl._ct_consts(Hp2, Wp2, M2, M3)
    eyeC, zC = np.eye(C2, dtype=np.float32), np.zeros((C2, C2), np.float32)
    ones = np.ones((Hp2 * Wp2 // 2, 1), np.float32)
    a2, b2 = jfl._pack_affine(jnp.asarray(d["a"])[None], jnp.asarray(d["b"])[None], C2)
    *_, k12b = jfl._layer_calls(BT, Hp2, Wp2 // 2, 2 * C2, M2, M3, act, True, "float32")
    dx, dwp2, dvec = k12b(
        jnp.asarray(d["x"]), a2, b2, jfl._block_diag2(jnp.asarray(d["wp"])).T,
        jnp.asarray(d["s"]), jnp.asarray(d["ds"]), _lanes(d["ds1"]), _lanes(d["ds2"]),
        jnp.asarray(d["dy"]), cst["EhPT"], cst["E67T"], cst["E67twT"],
        np.concatenate([eyeC, zC], axis=1), np.concatenate([zC, eyeC], axis=1), ones, ones)
    dwp2, dvec = np.asarray(dwp2), np.asarray(dvec)
    fold = lambda v: v[:C2] + v[C2:]
    ref = (dx, dwp2[:C2, :C2] + dwp2[C2:, C2:], fold(dvec[1]), fold(dvec[2]), fold(dvec[0]))
    for g, w in zip(got, ref):
        _close(g.numpy(), w)
