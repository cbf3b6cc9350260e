"""PyTorch port vs JAX package: the fused FNO layer and its three kernels.

On the CPU the port's ``k1``, ``t_stage`` and ``k2`` run their plain twins;
the JAX side runs its Pallas kernels in interpret mode, unaligned layout, at
the dims of tests/test_pallas_fno_layer.py. All f32; tolerance rtol 2e-4
with atol 2e-4·max|ref|. JAX's BN statistics are per (parity, channel)
[2, 2C] and are folded to the port's per-channel [2, C].
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.ops.pallas import fno_layer as jfl
from realpdebench_tpu_torch.ops import fno_layer as tfl
from realpdebench_tpu_torch.ops import kernels

B, Tp, Hp, Wp, C = 2, 6, 10, 12, 8
M1, M2, M3 = 2, 3, 4
DIMS = (B, Tp, Hp, Wp, C)
J, Y = Wp // 2, 2 * M2 * M3


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _fold(stats):
    stats = np.asarray(stats)
    return stats[:, :C] + stats[:, C:]


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * r.normal(size=s)).astype(
        np.float32)
    return dict(x=f(B * Tp, Hp * J, 2 * C), a=f(C, scale=0.1, loc=1.0),
                b=f(C, scale=0.1), wr=f(4, M1, M2, M3, C, C, scale=0.2),
                wi=f(4, M1, M2, M3, C, C, scale=0.2), wp=f(C, C, scale=0.3),
                bp=f(C, scale=0.1), g=f(B * Tp, Y, 2 * C))


def _jax_calls(act):
    k1, k2, _, _ = jfl._layer_calls(B * Tp, Hp, J, 2 * C, M2, M3, act, True,
                                    "float32")
    return k1, k2


def _t(v):
    return torch.from_numpy(v)


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k1_twin_matches_pallas_k1(act):
    d = _inputs()
    cst = jfl._ct_consts(Hp, Wp, M2, M3)
    a2, b2 = jfl._pack_affine(jnp.asarray(d["a"])[None],
                              jnp.asarray(d["b"])[None], C)
    k1, _ = _jax_calls(act)
    ref = k1(jnp.asarray(d["x"]), a2, b2, cst["E67X"], cst["EhP"],
             np.ones((Hp * J, 1), np.float32))
    got = tfl.k1(_t(d["x"]), _t(d["a"]), _t(d["b"]), Hp=Hp, Wp=Wp, m2=M2,
                 m3=M3, act=act)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("act", ["none", "exact"])
def test_k2_twin_matches_pallas_k2(act):
    d = _inputs(1)
    cst = jfl._ct_consts(Hp, Wp, M2, M3)
    eyeC, zC = np.eye(C, dtype=np.float32), np.zeros((C, C), np.float32)
    a2, b2 = jfl._pack_affine(jnp.asarray(d["a"])[None],
                              jnp.asarray(d["b"])[None], C)
    wp2 = jfl._block_diag2(jnp.asarray(d["wp"]))
    bp2 = jnp.concatenate([d["bp"][None], d["bp"][None]], axis=1)
    ones = np.ones((Hp * J, 1), np.float32)
    _, k2 = _jax_calls(act)
    s_ref, st_ref = k2(jnp.asarray(d["g"]), jnp.asarray(d["x"]), a2, b2, wp2,
                       bp2, cst["IhP"], cst["IwE2"], cst["IwO2"],
                       np.concatenate([eyeC, zC], axis=1),
                       np.concatenate([zC, eyeC], axis=1), ones, ones)
    s, st = tfl.k2(_t(d["g"]), _t(d["x"]), _t(d["a"]), _t(d["b"]), _t(d["wp"]),
                   _t(d["bp"]), Hp=Hp, Wp=Wp, m2=M2, m3=M3, act=act)
    _close(s.numpy(), s_ref)
    _close(st.numpy(), _fold(st_ref))


@pytest.mark.parametrize("kind", ["et", "it"])
def test_t_stage_twin_matches_pallas_t_stage(kind):
    r = np.random.default_rng(2)
    tin = Tp if kind == "et" else 2 * M1
    y = r.normal(size=(B * tin, Y, 2 * C)).astype(np.float32)
    ref = jfl.t_stage(jnp.asarray(y), kind, Tp, M1, "mxu", True)
    got = tfl.t_stage(_t(y), kind, Tp, M1)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("impl", ["fused_fno_layer", "reference_fused_fno_layer"])
@pytest.mark.parametrize("act", ["none", "exact"])
def test_layer_matches_jax_fused_and_reference(impl, act):
    d = _inputs(3)
    jargs = tuple(jnp.asarray(v) for v in (
        d["x"], d["a"][None], d["b"][None], d["wr"], d["wi"], d["wp"],
        d["bp"][None]))
    targs = tuple(_t(d[k]) for k in ("x", "a", "b", "wr", "wi", "wp", "bp"))
    s, st = getattr(tfl, impl)(*targs, dims=DIMS, act=act)
    s_f, st_f = jfl.fused_fno_layer(*jargs, dims=DIMS, act=act, interpret=True)
    s_r, st_r = jfl.reference_fused_fno_layer(*jargs, dims=DIMS, act=act)
    for s_ref, st_ref in ((s_f, st_f), (s_r, st_r)):
        _close(s.numpy(), s_ref)
        _close(st.numpy(), _fold(st_ref))


def test_layer_rejects_wrong_layout():
    d = _inputs()
    args = [_t(d[k]) for k in ("x", "a", "b", "wr", "wi", "wp", "bp")]
    with pytest.raises(ValueError, match="expected"):
        tfl.fused_fno_layer(*args, dims=(B, Tp, Hp, Wp + 2, C), act="none")


def test_routes_by_device_without_fallback():
    """A CPU tensor takes the twin; a device with no route raises; the
    kernel wrappers refuse CPU tensors before building anything."""
    d = _inputs()
    x = _t(d["x"])
    y = tfl.k1(x, _t(d["a"]), _t(d["b"]), Hp=Hp, Wp=Wp, m2=M2, m3=M3,
               act="none")
    assert y.device.type == "cpu" and y.shape == (B * Tp, Y, 2 * C)
    with pytest.raises(ValueError, match="no route"):
        tfl._use_kernel(x.to("meta"))
    with pytest.raises(ValueError, match="CUDA kernel given a tensor on cpu"):
        kernels.t_stage(_t(d["g"]), *map(_t, tfl.tstage_mats("et", Tp, M1)))
