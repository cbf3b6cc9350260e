"""PyTorch port vs JAX package: FNO3d weights, strict loading, eval forward.

JAX parameters and BN statistics are randomized (the init ones are all 0/1
and would not prove the key mapping), carried by the port's
interop/from_jax.py, loaded with strict=True, and both forwards run on the
same numpy input in f32. Tolerance: rtol 2e-4 with atol 2e-4·max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.interop.torch_export import export_fno
from realpdebench_tpu.models.fno import FNO3d as JFNO3d
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu_torch.interop.from_jax import fno_state_dict
from realpdebench_tpu_torch.models.fno import FNO3d
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.utils.misc import make_generator

SI = SO = (4, 12, 12, 3)
KW = dict(modes1=2, modes2=3, modes3=3, n_layers=2, width=8)


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _jax_variables(seed=0):
    """Init a JAX FNO3d, then give every leaf seeded random values of the
    right sign (variances positive)."""
    m = JFNO3d(**KW, shape_in=SI, shape_out=SO, use_pallas=False)
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((1, *SI)), train=False)
    r = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        a = np.asarray(leaf)
        if "'var'" in name:
            return r.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if "'scale'" in name:
            return (1.0 + 0.2 * r.normal(size=a.shape)).astype(a.dtype)
        if "w_real" in name or "w_imag" in name:
            return (0.05 * r.normal(size=a.shape)).astype(a.dtype)
        return (0.3 * r.normal(size=a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(fill, v)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _port_model(variables, dtype=torch.float32):
    m = FNO3d(**KW, shape_in=SI, shape_out=SO, compute_dtype=dtype)
    m.load_state_dict(fno_state_dict(_np_tree(variables["params"]),
                                     _np_tree(variables["batch_stats"])),
                      strict=True)
    return m.eval()


def test_from_jax_equals_exporter():
    v = _np_tree(_jax_variables())
    ref = export_fno(v["params"], {"batch_stats": v["batch_stats"]})
    got = fno_state_dict(v["params"], v["batch_stats"])
    assert sorted(got) == sorted(ref)
    for k, t in got.items():
        assert tuple(t.shape) == np.shape(ref[k]), k
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref[k]), err_msg=k)


def test_port_state_dict_has_exporter_names():
    v = _np_tree(_jax_variables())
    ref = export_fno(v["params"], {"batch_stats": v["batch_stats"]})
    sd = FNO3d(**KW, shape_in=SI, shape_out=SO).state_dict()
    assert sorted(sd) == sorted(ref)
    for k, t in sd.items():
        assert tuple(t.shape) == np.shape(ref[k]), k
        assert t.dtype == torch.from_numpy(np.asarray(ref[k])).dtype, k


@pytest.mark.parametrize("use_pallas", [False, True])
def test_eval_forward_matches_jax(monkeypatch, use_pallas):
    monkeypatch.setenv("REALPDEBENCH_GELU", "exact")
    v = _jax_variables(1)
    x = np.random.default_rng(2).normal(size=(2, *SI)).astype(np.float32)
    jm = JFNO3d(**KW, shape_in=SI, shape_out=SO, use_pallas=use_pallas,
                pallas_interpret=True, remat=False)
    ref = jm.apply(v, jnp.asarray(x), train=False)
    m = _port_model(v)
    got = m.predict(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)
    # the plain oracle path of the same module agrees too
    with torch.no_grad():
        _close(m(torch.from_numpy(x), reference=True).numpy(), ref)
        # and the eval loss is the bundle's MSE
        y = np.random.default_rng(3).normal(size=ref.shape).astype(np.float32)
        jloss, _ = jbuild(shapes=(SI, SO), model_name="fno", **KW,
                          use_pallas=False).loss(v, jnp.asarray(x),
                                                 jnp.asarray(y), None,
                                                 train=False)
        _close(m.loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
               jloss)


def test_time_interleaved_output_permutation():
    """T_out = 2*T_in: fc2 emits c_out*mult features, interleaved in time
    exactly as the JAX module does."""
    so = (8, 12, 12, 2)
    jm = JFNO3d(**KW, shape_in=SI, shape_out=so, use_pallas=False)
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, *SI)), train=False)
    x = np.random.default_rng(4).normal(size=(1, *SI)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x), train=False)
    m = FNO3d(**KW, shape_in=SI, shape_out=so)
    m.load_state_dict(fno_state_dict(_np_tree(v["params"]),
                                     _np_tree(v["batch_stats"])), strict=True)
    _close(m.predict(torch.from_numpy(x)).numpy(), ref)


def test_build_model_takes_jax_registry_kwargs():
    cfg = dict(model_name="fno", **KW, compute_dtype="bfloat16", remat=False,
               use_pallas=None)
    jb = jbuild(shapes=(SI, SO), **cfg)
    v = jb.init(jax.random.PRNGKey(0), np.zeros((1, *SI), np.float32))
    ref = export_fno(_np_tree(v["params"]),
                     {"batch_stats": _np_tree(v["batch_stats"])})
    m = build_model(shapes=(SI, SO), generator=make_generator(0), device="cpu",
                    **cfg)
    assert isinstance(m, FNO3d) and m.compute_dtype == torch.bfloat16
    sd = m.state_dict()
    assert {k: tuple(t.shape) for k, t in sd.items()} == {
        k: np.shape(a) for k, a in ref.items()}
    # every family of the JAX registry builds, WDNO among them
    wdno = build_model(shapes=(SI, SO), model_name="wdno", dim=8, device="cpu")
    assert type(wdno).__name__ == "WDNO" and wdno.model.compute_dtype == torch.float32
    with pytest.raises(ValueError, match="not supported"):
        build_model(shapes=(SI, SO), model_name="nope", device="cpu")


def test_build_model_defaults_to_the_card_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(model_name="fno", **KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(shapes=(SI, SO), **kw)
    assert next(build_model(shapes=(SI, SO), device="cpu", **kw).parameters()).is_cpu


def test_init_is_seeded_and_follows_jax_distributions():
    mk = lambda s: FNO3d(**KW, shape_in=SI, shape_out=SO,
                         generator=make_generator(s))
    a, b, c = mk(0).state_dict(), mk(0).state_dict(), mk(1).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["fc0.weight"], c["fc0.weight"])
    w = a["spectral_convs.0.weights1"]
    assert w.dtype == torch.complex64
    for part in (w.real, w.imag):    # U[0,1) / (C_in * C_out)
        assert part.min() >= 0 and part.max() < 1.0 / 64
    assert torch.equal(a["bns.0.running_var"], torch.ones(8))
    assert torch.equal(a["fc1.bias"], torch.zeros(128))
    # lecun normal truncated at 2 std: |w| <= 2 * sqrt(1/fan_in) / 0.8796
    big = FNO3d(modes1=2, modes2=3, modes3=3, n_layers=1, width=64,
                shape_in=SI, shape_out=SO, generator=make_generator(2))
    w1 = big.fc1.weight
    bound = 2 * (1 / 64) ** 0.5 / 0.87962566103423978
    assert w1.abs().max() <= bound + 1e-6
    assert abs(w1.var().item() * 64 - 1.0) < 0.1


def test_training_mode_is_refused():
    """Train mode runs the forward on batch statistics and moves the running
    statistics; like eval mode, it refuses a grid the packed layout cannot
    take (odd W), before computing anything."""
    m = FNO3d(**KW, shape_in=SI, shape_out=SO)
    before = m.bns[0].running_mean.clone()
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, *SI)).astype(np.float32))
    assert m(x).shape == (1, *SO)
    assert not torch.equal(m.bns[0].running_mean, before)
    with pytest.raises(ValueError, match="even W"):
        m(torch.zeros(1, 4, 12, 11, 3))
    assert m.predict(torch.zeros(1, *SI)).shape == (1, *SO)
    assert m.training  # predict restores the mode it found
