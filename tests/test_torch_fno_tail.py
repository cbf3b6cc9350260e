"""PyTorch port vs JAX package: the fused FNO tail + loss (K3F, K3B).

On the CPU the port's K3F and K3B run their plain twins. JAX's K3 kernels
need its aligned layout, so the twins are held against them through the
module loss: the port's FNO3d with a target against JAX's
FNO3d(use_pallas=True, pallas_interpret=True) with the same target, whose
tail then runs K3F/K3B (tests/test_pallas_fno_tail.py), at that file's dims
(time multiplier 2, so the target's time interleave is exercised). All f32;
tolerance rtol 2e-4 with atol 2e-4·max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from realpdebench_tpu.models.fno import FNO3d as JFNO3d
from realpdebench_tpu_torch.interop.from_jax import fno_state_dict
from realpdebench_tpu_torch.models.fno import FNO3d
from realpdebench_tpu_torch.ops import fno_tail as ft

B, T, H, W, CIN = 2, 3, 10, 12, 3
COUT, MULT = 3, 2
SI, SO = (T, H, W, CIN), (T * MULT, H, W, COUT)
KW = dict(modes1=2, modes2=3, modes3=4, n_layers=2, width=8, padding=6)


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def randomized_variables(module, x, seed):
    """Init a JAX FNO3d, then give every leaf seeded random values of the
    right sign (the init's zeros and ones would hide a mapping error)."""
    v = module.init(jax.random.PRNGKey(0), x, train=False)
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

    return jax.tree_util.tree_map(jnp.asarray,
                                  jax.tree_util.tree_map_with_path(fill, v))


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def port_model(variables, si=SI, so=SO, kw=KW):
    m = FNO3d(**kw, shape_in=si, shape_out=so)
    m.load_state_dict(fno_state_dict(np_tree(variables["params"]),
                                     np_tree(variables["batch_stats"])),
                      strict=True)
    return m


def _tail_inputs(seed, C=8, F_=6, pad=(2, 3, 4)):
    r = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.from_numpy((sc * r.normal(size=s)).astype(np.float32))
    Tp, Hp, Wp = T + pad[0], H + pad[1], W + pad[2]
    dims = (B, Tp, Hp, Wp, C)
    s = t(B * Tp, Hp * Wp // 2, 2 * C)
    weights = [t(C, 128, sc=0.3), t(128, sc=0.1), t(128, F_, sc=0.1), t(F_, sc=0.1)]
    return s, t(B, T, H, W, F_), weights, dims


@pytest.mark.parametrize("act", ["exact", "tanh"])
def test_k3_twins_match_autograd_of_the_plain_tail(act):
    """K3F's SSE and K3B's (ds, dk1, db1, dk2, db2) against autograd through
    crop → fc1 → GELU → fc2 → SSE in plain torch, on an uneven crop."""
    s, target, weights, dims = _tail_inputs(0)
    leaves = [s.requires_grad_()] + [w.requires_grad_() for w in weights]
    sse = ft.fused_tail_loss(s, target, *weights, dims=dims, tail_dims=(T, H, W),
                             act=act)
    got = torch.autograd.grad(0.37 * sse, leaves)
    k1, b1, k2, b2 = weights
    z = s.view(*dims)[:, :T, :H, :W]
    o = F.gelu(z @ k1 + b1, approximate="tanh" if act == "tanh" else "none") @ k2 + b2
    ref_sse = ((o - target) ** 2).sum()
    want = torch.autograd.grad(0.37 * ref_sse, leaves)
    _close(sse.item(), ref_sse.item())
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())
    ds = got[0].view(*dims)
    assert ds[:, T:].abs().max() == 0 and ds[:, :, H:].abs().max() == 0
    assert ds[:, :, :, W:].abs().max() == 0


def test_fused_tail_loss_rejects_mismatched_shapes():
    s, target, weights, dims = _tail_inputs(1)
    with pytest.raises(ValueError, match="do not fit"):
        ft.fused_tail_loss(s, target[:, :-1], *weights, dims=dims,
                           tail_dims=(T, H, W), act="exact")


@pytest.mark.parametrize("reference", [False, True], ids=["kernels", "reference"])
def test_module_loss_and_grads_match_jax_k3(monkeypatch, reference):
    """Eval-mode loss with a target, and its gradient in every parameter:
    the port's fused tail (or, with reference=True, its plain tail) against
    JAX's module loss through K3F/K3B."""
    monkeypatch.setenv("REALPDEBENCH_GELU", "exact")
    r = np.random.default_rng(2)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *SO)).astype(np.float32)
    jm = JFNO3d(**KW, shape_in=SI, shape_out=SO, use_pallas=True,
                pallas_interpret=True)
    v = randomized_variables(jm, jnp.asarray(x), 3)

    def jloss(p):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                        jnp.asarray(x), y=jnp.asarray(y), train=False)

    jl, jg = jax.value_and_grad(jloss)(v["params"])
    m = port_model(v).eval()
    loss = m(torch.from_numpy(x), y=torch.from_numpy(y), reference=reference)
    loss.backward()
    _close(loss.item(), float(jl))
    want = fno_state_dict(np_tree(jg), np_tree(v["batch_stats"]))
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), want[name].numpy())


def test_loss_is_the_mse_of_the_prediction():
    """The fused loss un-interleaves the time-multiplied target exactly as
    the prediction is interleaved: loss(x, y) == mse(predict(x), y)."""
    jm = JFNO3d(**KW, shape_in=SI, shape_out=SO, use_pallas=False)
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.normal(size=(B, *SI)).astype(np.float32))
    y = torch.from_numpy(r.normal(size=(B, *SO)).astype(np.float32))
    m = port_model(randomized_variables(jm, jnp.asarray(x.numpy()), 5)).eval()
    with torch.no_grad():
        _close(m.loss(x, y).item(), ((m.predict(x) - y) ** 2).mean().item())


def test_module_loss_and_grads_match_jax_k3_at_width_128(monkeypatch):
    """The same at the fsi config's width, 128 (the tail kernels' widest C):
    the port's fused tail twins against JAX's module loss and gradients."""
    monkeypatch.setenv("REALPDEBENCH_GELU", "exact")
    kw = dict(KW, width=128, n_layers=1)
    r = np.random.default_rng(6)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *SO)).astype(np.float32)
    jm = JFNO3d(**kw, shape_in=SI, shape_out=SO, use_pallas=True, pallas_interpret=True)
    v = randomized_variables(jm, jnp.asarray(x), 7)

    def jloss(p):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                        jnp.asarray(x), y=jnp.asarray(y), train=False)

    jl, jg = jax.value_and_grad(jloss)(v["params"])
    m = port_model(v, kw=kw).eval()
    loss = m(torch.from_numpy(x), y=torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(jl))
    want = fno_state_dict(np_tree(jg), np_tree(v["batch_stats"]))
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), want[name].numpy())


@pytest.mark.parametrize("c_in, c_out, mult", [(16, 16, 1), (3, 3, 3)], ids=["F16", "F9"])
def test_module_loss_and_grads_match_jax_k3_past_one_n_tile(monkeypatch, c_in, c_out, mult):
    """The same where fc2 is wider than one n-tile of 8 (F = c_out·mult): the
    combustion scenario's 16 channels in and out (F 16), and 3 channels at a
    tripled horizon (F 9)."""
    monkeypatch.setenv("REALPDEBENCH_GELU", "exact")
    si, so = (T, H, W, c_in), (T * mult, H, W, c_out)
    r = np.random.default_rng(8)
    x = r.normal(size=(B, *si)).astype(np.float32)
    y = r.normal(size=(B, *so)).astype(np.float32)
    jm = JFNO3d(**KW, shape_in=si, shape_out=so, use_pallas=True, pallas_interpret=True)
    v = randomized_variables(jm, jnp.asarray(x), 9)

    def jloss(p):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                        jnp.asarray(x), y=jnp.asarray(y), train=False)

    jl, jg = jax.value_and_grad(jloss)(v["params"])
    m = port_model(v, si=si, so=so).eval()
    assert m.fc2.weight.shape[0] == c_out * mult > 8
    loss = m(torch.from_numpy(x), y=torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(jl))
    want = fno_state_dict(np_tree(jg), np_tree(v["batch_stats"]))
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), want[name].numpy())
