"""PyTorch port vs JAX package at the other scenarios' own windows (CPU, f32).

The shipped scenario configs run their models at windows the cylinder's
tests do not reach: controlled_cylinder's T 10 with 5 input channels (its
two parameter planes) and 3 output channels, re-injected after each
rollout step (``para_c`` 2); fsi's and combustion's square 64×64 frames.
Here each kernel-carrying family, and the kernel-free families whose
layers take T apart, runs at its scenario's T and channel counts, at
narrow widths and small H and W:

* the FNO at controlled_cylinder's window: T 10 padded to Tp 16, the fused
  tail at F 3;
* the UNet at T 10 (its temporal attention at T 10, one level),
  controlled_cylinder;
* the Galerkin Transformer at H = W (fsi);
* MWT and Transolver at T 10 (controlled_cylinder).

For each: the forward (eval mode), the loss and every parameter gradient
in train mode (and the BatchNorms' running statistics where there are
some), and a 2-step rollout through ``make_rollout_fn`` with a Gaussian
normalizer against the JAX package's host rollout
(``realpdebench_tpu.eval.rollout.make_host_rollout_fn``, the same
semantics as its compiled scan), at rtol 2e-4 with atol 2e-4·max|ref|.
The JAX weights come from the port's seeded weights, perturbed by seeded
numpy noise (BatchNorm statistics too), through the JAX package's
``interop.torch_convert``. A gradient tensor whose reference is a true zero
(a conv bias a BatchNorm or a one-channel GroupNorm cancels) is held on
both sides to 1e-5 of the model's largest gradient instead. The GK's dropout masks are injected on both sides
(``tests/test_torch_galerkin.Masks``). Torch runs on one intra-op thread.
WDNO at T 8 is ``tests/test_torch_scenarios_wdno.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_trajectory as tt
from test_torch_galerkin import Masks

from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.eval.rollout import make_host_rollout_fn as jrollout
from realpdebench_tpu.interop import torch_convert as tcv
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.eval.rollout import make_rollout_fn
from realpdebench_tpu_torch.models import base as tbase
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.utils.misc import make_generator

B, STEPS = 2, 2
CONTROLLED = ((10, 8, 8, 5), (10, 8, 8, 3))
# name: (window in, window out, the config's model keys at narrow widths)
CASES = {
    "fno_controlled_tp16_f3": (*CONTROLLED, dict(
        model_name="fno", modes1=2, modes2=3, modes3=3, n_layers=2, width=8,
        use_pallas=False, remat=False)),
    "unet_controlled_t10": (*CONTROLLED, dict(model_name="unet", dim_mults=[1],
                                              remat=False)),
    "gk_fsi_square": ((4, 8, 8, 3), (4, 8, 8, 3), dict(
        model_name="galerkin_transformer", n_hidden=16, num_encoder_layers=1, n_head=2,
        dim_feedforward=16, layer_norm=False, norm_eps=1e-7, fourier_modes_x=3,
        fourier_modes_y=3, fourier_modes_t=2, num_regressor_layers=1, freq_dim=8,
        encoder_dropout=0.05, xavier_init=1e-2, diagonal_weight=1e-2)),
    "mwt_controlled_t10": ((10, 8, 16, 5), (10, 8, 16, 3), dict(
        model_name="mwt", k=3, alpha=3, c=2, nCZ=1, L=0, base="legendre")),
    "transolver_controlled_t10": ((10, 8, 16, 5), (10, 8, 16, 3), dict(
        model_name="transolver", space_dim=5, n_layers=1, n_hidden=16, n_head=2, H=8,
        W=16, D=10, fun_dim=0, out_dim=3, ref=4, mlp_ratio=2, slice_num=4)),
}
CONVERT = {"fno": tcv.convert_fno, "unet": tcv.convert_unet, "wdno": tcv.convert_unet,
           "galerkin_transformer": tcv.convert_galerkin, "mwt": tcv.convert_mwt,
           "transolver": tcv.convert_transolver}
ZERO_GRAD = 1e-5        # a true-zero gradient's share of the model's largest


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _perturb(model, seed):
    """Seeded noise on every parameter and BatchNorm statistic."""
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            noise = torch.from_numpy(0.1 * r.normal(size=(*p.shape, 2)).astype(np.float32))
            p.add_(torch.view_as_complex(noise) if p.is_complex() else noise[..., 0])
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(0.1 * r.normal(size=b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(r.uniform(0.5, 2.0, size=b.shape)))
    return model


def _pair(si, so, kw):
    """(port model, JAX bundle, JAX variables) with the same weights."""
    name = kw["model_name"]
    m = _perturb(build_model(shapes=(si, so), device="cpu", generator=make_generator(0),
                             **kw), 100)
    sd = {k: _np(v).copy() for k, v in m.state_dict().items()}
    if name == "wdno":          # the denoiser's weights; the schedule is the config's
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    params, state = CONVERT[name](sd, None, {})
    v = jax.tree_util.tree_map(jnp.asarray, {"params": params, **state})
    return m, jbuild(shapes=(si, so), **kw), v


def _normalizers(kw, si, so):
    name = kw.get("normalizer", "gaussian")
    r = np.random.default_rng(7)
    stats = None if name == "none" else dict(
        mean_inputs=r.normal(size=si[-1]).astype(np.float32),
        std_inputs=r.uniform(0.5, 2.0, si[-1]).astype(np.float32),
        mean_targets=r.normal(size=so[-1]).astype(np.float32),
        std_targets=r.uniform(0.5, 2.0, so[-1]).astype(np.float32))
    return jnorm.build_normalizer(name, stats=stats), tnorm.build_normalizer(name, stats=stats)


def _grads_vs_jax(m, jb, v, jgrads):
    """Every port gradient against the JAX one of the same parameter (its
    torch name from the JAX exporter)."""
    state = {k: w for k, w in v.items() if k != "params"}
    want = {k: tt.real(np.asarray(g))
            for k, g in export_torch_state_dict(jb, jgrads, state).items()}
    got = {n: tt.real(_np(p.grad)) for n, p in m.named_parameters()}
    scale = max(np.abs(g).max() for g in want.values() if g.size)
    for name, g in got.items():
        ref = want[name]
        if np.abs(ref).max() <= ZERO_GRAD * scale:
            assert np.abs(g).max() <= ZERO_GRAD * scale, name
            continue
        tt.close(g, ref, msg=name)


@pytest.mark.parametrize("case", tuple(CASES))
def test_forward_gradients_and_rollout_match_jax(case):
    si, so, kw = CASES[case]
    m, jb, v = _pair(si, so, kw)
    r = np.random.default_rng(11)
    x = r.normal(size=(B, *si)).astype(np.float32)
    y = r.normal(size=(B, *so)).astype(np.float32)
    y_roll = r.normal(size=(B, STEPS * so[0], *so[1:])).astype(np.float32)
    para_c = si[-1] - so[-1]
    jn, tn = _normalizers(kw, si, so)
    key = jax.random.PRNGKey(3)

    # the forward in eval mode
    tt.close(_np(m.predict(torch.from_numpy(x))), jb.predict(v, jnp.asarray(x)),
             msg="forward")
    # a 2-step rollout, the parameter planes re-injected
    jpred = jrollout(jb, jn, STEPS, para_c)(v, jnp.asarray(x), jnp.asarray(y_roll), key)[0]
    tpred = make_rollout_fn(m, tn, STEPS, para_c)(torch.from_numpy(x),
                                                   torch.from_numpy(y_roll))[0]
    assert tuple(tpred.shape) == (B, STEPS * so[0], *so[1:])
    tt.close(_np(tpred), np.asarray(jpred), msg="rollout")
    # the loss and every gradient in train mode (and the statistics after)
    # the same seeded dropout masks on both sides (the GK's encoder)
    masks = Masks(17)
    with masks:
        (jl, new_state), jg = jax.jit(jax.value_and_grad(
            lambda p: jb.loss({**v, "params": p}, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(0), train=True), has_aux=True))(v["params"])
    m.train()
    m.zero_grad()
    with mock.patch.object(tbase, "dropout_mask", masks.torch_mask):
        tl = m(torch.from_numpy(x), y=torch.from_numpy(y))
    tl.backward()
    assert masks.n_torch == masks.n_jax
    tt.close(tl.item(), float(jl), msg="loss")
    _grads_vs_jax(m, jb, v, jg)
    if new_state:
        stats = export_torch_state_dict(jb, v["params"], new_state)
        for bname, buf in m.named_buffers():
            if "running" in bname:
                tt.close(_np(buf), np.asarray(stats[bname]), msg=bname)


def test_chip_smoke_holds_deeponet_to_float64_on_its_relu_sides_and_pool_picks():
    """The float64 bar of chip_smoke.py's scenarios phase for DeepONet
    (``Kinks("deeponet")``): the pass that records the ReLUs' sides and the
    max pools' picks is the plain float32 pass bit for bit, and the float64
    copy replaying them sits within F32_LIMITS; replayed picks steer the
    float64 pools (moving one window's pick moves the gradients past the
    limits)."""
    import chip_smoke as cs

    si, so = (10, 8, 16, 5), (10, 8, 16, 3)
    m = _perturb(build_model(shapes=(si, so), device="cpu", generator=make_generator(0),
                             model_name="deeponet", p=16, dropout_rate=0.1), 100)
    ref = cs._f64_copy(m)
    r = np.random.default_rng(5)
    x, y = (torch.from_numpy(r.normal(size=(B, *s)).astype(np.float32)) for s in (si, so))
    cmp = cs._f32_vs_f64("deeponet", "deeponet", "deeponet", m, ref, x, y)
    assert cmp["recording_pass_bit_equal"] and cmp["kinks_replayed"] == 12
    assert cmp["worst_grad_rel_l2"] <= cs.F32_LIMITS[1]
    kinks = cs.Kinks("deeponet")
    with kinks.record():
        got = cs._family_pass(m, x, y)
    pick = next(k for k in kinks.sides if k.dtype == torch.int64)
    first = (0,) * pick.dim()
    pick[first] = pick[first] ^ 1                    # another element of its window
    with kinks.replay():
        moved = cs._family_pass(ref, x, y)
    with pytest.raises(AssertionError, match="step vs its reference"):
        cs._family_vs("deeponet", "deeponet", got, moved, cs.F32_LIMITS)


def test_chip_smoke_floors_a_gradient_norm_at_a_share_of_the_largest():
    """The scenarios phase's float64 bar for the kernel-free families
    (``chip_smoke.SCENARIO_GRAD_FLOOR``): a gradient whose norm is far below
    the model's largest is held to 1e-4 of the floored norm, so a
    cancelling sum's f32 rounding (relative error 1e-3 on a gradient 1e-7
    of the largest) passes, while 2% off on a gradient 1e-4 of the largest,
    or 2e-4 off on the largest, misses; without the floor the first misses
    too."""
    import chip_smoke as cs

    r = np.random.default_rng(3)
    big, small, mid = (torch.from_numpy(r.normal(size=n)) for n in (1000, 50, 200))
    small, mid = small * 1e-7 * big.norm() / small.norm(), mid * 1e-4 * big.norm() / mid.norm()
    ref = (torch.tensor(1.0), dict(a=big, b=small, c=mid), {})
    vs = lambda g, floor: cs._family_vs("x", "transolver", (torch.tensor(1.0), g, {}), ref,
                                        cs.F32_LIMITS, grad_floor=floor)
    noisy = dict(a=big, b=small * (1 + 1e-3 * torch.from_numpy(r.normal(size=50))), c=mid)
    vs(noisy, cs.SCENARIO_GRAD_FLOOR)
    with pytest.raises(AssertionError, match=r"\['b'\]"):
        vs(noisy, 0.0)
    with pytest.raises(AssertionError, match=r"\['c'\]"):
        vs(dict(a=big, b=small, c=mid * 1.02), cs.SCENARIO_GRAD_FLOOR)
    with pytest.raises(AssertionError, match=r"\['a'\]"):
        vs(dict(a=big * (1 + 2e-4), b=small, c=mid), cs.SCENARIO_GRAD_FLOOR)
