"""PyTorch port vs JAX package: FNO3d training.

1. Train mode: the loss with a target, every parameter gradient and the
   BatchNorm running-statistics update of the port's FNO3d (kernels' twins,
   and the plain oracle with reference=True) against JAX's
   FNO3d(use_pallas=True, pallas_interpret=True) applied with
   mutable=["batch_stats"], at the dims of tests/test_pallas_fno_tail.py.
2. Trajectory: 3 updates of the port's make_train_step against JAX's
   make_train_step on the same batches, with a Gaussian normalizer inside
   the step, for the cosine and step schedules, clipping on and off and
   grad_accum 1 and 2: the loss of every step and the parameters and
   running statistics after.

All f32; tolerance rtol 2e-4 with atol 2e-4·max|ref|, except where the
true gradient is 0 or too small for the tolerance to fix its sign:

* the pointwise conv biases ``convs.i.bias``, which the BatchNorm after each
  layer cancels: both frameworks return float noise. Their gradient is held
  to 1e-5 of the largest gradient of the same layer's pointwise weight;
* in the trajectory, Adam divides each update by the gradient's own size,
  so an entry whose true gradient is 0 steps by up to lr in a direction the
  gradient's float noise decides. Those entries are chosen by rule, not by
  size: the conv biases, and the imaginary part of the DC mode's spectral
  weight (``weights1[..., 0, 0, 0]``: the input's DC coefficient is real and
  the inverse rfft drops the imaginary part of the output's). Besides
  those, an entry whose first gradient happens to lie below the float
  noise (|g| < 1e-5·max|g| of its tensor; of its mode, for a spectral
  weight, whose gradient falls by orders of magnitude from low to high
  modes) has no step direction either framework can fix. At most 1% of a
  tensor may be such an entry (0.26% at most here, 2 of fc2's 768), and
  the test says how many there were if that cap is broken. These entries
  are held to Adam's bound instead: after n updates each framework has
  moved them by at most n·lr (1% slack for Adam's bias corrections).
  Every other entry is held to the default tolerance;
* the BatchNorm running means take in the conv bias, which the
  normalisation cancels. They are held to the default tolerance after the
  first update, when both frameworks ran the same forward on the same
  parameters, and after n updates to atol 2e-4·max|ref| + 2·n·lr, the most
  by which the biases can differ. The running variances do not see the
  bias and keep the default tolerance throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.models.fno import FNO3d as JFNO3d
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import fno_state_dict
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import (
    build_optimizer,
    build_schedule,
    make_train_step,
)
from tests.test_torch_fno_tail import (
    KW,
    SI,
    SO,
    np_tree,
    port_model,
    randomized_variables,
)

B = 2
STEPS, LR = 3, 1e-3


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _is_conv_bias(name):
    return name.startswith("convs.") and name.endswith(".bias")


def _zero_grad_mask(name, shape):
    """Entries whose true gradient is 0, on the real view of the parameter
    (complex → trailing [re, im] axis)."""
    mask = np.full(shape, _is_conv_bias(name))
    if name.startswith("spectral_convs.") and name.endswith(".weights1"):
        mask[:, :, 0, 0, 0, 1] = True      # imag of the (0, 0, 0) mode
    return mask


@pytest.mark.parametrize("reference", [False, True], ids=["kernels", "reference"])
def test_train_mode_matches_jax(monkeypatch, reference):
    monkeypatch.setenv("REALPDEBENCH_GELU", "exact")
    r = np.random.default_rng(10)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *SO)).astype(np.float32)
    jm = JFNO3d(**KW, shape_in=SI, shape_out=SO, use_pallas=True,
                pallas_interpret=True)
    v = randomized_variables(jm, jnp.asarray(x), 11)

    def jloss(p):
        return jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                        jnp.asarray(x), y=jnp.asarray(y), train=True,
                        mutable=["batch_stats"])

    (jl, jstate), jg = jax.value_and_grad(jloss, has_aux=True)(v["params"])
    m = port_model(v).train()
    loss = m(torch.from_numpy(x), y=torch.from_numpy(y), reference=reference)
    loss.backward()
    _close(loss.item(), float(jl))
    want = fno_state_dict(np_tree(jg), np_tree(jstate["batch_stats"]))
    grads = dict(m.named_parameters())
    for name, p in grads.items():
        if _is_conv_bias(name):
            scale = grads[name.replace("bias", "weight")].grad.abs().max()
            assert p.grad.abs().max() <= 1e-5 * scale, name
            assert np.abs(want[name].numpy()).max() <= 1e-5 * scale, name
        else:
            _close(p.grad.numpy(), want[name].numpy())
    for name, buf in m.named_buffers():
        if "running" in name:
            _close(buf.numpy(), want[name].numpy())


@pytest.mark.parametrize("sched", ["cosine", "step"])
def test_schedules_match_optax(sched):
    cfg = dict(lr=3e-3, scheduler=sched, num_update=7, step_size=3)
    want = jts.build_schedule(Config(**cfg))
    got = build_schedule(cfg)
    for count in range(10):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("clip", [0.0, 0.05], ids=["noclip", "clip"])
@pytest.mark.parametrize("sched", ["cosine", "step"])
def test_train_step_trajectory_matches_jax(monkeypatch, sched, clip, grad_accum):
    run_trajectory(monkeypatch, sched, clip, grad_accum)


def run_trajectory(monkeypatch, sched, clip, grad_accum, jmesh_ctx=None, tmesh_ctx=None):
    """3 steps of the port's make_train_step against JAX's from the same
    weights and batches (the checks the module's docstring lists). Without
    mesh contexts both compose their microbatches of consecutive rows; with
    them (``tests/test_torch_mesh.py``) both stride them, as the loops'
    steps do."""
    monkeypatch.setenv("REALPDEBENCH_GELU", "exact")
    cfg = dict(lr=LR, scheduler=sched, num_update=4, step_size=2,
               clip_grad_norm=clip)
    kw = dict(model_name="fno", **KW)
    del kw["padding"]                       # the registry's default, 6
    r = np.random.default_rng(20)
    xs = r.normal(size=(STEPS, 2 * B, *SI)).astype(np.float32)
    ys = r.normal(size=(STEPS, 2 * B, *SO)).astype(np.float32)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2.0, 3), std_targets=r.uniform(0.5, 2.0, 3))
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    # a mean of its own for every sample: the BatchNorm after each layer
    # cancels the batch mean of what the (0, 0, 0) mode adds, so with i.i.d.
    # fields alone that mode's real weights would get only a near-zero
    # gradient, in which float noise decides Adam's step
    offsets = r.normal(size=(STEPS, 2 * B) + (1,) * (len(SI) - 1) + (SI[-1],))
    xs += offsets.astype(np.float32)

    jb = jbuild(shapes=(SI, SO), **kw)
    v = randomized_variables(jb.module, jnp.asarray(xs[0, :1]), 21)
    vp = np_tree(v["params"])
    init = fno_state_dict(vp, np_tree(v["batch_stats"]))
    params, ms = jb.split_variables(v)      # the JAX step donates these
    state = jts.TrainState.create(params, ms, jts.build_optimizer(Config(**cfg)))
    jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats),
                                jmesh_ctx, grad_accum=grad_accum)
    jlosses = []
    for i in range(STEPS):
        state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                          jax.random.PRNGKey(i))
        jlosses.append(float(jl))
        if i == 0:
            jfirst = np_tree(state.model_state["batch_stats"])

    model = build_model(shapes=(SI, SO), device="cpu", **kw)
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, tnorm.build_normalizer("gaussian", stats=stats),
                           opt, grad_accum=grad_accum, mesh=tmesh_ctx)
    real = lambda a: np.stack([a.real, a.imag], -1) if np.iscomplexobj(a) else a
    losses, tiny = [], {}
    for i in range(STEPS):
        losses.append(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item())
        if i == 0:
            first = fno_state_dict(vp, jfirst)
            for name, buf in model.named_buffers():
                if "running" in name:
                    _close(buf.numpy(), first[name].numpy())
            for name, p in model.named_parameters():
                g = np.abs(real(p.grad.numpy()))
                # a spectral weight's gradient falls by orders of magnitude
                # from low to high modes: scale each mode by its own largest
                scale = g.max(axis=(0, 1), keepdims=True) if p.is_complex() else g.max()
                tiny[name] = g < 1e-5 * scale
    _close(losses, jlosses)

    want = fno_state_dict(np_tree(state.params),
                          np_tree(state.model_state["batch_stats"]))
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = real(t.numpy()), real(want[name].numpy())
        if name.endswith("running_mean"):
            np.testing.assert_allclose(
                got, ref, rtol=2e-4,
                atol=2e-4 * np.abs(ref).max() + 2 * STEPS * LR, err_msg=name)
            continue
        if name in tiny:                    # a parameter
            zero = _zero_grad_mask(name, got.shape)
            n_tiny = int((tiny[name] & ~zero).sum())
            assert n_tiny <= 1e-2 * got.size, \
                f"{name}: {n_tiny} of {got.size} first gradients below the noise"
            mask, p0 = zero | tiny[name], real(init[name].numpy())
            for moved in (got - p0, ref - p0):
                assert np.abs(moved[mask]).max(initial=0) <= 1.01 * STEPS * LR, name
            got = np.where(mask, ref, got)
        _close(got, ref)


def test_train_step_refuses_an_indivisible_batch():
    model = build_model(shapes=(SI, SO), model_name="fno", device="cpu", **KW)
    opt = build_optimizer(dict(lr=1e-3, num_update=10), model.parameters())
    step = make_train_step(model, tnorm.IdentityNormalizer(), opt, grad_accum=2)
    x, y = torch.zeros(3, *SI), torch.zeros(3, *SO)
    with pytest.raises(ValueError, match="not divisible"):
        step(x, y)
