"""PyTorch port vs JAX package: DeepONet (CPU, f32).

1. The whole model at shape (4, 16, 16, 3), where the branch's third max-pool
   window is clamped to the time axis's size 1 and the adaptive pool
   repeats values, and at (4, 16, 16, 3) → (2, 16, 16, 2): the forward in eval
   mode; in train mode the loss, every parameter gradient and the
   BatchNorms' running statistics, with the same dropout masks injected on
   both sides (rate 0.1, three sites); ``load_state_dict(strict=True)`` of
   the JAX package's ``export_torch_state_dict``, equal key for key and
   value for value to the port's ``from_jax.deeponet_state_dict``.
2. A 3-step trajectory of the port's ``make_train_step`` against the JAX
   step (Adam, cosine schedule, Gaussian normalizer inside the step,
   dropout injected).
3. ``build_model`` for the five shipped configs at their scenarios' window
   shapes (construction only): the parameter count equals the JAX init's
   (``jax.eval_shape``); the card is the default device and its absence
   raises.
4. ``python -m realpdebench_tpu_torch train`` then ``eval`` on a synthetic
   tree with ``--device cpu``, from the port's config.

Dropout: both frameworks take the same seeded numpy masks in call order
(``test_torch_galerkin.Masks``: flax's ``nn.Dropout.__call__`` intercepted,
the port's ``models/base.dropout_mask`` patched). The JAX weights come from
the port's seeded weights, perturbed by seeded numpy noise, converted with
the JAX package's ``convert_deeponet``. Tolerance: rtol 2e-4 with atol
2e-4·max|ref|. The branch's conv biases have a true gradient of 0 in train
mode (the BatchNorm after each cancels them): both sides' are held to 1e-5
of their conv weight's largest, and in the trajectory to Adam's bound of
n·lr, as ``tests/test_torch_galerkin.py`` sets out; so are the entries
that ``tests/torch_trajectory.step_noise`` finds to be float noise at any
of the steps (each framework's step replayed in float64 from its own
weights before it, with its batch and dropout masks; at most 1% of a
tensor), which ``tests/torch_trajectory.check_final`` exempts. The
trajectory runs
at the shipped learning rate, 1e-4, and batch 4, where the branch's last
BatchNorm sees 16 values a channel (at batch 2 its gradients' float noise
is 4e-5 relative L2 against float64, at 4 7e-6).
"""

import glob
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_trajectory as tt
from test_torch_galerkin import Masks

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_convert import convert_deeponet
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch import config as tc
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import deeponet_state_dict
from realpdebench_tpu_torch.models import base as tbase
from realpdebench_tpu_torch.models.deeponet import DeepONet
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

SI = SO = (4, 16, 16, 3)
KW = dict(model_name="deeponet", p=16, dropout_rate=0.1)
# batch 4: the branch BatchNorms see 16 values a channel at stage 4; lr
# the shipped configs' 1e-4
B, STEPS, LR = 4, 3, 1e-4
N_MASKS = 3      # dropout draws a train forward: branch, out_fc1, out_fc2

# the scenarios' windows (in, out) at the shipped in/out_step: fluid data
# u, v, p; controlled_cylinder adds its two parameter planes to the input;
# combustion carries 16 channels
WINDOWS = {
    "combustion": ((20, 64, 64, 16), (20, 64, 64, 16)),
    "controlled_cylinder": ((10, 64, 128, 5), (10, 64, 128, 3)),
    "cylinder": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "foil": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "fsi": ((20, 64, 64, 3), (20, 64, 64, 3)),
}


def _close(got, ref, rtol=2e-4, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()), err_msg=msg)


def _np(t):
    return t.detach().cpu().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _perturb(module, seed):
    """Seeded noise on every parameter and BatchNorm statistic."""
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(0.1 * r.normal(size=p.shape).astype(np.float32)))
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(0.1 * r.normal(size=b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(r.uniform(0.5, 2.0, size=b.shape)))
    return module


def _port_model(si=SI, so=SO, seed=0, **kw):
    return _perturb(build_model(shapes=(si, so), device="cpu",
                                generator=make_generator(seed), **{**KW, **kw}), seed + 100)


def _jax_variables(model):
    sd = {k: _np(v).copy() for k, v in model.state_dict().items()}
    params, state = convert_deeponet(sd, None, {})
    return jax.tree_util.tree_map(jnp.asarray, {"params": params, **state})


def _zero_grad(name):
    return name.startswith("branch.conv") and name.endswith(".0.bias")


def _compare_grads(grads, want, msg=""):
    for name, g in grads.items():
        got, ref = _np(g), want[name].numpy()
        if _zero_grad(name):
            scale = np.abs(_np(grads[name[:-4] + "weight"])).max()
            for side in (got, ref):
                assert np.abs(side).max() <= 1e-5 * scale, (msg, name)
            continue
        _close(got, ref, msg=f"{msg}{name}")


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX bundle, JAX variables) with the same weights."""
    m = _port_model()
    return m, jbuild(shapes=(SI, SO), **KW), _jax_variables(m)


def test_export_loads_strict_and_equals_from_jax(pair):
    m, jb, v = pair
    exported = export_torch_state_dict(jb, v["params"], {"batch_stats": v["batch_stats"]})
    mine = deeponet_state_dict(_np_tree(v["params"]), _np_tree(v["batch_stats"]))
    assert set(exported) == set(mine) == set(m.state_dict())
    for k, t in mine.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), t.numpy(), err_msg=k)
    fresh = build_model(shapes=(SI, SO), device="cpu", **KW)
    fresh.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in exported.items()},
                          strict=True)
    for k, t in fresh.state_dict().items():
        np.testing.assert_array_equal(_np(t), _np(m.state_dict()[k]), err_msg=k)


@pytest.mark.parametrize("shapes", [(SI, SO), (SI, (2, 16, 16, 2))], ids=["same", "t_out"])
def test_forward_gradients_and_statistics_match_jax(shapes):
    si, so = shapes
    m = _port_model(si, so, seed=1)
    jb, v = jbuild(shapes=(si, so), **KW), _jax_variables(m)
    r = np.random.default_rng(16)
    x = r.normal(size=(B, *si)).astype(np.float32)
    y = r.normal(size=(B, *so)).astype(np.float32)
    _close(_np(m.predict(torch.from_numpy(x))), jb.module.apply(v, jnp.asarray(x)),
           msg="eval forward")

    def loss(p):
        pred, new = jb.module.apply({"params": p, "batch_stats": v["batch_stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean((pred - y) ** 2), new

    masks = Masks(17)
    with masks:
        (jl, new), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    m.train()
    with mock.patch.object(tbase, "dropout_mask", masks.torch_mask):
        tl = m(torch.from_numpy(x), y=torch.from_numpy(y))
    tl.backward()
    assert masks.n_torch == masks.n_jax == N_MASKS
    _close(tl.item(), float(jl))
    want = deeponet_state_dict(_np_tree(jgrad), _np_tree(new["batch_stats"]))
    _compare_grads({n: p.grad for n, p in m.named_parameters()}, want)
    for name, buf in m.named_buffers():
        if "running" in name:
            _close(_np(buf), want[name].numpy(), msg=name)


def test_dropout_draws_from_the_models_seeded_stream():
    m = _port_model().train()
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(B, *SI)).astype(np.float32))
    state = torch.get_rng_state()
    m.reseed_dropout(4)
    a = m(x)
    b = m(x)
    m.reseed_dropout(4)
    c = m(x)
    assert torch.equal(torch.get_rng_state(), state)     # never the global RNG
    assert not torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(m.predict(x), m.predict(x))
    # dropout_rate 0 (the JAX registry's default) draws nothing
    z = _port_model(dropout_rate=0.0).train()
    with mock.patch.object(tbase, "dropout_mask", side_effect=AssertionError):
        z(x)


def test_train_step_trajectory_matches_jax(pair):
    m0, jb, v = pair
    cfg = dict(lr=LR, scheduler="cosine", num_update=4, clip_grad_norm=0.0)
    r = np.random.default_rng(20)
    xs = r.normal(size=(STEPS, B, *SI)).astype(np.float32)
    ys = r.normal(size=(STEPS, B, *SO)).astype(np.float32)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2.0, 3), std_targets=r.uniform(0.5, 2.0, 3))
    stats = {k: a.astype(np.float32) for k, a in stats.items()}

    masks = Masks(21)
    fresh = lambda t: jax.tree_util.tree_map(jnp.array, t)   # the step donates
    state = jts.TrainState.create(fresh(v["params"]), {"batch_stats": fresh(v["batch_stats"])},
                                  jts.build_optimizer(Config(**cfg)))
    jlosses, jbefore, mus = [], [], []
    for i in range(STEPS):
        jbefore.append(_np_tree(state.params))
        # a step built anew each time, so that its trace draws its own masks
        jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats))
        with masks:
            state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                              jax.random.PRNGKey(i))
        jlosses.append(float(jl))
        mus.append(_np_tree(tt.adam_mu(state.opt_state)))

    model = build_model(shapes=(SI, SO), device="cpu", **KW)
    init = {k: t.clone() for k, t in m0.state_dict().items()}
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, tnorm.build_normalizer("gaussian", stats=stats), opt)
    losses, before, g32 = [], [], []
    with mock.patch.object(tbase, "dropout_mask", masks.torch_mask):
        for i in range(STEPS):
            before.append({k: t.clone() for k, t in model.state_dict().items()})
            losses.append(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item())
            g32.append({n: _np(p.grad).astype(np.float64) for n, p in model.named_parameters()})
    assert masks.n_torch == masks.n_jax == N_MASKS * STEPS
    _close(losses, jlosses)
    bs = _np_tree(state.model_state["batch_stats"])
    norm = tnorm.build_normalizer("gaussian", stats=stats)
    noisy = {}
    for i, (gj, slack) in enumerate(tt.adam_grads(mus, lambda t: deeponet_state_dict(t, bs))):
        step_masks = masks.masks[i * N_MASKS:(i + 1) * N_MASKS]
        xn, yn = norm.preprocess(torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
        # each framework's step replayed in float64 from its own weights
        # before it, with the step's batch and dropout masks
        g64, j64 = (_grads64(w, xn, yn, step_masks)
                    for w in (before[i], deeponet_state_dict(jbefore[i], bs)))
        step_noise = tt.step_noise(g32[i], gj, slack, g64, j64)
        noisy = {n: noisy.get(n, False) | m for n, m in step_noise.items()}
    # floor 0: no tensor excuses more than 1% of its entries, the small
    # ones none
    tt.check_final(model, init, deeponet_state_dict(_np_tree(state.params), bs), noisy,
                   _zero_grad, STEPS, LR, floor=0.0)


def _grads64(weights, xn, yn, step_masks):
    """``tests/torch_trajectory.grads64`` of a fresh port model loaded with
    ``weights``, its dropout sites taking ``step_masks`` in call order."""
    replay = iter(step_masks)
    with mock.patch.object(tbase, "dropout_mask",
                           lambda shape, p, g: torch.from_numpy(next(replay))):
        return tt.grads64(build_model(shapes=(SI, SO), device="cpu", **KW), weights, xn, yn)

SCENARIOS = tuple(WINDOWS)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_build_model_for_each_shipped_config(scenario):
    si, so = WINDOWS[scenario]
    cfg = tc.load_config(f"{scenario}/deeponet.yaml").to_dict()
    m = build_model(shapes=(si, so), device="cpu", generator=make_generator(0), **cfg)
    assert isinstance(m, DeepONet) and m.compute_dtype == torch.float32
    jb = jbuild(shapes=(si, so), **cfg)
    shapes = jax.eval_shape(jb.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *si), jnp.float32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax
    assert m.dropout_rate == float(cfg["dropout_rate"]) and m.p == cfg["p"]


def test_init_follows_jax_and_build_model_defaults_to_the_card():
    a = build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0), **KW)
    b = build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0), **KW)
    for k, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[k]), k
    w = a.state_dict()["branch.conv1.0.weight"]            # lecun normal, fan-in 81
    assert w.abs().max() <= 2 * (1 / 81) ** 0.5 / 0.8796 + 1e-7
    assert torch.equal(a.state_dict()["branch.conv2.1.running_var"], torch.ones(64))
    m = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16", seed=5, **KW)
    assert m.compute_dtype == torch.bfloat16 and m.dropout_seed == 5
    out = m.predict(torch.zeros(1, *SI))
    assert out.dtype == torch.float32 and out.shape == (1, *SO)
    d = build_model(shapes=(SI, SO), device="cpu", model_name="deeponet", p=8)
    assert d.dropout_rate == 0.0                           # the JAX registry's default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(shapes=(SI, SO), **KW)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = tmp_path_factory.mktemp("deeponet_tree")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    return str(root)


def test_cli_train_then_eval_on_the_cpu(tree, tmp_path):
    from realpdebench_tpu_torch.cli import main
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    common = ["--config", "cylinder/deeponet.yaml", "--dataset_root", tree,
              "--device", "cpu", "--results_path", str(tmp_path), "--num_workers", "0",
              "--train_batch_size", "4", "--test_batch_size", "4", "--p", "8",
              "--N_autoregressive", "2", "--N_plot", "0", "--N_plot_probe", "0",
              "--is_use_tb", "false", "--num_update", "2", "--in_step", "4",
              "--out_step", "4", "--interval", "4", "--trunk_length", "8",
              "--n_sim_frame", "32", "--n_sim_in_distribution", "1",
              "--n_sim_out_distribution", "1", "--sub_s_real", "1",
              "--sub_s_numerical", "1", "--generate_ids_if_missing"]
    with pytest.raises(SystemExit) as e:
        main(["train", *common])
    assert e.value.code == 0
    (ckpt,) = glob.glob(os.path.join(str(tmp_path), "deeponet", "*_numerical_False", "*",
                                     "ckpt"))
    assert sorted(os.listdir(ckpt)) == ["checkpoint_1.pth", "checkpoint_2.pth"]
    _, results = eval_main([*common, "--checkpoint_path", ckpt])
    for k in ("rmse", "rel_l2_error", "normalized_mse", "probe_error"):
        assert np.isfinite(results[k]), k
