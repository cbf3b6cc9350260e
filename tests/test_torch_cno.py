"""PyTorch port vs JAX package: CNO3d (CPU, f32).

1. ``from_jax.cno_state_dict`` equals the JAX package's
   ``export_torch_state_dict`` key for key and value for value, and
   ``load_state_dict(strict=True)`` takes it.
2. The whole model at (4, 16, 16, 3), in both activation modes
   (``LeakyReLU``, the shipped one, and the filtered ``lrelu``) and at
   out_dim_mult 1 and 2: the forward in eval mode; in train mode the loss,
   every parameter gradient and the BatchNorms' running statistics. The
   conv biases before a BatchNorm have a true gradient of 0 (the
   BatchNorm cancels them): both sides' are held to 1e-5 of their conv
   weight's largest gradient.
3. BatchNorm under ``remat``: the running statistics after a step with
   ``remat`` equal those without it, bit for bit, and the JAX package's
   with ``remat=True`` (the checkpoint's recompute must not move them a
   second time).
4. A 3-step trajectory of the port's ``make_train_step`` against the JAX
   step with ``remat=True`` (Adam, cosine schedule, Gaussian normalizer
   inside the step, the shipped lr 3e-4), running statistics included;
   float-noise entries as ``tests/torch_trajectory.py`` sets out.
5. ``build_model`` for the five shipped configs at their scenarios' window
   shapes: the parameter count equals the JAX init's (``jax.eval_shape``),
   the state dict's keys and shapes equal the exporter's; the trailing
   commas of the YAMLs give N_res_neck 6 (the YAML shows 8), so
   ``res_nets`` holds 3 + 6 blocks. The card is the default device.
6. ``python -m realpdebench_tpu_torch train`` then ``eval`` on a synthetic
   tree with ``--device cpu``, from the port's config.

Weights: the JAX init perturbed by seeded numpy noise, converted by
``cno_state_dict``. Tolerance: rtol 2e-4 with atol 2e-4·max|ref|.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_trajectory as tt

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch import config as tc
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import cno_state_dict
from realpdebench_tpu_torch.models.cno import CNO3d
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

SI = SO = (4, 16, 16, 3)
KW = dict(model_name="cno", N_layers=2, N_res=1, N_res_neck=2, channel_multiplier=8,
          latent_lift_proj_dim=8, activation="LeakyReLU")
B, STEPS, LR = 4, 3, 3e-4

WINDOWS = {
    "combustion": ((20, 64, 64, 16), (20, 64, 64, 16)),
    "controlled_cylinder": ((10, 64, 128, 5), (10, 64, 128, 3)),
    "cylinder": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "foil": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "fsi": ((20, 64, 64, 3), (20, 64, 64, 3)),
}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_variables(jb, si, seed):
    """The JAX init, every parameter and statistic moved by seeded noise."""
    r = np.random.default_rng(seed)
    v = jb.init(jax.random.PRNGKey(seed), np.zeros((1, *si), np.float32))
    noise = lambda a, s: jnp.asarray(a + s * r.normal(size=a.shape), a.dtype)
    params = jax.tree_util.tree_map(lambda a: noise(a, 0.1), v["params"])
    stats = {k: jax.tree_util.tree_map(lambda a: a, b) for k, b in v["batch_stats"].items()}
    stats = jax.tree_util.tree_map(lambda a: noise(a, 0.1), stats)
    stats = jax.tree_util.tree_map(lambda a: jnp.abs(a) + 0.5, stats)  # variances > 0
    return {"params": params, "batch_stats": stats}


def _port(jb_vars, si=SI, so=SO, **kw):
    m = build_model(shapes=(si, so), device="cpu", **{**KW, **kw})
    sd = cno_state_dict(_np_tree(jb_vars["params"]), _np_tree(jb_vars["batch_stats"]))
    m.load_state_dict(sd, strict=True)
    return m


def _zero_grad(name):
    """The conv biases a BatchNorm follows (every block's but lift's and
    project's)."""
    return (not name.startswith(("lift.", "project."))
            and name.endswith(("convolution.bias", "convolution1.bias", "convolution2.bias")))


def _compare_grads(grads, want, msg=""):
    for name, g in grads.items():
        got, ref = g.numpy(), want[name].numpy()
        if _zero_grad(name):
            scale = np.abs(grads[name[:-4] + "weight"].numpy()).max()
            for side in (got, ref):
                assert np.abs(side).max() <= 1e-5 * scale, (msg, name)
            continue
        tt.close(got, ref, msg=f"{msg}{name}")


@pytest.fixture(scope="module")
def pair():
    jb = jbuild(shapes=(SI, SO), **KW)
    v = _jax_variables(jb, SI, 0)
    return _port(v), jb, v


def test_export_loads_strict_and_equals_from_jax(pair):
    m, jb, v = pair
    exported = export_torch_state_dict(jb, v["params"], {"batch_stats": v["batch_stats"]})
    mine = cno_state_dict(_np_tree(v["params"]), _np_tree(v["batch_stats"]))
    assert set(exported) == set(mine) == set(m.state_dict())
    for k, t in mine.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), t.numpy(), err_msg=k)
    fresh = build_model(shapes=(SI, SO), device="cpu", **KW)
    fresh.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in exported.items()},
                          strict=True)


@pytest.mark.parametrize("activation", ["LeakyReLU", "lrelu"])
@pytest.mark.parametrize("so", [SO, (8, 16, 16, 3)], ids=["mult1", "mult2"])
def test_forward_gradients_and_statistics_match_jax(activation, so):
    kw = dict(activation=activation)
    jb = jbuild(shapes=(SI, so), **{**KW, **kw})
    v = _jax_variables(jb, SI, 1)
    m = _port(v, SI, so, **kw)
    if activation == "lrelu":        # the bias a channel the exporter leaves out
        assert any(k.endswith("activation.bias") for k in m.state_dict())
    r = np.random.default_rng(16)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *so)).astype(np.float32)
    tt.close(m.predict(torch.from_numpy(x)).numpy(), jb.module.apply(v, jnp.asarray(x)),
             msg="eval forward")

    def loss(p):
        pred, new = jb.module.apply({"params": p, "batch_stats": v["batch_stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean((pred - y) ** 2), new

    (jl, new), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    m.train()
    tl = m(torch.from_numpy(x), y=torch.from_numpy(y))
    tl.backward()
    tt.close(tl.item(), float(jl))
    want = cno_state_dict(_np_tree(jgrad), _np_tree(new["batch_stats"]))
    _compare_grads({n: p.grad for n, p in m.named_parameters()}, want)
    for name, buf in m.named_buffers():
        if "running" in name:
            tt.close(buf.numpy(), want[name].numpy(), msg=name)


def test_batch_norm_moves_once_under_remat(pair):
    """One training forward-backward with and without ``remat``: the same
    loss, gradients and running statistics, bit for bit; the statistics
    also equal the JAX package's under ``remat=True``."""
    _, jb, v = pair
    r = np.random.default_rng(18)
    x = torch.from_numpy(r.normal(size=(B, *SI)).astype(np.float32))
    y = torch.from_numpy(r.normal(size=(B, *SO)).astype(np.float32))
    runs = {}
    for remat in (True, False):
        m = _port(v, remat=remat).train()
        assert m.remat is remat
        loss = m(x, y=y)
        loss.backward()
        runs[remat] = (loss, {n: p.grad for n, p in m.named_parameters()},
                       {n: b.clone() for n, b in m.named_buffers() if "running" in n})
    (la, ga, sa), (lb, gb, sb) = runs[True], runs[False]
    assert torch.equal(la, lb)
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n

    def loss(p):
        pred, new = jb.module.apply({"params": p, "batch_stats": v["batch_stats"]},
                                    jnp.asarray(x.numpy()), train=True, mutable=["batch_stats"])
        return jnp.mean((pred - jnp.asarray(y.numpy())) ** 2), new

    assert jb.module.remat
    (_, new), _ = jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])
    want = cno_state_dict(_np_tree(v["params"]), _np_tree(new["batch_stats"]))
    start = cno_state_dict(_np_tree(v["params"]), _np_tree(v["batch_stats"]))
    for n, b in sa.items():
        tt.close(b.numpy(), want[n].numpy(), msg=n)
        assert not torch.equal(b, start[n]), n          # moved, once


def test_train_step_trajectory_matches_jax(pair):
    m0, jb, v = pair
    cfg = dict(lr=LR, scheduler="cosine", num_update=4, clip_grad_norm=0.0)
    r = np.random.default_rng(20)
    xs = r.normal(size=(STEPS, B, *SI)).astype(np.float32)
    ys = r.normal(size=(STEPS, B, *SO)).astype(np.float32)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2.0, 3), std_targets=r.uniform(0.5, 2.0, 3))
    stats = {k: a.astype(np.float32) for k, a in stats.items()}

    fresh = lambda t: jax.tree_util.tree_map(jnp.array, t)   # the step donates
    state = jts.TrainState.create(fresh(v["params"]), {"batch_stats": fresh(v["batch_stats"])},
                                  jts.build_optimizer(Config(**cfg)))
    jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats))
    jlosses, jbefore, mus = [], [], []
    for i in range(STEPS):
        jbefore.append((_np_tree(state.params), _np_tree(state.model_state["batch_stats"])))
        state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]), jax.random.PRNGKey(i))
        jlosses.append(float(jl))
        mus.append(_np_tree(tt.adam_mu(state.opt_state)))

    model = build_model(shapes=(SI, SO), device="cpu", **KW)
    assert model.remat                       # the registry's default, as JAX's
    init = {k: t.clone() for k, t in m0.state_dict().items()}
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    norm = tnorm.build_normalizer("gaussian", stats=stats)
    step = make_train_step(model, norm, opt)
    losses, before, g32 = [], [], []
    for i in range(STEPS):
        before.append({k: t.clone() for k, t in model.state_dict().items()})
        losses.append(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item())
        g32.append({n: tt.real(p.grad.numpy()) for n, p in model.named_parameters()})
    tt.close(losses, jlosses)

    bs = _np_tree(state.model_state["batch_stats"])
    noisy = {}
    for i, (gj, slack) in enumerate(tt.adam_grads(mus, lambda t: cno_state_dict(t, bs))):
        xn, yn = norm.preprocess(torch.from_numpy(xs[i]).double(),
                                 torch.from_numpy(ys[i]).double())
        fresh64 = lambda: build_model(shapes=(SI, SO), device="cpu", **KW)
        g64, j64 = (tt.grads64(fresh64(), w, xn, yn)
                    for w in (before[i], cno_state_dict(*jbefore[i])))
        for n, m in tt.step_noise(g32[i], gj, slack, g64, j64).items():
            noisy[n] = noisy.get(n, False) | m
    want = cno_state_dict(_np_tree(state.params), bs)
    tt.check_final(model, init, want, noisy, _zero_grad, STEPS, LR)


SCENARIOS = tuple(WINDOWS)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_build_model_for_each_shipped_config(scenario):
    si, so = WINDOWS[scenario]
    cfg = tc.load_config(f"{scenario}/cno.yaml").to_dict()
    assert cfg["N_res_neck"] == "8," and cfg["channel_multiplier"] == "32,"
    m = build_model(shapes=(si, so), device="meta", **cfg)
    assert isinstance(m, CNO3d) and m.compute_dtype == torch.float32 and m.remat
    assert m.N_res_neck == 6 and len(m.res_nets) == cfg["N_layers"] + 6 == 9
    jb = jbuild(shapes=(si, so), **cfg)
    assert jb.module.N_res_neck == 6
    shapes = jax.eval_shape(jb.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *si), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    ref = export_torch_state_dict(jb, zeros["params"], {"batch_stats": zeros["batch_stats"]})
    assert {k: tuple(t.shape) for k, t in m.state_dict().items()} == {
        k: np.shape(a) for k, a in ref.items()}
    n = sum(p.numel() for p in m.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    if scenario == "cylinder":
        assert n == 7932723


def test_init_follows_jax_and_build_model_defaults_to_the_card():
    a = build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0), **KW)
    b = build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0), **KW)
    for k, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[k]), k
    w = a.state_dict()["lift.inter_CNOBlock.convolution.weight"]    # fan-in 81
    assert w.abs().max() <= 2 * (1 / 81) ** 0.5 / 0.8796 + 1e-7
    assert torch.equal(a.state_dict()["encoder.0.batch_norm.running_var"], torch.ones(8))
    m = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16", **KW)
    out = m.predict(torch.zeros(1, *SI))
    assert m.compute_dtype == torch.bfloat16 and out.dtype == torch.float32
    assert out.shape == (1, *SO)
    with pytest.raises(ValueError, match="incompatible"):
        build_model(shapes=(SI, (3, 16, 16, 3)), device="cpu", **KW)
    # in_size is W (shape_in[2]), which only the lrelu mode's geometry reads
    wide = build_model(shapes=((4, 8, 16, 3),) * 2, device="cpu",
                       **{**KW, "activation": "lrelu"})
    assert wide.lift.inter_CNOBlock.activation.geometry["in_size"] == 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(shapes=(SI, SO), **KW)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = tmp_path_factory.mktemp("cno_tree")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    return str(root)


def test_cli_train_then_eval_on_the_cpu(tree, tmp_path):
    from realpdebench_tpu_torch.cli import main
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    common = ["--config", "cylinder/cno.yaml", "--dataset_root", tree,
              "--device", "cpu", "--results_path", str(tmp_path), "--num_workers", "0",
              "--train_batch_size", "4", "--test_batch_size", "4", "--N_layers", "2",
              "--channel_multiplier", "4", "--latent_lift_proj_dim", "4",
              "--N_res_neck", "1", "--N_autoregressive", "2", "--N_plot", "0",
              "--N_plot_probe", "0", "--is_use_tb", "false", "--num_update", "2",
              "--in_step", "4", "--out_step", "4", "--interval", "4",
              "--trunk_length", "8", "--n_sim_frame", "32", "--n_sim_in_distribution", "1",
              "--n_sim_out_distribution", "1", "--sub_s_real", "1",
              "--sub_s_numerical", "1", "--generate_ids_if_missing"]
    with pytest.raises(SystemExit) as e:
        main(["train", *common])
    assert e.value.code == 0
    (ckpt,) = glob.glob(os.path.join(str(tmp_path), "cno", "*_numerical_False", "*", "ckpt"))
    assert sorted(os.listdir(ckpt)) == ["checkpoint_1.pth", "checkpoint_2.pth"]
    _, results = eval_main([*common, "--checkpoint_path", ckpt])
    for k in ("rmse", "rel_l2_error", "normalized_mse"):     # no probe_diagnostic key
        assert np.isfinite(results[k]), k
