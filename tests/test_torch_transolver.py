"""PyTorch port vs JAX package: Transolver (CPU, f32).

1. The whole model at shape (4, 8, 8, 3) with the mesh (H, W, D) = (8, 8,
   4), 2 blocks: the forward in eval mode, and in train mode the loss and
   every parameter gradient; the same with ``unified_pos``; on a grid view
   whose (H, W, D) = (16, 4, 6) is no permutation of the window's
   (4, 8, 12), where the reshape scrambles the points as in JAX; and with
   dropout 0.1 (the module's, which the registry never passes), the same
   masks injected on both sides. ``load_state_dict(strict=True)`` of the
   JAX package's ``export_torch_state_dict``, equal key for key and value
   for value to the port's ``from_jax.transolver_state_dict``. bfloat16:
   the port's forward against JAX's, and ``mlp2`` in float32.
2. A 3-step trajectory of the port's ``make_train_step`` against the JAX
   step (Adam, cosine schedule, Gaussian normalizer inside the step).
3. ``build_model`` for the ten shipped configs (transolver and trainsolver
   × five scenarios) at their scenarios' window shapes (construction only):
   the parameter count equals the JAX init's (``jax.eval_shape``), the
   configs' ``dropout`` is ignored as by the JAX registry; the card is the
   default device and its absence raises; a mesh that is not the window's
   size raises.
4. ``python -m realpdebench_tpu_torch train`` then ``eval`` on a synthetic
   tree with ``--device cpu``, from the port's config.

The JAX weights come from the port's seeded weights, perturbed by seeded
numpy noise, converted with the JAX package's ``convert_transolver``.
Tolerance: rtol 2e-4 with atol 2e-4·max|ref|; in the trajectory, entries
whose first gradient is below 1e-5 of their tensor's largest (at most 1%)
are held to Adam's bound of n·lr, as ``tests/test_torch_unet.py`` does.
"""

import glob
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_deeponet import WINDOWS
from test_torch_galerkin import Masks

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_convert import convert_transolver
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models import transolver as jtr
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch import config as tc
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import transolver_state_dict
from realpdebench_tpu_torch.models import base as tbase
from realpdebench_tpu_torch.models import transolver as ttr
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

SI = SO = (4, 8, 8, 3)
KW = dict(model_name="transolver", space_dim=3, n_layers=2, n_hidden=16, n_head=2,
          H=8, W=8, D=4, fun_dim=0, out_dim=3, ref=4, mlp_ratio=2, slice_num=8)
B, STEPS, LR = 2, 3, 1e-3
CASES = {   # name: (window, model keys)
    "registry": (SI, KW),
    "unified_pos": (SI, dict(KW, unified_pos=True, ref=3, n_layers=1)),
    "grid_view": ((4, 8, 12, 3), dict(KW, H=16, W=4, D=6)),
}
MODULE_KEYS = ("space_dim", "n_layers", "n_hidden", "n_head", "H", "W", "D", "fun_dim",
               "out_dim", "ref", "mlp_ratio", "slice_num")


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
    """Seeded noise on every parameter: no zero bias, no unit scale."""
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(0.1 * r.normal(size=p.shape).astype(np.float32)))
    return module


def _jax_variables(model):
    sd = {k: _np(v).copy() for k, v in model.state_dict().items()}
    params, _ = convert_transolver(sd, None, {})
    return {"params": jax.tree_util.tree_map(jnp.asarray, params)}


def _modules(si, kw, dropout):
    """(port model, flax module) with the same weights, built as modules so
    that ``dropout`` reaches them (the registries pass none)."""
    keys = {k: kw[k] for k in MODULE_KEYS}
    port = _perturb(ttr.Transolver3d(**keys, unified_pos=kw.get("unified_pos", False),
                                     dropout=dropout, shape_in=si, shape_out=si,
                                     device="cpu", generator=make_generator(1)), 101)
    flax = jtr.Transolver3d(**keys, unified_pos=kw.get("unified_pos", False),
                            dropout=dropout, shape_in=si, shape_out=si)
    return port, flax


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX bundle, JAX variables) with the same weights."""
    m = _perturb(build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0),
                             **KW), 100)
    return m, jbuild(shapes=(SI, SO), **KW), _jax_variables(m)


def test_export_loads_strict_and_equals_from_jax(pair):
    m, jb, v = pair
    exported = export_torch_state_dict(jb, v["params"], {})
    mine = transolver_state_dict(_np_tree(v["params"]))
    assert set(exported) == set(mine) == set(m.state_dict())
    assert "blocks.0.mlp2.weight" not in mine and "blocks.1.ln_3.weight" in mine
    for k, t in mine.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), t.numpy(), err_msg=k)
    fresh = build_model(shapes=(SI, SO), device="cpu", **KW)
    fresh.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in exported.items()},
                          strict=True)
    for k, t in fresh.state_dict().items():
        np.testing.assert_array_equal(_np(t), _np(m.state_dict()[k]), err_msg=k)


@pytest.mark.parametrize("case", [*CASES, "dropout"])
def test_forward_and_gradients_match_jax(case):
    si, kw = CASES.get(case, (SI, KW))
    port, flax = _modules(si, kw, 0.1 if case == "dropout" else 0.0)
    v = _jax_variables(port)
    r = np.random.default_rng(16)
    x = r.normal(size=(B, *si)).astype(np.float32)
    y = r.normal(size=(B, *si)).astype(np.float32)
    _close(_np(port.predict(torch.from_numpy(x))), flax.apply(v, jnp.asarray(x)),
           msg="eval forward")

    def loss(p):
        pred = flax.apply({"params": p}, jnp.asarray(x), train=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean((pred - y) ** 2)

    masks = Masks(17)
    with masks:
        jl, jgrad = jax.jit(jax.value_and_grad(loss))(v["params"])
    port.train()
    with mock.patch.object(tbase, "dropout_mask", masks.torch_mask):
        tl = port(torch.from_numpy(x), y=torch.from_numpy(y))
    tl.backward()
    assert masks.n_torch == masks.n_jax == (2 * kw["n_layers"] if case == "dropout" else 0)
    _close(tl.item(), float(jl))
    want = transolver_state_dict(_np_tree(jgrad))
    for name, p in port.named_parameters():
        _close(_np(p.grad), want[name].numpy(), msg=name)


def test_bf16_forward_tracks_jax_and_mlp2_runs_in_f32(pair):
    m, jb, v = pair
    x = np.random.default_rng(18).normal(size=(B, *SI)).astype(np.float32)
    m16 = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16", **KW)
    m16.load_state_dict(m.state_dict(), strict=True)
    got = m16.predict(torch.from_numpy(x))
    ref = np.asarray(jbuild(shapes=(SI, SO), compute_dtype="bfloat16", **KW)
                     .module.apply(v, jnp.asarray(x)))
    assert got.dtype == torch.float32
    got = _np(got)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 2e-2
    seen = {}

    def spy(mod, z, dt):
        seen[id(mod)] = dt
        return tbase.linear(mod, z, dt)

    with mock.patch.object(ttr, "linear", spy):
        m16.predict(torch.from_numpy(x))
    assert seen[id(m16.blocks[-1].mlp2)] == torch.float32
    assert seen[id(m16.blocks[-1].mlp.linear_post)] == torch.bfloat16


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
    state = jts.TrainState.create(fresh(v["params"]), {}, jts.build_optimizer(Config(**cfg)))
    jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats))
    jlosses = []
    for i in range(STEPS):
        state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]), jax.random.PRNGKey(i))
        jlosses.append(float(jl))

    model = build_model(shapes=(SI, SO), device="cpu", **KW)
    init = {k: t.clone() for k, t in m0.state_dict().items()}
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, tnorm.build_normalizer("gaussian", stats=stats), opt)
    losses, tiny = [], {}
    for i in range(STEPS):
        losses.append(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item())
        if i == 0:
            tiny = {n: ((p.grad != 0) & (p.grad.abs() < 1e-5 * p.grad.abs().max())).numpy()
                    for n, p in model.named_parameters()}
    _close(losses, jlosses)

    want = transolver_state_dict(_np_tree(state.params))
    for name, t in model.state_dict().items():
        got, ref = _np(t), want[name].numpy()
        mask = tiny[name]
        assert mask.sum() <= 1e-2 * mask.size, f"{name}: {mask.sum()} tiny gradients"
        p0 = _np(init[name])
        for moved in (got - p0, ref - p0):
            assert np.abs(moved[mask]).max(initial=0) <= 1.01 * STEPS * LR, name
        _close(np.where(mask, ref, got), ref, msg=name)


@pytest.mark.parametrize("scenario", tuple(WINDOWS))
@pytest.mark.parametrize("family", ["transolver", "trainsolver"])
def test_build_model_for_each_shipped_config(family, scenario):
    si, so = WINDOWS[scenario]
    cfg = tc.load_config(f"{scenario}/{family}.yaml").to_dict()
    assert cfg["dropout"] == 0.1 and cfg["compute_dtype"] is None
    m = build_model(shapes=(si, so), device="cpu", generator=make_generator(0), **cfg)
    assert isinstance(m, ttr.Transolver3d) and m.compute_dtype == torch.float32
    assert all(b.Attn.dropout == 0.0 for b in m.blocks)    # the registry passes none
    jb = jbuild(shapes=(si, so), **cfg)
    assert jb.module.dropout == 0.0
    shapes = jax.eval_shape(jb.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *si), jnp.float32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax


def test_init_follows_jax_and_build_model_defaults_to_the_card():
    a = build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0), **KW)
    b = build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0), **KW)
    for k, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[k]), k
    sd = a.state_dict()
    w = sd["blocks.0.Attn.to_q.weight"]                    # trunc normal, no correction
    assert w.abs().max() <= 0.04 and w.std() > 0.015
    ph = sd["placeholder"]
    assert ph.min() >= 0 and ph.max() < 1 / 16
    assert torch.equal(sd["blocks.1.Attn.temperature"], torch.full((1, 2, 1, 1), 0.5))
    m = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16",
                    seq_mesh=None, **KW)
    out = m.predict(torch.zeros(1, *SI))
    assert out.dtype == torch.float32 and out.shape == (1, *SO)
    with pytest.raises(ValueError, match="mesh"):
        build_model(shapes=(SI, SO), device="cpu", **dict(KW, D=5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(shapes=(SI, SO), **KW)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = tmp_path_factory.mktemp("transolver_tree")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    return str(root)


def test_cli_train_then_eval_on_the_cpu(tree, tmp_path):
    from realpdebench_tpu_torch.cli import main
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    common = ["--config", "cylinder/transolver.yaml", "--dataset_root", tree,
              "--device", "cpu", "--results_path", str(tmp_path), "--num_workers", "0",
              "--train_batch_size", "4", "--test_batch_size", "4", "--N_autoregressive", "2",
              "--N_plot", "0", "--is_use_tb", "false", "--num_update", "2",
              "--H", "16", "--W", "16", "--D", "4", "--n_hidden", "16", "--n_head", "2",
              "--slice_num", "4", "--mlp_ratio", "2", "--in_step", "4", "--out_step", "4",
              "--interval", "4", "--trunk_length", "8", "--n_sim_frame", "32",
              "--n_sim_in_distribution", "1", "--n_sim_out_distribution", "1",
              "--sub_s_real", "1", "--sub_s_numerical", "1", "--generate_ids_if_missing"]
    with pytest.raises(SystemExit) as e:
        main(["train", *common])
    assert e.value.code == 0
    (ckpt,) = glob.glob(os.path.join(str(tmp_path), "transolver", "*_numerical_False", "*",
                                     "ckpt"))
    assert sorted(os.listdir(ckpt)) == ["checkpoint_1.pth", "checkpoint_2.pth"]
    _, results = eval_main([*common, "--checkpoint_path", ckpt])
    for k in ("rmse", "rel_l2_error", "normalized_mse"):
        assert np.isfinite(results[k]), k
    assert "probe_error" not in results      # the config asks for no probe diagnostic
