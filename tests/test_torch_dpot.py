"""PyTorch port vs JAX package: DPOT and DPOT3D (CPU, f32).

1. ``fft_resize_2d`` / ``fft_resize_3d`` at up- and down-sizes, odd and
   even, against the JAX package's (its default dense-DFT route); the
   inverse transform ``irfftn`` on half spectra that are not Hermitian
   against that route's ``irfftn_planes``.
2. AFNO2D and AFNO3D alone, forward and the gradients of every parameter
   and the input.
3. The whole DPOT through the registry on a window (4, 12, 20, 3) resized
   to 16×16 (H up, W down, channels padded to 4): the forward, and the
   loss with every parameter gradient; the same with a data window twice
   the model's (the sliding window), at the model's own size, and for
   ``model_type: dpot3d`` on a volumetric window.
4. ``load_state_dict(strict=True)`` of the exporter's ``dpot_model.``
   layout, equal key for key to ``from_jax.dpot_state_dict``; a bare and
   a ``module.``-prefixed backbone through the loop's
   ``load_reference_or_orbax_checkpoint``.
5. ``remat`` on and off, bit for bit.
6. A 3-step trajectory of ``make_train_step`` against the JAX step (Adam,
   cosine schedule, gradient clipping at 1 as shipped, Gaussian
   normalizer).
7. The ten shipped configs (dpot_s, dpot_l × five scenarios): the port
   built on the meta device (no memory) has the parameter count of the
   JAX init's ``jax.eval_shape``.
8. ``python -m realpdebench_tpu_torch train`` then ``eval`` on a
   synthetic tree with ``--device cpu``, and a finetune from a bare
   backbone.

The JAX weights are the JAX init perturbed by seeded numpy noise, carried
to the port by ``from_jax.dpot_state_dict``. Tolerance: rtol 2e-4 with
atol 2e-4·max|ref|.
"""

import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_deeponet import WINDOWS

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models import dpot as jdp
from realpdebench_tpu.models import dpot3d as jdp3
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch import config as tc
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import dpot_state_dict
from realpdebench_tpu_torch.models import dpot as tdp
from realpdebench_tpu_torch.models import dpot3d as tdp3
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.train.loop import load_reference_or_orbax_checkpoint
from realpdebench_tpu_torch.utils.misc import make_generator

SI = (4, 12, 20, 3)
KW = dict(model_name="dpot", model_type="dpot", img_size=16, in_channels=4, out_channels=4,
          in_timesteps=4, out_timesteps=4, patch_size=4, embed_dim=32, depth=1, n_blocks=4,
          modes=3, mlp_ratio=2, out_layer_dim=8, n_cls=3, act="gelu", time_agg="exp_mlp")
CASES = {   # name: (window in, window out, model keys)
    "registry": (SI, SI, KW),
    "sliding": (SI, (8, 12, 20, 3), KW),
    "same_size": ((4, 16, 16, 3), (4, 16, 16, 3), dict(KW, modes=16)),
    "dpot3d": ((2, 6, 8, 10, 2), (2, 6, 8, 10, 2),
               dict(KW, model_type="dpot3d", img_size=8, in_timesteps=2, out_timesteps=2,
                    depth=1)),
}
B, STEPS, LR = 2, 3, 1e-3


def _close(got, ref, rtol=2e-4, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()), err_msg=msg)


def _np(t):
    return t.detach().cpu().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _perturb(params, seed):
    """Seeded noise on every JAX parameter: no zero bias, no unit scale."""
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.1 * r.normal(size=a.shape).astype(np.float32)),
        params)


@functools.lru_cache(maxsize=None)
def _jax(case):
    """(JAX bundle, perturbed JAX params) of a case, built once."""
    si, so, kw = CASES[case]
    jb = jbuild(shapes=(si, so), **kw)
    x0 = jnp.zeros((1, *si), jnp.float32)
    return jb, _perturb(jax.jit(jb.module.init)(jax.random.PRNGKey(0), x0)["params"], 100)


def _pair(case, **over):
    """(port model, JAX bundle, JAX params) with the same weights."""
    si, so, kw = CASES[case]
    jb, params = _jax(case)
    m = build_model(shapes=(si, so), device="cpu", **kw, **over)
    m.load_state_dict(dpot_state_dict(_np_tree(params)), strict=True)
    return m, jb, params


@pytest.mark.parametrize("size", [(12, 20), (16, 16), (9, 7), (32, 40)])
def test_fft_resize_2d_matches_jax(size):
    x = np.random.default_rng(1).normal(size=(2, 12, 20, 5)).astype(np.float32)
    ref = jdp.fft_resize_2d(jnp.asarray(x), size)
    _close(_np(tdp.fft_resize_2d(torch.from_numpy(x), size)), ref, msg=str(size))


@pytest.mark.parametrize("size", [(6, 8, 10), (8, 8, 8), (5, 12, 7)])
def test_fft_resize_3d_matches_jax(size):
    x = np.random.default_rng(2).normal(size=(2, 6, 8, 10, 3)).astype(np.float32)
    ref = jdp.fft_resize_3d(jnp.asarray(x), size)
    _close(_np(tdp.fft_resize_3d(torch.from_numpy(x), size)), ref, msg=str(size))


@pytest.mark.parametrize("s", [(6, 8), (5, 7), (4, 6, 8)])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_irfftn_takes_any_half_spectrum_as_jax(s, norm):
    """A half spectrum that is not Hermitian (imaginary zero and Nyquist
    frequencies, rows without their conjugates) inverts as the JAX
    package's dense-DFT route defines it."""
    from realpdebench_tpu.ops import spectral as S

    r = np.random.default_rng(7)
    shape = (2, *s[:-1], s[-1] // 2 + 1)
    re, im = (r.normal(size=shape).astype(np.float32) for _ in range(2))
    axes = tuple(range(1, len(s) + 1))
    ref = S.irfftn_planes(jnp.asarray(re), jnp.asarray(im), s=s, axes=axes, norm=norm)
    got = tdp.irfftn(torch.complex(torch.from_numpy(re), torch.from_numpy(im)), s, axes,
                     norm=norm)
    _close(_np(got), ref, msg=str(s))


@pytest.mark.parametrize("dims", [2, 3])
def test_afno_matches_jax(dims):
    C, nb = 16, 4
    r = np.random.default_rng(3 + dims)
    shape = (2, 8, 10, C) if dims == 2 else (2, 6, 8, 6, C)
    x = r.normal(size=shape).astype(np.float32)
    if dims == 2:
        flax, port = jdp.AFNO2D(C, nb, modes=3), tdp.AFNO2D(C, nb, modes=3)
    else:
        flax, port = jdp3.AFNO3D(C, nb, modes=3, temporal_modes=2), \
            tdp3.AFNO3D(C, nb, modes=3, temporal_modes=2)
    params = _perturb(jax.jit(flax.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 5)
    with torch.no_grad():
        for k in ("w1", "b1", "w2", "b2"):
            getattr(port, k).copy_(torch.from_numpy(np.asarray(params[k])))
    fwd = lambda p, xx: flax.apply({"params": p}, xx)
    g = r.normal(size=shape).astype(np.float32)
    jout, (jgp, jgx) = jax.jit(lambda p, xx, gg: (fwd(p, xx), jax.vjp(fwd, p, xx)[1](gg)))(
        params, jnp.asarray(x), jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = port(xt, torch.float32) if dims == 2 else port(xt)
    _close(_np(out), jout, msg="forward")
    out.backward(torch.from_numpy(g))
    _close(_np(xt.grad), jgx, msg="dx")
    for k in ("w1", "b1", "w2", "b2"):
        _close(_np(getattr(port, k).grad), jgp[k], msg=k)


@pytest.mark.parametrize("case", tuple(CASES))
def test_forward_and_gradients_match_jax(case):
    si, so, kw = CASES[case]
    m, jb, params = _pair(case)
    r = np.random.default_rng(16)
    x = r.normal(size=(B, *si)).astype(np.float32)
    y = r.normal(size=(B, *so)).astype(np.float32)
    def loss(p):
        pred = jb.module.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((pred - y) ** 2), pred

    (jl, jpred), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    _close(_np(m.predict(torch.from_numpy(x))), jpred, msg="forward")
    m.train()
    tl = m(torch.from_numpy(x), y=torch.from_numpy(y))
    tl.backward()
    _close(tl.item(), float(jl))
    want = dpot_state_dict(_np_tree({"dpot_model": jgrad["dpot_model"]}))
    for name, p in m.named_parameters():
        if ".cls_head." in name:    # the head's output is discarded: no gradient
            assert p.grad is None and not np.abs(want[name].numpy()).any(), name
            continue
        _close(_np(p.grad), want[name].numpy(), msg=name)


def test_export_layout_and_backbone_prefixes_load_strict(tmp_path):
    m, jb, params = _pair("registry")
    exported = export_torch_state_dict(jb, params, {})
    mine = dpot_state_dict(_np_tree(params))
    assert set(exported) == set(mine) == set(m.state_dict())
    assert all(k.startswith("dpot_model.") for k in mine)
    for k, t in mine.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), t.numpy(), err_msg=k)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(1, *SI)).astype(np.float32))
    want = m.predict(x)
    bare = {k[len("dpot_model."):]: torch.from_numpy(np.array(a)) for k, a in exported.items()}
    forms = {"wrapper": {"model_state_dict": {k: torch.from_numpy(np.array(a))
                                              for k, a in exported.items()}},
             "bare": bare, "module": {f"module.{k}": t for k, t in bare.items()}}
    for form, ckpt in forms.items():
        path = str(tmp_path / f"{form}.pth")
        torch.save(ckpt, path)
        fresh = build_model(shapes=(SI, SI), device="cpu", **KW)
        load_reference_or_orbax_checkpoint(path, fresh)
        assert torch.equal(fresh.predict(x), want), form
    with pytest.raises(RuntimeError):       # still strict after the prefix is mapped
        torch.save({k: t for k, t in bare.items() if "cls_head" not in k},
                   str(tmp_path / "short.pth"))
        load_reference_or_orbax_checkpoint(str(tmp_path / "short.pth"),
                                           build_model(shapes=(SI, SI), device="cpu", **KW))


def test_remat_on_and_off_bit_equal():
    m = build_model(shapes=(SI, SI), device="cpu", generator=make_generator(3), **KW)
    r = build_model(shapes=(SI, SI), device="cpu", remat=True, **KW)
    r.load_state_dict(m.state_dict(), strict=True)
    assert r.dpot_model.remat and not m.dpot_model.remat
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(B, *SI)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(B, *SI)).astype(np.float32))
    losses = []
    for model in (m, r):
        model.train()
        losses.append(model(x, y=y))
        losses[-1].backward()
    assert torch.equal(losses[0], losses[1])
    for (n, a), b in zip(m.named_parameters(), r.parameters()):
        assert (a.grad is None and b.grad is None) or torch.equal(a.grad, b.grad), n


def test_train_step_trajectory_matches_jax():
    m0, jb, params = _pair("registry")
    cfg = dict(lr=LR, scheduler="cosine", num_update=4, clip_grad_norm=1.0)
    r = np.random.default_rng(20)
    xs = r.normal(size=(STEPS, B, *SI)).astype(np.float32)
    ys = r.normal(size=(STEPS, B, *SI)).astype(np.float32)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2.0, 3), std_targets=r.uniform(0.5, 2.0, 3))
    stats = {k: a.astype(np.float32) for k, a in stats.items()}

    fresh = lambda t: jax.tree_util.tree_map(jnp.array, t)
    state = jts.TrainState.create(fresh(params), {}, jts.build_optimizer(Config(**cfg)))
    jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats))
    jlosses = []
    for i in range(STEPS):
        state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]), jax.random.PRNGKey(i))
        jlosses.append(float(jl))

    opt = build_optimizer(cfg, m0.parameters())
    step = make_train_step(m0, tnorm.build_normalizer("gaussian", stats=stats), opt)
    losses = [step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item()
              for i in range(STEPS)]
    _close(losses, jlosses)
    want = dpot_state_dict(_np_tree(state.params))
    for name, t in m0.state_dict().items():
        _close(_np(t), want[name].numpy(), msg=name)


@pytest.mark.parametrize("scenario", tuple(WINDOWS))
@pytest.mark.parametrize("family", ["dpot_s", "dpot_l"])
def test_build_model_for_each_shipped_config(family, scenario):
    si, so = WINDOWS[scenario]
    cfg = tc.load_config(f"{scenario}/{family}.yaml").to_dict()
    assert cfg["compute_dtype"] is None and not cfg.get("remat", False)
    m = build_model(shapes=(si, so), device="meta", **cfg)
    assert isinstance(m, tdp.DPOT) and m.compute_dtype == torch.float32
    assert all(p.is_meta for p in m.parameters())
    jb = jbuild(shapes=(si, so), **cfg)
    shapes = jax.eval_shape(jb.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *si), jnp.float32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in m.parameters()) == n_jax
    if family == "dpot_l" and scenario == "cylinder":
        assert 6.7e8 < n_jax < 6.8e8        # the 673M-parameter DPOT-L


def test_build_model_defaults_to_the_card():
    a = build_model(shapes=(SI, SI), device="cpu", **KW)
    assert a.predict(torch.zeros(1, *SI)).shape == (1, *SI)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(shapes=(SI, SI), **KW)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = tmp_path_factory.mktemp("dpot_tree")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    return str(root)


def test_cli_train_eval_and_finetune_from_a_bare_backbone(tree, tmp_path):
    from realpdebench_tpu_torch.cli import main
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    common = ["--config", "cylinder/dpot_s.yaml", "--dataset_root", tree,
              "--device", "cpu", "--num_workers", "0",
              "--train_batch_size", "4", "--test_batch_size", "4", "--N_autoregressive", "2",
              "--N_plot", "0", "--is_use_tb", "false", "--num_update", "2",
              "--img_size", "16", "--patch_size", "4", "--embed_dim", "16", "--depth", "1",
              "--n_blocks", "4", "--modes", "4", "--out_layer_dim", "8",
              "--in_timesteps", "4", "--out_timesteps", "4", "--in_step", "4",
              "--out_step", "4", "--interval", "4", "--trunk_length", "8",
              "--n_sim_frame", "32", "--n_sim_in_distribution", "1",
              "--n_sim_out_distribution", "1", "--sub_s_real", "1", "--sub_s_numerical", "1",
              "--generate_ids_if_missing"]
    with pytest.raises(SystemExit) as e:
        main(["train", *common, "--results_path", str(tmp_path / "a")])
    assert e.value.code == 0
    (ckpt,) = glob.glob(os.path.join(str(tmp_path / "a"), "dpot", "*_numerical_False", "*",
                                     "ckpt"))
    assert sorted(os.listdir(ckpt)) == ["checkpoint_1.pth", "checkpoint_2.pth"]
    _, results = eval_main([*common, "--results_path", str(tmp_path / "a"),
                            "--checkpoint_path", ckpt])
    for k in ("rmse", "rel_l2_error", "normalized_mse"):
        assert np.isfinite(results[k]), k

    # a pretrained backbone comes bare: the wrapper's prefix taken off
    sd = torch.load(os.path.join(ckpt, "checkpoint_2.pth"), weights_only=False)
    bare = str(tmp_path / "backbone.pth")
    torch.save({k[len("dpot_model."):]: v for k, v in sd["model_state_dict"].items()}, bare)
    with pytest.raises(SystemExit) as e:
        main(["train", *common, "--results_path", str(tmp_path / "b"), "--is_finetune",
              "--checkpoint_path", bare, "--num_update", "1"])
    assert e.value.code == 0
