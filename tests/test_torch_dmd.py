"""PyTorch port vs JAX package: DMD, the host rollout and eval's
training-free branch (CPU).

1. The port's numpy DMD against the JAX package's on the same seeded
   frames: the forecast within 1e-6 of max|ref| (the same numpy calls; the
   forecast is invariant to SVD and eig sign and order conventions).
2. ``build_model(model_name="dmd")``: training-free, no parameters, built
   for the card unless the CPU is asked for; ``predict`` computes on the
   host and hands the forecast back on the window's device.
3. ``eval.rollout.make_host_rollout_fn`` against JAX's on the same raw
   windows and Gaussian statistics (the normalizer sliced to DMD's
   ``input_feature`` channels), within 1e-5.
4. ``python -m realpdebench_tpu_torch eval`` with ``cylinder/dmd.yaml`` on
   a synthetic tree, no checkpoint: each of the 13 metrics and the
   normalized MSE within 1e-5 (relative; absolute below 1e-2) of JAX
   ``run_eval`` on the same tree; ``train`` with ``model_name: dmd`` refuses
   and names ``eval``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from realpdebench_tpu import config as jc
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.eval import rollout as jrollout
from realpdebench_tpu.models.dmd import DMD as JDMD
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.eval.rollout import make_host_rollout_fn
from realpdebench_tpu_torch.models.dmd import DMD
from realpdebench_tpu_torch.models.registry import build_model

KW = dict(model_name="dmd", n_modes=5, n_predict=6, input_feature=2, N_autoregressive=1)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while these small runs go: with the suite's
    workers on every core, a full pool of spinning threads slows them a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _smooth_frames(rng, b, t, h, w, c):
    y = np.linspace(0, 2 * np.pi, h)[None, None, :, None, None]
    x = np.linspace(0, 2 * np.pi, w)[None, None, None, :, None]
    tt = np.arange(t)[None, :, None, None, None] / t
    phase = rng.uniform(0, 1, size=(b, 1, 1, 1, 1))
    base = np.sin(y + 2 * np.pi * (tt + phase)) * np.cos(x - 2 * np.pi * tt)
    return (base + 0.01 * rng.normal(size=(b, t, h, w, c))).astype(np.float32)


@pytest.mark.parametrize("n_modes", [3, 5, None])
def test_forecast_matches_jax(n_modes):
    x = _smooth_frames(np.random.default_rng(1), 2, 8, 12, 10, 3)
    mine = DMD(n_modes=n_modes, n_predict=6, input_feature=2, n_autoregressive=1)
    want = JDMD(n_modes=n_modes, n_predict=6, input_feature=2, n_autoregressive=1)(x)
    got = mine.forecast(x)
    assert got.shape == want.shape == (2, 6, 12, 10, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(mine(torch.from_numpy(x)).numpy(), got)


def test_registry_builds_a_training_free_model():
    m = build_model(shapes=((8, 12, 10, 3), (6, 12, 10, 3)), device="cpu", **KW)
    jb = jbuild(shapes=((8, 12, 10, 3), (6, 12, 10, 3)), **KW)
    assert isinstance(m, DMD) and not m.trainable and not jb.trainable
    assert sum(p.numel() for p in m.parameters()) == 0
    x = torch.from_numpy(_smooth_frames(np.random.default_rng(2), 1, 8, 12, 10, 3))
    out = m.predict(x)
    assert out.device == x.device and out.shape == (1, 6, 12, 10, 2)
    np.testing.assert_array_equal(out.numpy(), jb.predict(None, x.numpy()))
    with pytest.raises(TypeError, match="eval"):
        m.loss(x, x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(shapes=((8, 12, 10, 3), (6, 12, 10, 3)), **KW)


def test_host_rollout_matches_jax():
    r = np.random.default_rng(3)
    x = _smooth_frames(r, 2, 8, 12, 10, 3) * 2.0 + 0.5
    y = _smooth_frames(r, 2, 6, 12, 10, 3)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2.0, 3), std_targets=r.uniform(0.5, 2.0, 3))
    stats = {k: a.astype(np.float32) for k, a in stats.items()}
    shapes = ((8, 12, 10, 3), (6, 12, 10, 3))
    jb = jbuild(shapes=shapes, **KW)
    want = jrollout.make_host_rollout_fn(jb, jnorm.build_normalizer("gaussian", stats=stats), 1)(
        None, x, y, jax.random.PRNGKey(0))
    m = build_model(shapes=shapes, device="cpu", **KW)
    got = make_host_rollout_fn(m, tnorm.build_normalizer("gaussian", stats=stats), 1)(
        torch.from_numpy(x), torch.from_numpy(y))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = tmp_path_factory.mktemp("dmd_tree")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    return str(root)


def _argv(tree, results):
    return ["--config", "cylinder/dmd.yaml", "--dataset_root", tree,
            "--results_path", results, "--num_workers", "0", "--test_batch_size", "4",
            "--n_predict", "4", "--N_plot", "0", "--N_plot_probe", "0",
            "--probe_diagnostic", "false", "--in_step", "4", "--out_step", "4",
            "--interval", "4", "--trunk_length", "8", "--n_sim_frame", "32",
            "--n_sim_in_distribution", "1", "--n_sim_out_distribution", "1",
            "--sub_s_real", "1", "--sub_s_numerical", "1", "--generate_ids_if_missing"]


def test_training_free_eval_matches_jax(tree, tmp_path):
    from realpdebench_tpu.eval.__main__ import run_eval as jrun_eval
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    argv = _argv(tree, str(tmp_path))
    parser = jc.make_arg_parser()
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--test_mode", default="all")
    # the JAX parser takes the config's keys only: overrides go in as kwargs
    args = parser.parse_args(["--config", "cylinder/dmd.yaml"])
    over = dict(zip(argv[2::2], argv[3::2]))
    cfg = jc.merge_config(args)
    cfg = jc.Config(**{**cfg.to_dict(), **{k[2:]: _yaml(v) for k, v in over.items()}},
                    generate_ids_if_missing=True)
    os.makedirs(tmp_path / "jax", exist_ok=True)
    want = jrun_eval(cfg, str(tmp_path / "jax"))
    _, got = eval_main([*argv, "--device", "cpu"])
    assert set(got) == set(want)
    for k, w in want.items():
        if np.isnan(w):          # the mid band is empty on a 16x16 grid
            assert np.isnan(got[k]), k
            continue
        err = abs(got[k] - w) if abs(w) < 1e-2 else abs(got[k] - w) / abs(w)
        assert err <= 1e-5, (k, got[k], w)


def _yaml(v):
    import yaml

    return yaml.safe_load(v)


def test_train_refuses_a_training_free_model(tree, tmp_path):
    from realpdebench_tpu_torch.train.__main__ import main as train_main

    with pytest.raises(ValueError, match="training-free.*eval"):
        train_main([*_argv(tree, str(tmp_path)), "--device", "cpu", "--num_update", "1",
                    "--train_batch_size", "4"])
