"""PyTorch port vs JAX package: the training loop, the eval entry point,
checkpoints and the CLI, on the CPU.

1. ``make_eval_step`` against JAX's on the same weights (carried by the
   ``.pth`` the JAX exporter writes), rtol 2e-4.
2. A trajectory through both loops: JAX writes its initial FNO weights with
   ``save_torch_checkpoint``; both ``run_training``s finetune from that
   ``.pth`` for 4 steps on one synthetic tree (noise and masks on), with a
   validation and a checkpoint after every step. At the tolerance of
   ``tests/test_torch_train.py``'s trajectory test (rtol 2e-4, atol
   2e-4·max|ref|):
   * the train losses of the two loops;
   * the parameters and BatchNorm statistics after the 4 steps, with that
     test's rule for the entries whose true gradient is 0 or below the
     float noise (Adam steps them by up to lr in a direction the noise
     decides): they are held to n·lr, and those not named by rule (the
     conv biases, the imaginary DC weight) to at most 1% of a tensor, and
     the running means to atol + 2·n·lr;
   * every validation metric the port's loop recorded against the JAX
     package's ``run_validation`` on the port's checkpoint of that step.
     The two loops' own validations are not held to each other: in eval
     mode the BatchNorm uses running statistics, so the noise-driven steps
     of the conv biases shift the prediction by a constant, which moves
     the metrics that see the mean (low_f_error, freq_error) by ~3e-3
     after one step at lr 1e-4 (and by ~1e-5 with lr 0).
   Then ``run_eval`` on the port's final checkpoint against the JAX
   ``run_eval`` on the same weights (the port's ``.pth``, read by the JAX
   converter).
3. Checkpoints: a save and restore round trip is bit-equal (parameters,
   buffers, optimizer state and count); resume starts at the saved step
   and continues the optimizer's count; two identical runs are bit-equal.
4. The CLI: train then eval with ``--device cpu`` for the FNO, the UNet
   and the Galerkin Transformer, from the port's own configs.
5. No card and no ``device``: ``run_training`` and ``run_eval`` raise.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from realpdebench_tpu.config import Config as JConfig
from realpdebench_tpu.data.synthetic import make_fluid_tree
from realpdebench_tpu_torch.config import Config

BASE = dict(
    exp_name="loop", seed=0, dataset_name="cylinder", num_workers=0,
    normalizer="gaussian", mask_prob=0.1, noise_scale=0.1,
    model_name="fno", modes1=2, modes2=3, modes3=3, n_layers=2, width=8,
    scheduler="cosine", step_size=100, num_update=4,
    train_batch_size=8, test_batch_size=8, lr=1e-4, clip_grad_norm=0.0,
    N_autoregressive=2, N_plot=0, probe_diagnostic=True, N_plot_probe=0,
    train_data_type="numerical", is_use_tb=False,
    in_step=4, out_step=4, interval=4, trunk_length=8, n_sim_frame=32,
    n_sim_in_distribution=1, n_sim_out_distribution=1,
    sub_s_real=1, sub_s_numerical=1, generate_ids_if_missing=True,
)
SHAPE = (4, 16, 16, 3)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while these small runs go: with the suite's
    workers on every core, a full pool of spinning threads slows them a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rtol=2e-4, err_msg=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()), err_msg=err_msg)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    return str(root)


def _pcfg(root, **kw):
    return Config(**{**BASE, "dataset_root": root, "mesh_shape": None, **kw})


def _jcfg(root, **kw):
    return JConfig(**{**BASE, "dataset_root": root, "mesh_shape": "dp=1,mp=1", **kw})


def _jax_fno_pth(path):
    """JAX FNO3d's initial weights, written as a reference .pth."""
    from realpdebench_tpu.interop.torch_export import save_torch_checkpoint
    from realpdebench_tpu.models.registry import build_model as jbuild

    kw = {k: BASE[k] for k in ("model_name", "modes1", "modes2", "modes3",
                               "n_layers", "width")}
    bundle = jbuild(shapes=(SHAPE, SHAPE), **kw)
    variables = bundle.init(jax.random.PRNGKey(3), np.zeros((1, *SHAPE), np.float32))
    params, state = bundle.split_variables(variables)
    save_torch_checkpoint(path, bundle, params, state)
    return bundle, variables


def test_eval_step_matches_jax(tmp_path):
    from realpdebench_tpu.data import normalizer as jnorm
    from realpdebench_tpu.train.train_step import make_eval_step as jeval
    from realpdebench_tpu_torch.data import normalizer as tnorm
    from realpdebench_tpu_torch.models.registry import build_model
    from realpdebench_tpu_torch.train import make_eval_step

    bundle, variables = _jax_fno_pth(str(tmp_path / "w.pth"))
    r = np.random.default_rng(1)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2, 3), std_targets=r.uniform(0.5, 2, 3))
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    x = r.normal(size=(2, *SHAPE)).astype(np.float32)
    y = r.normal(size=(2, *SHAPE)).astype(np.float32)
    model = build_model(shapes=(SHAPE, SHAPE), device="cpu",
                        **{k: BASE[k] for k in ("model_name", "modes1", "modes2",
                                                "modes3", "n_layers", "width")})
    model.load_state_dict(torch.load(tmp_path / "w.pth")["model_state_dict"], strict=True)
    for c in (2, None):
        ref = jeval(bundle, jnorm.build_normalizer("gaussian", stats=stats), c)(
            variables, x, y, jax.random.PRNGKey(0))
        got = make_eval_step(model, tnorm.build_normalizer("gaussian", stats=stats), c)(
            torch.from_numpy(x), torch.from_numpy(y))
        for g, rr in zip(got, ref):
            _close(g.numpy(), np.asarray(rr))


def _jax_validation(root, ckpt_path):
    """The JAX package's run_validation of the weights in ``ckpt_path``."""
    from realpdebench_tpu.data.loader import DataLoader as JLoader
    from realpdebench_tpu.data.normalizer import build_normalizer as jnorm
    from realpdebench_tpu.interop.torch_convert import load_torch_checkpoint
    from realpdebench_tpu.models.registry import build_model as jbuild
    from realpdebench_tpu.train import loop as jloop
    from realpdebench_tpu.train import train_step as jts

    cfg = _jcfg(root)
    _, val_ds, norm_ds = jloop.build_datasets(cfg, "numerical")
    bundle = jbuild(shapes=(SHAPE, SHAPE), **{k: BASE[k] for k in (
        "model_name", "modes1", "modes2", "modes3", "n_layers", "width")})
    params, ms = bundle.split_variables(
        bundle.init(jax.random.PRNGKey(0), np.zeros((1, *SHAPE), np.float32)))
    params, ms = load_torch_checkpoint(ckpt_path, bundle, params, ms)
    state = jts.TrainState.create(params, ms, jts.build_optimizer(cfg))
    normalizer = jnorm("gaussian", norm_ds)
    return jloop.run_validation(
        state, bundle, jts.make_eval_step(bundle, normalizer, 2),
        JLoader(val_ds, batch_size=BASE["test_batch_size"], pad_last=True),
        2, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def trajectory(root, tmp_path_factory):
    """The 4-step finetune through both loops, and both evaluations."""
    from realpdebench_tpu.eval.__main__ import run_eval as jrun_eval
    from realpdebench_tpu.train.loop import run_training as jrun
    from realpdebench_tpu_torch.eval.__main__ import run_eval
    from realpdebench_tpu_torch.train.loop import run_training

    tmp = tmp_path_factory.mktemp("traj")
    pth = str(tmp / "init.pth")
    _jax_fno_pth(pth)
    ft = dict(is_finetune=True, checkpoint_path=pth)
    jstate, jhist = jrun(_jcfg(root, **ft), str(tmp / "jax"))
    model, opt, phist = run_training(_pcfg(root, **ft), str(tmp / "port"), device="cpu")
    ckpt = os.path.join(str(tmp / "port"), "ckpt")
    jval = [_jax_validation(root, os.path.join(ckpt, f"checkpoint_{i}.pth"))
            for i in range(1, 5)]
    final = os.path.join(ckpt, "checkpoint_4.pth")
    jres = jrun_eval(_jcfg(root, checkpoint_path=final), str(tmp / "jeval"))
    pres = run_eval(_pcfg(root, checkpoint_path=ckpt), str(tmp / "peval"), device="cpu")
    return dict(jstate=jstate, jhist=jhist, phist=phist, jval=jval, jres=jres,
                pres=pres, model=model, opt=opt, init=torch.load(pth)["model_state_dict"])


def test_finetune_trajectory_matches_jax(trajectory):
    from realpdebench_tpu_torch.interop.from_jax import fno_state_dict
    from tests.test_torch_train import _zero_grad_mask

    jh, ph = trajectory["jhist"], trajectory["phist"]
    assert len(ph["train_loss"]) == 4 and np.isfinite(ph["train_loss"]).all()
    _close(ph["train_loss"], jh["train_loss"], err_msg="train_loss")

    n, lr = BASE["num_update"], BASE["lr"]
    js = trajectory["jstate"]
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    want = fno_state_dict(tree(js.params), tree(js.model_state["batch_stats"]))
    real = lambda a: np.stack([a.real, a.imag], -1) if np.iscomplexobj(a) else a
    for name, t in trajectory["model"].state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = real(t.numpy()), real(want[name].numpy())
        if name.endswith("running_mean"):
            np.testing.assert_allclose(got, ref, rtol=2e-4,
                                       atol=2e-4 * np.abs(ref).max() + 2 * n * lr,
                                       err_msg=name)
            continue
        if name.endswith("running_var"):
            _close(got, ref, err_msg=name)
            continue
        off = np.abs(got - ref) > 2e-4 * (np.abs(ref) + np.abs(ref).max())
        zero = _zero_grad_mask(name, got.shape)
        assert int((off & ~zero).sum()) <= 1e-2 * got.size, name
        p0 = real(trajectory["init"][name].numpy())
        for moved in (got - p0, ref - p0):
            assert np.abs(moved[off | zero]).max(initial=0) <= 1.01 * n * lr, name

    assert set(ph["val"]) == set(trajectory["jval"][0])
    for k in ph["val"]:
        assert len(ph["val"][k]) == len(jh["val"][k]) == 4, k
        _close(ph["val"][k], [v[k] for v in trajectory["jval"]], err_msg=k)


def test_run_eval_matches_jax_on_the_same_weights(trajectory):
    jr, pr = trajectory["jres"], trajectory["pres"]
    assert set(pr) == set(jr)
    for k, ref in jr.items():
        _close(pr[k], ref, err_msg=k)


def test_checkpoint_round_trip_is_bit_equal(trajectory, tmp_path):
    from realpdebench_tpu_torch.models.registry import build_model
    from realpdebench_tpu_torch.train import build_optimizer
    from realpdebench_tpu_torch.train.checkpoint import CheckpointManager

    model, opt = trajectory["model"], trajectory["opt"]
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=1)
    mgr.save(3, model, opt, metadata={"best_iteration": 2})
    mgr.save(7, model, opt, metadata={"best_iteration": 5})
    mgr.wait()
    assert mgr.all_steps() == [7]
    fresh = build_model(shapes=(SHAPE, SHAPE), device="cpu",
                        **{k: BASE[k] for k in ("model_name", "modes1", "modes2",
                                                "modes3", "n_layers", "width")})
    fresh_opt = build_optimizer(_pcfg(""), fresh.parameters())
    step, meta = mgr.restore(fresh, fresh_opt)
    assert step == 7 and meta["best_iteration"] == 5 and meta["iteration"] == 7
    for (n, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(a, b), n
    assert fresh_opt.count == opt.count == 4
    sa, sb = opt.adam.state_dict(), fresh_opt.adam.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_resume_continues_and_runs_are_bit_equal(root, tmp_path):
    from realpdebench_tpu_torch.train.loop import run_training

    _, opt1, h1 = run_training(_pcfg(root, num_update=2), str(tmp_path / "a"), device="cpu")
    assert opt1.count == 2
    _, opt2, h2 = run_training(_pcfg(root, num_update=4, resume=True),
                               str(tmp_path / "a"), device="cpu")
    assert h2["perf"]["start_iteration"] == 2 and len(h2["train_loss"]) == 2
    assert opt2.count == 4
    # the same run twice: the same losses and metrics, bit for bit
    _, _, h3 = run_training(_pcfg(root, num_update=2), str(tmp_path / "b"), device="cpu")
    assert h3["train_loss"] == h1["train_loss"]
    assert h3["val"].keys() == h1["val"].keys()
    for k, v in h1["val"].items():
        np.testing.assert_array_equal(h3["val"][k], v, err_msg=k)   # nan == nan


@pytest.mark.parametrize("model", ["fno", "unet", "galerkin_transformer"])
def test_cli_train_then_eval_on_the_cpu(root, tmp_path, model):
    from realpdebench_tpu_torch.cli import main

    sizes = {
        "fno": ["--modes1", "2", "--modes2", "3", "--modes3", "3", "--n_layers", "2",
                "--width", "8"],
        "unet": ["--dim_mults", "[1, 2]"],
        "galerkin_transformer": ["--n_hidden", "16", "--n_head", "2",
                                 "--dim_feedforward", "16", "--fourier_modes_x", "2",
                                 "--fourier_modes_y", "2", "--fourier_modes_t", "2",
                                 "--freq_dim", "8"],
    }[model]
    common = ["--config", f"cylinder/{model}.yaml", "--dataset_root", root,
              "--device", "cpu", "--results_path", str(tmp_path), "--num_workers", "0",
              "--train_batch_size", "4", "--test_batch_size", "4",
              "--N_autoregressive", "2", "--N_plot", "0", "--N_plot_probe", "0",
              "--is_use_tb", "false", "--num_update", "2", *sizes,
              *[f"--{k}={BASE[k]}" for k in ("in_step", "out_step", "interval",
                                              "trunk_length", "n_sim_frame",
                                              "n_sim_in_distribution",
                                              "n_sim_out_distribution", "sub_s_real",
                                              "sub_s_numerical",
                                              "generate_ids_if_missing")]]
    with pytest.raises(SystemExit) as e:
        main(["train", *common])
    assert e.value.code == 0
    (ckpt,) = glob.glob(os.path.join(str(tmp_path), model, "*_numerical_False", "*", "ckpt"))
    assert sorted(os.listdir(ckpt)) == ["checkpoint_1.pth", "checkpoint_2.pth"]
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    _, results = eval_main([*common, "--checkpoint_path", ckpt])
    for k in ("rmse", "rel_l2_error", "normalized_mse"):
        assert np.isfinite(results[k]), k
    # the FNO and UNet configs ask for the probe diagnostic, GK's does not
    assert np.isfinite(results.get("probe_error", 0.0))
    assert ("probe_error" in results) == (model != "galerkin_transformer")


def test_entry_points_default_to_the_card_and_never_fall_back(root, tmp_path, monkeypatch):
    from realpdebench_tpu_torch.eval.__main__ import run_eval
    from realpdebench_tpu_torch.train.loop import run_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(_pcfg(root), str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_eval(_pcfg(root, checkpoint_path=str(tmp_path)), str(tmp_path))
    # a mesh wider than the processes (one process here) raises, as JAX's
    # parse_mesh_shape does for more devices than there are
    with pytest.raises(ValueError, match="uses 2 devices but 1 available"):
        run_training(_pcfg(root, mesh_shape="dp=2"), str(tmp_path), device="cpu")
    # the CLI's --device defaults to cuda: without a card it raises too
    from realpdebench_tpu_torch.cli import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train", "--config", "cylinder/fno.yaml", "--dataset_root", root,
              "--results_path", str(tmp_path), "--num_workers", "0",
              "--generate_ids_if_missing"])


def test_an_orbax_directory_is_refused_with_the_way_out(tmp_path):
    from realpdebench_tpu_torch.models.registry import build_model
    from realpdebench_tpu_torch.train.loop import load_reference_or_orbax_checkpoint

    (tmp_path / "4" / "state").mkdir(parents=True)     # orbax's step layout
    model = build_model(shapes=(SHAPE, SHAPE), device="cpu",
                        **{k: BASE[k] for k in ("model_name", "modes1", "modes2",
                                                "modes3", "n_layers", "width")})
    with pytest.raises(NotImplementedError, match="orbax.*export-torch"):
        load_reference_or_orbax_checkpoint(str(tmp_path), model)


def test_step_timer_syncs_once_a_window():
    from realpdebench_tpu_torch.utils.profiling import StepTimer

    syncs = []
    timer = StepTimer(warmup=2, window=3, sync=lambda: syncs.append(1))
    for _ in range(11):
        timer.tick()
    # the warm-up's end, then one sync closing each window of 3 ticks
    assert len(syncs) == 4 and len(timer.windows) == 3
    assert [n for n, _ in timer.windows] == [3, 3, 3]
    summary = timer.summary()
    assert summary["windows"] == 3 and summary["steps_per_sec"] == timer.steps_per_sec > 0


@pytest.mark.parametrize("parts", [(), ("train", "numerical"), ("val", "real", 3)])
def test_derive_seed_equals_jax(parts):
    from realpdebench_tpu.utils.misc import derive_seed as jderive
    from realpdebench_tpu_torch.utils.misc import derive_seed

    for seed in (0, 7, 2**31 - 1):
        assert derive_seed(seed, *parts) == jderive(seed, *parts)
