"""The port's model parallelism (``core/partitioning.py``), on the CPU.

1. The leaf rule: for each of the nine trainable families at a tiny size
   and mp 2 and 4, every JAX parameter leaf is filled with its index along
   its last axis (positive where JAX's ``param_shardings`` shards it,
   negative where it replicates it) and carried across with
   ``interop/from_jax``: ``shard_dims`` shards exactly the tensors JAX
   shards, along the dim where that index varies, and replicates the rest,
   those whose axis mp does not divide included.
2. ``n_total``: the scores' twin and its autograd on two token halves with
   ``n_total`` = N, summed, equal the full scores and their gradients.
3. Two gloo ranks at ``dp=1,mp=2`` (``tests/torch_mp_worker.py``, one spawn
   for every case): 3 steps of the FNO (Adam's state sharded), the GK with
   ``seq_shard`` (dropout on) and the Transolver with ``seq_shard`` (H 8
   over 2 ranks) against the one-process step on the same global batches,
   at ``tests/test_torch_train.py``'s trajectory bars, with each rank's
   moments 1/mp of each sharded leaf; and the GK's ``seq_shard`` step
   against JAX's GSPMD step (``seq_mesh``, ``shard_train_state`` on 2 of
   the 8 host devices), the same dropout masks fed to both.
4. The loop: 2 steps of ``run_training`` of the GK under ``dp=1,mp=2`` with
   ``seq_shard`` against one process (rank 0's checkpoint file equal to
   the one process's), a 1-step resume, and ``run_eval`` of its checkpoint.

torch runs on one intra-op thread here, as the other small CPU runs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

from realpdebench_tpu.config import Config as JConfig
from realpdebench_tpu.core import mesh as jmesh
from realpdebench_tpu.core.partitioning import param_shardings
from realpdebench_tpu.core.partitioning import shard_train_state as jshard_train_state
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_convert import convert_galerkin
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch.core import partitioning
from realpdebench_tpu_torch.interop import from_jax
from realpdebench_tpu_torch.interop.from_jax import galerkin_state_dict
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.ops import galerkin as tga
from tests import torch_mp_worker as worker


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(got, ref) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-300))


# --------------------------------------------------------------------------
# 1. the leaf rule
# --------------------------------------------------------------------------

# name: (model keywords, (shape_in, shape_out), from_jax converter); the
# tiny sizes of each family's tests/test_torch_<family>.py
FAMILIES = {
    "fno": (worker.FNO, worker.CASES["fno"][1], from_jax.fno_state_dict),
    "unet": (dict(model_name="unet", dim_mults=[1, 2], remat=False), ((4, 16, 16, 3),) * 2,
             from_jax.unet_state_dict),
    "galerkin_transformer": (worker.GK, ((4, 8, 8, 3),) * 2, from_jax.galerkin_state_dict),
    "deeponet": (dict(model_name="deeponet", p=16, dropout_rate=0.1), ((4, 16, 16, 3),) * 2,
                 from_jax.deeponet_state_dict),
    "transolver": (worker.TRANSOLVER, ((4, 8, 8, 3),) * 2, from_jax.transolver_state_dict),
    "dpot": (dict(model_name="dpot", model_type="dpot", img_size=16, in_channels=4,
                  out_channels=4, in_timesteps=4, out_timesteps=4, patch_size=4, embed_dim=32,
                  depth=1, n_blocks=4, modes=3, mlp_ratio=2, out_layer_dim=8, n_cls=3,
                  act="gelu", time_agg="exp_mlp"), ((4, 12, 20, 3),) * 2,
             from_jax.dpot_state_dict),
    "cno": (dict(model_name="cno", N_layers=2, N_res=1, N_res_neck=2, channel_multiplier=8,
                 latent_lift_proj_dim=8, activation="LeakyReLU"), ((4, 16, 16, 3),) * 2,
            from_jax.cno_state_dict),
    "mwt": (dict(model_name="mwt", k=3, alpha=3, c=2, nCZ=2, L=0, base="legendre"),
            ((4, 16, 32, 3),) * 2, from_jax.mwt_state_dict),
    "wdno": (dict(model_name="wdno", dim=8, dim_mults=[1, 2], wave_type="bior1.1",
                  pad_mode="zero", beta_schedule="sigmoid", timesteps=20, sampling_timesteps=4,
                  ddim_sampling_eta=1.0), ((4, 8, 8, 2),) * 2,
             lambda p: from_jax.wdno_state_dict(p, "sigmoid", 20)),
}


def _filled(leaf, sharding=None):
    """The leaf's index along its last axis (from 1): positive where
    ``sharding`` puts that axis on mp, negative elsewhere."""
    if leaf.ndim == 0:
        return np.float32(-1)
    spec = sharding.spec if sharding is not None else ()
    sign = 1 if len(spec) == leaf.ndim and spec[-1] == jmesh.MODEL_AXIS else -1
    idx = sign * np.arange(1, leaf.shape[-1] + 1, dtype=np.float32)
    return np.broadcast_to(idx, leaf.shape).copy()


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_leaf_rule_matches_jax_param_shardings(family, mp):
    kw, (si, so), convert = FAMILIES[family]
    model = build_model(shapes=(si, so), device="meta", **kw)
    jb = jbuild(shapes=(si, so), **kw)
    if family == "wdno":      # its UNet sees the padded wavelet coefficients
        x0 = jnp.zeros((1, *model.model_shape, model.channels))
        shapes = jax.eval_shape(lambda: jb.module.init(jax.random.PRNGKey(0), x0))
    else:
        shapes = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0), jnp.zeros((1, *si))))
    shardings = param_shardings(shapes["params"], jmesh.make_mesh_context(f"dp=1,mp={mp}"))
    params = jax.tree_util.tree_map(_filled, shapes["params"], shardings)
    stats = jax.tree_util.tree_map(_filled, shapes.get("batch_stats", {}))
    sd = (convert(params, stats) if family in ("fno", "galerkin_transformer", "deeponet", "cno")
          else convert(params))
    dims = partitioning.shard_dims(model, mp)
    n_sharded = 0
    for name, p in model.named_parameters():
        t = sd[name].real if sd[name].is_complex() else sd[name]
        assert t.shape == p.shape, name
        if bool((t > 0).all()):             # JAX shards it
            varies = [i for i in range(t.dim())
                      if t.shape[i] > 1 and not bool((t == t.narrow(i, 0, 1)).all())]
            assert varies == [dims.get(name)], (name, varies, dims.get(name))
            n_sharded += 1
        else:
            assert bool((t < 0).all()), name
            assert name not in dims, (name, dims[name])
    assert n_sharded == len(dims) > 0


# --------------------------------------------------------------------------
# 2. the scores on token shards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 64, 2, 8), (3, 40, 4, 16)])
def test_scores_on_token_halves_sum_to_the_whole(shape):
    """n_total = N on each half of the tokens: the halves' scores and the
    gradients through them (the backward's recompute divides by n_total
    too) sum to the full scores' (f32, 1e-6 relative)."""
    B, N, h, d = shape
    r = np.random.default_rng(sum(shape))
    t = lambda *s, loc=0.0: torch.from_numpy(r.normal(loc, 1.0, size=s).astype(np.float32))
    k, v = t(B, N, h * d, loc=1.0), t(B, N, h * d, loc=-0.5)
    aff = [1 + 0.1 * t(h, d), 0.1 * t(h, d), 1 + 0.1 * t(h, d), 0.1 * t(h, d)]
    ct = t(B, h, d, d)

    def run(halves: bool):
        leaves = [x.clone().requires_grad_() for x in (k, v, *aff)]
        kk, vv, *a = leaves
        if halves:
            n = N // 2
            out = sum(tga.galerkin_scores(kk[:, s], vv[:, s], *a, h, 1e-5, n_total=N)
                      for s in (slice(0, n), slice(n, N)))
        else:
            out = tga.galerkin_scores(kk, vv, *a, h, 1e-5)
        return out.detach(), torch.autograd.grad(out, leaves, ct)

    (got, got_g), (ref, ref_g) = run(True), run(False)
    assert _rel_l2(got, ref) <= 1e-6
    plain = sum(tga.galerkin_scores_plain(k[:, s], v[:, s], *aff, h, 1e-5, N)
                for s in (slice(0, N // 2), slice(N // 2, N)))
    assert _rel_l2(plain, ref) <= 1e-6
    for g, w in zip(got_g, ref_g):
        assert _rel_l2(g, w) <= 1e-6
    with pytest.raises(ValueError, match="n_total"):
        tga.galerkin_scores(k, v, *aff, h, 1e-5, n_total=N - 1)


# --------------------------------------------------------------------------
# 3. two ranks at dp=1,mp=2
# --------------------------------------------------------------------------


def spawn(fn, world: int, *args):
    tmp_mp.start_processes(fn, args=(world, *args), nprocs=world, join=True,
                           start_method="spawn")


def spawn_steps(d, spec: str, names) -> list:
    """Each rank's results of ``names`` under ``spec`` (one spawn)."""
    world = 4 if spec == "dp=2,mp=2" else 2
    spawn(worker.steps_main, world, str(d / "store"), spec, tuple(names), str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def mp_steps(tmp_path_factory):
    return spawn_steps(tmp_path_factory.mktemp("mp_steps"), "dp=1,mp=2", worker.CASES)


def zero_grad_mask(name: str, shape) -> np.ndarray:
    """Entries whose true gradient is 0 (on the real view): a pointwise
    conv's bias, which the BatchNorm after it cancels, and the imaginary
    part of the DC mode's spectral weight (tests/test_torch_train.py)."""
    parts = name.split(".")
    mask = np.full(shape, len(parts) > 2 and parts[-3] == "convs" and parts[-1] == "bias")
    if name.endswith(".weights1") and len(shape) == 6:
        mask[:, :, 0, 0, 0, 1] = True
    return mask


def assert_steps_match(got: dict, ref: dict, init: dict, lr: float, steps: int):
    """``got`` against the one-process run ``ref`` from the state ``init``:
    the losses and the state after at tests/test_torch_train.py's
    trajectory bars (rtol 2e-4, atol 2e-4·max|ref|; entries whose true
    first gradient is 0 or below the float noise, |g| < 1e-5·max|g| of the
    tensor (of the mode, for a spectral weight; at most 1% of a tensor),
    or whose first gradients the two runs do not agree on to 1e-3 of its
    size (f32 noise that Adam, dividing each update by the gradient's own
    size, carries into the step; the tensor's gradient is held to 1e-4
    below), held to Adam's bound 1.01·steps·lr from init; the running means
    also to 2·steps·lr), and
    the first gradients at the f32 bar (1e-4 relative L2; one whose true
    value is below 1e-5 of the model's largest, only as small)."""
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-4,
                               atol=2e-4 * max(map(abs, ref["losses"])))
    top = max(float(g.norm()) for g in ref["grads"].values())
    assert got["grads"].keys() == ref["grads"].keys()
    for n, g in ref["grads"].items():
        if float(g.norm()) <= 1e-5 * top:
            assert float(got["grads"][n].norm()) <= 1e-5 * top, n
        else:
            assert _rel_l2(got["grads"][n], g) <= 1e-4, (n, _rel_l2(got["grads"][n], g))
    real = lambda t: (torch.view_as_real(t) if t.is_complex() else t).double().numpy()
    for n, t in ref["state"].items():
        if n.endswith("num_batches_tracked"):
            assert torch.equal(got["state"][n], t), n
            continue
        a, b = real(got["state"][n]), real(t)
        atol = 2e-4 * np.abs(b).max()
        if n.endswith("running_mean"):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=atol + 2 * steps * lr, err_msg=n)
            continue
        if n in ref["grads"]:
            g = np.abs(ref["grads"][n].double().numpy())
            scale = g.max(axis=(0, 1), keepdims=True) if g.ndim == 6 else g.max()
            zero, tiny = zero_grad_mask(n, g.shape), g < 1e-5 * scale
            assert (tiny & ~zero).sum() <= max(1e-2 * g.size, 1), n
            noisy = np.abs(got["grads"][n].double().numpy() - ref["grads"][n].double().numpy())
            mask = zero | tiny | (noisy > 1e-3 * g)
            p0 = real(init[n])
            for moved in (a - p0, b - p0):
                assert np.abs(moved[mask]).max(initial=0) <= 1.01 * steps * lr, n
            a = np.where(mask, b, a)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=atol, err_msg=n)


def assert_moments_sharded(results: list, case: str, mp: int):
    """Each rank holds 1/mp of every sharded leaf's moments (along its
    shard dim) and the whole of every other."""
    model = worker.model_for(case)
    dims = partitioning.shard_dims(model, mp)
    for r in results:
        moments = r["results"][case]["moments"]
        for n, p in model.named_parameters():
            want = list(p.shape)
            if n in dims:
                want[dims[n]] //= mp
            assert moments[n] == tuple(want), (n, moments[n], want)


def test_mp2_ranks_see_the_mesh_and_its_collectives(mp_steps):
    assert [r["ctx"] for r in mp_steps] == [(1, 2, 0, 0, True), (1, 2, 0, 1, True)]
    c = mp_steps[0]["collectives"]
    n = len(worker.CASES) * worker.STEPS
    # the mp group: an all-gather of the master slices a step, the token
    # splits' gradients and gathers, the halos and the cross-token sums; the
    # dp group (one rank here): the gradients and the loss a step
    assert c["mp"]["all_gather"] >= n and c["mp"]["all_reduce"] >= n
    assert c["dp"]["all_reduce"] >= 2 * n and c["world"]["broadcast"] > 0
    assert c["dp"]["all_gather"] == c["mp"]["broadcast"] == 0


@pytest.mark.parametrize("case", ["fno", "galerkin_transformer", "transolver"])
def test_an_mp2_step_equals_the_one_process_step(mp_steps, case):
    ref = worker.run_case(case)
    init = {n: t.clone() for n, t in worker.model_for(case).state_dict().items()}
    for r in mp_steps:
        assert_steps_match(r["results"][case], ref, init, worker.LR, worker.STEPS)
    assert_moments_sharded(mp_steps, case, 2)


def test_the_gk_seq_shard_step_equals_jax_gspmd(mp_steps):
    """The GK's seq_shard step at mp 2 against JAX's GSPMD step at mp 2
    (``seq_mesh``, the state placed by ``shard_train_state``) from the same
    weights, batches and dropout masks (numpy, in call order: rbg streams
    cannot match), at the trajectory bars."""
    from tests.test_torch_galerkin import Masks
    from tests.torch_trajectory import adam_mu

    case = "galerkin_transformer_jax"
    kw, (si, so), b, _, seed = worker.CASES[case]
    model = worker.model_for(case)
    init = {n: t.clone() for n, t in model.state_dict().items()}
    sd = {k: t.numpy().copy() for k, t in init.items()}
    params, state = convert_galerkin(sd, None, {})
    ctx = jmesh.make_mesh_context("dp=1,mp=2")
    jb = jbuild(shapes=(si, so), **kw, seq_mesh=ctx.mesh)
    cfg = dict(lr=worker.LR, scheduler="cosine", num_update=10, clip_grad_norm=0.0)
    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    jstate = jshard_train_state(jts.TrainState.create(
        tree(params), tree(state), jts.build_optimizer(JConfig(**cfg))), ctx)
    norm = jnorm.build_normalizer("gaussian", stats=worker.stats(si[-1]))
    xs, ys = worker.batches(case)
    masks, losses, first = Masks(seed), [], None
    for i in range(worker.STEPS):
        # a step built anew each time: its trace draws its own masks
        step = jts.make_train_step(jb, norm, ctx)
        with masks:
            jstate, loss = step(jstate, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                                jax.random.PRNGKey(i))
        losses.append(float(loss))
        if i == 0:      # Adam's first moment after one update is 0.1·g
            mu = adam_mu(jstate.opt_state)
            first = galerkin_state_dict(jax.tree_util.tree_map(lambda a: np.asarray(a) * 10, mu),
                                        jax.tree_util.tree_map(np.asarray,
                                                               jstate.model_state["batch_stats"]))
    assert masks.n_jax == 8 * worker.STEPS
    want = galerkin_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                               jax.tree_util.tree_map(np.asarray,
                                                      jstate.model_state["batch_stats"]))
    real = lambda t: torch.view_as_real(t) if t.is_complex() else t
    ref = dict(losses=losses, state=want,
               grads={n: real(first[n]) for n, _ in model.named_parameters()})
    for r in mp_steps:
        assert_steps_match(r["results"][case], ref, init, worker.LR, worker.STEPS)


# --------------------------------------------------------------------------
# 4. the loop, a resume and eval under dp=1,mp=2 with seq_shard
# --------------------------------------------------------------------------

LOOP_CFG = dict(
    exp_name="mp", seed=0, dataset_name="cylinder", num_workers=0, normalizer="gaussian",
    mask_prob=0.0, noise_scale=0.0, **{k: v for k, v in worker.GK.items()},
    scheduler="cosine", step_size=100, num_update=2, train_batch_size=4, test_batch_size=6,
    lr=1e-7, clip_grad_norm=0.0, grad_accum=1, N_autoregressive=2, N_plot=0,
    train_data_type="numerical", is_use_tb=False, in_step=4, out_step=4, interval=4,
    trunk_length=8, n_sim_frame=32, n_sim_in_distribution=1, n_sim_out_distribution=1,
    sub_s_real=1, sub_s_numerical=1, generate_ids_if_missing=True, test_mode="all")


def _assert_checkpoints_equal(a: dict, b: dict, steps: int):
    """Two checkpoint files: the same keys, the parameters and statistics
    at the trajectory bar, Adam's first moments at the gradient bar (1e-4
    relative L2; one whose true gradient is 0, below 1e-5 of the largest,
    only as small) and the second moments at twice it."""
    assert a.keys() == b.keys() and a["optimizer_count"] == b["optimizer_count"]
    for n, t in b["model_state_dict"].items():
        if t.is_floating_point() or t.is_complex():
            torch.testing.assert_close(a["model_state_dict"][n], t, rtol=2e-4,
                                       atol=2e-4 * float(t.abs().max()) + 2 * steps * 1e-7)
    states = b["optimizer_state_dict"]["state"]
    top = max(float(s["exp_avg"].abs().norm()) for s in states.values())
    real = lambda t: torch.view_as_real(t) if t.is_complex() else t
    for i, s_ref in states.items():
        s_got = a["optimizer_state_dict"]["state"][i]
        for k in ("exp_avg", "exp_avg_sq"):
            assert s_got[k].shape == s_ref[k].shape, (i, k)
        if float(s_ref["exp_avg"].abs().norm()) <= 1e-5 * top:   # a true zero: noise
            assert float(s_got["exp_avg"].abs().norm()) <= 1e-5 * top, i
            continue
        for k in ("exp_avg", "exp_avg_sq"):     # the second moment: twice the first's error
            rel = _rel_l2(real(s_got[k]), real(s_ref[k]))
            assert rel <= (1e-4 if k == "exp_avg" else 2e-4), (i, k, rel)


def test_an_mp2_seq_shard_loop_resume_and_eval_equal_one_process(tmp_path):
    """2 steps of run_training of the GK under dp=1,mp=2 with seq_shard
    (validation after each), a resume to step 3, and run_eval of step 3's
    checkpoint, against the same in one process: rank 0's checkpoint files
    (the moments gathered: one process's file), the validation metrics and
    the 13 eval metrics within 1e-5. mask_prob and noise 0; lr 1e-7, so
    that the float-noise steps Adam takes on the gradients BatchNorm
    cancels stay below the metrics' 1e-5."""
    from realpdebench_tpu_torch.config import Config
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree
    from realpdebench_tpu_torch.eval.__main__ import run_eval
    from realpdebench_tpu_torch.train.loop import run_training

    root = str(tmp_path / "tree")
    make_fluid_tree(root, "cylinder", n_sim=5, n_frame=32, h=8, w=8)
    cfg = dict(LOOP_CFG, dataset_root=root)
    one = str(tmp_path / "one")
    _, _, ref_hist = run_training(Config(**cfg), one, device="cpu")
    _, _, ref_resumed = run_training(Config(**dict(cfg, num_update=3, resume=True)), one,
                                     device="cpu")
    ref_metrics = run_eval(Config(**cfg, checkpoint_path=os.path.join(
        one, "ckpt", "checkpoint_3.pth")), str(tmp_path / "one_eval"), device="cpu")
    spawn(worker.loop_main, 2, str(tmp_path / "store"), cfg, str(tmp_path))
    got = torch.load(tmp_path / "loop.pt", weights_only=False)
    for hist, ref in ((got["history"], ref_hist), (got["resumed"], ref_resumed)):
        np.testing.assert_allclose(hist["train_loss"], ref["train_loss"], rtol=1e-5)
        for k, vals in ref["val"].items():
            for a, b in zip(hist["val"][k], vals, strict=True):
                assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-5 * max(abs(b), 1e-2), \
                    (k, a, b)
    for k, b in ref_metrics.items():
        a = got["metrics"][k]
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-5 * max(abs(b), 1e-2), (k, a, b)
    load = lambda d, s: torch.load(os.path.join(d, "ckpt", f"checkpoint_{s}.pth"),
                                   weights_only=False)
    for s in (2, 3):
        _assert_checkpoints_equal(load(got["exp"], s), load(one, s), s)
