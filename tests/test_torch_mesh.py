"""The port's mesh and data parallelism (``core/mesh.py``), on the CPU.

1. ``parse_mesh_shape``, ``pad_batch`` and ``local_batch_slice`` against
   the JAX package's, for a table of specs and device counts, errors
   included; ``make_mesh_context`` takes a model axis with JAX's rank
   layout (rank r at (r // mp, r % mp)) and refuses a foreign axis or a
   dp·mp other than the world size.
2. The process-sharded loader, bit-equal to the JAX ``DataLoader`` with
   ``process_shard=True, process_count=2, process_index=i``.
3. The loops' step (a mesh, grad_accum 2: strided microbatches) held to
   JAX's ``make_train_step`` with a ``dp=1`` mesh context over 3 steps of
   the tiny FNO with BatchNorm, at ``tests/test_torch_train.py``'s
   trajectory bars, including the running statistics (contiguous
   microbatches fail it).
4. Two-process gloo runs (``tests/torch_dp_worker.py``; a file store in
   the tmp path, no network): a dp = 2 step of the FNO, DeepONet and the
   Galerkin Transformer (dropout on) at grad_accum 1 and 2, and at batch 6
   with grad_accum 2, of WDNO (its t and noise drawn for the global batch)
   at grad_accum 2 and of CNO with remat (its BatchNorms' all-reduce run
   again in the recomputed forward), against the one-process step on the global batch at
   the f32 bars (loss 1e-5; gradients and statistics 1e-4 relative L2; a
   gradient whose true value is 0, below 1e-5 of the model's largest, only
   as small; DeepONet's grad_accum-2 cases against its float64 step, see
   the test); and a 2-step ``run_training`` under dp = 2 against the
   one-process run: rank 0's checkpoint (Adam's first moments at the
   gradient bar, the statistics, the parameters) and the validation
   metrics within 1e-5.
5. Four gloo ranks at ``dp=2,mp=2`` (``tests/torch_mp_worker.py``, one
   spawn): 3 steps of the GK with ``seq_shard`` (its regressor's BatchNorm
   summed over the dp group) and of the FNO against one process, at the
   trajectory bars, with each rank's moments half of each sharded leaf.

torch runs on one intra-op thread here, as the other small CPU runs.
"""

import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp

from realpdebench_tpu.core import mesh as jmesh
from realpdebench_tpu.data.loader import DataLoader as JDataLoader
from realpdebench_tpu_torch.core import mesh
from realpdebench_tpu_torch.data.loader import DataLoader
from tests import torch_dp_worker as worker
from tests import torch_mp_worker as mp_worker


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raised(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the type and message are what is compared
        return (type(e).__name__, str(e))


MESH_SPECS = [None, "", "dp=4", "dp=2,mp=2", "mp=2", "dp=-1", "dp=-1,mp=2", "mp=-1,dp=2",
              "dp=8", "dp=-1,mp=-1", "dp=3", "dp=2, mp=1", "mp=1"]


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("spec", MESH_SPECS)
def test_parse_mesh_shape_matches_jax(spec, n_devices):
    got = _raised(lambda: mesh.parse_mesh_shape(spec, n_devices))
    want = _raised(lambda: jmesh.parse_mesh_shape(spec, n_devices))
    assert got == want
    if got[0] == "ok":
        assert list(got[1]) == list(want[1])      # the axes' order too


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_pad_batch_and_local_batch_slice_match_jax(monkeypatch, dp):
    ctx = mesh.MeshContext(dp_size=dp)
    for n in (1, 5, 8, 13, 32, 64):
        assert ctx.pad_batch(n) == ((n + dp - 1) // dp) * dp
        # JAX's pad_batch on a mesh of dp devices of its kind (a stub mesh)
        class _M:
            shape = {"dp": dp, "mp": 1}
        assert ctx.pad_batch(n) == jmesh.MeshContext(mesh=_M()).pad_batch(n)
    for idx in range(dp):
        monkeypatch.setattr(mesh, "world_size", lambda: dp)
        monkeypatch.setattr(mesh, "rank", lambda idx=idx: idx)
        monkeypatch.setattr(jmesh.jax, "process_count", lambda: dp)
        monkeypatch.setattr(jmesh.jax, "process_index", lambda idx=idx: idx)
        for gb in (dp, 4 * dp, 6 * dp):
            assert mesh.local_batch_slice(gb) == jmesh.local_batch_slice(gb)


@pytest.mark.parametrize("spec", ["dp=2,mp=2", "dp=1,mp=4", "mp=2,dp=2", "dp=4", "mp=-1,dp=2"])
def test_make_mesh_context_takes_a_model_axis_in_jax_rank_layout(monkeypatch, spec):
    """dp·mp = the world size; rank r sits where the JAX mesh puts device r
    (``make_mesh_context``'s devices[:n] reshaped to the axes in the spec's
    order: (r // mp, r % mp) for dp=…,mp=…). Without a process group there
    are no groups."""
    ctx = mesh.make_mesh_context(None)
    assert (ctx.dp_size, ctx.mp_size, ctx.distributed) == (1, 1, False)
    assert mesh.make_mesh_context("dp=1,mp=1").dp_size == 1
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    jctx = jmesh.make_mesh_context(spec, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jctx.mesh.devices)
    for r in range(4):
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        ctx = mesh.make_mesh_context(spec)
        assert (ctx.dp_size, ctx.mp_size) == (jctx.dp_size, jctx.mp_size)
        at = {"dp": ctx.dp_index, "mp": ctx.mp_index}
        assert ids[tuple(at[n] for n in jctx.mesh.axis_names)] == jax.devices()[r].id
        assert (ctx.dp_group, ctx.mp_group, ctx.distributed) == (None, None, False)
        assert mesh.local_batch_slice(8, ctx) == slice(ctx.dp_index * 8 // ctx.dp_size,
                                                       (ctx.dp_index + 1) * 8 // ctx.dp_size)


def test_make_mesh_context_refuses_a_model_axis_and_a_foreign_dp(monkeypatch):
    """A model axis the world does not hold (dp·mp other than the world
    size), a foreign dp and an unknown axis are refused."""
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    with pytest.raises(ValueError, match="world size is 4"):
        mesh.make_mesh_context("dp=2")
    with pytest.raises(ValueError, match="world size is 4"):
        mesh.make_mesh_context("dp=1,mp=2")
    with pytest.raises(ValueError, match="unknown axes"):
        mesh.make_mesh_context("dp=2,tp=2")
    with pytest.raises(ValueError, match="uses 8 devices"):
        mesh.make_mesh_context("dp=4,mp=2")
    assert mesh.make_mesh_context(None).dp_size == 4      # null: dp = world size
    assert mesh.make_mesh_context("dp=-1").dp_size == 4
    assert mesh.make_mesh_context("mp=-1").mp_size == 4


def test_without_torchrun_nothing_is_started(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") == "cpu"
    assert mesh.maybe_initialize_distributed(None) is None
    assert not torch.distributed.is_initialized()
    a = torch.arange(6.0).view(2, 3)
    assert mesh.allgather_to_host(a) is a
    assert mesh.assemble_from_process_local(a) is a


class _Items:
    """A map-style dataset of 23 numbered windows."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        x = np.full((2, 3), i, np.float32)
        return x, x[:1] * 2


@pytest.mark.parametrize("kind", ["train", "val"])
def test_process_sharded_loader_matches_jax(kind):
    kw = (dict(batch_size=8, shuffle=True, drop_last=True, seed=3) if kind == "train"
          else dict(batch_size=6, shuffle=False, pad_last=True))
    for index in range(2):
        got = DataLoader(_Items(), process_shard=True, process_count=2, process_index=index,
                         **kw)
        want = JDataLoader(_Items(), process_shard=True, process_count=2,
                           process_index=index, **kw)
        for _ in range(2):       # two epochs: the permutation's stream too
            gb, wb = list(got), list(want)
            assert len(gb) == len(wb) > 0
            for g, w in zip(gb, wb):
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        DataLoader(_Items(), batch_size=5, process_shard=True, process_count=2,
                   process_index=0)
    with pytest.raises(ValueError, match="needs pad_last=True"):
        list(DataLoader(_Items(), batch_size=6, process_shard=True, process_count=2,
                        process_index=0))


@pytest.mark.parametrize("sched", ["cosine"])
def test_loop_step_with_a_mesh_matches_the_jax_loops_strided_step(monkeypatch, sched):
    """grad_accum 2 under a dp=1 mesh: microbatch i is rows {2r + i}, as the
    JAX loop's step makes it; 3 steps against JAX's at the trajectory
    bars, the running statistics included."""
    from tests.test_torch_train import run_trajectory

    run_trajectory(monkeypatch, sched, 0.0, 2, jmesh.make_mesh_context("dp=1"),
                   mesh.make_mesh_context("dp=1"))


def _spawn(fn, *args):
    tmp_mp.start_processes(fn, args=(2, *args), nprocs=2, join=True, start_method="spawn")


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_steps")
    _spawn(worker.step_main, str(d / "store"), str(d / "steps.pt"))
    return torch.load(d / "steps.pt", weights_only=False)


def _rel_l2(got, ref) -> float:
    return float((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-300))


def test_dp2_ranks_see_the_mesh_and_its_collectives(dp_steps):
    assert dp_steps["ctx"] == (2, 1, True)
    assert dp_steps["mp_ctx"] == (1, 2, 0, 0, True)      # rank 0 of a model axis
    torch.testing.assert_close(dp_steps["gathered"],
                               torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2))
    c = dp_steps["collectives"]
    n = len(worker.STEP_CASES)
    # a broadcast a parameter and buffer (from rank 0, over the world), one
    # all-reduce of the loss and at least one of the gradients a step over
    # the dp group, the BatchNorm sums besides; nothing over mp
    assert c["world"]["broadcast"] >= n and c["dp"]["all_reduce"] >= 2 * n
    assert c["dp"]["all_gather"] == 0 and not any(c["mp"].values())


@pytest.mark.parametrize("case", list(worker.STEP_CASES))
def test_a_dp2_step_equals_the_one_process_step(dp_steps, case):
    """At the f32 bars against the one-process f32 step. DeepONet's
    BatchNorms at a microbatch of 2 or 3 samples make its f32 step itself
    up to 3e-3 (relative L2) off its float64 copy (CPU, these cases; 2e-6
    at grad_accum 1): there both f32 steps are held to the one-process
    float64 step, the dp one no farther than 1e-4 or twice the one-process
    f32 step's distance (in float64 the two are 3e-15 apart)."""
    got = dp_steps["results"][case]
    one = mesh.make_mesh_context("dp=1")
    ref = worker.run_step_case(case, one)
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    top = max(float(g.norm()) for g in ref["grads"].values())
    assert got["grads"].keys() == ref["grads"].keys()
    f64 = (worker.run_step_case(case, one, torch.float64)["grads"]
           if case.startswith("deeponet") and not case.endswith("_k1") else None)
    for n, g in ref["grads"].items():
        if float(g.norm()) <= 1e-5 * top:       # a true zero (a bias BatchNorm cancels)
            assert float(got["grads"][n].norm()) <= 1e-5 * top, n
        elif f64 is None:
            assert _rel_l2(got["grads"][n], g) <= 1e-4, (n, _rel_l2(got["grads"][n], g))
        else:
            noise = _rel_l2(g, f64[n])
            assert _rel_l2(got["grads"][n], f64[n]) <= max(1e-4, 2 * noise), (n, noise)
    for n, b in ref["buffers"].items():
        if b.is_floating_point():
            assert _rel_l2(got["buffers"][n], b) <= 1e-4, n
        else:
            assert torch.equal(got["buffers"][n], b), n


LOOP_CFG = dict(
    exp_name="dp", seed=0, dataset_name="cylinder", num_workers=0, normalizer="gaussian",
    mask_prob=0.0, noise_scale=0.0, model_name="fno", modes1=2, modes2=3, modes3=3,
    n_layers=2, width=8, scheduler="cosine", step_size=100, num_update=2,
    train_batch_size=4, test_batch_size=6, lr=1e-7, clip_grad_norm=0.0, grad_accum=2,
    N_autoregressive=2, N_plot=0, train_data_type="numerical", is_use_tb=False,
    in_step=4, out_step=4, interval=4, trunk_length=8, n_sim_frame=32,
    n_sim_in_distribution=1, n_sim_out_distribution=1, sub_s_real=1, sub_s_numerical=1,
    generate_ids_if_missing=True)


def test_a_dp2_loop_equals_the_one_process_loop(tmp_path):
    """2 steps (validation after each) of run_training under dp=2 against
    one process on the same tree: rank 0's last checkpoint and the
    validation metrics. mask_prob and noise 0 (the datasets' own draws are
    per process); lr 1e-7, so that the float-noise steps Adam takes on the
    gradients BatchNorm cancels stay below the metrics' 1e-5."""
    from realpdebench_tpu_torch.config import Config
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree
    from realpdebench_tpu_torch.train.loop import run_training

    root = str(tmp_path / "tree")
    make_fluid_tree(root, "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    cfg = dict(LOOP_CFG, dataset_root=root)
    _, _, ref_hist = run_training(Config(**cfg, mesh_shape=None), str(tmp_path / "one"),
                                  device="cpu")
    _spawn(worker.loop_main, str(tmp_path / "store"), cfg, str(tmp_path))
    got = torch.load(tmp_path / "loop.pt", weights_only=False)
    assert not os.path.exists(tmp_path / "rank1" / "ckpt")      # rank 0 alone writes
    step = LOOP_CFG["num_update"]
    for k, ref in ref_hist["val"].items():
        assert len(got["history"]["val"][k]) == len(ref) == step, k
        for a, b in zip(got["history"]["val"][k], ref):
            if np.isnan(b):                 # a band these small windows do not have
                assert np.isnan(a), (k, a)
            else:
                assert abs(a - b) <= 1e-5 * max(abs(b), 1e-2), (k, a, b)
    np.testing.assert_allclose(got["history"]["train_loss"], ref_hist["train_loss"],
                               rtol=1e-5)
    load = lambda d: torch.load(os.path.join(d, "ckpt", f"checkpoint_{step}.pth"),
                                weights_only=False)
    a, b = load(got["exp"]), load(str(tmp_path / "one"))
    for n, t in b["model_state_dict"].items():
        if t.is_floating_point() or t.is_complex():
            torch.testing.assert_close(a["model_state_dict"][n], t, rtol=2e-4,
                                       atol=2e-4 * float(t.abs().max()) + 2 * step * 1e-7)
    moments = [s["exp_avg"] for s in b["optimizer_state_dict"]["state"].values()]
    top = max(float(m.abs().norm()) for m in moments)
    for s_got, s_ref in zip(a["optimizer_state_dict"]["state"].values(),
                            b["optimizer_state_dict"]["state"].values()):
        m_got, m_ref = s_got["exp_avg"], s_ref["exp_avg"]
        if float(m_ref.abs().norm()) <= 1e-5 * top:
            assert float(m_got.abs().norm()) <= 1e-5 * top
        else:
            assert _rel_l2(torch.view_as_real(m_got) if m_got.is_complex() else m_got,
                           torch.view_as_real(m_ref) if m_ref.is_complex() else m_ref) <= 1e-4


# ---------------------------------------------------------- dp=2,mp=2


@pytest.fixture(scope="module")
def mp4_steps(tmp_path_factory):
    from tests.test_torch_partitioning import spawn_steps

    return spawn_steps(tmp_path_factory.mktemp("mp4_steps"), "dp=2,mp=2", mp_worker.MP4_CASES)


def test_dp2_mp2_ranks_sit_in_jax_layout_and_reduce_by_group(mp4_steps):
    """Four gloo ranks at dp=2,mp=2: rank r at (r // 2, r % 2); the
    gradients and the loss over the dp group, the BatchNorm sums of the
    GK's regressor (replicated over mp) too; the master slices, the token
    gathers and the scores over the mp group."""
    assert [r["ctx"] for r in mp4_steps] == [(2, 2, r // 2, r % 2, True) for r in range(4)]
    c = mp4_steps[0]["collectives"]
    n = len(mp_worker.MP4_CASES) * mp_worker.STEPS
    assert c["dp"]["all_reduce"] >= 2 * n and c["mp"]["all_gather"] >= n
    assert c["mp"]["all_reduce"] >= mp_worker.STEPS and c["world"]["broadcast"] > 0


@pytest.mark.parametrize("case", mp_worker.MP4_CASES)
def test_a_dp2_mp2_step_equals_the_one_process_step(mp4_steps, case):
    """3 steps on each data rank's half of the global batch, the GK with
    seq_shard (dropout on), against one process on all of it, at the
    trajectory bars; each rank holds half of each sharded leaf's moments."""
    from tests.test_torch_partitioning import assert_moments_sharded, assert_steps_match

    ref = mp_worker.run_case(case)
    init = {n: t.clone() for n, t in mp_worker.model_for(case).state_dict().items()}
    for r in mp4_steps:
        assert_steps_match(r["results"][case], ref, init, mp_worker.LR, mp_worker.STEPS)
    assert_moments_sharded(mp4_steps, case, 2)
