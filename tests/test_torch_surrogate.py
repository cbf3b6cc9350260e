"""PyTorch port vs JAX package: the combustion surrogate pipeline (CPU, f32).

1. ``SurrogateDataset`` (HDF5) and ``CombustionSurrogateHFDataset``
   (Arrow) against the JAX classes item for item, each side given the same
   injected ``np.random.Generator`` (JAX seeds with the salted
   ``hash(mode)``; the port with ``derive_seed``), and their lengths.
2. The Arrow surrogate tree: the port's ``convert_surrogate_train`` (from
   the HDF5 files) and ``write_surrogate_train`` (from the arrays) against
   the JAX package's converter, row for row and bit for bit, sidecars
   included.
3. ``run_surrogate_training`` for 100 iterations (two evaluations) against
   the JAX package's, from the same initial weights and the same crops (the
   JAX side's ``hash`` replaced by the crc32 ``derive_seed`` uses): every
   training loss and evaluation within 1e-3 relative, the loop drift
   ROADMAP allows.
4. ``generate`` against JAX's ``generate`` on the same weights (the JAX
   run's final state exported to a reference ``.pth``), windows of 5 frames
   over 24-frame trajectories: four full windows and a partial tail.
5. ``numerical_real_compare.compare`` against JAX's.
6. ``python -m realpdebench_tpu_torch train-surrogate`` on the HDF5 tree
   and on the Arrow tree (``--use_hf_dataset``), with ``--device cpu``.

Tolerance, unless named: rtol 2e-4 with atol 2e-4·max|ref|.
"""

import glob
import os
import zlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import surrogate as jsur
from realpdebench_tpu.data.synthetic import make_combustion_tree, make_fluid_tree
from realpdebench_tpu_torch.data import surrogate as tsur
from realpdebench_tpu_torch.train import surrogate as ttrain

SKW = dict(step=4, n_sim_frame=24)
H = W = 8


def _close(got, ref, rtol=2e-4, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()), err_msg=msg)


def _pairs(n_sim=2, n_frame=24, seed=0):
    """(sim_id, real [T, H, W], numerical [T, H, W, 15]) arrays."""
    rng = np.random.default_rng(seed)
    return [(f"{40 + 10 * i}NH3_{0.6 + 0.2 * i:.1f}.h5",
             rng.standard_normal((n_frame, H, W)).astype(np.float32),
             rng.standard_normal((n_frame, H, W, 15)).astype(np.float32))
            for i in range(n_sim)]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A combustion tree with its surrogate-train pairs (HDF5) and the JAX
    converter's Arrow tree."""
    import h5py

    from realpdebench_tpu.tools.convert_hdf5_to_hf import convert_surrogate_train

    root = str(tmp_path_factory.mktemp("surrogate"))
    make_combustion_tree(root, n_sim=2, n_frame=24, h=H, w=W)
    scen = os.path.join(root, "combustion")
    for sim_id, real, num in _pairs():
        for sub, key, data in (("real_surrogate_train", "trajectory", real),
                               ("numerical_surrogate_train", "measured_data", num)):
            os.makedirs(os.path.join(scen, sub), exist_ok=True)
            with h5py.File(os.path.join(scen, sub, sim_id), "w") as f:
                f.create_dataset(key, data=data)
    convert_surrogate_train(root, **SKW)
    return root


def _crc_hash(s):
    """What ``derive_seed`` adds to the seed: the JAX side's ``hash(mode)``
    replaced by it, so both packages draw the same crops."""
    return zlib.crc32(str(s).encode())


@pytest.mark.parametrize("backend", ["hdf5", "arrow"])
def test_datasets_match_jax_item_for_item(root, backend):
    jcls, tcls = ((jsur.SurrogateDataset, tsur.SurrogateDataset) if backend == "hdf5" else
                  (jsur.CombustionSurrogateHFDataset, tsur.CombustionSurrogateHFDataset))
    for mode in ("train", "test"):
        j = jcls("combustion", root, mode, **SKW)
        t = tcls("combustion", root, mode, **SKW)
        assert len(t) == len(j) and t.sim_ids == j.sim_ids and t.time_ids == j.time_ids
        j._rng, t._rng = np.random.default_rng(7), np.random.default_rng(7)
        for i in range(6):
            (jx, jy), (tx, ty) = j[i], t[i]
            assert tx.shape == (4, H, W, 17) and ty.shape == (4, H, W, 1)
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)
    ds = tcls("combustion", root, "train", seed=3, **SKW)
    assert ds._rng.integers(1 << 30) == np.random.default_rng(
        (3 + zlib.crc32(b"train")) % 2**31).integers(1 << 30)


def test_arrow_rows_equal_the_jax_converter(root, tmp_path):
    import h5py
    from datasets import load_from_disk

    from realpdebench_tpu_torch.tools import convert_hdf5_to_hf as conv

    ref_dir = os.path.join(root, "combustion", "hf_dataset")
    ref = load_from_disk(os.path.join(ref_dir, "surrogate_train"))
    scen = os.path.join(root, "combustion")
    mirror = tmp_path / "h5"
    for sub in ("real_surrogate_train", "numerical_surrogate_train"):
        os.makedirs(mirror / "combustion" / sub)
        for fn in os.listdir(os.path.join(scen, sub)):
            os.link(os.path.join(scen, sub, fn), mirror / "combustion" / sub / fn)
    conv.convert_surrogate_train(str(mirror), **SKW)
    pairs = []
    for sim_id in sorted(os.listdir(os.path.join(scen, "numerical_surrogate_train"))):
        with h5py.File(os.path.join(scen, "real_surrogate_train", sim_id)) as f:
            real = f["trajectory"][:]
        with h5py.File(os.path.join(scen, "numerical_surrogate_train", sim_id)) as f:
            num = f["measured_data"][:]
        pairs.append((sim_id, real, num))
    conv.write_surrogate_train(str(tmp_path / "arrays" / "combustion"), pairs, **SKW)
    for got_root in (mirror / "combustion", tmp_path / "arrays" / "combustion"):
        got_dir = os.path.join(got_root, "hf_dataset")
        got = load_from_disk(os.path.join(got_dir, "surrogate_train"))
        assert got.features == ref.features and len(got) == len(ref) == 2 * 20
        for i in range(len(ref)):
            assert got[i] == ref[i], i
        for side in ("surrogate_train_sim_ids.txt", "surrogate_train_meta.json"):
            with open(os.path.join(got_dir, side)) as a, open(os.path.join(ref_dir, side)) as b:
                assert a.read() == b.read(), side


CFG = dict(exp_name="sur", seed=0, dataset_name="combustion", num_workers=0,
           normalizer="gaussian", model_name="fno", modes1=2, modes2=2, modes3=2,
           n_layers=1, width=4, scheduler="cosine", step_size=10, num_update=100,
           train_batch_size=4, test_batch_size=4, lr=1e-3, clip_grad_norm=0.0, **SKW)


@pytest.fixture(scope="module")
def trained(root, tmp_path_factory):
    """Both packages' surrogate training from the same weights and crops:
    (JAX state, JAX history, port history, JAX bundle)."""
    from realpdebench_tpu.interop.torch_export import export_torch_state_dict
    from realpdebench_tpu.models.registry import build_model as jbuild
    from realpdebench_tpu.train.surrogate import run_surrogate_training as jrun

    tmp = tmp_path_factory.mktemp("trained")
    cfg = Config(dataset_root=root, **CFG)
    si, so = (4, H, W, 17), (4, H, W, 1)
    jb = jbuild(shapes=(si, so), **cfg.to_dict())
    # the JAX loop's own init: PRNGKey(seed), split once
    _, init_rng = jax.random.split(jax.random.PRNGKey(0))
    params, state = jb.split_variables(jb.init(init_rng, np.zeros((1, *si), np.float32)))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_torch_state_dict(jb, params, state).items()}
    build = ttrain.build_model

    def build_from_jax_init(**kw):
        m = build(**kw)
        m.load_state_dict(sd, strict=True)
        return m

    with mock.patch.object(jsur, "hash", _crc_hash, create=True):
        os.makedirs(tmp / "jax")
        jstate, jhist = jrun(Config(mesh_shape="dp=1,mp=1", dataset_root=root, **CFG),
                             str(tmp / "jax"))
    with mock.patch.object(ttrain, "build_model", build_from_jax_init):
        os.makedirs(tmp / "port")
        _, _, thist = ttrain.run_surrogate_training(cfg, str(tmp / "port"), device="cpu")
    assert sorted(os.listdir(tmp / "port" / "ckpt")) == ["checkpoint_100.pth",
                                                         "checkpoint_50.pth"]
    return jstate, jhist, thist, jb


def test_training_history_matches_jax(trained):
    _, jhist, thist, _ = trained
    assert len(thist["train_loss"]) == len(jhist["train_loss"]) == 100
    _close(thist["train_loss"], jhist["train_loss"], rtol=1e-3, msg="train_loss")
    for k, v in jhist["test"].items():
        assert len(v) == 2, k
        _close(thist["test"][k], v, rtol=1e-3, msg=k)


def test_generate_matches_jax(root, trained, tmp_path):
    import h5py

    from realpdebench_tpu.interop.torch_export import save_torch_checkpoint
    from realpdebench_tpu.tools.generate_surrogate_data import generate as jgen
    from realpdebench_tpu.train.checkpoint import CheckpointManager as JMgr
    from realpdebench_tpu_torch.tools.generate_surrogate_data import generate

    jstate, _, _, jb = trained
    cfg = Config(dataset_root=root, **CFG)
    pth = str(tmp_path / "surrogate.pth")
    save_torch_checkpoint(pth, jb, jstate.params, jstate.model_state)
    jdir = str(tmp_path / "jax_ckpt")
    mgr = JMgr(jdir)
    mgr.save(100, jstate, metadata={"iteration": 100})
    mgr.wait()
    mgr.close()
    out = os.path.join(root, "combustion", "surrogate")
    outs = []
    with mock.patch.object(jsur, "hash", _crc_hash, create=True):
        for run in (lambda: jgen(root, jdir, cfg, step=5, n_sim_frame=24),
                    lambda: generate(root, pth, cfg, step=5, n_sim_frame=24, device="cpu")):
            run()
            got = {}
            for fn in sorted(os.listdir(out)):
                with h5py.File(os.path.join(out, fn), "r") as f:
                    got[fn] = f["measured_data"][:]
            outs.append(got)
    assert sorted(outs[1]) == sorted(outs[0]) and len(outs[0]) == 2
    for fn, ref in outs[0].items():
        assert ref.shape == (24, H, W)
        _close(outs[1][fn], ref, msg=fn)


def test_surrogate_trajectory_windows_and_tail():
    from realpdebench_tpu_torch.tools.generate_surrogate_data import surrogate_trajectory

    calls = []

    def predict(w):
        calls.append(float(w[0, 0, 0, 0, 0]))
        return w[..., :1] * 2

    inp = np.arange(23, dtype=np.float32)[:, None, None, None] * np.ones((23, 2, 2, 17))
    out = surrogate_trajectory(predict, inp, 5)
    assert calls == [0, 5, 10, 15, 18]        # the tail from the last full window
    np.testing.assert_array_equal(out, 2 * inp[..., 0])


def test_numerical_real_compare_matches_jax(tmp_path):
    from realpdebench_tpu.data.fluid import Cylinder
    from realpdebench_tpu.tools.numerical_real_compare import compare as jcompare
    from realpdebench_tpu_torch.tools.numerical_real_compare import compare

    root = str(tmp_path)
    make_fluid_tree(root, "cylinder", n_sim=3, n_frame=32, h=16, w=16)
    kw = dict(in_step=4, out_step=4, interval=4, trunk_length=16, n_sim_frame=32,
              n_sim_in_distribution=1, n_sim_out_distribution=1, sub_s_real=1,
              sub_s_numerical=1, generate_ids_if_missing=True)
    Cylinder("cylinder", root, "real", "train", **kw)         # the id files
    for interval in (False, True):
        ref = jcompare(root, "cylinder", is_interval=interval, horizon=8,
                       exp_path=str(tmp_path / "j"), dataset_kwargs=kw)
        got = compare(root, "cylinder", is_interval=interval, horizon=8,
                      exp_path=str(tmp_path / "t"), dataset_kwargs=kw)
        assert len(got) == len(ref) == 4
        _close(got, ref, rtol=1e-5)


@pytest.mark.parametrize("backend", ["hdf5", "arrow"])
def test_train_surrogate_through_the_cli(root, tmp_path, backend):
    from realpdebench_tpu_torch.cli import main

    argv = ["train-surrogate", "--config", "combustion/surrogate_model/fno.yaml",
            "--dataset_root", root, "--device", "cpu", "--results_path", str(tmp_path),
            "--num_workers", "0", "--num_update", "50", "--train_batch_size", "2",
            "--test_batch_size", "4", "--modes1", "2", "--modes2", "2", "--modes3", "2",
            "--width", "4", "--n_layers", "1", "--step", "4", "--n_sim_frame", "24",
            "--is_use_tb", "false"]
    if backend == "arrow":
        argv.append("--use_hf_dataset")
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 0
    (ckpt,) = glob.glob(os.path.join(str(tmp_path), "fno", "surrogate_fno_combustion", "*",
                                     "ckpt"))
    assert os.listdir(ckpt) == ["checkpoint_50.pth"]
