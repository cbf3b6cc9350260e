"""PyTorch port vs JAX package: the Arrow (Hugging Face V2) data backend,
the HDF5 → Arrow converter and the data-version check, on the CPU.

One small synthetic HDF5 tree (cylinder and combustion) with its id
mappings is converted twice: by the JAX package's converter and by the
port's. Each package's Arrow classes read both trees (the cross-read), and
the port's items equal the JAX package's bit for bit, with masking and
noise on and off, in the order the JAX classes draw them; the two
converters write equal tables, index files and sidecars. Then ``python -m
realpdebench_tpu_torch train`` and ``eval`` with ``--use_hf_dataset true
--device cpu`` are held against the JAX package's ``run_training`` and
``run_eval`` on the same Arrow tree, at the tolerance of
``tests/test_torch_loop.py`` (rtol 2e-4, atol 2e-4·max|ref|).
"""

import glob
import json
import os
import shutil

import jax  # noqa: F401  (JAX and torch in one process: JAX imported first)
import numpy as np
import pytest
import torch

import realpdebench_tpu
import realpdebench_tpu_torch
from realpdebench_tpu.data import hf_datasets as J
from realpdebench_tpu.data.combustion import CombustionDataset
from realpdebench_tpu.data.fluid import Cylinder
from realpdebench_tpu.data.synthetic import make_combustion_tree, make_fluid_tree
from realpdebench_tpu.tools.convert_hdf5_to_hf import convert_dataset_v2 as jconvert
from realpdebench_tpu_torch.data import hf_datasets as P
from realpdebench_tpu_torch.tools.convert_hdf5_to_hf import convert_dataset_v2 as pconvert
from tests.test_torch_loop import BASE, _close, _jax_fno_pth

KW = dict(in_step=4, out_step=4, interval=4, trunk_length=16, n_sim_frame=64,
          sub_s_real=1, sub_s_numerical=1)
CKW = dict(in_step=4, out_step=4, interval=2, trunk_length=10, n_sim_frame=40,
           sub_s_real=1, sub_s_numerical=1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{writer: root}: one HDF5 tree with its id mappings, converted by the
    JAX package ("jax") and by the port ("port")."""
    tmp = tmp_path_factory.mktemp("hf")
    base = str(tmp / "h5")
    make_fluid_tree(base, "cylinder", n_sim=5, n_frame=64, h=16, w=16)
    make_combustion_tree(base, n_sim=3, n_frame=40, h=16, w=16)
    for dtype in ("real", "numerical"):
        Cylinder("cylinder", base, dtype, "train", n_sim_in_distribution=1,
                 n_sim_out_distribution=1, generate_ids_if_missing=True, **KW)
        CombustionDataset("combustion", base, dtype, "train",
                          generate_ids_if_missing=True, **CKW)
    out = {}
    for writer, convert in (("jax", jconvert), ("port", pconvert)):
        out[writer] = shutil.copytree(base, str(tmp / writer))
        for scenario in ("cylinder", "combustion"):
            convert(out[writer], scenario)
    return out


def _assert_items_equal(ref, got):
    assert len(got) == len(ref) > 0
    assert got.sim_id_mapping == ref.sim_id_mapping
    assert got.time_id_mapping == ref.time_id_mapping
    for i in range(len(ref)):          # in order: the draws stay in step
        for a, b in zip(ref[i], got[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


CASES = {
    "cylinder-numerical-train-masked": ("CylinderHFDataset", "cylinder", "numerical",
                                        "train", dict(KW, mask_prob=0.5, noise_scale=0.1)),
    "cylinder-numerical-train": ("CylinderHFDataset", "cylinder", "numerical", "train",
                                 dict(KW, mask_prob=0.0)),
    "cylinder-real-val": ("CylinderHFDataset", "cylinder", "real", "val", KW),
    "combustion-numerical-train-masked": ("CombustionHFDataset", "combustion",
                                          "numerical", "train",
                                          dict(CKW, noise_scale=0.1)),
    "combustion-numerical-train": ("CombustionHFDataset", "combustion", "numerical",
                                   "train", dict(CKW, mask_prob=0.0)),
    "combustion-real-test": ("CombustionHFDataset", "combustion", "real", "test", CKW),
}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", list(CASES))
def test_items_equal_jax(trees, writer, case):
    """The port's Arrow items are the JAX package's, bit for bit, on the
    tree either converter wrote."""
    cls, scenario, dtype, mode, kw = CASES[case]
    args = (scenario, trees[writer], dtype, mode)
    _assert_items_equal(getattr(J, cls)(*args, seed=3, **kw),
                        getattr(P, cls)(*args, seed=3, **kw))


def test_the_two_converters_write_the_same_tree(trees):
    from datasets import load_from_disk

    for scenario in ("cylinder", "combustion"):
        d = {w: os.path.join(r, scenario) for w, r in trees.items()}
        for dtype in ("real", "numerical"):
            tables = [load_from_disk(os.path.join(d[w], "hf_dataset", dtype)).data.table
                      for w in ("jax", "port")]
            assert tables[0].schema == tables[1].schema, dtype
            assert tables[0].equals(tables[1]), dtype
        names = sorted(os.path.relpath(p, d["jax"]) for p in
                       glob.glob(os.path.join(d["jax"], "**", "*.json"), recursive=True))
        assert names == sorted(os.path.relpath(p, d["port"]) for p in glob.glob(
            os.path.join(d["port"], "**", "*.json"), recursive=True))
        assert any(n.startswith("hf_dataset/test_index_") for n in names)
        for n in names:
            with open(os.path.join(d["jax"], n)) as a, open(os.path.join(d["port"], n)) as b:
                assert a.read() == b.read(), n


@pytest.mark.parametrize("kind", ["binary", "large_binary"])
def test_values_are_found_in_any_chunk_and_offset_width(trees, tmp_path, kind):
    """The port reads a value in place through the column's offsets: the
    same items from a table in three shards (three chunks) whose fields are
    ``binary`` (32-bit offsets) or ``large_binary`` (64-bit)."""
    from datasets import Value, load_from_disk

    root = shutil.copytree(trees["port"], str(tmp_path / "t"))
    path = os.path.join(root, "cylinder", "hf_dataset", "numerical")
    ds = load_from_disk(path)
    for col in ("u", "v", "p"):
        ds = ds.cast_column(col, Value(kind))
    ds.save_to_disk(path + ".sharded", num_shards=3)
    del ds
    shutil.rmtree(path)
    os.rename(path + ".sharded", path)
    got = P.CylinderHFDataset("cylinder", root, "numerical", "train", seed=1,
                              mask_prob=0.5, **KW)
    assert got._table.column("u").num_chunks == 3
    _assert_items_equal(J.CylinderHFDataset("cylinder", trees["jax"], "numerical",
                                            "train", seed=1, mask_prob=0.5, **KW), got)


@pytest.mark.parametrize("test_mode", ["all", "seen", "unseen", "in_dist", "out_dist"])
def test_test_mode_filter(trees, test_mode):
    args = ("cylinder", trees["port"], "real", "test")
    ref = J.CylinderHFDataset(*args, test_mode=test_mode, **KW)
    got = P.CylinderHFDataset(*args, test_mode=test_mode, **KW)
    assert got.sim_id_mapping == ref.sim_id_mapping
    assert got.time_id_mapping == ref.time_id_mapping
    if test_mode in ("seen", "unseen"):
        full = P.CylinderHFDataset(*args, test_mode="all", **KW)
        other = P.CylinderHFDataset(*args, test_mode={"seen": "unseen",
                                                      "unseen": "seen"}[test_mode], **KW)
        assert len(got) + len(other) == len(full)


def test_autoregressive_filter(trees):
    args = ("cylinder", trees["jax"], "real", "test")
    ref = J.CylinderHFDataset(*args, N_autoregressive=3, **KW)
    got = P.CylinderHFDataset(*args, N_autoregressive=3, **KW)
    for t in got.time_id_mapping["test"]:
        assert t + got.horizon < KW["n_sim_frame"]
    _assert_items_equal(ref, got)
    assert got[0][1].shape[0] == 3 * KW["out_step"]


@pytest.mark.parametrize("min_code", [None, "0.1.0", "0.2.0", "0.2.1", "0.3.0", "1.0"])
def test_check_data_version_accepts_and_refuses_as_jax(tmp_path, min_code):
    if min_code is not None:
        (tmp_path / "version.json").write_text(json.dumps(
            {"data_version": "2.0", "min_code_version": min_code}))
    outcome = []
    for check in (realpdebench_tpu.check_data_version,
                  realpdebench_tpu_torch.check_data_version):
        try:
            r = check(str(tmp_path))
            outcome.append((r["ok"], r["data_version"], r["min_code_version"]))
        except RuntimeError:
            outcome.append("refused")
    assert outcome[0] == outcome[1]
    assert (outcome[1] == "refused") == (min_code in ("0.2.1", "0.3.0", "1.0"))


def test_the_datasets_check_the_version_and_find_the_tree(tmp_path):
    """The Arrow classes check version.json first, and without the tree (and
    without auto-download) raise as the JAX classes do."""
    (tmp_path / "version.json").write_text(json.dumps({"min_code_version": "0.3.0"}))
    for cls in (J.CylinderHFDataset, P.CylinderHFDataset):
        with pytest.raises(RuntimeError, match="0.3.0"):
            cls("cylinder", str(tmp_path), "real", "train")
    (tmp_path / "version.json").write_text(json.dumps({"min_code_version": "0.2.0"}))
    for cls in (J.CylinderHFDataset, P.CylinderHFDataset):
        with pytest.raises(FileNotFoundError, match="HF Arrow trajectories not found"):
            cls("cylinder", str(tmp_path), "real", "train")


def _argv(keys: dict) -> list:
    """``--key value`` for each key (values in YAML, strings as they are)."""
    return [a for k, v in keys.items()
            for a in (f"--{k}", v if isinstance(v, str) else json.dumps(v))]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_train_then_eval_on_the_arrow_backend_matches_jax(tmp_path):
    """`python -m realpdebench_tpu_torch train` then `eval`, --use_hf_dataset
    true --device cpu, finetuning the JAX package's initial FNO weights for
    2 steps on a converted tree (noise and masks on), against the JAX
    package's run_training and run_eval on the same tree: the train losses,
    and the eval of the port's final checkpoint in both packages."""
    from realpdebench_tpu.config import Config as JConfig
    from realpdebench_tpu.eval.__main__ import run_eval as jrun_eval
    from realpdebench_tpu.train.loop import run_training as jrun
    from realpdebench_tpu_torch.cli import main
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main
    from realpdebench_tpu_torch.train.__main__ import main as train_main

    root = str(tmp_path / "data")
    make_fluid_tree(root, "cylinder", n_sim=5, n_frame=BASE["n_sim_frame"], h=16, w=16)
    for dtype in ("real", "numerical"):
        Cylinder("cylinder", root, dtype, "train", **{k: BASE[k] for k in (
            "in_step", "out_step", "interval", "trunk_length", "n_sim_frame",
            "n_sim_in_distribution", "n_sim_out_distribution", "sub_s_real",
            "sub_s_numerical", "generate_ids_if_missing")})
    with pytest.raises(SystemExit) as e:
        main(["convert", "--dataset-root", root, "--scenario", "cylinder"])
    assert e.value.code == 0
    shutil.rmtree(os.path.join(root, "cylinder", "real"))       # Arrow alone from here
    shutil.rmtree(os.path.join(root, "cylinder", "numerical"))

    pth = str(tmp_path / "init.pth")
    _jax_fno_pth(pth)
    keys = {**BASE, "num_update": 2, "dataset_root": root, "use_hf_dataset": True,
            "is_finetune": True, "checkpoint_path": pth}
    argv = ["--config", "cylinder/fno.yaml", "--device", "cpu",
            "--results_path", str(tmp_path / "port")]
    argv += _argv(keys)
    exp, _, _, hist = train_main(argv)          # the CLI's train subcommand
    _, jhist = jrun(JConfig(**keys, mesh_shape="dp=1,mp=1"), str(tmp_path / "jax"))
    ckpt = os.path.join(exp, "ckpt")
    assert sorted(os.listdir(ckpt)) == ["checkpoint_1.pth", "checkpoint_2.pth"]
    _close(hist["train_loss"], jhist["train_loss"], err_msg="train_loss")

    final = os.path.join(ckpt, "checkpoint_2.pth")
    eval_keys = {**keys, "is_finetune": False, "checkpoint_path": ckpt}
    _, got = eval_main([*argv, *_argv(eval_keys)])
    ref = jrun_eval(JConfig(**{**eval_keys, "checkpoint_path": final},
                            mesh_shape="dp=1,mp=1"), str(tmp_path / "jeval"))
    assert set(got) == set(ref)
    for k, v in ref.items():
        _close(got[k], v, err_msg=k)
