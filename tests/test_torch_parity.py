"""The port's ``parity`` subcommand (CPU).

``python -m realpdebench_tpu_torch parity`` evaluates a reference-format
``.pth`` of the cylinder FNO at a tiny width on a synthetic tree, through
the port and through a stand-in ``realpdebench`` package written under
``tmp_path`` and found through ``$REALPDEBENCH_REF`` (its ``load_model``
builds the same network with the reference's checkpoint method): both
columns agree within 1e-5 on every metric, the table and the JSON report
name the port's column ``port``, and ``parity.json`` is written. With no
reference package the report carries ``torch_error`` and no reference
column. The JAX package's parity is the model: its report's metric keys
and table rows are the port's.
"""

import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from realpdebench_tpu.eval import parity as jparity
from realpdebench_tpu_torch.eval import parity
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.utils.misc import make_generator

MODEL = dict(model_name="fno", modes1=2, modes2=3, modes3=3, n_layers=2, width=8)

STAND_IN = textwrap.dedent("""
    import torch

    from realpdebench_tpu_torch.models.registry import build_model


    class Reference(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, x):
            return self.net(x)

        def load_checkpoint(self, path, device):
            ckpt = torch.load(path, map_location=device, weights_only=False)
            self.net.load_state_dict(ckpt["model_state_dict"])


    def load_model(train_dataset, **kwargs):
        assert kwargs["device"] == "cpu"
        return Reference(build_model(train_dataset=train_dataset, **kwargs))
""")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while these small runs go: with the suite's
    workers on every core, a full pool of spinning threads slows them a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = tmp_path_factory.mktemp("parity_tree")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=64, h=16, w=16)
    return str(root)


@pytest.fixture
def no_reference(monkeypatch):
    """No ``realpdebench`` importable, and none loaded after the test."""
    monkeypatch.delenv("REALPDEBENCH_REF", raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))
    yield
    for name in [m for m in sys.modules if m == "realpdebench" or m.startswith("realpdebench.")]:
        del sys.modules[name]


def _argv(tree, results, ckpt):
    return ["--config", "cylinder/fno.yaml", "--dataset_root", tree, "--device", "cpu",
            "--results_path", results, "--checkpoint_path", ckpt, "--num_workers", "0",
            *[a for k, v in MODEL.items() if k != "model_name" for a in (f"--{k}", str(v))],
            "--test_batch_size", "8", "--N_autoregressive", "2", "--N_plot", "0",
            "--N_plot_probe", "0", "--probe_diagnostic", "false", "--in_step", "4",
            "--out_step", "4", "--interval", "4", "--trunk_length", "16",
            "--n_sim_frame", "64", "--n_sim_in_distribution", "1",
            "--n_sim_out_distribution", "1", "--sub_s_real", "1", "--sub_s_numerical", "1",
            "--generate_ids_if_missing"]


def _checkpoint(path):
    m = build_model(shapes=((4, 16, 16, 3),) * 2, device="cpu",
                    generator=make_generator(3), **MODEL)
    torch.save({"model_state_dict": m.state_dict(), "iteration": 1}, path)
    return path


def test_parity_with_a_stand_in_reference(tree, tmp_path, monkeypatch, capsys, no_reference):
    from realpdebench_tpu_torch.cli import main

    ref = tmp_path / "ref"
    (ref / "realpdebench" / "model").mkdir(parents=True)
    (ref / "realpdebench" / "__init__.py").write_text("")
    (ref / "realpdebench" / "model" / "__init__.py").write_text("")
    (ref / "realpdebench" / "model" / "load_model.py").write_text(STAND_IN)
    monkeypatch.setenv("REALPDEBENCH_REF", str(ref))
    ckpt = _checkpoint(str(tmp_path / "fno.pth"))
    with pytest.raises(SystemExit) as e:
        main(["parity", *_argv(tree, str(tmp_path / "results"), ckpt)])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0].split() == ["metric", "port", "torch", "rel_dev"]
    report = json.loads(out.strip().splitlines()[-1])
    assert set(report) == {"port", "torch"}, report.get("torch_error")
    assert set(report["port"]) == set(report["torch"]) == {
        "normalized_mse", *jparity.METRIC_NAMES}
    for k, a in report["port"].items():
        b = report["torch"][k]
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-5 * max(abs(b), 1.0), k
    (found,) = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "results")
                for f in fs if f == "parity.json"]
    with open(found) as f:
        assert json.load(f)["port"] == report["port"]


def test_parity_without_a_reference_reports_torch_error(tree, tmp_path, no_reference):
    assert parity.import_reference() is None
    ckpt = _checkpoint(str(tmp_path / "fno.pth"))
    _, report = parity.main(_argv(tree, str(tmp_path), ckpt))
    assert report["torch"] is None and "not importable" in report["torch_error"]
    assert np.isfinite(report["port"]["rmse"])
    table = parity.parity_table(report["port"], None).splitlines()
    assert len(table) == 1 + len(report["port"]) and table[1].split()[2] == "-"
