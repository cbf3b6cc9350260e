"""PyTorch port vs JAX package: the Hugging Face download layer and the
``download`` subcommand, on the CPU and without the network.

``build_allow_patterns`` over a grid of scenarios, ``what``, types, splits
and the surrogate switch; ``download --dry-run`` prints what the JAX CLI
prints; and with ``huggingface_hub.snapshot_download`` replaced by a stub
that records its arguments (and writes, or fails, as a hub would),
``download_realpdebench`` and ``ensure_hf_artifacts`` call it as the JAX
package does, refuse data that needs a newer data contract, and turn a
failed fetch into the JAX package's ``RuntimeError``. No test reaches the
network.
"""

import itertools
import json
import os

import huggingface_hub
import pytest

from realpdebench_tpu import cli as jcli
from realpdebench_tpu.data import hf_download as J
from realpdebench_tpu_torch import cli as pcli
from realpdebench_tpu_torch.data import hf_download as P

SCENARIOS = [["cylinder"], ["fsi", "combustion"], list(J.ALL_SCENARIOS)]


@pytest.mark.parametrize("what", ["metadata", "hf_dataset", "all"])
@pytest.mark.parametrize("scenarios", SCENARIOS, ids=["one", "two", "all"])
def test_allow_patterns_equal_jax(scenarios, what):
    for types, splits, surrogate in itertools.product(
            [None, ["real"], ["numerical", "real"]], [None, ["train"], ["test", "val"]],
            [False, True]):
        kw = dict(scenarios=scenarios, what=what, dataset_types=types, splits=splits,
                  include_surrogate_train=surrogate)
        assert P.build_allow_patterns(**kw) == J.build_allow_patterns(**kw), kw
    for m in (J, P):
        with pytest.raises(ValueError, match="non-empty"):
            m.build_allow_patterns(scenarios=[], what=what)


def _run_cli(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    out = capsys.readouterr()
    return e.value.code, out.out, out.err


@pytest.mark.parametrize("args", [
    ["--scenario", "cylinder"],
    ["--scenario", "fsi", "--scenario", "foil", "--what", "hf_dataset",
     "--dataset-type", "real", "--split", "test"],
    ["--all", "--what", "all", "--include-surrogate-train", "--repo-id", "me/data"],
])
def test_download_dry_run_prints_what_jax_prints(tmp_path, capsys, args):
    argv = ["download", "--dataset-root", str(tmp_path / "d"), "--dry-run", *args]
    ref = _run_cli(jcli.main, argv, capsys)
    got = _run_cli(pcli.main, argv, capsys)
    assert got == ref and ref[0] == 0
    assert json.loads(got[1])["dataset_root"] == str(tmp_path / "d")


class _Hub:
    """A stand-in for ``snapshot_download``: records each call's keywords;
    writes ``version`` (if given) as version.json into the pre-check's
    directory, and raises ``fail`` (if given) on the main fetch."""

    def __init__(self, version=None, fail=None):
        self.calls, self.version, self.fail = [], version, fail

    def __call__(self, **kw):
        precheck = kw["allow_patterns"] == ["version.json"]
        self.calls.append({**kw, "local_dir": "<tmp>" if precheck else kw["local_dir"]})
        if precheck and self.version is not None:
            with open(os.path.join(kw["local_dir"], "version.json"), "w") as f:
                json.dump({"data_version": "9", "min_code_version": self.version}, f)
        if not precheck and self.fail is not None:
            raise self.fail
        return kw["local_dir"]


def _both(monkeypatch, hub_args, fn):
    """``fn(module)`` for the JAX module and the port's, each with a fresh
    hub stub: [(result or raised exception, the stub's calls)] × 2."""
    out = []
    for m in (J, P):
        hub = _Hub(**hub_args)
        monkeypatch.setattr(huggingface_hub, "snapshot_download", hub)
        try:
            res = fn(m)
        except RuntimeError as e:
            res = ("RuntimeError", str(e).replace("this package implements", "installed"))
        out.append((res, hub.calls))
    return out


@pytest.mark.parametrize("hub_args", [{}, {"version": "0.2.0"}],
                         ids=["no-version-file", "version-0.2.0"])
def test_download_calls_the_hub_as_jax_does(tmp_path, monkeypatch, hub_args):
    kw = dict(dataset_root=str(tmp_path), scenarios=["cylinder", "combustion"],
              what="all", dataset_types=["real"], splits=["val"],
              include_surrogate_train=True, repo_id="me/data",
              endpoint="http://localhost:1", revision="v2", token="t")
    ref, got = _both(monkeypatch, hub_args, lambda m: m.download_realpdebench(**kw))
    assert got == ref
    assert len(got[1]) == 2 and got[0]["snapshot_path"] == str(tmp_path)


def test_newer_data_is_refused_before_the_download(tmp_path, monkeypatch):
    ref, got = _both(monkeypatch, {"version": "0.3.0"}, lambda m: m.download_realpdebench(
        dataset_root=str(tmp_path), scenarios=["cylinder"], what="hf_dataset"))
    assert got == ref
    assert got[0][0] == "RuntimeError" and "0.3.0" in got[0][1]
    assert len(got[1]) == 1       # the pre-check alone


def test_a_failed_fetch_raises_the_jax_error(tmp_path, monkeypatch, capsys):
    """Without the network the fetch fails: the same RuntimeError, and the
    same exit code and message from the CLI."""
    offline = dict(fail=OSError("no route to host"))
    ref, got = _both(monkeypatch, offline, lambda m: m.download_realpdebench(
        dataset_root=str(tmp_path), scenarios=["foil"], what="metadata"))
    assert got == ref
    assert got[0][0] == "RuntimeError" and "Failed to download" in got[0][1]
    argv = ["download", "--dataset-root", str(tmp_path), "--scenario", "foil"]
    codes = []
    for main in (jcli.main, pcli.main):
        monkeypatch.setattr(huggingface_hub, "snapshot_download", _Hub(**offline))
        codes.append(_run_cli(main, argv, capsys))
    assert codes[0] == codes[1] and codes[1][0] == 2 and "no route" in codes[1][2]


@pytest.mark.parametrize("auto", [False, True])
@pytest.mark.parametrize("split", ["train", "test"])
def test_ensure_hf_artifacts_calls_the_hub_as_jax_does(tmp_path, monkeypatch, auto, split):
    kw = dict(dataset_root=str(tmp_path), scenario="fsi", dataset_type="numerical",
              split=split, need_test_params_json=split == "test", hf_auto_download=auto,
              repo_id="me/data", revision="v1")
    ref, got = _both(monkeypatch, {}, lambda m: m.ensure_hf_artifacts(**kw))
    assert got == ref and len(got[1]) == (2 if auto else 0)
    # present artifacts: nothing to fetch
    hf = tmp_path / "fsi" / "hf_dataset"
    (hf / "numerical").mkdir(parents=True, exist_ok=True)
    (hf / f"{split}_index_numerical.json").write_text("[]")
    ref, got = _both(monkeypatch, {}, lambda m: m.ensure_hf_artifacts(**kw))
    assert got == ref and got[1] == []


@pytest.mark.parametrize("entry", ["train", "eval"])
def test_the_entry_points_pass_the_download_options_as_jax(tmp_path, monkeypatch, entry):
    """With --use_hf_dataset and --hf_auto_download on an empty root, train's
    and eval's datasets fetch what the JAX package's fetch (then find no
    tree, as nothing was written)."""
    from realpdebench_tpu.config import Config as JConfig
    from realpdebench_tpu.eval.__main__ import run_eval as jrun_eval
    from realpdebench_tpu.train.loop import build_datasets as jbuild
    from realpdebench_tpu_torch.config import Config
    from realpdebench_tpu_torch.eval.__main__ import build_eval_datasets
    from realpdebench_tpu_torch.train.loop import build_datasets

    keys = dict(dataset_name="cylinder", dataset_root=str(tmp_path), use_hf_dataset=True,
                hf_auto_download=True, hf_repo_id="me/data", hf_endpoint="http://localhost:1",
                hf_revision="v3", N_autoregressive=2, test_batch_size=2)
    runs = {
        "train": (lambda: jbuild(JConfig(**keys), "numerical", use_hf=True),
                  lambda: build_datasets(Config(**keys), "numerical", use_hf=True)),
        "eval": (lambda: jrun_eval(JConfig(**keys, mesh_shape="dp=1,mp=1"),
                                   str(tmp_path / "e")),
                 lambda: build_eval_datasets(Config(**keys))),
    }[entry]
    calls = []
    for run in runs:
        hub = _Hub()
        monkeypatch.setattr(huggingface_hub, "snapshot_download", hub)
        with pytest.raises(FileNotFoundError, match="HF Arrow trajectories not found"):
            run()
        calls.append(hub.calls)
    assert calls[0] == calls[1] and len(calls[1]) == 2
    assert calls[1][1]["repo_id"] == "me/data" and calls[1][1]["revision"] == "v3"
