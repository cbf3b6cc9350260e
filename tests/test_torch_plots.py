"""PyTorch port vs JAX package: the result plots (``eval/plots``) and the
probe plots (``eval/probes._plot_probes``), on the CPU.

matplotlib's drawing calls (``Axes.imshow``, ``Axes.plot``) and
``pyplot.savefig`` are recorded while each package's ``run_eval``
evaluates the same FNO weights (the JAX package's initial weights, written
as a reference ``.pth``) on one synthetic tree with ``N_plot`` 1 and
``N_plot_probe`` 2: the same arrays are drawn in the same order (rtol
2e-4, atol 2e-4·max|ref|, as ``tests/test_torch_loop.py``) into the same
file names, and the port's files are on disk (the JAX package's calls
are recorded without drawing the files). Then ``python -m
realpdebench_tpu_torch eval`` with the shipped UNet and Galerkin
Transformer configs, their ``N_plot`` and ``N_plot_probe`` as shipped,
writes the files the JAX package's plot functions write for the same
arrays. The pixels are not compared.
"""

import json
import os

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch
from matplotlib.axes import Axes

from realpdebench_tpu.data.synthetic import make_fluid_tree
from tests.test_torch_loop import BASE, SHAPE, _close, _jcfg, _jax_fno_pth, _pcfg

matplotlib.use("Agg")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plots"))
    make_fluid_tree(root, "cylinder", n_sim=5, n_frame=BASE["n_sim_frame"], h=16, w=16)
    return root


class _Recorder:
    """Records imshow and plot arrays and savefig names (relative to
    ``base``); ``save`` False records the name without drawing the file."""

    def __init__(self, monkeypatch, base, save=True):
        self.calls, self.base = [], base
        imshow, plot, savefig = Axes.imshow, Axes.plot, plt.savefig

        def rec_imshow(ax, img, *a, **k):
            self.calls.append(("imshow", np.array(img, np.float64)))
            return imshow(ax, img, *a, **k)

        def rec_plot(ax, x, y, *a, **k):
            self.calls.append(("plot", np.array(x, np.float64), np.array(y, np.float64),
                               k.get("label")))
            return plot(ax, x, y, *a, **k)

        def rec_savefig(path, *a, **k):
            self.calls.append(("savefig", os.path.relpath(path, self.base)))
            if save:
                return savefig(path, *a, **k)

        monkeypatch.setattr(Axes, "imshow", rec_imshow)
        monkeypatch.setattr(Axes, "plot", rec_plot)
        monkeypatch.setattr(plt, "savefig", rec_savefig)

    def names(self):
        return [c[1] for c in self.calls if c[0] == "savefig"]


def _files(base):
    return sorted(os.path.relpath(os.path.join(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs
                  if f.endswith((".png", ".pdf")))


def test_eval_plots_the_jax_arrays_into_the_jax_files(root, tmp_path, monkeypatch):
    from realpdebench_tpu.eval.__main__ import run_eval as jrun_eval
    from realpdebench_tpu_torch.eval.__main__ import run_eval

    pth = str(tmp_path / "w.pth")
    _jax_fno_pth(pth)
    # 16 output frames: the panels' frame t//4·k + (t−1)%4 stays inside
    plots = dict(checkpoint_path=pth, N_plot=1, probe_diagnostic=True, N_plot_probe=2,
                 N_autoregressive=4)
    rec = {}
    for name, run, cfg in (("jax", jrun_eval, _jcfg(root, **plots)),
                           ("port", run_eval, _pcfg(root, **plots))):
        exp = str(tmp_path / name)
        rec[name] = _Recorder(monkeypatch, exp, save=name == "port")
        kw = {} if name == "jax" else dict(device="cpu")
        run(cfg, exp, **kw)
        monkeypatch.undo()
    ref, got = rec["jax"].calls, rec["port"].calls
    assert [c[0] for c in got] == [c[0] for c in ref]
    # c = 2 measured channels (p is not measured on real data): one figure
    # each of 12 panels; 2 probe figures (u, v) for each of 2 windows, of
    # 2 curves at each of the 4 stations
    assert rec["port"].names() == ["figs/pred_target_0_channel0.png",
                                   "figs/pred_target_0_channel1.png",
                                   *[f"probe_diagnostic/probe_diagnostic_{c}_{i}.pdf"
                                     for c in "uv" for i in range(2)]]
    assert sum(c[0] == "imshow" for c in got) == 2 * 12
    assert sum(c[0] == "plot" for c in got) == 4 * 4 * 2
    for a, b in zip(got, ref):
        if a[0] == "savefig":
            assert a == b
        elif a[0] == "imshow":
            _close(a[1], b[1])
        else:
            assert a[3] == b[3]
            _close(a[1], b[1])
            _close(a[2], b[2])
    assert _files(str(tmp_path / "port")) == sorted(rec["port"].names())


@pytest.mark.parametrize("model", ["unet", "galerkin_transformer"])
def test_shipped_configs_write_the_jax_file_names(root, tmp_path, monkeypatch, model):
    """`eval --config cylinder/<model>.yaml` with its shipped N_plot and
    N_plot_probe (the UNet's 1 and 12 with the probe diagnostic; the GK's
    1, no probes)."""
    import realpdebench_tpu_torch.eval.__main__ as pe
    from realpdebench_tpu.eval import plots as jplots
    from realpdebench_tpu.eval import probes as jprobes
    from realpdebench_tpu_torch.config import load_config, make_arg_parser, parse_config
    from realpdebench_tpu_torch.models.registry import build_model
    from realpdebench_tpu_torch.train.loop import model_kwargs

    sizes = {"unet": dict(dim_mults=[1, 2]),
             "galerkin_transformer": dict(n_hidden=16, n_head=2, dim_feedforward=16,
                                          fourier_modes_x=2, fourier_modes_y=2,
                                          fourier_modes_t=2, freq_dim=8)}[model]
    shipped = load_config(f"cylinder/{model}.yaml")
    assert shipped.N_plot == 1
    assert bool(shipped.get("probe_diagnostic")) == (model == "unet")
    pth = str(tmp_path / "w.pth")

    drawn = []
    for fn in ("plot_result", "probe_diagnostic"):
        def rec(*a, _f=getattr(pe, fn), _n=fn, **k):
            if "exp_path" in k or _n == "plot_result":
                drawn.append((_n, a, k))
            return _f(*a, **k)
        monkeypatch.setattr(pe, fn, rec)
    keys = {**sizes, "N_autoregressive": 4, "test_batch_size": 2, "num_workers": 0,
            "dataset_root": root, "checkpoint_path": pth, **{k: BASE[k] for k in (
                "in_step", "out_step", "interval", "trunk_length", "n_sim_frame",
                "n_sim_in_distribution", "n_sim_out_distribution", "sub_s_real",
                "sub_s_numerical", "generate_ids_if_missing")}}
    argv = ["--config", f"cylinder/{model}.yaml", "--device", "cpu",
            "--results_path", str(tmp_path / "port")]
    for k, v in keys.items():
        argv += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
    net = build_model(shapes=(SHAPE, SHAPE), device="cpu",
                      **model_kwargs(parse_config(make_arg_parser(), argv)))
    torch.save({"model_state_dict": net.state_dict()}, pth)
    exp, results = pe.main(argv)
    assert np.isfinite(results["rmse"])

    # the JAX package's plot functions on the same arrays
    jexp = str(tmp_path / "jax")
    rec = _Recorder(monkeypatch, jexp, save=False)
    for fn, a, k in drawn:
        a = [x.numpy() if isinstance(x, torch.Tensor) else x for x in a]
        if fn == "plot_result":
            jplots.plot_result(a[0], a[1], jexp, *a[3:])
        else:
            jprobes.probe_diagnostic(*a, **{**k, "exp_path": jexp})
    n_probe = min(shipped.get("N_plot_probe") or 0, 2) if model == "unet" else 0
    assert len(rec.names()) == 2 + 2 * n_probe
    assert _files(exp) == sorted(rec.names())
