"""PyTorch port vs JAX package: the 13 metrics, the unmeasured-channel
count and the probe diagnostic, on the CPU.

``eval_metrics`` against ``realpdebench_tpu.eval.metrics.eval_metrics`` on
seeded arrays at rtol 1e-5 (atol 1e-6 of the metric's scale), each metric
on its own (a radial bin off by one at K shows only in ``high_f_error``),
at odd and even t/h/w, c of 1, 2 and 3, and chunked; the radial bins and
band edges equal; inputs as numpy arrays or torch tensors.
"""

import os
import sys

import numpy as np
import pytest
import torch

from realpdebench_tpu.eval import metrics as jm
from realpdebench_tpu.eval import probes as jp
from realpdebench_tpu_torch.eval import metrics as tm
from realpdebench_tpu_torch.eval import probes as tp


def _pair(shape, seed, c_total=3):
    r = np.random.default_rng(seed)
    target = r.normal(size=(*shape, c_total)).astype(np.float32)
    pred = (target + 0.3 * r.normal(size=target.shape)).astype(np.float32)
    return pred, target


def _assert_metrics(got, ref):
    assert len(got) == len(ref) == 13
    for name, g, r in zip(tm.METRIC_NAMES, got, ref):
        if np.isnan(r):
            assert np.isnan(g), name
            continue
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6 * max(abs(r), 1e-3),
                                   err_msg=name)


def test_metric_names_and_bins_match_jax():
    assert tm.METRIC_NAMES == jm.METRIC_NAMES
    for t, h, w in ((20, 64, 128), (7, 9, 11), (8, 6, 10), (3, 4, 5)):
        got, ref = tm._radial_bins(t, h, w), jm._radial_bins(t, h, w)
        assert np.array_equal(got[0], ref[0]) and got[1:] == ref[1:]


@pytest.mark.parametrize("shape", [(3, 8, 12, 16), (2, 7, 9, 11), (4, 10, 6, 9),
                                   (2, 9, 16, 8)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("c", [1, 2, 3])
def test_metrics_match_jax(shape, c):
    pred, target = _pair(shape, seed=sum(shape) + c)
    ref = jm.eval_metrics(pred, target, c)
    _assert_metrics(tm.eval_metrics(pred, target, c), ref)
    _assert_metrics(tm.eval_metrics(torch.from_numpy(pred), torch.from_numpy(target), c), ref)


@pytest.mark.parametrize("batch_size", [2, 3, 5])
def test_chunked_metrics_match_jax(batch_size):
    pred, target = _pair((7, 8, 10, 12), seed=batch_size)
    _assert_metrics(tm.eval_metrics(pred, target, 2, batch_size),
                    jm.eval_metrics(pred, target, 2, batch_size))
    assert tm.eval_metrics_dict(pred, target, 2) == pytest.approx(
        jm.eval_metrics_dict(pred, target, 2), rel=1e-5, nan_ok=True)


def test_perfect_prediction_matches_jax():
    _, target = _pair((2, 8, 8, 8), seed=3)
    got = tm.eval_metrics(target, target, 3)
    _assert_metrics(got, jm.eval_metrics(target, target, 3))
    assert got[0] == 0 and got[3] == 1


@pytest.mark.parametrize("zeros", [(), (2,), (1, 2), (0, 1, 2)])
def test_infer_unmeasured_channels_matches_jax(zeros):
    _, target = _pair((2, 4, 5, 6), seed=4)
    target[..., list(zeros)] = 0.0
    ref = jm.infer_unmeasured_channels(target)
    assert tm.infer_unmeasured_channels(target) == ref == len(zeros)
    assert tm.infer_unmeasured_channels(torch.from_numpy(target)) == ref


@pytest.mark.parametrize("geometry", [(18, 32, 32, 1, (20, 64, 128)),
                                      (62, 30, 64, 2, (6, 64, 64)),
                                      (18, 4, 4, 1, (4, 8, 8))],
                         ids=["cylinder", "foil", "tiny"])
def test_probe_diagnostic_matches_jax(geometry):
    d, cx, cy, sub, (t, h, w) = geometry
    pred, target = _pair((3, t, h, w), seed=d)
    ref = jp.probe_diagnostic(pred, target, d, cx, cy, sub)
    for p_, t_ in ((pred, target), (torch.from_numpy(pred), torch.from_numpy(target))):
        got = tp.probe_diagnostic(p_, t_, d, cx, cy, sub)
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_probe_plots_are_not_ported(tmp_path, monkeypatch):
    """The probe plots: N_plot 0
    draws nothing and needs no matplotlib; N_plot 1 draws the JAX
    package's two files (``tests/test_torch_plots.py`` holds what is drawn);
    without matplotlib, asking for a plot raises its ImportError."""
    pred, target = _pair((1, 4, 8, 8), seed=0)
    errors = tp.probe_diagnostic(pred, target, 18, 4, 4, 1, N_plot=0,
                                 exp_path=str(tmp_path))
    assert errors and not os.listdir(tmp_path)
    assert tp.probe_diagnostic(pred, target, 18, 4, 4, 1, N_plot=1,
                               exp_path=str(tmp_path)) == errors
    assert sorted(os.listdir(tmp_path / "probe_diagnostic")) == [
        "probe_diagnostic_u_0.pdf", "probe_diagnostic_v_0.pdf"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        tp.probe_diagnostic(pred, target, 18, 4, 4, 1, N_plot=1, exp_path=str(tmp_path))
