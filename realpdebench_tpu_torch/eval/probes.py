"""Probe-based wake diagnostic.

Counterpart of ``realpdebench_tpu/eval/probes.py`` (reference
`realpdebench/utils/metrics.py:133-230`, ``probe_diagnostic``): time-averaged
profiles at 9 y-probes × 4 x-stations downstream of the body (1D..4D, or
1D..3D at half-steps when the domain is short), normalized to the target's
min/max per station, mean-abs-error per station, optional plots. Numpy on
the host, once per eval batch; matplotlib is imported only where the
probe plots are drawn.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def probe_diagnostic(
    pred,
    target,
    d,
    center_x,
    center_y,
    sub_s_real,
    start_time_pred=0,
    start_time_target=0,
    horizon=None,
    N_plot=None,
    exp_path=None,
):
    """pred/target: [b, t, h, w, c] arrays or tensors (the probes are
    gathered on their device, then moved). Returns list of per-station MAE."""
    N_probe = 9
    s1, s2 = pred.shape[2], pred.shape[3]
    if horizon is None:
        horizon = pred.shape[1]

    probe_center_y = int(center_y / sub_s_real)
    interval_y = min(2, int(s1 / (N_probe + 1)))
    probe_y = [
        probe_center_y + interval_y * j
        for j in range(-(N_probe - 1) // 2, N_probe - (N_probe - 1) // 2)
    ]
    # robustness guard for small (synthetic) grids: the published datasets all
    # satisfy these bounds, tiny fixtures may not
    probe_y = [min(max(p, 0), s1 - 1) for p in probe_y]

    probe_pred_list, probe_target_list, probe_error_list = [], [], []
    station_labels = []
    for i in range(4):
        if int((2 * d + center_x) / sub_s_real) < s2:
            probe_x = int(((i + 1) * d + center_x) / sub_s_real)
            station_labels.append(f"{i + 1}D")
        else:
            probe_x = int((0.5 * (i + 2) * d + center_x) / sub_s_real)
            station_labels.append(f"{0.5 * (i + 2)}D")
        probe_x = min(probe_x, s2 - 1)

        pp = _host(pred[:, start_time_pred : start_time_pred + horizon][
            :, :, probe_y, probe_x, :
        ].mean(1))  # [b, N_probe, c]
        pt = _host(target[:, start_time_target : start_time_target + horizon][
            :, :, probe_y, probe_x, :
        ].mean(1))
        if pp.shape[-1] != pt.shape[-1]:
            pt = pt[..., : pp.shape[-1]]
        probe_error_list.append(float(np.mean(np.abs(pp - pt))))
        probe_pred_list.append(pp)
        probe_target_list.append(pt)

    # normalize profiles to target range, ×1.5 (metrics.py:171-179)
    for i in range(len(probe_pred_list)):
        mn = probe_target_list[i].min(axis=1, keepdims=True)
        probe_pred_list[i] = probe_pred_list[i] - mn
        probe_target_list[i] = probe_target_list[i] - mn
        nrm = probe_target_list[i].max(axis=1, keepdims=True)
        nrm = np.where(nrm == 0, 1, nrm)
        probe_pred_list[i] = probe_pred_list[i] / nrm * 1.5
        probe_target_list[i] = probe_target_list[i] / nrm * 1.5

    # N_plot 0 draws nothing and imports nothing (the JAX package imports
    # matplotlib and makes the empty directory even then)
    if exp_path is not None and N_plot:
        _plot_probes(
            probe_pred_list, probe_target_list, probe_y, station_labels,
            min(N_plot, pred.shape[0]), exp_path,
        )
    return probe_error_list


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _plot_probes(pred_list, target_list, probe_y, labels, n_plot, exp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = os.path.join(exp_path, "probe_diagnostic")
    os.makedirs(out_dir, exist_ok=True)
    for comp, comp_name in ((0, "u"), (1, "v")):
        for idx in range(n_plot):
            fig, axes = plt.subplots(
                1, len(pred_list), figsize=(3 * len(pred_list), 6)
            )
            if len(pred_list) == 1:
                axes = [axes]
            y_axis = (
                np.linspace(-1, 1, len(probe_y)) if comp == 0 else probe_y
            )
            for i, ax in enumerate(axes):
                if target_list[i].shape[-1] <= comp:
                    continue
                ax.plot(target_list[i][idx, :, comp], y_axis, marker="o",
                        label="Target", color="blue")
                ax.plot(pred_list[i][idx, :, comp], y_axis, marker="x",
                        label="Pred", color="orange")
                ax.set_ylabel("$y/D$")
                ax.set_xlabel("$u/U_0$")
                ax.set_title(f"${labels[i]}$")
                ax.legend()
            plt.suptitle("Probe Based Diagnostic")
            plt.tight_layout()
            plt.savefig(
                os.path.join(out_dir, f"probe_diagnostic_{comp_name}_{idx}.pdf")
            )
            plt.close()
