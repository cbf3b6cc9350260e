"""Prediction/GT/error panel plots.

Counterpart of ``realpdebench_tpu/eval/plots.py`` (reference
`utils/utils.py:64-97`): the same figures under the same file names;
matplotlib is imported only here, inside the call, with the Agg backend.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch


def plot_result(pred, target, exp_path, N_plot, unmeasured_c):
    """pred/target: [b, t, h, w, c] arrays or tensors (moved to the host)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig_dir = os.path.join(exp_path, "figs")
    os.makedirs(fig_dir, exist_ok=True)

    pred, target = (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a) for a in (pred, target))
    b, t_, h, w, c = pred.shape
    N_plot = min(N_plot, b)
    c = c - unmeasured_c

    for idx in range(N_plot):
        for i in range(c):
            fig, axes = plt.subplots(3, 4, figsize=(20, 10))
            for k in range(4):
                t = t_ // 4 * k + (t_ - 1) % 4
                error = np.abs(pred[idx, t, :, :, i] - target[idx, t, :, :, i])
                for row, (img, title) in enumerate(
                    (
                        (error, f"Error, t={t}"),
                        (pred[idx, t, :, :, i], f"Prediction, t={t}"),
                        (target[idx, t, :, :, i], f"Ground Truth, t={t}"),
                    )
                ):
                    im = axes[row, k].imshow(img)
                    axes[row, k].set_title(title)
                    fig.colorbar(im, ax=axes[row, k], orientation="vertical",
                                 fraction=0.02, pad=0.04)
            plt.tight_layout()
            plt.savefig(os.path.join(fig_dir, f"pred_target_{idx}_channel{i}.png"))
            plt.close()
    logging.info(f"Visualization results saved at {fig_dir}")
