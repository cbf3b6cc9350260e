"""Sim-vs-real probe diagnostic over paired trajectories.

Counterpart of ``realpdebench_tpu/tools/numerical_real_compare.py``
(reference ``realpdebench/data/numerical_real_compare.py:108-178``): for
each trajectory present in both ``real/`` and ``numerical/``, read the
(u, v) fields, optionally align the start times at the frame of least
total norm, and compare the time-averaged wake profiles with
``eval.probes.probe_diagnostic``.

Usage:
    python -m realpdebench_tpu_torch.tools.numerical_real_compare \
        --dataset_root ./datasets --dataset_name cylinder [--is_interval]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from realpdebench_tpu_torch.data.fluid import FLUID_DATASETS
from realpdebench_tpu_torch.eval.probes import probe_diagnostic


def _uv(path: str, sub: int) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        g = f["measured_data"]
        return np.stack([g["u"][:, ::sub, ::sub], g["v"][:, ::sub, ::sub]], axis=-1)[None]


def compare(dataset_root, dataset_name, is_interval=False, horizon=200, N_plot=0,
            exp_path="./results/numerical_real_compare", dataset_kwargs=None):
    """The per-station probe errors of the numerical trajectories against
    the real ones."""
    dataset_dir = os.path.join(dataset_root, dataset_name)
    real_path = os.path.join(dataset_dir, "real")
    num_path = os.path.join(dataset_dir, "numerical")
    out_path = os.path.join(exp_path, dataset_name)
    os.makedirs(out_path, exist_ok=True)
    dataset = FLUID_DATASETS[dataset_name](dataset_name=dataset_name,
                                           dataset_root=dataset_root, mode="test",
                                           dataset_type="real", **(dataset_kwargs or {}))

    num_list, real_list = [], []
    start_num = start_real = 0
    for fn in sorted(os.listdir(real_path)):
        if not fn.endswith(".h5"):
            continue
        real = _uv(os.path.join(real_path, fn), dataset.sub_s_real)
        num = _uv(os.path.join(num_path, fn), dataset.sub_s_numerical)
        if is_interval:
            start_real = int(np.argmin(np.sqrt((real[0] ** 2).sum(axis=(1, 2, 3)))[:-horizon]))
            start_num = int(np.argmin(np.sqrt((num[0] ** 2).sum(axis=(1, 2, 3)))[:-horizon]))
        else:
            start_num = start_real = 0
            horizon = real.shape[1]
        num_list.append(num)
        real_list.append(real)

    errors = probe_diagnostic(
        np.concatenate(num_list, axis=0), np.concatenate(real_list, axis=0), dataset.d,
        dataset.center_x, dataset.center_y, dataset.sub_s_real,
        start_time_pred=start_num, start_time_target=start_real, horizon=horizon,
        N_plot=N_plot or None, exp_path=out_path if N_plot else None)
    logging.info(f"Probe diagnostic (numerical vs real) on {dataset_name}: "
                 f"{float(np.mean(errors))}")
    return errors


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_root", type=str, default="./datasets")
    parser.add_argument("--dataset_name", type=str, default="foil")
    parser.add_argument("--is_interval", action="store_true")
    parser.add_argument("--horizon", type=int, default=200)
    parser.add_argument("--N_plot", type=int, default=0)
    parser.add_argument("--exp_path", type=str, default="./results/numerical_real_compare")
    args = parser.parse_args(argv)
    errors = compare(args.dataset_root, args.dataset_name, args.is_interval, args.horizon,
                     args.N_plot, args.exp_path)
    print(f"Probe based diagnostic: {np.mean(errors)}")


if __name__ == "__main__":
    main()
