"""Offline HDF5 → Hugging Face Arrow (V2 lazy-slicing) converter.

Counterpart of ``realpdebench_tpu/tools/convert_hdf5_to_hf.py`` (reference
`realpdebench/utils/convert_hdf5_to_hf.py`, V2 schema documented at its
module top): complete full-resolution trajectories stored once per row,
per-split JSON index files generated from the shipped sim/time
id-mappings, and the test-params artifacts exported as JSON sidecars for
the Arrow datasets' test_mode filters.

Row schemas:
  fluid:       {sim_id, shape_t, shape_h, shape_w, u, v[, p]}   (f32 bytes)
  combustion:  {sim_id, shape_t, shape_h, shape_w, observed
                [, numerical, numerical_channels]}
  surrogate_train (combustion): {sim_id, shape_t, shape_h, shape_w,
                real, numerical, numerical_channels}

Reading the HDF5 rows (h5py) is kept apart from writing a type's Arrow
dataset (``write_dataset_v2`` and ``write_surrogate_train``, which need
``datasets`` alone), so a tree held in memory (``fluid_row`` over arrays,
(sim_id, real, numerical) surrogate pairs) is written the same way.

Usage:
    python -m realpdebench_tpu_torch convert \
        --dataset-root ./datasets --scenario cylinder --types real numerical
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def fluid_row(sim_id, u, v, p=None) -> dict:
    """One fluid trajectory's row from its [T, H, W] fields (p: numerical
    data only)."""
    u = np.asarray(u, np.float32)
    row = {
        "sim_id": sim_id,
        "shape_t": u.shape[0],
        "shape_h": u.shape[1],
        "shape_w": u.shape[2],
        "u": u.tobytes(),
        "v": np.asarray(v, np.float32).tobytes(),
    }
    if p is not None:
        row["p"] = np.asarray(p, np.float32).tobytes()
    return row


def _fluid_rows(dataset_path, dataset_type):
    import h5py

    for fn in sorted(os.listdir(dataset_path)):
        if not fn.endswith(".h5"):
            continue
        with h5py.File(os.path.join(dataset_path, fn), "r") as f:
            g = f["measured_data"]
            p = g["p"] if dataset_type == "numerical" and "p" in g else None
            yield fluid_row(fn, g["u"], g["v"], p)


def _combustion_rows(scenario_dir, dataset_type):
    import h5py

    dataset_path = os.path.join(scenario_dir, dataset_type)
    surrogate_path = os.path.join(scenario_dir, "surrogate")
    for fn in sorted(os.listdir(dataset_path)):
        if not fn.endswith(".h5"):
            continue
        if dataset_type == "real":
            with h5py.File(os.path.join(dataset_path, fn), "r") as f:
                obs = np.asarray(f["trajectory"], np.float32)
            row = dict(
                sim_id=fn, shape_t=obs.shape[0], shape_h=obs.shape[1],
                shape_w=obs.shape[2], observed=obs.tobytes(),
            )
        else:
            with h5py.File(os.path.join(surrogate_path, fn), "r") as f:
                obs = np.asarray(f["measured_data"], np.float32)
            with h5py.File(os.path.join(dataset_path, fn), "r") as f:
                num = np.asarray(f["measured_data"], np.float32)
            row = dict(
                sim_id=fn, shape_t=obs.shape[0], shape_h=obs.shape[1],
                shape_w=obs.shape[2], observed=obs.tobytes(),
                numerical=num.tobytes(), numerical_channels=num.shape[-1],
            )
        yield row


def generate_index_files(dataset_dir, hf_dir, dataset_type):
    """{split}_index_{type}.json from the shipped id-mapping artifacts
    (reference convert_hdf5_to_hf.py `generate_index_files`)."""
    from realpdebench_tpu_torch.data.splits import load_id_mappings

    loaded = load_id_mappings(dataset_dir, dataset_type)
    if loaded is None:
        raise FileNotFoundError(
            f"No id-mapping artifacts under {dataset_dir} for {dataset_type}"
        )
    in_p, out_p, rem_p, sim_map, time_map = loaded
    for split in ("train", "val", "test"):
        entries = [
            {"sim_id": s, "time_id": int(t)}
            for s, t in zip(sim_map.get(split, []), time_map.get(split, []))
        ]
        path = os.path.join(hf_dir, f"{split}_index_{dataset_type}.json")
        with open(path, "w") as f:
            json.dump(entries, f)
    return in_p, out_p, rem_p


def export_test_params_json(dataset_dir, dataset_type, in_p, out_p, rem_p):
    """Test-params artifacts → JSON sidecars for the Arrow datasets."""
    for name, obj in (
        (f"in_dist_test_params_{dataset_type}.json", in_p),
        (f"out_dist_test_params_{dataset_type}.json", out_p),
        (f"remain_params_{dataset_type}.json", rem_p),
    ):
        with open(os.path.join(dataset_dir, name), "w") as f:
            json.dump({k: list(v) for k, v in obj.items()}, f)


def write_dataset_v2(scenario_dir, dataset_type, rows) -> str:
    """Write one type's rows as ``{scenario_dir}/hf_dataset/{dataset_type}``,
    with its index files and test-params sidecars from the id mappings
    under ``scenario_dir``; returns the Arrow directory."""
    from datasets import Dataset

    hf_dir = os.path.join(scenario_dir, "hf_dataset")
    os.makedirs(hf_dir, exist_ok=True)
    rows = list(rows)
    out = os.path.join(hf_dir, dataset_type)
    Dataset.from_list(rows).save_to_disk(out)
    in_p, out_p, rem_p = generate_index_files(scenario_dir, hf_dir, dataset_type)
    export_test_params_json(scenario_dir, dataset_type, in_p, out_p, rem_p)
    print(f"{os.path.basename(scenario_dir)}/{dataset_type}: {len(rows)} "
          f"trajectories → {out}")
    return out


def convert_dataset_v2(dataset_root, scenario, dataset_types=("real",
                                                              "numerical")):
    """Convert one scenario to the V2 Arrow layout; returns hf_dataset dir."""
    scenario_dir = os.path.join(dataset_root, scenario)
    for dtype in dataset_types:
        if scenario == "combustion":
            rows = _combustion_rows(scenario_dir, dtype)
        else:
            rows = _fluid_rows(os.path.join(scenario_dir, dtype), dtype)
        write_dataset_v2(scenario_dir, dtype, rows)
    return os.path.join(scenario_dir, "hf_dataset")


def surrogate_rows(sim_id, real, numerical, step=20, n_sim_frame=40):
    """One surrogate-train pair's rows, one per time window: ``real`` the
    [T, H, W] observation, ``numerical`` the [T, H, W, 15] fields."""
    real_full = np.asarray(real, np.float32)
    num_full = np.asarray(numerical, np.float32)
    for time_id in range(n_sim_frame - step):
        real = real_full[time_id : time_id + step]
        num = num_full[time_id : time_id + step]
        yield dict(
            sim_id=sim_id, time_id=time_id,
            real_shape_t=real.shape[0], real_shape_h=real.shape[1],
            real_shape_w=real.shape[2],
            numerical_shape_t=num.shape[0], numerical_shape_h=num.shape[1],
            numerical_shape_w=num.shape[2],
            numerical_channels=num.shape[-1],
            real=real.tobytes(), numerical=num.tobytes(),
        )


def write_surrogate_train(scenario_dir, pairs, step=20, n_sim_frame=40):
    """Write the surrogate-train Arrow dataset from ``pairs`` of (sim_id,
    real, numerical) arrays, in the order given (sorted by sim_id as the
    HDF5 reader gives them): rows with sim_ids OUTER × time_ids inner, the
    ordering the reference HF wrapper asserts
    (combustion_surrogate_hf_dataset.py:193-199). Needs ``datasets``
    alone."""
    from datasets import Dataset

    hf_dir = os.path.join(scenario_dir, "hf_dataset")
    os.makedirs(hf_dir, exist_ok=True)
    rows, sim_ids = [], []
    for sim_id, real, numerical in pairs:
        sim_ids.append(sim_id)
        rows.extend(surrogate_rows(sim_id, real, numerical, step, n_sim_frame))
    Dataset.from_list(rows).save_to_disk(
        os.path.join(hf_dir, "surrogate_train")
    )
    with open(os.path.join(hf_dir, "surrogate_train_sim_ids.txt"), "w") as f:
        f.write("\n".join(sim_ids))
    with open(os.path.join(hf_dir, "surrogate_train_meta.json"), "w") as f:
        json.dump({"n_sim": len(sim_ids), "step": step,
                   "n_sim_frame": n_sim_frame}, f)
    print(f"combustion/surrogate_train: {len(rows)} windows, "
          f"{len(sim_ids)} sims")


def _surrogate_pairs(scenario_dir):
    import h5py

    real_dir = os.path.join(scenario_dir, "real_surrogate_train")
    num_dir = os.path.join(scenario_dir, "numerical_surrogate_train")
    for fn in sorted(os.listdir(num_dir)):
        if not fn.endswith(".h5"):
            continue
        with h5py.File(os.path.join(real_dir, fn), "r") as f:
            real = np.asarray(f["trajectory"], np.float32)
        with h5py.File(os.path.join(num_dir, fn), "r") as f:
            num = np.asarray(f["measured_data"], np.float32)
        yield fn, real, num


def convert_surrogate_train(dataset_root, step=20, n_sim_frame=40):
    """Combustion surrogate-train pairs (HDF5) → Arrow: the HDF5 files read
    by h5py, written by ``write_surrogate_train``."""
    scenario_dir = os.path.join(dataset_root, "combustion")
    write_surrogate_train(scenario_dir, _surrogate_pairs(scenario_dir), step,
                          n_sim_frame)


def main(argv=None):
    parser = argparse.ArgumentParser(description="HDF5 → Arrow V2 converter")
    parser.add_argument("--dataset-root", required=True)
    parser.add_argument("--scenario", required=True)
    parser.add_argument("--types", nargs="+", default=["real", "numerical"])
    parser.add_argument("--surrogate-train", action="store_true",
                        help="also convert combustion surrogate-train pairs")
    args = parser.parse_args(argv)
    convert_dataset_v2(args.dataset_root, args.scenario, tuple(args.types))
    if args.surrogate_train and args.scenario == "combustion":
        convert_surrogate_train(args.dataset_root)


if __name__ == "__main__":
    main()
