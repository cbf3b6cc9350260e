"""Hugging Face Arrow-backed dataset sources — V2 lazy-slicing format.

Counterpart of ``realpdebench_tpu/data/hf_datasets.py`` (reference
`realpdebench/data/fluid_hf_dataset.py`, `combustion_hf_dataset.py`):
complete trajectories are stored once in an Arrow dataset per
``{scenario}/hf_dataset/{type}/``; JSON index files
``{split}_index_{type}.json`` map samples to (sim_id, time_id); slicing
``[time_id : time_id+horizon, ::sub_s, ::sub_s]`` happens at read time, so
any N_autoregressive works without re-conversion. Test-params filters come
from JSON sidecars (fluid_hf_dataset.py:196-243).

These classes inherit the noise, conditioning and windowing code of the
HDF5 datasets; only the storage access differs. A window is sliced out of
the field's bytes in place, in the memory-mapped Arrow table
(``np.frombuffer`` over the value's slice of the column's data buffer), so
no row is copied whole: the JAX package's classes decode the row through
``datasets`` (every field of the row as Python ``bytes``) for each window.
The bytes, the draws and the items are the same.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List

import numpy as np

from realpdebench_tpu_torch import check_data_version
from realpdebench_tpu_torch.data import splits as S
from realpdebench_tpu_torch.data.combustion import CombustionDataset
from realpdebench_tpu_torch.data.fluid import (
    Cylinder,
    ControlledCylinder,
    FluidDataset,
    Foil,
    FSI,
)
from realpdebench_tpu_torch.utils.misc import derive_seed


class _HFTrajectoryMixin:
    """Arrow + JSON-index storage layer shared by all HF dataset classes."""

    def _init_hf(
        self,
        dataset_name,
        dataset_root,
        dataset_type,
        mode,
        test_mode,
        N_autoregressive,
        hf_auto_download=False,
        hf_repo_id="AI4Science-WestlakeU/RealPDEBench",
        hf_endpoint=None,
        hf_revision=None,
    ):
        check_data_version(dataset_root)
        self.dataset_dir = os.path.join(dataset_root, dataset_name)
        self.dataset_path = os.path.join(self.dataset_dir, dataset_type)
        self.hf_dataset_dir = os.path.join(self.dataset_dir, "hf_dataset")
        self.sub_s = (
            self.sub_s_real if dataset_type == "real" else self.sub_s_numerical
        )

        trajectory_path = os.path.join(self.hf_dataset_dir, dataset_type)
        index_path = os.path.join(
            self.hf_dataset_dir, f"{mode}_index_{dataset_type}.json"
        )
        if not (os.path.exists(trajectory_path) and os.path.exists(index_path)):
            from realpdebench_tpu_torch.data.hf_download import ensure_hf_artifacts

            ensure_hf_artifacts(
                dataset_root=dataset_root,
                scenario=dataset_name,
                dataset_type=dataset_type,
                split=mode,
                need_test_params_json=(
                    mode in ("val", "test") and test_mode != "all"
                ),
                hf_auto_download=hf_auto_download,
                repo_id=hf_repo_id,
                endpoint=hf_endpoint,
                revision=hf_revision,
            )
        if not os.path.exists(trajectory_path):
            raise FileNotFoundError(
                f"HF Arrow trajectories not found: {trajectory_path}\n"
                "Run `python -m realpdebench_tpu_torch convert ...`"
            )
        if not os.path.exists(index_path):
            raise FileNotFoundError(f"Index file not found: {index_path}")

        from datasets import load_from_disk

        self.trajectories = load_from_disk(trajectory_path)
        # the memory-mapped Arrow table behind the dataset: windows are cut
        # from a field's buffer in place, and the index reads one column
        self._table = self.trajectories.data
        self._sim_id_to_idx: Dict[str, int] = {
            s: i for i, s in enumerate(self._table.column("sim_id").to_pylist())
        }
        with open(index_path) as f:
            indices: List[dict] = json.load(f)
        logging.info(
            f"{type(self).__name__}: {len(self.trajectories)} trajectories, "
            f"{len(indices)} indices ({mode}/{dataset_type})"
        )

        # feed the parent-class split machinery
        self.sim_id_mapping = {mode: [e["sim_id"] for e in indices]}
        self.time_id_mapping = {mode: [e["time_id"] for e in indices]}

        self.in_dist_test_params = {}
        self.out_dist_test_params = {}
        self.remain_params = {}
        if mode in ("val", "test") and test_mode != "all":
            self._load_test_params_json(dataset_type)
            sids, tids = S.filter_test_mode(
                self.sim_id_mapping[mode], self.time_id_mapping[mode],
                test_mode, self.in_dist_test_params,
                self.out_dist_test_params, self.remain_params,
            )
            self.sim_id_mapping[mode] = sids
            self.time_id_mapping[mode] = tids
        if mode in ("val", "test") and N_autoregressive > 1:
            sids, tids = S.filter_horizon(
                self.sim_id_mapping[mode], self.time_id_mapping[mode],
                self.horizon, self.n_sim_frame,
            )
            self.sim_id_mapping[mode] = sids
            self.time_id_mapping[mode] = tids

    def _load_test_params_json(self, dataset_type):
        for name in ("in_dist_test_params", "out_dist_test_params",
                     "remain_params"):
            path = os.path.join(self.dataset_dir, f"{name}_{dataset_type}.json")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"Missing JSON test params file: {path}"
                )
            with open(path) as f:
                setattr(self, name, json.load(f))

    def _row(self, sim_id) -> tuple:
        """(row index, (shape_t, shape_h, shape_w)) of a trajectory."""
        i = self._sim_id_to_idx[sim_id]
        return i, tuple(self._table.column(k)[i].as_py()
                        for k in ("shape_t", "shape_h", "shape_w"))

    def _field(self, i, name, shape) -> np.ndarray:
        """Row ``i``'s float32 field ``name`` as a read-only array over the
        table's memory. The value's bytes are found through the binary
        column's offsets: a scalar of the column (``column[i]``) would copy
        them out first."""
        import pyarrow as pa

        for chunk in self._table.column(name).chunks:
            if i < len(chunk):
                break
            i -= len(chunk)
        _, offsets, data = chunk.buffers()
        kind = np.int64 if chunk.type == pa.large_binary() else np.int32
        lo, hi = np.frombuffer(offsets, kind, count=2,
                               offset=(chunk.offset + i) * np.dtype(kind).itemsize)
        return np.frombuffer(data.slice(int(lo), int(hi - lo)),
                             dtype=np.float32).reshape(shape)


class FluidHFDataset(_HFTrajectoryMixin, FluidDataset):
    """Arrow-backed fluid dataset; row schema: sim_id, shape_t/h/w,
    u, v [, p] as float32 bytes."""

    def __init__(self, dataset_name, dataset_root, dataset_type, mode,
                 hf_auto_download=False,
                 hf_repo_id="AI4Science-WestlakeU/RealPDEBench",
                 hf_endpoint=None, hf_revision=None, test_mode="all",
                 seed=0, generate_ids_if_missing=False, **kw):
        # the parent's parameter bookkeeping without its directory scan
        defaults = dict(
            mask_prob=0.5, in_step=20, out_step=20, N_autoregressive=1,
            interval=10, train_ratio=0.5, trunk_length=190, noise_scale=0.0,
            n_sim_frame=2173, sub_s_real=1, sub_s_numerical=2,
            noise_type="gaussian", optical_kernel_size=4, optical_sigma=1.0,
        )
        defaults.update({k: v for k, v in kw.items() if k in defaults})
        self.dataset_type = dataset_type
        self.mode = mode
        self.test_mode = test_mode
        self.mask_prob = defaults["mask_prob"]
        self.noise_scale = defaults["noise_scale"]
        self.noise_type = defaults["noise_type"]
        self.optical_kernel_size = defaults["optical_kernel_size"]
        self.optical_sigma = defaults["optical_sigma"]
        self.sub_s_real = defaults["sub_s_real"]
        self.sub_s_numerical = defaults["sub_s_numerical"]
        self.in_step = defaults["in_step"]
        self.out_step = defaults["out_step"] * defaults["N_autoregressive"]
        self.N_autoregressive = defaults["N_autoregressive"]
        self.horizon = self.in_step + self.out_step
        self.n_sim_frame = defaults["n_sim_frame"]
        self._rng = np.random.default_rng(derive_seed(seed, mode, dataset_type))
        self._init_hf(
            dataset_name, dataset_root, dataset_type, mode, test_mode,
            defaults["N_autoregressive"], hf_auto_download, hf_repo_id,
            hf_endpoint, hf_revision,
        )

    def _read_window(self, sim_id, time_id):
        i, shape = self._row(sim_id)
        sub = self.sub_s
        sl = slice(time_id, time_id + self.horizon)
        u = self._field(i, "u", shape)[sl, ::sub, ::sub]
        v = self._field(i, "v", shape)[sl, ::sub, ::sub]
        if self.dataset_type == "real" or self._rng.random() < self.mask_prob:
            p = np.zeros_like(u)
        else:
            p = self._field(i, "p", shape)[sl, ::sub, ::sub]
        return np.stack([u, v, p], axis=-1).astype(np.float32)


class CylinderHFDataset(FluidHFDataset):
    file_name_pattern = Cylinder.file_name_pattern
    condition_on_para = False
    d, center_x, center_y = Cylinder.d, Cylinder.center_x, Cylinder.center_y

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        kw.setdefault("in_step", 20)
        kw.setdefault("out_step", 20)
        kw.setdefault("interval", 20)
        kw.setdefault("trunk_length", 250)
        kw.setdefault("n_sim_frame", 3990)
        kw.setdefault("sub_s_real", 1)
        kw.setdefault("sub_s_numerical", 2)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **kw)


class FSIHFDataset(FluidHFDataset):
    file_name_pattern = FSI.file_name_pattern
    condition_on_para = False
    d, center_x, center_y = FSI.d, FSI.center_x, FSI.center_y

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        kw.setdefault("n_sim_frame", 2173)
        kw.setdefault("sub_s_real", 2)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **kw)


class ControlledCylinderHFDataset(FluidHFDataset):
    file_name_pattern = ControlledCylinder.file_name_pattern
    condition_on_para = True
    d = ControlledCylinder.d
    center_x, center_y = ControlledCylinder.center_x, ControlledCylinder.center_y

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        kw.setdefault("in_step", 10)
        kw.setdefault("out_step", 10)
        kw.setdefault("interval", 20)
        kw.setdefault("trunk_length", 250)
        kw.setdefault("n_sim_frame", 3990)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **kw)


class FoilHFDataset(FluidHFDataset):
    file_name_pattern = Foil.file_name_pattern
    condition_on_para = False
    d, center_x, center_y = Foil.d, Foil.center_x, Foil.center_y

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        kw.setdefault("in_step", 20)
        kw.setdefault("out_step", 20)
        kw.setdefault("interval", 20)
        kw.setdefault("trunk_length", 250)
        kw.setdefault("n_sim_frame", 3990)
        kw.setdefault("sub_s_real", 2)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **kw)


class CombustionHFDataset(_HFTrajectoryMixin, CombustionDataset):
    """Arrow-backed combustion dataset; row schema: sim_id, shape_t/h/w,
    observed (T·H·W f32 bytes) [, numerical (T·H·W·numerical_channels),
    numerical_channels] — reference combustion_hf_dataset.py:258-345."""

    file_name_pattern = CombustionDataset.file_name_pattern
    condition_on_para = False
    numerical_channel = 15
    d, center_x, center_y = 0, 0, 0

    def __init__(self, dataset_name, dataset_root, dataset_type, mode,
                 hf_auto_download=False,
                 hf_repo_id="AI4Science-WestlakeU/RealPDEBench",
                 hf_endpoint=None, hf_revision=None, test_mode="all",
                 seed=0, generate_ids_if_missing=False, **kw):
        defaults = dict(
            mask_prob=0.8, in_step=20, out_step=20, N_autoregressive=1,
            interval=1, trunk_length=101, noise_scale=0.0, n_sim_frame=2001,
            sub_s_real=2, sub_s_numerical=2, noise_type="gaussian",
            optical_kernel_size=4, optical_sigma=1.0,
        )
        defaults.update({k: v for k, v in kw.items() if k in defaults})
        self.dataset_type = dataset_type
        self.mode = mode
        self.test_mode = test_mode
        for k in ("mask_prob", "noise_scale", "noise_type",
                  "optical_kernel_size", "optical_sigma", "sub_s_real",
                  "sub_s_numerical", "n_sim_frame"):
            setattr(self, k, defaults[k])
        self.in_step = defaults["in_step"]
        self.out_step = defaults["out_step"] * defaults["N_autoregressive"]
        self.N_autoregressive = defaults["N_autoregressive"]
        self.horizon = self.in_step + self.out_step
        self._rng = np.random.default_rng(derive_seed(seed, mode, dataset_type))
        self._init_hf(
            dataset_name, dataset_root, dataset_type, mode, test_mode,
            defaults["N_autoregressive"], hf_auto_download, hf_repo_id,
            hf_endpoint, hf_revision,
        )

    def _read_window(self, sim_id, time_id):
        i, shape = self._row(sim_id)
        sub = self.sub_s
        sl = slice(time_id, time_id + self.horizon)
        obs = self._field(i, "observed", shape)[sl, ::sub, ::sub]
        obs = obs[..., None].astype(np.float32)
        if self.dataset_type == "real":
            zeros = np.zeros(obs.shape[:3] + (self.numerical_channel,),
                             np.float32)
            return np.concatenate([obs, zeros], axis=-1)
        if self._rng.random() < self.mask_prob:
            num = np.zeros(obs.shape[:3] + (self.numerical_channel,),
                           np.float32)
        else:
            nc = self._table.column("numerical_channels")[i].as_py()
            num = self._field(i, "numerical", (*shape, nc))[
                sl, ::sub, ::sub
            ].astype(np.float32)
        return np.concatenate([obs, num], axis=-1)


HF_DATASETS = {
    "cylinder": CylinderHFDataset,
    "fsi": FSIHFDataset,
    "controlled_cylinder": ControlledCylinderHFDataset,
    "foil": FoilHFDataset,
    "combustion": CombustionHFDataset,
}
