"""Combustion surrogate-training datasets (HDF5 and Arrow backends).

Counterpart of ``realpdebench_tpu/data/surrogate.py`` (reference
``realpdebench/data/combustion_surrogate_dataset.py:12-75`` and
``combustion_surrogate_hf_dataset.py``). The surrogate maps the 15
simulated combustion fields plus two parameter planes (gas ratio,
equivalence ratio) to the 1-channel real observation.

``__getitem__`` ignores its index and draws a random (sim, time) crop;
the epoch length is n_sim·n_sim_frame for train and the held-out fraction
for test. The crop generator is seeded with ``derive_seed(seed, mode)``:
the JAX package seeds with ``seed + hash(mode)``, which Python salts per
process, so its draws are not reproducible and the port does not copy
them; a test gives both packages the same generator.
"""

from __future__ import annotations

import os
import re

import numpy as np

from realpdebench_tpu_torch.utils.misc import derive_seed

FILE_NAME_PATTERN = r"(\d+)NH3_(\d+\.?\d*)\.h5"


def sim_params(sim_id: str) -> tuple:
    """(gas ratio, equivalence ratio) from a trajectory's file name."""
    m = re.match(FILE_NAME_PATTERN, sim_id)
    return int(m.group(1)), float(m.group(2))


def with_param_planes(num: np.ndarray, sim_id: str) -> np.ndarray:
    """The 15 fields [..., 15] plus the gas and equivalence-ratio planes:
    the surrogate's 17-channel input."""
    gas, equiv = sim_params(sim_id)
    ones = np.ones_like(num[..., :1])
    return np.concatenate([num, gas * ones, equiv * ones], axis=-1)


class SurrogateDataset:
    """(numerical fields + parameter planes, real observation) windows of
    ``step`` frames from ``combustion/{real,numerical}_surrogate_train``."""

    file_name_pattern = FILE_NAME_PATTERN

    def __init__(self, dataset_name, dataset_root, mode, train_ratio=0.8,
                 step=20, n_sim_frame=40, n_sim_frame_test=2001,
                 sub_s_real=1, sub_s_numerical=1, seed=0):
        assert dataset_name == "combustion"
        self.dataset_dir = os.path.join(dataset_root, dataset_name)
        self.real_dataset_path = os.path.join(self.dataset_dir, "real_surrogate_train")
        self.numerical_dataset_path = os.path.join(self.dataset_dir,
                                                   "numerical_surrogate_train")
        self.sim_ids = sorted(f for f in os.listdir(self.numerical_dataset_path)
                              if f.endswith(".h5"))
        self._setup(mode, train_ratio, step, n_sim_frame, sub_s_real, sub_s_numerical, seed)

    def _setup(self, mode, train_ratio, step, n_sim_frame, sub_s_real, sub_s_numerical,
               seed) -> None:
        self.n_sim = len(self.sim_ids)
        self.mode, self.step, self.n_sim_frame = mode, step, n_sim_frame
        self.train_ratio = train_ratio
        self.sub_s_real, self.sub_s_numerical = sub_s_real, sub_s_numerical
        self.numerical_channel = 15
        self.time_ids = list(range(n_sim_frame - step))
        self._rng = np.random.default_rng(derive_seed(seed, mode))

    def _load_pair(self, sim_id, time_id):
        import h5py

        sr, sn = self.sub_s_real, self.sub_s_numerical
        with h5py.File(os.path.join(self.real_dataset_path, sim_id), "r") as f:
            real = f["trajectory"][time_id:time_id + self.step, ::sr, ::sr]
        with h5py.File(os.path.join(self.numerical_dataset_path, sim_id), "r") as f:
            num = f["measured_data"][time_id:time_id + self.step, ::sn, ::sn]
        return real.astype(np.float32)[..., None], num.astype(np.float32)

    def __getitem__(self, idx):
        sim_id = self.sim_ids[self._rng.integers(len(self.sim_ids))]
        time_id = self.time_ids[self._rng.integers(len(self.time_ids))]
        real, num = self._load_pair(sim_id, time_id)
        return with_param_planes(num, sim_id), real      # (T,H,W,17), (T,H,W,1)

    def __len__(self):
        if self.mode == "train":
            return int(self.n_sim * self.n_sim_frame)
        return int(self.n_sim * self.n_sim_frame / self.train_ratio * (1 - self.train_ratio))


class CombustionSurrogateHFDataset(SurrogateDataset):
    """The Arrow V2 variant: one row a (sim, time) window, sims outer × time
    inner (reference ``combustion_surrogate_hf_dataset.py:181-213``), as
    ``tools.convert_hdf5_to_hf.write_surrogate_train`` writes them."""

    def __init__(self, dataset_name, dataset_root, mode, hf_auto_download=False,
                 hf_repo_id="AI4Science-WestlakeU/RealPDEBench", hf_endpoint=None,
                 hf_revision=None, train_ratio=0.8, step=20, n_sim_frame=40,
                 sub_s_real=1, sub_s_numerical=1, seed=0, **kw):
        assert dataset_name == "combustion"
        self.dataset_dir = os.path.join(dataset_root, dataset_name)
        self.hf_dir = os.path.join(self.dataset_dir, "hf_dataset")
        traj_path = os.path.join(self.hf_dir, "surrogate_train")
        if not os.path.exists(traj_path) and hf_auto_download:
            from realpdebench_tpu_torch.data.hf_download import download_realpdebench

            download_realpdebench(
                dataset_root=dataset_root, scenarios=["combustion"], what="hf_dataset",
                include_surrogate_train=True, repo_id=hf_repo_id, endpoint=hf_endpoint,
                revision=hf_revision)
        from datasets import load_from_disk

        self.trajectories = load_from_disk(traj_path)
        with open(os.path.join(self.hf_dir, "surrogate_train_sim_ids.txt")) as f:
            self.sim_ids = [line.strip() for line in f if line.strip()]
        self.real_dataset_path = self.numerical_dataset_path = traj_path
        self._setup(mode, train_ratio, step, n_sim_frame, sub_s_real, sub_s_numerical, seed)

    def _load_pair(self, sim_id, time_id):
        row = self.trajectories[self.sim_ids.index(sim_id) * len(self.time_ids) + time_id]
        if row["sim_id"] != sim_id or int(row["time_id"]) != int(time_id):
            raise RuntimeError(
                "HF surrogate dataset ordering mismatch; re-run conversion "
                "with sim_ids outer loop and time_ids inner loop.")
        real = np.frombuffer(row["real"], np.float32).reshape(
            row["real_shape_t"], row["real_shape_h"], row["real_shape_w"]
        )[:, ::self.sub_s_real, ::self.sub_s_real][..., None]
        num = np.frombuffer(row["numerical"], np.float32).reshape(
            row["numerical_shape_t"], row["numerical_shape_h"], row["numerical_shape_w"],
            row["numerical_channels"],
        )[:, ::self.sub_s_numerical, ::self.sub_s_numerical]
        return real, num
