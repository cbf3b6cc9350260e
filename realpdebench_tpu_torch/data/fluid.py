"""Fluid-scenario datasets (cylinder / fsi / controlled_cylinder / foil), HDF5.

Counterpart of ``realpdebench_tpu/data/fluid.py`` (reference semantics:
`realpdebench/data/fluid_dataset.py`). Each sample is a sliding temporal
window over one trajectory file:

    input  = data[:in_step]          # (in_step, H, W, C)
    target = data[in_step:horizon]   # (out_step*N_autoregressive, H, W, C)

with channels (u, v, p) where p is zeroed for real data (not measured), and
masked with probability ``mask_prob`` for numerical data. Noise injection
(gaussian/poisson/optical) and parameter-conditioning channels
(controlled_cylinder) are applied on the host. Items are numpy arrays; the
mask and noise draws come from the same numpy stream as in the JAX
package, so items are equal to its items bit for bit.

``with_arrays`` makes a subclass that reads its windows from arrays in
memory instead of HDF5 files (for hosts without h5py); everything else,
the draws included, is the same.
"""

from __future__ import annotations

import contextlib
import os
import random
import re

import numpy as np

from realpdebench_tpu_torch.data import splits as S
from realpdebench_tpu_torch.utils.misc import derive_seed


def gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """Normalized 2-D Gaussian kernel (reference data/dataset.py:130-142)."""
    k1 = np.linspace(-(size // 2), size // 2, size)
    k1 = np.exp(-0.5 * (k1 / sigma) ** 2)
    k1 = k1 / k1.sum()
    k2 = np.outer(k1, k1)
    return k2 / k2.sum()


def apply_gaussian_blur(data: np.ndarray, kernel_size: int, sigma: float):
    """Channel-wise spatial Gaussian blur of (T, H, W, C) data.

    The reference helper (`data/dataset.py:144-150`) passes mismatched shapes
    to F.conv2d; this implements the documented intent — an 'optical noise'
    low-pass blur over H, W applied independently per (T, C) slice — via two
    separable 1-D convolutions ('same' padding, zero boundary).
    """
    k1 = np.linspace(-(kernel_size // 2), kernel_size // 2, kernel_size)
    k1 = np.exp(-0.5 * (k1 / sigma) ** 2)
    k1 = (k1 / k1.sum()).astype(data.dtype)

    def conv_axis(x, axis):
        pad = [(0, 0)] * x.ndim
        half = kernel_size // 2
        pad[axis] = (half, kernel_size - 1 - half)
        xp = np.pad(x, pad)
        out = np.zeros_like(x)
        for i, w in enumerate(k1):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(i, i + x.shape[axis])
            out += w * xp[tuple(sl)]
        return out

    return conv_axis(conv_axis(data, 1), 2)


class FluidDataset:
    """Base fluid dataset. Subclasses set scenario constants (regex, probe
    geometry, default windows) — reference fluid_dataset.py:404-552."""

    # subclass attributes
    file_name_pattern: str = r"(\d+)\.h5"
    condition_on_para: bool = False
    d: int = 18
    center_x: int = 32
    center_y: int = 32

    # measured HDF5 channel names in order
    channels = ("u", "v", "p")

    def __init__(
        self,
        dataset_name: str,
        dataset_root: str,
        dataset_type: str,
        mode: str,
        test_mode: str = "all",
        mask_prob: float = 0.5,
        in_step: int = 20,
        out_step: int = 20,
        N_autoregressive: int = 1,
        interval: int = 10,
        train_ratio: float = 0.5,
        split_numerical: bool = False,
        trunk_length: int = 190,
        noise_scale: float = 0.0,
        n_sim_in_distribution: int = 0,
        n_sim_out_distribution: int = 4,
        n_sim_frame: int = 2173,
        sub_s_real: int = 1,
        sub_s_numerical: int = 2,
        noise_type: str = "gaussian",
        optical_kernel_size: int = 4,
        optical_sigma: float = 1.0,
        seed: int = 0,
        generate_ids_if_missing: bool = False,
    ):
        self.dataset_dir = os.path.join(dataset_root, dataset_name)
        self.dataset_path = os.path.join(self.dataset_dir, dataset_type)
        self.dataset_type = dataset_type
        self.mode = mode
        self.test_mode = test_mode
        self.mask_prob = mask_prob
        self.noise_scale = noise_scale
        self.noise_type = noise_type
        self.optical_kernel_size = optical_kernel_size
        self.optical_sigma = optical_sigma
        self.sub_s_real = sub_s_real
        self.sub_s_numerical = sub_s_numerical

        n_sim = len(self._sim_files())
        self.spec = S.SplitSpec(
            n_sim=n_sim,
            n_sim_frame=n_sim_frame,
            in_step=in_step,
            out_step=out_step,
            N_autoregressive=N_autoregressive,
            interval=interval,
            train_ratio=train_ratio,
            dataset_type=dataset_type,
            split_numerical=split_numerical,
            n_sim_in_distribution=n_sim_in_distribution,
            n_sim_out_distribution=n_sim_out_distribution,
            trunk_length=trunk_length,
        )
        self.in_step = in_step
        self.out_step = out_step * N_autoregressive
        self.N_autoregressive = N_autoregressive
        self.horizon = self.spec.horizon
        self.n_sim_frame = n_sim_frame

        self._rng = np.random.default_rng(derive_seed(seed, mode, dataset_type))

        loaded = S.load_id_mappings(self.dataset_dir, dataset_type)
        if loaded is None:
            if not generate_ids_if_missing:
                raise ValueError(
                    f"Error loading dataset ids from {self.dataset_dir} "
                    f"(expected shipped sim/time id-mapping artifacts)"
                )
            file_params = S.parse_file_names(self._sim_files(),
                                             self.file_name_pattern)
            pr = random.Random(seed)
            in_p, out_p, rem_p = S.separate_test_params(
                file_params,
                n_sim_in_distribution,
                n_sim_out_distribution,
                pr,
            )
            self.spec = S.SplitSpec(
                **{
                    **self.spec.__dict__,
                    "n_sim_in_distribution": len(in_p),
                    "n_sim_out_distribution": len(out_p),
                }
            )
            sim_map, time_map = S.assign_sim_and_time_ids(
                self.spec, in_p, out_p, rem_p, pr
            )
            loaded = (in_p, out_p, rem_p, sim_map, time_map)
            S.save_id_mappings(self.dataset_dir, dataset_type, loaded)
        (
            self.in_dist_test_params,
            self.out_dist_test_params,
            self.remain_params,
            self.sim_id_mapping,
            self.time_id_mapping,
        ) = loaded

        if self.mode in ("val", "test"):
            if self.test_mode != "all":
                sids, tids = S.filter_test_mode(
                    self.sim_id_mapping[self.mode],
                    self.time_id_mapping[self.mode],
                    self.test_mode,
                    self.in_dist_test_params,
                    self.out_dist_test_params,
                    self.remain_params,
                )
                self.sim_id_mapping[self.mode] = sids
                self.time_id_mapping[self.mode] = tids
            if self.N_autoregressive > 1:
                sids, tids = S.filter_horizon(
                    self.sim_id_mapping[self.mode],
                    self.time_id_mapping[self.mode],
                    self.horizon,
                    self.n_sim_frame,
                )
                self.sim_id_mapping[self.mode] = sids
                self.time_id_mapping[self.mode] = tids

    # ---------------- item access ----------------

    def _sim_files(self) -> list:
        """The ``.h5`` trajectory file names of this dataset type."""
        return [f for f in os.listdir(self.dataset_path) if f.endswith(".h5")]

    @contextlib.contextmanager
    def _measured(self, sim_id: str):
        """One trajectory's ``measured_data`` group: channel → array-like."""
        import h5py

        with h5py.File(os.path.join(self.dataset_path, f"{sim_id}"), "r") as f:
            yield f["measured_data"]

    def _read_window(self, sim_id: str, time_id: int) -> np.ndarray:
        """Read one (horizon, H, W, 3) window; p zeroed (real) or mask_prob-
        masked (numerical) — reference fluid_dataset.py:346-372."""
        sub = self.sub_s_real if self.dataset_type == "real" else self.sub_s_numerical
        with self._measured(sim_id) as g:
            u = g["u"][time_id : time_id + self.horizon, ::sub, ::sub]
            v = g["v"][time_id : time_id + self.horizon, ::sub, ::sub]
            if self.dataset_type == "real":
                p = np.zeros_like(u)
            elif self._rng.random() < self.mask_prob:
                p = np.zeros_like(u)
            else:
                p = g["p"][time_id : time_id + self.horizon, ::sub, ::sub]
        return np.stack([u, v, p], axis=-1).astype(np.float32)

    def _inject_noise(self, x: np.ndarray) -> np.ndarray:
        """Numerical-data noise injection (reference fluid_dataset.py:377-388)."""
        if self.noise_type == "gaussian":
            return x + x * self._rng.standard_normal(x.shape).astype(x.dtype) * self.noise_scale
        if self.noise_type == "poisson":
            lam = np.clip(x, 0, None).astype(np.float64)
            return x + self._rng.poisson(lam).astype(x.dtype) * self.noise_scale
        if self.noise_type == "optical":
            return apply_gaussian_blur(x, self.optical_kernel_size, self.optical_sigma)
        raise ValueError(f"Invalid noise type: {self.noise_type}")

    def __getitem__(self, idx: int):
        sim_id = self.sim_id_mapping[self.mode][idx]
        time_id = self.time_id_mapping[self.mode][idx]
        data = self._read_window(sim_id, time_id)

        inp = data[: self.in_step]
        out = data[self.in_step :]

        if self.noise_scale > 0 and self.dataset_type == "numerical":
            inp = self._inject_noise(inp)
            out = self._inject_noise(out)

        if self.condition_on_para:
            match = re.match(self.file_name_pattern, sim_id)
            planes = [
                float(g) * np.ones_like(inp[..., 0]) for g in match.groups()
            ]
            inp = np.concatenate([inp, np.stack(planes, axis=-1)], axis=-1)

        return inp, out

    def __len__(self):
        return len(self.sim_id_mapping[self.mode])


class Cylinder(FluidDataset):
    """Flow past a fixed cylinder (reference fluid_dataset.py:404-439)."""

    file_name_pattern = r"(\d+)\.h5"
    condition_on_para = False
    d, center_x, center_y = 18, 32, 32

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        defaults = dict(
            test_mode="all", mask_prob=0.5, in_step=20, out_step=20,
            N_autoregressive=1, interval=20, train_ratio=0.5,
            split_numerical=False, trunk_length=250, noise_scale=0.0,
            n_sim_in_distribution=10, n_sim_out_distribution=10,
            n_sim_frame=3990, sub_s_real=1, sub_s_numerical=2,
        )
        defaults.update(kw)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **defaults)


class FSI(FluidDataset):
    """Fluid–structure interaction (reference fluid_dataset.py:442-477)."""

    file_name_pattern = r"(\d+)_([\d\.]+)_"
    condition_on_para = False
    d, center_x, center_y = 24, 66, 64

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        defaults = dict(
            test_mode="all", mask_prob=0.5, in_step=20, out_step=20,
            N_autoregressive=1, interval=10, train_ratio=0.5,
            split_numerical=False, trunk_length=190, noise_scale=0.0,
            n_sim_in_distribution=0, n_sim_out_distribution=4,
            n_sim_frame=2173, sub_s_real=2, sub_s_numerical=2,
        )
        defaults.update(kw)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **defaults)


class ControlledCylinder(FluidDataset):
    """Rotation-controlled cylinder; appends parameter-conditioning channels
    (reference fluid_dataset.py:480-515)."""

    file_name_pattern = r"(\d+)_(\d+\.?\d*)\.h5"
    condition_on_para = True
    d, center_x, center_y = 18, 16, 32

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        defaults = dict(
            test_mode="all", mask_prob=0.5, in_step=10, out_step=10,
            N_autoregressive=1, interval=20, train_ratio=0.5,
            split_numerical=False, trunk_length=250, noise_scale=0.0,
            n_sim_in_distribution=10, n_sim_out_distribution=10,
            n_sim_frame=3990, sub_s_real=1, sub_s_numerical=2,
        )
        defaults.update(kw)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **defaults)


class Foil(FluidDataset):
    """3-D tapered NACA foil slice (reference fluid_dataset.py:517-552)."""

    file_name_pattern = r"(\d+)_(\d+\.?\d*)\.h5"
    condition_on_para = False
    d, center_x, center_y = 62, 30, 64

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        defaults = dict(
            test_mode="all", mask_prob=0.5, in_step=20, out_step=20,
            N_autoregressive=1, interval=20, train_ratio=0.5,
            split_numerical=False, trunk_length=250, noise_scale=0.0,
            n_sim_in_distribution=10, n_sim_out_distribution=10,
            n_sim_frame=3990, sub_s_real=2, sub_s_numerical=2,
        )
        defaults.update(kw)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **defaults)


FLUID_DATASETS = {
    "cylinder": Cylinder,
    "fsi": FSI,
    "controlled_cylinder": ControlledCylinder,
    "foil": Foil,
}


def with_arrays(cls, arrays: dict):
    """A subclass of the fluid dataset ``cls`` whose trajectories are
    ``arrays[dataset_type][file name][channel]`` ([T, H, W] arrays at the
    files' resolution, as ``data.synthetic.fluid_arrays`` makes them) instead
    of HDF5 files. The id mappings and the normalizer cache still live under
    ``dataset_root``; reads, draws and items are those of ``cls``."""

    class InMemory(cls):
        def _sim_files(self) -> list:
            return list(arrays[self.dataset_type])

        @contextlib.contextmanager
        def _measured(self, sim_id: str):
            yield arrays[self.dataset_type][sim_id]

    InMemory.__name__ = InMemory.__qualname__ = f"InMemory{cls.__name__}"
    return InMemory
