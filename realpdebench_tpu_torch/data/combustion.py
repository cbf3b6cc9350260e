"""Combustion dataset: paired real Schlieren-like observations and 15-field
numerical simulations, bridged by a learned surrogate channel.

Counterpart of ``realpdebench_tpu/data/combustion.py``. Reference semantics: `realpdebench/data/combustion_dataset.py:13-367`.
Channel layout (16 total):
  * real:      [trajectory(1)] + [15 zero channels]  — the numerical fields
               are unobserved in experiments (`combustion_dataset.py:321-329`)
  * numerical: [surrogate(1)] + [15 simulated fields], where the surrogate
               channel comes from `{scenario}/surrogate/{sim}.h5` (rolled out
               by a trained FNO surrogate, see train_surrogate) and the 15
               fields are masked to zero with prob ``mask_prob``
               (`combustion_dataset.py:331-345`).
Defaults (mask_prob=0.8, interval=1, trunk 101, 2001 frames, sub 2/2) per
`combustion_dataset.py:14-37`.
"""

from __future__ import annotations

import os

import numpy as np

from realpdebench_tpu_torch.data.fluid import FluidDataset


class CombustionDataset(FluidDataset):
    file_name_pattern = r"(\d+)NH3_(\d+\.?\d*)\.h5"
    condition_on_para = False
    numerical_channel = 15
    d, center_x, center_y = 0, 0, 0  # no probe geometry for combustion

    def __init__(self, dataset_name, dataset_root, dataset_type, mode, **kw):
        defaults = dict(
            test_mode="all", mask_prob=0.8, in_step=20, out_step=20,
            N_autoregressive=1, interval=1, train_ratio=0.5,
            split_numerical=False, trunk_length=101, noise_scale=0.0,
            n_sim_in_distribution=0, n_sim_out_distribution=0,
            n_sim_frame=2001, sub_s_real=2, sub_s_numerical=2,
        )
        defaults.update(kw)
        super().__init__(dataset_name, dataset_root, dataset_type, mode, **defaults)
        self.surrogate_dataset_path = os.path.join(self.dataset_dir, "surrogate")

    def _read_window(self, sim_id: str, time_id: int) -> np.ndarray:
        import h5py

        hor = self.horizon
        if self.dataset_type == "real":
            sub = self.sub_s_real
            with h5py.File(os.path.join(self.dataset_path, f"{sim_id}"), "r") as f:
                obs = f["trajectory"][time_id : time_id + hor, ::sub, ::sub]
            obs = obs[..., None].astype(np.float32)
            zeros = np.zeros(obs.shape[:3] + (self.numerical_channel,), np.float32)
            return np.concatenate([obs, zeros], axis=-1)

        sub = self.sub_s_numerical
        with h5py.File(
            os.path.join(self.surrogate_dataset_path, f"{sim_id}"), "r"
        ) as f:
            sur = f["measured_data"][time_id : time_id + hor, ::sub, ::sub]
        sur = sur[..., None].astype(np.float32)
        if self._rng.random() < self.mask_prob:
            num = np.zeros(sur.shape[:3] + (self.numerical_channel,), np.float32)
        else:
            with h5py.File(os.path.join(self.dataset_path, f"{sim_id}"), "r") as f:
                num = f["measured_data"][
                    time_id : time_id + hor, ::sub, ::sub
                ].astype(np.float32)
        return np.concatenate([sur, num], axis=-1)
