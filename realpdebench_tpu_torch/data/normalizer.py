"""Data normalizers: identity / gaussian (per-channel z-score) / range.

Counterpart of ``realpdebench_tpu/data/normalizer.py``. Statistics come
from a dict of arrays or from the ``.npz`` cache that the JAX package writes
next to a dataset (``mean_std.npz`` / ``max.npz``). Computing them from a
dataset waits for the data layer (ROADMAP.md queue A). Channel-sliced apply
(``[..., :c]``) lets a 3-channel statistics vector normalize 2-channel
targets, as in the reference.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class IdentityNormalizer:
    """No-op."""

    def preprocess(self, x, y):
        return x, y

    def postprocess(self, x, y):
        return x, y


class _StatsNormalizer:
    cache_name = ""
    keys: tuple = ()

    def __init__(self, stats: dict | None = None, cache_dir: str | None = None):
        if stats is None:
            if cache_dir is None:
                raise NotImplementedError(
                    "computing normalizer statistics from a dataset is not "
                    "ported yet (ROADMAP.md queue A); pass stats= or the "
                    "cache_dir holding " + self.cache_name + ".npz")
            with np.load(os.path.join(cache_dir, self.cache_name + ".npz")) as f:
                stats = {k: f[k] for k in self.keys}
        for k in self.keys:
            v = np.asarray(stats[k], np.float32)
            # a zero spread or range scales by one, as in the reference
            if not k.startswith("mean"):
                v = np.where(v == 0, 1.0, v).astype(np.float32)
            setattr(self, k, torch.from_numpy(v))
        self._device_stats = {}

    def _on(self, key: str, like: torch.Tensor, c: int) -> torch.Tensor:
        """The statistic ``key``'s first ``c`` channels on ``like``'s device.
        Each statistic crosses to a device once and is cached there, so a
        call makes no host-to-device copy (the JAX package holds them as
        device constants of the jitted step)."""
        v = self._device_stats.get((key, like.device))
        if v is None:
            v = self._device_stats[(key, like.device)] = getattr(self, key).to(like.device)
        return v[..., :c]


class GaussianNormalizer(_StatsNormalizer):
    """Per-channel z-score."""

    cache_name = "mean_std"
    keys = ("mean_inputs", "mean_targets", "std_inputs", "std_targets")

    def preprocess(self, x, y):
        c1, c2 = x.shape[-1], y.shape[-1]
        x = (x - self._on("mean_inputs", x, c1)) / self._on("std_inputs", x, c1)
        y = (y - self._on("mean_targets", y, c2)) / self._on("std_targets", y, c2)
        return x, y

    def postprocess(self, x, y):
        c1, c2 = x.shape[-1], y.shape[-1]
        x = x * self._on("std_inputs", x, c1) + self._on("mean_inputs", x, c1)
        y = y * self._on("std_targets", y, c2) + self._on("mean_targets", y, c2)
        return x, y


class RangeNormalizer(_StatsNormalizer):
    """Per-channel abs-max scaling."""

    cache_name = "max"
    keys = ("max_inputs", "max_targets")

    def preprocess(self, x, y):
        c1, c2 = x.shape[-1], y.shape[-1]
        return (x / self._on("max_inputs", x, c1),
                y / self._on("max_targets", y, c2))

    def postprocess(self, x, y):
        c1, c2 = x.shape[-1], y.shape[-1]
        return (x * self._on("max_inputs", x, c1),
                y * self._on("max_targets", y, c2))


def build_normalizer(name: str, stats: dict | None = None,
                     cache_dir: str | None = None):
    """Factory with the JAX package's names: 'none', 'gaussian', 'range'."""
    if name == "none":
        return IdentityNormalizer()
    if name == "gaussian":
        return GaussianNormalizer(stats=stats, cache_dir=cache_dir)
    if name == "range":
        return RangeNormalizer(stats=stats, cache_dir=cache_dir)
    raise ValueError(f"Normalizer {name} not supported")
