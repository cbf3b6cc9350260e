"""Data normalizers: identity / gaussian (per-channel z-score) / range.

Counterpart of ``realpdebench_tpu/data/normalizer.py``. Statistics come
from a dict of arrays, from the cache next to a dataset (``mean_std.npz`` /
``max.npz``, as the JAX package writes them, or the reference's
``mean_std.pt`` / ``max.pt``), or are streamed once over a dataset and
cached there. The Gaussian accumulation is the reference's pooled formula
in f64 (per-sample spatial means summed over samples, per-batch biased
variances weighted by batch size), so cached statistics are interchangeable
with the reference's. Channel-sliced apply (``[..., :c]``) lets a 3-channel
statistics vector normalize 2-channel targets, as in the reference.
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

    def __init__(self, dataset=None, batch_size: int = 512, is_save: bool = True,
                 stats: dict | None = None, cache_dir: str | None = None):
        if stats is None:
            if cache_dir is None and dataset is None:
                raise ValueError(f"{type(self).__name__} needs a dataset, "
                                 "stats= or the cache_dir of its statistics")
            cache_dir = cache_dir or dataset.dataset_dir
            npz_path = os.path.join(cache_dir, self.cache_name + ".npz")
            pt_path = os.path.join(cache_dir, self.cache_name + ".pt")
            if is_save and os.path.exists(npz_path):
                with np.load(npz_path) as f:
                    stats = {k: f[k] for k in self.keys}
            elif is_save and os.path.exists(pt_path):
                loaded = torch.load(pt_path, map_location="cpu", weights_only=False)
                stats = {k: np.asarray(v) for k, v in zip(self.keys, loaded)}
            elif dataset is None:
                raise ValueError(f"no {self.cache_name}.npz or .pt under "
                                 f"{cache_dir}, and no dataset to compute it from")
            else:
                stats = self._compute(dataset, batch_size)
                if is_save:
                    np.savez(npz_path, **stats)
        for k in self.keys:
            v = np.asarray(stats[k], np.float32)
            # a zero spread or range scales by one, as in the reference
            if not k.startswith("mean"):
                v = np.where(v == 0, 1.0, v).astype(np.float32)
            setattr(self, k, torch.from_numpy(v))
        self._device_stats = {}

    def _compute(self, dataset, batch_size) -> dict:
        raise NotImplementedError

    @staticmethod
    def _iter_batches(dataset, batch_size):
        n = len(dataset)
        for s in range(0, n, batch_size):
            items = [dataset[i] for i in range(s, min(s + batch_size, n))]
            xs = np.stack([it[0] for it in items])
            ys = np.stack([it[1] for it in items])
            yield xs, ys

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

    def _compute(self, dataset, batch_size):
        n_samples = 0
        mean_i = mean_t = 0.0
        var_i = var_t = 0.0
        for xs, ys in self._iter_batches(dataset, batch_size):
            b, c1, c2 = xs.shape[0], xs.shape[-1], ys.shape[-1]
            xf = xs.reshape(b, -1, c1).astype(np.float64)
            yf = ys.reshape(b, -1, c2).astype(np.float64)
            # per-sample spatial mean summed over samples; pooled biased var
            mean_i = mean_i + xf.mean(axis=1).sum(0)
            var_i = var_i + xf.var(axis=(0, 1)) * b
            mean_t = mean_t + yf.mean(axis=1).sum(0)
            var_t = var_t + yf.var(axis=(0, 1)) * b
            n_samples += b
        return dict(
            mean_inputs=(mean_i / n_samples).astype(np.float32),
            mean_targets=(mean_t / n_samples).astype(np.float32),
            std_inputs=np.sqrt(var_i / n_samples).astype(np.float32),
            std_targets=np.sqrt(var_t / n_samples).astype(np.float32),
        )

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

    def _compute(self, dataset, batch_size):
        max_i = max_t = None
        for xs, ys in self._iter_batches(dataset, batch_size):
            bi = np.abs(xs.reshape(-1, xs.shape[-1])).max(axis=0)
            bt = np.abs(ys.reshape(-1, ys.shape[-1])).max(axis=0)
            max_i = bi if max_i is None else np.maximum(max_i, bi)
            max_t = bt if max_t is None else np.maximum(max_t, bt)
        return dict(max_inputs=max_i.astype(np.float32),
                    max_targets=max_t.astype(np.float32))

    def preprocess(self, x, y):
        c1, c2 = x.shape[-1], y.shape[-1]
        return (x / self._on("max_inputs", x, c1),
                y / self._on("max_targets", y, c2))

    def postprocess(self, x, y):
        c1, c2 = x.shape[-1], y.shape[-1]
        return (x * self._on("max_inputs", x, c1),
                y * self._on("max_targets", y, c2))


def build_normalizer(name: str, dataset=None, **kw):
    """Factory with the JAX package's names and signature: 'none',
    'gaussian', 'range'; ``kw`` are ``batch_size``, ``is_save``, ``stats``
    and ``cache_dir``."""
    if name == "none":
        return IdentityNormalizer()
    if name == "gaussian":
        return GaussianNormalizer(dataset, **kw)
    if name == "range":
        return RangeNormalizer(dataset, **kw)
    raise ValueError(f"Normalizer {name} not supported")
