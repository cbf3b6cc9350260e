"""Evaluation metric suite: 13 scalars, as the reference computes them.

Counterpart of ``realpdebench_tpu/eval/metrics.py`` (reference
`realpdebench/utils/metrics.py:24-131`): RMSE, MAE, Rel-L2, R², the
kinetic-energy error, the radially binned Fourier errors (full, low, mid,
high, and relative low, mid, high) and the frequency error of the spatially
summed signal. A voxel (i, j, k) of the positive-frequency octant falls in
radial bin floor(sqrt(i²+j²+k²)); bins ≥ K = min(t//2, h//2, w//2) are
dropped. The bins are summed with one ``index_add_`` over a precomputed
bin index (the JAX package's ``segment_sum``), cached per shape and device.

Everything runs on the tensors' device (cuFFT on the card); ``eval_metrics``
chunks the batch as the reference does and averages the chunks' 13 values
at the end, with one transfer to the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

METRIC_NAMES = (
    "rmse",
    "mae",
    "rel_l2_error",
    "r2",
    "ke_error",
    "f_error",
    "low_f_error",
    "mid_f_error",
    "high_f_error",
    "rel_low_f_error",
    "rel_mid_f_error",
    "rel_high_f_error",
    "freq_error",
)


def mse_loss(pred, target):
    """Elementwise squared error (reference `metrics.py:11-13`, reduction='none')."""
    return (pred - target) ** 2


def kinetic_energy(x):
    """Turbulent kinetic-energy map. x: [b,t,h,w,c] → [b,h,w]: the time
    variance of u and v, k = ½(u'²+v'²) (reference `metrics.py:15-22`)."""
    u = x[..., 0]
    v = x[..., 1]
    u_prime = ((u - u.mean(dim=1, keepdim=True)) ** 2).mean(dim=1)
    v_prime = ((v - v.mean(dim=1, keepdim=True)) ** 2).mean(dim=1)
    return 0.5 * (u_prime + v_prime)


@functools.lru_cache(maxsize=64)
def _radial_bins(t: int, h: int, w: int):
    """Radial bin index of each voxel of the positive-frequency octant
    [0:t//2, 0:h//2, 0:w//2] (numpy, flat), K, and the band edges.

    Indices ≥ K go to an overflow bin K that is discarded, as the
    reference's ``continue`` (`metrics.py:79-80,97-98`); the band edges
    iLow/iHigh use np.round like the reference (`metrics.py:84-85`).
    """
    K = min(t // 2, h // 2, w // 2)
    i = np.arange(t // 2, dtype=np.float64)[:, None, None]
    j = np.arange(h // 2, dtype=np.float64)[None, :, None]
    k = np.arange(w // 2, dtype=np.float64)[None, None, :]
    r = np.floor(np.sqrt(i**2 + j**2 + k**2)).astype(np.int32)
    r = np.where(r > K - 1, K, r)
    i_low = int(np.round(K / 3))
    i_high = int(np.round(K * 2 / 3))
    return r.reshape(-1), K, i_low, i_high


@functools.lru_cache(maxsize=64)
def _bins_on(t: int, h: int, w: int, device: torch.device) -> torch.Tensor:
    """``_radial_bins``' index as an int64 tensor on ``device``, cached."""
    return torch.from_numpy(_radial_bins(t, h, w)[0].astype(np.int64)).to(device)


def _bin_octant(power, bins, num_bins):
    """Sum power over radial bins. power: [b, t, h, w, c] (full spectrum);
    only the positive octant contributes. Returns [b, num_bins, c]."""
    b, t, h, w, c = power.shape
    oct_ = power[:, : t // 2, : h // 2, : w // 2, :].reshape(b, -1, c)
    out = oct_.new_zeros((b, num_bins + 1, c))
    out.index_add_(1, bins, oct_)
    return out[:, :num_bins]


def _metrics_chunk(pred, target, *, c: int):
    """All 13 metrics for one chunk, as a [13] tensor. pred/target:
    [b,t,h,w,>=c]; computed in float32."""
    pred = pred[..., :c].float()
    target = target[..., :c].float()
    b, t, h, w, _ = target.shape

    se = mse_loss(pred, target)
    rmse = torch.sqrt(torch.mean(se))
    mae = torch.mean(torch.abs(pred - target))

    diff = (pred - target).reshape(b, -1)
    err_l2 = torch.linalg.vector_norm(diff, dim=1)
    norm = torch.linalg.vector_norm(target.reshape(b, -1), dim=1)
    rel_l2_error = torch.mean(err_l2 / norm)

    r2 = 1.0 - torch.sum(se) / torch.sum(
        (target - target.mean(dim=0, keepdim=True)) ** 2
    )

    if c < 2:
        ke_error = pred.new_zeros(())
    else:
        ke_error = torch.mean(torch.abs(kinetic_energy(pred) - kinetic_energy(target)))

    # |F(p) - F(t)|² = |F(p - t)|²: one FFT of the difference
    _, K, i_low, i_high = _radial_bins(t, h, w)
    bins = _bins_on(t, h, w, pred.device)
    diff_F = torch.fft.fftn(pred - target, dim=(1, 2, 3))
    target_F = torch.fft.fftn(target, dim=(1, 2, 3))
    err_power = diff_F.real**2 + diff_F.imag**2
    err_binned = _bin_octant(err_power, bins, K)  # [b, K, c]
    err_F = torch.sqrt(torch.mean(err_binned, dim=0)) / (t * h * w)  # [K, c]

    low_f_error = err_F[:i_low].mean()
    mid_f_error = err_F[i_low:i_high].mean()
    high_f_error = err_F[i_high:].mean()
    f_error = err_F.mean()

    norm_power = target_F.real**2 + target_F.imag**2
    norm_binned = _bin_octant(norm_power, bins, K)
    norm_F = torch.sqrt(torch.mean(norm_binned, dim=0)) / (t * h * w)

    rel = err_F / norm_F
    rel_low_f_error = rel[:i_low].mean()
    rel_mid_f_error = rel[i_low:i_high].mean()
    rel_high_f_error = rel[i_high:].mean()

    # frequency error of the spatially summed signal (metrics.py:107-111)
    sum_diff = torch.sum(pred - target, dim=(2, 3, 4))
    diff_f = torch.fft.fft(sum_diff, dim=1)
    freq_error = torch.mean(torch.sqrt(diff_f.real**2 + diff_f.imag**2))

    return torch.stack(
        [
            rmse,
            mae,
            rel_l2_error,
            r2,
            ke_error,
            f_error,
            low_f_error,
            mid_f_error,
            high_f_error,
            rel_low_f_error,
            rel_mid_f_error,
            rel_high_f_error,
            freq_error,
        ]
    )


def eval_metrics(pred, target, c: int, batch_size: int | None = None):
    """13-tuple of scalar metrics, in the reference's order.

    The batch is processed in chunks of ``batch_size`` (default: the whole
    batch), each chunk gives 13 scalars, and the result is the unweighted
    mean over chunks (reference `metrics.py:24-131`). Runs on the device of
    ``pred`` (numpy arrays: the CPU).
    """
    pred = torch.as_tensor(pred)
    target = torch.as_tensor(target)
    n = pred.shape[0]
    with torch.no_grad():
        if batch_size is None or batch_size >= n:
            vals = _metrics_chunk(pred, target, c=c)
        else:
            vals = torch.stack([
                _metrics_chunk(pred[i : i + batch_size], target[i : i + batch_size], c=c)
                for i in range(0, n, batch_size)
            ]).mean(dim=0)
    return tuple(np.asarray(vals.cpu().numpy(), np.float32))


def eval_metrics_dict(pred, target, c: int, batch_size: int | None = None):
    vals = eval_metrics(pred, target, c, batch_size)
    return dict(zip(METRIC_NAMES, (float(v) for v in vals)))


def infer_unmeasured_channels(target) -> int:
    """Count the channels that are zero everywhere (unmeasured modalities;
    reference `train.py:352-357`, `eval.py:298-303`)."""
    target = torch.as_tensor(target)
    return int((target == 0).reshape(-1, target.shape[-1]).all(dim=0).sum())
