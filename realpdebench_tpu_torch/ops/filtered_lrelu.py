"""Anti-aliased (filtered) leaky ReLU with Kaiser up/down-sampling: the
StyleGAN3 op family behind CNO's ``lrelu`` activation mode.

Counterpart of ``realpdebench_tpu/ops/filtered_lrelu.py``. Per 2-D slice:

    bias → upsample (zero-stuff ×up, FIR, gain up²) → leaky ReLU (slope
    0.2), gain √2 → downsample (FIR, stride ×down)

Layout: channels-first, ``[N, C, H, W]`` for the 2-D ops and
``[B, C, T, H, W]`` for ``filtered_lrelu_3d`` (as the port's CNO runs its
convolutions); the JAX ops take channels-last. Each separable FIR pass is
one depthwise ``conv2d`` (cuDNN on the card): the zero-stuffing is explicit
(each sample followed by ``up − 1`` zeros, the reference's length in·up),
the padding is ``F.pad`` (a negative pad crops) and the stride is the
downsampling. The filter is flipped unless ``flip_filter``, since the
convolution is a correlation, as in JAX. The padding order is
``(px0, px1, py0, py1)``: x-pads on W, y-pads on H.

``design_lowpass_filter`` runs ``scipy.signal.firwin`` on the host (scipy
is on the card's host too); filters and geometries are cached.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float):
    """Separable Kaiser low-pass as a float32 numpy array; None is the
    identity filter (numtaps 1)."""
    assert numtaps >= 1
    if numtaps == 1:
        return None
    import scipy.signal

    f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
    return np.asarray(f, np.float32)


def _depthwise_pass(x, f, dim: int, up: int, down: int, pad) -> torch.Tensor:
    """One separable FIR pass over ``dim`` (2: H, 3: W) of [N, C, H, W]:
    zero-stuff ×up, pad (a negative pad crops), correlate with ``f``,
    stride ×down."""
    N, C = x.shape[:2]
    if up > 1:
        # each sample followed by up − 1 zeros, on a new axis after dim
        z = x.unsqueeze(dim + 1)
        z = F.pad(z, (0, 0, 0, up - 1) if dim == 2 else (0, up - 1))
        shape = list(x.shape)
        shape[dim] *= up
        x = z.reshape(shape)
    p0, p1 = pad
    x = F.pad(x, (0, 0, p0, p1) if dim == 2 else (p0, p1))
    taps = f.shape[0]
    w = f.view(1, 1, taps, 1) if dim == 2 else f.view(1, 1, 1, taps)
    stride = (down, 1) if dim == 2 else (1, down)
    return F.conv2d(x, w.expand(C, 1, *w.shape[2:]).contiguous(), stride=stride, groups=C)


def upfirdn2d(x, f, up: int = 1, down: int = 1, padding=(0, 0, 0, 0), gain: float = 1.0,
              flip_filter: bool = False) -> torch.Tensor:
    """x [N, C, H, W]; f a 1-D separable FIR (numpy, None: identity),
    applied along H then W. padding = (px0, px1, py0, py1)."""
    px0, px1, py0, py1 = padding
    if f is None:
        f = np.ones(1, np.float32)
    f = np.asarray(f, np.float32) * (float(gain) ** 0.5)
    if not flip_filter:
        f = f[::-1].copy()
    ft = torch.from_numpy(np.ascontiguousarray(f)).to(device=x.device, dtype=x.dtype)
    y = _depthwise_pass(x, ft, 2, up, down, (py0, py1))
    return _depthwise_pass(y, ft, 3, up, down, (px0, px1))


def filtered_lrelu_2d(x, fu, fd, bias, up: int, down: int, padding,
                      gain: float = float(np.sqrt(2)), slope: float = 0.2) -> torch.Tensor:
    """The reference's ``_filtered_lrelu_ref`` on x [N, C, H, W];
    ``bias`` [C] or None. padding = (px0, px1, py0, py1)."""
    if bias is not None:
        x = x + bias.view(1, -1, 1, 1)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = torch.where(x >= 0, x, x * slope) * gain
    return upfirdn2d(x, fd, down=down)


@lru_cache(maxsize=128)
def lrelu_geometry(in_size: int, out_size: int, in_cutoff: float, out_cutoff: float,
                   in_half_width: float, out_half_width: float, filter_size: int = 6,
                   lrelu_upsampling: int = 2):
    """(up, down, fu, fd, padding) of the LReLu layer: the sampling rates
    are the sizes, as in CNO."""
    in_rate, out_rate = in_size, out_size
    tmp_rate = max(in_rate, out_rate) * lrelu_upsampling

    up = int(np.rint(tmp_rate / in_rate))
    up_taps = filter_size * up if up > 1 else 1
    fu = design_lowpass_filter(up_taps, in_cutoff, in_half_width * 2, tmp_rate)

    down = int(np.rint(tmp_rate / out_rate))
    down_taps = filter_size * down if down > 1 else 1
    fd = design_lowpass_filter(down_taps, out_cutoff, out_half_width * 2, tmp_rate)

    pad_total = (out_size - 1) * down + 1
    pad_total -= in_size * up
    pad_total += up_taps + down_taps - 2
    pad_lo = (pad_total + up) // 2
    pad_hi = pad_total - pad_lo
    padding = (int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi))
    return up, down, fu, fd, padding


def filtered_lrelu_3d(x, *, in_size, out_size, in_cutoff, out_cutoff, in_half_width,
                      out_half_width, filter_size=6, lrelu_upsampling=2,
                      bias=None) -> torch.Tensor:
    """x [B, C, T, H, W] → [B, C, T, H', W']: the 2-D filtered leaky ReLU on
    every frame with the LReLu geometry (H and W resampled, T untouched)."""
    up, down, fu, fd, padding = lrelu_geometry(
        int(in_size), int(out_size), float(in_cutoff), float(out_cutoff),
        float(in_half_width), float(out_half_width), int(filter_size),
        int(lrelu_upsampling))
    B, C, T, H, W = x.shape
    flat = x.transpose(1, 2).reshape(B * T, C, H, W)
    out = filtered_lrelu_2d(flat, fu, fd, bias, up, down, padding)
    return out.reshape(B, T, C, *out.shape[2:]).transpose(1, 2)
