"""CNO3d — the Convolutional Neural Operator.

Counterpart of ``realpdebench_tpu/models/cno.py`` (the reference's
``model/cno.py``): a lift block, an encoder of ``N_layers`` CNOBlocks
(a k3 'same' Conv3d, BatchNorm and the activation), ``N_res``
ResidualBlocks at each level and ``N_res_neck`` at the bottleneck, the
ED-expansion blocks that align the skips, the optional decoder_inv blocks,
the decoder, and a project block; with ``out_dim_mult`` > 1 the output's
channels are reshaped into time as the reference does (``cno.py:519-520``).

Activation modes:
  * ``LeakyReLU`` — LeakyReLU(0.2), what every shipped config runs; the
    network then keeps its resolution everywhere;
  * ``lrelu`` — the filtered leaky ReLU of ``ops/filtered_lrelu.py`` with a
    learnable bias a channel; the blocks resample H and W by their sizes.

Layout: channels-first, [B, C, T, H, W], as cuDNN's Conv3d takes it.

Precision: ``compute_dtype`` (float32 or bfloat16) is the dtype of the
activations and the convolutions; parameters stay float32 and are cast at
use, as flax's ``dtype=`` does. The BatchNorms take float32 statistics
(``models/base.batch_norm``). A float64 copy (``.double()`` and
``compute_dtype = torch.float64``) computes everything in float64.

Memory: ``remat`` (on by default, as the JAX registry has it) runs every
block through ``torch.utils.checkpoint`` while autograd records, as JAX
wraps them in ``nn.remat``. A BatchNorm moves its running statistics inside
the forward, and the checkpoint runs the forward a second time in the
backward; flax keeps only the first forward's update, so the recompute here
normalises with the batch statistics and leaves the running ones alone
(``_Remat``).

Parameters carry the names the JAX exporter writes
(``realpdebench_tpu/interop/torch_export.py::export_cno``):
``lift``/``project`` (``inter_CNOBlock.convolution``, ``convolution``),
``encoder.i``, ``decoder.i``, ``decoder_inv.i``, ``ED_expansion.i``
(``convolution``, ``batch_norm``), ``res_nets.j`` (``convolution1/2``,
``batch_norm1/2``): the level blocks first (``res_nets.{l·N_res + j}``),
then the neck by name; the neck runs in reverse order, its last block
first (``cno.py:490-491``). The ``lrelu`` mode's bias, which the exporter
does not write, is ``<block>.activation.bias`` (the reference LReLu
module's name), so ``load_state_dict(strict=True)`` takes an exported
checkpoint as it is in the shipped mode.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from realpdebench_tpu_torch.models.base import Model, batch_norm, lecun_normal_, mse, stats_dtype
from realpdebench_tpu_torch.ops.filtered_lrelu import filtered_lrelu_3d


def _filter_props(size: int, cutoff_den: float, half_width_mult: float):
    cutoff = size / cutoff_den
    return cutoff, half_width_mult * size - size / cutoff_den


class _Opts:
    """What every block of one forward reads: the compute dtype, train mode,
    and whether the BatchNorms move their running statistics."""

    def __init__(self, dt, training: bool, update_stats: bool):
        self.dt, self.training, self.update_stats = dt, training, update_stats


def _conv(m: nn.Conv3d, x, dt):
    """flax Conv with ``dtype=dt`` and 'SAME' padding."""
    return F.conv3d(x.to(dt), m.weight.to(dt), m.bias.to(dt), padding=m.kernel_size[0] // 2)


def _bn(m: nn.BatchNorm3d, x, o: _Opts):
    return batch_norm(m, x, o.training, o.dt, channel_dim=1, update_stats=o.update_stats)


class CNOActivation(nn.Module):
    """LeakyReLU(0.2), or the filtered leaky ReLU with a learnable bias a
    channel (``filtered_networks.py:356``)."""

    def __init__(self, activation: str, channels: int, in_size: int, out_size: int,
                 cutoff_den: float, half_width_mult: float, filter_size: int,
                 lrelu_upsampling: int):
        super().__init__()
        if activation not in ("LeakyReLU", "lrelu"):
            raise ValueError(f"Activation function {activation} not supported")
        self.activation = activation
        in_c, in_h = _filter_props(in_size, cutoff_den, half_width_mult)
        out_c, out_h = _filter_props(out_size, cutoff_den, half_width_mult)
        self.geometry = dict(in_size=in_size, out_size=out_size, in_cutoff=in_c,
                             out_cutoff=out_c, in_half_width=in_h, out_half_width=out_h,
                             filter_size=filter_size, lrelu_upsampling=lrelu_upsampling)
        if activation == "lrelu":
            self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if self.activation == "LeakyReLU":
            return F.leaky_relu(x, 0.2)
        return filtered_lrelu_3d(x, bias=self.bias.to(x.dtype), **self.geometry)


class CNOBlock3d(nn.Module):
    """Conv3d k3 'same' → BatchNorm (optional) → activation."""

    def __init__(self, c_in: int, c_out: int, in_size: int, out_size: int, bn: bool, cfg: dict):
        super().__init__()
        k = cfg["conv_kernel"]
        self.convolution = nn.Conv3d(c_in, c_out, k, padding=k // 2)
        self.batch_norm = nn.BatchNorm3d(c_out, eps=1e-5) if bn else None
        self.activation = CNOActivation(cfg["activation"], c_out, in_size, out_size,
                                        cfg["cutoff_den"], cfg["half_width_mult"],
                                        cfg["filter_size"], cfg["lrelu_upsampling"])

    def forward(self, x, o: _Opts):
        x = _conv(self.convolution, x, o.dt)
        if self.batch_norm is not None:
            x = _bn(self.batch_norm, x, o)
        return self.activation(x)


class LiftProjectBlock3d(nn.Module):
    """A CNOBlock to ``latent_dim`` channels without BatchNorm, then a k3
    Conv3d to ``c_out`` (the reference passes ``batch_norm=False`` for both
    of CNO's lift and project blocks)."""

    def __init__(self, c_in: int, c_out: int, in_size: int, out_size: int, latent_dim: int,
                 cfg: dict):
        super().__init__()
        self.inter_CNOBlock = CNOBlock3d(c_in, latent_dim, in_size, out_size, False, cfg)
        k = cfg["conv_kernel"]
        self.convolution = nn.Conv3d(latent_dim, c_out, k, padding=k // 2)

    def forward(self, x, o: _Opts):
        return _conv(self.convolution, self.inter_CNOBlock(x, o), o.dt)


class ResidualBlock3d(nn.Module):
    """x + BN(Conv(act(BN(Conv(x)))))."""

    def __init__(self, channels: int, size: int, bn: bool, cfg: dict):
        super().__init__()
        k = cfg["conv_kernel"]
        self.convolution1 = nn.Conv3d(channels, channels, k, padding=k // 2)
        self.convolution2 = nn.Conv3d(channels, channels, k, padding=k // 2)
        self.batch_norm1 = nn.BatchNorm3d(channels, eps=1e-5) if bn else None
        self.batch_norm2 = nn.BatchNorm3d(channels, eps=1e-5) if bn else None
        self.activation = CNOActivation(cfg["activation"], channels, size, size,
                                        cfg["cutoff_den"], cfg["half_width_mult"],
                                        cfg["filter_size"], cfg["lrelu_upsampling"])

    def forward(self, x, o: _Opts):
        out = _conv(self.convolution1, x, o.dt)
        if self.batch_norm1 is not None:
            out = _bn(self.batch_norm1, out, o)
        out = _conv(self.convolution2, self.activation(out), o.dt)
        if self.batch_norm2 is not None:
            out = _bn(self.batch_norm2, out, o)
        return x + out.to(x.dtype)


class _Remat:
    """A block through a non-reentrant checkpoint: its first run moves the
    BatchNorms' running statistics, the backward's recompute does not (flax
    ``nn.remat`` keeps the primal forward's update only). No RNG state is
    kept: the blocks draw none."""

    def __init__(self, block: nn.Module, o: _Opts):
        self.block, self.o, self.runs = block, o, 0

    def _run(self, *xs):
        first = self.runs == 0
        self.runs += 1
        o = self.o if first else _Opts(self.o.dt, self.o.training, False)
        return self.block(*xs, o)

    def __call__(self, *xs):
        return checkpoint(self._run, *xs, use_reentrant=False, preserve_rng_state=False)


class CNO3d(Model):
    """CNO3d on windows [B, T_in, H, W, C_in] → [B, T_out, H, W, C_out].

    ``generator`` draws the initial weights (on the CPU, then moved to
    ``device``) from the JAX init's distributions: lecun-normal kernels,
    zero biases, unit BatchNorm scales and running variances; None uses
    PyTorch's global generator.
    """

    def __init__(self, in_dim: int, in_size: int, N_layers: int, shape_in: Sequence[int],
                 shape_out: Sequence[int], N_res: int = 1, N_res_neck: int = 6,
                 channel_multiplier: int = 32, conv_kernel: int = 3,
                 cutoff_den: float = 2.0001, filter_size: int = 6, lrelu_upsampling: int = 2,
                 half_width_mult: float = 0.8, batch_norm: bool = True, out_dim: int = 1,
                 out_dim_mult: int = 1, out_size: int = 1, latent_lift_proj_dim: int = 64,
                 add_inv: bool = True, activation: str = "LeakyReLU", remat: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.shape_in, self.shape_out = tuple(shape_in), tuple(shape_out)
        self.N_layers, self.N_res, self.N_res_neck = N_layers, N_res, N_res_neck
        self.out_dim, self.out_dim_mult, self.add_inv = out_dim, out_dim_mult, add_inv
        self.remat, self.compute_dtype = remat, compute_dtype
        cfg = dict(conv_kernel=conv_kernel, cutoff_den=cutoff_den, filter_size=filter_size,
                   lrelu_upsampling=lrelu_upsampling, half_width_mult=half_width_mult,
                   activation=activation)

        lift_dim = channel_multiplier // 2
        enc = [lift_dim] + [2 ** i * channel_multiplier for i in range(N_layers)]
        dec_in = list(reversed(enc[1:]))
        dec_out = list(reversed(enc[:-1]))
        for i in range(1, N_layers):
            dec_in[i] = 2 * dec_in[i]       # the skip concatenated
        latent_out = in_size if out_size == 1 else out_size
        enc_s = [in_size // 2 ** i for i in range(N_layers + 1)]
        dec_s = [latent_out // 2 ** (N_layers - i) for i in range(N_layers + 1)]
        bn = batch_norm

        self.lift = LiftProjectBlock3d(in_dim, enc[0], in_size, enc_s[0],
                                       latent_lift_proj_dim, cfg)
        self.encoder = nn.ModuleList(
            CNOBlock3d(enc[i], enc[i + 1], enc_s[i], enc_s[i + 1], bn, cfg)
            for i in range(N_layers))
        # ED_expansion.i aligns level i: its input width enc[i]; the
        # bottleneck's (i = N_layers) feeds the decoder directly
        self.ED_expansion = nn.ModuleList(
            CNOBlock3d(enc[i], enc[i], enc_s[i], dec_s[N_layers - i], bn, cfg)
            for i in range(N_layers + 1))
        if add_inv:
            self.decoder_inv = nn.ModuleList(
                CNOBlock3d(dec_in[i], dec_in[i], dec_s[i], dec_s[i], bn, cfg)
                for i in range(N_layers))
        self.decoder = nn.ModuleList(
            CNOBlock3d(dec_in[i], dec_out[i], dec_s[i], dec_s[i + 1], bn, cfg)
            for i in range(N_layers))
        self.res_nets = nn.ModuleList(
            [ResidualBlock3d(enc[l], enc_s[l], bn, cfg)
             for l in range(N_layers) for _ in range(N_res)]
            + [ResidualBlock3d(enc[N_layers], enc_s[N_layers], bn, cfg)
               for _ in range(N_res_neck)])
        self.project = LiftProjectBlock3d(
            enc[0] + dec_out[-1], out_dim * out_dim_mult, dec_s[-1], latent_out,
            latent_lift_proj_dim, cfg)
        self.reset_parameters(generator)
        self.to(device)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv3d):
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()
            elif isinstance(m, CNOActivation) and m.activation == "lrelu":
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """x [B, T_in, H, W, C_in] → [B, T_out, H, W, C_out] float32 (float64
        for a float64 copy), or, given the target y, the scalar MSE.
        ``reference`` is accepted for the callers that hold a kernel path
        against the plain one; this family runs no kernel of its own."""
        o = _Opts(self.compute_dtype, self.training, True)
        if self.remat and torch.is_grad_enabled():
            run = lambda block, *xs: _Remat(block, o)(*xs)
        else:
            run = lambda block, *xs: block(*xs, o)
        L = self.N_layers
        h = run(self.lift, x.permute(0, 4, 1, 2, 3))        # [B, C, T, H, W]
        skip = []
        for i in range(L):
            s = h
            for j in range(self.N_res):
                s = run(self.res_nets[i * self.N_res + j], s)
            skip.append(s)
            h = run(self.encoder[i], h)
        # the neck in reverse construction order (cno.py:490-491)
        base = L * self.N_res
        for j in range(self.N_res_neck):
            h = run(self.res_nets[base + self.N_res_neck - 1 - j], h)
        for i in range(L):
            if i == 0:
                h = run(self.ED_expansion[L], h)
            else:
                h = torch.cat([h, run(self.ED_expansion[L - i], skip[-i])], dim=1)
            if self.add_inv:
                h = run(self.decoder_inv[i], h)
            h = run(self.decoder[i], h)
        h = torch.cat([h, run(self.ED_expansion[0], skip[0])], dim=1)
        h = run(self.project, h)

        out = h.permute(0, 2, 3, 4, 1).to(stats_dtype(self.compute_dtype))
        if self.out_dim_mult > 1:
            # cno.py:519-520: (T, H, W, C·M) flattened into (T·M, H, W, C)
            B = out.shape[0]
            out = out.reshape(B, -1, out.shape[2], out.shape[3], self.out_dim)
        return out if y is None else mse(out, y.to(out.dtype))
