"""The model contract.

Counterpart of ``realpdebench_tpu/models/base.py``. A model maps
``[B, T_in, H, W, C_in] → [B, T_out, H, W, C_out]``. In JAX a stateless
module plus a variables pytree is wrapped in a ``ModelBundle``; here the
``nn.Module`` owns its parameters and buffers, so the bundle's ``predict``
and ``loss`` are methods of the module itself.

The flax layers the families share, with flax's semantics: ``linear`` (a
Dense with its parameters cast to the compute dtype), ``layer_norm`` and
``batch_norm`` (statistics in at least float32, the variance as
E[x²] − E[x]², BatchNorm's running statistics moved by 0.1·(batch −
running); a BatchNorm module's own forward is never called), and
``dropout``. Every dropout of every model draws its keep mask through
``dropout_mask``, from the model's own generator (``Model.reseed_dropout``,
``Model.dropout_generator``), in the JAX call order; the global RNG is
never used. Where the compute dtype is float64 (a reference copy of an f32
model on the card), "at least float32" is float64.

Under data parallelism (``core/mesh.py``: a row share, set by the training
step around each microbatch) ``batch_norm``'s statistics are sums
all-reduced over the dp group's global batch, and ``dropout_mask`` draws
the global batch's mask and keeps this rank's rows; under token sharding
(a token share) ``dropout`` draws for the global token count and keeps
this rank's tokens; so every rank computes what one process on the whole
batch would.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from realpdebench_tpu_torch.core import mesh

# flax lecun_normal: a normal truncated at 2 std, rescaled to keep variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax's default kernel init, in place: variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


BN_MOMENTUM = 0.9    # flax's: running ← 0.9·running + 0.1·batch


def stats_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype of statistics and softmaxes at compute dtype ``dt``: at
    least float32 (float64 for a float64 reference copy)."""
    return torch.promote_types(dt, torch.float32)


def linear(m: nn.Linear, x, dt):
    """flax Dense with ``dtype=dt``: input and parameters cast to ``dt``."""
    return F.linear(x.to(dt), m.weight.to(dt),
                    None if m.bias is None else m.bias.to(dt))


class _LayerNorm(torch.autograd.Function):
    """flax's LayerNorm over the last axis as one autograd node: the
    forward is the elementwise chain below, the backward the analytic
    gradient, and only x, mean and rstd are kept between them (the chain
    under autograd keeps four tensors of x's size: xf·xf, xf − mean, the
    rstd product and the affine's input)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, dt):
        xf = x.to(stats_dtype(dt))
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
        rstd = torch.rsqrt(var.clamp_min(0.0) + eps)
        ctx.save_for_backward(x, mean, rstd, weight, var >= 0)
        return ((xf - mean) * rstd * weight + bias).to(dt)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, weight, var_kept = ctx.saved_tensors
        g = g.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean) * rstd
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dxhat = g * weight
            # the variance's path is cut where the clamp took a negative one
            proj = (dxhat * xhat).mean(dim=-1, keepdim=True) * var_kept
            dx = (rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True) - xhat * proj)).to(x.dtype)
        lead = tuple(range(g.dim() - 1))
        if ctx.needs_input_grad[1]:
            dw = (g * xhat).sum(dim=lead).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=lead).to(weight.dtype)
        return dx, dw, db, None, None


def layer_norm(m: nn.LayerNorm, x, dt):
    """flax LayerNorm: float32 statistics, variance as E[x²] − E[x]²,
    output in ``dt``; one autograd node that keeps x, mean and rstd."""
    return _LayerNorm.apply(x, m.weight, m.bias, m.eps, dt)


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x, training: bool, dt,
               channel_dim: int = -1, update_stats: bool = True):
    """flax BatchNorm over every axis of x but ``channel_dim``: float32
    statistics (the biased variance, as E[x²] − E[x]²); in training the
    running statistics move by 0.1·(batch − running), unless
    ``update_stats`` is false (a rematerialised block's recompute)."""
    xf = x.to(stats_dtype(dt))
    cd = channel_dim % x.dim()
    shape = [1] * x.dim()
    shape[cd] = -1
    if training:
        dims = tuple(d for d in range(x.dim()) if d != cd)
        if mesh.current_share() is None:
            mean = xf.mean(dim=dims)
            var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0.0)
        else:   # the global batch's: sums all-reduced over the ranks
            n = xf.numel() // xf.shape[cd] // xf.shape[0] * mesh.global_rows(xf.shape[0])
            sums = mesh.global_sum(torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]))
            mean = sums[0] / n
            var = (sums[1] / n - mean * mean).clamp_min(0.0)
        if update_stats:
            with torch.no_grad():
                for run, new in ((bn.running_mean, mean), (bn.running_var, var)):
                    run.mul_(BN_MOMENTUM).add_(new, alpha=1 - BN_MOMENTUM)
    else:
        mean, var = bn.running_mean, bn.running_var
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return ((xf - mean.view(shape)) * scale.view(shape) + bn.bias.view(shape)).to(dt)


def dropout_mask(shape, p: float, generator: torch.Generator) -> torch.Tensor:
    """Bool keep mask of ``shape`` (dim 0 the batch), True with probability
    1 − p, drawn from ``generator`` on its device (under a row share, the
    global batch's mask, this rank's rows). Every dropout of every model
    draws here."""
    return mesh.draw_rows(
        lambda sh: torch.rand(sh, generator=generator, device=generator.device) >= p, shape)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator,
            token_axis: int | None = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: x / (1 − p) where kept, else 0; no
    draw at p 0. ``token_axis`` names x's token axis: under a token share
    (``core.mesh.token_share``, model parallelism) the mask is drawn for the
    global token count and this rank keeps its tokens, so every rank draws
    what one process would; a tensor without it (replicated over the mp
    group) draws the same mask on every rank."""
    if p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    tokens = mesh.current_token_share() if token_axis is not None else None
    if tokens is not None:
        if shape[token_axis] != tokens.count:
            raise ValueError(f"a dropout over {shape[token_axis]} tokens under a share "
                             f"of {tokens.count}")
        shape[token_axis] = tokens.total
    keep = dropout_mask(tuple(shape), p, generator)
    if tokens is not None:
        keep = keep.narrow(token_axis, tokens.start, tokens.count)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class Model(nn.Module):
    """Base of every ported model: ``forward(x)`` is the prediction and
    ``forward(x, y)`` the scalar MSE training loss against the target ``y``
    (so a model can fuse its tail with the loss, as FNO3d does).
    ``trainable`` is false for a training-free model (DMD), which the
    training loop refuses and eval runs without a checkpoint."""

    trainable = True

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic forward in eval mode, without autograd; the
        module's train/eval mode is restored afterwards."""
        was_training = self.training
        self.train(False)
        try:
            with torch.inference_mode():
                return self(x)
        finally:
            self.train(was_training)

    def reseed_dropout(self, seed: int) -> None:
        """Restart the dropout stream: the next forward draws the masks a
        fresh model built with this dropout seed would."""
        self.dropout_seed, self._dropout_generator = int(seed), None

    def dropout_generator(self, device: torch.device) -> torch.Generator:
        """The dropout stream's generator on ``device``, seeded by
        ``dropout_seed`` at its first draw."""
        g = getattr(self, "_dropout_generator", None)
        if g is None:
            g = torch.Generator(device=device)
            g.manual_seed(self.dropout_seed)
            self._dropout_generator = g
        elif g.device != device:
            raise ValueError(f"the dropout stream lives on {g.device}, the input on "
                             f"{device}; call reseed_dropout after moving the model")
        return g

    def seq_parallel_parameters(self) -> list:
        """The parameters used between a token split and its gather
        (``core/partitioning.py``), whose gradients are per-shard partials
        under ``seq_shard``; none for a model that does not shard tokens."""
        return []

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Elementwise MSE of the prediction against ``y``, computed inside
        the module (JAX ``models/registry.py:52-60``)."""
        return self(x, y=y)
