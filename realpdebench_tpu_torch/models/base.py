"""The model contract.

Counterpart of ``realpdebench_tpu/models/base.py``. A model maps
``[B, T_in, H, W, C_in] → [B, T_out, H, W, C_out]``. In JAX a stateless
module plus a variables pytree is wrapped in a ``ModelBundle``; here the
``nn.Module`` owns its parameters and buffers, so the bundle's ``predict``
and ``loss`` are methods of the module itself.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax lecun_normal: a normal truncated at 2 std, rescaled to keep variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> None:
    """flax's default kernel init, in place: variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


class Model(nn.Module):
    """Base of every ported model: ``forward(x)`` is the prediction and
    ``forward(x, y)`` the scalar MSE training loss against the target ``y``
    (so a model can fuse its tail with the loss, as FNO3d does)."""

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

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Elementwise MSE of the prediction against ``y``, computed inside
        the module (JAX ``models/registry.py:52-60``)."""
        return self(x, y=y)
