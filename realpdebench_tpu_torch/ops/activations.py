"""GELU with the JAX package's variant selection.

Counterpart of ``realpdebench_tpu/ops/activations.py``. There the variant is
``exact`` (erf) on CPU and GPU and ``tanh`` on a TPU; the port runs on CPU
and GPU, so it is ``exact`` unless ``REALPDEBENCH_GELU`` names a variant.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from realpdebench_tpu_torch.utils.misc import env_choice

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715


def gelu_variant() -> str:
    """'exact' or 'tanh'. Read on every call, so a changed env applies."""
    return env_choice("REALPDEBENCH_GELU", ("exact", "tanh"), "exact")


def _check(variant: str) -> None:
    if variant not in ("exact", "tanh"):
        raise ValueError(f"unknown GELU variant {variant!r}")


def gelu(x: torch.Tensor, variant: str | None = None) -> torch.Tensor:
    variant = variant or gelu_variant()
    _check(variant)
    return F.gelu(x, approximate="tanh" if variant == "tanh" else "none")


def gelu_grad(u: torch.Tensor, variant: str | None = None) -> torch.Tensor:
    """d GELU(u) / du, analytically (JAX ``_act_grad``,
    ``ops/pallas/fno_layer.py:80-93``): Φ(u) + u·φ(u) for 'exact', the
    derivative of the tanh polynomial form for 'tanh'."""
    variant = variant or gelu_variant()
    _check(variant)
    if variant == "tanh":
        t = torch.tanh(_SQRT_2_OVER_PI * (u + _GELU_C * u * u * u))
        dinner = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * u * u)
        return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * dinner
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    return 0.5 * (1.0 + torch.erf(u / math.sqrt(2.0))) + u * phi
