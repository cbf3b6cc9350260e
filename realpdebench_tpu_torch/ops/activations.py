"""GELU with the JAX package's variant selection.

Counterpart of ``realpdebench_tpu/ops/activations.py``. There the variant is
``exact`` (erf) on CPU and GPU and ``tanh`` on a TPU; the port runs on CPU
and GPU, so it is ``exact`` unless ``REALPDEBENCH_GELU`` names a variant.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from realpdebench_tpu_torch.utils.misc import env_choice


def gelu_variant() -> str:
    """'exact' or 'tanh'. Read on every call, so a changed env applies."""
    return env_choice("REALPDEBENCH_GELU", ("exact", "tanh"), "exact")


def gelu(x: torch.Tensor, variant: str | None = None) -> torch.Tensor:
    variant = variant or gelu_variant()
    if variant not in ("exact", "tanh"):
        raise ValueError(f"unknown GELU variant {variant!r}")
    return F.gelu(x, approximate="tanh" if variant == "tanh" else "none")
