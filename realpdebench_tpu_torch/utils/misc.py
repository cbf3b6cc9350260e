"""Environment switches and seeding.

Counterpart of ``realpdebench_tpu/utils/misc.py``: only what the rollout
slice reads. Randomness in the port comes from explicit ``torch.Generator``s
(the JAX package threads PRNG keys the same way).
"""

from __future__ import annotations

import logging
import os

import torch


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env-var switch: "0/false/no/off/" opt out, "1/true/yes/on"
    opt in, anything else warns and keeps the default."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in ("0", "false", "no", "off", ""):
        return False
    if v in ("1", "true", "yes", "on"):
        return True
    logging.warning("env %s=%r not understood; keeping default %s",
                    name, raw, default)
    return default


def env_choice(name: str, choices, default):
    """String env-var switch restricted to ``choices`` (case- and
    whitespace-insensitive); an unknown value warns and keeps the default."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v in choices:
        return v
    logging.warning("env %s=%r not in %s; keeping default %r",
                    name, raw, sorted(choices), default)
    return default


def make_generator(seed: int) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded with ``seed``. Parameters are drawn on
    the CPU and then moved, so one seed gives the same weights on every
    device."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return g
