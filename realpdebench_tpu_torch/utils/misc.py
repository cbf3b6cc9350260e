"""Environment switches, seeding, logging and small host-side helpers.

Counterpart of ``realpdebench_tpu/utils/misc.py``. Parameters and dropout
draw from explicit ``torch.Generator``s (the JAX package threads PRNG keys
the same way); ``set_seed`` pins the host-side generators the data pipeline
uses (noise, masks, shuffles), as there.
"""

from __future__ import annotations

import logging
import os
import random as _py_random
import zlib

import numpy as np
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


def use_expandable_segments() -> None:
    """Let PyTorch's CUDA allocator grow its segments in place
    (``expandable_segments``) unless the caller set the allocator up
    otherwise: freed blocks then do not fragment the card. The f32
    Transolver step at its shipped batch 16 needs about 63 of an 80 GB
    card's 79 GiB and fails by fragmentation without it. Takes effect only
    before the process's first allocation on the card; the command line
    and ``chip_smoke.py`` call it first."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def set_f32_precision() -> None:
    """Full float32 in the library calls: no TF32 in cuBLAS's matmuls or in
    cuDNN's convolutions, and "highest" float32 matmul precision. The JAX
    package computes its float32 products in full float32; PyTorch's default
    puts cuDNN's convolutions on single-pass TF32 (about 10 mantissa bits).
    ``models.registry.build_model`` calls this for every model it builds;
    the bfloat16 paths are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def set_seed(seed: int) -> None:
    """Pin Python's, numpy's and torch's global generators."""
    np.random.seed(seed)
    _py_random.seed(seed)
    torch.manual_seed(seed)


def derive_seed(seed: int, *parts) -> int:
    """Mix string/int tags into a base seed with a process-stable digest
    (crc32; Python's ``hash`` of a string is salted per interpreter)."""
    tag = "\x1f".join(str(p) for p in parts).encode()
    return (seed + zlib.crc32(tag)) % 2**31


def setup_logging(exp_path: str, is_use_tb: bool = False, is_train: bool = True):
    """File and console logging, and a TensorBoard writer when asked for and
    ``torch.utils.tensorboard`` imports (otherwise a warning, no writer)."""
    log_filename = os.path.join(
        exp_path, "training.log" if is_train else "eval.log"
    )
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=[logging.FileHandler(log_filename), logging.StreamHandler()],
        force=True,
    )
    logging.info(f"Logging initialized at {log_filename}")

    writer = None
    if is_use_tb:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(log_dir=exp_path)
            logging.info(f"Tensorboard writer initialized at {writer.log_dir}")
        except Exception as e:  # tensorboard optional
            logging.warning(f"TensorBoard unavailable ({e}); continuing without")
    return writer


def cycle(iterable):
    """Infinite generator over a re-iterable."""
    while True:
        for x in iterable:
            yield x
