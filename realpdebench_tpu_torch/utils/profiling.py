"""Profiling hooks: a step timer and an optional trace of the loop.

Counterpart of ``realpdebench_tpu/utils/profiling.py``:

  * ``StepTimer`` times windows of ``window`` steps after ``warmup``, each
    ending in one call of ``sync`` (``torch.cuda.synchronize`` on the card),
    so the steps in a window queue on the device without a host stall;
  * ``maybe_trace`` records a window of the training loop with
    ``torch.profiler`` when the config sets ``profile_dir`` and writes it
    there as a Chrome trace (``trace.json``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Optional


class StepTimer:
    """Steps/s over windows of ``window`` ticks after ``warmup`` ticks. A
    window starts and ends with ``sync()``; ticks in between only count."""

    def __init__(self, warmup: int = 2, window: int = 10,
                 sync: Optional[Callable[[], None]] = None):
        self.warmup = warmup
        self.window = window
        self.sync = sync or (lambda: None)
        self.windows = []           # (steps, seconds)
        self._count = 0
        self._start = None

    def tick(self) -> None:
        self._count += 1
        n = self._count - self.warmup
        if n < 0 or (n % self.window and n):
            return
        self.sync()
        now = time.perf_counter()
        if self._start is not None:
            self.windows.append((self.window, now - self._start))
        self._start = now

    @property
    def steps_per_sec(self) -> Optional[float]:
        if not self.windows:
            return None
        return sum(n for n, _ in self.windows) / sum(s for _, s in self.windows)

    def summary(self) -> dict:
        if not self.windows:
            return {}
        import numpy as np

        ms = np.asarray([s / n for n, s in self.windows]) * 1e3
        rate = self.steps_per_sec
        return {
            "steps_per_sec": rate,
            "steps_per_sec_per_chip": rate,     # one device
            "step_ms_p50": float(np.percentile(ms, 50)),
            "step_ms_p95": float(np.percentile(ms, 95)),
            "windows": len(self.windows),
        }


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], enabled: bool = True):
    """Record the enclosed code with torch.profiler (host and, where there is
    one, the CUDA device) when ``profile_dir`` is set; yields the profiler or
    None."""
    if not (profile_dir and enabled):
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    logging.info(f"torch.profiler trace -> {profile_dir}")
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
