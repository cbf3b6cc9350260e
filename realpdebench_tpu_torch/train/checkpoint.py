"""Checkpoints in the reference's ``.pth`` layout, with full resume.

Counterpart of ``realpdebench_tpu/train/checkpoint.py``. The JAX package
writes orbax directories; the port writes what the reference writes and
what the JAX exporter writes (``interop/torch_export.save_torch_checkpoint``):
one ``torch.save`` dict a step, ``{"model_state_dict", "iteration", ...}``,
the state dict under the exporter's key names. Beside those it keeps what
the JAX manager keeps: the optimizer's state and update count, and the
metadata ``best_iteration``, ``best_val_loss`` and ``val_losses``. So a
reference or exported ``.pth`` loads into the port, and a port checkpoint
loads into the reference's ``Model.load_checkpoint``.

Files are ``{directory}/checkpoint_{step}.pth``. ``save`` copies the state
to the host and writes it in a background thread (orbax's async save);
the next ``save``, ``wait`` and ``close`` wait for the write before.
Under model parallelism the optimizer's moments are gathered over the mp
group before the save (``train.Optimizer.state_dict``), so the file is the
one one process writes, and a restore keeps each rank's slices.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Optional

import torch

_NAME = re.compile(r"checkpoint_(\d+)\.pth$")


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}.pth")

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, optimizer=None, metadata: Optional[dict] = None):
        """Snapshot ``model`` (and ``optimizer``: a ``train.Optimizer``, or
        the ``(state_dict(), count)`` of one taken beforehand, as every rank
        of a sharded optimizer's mp group must) at ``step`` to the host now;
        write it in the background."""
        self.wait()
        ckpt = {"model_state_dict": _to_host(model.state_dict())}
        if optimizer is not None:
            state, count = (optimizer if isinstance(optimizer, tuple)
                            else (optimizer.state_dict(), optimizer.count))
            ckpt["optimizer_state_dict"] = _to_host(state)
            ckpt["optimizer_count"] = count
        ckpt.update(metadata or {})
        ckpt["iteration"] = step
        self._writer = threading.Thread(target=self._write, args=(step, ckpt))
        self._writer.start()

    def _write(self, step: int, ckpt: dict) -> None:
        try:
            tmp = self.path(step) + ".tmp"
            torch.save(ckpt, tmp)
            os.replace(tmp, self.path(step))
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self.path(old))
        except Exception as e:  # raised by the next wait()
            self._error = e

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def load(self, step: Optional[int] = None) -> dict:
        """The checkpoint dict of ``step`` (default: the latest)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint under {self.directory}")
        return torch.load(self.path(step), map_location="cpu", weights_only=False)

    def restore(self, model, optimizer=None, step: Optional[int] = None,
                load_opt_state: bool = True):
        """Load ``step`` (default: the latest) into ``model`` (strict) and,
        with ``load_opt_state``, ``optimizer`` (a sharded one keeps this
        rank's slices); returns (step, metadata)."""
        ckpt = self.load(step)
        model.load_state_dict(ckpt["model_state_dict"], strict=True)
        if load_opt_state and optimizer is not None:
            optimizer.load_state_dict(ckpt["optimizer_state_dict"])
            optimizer.count = int(ckpt["optimizer_count"])
        return int(ckpt["iteration"]), _metadata(ckpt)

    def load_metadata(self, step: int):
        try:
            return _metadata(self.load(step))
        except FileNotFoundError:
            return None

    def close(self) -> None:
        self.wait()


def _metadata(ckpt: dict) -> dict:
    return {k: v for k, v in ckpt.items()
            if k not in ("model_state_dict", "optimizer_state_dict", "optimizer_count")}
