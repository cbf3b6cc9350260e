"""The training step, optimizer and learning-rate schedule.

Counterpart of ``realpdebench_tpu/train/train_step.py``: Adam with
b1 0.9, b2 0.999, eps 1e-8, an optional global-norm clip of the gradients,
and a cosine or step schedule, as optax builds them there. The normalizer
runs inside the step. ``cfg`` is any object with ``get(key, default)``
(a dict, or the JAX package's ``Config``) holding that package's keys:
``lr``, ``scheduler``, ``num_update``, ``step_size``, ``clip_grad_norm``.

The model owns its parameters and the optimizer its moments, so where JAX
threads a ``TrainState`` through a pure step, here ``step(x, y)`` updates
the model and the optimizer in place and returns the loss. The gradients
of the last step stay in ``p.grad`` until the next step.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def build_schedule(cfg) -> Callable[[int], float]:
    """Learning rate of update ``count`` (0 for the first update):
    'cosine' decays lr to 0 over ``num_update`` updates (optax
    ``cosine_decay_schedule``); 'step' halves it every ``step_size``
    updates (optax ``exponential_decay``, staircase)."""
    name = cfg.get("scheduler", "cosine")
    lr = float(cfg.get("lr"))
    if name == "cosine":
        n = int(cfg.get("num_update"))
        return lambda count: lr * 0.5 * (1.0 + math.cos(math.pi * min(count, n) / n))
    if name == "step":
        k = int(cfg.get("step_size"))
        return lambda count: lr * 0.5 ** (count // k)
    raise ValueError(f"Scheduler {name} not supported")


class Optimizer:
    """Adam under a schedule, with an optional global-norm clip.

    The learning rate of each update is ``schedule(count)`` with the count
    of updates made before it, set before ``torch.optim.Adam`` steps, as
    optax evaluates its schedule (``CosineAnnealingLR`` would step it after
    the update instead). Complex parameters count as their real and
    imaginary parts, as JAX's separate ``w_real``/``w_imag`` do.
    """

    def __init__(self, params, schedule: Callable[[int], float],
                 clip_grad_norm: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip = float(clip_grad_norm or 0.0)
        self.count = 0
        self.adam = torch.optim.Adam(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.clip > 0 and grads:
            # optax clip_by_global_norm: g * clip / norm where norm > clip
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm > self.clip, self.clip / norm,
                                torch.ones_like(norm))
            for g in grads:
                g.mul_(scale)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1


def build_optimizer(cfg, params) -> Optimizer:
    """Adam (torch defaults) under ``build_schedule(cfg)``, with the
    gradients' global norm clipped to ``clip_grad_norm`` when it is > 0."""
    return Optimizer(params, build_schedule(cfg),
                     cfg.get("clip_grad_norm", 0.0))


def make_train_step(model, normalizer, optimizer: Optimizer,
                    grad_accum: int = 1):
    """Build ``step(x, y) -> loss``: normalize, forward and backward in
    train mode through ``model.loss``, one optimizer update.

    ``grad_accum`` > 1 splits the batch into that many consecutive
    microbatches, averages their gradients and losses, and makes one
    update. The BatchNorm statistics are then those of each microbatch,
    and the running statistics move once per microbatch, as in the JAX
    step (``train_step.py:92-100``: ghost-batch normalization).
    """

    k = max(int(grad_accum), 1)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum {k}")
        model.train()
        xn, yn = normalizer.preprocess(x, y)
        optimizer.zero_grad()
        losses = []
        for xm, ym in zip(xn.chunk(k), yn.chunk(k)):
            loss = model.loss(xm, ym)
            loss.backward()
            losses.append(loss.detach())
        if k > 1:
            for p in optimizer.params:
                if p.grad is not None:
                    p.grad.div_(k)
        optimizer.step()
        return sum(losses) / k

    return step


def make_eval_step(model, normalizer, c: int | None = None):
    """Build ``step(x, y) -> (normalized_mse, pred_phys, target_phys)``: the
    normalized MSE on the first ``c`` channels (all when None) and the
    physical-unit prediction and target, in eval mode without autograd
    (JAX ``train_step.py:197-219``)."""

    def step(x: torch.Tensor, y: torch.Tensor):
        with torch.no_grad():
            xn, yn = normalizer.preprocess(x, y)
            pred = model.predict(xn)
            cc = c if c is not None else y.shape[-1]
            nmse = torch.mean((pred[..., :cc] - yn[..., :cc]) ** 2)
            _, pred_phys = normalizer.postprocess(xn, pred)
            _, target_phys = normalizer.postprocess(xn, yn)
        return nmse, pred_phys, target_phys

    return step
