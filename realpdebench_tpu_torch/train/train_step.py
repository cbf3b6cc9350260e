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

import contextlib
import math
from typing import Callable

import torch

from realpdebench_tpu_torch.core import mesh as mesh_lib


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

    Under model parallelism (``core.partitioning.shard_train_state``,
    ``shard``) Adam steps this rank's master slices of the sharded
    parameters and keeps their moments only; the clip still sees the full
    gradients, and the slices are all-gathered into the weights after the
    update. ``state_dict`` is then the one process's (the moments gathered:
    every rank of the mp group must call it) and ``load_state_dict`` keeps
    this rank's slices.
    """

    def __init__(self, params, schedule: Callable[[int], float],
                 clip_grad_norm: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip = float(clip_grad_norm or 0.0)
        self.count = 0
        self.shards = None
        self.adam = self._adam(self.params)

    def _adam(self, leaves):
        return torch.optim.Adam(leaves, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)

    def shard(self, shards) -> None:
        """Step ``shards`` (a ``core.partitioning.ParamShards`` over
        ``self.params``) from now on, keeping the state held so far."""
        full = self.state_dict()
        self.shards = shards
        self.adam = self._adam(shards.leaves)
        self.load_state_dict(full)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """Adam's ``state_dict`` over the full parameters."""
        sd = self.adam.state_dict()
        return sd if self.shards is None else self.shards.full_state(sd)

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd if self.shards is None else self.shards.local_state(sd))

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
        if self.shards is not None:
            self.shards.load()
        self.adam.step()
        if self.shards is not None:
            self.shards.gather()
        self.count += 1


def build_optimizer(cfg, params) -> Optimizer:
    """Adam (torch defaults) under ``build_schedule(cfg)``, with the
    gradients' global norm clipped to ``clip_grad_norm`` when it is > 0."""
    return Optimizer(params, build_schedule(cfg),
                     cfg.get("clip_grad_norm", 0.0))


def _microbatches(b: int, k: int, mesh):
    """(rows of the local batch, row share) of each of the ``k``
    microbatches of a local batch of ``b`` rows. Without a mesh, ``k``
    consecutive chunks. With one, microbatch i is the global batch's rows
    {r·k + i}, as the JAX step composes them under a mesh
    (``train_step.py:129-157``): this data rank's rows whose global index
    is ≡ i (mod k), which are consecutive rows of the global microbatch. A
    row share (None without a process group) tells the forward where they
    lie in it."""
    if mesh is None:
        n = b // k
        return [(slice(i * n, (i + 1) * n), None) for i in range(k)]
    world = mesh.dp_size if mesh.distributed else 1
    total, offset = b * world, b * (mesh.dp_index if mesh.distributed else 0)
    if total % k:
        raise ValueError(f"global batch {total} not divisible by grad_accum {k}")
    out = []
    for i in range(k):
        first = (i - offset) % k
        count = len(range(first, b, k))
        if count == 0:
            raise ValueError(f"a rank's {b} rows hold no row of microbatch {i} of {k}: "
                             "raise the batch or lower grad_accum")
        share = (mesh_lib.RowShare(total // k, (offset + first) // k, count, mesh)
                 if mesh.distributed else None)
        out.append((slice(first, b, k), share))
    return out


def _all_reduce_grads(params, mesh, axis: str) -> None:
    """Every gradient summed over the mesh's ``axis`` group, in one
    all-reduce a dtype (complex gradients as their real and imaginary
    parts)."""
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: dict = {}
    for g in grads:
        r = torch.view_as_real(g) if g.is_complex() else g
        by_dtype.setdefault(r.dtype, []).append((g, r))
    for pairs in by_dtype.values():
        flat = torch.cat([r.reshape(-1) for _, r in pairs])
        mesh_lib.all_reduce_(flat, mesh, axis)
        at = 0
        for _, r in pairs:
            r.copy_(flat[at:at + r.numel()].view_as(r))
            at += r.numel()


def broadcast_state(model) -> None:
    """The parameters and buffers of rank 0 on every rank (complex
    parameters as their real and imaginary parts)."""
    with torch.no_grad():
        for t in (*model.parameters(), *model.buffers()):
            mesh_lib.broadcast_(torch.view_as_real(t.data) if t.is_complex() else t.data)


def make_train_step(model, normalizer, optimizer: Optimizer,
                    grad_accum: int = 1, mesh=None):
    """Build ``step(x, y) -> loss``: normalize, forward and backward in
    train mode through ``model.loss``, one optimizer update.

    ``grad_accum`` > 1 splits the batch into that many microbatches,
    averages their gradients and losses, and makes one update. The
    BatchNorm statistics are then those of each microbatch, and the running
    statistics move once per microbatch, as in the JAX step
    (``train_step.py:92-100``: ghost-batch normalization). Without
    ``mesh`` the microbatches are consecutive chunks (the JAX step without a
    mesh context); with a ``core.mesh.MeshContext`` they are strided, as the
    JAX loops' step composes them (``_microbatches``). The loops always pass
    their mesh. Each microbatch draws its dropout masks (and WDNO its t and
    noise) in turn, from the model's generator.

    With a process group (``mesh.distributed``) ``x`` and ``y`` are this
    data rank's slice of the global batch: the parameters and buffers are
    broadcast from rank 0 once, here; each microbatch runs under a row share
    (BatchNorm statistics all-reduced over the dp group's global
    microbatch, draws made for it), its loss weighted by this rank's share
    of its rows; the gradients are all-reduced over the dp group into the
    global batch's before the clip and Adam, and the returned loss is the
    global batch's. Under model parallelism (``mesh.mp_size`` > 1) the
    gradients of ``model.seq_parallel_parameters()`` (used between a token
    split and its gather: per-shard partials) are first summed over the mp
    group, and no others; the optimizer, if ``shard_train_state`` sharded
    it, steps this rank's slices.
    """

    k = max(int(grad_accum), 1)
    distributed = mesh is not None and mesh.distributed
    if distributed:
        broadcast_state(model)
    region = (model.seq_parallel_parameters()
              if distributed and mesh.mp_size > 1 else [])

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if mesh is None and x.shape[0] % k:
            raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum {k}")
        model.train()
        xn, yn = normalizer.preprocess(x, y)
        optimizer.zero_grad()
        losses = []
        for rows, share in _microbatches(xn.shape[0], k, mesh):
            with mesh_lib.row_share(share) if share else contextlib.nullcontext():
                loss = model.loss(xn[rows].contiguous(), yn[rows].contiguous())
                if share and share.count != share.total:
                    loss = loss * (share.count / share.total)
                loss.backward()
            losses.append(loss.detach())
        if region:
            _all_reduce_grads(region, mesh, mesh_lib.MODEL_AXIS)
        if distributed:
            _all_reduce_grads(optimizer.params, mesh, mesh_lib.DATA_AXIS)
        if k > 1:
            for p in optimizer.params:
                if p.grad is not None:
                    p.grad.div_(k)
        optimizer.step()
        loss = sum(losses) / k
        return mesh_lib.all_reduce_(loss, mesh, mesh_lib.DATA_AXIS) if distributed else loss

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
