"""The (dp, mp) mesh: data parallelism over ``torch.distributed``.

Counterpart of ``realpdebench_tpu/core/mesh.py``. The JAX package lays a
logical mesh ``(dp, mp)`` over the devices of one program and lets GSPMD
insert the collectives. Here every rank of the data axis is a process of
its own, one per card, started by ``torchrun``
(``torchrun --nproc_per_node N -m realpdebench_tpu_torch train
--mesh_shape dp=N``), and the collectives are written out:

  * the parameters and buffers are broadcast from rank 0 once;
  * each rank loads its slice of every global batch (``data/loader.py``,
    ``process_shard``) and runs the step on it;
  * BatchNorm statistics are sums all-reduced over the global batch before
    the mean and variance (``global_sum``, differentiable: the statistics'
    gradients are reduced too), so a rank normalizes as one process on the
    whole batch would, which plain DDP does not;
  * dropout masks and WDNO's draws are drawn for the global batch from the
    model's generator, the same on every rank, and each rank keeps its
    rows (``draw_rows``);
  * the gradients are all-reduced into the global batch's gradient, so
    clipping and Adam see the same gradient on every rank.

The device count of ``parse_mesh_shape`` is the process group's world
size (1 without a group), not ``jax.device_count()``: a mesh spans the
processes. ``mesh_shape: null`` means dp = world size, as in JAX. The model
axis (``mp`` > 1: parameters, Adam moments and tokens sharded) is ROADMAP
item 9b and raises here.

Every collective is counted in ``COLLECTIVES``, the proof that a run went
through them. Nothing catches a failed collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "dp"
MODEL_AXIS = "mp"

# collectives run since the last reset_collectives()
COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def world_size() -> int:
    """Processes of the default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0 (or the only process): the one that writes checkpoints,
    logs and TensorBoard."""
    return rank() == 0


def parse_mesh_shape(spec: Optional[str], n_devices: Optional[int] = None) -> dict:
    """Parse ``'dp=4,mp=2'`` into an ordered dict of axis sizes.

    ``None``/empty → all processes on the data axis. A ``-1`` size is
    inferred from the device count (at most one ``-1``)."""
    if n_devices is None:
        n_devices = world_size()
    if not spec:
        return {DATA_AXIS: n_devices, MODEL_AXIS: 1}
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        axes[name.strip()] = int(size)
    unknown = [k for k, v in axes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError(f"At most one -1 axis allowed in mesh spec {spec!r}")
    if unknown:
        known = math.prod(v for v in axes.values() if v != -1)
        axes[unknown[0]] = n_devices // known
    total = math.prod(axes.values())
    if total > n_devices:
        raise ValueError(
            f"Mesh spec {spec!r} uses {total} devices but {n_devices} available"
        )
    axes.setdefault(DATA_AXIS, 1)
    axes.setdefault(MODEL_AXIS, 1)
    return axes


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """The mesh's axis sizes. ``distributed``: a process group is up, so
    the step runs its collectives (at dp 1 too, where they change no
    value)."""

    dp_size: int
    mp_size: int = 1
    distributed: bool = False

    def pad_batch(self, n: int) -> int:
        """Round a global batch size up to a multiple of dp."""
        dp = self.dp_size
        return ((n + dp - 1) // dp) * dp


def make_mesh_context(mesh_shape: Optional[str] = None) -> MeshContext:
    """The mesh over the process group's ranks (one process a card). Every
    process is a rank of the data axis: dp must equal the world size."""
    n = world_size()
    axes = parse_mesh_shape(mesh_shape, n)
    if axes[MODEL_AXIS] > 1 or any(k not in (DATA_AXIS, MODEL_AXIS) for k in axes):
        raise NotImplementedError(
            f"mesh_shape {mesh_shape!r}: the port shards only the data axis; the model "
            "axis (mp > 1: parameters, Adam moments and tokens sharded) is ROADMAP.md "
            "item 9b")
    if axes[DATA_AXIS] != n:
        raise ValueError(f"mesh_shape {mesh_shape!r}: dp={axes[DATA_AXIS]}, but the port "
                         f"runs one process a data rank and the world size is {n} "
                         "(start the ranks with torchrun --nproc_per_node dp)")
    return MeshContext(dp_size=axes[DATA_AXIS], mp_size=1,
                       distributed=dist.is_available() and dist.is_initialized())


def maybe_initialize_distributed(device: str | None = None):
    """Start the process group from torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` (and its ``MASTER_ADDR``/``MASTER_PORT``): ``nccl`` with
    this rank on ``cuda:{LOCAL_RANK}``, or ``gloo`` under ``--device cpu``.
    Returns the device this rank runs on, or ``device`` unchanged where
    those variables are absent (nothing is started). Catches no error."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return device
    r, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo", rank=r, world_size=n)
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", rank=r, world_size=n,
                            device_id=torch.device("cuda", local))
    return f"cuda:{local}"


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank; ``obj`` without a
    process group."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    COLLECTIVES["broadcast"] += 1
    return box[0]


def local_batch_slice(global_batch: int) -> slice:
    """The slice of the global batch this process is responsible for."""
    n_proc, idx = world_size(), rank()
    per = global_batch // n_proc
    return slice(idx * per, (idx + 1) * per)


def assemble_from_process_local(x, mesh_ctx: MeshContext | None = None):
    """The identity: the port's step works on this process's slice of the
    global batch, and the collectives inside it make the global result
    (the JAX package assembles a global array here)."""
    del mesh_ctx
    return x


def allgather_to_host(a: torch.Tensor) -> torch.Tensor:
    """Every rank's ``a`` (equal shapes) concatenated along dim 0 in rank
    order, on ``a``'s device; ``a`` itself without a process group."""
    if world_size() == 1:
        return a
    parts = [torch.empty_like(a) for _ in range(world_size())]
    dist.all_gather(parts, a.contiguous())
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts)


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    dist.all_reduce(t)
    COLLECTIVES["all_reduce"] += 1
    return t


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the gradients over the ranks,
    since every rank's loss depends on the sum."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone())


# ---------------------------------------------------------------- row shares


@dataclasses.dataclass(frozen=True)
class RowShare:
    """This rank's rows of the global (micro)batch a forward sees: rows
    ``start`` .. ``start + count`` of ``total``."""

    total: int
    start: int
    count: int


_SHARE: list = []   # the active share (the step sets it around each microbatch)


@contextlib.contextmanager
def row_share(share: RowShare):
    """Within the block, BatchNorm statistics and draws are those of the
    global batch that ``share`` describes (``global_sum``, ``draw_rows``)."""
    _SHARE.append(share)
    try:
        yield share
    finally:
        _SHARE.pop()


def current_share() -> RowShare | None:
    return _SHARE[-1] if _SHARE else None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a per-rank sum over local rows) summed over the ranks under a
    row share, differentiably; ``t`` itself outside one."""
    return t if current_share() is None else _GlobalSum.apply(t)


def global_rows(local: int) -> int:
    """Rows of the global batch under a row share (checked against the
    local ``local``); ``local`` outside one."""
    share = current_share()
    if share is None:
        return local
    if local != share.count:
        raise ValueError(f"a forward on {local} rows under a share of {share.count}")
    return share.total


def draw_rows(draw, shape):
    """``draw(shape)`` for a tensor whose dim 0 is the batch: under a row
    share the draw is made for the global batch (the same on every rank,
    from the same generator) and this rank keeps its rows."""
    share = current_share()
    if share is None:
        return draw(tuple(shape))
    full = draw((global_rows(shape[0]), *shape[1:]))
    return full[share.start:share.start + share.count]
