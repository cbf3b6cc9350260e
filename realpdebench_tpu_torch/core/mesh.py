"""The (dp, mp) mesh over ``torch.distributed``: data and model parallelism.

Counterpart of ``realpdebench_tpu/core/mesh.py``. The JAX package lays a
logical mesh ``(dp, mp)`` over the devices of one program and lets GSPMD
insert the collectives. Here every rank is a process of its own, one per
card, started by ``torchrun`` (``torchrun --nproc_per_node N -m
realpdebench_tpu_torch train --mesh_shape dp=D,mp=M`` with D·M = N), and
the collectives are written out. Rank r sits where the JAX mesh puts
device r: under ``dp=D,mp=M`` it is data index ``r // M`` and model index
``r % M`` (JAX's device id ``dp·M + mp``). Every rank builds the dp groups
(the ranks of one model index) and the mp groups (the ranks of one data
index) with ``dist.new_group``, in the same order.

Over the data axis (the dp group):

  * the parameters and buffers are broadcast from rank 0 once (over the
    whole world: every rank holds full working weights);
  * each data rank loads its slice of every global batch (``data/loader.py``,
    ``process_shard`` with ``dp_size`` and ``dp_index``) and runs the step
    on it; the ranks of one mp group load the same slice;
  * BatchNorm statistics are sums all-reduced over the global batch before
    the mean and variance (``global_sum``, differentiable: the statistics'
    gradients are reduced too), so a rank normalizes as one process on the
    whole batch would, which plain DDP does not;
  * dropout masks and WDNO's draws are drawn for the global batch from the
    model's generator, the same on every rank, and each rank keeps its
    rows (``draw_rows``);
  * the gradients are all-reduced into the global batch's gradient, so
    clipping and Adam see the same gradient on every rank.

Over the model axis (the mp group; ``core/partitioning.py``): Adam's
master slices and moments of the sharded parameters, gathered back into
full weights after each update, and under ``seq_shard`` the token shards
of the GK and Transolver (``token_share``; their per-token dropout masks
drawn for the global token count, each rank keeping its tokens).

The device count of ``parse_mesh_shape`` is the process group's world
size (1 without a group), not ``jax.device_count()``: a mesh spans the
processes. ``mesh_shape: null`` means dp = world size, as in JAX.

Every collective is counted in ``COLLECTIVES`` under its group's axis
(``dp``, ``mp``, or ``world`` for the broadcasts from rank 0), the proof
that a run went through them. Nothing catches a failed collective.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "dp"
MODEL_AXIS = "mp"
WORLD = "world"

# collectives run since the last reset_collectives(), by axis
COLLECTIVES = {axis: {"all_reduce": 0, "broadcast": 0, "all_gather": 0}
               for axis in (DATA_AXIS, MODEL_AXIS, WORLD)}


def reset_collectives() -> None:
    for ops in COLLECTIVES.values():
        for k in ops:
            ops[k] = 0


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


@dataclasses.dataclass(frozen=True, eq=False)
class MeshContext:
    """The mesh's axis sizes, this rank's place on them and its two groups.
    ``distributed``: a process group is up, so the step runs its dp
    collectives (at dp 1 too, where they change no value). A group of None
    is the default (world) group: the dp group when mp is 1, the mp group
    when dp is 1."""

    dp_size: int
    mp_size: int = 1
    distributed: bool = False
    dp_index: int = 0
    mp_index: int = 0
    dp_group: Any = None
    mp_group: Any = None

    def pad_batch(self, n: int) -> int:
        """Round a global batch size up to a multiple of dp."""
        dp = self.dp_size
        return ((n + dp - 1) // dp) * dp

    def group(self, axis: str):
        return {DATA_AXIS: self.dp_group, MODEL_AXIS: self.mp_group}[axis]

    def size(self, axis: str) -> int:
        return {DATA_AXIS: self.dp_size, MODEL_AXIS: self.mp_size}[axis]

    def index(self, axis: str) -> int:
        return {DATA_AXIS: self.dp_index, MODEL_AXIS: self.mp_index}[axis]


def rank_layout(axes: dict) -> list:
    """Each rank's (dp index, mp index): rank r sits where the JAX mesh puts
    device r, its devices reshaped to the axes in the spec's order; for
    ``dp=D,mp=M`` rank r is at (r // M, r % M)."""
    out = []
    for r in range(math.prod(axes.values())):
        at, rest = {}, r
        for name in reversed(axes):          # the last axis varies fastest
            rest, at[name] = divmod(rest, axes[name])
        out.append((at[DATA_AXIS], at[MODEL_AXIS]))
    return out


def _axis_groups(axes: dict, layout: list):
    """(this rank's dp group, its mp group), every group of both axes made
    on every rank in one order (the ranks of a group ascending, which is
    their order on the axis); None where an axis spans the world, and for
    the mp axis at mp 1 (never used). At dp 1 each rank is a dp group of
    its own."""
    me = layout[rank()]
    mine = {DATA_AXIS: None, MODEL_AXIS: None}
    for axis, at, other in ((DATA_AXIS, 0, 1), (MODEL_AXIS, 1, 0)):
        other_size = axes[MODEL_AXIS if axis == DATA_AXIS else DATA_AXIS]
        if other_size == 1 or (axis == MODEL_AXIS and axes[axis] == 1):
            continue
        for k in range(other_size):       # the ranks of index k on the other axis
            g = dist.new_group([r for r, c in enumerate(layout) if c[other] == k])
            if me[other] == k:
                mine[axis] = g
    return mine[DATA_AXIS], mine[MODEL_AXIS]


def make_mesh_context(mesh_shape: Optional[str] = None) -> MeshContext:
    """The mesh over the process group's ranks (one process a card): dp·mp
    must equal the world size, and only the dp and mp axes are known. Rank
    r sits where JAX puts device r (``rank_layout``); under a process group
    every rank must call this, in the same order (it makes the groups)."""
    n = world_size()
    axes = parse_mesh_shape(mesh_shape, n)
    foreign = [k for k in axes if k not in (DATA_AXIS, MODEL_AXIS)]
    if foreign:
        raise ValueError(f"mesh_shape {mesh_shape!r}: unknown axes {foreign}; the mesh "
                         f"has the axes {DATA_AXIS!r} and {MODEL_AXIS!r}")
    dp, mp = axes[DATA_AXIS], axes[MODEL_AXIS]
    if dp * mp != n:
        raise ValueError(f"mesh_shape {mesh_shape!r}: dp·mp = {dp}·{mp}, but the port "
                         f"runs one process a card and the world size is {n} (start "
                         "the ranks with torchrun --nproc_per_node dp·mp)")
    distributed = dist.is_available() and dist.is_initialized()
    layout = rank_layout(axes)
    dp_group, mp_group = _axis_groups(axes, layout) if distributed else (None, None)
    dp_index, mp_index = layout[rank()]
    return MeshContext(dp_size=dp, mp_size=mp, distributed=distributed, dp_index=dp_index,
                       mp_index=mp_index, dp_group=dp_group, mp_group=mp_group)


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
    COLLECTIVES[WORLD]["broadcast"] += 1
    return box[0]


def broadcast_(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, in place (over the world)."""
    dist.broadcast(t, src=0)
    COLLECTIVES[WORLD]["broadcast"] += 1
    return t


def local_batch_slice(global_batch: int, mesh_ctx: MeshContext | None = None) -> slice:
    """The slice of the global batch this process is responsible for: its
    data index's slice under a mesh (the ranks of one mp group share it),
    its rank's among the world's without one."""
    if mesh_ctx is None:
        n_proc, idx = world_size(), rank()
    else:
        n_proc, idx = mesh_ctx.dp_size, mesh_ctx.dp_index
    per = global_batch // n_proc
    return slice(idx * per, (idx + 1) * per)


def assemble_from_process_local(x, mesh_ctx: MeshContext | None = None):
    """The identity: the port's step works on this process's slice of the
    global batch, and the collectives inside it make the global result
    (the JAX package assembles a global array here)."""
    del mesh_ctx
    return x


def all_gather_(t: torch.Tensor, mesh_ctx: MeshContext, axis: str) -> list:
    """Every rank's ``t`` (equal shapes) over ``axis``'s group, in the
    order of the ranks' index on that axis."""
    parts = [torch.empty_like(t) for _ in range(mesh_ctx.size(axis))]
    dist.all_gather(parts, t.contiguous(), group=mesh_ctx.group(axis))
    COLLECTIVES[axis]["all_gather"] += 1
    return parts


def allgather_to_host(a: torch.Tensor, mesh_ctx: MeshContext | None = None) -> torch.Tensor:
    """Every data rank's ``a`` (equal shapes) concatenated along dim 0 in
    rank order, on ``a``'s device: over the mesh's dp group (the ranks of
    one mp group hold the same rows), or over the world without a mesh;
    ``a`` itself where there is one rank to gather."""
    if mesh_ctx is None:       # every rank of the world a data rank
        mesh_ctx = MeshContext(dp_size=world_size(), distributed=world_size() > 1,
                               dp_index=rank())
    if not mesh_ctx.distributed or mesh_ctx.dp_size == 1:
        return a
    return torch.cat(all_gather_(a, mesh_ctx, DATA_AXIS))


def all_reduce_(t: torch.Tensor, mesh_ctx: MeshContext | None = None,
                axis: str = DATA_AXIS) -> torch.Tensor:
    """``t`` summed over ``axis``'s group of the mesh (over the world,
    counted under ``world``, without a mesh), in place."""
    if mesh_ctx is None:
        dist.all_reduce(t)
        COLLECTIVES[WORLD]["all_reduce"] += 1
        return t
    dist.all_reduce(t, group=mesh_ctx.group(axis))
    COLLECTIVES[axis]["all_reduce"] += 1
    return t


class AxisSum(torch.autograd.Function):
    """Sum over an axis's group; its backward sums the gradients over the
    same group, since every rank's loss depends on the sum."""

    @staticmethod
    def forward(ctx, t, mesh_ctx, axis):
        ctx.mesh_ctx, ctx.axis = mesh_ctx, axis
        return all_reduce_(t.clone(), mesh_ctx, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.mesh_ctx, ctx.axis), None, None


# ---------------------------------------------------------------- row shares


@dataclasses.dataclass(frozen=True)
class RowShare:
    """This rank's rows of the global (micro)batch a forward sees: rows
    ``start`` .. ``start + count`` of ``total``, summed over ``mesh``'s
    dp group."""

    total: int
    start: int
    count: int
    mesh: Optional[MeshContext] = None


@dataclasses.dataclass(frozen=True)
class TokenShare:
    """This rank's tokens of the global token axis inside a token-sharded
    region: tokens ``start`` .. ``start + count`` of ``total``, summed over
    ``mesh``'s mp group."""

    total: int
    start: int
    count: int
    mesh: MeshContext


_SHARE: list = []   # the active row share (the step sets it around each microbatch)
_TOKENS: list = []  # the active token share (a model sets it around its sharded region)


@contextlib.contextmanager
def row_share(share: RowShare):
    """Within the block, BatchNorm statistics and draws are those of the
    global batch that ``share`` describes (``global_sum``, ``draw_rows``)."""
    _SHARE.append(share)
    try:
        yield share
    finally:
        _SHARE.pop()


@contextlib.contextmanager
def token_share(share: TokenShare | None):
    """Within the block, dropouts with a token axis draw for the global
    token count and keep this rank's tokens (``models/base.dropout``), and
    the cross-token sums are summed over the mp group; None: no token
    share."""
    if share is None:
        yield None
        return
    _TOKENS.append(share)
    try:
        yield share
    finally:
        _TOKENS.pop()


def current_share() -> RowShare | None:
    return _SHARE[-1] if _SHARE else None


def current_token_share() -> TokenShare | None:
    return _TOKENS[-1] if _TOKENS else None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a per-rank sum over local rows) summed over the dp group under
    a row share, differentiably; ``t`` itself outside one."""
    share = current_share()
    return t if share is None else AxisSum.apply(t, share.mesh, DATA_AXIS)


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
