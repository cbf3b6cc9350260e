"""Model parallelism over the mesh's ``mp`` axis.

Counterpart of ``realpdebench_tpu/core/partitioning.py``. The JAX package
places the parameters and Adam's moments sharded over ``mp`` and lets
GSPMD keep the result equal to one device's. Here each rank is a process
(``core/mesh.py``) and the collectives are written out over its mp group.

**The leaf rule** (``shard_dims``), JAX's on the port's own tensors: the
JAX leaf's last axis is sharded over mp where mp divides it, and every
other leaf is replicated.

  * spectral corner weights (JAX ``w_real``/``w_imag`` [4, m..., Cin,
    Cout]): the port's complex ``weights1..4`` [Cin, Cout, m...], dim 1;
  * Dense and Conv kernels (JAX ``kernel``, output features last): the
    port's ``nn.Linear`` and ``nn.Conv*d`` weights [out, in, ...], dim 0
    (``interop/from_jax`` moves the JAX leaf's last axis there, a
    ConvTranspose's too);
  * biases, norms, embeddings, scalars and the raw parameters: replicated.

**The state** (``shard_train_state``): Adam steps a slice of every sharded
parameter (its master slice) and keeps ``exp_avg``/``exp_avg_sq`` of that
slice only, 1/mp of the leaf; replicated parameters are stepped whole,
the same on every rank. The module keeps full working weights for the
forward and backward (a ZeRO-style layout): before each update the master
slices are read from the weights and the full gradient, after it they are
all-gathered over the mp group back into the weights. ``model_state`` (the
BatchNorm statistics) and the step count are replicated. A checkpoint
holds the moments gathered back: the file one process writes.

**Tokens** (``seq_shard``): ``split_tokens`` gives each rank its
contiguous slice of the token axis (its backward all-gathers the tokens'
gradients, so the layers before the split get the full gradient, as in
one process), ``gather_tokens`` the whole axis back (its backward keeps
this rank's slice), ``mp_sum`` sums a cross-token partial over the mp
group (and its gradient), ``halo`` brings the neighbours' boundary planes
for a convolution on the shards (its backward returns their gradient to
their owner). Between a split and its gather every parameter's gradient
is a per-shard partial (the gradient reaching the replicated parts through
``mp_sum`` is one too); the training step sums those over the mp group
(``Model.seq_parallel_parameters``) and no others. JAX's
``token_constraint`` does nothing without a mesh, at mp 1 or where mp does
not divide the tokens; ``token_share_for`` returns None there.
"""

from __future__ import annotations

import torch
from torch import nn

from realpdebench_tpu_torch.core import mesh as mesh_lib
from realpdebench_tpu_torch.core.mesh import MODEL_AXIS, MeshContext, TokenShare

SPECTRAL_WEIGHTS = ("weights1", "weights2", "weights3", "weights4")


def shard_dims(model: nn.Module, mp: int) -> dict:
    """{parameter name: the dim sharded over ``mp``} for every parameter
    JAX's ``param_shardings`` shards (the module's docstring); the others
    are replicated."""
    if mp <= 1:
        return {}
    dims = {}
    for prefix, m in model.named_modules():
        at = f"{prefix}." if prefix else ""
        if isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)) and m.weight.dim() >= 2:
            if m.weight.shape[0] % mp == 0:
                dims[f"{at}weight"] = 0
        for w in SPECTRAL_WEIGHTS:
            t = getattr(m, w, None)
            if isinstance(t, nn.Parameter) and t.dim() >= 3 and t.shape[1] % mp == 0:
                dims[f"{at}{w}"] = 1
    return dims


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _gather_dim(t: torch.Tensor, dim: int, mesh_ctx: MeshContext) -> torch.Tensor:
    """The mp group's slices of ``t`` (equal shapes) joined along ``dim``."""
    parts = mesh_lib.all_gather_(_real(t), mesh_ctx, MODEL_AXIS)
    full = torch.cat(parts, dim=dim)
    return torch.view_as_complex(full) if t.is_complex() else full


class ParamShards:
    """What Adam steps under mp: for each parameter, its master slice
    (``dims`` not None) or the parameter itself (``leaves``)."""

    def __init__(self, params, dims, mesh_ctx: MeshContext):
        self.params, self.dims, self.mesh = list(params), list(dims), mesh_ctx
        with torch.no_grad():
            self.leaves = [p if d is None else self.local(p.detach(), d).clone()
                           for p, d in zip(self.params, self.dims)]

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim``."""
        n = t.shape[dim] // self.mesh.mp_size
        return t.narrow(dim, self.mesh.mp_index * n, n)

    def sharded(self):
        return [(p, d, m) for p, d, m in zip(self.params, self.dims, self.leaves)
                if d is not None]

    def load(self) -> None:
        """Before an update: each master slice from its weight (a broadcast
        or a load may have moved it) and from its full gradient."""
        with torch.no_grad():
            for p, d, m in self.sharded():
                m.copy_(self.local(p, d))
                m.grad = None if p.grad is None else self.local(p.grad, d).clone()

    def gather(self) -> None:
        """After an update: the master slices all-gathered over the mp group
        into the weights, one collective a dtype."""
        by_dtype: dict = {}
        for p, d, m in self.sharded():
            by_dtype.setdefault(_real(m).dtype, []).append((p, d, _real(m)))
        with torch.no_grad():
            for items in by_dtype.values():
                flat = torch.cat([r.reshape(-1) for _, _, r in items])
                parts = mesh_lib.all_gather_(flat, self.mesh, MODEL_AXIS)
                at = 0
                for p, d, r in items:
                    n = r.numel()
                    _real(p.data).copy_(torch.cat(
                        [q[at:at + n].view(r.shape) for q in parts], dim=d))
                    at += n

    def full_state(self, sd: dict) -> dict:
        """An Adam ``state_dict`` over the leaves → the one over the full
        parameters (the moments gathered over the mp group): the dict one
        process's Adam gives. Every rank of the group must call it."""
        return self._moments(sd, lambda v, d: _gather_dim(v, d, self.mesh))

    def local_state(self, sd: dict) -> dict:
        """A full Adam ``state_dict`` → this rank's (each sharded moment's
        slice)."""
        return self._moments(sd, lambda v, d: self.local(v, d).clone())

    def _moments(self, sd: dict, fn) -> dict:
        """``sd`` with ``fn(moment, dim)`` for each moment of a sharded
        parameter."""
        def one(i, s):
            d = self.dims[i]
            return {k: fn(v, d) if d is not None and k in ("exp_avg", "exp_avg_sq") else v
                    for k, v in s.items()}
        return {"state": {i: one(i, s) for i, s in sd["state"].items()},
                "param_groups": sd["param_groups"]}


def shard_train_state(model: nn.Module, optimizer, mesh_ctx: MeshContext) -> None:
    """Shard ``optimizer``'s (a ``train.Optimizer`` over ``model``'s
    parameters) master slices and moments over the mp group by
    ``shard_dims``, keeping any state it holds; nothing at mp 1."""
    if mesh_ctx.mp_size <= 1:
        return
    by_id = {id(p): n for n, p in model.named_parameters()}
    dims = shard_dims(model, mesh_ctx.mp_size)
    optimizer.shard(ParamShards(optimizer.params,
                                [dims.get(by_id[id(p)]) for p in optimizer.params],
                                mesh_ctx))


# ------------------------------------------------------------------ tokens


def token_share_for(mesh_ctx: MeshContext | None, n: int, unit: int = 1):
    """This rank's share of ``n`` tokens over the mp group, in whole runs
    of ``unit`` tokens; None without a mesh, at mp 1, or where mp·unit
    does not divide ``n`` (JAX's ``token_constraint`` is then a no-op)."""
    if mesh_ctx is None or mesh_ctx.mp_size <= 1 or n % (mesh_ctx.mp_size * unit):
        return None
    per = n // mesh_ctx.mp_size
    return TokenShare(total=n, start=mesh_ctx.mp_index * per, count=per, mesh=mesh_ctx)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share: TokenShare, axis: int):
        ctx.share, ctx.axis = share, axis
        return x.narrow(axis, share.start, share.count).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        parts = mesh_lib.all_gather_(g, ctx.share.mesh, MODEL_AXIS)
        return torch.cat(parts, dim=ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share: TokenShare, axis: int):
        ctx.share, ctx.axis = share, axis
        return torch.cat(mesh_lib.all_gather_(x, share.mesh, MODEL_AXIS), dim=axis)

    @staticmethod
    def backward(ctx, g):
        s = ctx.share
        return g.narrow(ctx.axis, s.start, s.count).contiguous(), None, None


def split_tokens(x: torch.Tensor, share: TokenShare, axis: int = 1) -> torch.Tensor:
    """This rank's tokens of ``x`` (the whole axis on every rank)."""
    if x.shape[axis] != share.total:
        raise ValueError(f"split_tokens: {x.shape[axis]} tokens, the share's total is "
                         f"{share.total}")
    return _Split.apply(x, share, axis)


def gather_tokens(x: torch.Tensor, share: TokenShare, axis: int = 1) -> torch.Tensor:
    """The whole token axis from every rank's slice, in mp order."""
    if x.shape[axis] != share.count:
        raise ValueError(f"gather_tokens: {x.shape[axis]} tokens, the share's count is "
                         f"{share.count}")
    return _Gather.apply(x, share, axis)


def mp_sum(t: torch.Tensor, share: TokenShare) -> torch.Tensor:
    """A per-shard partial sum over tokens summed over the mp group
    (differentiable: the gradient is summed too)."""
    return mesh_lib.AxisSum.apply(t, share.mesh, MODEL_AXIS)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, share: TokenShare, dim: int, width: int):
        m = share.mesh
        ctx.share, ctx.dim, ctx.width = share, dim, width
        n = x.shape[dim]
        edges = torch.cat([x.narrow(dim, 0, width), x.narrow(dim, n - width, width)], dim)
        parts = mesh_lib.all_gather_(edges, m, MODEL_AXIS)
        r = m.mp_index
        zeros = torch.zeros_like(x.narrow(dim, 0, width))
        lo = parts[r - 1].narrow(dim, width, width) if r > 0 else zeros
        hi = parts[r + 1].narrow(dim, 0, width) if r < m.mp_size - 1 else zeros
        return torch.cat([lo, x, hi], dim)

    @staticmethod
    def backward(ctx, g):
        m, dim, w = ctx.share.mesh, ctx.dim, ctx.width
        n = g.shape[dim] - 2 * w
        inner = g.narrow(dim, w, n).clone()
        # the halos' gradients, sent back to the ranks that own those planes
        sent = torch.cat([g.narrow(dim, 0, w), g.narrow(dim, n + w, w)], dim)
        parts = mesh_lib.all_gather_(sent, m, MODEL_AXIS)
        r = m.mp_index
        if r > 0:                 # rank r-1's upper halo is my first planes
            inner.narrow(dim, 0, w).add_(parts[r - 1].narrow(dim, w, w))
        if r < m.mp_size - 1:     # rank r+1's lower halo is my last planes
            inner.narrow(dim, n - w, w).add_(parts[r + 1].narrow(dim, 0, w))
        return inner, None, None, None


def halo(x: torch.Tensor, share: TokenShare, dim: int, width: int) -> torch.Tensor:
    """``x`` (this rank's planes along ``dim``, the mp group's slices in
    order) with ``width`` planes of each neighbour before and after it,
    zeros past the ends: a 'same' convolution of half-width ``width`` on it
    without padding along ``dim`` gives this rank's output planes of the
    convolution of the whole. The halos' gradients go back to their
    owners, so no contribution is counted twice."""
    if x.shape[dim] < width:
        raise ValueError(f"halo: {x.shape[dim]} planes a rank, a halo of {width}")
    return _Halo.apply(x, share, dim, width)
