"""Transolver — physics attention on a structured 3-D mesh.

Counterpart of ``realpdebench_tpu/models/transolver.py`` (the reference's
``TRANSOLVER_libs/Transolver_Structured_Mesh_3D.py`` and
``Physics_Attention.py``): the window's (T, H, W) points are N tokens,
lifted by an MLP (n_hidden·2, GELU, n_hidden) plus a learned placeholder,
then ``n_layers`` pre-LN blocks of physics attention and an MLP
(n_hidden·mlp_ratio, GELU, n_hidden), the last block ending in a LayerNorm
and the Dense ``mlp2`` to ``out_dim``. Physics attention: two k3 'same'
Conv3d projections of the tokens' grid view, a per-head soft assignment of
the N tokens to ``slice_num`` slice tokens (a softmax of a Dense over the
slice axis, divided by a learned temperature clamped to [0.1, 5]), softmax
attention among the slice tokens with q, k, v Denses shared by the heads,
then the slice tokens spread back over the N tokens and a Dense.

The grid view is the JAX package's: ``x.reshape(B, H, W, D, C)`` of the
[B, T·H·W, C] tokens with the config's ``H``, ``W``, ``D`` (cylinder: 128,
64, 20 for 20×64×128 windows), a reshape and not a transpose, so the
convolutions see the points in that order, as the reference's benchmark
wrapper does. The port keeps it: another view would compute another
function. The convolutions run channels-first on that view,
``(B, C, H, W, D)``; the permute is a view in cuDNN's channels-last layout.

Precision: ``compute_dtype`` (float32 or bfloat16) is the dtype of the
activations, the convolutions and the Denses; parameters stay float32 and
are cast at use. The slice softmax and the slice-token attention's softmax
run in float32, the slice weights' sum over N is a float32 sum, the
LayerNorms take float32 statistics, and ``mlp2`` has no dtype in JAX: it
computes in float32 (flax promotes to its float32 parameters) and the
output is float32. A float64 copy (``.double()`` and ``compute_dtype =
torch.float64``) computes everything in float64: the reference the card
holds this kernel-free family against.

Sequence parallelism (``seq_mesh``, a ``core.mesh.MeshContext`` with mp > 1;
``seq_shard`` in the loops): the tokens are split over the mp group in
whole H planes of the grid view (mp must divide H) and gathered at the
output. The k3 projections take one halo plane from each neighbour
(``core.partitioning.halo``: each output is computed once, by its owner,
and the halo's gradient goes back to it); ``slice_norm`` and
``slice_token`` are partial sums over the rank's tokens summed over the
group; the G-token attention is replicated; ``out_x``, ``to_out``, the
MLPs and the LayerNorms are per token.

``dropout`` (on the slice attention and after ``to_out``, in train mode)
draws through ``models/base.dropout_mask``; ``build_model`` passes none, as
the JAX registry does, so the shipped models run without it.
``unified_pos`` replaces the input by the distances of each grid point to
a ``ref``³ reference grid. ``space_dim`` and ``fun_dim`` are accepted and
unused, as in JAX: the lift takes the window's channels.

Initialisation follows flax's: the Denses ``trunc_init`` (a normal of std
0.02 truncated at ±2 std, without flax's lecun variance correction) with
zero biases, the convolutions lecun-normal with zero biases, unit
LayerNorms, the temperature 0.5 and the placeholder (1/n_hidden)·U[0, 1).

Parameters carry the names the JAX exporter writes
(``realpdebench_tpu/interop/torch_export.py::export_transolver``):
``placeholder``, ``preprocess.linear_pre.0``, ``preprocess.linear_post``,
``blocks.i.{ln_1, ln_2, ln_3, mlp2}``, ``blocks.i.Attn.{temperature,
in_project_fx, in_project_x, in_project_slice, to_q, to_k, to_v,
to_out.0}``, ``blocks.i.mlp.{linear_pre.0, linear_post}``, so
``load_state_dict(strict=True)`` takes an exported checkpoint as it is.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from realpdebench_tpu_torch.core import mesh as mesh_lib
from realpdebench_tpu_torch.core import partitioning
from realpdebench_tpu_torch.models.base import (
    Model,
    dropout,
    layer_norm,
    lecun_normal_,
    linear,
    mse,
    stats_dtype,
)
from realpdebench_tpu_torch.ops.activations import gelu

TRUNC_STD = 0.02


def trunc_init_(w: torch.Tensor, generator=None) -> None:
    """flax ``truncated_normal(stddev=0.02, lower=-2, upper=2)``: no
    variance correction."""
    nn.init.trunc_normal_(w, std=TRUNC_STD, a=-2 * TRUNC_STD, b=2 * TRUNC_STD,
                          generator=generator)


class TransolverMLP(nn.Module):
    """linear_pre (GELU) → linear_post: the reference MLP with no hidden
    layers, the only form the model builds."""

    def __init__(self, n_input: int, n_hidden: int, n_output: int):
        super().__init__()
        self.linear_pre = nn.Sequential(nn.Linear(n_input, n_hidden))
        self.linear_post = nn.Linear(n_hidden, n_output)

    def forward(self, x, dt):
        return linear(self.linear_post, gelu(linear(self.linear_pre[0], x, dt)), dt)


class PhysicsAttention3d(nn.Module):
    """Physics attention on tokens [B, N, dim] with N = H·W·D."""

    def __init__(self, dim: int, heads: int, dim_head: int, slice_num: int,
                 H: int, W: int, D: int, dropout: float = 0.0, kernel: int = 3):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.grid = heads, dim_head, (H, W, D)
        self.dropout, self.kernel = float(dropout), kernel
        self.temperature = nn.Parameter(0.5 * torch.ones(1, heads, 1, 1))
        self.in_project_fx = nn.Conv3d(dim, inner, kernel, padding="same")
        self.in_project_x = nn.Conv3d(dim, inner, kernel, padding="same")
        self.in_project_slice = nn.Linear(dim_head, slice_num)
        self.to_q = nn.Linear(dim_head, dim_head, bias=False)
        self.to_k = nn.Linear(dim_head, dim_head, bias=False)
        self.to_v = nn.Linear(dim_head, dim_head, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x, dt, drop):
        B, N, C = x.shape
        h, dh = self.heads, self.dim_head
        H, W, D = self.grid
        # the grid view: a reshape of the token axis (not a transpose), then
        # channels-first for the convolutions. On a token shard (whole H
        # planes) the convolutions take the neighbours' halo planes and no
        # padding along H, so each output plane is computed once, by its owner
        tokens = mesh_lib.current_token_share()
        xg = x.to(dt).reshape(B, N // (W * D), W, D, C)
        pad = "same"
        if tokens is not None:
            xg = partitioning.halo(xg, tokens, dim=1, width=self.kernel // 2)
            pad = (0, self.kernel // 2, self.kernel // 2)
        xg = xg.permute(0, 4, 1, 2, 3)

        def project(conv):                               # → [B, h, N, dh]
            y = F.conv3d(xg, conv.weight.to(dt), conv.bias.to(dt), padding=pad)
            return y.permute(0, 2, 3, 4, 1).reshape(B, N, h, dh).transpose(1, 2)

        fx_mid, x_mid = project(self.in_project_fx), project(self.in_project_x)
        st = stats_dtype(dt)
        logits = linear(self.in_project_slice, x_mid, dt)          # [B, h, N, G]
        temp = self.temperature.to(st).clamp(0.1, 5.0)
        slice_weights = torch.softmax(logits.to(st) / temp, dim=-1).to(dt)
        # the N-contractions: the only cross-token sums (summed over the mp
        # group on a token shard); the G-token attention is replicated
        slice_norm = slice_weights.sum(dim=2, dtype=st)             # [B, h, G]
        slice_token = torch.matmul(slice_weights.transpose(-1, -2), fx_mid)
        if tokens is not None:
            slice_norm = partitioning.mp_sum(slice_norm, tokens)
            slice_token = partitioning.mp_sum(slice_token, tokens)
        slice_token = (slice_token / (slice_norm + 1e-5)[..., None]).to(dt)

        q = linear(self.to_q, slice_token, dt)
        k = linear(self.to_k, slice_token, dt)
        v = linear(self.to_v, slice_token, dt)
        dots = torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
        attn = torch.softmax(dots.to(st), dim=-1).to(dt)
        attn = drop(attn, self.dropout)
        out_token = torch.matmul(attn, v)                           # [B, h, G, dh]
        out_x = torch.matmul(slice_weights, out_token)              # [B, h, N, dh]
        out_x = out_x.transpose(1, 2).reshape(B, N, h * dh)
        return drop(linear(self.to_out[0], out_x, dt), self.dropout, token_axis=1)


class TransolverBlock(nn.Module):
    """Pre-LN physics attention and MLP, each residual; the last block adds
    ``ln_3`` and ``mlp2``."""

    def __init__(self, num_heads: int, hidden_dim: int, dropout: float,
                 mlp_ratio: int, slice_num: int, H: int, W: int, D: int,
                 last_layer: bool = False, out_dim: int = 1):
        super().__init__()
        self.last_layer = last_layer
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.Attn = PhysicsAttention3d(hidden_dim, num_heads, hidden_dim // num_heads,
                                       slice_num, H, W, D, dropout=dropout)
        self.ln_2 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.mlp = TransolverMLP(hidden_dim, hidden_dim * mlp_ratio, hidden_dim)
        if last_layer:
            self.ln_3 = nn.LayerNorm(hidden_dim, eps=1e-5)
            self.mlp2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, fx, dt, drop):
        fx = self.Attn(layer_norm(self.ln_1, fx, dt), dt, drop) + fx
        fx = self.mlp(layer_norm(self.ln_2, fx, dt), dt) + fx
        if self.last_layer:
            # mlp2 has no dtype in JAX: float32 (promoted to its parameters)
            st = stats_dtype(dt)
            return linear(self.mlp2, layer_norm(self.ln_3, fx, dt), st)
        return fx


class Transolver3d(Model):
    """Transolver on windows [B, T, H, W, C_in] → [B, T, H, W, out_dim]; the
    config's H·W·D is the window's T·H·W.

    ``generator`` draws the initial weights (on the CPU, then moved to
    ``device``); None uses PyTorch's global generator.
    """

    def __init__(self, space_dim: int, n_layers: int, n_hidden: int, n_head: int,
                 H: int, W: int, D: int, fun_dim: int, out_dim: int,
                 shape_in: Sequence[int], shape_out: Sequence[int], ref: int = 8,
                 mlp_ratio: int = 1, slice_num: int = 32, dropout: float = 0.0,
                 unified_pos: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None, dropout_seed: int = 0,
                 seq_mesh=None):
        super().__init__()
        if H * W * D != int(np.prod(shape_in[:-1])):
            raise ValueError(f"the mesh H·W·D = {H}·{W}·{D} is not the window's "
                             f"T·H·W = {int(np.prod(shape_in[:-1]))}")
        self.shape_in, self.shape_out = tuple(shape_in), tuple(shape_out)
        self.H, self.W, self.D, self.ref = H, W, D, ref
        self.n_hidden, self.out_dim = n_hidden, out_dim
        self.unified_pos, self.compute_dtype = bool(unified_pos), compute_dtype
        self.seq_mesh = seq_mesh
        n_in = ref ** 3 if unified_pos else shape_in[-1]
        self.preprocess = TransolverMLP(n_in, n_hidden * 2, n_hidden)
        self.placeholder = nn.Parameter(torch.empty(n_hidden))
        self.blocks = nn.ModuleList(
            TransolverBlock(n_head, n_hidden, dropout, mlp_ratio, slice_num, H, W, D,
                            last_layer=(i == n_layers - 1), out_dim=out_dim)
            for i in range(n_layers))
        self.reset_parameters(generator)
        self.to(device)
        self.reseed_dropout(dropout_seed)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_init_(m.weight.data, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv3d):
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, PhysicsAttention3d):
                nn.init.constant_(m.temperature, 0.5)
        with torch.no_grad():
            self.placeholder.copy_(torch.rand(self.n_hidden, generator=generator)
                                   / self.n_hidden)

    def unified_positions(self, device, dtype) -> torch.Tensor:
        """[H·W·D, ref³]: each grid point's distances to the reference grid
        (JAX ``Transolver3d._unified_pos``), computed in float64 numpy."""
        gx, gy, gz = (np.linspace(0, 1, n) for n in (self.H, self.W, self.D))
        grid = np.stack(np.meshgrid(gx, gy, gz, indexing="ij"), axis=-1)
        rr = np.linspace(0, 1, self.ref)
        grid_ref = np.stack(np.meshgrid(rr, rr, rr, indexing="ij"), axis=-1)
        pos = np.sqrt(((grid[:, :, :, None, None, None, :]
                        - grid_ref[None, None, None, :, :, :, :]) ** 2).sum(-1))
        pos = pos.reshape(self.H * self.W * self.D, self.ref ** 3)
        return torch.from_numpy(pos.astype(np.float32)).to(device=device, dtype=dtype)

    def _tokens(self):
        """This rank's share of the H·W·D tokens in whole H planes under
        ``seq_mesh``, or None (no mesh, mp 1, or mp does not divide H)."""
        return partitioning.token_share_for(self.seq_mesh, self.H * self.W * self.D,
                                            unit=self.W * self.D)

    def seq_parallel_parameters(self) -> list:
        # the split is at the input: every parameter is used on the shards
        return list(self.parameters()) if self._tokens() else []

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """x [B, T, H, W, C_in] → [B, T, H, W, out_dim] float32 (float64 for a
        float64 copy), or, given the target y, the scalar MSE. ``reference``
        is accepted for the callers that hold a kernel path against the
        plain one; this family runs no kernel of its own. Under
        ``seq_mesh`` (``seq_shard``) the tokens are split over the mp group
        at the input, as JAX's first ``token_constraint``, and gathered
        before the output reshape."""
        in_shape = x.shape
        B, dt = in_shape[0], self.compute_dtype
        x = x.reshape(B, -1, in_shape[-1])
        if self.unified_pos:
            pos = self.unified_positions(x.device, stats_dtype(dt))
            x = pos[None].expand(B, *pos.shape)
        if self.training:
            drop = lambda z, p, token_axis=None: (
                dropout(z, p, self.dropout_generator(z.device), token_axis) if p else z)
        else:
            drop = lambda z, p, token_axis=None: z
        tokens = self._tokens()
        if tokens is not None:
            x = partitioning.split_tokens(x, tokens)
        with mesh_lib.token_share(tokens):
            fx = self.preprocess(x, dt)
            fx = fx + self.placeholder[None, None, :].to(fx.dtype)
            for block in self.blocks:
                fx = block(fx, dt, drop)
        if tokens is not None:
            fx = partitioning.gather_tokens(fx, tokens)
        pred = fx.reshape(*in_shape[:-1], self.out_dim)
        return pred if y is None else mse(pred, y.to(pred.dtype))
