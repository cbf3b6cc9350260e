"""GalerkinTransformer3d — the linear-attention operator transformer, on the
fused Galerkin-scores kernel.

Counterpart of ``realpdebench_tpu/models/galerkin_transformer.py`` (the
benchmark configuration of the reference's Galerkin Transformer): a Dense
lift ("downscaler") of every (t, y, x) point to ``n_hidden`` features, one
token per point (N = T·H·W); ``num_encoder_layers`` encoder layers of
Galerkin attention ``Q · (LN(K)ᵀ · LN(V)) / N`` with per-head affine
LayerNorms on K and V, and a ReLU feed-forward; then the ``SpectralRegressor``
decoder: the grid features appended, a Dense to ``freq_dim``, a zero
end-pad of (T, H, W), truncated spectral convolutions (``ops/spectral``,
its 'dft' form) plus pointwise Denses and BatchNorms, the crop, and two
Denses with SiLU between. The output is time-interleaved when
T_out = mult·T_in.

The scores run ``ops.galerkin.galerkin_scores`` (the scores kernel on a
CUDA tensor); ``forward(..., reference=True)`` runs its plain twin instead.
The product ``q · scores`` is one batched matmul of the tokens [B, N, h·d]
with the block-diagonal [B, h·d, h·d] of the per-head scores, so q and the
output keep the Dense's layout with no transpose copy.

Dropout follows flax's ``nn.Dropout``: keep with probability 1 − p, scale
the kept values by 1/(1 − p). Every mask comes from ``models/base.py``'s
``dropout_mask``, drawn from the model's own ``torch.Generator`` on the
activations' device, seeded by ``dropout_seed`` (``build_model`` passes the
run's ``seed``; ``reseed_dropout`` restarts the stream); the global RNG is
never used. In train mode the score dropout (p 0.5), the
residual dropouts and the feed-forward dropout (p ``dropout``) run; in eval
mode none does, unless ``reference_eval_dropout`` keeps the score dropout
on, as the reference does (JAX ``galerkin_transformer.py:108-110``).

Sequence parallelism (``seq_mesh``, a ``core.mesh.MeshContext`` with mp > 1;
``seq_shard`` in the loops): the tokens are split over the mp group after
the downscaler and gathered before the regressor, as JAX's
``token_constraint`` places them. The scores are the only cross-token
coupling: each rank's kernel sums its tokens over the global N and the
partials are summed over the group. q·scores, the feed-forward and the
per-token dropouts (masks drawn for the global token count) stay local; the
regressor's DFT and BatchNorm run replicated over mp.

Precision: ``compute_dtype`` (float32 or bfloat16) is the dtype of the
activations and of the Denses; parameters stay float32 and are cast at
use, as flax's ``dtype=`` does. The per-head LayerNorm affine is cast to
k's dtype before the scores (as JAX does); the scores come back in float32
and are cast to the compute dtype before the dropout and ``q · scores``
(JAX's einsum path yields k's dtype there). The BatchNorm takes float32
statistics (the biased variance, as E[x²] − E[x]²) and moves its running
statistics by 0.1·(batch − running), flax's semantics; its module is never
called.

Parameters carry the names the JAX exporter writes
(``realpdebench_tpu/interop/torch_export.py::export_galerkin``):
``downscaler.id``, ``encoder_layers.i.attn.linears.0/1/2`` (q, k, v),
``encoder_layers.i.attn.norm_K.h`` / ``norm_V.h`` (per head),
``encoder_layers.i.ff.lr1/lr2``, ``encoder_layers.i.layer_norm1/2`` (with
``layer_norm``), ``regressor.fc``, ``regressor.spectral_conv.i.weights1..4``,
``regressor.convs.i``, ``regressor.bns.i``, ``regressor.regressor1/2``, so
``load_state_dict(strict=True)`` takes an exported checkpoint as it is.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from realpdebench_tpu_torch.core import mesh as mesh_lib
from realpdebench_tpu_torch.core import partitioning
from realpdebench_tpu_torch.models.base import (
    Model,
    batch_norm,
    dropout,
    layer_norm,
    lecun_normal_,
    linear,
    mse,
)
from realpdebench_tpu_torch.models.fno import SpectralConv3d
from realpdebench_tpu_torch.ops.activations import gelu
from realpdebench_tpu_torch.ops.galerkin import (
    galerkin_scores,
    galerkin_scores_plain,
)
from realpdebench_tpu_torch.ops.spectral import (
    grid_features,
    truncated_spectral_conv3d_dft_lowp,
)

SCORE_DROPOUT = 0.5   # the reference's F.dropout default on the scores


class GalerkinAttention(nn.Module):
    """Galerkin attention on tokens [B, N, d_model] (JAX
    ``GalerkinAttention``): q, k, v Denses, the fused scores of k and v with
    the per-head LayerNorm affine, the score dropout, then q · scores."""

    def __init__(self, d_model: int, n_head: int, norm_eps: float = 1e-5,
                 xavier_init: float = 1e-2, diagonal_weight: float = 1e-2,
                 reference_eval_dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_head, self.norm_eps = d_model, n_head, norm_eps
        self.xavier_init, self.diagonal_weight = xavier_init, diagonal_weight
        self.reference_eval_dropout = reference_eval_dropout
        self.dtype = dtype
        d_k = d_model // n_head
        self.linears = nn.ModuleList(nn.Linear(d_model, d_model) for _ in range(3))
        self.norm_K = nn.ModuleList(nn.LayerNorm(d_k, eps=norm_eps) for _ in range(n_head))
        self.norm_V = nn.ModuleList(nn.LayerNorm(d_k, eps=norm_eps) for _ in range(n_head))

    def reset_parameters(self, generator=None) -> None:
        """Reference ``SimpleAttention._reset_parameters``: xavier-uniform
        times ``xavier_init`` plus ``diagonal_weight``·I, zero biases; unit
        LayerNorm scales and zero biases."""
        for lin in self.linears:
            nn.init.xavier_uniform_(lin.weight, gain=self.xavier_init,
                                    generator=generator)
            with torch.no_grad():
                lin.weight.add_(self.diagonal_weight * torch.eye(
                    self.d_model, device=lin.weight.device))
            nn.init.zeros_(lin.bias)
        for ln in (*self.norm_K, *self.norm_V):
            ln.reset_parameters()

    @staticmethod
    def _affine(norms, dt):
        return (torch.stack([n.weight for n in norms]).to(dt),
                torch.stack([n.bias for n in norms]).to(dt))

    def forward(self, x, generator=None, reference: bool = False):
        B, N, D = x.shape
        h, dt = self.n_head, self.dtype
        q, k, v = (linear(lin, x, dt) for lin in self.linears)
        scores_fn = galerkin_scores_plain if reference else galerkin_scores
        # on a token shard: this shard's partial sum over the global count,
        # summed over the mp group (the only cross-token coupling)
        tokens = mesh_lib.current_token_share()
        scores = scores_fn(k, v, *self._affine(self.norm_K, k.dtype),
                           *self._affine(self.norm_V, k.dtype), h, self.norm_eps,
                           n_total=None if tokens is None else tokens.total)
        if tokens is not None:
            scores = partitioning.mp_sum(scores, tokens)
        scores = scores.to(dt)                                 # [B, h, d, d]
        # the score dropout's tensor is replicated over the mp group: the
        # same mask on every rank
        if self.training or self.reference_eval_dropout:
            scores = dropout(scores, SCORE_DROPOUT, generator)
        # per-head q·scores as one product with the block-diagonal scores
        eye = torch.eye(h, dtype=dt, device=x.device)
        blocks = (scores[:, :, :, None, :] * eye[None, :, None, :, None]).reshape(B, D, D)
        return torch.matmul(q, blocks)


class FeedForward(nn.Module):
    """The encoder's two feed-forward Denses (reference ``ff.lr1/lr2``)."""

    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.lr1 = nn.Linear(d_model, dim_feedforward)
        self.lr2 = nn.Linear(dim_feedforward, d_model)


class GKTEncoderLayer(nn.Module):
    """Galerkin-attention encoder layer (JAX ``GKTEncoderLayer``): residual
    attention, optional LayerNorm, residual ReLU feed-forward, optional
    LayerNorm, with dropout on both residual branches and inside the
    feed-forward."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int,
                 layer_norm: bool = False, norm_eps: float = 1e-7,
                 dropout: float = 0.05, ffn_dropout: float = 0.05,
                 xavier_init: float = 1e-2, diagonal_weight: float = 1e-2,
                 reference_eval_dropout: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.ffn_dropout, self.dtype = dropout, ffn_dropout, dtype
        self.attn = GalerkinAttention(
            d_model, n_head, norm_eps=norm_eps, xavier_init=xavier_init,
            diagonal_weight=diagonal_weight,
            reference_eval_dropout=reference_eval_dropout, dtype=dtype)
        self.ff = FeedForward(d_model, dim_feedforward)
        if layer_norm:
            self.layer_norm1 = nn.LayerNorm(d_model, eps=norm_eps)
            self.layer_norm2 = nn.LayerNorm(d_model, eps=norm_eps)
        self.layer_norm = layer_norm

    def forward(self, x, generator=None, reference: bool = False):
        dt = self.dtype
        drop = ((lambda z, p: dropout(z, p, generator, token_axis=1)) if self.training
                else (lambda z, p: z))
        x = x + drop(self.attn(x, generator, reference), self.dropout)
        if self.layer_norm:
            x = layer_norm(self.layer_norm1, x, dt)
        h = drop(F.relu(linear(self.ff.lr1, x, dt)), self.ffn_dropout)
        x = x + drop(linear(self.ff.lr2, h, dt), self.dropout)
        if self.layer_norm:
            x = layer_norm(self.layer_norm2, x, dt)
        return x


class SpectralRegressor(nn.Module):
    """The FNO-style decoder head (JAX ``SpectralRegressor``), its spectral
    convolutions with modes (t, x, y) on the (T, H, W) axes."""

    def __init__(self, in_dim: int, freq_dim: int, out_dim: int, modes_x: int,
                 modes_y: int, modes_t: int, num_layers: int = 1,
                 padding: int = 6, dim_feedforward: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers, self.padding, self.dtype = num_layers, padding, dtype
        self.fc = nn.Linear(in_dim + 3, freq_dim)
        self.spectral_conv = nn.ModuleList(
            SpectralConv3d(freq_dim, freq_dim, modes_t, modes_x, modes_y)
            for _ in range(num_layers))
        self.convs = nn.ModuleList(nn.Conv3d(freq_dim, freq_dim, 1)
                                   for _ in range(num_layers))
        self.bns = nn.ModuleList(nn.BatchNorm3d(freq_dim, eps=1e-5)
                                 for _ in range(num_layers))
        self.regressor1 = nn.Linear(freq_dim, dim_feedforward)
        self.regressor2 = nn.Linear(dim_feedforward, out_dim)

    def forward(self, x, grid):
        """x [B, T, H, W, in_dim], grid [T, H, W, 3] → [B, T, H, W, out_dim]
        in the compute dtype."""
        dt, p = self.dtype, self.padding
        grid = grid.to(x.dtype).expand(x.shape[0], *grid.shape)
        x = linear(self.fc, torch.cat([x, grid], dim=-1), dt)
        x = F.pad(x, (0, 0, 0, p, 0, p, 0, p))           # end-pad W, H, T
        for i in range(self.num_layers):
            w_real, w_imag = self.spectral_conv[i].corner_weights()
            x1 = truncated_spectral_conv3d_dft_lowp(x, w_real, w_imag, compute_dtype=dt)
            conv = self.convs[i]
            x2 = F.linear(x.to(dt), conv.weight[:, :, 0, 0, 0].to(dt), conv.bias.to(dt))
            x = batch_norm(self.bns[i], x1.to(dt) + x2, self.training, dt)
            if i < self.num_layers - 1:
                x = gelu(x)
        x = x[:, :-p, :-p, :-p]
        return linear(self.regressor2, F.silu(linear(self.regressor1, x, dt)), dt)


class GalerkinTransformer3d(Model):
    """The Galerkin Transformer on windows [B, T_in, H, W, C_in] →
    [B, T_out, H, W, C_out].

    ``generator`` draws the initial weights (on the CPU, then moved to
    ``device``) from the JAX init's distributions; None uses PyTorch's
    global generator. ``dropout_seed`` seeds the dropout stream.
    ``attention_type`` must be 'galerkin' and ``attn_norm`` true: the
    benchmark configuration, the only one the JAX module implements.
    """

    def __init__(self, shape_in: Sequence[int], shape_out: Sequence[int],
                 n_hidden: int = 256, num_encoder_layers: int = 1,
                 n_head: int = 4, dim_feedforward: int = 256,
                 attention_type: str = "galerkin", layer_norm: bool = False,
                 attn_norm: bool = True, norm_eps: float = 1e-7,
                 modes1: int = 16, modes2: int = 20, modes3: int = 4,
                 spectral_layers: int = 1, freq_dim: int = 128,
                 dropout: float = 0.05, xavier_init: float = 1e-2,
                 diagonal_weight: float = 1e-2,
                 reference_eval_dropout: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None,
                 dropout_seed: int = 0, seq_mesh=None):
        super().__init__()
        if attention_type != "galerkin" or not attn_norm:
            raise ValueError(f"the Galerkin Transformer implements galerkin "
                             f"attention with attn_norm, got {attention_type!r}, "
                             f"attn_norm={attn_norm}")
        if n_hidden % n_head:
            raise ValueError(f"n_hidden {n_hidden} is not a multiple of n_head {n_head}")
        self.shape_in, self.shape_out = tuple(shape_in), tuple(shape_out)
        self.n_hidden, self.compute_dtype = n_hidden, compute_dtype
        self.reference_eval_dropout = reference_eval_dropout
        self.seq_mesh = seq_mesh
        self.mult = shape_out[0] // shape_in[0]
        dt = compute_dtype
        self.downscaler = nn.Module()
        self.downscaler.id = nn.Linear(shape_in[-1], n_hidden)
        self.encoder_layers = nn.ModuleList(GKTEncoderLayer(
            n_hidden, n_head, dim_feedforward, layer_norm=layer_norm,
            norm_eps=norm_eps, dropout=dropout, ffn_dropout=dropout,
            xavier_init=xavier_init, diagonal_weight=diagonal_weight,
            reference_eval_dropout=reference_eval_dropout, dtype=dt)
            for _ in range(num_encoder_layers))
        self.regressor = SpectralRegressor(
            n_hidden, freq_dim, shape_out[-1] * self.mult, modes_x=modes1,
            modes_y=modes2, modes_t=modes3, num_layers=spectral_layers,
            dtype=dt)
        self.reset_parameters(generator)
        self.to(device)
        self.reseed_dropout(dropout_seed)

    def reset_parameters(self, generator=None) -> None:
        """The JAX init's distributions: lecun-normal kernels and zero biases
        for the Denses and pointwise convs, xavier + diagonal for q/k/v,
        U[0,1)/(C_in·C_out) spectral weights, unit norm scales, zero norm
        biases, BatchNorm running mean 0 and var 1."""
        for m in self.modules():
            if isinstance(m, GalerkinAttention):
                m.reset_parameters(generator)
            elif isinstance(m, SpectralConv3d):
                m.reset_parameters(generator)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm3d)):
                m.reset_parameters()
        attn_linears = {id(lin) for m in self.modules()
                        if isinstance(m, GalerkinAttention) for lin in m.linears}
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv3d)) and id(m) not in attn_linears:
                lecun_normal_(m.weight.data, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)

    def _tokens(self, n: int):
        """This rank's token share of ``n`` tokens under ``seq_mesh``, or
        None (no mesh, mp 1, or mp does not divide n)."""
        return partitioning.token_share_for(self.seq_mesh, n)

    def seq_parallel_parameters(self) -> list:
        n = self.shape_in[0] * self.shape_in[1] * self.shape_in[2]
        return list(self.encoder_layers.parameters()) if self._tokens(n) else []

    def forward(self, x: torch.Tensor, y: torch.Tensor | None = None,
                reference: bool = False) -> torch.Tensor:
        """x [B, T_in, H, W, C_in] → [B, T_out, H, W, C_out] float32, or,
        given the target y, the scalar MSE. ``reference=True`` runs the
        scores through their plain twin: the check a kernel run is compared
        against. Under ``seq_mesh`` (``seq_shard``) the encoder runs on this
        rank's tokens (split after the downscaler, gathered before the
        regressor, which runs replicated over the mp group)."""
        B, T, H, W, _ = x.shape
        stochastic = self.training or self.reference_eval_dropout
        gen = self.dropout_generator(x.device) if stochastic else None
        h = linear(self.downscaler.id, x, self.compute_dtype).reshape(B, T * H * W, -1)
        tokens = self._tokens(T * H * W)
        if tokens is not None:
            h = partitioning.split_tokens(h, tokens)
        with mesh_lib.token_share(tokens):
            for layer in self.encoder_layers:
                h = layer(h, gen, reference)
        if tokens is not None:
            h = partitioning.gather_tokens(h, tokens)
        grid = torch.cat(grid_features((T, H, W), device=x.device), dim=-1)
        out = self.regressor(h.reshape(B, T, H, W, self.n_hidden), grid).float()
        t_out, c_out = self.shape_out[0], self.shape_out[-1]
        # [B,T,H,W,c_out*mult] -> [B,T,H,W,c_out,mult] -> [B,T,mult,H,W,c_out]
        out = out.reshape(B, T, H, W, c_out, self.mult).permute(0, 1, 5, 2, 3, 4)
        pred = out.reshape(B, t_out, H, W, c_out)
        return pred if y is None else mse(pred, y.float())
