"""The ranks of the model-parallel runs of tests/test_torch_partitioning.py
and tests/test_torch_mesh.py (gloo on the CPU).

Imports only torch, numpy and the port, so the spawned processes stay
small. Each process joins a gloo group through a file store in the test's
tmp path (no network), runs torch ops on one intra-op thread, and saves
what the test compares with the same work done in one process
(``run_case`` without a mesh):

* ``steps_main``: STEPS training steps of each case in ``CASES`` under a
  ``mesh_shape`` (``dp=1,mp=2`` or ``dp=2,mp=2``), each rank on its data
  rank's slice of the global batch; every rank saves its results (its
  moments' shapes differ);
* ``loop_main``: ``run_training`` of the GK under ``dp=1,mp=2`` with
  ``seq_shard``, then a resume, then ``run_eval`` of its checkpoint.
"""

from __future__ import annotations

import contextlib
import os
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from realpdebench_tpu_torch.core import mesh
from realpdebench_tpu_torch.core.partitioning import shard_train_state
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.models import base as tbase
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

STEPS, LR = 3, 1e-3
# the tiny sizes of tests/test_torch_fno_tail.py, test_torch_galerkin.py and
# test_torch_transolver.py (its H 8 divided by mp 2)
FNO = dict(model_name="fno", modes1=2, modes2=3, modes3=4, n_layers=2, width=8)
GK = dict(model_name="galerkin_transformer", n_hidden=32, num_encoder_layers=2, n_head=2,
          dim_feedforward=24, layer_norm=False, norm_eps=1e-7, fourier_modes_x=3,
          fourier_modes_y=3, fourier_modes_t=2, num_regressor_layers=2, freq_dim=16,
          encoder_dropout=0.05, xavier_init=1e-2, diagonal_weight=1e-2)
TRANSOLVER = dict(model_name="transolver", space_dim=3, n_layers=2, n_hidden=16, n_head=2,
                  H=8, W=8, D=4, fun_dim=0, out_dim=3, ref=4, mlp_ratio=2, slice_num=8)
# name: (model keywords, (shape_in, shape_out), global batch, seq_shard,
# masks: the seed of shared numpy dropout masks, or None for the model's
# own generator)
CASES = {
    "fno": (FNO, ((3, 10, 12, 3), (6, 10, 12, 3)), 4, False, None),
    "galerkin_transformer": (GK, ((4, 8, 8, 3),) * 2, 4, True, None),
    "transolver": (TRANSOLVER, ((4, 8, 8, 3),) * 2, 2, True, None),
    # held against JAX's GSPMD step, which takes the same masks
    "galerkin_transformer_jax": (GK, ((4, 8, 8, 3),) * 2, 2, True, 21),
}
MP4_CASES = ("galerkin_transformer", "fno")
MASK_SEED = 21


def stats(c: int) -> dict:
    """The Gaussian normalizer's statistics of every case."""
    r = np.random.default_rng(20)
    s = dict(mean_inputs=r.normal(size=c), mean_targets=r.normal(size=c),
             std_inputs=r.uniform(0.5, 2.0, c), std_targets=r.uniform(0.5, 2.0, c))
    return {k: v.astype(np.float32) for k, v in s.items()}


def batches(name: str) -> tuple:
    """The STEPS global batches (x, y) of case ``name``, numpy f32."""
    _, (si, so), b, _, _ = CASES[name]
    r = np.random.default_rng(sum(map(ord, name)))
    xs = r.normal(size=(STEPS, b, *si)).astype(np.float32)
    # a mean of its own for every sample, as tests/test_torch_train.py
    xs += r.normal(size=(STEPS, b, 1, 1, 1, si[-1])).astype(np.float32)
    ys = r.normal(size=(STEPS, b, *so)).astype(np.float32)
    return xs, ys


class NumpyMasks:
    """Seeded keep masks in call order, each drawn with its call's shape
    and rate (tests/test_torch_galerkin.py's ``Masks`` draws the same ones
    for flax)."""

    def __init__(self, seed: int):
        self.rng, self.n = np.random.default_rng(seed), 0

    def torch_mask(self, shape, p, generator):
        self.n += 1
        return torch.from_numpy(self.rng.random(shape) >= p)


def model_for(name: str, mesh_ctx=None):
    """Case ``name``'s model from seeded weights; its tokens sharded over
    ``mesh_ctx``'s mp group where the case shards them."""
    kw, (si, so), _, seq, _ = CASES[name]
    extra = {"seq_mesh": mesh_ctx} if seq and mesh_ctx is not None else {}
    return build_model(shapes=(si, so), device="cpu", generator=make_generator(5), seed=7,
                       **kw, **extra)


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def run_case(name: str, mesh_ctx=None) -> dict:
    """STEPS steps of case ``name`` (Adam at LR, cosine, no clip) on the
    global batches: on this data rank's slice under ``mesh_ctx``, with the
    optimizer's state sharded over its mp group; on all of it without.
    Returns the losses, the first step's gradients, the state after and
    the shapes of Adam's first moments by parameter name."""
    _, (si, _), _, _, mask_seed = CASES[name]
    model = model_for(name, mesh_ctx)
    opt = build_optimizer(dict(lr=LR, scheduler="cosine", num_update=10, clip_grad_norm=0.0),
                          model.parameters())
    if mesh_ctx is not None:
        shard_train_state(model, opt, mesh_ctx)
    step = make_train_step(model, tnorm.build_normalizer("gaussian", stats=stats(si[-1])),
                           opt, mesh=mesh_ctx)
    xs, ys = batches(name)
    rows = mesh.local_batch_slice(xs.shape[1], mesh_ctx) if mesh_ctx else slice(None)
    losses, grads = [], None
    patch = (mock.patch.object(tbase, "dropout_mask", NumpyMasks(mask_seed).torch_mask)
             if mask_seed is not None else contextlib.nullcontext())
    with patch:
        for i in range(STEPS):
            losses.append(float(step(torch.from_numpy(xs[i][rows]),
                                     torch.from_numpy(ys[i][rows]))))
            if i == 0:
                grads = {n: _real(p.grad).clone() for n, p in model.named_parameters()
                         if p.grad is not None}
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {names[id(p)]: tuple(opt.adam.state[leaf]["exp_avg"].shape)
               for p, leaf in zip(opt.params, opt.shards.leaves if opt.shards else opt.params)}
    return dict(losses=losses, grads=grads,
                state={n: t.clone() for n, t in model.state_dict().items()},
                moments=moments)


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)


def steps_main(rank: int, world: int, store: str, spec: str, names: tuple,
               out_dir: str) -> None:
    """Every case in ``names`` under ``mesh_shape`` ``spec``; each rank
    saves its results, its mesh coordinates and the collectives counted by
    group to ``out_dir/rank{r}.pt``."""
    _join(rank, world, store)
    try:
        ctx = mesh.make_mesh_context(spec)
        mesh.reset_collectives()
        results = {name: run_case(name, ctx) for name in names}
        torch.save(dict(results=results, collectives=mesh.COLLECTIVES,
                        ctx=(ctx.dp_size, ctx.mp_size, ctx.dp_index, ctx.mp_index,
                             ctx.distributed)),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def loop_main(rank: int, world: int, store: str, cfg: dict, out_dir: str) -> None:
    """``run_training`` on ``cfg`` under ``dp=1,mp=world`` with
    ``seq_shard`` (``cfg``'s num_update steps), a resume of it to one step
    more, and ``run_eval`` of its last checkpoint; rank 0 saves the
    histories and the metrics."""
    from realpdebench_tpu_torch.config import Config
    from realpdebench_tpu_torch.eval.__main__ import run_eval
    from realpdebench_tpu_torch.train.loop import run_training

    _join(rank, world, store)
    try:
        spec = dict(mesh_shape=f"dp=1,mp={world}", seq_shard=True)
        exp = os.path.join(out_dir, "mp")
        _, _, history = run_training(Config(**cfg, **spec), exp, device="cpu")
        _, _, resumed = run_training(Config(**dict(cfg, num_update=cfg["num_update"] + 1,
                                                   resume=True), **spec), exp, device="cpu")
        last = os.path.join(exp, "ckpt", f"checkpoint_{cfg['num_update'] + 1}.pth")
        metrics = run_eval(Config(**cfg, **spec, checkpoint_path=last),
                           os.path.join(out_dir, "mp_eval"), device="cpu")
        if rank == 0:
            torch.save(dict(history=history, resumed=resumed, metrics=metrics, exp=exp),
                       os.path.join(out_dir, "loop.pt"))
    finally:
        dist.destroy_process_group()
