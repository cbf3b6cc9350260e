"""The ranks of tests/test_torch_mesh.py's two-process runs (gloo on the CPU).

Imports only torch and the port, so the spawned processes stay small. Each
process joins a gloo group through a file store in the test's tmp path (no
network), runs torch ops on one intra-op thread, and rank 0 saves what the
test compares with the same work done in one process:

* ``step_main``: one training step of every case in ``STEP_CASES`` on this
  rank's slice of the global batch, under ``mesh_shape: dp=2``;
* ``loop_main``: ``run_training`` on a synthetic tree under ``dp=2``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from realpdebench_tpu_torch.core import mesh
from realpdebench_tpu_torch.data.normalizer import IdentityNormalizer
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

# name: (model keywords, (shape_in, shape_out), global batch, grad_accum);
# the tiny sizes of tests/test_torch_fno_tail.py, test_torch_deeponet.py
# and test_torch_galerkin.py (dropout on)
_FNO = dict(model_name="fno", modes1=2, modes2=3, modes3=4, n_layers=2, width=8)
_DEEPONET = dict(model_name="deeponet", p=16, dropout_rate=0.1)
_GK = dict(model_name="galerkin_transformer", n_hidden=32, num_encoder_layers=2, n_head=2,
           dim_feedforward=24, layer_norm=False, norm_eps=1e-7, fourier_modes_x=3,
           fourier_modes_y=3, fourier_modes_t=2, num_regressor_layers=2, freq_dim=16,
           encoder_dropout=0.05, xavier_init=1e-2, diagonal_weight=1e-2)
# test_torch_wdno.py's WDNO (t and noise drawn from the model's generator)
# and test_torch_cno.py's CNO with remat (its BatchNorms' all-reduce runs
# again in the recomputed forward)
_WDNO = dict(model_name="wdno", dim=8, dim_mults=[1, 2], wave_type="bior1.1",
             pad_mode="zero", beta_schedule="sigmoid", timesteps=20, sampling_timesteps=4,
             ddim_sampling_eta=1.0)
_CNO = dict(model_name="cno", N_layers=2, N_res=1, N_res_neck=2, channel_multiplier=8,
            latent_lift_proj_dim=8, activation="LeakyReLU", remat=True)
_FNO_SHAPES = ((3, 10, 12, 3), (6, 10, 12, 3))
STEP_CASES = {
    "fno_k1": (_FNO, _FNO_SHAPES, 4, 1),
    "fno_k2": (_FNO, _FNO_SHAPES, 4, 2),
    "fno_b6_k2": (_FNO, _FNO_SHAPES, 6, 2),   # a rank's rows split 2 + 1 over the microbatches
    "deeponet_k1": (_DEEPONET, ((4, 16, 16, 3),) * 2, 4, 1),
    "deeponet_k2": (_DEEPONET, ((4, 16, 16, 3),) * 2, 4, 2),
    "deeponet_b6_k2": (_DEEPONET, ((4, 16, 16, 3),) * 2, 6, 2),
    "galerkin_transformer_k1": (_GK, ((4, 8, 8, 3),) * 2, 4, 1),
    "galerkin_transformer_k2": (_GK, ((4, 8, 8, 3),) * 2, 4, 2),
    "galerkin_transformer_b6_k2": (_GK, ((4, 8, 8, 3),) * 2, 6, 2),
    "wdno_k2": (_WDNO, ((4, 8, 8, 2),) * 2, 4, 2),
    "cno_remat_k1": (_CNO, ((4, 16, 16, 3),) * 2, 4, 1),
}
STEP_LR = 1e-3


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def run_step_case(name: str, mesh_ctx, dtype=torch.float32) -> dict:
    """One step of case ``name`` from seeded weights and data: on this
    rank's slice of the global batch under a process group, on all of it
    without one; ``dtype`` float64 makes a float64 copy of the model and the
    data (not for the FNO, whose kernels' twins compute in float32).
    Returns the loss, every gradient and every buffer."""
    kw, (si, so), b, k = STEP_CASES[name]
    model = build_model(shapes=(si, so), device="cpu", generator=make_generator(5), seed=7,
                        **kw)
    if dtype == torch.float64:
        model = model.double()
        model.compute_dtype = torch.float64
    opt = build_optimizer(dict(lr=STEP_LR, scheduler="cosine", num_update=10,
                               clip_grad_norm=0.0), model.parameters())
    step = make_train_step(model, IdentityNormalizer(), opt, grad_accum=k, mesh=mesh_ctx)
    r = np.random.default_rng(sum(map(ord, name)))
    x = torch.from_numpy(r.normal(size=(b, *si)).astype(np.float32))
    y = torch.from_numpy(r.normal(size=(b, *so)).astype(np.float32))
    # a mean of its own for every sample, as tests/test_torch_train.py
    x += torch.from_numpy(r.normal(size=(b, 1, 1, 1, si[-1])).astype(np.float32))
    x, y = x.to(dtype), y.to(dtype)
    rows = mesh.local_batch_slice(b, mesh_ctx) if mesh_ctx.distributed else slice(None)
    loss = step(x[rows], y[rows])
    return dict(loss=float(loss),
                grads={n: _real(p.grad).clone() for n, p in model.named_parameters()
                       if p.grad is not None},
                buffers={n: t.clone() for n, t in model.named_buffers()})


def _join(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)


def step_main(rank: int, world: int, store: str, out: str) -> None:
    """Every step case under dp=world; rank 0 saves the results, the
    collectives counted by group, an all-gather of the ranks' ids and its
    place on a model axis of the same ranks."""
    _join(rank, world, store)
    try:
        ctx = mesh.make_mesh_context(f"dp={world}")
        mesh.reset_collectives()
        results = {name: run_step_case(name, ctx) for name in STEP_CASES}
        collectives = {k: dict(v) for k, v in mesh.COLLECTIVES.items()}
        gathered = mesh.allgather_to_host(torch.full((2, 3), float(rank)), ctx)
        mp = mesh.make_mesh_context(f"dp=1,mp={world}")
        if rank == 0:
            torch.save(dict(results=results, collectives=collectives, gathered=gathered,
                            mp_ctx=(mp.dp_size, mp.mp_size, mp.dp_index, mp.mp_index,
                                    mp.distributed),
                            ctx=(ctx.dp_size, ctx.mp_size, ctx.distributed)), out)
    finally:
        dist.destroy_process_group()


def loop_main(rank: int, world: int, store: str, cfg: dict, out_dir: str) -> None:
    """``run_training`` on ``cfg`` under dp=world; rank 0 saves the
    history. Checkpoints are rank 0's alone."""
    from realpdebench_tpu_torch.config import Config
    from realpdebench_tpu_torch.train.loop import run_training

    _join(rank, world, store)
    try:
        exp = os.path.join(out_dir, f"rank{rank}")
        _, _, history = run_training(Config(**cfg, mesh_shape=f"dp={world}"), exp,
                                     device="cpu")
        if rank == 0:
            torch.save(dict(history=history, exp=exp), os.path.join(out_dir, "loop.pt"))
    finally:
        dist.destroy_process_group()
