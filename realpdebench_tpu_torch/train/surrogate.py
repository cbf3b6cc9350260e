"""Combustion surrogate training — ``python -m realpdebench_tpu_torch train-surrogate``.

Counterpart of ``realpdebench_tpu/train/surrogate.py`` (reference
``realpdebench/train_surrogate.py:50-243``): trains the 17-channel →
1-channel surrogate (numerical fields and parameter planes → the real
observation) with the main loop's training step, evaluates every 50
iterations with the short metric set (normalized MSE, RMSE, MAE, Rel-L2)
and checkpoints at each evaluation, the best iteration chosen by RMSE.
The Gaussian normalizer's statistics are never cached (reference
``train_surrogate.py:113-116``). The JAX CLI's ``--mesh_shape`` is not
taken: mesh handling waits for ROADMAP item 9, as in ``train/loop.py``.
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import time

import torch

from realpdebench_tpu_torch.config import _flag, parse_config
from realpdebench_tpu_torch.data.loader import DataLoader, cycle_loader
from realpdebench_tpu_torch.data.normalizer import build_normalizer
from realpdebench_tpu_torch.data.surrogate import CombustionSurrogateHFDataset, SurrogateDataset
from realpdebench_tpu_torch.models.registry import build_model, resolve_device
from realpdebench_tpu_torch.train.checkpoint import CheckpointManager
from realpdebench_tpu_torch.train.loop import model_kwargs, param_count, validation_arrays
from realpdebench_tpu_torch.train.train_step import (
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from realpdebench_tpu_torch.utils.misc import make_generator, set_seed, setup_logging

EVAL_EVERY = 50
TEST_KEYS = ("normalized_mse", "rmse", "mae", "rel_l2_error")


def surrogate_datasets(cfg):
    """(train, test, normalizer) datasets of the config's backend."""
    use_hf = bool(cfg.get("use_hf_dataset", False))
    cls = CombustionSurrogateHFDataset if use_hf else SurrogateDataset
    common = dict(dataset_name=cfg.dataset_name, dataset_root=cfg.dataset_root)
    if use_hf:
        common.update(hf_auto_download=bool(cfg.get("hf_auto_download", False)),
                      hf_repo_id=cfg.get("hf_repo_id", "AI4Science-WestlakeU/RealPDEBench"),
                      hf_endpoint=cfg.get("hf_endpoint"), hf_revision=cfg.get("hf_revision"))
    for k in ("step", "n_sim_frame", "sub_s_real", "sub_s_numerical", "train_ratio"):
        if cfg.get(k) is not None:
            common[k] = cfg.get(k)
    return cls(mode="train", **common), cls(mode="test", **common), cls(mode="train", **common)


def surrogate_metrics(nmse_vals, pred, target) -> dict:
    """The surrogate's evaluation: normalized MSE (mean over batches), RMSE
    and MAE over every value, Rel-L2 the mean over windows."""
    diff = pred - target
    b = pred.shape[0]
    rel = diff.reshape(b, -1).norm(dim=1) / target.reshape(b, -1).norm(dim=1)
    return dict(normalized_mse=sum(nmse_vals) / max(len(nmse_vals), 1),
                rmse=float(torch.sqrt(torch.mean(diff ** 2))),
                mae=float(torch.mean(diff.abs())), rel_l2_error=float(rel.mean()))


def run_surrogate_training(cfg, exp_path: str, device=None):
    """Train as ``cfg`` says on ``device`` (None: the CUDA device, and an
    error where there is none); returns (model, optimizer, history)."""
    device = resolve_device(device, "run_surrogate_training trains")
    cuda = device.type == "cuda"
    train_ds, test_ds, norm_ds = surrogate_datasets(cfg)
    logging.info(f"Data loaded from {train_ds.numerical_dataset_path}")

    num_workers = int(cfg.get("num_workers", 4))
    train_loader = DataLoader(train_ds, batch_size=int(cfg.train_batch_size), shuffle=True,
                              drop_last=True, seed=int(cfg.get("seed", 0)),
                              num_workers=num_workers, pin_memory=cuda)
    test_loader = DataLoader(test_ds, batch_size=int(cfg.test_batch_size), pad_last=True,
                             num_workers=num_workers, pin_memory=cuda)
    normalizer = build_normalizer(cfg.get("normalizer", "gaussian"), norm_ds, is_save=False)
    model = build_model(train_dataset=train_ds, device=device,
                        generator=make_generator(int(cfg.get("seed", 0))),
                        **model_kwargs(cfg))
    # the JAX loop reads item 0 again for its init; the read keeps the
    # crops in step with it
    train_ds[0]
    logging.info(f"Number of parameters: {param_count(model)}")

    optimizer = build_optimizer(cfg, model.parameters())
    step_fn = make_train_step(model, normalizer, optimizer,
                              grad_accum=int(cfg.get("grad_accum", 1) or 1))
    eval_fn = make_eval_step(model, normalizer, c=None)
    ckpt = CheckpointManager(os.path.join(exp_path, "ckpt"), max_to_keep=cfg.get("max_to_keep"))
    batches = cycle_loader(train_loader, device=device)

    num_update = int(cfg.num_update)
    history = {"train_loss": [], "test": {k: [] for k in TEST_KEYS}}
    best_loss, best_iter = float("inf"), 0
    pending: list = []
    t0 = time.time()
    try:
        for iteration in range(1, num_update + 1):
            x, y = next(batches)
            pending.append(step_fn(x, y).detach())
            if iteration % EVAL_EVERY:
                continue
            losses = torch.stack(pending).tolist()
            pending.clear()
            history["train_loss"].extend(losses)
            vals = surrogate_metrics(*validation_arrays(eval_fn, test_loader, device))
            for k, v in vals.items():
                history["test"][k].append(v)
            if vals["rmse"] < best_loss:
                best_loss, best_iter = vals["rmse"], iteration
            logging.info(f"Iteration {iteration}, train loss: "
                         f"{sum(losses) / max(len(losses), 1):.5f}")
            logging.info("Validation results: "
                         + ", ".join(f"{k}: {v:.5f}" for k, v in vals.items()))
            ckpt.save(iteration, model, optimizer, metadata={
                "iteration": iteration, "best_iteration": best_iter,
                "best_test_loss": best_loss})
    finally:
        batches.close()
    history["train_loss"].extend(torch.stack(pending).tolist() if pending else [])
    ckpt.wait()
    elapsed = time.time() - t0
    history["perf"] = dict(elapsed_s=elapsed, steps=num_update,
                           loop_steps_per_sec=num_update / max(elapsed, 1e-9))
    logging.info(f"Training complete, best iteration {best_iter}, "
                 f"time {elapsed / 60:.2f} min")
    ckpt.close()
    return model, optimizer, history


def make_arg_parser() -> argparse.ArgumentParser:
    # no abbreviations: a key the parser does not know is a config override
    parser = argparse.ArgumentParser(description="Surrogate training (PyTorch)",
                                     allow_abbrev=False)
    parser.add_argument("--config", type=str,
                        default="configs/combustion/surrogate_model/fno.yaml")
    flag = dict(nargs="?", const=True, default=False, type=_flag)
    parser.add_argument("--use_hf_dataset", **flag)
    parser.add_argument("--hf_auto_download", **flag)
    parser.add_argument("--hf_repo_id", type=str, default="AI4Science-WestlakeU/RealPDEBench")
    parser.add_argument("--hf_endpoint", type=str, default=None)
    parser.add_argument("--hf_revision", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) | cuda:N | cpu")
    return parser


def main(argv=None):
    """Train the surrogate as the command line ``argv`` says (the JAX
    CLI's flags but ``--mesh_shape``, plus ``--device`` and ``--key value``
    config overrides); returns (exp_path, model, optimizer, history)."""
    cfg = parse_config(make_arg_parser(), argv)
    set_seed(int(cfg.get("seed", 0)))
    current_time = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    exp_path = os.path.join(cfg.get("results_path", "./results/"), cfg.model_name,
                            cfg.exp_name, current_time)
    os.makedirs(exp_path, exist_ok=True)
    writer = setup_logging(exp_path, bool(cfg.get("is_use_tb")))
    logging.info(f"args: {cfg.to_dict()}")
    model, optimizer, history = run_surrogate_training(cfg, exp_path, device=cfg.device)
    if writer is not None:
        writer.close()
    return exp_path, model, optimizer, history


if __name__ == "__main__":
    main()
