"""End-to-end training loop for the three paradigms.

Counterpart of ``realpdebench_tpu/train/loop.py`` (reference
`realpdebench/train.py:55-425`). Paradigms (``train_data_type``
numerical | real, ``is_finetune``):
  * train-on-numerical  — train split of the numerical data
  * train-on-real       — train split of the real data
  * finetune            — load a checkpoint, continue on the other type
Validation runs every num_update/50 iterations on the real val split with
the full 13-metric sweep on the device; a checkpoint is saved at each
validation. ``resume`` continues this experiment's own checkpoint
(parameters, optimizer state and step).

Batches reach the device from one background thread (``data/loader``);
the losses stay on the device between validations and are fetched in one
transfer there, so no step waits for the host. The run is on one device:
``mesh_shape`` must be null (data, tensor and sequence parallelism wait
for ROADMAP.md queue A, item 9).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

from realpdebench_tpu_torch.data.loader import DataLoader, cycle_loader, to_device
from realpdebench_tpu_torch.data.normalizer import build_normalizer
from realpdebench_tpu_torch.eval.metrics import (
    METRIC_NAMES,
    eval_metrics,
    infer_unmeasured_channels,
)
from realpdebench_tpu_torch.models.registry import build_model, resolve_device
from realpdebench_tpu_torch.train.checkpoint import CheckpointManager
from realpdebench_tpu_torch.train.train_step import (
    build_optimizer,
    make_eval_step,
    make_train_step,
)
from realpdebench_tpu_torch.utils.misc import make_generator
from realpdebench_tpu_torch.utils.profiling import StepTimer, maybe_trace

VAL_KEYS = ["normalized_mse"] + list(METRIC_NAMES)

# config keys that are not model options (the rest of the flat config
# namespace goes to build_model, as in the JAX package)
_NOT_MODEL_KEYS = ("device",)


def build_datasets(cfg, train_data_type: str, use_hf: bool = False,
                   dataset_class=None):
    """Dataset triplet (train / val / normalizer) per reference
    train.py:81-267. Val is always the real val split; the normalizer
    always streams the numerical train split. ``use_hf`` reads the Arrow
    tree (``data/hf_datasets``); ``dataset_class`` replaces the scenario's
    class (``data.fluid.with_arrays``)."""
    name = cfg.dataset_name
    common = dict(dataset_name=name, dataset_root=cfg.dataset_root)
    extra_train = dict(
        mask_prob=cfg.get("mask_prob", 0.5),
        noise_scale=cfg.get("noise_scale", 0.0),
    )
    gen = dict(generate_ids_if_missing=bool(cfg.get("generate_ids_if_missing",
                                                    False)))
    for k in ("in_step", "out_step", "interval", "trunk_length", "n_sim_frame",
              "sub_s_real", "sub_s_numerical", "train_ratio",
              "n_sim_in_distribution", "n_sim_out_distribution", "noise_type",
              "optical_kernel_size", "optical_sigma"):
        if cfg.get(k) is not None:
            gen[k] = cfg.get(k)

    if use_hf:
        common.update(hf_kwargs(cfg))
    cls = dataset_class or _dataset_class(name, use_hf)
    train_ds = cls(mode="train", dataset_type=train_data_type,
                   **common, **extra_train, **gen)
    val_ds = cls(mode="val", dataset_type="real", **common, **gen)
    norm_ds = cls(mode="train", dataset_type="numerical", **common, **gen)
    return train_ds, val_ds, norm_ds


def hf_kwargs(cfg) -> dict:
    """The Arrow datasets' download options, from the config."""
    return dict(
        hf_auto_download=bool(cfg.get("hf_auto_download", False)),
        hf_repo_id=cfg.get("hf_repo_id", "AI4Science-WestlakeU/RealPDEBench"),
        hf_endpoint=cfg.get("hf_endpoint"),
        hf_revision=cfg.get("hf_revision"),
    )


def _dataset_class(name: str, use_hf: bool):
    if use_hf:
        from realpdebench_tpu_torch.data.hf_datasets import HF_DATASETS

        if name not in HF_DATASETS:
            raise ValueError(f"Dataset {name} not supported (hf)")
        return HF_DATASETS[name]
    from realpdebench_tpu_torch.data.combustion import CombustionDataset
    from realpdebench_tpu_torch.data.fluid import FLUID_DATASETS

    if name == "combustion":
        return CombustionDataset
    if name in FLUID_DATASETS:
        return FLUID_DATASETS[name]
    raise ValueError(f"Dataset {name} not supported")


def check_single_device(cfg) -> None:
    if cfg.get("mesh_shape") is not None:
        raise NotImplementedError(
            f"mesh_shape {cfg.get('mesh_shape')!r}: the port runs on one "
            "device; meshes wait for ROADMAP.md queue A, item 9 (pass "
            "mesh_shape null)")


def model_kwargs(cfg) -> dict:
    return {k: v for k, v in cfg.to_dict().items() if k not in _NOT_MODEL_KEYS}


def param_count(model) -> int:
    """Parameters as the JAX package counts them: a complex entry is two."""
    return sum(p.numel() * (2 if p.is_complex() else 1) for p in model.parameters())


def run_training(cfg, exp_path: str, writer=None, device=None, dataset_class=None):
    """Run the full training loop on ``device`` (None: the CUDA device, and
    an error where there is none); returns (model, optimizer, history)."""
    device = resolve_device(device, "run_training trains")
    check_single_device(cfg)
    cuda = device.type == "cuda"

    train_data_type = cfg.get("train_data_type", "numerical")
    use_hf = bool(cfg.get("use_hf_dataset", False))
    train_ds, val_ds, norm_ds = build_datasets(cfg, train_data_type, use_hf,
                                               dataset_class)
    logging.info(
        f"Datasets: train={len(train_ds)} val={len(val_ds)} "
        f"(type={train_data_type}, hf={use_hf})"
    )

    num_workers = int(cfg.get("num_workers", 4))
    train_loader = DataLoader(
        train_ds, batch_size=int(cfg.train_batch_size), shuffle=True,
        drop_last=True, num_workers=num_workers, seed=int(cfg.get("seed", 0)),
        pin_memory=cuda,
    )
    # pad_last keeps every val batch the same shape; padded rows are dropped
    # before the metric sweep
    val_loader = DataLoader(
        val_ds, batch_size=int(cfg.test_batch_size), shuffle=False,
        num_workers=num_workers, pad_last=True, pin_memory=cuda,
    )

    normalizer = build_normalizer(cfg.get("normalizer", "gaussian"), norm_ds)
    model = build_model(train_dataset=train_ds, device=device,
                        generator=make_generator(int(cfg.get("seed", 0))),
                        **model_kwargs(cfg))
    if not model.trainable:
        raise ValueError(f"model {cfg.model_name!r} is training-free and has nothing to "
                         "train: evaluate it with `python -m realpdebench_tpu_torch eval "
                         "--config ...` (no checkpoint)")
    # the JAX loop reads item 0 again for its init; the read keeps the
    # dataset's noise and mask draws in step with it
    train_ds[0]
    logging.info(f"Number of parameters: {param_count(model)}")

    optimizer = build_optimizer(cfg, model.parameters())
    ckpt = CheckpointManager(os.path.join(exp_path, "ckpt"),
                             max_to_keep=cfg.get("max_to_keep"))
    start_iteration = 0
    if cfg.get("resume"):
        # full resume (parameters, optimizer, step) from this experiment's
        # own checkpoints, or from the directory ``resume`` names
        resume_dir = cfg.get("resume") if isinstance(cfg.get("resume"), str) \
            else os.path.join(exp_path, "ckpt")
        mgr = CheckpointManager(resume_dir)
        if mgr.latest_step() is not None:
            start_iteration, _ = mgr.restore(model, optimizer, load_opt_state=True)
            logging.info(f"Resumed from {resume_dir} at iteration {start_iteration}")
        mgr.close()
    if cfg.get("is_finetune"):
        load_reference_or_orbax_checkpoint(cfg.checkpoint_path, model)
        logging.info(f"Checkpoint {cfg.checkpoint_path} loaded (finetune)")

    step_fn = make_train_step(model, normalizer, optimizer,
                              grad_accum=int(cfg.get("grad_accum", 1) or 1))
    eval_fn = None  # built once c is known

    num_update = int(cfg.num_update)
    val_every = max(1, num_update // 50)
    batches = cycle_loader(train_loader, device=device)

    history = {"train_loss": [], "val": {k: [] for k in VAL_KEYS}}
    best_val, best_iter = float("inf"), 0
    c = None
    t_start = time.time()
    total_loss, count = 0.0, 0
    timer = StepTimer(warmup=2, sync=torch.cuda.synchronize if cuda else None)
    profile_dir = cfg.get("profile_dir")
    profile_window = (10, min(19, num_update))  # iterations traced when enabled
    trace = contextlib.ExitStack()

    # the losses stay on the device between validations: one transfer
    # drains them at each validation and at the end
    pending_losses: list = []

    def _drain_losses():
        nonlocal total_loss, count
        if not pending_losses:
            return
        vals = torch.stack(pending_losses).tolist()
        start_it = iteration - len(vals) + 1
        for j, lv in enumerate(vals):
            history["train_loss"].append(lv)
            if writer is not None:
                writer.add_scalar("train_loss", lv, start_it + j)
        total_loss += sum(vals)
        count += len(vals)
        pending_losses.clear()

    record = torch.profiler.record_function
    iteration = start_iteration
    val_s = ckpt_s = 0.0
    try:
        for iteration in range(start_iteration + 1, num_update + 1):
            if profile_dir and iteration == profile_window[0]:
                trace.enter_context(maybe_trace(profile_dir))
            with record("wait_batch"):
                x, y = next(batches)
            with record("train_step"):
                loss = step_fn(x, y)
            timer.tick()
            pending_losses.append(loss.detach())

            if iteration % val_every == 0:
                t_val = time.perf_counter()
                with record("validation"):
                    _drain_losses()
                    if c is None:
                        _, y_probe = val_ds[0]
                        c = y_probe.shape[-1] - infer_unmeasured_channels(y_probe[None])
                        eval_fn = make_eval_step(model, normalizer, c)
                    val = run_validation(model, eval_fn, val_loader, c, device)
                val_s += time.perf_counter() - t_val
                for kk in VAL_KEYS:
                    history["val"][kk].append(val[kk])
                if val["rmse"] < best_val:
                    best_val, best_iter = val["rmse"], iteration
                logging.info(
                    f"Iteration {iteration}, train loss: {total_loss / max(count, 1):.5f}")
                logging.info(
                    "Validation results: "
                    + ", ".join(f"{kk}: {val[kk]:.5f}" for kk in VAL_KEYS)
                )
                total_loss, count = 0.0, 0
                if writer is not None:
                    for kk in ("normalized_mse", "rmse", "mae", "rel_l2_error"):
                        writer.add_scalar(f"val_{kk}", val[kk], iteration)
                t_ckpt = time.perf_counter()
                with record("checkpoint"):
                    ckpt.save(
                        iteration, model, optimizer,
                        metadata={
                            "iteration": iteration,
                            "best_iteration": best_iter,
                            "best_val_loss": best_val,
                            "val_losses": {k: list(v) for k, v in history["val"].items()},
                        },
                    )
                ckpt_s += time.perf_counter() - t_ckpt
            if iteration == profile_window[1] and profile_dir:
                if cuda:
                    torch.cuda.synchronize()
                trace.close()
    finally:
        trace.close()
        batches.close()

    _drain_losses()
    ckpt.wait()
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.time() - t_start
    n_run = num_update - start_iteration
    perf = timer.summary()
    perf.update(loop_steps_per_sec=n_run / elapsed if n_run else None,
                elapsed_s=elapsed, steps=n_run, start_iteration=start_iteration,
                validation_s=val_s, checkpoint_s=ckpt_s,
                batch_assembly_s=batches.assembly_s / max(batches.batches, 1))
    logging.info(
        f"Training complete, best iteration {best_iter}, "
        f"time {elapsed / 60:.2f} min "
        f"({n_run / max(elapsed, 1e-9):.2f} steps/s incl. data and validation; "
        f"perf: {perf})"
    )
    history["perf"] = perf
    ckpt.close()
    return model, optimizer, history


def validation_arrays(eval_fn, val_loader, device=None):
    """The val split through ``eval_fn``: (the batches' normalized MSEs,
    the physical predictions, the targets), padding dropped, on the
    device."""
    nmses, preds, targets = [], [], []
    batches = to_device(val_loader, device)
    try:
        for batch in batches:
            x, y = batch[0], batch[1]
            n_real = int(batch[2].sum()) if len(batch) > 2 else x.shape[0]
            nmse, pred_phys, target_phys = eval_fn(x, y)
            nmses.append(nmse)
            preds.append(pred_phys[:n_real])
            targets.append(target_phys[:n_real])
    finally:
        batches.close()
    return torch.stack(nmses).tolist(), torch.cat(preds), torch.cat(targets)


def run_validation(model, eval_fn, val_loader, c, device=None):
    """Full-val-set metric sweep (reference train.py:344-402): the
    predictions and targets stay on the device and the 13 metrics are
    computed there."""
    nmse_vals, preds, targets = validation_arrays(eval_fn, val_loader, device)
    vals = eval_metrics(preds, targets, c)
    out = dict(zip(METRIC_NAMES, (float(v) for v in vals)))
    out["normalized_mse"] = sum(nmse_vals) / max(len(nmse_vals), 1)
    return out


def load_reference_or_orbax_checkpoint(path: str, model):
    """Load a checkpoint's weights (and BatchNorm statistics) into ``model``,
    strictly: a directory of this package's checkpoints (the latest), or a
    reference ``.pth`` (the reference's own, one the JAX package's
    ``save_torch_checkpoint`` wrote, or a bare state dict; DPOT's keys
    mapped by ``reference_state_dict``). The optimizer is not touched: a
    finetune starts a fresh Adam, as the reference does. An orbax directory
    of the JAX package cannot be read without orbax and tensorstore."""
    if os.path.isdir(path):
        mgr = CheckpointManager(path)
        if mgr.latest_step() is None:
            raise NotImplementedError(
                f"{path} holds no checkpoint_<step>.pth; reading an orbax "
                "checkpoint directory of the JAX package needs orbax and "
                "tensorstore (ROADMAP.md queue A): export it to a .pth with "
                "`python -m realpdebench_tpu export-torch` first")
        mgr.restore(model, load_opt_state=False)
        return model
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state_dict", ckpt)
    model.load_state_dict(reference_state_dict(sd, model), strict=True)
    return model


def reference_state_dict(sd: dict, model) -> dict:
    """A reference state dict's keys as ``model`` names them. DPOT takes
    what the JAX package's ``convert_dpot`` takes: the wrapper's
    ``dpot_model.``-prefixed keys, a ``module.``-prefixed (data-parallel)
    pretrained backbone, or a bare one; every other family's keys are its
    own."""
    if not hasattr(model, "dpot_model"):
        return sd
    strip = lambda k: (k[len("dpot_model."):] if k.startswith("dpot_model.") else
                       k[len("module."):] if k.startswith("module.") else k)
    return {f"dpot_model.{strip(k)}": v for k, v in sd.items()}
