"""`python -m realpdebench_tpu_torch.eval --config ... --checkpoint_path ...`

Counterpart of ``realpdebench_tpu/eval/__main__.py`` (reference
`realpdebench/eval.py:57-367`): load a checkpoint, roll it out
autoregressively over the real test split, and run the 13-metric sweep
(chunked per eval batch when N_autoregressive > 4) on the device, plus the
probe diagnostic. A training-free model (DMD) loads no checkpoint and
rolls out through ``make_host_rollout_fn``; the first batch's result plots (``N_plot``) and probe
plots (``N_plot_probe``) need matplotlib, imported where they are drawn.
"""

import datetime
import logging
import os

import numpy as np
import torch

from realpdebench_tpu_torch.config import make_arg_parser, parse_config
from realpdebench_tpu_torch.data.loader import DataLoader, to_device
from realpdebench_tpu_torch.data.normalizer import build_normalizer
from realpdebench_tpu_torch.eval.metrics import (
    METRIC_NAMES,
    eval_metrics,
    infer_unmeasured_channels,
)
from realpdebench_tpu_torch.eval.plots import plot_result
from realpdebench_tpu_torch.eval.probes import probe_diagnostic
from realpdebench_tpu_torch.eval.rollout import (
    finalize_rollout,
    make_host_rollout_fn,
    make_rollout_fn,
)
from realpdebench_tpu_torch.models.registry import build_model, resolve_device
from realpdebench_tpu_torch.train.loop import (
    _dataset_class,
    check_single_device,
    hf_kwargs,
    load_reference_or_orbax_checkpoint,
    model_kwargs,
    param_count,
)
from realpdebench_tpu_torch.utils.misc import make_generator, set_seed, setup_logging


def build_eval_datasets(cfg, dataset_class=None):
    """(test, train, normalizer) datasets per reference eval.py:91-260: the
    real test split at the autoregressive horizon, the train split (shape
    probe) and the numerical train split (normalizer statistics)."""
    use_hf = bool(cfg.get("use_hf_dataset", False))
    cls = dataset_class or _dataset_class(cfg.dataset_name, use_hf)
    common = dict(dataset_name=cfg.dataset_name, dataset_root=cfg.dataset_root)
    if use_hf:
        common.update(hf_kwargs(cfg))
    gen = {}
    for k in ("in_step", "out_step", "interval", "trunk_length", "n_sim_frame",
              "sub_s_real", "sub_s_numerical", "train_ratio",
              "n_sim_in_distribution", "n_sim_out_distribution",
              "generate_ids_if_missing"):
        if cfg.get(k) is not None:
            gen[k] = cfg.get(k)
    test_ds = cls(mode="test", dataset_type="real",
                  N_autoregressive=int(cfg.N_autoregressive),
                  test_mode=cfg.get("test_mode", "all"), **common, **gen)
    train_ds = cls(mode="train", dataset_type=cfg.get("train_data_type",
                                                      "numerical"),
                   mask_prob=cfg.get("mask_prob", 0.5), **common, **gen)
    norm_ds = cls(mode="train", dataset_type="numerical", **common, **gen)
    return test_ds, train_ds, norm_ds


def run_eval(cfg, exp_path: str, device=None, dataset_class=None):
    """Evaluate ``cfg.checkpoint_path`` on ``device`` (None: the CUDA
    device, and an error where there is none); returns the metrics."""
    device = resolve_device(device, "run_eval evaluates")
    check_single_device(cfg)

    test_ds, train_ds, norm_ds = build_eval_datasets(cfg, dataset_class)
    loader = DataLoader(test_ds, batch_size=int(cfg.test_batch_size),
                        num_workers=int(cfg.get("num_workers", 4)),
                        pad_last=True, pin_memory=device.type == "cuda")
    normalizer = build_normalizer(cfg.get("normalizer", "gaussian"), norm_ds)
    model = build_model(train_dataset=train_ds, device=device,
                        generator=make_generator(int(cfg.get("seed", 0))),
                        **model_kwargs(cfg))
    logging.info(f"Number of parameters: {param_count(model)}")
    if model.trainable:
        load_reference_or_orbax_checkpoint(cfg.checkpoint_path, model)
        logging.info(f"Checkpoint {cfg.checkpoint_path} loaded.")
    else:
        logging.info("Training-free model; no checkpoint loaded.")

    x_probe, y_probe = test_ds[0]
    unmeasured_c = infer_unmeasured_channels(y_probe[None])
    c = y_probe.shape[-1] - unmeasured_c
    para_c = max(0, x_probe.shape[-1] - y_probe.shape[-1])

    n_steps = int(cfg.N_autoregressive)
    rollout = (make_rollout_fn if model.trainable else make_host_rollout_fn)(
        model, normalizer, n_steps, para_c)

    pred_list, target_list, probe_errors, nmses = [], [], [], []
    batches = to_device(loader, device)
    try:
        for batch_idx, batch in enumerate(batches):
            x, y = batch[0], batch[1]
            n_real = int(batch[2].sum()) if len(batch) > 2 else x.shape[0]
            pred_norm, xn, yn = rollout(x, y)
            nmse, pred_phys, target_phys = finalize_rollout(
                normalizer, pred_norm, xn, yn, c
            )
            nmses.append(nmse)
            pred, target = pred_phys[:n_real], target_phys[:n_real]
            if batch_idx == 0 and int(cfg.get("N_plot", 0)) > 0:
                plot_result(pred, target, exp_path, int(cfg.N_plot), unmeasured_c)
            if cfg.get("probe_diagnostic"):
                kwargs = {}
                if batch_idx == 0:
                    kwargs = dict(N_plot=int(cfg.get("N_plot_probe", 0)),
                                  exp_path=exp_path)
                probe_errors.extend(
                    probe_diagnostic(pred, target, test_ds.d, test_ds.center_x,
                                     test_ds.center_y, test_ds.sub_s_real, **kwargs)
                )
            pred_list.append(pred)
            target_list.append(target)
    finally:
        batches.close()

    pred_all = torch.cat(pred_list)
    target_all = torch.cat(target_list)
    eval_bs = int(cfg.test_batch_size) if n_steps > 4 else pred_all.shape[0]
    vals = eval_metrics(pred_all, target_all, c, eval_bs)
    results = dict(zip(METRIC_NAMES, (float(v) for v in vals)))
    nmse_vals = torch.stack(nmses).tolist()
    results["normalized_mse"] = sum(nmse_vals) / max(len(nmse_vals), 1)

    logging.info(
        "Test results: "
        + ", ".join(f"{k}: {v:.5f}" for k, v in results.items())
    )
    if probe_errors:
        results["probe_error"] = float(np.mean(probe_errors))
        logging.info(f"Probe based diagnostic: {results['probe_error']:.5f}")
    return results


def main(argv=None, dataset_class=None):
    """Evaluate as the command line ``argv`` says; returns (exp_path,
    results). ``dataset_class`` as in ``train.__main__.main``."""
    parser = make_arg_parser("RealPDEBench (PyTorch) evaluation")
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--test_mode", type=str, default="all",
                        help="all | in_dist | out_dist | seen | unseen")
    cfg = parse_config(parser, argv)
    set_seed(int(cfg.get("seed", 0)))

    current_time = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    exp_path = os.path.join(cfg.get("results_path", "./results/"),
                            cfg.model_name, f"{cfg.exp_name}_eval", current_time)
    os.makedirs(exp_path, exist_ok=True)
    setup_logging(exp_path, is_train=False)
    logging.info(f"args: {cfg.to_dict()}")

    results = run_eval(cfg, exp_path, device=cfg.device, dataset_class=dataset_class)
    logging.info(f"Results saved at {exp_path}")
    return exp_path, results


if __name__ == "__main__":
    main()
