"""`python -m realpdebench_tpu_torch parity` — the port's evaluation beside the
reference PyTorch package's, on one checkpoint.

Counterpart of ``realpdebench_tpu/eval/parity.py``. A reference checkpoint
(``{"model_state_dict": ...}``, the reference's train.py:410-418 layout)
is evaluated

  (a) through the port: ``eval.__main__.run_eval`` (the rollout on the
      card unless ``--device cpu``, the 13-metric sweep), and
  (b) through the reference ``realpdebench`` model itself, on the CPU, when
      that package is importable: the SAME test batches, the SAME
      normalizer statistics and the SAME metric code (the reference's
      eval.py:296-322 rollout: normalizer round trips, control channels
      put back after every step),

and the two metric sets are printed side by side with their relative
deviation, and written to ``parity.json``:

    python -m realpdebench_tpu_torch parity --config cylinder/fno.yaml \\
        --checkpoint_path model.pth --dataset_root /data ...

The reference package is looked for as an importable ``realpdebench``,
then under the directory ``$REALPDEBENCH_REF`` names. Where neither
holds it, or its run fails, the report carries ``torch_error`` and no
reference column.
"""

from __future__ import annotations

import datetime
import importlib
import json
import logging
import os
import sys

import numpy as np
import torch

from realpdebench_tpu_torch.config import make_arg_parser, parse_config
from realpdebench_tpu_torch.data.loader import DataLoader
from realpdebench_tpu_torch.data.normalizer import build_normalizer
from realpdebench_tpu_torch.eval.metrics import METRIC_NAMES, eval_metrics, infer_unmeasured_channels
from realpdebench_tpu_torch.utils.misc import set_seed, setup_logging

PORT, REFERENCE = "port", "torch"


def import_reference():
    """The reference ``realpdebench`` package: importable as it is, or from
    the directory ``$REALPDEBENCH_REF``; None where neither holds it."""
    try:
        return importlib.import_module("realpdebench")
    except ImportError:
        pass
    root = os.environ.get("REALPDEBENCH_REF")
    if root and os.path.isdir(os.path.join(root, "realpdebench")):
        if root not in sys.path:
            sys.path.insert(0, root)
        try:
            return importlib.import_module("realpdebench")
        except ImportError:
            return None
    return None


def run_reference_eval(cfg, normalizer, test_loader, train_ds, c: int, para_c: int) -> dict:
    """The reference torch model on the CPU over ``test_loader``'s batches:
    the reference's rollout (eval.py:296-322), padded rows dropped, then
    the port's metric sweep."""
    from realpdebench.model.load_model import load_model

    kwargs = dict(cfg.to_dict())
    kwargs["device"] = "cpu"
    model = load_model(train_ds, **kwargs)
    model.load_checkpoint(cfg.checkpoint_path, torch.device("cpu"))
    model.eval()

    n_steps = int(cfg.N_autoregressive)
    preds, targets, nmses = [], [], []
    with torch.no_grad():
        for batch in test_loader:
            x, y = (torch.as_tensor(np.asarray(t), dtype=torch.float32) for t in batch[:2])
            n_real = int(batch[2].sum()) if len(batch) > 2 else x.shape[0]
            para_input = x[..., x.shape[-1] - para_c:] if para_c else None
            xn, yn = normalizer.preprocess(x, y)
            window, steps = xn, []
            for _ in range(n_steps):
                p = model(window.contiguous())
                _, p_phys = normalizer.postprocess(window[..., : p.shape[-1]], p)
                if para_c:
                    p_phys = torch.cat([p_phys, para_input], dim=-1)
                window, _ = normalizer.preprocess(p_phys, yn)
                steps.append(window)
            pred_norm = torch.cat(steps, dim=1)
            if para_c:
                pred_norm = pred_norm[..., :-para_c]
            nmses.append(float(torch.mean((pred_norm[..., :c] - yn[..., :c]) ** 2)))
            _, pred_phys = normalizer.postprocess(xn, pred_norm)
            _, target_phys = normalizer.postprocess(xn, yn)
            preds.append(pred_phys[:n_real])
            targets.append(target_phys[:n_real])
    pred_all, target_all = torch.cat(preds), torch.cat(targets)
    eval_bs = int(cfg.test_batch_size) if n_steps > 4 else pred_all.shape[0]
    out = dict(zip(METRIC_NAMES, (float(v) for v in eval_metrics(pred_all, target_all, c,
                                                                 eval_bs))))
    out["normalized_mse"] = sum(nmses) / max(len(nmses), 1)
    return out


def parity_table(port: dict, reference: dict | None) -> str:
    lines = [f"{'metric':<22}{PORT:>14}{REFERENCE:>14}{'rel_dev':>10}"]
    for k in ["normalized_mse"] + list(METRIC_NAMES):
        a = port.get(k)
        b = (reference or {}).get(k)
        if a is None:
            continue
        if b is None:
            lines.append(f"{k:<22}{a:>14.6f}{'-':>14}{'-':>10}")
        else:
            dev = abs(a - b) / max(abs(b), 1e-12)
            lines.append(f"{k:<22}{a:>14.6f}{b:>14.6f}{dev:>10.4f}")
    return "\n".join(lines)


def run_parity(cfg, exp_path: str, device=None, dataset_class=None) -> dict:
    """(a) the port's eval on ``device`` (None: the card), (b) the
    reference's on the CPU where importable; prints the table and the
    JSON report, writes ``parity.json``, returns the report."""
    from realpdebench_tpu_torch.eval.__main__ import build_eval_datasets, run_eval

    results_port = run_eval(cfg, exp_path, device=device, dataset_class=dataset_class)
    results_ref, err = None, None
    if import_reference() is None:
        err = "reference `realpdebench` package not importable"
    else:
        try:
            test_ds, train_ds, norm_ds = build_eval_datasets(cfg, dataset_class)
            loader = DataLoader(test_ds, batch_size=int(cfg.test_batch_size),
                                num_workers=int(cfg.get("num_workers", 4)), pad_last=True)
            normalizer = build_normalizer(cfg.get("normalizer", "gaussian"), norm_ds)
            x_probe, y_probe = test_ds[0]
            c = y_probe.shape[-1] - infer_unmeasured_channels(y_probe[None])
            para_c = max(0, x_probe.shape[-1] - y_probe.shape[-1])
            results_ref = run_reference_eval(cfg, normalizer, loader, train_ds, c, para_c)
        except Exception as e:  # the reference side is diagnostics: report, go on
            err = f"{type(e).__name__}: {e}"
            logging.exception("reference torch eval failed")

    report = {PORT: results_port, REFERENCE: results_ref}
    if err:
        report["torch_error"] = err
    table = parity_table(results_port, results_ref)
    logging.info("Parity table:\n" + table)
    print(table)
    print(json.dumps(report))
    with open(os.path.join(exp_path, "parity.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    return report


def main(argv=None, dataset_class=None):
    """Run the comparison as the command line ``argv`` says; returns
    (exp_path, report)."""
    parser = make_arg_parser("RealPDEBench (PyTorch) reference-parity evaluation")
    parser.add_argument("--checkpoint_path", type=str, required=True,
                        help="reference .pth (or a directory of the port's checkpoints)")
    parser.add_argument("--test_mode", type=str, default="all",
                        help="all | in_dist | out_dist | seen | unseen")
    cfg = parse_config(parser, argv)
    set_seed(int(cfg.get("seed", 0)))
    current_time = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    exp_path = os.path.join(cfg.get("results_path", "./results/"), cfg.model_name,
                            f"{cfg.exp_name}_parity", current_time)
    os.makedirs(exp_path, exist_ok=True)
    setup_logging(exp_path, is_train=False)
    logging.info(f"args: {cfg.to_dict()}")
    return exp_path, run_parity(cfg, exp_path, device=cfg.device,
                                dataset_class=dataset_class)


if __name__ == "__main__":
    main()
