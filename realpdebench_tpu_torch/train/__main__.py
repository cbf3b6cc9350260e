"""`python -m realpdebench_tpu_torch.train --config ... --train_data_type ...`

Counterpart of ``realpdebench_tpu/train/__main__.py``, CLI-compatible with
the reference trainer (`realpdebench/train.py`), plus ``--device`` and
``--key value`` config overrides (``config.parse_config``)."""

import datetime
import logging
import os

from realpdebench_tpu_torch.config import make_arg_parser, parse_config
from realpdebench_tpu_torch.train.loop import run_training
from realpdebench_tpu_torch.utils.misc import set_seed, setup_logging


def main(argv=None, dataset_class=None):
    """Train as the command line ``argv`` says; returns (exp_path, model,
    optimizer, history).
    ``dataset_class`` replaces the scenario's dataset class (in-memory
    trees, ``data.fluid.with_arrays``)."""
    cfg = parse_config(make_arg_parser("RealPDEBench (PyTorch) training"), argv)
    set_seed(int(cfg.get("seed", 0)))

    current_time = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    exp_path = os.path.join(
        cfg.get("results_path", "./results/"),
        cfg.model_name,
        f"{cfg.exp_name}_{cfg.train_data_type}_{bool(cfg.get('is_finetune'))}",
        current_time,
    )
    os.makedirs(exp_path, exist_ok=True)

    writer = setup_logging(exp_path, bool(cfg.get("is_use_tb")))
    if writer is not None:
        for key, value in cfg.to_dict().items():
            writer.add_text(key, str(value), 0)
    logging.info(f"args: {cfg.to_dict()}")

    model, optimizer, history = run_training(cfg, exp_path, writer=writer,
                                             device=cfg.device,
                                             dataset_class=dataset_class)
    logging.info(f"Results saved at {exp_path}")
    if writer is not None:
        writer.close()
    return exp_path, model, optimizer, history


if __name__ == "__main__":
    main()
