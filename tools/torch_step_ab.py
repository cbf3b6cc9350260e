#!/usr/bin/env python3
"""The bf16 FNO training steps of two checkouts timed on one card, to tell
whether a change moved them end to end.

    python3 tools/torch_step_ab.py PARENT_ROOT CHANGE_ROOT

From a host with a Hopper card and nvcc, each root a checkout (for example
a ``git archive`` of each commit unpacked into a git-ignored directory).
Runs parent, change, change, parent, each in a child process that imports
the package of its root and builds that root's kernels there (a fresh root
builds once). Each child times two steps of ``chip_smoke.py``'s cells
through ``make_train_step``, weights from ``make_generator(0)`` and data
from a seeded CUDA generator: the cylinder FNO3d (width 64, modes
4/12/16, batch 32, Adam at lr 1e-4, Identity normalizer) and the fsi FNO3d
(width 128, modes 4/16/16, batch 32, lr 0.01, the normalizer left out);
both bf16, 20x64x128x3 windows. Steps/s is the median of 5 windows of 10
steps (fsi: 3 of 2) after 2 warm-up steps, each window ending in a
synchronising ``loss.item()``. One JSON line a run: the root and the
steps/s of each window.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SHAPE = (20, 64, 128, 3)
CELLS = {
    "fno": (dict(modes1=4, modes2=12, modes3=16, width=64), 1e-4, 5, 10),
    "fsi_fno": (dict(modes1=4, modes2=16, modes3=16, width=128), 1e-2, 3, 2),
}


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from realpdebench_tpu_torch.data.normalizer import IdentityNormalizer
    from realpdebench_tpu_torch.models.registry import build_model
    from realpdebench_tpu_torch.ops import kernels
    from realpdebench_tpu_torch.train import build_optimizer, make_train_step
    from realpdebench_tpu_torch.utils.misc import make_generator

    kernels.library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(32, *SHAPE, generator=g, device=dev)
    y = torch.randn(32, *SHAPE, generator=g, device=dev)
    row = dict(root=root)
    for name, (kw, lr, windows, steps) in CELLS.items():
        model = build_model(shapes=(SHAPE, SHAPE), model_name="fno", n_layers=4,
                            compute_dtype="bfloat16", device=dev,
                            generator=make_generator(0), **kw)
        cfg = dict(lr=lr, scheduler="cosine", num_update=4000, clip_grad_norm=0.0)
        step = make_train_step(model, IdentityNormalizer(), build_optimizer(
            cfg, model.parameters()), grad_accum=1)
        for _ in range(2):
            step(x, y)
        rates = []
        for _ in range(windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                loss = step(x, y)
            loss.item()
            rates.append(steps / (time.perf_counter() - t0))
        row[name] = dict(steps_per_s=statistics.median(rates), windows=rates)
        del model, step
        torch.cuda.empty_cache()
    print(json.dumps(row), flush=True)


def main() -> None:
    if sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    parent, change = (str(Path(p).resolve()) for p in sys.argv[1:3])
    for root in (parent, change, change, parent):
        subprocess.run([sys.executable, __file__, "--child", root], check=True)


if __name__ == "__main__":
    main()
