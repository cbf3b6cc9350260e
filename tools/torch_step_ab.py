#!/usr/bin/env python3
"""The bf16 training steps and rollouts of two checkouts timed on one card,
to tell whether a change moved them end to end.

    python3 tools/torch_step_ab.py PARENT_ROOT CHANGE_ROOT

From a host with a Hopper card and nvcc, each root a checkout (for example
a ``git archive`` of each commit unpacked into a git-ignored directory).
Runs parent, change, change, parent, each in a child process that imports
the package of its root and builds that root's kernels there (a fresh root
builds once). Each child times ``chip_smoke.py``'s cells, weights from
``make_generator(0)`` (fsi: 1), data from a seeded CUDA generator, all bf16
at 20x64x128x3 windows:

  steps (``make_train_step``, Adam, cosine schedule, no clipping): the
    cylinder FNO3d (width 64, modes 4/12/16, batch 32, lr 1e-4, Identity
    normalizer), the fsi FNO3d (width 128, modes 4/16/16, batch 32, lr
    0.01, the normalizer left out), the UNet3d (dim_mults 1/2/4, batch 12,
    lr 1e-4) and the Galerkin Transformer (width 256, 4 heads, batch 16, lr
    0.01), the last two with chip_smoke.py's seeded Gaussian normalizer.
    Steps/s is the median of windows of steps after 2 warm-up steps, each
    window ending in a synchronising ``loss.item()``.
  rollouts (``make_rollout_fn``): FNO at batch 8 over 10 steps, the UNet
    at batch 12 over 5, the Galerkin Transformer at batch 16 over 1;
    frames/s is the median of 5 (GK: 10) after one run.

One JSON line a run: the root, and each cell's rate with its windows.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SHAPE = (20, 64, 128, 3)
FNO = dict(model_name="fno", n_layers=4, modes1=4, modes2=12, modes3=16, width=64)
UNET = dict(model_name="unet", dim_mults=[1, 2, 4])
GK = dict(model_name="galerkin_transformer", n_hidden=256, num_encoder_layers=1, n_head=4,
          dim_feedforward=256, attention_type="galerkin", layer_norm=False, attn_norm=True,
          norm_eps=1e-7, fourier_modes_x=16, fourier_modes_y=20, fourier_modes_t=4,
          num_regressor_layers=1, freq_dim=128, encoder_dropout=0.05, xavier_init=0.01,
          diagonal_weight=0.01, seed=0)
# name: (model kwargs, weight seed, batch, lr, normalizer, windows, steps a window)
STEPS = {
    "fno": (FNO, 0, 32, 1e-4, "identity", 5, 10),
    "fsi_fno": (dict(FNO, modes2=16, width=128), 1, 32, 1e-2, "identity", 3, 2),
    "unet": (UNET, 0, 12, 1e-4, "gaussian", 5, 5),
    "gk": (GK, 0, 16, 1e-2, "gaussian", 5, 3),
}
# name: (model kwargs, batch, rollout steps, normalizer, timed runs)
ROLLOUTS = {
    "fno_rollout": (FNO, 8, 10, "identity", 5),
    "unet_rollout": (UNET, 12, 5, "gaussian", 5),
    "gk_rollout": (GK, 16, 1, "gaussian", 10),
}


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from realpdebench_tpu_torch.data.normalizer import IdentityNormalizer, build_normalizer
    from realpdebench_tpu_torch.eval.rollout import make_rollout_fn
    from realpdebench_tpu_torch.models.registry import build_model
    from realpdebench_tpu_torch.ops import kernels
    from realpdebench_tpu_torch.train import build_optimizer, make_train_step
    from realpdebench_tpu_torch.utils.misc import make_generator

    def normalizer(kind):
        if kind == "identity":
            return IdentityNormalizer()
        r = np.random.default_rng(0)   # chip_smoke.gaussian_normalizer
        mean, std = r.normal(size=3), r.uniform(0.5, 2.0, size=3)
        return build_normalizer("gaussian", stats=dict(
            mean_inputs=mean, mean_targets=mean, std_inputs=std, std_targets=std))

    def model_of(kw, seed):
        return build_model(shapes=(SHAPE, SHAPE), compute_dtype="bfloat16", device=dev,
                           generator=make_generator(seed), **kw)

    kernels.library()
    dev = torch.device("cuda", 0)
    row = dict(root=root)
    for name, (kw, seed, batch, lr, norm, windows, steps) in STEPS.items():
        g = torch.Generator(device=dev).manual_seed(4)
        x = torch.randn(batch, *SHAPE, generator=g, device=dev)
        y = torch.randn(batch, *SHAPE, generator=g, device=dev)
        model = model_of(kw, seed)
        cfg = dict(lr=lr, scheduler="cosine", num_update=4000, clip_grad_norm=0.0)
        step = make_train_step(model, normalizer(norm), build_optimizer(
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
        del model, step, x, y
        torch.cuda.empty_cache()
    for name, (kw, batch, n, norm, runs) in ROLLOUTS.items():
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn(batch, *SHAPE, generator=g, device=dev)
        y = torch.randn(batch, SHAPE[0] * n, *SHAPE[1:], generator=g, device=dev)
        model = model_of(kw, 0).eval()
        rollout = make_rollout_fn(model, normalizer(norm), n)
        rollout(x, y)
        secs = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rollout(x, y)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        frames = batch * n * SHAPE[0]
        row[name] = dict(frames_per_s=frames / statistics.median(secs),
                         runs=[frames / t for t in secs])
        del model, rollout, x, y
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
