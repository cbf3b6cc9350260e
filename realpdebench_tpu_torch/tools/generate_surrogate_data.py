"""Offline surrogate rollout: a trained surrogate over full numerical
trajectories → ``{root}/combustion/surrogate/*.h5``, the channel that
CombustionDataset's numerical branch reads.

Counterpart of ``realpdebench_tpu/tools/generate_surrogate_data.py``
(reference ``realpdebench/data/generate_surrogate_data.py:42-98``). The
surrogate's input is the 15 numerical fields plus the gas-ratio and
equivalence-ratio planes; its output the predicted observed channel. A
trajectory is predicted in windows of ``step`` frames; a trailing partial
window is predicted as the last full window and only its tail kept
(``surrogate_trajectory``, over one trajectory's arrays; the files are
read and written around it). The checkpoint is the port's own (a
``ckpt`` directory of ``checkpoint_<step>.pth`` or one ``.pth``).

Usage:
    python -m realpdebench_tpu_torch.tools.generate_surrogate_data \
        --dataset-root ./datasets --checkpoint ./results/.../ckpt \
        --config configs/combustion/surrogate_model/fno.yaml [--step 10]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def surrogate_trajectory(predict, inp: np.ndarray, step: int) -> np.ndarray:
    """One trajectory's surrogate channel [T, H, W] from its 17-channel
    input [T, H, W, 17]: ``predict`` maps a window [1, step, H, W, 17] to
    [1, step, H, W, 1]; the trailing partial window is the last full one,
    its tail kept."""
    T = inp.shape[0]
    preds = [predict(inp[s:s + step][None])[0, ..., 0] for s in range(0, T - step + 1, step)]
    rem = T - (T // step) * step
    if rem > 0:
        preds.append(predict(inp[T - step:][None])[0, -rem:, ..., 0])
    out = np.concatenate(preds, axis=0)
    assert out.shape[0] == T, (out.shape, T)
    return out


def surrogate_predictor(model, normalizer, device):
    """numpy window → numpy prediction in physical units, through the
    normalizer, on ``device``."""
    def predict(window: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(window)).to(device)
        xn, _ = normalizer.preprocess(x, x[..., :1])
        _, pred = normalizer.postprocess(xn, model.predict(xn))
        return pred.float().cpu().numpy()

    return predict


def generate(dataset_root, checkpoint_path, cfg, step=10, batch_size=8, sub_s=1,
             n_sim_frame=40, device=None):
    """Write ``combustion/surrogate/<sim>.h5`` for every numerical
    trajectory, from the surrogate in ``checkpoint_path`` (the port's
    checkpoints) with the config ``cfg``; the normalizer's statistics from
    the surrogate-train pairs, as in training. ``batch_size`` is the JAX
    signature's and unused there too."""
    import h5py

    from realpdebench_tpu_torch.data.normalizer import GaussianNormalizer
    from realpdebench_tpu_torch.data.surrogate import SurrogateDataset, with_param_planes
    from realpdebench_tpu_torch.models.registry import build_model, resolve_device
    from realpdebench_tpu_torch.train.loop import (
        load_reference_or_orbax_checkpoint,
        model_kwargs,
    )

    device = resolve_device(device, "generate predicts")
    num_dir = os.path.join(dataset_root, "combustion", "numerical")
    out_dir = os.path.join(dataset_root, "combustion", "surrogate")
    os.makedirs(out_dir, exist_ok=True)
    norm_ds = SurrogateDataset("combustion", dataset_root, "train", step=step,
                               n_sim_frame=n_sim_frame)
    normalizer = GaussianNormalizer(norm_ds, is_save=False)
    x0, _ = norm_ds[0]
    model = build_model(shapes=((step, *x0.shape[1:3], 17), (step, *x0.shape[1:3], 1)),
                        device=device, **model_kwargs(cfg))
    load_reference_or_orbax_checkpoint(checkpoint_path, model)
    predict = surrogate_predictor(model, normalizer, device)

    for fn in sorted(os.listdir(num_dir)):
        if not fn.endswith(".h5"):
            continue
        with h5py.File(os.path.join(num_dir, fn), "r") as f:
            num = np.asarray(f["measured_data"][:, ::sub_s, ::sub_s], np.float32)
        surrogate = surrogate_trajectory(predict, with_param_planes(num, fn), step)
        with h5py.File(os.path.join(out_dir, fn), "w") as f:
            f.create_dataset("measured_data", data=surrogate)
        print(f"{fn}: surrogate {surrogate.shape} written")


def main(argv=None):
    from realpdebench_tpu_torch.config import load_config

    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-root", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", required=True)
    parser.add_argument("--step", type=int, default=10)
    parser.add_argument("--sub-s", type=int, default=1)
    parser.add_argument("--n-sim-frame", type=int, default=40)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    generate(args.dataset_root, args.checkpoint, load_config(args.config), step=args.step,
             sub_s=args.sub_s, n_sim_frame=args.n_sim_frame, device=args.device)


if __name__ == "__main__":
    main()
