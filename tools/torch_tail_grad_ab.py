#!/usr/bin/env python3
"""How far the f32 FNO training step's gradients move from the plain f32
step's with the tail kernels (K3F, K3B) in the variants named, or built
from a patched ``csrc/fno_tail.cu``: chip_smoke.py's ``train_f32`` step
(bench.py's cylinder FNO at batch 32, weights from make_generator(0), the
same seeded batch) once through make_train_step and once through the plain
f32 path; the loss's relative error and the four worst gradients' relative
L2 (the convs' biases left out: their true gradient is zero, chip_smoke.py
holds them to their scale).

    PYTHONPATH=. python3 tools/torch_tail_grad_ab.py [--k3f V] [--k3b V] [OLD NEW ...]

From the repository root on a host with a Hopper card and nvcc. OLD NEW
pairs patch a copy of csrc/ (fno_tail.cu, each OLD found once) under
build/tail_grad_ab/, which the kernels are then built from. One JSON line.
"""

import argparse
import json
import shutil

import torch

import chip_smoke as cs
from realpdebench_tpu_torch.data.normalizer import IdentityNormalizer
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.ops import fno_tail as ft
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator


def patched_csrc(pairs) -> None:
    """Point the kernel build at a copy of csrc/ with fno_tail.cu patched."""
    src = kernels.BUILD_DIR.parent / "tail_grad_ab" / "csrc"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(kernels.CSRC, src)
    f = src / "fno_tail.cu"
    text = f.read_text()
    for old, new in zip(pairs[::2], pairs[1::2]):
        if text.count(old) != 1:
            raise SystemExit(f"torch_tail_grad_ab: {text.count(old)} copies of {old!r}")
        text = text.replace(old, new)
    f.write_text(text)
    kernels.CSRC = src


def named(fn, variant):
    return (lambda *a, **kw: fn(*a, **kw, variant=variant)) if variant else fn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k3f")
    ap.add_argument("--k3b")
    ap.add_argument("patch", nargs="*")
    args = ap.parse_args()
    if len(args.patch) % 2:
        raise SystemExit("torch_tail_grad_ab: patches come as OLD NEW pairs")
    if args.patch:
        patched_csrc(args.patch)
    card = cs.phase_env()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    ft.k3f, ft.k3b = named(ft.k3f, args.k3f), named(ft.k3b, args.k3b)
    shapes = (cs.SHAPE_IN, cs.SHAPE_OUT)
    g = torch.Generator(device=dev).manual_seed(4)   # phase_train's batch
    x = torch.randn(cs.TRAIN_BATCH, *cs.SHAPE_IN, generator=g, device=dev)
    y = torch.randn(cs.TRAIN_BATCH, *cs.SHAPE_OUT, generator=g, device=dev)
    model = build_model(shapes=shapes, compute_dtype=None, device=dev,
                        generator=make_generator(0), **cs.MODEL)
    ref_model = build_model(shapes=shapes, device=dev, **cs.MODEL)
    ref_model.load_state_dict(model.state_dict(), strict=True)
    opt = build_optimizer(cs.TRAIN_CFG, model.parameters())
    loss = make_train_step(model, IdentityNormalizer(), opt, grad_accum=1)(x, y)
    grads = cs._grads(model)
    ref_model.train()
    ref_loss = ref_model(x, y=y, reference=True)
    ref_loss.backward()
    ref = cs._grads(ref_model)
    worst = sorted(((cs._rel_l2(grads[n], ref[n]), n) for n in grads
                    if not (n.startswith("convs.") and n.endswith(".bias"))), reverse=True)[:4]
    cs.emit(dict(tool="torch_tail_grad_ab", card=card, k3f=args.k3f or "chosen",
                 k3b=args.k3b or "chosen", patch=args.patch, variants=kernels.VARIANTS,
                 loss_rel=abs(loss.item() - ref_loss.item()) / abs(ref_loss.item()),
                 worst_grad_rel_l2=[[n, r] for r, n in worst]))


if __name__ == "__main__":
    main()
