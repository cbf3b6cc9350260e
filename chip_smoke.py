#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root on a host with a Hopper card and nvcc. Phases, one
JSON line each; any failure raises (non-zero exit, no result line):

  1. env     torch/CUDA versions and the card (plus nvidia-smi's name and
             power limit on a line of its own).
  2. build   nvcc builds the kernels of realpdebench_tpu_torch/csrc (or finds
             them built).
  3. kernel  K1, the T-stage (et, it) and K2 against their plain twins on the
             card at the full rollout width (B·Tp=208, Hp=70, Wp=134, C=64,
             modes 4/12/16), in float32 and bfloat16; CUDA-event medians of
             kernel and twin.
  4. slice   the cylinder FNO3d at the benchmark configuration (width 64,
             4 layers, bf16 compute, seeded random weights) rolled out 10
             steps at batch 8 through make_rollout_fn; the launch counters
             prove the kernels ran; compared with the same rollout through
             the plain f32 path on the card; rollout frames/s.
Then the per-kernel summary line, and the last line
{"ok": true, "device": {...}}.

The port imports neither JAX nor the JAX package; neither does this script.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

from realpdebench_tpu_torch.data.normalizer import IdentityNormalizer
from realpdebench_tpu_torch.eval.rollout import make_rollout_fn
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.ops import fno_layer as fl
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.utils.misc import make_generator

# the benchmark's rollout (bench.py): eval batch 8, 10 steps, 20x64x128x3
BATCH, STEPS = 8, 10
SHAPE_IN = SHAPE_OUT = (20, 64, 128, 3)
MODEL = dict(model_name="fno", modes1=4, modes2=12, modes3=16, n_layers=4,
             width=64)
PAD = 6
TP, HP, WP = (n + PAD for n in SHAPE_IN[:3])
C, M1, M2, M3 = MODEL["width"], MODEL["modes1"], MODEL["modes2"], MODEL["modes3"]

# kernel vs twin, as max|Δ| / max|ref|. f32: both sides accumulate in f32 in
# another order. bf16: both compute in f32 from the same bf16 inputs and
# round once, so they differ by at most one bf16 step (2^-8 relative).
# Statistics (f32 on both sides, from the unrounded s): relative to the sum
# of |terms| per channel, for f32 partial sums over ~2M positions.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
STATS_TOL = 1e-4
# bf16 kernel rollout vs f32 plain rollout over 10 autoregressive steps:
# relative L2 error of the whole prediction, and max|Δ| / max|ref|.
ROLLOUT_REL_L2 = 5e-2
ROLLOUT_MAX = 1e-1

SOURCES = {
    "k1": ("realpdebench_tpu_torch/csrc/fno_k1.cu",
           "realpdebench_tpu/ops/pallas/fno_layer.py:331"),
    "t_stage": ("realpdebench_tpu_torch/csrc/fno_tstage.cu",
                "realpdebench_tpu/ops/pallas/fno_layer.py:1161"),
    "k2": ("realpdebench_tpu_torch/csrc/fno_k2.cu",
           "realpdebench_tpu/ops/pallas/fno_layer.py:393"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` launches of ``fn`` timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def compare(name, got, ref, tol) -> dict:
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    rel = err / scale
    row = dict(name=name, max_abs_err=err, limit_abs=tol * scale,
               max_rel_err=rel, limit_rel=tol)
    if not rel <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its twin: {row}")
    return row


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit(dict(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
              python=sys.version.split()[0], device=name,
              device_count=torch.cuda.device_count(),
              capability=list(torch.cuda.get_device_capability(0)),
              nvidia_smi=smi))
    print(smi, flush=True)
    # the plain twins are the reference: full f32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    path, compile_s = kernels.build()
    kernels.library()
    emit(dict(phase="build", library=path.name, compile_s=compile_s,
              total_s=time.perf_counter() - t0))


def phase_kernels(dev) -> dict:
    """Each kernel against its twin at the rollout width; returns per-kernel
    summaries (bf16 errors and times: the dtype of the main path)."""
    B = BATCH
    BT = B * TP
    summary = {k: dict(max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0)
               for k in SOURCES}
    cst = fl._ct_on(dev, HP, WP, M2, M3)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(1)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        x = rn(BT, HP * WP // 2, 2 * C).to(dtype)
        a, b = 1 + 0.1 * rn(C), 0.1 * rn(C)
        wp, bp = rn(C, C) / C ** 0.5, 0.1 * rn(C)
        tol = KERNEL_TOL[dtype]
        rows, times = [], {}
        for act in ("none", "exact"):
            k1 = lambda: fl.k1(x, a, b, Hp=HP, Wp=WP, m2=M2, m3=M3, act=act)
            k1p = lambda: fl.k1_plain(x, a, b, cst, Hp=HP, Wp=WP, act=act)
            y = k1()
            rows.append(compare(f"k1/{act}", y, k1p(), tol))
            mats = {k: fl._tmats_on(dev, k, TP, M1) for k in ("et", "it")}
            ins = {"et": y, "it": y[: B * 2 * M1].contiguous()}
            for kind in ("et", "it"):
                rows.append(compare(
                    f"t_stage/{kind}/{act}", fl.t_stage(ins[kind], kind, TP, M1),
                    fl.t_stage_plain(ins[kind], *mats[kind]), tol))
            gsp = fl.t_stage(fl.t_stage(y, "et", TP, M1), "it", TP, M1)
            k2 = lambda: fl.k2(gsp, x, a, b, wp, bp, Hp=HP, Wp=WP, m2=M2, m3=M3,
                               act=act)
            k2p = lambda: fl.k2_plain(gsp, x, a, b, wp, bp, cst, Hp=HP, Wp=WP,
                                      act=act)
            (s, st), (s_ref, st_ref) = k2(), k2p()
            rows.append(compare(f"k2/s/{act}", s, s_ref, tol))
            sr = s_ref.float().view(-1, C)
            terms = torch.stack([sr.abs().sum(0), (sr * sr).sum(0)])
            st_rel = ((st - st_ref).abs() / terms).max().item()
            rows.append(dict(name=f"k2/stats/{act}", max_rel_err=st_rel,
                             limit_rel=STATS_TOL,
                             max_abs_err=(st - st_ref).abs().max().item()))
            if not st_rel <= STATS_TOL:
                raise AssertionError(f"k2 statistics disagree: {rows[-1]}")
            if act == "exact":   # layers 1.. of the path; layer 0 is 'none'
                times = dict(
                    k1=(cuda_ms(k1), cuda_ms(k1p)),
                    t_stage_et=(cuda_ms(lambda: fl.t_stage(y, "et", TP, M1)),
                                cuda_ms(lambda: fl.t_stage_plain(y, *mats["et"]))),
                    t_stage_it=(cuda_ms(lambda: fl.t_stage(ins["it"], "it", TP, M1)),
                                cuda_ms(lambda: fl.t_stage_plain(ins["it"], *mats["it"]))),
                    k2=(cuda_ms(k2), cuda_ms(k2p)))
        torch.cuda.synchronize()
        emit(dict(phase="kernel", dtype=str(dtype).replace("torch.", ""),
                  shapes=dict(BT=BT, Hp=HP, Wp=WP, C=C, modes=[M1, M2, M3]),
                  checks=rows, ms={k: dict(kernel=v[0], plain=v[1])
                                   for k, v in times.items()}))
        if dtype == torch.bfloat16:
            for k in SOURCES:
                mine = [r for r in rows
                        if r["name"].startswith(k) and "/stats/" not in r["name"]]
                for key in ("max_abs_err", "max_rel_err"):
                    summary[k][key] = max(r[key] for r in mine)
            summary["k1"]["ms"], summary["k1"]["plain_ms"] = times["k1"]
            summary["k2"]["ms"], summary["k2"]["plain_ms"] = times["k2"]
            # one layer's T-stage: one 'et' and one 'it' launch
            summary["t_stage"]["ms"] = times["t_stage_et"][0] + times["t_stage_it"][0]
            summary["t_stage"]["plain_ms"] = (times["t_stage_et"][1]
                                              + times["t_stage_it"][1])
    return summary


class _PlainPath:
    """The same model with every layer through the plain oracle."""

    def __init__(self, model):
        self.model = model

    def predict(self, x):
        with torch.inference_mode():
            return self.model(x, reference=True)


def phase_slice(dev) -> dict:
    model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), compute_dtype="bfloat16",
                        device=dev, generator=make_generator(0), **MODEL).eval()
    g = torch.Generator(device=dev).manual_seed(2)
    x_raw = torch.randn(BATCH, *SHAPE_IN, generator=g, device=dev)
    y_raw = torch.randn(BATCH, SHAPE_OUT[0] * STEPS, *SHAPE_OUT[1:],
                        generator=g, device=dev)
    rollout = make_rollout_fn(model, IdentityNormalizer(), STEPS)

    # the main path, counted: nothing but this run between reset and read
    kernels.reset_launches()
    t0 = time.perf_counter()
    pred, _, _ = rollout(x_raw, y_raw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    per_predict = {"k1": MODEL["n_layers"], "k2": MODEL["n_layers"],
                   "t_stage": 2 * MODEL["n_layers"]}
    for k, n in per_predict.items():
        if launches[k] != n * STEPS:
            raise AssertionError(f"{k} launched {launches[k]} times in a "
                                 f"{STEPS}-step rollout, expected {n * STEPS}")

    want = (BATCH, STEPS * SHAPE_OUT[0], *SHAPE_OUT[1:])
    if tuple(pred.shape) != want or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"rollout output {tuple(pred.shape)} (want {want}) "
                             "or not finite")

    ref_model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), device=dev,
                            **MODEL).eval()
    ref_model.load_state_dict(model.state_dict(), strict=True)
    ref, _, _ = make_rollout_fn(_PlainPath(ref_model), IdentityNormalizer(),
                                STEPS)(x_raw, y_raw)
    rel_l2 = ((pred - ref).norm() / ref.norm()).item()
    max_rel = ((pred - ref).abs().max() / ref.abs().max()).item()
    row = dict(rel_l2=rel_l2, limit_rel_l2=ROLLOUT_REL_L2,
               max_abs_over_max_ref=max_rel, limit_max=ROLLOUT_MAX,
               ref_abs_max=ref.abs().max().item())
    if not (rel_l2 <= ROLLOUT_REL_L2 and max_rel <= ROLLOUT_MAX):
        raise AssertionError(f"bf16 kernel rollout vs f32 plain rollout: {row}")

    secs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rollout(x_raw, y_raw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    frames = BATCH * STEPS * SHAPE_OUT[0]
    emit(dict(phase="slice", batch=BATCH, steps=STEPS, shape=list(want),
              launches=launches, vs_plain_f32=row, first_rollout_s=first_s,
              rollout_s=secs, frames_per_s=frames / med,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    return launches


def main() -> None:
    name = phase_env()
    dev = torch.device("cuda", 0)
    phase_build()
    summary = phase_kernels(dev)
    launches = phase_slice(dev)
    emit({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k][0], replaces=SOURCES[k][1],
             launches=launches[k], **summary[k]) for k in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
