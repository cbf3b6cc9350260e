#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py


From the repository root on a host with a Hopper card and nvcc. Phases, one
JSON line each; any failure raises (non-zero exit, no result line):

  1. env       torch/CUDA versions and the card (plus nvidia-smi's name and
               power limit on a line of its own).
  2. build     nvcc builds the kernels of realpdebench_tpu_torch/csrc (or
               finds them built).
  3. kernel    the forward kernels K1, the T-stage (et, it) and K2 against
               their plain twins on the card at the full rollout width
               (B·Tp=208, Hp=70, Wp=134, C=64, modes 4/12/16), in float32
               and bfloat16; CUDA-event medians of kernel and twin.
  4. backward  the backward and tail kernels, K2A-lite, K2A, K12B, the
               T-stage adjoints (et_adj, it_adj), K3F and K3B, against
               their twins at the training width (B·Tp=832: the f32 twins
               fit the card's memory), in float32 and bfloat16; K2A-lite
               against K2A; CUDA-event medians.
  5. slice     the cylinder FNO3d at the benchmark configuration (width 64,
               4 layers, bf16 compute, seeded random weights) rolled out 10
               steps at batch 8 through make_rollout_fn; the launch counters
               prove the kernels ran; compared with the same rollout through
               the plain f32 path on the card; rollout frames/s.
  6. train     bench.py's training step (batch 32, Adam at lr 1e-4, cosine
               over 4000 updates, no clipping, Identity normalizer) through
               make_train_step: one counted step (exact launch counts),
               compared with the same step from the same weights through
               the plain f32 path with autograd (loss, every gradient, the
               running statistics); two more forward-backward passes equal
               bit for bit; 2 warm-up steps and 5 windows of 10 steps:
               median steps/s, loss, peak memory.
  7. profile   torch.profiler over three more training steps: device time
               by kernel, the host's wall time, the device's idle share.
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
from realpdebench_tpu_torch.ops import fno_tail as ft
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.activations import gelu, gelu_grad
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

# the benchmark's rollout (bench.py): eval batch 8, 10 steps, 20x64x128x3
BATCH, STEPS = 8, 10
SHAPE_IN = SHAPE_OUT = (20, 64, 128, 3)
MODEL = dict(model_name="fno", modes1=4, modes2=12, modes3=16, n_layers=4,
             width=64)
PAD = 6
TP, HP, WP = (n + PAD for n in SHAPE_IN[:3])
C, M1, M2, M3 = MODEL["width"], MODEL["modes1"], MODEL["modes2"], MODEL["modes3"]
# the benchmark's training step (bench.py): batch 32, Adam, cosine schedule
TRAIN_BATCH = 32
TRAIN_CFG = dict(lr=1e-4, scheduler="cosine", num_update=4000, clip_grad_norm=0.0)
WARMUP, WINDOWS, WINDOW_STEPS = 2, 5, 10

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
# bf16 kernel training step vs the f32 plain step from the same weights over
# 4 layers (fixed before the first run): the loss relative to the plain
# loss; each gradient and each running-statistics vector as relative L2.
# The conv biases' true gradient is 0 (the BatchNorm after each layer
# cancels them): both sides' largest |gradient| is held to 1e-2 of the
# largest gradient of the same layer's pointwise weight.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_STATS_REL_L2 = 2e-2
TRAIN_ZERO_GRAD = 1e-2
# per training step: 4 layers forward (K1, 2 T-stages, K2) and backward
# (K2A-lite, 2 T-stage adjoints, K12B), one fused tail + loss
TRAIN_LAUNCHES = {"k1": 4, "t_stage": 16, "k2": 4, "k2a": 0, "k2a_lite": 4,
                  "k12b": 4, "k3f": 1, "k3b": 1}

_PALLAS = "realpdebench_tpu/ops/pallas/"
SOURCES = {
    "k1": ("fno_k1.cu", "fno_layer.py:331"),
    "t_stage": ("fno_tstage.cu", "fno_layer.py:1161"),
    "k2": ("fno_k2.cu", "fno_layer.py:393"),
    "k2a_lite": ("fno_k2a.cu", "fno_layer.py:504"),
    "k2a": ("fno_k2a.cu", "fno_layer.py:487"),
    "k12b": ("fno_k12b.cu", "fno_layer.py:618"),
    "k3f": ("fno_tail.cu", "fno_tail.py:73"),
    "k3b": ("fno_tail.cu", "fno_tail.py:102"),
}
SOURCES = {k: ("realpdebench_tpu_torch/csrc/" + s, _PALLAS + r)
           for k, (s, r) in SOURCES.items()}


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


def compare_sums(name, got, ref, terms) -> dict:
    """An f32 accumulator against its twin, relative to the sum of the
    |terms| it adds (elementwise), within STATS_TOL."""
    diff = (got.float() - ref.float()).abs()
    rel = (diff / terms.clamp_min(1e-30)).max().item()
    row = dict(name=name, max_abs_err=diff.max().item(),
               max_rel_to_terms=rel, limit_rel=STATS_TOL)
    if not rel <= STATS_TOL:
        raise AssertionError(f"{name}: accumulator disagrees with its twin: {row}")
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
               for k in ("k1", "t_stage", "k2")}
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
            for k in summary:
                mine = [r for r in rows
                        if r["name"].startswith(k + "/") and "/stats/" not in r["name"]]
                for key in ("max_abs_err", "max_rel_err"):
                    summary[k][key] = max(r[key] for r in mine)
            summary["k1"]["ms"], summary["k1"]["plain_ms"] = times["k1"]
            summary["k2"]["ms"], summary["k2"]["plain_ms"] = times["k2"]
            # one layer's T-stage: one 'et' and one 'it' launch
            summary["t_stage"]["ms"] = times["t_stage_et"][0] + times["t_stage_it"][0]
            summary["t_stage"]["plain_ms"] = (times["t_stage_et"][1]
                                              + times["t_stage_it"][1])
    return summary


def phase_backward(dev) -> dict:
    """The backward and tail kernels against their twins at the training
    width; returns per-kernel summaries (bf16 errors and times)."""
    B = TRAIN_BATCH
    BT = B * TP
    T, H, W = SHAPE_IN[:3]
    F = SHAPE_OUT[-1] * (SHAPE_OUT[0] // SHAPE_IN[0])
    geo = dict(Hp=HP, Wp=WP, m2=M2, m3=M3)
    cst = fl._ct_on(dev, HP, WP, M2, M3)
    lite = fl._lite_on(dev, HP, WP, M2, M3)
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(3)
        rn = lambda *s: torch.randn(*s, generator=g, device=dev)
        tol = KERNEL_TOL[dtype]
        x = rn(BT, HP * WP // 2, 2 * C).to(dtype)
        a, b = 1 + 0.1 * rn(C), 0.1 * rn(C)
        wp, bp = rn(C, C) / C ** 0.5, 0.1 * rn(C)
        y = fl.k1(x, a, b, **geo, act="exact")
        gsp = rn(*y.shape).to(dtype)
        s, _ = fl.k2(gsp, x, a, b, wp, bp, **geo, act="exact")
        del x
        # cotangents at the scale the step gives them: ds ~ 1/n_pos per
        # position, the statistics' cotangents ~ 1/n_pos too
        npos = BT * HP * WP
        ds, dy = (rn(*s.shape) / npos).to(dtype), (rn(*y.shape) / npos).to(dtype)
        ds1, ds2 = rn(C) / npos, rn(C) / npos
        rows, times = [], {}
        adj_in = {"it_adj": dy, "et_adj": dy[: B * 2 * M1].contiguous()}
        for kind, inp in adj_in.items():
            mats = fl._tmats_on(dev, kind, TP, M1)
            run = lambda: fl.t_stage(inp, kind, TP, M1)
            plain = lambda: fl.t_stage_plain(inp, *mats)
            rows.append(compare(f"t_stage/{kind}", run(), plain(), tol))
            times[f"t_stage_{kind}"] = (cuda_ms(run), cuda_ms(plain))
        k2a = lambda: fl.k2a(s, ds, ds1, ds2, **geo)
        k2a_p = lambda: fl.k2a_plain(s, ds, ds1, ds2, cst, Hp=HP, Wp=WP)
        k2l = lambda: fl.k2a_lite(ds, gsp, y, ds1, ds2, wp, bp, **geo)
        k2l_p = lambda: fl.k2a_lite_plain(ds, gsp, y, ds1, ds2, wp, bp, lite, cst,
                                          Hp=HP, Wp=WP)
        full, lite_dg = k2a(), k2l()
        rows.append(compare("k2a/dg", full, k2a_p(), tol))
        rows.append(compare("k2a_lite/dg", lite_dg, k2l_p(), tol))
        rows.append(compare("k2a_lite/vs_k2a", lite_dg, full, tol))
        del full, lite_dg
        times["k2a"] = (cuda_ms(k2a), cuda_ms(k2a_p))
        times["k2a_lite"] = (cuda_ms(k2l), cuda_ms(k2l_p))

        x = rn(BT, HP * WP // 2, 2 * C).to(dtype)
        k12 = lambda: fl.k12b(x, a, b, wp, s, ds, ds1, ds2, dy, **geo, act="exact")
        k12_p = lambda: fl.k12b_plain(x, a, b, wp, s, ds, ds1, ds2, dy, cst, Hp=HP,
                                      Wp=WP, act="exact")
        got, ref = k12(), k12_p()
        rows.append(compare("k12b/dx", got[0], ref[0], tol))
        v = lambda q: q.float().view(BT, HP, WP, C)
        x4 = v(x)
        z = gelu(x4 * a + b, "exact")
        dse = v(ds) + ds1 + 2.0 * ds2 * v(s)
        du = v(ref[0]) / a
        terms = (torch.einsum("bhwc,bhwd->cd", z.abs(), dse.abs()),
                 (du * x4).abs().sum((0, 1, 2)), du.abs().sum((0, 1, 2)),
                 dse.abs().sum((0, 1, 2)))
        for name, gv, rv, tv in zip(("dwp", "da", "db", "dbp"), got[1:], ref[1:], terms):
            rows.append(compare_sums(f"k12b/{name}", gv, rv, tv))
        del got, ref, x4, z, dse, du
        times["k12b"] = (cuda_ms(k12, reps=10), cuda_ms(k12_p, reps=5))

        kw = dict(dims=(B, TP, HP, WP, C), tail_dims=(T, H, W), act="exact")
        tail = (rn(B, T, H, W, F), rn(C, 128) / C ** 0.5, 0.1 * rn(128),
                rn(128, F) / 128 ** 0.5, 0.1 * rn(F))
        gl = torch.tensor(1.0 / (B * T * H * W * F), device=dev)
        k3f = lambda: ft.k3f(s, *tail, **kw)
        k3f_p = lambda: ft.k3f_plain(s, *tail, **kw)
        k3b = lambda: ft.k3b(s, *tail, gl, **kw)
        k3b_p = lambda: ft.k3b_plain(s, *tail, gl, **kw)
        sse, sse_ref = k3f(), k3f_p()
        rows.append(compare_sums("k3f/sse", sse, sse_ref, sse_ref))
        got, ref = k3b(), k3b_p()
        rows.append(compare("k3b/ds", got[0], ref[0], tol))
        k1w, b1w, k2w, b2w = tail[1:]
        zt = s.float().view(B, TP, HP, WP, C)[:, :T, :H, :W].reshape(-1, C)
        u1 = zt @ k1w + b1w
        h1 = gelu(u1, "exact")
        do = 2 * gl * (h1 @ k2w + b2w - tail[0].reshape(-1, F))
        du1 = (do @ k2w.t()) * gelu_grad(u1, "exact")
        terms = (zt.abs().t() @ du1.abs(), du1.abs().sum(0), h1.abs().t() @ do.abs(),
                 do.abs().sum(0))
        for name, gv, rv, tv in zip(("dk1", "db1", "dk2", "db2"), got[1:], ref[1:], terms):
            rows.append(compare_sums(f"k3b/{name}", gv, rv, tv))
        del got, ref, zt, u1, h1, do, du1
        times["k3f"] = (cuda_ms(k3f, reps=10), cuda_ms(k3f_p, reps=5))
        times["k3b"] = (cuda_ms(k3b, reps=10), cuda_ms(k3b_p, reps=5))
        torch.cuda.synchronize()
        emit(dict(phase="backward", dtype=str(dtype).replace("torch.", ""),
                  shapes=dict(BT=BT, Hp=HP, Wp=WP, C=C, modes=[M1, M2, M3],
                              tail=[B, T, H, W, F]),
                  checks=rows, ms={k: dict(kernel=v[0], plain=v[1])
                                   for k, v in times.items()}))
        if dtype == torch.bfloat16:
            for k in ("k2a_lite", "k2a", "k12b", "k3f", "k3b"):
                mine = [r for r in rows if r["name"].startswith(k + "/")]
                summary[k] = dict(
                    max_abs_err=max(r["max_abs_err"] for r in mine),
                    max_rel_err=max(r.get("max_rel_err", r.get("max_rel_to_terms"))
                                    for r in mine),
                    ms=times[k][0], plain_ms=times[k][1])
            adj = [r for r in rows if r["name"].startswith("t_stage/")]
            summary["t_stage_adjoint"] = dict(
                max_abs_err=max(r["max_abs_err"] for r in adj),
                max_rel_err=max(r["max_rel_err"] for r in adj),
                ms=times["t_stage_et_adj"][0] + times["t_stage_it_adj"][0],
                plain_ms=times["t_stage_et_adj"][1] + times["t_stage_it_adj"][1])
        del s, y, gsp, ds, dy, x
        torch.cuda.empty_cache()
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
                   "t_stage": 2 * MODEL["n_layers"], "k2a": 0, "k2a_lite": 0,
                   "k12b": 0, "k3f": 0, "k3b": 0}
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


def _rel_l2(got, ref) -> float:
    f = lambda t: torch.view_as_real(t) if t.is_complex() else t.float()
    return ((f(got) - f(ref)).norm() / f(ref).norm()).item()


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def phase_train(dev) -> dict:
    """bench.py's training step through make_train_step; returns the launch
    counts of the counted step."""
    T, H, W = SHAPE_IN[:3]
    model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), compute_dtype="bfloat16",
                        device=dev, generator=make_generator(0), **MODEL)
    ref_model = build_model(shapes=(SHAPE_IN, SHAPE_OUT), device=dev, **MODEL)
    ref_model.load_state_dict(model.state_dict(), strict=True)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(TRAIN_BATCH, *SHAPE_IN, generator=g, device=dev)
    y = torch.randn(TRAIN_BATCH, *SHAPE_OUT, generator=g, device=dev)
    opt = build_optimizer(TRAIN_CFG, model.parameters())
    step = make_train_step(model, IdentityNormalizer(), opt, grad_accum=1)

    # the main path, counted: nothing but this step between reset and read
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    loss = step(x, y)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"one training step launched {launches}, "
                             f"expected {TRAIN_LAUNCHES}")
    grads = _grads(model)
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"training loss {loss.item()} is not finite")

    # the same step from the same weights through the plain f32 path
    ref_model.train()
    ref_loss = ref_model(x, y=y, reference=True)
    ref_loss.backward()
    ref_grads = _grads(ref_model)
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    cmp = dict(batch=TRAIN_BATCH, loss=loss.item(), ref_loss=ref_loss.item(),
               loss_rel=loss_rel, limit_loss_rel=TRAIN_LOSS_REL, grad_rel_l2={},
               limit_grad_rel_l2=TRAIN_GRAD_REL_L2, zero_grads={},
               limit_zero_grad=TRAIN_ZERO_GRAD, stats_rel_l2={},
               limit_stats_rel_l2=TRAIN_STATS_REL_L2)
    bad = [] if loss_rel <= TRAIN_LOSS_REL else ["loss"]
    for name, gr in ref_grads.items():
        if name.startswith("convs.") and name.endswith(".bias"):
            scale = ref_grads[name[:-4] + "weight"].abs().max().item()
            worst = max(grads[name].abs().max().item(), gr.abs().max().item()) / scale
            cmp["zero_grads"][name] = worst
            bad += [] if worst <= TRAIN_ZERO_GRAD else [name]
            continue
        rel = _rel_l2(grads[name], gr)
        cmp["grad_rel_l2"][name] = rel
        bad += [] if rel <= TRAIN_GRAD_REL_L2 else [name]
    ref_bufs = dict(ref_model.named_buffers())
    for name, buf in model.named_buffers():
        if "running" in name:
            rel = _rel_l2(buf, ref_bufs[name])
            cmp["stats_rel_l2"][name] = rel
            bad += [] if rel <= TRAIN_STATS_REL_L2 else [name]
    cmp["worst_grad_rel_l2"] = max(cmp["grad_rel_l2"].values())
    cmp["worst_stats_rel_l2"] = max(cmp["stats_rel_l2"].values())
    if bad:
        raise AssertionError(f"bf16 kernel step vs f32 plain step: {bad}: {cmp}")
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    del ref_model, ref_loss, ref_grads
    torch.cuda.empty_cache()

    # determinism: the same forward-backward twice, bit for bit
    rep = []
    for _ in range(2):
        opt.zero_grad()
        rep.append(model.loss(x, y))
        rep[-1].backward()
        rep.append(_grads(model))
    same = torch.equal(rep[0], rep[2]) and all(
        torch.equal(rep[1][n], rep[3][n]) for n in rep[1])
    if not same:
        raise AssertionError("two identical forward-backward passes differ")
    del rep

    for _ in range(WARMUP):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates, losses = [], []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW_STEPS):
            loss = step(x, y)
        losses.append(loss.item())      # synchronises
        rates.append(WINDOW_STEPS / (time.perf_counter() - t0))
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"training losses {losses} are not finite")
    frames = TRAIN_BATCH * SHAPE_OUT[0]
    med = statistics.median(rates)
    emit(dict(phase="train", batch=TRAIN_BATCH, cfg=TRAIN_CFG, launches=launches,
              vs_plain_f32=cmp, bitwise_repeatable=same, first_step_s=first_s,
              window_steps_per_s=rates, steps_per_s=med,
              frames_per_s=med * frames, losses=losses,
              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
              peak_mem_with_plain_step_gb=ref_peak))
    phase_profile(step, x, y)
    return launches


def phase_profile(step, x, y) -> None:
    """torch.profiler over 3 training steps: device time by kernel against
    the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device time of the kernels themselves: an autograd function's row
    # also carries the time of the kernels it launched through ctypes
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in ka
                   if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    emit(dict(phase="profile", steps=3, wall_ms=wall * 1e3, device_ms=total,
              idle_share=1 - total / (wall * 1e3),
              kernels=[dict(name=k[:100], ms=ms, count=n) for k, ms, n in rows[:25]]))


def main() -> None:
    name = phase_env()
    dev = torch.device("cuda", 0)
    phase_build()
    summary = phase_kernels(dev)
    summary.update(phase_backward(dev))
    adjoint = summary.pop("t_stage_adjoint")
    summary["t_stage"].update(adjoint_ms=adjoint["ms"],
                              adjoint_plain_ms=adjoint["plain_ms"])
    for key in ("max_abs_err", "max_rel_err"):
        summary["t_stage"][key] = max(summary["t_stage"][key], adjoint[key])
    by_path = {"rollout": phase_slice(dev), "train": phase_train(dev)}
    emit({"kernels": [
        dict(name=k, route="cuda", source=SOURCES[k][0], replaces=SOURCES[k][1],
             launches=sum(p[k] for p in by_path.values()),
             launches_by_path={n: p[k] for n, p in by_path.items()}, **summary[k])
        for k in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
