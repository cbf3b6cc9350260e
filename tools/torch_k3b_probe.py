#!/usr/bin/env python3
"""Where the time of K3B's and K3F's tensor-core variants goes, and what a
change to their loops would buy, without a profiler that reads hardware
counters: patched scratch copies of ``csrc/fno_tail.cu`` are built with nvcc
into ``build/k3b_probe/`` (all at once) and launched through ctypes at the
cylinder training width (B 32, Tp 26, Hp 70, Wp 134, C 64; the tail over
32·20·64·128 positions, F 3; bf16). A variant named k3f_* launches K3F, the
others K3B.

    PYTHONPATH=. python3 tools/torch_k3b_probe.py [VARIANT ...]

From the repository root on a host with a Hopper card and nvcc. Variants
(all by default), each a set of patches of the source as it is:

  as_is      the source unchanged
  roll       `#pragma unroll 1` on the k-step loops of fc1 (in the forward
             K3F shares), dk2 and dk1 (the loops that index no register
             array by their counter)
  ng64       ds in passes of 64 channels instead of 32
  no_flush   one row of partial sums a block (kFlush past any tile count)
  cut_act    GELU and GELU' replaced by a copy (time only)
  cut_dk1    the dk1 and db1 MMAs replaced by a cheap dependency (time only)
  cut_ds     no ds product and no ds store (time only)
  k3f_as_is     K3F, the source unchanged
  k3f_cut_act   K3F with GELU replaced by a copy (time only)
  k3f_cut_fc1   K3F with fc1's MMAs replaced by a cheap dependency (time only)
  k3f_fetch     K3F's ring of z copies and barriers, no compute (time only)

One JSON line a variant: ptxas's registers and spill bytes of
``k3b_mma_kernel<64, exact GELU>`` (``k3f_mma_kernel`` for K3F), the device
time of queued launches (median of 5, 8 launches each, taken twice: in the
listed order and in reverse), and, for the variants that compute what the
kernel computes, ds's max|Δ| / max|ref| and the worst of dk1, db1, dk2 and
db2 against the plain twin relative to the sum of |terms| (K3F: the SSE's
relative error). The patches fail loudly when their anchors are gone.
"""

import ctypes
import json
import sys

import torch

import torch_probe_common as common
from realpdebench_tpu_torch.ops import fno_tail as ft
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.activations import gelu, gelu_grad
from torch_probe_common import queued_ms, sub

OUT = kernels.BUILD_DIR.parent / "k3b_probe"
B, TP, HP, WP, C, T, H, W, F = 32, 26, 70, 134, 64, 20, 64, 128, 3

FC1 = ("#pragma unroll\n  for (int ks = 0; ks < C / 16; ++ks) {\n    uint32_t fa[4];\n"
       "    mma::ldmatrix_x4(fa,")
DK2 = ("    // dk2 += h1^T do on hidden units 16 warp .. + 15\n#pragma unroll\n"
       "    for (int ks = 0; ks < 8; ++ks) {")
DK1 = "    const uint32_t ones[4] = {one, 0u, one, 0u};\n#pragma unroll\n    for (int ks = 0; ks < 8; ++ks) {"
NG = "  constexpr int NG = 32;"
ACT = ("        fno::act_and_grad_fast(u[nt][2 * hf], ACT, hv0, u[nt][2 * hf]);\n"
       "        fno::act_and_grad_fast(u[nt][2 * hf + 1], ACT, hv1, u[nt][2 * hf + 1]);\n")
FLUSH = "constexpr int kFlush = 32;"
DK1_MMA = ("        mma::mma_bf16(dk1[mi][0], fa, bh[0], bh[1]);\n"
           "        mma::mma_bf16(dk1[mi][0], fa, bl[0], bl[1]);\n"
           "        mma::mma_bf16(dk1[mi][1], fa, bh[2], bh[3]);\n"
           "        mma::mma_bf16(dk1[mi][1], fa, bl[2], bl[3]);\n")
DS = "    for (int cg = 0; cg < C / NG; ++cg) {"
K3F_ACT = ("        hv0 = fno::affine_act_fast(u[nt][2 * hf], 1.f, 0.f, ACT);\n"
           "        hv1 = fno::affine_act_fast(u[nt][2 * hf + 1], 1.f, 0.f, ACT);\n")
FC1_MMA = ("        mma::mma_bf16(u[2 * np], fa, fb[0], fb[1]);\n"
           "        mma::mma_bf16(u[2 * np + 1], fa, fb[2], fb[3]);\n")
K3F_COMPUTE = "    forward_warp<C, ACT, false>("


def roll(s: str) -> str:
    for anchor in (FC1, DK2, DK1):
        s = sub(s, anchor, anchor.replace("#pragma unroll\n", "#pragma unroll 1\n"))
    return s


VARIANTS = {
    "as_is": (lambda s: s, True),
    "roll": (roll, True),
    "ng64": (lambda s: sub(s, NG, "  constexpr int NG = C < 64 ? C : 64;"), True),
    "no_flush": (lambda s: sub(s, FLUSH, "constexpr int kFlush = 1 << 30;"), True),
    "cut_act": (lambda s: sub(s, ACT, "        hv0 = u[nt][2 * hf];\n        hv1 = u[nt][2 * hf + 1];\n"
                                      "        u[nt][2 * hf] = u[nt][2 * hf + 1] = 1.f;\n"), False),
    "cut_dk1": (lambda s: sub(s, DK1_MMA, "        dk1[mi][0][0] += __uint_as_float(fa[0] ^ bh[0] ^ bl[1]);\n"
                                          "        dk1[mi][1][0] += __uint_as_float(fa[1] ^ bh[2] ^ bl[3]);\n"),
                False),
    "cut_ds": (lambda s: sub(s, DS, "    for (int cg = 0; cg < 0; ++cg) {"), False),
    "k3f_as_is": (lambda s: s, True),
    "k3f_cut_act": (lambda s: sub(s, K3F_ACT, "        hv0 = u[nt][2 * hf];\n"
                                              "        hv1 = u[nt][2 * hf + 1];\n"), False),
    "k3f_cut_fc1": (lambda s: sub(s, FC1_MMA, "        u[2 * np][0] += __uint_as_float(fa[0] ^ fb[0]);\n"
                                              "        u[2 * np + 1][1] += __uint_as_float(fa[1] ^ fb[2]);\n"),
                    False),
    "k3f_fetch": (lambda s: sub(s, K3F_COMPUTE, "    continue;\n" + K3F_COMPUTE), False),
}


def build(names):
    """The patched copies of each variant, built all at once."""
    src = (kernels.CSRC / "fno_tail.cu").read_text()
    return common.build(OUT, {name: {"fno_tail.cu": VARIANTS[name][0](src)} for name in names})


def registers(report: str, kernel: str) -> dict:
    """Registers and spill bytes ptxas reported for `kernel`<64, exact>."""
    return common.registers(report, f"{kernel}ILi64ELi1E")


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(names)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    s = rn(B * TP, HP * WP // 2, 2 * C).bfloat16()
    tail = (rn(B, T, H, W, F), rn(C, 128) / C ** 0.5, 0.1 * rn(128), rn(128, F) / 128 ** 0.5,
            0.1 * rn(F))
    gl = torch.tensor(1.0 / (B * T * H * W * F), device=dev)
    kw = dict(dims=(B, TP, HP, WP, C), tail_dims=(T, H, W), act="exact")
    ref = ft.k3b_plain(s, *tail, gl, **kw)
    zt = s.float().view(B, TP, HP, WP, C)[:, :T, :H, :W].reshape(-1, C)
    u1 = zt @ tail[1] + tail[2]
    h1 = gelu(u1, "exact")
    do = 2 * gl * (h1 @ tail[3] + tail[4] - tail[0].reshape(-1, F))
    du = (do @ tail[3].t()) * gelu_grad(u1, "exact")
    terms = (zt.abs().t() @ du.abs(), du.abs().sum(0), h1.abs().t() @ do.abs(), do.abs().sum(0))
    del zt, u1, h1, do, du
    n = C * 128 + 128 + 128 * F + F
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    sse_ref = ft.k3f_plain(s, *tail, **kw)

    def runner_k3f(lib):
        nparts = lib.fno_k3f_num_partials(B, T, H, W, C, kernels.ACT_CODES["exact"], 1)
        partial = torch.empty(nparts, dtype=torch.float32, device=dev)
        sse = torch.empty((), dtype=torch.float32, device=dev)

        def fn():
            err = lib.fno_k3f(p(s), p(tail[0]), p(tail[1]), p(tail[2]), p(tail[3]), p(tail[4]),
                              p(partial), p(sse), B, T, H, W, TP, HP, WP, C, 128, F,
                              kernels.ACT_CODES["exact"], 1, 1, stream)
            if err:
                raise SystemExit(f"torch_k3b_probe: launch failed ({err})")
            return sse
        return fn

    def runner(lib):
        nparts = lib.fno_k3b_num_partials(B, T, H, W, TP, C, kernels.ACT_CODES["exact"], 1)
        ds = torch.empty_like(s)
        partial = torch.empty((nparts, n), dtype=torch.float32, device=dev)
        out = torch.empty(n, dtype=torch.float32, device=dev)

        def fn():
            err = lib.fno_k3b(p(s), p(tail[0]), p(tail[1]), p(tail[2]), p(tail[3]), p(tail[4]),
                              p(gl), p(ds), p(partial), p(out), B, T, H, W, TP, HP, WP, C, 128,
                              F, kernels.ACT_CODES["exact"], 1, 1, stream)
            if err:
                raise SystemExit(f"torch_k3b_probe: launch failed ({err})")
            return ds, out
        return fn

    fns = {name: (runner_k3f if name.startswith("k3f") else runner)(lib)
           for name, (lib, _) in libs.items()}
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(queued_ms([fns[name]], n=8, reps=5))
    for name in names:
        k3f = name.startswith("k3f")
        row = dict(variant=name, **registers(libs[name][1], "k3f_mma_kernel" if k3f
                                             else "k3b_mma_kernel"), ms=times[name])
        if VARIANTS[name][1] and k3f:
            row["sse_rel"] = abs(fns[name]().item() - sse_ref.item()) / sse_ref.item()
        elif VARIANTS[name][1]:
            ds, out = fns[name]()
            torch.cuda.synchronize()
            row["ds_rel"] = ((ds.float() - ref[0].float()).abs().max()
                             / ref[0].float().abs().max()).item()
            parts = out.split([C * 128, 128, 128 * F, F])
            row["sums_rel_to_terms"] = max(
                ((got.view(r.shape) - r).abs() / t.clamp_min(1e-30)).max().item()
                for got, r, t in zip(parts, ref[1:], terms))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
