#!/usr/bin/env python3
"""Where the time of K3B's and K3F's tensor-core variants goes, and what a
change to their loops would buy, without a profiler that reads hardware
counters: patched scratch copies of ``csrc/fno_tail.cu`` are built with nvcc
into ``build/k3b_probe/`` (all at once) and launched through ctypes at the
cylinder training width (B 32, Tp 26, Hp 70, Wp 134, C 64; the tail over
32·20·64·128 positions, F 3). A variant named k3f_* launches K3F, the
others K3B; one named *tf32* the tf32 variant on f32 s, the others the mma
variant on bf16 s.

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
  k3b_tf32_as_is, k3f_tf32_as_is     the tf32 variants, the source unchanged
  k3b_tf32_cut_act, k3f_tf32_cut_act GELU (and GELU') replaced by a copy (time only)
  k3b_tf32_cut_fc1, k3f_tf32_cut_fc1 fc1's MMAs replaced by a cheap dependency,
                                     its loads and splits kept (time only)
  k3b_tf32_fetch, k3f_tf32_fetch     the ring of z copies and barriers alone (time only)
  k3b_tf32_{bare,cvt,tested,fma}_split, k3f_tf32_..._split  mma.cuh's tf32 split in
                     another form (torch_probe_common.split_form): lo by the
                     integer rounding too (a NaN lost); both by cvt.rna.tf32.f32;
                     both by an integer rounding that tests for Inf and NaN; lo
                     by the integer rounding with its NaN kept by an FMA
  k3b_tf32_cheap_act GELU and GELU' replaced by two FMAs, u kept live (time only)
  k3b_tf32_erff, k3f_tf32_erff  the exact GELU by erff (and expf) instead of fno::erf_fast
  k3b_tf32_cut_fc2   the forward's fc2 MMAs replaced by a cheap dependency (time only)
  k3b_tf32_cut_ds    no ds product and no ds store (time only)
  k3b_tf32_cut_dk2   no dk2 product (time only)
  k3b_tf32_cut_dk1   the dk1 and db1 MMAs replaced by a cheap dependency (time only)

One JSON line a variant: ptxas's registers and spill bytes of
``k3b_mma_kernel<64, exact GELU>`` (``k3f_mma_kernel`` for K3F,
``*_tf32_kernel`` for the tf32 variants), the device time of queued launches
(median of 5, 8 launches each, taken twice: in the listed order and in
reverse), and, for the variants that compute what the
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
K3F_COMPUTE = "    forward_warp<C, ACT, false, NF>("
TF32_ACT = "        fno::act_and_grad_fast(u[nt][e], ACT, hv[e], u[nt][e]);\n"
TF32_K3F_ACT = "        hv[e] = fno::affine_act_fast(u[nt][e], 1.f, 0.f, ACT);\n"
TF32_FC1 = "      mma::mma_tf32x3(u[nt], ah, al, bh0, bh1, bl0, bl1);\n"
TF32_K3B = "    forward_warp_tf32<C, ACT, true, NF>("
TF32_K3F = "    forward_warp_tf32<C, ACT, false, NF>("
CUT_TF32_FC1 = "      u[nt][0] += __uint_as_float(ah[0] ^ al[1] ^ bh0 ^ bl1);\n"
TF32_ERFF = ("        { const float uu = u[nt][e]; hv[e] = fno::act_fn(uu, ACT); "
             "u[nt][e] = fno::act_grad(uu, ACT); }\n")
TF32_FC2 = "      mma_f32x3(o[n], os[n], a, kb.x, kb.y);\n"
TF32_DS = "    for (int cp = 0; cp < C / NP; ++cp) {"
TF32_DK2 = "        mma_f32x3(dk2[nf], dk2s[nf], a, db.x, db.y);\n"
TF32_DK1 = ("          mma::mma_tf32x3(dk1[mi][nt], ah, al, bh[nt][0], bh[nt][1], bl[nt][0], "
            "bl[nt][1]);\n")


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
    "k3b_tf32_as_is": (lambda s: s, True),
    "k3b_tf32_cut_act": (lambda s: sub(s, TF32_ACT,
                                       "        { hv[e] = u[nt][e]; u[nt][e] = 1.f; }\n"), False),
    "k3b_tf32_cut_fc1": (lambda s: sub(s, TF32_FC1, CUT_TF32_FC1), False),
    "k3b_tf32_fetch": (lambda s: sub(s, TF32_K3B, "    continue;\n" + TF32_K3B), False),
    "k3b_tf32_erff": (lambda s: sub(s, TF32_ACT, TF32_ERFF), True),
    "k3f_tf32_erff": (lambda s: sub(s, TF32_K3F_ACT,
                                    "        hv[e] = fno::act_fn(u[nt][e], ACT);\n"), True),
    "k3b_tf32_cheap_act": (lambda s: sub(s, TF32_ACT, "        { hv[e] = u[nt][e] * 0.5f; "
                                                      "u[nt][e] = fmaf(u[nt][e], 0.25f, 1.f); }\n"),
                           False),
    "k3b_tf32_cut_fc2": (lambda s: sub(s, TF32_FC2, "      o[n][0] += a[0] * kb.x + a[3] * kb.y;\n"),
                         False),
    "k3b_tf32_cut_ds": (lambda s: sub(s, TF32_DS, "    for (int cp = 0; cp < 0; ++cp) {"), False),
    "k3b_tf32_cut_dk2": (lambda s: sub(s, TF32_DK2, "        dk2[nf][0] += a[0] * db.x;\n"), False),
    "k3b_tf32_cut_dk1": (lambda s: sub(s, TF32_DK1, "          dk1[mi][nt][0] += __uint_as_float("
                                                    "ah[0] ^ al[1] ^ bh[nt][0] ^ bl[nt][1]);\n"),
                         False),
    "k3f_tf32_as_is": (lambda s: s, True),
    "k3f_tf32_cut_act": (lambda s: sub(s, TF32_K3F_ACT, "        hv[e] = u[nt][e];\n"), False),
    "k3f_tf32_cut_fc1": (lambda s: sub(s, TF32_FC1, CUT_TF32_FC1), False),
    "k3f_tf32_fetch": (lambda s: sub(s, TF32_K3F, "    continue;\n" + TF32_K3F), False),
}
# variants that patch csrc/mma.cuh, whose copy beside theirs is included first
MMA_PATCHES = {f"{k}_tf32_{form}_split": common.split_form(form)
               for k in ("k3b", "k3f") for form in ("bare", "cvt", "tested", "fma")}
VARIANTS.update({name: (lambda s: s, True) for name in MMA_PATCHES})


def build(names):
    """The patched copies of each variant, built all at once."""
    src = (kernels.CSRC / "fno_tail.cu").read_text()
    mma = (kernels.CSRC / "mma.cuh").read_text()
    files = {}
    for name in names:
        files[name] = {"fno_tail.cu": VARIANTS[name][0](src)}
        if name in MMA_PATCHES:
            files[name]["mma.cuh"] = MMA_PATCHES[name](mma)
    return common.build(OUT, files)


def kind(name: str) -> str:
    """The variant a probe variant launches: tf32 or mma."""
    return "tf32" if "tf32" in name else "mma"


def registers(report: str, kernel: str) -> dict:
    """Registers and spill bytes ptxas reported for `kernel`<64, exact, NF>."""
    return common.registers(report, f"{kernel}ILi64ELi1ELi{kernels.fc2_width(F)}E")


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(names)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    s32 = rn(B * TP, HP * WP // 2, 2 * C)
    inputs = {"mma": s32.bfloat16(), "tf32": s32}   # s by variant
    tail = (rn(B, T, H, W, F), rn(C, 128) / C ** 0.5, 0.1 * rn(128), rn(128, F) / 128 ** 0.5,
            0.1 * rn(F))
    gl = torch.tensor(1.0 / (B * T * H * W * F), device=dev)
    kw = dict(dims=(B, TP, HP, WP, C), tail_dims=(T, H, W), act="exact")
    refs = {}
    for v in sorted({kind(name) for name in names}):
        s = inputs[v]
        zt = s.float().view(B, TP, HP, WP, C)[:, :T, :H, :W].reshape(-1, C)
        u1 = zt @ tail[1] + tail[2]
        h1 = gelu(u1, "exact")
        do = 2 * gl * (h1 @ tail[3] + tail[4] - tail[0].reshape(-1, F))
        du = (do @ tail[3].t()) * gelu_grad(u1, "exact")
        terms = (zt.abs().t() @ du.abs(), du.abs().sum(0), h1.abs().t() @ do.abs(),
                 do.abs().sum(0))
        del zt, u1, h1, do, du
        refs[v] = (ft.k3b_plain(s, *tail, gl, **kw), terms, ft.k3f_plain(s, *tail, **kw))
    n = C * 128 + 128 + 128 * F + F
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    act = kernels.ACT_CODES["exact"]

    def runner_k3f(lib, v):
        s, code = inputs[v], list(kernels.VARIANTS["k3f"]).index(v)
        nparts = lib.fno_k3f_num_partials(B, T, H, W, C, F, act, code)
        partial = torch.empty(nparts, dtype=torch.float32, device=dev)
        sse = torch.empty((), dtype=torch.float32, device=dev)

        def fn():
            err = lib.fno_k3f(p(s), p(tail[0]), p(tail[1]), p(tail[2]), p(tail[3]), p(tail[4]),
                              p(partial), p(sse), B, T, H, W, TP, HP, WP, C, 128, F, act, code,
                              kernels._DTYPE_CODES[s.dtype], stream)
            if err:
                raise SystemExit(f"torch_k3b_probe: launch failed ({err})")
            return sse
        return fn

    def runner(lib, v):
        s, code = inputs[v], list(kernels.VARIANTS["k3b"]).index(v)
        nparts = lib.fno_k3b_num_partials(B, T, H, W, TP, C, F, act, code)
        ds = torch.empty_like(s)
        partial = torch.empty((nparts, n), dtype=torch.float32, device=dev)
        out = torch.empty(n, dtype=torch.float32, device=dev)

        def fn():
            err = lib.fno_k3b(p(s), p(tail[0]), p(tail[1]), p(tail[2]), p(tail[3]), p(tail[4]),
                              p(gl), p(ds), p(partial), p(out), B, T, H, W, TP, HP, WP, C, 128,
                              F, act, code, kernels._DTYPE_CODES[s.dtype], stream)
            if err:
                raise SystemExit(f"torch_k3b_probe: launch failed ({err})")
            return ds, out
        return fn

    fns = {name: (runner_k3f if name.startswith("k3f") else runner)(lib, kind(name))
           for name, (lib, _) in libs.items()}
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(queued_ms([fns[name]], n=8, reps=5))
    for name in names:
        k3f, v = name.startswith("k3f"), kind(name)
        ref, terms, sse_ref = refs[v]
        kernel = f"{'k3f' if k3f else 'k3b'}_{v}_kernel"
        row = dict(variant=name, **registers(libs[name][1], kernel), ms=times[name])
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
