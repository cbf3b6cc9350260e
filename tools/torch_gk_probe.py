#!/usr/bin/env python3
"""Where the time of the Galerkin scores' tensor-core variant goes, without
a profiler that reads hardware counters: patched scratch copies of
``csrc/galerkin_scores.cu`` are built with nvcc into ``build/gk_probe/``
(all at once) and launched through ctypes at the cylinder width (B 16,
N 163840, h 4, d 64; bf16, and f32 for the variants named ``*_f32``).

    PYTHONPATH=. python3 tools/torch_gk_probe.py [VARIANT ...]

From the repository root on a host with a Hopper card and nvcc. Variants
(all by default), each a set of patches of the source as it is:

  as_is          the source unchanged
  as_is_f32      the same, f32 inputs
  stages3        a ring of three tiles a block (two in flight) instead of two
  stages4        four
  products_first tile t's products before tile t + 1's LayerNorm in a
                 barrier interval, not after
  cut_products   the LayerNorm and its staged rows, no products (time only)
  cut_ln         the products over rows that are never written: no
                 LayerNorm (time only)
  fetch_only     the ring's copies and barriers alone (time only)

One JSON line a variant: ptxas's registers and spill bytes of
``gk_scores_mma_kernel<T, 64>``, the shared memory of a block, the
partials (blocks of (head, b) a chunk), the device time of queued launches
(median of 5, 8 launches each, taken twice: in the listed order and in
reverse), and, for the variants that compute the scores, max|Δ| / max|ref|
against the plain twin. The patches fail loudly when their anchors are
gone.
"""

import ctypes
import json
import sys

import torch

import torch_probe_common as common
from realpdebench_tpu_torch.ops import galerkin as tga
from realpdebench_tpu_torch.ops import kernels
from torch_probe_common import queued_ms, sub

OUT = kernels.BUILD_DIR.parent / "gk_probe"
B, N, HEADS, D, EPS = 16, 163840, 4, 64, 1e-7

STAGES = "constexpr int kGkStages = 2;"
LN = "    for (int pass = 0; pass < 2 * kGkTile / RPP; ++pass) {"
PRODUCTS = "    for (int ks16 = 0; ks16 < kGkTile / 16; ++ks16) {"
ORDER = "    if (t + 1 < ntiles) normalise_tile(t + 1);\n    products(t);\n"


cut_ln = lambda s: sub(s, LN, LN.replace("pass < 2 * kGkTile / RPP", "pass < 0"))
cut_products = lambda s: sub(s, PRODUCTS, PRODUCTS.replace("ks16 < kGkTile / 16", "ks16 < 0"))

# name: (patch, computes the scores, input dtype)
VARIANTS = {
    "as_is": (lambda s: s, True, torch.bfloat16),
    "as_is_f32": (lambda s: s, True, torch.float32),
    "stages3": (lambda s: sub(s, STAGES, "constexpr int kGkStages = 3;"), True, torch.bfloat16),
    "stages4": (lambda s: sub(s, STAGES, "constexpr int kGkStages = 4;"), True, torch.bfloat16),
    "products_first": (lambda s: sub(s, ORDER, "".join(ORDER.splitlines(True)[::-1])), True,
                       torch.bfloat16),
    "cut_products": (cut_products, False, torch.bfloat16),
    "cut_ln": (cut_ln, False, torch.bfloat16),
    "fetch_only": (lambda s: cut_products(cut_ln(s)), False, torch.bfloat16),
}


def build(names):
    """The patched copies of each variant, built all at once."""
    src = (kernels.CSRC / "galerkin_scores.cu").read_text()
    return common.build(OUT, {name: {"galerkin_scores.cu": VARIANTS[name][0](src)}
                              for name in names})


def registers(report: str, dtype) -> dict:
    """Registers and spill bytes ptxas reported for gk_scores_mma_kernel<T, 64>."""
    return common.registers(report, "gk_scores_mma_kernelI13__nv_bfloat16Li64E"
                            if dtype == torch.bfloat16 else "gk_scores_mma_kernelIfLi64E")


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    libs = build(names)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(8)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    k32 = rn(B, N, HEADS * D)
    v32 = 0.5 * k32 + rn(B, N, HEADS * D)          # correlated, as q/k/v are
    aff = [1 + 0.1 * rn(HEADS, D), 0.1 * rn(HEADS, D), 1 + 0.1 * rn(HEADS, D),
           0.1 * rn(HEADS, D)]
    inputs = {dt: (k32.to(dt), v32.to(dt)) for dt in {VARIANTS[n][2] for n in names}}
    del k32, v32
    refs = {dt: tga.galerkin_scores_plain(k, v, *aff, HEADS, EPS) for dt, (k, v) in inputs.items()}
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def runner(lib, dtype):
        k, v = inputs[dtype]
        code = 0 if dtype == torch.float32 else 1
        nparts = lib.gk_scores_num_partials(B, N, HEADS, D, 1, code)
        partial = torch.empty((nparts, B, HEADS, D, D), dtype=torch.float32, device=dev)
        out = torch.empty((B, HEADS, D, D), dtype=torch.float32, device=dev)

        def fn():
            err = lib.gk_scores(ptr(k), ptr(v), *map(ptr, aff), ptr(partial), ptr(out), B, N,
                                N, HEADS, D, EPS, 1, code, stream)
            if err:
                raise SystemExit(f"torch_gk_probe: launch failed ({err})")
            return out
        return fn, nparts

    fns = {name: runner(lib, VARIANTS[name][2]) for name, (lib, _) in libs.items()}
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(queued_ms([fns[name][0]], n=8, reps=5))
    for name in names:
        lib, report = libs[name]
        dtype = VARIANTS[name][2]
        row = dict(variant=name, **registers(report, dtype),
                   smem_bytes=lib.gk_scores_mma_smem_bytes(D, 0 if dtype == torch.float32 else 1),
                   partials=fns[name][1], ms=times[name])
        if VARIANTS[name][1]:
            got = fns[name][0]()
            torch.cuda.synchronize()
            ref = refs[dtype]
            row["rel"] = ((got - ref).abs().max() / ref.abs().max()).item()
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
