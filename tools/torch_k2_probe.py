#!/usr/bin/env python3
"""Where the time of K2's tensor-core variant goes, without a profiler that
reads hardware counters: scratch copies of ``csrc/fno_k2.cu`` are patched,
built with nvcc into ``build/k2_probe/`` and launched through ctypes at the
cylinder rollout width (B·Tp 208, Hp 70, Wp 134, C 64, modes 4/12/16, bf16).

    PYTHONPATH=. python3 tools/torch_k2_probe.py

From the repository root on a host with a Hopper card and nvcc. One JSON
line each:

  clocks     ``clock64()`` deltas of warp 0 per block (mean over blocks):
             staging the constants, the inverse-H stage, the main loop.
  ablation   CUDA-event medians of the kernel (with its reduction pass) as
             it is, and with one part cut out of the main loop: the MMAs,
             the B-operand ldmatrix loads, both, the statistics, the s
             store. The cut copies compute wrong results; only their time
             is read. The activation is 'none' and 'exact'.

The patches are anchored on comment lines of the source and fail loudly
when the source no longer has them.
"""

import ctypes
import json
import re
import subprocess
import sys

import torch

from realpdebench_tpu_torch.ops import fno_layer as fl
from realpdebench_tpu_torch.ops import kernels
from torch_probe_common import build, sub

OUT = kernels.BUILD_DIR.parent / "k2_probe"
BT, HP, WP, C, M2, M3 = 208, 70, 134, 64, 12, 16
MAIN = "  // ---- main loop: warp = the 16 columns w0.. of every row of the block\n"
STATS = "  // ---- the block's partial statistics: lanes of a column pair, then warps, in a fixed order\n"


def with_clocks(s: str) -> str:
    s = sub(s, "  // ---- constants: Wp split into hi + lo while staged; a, b, bp\n",
            "  const long long t0 = clock64();\n")
    s = sub(s, "  // ---- inverse H: sih[hl][part*M3 + m][c]",
            "  __syncthreads();\n  const long long t1 = clock64();\n  // ---- inverse H:")
    s = sub(s, MAIN, "  const long long t2 = clock64();\n")
    s = sub(s, STATS, "  const long long t3 = clock64();\n")
    return sub(s, "    pb[i] = v;\n  }\n}\n\nint num_chunks",
               "    pb[i] = v;\n  }\n  __syncthreads();\n  if (tid == 0) {\n"
               "    pb[0] = (float)(t1 - t0), pb[1] = (float)(t2 - t1), pb[2] = (float)(t3 - t2);\n"
               "  }\n}\n\nint num_chunks")


def cut(s: str, *parts: str) -> str:
    """The source with ``parts`` of the main loop cut out."""
    i0, i1 = s.index(MAIN), s.index(STATS)
    if min(s.count(MAIN), s.count(STATS)) != 1:
        raise SystemExit("torch_k2_probe: the main loop's anchors are gone")
    m = s[i0:i1]
    if "mma" in parts:     # a cheap dependency on both operands instead of the product
        m = re.sub(r"mma::mma_bf16\((acc\[[^\]]+\]), (\w+)(\[ks\])?, (\w+)\[(\d)\], \w+\[\d\]\);",
                   lambda g: f"{g[1]}[{g[5]}] += __uint_as_float({g[4]}[{g[5]}] ^ {g[2]}{g[3] or ''}[0]);",
                   m)
    if "ldmatrix" in parts:   # the B fragments from the address, not from shared memory
        m = re.sub(r"mma::ldmatrix_x4_trans\((\w+), mma::smem_addr\(([^;]+)\)\);",
                   lambda g: (f"{{ const uint32_t v_ = (uint32_t)(size_t)({g[2]}); {g[1]}[0] = v_; "
                              f"{g[1]}[1] = v_ * 3; {g[1]}[2] = v_ * 5; {g[1]}[3] = v_ * 7; }}"), m)
    a = "    // statistics from the f32 accumulators"
    b = "    // the s tile goes back through the slab"
    c = "    __syncwarp();   // the slab is free for the copy"
    if "stats" in parts:
        m = m[:m.index(a)] + "    ssum[0][0] += acc[0][0] + acc[NT - 1][3];\n" + m[m.index(b):]
    if "store" in parts:
        m = m[:m.index(b)] + m[m.index(c):]
    return s[:i0] + m + s[i1:]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_probe: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    base = (kernels.CSRC / "fno_k2.cu").read_text()
    variants = {"clocks": with_clocks(base), "as_is": base}
    for parts in (("mma",), ("ldmatrix",), ("mma", "ldmatrix"), ("stats",), ("store",)):
        variants["no_" + "_".join(parts)] = cut(base, *parts)
    libs = build(OUT, {name: {"fno_k2.cu": src} for name, src in variants.items()})

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x = rn(BT, HP * WP // 2, 2 * C).bfloat16()
    gsp = rn(BT, 2 * M2 * M3, 2 * C).bfloat16()
    a, b, wp, bp = 1 + 0.1 * rn(C), 0.1 * rn(C), rn(C, C) / C ** 0.5, 0.1 * rn(C)
    cst = fl._ct_on(dev, HP, WP, M2, M3)
    rows = kernels.K2_MMA_ROWS[C]
    ah, iw = fl._k2_mma_on(dev, HP, WP, M2, M3, rows)
    nch = -(-HP // rows)
    s = torch.empty_like(x)
    partial = torch.zeros(BT * nch, 2 * C, device=dev)
    stats = torch.empty(2, C, device=dev)
    p = lambda t: ctypes.c_void_p(t.data_ptr())

    def ms(lib, act: int, reps: int = 20) -> float:
        times = []
        for i in range(reps + 3):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            err = lib.fno_k2(p(gsp), p(x), p(a), p(b), p(wp), p(bp), p(cst["ihr"]),
                             p(cst["ihi"]), p(cst["iwr"]), p(cst["iwi"]), p(ah), p(iw), p(s),
                             p(partial), p(stats), BT, HP, WP, C, 2 * M2, M3, act, 1, 1,
                             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            e1.record()
            e1.synchronize()
            if err:
                raise RuntimeError(f"fno_k2 returned {err}")
            times.append(e0.elapsed_time(e1))
        return sorted(times[3:])[reps // 2]

    ablation = {}
    for name, (lib, _) in libs.items():
        if name == "clocks":
            for act, label in ((0, "none"), (1, "exact")):
                ms(lib, act, reps=3)
                c = partial.view(BT, nch, 2 * C)[:, :-1, :3].reshape(-1, 3).mean(0).tolist()
                print(json.dumps(dict(phase="clocks", act=label, rows_per_block=rows,
                                      blocks=BT * nch, constants=c[0], inverse_h=c[1],
                                      main_loop=c[2], inverse_h_share=c[1] / sum(c))), flush=True)
        else:
            ablation[name] = dict(none=ms(lib, 0), exact=ms(lib, 1))
    print(json.dumps(dict(phase="ablation", shapes=dict(BT=BT, Hp=HP, Wp=WP, C=C, m2=M2, m3=M3),
                          ms=ablation)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
