#!/usr/bin/env python3
"""Where the time of K2's and K12B's tf32 variants goes, and what a change
would buy, without a profiler that reads hardware counters: patched scratch
copies of ``csrc/fno_k2.cu`` or ``csrc/fno_k12b.cu`` (and of the
``fno_tf32.cuh`` they share, placed beside them) are built with nvcc into
``build/tf32_probe/`` (all at once) and launched through the port's own
wrappers at the cylinder training width (BT 832, Hp 70, Wp 134, C 64,
modes 12/16; f32, the exact GELU).

    PYTHONPATH=. python3 tools/torch_tf32_probe.py [VARIANT ...]

From the repository root on a host with a Hopper card and nvcc. Variants
(all by default), each a set of patches of the sources as they are:

  k2_as_is         K2, the source unchanged
  k2_minb1         K2 at one block an SM (no cap of 96 registers a thread)
  k2_cut_act       K2, the activation replaced by a copy (time only)
  k2_cut_bsplit    the split of the B fragments read from ih skipped, lo = 0
                   (time only; Wp's pair is split once a block)
  k2_cut_mma       the pointwise and inverse-W products' MMAs replaced by a
                   cheap dependency (time only)
  k12b_as_is       K12B, both passes, the source unchanged
  k12b_dz          K12B's dz pass alone (time only)
  k12b_dwp         K12B's dWp pass alone (time only)
  k12b_dz_minb1    the dz pass at one block an SM
  k12b_dz_pf       the dz pass with an L2 prefetch (cp.async.bulk.prefetch)
                   of the next row's x, s and ds, the first row's before
                   the H stage
  k12b_dz_cut_ld   the dz pass's ds and s loads replaced by a constant
                   (time only)

One JSON line a variant: ptxas's registers and spill bytes of the tf32
kernel at <64, 2, 9, 2> (the dWp pass at <64>), the device time of queued
launches (median of 5, 6 launches each, taken twice: in the listed order
and in reverse), and, for the variants that compute what the kernel
computes, the outputs' worst relative error against the plain twin (s and
dx to max|ref|, the sums to their sum of |terms|). The patches fail loudly
when their anchors are gone.
"""

import json
import sys

import torch

import torch_probe_common as common
from realpdebench_tpu_torch.ops import fno_layer as fl
from realpdebench_tpu_torch.ops import kernels
from torch_probe_common import queued_ms, registers, sub

OUT = kernels.BUILD_DIR.parent / "tf32_probe"
BT, HP, WP, C, M2, M3 = 832, 70, 134, 64, 12, 16

BSPLIT = "    mma::split_frag(fb, fh, fl);\n"
K2_ACT = """          mma::split_tf32(fno::affine_act_fast(__uint_as_float(xr[r]), r < 2 ? a0 : a4,
                                               r < 2 ? b0 : b4, act),
                          zh[r], zl[r]);"""
BT_MMA = """    mma::mma_tf32x3(acc[2 * np], ah, al, fh[0], fh[1], fl[0], fl[1]);
    mma::mma_tf32x3(acc[2 * np + 1], ah, al, fh[2], fh[3], fl[2], fl[3]);"""
DWP_LAUNCH = "  kb<<<parts, C / 16 * 32, dwp_tf32_smem(C), stream>>>("
DZ_LAUNCH = ("  ka<<<dim3(dz_chunks(Hp, C), BT), warps * 32, L.total, stream>>>(\n"
             "      static_cast<const float*>(x)")
DZ_LOOP = """  for (int hl = 0; hl < nrows; ++hl) {
    const size_t rowbase = ((size_t)bt * Hp + h0 + hl) * Wp * C + (size_t)w0 * C;
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    // spectral branch: EW (16 x K3)"""
DZ_H = """  // ---- adjoint H into sdx[hl][c][part*M3 + m]
  fno_tf32::h_stage<C, M3, kRows>(dy,"""
DZ_LD = """          const float2 dv = *reinterpret_cast<const float2*>(ds + at);
          const float2 sv = *reinterpret_cast<const float2*>(s + at);"""
PF = """__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n" ::"l"(p), "r"(bytes) : "memory");
}
"""


def dz_prefetch(s: str) -> str:
    s = sub(s, "using fno_tf32::kTPad;\nconstexpr int kTilePosT", PF + "using fno_tf32::kTPad;\n"
            "constexpr int kTilePosT")
    s = sub(s, DZ_H, """  {   // the first row's x, s and ds into L2 while the H stage runs
    const int w0p = warp * 16;
    if (lane == 0 && w0p < Wp) {
      const size_t rb = ((size_t)bt * Hp + h0) * Wp * C + (size_t)w0p * C;
      const uint32_t nb = (uint32_t)(min(16, Wp - w0p) * C * 4);
      prefetch_l2(x + rb, nb);
      prefetch_l2(s + rb, nb);
      prefetch_l2(ds + rb, nb);
    }
  }
""" + DZ_H)
    return sub(s, DZ_LOOP, DZ_LOOP.replace("    // spectral branch: EW (16 x K3)", """    if (lane == 0 && hl + 1 < nrows && w0 < Wp) {   // the next row's, into L2
      const uint32_t nb = (uint32_t)(min(16, Wp - w0) * C * 4);
      prefetch_l2(x + rowbase + (size_t)Wp * C, nb);
      prefetch_l2(s + rowbase + (size_t)Wp * C, nb);
      prefetch_l2(ds + rowbase + (size_t)Wp * C, nb);
    }
    // spectral branch: EW (16 x K3)"""))


# name: (source, header patch, source patch, computes what the kernel computes)
VARIANTS = {
    "k2_as_is": ("fno_k2.cu", None, lambda s: s, True),
    "k2_minb1": ("fno_k2.cu", None,
                 lambda s: sub(s, "  K2_TF32(64, 2, 9, 2);", "  K2_TF32(64, 2, 9, 1);"), True),
    "k2_cut_act": ("fno_k2.cu", None, lambda s: sub(
        s, K2_ACT, "          mma::split_tf32(__uint_as_float(xr[r]), zh[r], zl[r]);"), False),
    "k2_cut_bsplit": ("fno_k2.cu", lambda h: sub(
        h, BSPLIT, "    for (int i = 0; i < 4; ++i) fh[i] = fb[i], fl[i] = 0u;\n"),
        lambda s: s, False),
    "k2_cut_mma": ("fno_k2.cu", lambda h: sub(
        h, BT_MMA, "    acc[2 * np][0] += __uint_as_float(ah[0] ^ fh[0] ^ fl[1] ^ al[2]);\n"
                   "    acc[2 * np + 1][1] += __uint_as_float(ah[1] ^ fh[2] ^ fl[3] ^ al[3]);",
        count=2), lambda s: s, False),
    "k12b_as_is": ("fno_k12b.cu", None, lambda s: s, True),
    "k12b_dz": ("fno_k12b.cu", None,
                lambda s: sub(s, DWP_LAUNCH, "  if (0) " + DWP_LAUNCH.lstrip()), False),
    "k12b_dwp": ("fno_k12b.cu", None,
                 lambda s: sub(s, DZ_LAUNCH, "  if (0) " + DZ_LAUNCH.lstrip()), False),
    "k12b_dz_minb1": ("fno_k12b.cu", None,
                      lambda s: sub(s, "  K12B_TF32(64, 2, 9, 2);", "  K12B_TF32(64, 2, 9, 1);"),
                      True),
    "k12b_dz_pf": ("fno_k12b.cu", None, dz_prefetch, True),
    "k12b_dz_cut_ld": ("fno_k12b.cu", None, lambda s: sub(
        s, DZ_LD, "          const float2 dv = make_float2(c1.y, c2.x), sv = make_float2(c2.y, "
                  "c1.x);"), False),
}


def build(names):
    """The patched copies of each variant, built all at once."""
    header = (kernels.CSRC / "fno_tf32.cuh").read_text()
    files = {}
    for name in names:
        source, hpatch, spatch, _ = VARIANTS[name]
        files[name] = {source: spatch((kernels.CSRC / source).read_text()),
                       "fno_tf32.cuh": hpatch(header) if hpatch else header}
    return common.build(OUT, files)


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    built = build(names)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    geo = dict(Hp=HP, Wp=WP, m2=M2, m3=M3)
    cst = fl._ct_on(dev, HP, WP, M2, M3)
    x, x2 = rn(BT, HP * WP // 2, 2 * C), rn(BT, HP * WP // 2, 2 * C)
    a, b, wp, bp = 1 + 0.1 * rn(C), 0.1 * rn(C), rn(C, C) / C ** 0.5, 0.1 * rn(C)
    gsp = rn(BT, 2 * M2 * M3, 2 * C)
    npos = BT * HP * WP
    s = rn(BT, HP * WP // 2, 2 * C)
    ds, dy = rn(*s.shape) / npos, rn(*gsp.shape) / npos
    ds1, ds2 = rn(C) / npos, rn(C) / npos
    calls = {
        "fno_k2.cu": lambda: fl.k2(gsp, x, a, b, wp, bp, **geo, act="exact", variant="tf32"),
        "fno_k12b.cu": lambda: fl.k12b(x2, a, b, wp, s, ds, ds1, ds2, dy, **geo, act="exact",
                                       variant="tf32"),
    }
    s_ref, st_ref = fl.k2_plain(gsp, x, a, b, wp, bp, cst, Hp=HP, Wp=WP, act="exact")
    sr = s_ref.view(-1, C)
    k2_terms = torch.stack([sr.abs().sum(0), (sr * sr).sum(0)])
    del sr
    ref12 = fl.k12b_plain(x2, a, b, wp, s, ds, ds1, ds2, dy, cst, Hp=HP, Wp=WP, act="exact")
    v = lambda q: q.view(-1, C)
    z = fl._act(v(x2) * a + b, "exact")
    dse = v(ds) + ds1 + 2.0 * ds2 * v(s)
    du = v(ref12[0]) / a
    k12_terms = (z.abs().t() @ dse.abs(), (du * v(x2)).abs().sum(0), du.abs().sum(0),
                 dse.abs().sum(0))
    del z, dse, du
    real_library = kernels.library
    times = {n: [] for n in names}
    rows = {}
    for order in (names, names[::-1]):
        for name in order:
            lib, report = built[name]
            source, _, _, computes = VARIANTS[name]
            kernels.library = lambda lib=lib: lib
            try:
                fn = calls[source]
                times[name].append(queued_ms([fn], n=6, reps=5))
                if name in rows:
                    continue
                kern = ("k2_tf32_kernelILi64ELi2ELi9ELi" if source == "fno_k2.cu"
                        else "k12b_dz_tf32_kernelILi64ELi2ELi9ELi")
                row = dict(variant=name, **registers(report, kern))
                if source == "fno_k12b.cu":
                    row["dwp"] = registers(report, "k12b_dwp_tf32_kernelILi64E")
                if computes:
                    out = fn()
                    torch.cuda.synchronize()
                    if source == "fno_k2.cu":
                        errs = [((out[0] - s_ref).abs().max() / s_ref.abs().max()).item(),
                                ((out[1] - st_ref).abs() / k2_terms).max().item()]
                    else:
                        errs = [((out[0] - ref12[0]).abs().max() / ref12[0].abs().max()).item()]
                        errs += [((u - w).abs() / t.clamp_min(1e-30)).max().item()
                                 for u, w, t in zip(out[1:], ref12[1:], k12_terms)]
                    row["worst_rel_err"] = max(errs)
                rows[name] = row
            finally:
                kernels.library = real_library
    for name in names:
        print(json.dumps(dict(rows[name], ms=times[name],
                              device=torch.cuda.get_device_name(0))), flush=True)


if __name__ == "__main__":
    main()
