#!/usr/bin/env python3
"""Where the time of the tf32 variants of K2, K12B, K1 and K2A-lite goes, and
what a change would buy, without a profiler that reads hardware counters:
patched scratch copies of ``csrc/fno_k2.cu`` or ``csrc/fno_k12b.cu`` (and of
the ``fno_tf32.cuh`` they share), or of ``csrc/fno_k1.cu`` or
``csrc/fno_k2a.cu`` (and of the ``fno_dft_tf32.cuh`` they share), each
header placed beside its source, are built with nvcc into
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
  k1_as_is         K1, the source unchanged
  k1_w_only        K1's W product alone: no copies into the ring, no H fold
                   (time only; so are the four below)
  k1_h_only        K1's H fold alone: no copies, no W product
  k1_fetch_only    the copies into the ring alone: no W product, no H fold
  k1_cut_act       the activation cut (the affine stays)
  k2a_lite_as_is   K2A-lite, the source unchanged
  k2a_lite_w_only, k2a_lite_h_only, k2a_lite_fetch_only   as K1's
  k2a_lite_epi_only  the correction epilogue alone (y @ wps and the
                   elementwise terms, on zero accumulators)
  k2a_lite_cut_epi   the epilogue's y @ wps product cut
  k2a_lite_epi_cut_y, k2a_lite_epi_cut_mma   the epilogue alone with its
                   loads of y, or its MMAs, cut
  k1_cvt_split, k2_cvt_split, k2a_lite_cvt_split, k12b_cvt_split   the
                   kernel with both of mma.cuh's tf32 roundings by
                   cvt.rna.tf32.f32, as before hi's integer rounding (the
                   same bits on finite values; every header copied beside
                   the source, mma.cuh patched)

One JSON line a variant: ptxas's registers and spill bytes of the tf32
kernel at <64, 2, 9, 2> (the dWp pass at <64>; K1's and K2A-lite's at
<16, 3>), the device time of queued
launches (median of 5, 6 launches each, taken twice: in the listed order
and in reverse), and, for the variants that compute what the kernel
computes, the outputs' worst relative error against the plain twin (s, dx,
y and dg to max|ref|, the sums to their sum of |terms|). The patches fail
loudly when their anchors are gone.
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
# the header each source's tf32 variant takes its shared parts from
HEADER = {"fno_k2.cu": "fno_tf32.cuh", "fno_k12b.cu": "fno_tf32.cuh",
          "fno_k1.cu": "fno_dft_tf32.cuh", "fno_k2a.cu": "fno_dft_tf32.cuh"}

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


# fno_dft_tf32.cuh: the copies into a warp's ring, the W product's and the H
# fold's k-steps, K1's activation
WH_FETCH = """    for (int i = lane; i < 4 * len; i += 32)
      mma::cp_async_16(dst + ring_at(i >> 2, 4 * (i & 3)), src + (size_t)(i >> 2) * C + 4 * (i & 3));
"""
WH_W = "        for (int ks = 0; ks < nks; ++ks) {   // W product"
WH_H = "    for (int ks = 0; ks < 2; ++ks) {   // H fold"
WH_ACT = "              if (kAffine) v = fno::affine_act_fast(v, av[t], bv[t], act);"
# fno_k2a.cu: K2A-lite's tf32 kernel body and its epilogue's product
K2AL_BODY = """  dfttf32::wh_tf32_body<M3, MTH, false>(ds, nullptr, nullptr, iw, ih, epi, Hp, Wp, C,
                                        fno::kActNone);"""
K2AL_EPI_ONLY = """  extern __shared__ __align__(16) unsigned char smem_raw[];
  float acc[MTH][2 * M3 / 8][4] = {};
  epi.stage(smem_raw + epi.smem_off, threadIdx.x);
  __syncthreads();
  epi(acc, blockIdx.y, blockIdx.x * dfttf32::kSlice, threadIdx.x >> 5, threadIdx.x & 31);"""
K2AL_YW = "      for (int kp = 0; kp < C / 16; ++kp) {   // y @ wps"
K2AL_Y = """              ya[mi][hf] = __ldg(reinterpret_cast<const float4*>(
                  y + img + (size_t)(j * M3 + mbase + mi) * C2 + part * C + kp * 16 + 4 * q));"""
K2AL_MMA = "            mma::mma_tf32x3(yw[2 * mi + t], ah, al, bh[t][0], bh[t][1], bl[t][0], bl[t][1]);"


def epi_only(*cuts):
    """A patch of fno_k2a.cu: K2A-lite's epilogue alone, its loads of y
    ('y') or its MMAs ('mma') cut."""
    def patch(s: str) -> str:
        s = sub(s, K2AL_BODY, K2AL_EPI_ONLY)
        if "y" in cuts:
            s = sub(s, K2AL_Y, "              ya[mi][hf] = make_float4(1.f + kp, 1.f, 1.f, 1.f);")
        if "mma" in cuts:
            s = sub(s, K2AL_MMA, "            yw[2 * mi + t][0] += __uint_as_float(ah[0] ^ al[1] ^ "
                                 "bh[t][0] ^ bl[t][1]);")
        return s
    return patch


def wh_cut(*parts):
    """A patch of fno_dft_tf32.cuh that cuts the named parts: 'fetch', 'w',
    'h'."""
    def patch(h: str) -> str:
        if "fetch" in parts:
            h = sub(h, WH_FETCH, "    (void)dst; (void)src; (void)len;\n")
        if "w" in parts:
            h = sub(h, WH_W, WH_W.replace("ks < nks", "ks < 0 * nks"))
        if "h" in parts:
            h = sub(h, WH_H, WH_H.replace("ks < 2", "ks < 0"))
        return h
    return patch


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
    "k1_as_is": ("fno_k1.cu", None, lambda s: s, True),
    "k1_w_only": ("fno_k1.cu", wh_cut("fetch", "h"), lambda s: s, False),
    "k1_h_only": ("fno_k1.cu", wh_cut("fetch", "w"), lambda s: s, False),
    "k1_fetch_only": ("fno_k1.cu", wh_cut("w", "h"), lambda s: s, False),
    "k1_cut_act": ("fno_k1.cu", lambda h: sub(
        h, WH_ACT, "              if (kAffine) v = fmaf(av[t], v, bv[t]);"), lambda s: s, False),
    "k2a_lite_as_is": ("fno_k2a.cu", None, lambda s: s, True),
    "k2a_lite_w_only": ("fno_k2a.cu", wh_cut("fetch", "h"), lambda s: s, False),
    "k2a_lite_h_only": ("fno_k2a.cu", wh_cut("fetch", "w"), lambda s: s, False),
    "k2a_lite_fetch_only": ("fno_k2a.cu", wh_cut("w", "h"), lambda s: s, False),
    "k2a_lite_epi_only": ("fno_k2a.cu", None, epi_only(), False),
    "k2a_lite_epi_cut_y": ("fno_k2a.cu", None, epi_only("y"), False),
    "k2a_lite_epi_cut_mma": ("fno_k2a.cu", None, epi_only("mma"), False),
    "k2a_lite_cut_epi": ("fno_k2a.cu", None,
                         lambda s: sub(s, K2AL_YW, K2AL_YW.replace("kp < C / 16", "kp < 0")),
                         False),
}
for _k, _src in (("k1", "fno_k1.cu"), ("k2", "fno_k2.cu"), ("k2a_lite", "fno_k2a.cu"),
                 ("k12b", "fno_k12b.cu")):
    VARIANTS[f"{_k}_cvt_split"] = (_src, None, lambda s: s, True)
# variants that patch csrc/mma.cuh (every header is then copied beside the
# source, so each include finds the patched copy)
MMA_PATCHES = {name: common.split_form("cvt") for name in VARIANTS if name.endswith("_cvt_split")}
# the tf32 kernel whose ptxas report each source's row shows
KERNEL_TAG = {"fno_k2.cu": "k2_tf32_kernelILi64ELi2ELi9ELi",
              "fno_k12b.cu": "k12b_dz_tf32_kernelILi64ELi2ELi9ELi",
              "fno_k1.cu": "k1_tf32_kernelILi16ELi3E",
              "fno_k2a.cu": "k2a_lite_tf32_kernelILi16ELi3E"}


def build(names):
    """The patched copies of each variant, built all at once."""
    files = {}
    for name in names:
        source, hpatch, spatch, _ = VARIANTS[name]
        header = (kernels.CSRC / HEADER[source]).read_text()
        files[name] = {source: spatch((kernels.CSRC / source).read_text()),
                       HEADER[source]: hpatch(header) if hpatch else header}
        if name in MMA_PATCHES:
            for h in kernels.CSRC.glob("*.cuh"):
                files[name].setdefault(h.name, h.read_text())
            files[name]["mma.cuh"] = MMA_PATCHES[name](files[name]["mma.cuh"])
    return common.build(OUT, files)


def references(sources, inputs) -> dict:
    """{source: (call of the tf32 variant, its outputs' errors against the
    plain twin)} for the sources the variants named build, the twins
    computed once each."""
    x, x2, a, b, wp, bp, gsp, yk, s, ds, dy, ds1, ds2 = inputs
    geo = dict(Hp=HP, Wp=WP, m2=M2, m3=M3)
    cst = fl._ct_on(x.device, HP, WP, M2, M3)
    rel = lambda u, w: ((u - w).abs().max() / w.abs().max()).item()
    out = {}
    if "fno_k2.cu" in sources:
        s_ref, st_ref = fl.k2_plain(gsp, x, a, b, wp, bp, cst, Hp=HP, Wp=WP, act="exact")
        sr = s_ref.view(-1, C)
        terms = torch.stack([sr.abs().sum(0), (sr * sr).sum(0)])
        del sr
        out["fno_k2.cu"] = (
            lambda: fl.k2(gsp, x, a, b, wp, bp, **geo, act="exact", variant="tf32"),
            lambda o: [rel(o[0], s_ref), ((o[1] - st_ref).abs() / terms).max().item()])
    if "fno_k12b.cu" in sources:
        ref12 = fl.k12b_plain(x2, a, b, wp, s, ds, ds1, ds2, dy, cst, Hp=HP, Wp=WP, act="exact")
        v = lambda q: q.view(-1, C)
        z = fl._act(v(x2) * a + b, "exact")
        dse = v(ds) + ds1 + 2.0 * ds2 * v(s)
        du = v(ref12[0]) / a
        terms12 = (z.abs().t() @ dse.abs(), (du * v(x2)).abs().sum(0), du.abs().sum(0),
                   dse.abs().sum(0))
        del z, dse, du
        out["fno_k12b.cu"] = (
            lambda: fl.k12b(x2, a, b, wp, s, ds, ds1, ds2, dy, **geo, act="exact",
                            variant="tf32"),
            lambda o: [rel(o[0], ref12[0])] + [((u - w).abs() / t.clamp_min(1e-30)).max().item()
                                               for u, w, t in zip(o[1:], ref12[1:], terms12)])
    if "fno_k1.cu" in sources:
        y_ref = fl.k1_plain(x, a, b, cst, Hp=HP, Wp=WP, act="exact")
        out["fno_k1.cu"] = (lambda: fl.k1(x, a, b, **geo, act="exact", variant="tf32"),
                            lambda o: [rel(o, y_ref)])
    if "fno_k2a.cu" in sources:
        lite = fl._lite_on(x.device, HP, WP, M2, M3)
        dg_ref = fl.k2a_lite_plain(ds, gsp, yk, ds1, ds2, wp, bp, lite, cst, Hp=HP, Wp=WP)
        out["fno_k2a.cu"] = (
            lambda: fl.k2a_lite(ds, gsp, yk, ds1, ds2, wp, bp, **geo, variant="tf32"),
            lambda o: [rel(o, dg_ref)])
    return out


def main() -> None:
    names = sys.argv[1:] or list(VARIANTS)
    built = build(names)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    x, x2 = rn(BT, HP * WP // 2, 2 * C), rn(BT, HP * WP // 2, 2 * C)
    a, b, wp, bp = 1 + 0.1 * rn(C), 0.1 * rn(C), rn(C, C) / C ** 0.5, 0.1 * rn(C)
    gsp, yk = rn(BT, 2 * M2 * M3, 2 * C), 3.0 * rn(BT, 2 * M2 * M3, 2 * C)
    npos = BT * HP * WP
    s = rn(BT, HP * WP // 2, 2 * C)
    ds, dy = rn(*s.shape) / npos, rn(*gsp.shape) / npos
    ds1, ds2 = rn(C) / npos, rn(C) / npos
    refs = references({VARIANTS[n][0] for n in names},
                      (x, x2, a, b, wp, bp, gsp, yk, s, ds, dy, ds1, ds2))
    real_library = kernels.library
    times = {n: [] for n in names}
    rows = {}
    for order in (names, names[::-1]):
        for name in order:
            lib, report = built[name]
            source, _, _, computes = VARIANTS[name]
            kernels.library = lambda lib=lib: lib
            try:
                fn, errors = refs[source]
                times[name].append(queued_ms([fn], n=6, reps=5))
                if name in rows:
                    continue
                row = dict(variant=name, **registers(report, KERNEL_TAG[source]))
                if source == "fno_k12b.cu":
                    row["dwp"] = registers(report, "k12b_dwp_tf32_kernelILi64E")
                if computes:
                    out = fn()
                    torch.cuda.synchronize()
                    row["worst_rel_err"] = max(errors(out))
                rows[name] = row
            finally:
                kernels.library = real_library
    for name in names:
        print(json.dumps(dict(rows[name], ms=times[name],
                              device=torch.cuda.get_device_name(0))), flush=True)


if __name__ == "__main__":
    main()
