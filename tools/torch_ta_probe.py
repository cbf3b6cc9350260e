#!/usr/bin/env python3
"""Where the time of the TA kernels' tensor-core variants goes, and what a
change would buy, without a profiler that reads hardware counters: patched
scratch copies of ``csrc/temporal_attention.cu`` are built with nvcc into
``build/ta_probe/`` (all at once) and launched through ctypes at the UNet's
level 0 in the training step (B 12, S 8192, T 20, h 4, d 32; bf16 for the
mma variants, f32 for the tf32 ones).

    PYTHONPATH=. python3 tools/torch_ta_probe.py [--parent ROOT] [VARIANT ...]

From the repository root on a host with a Hopper card and nvcc. Variants
(all by default but ``parent``), each a set of patches of the source as it
is; those named ``fwd_*`` launch the forward, the others the backward:

  as_is         the source unchanged
  parent        the backward of ROOT's source, unchanged (``--parent``: a
                checkout of another commit, for example a ``git archive``
                under ``build/``), against which as_is is timed
  stages3       a ring of three sites a block (two in flight) instead of two
  stages4       four
  flush64       dpb's f32 sums flushed every 64 sites instead of 16
  cut_store     dq, dk and dv computed into shared memory but not written
                out (time only)
  cut_tiles     dk and dv not computed (time only)
  fetch_only    the ring's copies and barriers, no compute (time only)
  fwd_as_is     the forward, unchanged
  fwd_p_once    P rounded once to bf16, one MMA of P v instead of hi + lo
  fwd_stages3   the forward's ring of three sites
  fwd_cut_store o computed into shared memory but not written out (time only)
  fwd_fetch_only the forward's copies and barriers, no compute (time only)
  tf32_as_is    the backward's tf32 variant, unchanged
  tf32_stages3  its ring of three sites (one block an SM)
  tf32_flush64  its dpb sums flushed every 64 sites
  tf32_cut_store  dq, dk and dv computed into shared memory but not written
                out (time only)
  tf32_fetch_only its copies and barriers, no compute (time only)
  tf32_products_only its products alone: no site fetched past the first
                stage, nothing written out (time only)
  fwd_tf32_as_is, fwd_tf32_cut_store, fwd_tf32_fetch_only,
  fwd_tf32_products_only  the same for the forward's tf32 variant

One JSON line a variant: ptxas's registers and spill bytes of
``ta_bwd_mma_kernel<32, 3>`` (``ta_fwd_mma_kernel<32, 3>`` for the forward;
``ta_*_tf32_kernel<32, 3>`` for the tf32 variants),
the shared memory of a block, the device time of queued launches (median of
5, 8 launches each, taken twice: in the listed order and in reverse), and,
for the variants that compute what the kernel computes, the worst of dq, dk
and dv as max|Δ| / max|ref| against autograd through the plain twin and dpb
against it relative to the sum of |terms| (the forward: o as max|Δ| /
max|ref| against the twin). The patches fail loudly when their anchors are
gone.
"""

import ctypes
import json
import sys
from pathlib import Path

import torch

import torch_probe_common as common
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops import temporal_attention as tta
from torch_probe_common import queued_ms, sub

OUT = kernels.BUILD_DIR.parent / "ta_probe"
B, S, T, HEADS, D = 12, 8192, 20, 4, 32

STAGES = "constexpr int kTaStages = 2;"
FLUSH = "constexpr int kTaFlush = 16;"
STORE = "    for (int i = threadIdx.x; i < 3 * T * (F / 8); i += nthreads) {"
TILES = "    tile_product(Qs, Qs);         // dk = dS^T q, into q's slot"
TILES_V = "    tile_product(Vs, Os);         // dv = P^T do, into v's slot (read last by dP)"
COMPUTE = "    bf16* const Qs = ring + stage * 4 * slab + warp * D;"
FWD_STORE = "    for (int i = threadIdx.x; i < T * (F / 8); i += nthreads) {"
FWD_COMPUTE = "    bf16* const Qs = ring + stage * 3 * slab + warp * D;"
FWD_LO = ("            mma::mma_bf16(acc[mi][2 * cp], al, fb[0], fb[1]);\n",
          "            mma::mma_bf16(acc[mi][2 * cp + 1], al, fb[2], fb[3]);\n")
# the tf32 variants' (ta_bwd_tf32_kernel, ta_fwd_tf32_kernel)
TF32_STAGES = "constexpr int kTaTf32Stages = 2;"
TF32_STORE = "    for (int i = threadIdx.x; i < 3 * T * (F / 4); i += nthreads) {"
TF32_COMPUTE = "    float* const Qs = ring + stage * 4 * slab + warp * D;"
TF32_FETCH = "    if (ahead < nsites) fetch(ahead, (it + kTaTf32Stages - 1) % kTaTf32Stages);"
FWD_TF32_STORE = "    for (int i = threadIdx.x; i < T * (F / 4); i += nthreads) {"
FWD_TF32_COMPUTE = "    float* const Qs = ring + stage * 3 * slab + warp * D;"


def _no_fetch(s: str) -> str:
    """The tf32 kernels with no site fetched past the first stage: each
    computes on the stage it holds."""
    return sub(s, TF32_FETCH, TF32_FETCH.replace("if (ahead < nsites)", "if (false)"), 2)


# name: (patch, computes what the kernel computes, launches the forward,
# launches the tf32 variant on f32 tensors)
VARIANTS = {
    "as_is": (lambda s: s, True, False, False),
    "parent": (None, True, False, False),
    "stages3": (lambda s: sub(s, STAGES, "constexpr int kTaStages = 3;"), True, False, False),
    "stages4": (lambda s: sub(s, STAGES, "constexpr int kTaStages = 4;"), True, False, False),
    "flush64": (lambda s: sub(s, FLUSH, "constexpr int kTaFlush = 64;"), True, False, False),
    "cut_store": (lambda s: sub(s, STORE, STORE.replace("3 * T", "0 * T")), False, False,
                  False),
    "cut_tiles": (lambda s: sub(sub(s, TILES, ""), TILES_V, ""), False, False, False),
    "fetch_only": (lambda s: sub(s, COMPUTE, "    continue;\n" + COMPUTE), False, False, False),
    "fwd_as_is": (lambda s: s, True, True, False),
    "fwd_p_once": (lambda s: sub(sub(s, FWD_LO[0], ""), FWD_LO[1], ""), True, True, False),
    "fwd_stages3": (lambda s: sub(s, STAGES, "constexpr int kTaStages = 3;"), True, True, False),
    "fwd_cut_store": (lambda s: sub(s, FWD_STORE, FWD_STORE.replace("T * (F", "0 * (F")),
                      False, True, False),
    "fwd_fetch_only": (lambda s: sub(s, FWD_COMPUTE, "    continue;\n" + FWD_COMPUTE), False,
                       True, False),
    "tf32_as_is": (lambda s: s, True, False, True),
    "tf32_stages3": (lambda s: sub(s, TF32_STAGES, "constexpr int kTaTf32Stages = 3;"), True,
                     False, True),
    "tf32_flush64": (lambda s: sub(s, FLUSH, "constexpr int kTaFlush = 64;"), True, False, True),
    "tf32_cut_store": (lambda s: sub(s, TF32_STORE, TF32_STORE.replace("3 * T", "0 * T")),
                       False, False, True),
    "tf32_fetch_only": (lambda s: sub(s, TF32_COMPUTE, "    continue;\n" + TF32_COMPUTE),
                        False, False, True),
    "tf32_products_only": (lambda s: sub(_no_fetch(s), TF32_STORE,
                                         TF32_STORE.replace("3 * T", "0 * T")),
                           False, False, True),
    "fwd_tf32_as_is": (lambda s: s, True, True, True),
    "fwd_tf32_cut_store": (lambda s: sub(s, FWD_TF32_STORE,
                                         FWD_TF32_STORE.replace("T * (F", "0 * (F")),
                           False, True, True),
    "fwd_tf32_fetch_only": (lambda s: sub(s, FWD_TF32_COMPUTE,
                                          "    continue;\n" + FWD_TF32_COMPUTE),
                            False, True, True),
    "fwd_tf32_products_only": (lambda s: sub(_no_fetch(s), FWD_TF32_STORE,
                                             FWD_TF32_STORE.replace("T * (F", "0 * (F")),
                               False, True, True),
}


def build(names, parent):
    """The patched copies of each variant (the parent's source as it is),
    built all at once."""
    src = (kernels.CSRC / "temporal_attention.cu").read_text()
    files, includes = {}, {}
    for name in names:
        patch = VARIANTS[name][0]
        if patch:
            files[name] = {"temporal_attention.cu": patch(src)}
        else:
            includes[name] = Path(parent) / "realpdebench_tpu_torch" / "csrc"
            files[name] = {"temporal_attention.cu":
                           (includes[name] / "temporal_attention.cu").read_text()}
    return common.build(OUT, files, includes)


def registers(report: str, kernel: str) -> dict:
    """Registers and spill bytes ptxas reported for ``kernel``<32, 3>."""
    return common.registers(report, f"{kernel}ILi32ELi3E")


def main() -> None:
    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = args[1], args[2:]
    names = args or [n for n in VARIANTS if n != "parent"]
    if "parent" in names and parent is None:
        raise SystemExit("torch_ta_probe: the parent variant needs --parent ROOT")
    libs = build(names, parent)
    dev = torch.device("cuda", 0)
    inputs = {dtype: _inputs(dev, dtype) for dtype in
              {torch.float32 if VARIANTS[n][3] else torch.bfloat16 for n in names}}
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def runner(lib, fwd, tf32):
        (q, k, v, pb, do), _ = inputs[torch.float32 if tf32 else torch.bfloat16]
        code, dt = (2, 0) if tf32 else (1, 1)   # the variant's code and the dtype's
        if fwd:
            o = torch.empty_like(q)

            def fn():
                err = lib.ta_fwd(ptr(q), ptr(k), ptr(v), ptr(pb), ptr(o), B * S, T, HEADS, D, code,
                                 dt, stream)
                if err:
                    raise SystemExit(f"torch_ta_probe: launch failed ({err})")
                return o
            return fn, None
        nparts = lib.ta_bwd_num_partials(B * S, T, HEADS, D, code, dt)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        partial = torch.empty((nparts, HEADS, T, T), dtype=torch.float32, device=dev)
        dpb = torch.empty((HEADS, T, T), dtype=torch.float32, device=dev)

        def fn():
            err = lib.ta_bwd(ptr(q), ptr(k), ptr(v), ptr(pb), ptr(do), ptr(dq), ptr(dk),
                             ptr(dv), ptr(partial), ptr(dpb), B * S, T, HEADS, D, code, dt,
                             stream)
            if err:
                raise SystemExit(f"torch_ta_probe: launch failed ({err})")
            return dq, dk, dv, dpb
        return fn, nparts

    fns = {name: runner(lib, *VARIANTS[name][2:]) for name, (lib, _) in libs.items()}
    times = {name: [] for name in names}
    for order in (names, names[::-1]):
        for name in order:
            times[name].append(queued_ms([fns[name][0]], n=8, reps=5))
    for name in names:
        lib, report = libs[name]
        _, computes, fwd, tf32 = VARIANTS[name]
        kind = "tf32" if tf32 else "mma"
        kernel = f"ta_{'fwd' if fwd else 'bwd'}_{kind}_kernel"
        smem = getattr(lib, f"ta_{'fwd' if fwd else 'bwd'}_{kind}_smem_bytes")(T, HEADS, D)
        row = dict(variant=name, **registers(report, kernel), smem_bytes=smem,
                   blocks=fns[name][1], ms=times[name])
        if computes:
            got = fns[name][0]()
            torch.cuda.synchronize()
            _, (o_ref, ref, terms) = inputs[torch.float32 if tf32 else torch.bfloat16]
            if fwd:
                row["o_rel"] = ((got.float() - o_ref).abs().max() / o_ref.abs().max()).item()
            else:
                row["dqkv_rel"] = max(((u.float() - r).abs().max() / r.abs().max()).item()
                                      for u, r in zip(got[:3], ref[:3]))
                row["dpb_rel_to_terms"] = ((got[3] - ref[3]).abs()
                                           / terms.clamp_min(1e-30)).max().item()
        print(json.dumps(row), flush=True)


def _inputs(dev, dtype):
    """((q, k, v, pb, do) in dtype, (o, the gradients and dpb's sum of
    |terms| through the plain twin in f32)) at the UNet's level 0."""
    g = torch.Generator(device=dev).manual_seed(5)
    rn = lambda: torch.randn(B, S, T, HEADS * D, generator=g, device=dev)
    q = (rn() * D ** -0.5).to(dtype)
    k, v, do = rn().to(dtype), rn().to(dtype), rn().to(dtype)
    pb = torch.randn(HEADS, T, T, generator=g, device=dev)
    o_ref = tta.temporal_attention_tokens_plain(q, k, v, pb, HEADS).float()
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v, pb)]
    ref = torch.autograd.grad(tta.temporal_attention_tokens_plain(*leaves, HEADS), leaves,
                              do.float())
    spl = lambda z: z.float().view(B, S, T, HEADS, D)
    with torch.no_grad():
        p = torch.softmax(torch.einsum("bsihd,bsjhd->bshij", spl(q), spl(k)) + pb, dim=-1)
        dp = torch.einsum("bsihd,bsjhd->bshij", spl(do), spl(v))
        terms = (p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())).sum((0, 1))
    return (q, k, v, pb, do), (o_ref, ref, terms)


if __name__ == "__main__":
    main()
