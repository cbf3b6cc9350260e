"""What the port's kernel probes (tools/torch_*_probe.py) share: patching a
scratch copy of a CUDA source, building the copies with nvcc all at once,
reading ptxas's register report, and the device time of queued launches
(chip_smoke.queued_ms). Each probe keeps only its own patches and calls.
Run the probes from the repository root with ``PYTHONPATH=.``."""

import ctypes
import subprocess
import sys
from pathlib import Path

from chip_smoke import queued_ms  # noqa: F401  (re-exported for the probes)
from realpdebench_tpu_torch.ops import kernels

PROBE = Path(sys.argv[0]).stem

# csrc/mma.cuh: to_tf32's body and split_tf32's, and what the probes put in
# their place: to_tf32 testing for Inf and NaN; the split with both roundings
# by to_tf32 or by cvt_tf32, or lo's NaN kept by an FMA instead of cvt_tf32
TF32_RNA = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
TESTED_RNA = ("  const uint32_t bits = __float_as_uint(v);\n"
              "  const uint32_t half = (bits & 0x7f800000u) == 0x7f800000u ? 0u : 0x1000u;\n"
              "  return (bits + half) & 0xffffe000u;\n")
SPLIT = "  hi = to_tf32(v);\n  lo = cvt_tf32(v - __uint_as_float(hi));\n"
PLAIN_SPLIT = "  hi = to_tf32(v);\n  lo = to_tf32(v - __uint_as_float(hi));\n"
SPLITS = {
    "bare": PLAIN_SPLIT,
    "cvt": "  hi = cvt_tf32(v);\n  lo = cvt_tf32(v - __uint_as_float(hi));\n",
    "tested": PLAIN_SPLIT,
    "fma": ("  hi = to_tf32(v);\n  const float d = v - __uint_as_float(hi);\n"
            "  lo = __float_as_uint(__fmaf_rn(d, 0.f, __uint_as_float(to_tf32(d))));\n"),
}


def sub(s: str, old: str, new: str, count: int = 1) -> str:
    """``s`` with the ``count`` copies of the anchor ``old`` replaced; stops
    the probe when the source holds another number of them."""
    if s.count(old) != count:
        raise SystemExit(f"{PROBE}: the source has {s.count(old)} of the anchor {old!r}")
    return s.replace(old, new)


def split_form(form: str):
    """A patch of csrc/mma.cuh: its tf32 split in another form. 'bare': lo
    by to_tf32 too (a NaN lost); 'cvt': both by cvt_tf32 (the split before
    the integer rounding); 'tested': both by a to_tf32 that tests for Inf
    and NaN; 'fma': lo by to_tf32 with d·0 added by an FMA (d = v - hi)."""
    def patch(s: str) -> str:
        s = sub(s, SPLIT, SPLITS[form])
        return sub(s, TF32_RNA, TESTED_RNA) if form == "tested" else s
    return patch


def build(out: Path, files: dict, includes: dict | None = None) -> dict:
    """One nvcc per variant, all at once. ``files`` maps a variant to the
    files written into ``out/<variant>/`` ({name: text}); the one ``.cu``
    among them is built into a shared library, with ``includes[variant]``
    (by default the port's csrc/) after its own directory on the include
    path. Returns {variant: (library, ptxas report)}, every entry point of
    kernels.SIGNATURES that the library exports bound to its signature."""
    nvcc = kernels._nvcc()
    jobs = {}
    for name, texts in files.items():
        include = (includes or {}).get(name, kernels.CSRC)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        (cu,) = (fname for fname in texts if fname.endswith(".cu"))
        so = d / "libprobe.so"
        cmd = [nvcc, *kernels.NVCC_FLAGS, "-I", str(include), "-shared", "-o", str(so),
               str(d / cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{PROBE}: nvcc failed for {name}:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(so))
        for fn, sig in kernels.SIGNATURES.items():
            f = getattr(lib, fn, None)
            if f is not None:
                f.argtypes, f.restype = sig
        libs[name] = (lib, err)
    return libs


def registers(report: str, tag: str) -> dict:
    """Registers and spill bytes ptxas reported for the first entry whose
    mangled name holds ``tag``."""
    out, inside = {}, False
    for line in report.splitlines():
        if "Compiling entry function" in line:
            if inside:
                break
            inside = tag in line
        elif inside and "spill" in line:
            out["spill"] = line.strip()
        elif inside and "Used" in line and "registers" in line:
            out["registers"] = int(line.split("Used")[1].split()[0])
    return out
