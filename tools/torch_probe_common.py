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


def sub(s: str, old: str, new: str, count: int = 1) -> str:
    """``s`` with the ``count`` copies of the anchor ``old`` replaced; stops
    the probe when the source holds another number of them."""
    if s.count(old) != count:
        raise SystemExit(f"{PROBE}: the source has {s.count(old)} of the anchor {old!r}")
    return s.replace(old, new)


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
