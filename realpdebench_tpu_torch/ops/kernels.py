"""Build and bind the hand-written CUDA kernels in ``csrc/``.

``build()`` compiles every ``csrc/*.cu`` with nvcc for ``sm_90a`` (Hopper)
into one shared library with a plain C interface, at first use, into
``build/kernels/`` at the repository root (git ignores it). The library's
name carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded. ``library()`` loads it with ctypes.

One wrapper per kernel (``k1``, ``t_stage``, ``k2``): each checks its
tensors, allocates the outputs, launches on PyTorch's current stream (the
kernels allocate nothing and do not synchronise), raises if the launch
returned an error, and adds one to its entry in ``LAUNCHES``. Nothing here
runs at import: this module is imported on machines with no GPU and no nvcc,
where only the plain twins in ``ops/fno_layer.py`` run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from functools import lru_cache
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset_launches(): the proof that a run
# went through the kernels and not through the plain twins.
LAUNCHES = {"k1": 0, "t_stage": 0, "k2": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc: fno::DType
ACT_CODES = {"none": 0, "exact": 1, "tanh": 2}         # csrc: fno::Act


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of realpdebench_tpu_torch need the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfno_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu into the library unless it is built already.
    Returns (path, seconds spent compiling; 0.0 when it was there). The
    compiler's per-kernel register and shared-memory report goes to stderr."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    sys.stderr.write(res.stderr)
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    return out, seconds


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fno_k1.argtypes = [P] * 8 + [I] * 8 + [P]
    lib.fno_k1.restype = I
    lib.fno_tstage.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.fno_tstage.restype = I
    lib.fno_k2.argtypes = [P] * 13 + [I] * 8 + [P]
    lib.fno_k2.restype = I
    lib.fno_k2_num_partials.argtypes = [I, I]
    lib.fno_k2_num_partials.restype = I
    lib.fno_error_string.argtypes = [I]
    lib.fno_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _io_dtype(t: torch.Tensor) -> int:
    if not t.is_cuda:
        raise ValueError(f"CUDA kernel given a tensor on {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"CUDA kernels take float32 or bfloat16, not {t.dtype}")
    return _DTYPE_CODES[t.dtype]


def _launch(name: str, fn, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        msg = library().fno_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")
    LAUNCHES[name] += 1


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def k1(x, a, b, ewr, ewi, ehr, ehi, *, Hp: int, Wp: int, act: str):
    """x [BT, Hp*Wp/2, 2C] → y [BT, 2m2*m3, 2C]; see csrc/fno_k1.cu."""
    dt = _io_dtype(x)
    dev, f32 = x.device, torch.float32
    BT, C = x.shape[0], x.shape[-1] // 2
    m3, m2x2 = ewr.shape[1], ehr.shape[1]
    _check("x", x, dev, x.dtype, (BT, Hp * Wp // 2, 2 * C))
    for n, t, s in (("a", a, (C,)), ("b", b, (C,)), ("ewr", ewr, (Wp, m3)),
                    ("ewi", ewi, (Wp, m3)), ("ehr", ehr, (Hp, m2x2)),
                    ("ehi", ehi, (Hp, m2x2))):
        _check(n, t, dev, f32, s)
    if m2x2 > 32 or C % min(C, 16) or min(C, 16) * m3 > 1024:
        raise ValueError(f"k1 takes 2*m2 <= 32, C a multiple of 16 (or < 16) "
                         f"and min(C,16)*m3 <= 1024; got 2*m2={m2x2}, C={C}, m3={m3}")
    y = torch.empty((BT, m2x2 * m3, 2 * C), dtype=x.dtype, device=dev)
    _launch("k1", library().fno_k1, dev, _p(x), _p(a), _p(b), _p(ewr), _p(ewi),
            _p(ehr), _p(ehi), _p(y), BT, Hp, Wp, C, m2x2, m3, ACT_CODES[act], dt)
    return y


def t_stage(y, mr, mi):
    """y [B*Tin, Y, 2C] → [B*Tout, Y, 2C] with (MR + i MI) [Tin, Tout]; see
    csrc/fno_tstage.cu."""
    dt = _io_dtype(y)
    dev = y.device
    Tin, Tout = mr.shape
    BT, Y, C2 = y.shape
    if BT % Tin or C2 % 2:
        raise ValueError(f"t_stage: {BT} rows are not a multiple of Tin={Tin}, "
                         f"or {C2} lanes are odd")
    _check("y", y, dev, y.dtype, (BT, Y, C2))
    _check("mr", mr, dev, torch.float32, (Tin, Tout))
    _check("mi", mi, dev, torch.float32, (Tin, Tout))
    B = BT // Tin
    out = torch.empty((B * Tout, Y, C2), dtype=y.dtype, device=dev)
    _launch("t_stage", library().fno_tstage, dev, _p(y), _p(mr), _p(mi), _p(out),
            B, Tin, Tout, Y, C2 // 2, dt)
    return out


def k2(g, x, a, b, wp, bp, ihr, ihi, iwr, iwi, *, Hp: int, Wp: int, act: str):
    """(g [BT, 2m2*m3, 2C], x like s) → (s like x, stats [2, C] f32); see
    csrc/fno_k2.cu."""
    dt = _io_dtype(x)
    dev, f32 = x.device, torch.float32
    BT, C = x.shape[0], x.shape[-1] // 2
    m2x2, m3 = ihr.shape[0], iwr.shape[0]
    _check("x", x, dev, x.dtype, (BT, Hp * Wp // 2, 2 * C))
    _check("g", g, dev, x.dtype, (BT, m2x2 * m3, 2 * C))
    for n, t, s in (("a", a, (C,)), ("b", b, (C,)), ("wp", wp, (C, C)),
                    ("bp", bp, (C,)), ("ihr", ihr, (m2x2, Hp)),
                    ("ihi", ihi, (m2x2, Hp)), ("iwr", iwr, (m3, Wp)),
                    ("iwi", iwi, (m3, Wp))):
        _check(n, t, dev, f32, s)
    if C > 256 or 256 % C:
        raise ValueError(f"k2 takes C dividing 256; got C={C}")
    lib = library()
    s = torch.empty_like(x)
    partial = torch.empty((lib.fno_k2_num_partials(BT, Hp), 2, C), dtype=f32,
                          device=dev)
    stats = torch.empty((2, C), dtype=f32, device=dev)
    _launch("k2", lib.fno_k2, dev, _p(g), _p(x), _p(a), _p(b), _p(wp), _p(bp),
            _p(ihr), _p(ihi), _p(iwr), _p(iwi), _p(s), _p(partial), _p(stats),
            BT, Hp, Wp, C, m2x2, m3, ACT_CODES[act], dt)
    return s, stats
