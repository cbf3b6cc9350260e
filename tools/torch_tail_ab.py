#!/usr/bin/env python3
"""K3F and K3B of two checkouts timed on one card, to tell whether a change
to ``csrc/fno_tail.cu`` moved them, with the build's register report beside
the times.

    python3 tools/torch_tail_ab.py PARENT_ROOT CHANGE_ROOT

From a host with a Hopper card and nvcc, each root a checkout (for example
a ``git archive`` of each commit unpacked into a git-ignored directory).
Runs parent, change, change, parent, each in a child process that imports
the package of its root, builds that root's kernels there (a fresh root
builds once), and times K3F and K3B with CUDA events (median of 10 launches
after 3) at the cylinder training width (B 32, Tp 26, Hp 70, Wp 134, C 64;
the tail over 32·20·64·128 positions, F 3), in float32 and bfloat16. One
JSON line a run: the root, nvcc's version, the registers and spills ptxas
reported for each ``k3b_kernel`` (when this run built the library), the
times in ms. Each run also keeps the outputs (SSE, ds and the four sums) of
every variant (the tensor-core one of each dtype and the fma one) at F 1
and 3 on the same seeded inputs; a last line says whether the parent's and
the change's first runs gave them bit for bit (``bits_equal``).
"""

import contextlib
import io
import json
import statistics
import subprocess
import sys
from pathlib import Path

B, TP, HP, WP, C, T, H, W, F = 32, 26, 70, 134, 64, 20, 64, 128, 3
BIT_F = (1, 3)   # fc2 widths whose outputs the two roots must give bit for bit


def _ms(fn, reps: int = 10, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _registers(report: str) -> dict:
    """ptxas's 'Used N registers' and spill line of each k3b_kernel."""
    out, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "k3b_kernel" in line else None
        elif name and "spill stores" in line:
            out[name] = {"spill": line.strip()}
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
            name = None
    return out


def child(root: str, out_path: str | None = None) -> None:
    sys.path.insert(0, root)
    import torch

    from realpdebench_tpu_torch.ops import fno_tail as ft
    from realpdebench_tpu_torch.ops import kernels

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        kernels.library()
    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    kw = dict(dims=(B, TP, HP, WP, C), tail_dims=(T, H, W), act="exact")
    times, outputs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        tc = "tf32" if dtype == torch.float32 else "mma"
        for f in BIT_F:
            s = rn(B * TP, HP * WP // 2, 2 * C).to(dtype)
            tail = (rn(B, T, H, W, f), rn(C, 128) / C ** 0.5, 0.1 * rn(128),
                    rn(128, f) / 128 ** 0.5, 0.1 * rn(f))
            gl = torch.tensor(1.0 / (B * T * H * W * f), device=dev)
            for v in (tc, "fma"):
                outputs[f"{name}_F{f}_{v}"] = [
                    ft.k3f(s, *tail, **kw, variant=v).cpu(),
                    *(t.cpu() for t in ft.k3b(s, *tail, gl, **kw, variant=v))]
            if f == F:
                times[f"k3f_{name}"] = _ms(lambda: ft.k3f(s, *tail, **kw))
                times[f"k3b_{name}"] = _ms(lambda: ft.k3b(s, *tail, gl, **kw))
    if out_path:
        torch.save(outputs, out_path)
    print(json.dumps(dict(root=root, nvcc=nvcc, k3b_registers=_registers(err.getvalue()),
                          ms=times)), flush=True)


def main() -> None:
    if sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else None)
        return
    import tempfile

    import torch

    parent, change = (str(Path(p).resolve()) for p in sys.argv[1:3])
    with tempfile.TemporaryDirectory() as tmp:
        kept = {parent: f"{tmp}/parent.pt", change: f"{tmp}/change.pt"}
        for i, root in enumerate((parent, change, change, parent)):
            extra = [kept[root]] if i < 2 else []
            subprocess.run([sys.executable, __file__, "--child", root, *extra], check=True)
        a, b = torch.load(kept[parent]), torch.load(kept[change])
    differ = sorted(k for k in a if not all(torch.equal(x, y) for x, y in zip(a[k], b[k])))
    print(json.dumps(dict(bits_equal=not differ and a.keys() == b.keys(), compared=sorted(a),
                          differ=differ)), flush=True)


if __name__ == "__main__":
    main()
