"""The port's simulation generators on the CPU: how far their f32 steps lie
from a float64 copy, how many operations a substep issues, and (with
``--anchor``) the Strouhal/CD anchor of the JAX package and of the port
from the same draw.

    PYTHONPATH=. python tools/torch_sim_precision.py [--anchor]

1. At the default geometries (256x128, Re 100; the wing 96x64x32), from
   one seeded f32 state: the cylinder and FSI steppers after 20 substeps,
   the wing's (static, and pitching 5° at 0.5) after 5, in f32 against the
   port's float64 copy, max|d|/max|ref| (cd, cl absolute): what
   chip_smoke.py's sim_step holds on the card.
2. The top-level aten operations of one substep of each stepper
   (torch.profiler on the CPU, a small grid: the count does not depend on
   it), each a kernel launch or more on the card.
3. ``--anchor`` (minutes; imports JAX): the anchor's statistics (mean CD,
   St, CL rms over the second half of 1500 frames of 4 substeps) at Re 100
   and 200 for the JAX package and for the port from the JAX package's
   draw, and for the port from its own seeded draw, as chip_smoke.py's
   sim_anchor takes it.
"""

import argparse
import json

import numpy as np
import torch

from realpdebench_tpu_torch.sim import ns2d, ns3d
from realpdebench_tpu_torch.utils.misc import make_generator

CPU = torch.device("cpu")


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max()).item()


def f32_vs_f64() -> dict:
    out = {}
    cfg = ns2d.SolverConfig()
    u, v = ns2d.initial_state(cfg, make_generator(0), device=CPU)
    step = ns2d.make_stepper(cfg, device=CPU)
    body = ns2d.cylinder_fraction(cfg, device=CPU)
    fsi = ns2d.make_fsi_stepper(cfg, ns2d.FSIConfig(), device=CPU)
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        s = (u.to(dtype), v.to(dtype))
        f = (u.to(dtype), v.to(dtype), torch.tensor(cfg.center).to(dtype),
             torch.zeros(2, dtype=dtype))
        for _ in range(20):
            s, (p, cd, cl) = step(s, body)
            f, (fp, fcd, fcl, _) = fsi(f)
        out[name] = dict(cylinder=dict(u=s[0], v=s[1], p=p, cd=cd, cl=cl),
                         fsi=dict(u=f[0], v=f[1], xc=f[2], vc=f[3], p=fp, cd=fcd, cl=fcl))
    cfg3 = ns3d.Solver3DConfig()
    s3 = ns3d._initial_state(cfg3, make_generator(0), None, CPU)
    static = ns3d.make_stepper_3d(cfg3, device=CPU)
    wing = ns3d.wing_fraction(cfg3, device=CPU)
    pitching = ns3d.make_pitching_stepper(cfg3, 5.0, 0.5, device=CPU)
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        for kind in ("wing_static", "wing_pitching"):
            s = tuple(x.to(dtype) for x in s3)
            for j in range(5):
                if kind == "wing_static":
                    s, p = static(s, wing)
                else:
                    s, (p, _) = pitching(s, torch.tensor(j * cfg3.dt, dtype=torch.float32))
            out[name][kind] = dict(u=s[0], v=s[1], w=s[2], p=p)
    return {path: {k: (abs(float(x) - float(out["f64"][path][k])) if k in ("cd", "cl")
                       else rel(x, out["f64"][path][k])) for k, x in fields.items()}
            for path, fields in out["f32"].items()}


def ops_per_substep() -> dict:
    from torch.profiler import ProfilerActivity, profile

    cfg = ns2d.SolverConfig(nx=32, ny=16)
    step = ns2d.make_stepper(cfg, device=CPU)
    body = ns2d.cylinder_fraction(cfg, device=CPU)
    fsi = ns2d.make_fsi_stepper(cfg, ns2d.FSIConfig(), device=CPU)
    u, v = ns2d.initial_state(cfg, make_generator(0), device=CPU)
    cfg3 = ns3d.Solver3DConfig(nx=8, ny=8, nz=4)
    step3 = ns3d.make_stepper_3d(cfg3, device=CPU)
    wing = ns3d.wing_fraction(cfg3, device=CPU)
    pitching = ns3d.make_pitching_stepper(cfg3, device=CPU)
    s3 = ns3d._initial_state(cfg3, make_generator(0), None, CPU)
    t = torch.tensor(0.1)
    body_state = (u, v, torch.tensor(cfg.center), torch.zeros(2))
    calls = dict(cylinder=lambda: step((u, v), body),
                 fsi=lambda: fsi(body_state),
                 wing_static=lambda: step3(s3, wing),
                 wing_pitching=lambda: pitching(s3, t))
    out = {}
    for name, call in calls.items():
        call()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
        out[name] = sum(1 for e in prof.events() if e.cpu_parent is None)
    return out


def _stats(cd, cl, cfg) -> dict:
    tail = slice(len(cd) // 2, None)
    cl_t = cl[tail] - cl[tail].mean()
    spec = np.abs(np.fft.rfft(cl_t))
    f0 = float(np.fft.rfftfreq(len(cl_t), d=cfg.dt * 4)[1:][spec[1:].argmax()])
    st = f0 * (2.0 * ns2d.force_reference(cfg) / cfg.u_inf**2) / cfg.u_inf
    return dict(mean_cd=float(cd[tail].mean()), strouhal=st, cl_rms=float(cl_t.std()))


def anchor() -> dict:
    import jax

    from realpdebench_tpu.sim import ns2d as jns2d

    out = {}
    for re_ in (100.0, 200.0):
        cfg = ns2d.SolverConfig(reynolds=re_)
        key = jax.random.PRNGKey(0)
        _, cd, cl = jns2d.simulate(jns2d.SolverConfig(reynolds=re_), key, 1500, 4)
        runs = dict(jax=_stats(np.asarray(cd, np.float64), np.asarray(cl, np.float64), cfg))
        noise = np.asarray(jax.random.normal(key, (cfg.nx, cfg.ny)))
        for name, kw in (("port_jax_draw", dict(noise=noise)),
                         ("port_own_draw", dict(key=make_generator(0)))):
            _, cd, cl = ns2d.simulate(cfg, kw.pop("key", None), 1500, 4, device=CPU, **kw)
            runs[name] = _stats(cd.numpy().astype(np.float64), cl.numpy().astype(np.float64),
                                cfg)
        out[f"re_{re_:g}"] = runs
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--anchor", action="store_true")
    args = ap.parse_args()
    print(json.dumps(dict(f32_vs_f64=f32_vs_f64(), ops_per_substep=ops_per_substep())),
          flush=True)
    if args.anchor:
        print(json.dumps(dict(anchor=anchor())), flush=True)


if __name__ == "__main__":
    main()
