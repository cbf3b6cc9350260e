"""Offline trajectory generation: parameter sweeps → benchmark-layout HDF5.

Counterpart of ``realpdebench_tpu/sim/generate.py``. Each sweep runs its
simulations one after another on the device (the JAX package's docstring
calls its sweep a ``jax.vmap``; its code, like this one, loops over them)
and comes in two parts:

- the simulation (``cylinder_sweep``, ``controlled_sweep``, ``fsi_sweep``,
  ``foil_sweep``), which returns a :class:`Sweep`: per file name the
  datasets as numpy arrays, ``u``, ``v``, ``p`` ([T, nx, ny], x along the
  flow first) being ``measured_data``'s, which is the tree
  ``data.fluid.with_arrays`` reads, and the file's attributes;
- the writer (:func:`write_sweep`), which writes
  ``{root}/{scenario}/numerical/{file name}`` with h5py, imported there.

``generate_*_sweep`` run both and return the paths written; on a host
without h5py they raise ``ImportError`` before any simulation runs. Each
simulation draws its initial perturbation (and the controlled sweep its
raw actions, first) from a generator seeded with ``derive_seed(seed, i)``;
``draws`` injects them instead: one dict a simulation with ``noise`` (the
standard normal draw of the initial state) and, for the controlled sweep,
``raw`` (the [warmup + n_frames] actions before smoothing).

Usage:
    python -m realpdebench_tpu_torch.sim.generate --dataset-root ./datasets \\
        --scenario cylinder --n-sim 4 --n-frames 256 [--nx 128 --ny 128] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F

from realpdebench_tpu_torch.models.registry import resolve_device
from realpdebench_tpu_torch.sim.ns2d import (
    FSIConfig,
    SolverConfig,
    _draw_tensor,
    _store,
    cylinder_fraction,
    initial_state,
    make_stepper,
    simulate,
    simulate_fsi,
)
from realpdebench_tpu_torch.sim.ns3d import (
    Solver3DConfig,
    simulate_foil,
    simulate_pitching_foil,
)
from realpdebench_tpu_torch.utils.misc import derive_seed, make_generator

MEASURED = ("u", "v", "p")  # the datasets under measured_data/; the rest at the root


@dataclasses.dataclass
class Sweep:
    """A sweep's files: ``arrays[file name][dataset]`` (numpy), ``attrs[file
    name][attribute]``, and ``labels[file name]``, the line printed when the
    file is written."""

    scenario: str
    arrays: dict = dataclasses.field(default_factory=dict)
    attrs: dict = dataclasses.field(default_factory=dict)
    labels: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, frames, label: str, attrs=None, **datasets) -> None:
        frames = frames.cpu().numpy()
        self.arrays[name] = {c: frames[..., i] for i, c in enumerate(MEASURED)}
        self.arrays[name].update({k: v.cpu().numpy() for k, v in datasets.items()})
        self.attrs[name] = dict(attrs or {})
        self.labels[name] = label


def _require_h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "writing the sweep's HDF5 files needs h5py, which this host lacks; "
            "the *_sweep functions return the same arrays without it") from e
    return h5py


def write_sweep(dataset_root: str, sweep: Sweep) -> list:
    """Write each file of ``sweep`` under ``{dataset_root}/{scenario}/numerical``
    (``measured_data/{u,v,p}``, the other datasets and the attributes at the
    root) and return the paths."""
    return _write(_require_h5py(), dataset_root, sweep)


def _write(h5py, dataset_root: str, sweep: Sweep) -> list:
    out_dir = os.path.join(dataset_root, sweep.scenario, "numerical")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, arrays in sweep.arrays.items():
        path = os.path.join(out_dir, name)
        with h5py.File(path, "w") as f:
            g = f.create_group("measured_data")
            for c in MEASURED:
                g.create_dataset(c, data=arrays[c])
            for key, value in sweep.attrs[name].items():
                f.attrs[key] = value
            for key, data in arrays.items():
                if key not in MEASURED:
                    f.create_dataset(key, data=data)
        written.append(path)
        print(f"{sweep.labels[name]} → {path}")
    return written


def _draw(seed: int, i: int, *shapes) -> list:
    """Simulation ``i``'s standard normal draws of ``shapes`` (float32, on
    the CPU), from the generator of ``derive_seed(seed, i)``."""
    g = make_generator(derive_seed(seed, i))
    return [torch.randn(s, generator=g) for s in shapes]


def smooth_actions(raw: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale`` times ``raw`` smoothed by a 9-tap moving average, zero
    padded to its own length (``jnp.convolve(raw, ones(9) / 9,
    mode="same")``; the kernel is symmetric)."""
    kernel = torch.full((1, 1, 9), 1 / 9.0, dtype=raw.dtype, device=raw.device)
    return float(scale) * F.conv1d(raw.view(1, 1, -1), kernel, padding=4).view(-1)


def cylinder_sweep(scenario="cylinder", n_sim=4, n_frames=256, nx=256, ny=128,
                   substeps=4, re_min=80.0, re_max=200.0, seed=0, warmup_frames=64,
                   *, device=None, draws=None) -> Sweep:
    """Fixed-cylinder trajectories over ``n_sim`` Reynolds numbers from
    ``re_min`` to ``re_max``: files ``{1000+i}.h5`` with cd, cl and the
    attribute ``reynolds``."""
    dev = resolve_device(device, "cylinder_sweep runs")
    sweep = Sweep(scenario)
    for i, re in enumerate(np.linspace(re_min, re_max, n_sim)):
        cfg = SolverConfig(nx=nx, ny=ny, reynolds=float(re))
        noise = draws[i]["noise"] if draws else _draw(seed, i, (nx, ny))[0]
        frames, cd, cl = simulate(cfg, None, n_frames + warmup_frames, substeps=substeps,
                                  noise=noise, device=dev)
        w = warmup_frames
        sim_id = 1000 + i
        sweep.add(f"{sim_id}.h5", frames[w:], f"sim {sim_id}: Re={re:.1f}",
                  dict(reynolds=float(re)), cd=cd[w:], cl=cl[w:])
    return sweep



def controlled_sweep(n_sim=4, n_frames=256, nx=256, ny=128, substeps=4, re=150.0,
                     seed=0, warmup_frames=64, action_scale_min=0.2,
                     action_scale_max=1.0, *, device=None, draws=None) -> Sweep:
    """Controlled-cylinder trajectories: a smoothed random rotation-control
    action (the body's transverse surface speed) a frame, at ``n_sim``
    action scales; files ``{1000+i}_{scale:.2f}.h5`` (the pattern the
    parameter-conditioning channels parse) with the dataset ``action``."""
    dev = resolve_device(device, "controlled_sweep runs")
    cfg = SolverConfig(nx=nx, ny=ny, reynolds=float(re))
    step = make_stepper(cfg, device=dev)
    body = cylinder_fraction(cfg, device=dev)
    total = n_frames + warmup_frames
    sweep = Sweep("controlled_cylinder")
    for i, scale in enumerate(np.linspace(action_scale_min, action_scale_max, n_sim)):
        if draws:
            raw, noise = draws[i]["raw"], draws[i]["noise"]
        else:
            raw, noise = _draw(seed, i, (total,), (nx, ny))
        actions = smooth_actions(_draw_tensor(raw).to(dev), scale)
        state = initial_state(cfg, noise=noise, device=dev)
        frames = torch.empty((total, nx, ny, 3), dtype=torch.float32, device=dev)
        for t in range(total):
            for _ in range(substeps):
                state, (p, _, _) = step(state, body, (0.0, actions[t]))
            _store(frames[t], state, p)
        w = warmup_frames
        sim_id = 1000 + i
        sweep.add(f"{sim_id}_{scale:.2f}.h5", frames[w:],
                  f"controlled sim {sim_id}: scale={scale:.2f}", action=actions[w:])
    return sweep



def fsi_sweep(n_sim=4, n_frames=256, nx=256, ny=128, substeps=4, re_min=100.0,
              re_max=300.0, seed=0, warmup_frames=64, stiffness_min=4.0,
              stiffness_max=16.0, *, device=None, draws=None) -> Sweep:
    """FSI trajectories: an elastically mounted cylinder responding to the
    fluid force (vortex-induced vibration), over ``n_sim`` (Re, spring
    stiffness) pairs; files ``{1000+i}_{Re/100:.2f}_.h5`` (the FSI dataset's
    pattern ``(\\d+)_([\\d\\.]+)_``) with cd, cl, the body-centre path
    ``body_center`` [T, 2] and the attributes ``reynolds``, ``stiffness``."""
    dev = resolve_device(device, "fsi_sweep runs")
    sweep = Sweep("fsi")
    pairs = zip(np.linspace(re_min, re_max, n_sim),
                np.linspace(stiffness_min, stiffness_max, n_sim))
    for i, (re, k_spring) in enumerate(pairs):
        cfg = SolverConfig(nx=nx, ny=ny, reynolds=float(re))
        fsi = FSIConfig(stiffness=float(k_spring))
        noise = draws[i]["noise"] if draws else _draw(seed, i, (nx, ny))[0]
        frames, cd, cl, centers = simulate_fsi(
            cfg, fsi, None, n_frames + warmup_frames, substeps=substeps, noise=noise,
            device=dev)
        w = warmup_frames
        sim_id = 1000 + i
        sweep.add(f"{sim_id}_{re / 100.0:.2f}_.h5", frames[w:],
                  f"fsi sim {sim_id}: Re={re:.1f} k={k_spring:.1f}",
                  dict(reynolds=float(re), stiffness=float(k_spring)),
                  cd=cd[w:], cl=cl[w:], body_center=centers[w:])
    return sweep



def foil_sweep(n_sim=4, n_frames=256, nx=96, ny=64, nz=32, substeps=4, aoa_min=5.0,
               aoa_max=15.0, seed=0, warmup_frames=32, pitch_amp_deg=0.0,
               pitch_freq=0.5, *, device=None, draws=None) -> Sweep:
    """3-D tapered-wing trajectories over ``n_sim`` angles of attack, saved
    as the mid-span ``measured_data/{u,v,p}``; ``pitch_amp_deg > 0``
    switches to the pitching wing and stores its AoA trace ``aoa_trace``.
    Files ``{2000+i}_{aoa:.1f}.h5`` (the Foil dataset's pattern, no trailing
    underscore) with the attributes ``aoa_deg``, ``pitch_amp_deg``."""
    dev = resolve_device(device, "foil_sweep runs")
    sweep = Sweep("foil")
    total = n_frames + warmup_frames
    w = warmup_frames
    for i, aoa in enumerate(np.linspace(aoa_min, aoa_max, n_sim)):
        cfg = Solver3DConfig(nx=nx, ny=ny, nz=nz, aoa_deg=float(aoa))
        noise = draws[i]["noise"] if draws else _draw(seed, i, (nx, ny, nz))[0]
        extra = {}
        if pitch_amp_deg > 0:
            frames, aoa_trace = simulate_pitching_foil(
                cfg, None, total, substeps=substeps, pitch_amp_deg=float(pitch_amp_deg),
                pitch_freq=float(pitch_freq), noise=noise, device=dev)
            extra["aoa_trace"] = aoa_trace[w:]
        else:
            frames = simulate_foil(cfg, None, total, substeps=substeps, noise=noise,
                                   device=dev)
        sim_id = 2000 + i
        sweep.add(f"{sim_id}_{aoa:.1f}.h5", frames[w:],
                  f"foil sim {sim_id}: AoA={aoa:.1f} pitch={pitch_amp_deg:.1f}",
                  dict(aoa_deg=float(aoa), pitch_amp_deg=float(pitch_amp_deg)), **extra)
    return sweep



def _generating(sweep_fn):
    """``generate_*_sweep(dataset_root, *args, **kw)``: ``sweep_fn(*args,
    **kw)`` written by :func:`write_sweep`, h5py required before the
    simulation runs."""
    def generate(dataset_root, *args, **kw) -> list:
        h5py = _require_h5py()
        return _write(h5py, dataset_root, sweep_fn(*args, **kw))

    generate.__name__ = f"generate_{sweep_fn.__name__}"
    generate.__doc__ = (f"Run :func:`{sweep_fn.__name__}` (same arguments after "
                        "``dataset_root``) and write its files; the paths written.")
    return generate


generate_cylinder_sweep = _generating(cylinder_sweep)
generate_controlled_sweep = _generating(controlled_sweep)
generate_fsi_sweep = _generating(fsi_sweep)
generate_foil_sweep = _generating(foil_sweep)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-root", required=True)
    parser.add_argument("--scenario", default="cylinder")
    parser.add_argument("--n-sim", type=int, default=4)
    parser.add_argument("--n-frames", type=int, default=256)
    parser.add_argument("--nx", type=int, default=256)
    parser.add_argument("--ny", type=int, default=128)
    parser.add_argument("--re-min", type=float, default=80.0)
    parser.add_argument("--re-max", type=float, default=200.0)
    parser.add_argument("--nz", type=int, default=32,
                        help="spanwise resolution (foil only)")
    parser.add_argument("--pitch-amp-deg", type=float, default=0.0,
                        help="pitching amplitude (foil only; 0 = static)")
    parser.add_argument("--pitch-freq", type=float, default=0.5,
                        help="pitching frequency (foil only)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the solver runs on (default cuda; "
                             "cpu for a run without a card)")
    args = parser.parse_args(argv)
    dev = args.device
    if args.scenario == "fsi":
        generate_fsi_sweep(
            args.dataset_root, args.n_sim, args.n_frames, args.nx, args.ny,
            re_min=args.re_min, re_max=args.re_max, device=dev,
        )
    elif args.scenario == "controlled_cylinder":
        generate_controlled_sweep(
            args.dataset_root, args.n_sim, args.n_frames, args.nx, args.ny, device=dev,
        )
    elif args.scenario == "foil":
        generate_foil_sweep(
            args.dataset_root, args.n_sim, args.n_frames,
            nx=args.nx, ny=args.ny, nz=args.nz,
            pitch_amp_deg=args.pitch_amp_deg, pitch_freq=args.pitch_freq, device=dev,
        )
    else:
        generate_cylinder_sweep(
            args.dataset_root, args.scenario, args.n_sim, args.n_frames,
            args.nx, args.ny, re_min=args.re_min, re_max=args.re_max, device=dev,
        )


if __name__ == "__main__":
    main()
