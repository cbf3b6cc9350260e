"""Synthetic dataset trees: random HDF5 trees with the exact on-disk layout
the real datasets ship with.

Counterpart of ``realpdebench_tpu/data/synthetic.py``: for the same seed
the arrays written are the JAX writer's. Layout (reference
`fluid_dataset.py:346-372`, `combustion_dataset.py:321-345`):

    {root}/{scenario}/real/{name}.h5        measured_data/{u,v}
    {root}/{scenario}/numerical/{name}.h5   measured_data/{u,v,p}
    {root}/combustion/real/*.h5             trajectory (T,H,W)
    {root}/combustion/numerical/*.h5        measured_data (T,H,W,15)
    {root}/combustion/surrogate/*.h5        measured_data (T,H,W)

``fluid_arrays`` returns a fluid tree's arrays without writing them, for
``data.fluid.with_arrays`` on hosts without h5py.
"""

from __future__ import annotations

import os

import numpy as np

FLUID_NAME_FORMATS = {
    # filename generator per scenario: must match each scenario's regex
    "cylinder": lambda i, rng: f"{1000 + i}.h5",
    "fsi": lambda i, rng: f"{1000 + i}_{18.0 + i / 10:.1f}_x.h5",
    "controlled_cylinder": lambda i, rng: f"{1000 + i}_{0.5 + i / 10:.1f}.h5",
    "foil": lambda i, rng: f"{1000 + i}_{5.0 + i:.1f}.h5",
}


def _vortex_field(rng, n_frame, h, w, n_modes=3):
    """Smooth traveling-wave field so spectra/metrics are non-trivial."""
    t = np.arange(n_frame)[:, None, None] / max(n_frame, 1)
    y = np.linspace(0, 2 * np.pi, h)[None, :, None]
    x = np.linspace(0, 2 * np.pi, w)[None, None, :]
    field = np.zeros((n_frame, h, w), np.float32)
    for _ in range(n_modes):
        ky, kx, om = rng.integers(1, 4, size=3)
        amp = rng.uniform(0.2, 1.0)
        ph = rng.uniform(0, 2 * np.pi)
        field += amp * np.sin(ky * y + kx * x - 2 * np.pi * om * t + ph).astype(
            np.float32
        )
    return field + 0.05 * rng.standard_normal(field.shape).astype(np.float32)


def fluid_arrays(scenario: str = "cylinder", n_sim: int = 4, n_frame: int = 64,
                 h: int = 16, w: int = 16, seed: int = 0,
                 types=("real", "numerical"), sizes=None) -> dict:
    """A fluid tree's arrays: ``{type: {file name: {channel: [T, H, W]}}}``,
    drawn in ``make_fluid_tree``'s order. ``sizes`` maps a type to its own
    ``(n_sim, h, w)`` (the real and numerical grids of a scenario differ
    when ``sub_s_numerical`` > ``sub_s_real``); types not named take
    ``(n_sim, h, w)``."""
    rng = np.random.default_rng(seed)
    namer = FLUID_NAME_FORMATS[scenario]
    out = {}
    for dtype in types:
        n, hh, ww = (sizes or {}).get(dtype, (n_sim, h, w))
        out[dtype] = {}
        for i in range(n):
            name = namer(i, rng)
            chans = ("u", "v", "p") if dtype == "numerical" else ("u", "v")
            out[dtype][name] = {c: _vortex_field(rng, n_frame, hh, ww) for c in chans}
    return out


def make_fluid_tree(
    root: str,
    scenario: str = "cylinder",
    n_sim: int = 4,
    n_frame: int = 64,
    h: int = 16,
    w: int = 16,
    seed: int = 0,
    types=("real", "numerical"),
    sizes=None,
):
    """Write a fluid scenario tree; returns the scenario directory."""
    import h5py

    scen_dir = os.path.join(root, scenario)
    arrays = fluid_arrays(scenario, n_sim, n_frame, h, w, seed, types, sizes)
    for dtype, sims in arrays.items():
        ddir = os.path.join(scen_dir, dtype)
        os.makedirs(ddir, exist_ok=True)
        for name, chans in sims.items():
            with h5py.File(os.path.join(ddir, name), "w") as f:
                g = f.create_group("measured_data")
                for c, a in chans.items():
                    g.create_dataset(c, data=a)
    return scen_dir


def make_combustion_tree(
    root: str,
    n_sim: int = 2,
    n_frame: int = 32,
    h: int = 16,
    w: int = 16,
    seed: int = 0,
    with_surrogate: bool = True,
):
    """Write a combustion tree in the reference layout: real files carry a
    1-channel `trajectory` (T,H,W); numerical files a 15-field
    `measured_data` (T,H,W,15); surrogate/ files the surrogate-predicted
    observed channel under `measured_data` (T,H,W). Filenames:
    `{gas}NH3_{equiv}.h5`."""
    import h5py

    rng = np.random.default_rng(seed)
    scen_dir = os.path.join(root, "combustion")
    for dtype in ("real", "numerical"):
        ddir = os.path.join(scen_dir, dtype)
        os.makedirs(ddir, exist_ok=True)
        for i in range(n_sim):
            name = f"{40 + 10 * i}NH3_{0.6 + 0.2 * i:.1f}.h5"
            with h5py.File(os.path.join(ddir, name), "w") as f:
                if dtype == "real":
                    f.create_dataset(
                        "trajectory", data=_vortex_field(rng, n_frame, h, w)
                    )
                else:
                    fields = np.stack(
                        [_vortex_field(rng, n_frame, h, w) for _ in range(15)],
                        axis=-1,
                    )  # (T, H, W, 15)
                    f.create_dataset("measured_data", data=fields)
            if dtype == "numerical" and with_surrogate:
                sdir = os.path.join(scen_dir, "surrogate")
                os.makedirs(sdir, exist_ok=True)
                with h5py.File(os.path.join(sdir, name), "w") as f:
                    f.create_dataset(
                        "measured_data", data=_vortex_field(rng, n_frame, h, w)
                    )
    return scen_dir
