"""The port's sweeps (realpdebench_tpu_torch.sim.generate) against the JAX
package's on the CPU at tiny sizes, the JAX draws injected: file names,
groups, datasets, attributes and values (rtol 2e-4, atol 2e-4·max|ref|;
cd and cl absolute at 2e-4 of cd's scale); the action smoothing; the array
route read by the datasets; the writer's refusal without h5py; the CLI."""

import os
import re
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.sim import generate as jgen
from realpdebench_tpu_torch.data import fluid
from realpdebench_tpu_torch.sim import generate as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the solver's tensors are small, so it runs as
    fast alone, and far faster beside other busy processes (the suite's
    other workers) than a pool of spinning threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(n_sim, *shapes, seed=0):
    """The standard normal draws the JAX sweeps take, per simulation: one
    split a simulation (the controlled sweep three: raw actions, then the
    initial state)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_sim):
        if len(shapes) == 2:
            key, ka, ks = jax.random.split(key, 3)
            out.append(dict(raw=np.asarray(jax.random.normal(ka, shapes[0])),
                            noise=np.asarray(jax.random.normal(ks, shapes[1]))))
        else:
            key, k = jax.random.split(key)
            out.append(dict(noise=np.asarray(jax.random.normal(k, shapes[0]))))
    return out


def read_tree(path):
    """{dataset path: array} and {attribute: value} of one HDF5 file."""
    data = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: data.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
        return data, dict(f.attrs), sorted(f.keys())


def same_files(jpaths, tpaths):
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    for jp, tp in zip(jpaths, tpaths):
        jd, ja, jk = read_tree(jp)
        td, ta, tk = read_tree(tp)
        assert tk == jk and sorted(td) == sorted(jd) and ta == ja, (tp, tk, sorted(td), ta)
        scale = np.abs(jd["cd"]).max() if "cd" in jd else None
        for name, ref in jd.items():
            got = td[name]
            assert got.shape == ref.shape and got.dtype == ref.dtype, name
            if name in ("cd", "cl"):
                np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale, err_msg=name)
            else:
                np.testing.assert_allclose(got, ref, rtol=RTOL,
                                           atol=RTOL * np.abs(ref).max(), err_msg=name)


# one simulation a sweep (the JAX sweep compiles a trajectory for each
# simulation's parameters); later simulations' names are the datasets' test's
SWEEPS = {
    # name: (JAX writer, port writer, keywords, draw shapes)
    "cylinder": (jgen.generate_cylinder_sweep, tgen.generate_cylinder_sweep,
                 dict(n_sim=1, n_frames=6, nx=32, ny=32, substeps=2, warmup_frames=3),
                 ((32, 32),)),
    "controlled": (jgen.generate_controlled_sweep, tgen.generate_controlled_sweep,
                   dict(n_sim=1, n_frames=6, nx=32, ny=32, substeps=2, warmup_frames=3),
                   ((9,), (32, 32))),
    "fsi": (jgen.generate_fsi_sweep, tgen.generate_fsi_sweep,
            dict(n_sim=1, n_frames=6, nx=32, ny=32, substeps=2, warmup_frames=3),
            ((32, 32),)),
    "foil_pitching": (jgen.generate_foil_sweep, tgen.generate_foil_sweep,
                      dict(n_sim=1, n_frames=4, nx=24, ny=16, nz=8, substeps=2,
                           warmup_frames=2, pitch_amp_deg=6.0, pitch_freq=1.0),
                      ((24, 16, 8),)),
    "foil_static": (jgen.generate_foil_sweep, tgen.generate_foil_sweep,
                    dict(n_sim=1, n_frames=4, nx=24, ny=16, nz=8, substeps=1,
                         warmup_frames=2), ((24, 16, 8),)),
}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_sweep_files_match_jax(name, tmp_path):
    jwrite, twrite, kw, shapes = SWEEPS[name]
    jpaths = jwrite(str(tmp_path / "jax"), **kw)
    tpaths = twrite(str(tmp_path / "port"), **kw, device="cpu",
                    draws=jax_draws(kw["n_sim"], *shapes))
    same_files(jpaths, tpaths)


def test_action_smoothing_matches_jnp_convolve():
    raw = np.random.default_rng(0).standard_normal(37).astype(np.float32)
    ref = 0.6 * jnp.convolve(raw, jnp.ones(9) / 9.0, mode="same")
    got = tgen.smooth_actions(torch.from_numpy(raw), 0.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_sweep_draws_from_derived_seeds():
    """Without draws, simulation i takes its perturbation from
    derive_seed(seed, i): the same files for the same seed, other values
    for another."""
    kw = dict(n_sim=2, n_frames=2, nx=16, ny=16, substeps=1, warmup_frames=1, device="cpu")
    a, b = tgen.cylinder_sweep(**kw), tgen.cylinder_sweep(**kw)
    c = tgen.cylinder_sweep(**kw, seed=1)
    for name in a.arrays:
        np.testing.assert_array_equal(a.arrays[name]["v"], b.arrays[name]["v"])
        assert not np.array_equal(a.arrays[name]["v"], c.arrays[name]["v"])
    assert not np.array_equal(a.arrays["1000.h5"]["v"], a.arrays["1001.h5"]["v"])


@pytest.mark.parametrize("scenario", ["cylinder", "fsi", "controlled_cylinder", "foil"])
def test_array_route_read_by_datasets(scenario, tmp_path):
    """The arrays of a sweep, read through data.fluid.with_arrays, give the
    items the same sweep's HDF5 files give; file names parse."""
    small = dict(n_sim=3, n_frames=24, substeps=1, warmup_frames=2, device="cpu")
    if scenario == "foil":
        sweep = tgen.foil_sweep(nx=16, ny=16, nz=4, **small)
    elif scenario == "controlled_cylinder":
        sweep = tgen.controlled_sweep(nx=16, ny=16, **small)
    elif scenario == "fsi":
        sweep = tgen.fsi_sweep(nx=16, ny=16, **small)
    else:
        sweep = tgen.cylinder_sweep(nx=16, ny=16, **small)
    assert sweep.scenario == scenario
    cls = fluid.FLUID_DATASETS[scenario]
    for name in sweep.arrays:
        assert re.match(cls.file_name_pattern, name), name
    tgen.write_sweep(str(tmp_path / "h5"), sweep)
    kw = dict(in_step=4, out_step=4, interval=4, trunk_length=8, n_sim_frame=24,
              n_sim_in_distribution=1, n_sim_out_distribution=1, sub_s_real=1,
              sub_s_numerical=1, generate_ids_if_missing=True, mask_prob=0.0)
    files = cls(scenario, str(tmp_path / "h5"), "numerical", "train", **kw)
    arrays = fluid.with_arrays(cls, {"numerical": sweep.arrays})(
        scenario, str(tmp_path / "mem"), "numerical", "train", **kw)
    assert len(files) == len(arrays) > 0
    for i in (0, len(files) - 1):
        for a, b in zip(files[i], arrays[i]):
            np.testing.assert_array_equal(a, b)
    x, _ = files[0]
    channels = 5 if scenario == "controlled_cylinder" else 3
    assert x.shape == (4, 16, 16, channels) and np.isfinite(x).all()


def test_writer_refuses_without_h5py_before_simulating(monkeypatch, tmp_path):
    """Where h5py does not import, generate_*_sweep raise ImportError naming
    it, before any simulation runs (the arrays route needs no h5py)."""
    monkeypatch.setitem(sys.modules, "h5py", None)

    def no_simulation(*a, **k):
        raise AssertionError("a simulation ran")

    for fn in ("simulate", "simulate_fsi", "simulate_foil", "simulate_pitching_foil",
               "make_stepper"):
        monkeypatch.setattr(tgen, fn, no_simulation)
    for gen in (tgen.generate_cylinder_sweep, tgen.generate_controlled_sweep,
                tgen.generate_fsi_sweep, tgen.generate_foil_sweep):
        with pytest.raises(ImportError, match="h5py"):
            gen(str(tmp_path), n_sim=1, n_frames=2, device="cpu")
    assert not os.path.exists(tmp_path / "cylinder")


def test_generate_cli_on_cpu(tmp_path):
    """python -m realpdebench_tpu_torch.sim.generate --device cpu writes the
    sweep's files (the CLI's --re-min/--re-max, 80 and 200, reach the fsi
    sweep too, as in the JAX package's CLI); --device defaults to the card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"    # as the file's own fixture: small tensors
    res = subprocess.run(
        [sys.executable, "-m", "realpdebench_tpu_torch.sim.generate", "--dataset-root",
         str(tmp_path), "--scenario", "fsi", "--n-sim", "2", "--n-frames", "4", "--nx", "16",
         "--ny", "16", "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    names = sorted(os.listdir(tmp_path / "fsi" / "numerical"))
    assert names == ["1000_0.80_.h5", "1001_2.00_.h5"], names
    with h5py.File(tmp_path / "fsi" / "numerical" / names[0], "r") as f:
        assert f["measured_data/u"].shape == (4, 16, 16)
        assert f["body_center"].shape == (4, 2)
        assert f.attrs["stiffness"] == 4.0
    assert "fsi sim 1000: Re=80.0 k=4.0 →" in res.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tgen.main(["--dataset-root", str(tmp_path / "default"), "--n-sim", "1"])
