"""PyTorch port vs JAX package: the data layer, on the CPU.

* ``make_fluid_tree`` (every scenario) and ``make_combustion_tree`` write
  the JAX writer's arrays for a seed, and ``fluid_arrays`` returns them;
* every item of every dataset class, in every mode and paradigm, with the
  noise types and the p mask on, equals the JAX package's bit for bit
  (``num_workers=0``: the noise and mask stream is shared by the loader's
  threads), and so do the in-memory datasets of ``with_arrays``;
* the loader's batch order, drop_last and pad mask are equal, and so are
  ``cycle_loader``'s batches through the background thread;
* the normalizer statistics from a dataset (Gaussian and range) equal the
  JAX package's, and so does the reference ``.pt`` cache read by both.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from realpdebench_tpu.data import combustion as jcomb
from realpdebench_tpu.data import fluid as jfluid
from realpdebench_tpu.data import loader as jloader
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.data import synthetic as jsyn
from realpdebench_tpu_torch.data import combustion as tcomb
from realpdebench_tpu_torch.data import fluid as tfluid
from realpdebench_tpu_torch.data import loader as tloader
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.data import synthetic as tsyn

SCENARIOS = ("cylinder", "fsi", "controlled_cylinder", "foil")
FLUID_KW = dict(in_step=4, out_step=4, interval=4, trunk_length=16, n_sim_frame=48,
                n_sim_in_distribution=1, n_sim_out_distribution=1,
                sub_s_real=1, sub_s_numerical=2, generate_ids_if_missing=True)
COMB_KW = dict(in_step=4, out_step=4, interval=2, trunk_length=10, n_sim_frame=32,
               sub_s_real=1, sub_s_numerical=1, generate_ids_if_missing=True)


def _read_tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".h5"):
                with h5py.File(os.path.join(dirpath, f), "r") as h:
                    h.visititems(lambda name, obj: out.__setitem__(
                        (os.path.relpath(dirpath, root), f, name), obj[()])
                        if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_fluid_tree_writes_the_jax_arrays(tmp_path, scenario):
    kw = dict(n_sim=3, n_frame=12, h=8, w=10, seed=4)
    jsyn.make_fluid_tree(str(tmp_path / "j"), scenario, **kw)
    tsyn.make_fluid_tree(str(tmp_path / "t"), scenario, **kw)
    ref, got = _read_tree(str(tmp_path / "j")), _read_tree(str(tmp_path / "t"))
    assert got.keys() == ref.keys() and len(ref) == 15
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    arrays = tsyn.fluid_arrays(scenario, **kw)
    for (d, f, name), v in ref.items():
        typ = os.path.basename(d)
        assert np.array_equal(arrays[typ][f][name.split("/")[-1]], v)


def test_combustion_tree_writes_the_jax_arrays(tmp_path):
    kw = dict(n_sim=2, n_frame=10, h=8, w=8, seed=2)
    jsyn.make_combustion_tree(str(tmp_path / "j"), **kw)
    tsyn.make_combustion_tree(str(tmp_path / "t"), **kw)
    ref, got = _read_tree(str(tmp_path / "j")), _read_tree(str(tmp_path / "t"))
    assert got.keys() == ref.keys() and len(ref) == 6
    for k, v in ref.items():
        assert np.array_equal(got[k], v), k


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree per package (each writes its own id mappings), equal arrays;
    the numerical grids at twice the real resolution, as shipped."""
    roots = {}
    for pkg, syn in (("jax", jsyn), ("port", tsyn)):
        root = str(tmp_path_factory.mktemp(pkg))
        for i, sc in enumerate(SCENARIOS):
            syn.make_fluid_tree(root, sc, n_sim=10, n_frame=48, h=8, w=8, seed=i,
                                types=("real",))
            syn.make_fluid_tree(root, sc, n_sim=4, n_frame=48, h=16, w=16, seed=10 + i,
                                types=("numerical",))
        syn.make_combustion_tree(root, n_sim=3, n_frame=32, h=8, w=8)
        roots[pkg] = root
    return roots


def _items(ds):
    return [ds[i] for i in range(len(ds))]


def _assert_items_equal(got, ref):
    assert len(got) == len(ref) > 0
    for i, ((gx, gy), (rx, ry)) in enumerate(zip(got, ref)):
        assert gx.dtype == rx.dtype and gy.dtype == ry.dtype, i
        assert np.array_equal(gx, rx) and np.array_equal(gy, ry), i


CASES = [
    (mode, typ, extra)
    for mode, typ in (("train", "numerical"), ("train", "real"), ("val", "real"),
                      ("test", "real"))
    for extra in (dict(), dict(noise_scale=0.1, mask_prob=0.5),
                  dict(noise_scale=0.1, noise_type="poisson"),
                  dict(noise_scale=0.1, noise_type="optical", mask_prob=0.2))
    if typ == "numerical" or not extra
] + [("test", "real", dict(N_autoregressive=2)),
     ("test", "real", dict(test_mode="out_dist")),
     ("val", "real", dict(test_mode="seen"))]


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("mode,typ,extra", CASES)
def test_fluid_items_equal_jax_bit_for_bit(trees, scenario, mode, typ, extra):
    kw = dict(FLUID_KW, seed=3, **extra)
    ref = _items(jfluid.FLUID_DATASETS[scenario](scenario, trees["jax"], typ, mode, **kw))
    got = _items(tfluid.FLUID_DATASETS[scenario](scenario, trees["port"], typ, mode, **kw))
    _assert_items_equal(got, ref)


@pytest.mark.parametrize("mode,typ,extra", [
    ("train", "numerical", dict(mask_prob=0.5)), ("train", "numerical", dict(mask_prob=0.0)),
    ("train", "real", {}), ("val", "real", {}), ("test", "real", {})])
def test_combustion_items_equal_jax_bit_for_bit(trees, mode, typ, extra):
    kw = dict(COMB_KW, seed=1, **extra)
    ref = _items(jcomb.CombustionDataset("combustion", trees["jax"], typ, mode, **kw))
    got = _items(tcomb.CombustionDataset("combustion", trees["port"], typ, mode, **kw))
    _assert_items_equal(got, ref)


@pytest.mark.parametrize("scenario", ["cylinder", "controlled_cylinder"])
def test_in_memory_datasets_equal_the_hdf5_ones(tmp_path, scenario):
    sizes = {"real": (10, 8, 8), "numerical": (4, 16, 16)}
    arrays = tsyn.fluid_arrays(scenario, n_frame=48, seed=7, sizes=sizes)
    h5_root, mem_root = str(tmp_path / "h5"), str(tmp_path / "mem")
    tsyn.make_fluid_tree(h5_root, scenario, n_frame=48, seed=7, sizes=sizes)
    cls = tfluid.FLUID_DATASETS[scenario]
    mem = tfluid.with_arrays(cls, arrays)
    assert mem.__name__ == f"InMemory{cls.__name__}"
    for mode, typ in (("train", "numerical"), ("train", "real"), ("test", "real")):
        kw = dict(FLUID_KW, seed=5, noise_scale=0.1, mask_prob=0.5)
        ref = _items(cls(scenario, h5_root, typ, mode, **kw))
        _assert_items_equal(_items(mem(scenario, mem_root, typ, mode, **kw)), ref)


def _batches(loader):
    return [tuple(np.asarray(a) for a in b) for b in loader]


@pytest.mark.parametrize("drop_last,pad_last,shuffle", [
    (True, False, True), (False, True, False), (False, False, True)])
def test_loader_batches_equal_jax(trees, drop_last, pad_last, shuffle):
    kw = dict(FLUID_KW, seed=3, noise_scale=0.1, mask_prob=0.5)
    jds = jfluid.Cylinder("cylinder", trees["jax"], "numerical", "train", **kw)
    tds = tfluid.Cylinder("cylinder", trees["port"], "numerical", "train", **kw)
    assert len(jds) % 5
    lkw = dict(batch_size=5, shuffle=shuffle, seed=9, drop_last=drop_last,
               pad_last=pad_last)
    jl, tl = jloader.DataLoader(jds, **lkw), tloader.DataLoader(tds, **lkw)
    assert len(jl) == len(tl)
    for _ in range(2):                      # two epochs: two permutations
        ref, got = _batches(jl), _batches(tl)
        assert len(got) == len(ref) == len(jl)
        for g, r in zip(got, ref):
            assert len(g) == len(r) == (3 if pad_last else 2)
            for a, b in zip(g, r):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cycle_loader_thread_keeps_the_order(trees):
    kw = dict(FLUID_KW, seed=3, noise_scale=0.1)
    jds = jfluid.Cylinder("cylinder", trees["jax"], "numerical", "train", **kw)
    tds = tfluid.Cylinder("cylinder", trees["port"], "numerical", "train", **kw)
    lkw = dict(batch_size=4, shuffle=True, seed=2, drop_last=True)
    ref = jloader.cycle_loader(jloader.DataLoader(jds, **lkw), background=False)
    got = tloader.cycle_loader(tloader.DataLoader(tds, **lkw), device="cpu")
    try:
        for _ in range(2 * (len(jds) // 4) + 1):      # wraps around an epoch
            (rx, ry), (gx, gy) = next(ref), next(got)
            assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
            assert np.array_equal(gx.numpy(), rx) and np.array_equal(gy.numpy(), ry)
    finally:
        got.close()
    assert not got.thread.is_alive()


@pytest.mark.parametrize("name", ["gaussian", "range"])
def test_normalizer_statistics_from_a_dataset_equal_jax(trees, tmp_path, name):
    kw = dict(FLUID_KW, seed=3)
    jds = jfluid.Cylinder("cylinder", trees["jax"], "numerical", "train", **kw)
    tds = tfluid.Cylinder("cylinder", trees["port"], "numerical", "train", **kw)
    ref = jnorm.build_normalizer(name, jds, batch_size=3, is_save=False)
    got = tnorm.build_normalizer(name, tds, batch_size=3, is_save=False)
    for k in type(got).keys:
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k
    # computed once (a new dataset: the same draws), cached as .npz, read back
    tds = tfluid.Cylinder("cylinder", trees["port"], "numerical", "train", **kw)
    cached = tnorm.build_normalizer(name, tds, batch_size=3, cache_dir=str(tmp_path))
    again = tnorm.build_normalizer(name, cache_dir=str(tmp_path))
    for k in type(got).keys:
        assert torch.equal(getattr(cached, k), getattr(got, k))
        assert torch.equal(getattr(again, k), getattr(got, k))


@pytest.mark.parametrize("name", ["gaussian", "range"])
def test_reference_pt_cache_reads_as_in_jax(tmp_path, name):
    r = np.random.default_rng(6)
    keys = tnorm.build_normalizer(name, stats={
        k: np.ones(3, np.float32) for k in (
            ("mean_inputs", "mean_targets", "std_inputs", "std_targets")
            if name == "gaussian" else ("max_inputs", "max_targets"))}).keys
    vals = [torch.from_numpy(r.uniform(0.5, 2, 3).astype(np.float32)) for _ in keys]
    vals[-1][1] = 0.0                       # a zero spread or range scales by one
    cache = "mean_std" if name == "gaussian" else "max"
    torch.save(tuple(vals), tmp_path / f"{cache}.pt")
    ref = jnorm.build_normalizer(name, cache_dir=str(tmp_path))
    got = tnorm.build_normalizer(name, cache_dir=str(tmp_path))
    for k in keys:
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k))), k
