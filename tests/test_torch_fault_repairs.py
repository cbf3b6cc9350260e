"""Repairs of the port's faults against the reference, on the CPU.

1. The normalizer's statistics cross to a device once and are cached there:
   a ``preprocess`` or ``postprocess`` makes no copy once the cache holds
   them (the JAX package keeps them as device constants of its jitted step).
2. Where the CUDA kernels are built: ``build/kernels`` at the root of a
   source checkout, a per-user cache directory for an installed copy.
3. The Galerkin scores' backward runs in the dtypes of the JAX package's
   ``_scores_bwd``: for bfloat16 k and v with float32 affine parameters, the
   LayerNorm's centring, rsqrt and normalised rows stay in bfloat16 and the
   affine and the product run in float32, read from the jaxpr of JAX's vjp
   and from the operations PyTorch dispatches for the port's; the
   gradients agree to bfloat16 level (relative L2 1e-2), and in float32 the
   recompute is the twin.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from realpdebench_tpu.ops.pallas import galerkin as jpg
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.ops import galerkin as tga
from realpdebench_tpu_torch.ops import kernels

# --------------------------------------------------------------------------
# 1. normalizer statistics cached per device
# --------------------------------------------------------------------------

STATS = dict(mean_inputs=[0.5, -1.0, 2.0], std_inputs=[2.0, 0.5, 1.5],
             mean_targets=[0.1, 0.2, 0.3], std_targets=[1.0, 3.0, 0.25],
             max_inputs=[4.0, 2.0, 1.0], max_targets=[3.0, 5.0, 7.0])


class _CountTo(TorchDispatchMode):
    """Counts the copies between devices and dtypes that run under it."""

    def __init__(self):
        super().__init__()
        self.copies = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.startswith(("_to_copy", "copy_")):
            self.copies += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["gaussian", "range"])
def test_normalizer_statistics_cross_once_per_device(name):
    norm = tnorm.build_normalizer(name, stats=STATS)
    r = np.random.default_rng(0)
    for dev in ("cpu", "meta"):
        x = torch.from_numpy(r.normal(size=(2, 4, 5, 5, 3)).astype(np.float32)).to(dev)
        y = torch.from_numpy(r.normal(size=(2, 4, 5, 5, 2)).astype(np.float32)).to(dev)
        norm.preprocess(x, y)                      # fills the cache for this device
        cached = dict(norm._device_stats)
        assert all(v.device == x.device for (k, d), v in cached.items() if d == x.device)
        with _CountTo() as mode:
            xn, yn = norm.preprocess(x, y)
            norm.postprocess(xn, yn)
        assert mode.copies == 0
        assert all(norm._device_stats[k] is v for k, v in cached.items())
    assert {d.type for _, d in norm._device_stats} == {"cpu", "meta"}
    keys = {k for k, _ in norm._device_stats}
    assert keys == set(norm.keys)
    xn, yn = norm.preprocess(torch.ones(1, 3), torch.ones(1, 2))
    back = norm.postprocess(xn, yn)
    np.testing.assert_allclose(back[0].numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(back[1].numpy(), 1.0, rtol=1e-6)


# --------------------------------------------------------------------------
# 2. the kernels' build directory
# --------------------------------------------------------------------------


def test_build_dir_in_a_checkout_and_in_an_installed_copy(tmp_path, monkeypatch):
    repo = tmp_path / "checkout"
    (repo / "realpdebench_tpu_torch").mkdir(parents=True)
    (repo / "pyproject.toml").write_text("[project]\n")
    assert kernels.build_dir(repo / "realpdebench_tpu_torch") == repo / "build" / "kernels"
    site = tmp_path / "site-packages" / "realpdebench_tpu_torch"
    site.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert kernels.build_dir(site) == tmp_path / "cache" / "realpdebench_tpu_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert kernels.build_dir(site) == (tmp_path / "home" / ".cache" / "realpdebench_tpu_torch"
                                       / "kernels")
    # this repository is a source checkout: the directory .gitignore lists
    root = Path(kernels.__file__).resolve().parents[2]
    assert kernels.BUILD_DIR == root / "build" / "kernels"
    assert "build/" in (root / ".gitignore").read_text().splitlines()
    assert kernels.library_path().parent == kernels.BUILD_DIR


# --------------------------------------------------------------------------
# 3. the Galerkin scores' backward dtypes
# --------------------------------------------------------------------------

B, H, N, D = 2, 2, 24, 8


def _scores_inputs():
    r = np.random.default_rng(5)
    k = r.normal(1.0, 2.0, size=(B, H, N, D)).astype(np.float32)
    v = r.normal(-0.5, 1.5, size=(B, H, N, D)).astype(np.float32)
    aff = [(1 + 0.1 * r.normal(size=(H, D))).astype(np.float32),
           (0.1 * r.normal(size=(H, D))).astype(np.float32),
           (1 + 0.1 * r.normal(size=(H, D))).astype(np.float32),
           (0.1 * r.normal(size=(H, D))).astype(np.float32)]
    g = r.normal(size=(B, H, D, D)).astype(np.float32)
    return k, v, aff, g


def _jaxpr_eqns(jaxpr):
    """Every equation of a jaxpr, its sub-jaxprs' included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    yield from _jaxpr_eqns(getattr(inner, "jaxpr", inner))


class _Ops(TorchDispatchMode):
    """Records (op name, output dtype, output shape) of what runs under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            self.ops.append((func.__name__.split(".")[0], out.dtype, tuple(out.shape)))
        return out


def _tokens(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(B, N, H * D))


def test_scores_backward_runs_in_the_dtypes_of_jax():
    k, v, aff, g = _scores_inputs()
    kb, vb = (jnp.asarray(t, jnp.bfloat16) for t in (k, v))
    fn = lambda *a: jpg.galerkin_scores(*a, 1e-5)
    out, vjp = jax.vjp(fn, kb, vb, *map(jnp.asarray, aff))
    jgrads = vjp(jnp.asarray(g))
    eqns = list(_jaxpr_eqns(jax.make_jaxpr(vjp)(jnp.asarray(g)).jaxpr))
    dtypes = lambda prim, shape: {str(e.outvars[0].aval.dtype) for e in eqns
                                  if e.primitive.name == prim
                                  and tuple(e.outvars[0].aval.shape) == shape}
    rows, stat = (B, H, N, D), (B, H, N, 1)
    # JAX: the normalised rows' cotangent and the centring's backward in bf16,
    # the affine's gradients and the product's in f32
    assert "bfloat16" in dtypes("mul", rows) and "float32" in dtypes("mul", rows)
    assert dtypes("rsqrt", stat) == {"bfloat16"}
    assert [str(t.dtype) for t in jgrads] == ["bfloat16"] * 2 + ["float32"] * 4

    leaves = [_tokens(k).bfloat16(), _tokens(v).bfloat16(), *map(torch.from_numpy, aff)]
    leaves = [t.requires_grad_() for t in leaves]
    out_t = tga.galerkin_scores(*leaves, H, 1e-5)
    assert out_t.dtype == torch.float32
    with _Ops() as rec:
        grads = torch.autograd.grad(out_t, leaves, torch.from_numpy(g))
    ops = rec.ops
    prows, pstat = (B, N, H, D), (B, N, H, 1)
    got = lambda name, shape: {dt for n, dt, s in ops if n == name and s == shape}
    # the port: the same split, rsqrt recomputed in bf16 and bf16 products
    # on the rows in the backward beside the f32 ones
    assert got("rsqrt", pstat) == {torch.bfloat16}
    assert {torch.bfloat16, torch.float32} <= got("mul", prows)
    assert [t.dtype for t in grads] == [torch.bfloat16] * 2 + [torch.float32] * 4

    split = lambda t: t.float().numpy().reshape(B, N, H, D).transpose(0, 2, 1, 3)
    for name, mine, want in zip(("dk", "dv", "dks", "dkb", "dvs", "dvb"),
                                (split(grads[0]), split(grads[1]),
                                 *(t.numpy() for t in grads[2:])), jgrads):
        want = np.asarray(want, np.float32)
        rel = np.linalg.norm(mine - want) / np.linalg.norm(want)
        assert rel <= 1e-2, (name, rel)


def test_ln_as_jax_rounds_where_jax_does():
    """The recompute's LayerNorm against JAX ``_ln`` on bf16 rows: within one
    bf16 step of each other; in f32 the recompute equals the twin."""
    k, _, aff, _ = _scores_inputs()
    x = k[0].transpose(1, 0, 2)                       # [N, H, D]
    want = np.asarray(jpg._ln(jnp.asarray(x, jnp.bfloat16), jnp.asarray(aff[0]),
                              jnp.asarray(aff[1]), 1e-5), np.float32)
    got = tga._ln_as_jax(torch.from_numpy(x).bfloat16(), torch.from_numpy(aff[0]),
                         torch.from_numpy(aff[1]), 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -7, atol=2.0 ** -7)
    kt, vt = _tokens(k), _tokens(k[::-1].copy())
    a = [torch.from_numpy(t) for t in aff]
    assert torch.equal(tga.galerkin_scores_as_jax(kt, vt, *a, H, 1e-5),
                       tga.galerkin_scores_plain(kt, vt, *a, H, 1e-5))
