"""PyTorch port vs JAX package: the autoregressive rollout (CPU, f32).

The JAX rollout (one jitted lax.scan over the unfused FNO3d) and the port's
Python loop over its FNO3d run 3 steps from the same numpy window, weights
and normalizer statistics, with and without control-channel re-injection.
Tolerance: rtol 2e-4 with atol 2e-4·max|ref|.
"""

import jax
import numpy as np
import pytest
import torch

from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.eval.rollout import finalize_rollout as jfinalize
from realpdebench_tpu.eval.rollout import make_rollout_fn as jrollout
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.eval.rollout import finalize_rollout, make_rollout_fn
from realpdebench_tpu_torch.interop.from_jax import fno_state_dict
from realpdebench_tpu_torch.models.registry import build_model

STEPS, B = 3, 2
KW = dict(model_name="fno", modes1=2, modes2=3, modes3=3, n_layers=2,
          width=8, use_pallas=False, remat=False)


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _stats(r, c):
    return dict(mean_inputs=r.normal(size=c).astype(np.float32),
                mean_targets=r.normal(size=c).astype(np.float32),
                std_inputs=r.uniform(0.5, 2.0, c).astype(np.float32),
                std_targets=r.uniform(0.5, 2.0, c).astype(np.float32))


@pytest.mark.parametrize("para_c", [0, 1])
@pytest.mark.parametrize("norm", ["none", "gaussian"])
def test_rollout_matches_jax(monkeypatch, norm, para_c):
    monkeypatch.setenv("REALPDEBENCH_GELU", "exact")
    c_in = 3
    si = (4, 12, 12, c_in)
    so = (4, 12, 12, c_in - para_c)
    r = np.random.default_rng(10 * para_c + (norm == "gaussian"))
    stats = _stats(r, c_in) if norm == "gaussian" else None

    jb = jbuild(shapes=(si, so), **KW)
    v = jb.init(jax.random.PRNGKey(0), np.zeros((1, *si), np.float32))
    # non-trivial BN statistics: the init ones would hide a folding error
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (r.uniform(0.5, 1.5, a.shape).astype(np.float32)
                      if "var" in jax.tree_util.keystr(p) else a), v)
    x = r.normal(size=(B, *si)).astype(np.float32)
    y = r.normal(size=(B, STEPS * so[0], *so[1:])).astype(np.float32)

    jn = jnorm.build_normalizer(norm, stats=stats)
    j_pred, j_xn, j_yn = jrollout(jb, jn, STEPS, para_c=para_c)(
        v, x, y, jax.random.PRNGKey(1))

    model = build_model(shapes=(si, so), device="cpu", **KW)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    model.load_state_dict(fno_state_dict(np_tree(v["params"]),
                                         np_tree(v["batch_stats"])), strict=True)
    tn = tnorm.build_normalizer(norm, stats=stats)
    pred, xn, yn = make_rollout_fn(model, tn, STEPS, para_c=para_c)(
        torch.from_numpy(x), torch.from_numpy(y))
    assert tuple(pred.shape) == (B, STEPS * so[0], *so[1:])
    _close(pred.numpy(), j_pred)
    _close(xn.numpy(), j_xn)
    _close(yn.numpy(), j_yn)

    c = so[-1]
    j_final = jfinalize(jn, j_pred, j_xn, j_yn, c)
    t_final = finalize_rollout(tn, pred, xn, yn, c)
    for got, ref in zip(t_final, j_final):
        _close(got.numpy(), ref)


def test_normalizers_match_jax_and_read_npz(tmp_path):
    r = np.random.default_rng(5)
    stats = _stats(r, 3)
    np.savez(tmp_path / "mean_std.npz", **stats)
    rng_stats = dict(max_inputs=r.uniform(0.5, 2, 3).astype(np.float32),
                     max_targets=np.array([2.0, 0.0, 1.5], np.float32))
    np.savez(tmp_path / "max.npz", **rng_stats)
    x = r.normal(size=(2, 4, 3)).astype(np.float32)
    y = r.normal(size=(2, 4, 2)).astype(np.float32)
    for name in ("gaussian", "range"):
        jn = jnorm.build_normalizer(name, cache_dir=str(tmp_path))
        tn = tnorm.build_normalizer(name, cache_dir=str(tmp_path))
        for op in ("preprocess", "postprocess"):
            ref = getattr(jn, op)(x, y)
            got = getattr(tn, op)(torch.from_numpy(x), torch.from_numpy(y))
            for g, rr in zip(got, ref):
                _close(g.numpy(), rr)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tnorm.build_normalizer("gaussian")
