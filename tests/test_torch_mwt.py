"""PyTorch port vs JAX package: MWT3d and its ops (CPU, f32).

1. ``ops/multiwavelet.cz_matrices`` equals the JAX package's, legendre and
   chebyshev, k 2 to 4.
2. The shared ``ops/spectral.rfftn`` / ``irfftn`` against the JAX package's
   dense-DFT route ``rfftn_planes`` / ``irfftn_planes``, on half spectra
   that are not Hermitian too (imaginary zero and Nyquist frequencies,
   overlapping corners); the low-precision DFT route keeps a float64
   copy's float64.
3. ``from_jax.mwt_state_dict`` equals ``export_torch_state_dict`` key for
   key and value for value, and ``load_state_dict(strict=True)`` takes it.
4. The whole model at a rectangular (4, 16, 32, 3) window with alpha 3,
   whose levels reach both branches of the Fourier kernel (the shared
   truncated spectral conv at 8×16, the overlapping corners below), at
   T_out = T_in and 2·T_in: the forward in eval mode, the loss and every
   parameter gradient in train mode; in bfloat16, the same forward within
   bf16 limits of the f32 one.
5. A 3-step trajectory of the port's ``make_train_step`` against the JAX
   step (Adam, cosine schedule, Gaussian normalizer inside the step, the
   shipped lr 1e-3); float-noise entries as ``tests/torch_trajectory.py``
   sets out; the imaginary part of the first corner's zero mode, which
   the inverse transform drops, has a true gradient of 0.
6. ``build_model`` for the five shipped configs at their scenarios' window
   shapes: the parameter count equals the JAX init's, the state dict's
   keys and shapes the exporter's; the card is the default device;
   ``wdno`` and ``dmd`` still raise.
7. ``python -m realpdebench_tpu_torch train`` then ``eval`` on a synthetic
   tree with ``--device cpu``, from the port's config.
8. The CZ matrices are buffers outside the state dict: a forward reads
   them from the model's device, not from the host.

Weights: the JAX init perturbed by seeded numpy noise, converted by
``mwt_state_dict``. Tolerance: rtol 2e-4 with atol 2e-4·max|ref|.
"""

import glob
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_trajectory as tt

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.ops import multiwavelet as jmw
from realpdebench_tpu.ops import spectral as jsp
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch import config as tc
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import mwt_state_dict
from realpdebench_tpu_torch.models import mwt as tmwt
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.ops import multiwavelet as tmw
from realpdebench_tpu_torch.ops import spectral as tsp
from realpdebench_tpu_torch.train import build_optimizer, make_train_step

SI = SO = (4, 16, 32, 3)
KW = dict(model_name="mwt", k=3, alpha=3, c=2, nCZ=2, L=0, base="legendre")
B, STEPS, LR = 2, 3, 1e-3

WINDOWS = {
    "combustion": ((20, 64, 64, 16), (20, 64, 64, 16)),
    "controlled_cylinder": ((10, 64, 128, 5), (10, 64, 128, 3)),
    "cylinder": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "foil": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "fsi": ((20, 64, 64, 3), (20, 64, 64, 3)),
}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_params(jb, si, seed):
    """The JAX init, every parameter moved by seeded noise."""
    r = np.random.default_rng(seed)
    v = jb.init(jax.random.PRNGKey(seed), np.zeros((1, *si), np.float32))
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a + 0.1 * r.normal(size=a.shape), a.dtype), v["params"])


def _port(params, si=SI, so=SO, **kw):
    m = build_model(shapes=(si, so), device="cpu", **{**KW, **kw})
    m.load_state_dict(mwt_state_dict(_np_tree(params)), strict=True)
    return m


def _zero_grad(name):
    """The imaginary part of the first corner's zero mode (the inverse
    transform drops it), in the ``real`` form [C_in, C_out, α, α, α, 2]."""
    if not name.endswith("A.weights1"):
        return False
    mask = np.zeros((1, 1, KW["alpha"], KW["alpha"], KW["alpha"], 2), bool)
    mask[0, 0, 0, 0, 0, 1] = True
    return mask


@pytest.mark.parametrize("base", ["legendre", "chebyshev"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_cz_matrices_equal_jax(base, k):
    for got, ref in zip(tmw.cz_matrices(base, k), jmw.cz_matrices(base, k), strict=True):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("s", [(6, 8, 10), (5, 7, 9), (4, 2, 5), (2, 4, 20)], ids=str)
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_rfftn_and_irfftn_match_the_planes(s, norm):
    r = np.random.default_rng(8)
    x = r.normal(size=(2, *s, 3)).astype(np.float32)
    axes = (1, 2, 3)
    re, im = jsp.rfftn_planes(jnp.asarray(x), axes=axes, norm=norm)
    got = tsp.rfftn(torch.from_numpy(x), dim=axes, norm=norm)
    tt.close(got.real.numpy(), re, msg="rfftn re")
    tt.close(got.imag.numpy(), im, msg="rfftn im")
    # a half spectrum that is not Hermitian: every frequency drawn
    hs = (2, *s[:-1], s[-1] // 2 + 1, 3)
    zr, zi = (r.normal(size=hs).astype(np.float32) for _ in range(2))
    ref = jsp.irfftn_planes(jnp.asarray(zr), jnp.asarray(zi), s=s, axes=axes, norm=norm)
    got = tsp.irfftn(torch.complex(torch.from_numpy(zr), torch.from_numpy(zi)), s, axes,
                     norm=norm)
    tt.close(got.numpy(), ref, msg="irfftn")


def test_lowp_dft_keeps_float64():
    """A float64 copy's truncated spectral conv stays in float64 (its DFT
    factors are the float32 ones), against numpy's FFT in float64."""
    r = np.random.default_rng(9)
    x = r.normal(size=(2, 8, 8, 6, 3))
    wr, wi = (r.normal(size=(4, 2, 2, 3, 3, 4)) for _ in range(2))
    got = tsp.truncated_spectral_conv3d(torch.from_numpy(x), torch.from_numpy(wr),
                                        torch.from_numpy(wi), compute_dtype=torch.float64)
    assert got.dtype == torch.float64
    f = np.fft.rfftn(x, axes=(1, 2, 3))
    out = np.zeros(f.shape[:-1] + (4,), complex)
    for k, (a, b) in enumerate(((slice(0, 2), slice(0, 2)), (slice(-2, None), slice(0, 2)),
                                (slice(0, 2), slice(-2, None)),
                                (slice(-2, None), slice(-2, None)))):
        out[:, a, b, :3] = np.einsum("bxyzi,xyzio->bxyzo", f[:, a, b, :3], wr[k] + 1j * wi[k])
    ref = np.fft.irfftn(out, s=(8, 8, 6), axes=(1, 2, 3))
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.fixture(scope="module")
def pair():
    jb = jbuild(shapes=(SI, SO), **KW)
    p = _jax_params(jb, SI, 0)
    return _port(p), jb, p


def test_export_loads_strict_and_equals_from_jax(pair):
    m, jb, p = pair
    exported = export_torch_state_dict(jb, p, {})
    mine = mwt_state_dict(_np_tree(p))
    assert set(exported) == set(mine) == set(m.state_dict())
    for k, t in mine.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), t.numpy(), err_msg=k)
    fresh = build_model(shapes=(SI, SO), device="cpu", **KW)
    fresh.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in exported.items()},
                          strict=True)


@pytest.mark.parametrize("so", [SO, (8, 16, 32, 3)], ids=["same", "t_out"])
def test_forward_and_gradients_match_jax(so):
    jb = jbuild(shapes=(SI, so), **KW)
    p = _jax_params(jb, SI, 1)
    m = _port(p, SI, so)
    r = np.random.default_rng(16)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *so)).astype(np.float32)
    calls = {"truncated": 0, "corners": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    with mock.patch.object(tmwt, "truncated_spectral_conv3d",
                           count("truncated", tmwt.truncated_spectral_conv3d)), \
            mock.patch.object(tmwt, "irfftn", count("corners", tmwt.irfftn)):
        fwd = m.predict(torch.from_numpy(x))
    # per cell: level 8x16 truncated; 4x8, 2x4, 1x2 the corners
    assert calls == {"truncated": KW["nCZ"], "corners": 3 * KW["nCZ"]}, calls
    tt.close(fwd.numpy(), jb.module.apply({"params": p}, jnp.asarray(x)), msg="forward")

    def loss(q):
        return jnp.mean((jb.module.apply({"params": q}, jnp.asarray(x), train=True) - y) ** 2)

    jl, jgrad = jax.jit(jax.value_and_grad(loss))(p)
    m.train()
    tl = m(torch.from_numpy(x), y=torch.from_numpy(y))
    tl.backward()
    tt.close(tl.item(), float(jl))
    want = mwt_state_dict(_np_tree(jgrad))
    for name, q in m.named_parameters():
        got, ref = tt.real(q.grad.numpy()), tt.real(want[name].numpy())
        zero = np.broadcast_to(_zero_grad(name), got.shape)
        for side in (got, ref):
            assert np.abs(side[zero]).max(initial=0) <= 1e-5 * np.abs(ref).max(), name
        tt.close(np.where(zero, 0, got), np.where(zero, 0, ref), msg=name)

    mb = _port(p, SI, so, compute_dtype="bfloat16")
    low = mb.predict(torch.from_numpy(x))
    assert low.dtype == torch.float32
    assert ((low - fwd).norm() / fwd.norm()).item() <= 5e-2


def test_train_step_trajectory_matches_jax(pair):
    m0, jb, p = pair
    cfg = dict(lr=LR, scheduler="cosine", num_update=4, clip_grad_norm=0.0)
    r = np.random.default_rng(20)
    xs = r.normal(size=(STEPS, B, *SI)).astype(np.float32)
    ys = r.normal(size=(STEPS, B, *SO)).astype(np.float32)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2.0, 3), std_targets=r.uniform(0.5, 2.0, 3))
    stats = {k: a.astype(np.float32) for k, a in stats.items()}

    fresh = lambda t: jax.tree_util.tree_map(jnp.array, t)   # the step donates
    state = jts.TrainState.create(fresh(p), {}, jts.build_optimizer(Config(**cfg)))
    jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats))
    jlosses, jbefore, mus = [], [], []
    for i in range(STEPS):
        jbefore.append(_np_tree(state.params))
        state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]), jax.random.PRNGKey(i))
        jlosses.append(float(jl))
        mus.append(_np_tree(tt.adam_mu(state.opt_state)))

    model = build_model(shapes=(SI, SO), device="cpu", **KW)
    init = {k: t.clone() for k, t in m0.state_dict().items()}
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    norm = tnorm.build_normalizer("gaussian", stats=stats)
    step = make_train_step(model, norm, opt)
    losses, before, g32 = [], [], []
    for i in range(STEPS):
        before.append({k: t.clone() for k, t in model.state_dict().items()})
        losses.append(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item())
        g32.append({n: tt.real(q.grad.numpy()) for n, q in model.named_parameters()})
    tt.close(losses, jlosses)

    fresh64 = lambda: build_model(shapes=(SI, SO), device="cpu", **KW)
    noisy = {}
    for i, (gj, slack) in enumerate(tt.adam_grads(mus, mwt_state_dict)):
        xn, yn = norm.preprocess(torch.from_numpy(xs[i]).double(),
                                 torch.from_numpy(ys[i]).double())
        g64, j64 = (tt.grads64(fresh64(), w, xn, yn)
                    for w in (before[i], mwt_state_dict(jbefore[i])))
        for n, mask in tt.step_noise(g32[i], gj, slack, g64, j64).items():
            noisy[n] = noisy.get(n, False) | mask
    tt.check_final(model, init, mwt_state_dict(_np_tree(state.params)), noisy, _zero_grad,
                   STEPS, LR)


def test_fourier_kernel_dtypes_under_bfloat16():
    """The truncated branch returns the compute dtype; the deep levels'
    branch computes in float32, its Lo too (JAX's has no dtype there)."""
    m = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16", **KW)
    A = m.MWT_CZ[0].A
    r = np.random.default_rng(3)
    top = torch.from_numpy(r.normal(size=(1, 8, 16, 4, 2, 9))).to(torch.bfloat16)
    deep = torch.from_numpy(r.normal(size=(1, 2, 4, 4, 2, 9))).to(torch.bfloat16)
    assert A(top, torch.bfloat16).dtype == torch.bfloat16
    assert A(deep, torch.bfloat16).dtype == torch.float32


def test_cz_matrices_are_buffers_outside_the_state_dict():
    """Each cell holds the six matrices as buffers that move with the model
    (a float64 copy's in float64), the state dict leaves them out, and a
    forward copies none from the host."""
    m = build_model(shapes=(SI, SO), device="cpu", **KW)
    names = ("ec_s", "ec_d", "rc_ee", "rc_eo", "rc_oe", "rc_oo")
    for cell in m.MWT_CZ:
        for name, ref in zip(names, tmw.cz_matrices(KW["base"], KW["k"]), strict=True):
            assert torch.equal(getattr(cell, name), torch.from_numpy(ref)), name
    assert not [k for k in m.state_dict() if k.rsplit(".", 1)[-1] in names]
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, *SI)).astype(np.float32))
    with mock.patch.object(tmwt, "cz_matrices", side_effect=AssertionError):
        m(x)
    m.double()
    assert m.MWT_CZ[0].ec_s.dtype == torch.float64


@pytest.mark.parametrize("scenario", tuple(WINDOWS))
def test_build_model_for_each_shipped_config(scenario):
    si, so = WINDOWS[scenario]
    cfg = tc.load_config(f"{scenario}/mwt.yaml").to_dict()
    m = build_model(shapes=(si, so), device="meta", remat=True, **cfg)
    assert isinstance(m, tmwt.MWT3d) and m.compute_dtype == torch.float32
    jb = jbuild(shapes=(si, so), **cfg)
    shapes = jax.eval_shape(jb.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *si), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes["params"])
    ref = export_torch_state_dict(jb, zeros, {})
    assert {k: tuple(t.shape) for k, t in m.state_dict().items()} == {
        k: np.shape(a) for k, a in ref.items()}
    n = sum(q.numel() for q in m.parameters())
    # complex weights count twice: JAX holds their real and imaginary planes
    n += sum(q.numel() for q in m.parameters() if q.is_complex())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    if scenario == "cylinder":
        assert n == 5495987


def test_build_model_defaults_to_the_card_and_the_rest_still_raise():
    m = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16", **KW)
    out = m.predict(torch.zeros(1, *SI))
    assert m.compute_dtype == torch.bfloat16 and out.dtype == torch.float32
    assert out.shape == (1, *SO)
    # every family of the JAX registry builds now, the last two among them
    assert type(build_model(shapes=(SI, SO), model_name="wdno", dim=8,
                            device="cpu")).__name__ == "WDNO"
    dmd = build_model(shapes=(SI, SO), model_name="dmd", n_modes=2, n_predict=SO[0],
                      input_feature=2, N_autoregressive=1, device="cpu")
    assert not dmd.trainable
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(shapes=(SI, SO), **KW)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = tmp_path_factory.mktemp("mwt_tree")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    return str(root)


def test_cli_train_then_eval_on_the_cpu(tree, tmp_path):
    from realpdebench_tpu_torch.cli import main
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    common = ["--config", "cylinder/mwt.yaml", "--dataset_root", tree,
              "--device", "cpu", "--results_path", str(tmp_path), "--num_workers", "0",
              "--train_batch_size", "4", "--test_batch_size", "4", "--c", "1",
              "--nCZ", "1", "--alpha", "2", "--N_autoregressive", "2", "--N_plot", "0",
              "--N_plot_probe", "0", "--is_use_tb", "false", "--num_update", "2",
              "--in_step", "4", "--out_step", "4", "--interval", "4",
              "--trunk_length", "8", "--n_sim_frame", "32", "--n_sim_in_distribution", "1",
              "--n_sim_out_distribution", "1", "--sub_s_real", "1",
              "--sub_s_numerical", "1", "--generate_ids_if_missing"]
    with pytest.raises(SystemExit) as e:
        main(["train", *common])
    assert e.value.code == 0
    (ckpt,) = glob.glob(os.path.join(str(tmp_path), "mwt", "*_numerical_False", "*", "ckpt"))
    assert sorted(os.listdir(ckpt)) == ["checkpoint_1.pth", "checkpoint_2.pth"]
    _, results = eval_main([*common, "--checkpoint_path", ckpt])
    for k in ("rmse", "rel_l2_error", "normalized_mse"):     # no probe_diagnostic key
        assert np.isfinite(results[k]), k
