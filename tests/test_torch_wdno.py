"""PyTorch port vs JAX package: WDNO (CPU, f32).

1. ``from_jax.wdno_state_dict`` equals the JAX exporter's ``export_wdno``
   key for key (the Unet3d under ``model.``, the eleven schedule buffers
   and ``log_one_minus_alphas_cumprod``), and ``load_state_dict(strict=
   True)`` takes it.
2. The three beta schedules and every schedule array, bit for bit.
3. The pipeline's geometry at each shipped scenario's window with its
   shipped config (the H pad reused for W on the non-square grids; the
   denoiser at dim 8 but for the cylinder's), the parameter shapes at the
   cylinder's full width, and the coefficient
   packing: ``to_coef_tensor`` against JAX's, and the round trip back to
   the target (also time-upsampled, sub_f 2).
4. The DDPM loss and every parameter gradient, with ``t`` and the noise
   that ``jax.random`` draws from the key ``WDNOPipeline.loss`` splits
   injected into the port (rtol 2e-4). The conv biases before a GroupNorm
   of one channel a group have a true gradient of 0: both sides' are held
   to 1e-5 of the same block's conv weight's largest gradient.
5. Sampling with the draws of the JAX sampler injected: DDIM at eta 1 and
   0, ancestral, and a time-upsampled output. The first DDIM step
   multiplies the denoiser's rounding by √(1/ᾱ−1) (241 at t 19 of the
   20-step sigmoid schedule; 1825 at the shipped t 999) before the clip,
   so each f32 side is held to a float64 replay of the port's sampler on
   the same draws, within 2e-4 of its max|ref| (the f32 sides sit 1.6–3e-5
   from it at these shapes), rather than to each other at rtol 2e-4.
6. The rescaler on a synthetic tree against JAX's, and its cache written
   by either package read by the other.
7. A 3-step trajectory of the port's ``make_train_step`` against the JAX
   step (clip 1.0, Adam, cosine schedule, Gaussian normalizer), each step's
   draws from ``jax.random.PRNGKey(i)`` injected; float noise as
   ``tests/torch_trajectory.py`` sets out, with each step's float64 replay
   clipped by its own global norm.
8. ``python -m realpdebench_tpu_torch train`` then ``eval`` on a synthetic
   tree with ``--device cpu``, from the port's config; the rescaler's cache
   written by the train run.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_trajectory as tt

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_convert import convert_unet
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models import wdno as jw
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch import config as tc
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import wdno_state_dict
from realpdebench_tpu_torch.models import wdno as tw
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

SI = SO = (4, 8, 8, 2)
KW = dict(model_name="wdno", dim=8, dim_mults=[1, 2], wave_type="bior1.1",
          pad_mode="zero", beta_schedule="sigmoid", timesteps=20,
          sampling_timesteps=4, ddim_sampling_eta=1.0)
B, STEPS, LR = 2, 3, 1e-3
SAMPLE_TOL = 2e-4

WINDOWS = {
    "combustion": ((20, 64, 64, 16), (20, 64, 64, 16)),
    "controlled_cylinder": ((10, 64, 128, 5), (10, 64, 128, 3)),
    "cylinder": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "foil": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "fsi": ((20, 64, 64, 3), (20, 64, 64, 3)),
}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while these small runs go: with the suite's
    workers on every core, a full pool of spinning threads slows them a
    hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_params(so=SO, seed=0, **kw):
    """JAX parameters from the port's seeded init, every parameter moved by
    seeded noise (no zero bias, no unit scale), through the JAX package's
    converter (no JAX init to run)."""
    m = build_model(shapes=(SI, so), device="cpu", generator=make_generator(seed),
                    **{**KW, **kw})
    r = np.random.default_rng(seed + 100)
    sd = {k[len("model."):]: v.numpy() + 0.1 * r.normal(size=v.shape).astype(np.float32)
          for k, v in m.state_dict().items() if k.startswith("model.")}
    return jax.tree_util.tree_map(jnp.asarray, convert_unet(sd, None, {})[0])


def _port(params, si=SI, so=SO, dtype=None, **kw):
    kw = {**KW, **kw}
    if dtype is None:
        m = build_model(shapes=(si, so), device="cpu", **kw)
    else:   # a float64 copy: every layer built in float64
        m = tw.WDNO(si, so, dim=kw["dim"], dim_mults=kw["dim_mults"],
                    wave_type=kw["wave_type"], beta_schedule=kw["beta_schedule"],
                    timesteps=kw["timesteps"], sampling_timesteps=kw["sampling_timesteps"],
                    ddim_eta=kw["ddim_sampling_eta"], compute_dtype=dtype).to(dtype)
    m.load_state_dict(wdno_state_dict(_np_tree(params), kw["beta_schedule"],
                                      kw["timesteps"]), strict=True)
    return m


@pytest.fixture(scope="module")
def pair():
    params = _jax_params()
    return _port(params), jbuild(shapes=(SI, SO), **KW), params


def _apply(jb):
    return jax.jit(lambda v, s: jb.module.apply(v, s, train=False))


def _zero_grad(name, grads=None):
    """The conv biases before a GroupNorm of one channel a group (the
    8-channel blocks at dim 8): the norm cancels them."""
    return name.endswith("proj.bias") and (grads is None or grads[name].size == 8)


def _compare_grads(grads, want):
    for name, g in grads.items():
        if _zero_grad(name, grads):
            scale = np.abs(grads[name[:-4] + "weight"]).max()
            for side in (g, want[name]):
                assert np.abs(side).max() <= 1e-5 * scale, name
            continue
        tt.close(g, want[name], msg=name)


# --------------------------------------------------------------------------


def test_state_dict_equals_export_and_loads_strict(pair):
    m, jb, params = pair
    exported = export_torch_state_dict(jb, params, {})
    mine = wdno_state_dict(_np_tree(params), "sigmoid", 20)
    assert set(exported) == set(mine) == set(m.state_dict())
    assert len([k for k in mine if not k.startswith("model.")]) == 12
    for k, t in mine.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), t.numpy(), err_msg=k)
    fresh = build_model(shapes=(SI, SO), device="cpu", **KW)
    fresh.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in exported.items()},
                          strict=True)


@pytest.mark.parametrize("name", ["linear", "cosine", "sigmoid"])
@pytest.mark.parametrize("timesteps", [20, 1000])
def test_schedules_equal_jax_bit_for_bit(name, timesteps):
    np.testing.assert_array_equal(tw.BETA_SCHEDULES[name](timesteps),
                                  jw.BETA_SCHEDULES[name](timesteps))
    with np.errstate(divide="ignore"):
        want = jw.DiffusionSchedule.create(name, timesteps)
    got = tw.DiffusionSchedule.create(name, timesteps)
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
              "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_variance",
              "posterior_log_variance_clipped", "posterior_mean_coef1",
              "posterior_mean_coef2"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("scenario", tuple(WINDOWS))
def test_geometry_of_each_shipped_config(scenario):
    si, so = WINDOWS[scenario]
    cfg = tc.load_config(f"{scenario}/wdno.yaml").to_dict()
    if scenario != "cylinder":     # the geometry does not depend on the width
        cfg["dim"] = 8
    m = build_model(shapes=(si, so), device="meta", **cfg)
    pipe = jbuild(shapes=(si, so), **cfg).pipeline
    for k in ("c_in", "c_out", "channels", "coef_shape", "model_shape", "pad_t", "pad_x",
              "num_timesteps", "is_ddim", "sampling_timesteps", "ddim_eta"):
        assert getattr(m, k) == getattr(pipe, k), k
    assert m.pad_factor == pipe.pad_factor and m.remat
    assert m.model.in_time == m.model.out_time == m.model_shape[0]
    np.testing.assert_array_equal(m.pad_mask.cpu().numpy() if m.pad_mask.device.type != "meta"
                                  else pipe._pad_mask, pipe._pad_mask)
    if scenario == "cylinder":         # the shapes the card runs
        assert (m.channels, m.model_shape) == (48, (12, 32, 64))
        shapes = jax.eval_shape(lambda: jbuild(shapes=(si, so), **cfg).module.init(
            jax.random.PRNGKey(0), jnp.zeros((1, *m.model_shape, m.channels))))
        ref = wdno_state_dict(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes["params"]))
        assert {k: tuple(t.shape) for k, t in m.state_dict().items()} == {
            k: tuple(t.shape) for k, t in ref.items()}
    if scenario == "foil":             # bior1.3: H padded 34 → 36, W by H's pad
        assert m.coef_shape == (12, 34, 66) and m.model_shape == (12, 36, 68)


@pytest.mark.parametrize("so", [SO, (8, 8, 8, 2)], ids=["sub_f1", "sub_f2"])
def test_coefficients_and_round_trip(so):
    m = build_model(shapes=(SI, so), device="cpu", **KW)
    pipe = jbuild(shapes=(SI, so), **KW).pipeline
    r = np.random.default_rng(3)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *so)).astype(np.float32)
    packed = tw.pack_input_target(x, y)
    np.testing.assert_array_equal(packed, jw._pack_input_target(x, y))
    np.testing.assert_array_equal(
        tw.pack_input_target(torch.from_numpy(x), torch.from_numpy(y)).numpy(), packed)
    state = m.to_coef_tensor(torch.from_numpy(packed))
    assert tuple(state.shape) == (B, *m.model_shape, m.channels)
    tt.close(state.numpy(), pipe.to_coef_tensor(jnp.asarray(packed)), rtol=1e-6)
    np.testing.assert_allclose(m.from_coef_tensor(state).numpy(), y, atol=2e-5)


def test_loss_and_gradients_match_jax(pair):
    m, jb, params = pair
    pipe = jb.pipeline
    r = np.random.default_rng(4)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *SO)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    apply = lambda v, s: jb.module.apply(v, s, train=False)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: pipe.loss(apply, {"params": p}, jnp.asarray(x), jnp.asarray(y), key)))(params)
    t, noise = _loss_draws(pipe, key, B)
    m.zero_grad()
    tl = m.loss(torch.from_numpy(x), torch.from_numpy(y), t=t, noise=noise)
    tl.backward()
    tt.close(tl.item(), float(jl))
    _compare_grads({n: p.grad.numpy() for n, p in m.named_parameters()},
                   {k: v.numpy() for k, v in wdno_state_dict(_np_tree(jg)).items()})


def _loss_draws(pipe, key, b):
    """``t`` and the noise ``WDNOPipeline.loss`` draws from ``key``."""
    rng_t, rng_n = jax.random.split(key)
    t = jax.random.randint(rng_t, (b,), 0, pipe.num_timesteps)
    shape = (b, *pipe.model_shape, pipe.channels)
    return (torch.from_numpy(np.array(t)),
            torch.from_numpy(np.array(jax.random.normal(rng_n, shape, jnp.float32))))


def _sample_draws(m, pipe, key, b):
    """The Gaussian draws ``WDNOPipeline.sample`` takes from ``key``: the
    initial state, then one a step (DDIM: those with a next time)."""
    shape = (b, *pipe.model_shape, pipe.channels)
    rng, k = jax.random.split(key)
    draws = [jax.random.normal(k, shape, jnp.float32)]
    for _ in range(m.n_draws() - 1):
        rng, k = jax.random.split(rng)
        draws.append(jax.random.normal(k, shape, jnp.float32))
    return [torch.from_numpy(np.array(d)) for d in draws]


SAMPLERS = {"ddim_eta1": dict(), "ddim_eta0": dict(ddim_sampling_eta=0.0),
            "ancestral": dict(sampling_timesteps=20),
            "sub_f2": dict(so=(8, 8, 8, 2))}


@pytest.mark.parametrize("case", tuple(SAMPLERS))
def test_sampling_matches_jax_with_its_draws(pair, case):
    kw = dict(SAMPLERS[case])
    so = kw.pop("so", SO)
    _, jb0, params = pair
    jb = jbuild(shapes=(SI, so), **{**KW, **kw}) if (kw or so != SO) else jb0
    if so != SO:             # more target channels: another denoiser width
        params = _jax_params(so, seed=1)
    m = _port(params, so=so, **kw)
    assert m.is_ddim == (case != "ancestral") == jb.pipeline.is_ddim
    x = np.random.default_rng(5).normal(size=(B, *SI)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jb.pipeline.sample(_apply(jb), {"params": params}, jnp.asarray(x), key))
    draws = _sample_draws(m, jb.pipeline, key, B)
    with torch.inference_mode():
        got = m.sample(torch.from_numpy(x), draws=draws).numpy()
        ref = _port(params, so=so, dtype=torch.float64, **kw).sample(
            torch.from_numpy(x).double(), draws=draws).numpy()
    assert got.shape == want.shape == (B, *so)
    for side in (got, want):
        tt.close(side, ref, rtol=SAMPLE_TOL)
    # the generator's own draws: seeded, and the same after a reseed
    m.reseed_dropout(7)
    a = m.predict(torch.from_numpy(x))
    m.reseed_dropout(7)
    assert torch.equal(a, m.predict(torch.from_numpy(x)))


def test_rescaler_matches_jax_and_caches_cross_read(tmp_path):
    from realpdebench_tpu.data.fluid import Cylinder as JCylinder
    from realpdebench_tpu_torch.data.fluid import Cylinder
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = str(tmp_path)
    make_fluid_tree(root, "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    kw = dict(dataset_name="cylinder", dataset_root=root, dataset_type="numerical",
              mode="train", in_step=4, out_step=4, interval=4, trunk_length=8,
              n_sim_frame=32, n_sim_in_distribution=1, n_sim_out_distribution=1,
              sub_s_real=1, sub_s_numerical=1, mask_prob=0.0, noise_scale=0.0,
              generate_ids_if_missing=True)
    jds, tds = JCylinder(**kw), Cylinder(**kw)
    cache = tw.rescaler_cache(root, "cylinder", "bior1.3", "zero")
    args = ("bior1.3", "zero", root, "cylinder")
    want = jw.compute_wdno_rescaler(jds, *args, batch_size=4)       # JAX writes
    with np.load(cache) as f:
        raw = f["rescaler"]
    assert raw.shape == (8 * 6,) and want.dtype == np.float32
    np.testing.assert_array_equal(tw.compute_wdno_rescaler(None, *args), want)   # port reads
    os.remove(cache)
    got = tw.compute_wdno_rescaler(tds, *args, batch_size=4)       # port writes
    tt.close(got, want, rtol=1e-6)
    with np.load(cache) as f:
        tt.close(f["rescaler"], raw, rtol=1e-6)
    np.testing.assert_array_equal(jw.compute_wdno_rescaler(None, *args), got)    # JAX reads
    with pytest.raises(ValueError, match="numerical"):
        os.remove(cache)
        tw.compute_wdno_rescaler(Cylinder(**{**kw, "dataset_type": "real"}), *args)


def _clipped(g: dict, clip: float) -> dict:
    norm = np.sqrt(sum(float((v ** 2).sum()) for v in g.values()))
    return {k: v * min(1.0, clip / norm) for k, v in g.items()}


def test_train_step_trajectory_matches_jax(pair):
    m0, jb, params = pair
    cfg = dict(lr=LR, scheduler="cosine", num_update=4, clip_grad_norm=1.0)
    r = np.random.default_rng(20)
    xs = r.normal(size=(STEPS, B, *SI)).astype(np.float32)
    ys = r.normal(size=(STEPS, B, *SO)).astype(np.float32)
    stats = dict(mean_inputs=r.normal(size=2), mean_targets=r.normal(size=2),
                 std_inputs=r.uniform(0.5, 2.0, 2), std_targets=r.uniform(0.5, 2.0, 2))
    stats = {k: a.astype(np.float32) for k, a in stats.items()}

    fresh = lambda t: jax.tree_util.tree_map(jnp.array, t)   # the step donates
    state = jts.TrainState.create(fresh(params), {}, jts.build_optimizer(Config(**cfg)))
    jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats))
    jlosses, jbefore, mus = [], [], []
    for i in range(STEPS):
        jbefore.append(_np_tree(state.params))
        state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]), jax.random.PRNGKey(i))
        jlosses.append(float(jl))
        mus.append(_np_tree(tt.adam_mu(state.opt_state)))

    model = build_model(shapes=(SI, SO), device="cpu", **KW)
    assert model.remat                       # the registry's default, as JAX's
    init = {k: t.clone() for k, t in m0.state_dict().items()}
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    norm = tnorm.build_normalizer("gaussian", stats=stats)
    step = make_train_step(model, norm, opt)
    losses, before, g32, draws = [], [], [], []
    for i in range(STEPS):
        draws.append(_loss_draws(jb.pipeline, jax.random.PRNGKey(i), B))
        t, noise = draws[-1]
        model.loss = lambda x, y, t=t, noise=noise: tw.WDNO.loss(model, x, y, t=t, noise=noise)
        before.append({k: v.clone() for k, v in model.state_dict().items()})
        losses.append(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item())
        g32.append({n: p.grad.numpy().copy() for n, p in model.named_parameters()})
    tt.close(losses, jlosses)

    def grads64(weights, i):
        m64 = _port(params, dtype=torch.float64)
        m64.load_state_dict(weights, strict=True)
        xn, yn = norm.preprocess(torch.from_numpy(xs[i]).double(),
                                 torch.from_numpy(ys[i]).double())
        m64.loss(xn, yn, t=draws[i][0], noise=draws[i][1]).backward()
        return _clipped({n: p.grad.numpy() for n, p in m64.named_parameters()}, 1.0)

    convert = lambda t: wdno_state_dict(t, "sigmoid", KW["timesteps"])
    noisy = {}
    for i, (gj, slack) in enumerate(tt.adam_grads(mus, convert)):
        g64, j64 = grads64(before[i], i), grads64(convert(jbefore[i]), i)
        for n, mask in tt.step_noise(g32[i], gj, slack, g64, j64).items():
            noisy[n] = noisy.get(n, False) | mask
    want = {k: v.numpy() for k, v in convert(_np_tree(state.params)).items()}
    zero = lambda n: _zero_grad(n) and want[n].size == 8
    tt.check_final(model, init, want, noisy, zero, STEPS, LR)


def test_build_model_defaults():
    m = build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0),
                    model_name="wdno", dim=8)
    pipe = jbuild(shapes=(SI, SO), model_name="wdno", dim=8).pipeline
    assert (m.wave_type, m.num_timesteps, m.sampling_timesteps, m.ddim_eta, m.remat) == (
        "bior1.3", 1000, 1000, 0.0, True) and not m.is_ddim
    assert m.model_shape == pipe.model_shape and m.channels == pipe.channels
    assert torch.equal(m.rescaler, torch.ones(m.channels))
    b = build_model(shapes=(SI, SO), device="cpu", generator=make_generator(0),
                    model_name="wdno", dim=8)
    for k, v in m.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    half = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16", **KW)
    assert half.model.compute_dtype == torch.bfloat16
    assert half.predict(torch.zeros(1, *SI)).dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(shapes=(SI, SO), **KW)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = tmp_path_factory.mktemp("wdno_tree")
    make_fluid_tree(str(root), "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    return str(root)


def test_cli_train_then_eval_on_the_cpu(tree, tmp_path):
    from realpdebench_tpu_torch.cli import main
    from realpdebench_tpu_torch.eval.__main__ import main as eval_main

    common = ["--config", "cylinder/wdno.yaml", "--dataset_root", tree,
              "--device", "cpu", "--results_path", str(tmp_path), "--num_workers", "0",
              "--train_batch_size", "4", "--test_batch_size", "4", "--dim", "8",
              "--timesteps", "20", "--sampling_timesteps", "4", "--N_autoregressive", "1",
              "--N_plot", "0", "--N_plot_probe", "0", "--probe_diagnostic", "false",
              "--is_use_tb", "false", "--num_update", "2", "--in_step", "4",
              "--out_step", "4", "--interval", "4", "--trunk_length", "8",
              "--n_sim_frame", "32", "--n_sim_in_distribution", "1",
              "--n_sim_out_distribution", "1", "--sub_s_real", "1",
              "--sub_s_numerical", "1", "--generate_ids_if_missing"]
    with pytest.raises(SystemExit) as e:
        main(["train", *common])
    assert e.value.code == 0
    assert os.path.isfile(tw.rescaler_cache(tree, "cylinder", "bior1.1", "zero"))
    (ckpt,) = glob.glob(os.path.join(str(tmp_path), "wdno", "*_numerical_False", "*", "ckpt"))
    assert sorted(os.listdir(ckpt)) == ["checkpoint_1.pth", "checkpoint_2.pth"]
    _, results = eval_main([*common, "--checkpoint_path", ckpt])
    for k in ("rmse", "rel_l2_error", "normalized_mse"):
        assert np.isfinite(results[k]), k
