"""PyTorch port vs JAX package: WDNO at controlled_cylinder's own window (CPU,
f32).

controlled_cylinder's WDNO packs 5 input channels (u, v, p and the two
parameter planes) and 3 output channels of a T 10 window into 5
coefficient frames, which its U-Net pads to T 8: its temporal attention
runs at T 8, which the cylinder's T 12 never reaches. Here, at narrow
widths and a 16×16 window (dim 8, dim_mults 1/2: T 8 as in the shipped
1/2/4), with the weights of ``tests/test_torch_scenarios.py``'s ``_pair``
and the JAX sampler's draws injected (``tests/test_torch_wdno.py``):

* the denoiser's forward on the first sampling state against JAX's, and
  the DDPM loss with every parameter gradient (``t`` and the noise that
  ``WDNOPipeline.loss`` draws injected), at rtol 2e-4 with atol
  2e-4·max|ref|; a gradient tensor whose reference is a true zero held on
  both sides to 1e-5 of the largest gradient;
* the DDIM sample, and a 2-step rollout through ``make_rollout_fn`` with
  the parameter planes re-injected (``para_c`` 2), against the JAX
  package's host rollout (``make_host_rollout_fn``, its sampler jitted).
  The first DDIM step multiplies the denoiser's rounding by 241 before the
  clip, and a second rollout step conditions on the first's rounded
  prediction: so each step is held on the window JAX's rollout gave it,
  JAX's step and the port's sample of that window against the port's
  float64 replay on the same draws (``WDNO_SAMPLE``), and the port's own
  rollout step is its sample of its own window, bit for bit.

Torch runs on one intra-op thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_trajectory as tt
from test_torch_scenarios import ZERO_GRAD, _normalizers, _np, _pair
from test_torch_wdno import _loss_draws, _sample_draws

from realpdebench_tpu.eval.rollout import make_host_rollout_fn as jrollout
from realpdebench_tpu_torch.eval.rollout import make_rollout_fn
from realpdebench_tpu_torch.interop.from_jax import wdno_state_dict
from realpdebench_tpu_torch.models import wdno as tw

B, STEPS = 2, 2
SI, SO = (10, 16, 16, 5), (10, 16, 16, 3)
KW = dict(model_name="wdno", dim=8, dim_mults=[1, 2], wave_type="bior1.1", pad_mode="zero",
          beta_schedule="sigmoid", timesteps=20, sampling_timesteps=2,
          ddim_sampling_eta=1.0, normalizer="none")
# a sample (or a rollout step) in f32 against the float64 replay on the same
# draws: relative L2 and max|d|/max|ref|. The port's first denoiser forward
# sits 2.2e-6 (max|d|/max|ref|) from float64 at this window, JAX's 4.7e-7;
# over three draws the port's samples sit 3.3e-5-1.1e-4 (relative L2) and
# 1.2e-4-4.0e-4 (max) from the replay, JAX's 8.5e-6-4.3e-5 and
# 5.1e-5-1.5e-4: held to 5e-4 and 2e-3
WDNO_SAMPLE = (5e-4, 2e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample_close(got, ref, msg):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, msg
    rel_l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    rel_max = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel_l2 <= WDNO_SAMPLE[0] and rel_max <= WDNO_SAMPLE[1], (msg, rel_l2, rel_max)


class _Injected:
    """A WDNO predictor whose every sample takes ``draws``."""

    def __init__(self, model, draws):
        self.model, self.draws = model, draws

    def predict(self, window):
        with torch.inference_mode():
            return self.model.sample(window, draws=self.draws)


def _wdno64(m):
    ref = tw.WDNO(SI, SO, dim=KW["dim"], dim_mults=KW["dim_mults"],
                  wave_type=KW["wave_type"], beta_schedule=KW["beta_schedule"],
                  timesteps=KW["timesteps"], sampling_timesteps=KW["sampling_timesteps"],
                  ddim_eta=KW["ddim_sampling_eta"], compute_dtype=torch.float64).double()
    ref.load_state_dict(m.state_dict())
    return ref


def test_wdno_at_t8_matches_jax():
    m, jb, v = _pair(SI, SO, KW)
    pipe = jb.pipeline
    assert m.model_shape[0] == 8 and m.c_in == 5
    # the bundle's sampler, jitted (the same function; compiled once)
    predict_fn, module = jb.predict_fn, jb.module
    sample = jax.jit(lambda w, xx, r: predict_fn(module, w, xx, r))
    jb = dataclasses.replace(jb, predict_fn=lambda mod, w, xx, r: sample(w, xx, r))
    r = np.random.default_rng(11)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *SO)).astype(np.float32)
    y_roll = r.normal(size=(B, STEPS * SO[0], *SO[1:])).astype(np.float32)
    jn, tn = _normalizers(KW, SI, SO)
    key = jax.random.PRNGKey(3)
    draws = _sample_draws(m, pipe, key, B)
    ref64 = _wdno64(m)

    # the denoiser's forward, then the sample
    with torch.inference_mode():
        cond = m.to_coef_tensor(torch.from_numpy(x))[..., : 8 * m.c_in]
        state = m.set_conditions(draws[0], cond)
        apply = jax.jit(lambda w, s: jb.module.apply(w, s, train=False))
        tt.close(m.model(state).numpy(), apply(v, jnp.asarray(state.numpy())), msg="denoiser")
        got = m.sample(torch.from_numpy(x), draws=draws).numpy()
        ref = ref64.sample(torch.from_numpy(x).double(), draws=draws).numpy()
    for side, who in ((got, "port"), (np.asarray(jb.predict(v, jnp.asarray(x), rng=key)),
                                      "JAX")):
        _sample_close(side, ref, f"{who} sample")

    # the loss and every gradient, the JAX draws injected
    jl, jg = jax.jit(jax.value_and_grad(lambda p: pipe.loss(
        apply, {"params": p}, jnp.asarray(x), jnp.asarray(y), key)))(v["params"])
    t, noise = _loss_draws(pipe, key, B)
    m.zero_grad()
    tl = m.loss(torch.from_numpy(x), torch.from_numpy(y), t=t, noise=noise)
    tl.backward()
    tt.close(tl.item(), float(jl))
    want = {k[len("model."):]: _np(w) for k, w in
            wdno_state_dict(jax.tree_util.tree_map(np.asarray, jg)).items()
            if k.startswith("model.")}
    scale = max(np.abs(g).max() for g in want.values())
    for name, p in m.model.named_parameters():
        g, wg = _np(p.grad), want[name]
        if np.abs(wg).max() <= ZERO_GRAD * scale:
            assert np.abs(g).max() <= ZERO_GRAD * scale, name
            continue
        tt.close(g, wg, msg=name)

    # the rollout: the JAX host rollout takes the same key at every step, so
    # every step's sample takes the same draws
    jpred = np.asarray(jrollout(jb, jn, STEPS, SI[-1] - SO[-1])(
        v, jnp.asarray(x), jnp.asarray(y_roll), key)[0])
    tpred = make_rollout_fn(_Injected(m, draws), tn, STEPS, SI[-1] - SO[-1])(
        torch.from_numpy(x), torch.from_numpy(y_roll))[0].numpy()
    assert tpred.shape == jpred.shape == (B, STEPS * SO[0], *SO[1:])
    planes, T = x[..., SO[-1]:], SO[0]
    with torch.inference_mode():
        for i in range(STEPS):
            step = slice(i * T, (i + 1) * T)

            def window(pred):
                return torch.from_numpy(x if i == 0 else np.concatenate(
                    [pred[:, step.start - T:step.start], planes], -1))

            np.testing.assert_array_equal(tpred[:, step],
                                          m.sample(window(tpred), draws=draws).numpy())
            ref = ref64.sample(window(jpred).double(), draws=draws).numpy()
            _sample_close(m.sample(window(jpred), draws=draws).numpy(), ref, f"port step {i}")
            _sample_close(jpred[:, step], ref, f"JAX step {i}")
