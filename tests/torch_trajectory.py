"""Shared by the port's 3-step training-trajectory tests against the JAX
step (DeepONet, CNO, MWT): which entries of each gradient are float noise, and the
comparison of the final weights that exempts them.

Adam turns an entry whose gradient is float noise into steps of up to lr in
a direction the noise decides, in either framework. An entry is noise
where, at any step, either framework's float32 gradient is off by more than
10% of a float64 replay of that step from that framework's own weights
before it (which entries fall below the noise, and at which step, depends
on each side's reduction order: on the CPU, on the thread count; a
pre-activation within rounding of a ReLU's kink moves a whole gradient), or
where the two frameworks' weights before the step, apart where earlier
steps were noise, give float64 gradients more than 10% apart. The JAX
step's gradients are recovered from its Adam first moments,
m_i = 0.9·m_(i−1) + 0.1·g_i, with the bound of that recovery's rounding.
Such entries, where they miss rtol 2e-4 (at most 1% of a tensor, or one
entry of a tensor under 100), and the entries whose true gradient is 0,
are held to Adam's bound of n·lr; every other entry to rtol 2e-4.
A complex tensor is compared as its real and imaginary planes (``real``),
which Adam moves each by up to lr a step.
"""

import jax
import numpy as np
import torch


def real(a) -> np.ndarray:
    """A complex array as its [..., 2] real and imaginary planes."""
    a = np.asarray(a)
    return np.stack([a.real, a.imag], -1) if np.iscomplexobj(a) else a


def close(got, ref, rtol=2e-4, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()), err_msg=msg)


def adam_mu(opt_state):
    """The first moment of a JAX step's Adam state."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu
    for s in opt_state if isinstance(opt_state, tuple) else ():
        mu = adam_mu(s)
        if mu is not None:
            return mu
    return None


def adam_grads(mus, convert):
    """[(gradient, slack)] of each JAX step, ``convert``ed to the port's
    names: g_i in float64 from the float32 moments, and the bound of that
    recovery's rounding."""
    out, prev = [], None
    for mu in mus:
        a = jax.tree_util.tree_map(np.float64, mu)
        b = jax.tree_util.tree_map(np.zeros_like, a) if prev is None else \
            jax.tree_util.tree_map(np.float64, prev)
        g = jax.tree_util.tree_map(lambda u, v: (u - 0.9 * v) / 0.1, a, b)
        slack = jax.tree_util.tree_map(
            lambda u, v: 2.0 ** -23 * (np.abs(u) + 0.9 * np.abs(v)) / 0.1, a, b)
        out.append(tuple({k: real(t) for k, t in convert(t).items()} for t in (g, slack)))
        prev = mu
    return out


def grads64(model, weights, xn, yn):
    """Every parameter's gradient of one train-mode loss in float64:
    ``model`` (a fresh port model) loaded with ``weights``."""
    model.load_state_dict(weights, strict=True)
    model.double().train()
    model.compute_dtype = torch.float64
    model(xn.double(), y=yn.double()).backward()
    return {n: real(p.grad.detach().numpy()) for n, p in model.named_parameters()}


def float_noise(g, g64, slack=None):
    """{parameter: entries of ``g`` off by more than 10% of ``g64`` (plus
    ``slack``)}."""
    return {n: np.abs(g[n] - ref) > 0.1 * np.abs(ref) + (0.0 if slack is None else slack[n])
            for n, ref in g64.items()}


def step_noise(g32, gj, slack, g64, j64):
    """{parameter: entries that are noise at one step}: the port's float32
    gradient ``g32`` against ``g64`` (the float64 replay from the port's
    weights), the JAX gradient ``gj`` (recovered with ``slack``) against
    ``j64`` (from JAX's weights), and ``j64`` against ``g64``."""
    masks = (float_noise(g32, g64), float_noise(gj, j64, slack), float_noise(j64, g64))
    return {n: masks[0][n] | masks[1][n] | masks[2][n] for n in g64}


def check_final(model, init, want, noisy, zero_grad, steps, lr, floor=1.0):
    """The port's weights and statistics after ``steps`` steps against the
    JAX step's ``want`` at rtol 2e-4, but for the entries with a true
    gradient of 0 (``zero_grad(name)``: a bool, or an entry mask of the
    tensor's ``real`` form) and the entries of ``noisy`` that miss rtol
    2e-4 (at most 1% of a tensor, or ``floor`` entries where that is more:
    one of a BatchNorm's 8 scales at the default), which are held within
    1.01·steps·lr of where they started on both sides; running means,
    which take in the conv biases, within 2·steps·lr more."""
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = real(t.detach().numpy()), real(want[name])
        if name.endswith("running_mean"):
            np.testing.assert_allclose(got, ref, rtol=2e-4,
                                       atol=2e-4 * np.abs(ref).max() + 2 * steps * lr,
                                       err_msg=name)
            continue
        if name in noisy:                         # a parameter
            zero = np.broadcast_to(zero_grad(name), got.shape)
            missed = ~np.isclose(got, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max())
            excused = noisy[name] & missed & ~zero
            assert excused.sum() <= max(floor, 1e-2 * got.size), (name, excused.sum())
            mask = excused | zero
            p0 = real(init[name].numpy())
            for moved in (got - p0, ref - p0):
                assert np.abs(moved[mask]).max(initial=0) <= 1.01 * steps * lr, name
            got = np.where(mask, ref, got)
        close(got, ref, msg=name)
