"""PyTorch port vs JAX package: the cylinder Galerkin Transformer (CPU, f32).

1. The scores: the twin ``galerkin_scores_plain`` against JAX
   ``galerkin_scores(..., force_ref=True)`` and, head by head, against the
   Pallas kernel ``_scores_pallas`` in interpret mode; the gradients of the
   twin and of the autograd function (its kernel replaced by the twin, so
   that its backward runs on the CPU) against ``jax.grad`` through the
   ``custom_vjp``. The kernel's tensor-core variant runs only on the card
   (tests/test_torch_kernels.py); here its arithmetic (the f32 LayerNorm,
   the bf16 hi + lo split of the normalised rows, the three products per
   16-token step, the f32 accumulators flushed every 32 tiles, the
   per-chunk partials) is replayed against the twin, within the card's
   bound, and against the Pallas kernel in interpret mode.
2. The decoder's spectral convolution: ``truncated_spectral_conv3d_dft_lowp``
   and the dispatcher's three forms, outputs and gradients, against JAX's.
3. Units: GalerkinAttention, GKTEncoderLayer (LayerNorms off and on) and
   SpectralRegressor against their flax counterparts with the same weights,
   in eval and in train mode: outputs, input and weight gradients, and the
   BatchNorm's running statistics.
4. The whole model at shape (4, 8, 8, 3): the forward, the train-mode
   loss's parameter gradients, and ``load_state_dict(strict=True)`` of the
   JAX package's ``export_torch_state_dict``, equal key for key to the
   port's ``from_jax.galerkin_state_dict``.
5. A 3-step trajectory of the port's ``make_train_step`` against the JAX
   step (Adam, cosine schedule, Gaussian normalizer inside the step).

Dropout: the two frameworks' random streams cannot match, so both take
the same seeded numpy masks in call order: the JAX side through
``flax.linen.intercept_methods`` on ``nn.Dropout.__call__``, the port
through its one mask function ``models/base.dropout_mask``. The JAX weights come from
the port's seeded weights, perturbed by seeded numpy noise, converted with
the JAX package's ``convert_galerkin``. Tolerance: rtol 2e-4 with atol
2e-4·max|ref|. Where the true gradient is 0 (the pointwise conv biases,
which the BatchNorm after them cancels, and the imaginary part of the DC
spectral weight, which the inverse rfft drops), both sides' gradients are
held to 1e-5 of their tensor's largest, and in the trajectory such entries,
and entries whose first gradient lies below float noise, to Adam's bound of
n·lr, as ``tests/test_torch_train.py`` sets out.
"""

from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tnf

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_convert import convert_galerkin
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models import galerkin_transformer as jg
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.ops import spectral as jsp
from realpdebench_tpu.ops.pallas import galerkin as jpg
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import galerkin_state_dict
from realpdebench_tpu_torch.models import base as tbase
from realpdebench_tpu_torch.models import galerkin_transformer as tg
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.ops import galerkin as tga
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops import spectral as tsp
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

SI = SO = (4, 8, 8, 3)
KW = dict(model_name="galerkin_transformer", n_hidden=32, num_encoder_layers=2,
          n_head=2, dim_feedforward=24, layer_norm=False, norm_eps=1e-7,
          fourier_modes_x=3, fourier_modes_y=3, fourier_modes_t=2,
          num_regressor_layers=2, freq_dim=16, encoder_dropout=0.05,
          xavier_init=1e-2, diagonal_weight=1e-2)
B, STEPS, LR = 2, 3, 1e-3


def _close(got, ref, rtol=2e-4, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()), err_msg=msg)


def _np(t):
    return t.detach().cpu().numpy()


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


class Masks:
    """The same seeded keep masks, in call order, for flax's nn.Dropout and
    for the port's ``dropout_mask``: mask j is drawn the first time either
    side asks for it, with that call's shape and rate."""

    def __init__(self, seed):
        self.rng, self.masks, self.n_jax, self.n_torch = (
            np.random.default_rng(seed), [], 0, 0)

    def _get(self, j, shape, rate):
        if j == len(self.masks):
            self.masks.append(self.rng.random(shape) >= rate)
        assert self.masks[j].shape == tuple(shape), (j, self.masks[j].shape, shape)
        return self.masks[j]

    def interceptor(self, next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        det = kwargs.get("deterministic", mod.deterministic)
        if det or mod.rate == 0.0:
            return next_fun(*args, **kwargs)
        x = args[0]
        keep = jnp.asarray(self._get(self.n_jax, x.shape, mod.rate))
        self.n_jax += 1
        return jax.lax.select(keep, x / (1.0 - mod.rate), jnp.zeros_like(x))

    def torch_mask(self, shape, p, generator):
        m = self._get(self.n_torch, shape, p)
        self.n_torch += 1
        return torch.from_numpy(m)

    def __enter__(self):
        self._ctx = fnn.intercept_methods(self.interceptor)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def _perturb(module, seed):
    """Seeded noise on every parameter and BatchNorm statistic: no zero bias,
    no unit scale, no initial running statistics."""
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            noise = torch.from_numpy(
                0.1 * r.normal(size=(*p.shape, 2)).astype(np.float32))
            p.add_(torch.view_as_complex(noise) if p.is_complex() else noise[..., 0])
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.from_numpy(0.1 * r.normal(size=b.shape)))
            elif name.endswith("running_var"):
                b.copy_(torch.from_numpy(r.uniform(0.5, 2.0, size=b.shape)))
    return module


def _port_model(seed=0, **kw):
    kw = {**KW, **kw}
    return _perturb(build_model(shapes=(SI, SO), device="cpu",
                                generator=make_generator(seed), **kw), seed + 100)


def _jax_variables(model):
    sd = {k: _np(v).copy() for k, v in model.state_dict().items()}  # no aliasing
    params, state = convert_galerkin(sd, None, {})
    return jax.tree_util.tree_map(jnp.asarray, {"params": params, **state})


def _zero_grad(name):
    return name.startswith("regressor.convs.") and name.endswith(".bias")


def _real(a):
    a = np.asarray(a)
    return np.stack([a.real, a.imag], -1) if np.iscomplexobj(a) else a


def _zero_grad_mask(name, shape, train=True):
    """Entries whose true gradient is 0, on the real view of the parameter
    (the BatchNorm cancels the conv biases only with batch statistics)."""
    mask = np.full(shape, train and _zero_grad(name))
    if name.startswith("regressor.spectral_conv.") and name.endswith(".weights1"):
        mask[:, :, 0, 0, 0, 1] = True      # imag of the (0, 0, 0) mode
    return mask


def _compare_grads(grads, want, train=True, msg=""):
    """Port gradients {name: tensor} against the JAX ones in port names."""
    for name, g in grads.items():
        got, ref = _real(_np(g)), _real(want[name].numpy())
        zero = _zero_grad_mask(name, got.shape, train)
        if zero.any():    # a conv bias: against its conv weight's largest
            scale = np.abs(_np(grads[name[:-4] + "weight"] if _zero_grad(name) else g)).max()
            for side in (got, ref):
                assert np.abs(side[zero]).max() <= 1e-5 * scale, (msg, name)
            got, ref = got[~zero], ref[~zero]
            if not got.size:
                continue
        _close(got, ref, msg=f"{msg}{name}")


# --------------------------------------------------------------------------
# 1. the scores
# --------------------------------------------------------------------------


def _score_inputs(seed, B_, h, n, d):
    r = np.random.default_rng(seed)
    k = r.normal(1.0, 2.0, size=(B_, h, n, d)).astype(np.float32)
    v = r.normal(-0.5, 1.5, size=(B_, h, n, d)).astype(np.float32)
    aff = [(1 + 0.1 * r.normal(size=(h, d))).astype(np.float32),
           (0.1 * r.normal(size=(h, d))).astype(np.float32),
           (1 + 0.1 * r.normal(size=(h, d))).astype(np.float32),
           (0.1 * r.normal(size=(h, d))).astype(np.float32)]
    return k, v, aff


def _tokens(a):
    """[B, h, N, d] → the Dense's token layout [B, N, h·d]."""
    B_, h, n, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(B_, n, h * d))


@pytest.mark.parametrize("shape,eps", [((2, 3, 300, 16), 1e-7), ((1, 4, 37, 32), 1e-5)])
def test_scores_twin_matches_jax_reference(shape, eps):
    k, v, aff = _score_inputs(1, *shape)
    want = jpg.galerkin_scores(jnp.asarray(k), jnp.asarray(v), *map(jnp.asarray, aff),
                               eps, True)
    got = tga.galerkin_scores(_tokens(k), _tokens(v), *map(torch.from_numpy, aff),
                              shape[1], eps)
    assert got.dtype == torch.float32 and got.shape == (shape[0], shape[1], shape[3], shape[3])
    _close(_np(got), want)


def test_scores_twin_matches_pallas_interpret_per_head():
    k, v, aff = _score_inputs(2, 1, 2, 256, 32)
    got = _np(tga.galerkin_scores_plain(_tokens(k), _tokens(v), *map(torch.from_numpy, aff),
                                        2, 1e-7))
    for hh in range(2):
        want = jpg._scores_pallas(jnp.asarray(k[0, hh]), jnp.asarray(v[0, hh]),
                                  *(jnp.asarray(a[hh]) for a in aff), 1e-7, tile=64,
                                  interpret=True)
        _close(got[0, hh], want, msg=f"head {hh}")


# csrc/galerkin_scores.cu, the mma variant: tokens a tile, tiles an MMA
# accumulator takes before the f32 sums
GK_MMA_TILE, GK_MMA_FLUSH = 32, 32


def _replay_gk_scores_mma(k, v, k_scale, k_bias, v_scale, v_bias, heads, eps, nparts, *,
                          rounding=True):
    """The scores' tensor-core variant in plain PyTorch: the LayerNorm of
    each (token, head) in f32 (mean, centred rows, population variance, eps
    inside the square root, the f32 affine); N cut into ``nparts`` chunks of
    whole 32-token tiles (the last tile of a chunk padded with zero rows);
    per 16-token k-step the three products hi·hi + hi·lo + lo·hi of the
    rows' bf16 hi + lo pairs, in f64, added into an f32 accumulator, which
    goes into the f32 sums every 32 tiles and at the chunk's end; the
    chunks' sums added in f64 and scaled by 1/N. ``rounding=False``: the
    products of the f32 rows, in f64, no f32 sums."""
    B, N, F = k.shape
    d = F // heads

    def ln(x, scale, bias):
        x = x.float().reshape(B, N, heads, d)
        c = x - x.mean(-1, keepdim=True)
        inv = 1.0 / torch.sqrt((c * c).mean(-1, keepdim=True) + eps)
        return (c * inv) * scale.float() + bias.float()

    kn, vn = ln(k, k_scale, k_bias), ln(v, v_scale, v_bias)
    tiles = -(-N // GK_MMA_TILE)
    chunk = -(-tiles // nparts) * GK_MMA_TILE
    parts = []
    for n0 in range(0, N, chunk):
        kc, vc = kn[:, n0:n0 + chunk], vn[:, n0:n0 + chunk]
        pad = -kc.shape[1] % GK_MMA_TILE
        kc, vc = (tnf.pad(t, (0, 0, 0, 0, 0, pad)) for t in (kc, vc))
        steps = kc.shape[1] // 16
        kc, vc = (t.reshape(B, steps, 16, heads, d) for t in (kc, vc))
        if not rounding:
            parts.append(torch.einsum("bsthi,bsthj->bhij", kc.double(), vc.double()))
            continue
        (kh, kl), (vh, vl) = (tuple(u.double() for u in kernels.split_bf16(t)) for t in (kc, vc))
        prod = lambda a, b: torch.einsum("bsthi,bsthj->bshij", a, b)
        step_sums = prod(kh, vh) + prod(kh, vl) + prod(kl, vh)
        acc = torch.zeros(B, heads, d, d)
        total = torch.zeros(B, heads, d, d)
        for s in range(steps):
            acc = (acc.double() + step_sums[:, s]).float()
            tile = s // 2
            if s % 2 == 1 and ((tile + 1) % GK_MMA_FLUSH == 0 or s == steps - 1):
                total, acc = total + acc, torch.zeros_like(acc)
        parts.append(total.double())
    return (torch.stack(parts).sum(0) / N).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, nparts", [
    ((2, 300, 3, 16), 3),     # N no multiple of the tile, three chunks
    ((1, 1037, 2, 32), 1),    # one chunk of 33 tiles: a flush, then the last tile
    ((1, 2500, 2, 64), 2),    # two chunks of 40 and 39 tiles, flushed at 32
])
def test_gk_scores_mma_replay_matches_twin(shape, nparts, dtype):
    """The replay against the twin from the same inputs: within 1e-4 of
    max|ref| (GK_SCORES_TOL, the card's bound, in both dtypes: the rows are
    f32 and hi + lo carries them to 2^-17); unrounded, within 2e-4 of the
    twin."""
    B_, h, n, d = shape[0], shape[2], shape[1], shape[3]
    k, v, aff = _score_inputs(5, B_, h, n, d)
    kt, vt = _tokens(k).to(dtype), _tokens(v).to(dtype)
    aff = [torch.from_numpy(a) for a in aff]
    ref = tga.galerkin_scores_plain(kt, vt, *aff, h, 1e-7)
    got = _replay_gk_scores_mma(kt, vt, *aff, h, 1e-7, nparts)
    assert got.shape == ref.shape == (B_, h, d, d)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    exact = _replay_gk_scores_mma(kt, vt, *aff, h, 1e-7, nparts, rounding=False)
    _close(_np(exact), _np(ref))


def test_gk_scores_mma_replay_matches_pallas_scores():
    """The replay, rounded as the kernel rounds, against the JAX Pallas
    scores kernel in interpret mode (f32), head by head, N no multiple of
    the tile (the Pallas kernel's tile of 37 divides it)."""
    h, n, d = 2, 37 * 9, 32
    k, v, aff = _score_inputs(6, 1, h, n, d)
    got = _np(_replay_gk_scores_mma(_tokens(k), _tokens(v), *map(torch.from_numpy, aff), h,
                                    1e-7, 2))
    for hh in range(h):
        want = jpg._scores_pallas(jnp.asarray(k[0, hh]), jnp.asarray(v[0, hh]),
                                  *(jnp.asarray(a[hh]) for a in aff), 1e-7, tile=37,
                                  interpret=True)
        _close(got[0, hh], want, msg=f"head {hh}")


@pytest.mark.parametrize("route", ["twin", "autograd_function"])
def test_scores_gradients_match_jax(monkeypatch, route):
    h, d = 2, 16
    k, v, aff = _score_inputs(3, 2, h, 96, d)
    g = np.random.default_rng(4).normal(size=(2, h, d, d)).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jpg.galerkin_scores(*a, 1e-7) * g),
                      argnums=tuple(range(6)))(jnp.asarray(k), jnp.asarray(v),
                                               *map(jnp.asarray, aff))
    leaves = [_tokens(k), _tokens(v), *map(torch.from_numpy, aff)]
    leaves = [t.clone().requires_grad_() for t in leaves]
    if route == "twin":
        out = tga.galerkin_scores(*leaves, h, 1e-7)
    else:   # the kernel's autograd function, the twin in the kernel's place
        monkeypatch.setattr(kernels, "gk_scores", lambda k_, v_, *a, heads, eps:
                            tga.galerkin_scores_plain(k_, v_, *a, heads, eps))
        out = tga._GalerkinScores.apply(*leaves, h, 1e-7)
    (out * torch.from_numpy(g)).sum().backward()
    split = lambda t: _np(t).reshape(2, 96, h, d).transpose(0, 2, 1, 3)
    _close(split(leaves[0].grad), jgrads[0], msg="dk")
    _close(split(leaves[1].grad), jgrads[1], msg="dv")
    for name, t, want in zip(("dks", "dkb", "dvs", "dvb"), leaves[2:], jgrads[2:]):
        _close(_np(t.grad), want, msg=name)


def test_scores_refuse_bad_shapes_and_build_nothing_on_cpu():
    k = torch.zeros(1, 5, 12)
    with pytest.raises(ValueError, match="heads"):
        tga.galerkin_scores(k, k, *[torch.ones(5, 2)] * 4, 5)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.gk_scores(k, k, *[torch.ones(3, 4)] * 4, heads=3, eps=1e-5)
    kernels.reset_launches()
    tga.galerkin_scores(k, k, *[torch.ones(3, 4)] * 4, 3)
    assert kernels.LAUNCHES["gk_scores"] == 0


# --------------------------------------------------------------------------
# 2. the decoder's spectral convolution
# --------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["lowp", "dft", "fft", "dft_c64"])
def test_spectral_conv_forms_match_jax(form):
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 6, 10, 12, 5)).astype(np.float32)
    wr, wi = (0.1 * r.normal(size=(4, 2, 3, 4, 5, 7)).astype(np.float32) for _ in range(2))
    ct = r.normal(size=(2, 6, 10, 12, 7)).astype(np.float32)
    if form == "lowp":
        jf = lambda a, b, c: jsp.truncated_spectral_conv3d_dft_lowp(
            a, b, c, compute_dtype=jnp.float32)
        tf = lambda a, b, c: tsp.truncated_spectral_conv3d_dft_lowp(
            a, b, c, compute_dtype=torch.float32)
    else:
        jf = lambda a, b, c: jsp.truncated_spectral_conv3d(a, b, c, impl=form)
        tf = lambda a, b, c: tsp.truncated_spectral_conv3d(a, b, c, impl=form)
    out, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(wr), jnp.asarray(wi))
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, wr, wi)]
    got = tf(*leaves)
    got.backward(torch.from_numpy(ct))
    _close(_np(got), out, msg="out")
    for name, t, w in zip(("dx", "dwr", "dwi"), leaves, want):
        _close(_np(t.grad), w, msg=name)


# --------------------------------------------------------------------------
# 3. units
# --------------------------------------------------------------------------


def _vjp_unit(jfn, jparams, tmodule, tfn, x, seed, masks_seed):
    """Output, input gradient and weight gradients of one cotangent through
    the flax apply ``jfn(params, x)`` and the port's ``tfn(x)``, with the
    same dropout masks; the JAX weight gradients come back as a tree."""
    masks = Masks(masks_seed)
    with masks:
        out, vjp = jax.vjp(jfn, jparams, jnp.asarray(x))
    ct = np.random.default_rng(seed).normal(size=out.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    tmodule.zero_grad()
    with mock.patch.object(tbase, "dropout_mask", masks.torch_mask):
        o = tfn(xt)
    o.backward(torch.from_numpy(ct))
    assert masks.n_torch == masks.n_jax
    _close(_np(o), out, msg="out")
    _close(_np(xt.grad), gx, msg="dx")
    return gp, masks.n_jax


def _unit_grads_want(variables, sub, gsub):
    """The JAX gradient subtree ``gsub`` at ``sub`` (a path into params) in
    the port's names, through galerkin_state_dict on a zero tree."""
    zeros = jax.tree_util.tree_map(np.zeros_like, _np_tree(variables["params"]))
    node = zeros
    for key in sub[:-1]:
        node = node[key]
    node[sub[-1]] = _np_tree(gsub)
    return galerkin_state_dict(zeros, _np_tree(variables["batch_stats"]))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_galerkin_attention_matches_jax(train):
    m = _port_model()
    unit = m.encoder_layers[0].attn.train(train)
    v = _jax_variables(m)
    jm = jg.GalerkinAttention(32, 2, norm_eps=1e-7)
    x = np.random.default_rng(6).normal(size=(B, 40, 32)).astype(np.float32)
    gp, n = _vjp_unit(lambda p, xx: jm.apply({"params": p}, xx, train=train),
                      v["params"]["encoder_0"]["attn"], unit,
                      lambda xx: unit(xx, generator=None), x, 7, 8)
    assert n == (1 if train else 0)
    want = _unit_grads_want(v, ("encoder_0", "attn"), gp)
    _compare_grads({f"encoder_layers.0.attn.{k}": p.grad for k, p in unit.named_parameters()},
                   want)


@pytest.mark.parametrize("layer_norm", [False, True], ids=["plain", "layer_norm"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_layer_matches_jax(train, layer_norm):
    m = _port_model(layer_norm=layer_norm)
    unit = m.encoder_layers[1].train(train)
    v = _jax_variables(m)
    jm = jg.GKTEncoderLayer(32, 2, 24, layer_norm=layer_norm, norm_eps=1e-7)
    x = np.random.default_rng(9).normal(size=(B, 40, 32)).astype(np.float32)
    gp, n = _vjp_unit(lambda p, xx: jm.apply({"params": p}, xx, train=train),
                      v["params"]["encoder_1"], unit, lambda xx: unit(xx), x, 10, 11)
    assert n == (4 if train else 0)
    want = _unit_grads_want(v, ("encoder_1",), gp)
    _compare_grads({f"encoder_layers.1.{k}": p.grad for k, p in unit.named_parameters()},
                   want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_spectral_regressor_matches_jax(train):
    m = _port_model()
    unit = m.regressor.train(train)
    v = _jax_variables(m)
    jm = jg.SpectralRegressor(32, 16, 3, modes_x=3, modes_y=3, modes_t=2, num_layers=2)
    grid = jnp.concatenate(jsp.grid_features(SI[:3]), axis=-1)
    x = np.random.default_rng(12).normal(size=(B, *SI[:3], 32)).astype(np.float32)
    jvars = {"batch_stats": v["batch_stats"]["regressor"]}
    if train:
        jfn = lambda p, xx: jm.apply({"params": p, **jvars}, xx,
                                     jnp.broadcast_to(grid, (B, *grid.shape)),
                                     train=True, mutable=["batch_stats"])[0]
    else:
        jfn = lambda p, xx: jm.apply({"params": p, **jvars}, xx,
                                     jnp.broadcast_to(grid, (B, *grid.shape)))
    tgrid = torch.cat(tsp.grid_features(SI[:3]), dim=-1)
    gp, _ = _vjp_unit(jfn, v["params"]["regressor"], unit, lambda xx: unit(xx, tgrid),
                      x, 13, 14)
    want = _unit_grads_want(v, ("regressor",), gp)
    _compare_grads({f"regressor.{k}": p.grad for k, p in unit.named_parameters()}, want,
                   train)
    if train:
        _, new = jm.apply({"params": v["params"]["regressor"], **jvars}, jnp.asarray(x),
                          jnp.broadcast_to(grid, (B, *grid.shape)), train=True,
                          mutable=["batch_stats"])
        for i in range(2):
            for name, key in (("running_mean", "mean"), ("running_var", "var")):
                _close(_np(getattr(unit.bns[i], name)),
                       new["batch_stats"][f"bn_{i}"][key], msg=f"bn_{i} {name}")


def test_dropout_is_flax_semantics_and_seeded():
    g = torch.Generator().manual_seed(3)
    x = torch.ones(200, 100)
    state = torch.get_rng_state()
    y = tg.dropout(x, 0.25, g)
    assert torch.equal(torch.get_rng_state(), state)     # never the global RNG
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(1 / 0.75))
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.equal(tg.dropout(x, 0.0, g), x)
    assert torch.equal(tg.dropout(x, 1.0, g), torch.zeros_like(x))
    m = _port_model().train()
    xin = torch.from_numpy(np.random.default_rng(15).normal(size=(B, *SI)).astype(np.float32))
    a = m(xin)
    b = m(xin)
    m.reseed_dropout(0)
    c = m(xin)
    assert not torch.equal(a, b) and torch.equal(a, c)
    # eval: deterministic, unless reference_eval_dropout keeps the score dropout
    m.eval()
    assert torch.equal(m.predict(xin), m.predict(xin))
    r = _port_model(reference_eval_dropout=True)
    assert not torch.equal(r.predict(xin), r.predict(xin))


# --------------------------------------------------------------------------
# 4. the whole model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX bundle, JAX variables) with the same weights."""
    m = _port_model()
    return m, jbuild(shapes=(SI, SO), **KW), _jax_variables(m)


def test_export_loads_strict_and_equals_from_jax(pair):
    m, jb, v = pair
    exported = export_torch_state_dict(jb, v["params"], {"batch_stats": v["batch_stats"]})
    mine = galerkin_state_dict(_np_tree(v["params"]), _np_tree(v["batch_stats"]))
    assert set(exported) == set(mine) == set(m.state_dict())
    for k, t in mine.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), t.numpy(), err_msg=k)
    fresh = build_model(shapes=(SI, SO), device="cpu", **KW)
    fresh.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in exported.items()},
                          strict=True)
    for k, t in fresh.state_dict().items():
        np.testing.assert_array_equal(_np(t), _np(m.state_dict()[k]), err_msg=k)


def test_forward_and_train_loss_gradients_match_jax(pair):
    m, jb, v = pair
    r = np.random.default_rng(16)
    x = r.normal(size=(B, *SI)).astype(np.float32)
    y = r.normal(size=(B, *SO)).astype(np.float32)
    _close(_np(m.predict(torch.from_numpy(x))), jb.module.apply(v, jnp.asarray(x)))

    def loss(p):
        pred, new = jb.module.apply({"params": p, "batch_stats": v["batch_stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.mean((pred - y) ** 2), new

    masks = Masks(17)
    with masks:
        (jl, new), jgrad = jax.value_and_grad(loss, has_aux=True)(v["params"])
    m.train()
    m.zero_grad()
    init = {k: t.clone() for k, t in m.state_dict().items()}
    with mock.patch.object(tbase, "dropout_mask", masks.torch_mask):
        tl = m(torch.from_numpy(x), y=torch.from_numpy(y))
    tl.backward()
    assert masks.n_torch == masks.n_jax == 8
    _close(tl.item(), float(jl))
    want = galerkin_state_dict(_np_tree(jgrad), _np_tree(new["batch_stats"]))
    _compare_grads(dict((n, p.grad) for n, p in m.named_parameters()), want)
    for name, buf in m.named_buffers():
        if "running" in name:
            _close(_np(buf), want[name].numpy(), msg=name)
    m.load_state_dict(init)
    m.eval()


def test_time_upsampling_matches_jax():
    si, so = (2, 8, 8, 3), (4, 8, 8, 2)
    kw = dict(KW, num_encoder_layers=1)
    m = _perturb(build_model(shapes=(si, so), device="cpu",
                             generator=make_generator(3), **kw), 18)
    jb = jbuild(shapes=(si, so), **kw)
    x = np.random.default_rng(19).normal(size=(1, *si)).astype(np.float32)
    got = _np(m.predict(torch.from_numpy(x)))
    assert got.shape == (1, *so)
    _close(got, jb.module.apply(_jax_variables(m), jnp.asarray(x)))


def test_init_is_seeded_and_follows_jax_shapes():
    jb = jbuild(shapes=(SI, SO), **KW)
    shapes = jax.eval_shape(jb.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *SI), jnp.float32))
    zeros = lambda t: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), t)
    want = galerkin_state_dict(zeros(shapes["params"]), zeros(shapes["batch_stats"]))
    mk = lambda s: build_model(shapes=(SI, SO), device="cpu",
                               generator=make_generator(s), **KW).state_dict()
    a, b, c = mk(0), mk(0), mk(1)
    assert {k: tuple(t.shape) for k, t in a.items()} == {
        k: tuple(t.shape) for k, t in want.items()}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["downscaler.id.weight"], c["downscaler.id.weight"])
    q = a["encoder_layers.0.attn.linears.0.weight"]
    bound = 1e-2 * (6 / 64) ** 0.5                       # xavier-uniform · gain
    off = q - 1e-2 * torch.eye(32)
    assert off.abs().max() <= bound + 1e-7 and off.abs().max() > 0.5 * bound
    assert torch.equal(a["encoder_layers.0.attn.norm_K.1.weight"], torch.ones(16))
    assert torch.equal(a["regressor.bns.0.running_var"], torch.ones(16))
    w = a["regressor.fc.weight"]                          # lecun normal, fan-in 35
    assert w.abs().max() <= 2 * (1 / 35) ** 0.5 / 0.8796 + 1e-7


def test_build_model_takes_jax_registry_kwargs_and_defaults_to_the_card():
    m = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16",
                    seq_mesh=None, seed=5, **KW)
    assert isinstance(m, tg.GalerkinTransformer3d) and m.compute_dtype == torch.bfloat16
    assert m.dropout_seed == 5
    out = m.predict(torch.zeros(1, *SI))
    assert out.dtype == torch.float32 and out.shape == (1, *SO)
    with pytest.raises(ValueError, match="galerkin"):
        build_model(shapes=(SI, SO), device="cpu", **dict(KW, attention_type="linear"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(shapes=(SI, SO), **KW)


# --------------------------------------------------------------------------
# 5. training trajectory
# --------------------------------------------------------------------------


def test_train_step_trajectory_matches_jax(pair):
    m0, jb, v = pair
    cfg = dict(lr=LR, scheduler="cosine", num_update=4, clip_grad_norm=0.0)
    r = np.random.default_rng(20)
    xs = r.normal(size=(STEPS, B, *SI)).astype(np.float32)
    ys = r.normal(size=(STEPS, B, *SO)).astype(np.float32)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2.0, 3), std_targets=r.uniform(0.5, 2.0, 3))
    stats = {k: a.astype(np.float32) for k, a in stats.items()}

    masks = Masks(21)
    fresh = lambda t: jax.tree_util.tree_map(jnp.array, t)   # the step donates
    state = jts.TrainState.create(fresh(v["params"]), {"batch_stats": fresh(v["batch_stats"])},
                                  jts.build_optimizer(Config(**cfg)))
    jlosses = []
    for i in range(STEPS):
        # a step built anew each time, so that its trace draws its own masks
        jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats))
        with masks:
            state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                              jax.random.PRNGKey(i))
        jlosses.append(float(jl))

    model = build_model(shapes=(SI, SO), device="cpu", **KW)
    init = {k: t.clone() for k, t in m0.state_dict().items()}
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, tnorm.build_normalizer("gaussian", stats=stats), opt)
    losses, tiny = [], {}
    with mock.patch.object(tbase, "dropout_mask", masks.torch_mask):
        for i in range(STEPS):
            losses.append(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item())
            if i == 0:
                for name, p in model.named_parameters():
                    g = np.abs(_real(_np(p.grad)))
                    scale = g.max(axis=(0, 1), keepdims=True) if p.is_complex() else g.max()
                    tiny[name] = g < 1e-5 * scale
    assert masks.n_torch == masks.n_jax == 8 * STEPS
    _close(losses, jlosses)

    want = galerkin_state_dict(_np_tree(state.params),
                               _np_tree(state.model_state["batch_stats"]))
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = _real(_np(t)), _real(want[name].numpy())
        if name.endswith("running_mean"):     # takes in the conv bias
            np.testing.assert_allclose(
                got, ref, rtol=2e-4,
                atol=2e-4 * np.abs(ref).max() + 2 * STEPS * LR, err_msg=name)
            continue
        if name in tiny:                      # a parameter
            zero = _zero_grad_mask(name, got.shape)
            n_tiny = int((tiny[name] & ~zero).sum())
            assert n_tiny <= 1e-2 * got.size, \
                f"{name}: {n_tiny} of {got.size} first gradients below the noise"
            mask, p0 = zero | tiny[name], _real(init[name].numpy())
            for moved in (got - p0, ref - p0):
                assert np.abs(moved[mask]).max(initial=0) <= 1.01 * STEPS * LR, name
            got = np.where(mask, ref, got)
        _close(got, ref, msg=name)
