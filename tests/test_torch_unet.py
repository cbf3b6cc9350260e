"""PyTorch port vs JAX package: the cylinder Unet3d (CPU, f32).

1. Units: each module of ``models/unet.py`` against its flax counterpart
   with the same weights (relative-position bias, rotary embedding,
   channel LayerNorm, temporal attention through the einsum path and
   through the Pallas kernel in interpret mode, spatial attention, spatial
   linear attention, ResnetBlock, the sinusoidal embedding): outputs, and
   for the attentions the input and weight gradients.
2. The whole Unet3d at shape (4, 16, 16, 3) with dim_mults (1, 2), as
   ``tests/test_unet.py``: the forward, the loss's parameter gradients
   against ``jax.grad``, and ``load_state_dict(strict=True)`` of the JAX
   package's ``export_torch_state_dict``, equal key for key to the port's
   ``from_jax.unet_state_dict``.
3. A 3-step training trajectory of the port's ``make_train_step`` against
   the JAX ``make_train_step`` (Adam, cosine schedule, Gaussian
   normalizer inside the step): each loss and the parameters after.
4. ``remat`` (the ResnetBlocks rematerialised in the backward): on by
   default as in the JAX registry, off by ``remat=False``; the loss and
   every gradient with it on equal those with it off (rtol 1e-6); on, the
   model and a 3-step trajectory against the JAX package's with
   ``remat=True`` (rtol 2e-4).

The JAX weights come from the port's seeded weights, perturbed by seeded
numpy noise so that no bias is zero and no norm scale one, converted with
the JAX package's ``convert_unet`` (no JAX init to compile). Tolerance:
rtol 2e-4 with atol 2e-4·max|ref|. In the trajectory, a parameter whose
first gradient is nonzero but below float noise (0 < |g| < 1e-5·max|g| of
its tensor) has no step direction either framework can fix, and Adam moves
it by up to lr either way; such entries (counted, at most 1% of a tensor)
are held to Adam's bound of n·lr instead. An exact zero gradient (the rows
of the bias table that no T offset uses) stays zero in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realpdebench_tpu.config import Config
from realpdebench_tpu.data import normalizer as jnorm
from realpdebench_tpu.interop.torch_convert import convert_unet
from realpdebench_tpu.interop.torch_export import export_torch_state_dict
from realpdebench_tpu.models import unet as ju
from realpdebench_tpu.models.registry import build_model as jbuild
from realpdebench_tpu.train import train_step as jts
from realpdebench_tpu_torch.data import normalizer as tnorm
from realpdebench_tpu_torch.interop.from_jax import unet_state_dict
from realpdebench_tpu_torch.models import unet as tu
from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.train import build_optimizer, make_train_step
from realpdebench_tpu_torch.utils.misc import make_generator

SI = SO = (4, 16, 16, 3)
KW = dict(model_name="unet", dim_mults=[1, 2], remat=False)
KW_REMAT = dict(KW, remat=True)
STEPS, LR = 3, 1e-3


def _close(got, ref, rtol=2e-4, msg=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (msg, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()), err_msg=msg)


def _np(t):
    return t.detach().cpu().numpy()


def _perturb(module, seed):
    """Seeded noise on every parameter: no zero bias, no unit scale."""
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(0.1 * r.normal(size=p.shape).astype(np.float32)))
    return module


def _kernel(w):
    """torch Conv weight (O, I, *K) or Linear weight (O, I) → flax kernel."""
    w = _np(w)
    return np.ascontiguousarray(w.transpose(*range(2, w.ndim), 1, 0))


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def _port_model(seed=0, kw=KW):
    return _perturb(build_model(shapes=(SI, SO), device="cpu",
                                generator=make_generator(seed), **kw), seed + 100)


def _jax_params(model):
    sd = {k: _np(v) for k, v in model.state_dict().items()}
    return jax.tree_util.tree_map(jnp.asarray, convert_unet(sd, None, {})[0])


# --------------------------------------------------------------------------
# 1. units
# --------------------------------------------------------------------------


def test_relative_position_bias_matches_jax():
    m = _perturb(tu.RelativePositionBias(heads=4, max_distance=32), 1)
    want = ju.RelativePositionBias(heads=4, max_distance=32).apply(
        {"params": {"embedding": _np(m.relative_attention_bias.weight)}}, 20)
    _close(_np(m(20)), want)
    rel = np.arange(40)[None, :] - np.arange(40)[:, None]
    np.testing.assert_array_equal(tu.relative_position_bucket(rel, 32, 32),
                                  ju.relative_position_bucket(rel, 32, 32))


@pytest.mark.parametrize("d", [8, 48])   # rotates all features; the first 32
def test_rotary_matches_jax(d):
    x = np.random.default_rng(2).normal(size=(2, 3, 7, 2, d)).astype(np.float32)
    got = tu.apply_rotary(torch.from_numpy(x),
                          tu.rotary_freqs(7, min(32, d), torch.device("cpu"))[:, None])
    freqs = ju.rotary_freqs(7, min(32, d))[None, None, :, None, :]
    _close(_np(got), ju.apply_rotary(jnp.asarray(x), freqs))


def test_channel_layer_norm_matches_jax():
    x = np.random.default_rng(3).normal(1.0, 2.0, size=(2, 3, 4, 5, 8)).astype(np.float32)
    m = _perturb(tu.ChannelLayerNorm(8), 3)
    want = ju.ChannelLayerNorm(8).apply({"params": {"gamma": _np(m.gamma).reshape(-1)}},
                                        jnp.asarray(x))
    _close(_np(m(_ncdhw(x))).transpose(0, 2, 3, 4, 1), want)
    assert m(_ncdhw(x).bfloat16()).dtype == torch.bfloat16


def _vjp_both(jfn, jparams, tfn, tmodule, x, seed):
    """Output, input gradient and weight gradients of the same cotangent
    through the flax apply ``jfn(params, x)`` ([B, T, H, W, C] in and out)
    and the port module ``tfn`` (NCDHW)."""
    r = np.random.default_rng(seed)
    out, vjp = jax.vjp(jfn, jparams, jnp.asarray(x))
    ct = r.normal(size=out.shape).astype(np.float32)
    gp, gx = vjp(jnp.asarray(ct))
    xt = _ncdhw(x).requires_grad_()
    o = tfn(xt)
    o.backward(_ncdhw(ct))
    _close(_np(o).transpose(0, 2, 3, 4, 1), out, msg="out")
    _close(_np(xt.grad).transpose(0, 2, 3, 4, 1), gx, msg="dx")
    return gp, {n: _np(p.grad) for n, p in tmodule.named_parameters()}


@pytest.mark.parametrize("route", ["einsum", "pallas_interpret"])
def test_temporal_attention_matches_jax(route):
    b, t, h, w, c = 2, 5, 8, 16, 16          # S = 128: the Pallas kernel's tile
    x = np.random.default_rng(4).normal(size=(b, t, h, w, c)).astype(np.float32)
    pb = 0.3 * np.random.default_rng(5).normal(size=(4, t, t)).astype(np.float32)
    ta = _perturb(tu.TemporalAttention(c, heads=4, dim_head=8), 4)
    m = tu.TemporalTokens(ta)
    jm = ju.TemporalAttention(c, heads=4, dim_head=8,
                              use_pallas=route == "pallas_interpret",
                              pallas_interpret=True)
    jp = {"to_qkv": {"kernel": _kernel(ta.to_qkv.weight)},
          "to_out": {"kernel": _kernel(ta.to_out.weight)}}
    gp, gt = _vjp_both(lambda p, xx: jm.apply({"params": p}, xx, jnp.asarray(pb)),
                       jp, lambda xx: m(xx, torch.from_numpy(pb)), ta, x, 6)
    _close(gt["to_qkv.weight"], _kernel_t(gp["to_qkv"]["kernel"]))
    _close(gt["to_out.weight"], _kernel_t(gp["to_out"]["kernel"]))


def _kernel_t(k):
    k = np.asarray(k)
    return np.ascontiguousarray(k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2)))


def test_spatial_attention_matches_jax():
    x = np.random.default_rng(7).normal(size=(2, 3, 4, 6, 16)).astype(np.float32)
    sa = _perturb(tu.SpatialAttention(16, heads=2, dim_head=8), 7)
    jm = ju.SpatialAttention(16, heads=2, dim_head=8)
    jp = {"to_qkv": {"kernel": _kernel(sa.to_qkv.weight)},
          "to_out": {"kernel": _kernel(sa.to_out.weight)}}
    gp, gt = _vjp_both(lambda p, xx: jm.apply({"params": p}, xx), jp,
                       tu.FrameTokens(sa), sa, x, 8)
    _close(gt["to_qkv.weight"], _kernel_t(gp["to_qkv"]["kernel"]))
    _close(gt["to_out.weight"], _kernel_t(gp["to_out"]["kernel"]))


def test_spatial_linear_attention_matches_jax():
    x = np.random.default_rng(9).normal(size=(2, 3, 4, 6, 16)).astype(np.float32)
    sla = _perturb(tu.SpatialLinearAttention(16, heads=2, dim_head=8), 9)
    jm = ju.SpatialLinearAttention(16, heads=2, dim_head=8)
    jp = {"to_qkv": {"kernel": _kernel(sla.to_qkv.weight)},
          "to_out": {"kernel": _kernel(sla.to_out.weight), "bias": _np(sla.to_out.bias)}}
    gp, gt = _vjp_both(lambda p, xx: jm.apply({"params": p}, xx), jp, sla, sla, x, 10)
    _close(gt["to_qkv.weight"], _kernel_t(gp["to_qkv"]["kernel"]))
    _close(gt["to_out.bias"], gp["to_out"]["bias"])


@pytest.mark.parametrize("dim,dim_out,time", [(8, 16, 12), (16, 16, None)])
def test_resnet_block_matches_jax(dim, dim_out, time):
    r = np.random.default_rng(11)
    x = r.normal(size=(2, 3, 4, 6, dim)).astype(np.float32)
    temb = r.normal(size=(2, time)).astype(np.float32) if time else None
    m = _perturb(tu.ResnetBlock(dim, dim_out, time, groups=8), 11)
    blk = lambda b: {"proj": {"kernel": _kernel(b.proj.weight), "bias": _np(b.proj.bias)},
                     "norm": {"scale": _np(b.norm.weight), "bias": _np(b.norm.bias)}}
    p = {"block1": blk(m.block1), "block2": blk(m.block2)}
    if time:
        p["mlp"] = {"kernel": _kernel(m.mlp[1].weight), "bias": _np(m.mlp[1].bias)}
    if dim != dim_out:
        p["res_conv"] = {"kernel": _kernel(m.res_conv.weight), "bias": _np(m.res_conv.bias)}
    want = ju.ResnetBlock(dim_out, time, groups=8).apply(
        {"params": p}, jnp.asarray(x), None if temb is None else jnp.asarray(temb))
    got = m(_ncdhw(x), None if temb is None else torch.from_numpy(temb))
    _close(_np(got).transpose(0, 2, 3, 4, 1), want)


def test_sinusoidal_pos_emb_matches_jax():
    t = np.array([0.0, 1.5, 7.0], np.float32)
    _close(_np(tu.sinusoidal_pos_emb(torch.from_numpy(t), 16)),
           ju.sinusoidal_pos_emb(jnp.asarray(t), 16))


# --------------------------------------------------------------------------
# 2. the whole model
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(port model, JAX bundle, JAX params) with the same weights."""
    m = _port_model()
    return m, jbuild(shapes=(SI, SO), **KW), _jax_params(m)


def test_export_loads_strict_and_equals_from_jax(pair):
    m, jb, params = pair
    exported = export_torch_state_dict(jb, params, {})
    mine = unet_state_dict(jax.tree_util.tree_map(np.asarray, params))
    assert set(exported) == set(mine) == set(m.state_dict())
    for k, v in mine.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), v.numpy(), err_msg=k)
    fresh = build_model(shapes=(SI, SO), device="cpu", **KW)
    fresh.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in exported.items()}, strict=True)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(_np(v), _np(m.state_dict()[k]), err_msg=k)


def test_unet_forward_and_loss_gradients_match_jax(pair):
    _forward_and_gradients_vs_jax(*pair)


def _forward_and_gradients_vs_jax(m, jb, params):
    """The port's prediction, loss and every parameter gradient against the
    JAX bundle's from the same weights and inputs."""
    r = np.random.default_rng(12)
    x = r.normal(size=(2, *SI)).astype(np.float32)
    y = r.normal(size=(2, *SO)).astype(np.float32)
    _close(_np(m.predict(torch.from_numpy(x))),
           jax.jit(jb.module.apply)({"params": params}, jnp.asarray(x)))

    def loss(p):
        return jnp.mean((jb.module.apply({"params": p}, jnp.asarray(x)) - y) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss))(params)
    m.zero_grad()
    tl = m(torch.from_numpy(x), y=torch.from_numpy(y))
    tl.backward()
    _close(tl.item(), float(jl))
    want = unet_state_dict(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in m.named_parameters():
        _close(_np(p.grad), want[name].numpy(), msg=name)


def test_unet_time_upsampling_matches_jax():
    si, so = (2, 16, 16, 3), (4, 16, 16, 2)
    kw = dict(KW, dim_mults=[1])
    m = _perturb(build_model(shapes=(si, so), device="cpu",
                             generator=make_generator(3), **kw), 13)
    jb = jbuild(shapes=(si, so), **kw)
    x = np.random.default_rng(14).normal(size=(1, *si)).astype(np.float32)
    got = _np(m.predict(torch.from_numpy(x)))
    assert got.shape == (1, *so)
    _close(got, jax.jit(jb.module.apply)({"params": _jax_params(m)}, jnp.asarray(x)))


def test_init_is_seeded_and_follows_jax_shapes():
    jb = jbuild(shapes=(SI, SO), **KW)
    shapes = jax.eval_shape(jb.module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *SI), jnp.float32))["params"]
    want = unet_state_dict(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    mk = lambda s: build_model(shapes=(SI, SO), device="cpu",
                               generator=make_generator(s), **KW).state_dict()
    a, b, c = mk(0), mk(0), mk(1)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["init_conv.weight"], c["init_conv.weight"])
    assert torch.equal(a["downs.0.0.block1.norm.weight"], torch.ones(16))
    assert torch.equal(a["init_conv.bias"], torch.zeros(16))
    assert torch.equal(a["mid_temporal_attn.fn.norm.gamma"], torch.ones(1, 32, 1, 1, 1))
    # lecun normal truncated at 2 std: |w| <= 2 * sqrt(1/fan_in) / 0.8796
    w = a["downs.0.0.block1.proj.weight"]
    assert w.abs().max() <= 2 * (1 / (16 * 27)) ** 0.5 / 0.8796 + 1e-7
    assert 0.9 < w.std().item() * (16 * 27) ** 0.5 < 1.1
    assert 0.5 < a["time_rel_pos_bias.relative_attention_bias.weight"].std().item() < 1.5


def test_build_model_unet_takes_jax_registry_kwargs():
    m = build_model(shapes=(SI, SO), device="cpu", compute_dtype="bfloat16",
                    use_pallas=None, **KW)
    assert isinstance(m, tu.Unet3d) and m.compute_dtype == torch.bfloat16
    out = m.predict(torch.zeros(1, *SI))
    assert out.dtype == torch.float32 and out.shape == (1, *SO)


# --------------------------------------------------------------------------
# 3. training trajectory
# --------------------------------------------------------------------------


def test_train_step_trajectory_matches_jax(pair):
    _trajectory_vs_jax(*pair, KW)


def _trajectory_vs_jax(m0, jb, params, kw):
    """STEPS training steps of the port (a model built with ``kw`` from
    m0's weights) against the JAX step from the same weights and batches:
    each loss and every parameter after."""
    cfg = dict(lr=LR, scheduler="cosine", num_update=4, clip_grad_norm=0.0)
    r = np.random.default_rng(20)
    xs = r.normal(size=(STEPS, 2, *SI)).astype(np.float32)
    ys = r.normal(size=(STEPS, 2, *SO)).astype(np.float32)
    stats = dict(mean_inputs=r.normal(size=3), mean_targets=r.normal(size=3),
                 std_inputs=r.uniform(0.5, 2.0, 3), std_targets=r.uniform(0.5, 2.0, 3))
    stats = {k: v.astype(np.float32) for k, v in stats.items()}

    state = jts.TrainState.create(params, {}, jts.build_optimizer(Config(**cfg)))
    jstep = jts.make_train_step(jb, jnorm.build_normalizer("gaussian", stats=stats))
    jlosses = []
    for i in range(STEPS):
        state, jl = jstep(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                          jax.random.PRNGKey(i))
        jlosses.append(float(jl))

    model = build_model(shapes=(SI, SO), device="cpu", **kw)
    init = {k: v.clone() for k, v in m0.state_dict().items()}
    model.load_state_dict(init, strict=True)
    opt = build_optimizer(cfg, model.parameters())
    step = make_train_step(model, tnorm.build_normalizer("gaussian", stats=stats), opt)
    losses, tiny = [], {}
    for i in range(STEPS):
        losses.append(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])).item())
        if i == 0:
            tiny = {n: ((p.grad != 0) & (p.grad.abs() < 1e-5 * p.grad.abs().max())).numpy()
                    for n, p in model.named_parameters()}
    _close(losses, jlosses)

    want = unet_state_dict(jax.tree_util.tree_map(np.asarray, state.params))
    for name, t in model.state_dict().items():
        got, ref = _np(t), want[name].numpy()
        mask = tiny[name]
        assert mask.sum() <= 1e-2 * mask.size, f"{name}: {mask.sum()} tiny gradients"
        p0 = _np(init[name])
        for moved in (got - p0, ref - p0):
            assert np.abs(moved[mask]).max(initial=0) <= 1.01 * STEPS * LR, name
        _close(np.where(mask, ref, got), ref, msg=name)


# --------------------------------------------------------------------------
# 4. remat
# --------------------------------------------------------------------------


def _resnet_forwards(model, fn):
    """fn(), with the ResnetBlocks' forward calls counted (at their start: a
    checkpoint's recompute may stop before a block's end)."""
    calls = [0]
    hooks = [m.register_forward_pre_hook(lambda *_: calls.__setitem__(0, calls[0] + 1))
             for m in model.modules() if isinstance(m, tu.ResnetBlock)]
    try:
        fn()
    finally:
        for hk in hooks:
            hk.remove()
    return calls[0]


def test_build_model_unet_defaults_to_remat():
    """``remat`` defaults to true for unet, as in the JAX registry, and
    ``remat=False`` turns it off; the FNO's and the GK's registries accept
    the key."""
    kw = {k: v for k, v in KW.items() if k != "remat"}
    assert build_model(shapes=(SI, SO), device="cpu", **kw).remat is True
    assert build_model(shapes=(SI, SO), device="cpu", **KW_REMAT).remat is True
    assert build_model(shapes=(SI, SO), device="cpu", **KW).remat is False


def test_remat_changes_no_number():
    """The same weights and batch with remat on and off: the loss and every
    gradient equal within rtol 1e-6 (the blocks draw no random numbers). With
    it on the backward recomputes each ResnetBlock's forward (2 calls a block
    instead of 1); without autograd, or on the plain path, nothing is
    recomputed."""
    r = np.random.default_rng(30)
    x = torch.from_numpy(r.normal(size=(2, *SI)).astype(np.float32))
    y = torch.from_numpy(r.normal(size=(2, *SO)).astype(np.float32))
    losses, grads, calls = {}, {}, {}
    for remat in (False, True):
        m = _port_model(4, dict(KW, remat=remat))
        n_blocks = sum(isinstance(b, tu.ResnetBlock) for b in m.modules())

        def loss_and_backward():
            loss = m(x, y=y)
            loss.backward()
            losses[remat] = loss.item()
        calls[remat] = _resnet_forwards(m, loss_and_backward)
        grads[remat] = {n: p.grad.clone() for n, p in m.named_parameters()}
        with torch.no_grad():
            assert _resnet_forwards(m, lambda: m.predict(x)) == n_blocks
        assert _resnet_forwards(m, lambda: m(x, y=y, reference=True).backward()) == n_blocks
    assert calls == {False: n_blocks, True: 2 * n_blocks}
    _close(losses[True], losses[False], rtol=1e-6)
    for name, g in grads[False].items():
        _close(_np(grads[True][name]), _np(g), rtol=1e-6, msg=name)


@pytest.fixture(scope="module")
def pair_remat():
    """(port model with remat, JAX bundle with remat=True, JAX params) with
    the same weights."""
    m = _port_model(kw=KW_REMAT)
    return m, jbuild(shapes=(SI, SO), **KW_REMAT), _jax_params(m)


def test_unet_with_remat_matches_jax_with_remat(pair_remat):
    assert pair_remat[0].remat and pair_remat[1].module.remat
    _forward_and_gradients_vs_jax(*pair_remat)


def test_train_step_trajectory_with_remat_matches_jax(pair_remat):
    _trajectory_vs_jax(*pair_remat, KW_REMAT)
