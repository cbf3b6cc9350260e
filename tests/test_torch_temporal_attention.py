"""PyTorch port vs JAX package: temporal attention over T per site (CPU).

The port's plain twin ``temporal_attention_tokens_plain`` and its public
``temporal_attention_tokens`` (which runs the twin, differentiated by
autograd, on a CPU tensor) against the JAX Pallas kernel in interpret mode
and its pure-jnp oracle ``reference_temporal_attention_tokens``: the output
and all four gradients (q, k, v, pos_bias) at S = 256, and at S = 300 (not
a multiple of the TPU kernel's 128 sites) against the oracle. Inputs from a
seeded numpy generator; f32; tolerance rtol 2e-4 with atol 2e-4·max|ref|.

The tensor-core variants of TA forward and backward run only on the card
(tests/test_torch_kernels.py); here their arithmetic is replayed in plain
PyTorch (the padded and masked T, the bf16 rounding points: the forward's
P as a bf16 hi + lo pair and o rounded once; the backward's dpb flush)
against the twin (the backward: autograd through it) at the UNet's
level-0 statistics, within the bounds the kernels are held to on the card,
and, unrounded, against the Pallas kernels in interpret mode. The tf32
variants' arithmetic (each f32 operand a tf32 hi + lo pair, hi·hi + hi·lo +
lo·hi; the k order of the products after the softmax permuted alike in both
operands; S, P, dP, dS and the outputs rounded to f32; dpb's flush) is
replayed the same way, summed in f64, against the twin's f64 arithmetic
(1e-5·max|ref| for o, dq, dk and dv, 1e-6 of the sum of |terms| for dpb)
and against the Pallas kernels in interpret mode (rtol 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tnf

from realpdebench_tpu.ops.pallas.temporal_attention import (
    reference_temporal_attention_tokens,
    temporal_attention_tokens as jax_ta,
)
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.temporal_attention import (
    temporal_attention_tokens,
    temporal_attention_tokens_plain,
)

# csrc/temporal_attention.cu: sites a warp's f32 sums of dS take before the
# block's f64 accumulator
TA_MMA_FLUSH = 16

B, T, H_, D = 2, 5, 3, 8
F = H_ * D


def _close(got, ref, rtol=2e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _inputs(S, seed):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.normal(size=(B, S, T, F)).astype(np.float32) for _ in range(4))
    pb = (0.3 * r.normal(size=(H_, T, T))).astype(np.float32)
    return q, k, v, pb, do


def _jax_vjp(fn, q, k, v, pb, do):
    out, vjp = jax.vjp(lambda *a: fn(*a), *map(jnp.asarray, (q, k, v, pb)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_vjp(fn, q, k, v, pb, do):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, pb)]
    out = fn(*leaves, H_)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("port", [temporal_attention_tokens_plain,
                                  temporal_attention_tokens], ids=["twin", "public"])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "reference"])
def test_matches_jax_at_256_sites(port, oracle):
    args = _inputs(256, seed=0)
    jfn = ((lambda *a: jax_ta(*a, H_, interpret=True)) if oracle == "pallas_interpret"
           else (lambda *a: reference_temporal_attention_tokens(*a, H_)))
    ref, ref_grads = _jax_vjp(jfn, *args)
    got, grads = _port_vjp(port, *args)
    _close(got, ref)
    for name, g, r in zip(("dq", "dk", "dv", "dpb"), grads, ref_grads):
        assert g.shape == r.shape, name
        _close(g, r)


def test_ragged_site_count_matches_reference():
    """S = 300: the port takes any S (the TPU kernel needs S % 128 == 0)."""
    args = _inputs(300, seed=1)
    ref, ref_grads = _jax_vjp(lambda *a: reference_temporal_attention_tokens(*a, H_),
                              *args)
    got, grads = _port_vjp(temporal_attention_tokens, *args)
    _close(got, ref)
    for g, r in zip(grads, ref_grads):
        _close(g, r)


def test_output_keeps_the_input_dtype_and_refuses_mismatched_shapes():
    q, k, v, pb, _ = (torch.from_numpy(a) for a in _inputs(7, seed=2))
    out = temporal_attention_tokens(q.bfloat16(), k.bfloat16(), v.bfloat16(), pb, H_)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    with pytest.raises(ValueError, match="heads"):
        temporal_attention_tokens(q, k[:, :3], v, pb, H_)
    with pytest.raises(ValueError, match="heads"):
        temporal_attention_tokens(q, k, v, pb, 5)


def _replay_ta_bwd_mma(q, k, v, pb, do, heads, *, rounding=True, nblocks=7):
    """TA backward's tensor-core variant in plain PyTorch. Per (site, head):
    the rows padded to 16·MT and the columns to 8·NT (NT = ceil(T/8), MT =
    ceil(NT/2)) with zeros; S = q·kᵀ and dP = do·vᵀ from the inputs as they
    are; the columns j ≥ T masked to −inf before the softmax, the rows i ≥ T
    zero; dS = P∘(dP − Σⱼ P·dP); dq = dS·k and dk = dSᵀ·q with dS rounded
    once to bf16, dv = Pᵀ·do with P rounded once; each output rounded once
    to bf16; the products in f64. dpb: the sites of a persistent grid of
    ``nblocks`` blocks (site s in block s mod nblocks, in order), a block's
    dS in f32 summed in f32 over TA_MMA_FLUSH sites at a time, each sum
    added into the block's f64 accumulator, the blocks' partials rounded to
    f32 and added in f64. ``rounding=False``: nothing rounded. Returns (dq,
    dk, dv, dpb)."""
    B, S, T, Fd = q.shape
    h, d = heads, Fd // heads
    NT = -(-T // 8)
    Ti, Tj = 16 * (-(-NT // 2)), 8 * NT
    heads_first = lambda z: z.double().reshape(B * S, T, h, d).permute(0, 2, 1, 3)
    rows = lambda z, n: tnf.pad(z, (0, 0, 0, n - T))
    Q, K, V, O = (heads_first(t) for t in (q, k, v, do))
    bias = torch.zeros(h, Ti, Tj, dtype=torch.float64)
    bias[:, :T, :T] = pb.double()
    sc = rows(Q, Ti) @ rows(K, Tj).transpose(-1, -2) + bias
    sc[..., T:] = -torch.inf
    p = torch.softmax(sc, -1)
    p[..., T:, :] = 0.0
    dp = rows(O, Ti) @ rows(V, Tj).transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    once = ((lambda t: t.float().bfloat16().double()) if rounding else (lambda t: t))
    dq = (once(ds) @ rows(K, Tj))[:, :, :T]
    dk = (once(ds).transpose(-1, -2) @ rows(Q, Ti))[:, :, :T]
    dv = (once(p).transpose(-1, -2) @ rows(O, Ti))[:, :, :T]
    back = lambda z: once(z.permute(0, 2, 1, 3).reshape(B, S, T, Fd))
    dsv = ds[:, :, :T, :T]
    if not rounding:
        return back(dq), back(dk), back(dv), dsv.sum(0)
    ds32 = dsv.float()
    total = torch.zeros(h, T, T, dtype=torch.float64)
    for b in range(nblocks):
        mine = ds32[b::nblocks]
        acc = torch.zeros(h, T, T, dtype=torch.float64)
        for g0 in range(0, mine.shape[0], TA_MMA_FLUSH):
            run = torch.zeros(h, T, T)
            for site in mine[g0:g0 + TA_MMA_FLUSH]:
                run = run + site
            acc += run.double()
        total += acc.float().double()
    return back(dq), back(dk), back(dv), total.float()


def _replay_ta_fwd_mma(q, k, v, pb, heads, *, rounding=True):
    """TA forward's tensor-core variant in plain PyTorch. Per (site, head):
    the rows padded to 16·MT and the columns to 8·NT with zeros; S = q·kᵀ
    from the inputs as they are; the columns j ≥ T masked to −inf before the
    softmax, the rows i ≥ T zero; P, an f32 value, split into a bf16 hi + lo
    pair (both MMAs: P·v = hi·v + lo·v); o rounded once to q's dtype; the
    products in f64. ``rounding=False``: nothing rounded."""
    B, S, T, Fd = q.shape
    h, d = heads, Fd // heads
    NT = -(-T // 8)
    Ti, Tj = 16 * (-(-NT // 2)), 8 * NT
    heads_first = lambda z: z.double().reshape(B * S, T, h, d).permute(0, 2, 1, 3)
    rows = lambda z, n: tnf.pad(z, (0, 0, 0, n - T))
    Q, K, V = (heads_first(t) for t in (q, k, v))
    bias = torch.zeros(h, Ti, Tj, dtype=torch.float64)
    bias[:, :T, :T] = pb.double()
    sc = rows(Q, Ti) @ rows(K, Tj).transpose(-1, -2) + bias
    sc[..., T:] = -torch.inf
    p = torch.softmax(sc, -1)
    p[..., T:, :] = 0.0
    if rounding:
        hi = p.float().bfloat16()
        lo = (p.float() - hi.float()).bfloat16()
        p = hi.double() + lo.double()
    o = (p @ rows(V, Tj))[:, :, :T].permute(0, 2, 1, 3).reshape(B, S, T, Fd)
    return o.to(q.dtype) if rounding else o


def _bf16_step(x):
    """The spacing of bfloat16 at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("T_", [7, 20, 32])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_ta_fwd_mma_replay_matches_twin(T_, d):
    """The replay against the twin from the same bf16 inputs at the UNet's
    level-0 statistics: within 1e-2·max|ref| (KERNEL_TOL's bf16 entry, the
    card's bound), and everywhere within one bf16 step of the twin's o plus
    1e-4·max|ref| (hi + lo carries P to 2^-17): only the one rounding of o
    is left (hi + lo: 1.8e-3-2.8e-3 of max|ref| at these nine
    shapes; P rounded once put o 3.7e-3-5.6e-3 from the twin, over the 5e-3
    line this choice was made on at five of them, the UNet's T 20, d 32
    among them); unrounded, within 2e-4 of the twin in f32."""
    h = 4 if d < 64 else 2
    shape = (2, 96, T_, h, d)
    q, k, v, pb, _ = (t.bfloat16() if t.dim() == 4 else t
                      for t in _unet_stats_inputs(*shape, seed=T_ + d))
    ref = temporal_attention_tokens_plain(q, k, v, pb, h)
    got = _replay_ta_fwd_mma(q, k, v, pb, h)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    assert err.max() <= 1e-2 * ref.float().abs().max()
    step = torch.maximum(_bf16_step(got.float()), _bf16_step(ref.float()))
    assert bool((err <= step + 1e-4 * ref.float().abs().max()).all())
    exact = _replay_ta_fwd_mma(q, k, v, pb, h, rounding=False)
    _close(exact.numpy(), temporal_attention_tokens_plain(
        q.float(), k.float(), v.float(), pb, h).numpy())


@pytest.mark.parametrize("T_", [7, 20])
def test_ta_fwd_mma_replay_matches_pallas_forward(T_):
    """Unrounded, the replay against the JAX Pallas forward in interpret
    mode (f32) at head widths and T the variant takes."""
    shape = (1, 128, T_, 4, 16)
    q, k, v, pb, _ = (t.numpy() for t in _unet_stats_inputs(*shape, seed=T_))
    ref = np.asarray(jax_ta(*map(jnp.asarray, (q, k, v, pb)), shape[3], interpret=True))
    got = _replay_ta_fwd_mma(*(torch.from_numpy(a) for a in (q, k, v, pb)), shape[3],
                             rounding=False)
    _close(got.numpy(), ref)


def _unet_stats_inputs(B_, S, T_, h, d, seed):
    """The UNet's level-0 statistics, as chip_smoke.py's ta phase draws
    them: q ~ N(0, 1)·d^-0.5 (the model pre-scales it), k, v, do and the
    bias N(0, 1); q, k, v and do rounded to bf16."""
    r = np.random.default_rng(seed)
    n = lambda *sh: torch.from_numpy(r.normal(size=sh).astype(np.float32))
    bf = lambda t: t.bfloat16().float()
    q = bf(n(B_, S, T_, h * d) * d ** -0.5)
    k, v, do = (bf(n(B_, S, T_, h * d)) for _ in range(3))
    return q, k, v, n(h, T_, T_), do


@pytest.mark.parametrize("shape", [
    (2, 150, 20, 4, 32),   # the UNet's T, heads and head width: NT 3, MT 2
    (2, 64, 5, 3, 16),     # NT 1, MT 1
    (1, 60, 32, 2, 64),    # T at its bound: NT 4
    (1, 40, 9, 8, 16),     # 8 heads, a second row tile of one row
])
def test_ta_bwd_mma_replay_matches_twin(shape):
    """The replay against autograd through the twin in f32 from the same
    bf16 inputs: dq, dk and dv within 1e-2·max|ref| and dpb within 1e-6 of
    the sum over sites of P·(|dP| + |Σ P·dP|), the bounds the kernel is
    held to on the card (KERNEL_TOL's bf16 entry, TA_DPB_TOL); the f32 flush
    of dpb within 1e-7 of that sum from the unrounded f64 sum, ten times
    inside TA_DPB_TOL; unrounded, dq, dk, dv and dpb within 2e-4 of the
    twin."""
    B_, S, T_, h, d = shape
    q, k, v, pb, do = _unet_stats_inputs(*shape, seed=sum(shape))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, pb)]
    ref = torch.autograd.grad(temporal_attention_tokens_plain(*leaves, h), leaves, do)
    got = _replay_ta_bwd_mma(q, k, v, pb, do, h)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape, name
        assert (g.float() - r).abs().max() <= 1e-2 * r.abs().max(), name
    spl = lambda z: z.double().view(B_, S, T_, h, d)
    pr = torch.softmax(torch.einsum("bsihd,bsjhd->bshij", spl(q), spl(k)) + pb.double(), -1)
    dp = torch.einsum("bsihd,bsjhd->bshij", spl(do), spl(v))
    terms = (pr * (dp.abs() + (pr * dp).sum(-1, keepdim=True).abs())).sum((0, 1))
    assert ((got[3].double() - ref[3].double()).abs() / terms).max() <= 1e-6
    exact = _replay_ta_bwd_mma(q, k, v, pb, do, h, rounding=False)
    assert ((got[3].double() - exact[3]).abs() / terms).max() <= 1e-7
    for name, g, r in zip(("dq", "dk", "dv", "dpb"), exact, ref):
        _close(g.numpy(), r.numpy())


def test_ta_bwd_mma_replay_matches_pallas_backward():
    """Unrounded, the replay against the JAX Pallas backward in interpret
    mode (f32) at a head width and T the variant takes (d 16, T 20)."""
    shape = (1, 128, 20, 4, 16)
    q, k, v, pb, do = (t.numpy() for t in _unet_stats_inputs(*shape, seed=9))
    _, ref = _jax_vjp(lambda *a: jax_ta(*a, shape[3], interpret=True), q, k, v, pb, do)
    got = _replay_ta_bwd_mma(*(torch.from_numpy(a) for a in (q, k, v, pb, do)), shape[3],
                             rounding=False)
    for name, g, r in zip(("dq", "dk", "dv", "dpb"), got, ref):
        assert g.shape == r.shape, name
        _close(g.numpy(), r)


# --------------------------------------------------------------------------
# the tf32 variants (f32 tensors, every product 3xTF32 on the tensor cores)
# --------------------------------------------------------------------------


def _pair(t):
    """t (f32) → its tf32 (hi, lo) pair in f64, as csrc/mma.cuh::split_tf32."""
    return tuple(u.double() for u in kernels.split_tf32(t))


def _x3(eq, a, b):
    """The 3xTF32 product of two f32 tensors by ``eq``, summed in f64:
    hi·hi + hi·lo + lo·hi of their tf32 pairs."""
    pa, pb = _pair(a), _pair(b)
    return (torch.einsum(eq, pa[0], pb[0]) + torch.einsum(eq, pa[0], pb[1])
            + torch.einsum(eq, pa[1], pb[0]))


def _k_order(n):
    """The tf32 variants' k order over n (a multiple of 8) indices: within
    a k-step of 8, slot q holds index 2q and slot q + 4 index 2q + 1, in the
    A and the B fragments alike (the transposed products after the
    softmax)."""
    step = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    return torch.cat([step + 8 * s for s in range(n // 8)])


def _permuted_x3(eq, a, b, dim_a, dim_b, T):
    """``_x3`` over a k dimension of length T padded with zeros to 8·ceil(T/8)
    and taken in ``_k_order`` (dimension dim_a of a, dim_b of b)."""
    n = 8 * -(-T // 8)
    order = _k_order(n)

    def pad(t, dim):
        shape = list(t.shape)
        shape[dim] = n - T
        return torch.cat([t, t.new_zeros(shape)], dim).index_select(dim, order)
    return _x3(eq, pad(a, dim_a), pad(b, dim_b))


def _tf32_heads(z, heads):
    B, S, T, Fd = z.shape
    return z.float().reshape(B * S, T, heads, Fd // heads).permute(0, 2, 1, 3)


def _tf32_softmax(q, k, pb, heads):
    """S = q·kᵀ (3xTF32, an f32 accumulator) + the f32 bias, and P =
    softmax(S) kept in f32, as ta_warp_softmax_tf32 leaves them."""
    s = _x3("nhid,nhjd->nhij", _tf32_heads(q, heads), _tf32_heads(k, heads)).float()
    return torch.softmax((s + pb.float()).double(), -1).float()


def _replay_ta_fwd_tf32(q, k, v, pb, heads):
    """TA forward's tf32 variant in plain PyTorch: P from
    ``_tf32_softmax``; o = P·v on the tf32 pairs of P and v, j in the
    permuted k order, summed in f64 and rounded once to f32."""
    B, S, T, Fd = q.shape
    p = _tf32_softmax(q, k, pb, heads)
    o = _permuted_x3("nhij,nhjd->nhid", p, _tf32_heads(v, heads), 3, 2, T).float()
    return o.permute(0, 2, 1, 3).reshape(B, S, T, Fd)


def _replay_ta_bwd_tf32(q, k, v, pb, do, heads, nblocks=7):
    """TA backward's tf32 variant in plain PyTorch: P as the forward's;
    dP = do·vᵀ (3xTF32, f32); dS = P∘(dP − Σⱼ P·dP) in f32; dq = dS·k
    (over j), dk = dSᵀ·q and dv = Pᵀ·do (over i), each on the tf32 pairs of
    its f32 operands in the permuted k order, summed in f64 and rounded once
    to f32; dpb over a persistent grid of ``nblocks`` blocks (site s in
    block s mod nblocks), a block's f32 sums of dS over TA_MMA_FLUSH sites
    at a time added into its f64 accumulator, the partials rounded to f32
    and added in f64. Returns (dq, dk, dv, dpb)."""
    B, S, T, Fd = q.shape
    Q, K, V, O = (_tf32_heads(t, heads) for t in (q, k, v, do))
    p = _tf32_softmax(q, k, pb, heads)
    dp = _x3("nhid,nhjd->nhij", O, V).float().double()
    ds = (p.double() * (dp - (p.double() * dp).sum(-1, keepdim=True))).float()
    dq = _permuted_x3("nhij,nhjd->nhid", ds, K, 3, 2, T)
    dk = _permuted_x3("nhij,nhid->nhjd", ds, Q, 2, 2, T)
    dv = _permuted_x3("nhij,nhid->nhjd", p, O, 2, 2, T)
    back = lambda z: z.float().permute(0, 2, 1, 3).reshape(B, S, T, Fd)
    total = torch.zeros(heads, T, T, dtype=torch.float64)
    for b in range(nblocks):
        mine = ds[b::nblocks]
        acc = torch.zeros(heads, T, T, dtype=torch.float64)
        for g0 in range(0, mine.shape[0], TA_MMA_FLUSH):
            run = torch.zeros(heads, T, T)
            for site in mine[g0:g0 + TA_MMA_FLUSH]:
                run = run + site
            acc += run.double()
        total += acc.float().double()
    return back(dq), back(dk), back(dv), total.float()


def _f32_inputs(B_, S, T_, h, d, seed):
    """f32 inputs at the UNet's level-0 statistics (chip_smoke.py's ta
    phase): q ~ N(0, 1)·d^-0.5, k, v, do and the bias N(0, 1); not rounded,
    so that every tf32 split carries a lo part."""
    r = np.random.default_rng(seed)
    n = lambda *sh: torch.from_numpy(r.normal(size=sh).astype(np.float32))
    return (n(B_, S, T_, h * d) * d ** -0.5, n(B_, S, T_, h * d), n(B_, S, T_, h * d),
            n(h, T_, T_), n(B_, S, T_, h * d))


def _twin64_grads(q, k, v, pb, do, heads):
    """The twin's output and autograd gradients in f64 from the same inputs."""
    leaves = [t.double().requires_grad_() for t in (q, k, v, pb)]
    out = temporal_attention_tokens_plain(*leaves, heads)
    return out.detach(), torch.autograd.grad(out, leaves, do.double())


def _dpb_terms64(q, k, v, pb, do, heads):
    """Σ over sites of P·(|dP| + |Σⱼ P·dP|) in f64: the scale of dpb."""
    B_, S, T_, Fd = q.shape
    spl = lambda z: z.double().view(B_, S, T_, heads, Fd // heads)
    p = torch.softmax(torch.einsum("bsihd,bsjhd->bshij", spl(q), spl(k)) + pb.double(), -1)
    dp = torch.einsum("bsihd,bsjhd->bshij", spl(do), spl(v))
    return (p * (dp.abs() + (p * dp).sum(-1, keepdim=True).abs())).sum((0, 1))


def _within(got, ref, tol):
    return (got.double() - ref).abs().max() <= tol * ref.abs().max()


@pytest.mark.parametrize("T_", [7, 20, 32])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_ta_fwd_tf32_replay_matches_twin(T_, d):
    """The replay against the twin's f64 arithmetic from the same f32
    inputs at the UNet's level-0 statistics: o within 1e-5·max|ref|, ten
    times inside the f32 bound the kernel is held to on the card (1e-4);
    the permuted k order gives the product of the unpermuted one."""
    h = 4 if d < 64 else 2
    q, k, v, pb, _ = _f32_inputs(2, 40, T_, h, d, seed=T_ + d)
    ref, _ = _twin64_grads(q, k, v, pb, q, h)
    got = _replay_ta_fwd_tf32(q, k, v, pb, h)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _within(got, ref, 1e-5)
    p = _tf32_softmax(q, k, pb, h)
    vh = _tf32_heads(v, h)
    assert torch.allclose(_permuted_x3("nhij,nhjd->nhid", p, vh, 3, 2, T_),
                          _x3("nhij,nhjd->nhid", p, vh), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("T_", [7, 20, 32])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_ta_bwd_tf32_replay_matches_twin(T_, d):
    """The replay against autograd through the twin in f64 from the same f32
    inputs: dq, dk and dv within 1e-5·max|ref|; dpb within 1e-6 of the sum
    over sites of P·(|dP| + |Σ P·dP|) (TA_DPB_TOL, the card's bound)."""
    h = 4 if d < 64 else 2
    q, k, v, pb, do = _f32_inputs(2, 40, T_, h, d, seed=2 * T_ + d)
    _, ref = _twin64_grads(q, k, v, pb, do, h)
    got = _replay_ta_bwd_tf32(q, k, v, pb, do, h)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        assert _within(g, r, 1e-5), name
    terms = _dpb_terms64(q, k, v, pb, do, h)
    assert ((got[3].double() - ref[3]).abs() / terms).max() <= 1e-6


def test_ta_tf32_replays_match_pallas_kernels():
    """The replays against the JAX Pallas forward and backward in interpret
    mode (f32) at a head width and T the variant takes (d 16, T 20)."""
    shape = (1, 128, 20, 4, 16)
    q, k, v, pb, do = (t.numpy() for t in _f32_inputs(*shape, seed=19))
    out, ref = _jax_vjp(lambda *a: jax_ta(*a, shape[3], interpret=True), q, k, v, pb, do)
    args = [torch.from_numpy(a) for a in (q, k, v, pb, do)]
    _close(_replay_ta_fwd_tf32(*args[:4], shape[3]).numpy(), out)
    for name, g, r in zip(("dq", "dk", "dv", "dpb"), _replay_ta_bwd_tf32(*args, shape[3]), ref):
        assert g.shape == r.shape, name
        _close(g.numpy(), r)
