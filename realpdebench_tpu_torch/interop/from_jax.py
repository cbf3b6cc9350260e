"""JAX parameters → the port's ``state_dict``.

Counterpart of ``realpdebench_tpu/interop/torch_export.py`` (its
``export_fno``, ``export_unet``, ``export_galerkin``, ``export_deeponet``,
``export_transolver``, ``export_dpot``, ``export_cno``, ``export_mwt`` and
``export_wdno``):
the same key names
and conventions,
producing torch tensors that the port's ``load_state_dict(...,
strict=True)`` takes. Inputs are the JAX ``params`` (and ``batch_stats``)
trees as nested dicts of numpy arrays, so this module needs no JAX.

Conventions: a flax Dense kernel [in, out] becomes a Linear weight
[out, in]; a flax Conv kernel [*K, in, out] a Conv weight [out, in, *K];
a flax ConvTranspose kernel with ``transpose_kernel=True`` [*K, out, in]
a ConvTranspose weight [in, out, *K] (the same axis permutation); the
channels-minor corner weights (w_real, w_imag) [4, m1, m2, m3, C_in, C_out]
become complex ``weights1..4`` [C_in, C_out, m1, m2, m3]; the pointwise
kernel [C_in, C_out] becomes a 1x1x1 Conv3d weight [C_out, C_in, 1, 1, 1];
BatchNorm and GroupNorm scale/bias map to weight/bias, BatchNorm running
mean/var to running_mean/running_var, plus the ``num_batches_tracked``
counter every torch BatchNorm carries.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))   # a copy the port owns


def _spectral_layer(sd, spectral, pointwise, bn, stats, *, spec_key, conv_key,
                    bn_key) -> None:
    """One spectral layer: the corner weights, the pointwise conv and the
    BatchNorm with its running statistics."""
    w = (np.asarray(spectral["w_real"]).astype(np.complex64)
         + 1j * np.asarray(spectral["w_imag"]).astype(np.complex64))
    w = w.transpose(0, 4, 5, 1, 2, 3)
    for k in range(4):
        sd[f"{spec_key}.weights{k + 1}"] = _t(w[k])
    kern = np.asarray(pointwise["kernel"])
    sd[f"{conv_key}.weight"] = _t(kern.T[:, :, None, None, None])
    sd[f"{conv_key}.bias"] = _t(pointwise["bias"])
    _bn(sd, bn_key, bn, stats)


def fno_state_dict(params: dict, batch_stats: dict) -> dict:
    """JAX FNO3d ``params`` and ``batch_stats`` → FNO3d ``state_dict``."""
    sd = {}
    for k in ("fc0", "fc1", "fc2"):
        _dense(sd, k, params[k])
    i = 0
    while f"layer_{i}" in params:
        lp = params[f"layer_{i}"]
        _spectral_layer(sd, lp["spectral"], lp["pointwise"], lp["bn"],
                        batch_stats[f"layer_{i}"]["bn"],
                        spec_key=f"spectral_convs.{i}", conv_key=f"convs.{i}",
                        bn_key=f"bns.{i}")
        i += 1
    return sd


def galerkin_state_dict(params: dict, batch_stats: dict) -> dict:
    """JAX GalerkinTransformer3d ``params`` and ``batch_stats`` →
    GalerkinTransformer3d ``state_dict``."""
    sd = {}
    _dense(sd, "downscaler.id", params["downscaler"])
    i = 0
    while f"encoder_{i}" in params:
        enc, pre = params[f"encoder_{i}"], f"encoder_layers.{i}"
        for src, dst in (("q", 0), ("k", 1), ("v", 2)):
            _dense(sd, f"{pre}.attn.linears.{dst}", enc["attn"][src])
        for which in ("K", "V"):
            nrm = enc["attn"][f"norm_{which}"]
            for h, (scale, bias) in enumerate(zip(np.asarray(nrm["scale"]),
                                                  np.asarray(nrm["bias"]))):
                sd[f"{pre}.attn.norm_{which}.{h}.weight"] = _t(scale)
                sd[f"{pre}.attn.norm_{which}.{h}.bias"] = _t(bias)
        _dense(sd, f"{pre}.ff.lr1", enc["ff1"])
        _dense(sd, f"{pre}.ff.lr2", enc["ff2"])
        for ln in ("layer_norm1", "layer_norm2"):
            if ln in enc:
                sd[f"{pre}.{ln}.weight"] = _t(enc[ln]["scale"])
                sd[f"{pre}.{ln}.bias"] = _t(enc[ln]["bias"])
        i += 1
    reg, stats = params["regressor"], batch_stats["regressor"]
    _dense(sd, "regressor.fc", reg["fc"])
    i = 0
    while f"spectral_{i}" in reg:
        _spectral_layer(sd, reg[f"spectral_{i}"], reg[f"pointwise_{i}"],
                        reg[f"bn_{i}"], stats[f"bn_{i}"],
                        spec_key=f"regressor.spectral_conv.{i}",
                        conv_key=f"regressor.convs.{i}",
                        bn_key=f"regressor.bns.{i}")
        i += 1
    _dense(sd, "regressor.regressor1", reg["regressor1"])
    _dense(sd, "regressor.regressor2", reg["regressor2"])
    return sd


def deeponet_state_dict(params: dict, batch_stats: dict) -> dict:
    """JAX DeepONet ``params`` and ``batch_stats`` → DeepONet ``state_dict``.
    The branch's first Dense reads the pooled [1, 4, 4, 256] features
    flattened channels-last in JAX and channels-first in the port: its
    columns are permuted from (spatial, C) to (C, spatial) order."""
    sd, br, bs = {}, params["branch"], batch_stats["branch"]
    for i in range(4):
        key = f"branch.conv{i + 1}"
        _conv(sd, f"{key}.0", br[f"Conv_{i}"])
        _bn(sd, f"{key}.1", br[f"BatchNorm_{i}"], bs[f"BatchNorm_{i}"])
    k0 = np.asarray(br["Dense_0"]["kernel"])             # [spatial·C, 512]
    c = np.asarray(br["Conv_3"]["kernel"]).shape[-1]
    w0 = k0.T.reshape(k0.shape[1], -1, c).transpose(0, 2, 1)
    sd["branch.fc.0.weight"] = _t(w0.reshape(k0.shape[1], -1))
    sd["branch.fc.0.bias"] = _t(br["Dense_0"]["bias"])
    _dense(sd, "branch.fc.3", br["Dense_1"])
    for i, dst in enumerate(("trunk.fc.0", "trunk.fc.2", "trunk.fc.4")):
        _dense(sd, dst, params["trunk"][f"Dense_{i}"])
    for src, dst in (("out_fc1", "output_net.0"), ("out_fc2", "output_net.3"),
                     ("out_fc3", "output_net.6")):
        _dense(sd, dst, params[src])
    return sd


def transolver_state_dict(params: dict) -> dict:
    """JAX Transolver3d ``params`` → Transolver3d ``state_dict``."""
    sd = {"placeholder": _t(params["placeholder"])}
    _dense(sd, "preprocess.linear_pre.0", params["preprocess"]["Dense_0"])
    _dense(sd, "preprocess.linear_post", params["preprocess"]["Dense_1"])
    i = 0
    while f"block_{i}" in params:
        blk, pre = params[f"block_{i}"], f"blocks.{i}"
        for ln in ("ln_1", "ln_2", "ln_3"):
            if ln in blk:
                sd[f"{pre}.{ln}.weight"] = _t(blk[ln]["scale"])
                sd[f"{pre}.{ln}.bias"] = _t(blk[ln]["bias"])
        attn = blk["attn"]
        sd[f"{pre}.Attn.temperature"] = _t(attn["temperature"])
        for conv in ("in_project_fx", "in_project_x"):
            _conv(sd, f"{pre}.Attn.{conv}", attn[conv])
        for dense in ("in_project_slice", "to_q", "to_k", "to_v"):
            _dense(sd, f"{pre}.Attn.{dense}", attn[dense])
        _dense(sd, f"{pre}.Attn.to_out.0", attn["to_out"])
        _dense(sd, f"{pre}.mlp.linear_pre.0", blk["mlp"]["Dense_0"])
        _dense(sd, f"{pre}.mlp.linear_post", blk["mlp"]["Dense_1"])
        if "mlp2" in blk:
            _dense(sd, f"{pre}.mlp2", blk["mlp2"])
        i += 1
    return sd


def dpot_state_dict(params: dict) -> dict:
    """JAX DPOT ``params`` (``model_type`` dpot or dpot3d) → DPOT
    ``state_dict``: the exporter's ``dpot_model.``-prefixed layout. The
    exporter refuses dpot3d; its keys here follow the 2-D model's, with
    the position embedding [1, hx, wy, lz, E] → [1, E, hx, wy, lz]."""
    net, sd = params["dpot_model"], {}
    pos = np.asarray(net["pos_embed"])
    sd["pos_embed"] = _t(np.moveaxis(pos, -1, 1))
    _conv(sd, "patch_embed.proj.0", net["patch_proj1"])
    _conv(sd, "patch_embed.proj.2", net["patch_proj2"])
    sd["time_agg_layer.w"] = _t(net["time_agg_w"])
    if "time_agg_gamma" in net:
        sd["time_agg_layer.gamma"] = _t(net["time_agg_gamma"])
    for f in ("scale_feats_mu", "scale_feats_sigma"):
        if f in net:
            _dense(sd, f, net[f])
    i = 0
    while f"block_{i}" in net:
        blk, pre = net[f"block_{i}"], f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{pre}.{norm}.weight"] = _t(blk[norm]["scale"])
            sd[f"{pre}.{norm}.bias"] = _t(blk[norm]["bias"])
        for w in ("w1", "b1", "w2", "b2"):
            sd[f"{pre}.filter.{w}"] = _t(blk["filter"][w])
        _conv(sd, f"{pre}.mlp.0", blk["mlp1"])
        _conv(sd, f"{pre}.mlp.2", blk["mlp2"])
        i += 1
    for src, dst in (("cls1", "cls_head.0"), ("cls2", "cls_head.2"), ("cls3", "cls_head.4")):
        _dense(sd, dst, net[src])
    _conv(sd, "out_layer.0", net["out_deconv"])
    _conv(sd, "out_layer.2", net["out_conv1"])
    _conv(sd, "out_layer.4", net["out_conv2"])
    return {f"dpot_model.{k}": v for k, v in sd.items()}


def _bn(sd, key, p, stats) -> None:
    """A BatchNorm's scale, bias and running statistics, and the counter
    every torch BatchNorm carries."""
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(stats["mean"])
    sd[f"{key}.running_var"] = _t(stats["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _cno_act(sd, key, p) -> None:
    """The lrelu mode's bias a channel, which the exporter does not write,
    under the port's name ``<block>.activation.bias``."""
    if "act" in p and "bias" in p["act"]:
        sd[f"{key}.activation.bias"] = _t(p["act"]["bias"])


def cno_state_dict(params: dict, batch_stats: dict) -> dict:
    """JAX CNO3d ``params`` and ``batch_stats`` → CNO3d ``state_dict``: the
    exporter's keys (its level resnets ``res_{l}_{j}`` at
    ``res_nets.{l·N_res + j}``, which is the exporter's order at its
    N_res 1, then ``res_neck_{j}`` by name), plus the lrelu mode's
    ``<block>.activation.bias``."""
    sd = {}
    for name in ("lift", "project"):
        p = params[name]
        _conv(sd, f"{name}.inter_CNOBlock.convolution", p["inter"]["convolution"])
        _cno_act(sd, f"{name}.inter_CNOBlock", p["inter"])
        _conv(sd, f"{name}.convolution", p["convolution"])

    def block(name, key):
        p = params[name]
        _conv(sd, f"{key}.convolution", p["convolution"])
        if "bn" in p:
            _bn(sd, f"{key}.batch_norm", p["bn"], batch_stats[name]["bn"])
        _cno_act(sd, key, p)

    n_layers = 0
    while f"encoder_{n_layers}" in params:
        n_layers += 1
    for i in range(n_layers):
        block(f"encoder_{i}", f"encoder.{i}")
        block(f"decoder_{i}", f"decoder.{i}")
        if f"decoder_inv_{i}" in params:
            block(f"decoder_inv_{i}", f"decoder_inv.{i}")
    for i in range(n_layers + 1):
        block(f"ed_expansion_{i}", f"ED_expansion.{i}")

    def res(name, key):
        p = params[name]
        for k in ("1", "2"):
            _conv(sd, f"{key}.convolution{k}", p[f"convolution{k}"])
            if f"bn{k}" in p:
                _bn(sd, f"{key}.batch_norm{k}", p[f"bn{k}"], batch_stats[name][f"bn{k}"])
        _cno_act(sd, key, p)

    n_res = 0
    while f"res_0_{n_res}" in params:
        n_res += 1
    for l in range(n_layers):
        for j in range(n_res):
            res(f"res_{l}_{j}", f"res_nets.{l * n_res + j}")
    j = 0
    while f"res_neck_{j}" in params:
        res(f"res_neck_{j}", f"res_nets.{n_layers * n_res + j}")
        j += 1
    return sd


def mwt_state_dict(params: dict) -> dict:
    """JAX MWT3d ``params`` → MWT3d ``state_dict`` (``MWT_CZ.i`` with its
    Fourier kernel ``A`` (complex ``weights1..4``, ``Lo``), conv kernels
    ``B`` and ``C`` (``conv.0``, ``Lo``) and ``T0``; ``Lk``, ``Lc0``,
    ``Lc1``)."""
    sd = {}
    for k in ("Lk", "Lc0", "Lc1"):
        _dense(sd, k, params[k])
    i = 0
    while f"cz_{i}" in params:
        cz, pre = params[f"cz_{i}"], f"MWT_CZ.{i}"
        w = (np.asarray(cz["A"]["w_real"]).astype(np.complex64)
             + 1j * np.asarray(cz["A"]["w_imag"]).astype(np.complex64))
        w = w.transpose(0, 4, 5, 1, 2, 3)
        for k in range(4):
            sd[f"{pre}.A.weights{k + 1}"] = _t(w[k])
        _dense(sd, f"{pre}.A.Lo", cz["A"]["Lo"])
        for mod in ("B", "C"):
            _conv(sd, f"{pre}.{mod}.conv.0", cz[mod]["conv"])
            _dense(sd, f"{pre}.{mod}.Lo", cz[mod]["Lo"])
        _dense(sd, f"{pre}.T0", cz["T0"])
        i += 1
    return sd


def _dense(sd, key, p) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _conv(sd, key, p) -> None:
    """flax [*K, I, O] → torch [O, I, *K]; the same permutation takes a
    ConvTranspose's [*K, O, I] to torch's [I, O, *K]."""
    w = np.asarray(p["kernel"])
    n = w.ndim
    sd[f"{key}.weight"] = _t(w.transpose((n - 1, n - 2, *range(n - 2))))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _resnet(sd, key, p) -> None:
    for blk in ("block1", "block2"):
        _conv(sd, f"{key}.{blk}.proj", p[blk]["proj"])
        sd[f"{key}.{blk}.norm.weight"] = _t(p[blk]["norm"]["scale"])
        sd[f"{key}.{blk}.norm.bias"] = _t(p[blk]["norm"]["bias"])
    if "mlp" in p:
        _dense(sd, f"{key}.mlp.1", p["mlp"])
    if "res_conv" in p:
        _conv(sd, f"{key}.res_conv", p["res_conv"])


def _gamma(sd, key, norm) -> None:
    sd[f"{key}.fn.norm.gamma"] = _t(np.asarray(norm["gamma"]).reshape(1, -1, 1, 1, 1))


def _attention(sd, key, norm, attn, conv: bool) -> None:
    """Residual(PreNorm(attention)): the token attentions sit one wrapper
    deeper (``fn.fn.fn``) than the spatial linear one (``fn.fn``)."""
    _gamma(sd, key, norm)
    put, inner = (_conv, "fn.fn") if conv else (_dense, "fn.fn.fn")
    put(sd, f"{key}.{inner}.to_qkv", attn["to_qkv"])
    put(sd, f"{key}.{inner}.to_out", attn["to_out"])


def unet_state_dict(params: dict) -> dict:
    """JAX Unet3d ``params`` → Unet3d ``state_dict``."""
    p, sd = params, {}
    _conv(sd, "init_conv", p["init_conv"])
    _attention(sd, "init_temporal_attn", p["init_attn_norm"],
               p["init_temporal_attn"], conv=False)
    sd["time_rel_pos_bias.relative_attention_bias.weight"] = _t(
        p["time_rel_pos_bias"]["embedding"])
    _dense(sd, "time_mlp.1", p["time_mlp_1"])
    _dense(sd, "time_mlp.3", p["time_mlp_2"])
    for path, resample in (("down", "downsample"), ("up", "upsample")):
        i = 0
        while f"{path}_{i}_block1" in p:
            key, pre = f"{path}s.{i}", f"{path}_{i}_"
            _resnet(sd, f"{key}.0", p[pre + "block1"])
            _resnet(sd, f"{key}.1", p[pre + "block2"])
            if pre + "spatial_attn" in p:
                _attention(sd, f"{key}.2", p[pre + "spatial_norm"],
                           p[pre + "spatial_attn"], conv=True)
            _attention(sd, f"{key}.3", p[pre + "temporal_norm"],
                       p[pre + "temporal_attn"], conv=False)
            if pre + resample in p:
                _conv(sd, f"{key}.4", p[pre + resample])
            i += 1
    _resnet(sd, "mid_block1", p["mid_block1"])
    _attention(sd, "mid_spatial_attn", p["mid_spatial_norm"],
               p["mid_spatial_attn"], conv=False)
    _attention(sd, "mid_temporal_attn", p["mid_temporal_norm"],
               p["mid_temporal_attn"], conv=False)
    _resnet(sd, "mid_block2", p["mid_block2"])
    _resnet(sd, "final_conv.0", p["final_block"])
    _conv(sd, "final_conv.1", p["final_conv"])
    return sd


def wdno_state_dict(params: dict, beta_schedule: str = "sigmoid",
                    timesteps: int = 1000) -> dict:
    """JAX WDNO ``params`` (its Unet3d's) → WDNO ``state_dict``: the
    backbone's keys under the reference's ``model.`` prefix, plus the DDPM
    schedule's buffers recomputed from its name and length, as
    ``export_wdno`` writes them (the rescaler is no entry: it has its own
    cache file)."""
    from realpdebench_tpu_torch.models.wdno import DiffusionSchedule

    sd = {f"model.{k}": v for k, v in unet_state_dict(params).items()}
    for k, v in DiffusionSchedule.create(beta_schedule, timesteps).buffers().items():
        sd[k] = _t(v)
    return sd
