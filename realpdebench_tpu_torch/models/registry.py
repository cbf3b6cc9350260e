"""Model factory: name + config + data shapes → model.

Counterpart of ``realpdebench_tpu/models/registry.py``, with the same
keyword names (the flat YAML config namespace). It returns the
``nn.Module`` itself: in the port a module owns its parameters, so there is
no separate bundle.
"""

from __future__ import annotations

import torch

from realpdebench_tpu_torch.models.base import Model
from realpdebench_tpu_torch.utils.misc import set_f32_precision

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def resolve_device(device, what: str = "build_model builds") -> torch.device:
    """``device``, or the card when it is None; never a silent CPU. A CUDA
    device where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} on the CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def build_model(train_dataset=None, shapes=None, *, device=None,
                generator: torch.Generator | None = None, **kwargs) -> Model:
    """Build a model on ``device`` (None: the CUDA device, and an error where
    there is none) with weights drawn from ``generator``.

    Pass ``train_dataset`` (shapes probed from item 0) or explicit
    ``shapes=(shape_in, shape_out)``. The remaining kwargs are the config
    namespace of the JAX registry. ``remat`` is honoured for ``unet``
    and ``cno`` (default true, as in the JAX registry: their blocks are
    rematerialised in the backward) and ``dpot`` (default false, as
    there); ``fno`` and ``galerkin_transformer``
    accept it and ignore it: their f32 steps fit an 80 GB card at the
    shipped batches; ``mwt`` ignores it, as the JAX registry does. The
    TPU-only switches (``use_pallas``,
    ``pallas_interpret``, ``seq_mesh``) are accepted and have no effect: on
    a CUDA device the model always runs the kernels. ``wdno`` computes its
    wavelet rescaler from ``train_dataset`` (cached beside the data, as the
    JAX package caches it), or takes ones without it; ``dmd`` has no
    parameters and computes on the host.

    Every call pins the library calls' float32 precision to full float32
    (``utils.misc.set_f32_precision``), as the JAX package computes them:
    the train and eval entry points, and any other caller, build here.
    """
    set_f32_precision()
    model_name = kwargs["model_name"]
    if shapes is None:
        x0, y0 = train_dataset[0]
        shape_in, shape_out = tuple(x0.shape), tuple(y0.shape)
    else:
        shape_in, shape_out = tuple(shapes[0]), tuple(shapes[1])
    compute_dtype = _DTYPES[kwargs.get("compute_dtype")]

    if model_name == "fno":
        from realpdebench_tpu_torch.models.fno import FNO3d

        return FNO3d(
            modes1=kwargs["modes1"], modes2=kwargs["modes2"],
            modes3=kwargs["modes3"], n_layers=kwargs["n_layers"],
            width=kwargs["width"], shape_in=shape_in, shape_out=shape_out,
            compute_dtype=compute_dtype, device=resolve_device(device),
            generator=generator)
    if model_name == "unet":
        from realpdebench_tpu_torch.models.unet import Unet3d

        # dim is H, as in the JAX registry and the reference
        return Unet3d(
            dim=shape_in[1], out_channels=shape_out[-1],
            dim_mults=tuple(kwargs["dim_mults"]), channels=shape_in[-1],
            in_time=shape_in[0], out_time=shape_out[0],
            compute_dtype=compute_dtype, remat=bool(kwargs.get("remat", True)),
            device=resolve_device(device), generator=generator)
    if model_name == "galerkin_transformer":
        from realpdebench_tpu_torch.models.galerkin_transformer import (
            GalerkinTransformer3d,
        )

        # the JAX registry's defaults and key names; the run's seed seeds
        # the dropout stream
        return GalerkinTransformer3d(
            shape_in=shape_in, shape_out=shape_out,
            n_hidden=kwargs.get("n_hidden", 96),
            num_encoder_layers=kwargs.get("num_encoder_layers", 4),
            n_head=kwargs.get("n_head", 4),
            dim_feedforward=kwargs.get("dim_feedforward", 192),
            attention_type=kwargs.get("attention_type", "galerkin"),
            layer_norm=bool(kwargs.get("layer_norm", False)),
            attn_norm=bool(kwargs.get("attn_norm", True)),
            norm_eps=float(kwargs.get("norm_eps", 1e-5)),
            modes1=kwargs.get("fourier_modes_x", 16),
            modes2=kwargs.get("fourier_modes_y", 20),
            modes3=kwargs.get("fourier_modes_t", 4),
            spectral_layers=kwargs.get("num_regressor_layers", 1),
            freq_dim=kwargs.get("freq_dim", 128),
            dropout=float(kwargs.get("encoder_dropout", 0.05) or 0.0),
            xavier_init=float(kwargs.get("xavier_init", 1e-2)),
            diagonal_weight=float(kwargs.get("diagonal_weight", 1e-2)),
            reference_eval_dropout=bool(kwargs.get("reference_eval_dropout", False)),
            compute_dtype=compute_dtype, device=resolve_device(device),
            generator=generator,
            dropout_seed=int(kwargs.get("seed", 0)))
    if model_name == "deeponet":
        from realpdebench_tpu_torch.models.deeponet import DeepONet

        # the JAX registry's keys and defaults; the run's seed seeds the
        # dropout stream
        return DeepONet(
            shape_in=shape_in, shape_out=shape_out, p=kwargs["p"],
            dropout_rate=kwargs.get("dropout_rate", 0.0),
            compute_dtype=compute_dtype, device=resolve_device(device),
            generator=generator, dropout_seed=int(kwargs.get("seed", 0)))
    if model_name == "transolver":
        from realpdebench_tpu_torch.models.transolver import Transolver3d

        # the JAX registry's keys and defaults. As there, no ``dropout`` is
        # passed: the shipped configs' ``dropout: 0.1`` is ignored and the
        # model runs without dropout (a finding of the reference side, kept)
        return Transolver3d(
            space_dim=kwargs["space_dim"], n_layers=kwargs["n_layers"],
            n_hidden=kwargs["n_hidden"], n_head=kwargs["n_head"],
            H=kwargs["H"], W=kwargs["W"], D=kwargs["D"],
            fun_dim=kwargs["fun_dim"], out_dim=kwargs["out_dim"],
            ref=kwargs.get("ref", 8), mlp_ratio=kwargs.get("mlp_ratio", 1),
            slice_num=kwargs.get("slice_num", 32),
            unified_pos=bool(kwargs.get("unified_pos", False)),
            shape_in=shape_in, shape_out=shape_out, compute_dtype=compute_dtype,
            device=resolve_device(device), generator=generator)
    if model_name == "dpot":
        from realpdebench_tpu_torch.models.dpot import DPOT

        # the JAX registry's keys and defaults; ``remat`` defaults to false
        # there and here. On the meta device the model has shapes only.
        return DPOT(
            shape_in=shape_in, shape_out=shape_out,
            model_type=kwargs.get("model_type", "dpot"), img_size=kwargs["img_size"],
            in_channels=kwargs["in_channels"], out_channels=kwargs["out_channels"],
            in_timesteps=kwargs["in_timesteps"], out_timesteps=kwargs["out_timesteps"],
            patch_size=kwargs["patch_size"], embed_dim=kwargs["embed_dim"],
            depth=kwargs["depth"], n_blocks=kwargs["n_blocks"], modes=kwargs["modes"],
            mlp_ratio=kwargs["mlp_ratio"], out_layer_dim=kwargs["out_layer_dim"],
            normalize=bool(kwargs.get("normalize", False)), act=kwargs.get("act", "gelu"),
            time_agg=kwargs.get("time_agg", "exp_mlp"), n_cls=int(kwargs.get("n_cls", 1)),
            compute_dtype=compute_dtype, remat=bool(kwargs.get("remat", False)),
            device=resolve_device(device), generator=generator)
    if model_name == "mwt":
        from realpdebench_tpu_torch.models.mwt import MWT3d

        # the JAX registry's keys and defaults; ``remat`` is ignored there
        # and here
        return MWT3d(
            ich=kwargs.get("ich", shape_in[-1]), shape_in=shape_in, shape_out=shape_out, k=kwargs.get("k", 3),
            alpha=kwargs.get("alpha", 8), c=kwargs.get("c", 3), nCZ=kwargs.get("nCZ", 4),
            L=kwargs.get("L", 0), base=kwargs.get("base", "legendre"),
            compute_dtype=compute_dtype, device=resolve_device(device), generator=generator)
    if model_name == "cno":
        from realpdebench_tpu_torch.models.cno import CNO3d

        t_in, t_out = shape_in[0], shape_out[0]
        if t_out > t_in and t_out % t_in == 0:
            out_dim_mult = t_out // t_in
        elif t_out == t_in:
            out_dim_mult = 1
        else:
            raise ValueError(f"T_out {t_out} incompatible with T_in {t_in}")

        def _int(key, default):
            # the shipped YAMLs carry trailing commas ("N_res: 1," reads as a
            # string): those keys take the model's default, as in the JAX
            # registry (so N_res_neck is 6 where the YAML shows 8)
            try:
                return int(kwargs.get(key, default))
            except (TypeError, ValueError):
                return default

        # the JAX registry's keys and defaults; in_size is W (shape_in[2]),
        # which only the lrelu mode's geometry reads; remat on by default
        return CNO3d(
            in_dim=shape_in[-1], out_dim=shape_out[-1], out_dim_mult=out_dim_mult,
            in_size=shape_in[2], N_layers=kwargs["N_layers"], N_res=_int("N_res", 1),
            N_res_neck=_int("N_res_neck", 6),
            channel_multiplier=_int("channel_multiplier", 32),
            latent_lift_proj_dim=_int("latent_lift_proj_dim", 64),
            activation=kwargs.get("activation", "LeakyReLU"), shape_in=shape_in,
            shape_out=shape_out, remat=bool(kwargs.get("remat", True)),
            compute_dtype=compute_dtype, device=resolve_device(device), generator=generator)
    if model_name == "wdno":
        from realpdebench_tpu_torch.models.wdno import WDNO, compute_wdno_rescaler

        # the JAX registry's keys and defaults; remat on by default
        dev = resolve_device(device)
        wave_type = kwargs.get("wave_type", "bior1.3")
        rescaler = None
        if train_dataset is not None:
            rescaler = compute_wdno_rescaler(
                train_dataset, wave_type, kwargs.get("pad_mode", "zero"),
                kwargs["dataset_root"], kwargs["dataset_name"], device=dev)
        return WDNO(
            shape_in=shape_in, shape_out=shape_out, dim=int(kwargs["dim"]),
            dim_mults=tuple(kwargs.get("dim_mults", (1, 2))), wave_type=wave_type,
            beta_schedule=kwargs.get("beta_schedule", "sigmoid"),
            timesteps=int(kwargs.get("timesteps", 1000)),
            sampling_timesteps=int(kwargs.get("sampling_timesteps") or 1000),
            ddim_eta=float(kwargs.get("ddim_sampling_eta", 0.0) or 0.0),
            rescaler=rescaler, compute_dtype=compute_dtype,
            remat=bool(kwargs.get("remat", True)), seed=int(kwargs.get("seed", 0)),
            device=dev, generator=generator)
    if model_name == "dmd":
        from realpdebench_tpu_torch.models.dmd import DMD

        # no parameters: the device only says where its forecasts go
        return DMD(n_modes=kwargs["n_modes"], n_predict=kwargs["n_predict"],
                   input_feature=kwargs["input_feature"],
                   n_autoregressive=kwargs["N_autoregressive"],
                   shape_out=shape_out).to(resolve_device(device))
    raise ValueError(f"Model {model_name} not supported")
