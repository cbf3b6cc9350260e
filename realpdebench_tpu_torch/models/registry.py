"""Model factory: name + config + data shapes → model.

Counterpart of ``realpdebench_tpu/models/registry.py``, with the same
keyword names (the flat YAML config namespace). It returns the
``nn.Module`` itself: in the port a module owns its parameters, so there is
no separate bundle.
"""

from __future__ import annotations

import torch

from realpdebench_tpu_torch.models.base import Model

# families the JAX registry builds that the port has not reached yet
_NOT_PORTED = ("deeponet", "transolver", "galerkin_transformer", "mwt", "cno",
               "dpot", "wdno", "dmd")

_DTYPES = {None: torch.float32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


def _device(device) -> torch.device:
    """``device``, or the card when it is None; never a silent CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "build_model builds on the CUDA device by default and none is "
            "available; pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def build_model(train_dataset=None, shapes=None, *, device=None,
                generator: torch.Generator | None = None, **kwargs) -> Model:
    """Build a model on ``device`` (None: the CUDA device, and an error where
    there is none) with weights drawn from ``generator``.

    Pass ``train_dataset`` (shapes probed from item 0) or explicit
    ``shapes=(shape_in, shape_out)``. The remaining kwargs are the config
    namespace of the JAX registry; its TPU-only switches (``remat``,
    ``use_pallas``, ``pallas_interpret``) are accepted and have no effect:
    on a CUDA device the model always runs the kernels.
    """
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
            compute_dtype=compute_dtype, device=_device(device),
            generator=generator)
    if model_name == "unet":
        from realpdebench_tpu_torch.models.unet import Unet3d

        # dim is H, as in the JAX registry and the reference
        return Unet3d(
            dim=shape_in[1], out_channels=shape_out[-1],
            dim_mults=tuple(kwargs["dim_mults"]), channels=shape_in[-1],
            in_time=shape_in[0], out_time=shape_out[0],
            compute_dtype=compute_dtype, device=_device(device),
            generator=generator)
    if model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {model_name!r} is not ported to PyTorch yet; ROADMAP.md "
            "(queue A) lists the order in which the families follow")
    raise ValueError(f"Model {model_name} not supported")
