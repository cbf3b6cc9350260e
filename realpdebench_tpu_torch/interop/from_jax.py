"""JAX parameters → the port's ``state_dict``.

Counterpart of ``realpdebench_tpu/interop/torch_export.py`` (the FNO
exporter, ``export_fno``): the same key names and conventions, producing
torch tensors that ``FNO3d.load_state_dict(..., strict=True)`` takes.
Inputs are the JAX ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays, so this module needs no JAX.

Conventions: a flax Dense kernel [in, out] becomes a Linear weight
[out, in]; the channels-minor corner weights (w_real, w_imag)
[4, m1, m2, m3, C_in, C_out] become complex ``weights1..4``
[C_in, C_out, m1, m2, m3]; the pointwise kernel [C_in, C_out] becomes a
1x1x1 Conv3d weight [C_out, C_in, 1, 1, 1]; BatchNorm scale/bias and
running mean/var map to weight/bias and running_mean/running_var, plus the
``num_batches_tracked`` counter every torch BatchNorm carries.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C"))   # a copy the port owns


def fno_state_dict(params: dict, batch_stats: dict) -> dict:
    """JAX FNO3d ``params`` and ``batch_stats`` → FNO3d ``state_dict``."""
    sd = {}
    for k in ("fc0", "fc1", "fc2"):
        sd[f"{k}.weight"] = _t(np.asarray(params[k]["kernel"]).T)
        sd[f"{k}.bias"] = _t(params[k]["bias"])
    i = 0
    while f"layer_{i}" in params:
        lp, bs = params[f"layer_{i}"], batch_stats[f"layer_{i}"]["bn"]
        spec = lp["spectral"]
        w = (np.asarray(spec["w_real"]).astype(np.complex64)
             + 1j * np.asarray(spec["w_imag"]).astype(np.complex64))
        w = w.transpose(0, 4, 5, 1, 2, 3)
        for k in range(4):
            sd[f"spectral_convs.{i}.weights{k + 1}"] = _t(w[k])
        kern = np.asarray(lp["pointwise"]["kernel"])
        sd[f"convs.{i}.weight"] = _t(kern.T[:, :, None, None, None])
        sd[f"convs.{i}.bias"] = _t(lp["pointwise"]["bias"])
        sd[f"bns.{i}.weight"] = _t(lp["bn"]["scale"])
        sd[f"bns.{i}.bias"] = _t(lp["bn"]["bias"])
        sd[f"bns.{i}.running_mean"] = _t(bs["mean"])
        sd[f"bns.{i}.running_var"] = _t(bs["var"])
        sd[f"bns.{i}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        i += 1
    return sd
