"""Every shipped config against the limits of the kernels it would launch,
on the CPU, without a card.

For each of the port's configs (``realpdebench_tpu_torch/configs``: five
scenarios' twelve and the combustion surrogate's two) at its scenario's
real window, in its shipped dtype (``compute_dtype``, f32 where null):

* the FNO's seven kernels: K1, the T-stage, K2, K2A-lite (the geometry's
  lite statics exist), K12B, K3F and K3B each choose their redesigned
  variant (tf32 in f32, mma in bf16; the T-stage ``registers``), and the
  fused tail's own checks (``kernels._tail_checks``, on meta tensors of the
  step's shapes) take fc2's width F = c_out·mult;
* the UNet's and WDNO's temporal attention: TA forward and backward choose
  their tensor-core variant at the T, heads and head width the model runs
  them at (WDNO's child U-Net on the padded wavelet coefficients);
* the Galerkin Transformer's scores: the mma variant at its head width;
* every other family launches no kernel of the port's.

The combustion FNO at F 16 is the case this would have caught before its
fused tail took two n-tiles of fc2.
"""

import inspect
from pathlib import Path

import pytest
import torch

from realpdebench_tpu_torch.config import load_config
from realpdebench_tpu_torch.models.unet import Unet3d
from realpdebench_tpu_torch.ops import fno_layer as fl
from realpdebench_tpu_torch.ops import kernels
from realpdebench_tpu_torch.ops.wavelet import coef_len

CONFIGS = Path(__file__).resolve().parents[1] / "realpdebench_tpu_torch" / "configs"
PATHS = sorted(str(p.relative_to(CONFIGS)) for p in CONFIGS.rglob("*.yaml"))
# the scenarios' windows (in, out) at the shipped in/out_step (as
# tests/test_torch_deeponet.py): fluid data u, v, p; controlled_cylinder
# adds its two parameter planes to the input; combustion carries 16
# channels; the surrogate maps 17 channels of 20x128x128 to 1
WINDOWS = {
    "combustion": ((20, 64, 64, 16), (20, 64, 64, 16)),
    "controlled_cylinder": ((10, 64, 128, 5), (10, 64, 128, 3)),
    "cylinder": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "foil": ((20, 64, 128, 3), (20, 64, 128, 3)),
    "fsi": ((20, 64, 64, 3), (20, 64, 64, 3)),
    "surrogate": ((20, 128, 128, 17), (20, 128, 128, 1)),
}
KERNEL_FREE = {"cno", "deeponet", "dmd", "dpot", "mwt", "transolver"}
FNO_PADDING = 6       # the registry's default


def test_every_config_is_covered():
    assert len(PATHS) == 62
    assert {p.split("/")[0] for p in PATHS} == set(WINDOWS) - {"surrogate"}


def _fno(cfg, si, so, dtype, tc):
    C, m1, m2, m3 = cfg["width"], cfg["modes1"], cfg["modes2"], cfg["modes3"]
    p = cfg.get("padding", FNO_PADDING)
    T, H, W = si[:3]
    Tp, Hp, Wp = T + p, H + p, W + p
    F = so[-1] * (so[0] // si[0])
    assert kernels.k1_variant(dtype, C, 2 * m2, m3, Wp) == tc
    assert kernels.k2_variant(dtype, C, m3, Wp, 2 * m2) == tc
    assert fl._lite_or_none(Hp, Wp, m2, m3) is not None       # K2A-lite, not K2A
    assert kernels.k2a_lite_variant(dtype, C, 2 * m2, m3, Wp) == tc
    assert kernels.k12b_variant(dtype, C, 2 * m2, m3, Wp) == tc
    for tin, tout in ((Tp, 2 * m1), (2 * m1, Tp)):
        assert kernels.t_stage_variant(dtype, C, tin, tout) == "registers"
    assert kernels.k3f_variant(dtype, C, F) == kernels.k3b_variant(dtype, C, F) == tc
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device="meta")
    B = 1
    ints = kernels._tail_checks(
        meta(B * Tp, Hp * Wp // 2, 2 * C, dt=dtype), meta(B, T, H, W, F), meta(C, 128),
        meta(128), meta(128, F), meta(F), (B, Tp, Hp, Wp, C), (T, H, W), "exact")
    assert ints[-1] == F
    return F


def _ta(dtype, tc, T, heads, d):
    assert kernels.ta_fwd_variant(dtype, T, heads, d) == tc
    assert kernels.ta_bwd_variant(dtype, T, heads, d) == tc


def _unet_heads():
    sig = inspect.signature(Unet3d).parameters
    return sig["attn_heads"].default, sig["attn_dim_head"].default


@pytest.mark.parametrize("path", PATHS)
def test_a_shipped_config_takes_its_kernels(path):
    cfg = load_config(path).to_dict()
    scenario = "surrogate" if "surrogate_model" in path else path.split("/")[0]
    si, so = WINDOWS[scenario]
    dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else torch.float32
    tc = "mma" if dtype == torch.bfloat16 else "tf32"
    name = cfg["model_name"]
    if name == "fno":
        F = _fno(cfg, si, so, dtype, tc)
        if path == "combustion/fno.yaml":
            assert F == 16 and cfg["width"] == 64
    elif name == "unet":
        _ta(dtype, tc, so[0], *_unet_heads())
    elif name == "wdno":
        pf = 2 ** len(cfg.get("dim_mults", (1, 2)))
        n = coef_len(si[0], cfg.get("wave_type", "bior1.3"))
        _ta(dtype, tc, -(-n // pf) * pf, *_unet_heads())
    elif name == "galerkin_transformer":
        d = cfg["n_hidden"] // cfg["n_head"]
        assert kernels.gk_scores_variant(dtype, d) == "mma"
    else:
        assert name in KERNEL_FREE, name
