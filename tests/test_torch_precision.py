"""The port's float32 is full float32 (no TF32), on the CPU.

The JAX package computes its float32 products in full float32; PyTorch's
default lets cuDNN's convolutions run in single-pass TF32. Every model the
port builds goes through ``models.registry.build_model``, which pins the
library calls to full float32 (``utils.misc.set_f32_precision``):
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False, the float32 matmul precision
"highest". Held here for each family's ``build_model`` and for the train
and eval entry points, each after a caller set the looser modes.
"""

import glob
import os

import pytest
import torch

from realpdebench_tpu_torch.models.registry import build_model
from realpdebench_tpu_torch.utils.misc import make_generator

S = (4, 16, 16, 3)
FAMILIES = {
    "fno": dict(model_name="fno", modes1=2, modes2=2, modes3=2, n_layers=1, width=8),
    "unet": dict(model_name="unet", dim_mults=[1, 2]),
    "galerkin_transformer": dict(model_name="galerkin_transformer", n_hidden=16, n_head=2,
                                 num_encoder_layers=1, dim_feedforward=8,
                                 fourier_modes_x=2, fourier_modes_y=2,
                                 fourier_modes_t=2, freq_dim=8),
    "deeponet": dict(model_name="deeponet", p=8),
    "transolver": dict(model_name="transolver", space_dim=3, n_layers=1, n_hidden=8,
                       n_head=2, H=16, W=16, D=4, fun_dim=0, out_dim=3, slice_num=4),
}


def _state():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


EXACT = (False, False, "highest")


@pytest.fixture
def loosened():
    """The looser modes a caller may have set (PyTorch's default for cuDNN,
    TF32 for cuBLAS); the state before is restored afterwards."""
    before = _state()

    def loosen():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        assert _state() != EXACT

    yield loosen
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
    torch.set_float32_matmul_precision(before[2])


@pytest.mark.parametrize("family", FAMILIES)
def test_build_model_pins_full_f32(loosened, family):
    loosened()
    build_model(shapes=(S, S), device="cpu", generator=make_generator(0), **FAMILIES[family])
    assert _state() == EXACT


def test_train_and_eval_entry_points_leave_full_f32(loosened, tmp_path):
    from realpdebench_tpu_torch.cli import main
    from realpdebench_tpu_torch.data.synthetic import make_fluid_tree

    root = str(tmp_path / "data")
    make_fluid_tree(root, "cylinder", n_sim=5, n_frame=32, h=16, w=16)
    common = ["--config", "cylinder/fno.yaml", "--dataset_root", root, "--device", "cpu",
              "--results_path", str(tmp_path), "--num_workers", "0",
              "--train_batch_size", "4", "--test_batch_size", "4", "--N_autoregressive", "1",
              "--N_plot", "0", "--N_plot_probe", "0", "--is_use_tb", "false",
              "--num_update", "1", "--modes1", "2", "--modes2", "2", "--modes3", "2",
              "--n_layers", "1", "--width", "8", "--in_step", "4", "--out_step", "4",
              "--interval", "4", "--trunk_length", "8", "--n_sim_frame", "32",
              "--n_sim_in_distribution", "1", "--n_sim_out_distribution", "1",
              "--sub_s_real", "1", "--sub_s_numerical", "1", "--generate_ids_if_missing"]
    loosened()
    with pytest.raises(SystemExit) as e:
        main(["train", *common])
    assert e.value.code == 0 and _state() == EXACT
    (ckpt,) = glob.glob(os.path.join(str(tmp_path), "fno", "*_numerical_False", "*", "ckpt"))
    loosened()
    with pytest.raises(SystemExit) as e:
        main(["eval", *common, "--checkpoint_path", ckpt])
    assert e.value.code == 0 and _state() == EXACT
