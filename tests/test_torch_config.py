"""PyTorch port vs JAX package: the config system, on the CPU.

The port's 52 configs (fno, unet, galerkin_transformer, deeponet,
transolver, trainsolver, dpot_s, dpot_l, cno, mwt × five scenarios, and
the combustion surrogate's fno and unet) are the JAX package's files byte for
byte; ``merge_config`` gives the JAX
package's dict for the same argv (the port adds ``device``); config names
resolve inside the port's own tree; ``--key value`` overrides are read as
YAML and win over the file.
"""

import os

import pytest

from realpdebench_tpu import config as jc
from realpdebench_tpu_torch import config as tc

SCENARIOS = ("combustion", "controlled_cylinder", "cylinder", "foil", "fsi")
MODELS = ("fno", "unet", "galerkin_transformer", "deeponet", "transolver", "trainsolver",
          "dpot_s", "dpot_l", "cno", "mwt")
NAMES = [f"{s}/{m}.yaml" for s in SCENARIOS for m in MODELS] + [
    f"combustion/surrogate_model/{m}.yaml" for m in ("fno", "unet")]
JAX_CONFIGS = os.path.join(os.path.dirname(jc.__file__), "configs")
PORT_CONFIGS = os.path.join(os.path.dirname(tc.__file__), "configs")


def test_the_port_ships_the_configs_of_its_families():
    got = sorted(os.path.relpath(os.path.join(d, f), PORT_CONFIGS)
                 for d, _, fs in os.walk(PORT_CONFIGS) for f in fs)
    assert got == sorted(NAMES)


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("model", MODELS)
def test_config_files_equal_jax_byte_for_byte(scenario, model):
    _byte_equal(f"{scenario}/{model}.yaml")


@pytest.mark.parametrize("model", ["fno", "unet"])
def test_surrogate_config_files_equal_jax_byte_for_byte(model):
    _byte_equal(f"combustion/surrogate_model/{model}.yaml")


def _byte_equal(name):
    with open(os.path.join(JAX_CONFIGS, name), "rb") as f:
        ref = f.read()
    with open(os.path.join(PORT_CONFIGS, name), "rb") as f:
        assert f.read() == ref


ARGVS = [
    [],
    ["--train_data_type", "real", "--is_finetune"],
    ["--compute_dtype", "bfloat16", "--mesh_shape", "dp=1"],
    ["--use_hf_dataset", "--hf_revision", "main", "--hf_endpoint", "http://localhost"],
]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "finetune", "dtype", "hf"])
def test_merge_config_equals_jax(name, argv):
    argv = ["--config", name, *argv]
    ref = jc.merge_config(jc.make_arg_parser().parse_args(argv)).to_dict()
    got = tc.merge_config(tc.make_arg_parser().parse_args(argv)).to_dict()
    assert got.pop("device") == "cuda"
    assert os.path.relpath(got.pop("config"), PORT_CONFIGS) == \
        os.path.relpath(ref.pop("config"), JAX_CONFIGS)
    assert got == ref
    loaded = tc.load_config(name, lr=0.5).to_dict()
    assert loaded.pop("config") == tc.resolve_config_path(name)
    want = jc.load_config(name, lr=0.5).to_dict()
    want.pop("config")
    assert loaded == want


def test_config_names_resolve_in_the_port():
    for name in ("cylinder/fno.yaml", "configs/cylinder/fno.yaml"):
        assert tc.resolve_config_path(name) == os.path.join(PORT_CONFIGS, "cylinder", "fno.yaml")
    # a family the port has not reached has no config here
    assert tc.resolve_config_path("cylinder/dmd.yaml") == "cylinder/dmd.yaml"


def test_overrides_are_yaml_and_win_over_the_file():
    parser = tc.make_arg_parser()
    cfg = tc.parse_config(parser, [
        "--config", "cylinder/fno.yaml", "--device", "cpu", "--num_update", "100",
        "--resume", "--checkpoint_path", "null", "--lr=0.5", "--dim_mults", "[1, 2]",
        "--dataset_root", "/data/x", "--compute_dtype", "bfloat16"])
    assert cfg.device == "cpu" and cfg.compute_dtype == "bfloat16"
    assert cfg.num_update == 100 and cfg.resume is True and cfg.checkpoint_path is None
    assert cfg.lr == 0.5 and cfg.dim_mults == [1, 2] and cfg.dataset_root == "/data/x"
    assert cfg.width == 64                  # the file's value where none is given
    with pytest.raises(SystemExit):
        tc.parse_overrides(["stray"])
