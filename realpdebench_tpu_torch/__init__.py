"""RealPDEBench in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``realpdebench_tpu`` (JAX/Pallas on TPU), module for module: each
file here has the same path as its counterpart there. The JAX package is the
reference the port is tested against; this package never imports it, nor JAX.

What is ported so far is the FNO3d, UNet3d and Galerkin Transformer
families with the user's path around them: ``python -m
realpdebench_tpu_torch train|eval|convert|download`` (``cli.py``) on an
HDF5 or a Hugging Face Arrow dataset tree, with the config system, the
data layer (``data/``), the training loop of
the three paradigms with validation and checkpoints (``train/loop.py``),
and the evaluation by autoregressive rollout and the 13 metrics
(``eval/``) with its plots. On a CUDA device the models' hot paths run through the
kernels in ``csrc/`` (built with nvcc on first use, see
``ops/kernels.py``); on the CPU they run through each kernel's plain
PyTorch twin beside its wrapper in ``ops/``. The entry points run on the
card unless given ``--device cpu``. ``ROADMAP.md`` lists what is left.
"""

__version__ = "0.1.0"

# The data contract this package implements: the reference's, which the JAX
# package carries as its own version (realpdebench_tpu.__version__). A
# dataset's version.json names the oldest code it works with
# (``min_code_version``); the port is held to this version, not to its own
# package version, so it takes exactly the data the JAX package takes.
DATA_CONTRACT_VERSION = "0.2.0"


def _parse_version(v):
    parts = []
    for p in str(v).split("."):
        num = ""
        for ch in p:
            if ch.isdigit():
                num += ch
            else:
                break
        parts.append(int(num) if num else 0)
    while len(parts) < 3:
        parts.append(0)
    return tuple(parts[:3])


def check_data_version(dataset_root):
    """Validate ``version.json`` under ``dataset_root`` against the data
    contract this package implements (``DATA_CONTRACT_VERSION``).

    Counterpart of ``realpdebench_tpu.check_data_version`` (reference
    realpdebench/__init__.py:10-71): the file carries ``{"data_version":
    ..., "min_code_version": ...}``; a dataset whose ``min_code_version`` is
    newer than the contract is refused. A missing file is tolerated
    (local/synthetic data trees).

    Returns a dict with keys ``ok``, ``data_version``, ``min_code_version``,
    ``message``.
    """
    import json
    import os

    path = os.path.join(dataset_root, "version.json")
    if not os.path.exists(path):
        return {
            "ok": True,
            "data_version": None,
            "min_code_version": None,
            "message": "no version.json found; skipping data-version check",
        }
    with open(path) as f:
        info = json.load(f)
    data_version = info.get("data_version")
    min_code = info.get("min_code_version", "0.0.0")
    ok = _parse_version(DATA_CONTRACT_VERSION) >= _parse_version(min_code)
    msg = (
        f"data_version={data_version}, requires code >= {min_code}; "
        f"implemented {DATA_CONTRACT_VERSION} -> {'OK' if ok else 'TOO OLD'}"
    )
    if not ok:
        raise RuntimeError(
            f"Dataset at {dataset_root} requires realpdebench >= {min_code}, but "
            f"realpdebench_tpu_torch {__version__} implements "
            f"{DATA_CONTRACT_VERSION}. Please upgrade."
        )
    return {
        "ok": ok,
        "data_version": data_version,
        "min_code_version": min_code,
        "message": msg,
    }
