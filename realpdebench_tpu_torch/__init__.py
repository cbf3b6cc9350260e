"""RealPDEBench in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``realpdebench_tpu`` (JAX/Pallas on TPU), module for module: each
file here has the same path as its counterpart there. The JAX package is the
reference the port is tested against; this package never imports it, nor JAX.

What is ported so far is the FNO3d, UNet3d and Galerkin Transformer
families with the user's path around them: ``python -m
realpdebench_tpu_torch train|eval`` (``cli.py``) on an HDF5 dataset tree,
with the config system, the data layer (``data/``), the training loop of
the three paradigms with validation and checkpoints (``train/loop.py``),
and the evaluation by autoregressive rollout and the 13 metrics
(``eval/``). On a CUDA device the models' hot paths run through the
kernels in ``csrc/`` (built with nvcc on first use, see
``ops/kernels.py``); on the CPU they run through each kernel's plain
PyTorch twin beside its wrapper in ``ops/``. The entry points run on the
card unless given ``--device cpu``. ``ROADMAP.md`` lists what is left.
"""

__version__ = "0.1.0"
