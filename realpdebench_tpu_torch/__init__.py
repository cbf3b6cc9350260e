"""RealPDEBench in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of ``realpdebench_tpu`` (JAX/Pallas on TPU), module for module: each
file here has the same path as its counterpart there. The JAX package is the
reference the port is tested against; this package never imports it, nor JAX.

What is ported so far is the cylinder FNO3d, UNet3d and Galerkin
Transformer, each through ``models.registry.build_model`` →
``eval.rollout.make_rollout_fn`` (the autoregressive rollout) and
``train.make_train_step`` (the training step). On a CUDA device their hot
paths run through the kernels in ``csrc/`` (built with nvcc on first use,
see ``ops/kernels.py``); on the CPU they run through each kernel's plain
PyTorch twin beside its wrapper in ``ops/``. ``ROADMAP.md`` lists what is
left.
"""

__version__ = "0.1.0"
