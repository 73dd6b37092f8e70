"""neuralstyletransferv1_torch — the PyTorch/CUDA port of the style-transfer
engine, for one NVIDIA H100.

It mirrors ``neuralstyletransferv1_tpu`` module for module (``ops/``,
``models/``, ``engine/``, ``temporal/``) and keeps that package's public
layouts (NHWC frames, HWC flows) so the two can be compared directly. It
never imports jax and shares no module with the JAX package: the host code
it needs (``io/checkpoints.py``, ``io/frames.py``, ``engine/config.py``) is
its own copy.

Kernels written by hand for Hopper live under ``kernels/`` (Python wrappers
with a plain PyTorch twin each) and ``csrc/`` (CUDA C++ sources, built with
nvcc at first use into ``_build/``).
"""

__version__ = "0.1.0"
