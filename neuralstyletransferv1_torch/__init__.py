"""neuralstyletransferv1_torch — the PyTorch/CUDA port of the style-transfer
engine, for one NVIDIA H100.

It mirrors ``neuralstyletransferv1_tpu`` module for module (``ops/``,
``models/``, ``engine/``, ``temporal/``) and keeps that package's public
layouts (NHWC frames, HWC flows) so the two can be compared directly. It
never imports jax. The only modules it shares with the JAX package are
JAX-free host code: ``io/checkpoints.py``, ``engine/config.py`` and (lazily,
for file IO only) ``io/frames.py``.

Kernels written by hand for Hopper live under ``kernels/`` (Python wrappers
with a plain PyTorch twin each) and ``csrc/`` (CUDA C++ sources, built with
nvcc at first use into ``_build/``).
"""

__version__ = "0.1.0"
