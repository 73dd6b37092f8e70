"""Kernels written by hand for Hopper, each with its plain PyTorch twin.

A wrapper takes the plain version only for CPU tensors; for a CUDA tensor
it launches its kernel or raises. Each wrapper counts its launches in a
module-level ``LAUNCHES`` integer.
"""
