"""Kernels of the port and their plain PyTorch versions.

Each kernel module holds a wrapper that launches the CUDA kernel for CUDA
tensors (``ops/csrc/*.cu``, built by ``ops/build.py``) and runs the plain
version, in the same module, for CPU tensors.
"""
