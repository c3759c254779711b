"""PyTorch + CUDA port of the B-KFAC optimizer family for one NVIDIA H100.

The JAX package ``repro`` is the reference; each module here names the
module it is held against.  This package imports torch and numpy, never
jax and nothing of ``repro``.
"""
