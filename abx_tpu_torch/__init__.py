"""PyTorch / CUDA port of abx_tpu for NVIDIA Hopper (H100).

Mirrors the `abx_tpu/` layout file for file; the JAX package is the
reference every module here is held against.  Imports torch, never jax.
"""
