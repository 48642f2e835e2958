"""PyTorch/CUDA port of the repro package, for one NVIDIA Hopper card.

The JAX package ``repro`` stays the reference; nothing here imports it or
JAX.  Kernels are hand-written CUDA under ``kernels/csrc``.
"""
