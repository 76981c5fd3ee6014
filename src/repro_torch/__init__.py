"""PyTorch/CUDA port of the RedMulE reproduction, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package imports
neither JAX nor ``repro``. It covers continuous-batching serving and
training of the dense decoder (granite-3-8b) with three hand-written CUDA
kernels: the GEMM-Op engine (``kernels/redmule_gemm.py``, forward and both
backward GEMMs), paged flash-decode attention and dense flash attention
(``kernels/flash_attention.py``).
"""
