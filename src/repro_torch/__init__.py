"""PyTorch/CUDA port of the RedMulE reproduction, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package imports
neither JAX nor ``repro``. It covers continuous-batching serving of the
dense decoder (granite-3-8b) with two hand-written CUDA kernels: the
GEMM-Op engine (``kernels/redmule_gemm.py``) and paged flash-decode
attention (``kernels/flash_attention.py``).
"""
