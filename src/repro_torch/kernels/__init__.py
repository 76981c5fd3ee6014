"""The port's kernels: CUDA C++ for Hopper beside their plain PyTorch versions."""
