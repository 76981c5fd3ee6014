"""The port's kernels: CUDA C++ for Hopper beside their plain PyTorch versions,
the entry points (``ops``), the plain oracle (``ref``) and the plan tables
(``tuning``)."""
from repro_torch.kernels import ops, ref, tuning

__all__ = ["ops", "ref", "tuning"]
