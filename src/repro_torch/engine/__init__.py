"""The port's engine: one handle for every GEMM of the models."""
from repro_torch.engine.engine import Engine

__all__ = ["Engine"]
