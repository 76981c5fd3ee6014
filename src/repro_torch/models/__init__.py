"""Models of the port: the dense decoder and its building blocks."""
from repro_torch.models.registry import build, make_batch

__all__ = ["build", "make_batch"]
