"""Models of the port: the dense decoder and its building blocks."""
from repro_torch.models.registry import build

__all__ = ["build"]
