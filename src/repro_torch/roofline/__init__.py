"""repro_torch.roofline: the port's roofline on one H100 (``analysis``) from
operation and byte counts of its kernel calls (``cost``), the counterpart
of ``repro.roofline``."""
from repro_torch.roofline import analysis, cost

__all__ = ["analysis", "cost"]
