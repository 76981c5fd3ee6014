"""Numerics of the port: precision policies, the Table-1 GEMM-Ops and the
paper's RedMulE cycle and energy model (``perfmodel``)."""
from repro_torch.core import perfmodel, precision, semiring
from repro_torch.core.precision import PrecisionPolicy, get_policy
from repro_torch.core.semiring import TABLE1, GemmOp, Op

__all__ = ["GemmOp", "Op", "PrecisionPolicy", "TABLE1", "get_policy", "perfmodel", "precision",
           "semiring"]
