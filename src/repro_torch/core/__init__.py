"""Numerics of the port: precision policies, the Table-1 GEMM-Ops and the
paper's RedMulE cycle and energy model (``perfmodel``).

The pre-Engine names (``mp_matmul``, ``gemm_op``, ``use_backend``, ...)
remain importable from here as deprecated shims, served lazily (PEP 562)
from ``repro_torch.core.redmule``, so that importing ``repro_torch.core``
for policies and semirings does not touch the deprecated module.
"""
from repro_torch.core import perfmodel, precision, semiring
from repro_torch.core.precision import PrecisionPolicy, get_policy
from repro_torch.core.semiring import TABLE1, GemmOp, Op

_REDMULE_NAMES = (
    "BACKENDS",
    "RedMulEConfig",
    "default_backend",
    "from_storage",
    "gemm_op",
    "linear",
    "mp_matmul",
    "set_default_backend",
    "to_fp8_storage",
    "use_backend",
)

__all__ = ["GemmOp", "Op", "PrecisionPolicy", "TABLE1", "get_policy", "perfmodel", "precision",
           "semiring", *_REDMULE_NAMES]


def __getattr__(name: str):
    if name in _REDMULE_NAMES or name == "redmule":
        import importlib

        redmule = importlib.import_module("repro_torch.core.redmule")
        return redmule if name == "redmule" else getattr(redmule, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
