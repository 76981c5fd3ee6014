"""Precision policies for the RedMulE engine (paper Sec. 4.2.3), in torch dtypes.

Same policy names and roles as ``repro.core.precision``: ``storage_*`` is
what crosses device memory, ``compute`` the engine's internal element
format, ``acc`` the accumulator and ``out`` the output storage format.

:func:`cast` is the port's cast unit. It reproduces the reference's E4M3
rule: the reference (ml_dtypes) rounds |x| > 464 -- past the midpoint
between 448, the largest finite E4M3 value, and 480 -- and +-inf to NaN,
while ``torch.Tensor.to(torch.float8_e4m3fn)`` saturates them to +-448.
Every other cast (E5M2, fp16, bf16, fp32) agrees between the two
frameworks on every non-NaN value, so it is a plain ``.to``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

E4M3 = torch.float8_e4m3fn  # {1,4,3}: forward / activations
E5M2 = torch.float8_e5m2  # {1,5,2}: backward / gradients
FP16 = torch.float16
BF16 = torch.bfloat16
FP32 = torch.float32

FP8_DTYPES = (E4M3, E5M2)

_DTYPES = {
    "e4m3": E4M3,
    "e5m2": E5M2,
    "fp8": E4M3,
    "fp16": FP16,
    "bf16": BF16,
    "fp32": FP32,
}

# Above this magnitude the reference's E4M3 cast gives NaN (round to
# nearest even: 464 itself rounds down to 448).
E4M3_NAN_ABOVE = 464.0
_E4M3_NAN_BITS = 0x7F  # | 0x80 for a negative input


def as_dtype(x: Any) -> torch.dtype:
    if isinstance(x, str):
        return _DTYPES[x]
    return x


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The cast unit: ``x.to(dtype)`` with the reference's E4M3 overflow rule."""
    if x.dtype == dtype:
        return x
    y = x.to(dtype)
    if dtype != E4M3:
        return y
    xf = x if x.dtype in (FP16, BF16, FP32) else x.to(FP32)
    bad = ~(xf.abs() <= E4M3_NAN_ABOVE)  # overflow, +-inf and NaN
    nan_bits = torch.where(torch.signbit(xf), _E4M3_NAN_BITS | 0x80, _E4M3_NAN_BITS)
    bits = torch.where(bad, nan_bits.to(torch.uint8), y.view(torch.uint8))
    return bits.view(E4M3)


def exact_widen(src: torch.dtype, dst: torch.dtype) -> bool:
    """True when every ``src`` value is exactly representable in ``dst``, so
    a round trip src -> dst -> src is the identity."""
    if src == dst:
        return True
    if src in FP8_DTYPES:
        return dst in (FP16, BF16, FP32)
    return src in (FP16, BF16) and dst == FP32


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype roles for one RedMulE GEMM."""

    name: str
    storage_fwd: Any
    storage_bwd: Any
    compute: Any
    acc: Any
    out: Any
    param: Any = FP32

    def __post_init__(self):
        for f in ("storage_fwd", "storage_bwd", "compute", "acc", "out", "param"):
            object.__setattr__(self, f, as_dtype(getattr(self, f)))

    @property
    def fp8_storage(self) -> bool:
        """Operands cross memory in an fp8 format."""
        return self.storage_fwd.itemsize == 1

    def cast_in_fwd(self, x):
        """Input cast unit, forward path: storage -> compute."""
        return cast(cast(x, self.storage_fwd), self.compute)

    def cast_in_bwd(self, g):
        """Input cast unit, backward path (gradients): storage -> compute."""
        return cast(cast(g, self.storage_bwd), self.compute)

    def cast_out(self, z):
        """Output cast unit: accumulator -> storage."""
        return cast(z, self.out)


REDMULE_FP16 = PrecisionPolicy(
    "redmule_fp16", storage_fwd=FP16, storage_bwd=FP16, compute=FP16,
    acc=FP32, out=FP16,
)
REDMULE_HFP8 = PrecisionPolicy(
    "redmule_hfp8", storage_fwd=E4M3, storage_bwd=E5M2, compute=FP16,
    acc=FP32, out=FP16,
)
REDMULE_HFP8_OUT8 = PrecisionPolicy(
    "redmule_hfp8_out8", storage_fwd=E4M3, storage_bwd=E5M2, compute=FP16,
    acc=FP32, out=E4M3,
)
TPU_HFP8 = PrecisionPolicy(
    "tpu_hfp8", storage_fwd=E4M3, storage_bwd=E5M2, compute=BF16,
    acc=FP32, out=BF16,
)
TPU_BF16 = PrecisionPolicy(
    "tpu_bf16", storage_fwd=BF16, storage_bwd=BF16, compute=BF16,
    acc=FP32, out=BF16,
)
FP32_REF = PrecisionPolicy(
    "fp32", storage_fwd=FP32, storage_bwd=FP32, compute=FP32,
    acc=FP32, out=FP32,
)

POLICIES: dict[str, PrecisionPolicy] = {
    p.name: p
    for p in (REDMULE_FP16, REDMULE_HFP8, REDMULE_HFP8_OUT8, TPU_HFP8, TPU_BF16, FP32_REF)
}


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(POLICIES)}") from None


def _bits_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype in FP8_DTYPES else t


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along the leading axis. fp8 tables are read through a
    bit-exact ``uint8`` view, so the gather needs no fp8 indexing kernel;
    other tables are indexed directly, which keeps the gather
    differentiable (the tied embedding's gradient)."""
    if table.dtype not in FP8_DTYPES:
        return table[idx]
    return _bits_view(table)[idx].view(table.dtype)


def put_rows_(table: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """In place ``table[idx] = rows`` along the leading axis, through a
    ``uint8`` view for fp8 tables (torch has no fp8 ``index_put_`` on the
    CPU). ``rows`` must already be in ``table``'s dtype."""
    _bits_view(table)[idx] = _bits_view(rows)
