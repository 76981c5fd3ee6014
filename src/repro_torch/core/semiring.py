"""GEMM-Ops semiring definitions (paper Table 1).

A GEMM-Op is ``Z = (X circ W) star Y``:

    Z[m, n] = star( Y[m, n],  star_k( circ(X[m, k], W[k, n]) ) )

For the canonical GEMM (circ=mul, star=add) this is ``Z = X @ W + Y``.
The C++ kernel (``csrc/redmule_gemm.cu``) uses the same ``Op`` codes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch


class Op(enum.Enum):
    """Elementary operators available to the CE stages."""

    MUL = "mul"
    ADD = "add"
    MIN = "min"
    MAX = "max"


# Integer codes shared with csrc/redmule_gemm.cu (enum OpCode).
OP_CODE: dict[Op, int] = {Op.MUL: 0, Op.ADD: 1, Op.MIN: 2, Op.MAX: 3}



def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum``: NaN propagates and -0 orders below +0 (IEEE
    754-2019), where ``torch.minimum`` returns whichever zero comes first.
    Where both are zeros, -((-a) + (-b)) / 2 is -0 unless both are +0; its
    gradient splits the tie half and half, as ``torch.minimum``'s does."""
    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, -0.5 * (-a - b), torch.minimum(a, b))


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum``: NaN propagates and +0 orders above -0; where both
    are zeros, (a + b) / 2 is +0 unless both are -0."""
    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, 0.5 * (a + b), torch.maximum(a, b))


_OP_FN: dict[Op, Callable] = {
    Op.MUL: torch.mul,
    Op.ADD: torch.add,
    Op.MIN: minimum,
    Op.MAX: maximum,
}

# Identity element of each operator when used as a reduction (star).
_REDUCE_IDENTITY: dict[Op, float] = {
    Op.ADD: 0.0,
    Op.MIN: float("inf"),
    Op.MAX: float("-inf"),
    Op.MUL: 1.0,
}


def op_fn(op: Op) -> Callable:
    return _OP_FN[op]


def reduce_identity(op: Op) -> float:
    return _REDUCE_IDENTITY[op]


def star_reduce(op: Op, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reduce ``x`` over ``dim`` with a star operator, as ``jnp.sum`` /
    ``jnp.min`` / ``jnp.max`` do: min and max propagate NaN and give -0
    (min) or +0 (max) whenever such a zero is among the zeros they pick
    from, whatever the order (``amin``/``amax`` return any of them)."""
    if op is Op.ADD:
        return x.sum(dim)
    if op is Op.MIN:
        r = x.amin(dim)
        signed = ((x == 0) & torch.signbit(x)).any(dim)
        return torch.where((r == 0) & signed, -r.abs(), r)
    if op is Op.MAX:
        r = x.amax(dim)
        signed = ((x == 0) & ~torch.signbit(x)).any(dim)
        return torch.where((r == 0) & signed, r.abs(), r)
    raise ValueError(f"{op} is no star operator")


def finite_identity(op: Op, dtype: torch.dtype) -> float:
    """``reduce_identity`` clamped to ``dtype``'s finite range: e4m3fn has
    no inf encoding, so +/-inf identities become +/-448 there."""
    ident = _REDUCE_IDENTITY[op]
    fin = float(torch.finfo(dtype).max)
    return max(min(ident, fin), -fin)


@dataclasses.dataclass(frozen=True)
class GemmOp:
    """One row of paper Table 1."""

    name: str
    circ: Op  # first CE stage: maps (x, w) pairs
    star: Op  # second CE stage: k-reduction and Y-combination
    group: int  # 0 = plain GEMM, 1 = Group 1, 2 = Group 2

    @property
    def is_gemm(self) -> bool:
        return self.circ is Op.MUL and self.star is Op.ADD

    @property
    def uses_mxu(self) -> bool:
        """Whether the op takes a tensor-core schedule (the reference's MXU):
        only the (mul, add) pair does, on fp8 or compute-format operands;
        the semiring pairs run on the CUDA cores."""
        return self.is_gemm


MATMUL = GemmOp("matmul", Op.MUL, Op.ADD, group=0)
MAX_CRITICAL_PATH = GemmOp("max_critical_path", Op.ADD, Op.MAX, group=1)
ALL_PAIRS_SHORTEST_PATH = GemmOp("apsp", Op.ADD, Op.MIN, group=1)
MAX_RELIABILITY_PATH = GemmOp("max_reliability_path", Op.MUL, Op.MAX, group=1)
MIN_RELIABILITY_PATH = GemmOp("min_reliability_path", Op.MUL, Op.MIN, group=1)
MIN_SPANNING_TREE = GemmOp("min_spanning_tree", Op.MAX, Op.MIN, group=2)
MAX_CAPACITY_PATH = GemmOp("max_capacity_path", Op.MIN, Op.MAX, group=2)

TABLE1: tuple[GemmOp, ...] = (
    MATMUL,
    MAX_CRITICAL_PATH,
    ALL_PAIRS_SHORTEST_PATH,
    MAX_RELIABILITY_PATH,
    MIN_RELIABILITY_PATH,
    MIN_SPANNING_TREE,
    MAX_CAPACITY_PATH,
)

BY_NAME: dict[str, GemmOp] = {g.name: g for g in TABLE1}
BY_NAME["gemm"] = MATMUL
BY_NAME["all_pairs_shortest_path"] = ALL_PAIRS_SHORTEST_PATH


def get(name: str) -> GemmOp:
    try:
        return BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown GEMM-Op {name!r}; known: {sorted(BY_NAME)}") from None


def pad_value_for(gop: GemmOp) -> tuple[float, float]:
    """The fills (for circ's outputs, for Y) that leave a GEMM-Op result
    unchanged: both the identity of ``star``. The kernels mask padded K
    lanes and rows explicitly; this is the value of that masked fill."""
    ident = reduce_identity(gop.star)
    return ident, ident
