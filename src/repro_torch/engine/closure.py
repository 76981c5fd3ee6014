"""Semiring closure: the fixpoint A* under any Table-1 semiring
(counterpart of ``repro.engine.closure``).

One relaxation step of the path problems is a GEMM-Op square,
``D <- star(D, D circ-star D)``. Starting from the adjacency matrix with
the semiring's circ identity on the diagonal (the empty path: 0 for
min-plus APSP, the largest finite value for max-min capacity, 1 for
max-mul reliability), repeated squaring reaches the closure in at most
ceil(log2(V-1)) engine calls. The reference runs a ``lax.while_loop``; the
port runs a host loop whose early exit compares the new matrix with the
old (min/max lattices reach their fixpoint exactly, so equality is a sound
test). Like the reference, the closure is forward-only in spirit:
differentiate single ``Engine.gemm_op`` steps instead.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import semiring
from repro_torch.core.precision import cast
from repro_torch.core.semiring import GemmOp


def closure(engine, a: torch.Tensor, op: str | GemmOp = "apsp", *,
            max_steps: int | None = None, include_diagonal: bool = True) -> torch.Tensor:
    """A*: the repeated-squaring fixpoint of ``a`` under the op's semiring.

    a: (..., V, V); missing edges carry the star identity (for APSP a large
    but representable "infinity"). ``include_diagonal`` seeds the diagonal
    with the circ identity first. Returns the closure in the policy's
    output format.
    """
    gop = semiring.get(op) if isinstance(op, str) else op
    v = a.shape[-1]
    if a.dim() < 2 or a.shape[-2] != v:
        raise ValueError(f"closure needs a square matrix, got {tuple(a.shape)}")
    out = engine.policy.out
    d = cast(a, out)
    if include_diagonal:
        # circ(e, x) == x: the weight of staying put, clamped to the
        # format's finite range (E4M3 has no inf).
        ident = semiring.finite_identity(gop.circ, out)
        eye = torch.eye(v, dtype=torch.bool, device=a.device)
        d = cast(torch.where(eye, ident, d.float()), out)
    if max_steps is None:
        max_steps = max(1, math.ceil(math.log2(max(v - 1, 2))) + 1)
    for _ in range(max_steps):
        new = engine.gemm_op(d, d, d, op=gop)
        done = torch.equal(new.float(), d.float())
        d = new
        if done:
            break
    return d
