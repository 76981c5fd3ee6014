"""The ``Engine`` handle of the port: numerics and execution in one object.

Counterpart of ``repro.engine.Engine``: a frozen dataclass holding the
:class:`~repro_torch.core.precision.PrecisionPolicy` and the backend, with
:meth:`Engine.matmul`, :meth:`Engine.linear`, :meth:`Engine.gemm_op` (all
seven Table-1 ops, differentiable; see ``repro_torch.engine.autodiff``) and
:meth:`Engine.closure` (semiring fixpoint by repeated squaring; see
``repro_torch.engine.closure``).

Backends: ``"cuda"`` launches the hand-written kernels and needs CUDA
tensors; ``"torch"`` runs their plain PyTorch versions and uses no kernel
(the reference path, on the CPU or, for comparison, on the card).

Ambient selection uses :func:`engine_scope`, a ``contextvars`` scope (safe
across threads and asyncio tasks), as in the reference.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import torch

from repro_torch.core.precision import PrecisionPolicy, get_policy
from repro_torch.core.semiring import GemmOp
from repro_torch.engine import autodiff
from repro_torch.engine.closure import closure as _closure
from repro_torch.kernels.ops import BACKENDS


@dataclasses.dataclass(frozen=True)
class Engine:
    """Immutable handle for the RedMulE engine (numerics + execution)."""

    policy: PrecisionPolicy | str = "fp32"
    backend: str = "cuda"

    def __post_init__(self):
        if isinstance(self.policy, str):
            object.__setattr__(self, "policy", get_policy(self.policy))
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected one of {BACKENDS}")

    # -- functional updates ------------------------------------------------
    def replace(self, **kw) -> "Engine":
        if isinstance(kw.get("policy"), str):
            kw["policy"] = get_policy(kw["policy"])
        return dataclasses.replace(self, **kw)

    def with_backend(self, backend: str) -> "Engine":
        return self.replace(backend=backend)

    def with_policy(self, policy: PrecisionPolicy | str) -> "Engine":
        return self.replace(policy=policy)

    # -- operations --------------------------------------------------------
    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """z = a @ b under the policy, differentiable with the hybrid-FP8
        rule (E4M3 forward, E5M2 backward). a: (..., M, K); b: (K, N) or
        broadcast-batched (..., K, N). Returns ``policy.out``."""
        return autodiff.mp_matmul(a, b, self)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
        """y = x @ w (+ b) through the engine. x: (..., K), w: (K, N)."""
        y = self.matmul(x, w)
        if b is not None:
            y = y + b.to(y.dtype)
        return y

    def gemm_op(self, x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None = None,
                op: str | GemmOp = "matmul") -> torch.Tensor:
        """Full GEMM-Op surface (paper Table 1): Z = star(Y, star_k(circ(X, W))),
        differentiable for every op: (mul, add) with the hybrid-FP8 VJP, the
        semiring ops with tropical subgradients."""
        return autodiff.gemm_op(x, w, y, op, self)

    def closure(self, a: torch.Tensor, op: str | GemmOp = "apsp", *,
                max_steps: int | None = None, include_diagonal: bool = True) -> torch.Tensor:
        """Semiring closure a* by repeated squaring (APSP, max-capacity, ...):
        D <- star(D, D circ-star D) with an early exit at the fixpoint;
        ceil(log2(V-1)) engine calls at worst."""
        return _closure(self, a, op, max_steps=max_steps, include_diagonal=include_diagonal)


DEFAULT_ENGINE = Engine()

_AMBIENT: contextvars.ContextVar[Engine | None] = contextvars.ContextVar(
    "repro_torch_engine_ambient", default=None
)


def ambient_engine() -> Engine | None:
    """The innermost active :func:`engine_scope`'s engine, or None."""
    return _AMBIENT.get()


def set_ambient_engine(engine: Engine | None) -> Engine | None:
    """Set the ambient engine of the current context; returns the previous
    one. Prefer :func:`engine_scope`; this serves the deprecated
    ``set_default_backend`` shim and interactive use."""
    prev = _AMBIENT.get()
    _AMBIENT.set(engine)
    return prev


def current_engine() -> Engine:
    """The innermost :func:`engine_scope`'s engine, else :data:`DEFAULT_ENGINE`."""
    amb = _AMBIENT.get()
    return DEFAULT_ENGINE if amb is None else amb


def as_engine(obj: Any) -> Engine:
    """An Engine from an Engine, a PrecisionPolicy or a policy name. A bare
    policy keeps the ambient engine's backend and swaps the numerics."""
    if isinstance(obj, Engine):
        return obj
    if isinstance(obj, (PrecisionPolicy, str)):
        return current_engine().replace(policy=obj)
    raise TypeError(
        f"cannot interpret {type(obj).__name__} as an Engine; pass an "
        "Engine, a PrecisionPolicy, or a policy name"
    )


@contextlib.contextmanager
def engine_scope(engine):
    """Scoped ambient engine: :func:`current_engine` inside resolves to it."""
    engine = as_engine(engine)
    token = _AMBIENT.set(engine)
    try:
        yield engine
    finally:
        _AMBIENT.reset(token)
