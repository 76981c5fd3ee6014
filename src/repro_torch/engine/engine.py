"""The ``Engine`` handle of the port: numerics and execution in one object.

Counterpart of ``repro.engine.Engine`` for the serving slice: a frozen
dataclass holding the :class:`~repro_torch.core.precision.PrecisionPolicy`
and the backend, with :meth:`Engine.matmul` and :meth:`Engine.linear`.

Backends: ``"cuda"`` launches the hand-written kernels and needs CUDA
tensors; ``"torch"`` runs their plain PyTorch versions and uses no kernel
(the reference path, on the CPU or, for comparison, on the card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.precision import PrecisionPolicy, get_policy
from repro_torch.engine import autodiff
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

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """z = a @ b under the policy. a: (..., M, K); b: (K, N) or
        broadcast-batched (..., K, N). Returns ``policy.out``."""
        return autodiff.mp_matmul(a, b, self)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None) -> torch.Tensor:
        """y = x @ w (+ b) through the engine. x: (..., K), w: (K, N)."""
        y = self.matmul(x, w)
        if b is not None:
            y = y + b.to(y.dtype)
        return y
