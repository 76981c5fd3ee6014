"""DEPRECATED compatibility shims over :mod:`repro_torch.engine`
(counterpart of ``repro.core.redmule``).

The engine's pre-``Engine`` surface; every entry point delegates to
``repro_torch.engine`` and emits a ``DeprecationWarning``. Migration map:

    mp_matmul(a, b, policy, backend=...)   -> Engine(policy=..., backend=...).matmul(a, b)
    linear(x, w, b, policy, backend=...)   -> Engine(...).linear(x, w, b)
    gemm_op(x, w, y, op=..., policy=...)   -> Engine(...).gemm_op(x, w, y, op=...)
    use_backend(name) / set_default_backend -> engine_scope(Engine(backend=name))
    RedMulEConfig(...)                     -> Engine(...)

The backends are the port's: ``"cuda"`` (the kernels) and ``"torch"``
(their plain versions, the reference's ``"xla"``). Where no backend was
given, set or scoped, a call runs on its operands' device: the kernels for
CUDA tensors, the plain path for CPU ones. ``RedMulEConfig`` keeps the
reference's fields; its tile fields (``block_m``/``n``/``k``) were TPU
block sizes and do not reach the port's engine, whose plans come from
``kernels/tuning.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings

import torch

from repro_torch.core.precision import FP32_REF, TPU_BF16, PrecisionPolicy, get_policy
from repro_torch.core.semiring import GemmOp
from repro_torch.engine import (
    BACKENDS,
    DEFAULT_ENGINE,
    Engine,
    ambient_engine,
    engine_scope,
    set_ambient_engine,
)

__all__ = [
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
]

warnings.warn(
    "repro_torch.core.redmule is deprecated; use the Engine API in repro_torch.engine",
    DeprecationWarning,
    stacklevel=2,
)


def _warn(old: str, new: str) -> None:
    warnings.warn(f"repro_torch.core.redmule.{old} is deprecated; use {new}",
                  DeprecationWarning, stacklevel=3)


# The old set_default_backend was a process-wide module global visible to
# every thread; contextvars scopes are per-context. The shim keeps the old
# cross-thread semantics with this fallback, consulted only when no
# engine_scope is active.
_process_default_backend: str | None = None


def default_backend() -> str:
    """The ambient engine's backend, else the process-wide
    ``set_default_backend`` value, else ``"torch"`` (the plain path, the
    reference's ``"xla"``)."""
    amb = ambient_engine()
    if amb is not None:
        return amb.backend
    return _process_default_backend or "torch"


def set_default_backend(name: str) -> str | None:
    """Set the process-wide default backend; returns the previous one (or
    None). Also sets the current context's ambient engine, so the setter
    and ``use_backend`` compose as the old module global did."""
    global _process_default_backend
    prev_engine = ambient_engine()
    prev = prev_engine.backend if prev_engine is not None else _process_default_backend
    base = prev_engine if prev_engine is not None else DEFAULT_ENGINE
    set_ambient_engine(base.with_backend(name))  # validates the name first
    _process_default_backend = name
    return prev


@contextlib.contextmanager
def use_backend(name: str):
    """A scoped ambient backend."""
    amb = ambient_engine()
    base = amb if amb is not None else DEFAULT_ENGINE
    with engine_scope(base.with_backend(name)):
        yield


def _backend(backend: str | None, x: torch.Tensor) -> str:
    """Explicit > ambient scope > process default > the operand's device."""
    if backend is not None:
        return backend
    amb = ambient_engine()
    if amb is not None:
        return amb.backend
    if _process_default_backend is not None:
        return _process_default_backend
    return "cuda" if x.is_cuda else "torch"


def _shim_engine(policy: PrecisionPolicy | str, backend: str | None, x: torch.Tensor) -> Engine:
    return Engine(policy=get_policy(policy) if isinstance(policy, str) else policy,
                  backend=_backend(backend, x))


@dataclasses.dataclass(frozen=True)
class RedMulEConfig:
    """DEPRECATED: absorbed into :class:`repro_torch.engine.Engine`."""

    L: int = 12
    H: int = 4
    P: int = 3
    block_m: int | None = None
    block_n: int | None = None
    block_k: int | None = None
    policy: PrecisionPolicy = TPU_BF16
    backend: str | None = None

    @property
    def tile_cols(self) -> int:
        """H*(P+1): the column width of one datapath tile (paper Sec. 4.3)."""
        return self.H * (self.P + 1)

    def to_engine(self, backend: str | None = None) -> Engine:
        return Engine(policy=self.policy, backend=backend or self.backend or "torch")


def mp_matmul(a: torch.Tensor, b: torch.Tensor, policy: PrecisionPolicy = TPU_BF16, *,
              backend: str | None = None) -> torch.Tensor:
    """DEPRECATED: use ``Engine(policy=..., backend=...).matmul(a, b)``."""
    _warn("mp_matmul", "Engine.matmul")
    return _shim_engine(policy, backend, a).matmul(a, b)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           policy: PrecisionPolicy = TPU_BF16, *, backend: str | None = None) -> torch.Tensor:
    """DEPRECATED: use ``Engine(...).linear(x, w, b)``."""
    _warn("linear", "Engine.linear")
    return _shim_engine(policy, backend, x).linear(x, w, b)


def gemm_op(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None = None,
            op: str | GemmOp = "matmul", *, policy: PrecisionPolicy | str = FP32_REF,
            config: RedMulEConfig | None = None, backend: str | None = None) -> torch.Tensor:
    """DEPRECATED: use ``Engine(...).gemm_op(x, w, y, op=...)``. Semiring
    ops are differentiable here too (the engine's tropical VJP)."""
    _warn("gemm_op", "Engine.gemm_op")
    cfg = config or RedMulEConfig()
    # Explicit argument > ambient scope > process default > the config's
    # backend > the operand's device.
    amb = ambient_engine()
    resolved = (backend or (amb.backend if amb is not None else None)
                or _process_default_backend or cfg.backend or _backend(None, x))
    eng = cfg.to_engine(resolved).replace(
        policy=get_policy(policy) if isinstance(policy, str) else policy)
    return eng.gemm_op(x, w, y, op=op)


# fp8 storage helpers (KV cache / parameter compression) ----------------------


def to_fp8_storage(x: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    return x.to(policy.storage_fwd) if policy.fp8_storage else x


def from_storage(x: torch.Tensor, policy: PrecisionPolicy) -> torch.Tensor:
    return x.to(policy.compute)
