"""The port's engine: one handle for every GEMM-Op of the models, with
gradients, the closure and the ambient scope. The pre-Engine surface
(``repro_torch.core.redmule``) survives as deprecated shims over it."""
from repro_torch.engine.closure import closure
from repro_torch.engine.engine import (
    BACKENDS,
    DEFAULT_ENGINE,
    Engine,
    ambient_engine,
    as_engine,
    current_engine,
    engine_scope,
    set_ambient_engine,
)

__all__ = ["BACKENDS", "DEFAULT_ENGINE", "Engine", "ambient_engine", "as_engine", "closure",
           "current_engine", "engine_scope", "set_ambient_engine"]
