"""The port's engine: one handle for every GEMM-Op of the models, with
gradients, the closure and the ambient scope."""
from repro_torch.engine.engine import (
    DEFAULT_ENGINE,
    Engine,
    as_engine,
    current_engine,
    engine_scope,
)

__all__ = ["DEFAULT_ENGINE", "Engine", "as_engine", "current_engine",
           "engine_scope"]
