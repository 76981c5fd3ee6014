"""The run's environment: the program's plan switches pinned to its
tables, and the guard that no JAX (nor the JAX package) was loaded."""
from __future__ import annotations

import os
import sys
import tempfile

PLAN_SWITCHES = ("REPRO_AUTOTUNE", "REPRO_TORCH_GEMM_PLAN", "REPRO_TORCH_DECODE_SPLITS")
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def pin(environ=os.environ) -> None:
    """Unset the program's plan switches and point its autotune cache at a
    path that does not exist, so every plan is ``kernels/tuning.py``'s
    table's. Call before the program is imported (it reads them once)."""
    for k in PLAN_SWITCHES:
        environ.pop(k, None)
    tmp = environ.get("TMPDIR") or tempfile.gettempdir()
    environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "perfbench-no-plans", "plans.json")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot,
    compared whole) is JAX's, jaxlib's, flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
