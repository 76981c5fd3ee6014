"""Feed-forward blocks, gated (SwiGLU, GeGLU) and plain (gelu, relu), every
GEMM through the engine (counterpart of ``repro.models.ffn``)."""
from __future__ import annotations

import torch

from repro_torch.engine import Engine
from repro_torch.models import common

KINDS = ("swiglu", "geglu", "gelu", "relu")


def init(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype, device,
         kind: str = "swiglu"):
    """``up`` and ``down``, and ``gate`` for the gated kinds, as the
    reference's parameter set."""
    if kind not in KINDS:
        raise ValueError(kind)
    p = {"up": common.dense_init(gen, d_model, d_ff, dtype, device)}
    if kind in ("swiglu", "geglu"):
        p["gate"] = common.dense_init(gen, d_model, d_ff, dtype, device)
    p["down"] = common.dense_init(gen, d_ff, d_model, dtype, device)
    return p


def apply(params, x: torch.Tensor, kind: str, engine: Engine) -> torch.Tensor:
    up = common.dense_apply(params["up"], x, engine)
    if kind == "swiglu":
        h = common.silu(common.dense_apply(params["gate"], x, engine)) * up
    elif kind == "geglu":
        h = common.gelu(common.dense_apply(params["gate"], x, engine)) * up
    elif kind == "gelu":
        h = common.gelu(up)
    elif kind == "relu":
        h = torch.relu(up)
    else:
        raise ValueError(kind)
    return common.dense_apply(params["down"], h, engine)
