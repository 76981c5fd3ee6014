"""SwiGLU feed-forward block, every GEMM through the engine (counterpart of
``repro.models.ffn`` for the dense decoder)."""
from __future__ import annotations

import torch

from repro_torch.engine import Engine
from repro_torch.models import common


def init(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype, device):
    return {
        "up": common.dense_init(gen, d_model, d_ff, dtype, device),
        "gate": common.dense_init(gen, d_model, d_ff, dtype, device),
        "down": common.dense_init(gen, d_ff, d_model, dtype, device),
    }


def apply(params, x: torch.Tensor, kind: str, engine: Engine) -> torch.Tensor:
    if kind != "swiglu":
        raise NotImplementedError(f"ffn kind {kind!r} is not ported yet")
    up = common.dense_apply(params["up"], x, engine)
    h = common.silu(common.dense_apply(params["gate"], x, engine)) * up
    return common.dense_apply(params["down"], h, engine)
