"""Feed-forward blocks, gated (SwiGLU, GeGLU) and plain (gelu, relu), every
GEMM through the engine (counterpart of ``repro.models.ffn``). Under
tensor parallelism (``tp``) up and gate are column-parallel and down is
row-parallel (``distrib/tensor_parallel.py``)."""
from __future__ import annotations

import torch

from repro_torch.distrib import tensor_parallel as tpl
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


def apply(params, x: torch.Tensor, kind: str, engine: Engine, tp=None,
          d_ff: int | None = None) -> torch.Tensor:
    """The block on x (..., d). With ``tp`` the params may be this rank's
    pieces: a weight narrower than the config's ``d_ff`` is split."""
    d_ff = params["up"]["w"].shape[1] if d_ff is None else d_ff
    up = tpl.linear(x, params["up"], engine, tp, d_ff)
    if kind == "swiglu":
        h = common.silu(tpl.linear(x, params["gate"], engine, tp, d_ff)) * up
    elif kind == "geglu":
        h = common.gelu(tpl.linear(x, params["gate"], engine, tp, d_ff)) * up
    elif kind == "gelu":
        h = common.gelu(up)
    elif kind == "relu":
        h = torch.relu(up)
    else:
        raise ValueError(kind)
    return tpl.out_linear(h, params["down"], engine, tp, d_ff)
