"""Shared model building blocks of the port (counterpart of
``repro.models.common``). Parameters are plain dicts of tensors, and every
matrix product goes through the :class:`~repro_torch.engine.Engine`."""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.precision import FP8_DTYPES, cast, take_rows
from repro_torch.engine import Engine

Params = dict[str, Any]


def kmajor_weight(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) weight stored in fp8 for good (``cfg.fp8_params``) as the
    (K, N) view of a contiguous (N, K) tensor: the K-major layout that the
    GEMM kernel's tensor-core and small-row schedules read, made once so
    that no serving step copies a weight. Other weights keep their layout;
    the values and the (K, N) shape are the same either way."""
    if w.dtype not in FP8_DTYPES or w.stride(0) == 1:
        return w
    return w.T.contiguous().T


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               device, scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device) * scale
    return {"w": kmajor_weight(cast(w, dtype))}


def dense_apply(p: Params, x: torch.Tensor, engine: Engine) -> torch.Tensor:
    return engine.linear(x, p["w"], p.get("b"))


def norm_init(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), rounded as the reference's ``jax.nn.silu`` is: in a
    16-bit format XLA expands the logistic into 1 / (1 + exp(-x)) with each
    step rounded to that format, which ``torch.sigmoid`` (one rounding)
    would miss in about a quarter of the elements."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return x * (1 / (1 + torch.exp(-x)))
    return x * torch.sigmoid(x)


def rope_freqs(head_dim: int, theta: float, fraction: float, device):
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))
    return inv, rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S). Rotates interleaved pairs
    (x[..., 0::2], x[..., 1::2]) over the first ``fraction`` of hd."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, theta, fraction, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv  # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device) -> Params:
    table = torch.randn((vocab, d), generator=gen, device=device) * 0.02
    return {"table": cast(table, dtype)}


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return take_rows(p["table"], tokens)


def unembed_apply(p: Params, x: torch.Tensor, engine: Engine) -> torch.Tensor:
    """Tied unembedding: logits = x @ table.T. ``table.T`` is a transposed
    view; the GEMM kernel reads it through its strides, so no copy of the
    (vocab, d) table is made (0 extra bytes)."""
    return engine.matmul(x, p["table"].T)
