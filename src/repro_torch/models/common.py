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


def cast_rows(w: torch.Tensor, dtype: torch.dtype, rows_elems: int = 1 << 26) -> torch.Tensor:
    """``cast(w, dtype)`` of a 2-D ``w``, about ``rows_elems`` elements of
    rows at a time (the same bits: the cast is elementwise). The cast
    unit's temporaries are several times its input, which for a 128256 x
    8192 head would not fit beside a 70 GB model's weights."""
    out = torch.empty(w.shape, dtype=dtype, device=w.device)
    step = max(1, rows_elems // max(w.shape[1], 1))
    for r in range(0, w.shape[0], step):
        out[r:r + step] = cast(w[r:r + step], dtype)
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
               device, scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device).mul_(scale)
    return {"w": kmajor_weight(cast_rows(w, dtype))}


def dense_apply(p: Params, x: torch.Tensor, engine: Engine) -> torch.Tensor:
    return engine.linear(x, p["w"], p.get("b"))


def norm_init(d: int, device, kind: str = "rmsnorm") -> Params:
    """RMSNorm's fp32 scale, or LayerNorm's (``kind="layernorm"``) scale
    and bias."""
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm with ``kind="layernorm"`` (the mean, the
    variance of the centred values, ``rsqrt``, then scale and bias), each
    computed in fp32 and cast back to x's dtype. LayerNorm's last step is
    one fused multiply-add, ``(x - mu) r`` times the scale plus the bias,
    as XLA's compiled code contracts it; its two means sum in torch's
    order, not XLA's, so an fp32 output may differ from the reference's by
    an ulp or two, which the 16-bit cast rarely keeps
    (tests/test_torch_encdec.py states the bounds)."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        c = xf - mu
        r = torch.rsqrt(c.square().mean(-1, keepdim=True) + eps)
        return torch.addcmul(p["bias"], c * r, p["scale"]).to(x.dtype)
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


_GELU_C = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation x/2 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))),
    the reference's ``jax.nn.gelu(approximate=True)``. In a 16-bit format
    each step is rounded to that format as XLA's compiled CPU code rounds it
    (the reference's layers run inside ``lax.scan`` or ``jit``), with the
    constants rounded to the format first: x^3 as (x x) x, then every later
    step, except that in fp16 XLA keeps the product 0.044715 x^3 in fp32
    for the add that follows. Under fp32 the formula is evaluated in fp32,
    and XLA's tanh differs from torch's by an ulp or so
    (tests/test_torch_families.py states the bounds)."""
    if x.dtype not in (torch.float16, torch.bfloat16):
        return x * (0.5 * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x)))))
    dt = x.dtype
    k, c = (torch.tensor(v, dtype=dt) for v in (0.044715, _GELU_C))
    x3 = (x * x) * x
    if dt == torch.float16:
        b = (x.float() + x3.float() * k.float()).to(dt)
    else:
        b = x + k * x3
    return x * (0.5 * (1 + torch.tanh(c * b)))


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """cap * tanh(x / cap), or x when ``cap`` is None (gemma2's attention
    and final-logit caps; the callers apply it to fp32 scores and logits)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


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
    table = torch.randn((vocab, d), generator=gen, device=device).mul_(0.02)
    return {"table": cast_rows(table, dtype)}


def embed_apply(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return take_rows(p["table"], tokens)


def unembed_apply(p: Params, x: torch.Tensor, engine: Engine) -> torch.Tensor:
    """Tied unembedding: logits = x @ table.T. ``table.T`` is a transposed
    view; the GEMM kernel reads it through its strides, so no copy of the
    (vocab, d) table is made (0 extra bytes)."""
    return engine.matmul(x, p["table"].T)
