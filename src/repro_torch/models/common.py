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


# -- XLA's compiled fp32 exp, log1p, tanh and logistic ------------------------------
#
# The reference's fp32 transcendentals run as XLA's compiled CPU code: a
# Cephes-style exp (Cody-Waite reduction, a degree-6 polynomial, 2^n from
# exponent bits) and log, a small-|x| rational log1p, Eigen's rational tanh
# and the logistic expanded to 1 / (1 + exp(-x)), with every single-use
# multiply feeding an add fused into one multiply-add and denormal results
# flushed to zero. torch's functions differ from them by an ulp or a few in
# 0.4-47% of the values. On CPU tensors the functions below evaluate the same
# expansions in the same order (each fused multiply-add through fp64, as
# ``rglru.fma``), which gives XLA's bits on every one of 2^20 N(0, 64) draws
# (tests/test_torch_xla_math.py). On the card (and on ``meta`` tensors), and for other formats, they are
# torch's functions. The gradients are torch's formulas on these values.

_FLT_MIN = 2.0 ** -126


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    return (a.double() * b + c).float()


def _ftz(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y.abs() < _FLT_MIN, y * 0.0, y)


def _exp_values(x: torch.Tensor) -> torch.Tensor:
    x = x.clamp(-87.80000305175781, 88.80000305175781)
    fx = torch.floor(_fma(x, 1.4426950216293335, 0.5)).clamp(-127.0, 127.0)
    r = _fma(fx, -0.693359375, x)
    r = _fma(fx, 0.00021219444170128554, r)
    y = _fma(r, 0.00019875691214110702, 0.001398199936375022)
    for p in (0.008333452045917511, 0.04166579619050026, 0.1666666567325592, 0.5):
        y = _fma(y, r, p)
    y = 1.0 + _fma(y, r * r, r)
    two_n = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return _ftz(y * two_n)


def _log_values(a: torch.Tensor) -> torch.Tensor:
    """log(a), a > 0, as XLA's compiled fp32 log; NaN below 0, -inf at 0."""
    bits = torch.where(a > _FLT_MIN, a, _FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = mant < 0.7071067690849304
    e = e - low.float()
    xm = (mant + -1.0) + torch.where(low, mant, 0.0)
    x2 = xm * xm
    x3 = x2 * xm
    y0 = _fma(_fma(xm, 0.07037683576345444, -0.11514610052108765), xm, 0.11676998436450958)
    y1 = _fma(_fma(xm, -0.12420140951871872, 0.14249323308467865), xm, -0.16668057441711426)
    y2 = _fma(_fma(xm, 0.2000071406364441, -0.24999994039535522), xm, 0.3333333134651184)
    y = _fma(_fma(y0, x3, y1), x3, y2)
    y = _fma(y, x3, e * -0.00021219444170128554)
    r = _fma(e, 0.693359375, _fma(x2, -0.5, xm) + y)
    r = torch.where(a > 0, r, float("nan"))
    r = torch.where(a == 0, -math.inf, r)
    return torch.where(a == math.inf, math.inf, r)


def _log1p_values(x: torch.Tensor) -> torch.Tensor:
    big = _log_values(x + 1.0)
    x2 = x * x
    q = x * 0.0 + 1.0
    for c in (15.062909126281738, 83.04756927490234, 221.7624053955078, 309.0987243652344,
              216.42788696289062, 60.11865997314453):
        q = _fma(q, x, c)
    p = x * 0.0 + 4.527000055531971e-05
    for c in (0.4985410273075104, 6.578732490539551, 29.91191864013672, 60.949668884277344,
              57.11296463012695, 20.039552688598633):
        p = _fma(p, x, c)
    small = x + _fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(x.abs() < 0.4142135679721832, small, big)


def _tanh_values(x: torch.Tensor) -> torch.Tensor:
    xc = x.clamp(-7.998811721801758, 7.998811721801758)
    x2 = xc * xc
    p = _fma(x2, -2.7607683663038313e-16, 2.0001879384549948e-13)
    for c in (-8.604671836165423e-11, 5.122297253024044e-08, 1.4857223504805006e-05,
              0.0006372619536705315, 0.004893524572253227):
        p = _fma(x2, p, c)
    q = _fma(x2, 1.1982583600911312e-06, 0.00011853470641653985)
    for c in (0.0022684347350150347, 0.0048935250379145145):
        q = _fma(x2, q, c)
    y = torch.where(x.abs() < 0.00039999998989515007, x, (xc * p) / q)
    return torch.where(x.abs() >= 20.0, torch.copysign(torch.ones_like(x), x), y)


def _sigmoid_values(x: torch.Tensor) -> torch.Tensor:
    return _ftz(1.0 / (_exp_values(-x) + 1.0))


class _XlaRounded(torch.autograd.Function):
    """``values(x)`` forward; ``grad(g, x, y)`` backward."""

    @staticmethod
    def forward(ctx, x, values, grad):
        y = values(x)
        ctx.grad = grad
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return ctx.grad(g, x, y), None, None


def _xla_rounded(x: torch.Tensor, torch_fn, values, grad) -> torch.Tensor:
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return torch_fn(x)
    return _XlaRounded.apply(x, values, grad)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.exp, _exp_values, lambda g, x, y: g * y)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.log1p, _log1p_values, lambda g, x, y: g / (1 + x))


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.tanh, _tanh_values, lambda g, x, y: g * (1 - y * y))


def xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.sigmoid, _sigmoid_values, lambda g, x, y: g * (1 - y) * y)


def xla_fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c, contracted into one fused multiply-add on fp32 CPU tensors
    as XLA's compiled code contracts a multiply that feeds an add."""
    if a.device.type != "cpu" or a.dtype != torch.float32:
        return a * b + c
    return _fma(a, b, c)


def xla_softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` writes it, logaddexp(x, 0), with
    XLA's exp and log1p."""
    return x.clamp(min=0) + xla_log1p(xla_exp(-x.abs()))


ACTIVATIONS = {
    "gelu": gelu,
    "silu": silu,
    "relu": torch.relu,
}


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
