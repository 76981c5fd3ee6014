"""Shared model building blocks of the port (counterpart of
``repro.models.common``). Parameters are plain dicts of tensors, and every
matrix product goes through the :class:`~repro_torch.engine.Engine`."""
from __future__ import annotations

import contextlib
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


def _logistic16(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), each step rounded to x's 16-bit format; in bf16 on
    the CPU a subnormal result flushed to zero, as XLA's compiled code
    flushes it (x in (-88.7, -87.3), where exp(-x) is still finite)."""
    s = 1 / (1 + torch.exp(-x))
    return _ftz(s) if xla_rounds(x, torch.bfloat16) else s


def _silu16_values(x: torch.Tensor) -> torch.Tensor:
    return x * _logistic16(x)


def _silu16_grad(g, x, y):
    """The gradient XLA compiles for the reference's 16-bit silu: g s + (x
    g) (s (1 - s)), every step rounded to the format but g s, which stays
    exact in fp32 for the add."""
    s = _logistic16(x)
    return (g.float() * s.float() + ((x * g) * (s * (1 - s))).float()).to(x.dtype)


def _silu_bf16_grad(g, x, y):
    """The gradient XLA compiles for the reference's bf16 silu: g s + (x g)
    (s (1 - s)), every step rounded to bf16 (no product stays in fp32 for
    the add that follows, as in fp16)."""
    s = _logistic16(x)
    return g * s + (x * g) * (s * (1 - s))


def _silu_values(x: torch.Tensor) -> torch.Tensor:
    return x * _sigmoid_values(x)


def _silu_grad(g, x, y):
    """The reference's g s + (x g) (s (1 - s)), the first product fused
    into the add."""
    s = _sigmoid_values(x)
    return _fma(g, s, (x * g) * (s * (1 - s)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), rounded as the reference's ``jax.nn.silu`` is: in a
    16-bit format XLA expands the logistic into 1 / (1 + exp(-x)) with each
    step rounded to that format, which ``torch.sigmoid`` (one rounding)
    would miss in about a quarter of the elements. In fp16 and bf16 the
    gradient is the reference's too (:func:`_silu16_grad`,
    :func:`_silu_bf16_grad`), on every device: autograd through the
    expansion gives NaN where exp(-x) overflows (x < -11.1 in fp16, < -88.7
    in bf16). In fp32 on the CPU the logistic is XLA's and the gradient the
    reference's."""
    if x.dtype in (torch.float16, torch.bfloat16):
        grad = _silu16_grad if x.dtype == torch.float16 else _silu_bf16_grad
        return _XlaRounded.apply(x, _silu16_values, grad)
    if not xla_rounds(x):
        return x * torch.sigmoid(x)
    return _XlaRounded.apply(x, _silu_values, _silu_grad)


_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_K = 0.044714998453855515  # 0.044715 rounded to fp32, as XLA takes the constant
_GELU_CK = 0.035677406936883926  # sqrt(2/pi) 0.044715 in fp32: the backward's folded constant


def _gelu_values(x: torch.Tensor) -> torch.Tensor:
    return x * (0.5 * (1.0 + _tanh_values(_GELU_C * _fma(x * x * x, _GELU_K, x))))


def _gelu_grad(g, x, y):
    """The reference's gradient as XLA compiles it: u' = g x / 2 (1 - t)
    (1 + t) (tanh's rule, one fused multiply-add), then g cdf + c u' and
    + (c k u') (3 x^2), each product fused into its add (c k folded into
    one fp32 constant)."""
    x2 = x * x
    t = _tanh_values(_GELU_C * _fma(x2 * x, _GELU_K, x))
    m = (x * g) * 0.5 * (1 - t)
    du = _fma(m, t, m)
    return _fma(du * _GELU_CK, x2 * 3, _fma(g, 0.5 * (1.0 + t), du * _GELU_C))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation x/2 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))),
    the reference's ``jax.nn.gelu(approximate=True)``. In a 16-bit format
    each step is rounded to that format as XLA's compiled CPU code rounds it
    (the reference's layers run inside ``lax.scan`` or ``jit``), with the
    constants rounded to the format first: x^3 as (x x) x, then every later
    step, except that in fp16 XLA keeps the product 0.044715 x^3 in fp32
    for the add that follows. Under fp32 the formula is evaluated in fp32
    as XLA compiles it: 0.044715 x^3 + x one fused multiply-add, and the
    tanh :func:`xla_tanh`. The gradient is the reference's in bf16 on every
    device (:func:`_gelu_bf16_grad`), and in fp16 on the CPU."""
    if x.dtype not in (torch.float16, torch.bfloat16):
        if not xla_rounds(x):
            return x * (0.5 * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * (x * x * x)))))
        return _XlaRounded.apply(x, _gelu_values, _gelu_grad)
    if x.dtype == torch.bfloat16:
        return _XlaRounded.apply(x, lambda t: _gelu16_values(t)[0], _gelu_bf16_grad)
    if xla_rounds(x, torch.float16):
        return _XlaRounded.apply(x, lambda t: _gelu16_values(t)[0], _gelu16_grad)
    return _gelu16_values(x)[0]


def _gelu16_values(x: torch.Tensor):
    """(gelu(x), tanh's value, x^2) with the reference's 16-bit roundings."""
    dt = x.dtype
    k, c = (torch.tensor(v, dtype=dt) for v in (0.044715, _GELU_C))
    x2 = x * x
    x3 = x2 * x
    if dt == torch.float16:
        b = (x.float() + x3.float() * k.float()).to(dt)
    else:
        b = x + k * x3
    t = torch.tanh(c * b)
    return x * (0.5 * (1 + t)), t, x2


def _gelu16_grad(g, x, y):
    """The gradient XLA compiles for the reference's fp16 gelu:
    :func:`_gelu_grad`'s steps, each rounded to fp16, each fused multiply-add
    an exact product added in fp32. It parts from the reference's on one
    fp16 element in 2^16 draws at most (tests/test_torch_xla_sites.py)."""
    _, t, x2 = _gelu16_values(x)
    dt = x.dtype
    c, k = (torch.tensor(v, dtype=dt) for v in (_GELU_C, 0.044715))

    def fused(a, b, c):
        return _fma(a.float(), b.float(), c.float()).to(dt)

    m = (x * g) * 0.5 * (1 - t)
    du = fused(m, t, m)
    return fused(du * (c * k), x2 * 3, fused(g, (t + 1) * 0.5, du * c))


def _gelu_bf16_grad(g, x, y):
    """The gradient XLA compiles for the reference's bf16 gelu:
    :func:`_gelu_grad`'s steps with every step rounded to bf16 and no
    fused multiply-add (the constants rounded to bf16 first)."""
    _, t, x2 = _gelu16_values(x)
    c, k = (torch.tensor(v, dtype=x.dtype) for v in (_GELU_C, 0.044715))
    m = ((x * g) * 0.5) * (1 - t)
    duc = (m + m * t) * c
    return (g * ((t + 1) * 0.5) + duc) + (duc * k) * (x2 * 3)


# -- XLA's compiled fp32 transcendentals ---------------------------------------------
#
# The reference's fp32 transcendentals run as XLA's compiled CPU code: a
# Cephes-style exp (Cody-Waite reduction, a degree-6 polynomial, 2^n from
# exponent bits) and log, a small-|x| rational log1p, Eigen's rational tanh
# and the logistic expanded to 1 / (1 + exp(-x)), with every single-use
# multiply feeding an add fused into one multiply-add and denormal results
# flushed to zero; sin and cos are the C library's sinf and cosf (glibc's:
# the argument reduced by pi/2 in fp64, or by a 192-bit 4/pi past 120, and
# fp64 polynomials rounded once). torch's functions differ from them by an
# ulp or a few in 0.4-78% of the values. On CPU tensors the functions below
# evaluate the same expansions in the same order (each fused multiply-add
# through fp64, as ``rglru.fma``), which gives XLA's bits on every one of
# 2^20 N(0, 64) draws (tests/test_torch_xla_math.py). On the card (and on
# ``meta`` tensors), and for other formats, they are torch's functions.
# On the CPU the gradients are the reference's: JAX's derivative rules on
# these values, contracted as XLA compiles them (tanh's g (1 - y) + g (1 -
# y) y one fused multiply-add); elsewhere torch's formulas. Inside
# :func:`torch_rounding` CPU tensors take the card's formulas too, so that
# the tests hold those against the reference on the CPU.

_TORCH_ROUNDING = [False]


@contextlib.contextmanager
def torch_rounding():
    """Every XLA-rounded site (these functions, silu, gelu, the softcap,
    RoPE, the attention's softmax, the RG-LRU's fp16 convolution) runs the
    code it runs on the card, torch's functions, sums and autograd, on CPU
    tensors too while this block is open."""
    before, _TORCH_ROUNDING[0] = _TORCH_ROUNDING[0], True
    try:
        yield
    finally:
        _TORCH_ROUNDING[0] = before


def xla_rounds(x: torch.Tensor, *dtypes: torch.dtype) -> bool:
    """Whether ``x`` takes XLA's rounding: a CPU tensor of one of ``dtypes``
    (fp32 when none is named) outside :func:`torch_rounding`."""
    return (x.device.type == "cpu" and x.dtype in (dtypes or (torch.float32,))
            and not _TORCH_ROUNDING[0])


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


# glibc's sincosf tables: the cosine and sine polynomials (the cosine's
# negated in quadrants 2 and 3) and 4/pi to 192 bits, 8 new bits an entry.
_COS_POLY = (1.0, -0.49999999725108224, 0.041666623324344516, -0.001388676379437604,
             2.4390450703564542e-05)
_SIN_POLY = (-0.16666654943701084, 0.008332178146138854, -0.00019517298981385725)
_HPI_INV_2_24 = 10680707.430881744  # 2/pi * 2^24
_HPI = 1.5707963267948966
_PI63 = 3.4061215800865545e-19  # 2 pi * 2^-64
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415, 0x4e441529,
    0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5, 0x57d1f534, 0xd1f534dd,
    0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295, 0xdb629599, 0x6295993c, 0x95993c43,
    0x993c4390, 0x3c439041)


def _srl(v: torch.Tensor, k: int) -> torch.Tensor:
    """v >>> k: the logical shift of an int64 read as unsigned."""
    return (v >> k) & ((1 << (64 - k)) - 1)


def _sincos_poly(x: torch.Tensor, neg: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """sinf_poly on fp64 x in [-pi/4, pi/4]: the sine polynomial, or the
    cosine's (negated where ``neg``) where ``odd``."""
    x2 = x * x
    x3 = x * x2
    s = (x + x3 * _SIN_POLY[0]) + (x3 * x2) * (_SIN_POLY[1] + x2 * _SIN_POLY[2])
    sg = torch.where(neg, -1.0, 1.0).double()
    x4 = x2 * x2
    c = (_COS_POLY[0] + x2 * _COS_POLY[1]) * sg + x4 * (_COS_POLY[2] * sg)
    c = c + (x4 * x2) * ((_COS_POLY[3] + x2 * _COS_POLY[4]) * sg)
    return torch.where(odd, c, s)


def _sincos_values(y: torch.Tensor, cos: bool) -> torch.Tensor:
    bits = y.view(torch.int32)
    top = (bits >> 20) & 0x7FF  # the exponent and the mantissa's top 3 bits
    x = y.double()
    # |y| < 120: n = round(y 2/pi) through the 2^24-scaled integer.
    n = (((x * _HPI_INV_2_24).to(torch.int32) + 0x800000) >> 24).long()
    r = x - n.double() * _HPI
    # Larger: the 2.62-bit fixed-point product with 4/pi's 96 bits at y's exponent.
    xi = bits.long() & 0xFFFFFFFF
    idx = _srl(xi, 26) & 15
    tab = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    m = ((xi & 0xFFFFFF) | 0x800000) << ((xi >> 23) & 7)
    res = (_srl(m * tab[idx + 8], 32) | ((m * tab[idx]) & 0xFFFFFFFF) << 32) + m * tab[idx + 4]
    n_big = _srl(res + (1 << 61), 62)
    r_big = (res - (n_big << 62)).double() * _PI63
    fast = top < 0x42F  # |y| < 120
    q = torch.where(fast, n, n_big + _srl(xi, 31))
    n = torch.where(fast, n, n_big)
    r = torch.where(fast, r, r_big)
    sign = torch.where((q & 3 == 1) | (q & 3 == 2), -1.0, 1.0).double()
    v = _sincos_poly(r * sign, (q & 2) != 0, ((n & 1) != 0) ^ cos)
    zero = torch.zeros_like(n, dtype=torch.bool)
    v = torch.where(top < 0x3F4, _sincos_poly(x, zero, zero | cos), v).float()  # |y| < pi/4
    v = torch.where(top < 0x398, 1.0 if cos else y, v)  # |y| < 2^-12
    return torch.where(torch.isfinite(y), v, math.nan)


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
    if not xla_rounds(x):
        return torch_fn(x)
    return _XlaRounded.apply(x, values, grad)


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.exp, _exp_values, lambda g, x, y: g * y)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.log1p, _log1p_values, lambda g, x, y: g / (1 + x))


def _tanh_grad(g, x, y):
    t = g * (1 - y)
    return _fma(t, y, t)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.tanh, _tanh_values, _tanh_grad)


def xla_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.sigmoid, _sigmoid_values, lambda g, x, y: g * (y * (1 - y)))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.log, _log_values, lambda g, x, y: g / x)


def xla_sin(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.sin, lambda x: _sincos_values(x, False),
                        lambda g, x, y: g * _sincos_values(x, True))


def xla_cos(x: torch.Tensor) -> torch.Tensor:
    return _xla_rounded(x, torch.cos, lambda x: _sincos_values(x, True),
                        lambda g, x, y: -(g * _sincos_values(x, False)))


_XLA_WINDOW = 32


def _fold(t: torch.Tensor, add=torch.add) -> torch.Tensor:
    """add(... add(add(0, t[0]), t[1]) ..., t[-1]) over dim 0."""
    acc = torch.zeros(t.shape[1:], dtype=t.dtype, device=t.device)
    for v in t:
        acc = add(acc, v)
    return acc


def xla_reduce(x: torch.Tensor, add=torch.add) -> torch.Tensor:
    """The sum over dims 0 and 1 of x in the order of XLA's compiled CPU
    reduce: while either dim is longer than 32, windows of 32 along it (the
    other whole; the padding split low and high) are each folded left from
    0 in row-major order, and the array of the windows' sums is reduced so
    in turn. ``add`` takes each step (an fp16 reduce rounds there)."""
    while max(x.shape[:2]) > _XLA_WINDOW:
        cuts = [(-(-n // _XLA_WINDOW), _XLA_WINDOW) if n > _XLA_WINDOW else (1, n)
                for n in x.shape[:2]]
        pads = [0, 0] * (x.dim() - 2)
        for n, (k, w) in zip(reversed(x.shape[:2]), reversed(cuts)):
            pads += [(k * w - n) // 2, k * w - n - (k * w - n) // 2]
        (k0, w0), (k1, w1) = cuts
        rest = x.shape[2:]
        x = torch.nn.functional.pad(x, pads).reshape(k0, w0, k1, w1, *rest)
        x = x.permute(1, 3, 0, 2, *range(4, x.dim())).reshape(w0 * w1, k0, k1, *rest)
        x = _fold(x, add)
    return _fold(x.reshape(-1, *x.shape[2:]), add)


def _pad_to(x: torch.Tensor, dim: int, width: int) -> torch.Tensor:
    """x with zeros on the right of ``dim`` up to ``width``."""
    if width <= x.shape[dim]:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, width - x.shape[dim]]
    return torch.nn.functional.pad(x, pad)


def _sum_values(x: torch.Tensor, dim: int, width: int = 0) -> torch.Tensor:
    """The sum over ``dim`` (kept) in XLA's compiled CPU order
    (:func:`xla_reduce`). ``width``: the order of a dim that zeros pad on
    the right to that length."""
    x = _pad_to(x, dim, width).movedim(dim, 0)
    return xla_reduce(x[None]).unsqueeze(dim)


class _XlaSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, width):
        ctx.shape = x.shape
        return xla_reduce(_pad_to(x, -1, width)) if dim is None else _sum_values(x, dim, width)

    @staticmethod
    def backward(ctx, g):
        return g.expand(ctx.shape), None, None


def xla_sum(x: torch.Tensor, dim: int | None = -1, width: int = 0) -> torch.Tensor:
    """``x.sum(dim, keepdim=True)``, or with ``dim=None`` the sum of a 2-D
    x's elements, in XLA's compiled CPU order on fp32 CPU tensors
    (:func:`xla_reduce`; ``width`` pads the last dim with zeros to that
    length first, as the reference pads its last KV or loss chunk),
    torch's elsewhere."""
    if not xla_rounds(x):
        return x.sum() if dim is None else x.sum(dim, keepdim=True)
    return _XlaSum.apply(x, dim, width)


def xla_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.mean(dim)``: on fp32 CPU tensors as XLA compiles ``jnp.mean``,
    :func:`xla_sum` times the count's fp32 reciprocal (its simplifier's
    form of a division by a constant)."""
    if not xla_rounds(x):
        return x.mean(dim)
    one, n = torch.tensor([1.0, x.shape[dim]], dtype=torch.float32)
    return xla_sum(x, dim).squeeze(dim) * float(one / n)


def _softmax_values(x: torch.Tensor, dim: int) -> torch.Tensor:
    e = _exp_values(x - x.amax(dim, keepdim=True))
    return e / _sum_values(e, dim)


def xla_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax``: exp(x - max) over its sum, with :func:`xla_exp`
    and XLA's sum order. The gradient is torch's softmax formula."""
    return _xla_rounded(x, lambda t: torch.softmax(t, dim), lambda t: _softmax_values(t, dim),
                        lambda g, x, y: y * (g - (g * y).sum(dim, keepdim=True)))


class _XlaLogSumExp(torch.autograd.Function):
    """``jax.nn.logsumexp`` over ``dim``: the max (0 where it is not
    finite; no gradient), e = exp(x - max) with XLA's exp, log(sum e) +
    max with XLA's log, the sum in XLA's order. The backward is the
    reference's own, g / sum e times e, on the saved e."""

    @staticmethod
    def forward(ctx, x, dim):
        m = x.amax(dim, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        e = _exp_values(x - m)
        s = _sum_values(e, dim)
        ctx.dim = dim
        ctx.save_for_backward(e, s)
        return (_log_values(s) + m).squeeze(dim)

    @staticmethod
    def backward(ctx, g):
        e, s = ctx.saved_tensors
        return (g.unsqueeze(ctx.dim) / s) * e, None


def xla_logsumexp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if not xla_rounds(x):
        return torch.logsumexp(x, dim)
    return _XlaLogSumExp.apply(x, dim)


def xla_fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c, contracted into one fused multiply-add on fp32 CPU tensors
    as XLA's compiled code contracts a multiply that feeds an add."""
    if not xla_rounds(a):
        return a * b + c
    return _fma(a, b, c)


def _softplus_values(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0) + _log1p_values(_exp_values(-x.abs()))


def _softplus_grad(g, x, y):
    """logaddexp's derivative rule: g exp(x - y), infinities read as 0."""
    def finite(t):
        return torch.where(torch.isinf(t), 0.0, t)
    return g * _exp_values(finite(x) - finite(y))


def xla_softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` writes it, logaddexp(x, 0), with
    XLA's exp and log1p."""
    if not xla_rounds(x):
        return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))
    return _XlaRounded.apply(x, _softplus_values, _softplus_grad)


ACTIVATIONS = {
    "gelu": gelu,
    "silu": silu,
    "relu": torch.relu,
}


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """cap * tanh(x / cap), or x when ``cap`` is None (gemma2's attention
    and final-logit caps; the callers apply it to fp32 scores and logits).
    On fp32 CPU tensors as XLA compiles it: x times cap's fp32 reciprocal
    (its simplifier's form of a division by a constant), and XLA's tanh."""
    if cap is None:
        return x
    if not xla_rounds(x):
        return cap * torch.tanh(x / cap)
    one, c = torch.tensor([1.0, cap], dtype=torch.float32)
    return cap * xla_tanh(x * float(one / c))


def rope_freqs(head_dim: int, theta: float, fraction: float, device):
    """(1 / theta^(i / rot) for even i < rot, rot). On the CPU as XLA
    compiles the reference's expression: its simplifier rewrites 1 / a^b as
    a^-b, and its pow (the C library's powf) gives the fp64 power rounded
    once on every config's frequencies (tests/test_torch_xla_sites.py)."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    e = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    if xla_rounds(e):
        inv = (float(torch.tensor(theta, dtype=torch.float32)) ** -e.double()).float()
    else:
        inv = 1.0 / (theta ** e)
    return inv, rot


class _Rotate(torch.autograd.Function):
    """RoPE's rotation of the pairs (x1, x2), in fp32, as XLA compiles the
    reference's: each output's first product fused into its add. The
    gradient is too: in fp32 g2 sin + g1 cos and g2 cos - g1 sin with the
    g2 product fused; in a 16-bit format each product rounded to it and
    summed there (x's promotion at each use). A signed zero reads +0, as
    the reference's scatter into zeros gives it."""

    @staticmethod
    def forward(ctx, x1, x2, cos, sin):
        ctx.save_for_backward(cos, sin)
        ctx.dtype = x1.dtype
        a, b = x1.float(), x2.float()
        return _fma(a, cos, -(b * sin)), _fma(b, cos, a * sin)

    @staticmethod
    def backward(ctx, g1, g2):
        cos, sin = ctx.saved_tensors
        dt = ctx.dtype
        if dt == torch.float32:
            d1, d2 = _fma(g2, sin, g1 * cos), _fma(g2, cos, -g1 * sin)
        else:
            d1 = (g2 * sin).to(dt) + (g1 * cos).to(dt)
            d2 = (g2 * cos).to(dt) + (-g1 * sin).to(dt)
        return d1 + 0.0, d2 + 0.0, None, None


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S). Rotates interleaved pairs
    (x[..., 0::2], x[..., 1::2]) over the first ``fraction`` of hd, with
    XLA's sin and cos, and each output's first product fused into its add,
    on the CPU (the reference's compiled bits in fp32)."""
    hd = x.shape[-1]
    inv, rot = rope_freqs(hd, theta, fraction, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv  # (B, S, rot/2)
    cos = xla_cos(ang)[:, :, None, :]
    sin = xla_sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    if xla_rounds(x1, torch.float32, torch.float16, torch.bfloat16):
        y1, y2 = _Rotate.apply(x1, x2, cos.detach(), sin.detach())
    else:
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
