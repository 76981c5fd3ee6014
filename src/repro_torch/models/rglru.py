"""RecurrentGemma's RG-LRU recurrent block (Griffin; arXiv:2402.19427), the
counterpart of ``repro.models.rglru``.

The training and prefill path runs the linear recurrence
h_t = a_t h_{t-1} + b_t as the reference does, with the odd/even tree of
``jax.lax.associative_scan`` (:func:`associative_scan`), parallel over the
sequence; decode carries (h, conv state) with O(1) memory. The five
projections go through the engine (on the card the GEMM-Op kernel); the
gates, the width-4 causal convolution and the scan stay plain torch, as
the reference computes them outside any Pallas kernel.

Rounding, kept from the reference's compiled CPU code: its combine
``(a1 a2, a2 b1 + b2)`` contracts ``a2 b1 + b2`` into one fused
multiply-add, and so does the carried state's fold ``b_1 + a_1 h_0`` and
the decode step's ``a h + b``, and in fp32 and fp16 the convolution's sum
of four products contracts likewise. :func:`fma` computes each from fp32
operands in fp64 (the product is exact there) and rounds to fp32, on the
CPU and on the card alike, so the scan gives the same bits on both.

Tensor parallelism (``tp``, the training scan; ``distrib/tensor_parallel.py``):
the recurrence is per channel, so a rank runs its channels of d_rnn.
in_x and in_gate are column-parallel, the conv weight and ``lam`` its
channels' pieces, gate_a and gate_x take the whole conv output (gathered
over the axis) and give its channels, and out is row-parallel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.precision import FP8_DTYPES
from repro_torch.distrib import tensor_parallel as tpl
from repro_torch.engine import Engine
from repro_torch.models import common

_C = 8.0  # Griffin's recurrence-gate exponent
_CONV_W = 4


class RGLRUConfig(NamedTuple):
    d_model: int
    d_rnn: int


def init(gen: torch.Generator, cfg: RGLRUConfig, dtype: torch.dtype, device) -> dict:
    """The reference's parameters and scales: ``lam`` fp32 on
    linspace(0.5, 4), the rest in ``dtype``."""
    d, r = cfg.d_model, cfg.d_rnn
    conv = torch.randn((_CONV_W, r), generator=gen, device=device) * 0.1
    return {
        "in_x": common.dense_init(gen, d, r, dtype, device),
        "in_gate": common.dense_init(gen, d, r, dtype, device),
        "conv_w": conv.to(dtype),
        "gate_a": common.dense_init(gen, r, r, dtype, device),
        "gate_x": common.dense_init(gen, r, r, dtype, device),
        "lam": torch.linspace(0.5, 4.0, r, dtype=torch.float32, device=device),
        "out": common.dense_init(gen, r, d, dtype, device),
    }


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c on fp32 tensors with one rounding (a fused multiply-add),
    through fp64: the product of two fp32 values is exact there, and the
    sum's fp64 rounding lies far below the fp32 result's."""
    return (a.double() * b.double() + c.double()).float()


def associative_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over dim 1 from h_0 = 0, by the odd/even
    recursion of ``jax.lax.associative_scan`` with the reference's combine
    (the earlier element first): pairs are combined, the half-length scan
    recurses, and each even element combines the scan before it with
    itself. Returns h (B, S, R) fp32."""
    def combine(a1, b1, a2, b2):
        return a1 * a2, fma(a2, b1, b2)

    def scan(a, b):
        n = a.shape[1]
        if n < 2:
            return a, b
        ra, rb = combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
        oa, ob = scan(ra, rb)
        if n % 2 == 0:
            ea, eb = combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
        else:
            ea, eb = combine(oa, ob, a[:, 2::2], b[:, 2::2])
        ea = torch.cat([a[:, :1], ea], dim=1)
        eb = torch.cat([b[:, :1], eb], dim=1)
        return _interleave(ea, oa), _interleave(eb, ob)

    return scan(a, b)[1]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] over dim 1 (``even`` may be one longer)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv, width 4. x: (B, S, R); state: (B, 3, R).
    Returns (y in x's format, the last 3 inputs). The reference promotes
    ``x * w`` and has no promotion of E4M3 with a 16-bit format, so E4M3
    weights (``cfg.fp8_params``) raise here as they do there."""
    if w.dtype in FP8_DTYPES:
        raise TypeError(f"the RG-LRU conv weight is {w.dtype}: the reference promotes it with "
                        f"{x.dtype} and has no promotion for an fp8 format, so recurrentgemma "
                        "takes no fp8_params (ROADMAP queue 3)")
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, _CONV_W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    if w.dtype == torch.float16 and common.xla_rounds(x, torch.float16) and state is None:
        return _Conv16.apply(x, w), xp[:, -(_CONV_W - 1):]
    return _conv_values(xp, w, x.shape[1]), xp[:, -(_CONV_W - 1):]


def _conv_values(xp: torch.Tensor, w: torch.Tensor, s: int) -> torch.Tensor:
    taps = [xp[:, i:i + s] for i in range(_CONV_W)]
    if xp.dtype == w.dtype and xp.dtype in (torch.float32, torch.float16):
        # The reference's compiled sum of the four products: the second
        # product rounded, the first added to it as one fused multiply-add,
        # then one for each later tap (in fp16 an fp32 FMA rounded to fp16).
        def fused(a, b, c):
            return fma(a.float(), b.float(), c.float()).to(xp.dtype)

        y = fused(taps[0], w[0], taps[1] * w[1])
        for i in range(2, _CONV_W):
            y = fused(taps[i], w[i], y)
        return y
    y = taps[0] * w[0]
    for i in range(1, _CONV_W):
        y = y + taps[i] * w[i]
    return y


def _sum16_bt(p: torch.Tensor) -> torch.Tensor:
    """The fp16 sum over (batch, time) of exact fp32 products p (B, S, C) as
    XLA compiles the reference's reduce (``common.xla_reduce``, each add
    rounded to fp16): a windowed reduce (a dim past 32) reads the products
    stored in fp16, a single fold has them fused into its adds."""
    if max(p.shape[:2]) > 32:
        p = p.half().float()
    return common.xla_reduce(p, lambda acc, v: (acc + v).half().float())


class _Conv16(torch.autograd.Function):
    """The fp16 convolution over a zero-padded start on CPU tensors, with
    the gradient XLA compiles for the reference's: dx sums each tap's
    g w from the last tap to the first, each add rounded to fp16, the last
    tap's and the second's products exact in it (fused) and the others
    rounded first; dw is each tap's fp16 reduce of g x over (batch, time)
    with the products fused into its adds."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv_values(torch.nn.functional.pad(x, (0, 0, _CONV_W - 1, 0)), w, x.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s, k = x.shape[1], _CONV_W - 1
        gp = torch.nn.functional.pad(g, (0, 0, k, k)).float()
        wf = w.float()
        p = [gp[:, 2 * k - i:2 * k - i + s] * wf[i] for i in range(_CONV_W)]  # exact
        dx = (p[3] + p[2].half().float()).half().float()
        dx = (dx + p[1]).half().float()
        dx = (dx + p[0].half().float()).half()
        xp = torch.nn.functional.pad(x, (0, 0, k, 0)).float()
        gf = g.float()
        dw = torch.stack([_sum16_bt(gf * xp[:, i:i + s]) for i in range(_CONV_W)]).half()
        return dx, dw


def _gates(params, xr: torch.Tensor, engine: Engine, tp=None):
    """(a_t, gated input b_t) for the linear recurrence, in fp32. With
    ``tp`` xr holds this rank's channels and the gates take it whole."""
    xw = tpl.gather_from(xr, tp) if tp is not None else xr
    r = xw.shape[-1]
    rgate = common.xla_sigmoid(tpl.linear(xw, params["gate_a"], engine, tp, r).float())
    igate = common.xla_sigmoid(tpl.linear(xw, params["gate_x"], engine, tp, r).float())
    log_a = -_C * common.xla_softplus(params["lam"]) * rgate
    a = common.xla_exp(log_a)
    # The multiplier keeps the state's norm bounded: sqrt(1 - a^2).
    mult = torch.sqrt(torch.clamp(1.0 - common.xla_exp(2.0 * log_a), min=1e-6))
    return a, mult * igate * xr.float()


def apply_scan(params, x: torch.Tensor, cfg: RGLRUConfig, engine: Engine, *,
               state: dict | None = None, lengths: torch.Tensor | None = None, tp=None):
    """The training and prefill path: the associative scan over time.
    x: (B, S, D). Returns (y (B, S, D), final state {"h", "conv"} fp32).

    ``state`` continues the recurrence from a carried state (a chunked
    prefill over a stored state row). ``lengths`` (B,) counts the valid
    tokens of right-padded rows: pad positions become scan identities
    (a = 1, b = 0), so the final ``h`` is each row's state at its last
    valid token, and the conv state is gathered at that boundary.

    ``tp``: the params are this rank's pieces (the module docstring), with
    no ``state`` or ``lengths`` (training)."""
    b_sz, s, _ = x.shape
    if tp is not None and params["lam"].shape[0] == cfg.d_rnn:
        tp = None  # the channels do not split: every weight is whole
    gate = common.gelu(tpl.linear(x, params["in_gate"], engine, tp, cfg.d_rnn))
    xr_raw = tpl.linear(x, params["in_x"], engine, tp, cfg.d_rnn)
    valid = None
    if lengths is not None:
        valid = (torch.arange(s, device=x.device)[None, :] < lengths[:, None])[..., None]
        xr_raw = torch.where(valid, xr_raw, 0.0)
    xr, conv_state = _causal_conv(xr_raw, params["conv_w"],
                                  None if state is None else state["conv"])
    a, b = _gates(params, xr, engine, tp)
    if state is not None:
        # Fold the carried h into the first step: h_1 = a_1 h_0 + b_1.
        b = torch.cat([fma(a[:, :1], state["h"][:, None], b[:, :1]), b[:, 1:]], dim=1)
    if valid is not None:
        a = torch.where(valid, a, 1.0)
        b = torch.where(valid, b, 0.0)
    h = associative_scan(a, b)
    out = tpl.out_linear(h.to(x.dtype) * gate, params["out"], engine, tp, cfg.d_rnn)
    if valid is not None:
        # The conv state at each row's valid boundary: the last 3 inputs of
        # [carried conv | valid xr], i.e. ext[len : len + 3].
        carried = (xr_raw.new_zeros((b_sz, _CONV_W - 1, cfg.d_rnn)) if state is None
                   else state["conv"].to(xr_raw.dtype))
        ext = torch.cat([carried, xr_raw], dim=1)
        idx = lengths.long()[:, None] + torch.arange(_CONV_W - 1, device=x.device)[None]
        conv_state = torch.gather(ext, 1, idx[..., None].expand(-1, -1, ext.shape[-1]))
    # The conv state stays fp32 like h: a chunked prefill carries it through
    # the StateStore at every chunk boundary, where a 16-bit store would
    # add error that the single-scan static path never sees.
    return out, {"h": h[:, -1], "conv": conv_state.float()}


def apply_decode(params, x: torch.Tensor, state: dict, cfg: RGLRUConfig, engine: Engine):
    """One-token decode. x: (B, 1, D); state: {"h": (B, R), "conv":
    (B, 3, R)} fp32. Returns (y, new state)."""
    gate = common.gelu(common.dense_apply(params["in_gate"], x, engine))
    xr = common.dense_apply(params["in_x"], x, engine)
    xr, conv_state = _causal_conv(xr, params["conv_w"], state["conv"])
    a, b = _gates(params, xr, engine)
    h = fma(a[:, 0], state["h"], b[:, 0])
    out = common.dense_apply(params["out"], h[:, None].to(x.dtype) * gate, engine)
    return out, {"h": h, "conv": conv_state.to(state["conv"].dtype)}


def init_state(batch: int, cfg: RGLRUConfig, device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, cfg.d_rnn), dtype=torch.float32,
                            device=device),
    }
