"""xLSTM cells (arXiv:2405.04517), the counterpart of ``repro.models.xlstm``:
mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar memory, a
sequential scan), with the paper's stabilized exponential gating.

The wiring is the reference's: pre-norm residual cells whose fused in and
out projections fold the paper's up/down projection sandwich in (so
xlstm-125m instantiates 78M parameters on the published 12-layer, d 768,
4-head skeleton). Every projection goes through the engine, and so do
mLSTM's three chunk products (``q C``, ``q k^T`` and ``w v``, batched over
(B, H)); under an fp8 policy the engine casts their operands to E4M3, the
fp32 state ``C`` included, as the reference does. The reference's fp32
einsums (the normaliser's and the state update's sums, the decode's
``q C``) and sLSTM's block-diagonal recurrence are fp32 products outside
any Pallas kernel there; here they go through the engine under the fp32
policy (:func:`_f32_matmul`), fp32 products summed in fp32, as the MoE
router does.

Tensor parallelism (``tp``, training; ``distrib/tensor_parallel.py``):
the fused qkv and wx projections are column-split across their parts, so
their output is gathered whole and the cells run replicated; ogate is
column-parallel and out row-parallel on this rank's slice of the cells'
output; ifg and r are whole.

Each ``*_apply`` returns (y, final state), so prefill falls out of the
training path; ``state=`` continues from a carried state and ``lengths=``
masks right-padded rows, whose pad steps leave the state untouched.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distrib import tensor_parallel as tpl
from repro_torch.engine import Engine, autodiff
from repro_torch.models import common

_CHUNK = 256
_LOG_ZERO = -1e30  # a finite stand-in for log 0 (inf would give NaN under inf - inf)


class XLSTMConfig(NamedTuple):
    d_model: int
    n_heads: int

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _f32_matmul(engine: Engine, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 on the engine's backend (batched over leading dims):
    the reference's fp32 einsums, whatever the model's policy."""
    return engine.with_policy("fp32").matmul(a, b)


def _scaled(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """t / divisor with the divisor rounded to t's format first, as the
    reference's weakly typed Python scalar is."""
    return t / float(torch.tensor(divisor, dtype=t.dtype))


# -- mLSTM ---------------------------------------------------------------------------


def mlstm_init(gen: torch.Generator, cfg: XLSTMConfig, dtype: torch.dtype, device) -> dict:
    d = cfg.d_model
    return {
        "qkv": common.dense_init(gen, d, 3 * d, dtype, device),
        "ifg": common.dense_init(gen, d, 2 * cfg.n_heads, dtype, device, scale=0.02),
        "ogate": common.dense_init(gen, d, d, dtype, device),
        "out": common.dense_init(gen, d, d, dtype, device),
    }


def _out(params, y: torch.Tensor, x: torch.Tensor, engine: Engine, tp, d: int) -> torch.Tensor:
    """``out`` on the cells' output y (B, S, d), gated by ``ogate`` where
    the cell has one; with ``tp`` on this rank's slice of y where ogate's
    columns or out's rows are split."""
    og_split = tp is not None and "ogate" in params and params["ogate"]["w"].shape[1] != d
    out_split = tp is not None and params["out"]["w"].shape[0] != d
    if og_split:
        y = tpl.split_to(y, tp)
    if "ogate" in params:
        og = tpl.linear(x, params["ogate"], engine, tp, d)
        y = y * common.xla_sigmoid(og.float()).to(x.dtype)
    if out_split and not og_split:
        y = tpl.split_to(y, tp)
    elif og_split and not out_split:
        y = tpl.gather_from(y, tp)
    return tpl.out_linear(y, params["out"], engine, tp if out_split else None, d)


def _mlstm_heads(params, x: torch.Tensor, cfg: XLSTMConfig, engine: Engine, tp=None):
    """q, k / sqrt(hd), v (B, H, S, hd) in the output format, and the log
    input and log forget gates (B, H, S) in fp32."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v = tpl.whole_linear(x, params["qkv"], engine, tp, 3 * d).split(d, dim=-1)
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = _scaled(k.reshape(b, s, h, hd).transpose(1, 2), math.sqrt(hd))
    v = v.reshape(b, s, h, hd).transpose(1, 2)
    log_i, f_pre = common.dense_apply(params["ifg"], x, engine).float().split(h, dim=-1)
    log_f = -common.xla_softplus(-f_pre)  # log sigmoid(f_pre)
    return q, k, v, log_i.transpose(1, 2), log_f.transpose(1, 2)


def _mlstm_chunk(engine: Engine, carry, qi, ki, vi, li, lf, tri):
    """One chunk of the chunkwise-parallel form: (new carry, h (B, H, c, hd)
    fp32). carry: C (B, H, hd, hd), n (B, H, hd), m (B, H)."""
    c_in, n_in, m_in = carry
    f = torch.cumsum(lf, dim=-1)  # inclusive cumulative log-forget (B, H, c)
    # Log weight of source s into target t inside the chunk: F_t - F_s + li_s.
    src = li - f
    intra_max = torch.where(tri, src[:, :, None, :], -math.inf).amax(-1)
    m_t = torch.maximum(f + m_in[..., None], f + intra_max)
    # Inter-chunk: q_t . C_in, scaled by exp(F_t + m_in - m_t).
    w_inter = common.xla_exp(f + m_in[..., None] - m_t)
    inter = engine.matmul(qi, c_in).float() * w_inter[..., None]
    n_inter = n_in[:, :, None, :] * w_inter[..., None]
    # The intra-chunk quadratic part.
    scores = engine.matmul(qi, ki.transpose(-1, -2)).float()
    logw = f[:, :, :, None] + src[:, :, None, :] - m_t[..., None]
    # The reference takes where(tri, exp(logw), 0): above the diagonal
    # logw grows with the distance (up to ~0.7 a position at random
    # weights), exp overflows past ~128 positions, and the backward's
    # 0 * inf is NaN (its gradients are NaN at 256-token chunks). Masking
    # before the exp gives the same forward values, exactly, and a finite
    # backward (ROADMAP queue 3).
    wexp = common.xla_exp(torch.where(tri, logw, -math.inf))
    intra = engine.matmul((wexp * scores).to(qi.dtype), vi).float()
    kf, vf = ki.float(), vi.float()
    n_t = n_inter + _f32_matmul(engine, wexp, kf)
    qn = (n_t * qi.float()).sum(-1)
    denom = torch.maximum(qn.abs(), common.xla_exp(-m_t))
    h_t = (inter + intra) / denom[..., None]
    # The carry at the chunk's end.
    f_end = f[..., -1]
    m_out = torch.maximum(f_end + m_in, f_end + src.amax(-1))
    w_c = common.xla_exp(f_end + m_in - m_out)
    w_s = common.xla_exp(f_end[..., None] - f + li - m_out[..., None])
    kv = _f32_matmul(engine, (w_s[..., None] * kf).transpose(-1, -2), vf)
    c_out = c_in * w_c[..., None, None] + kv
    n_out = n_in * w_c[..., None] + (w_s[..., None] * kf).sum(2)
    return (c_out, n_out, m_out), h_t


def mlstm_apply(params, x: torch.Tensor, cfg: XLSTMConfig, engine: Engine, *,
                state: dict | None = None, lengths: torch.Tensor | None = None, tp=None):
    """The chunkwise-parallel mLSTM over x (B, S, D), in chunks of
    min(256, S); S must be a multiple of the chunk (the reference's
    ``ValueError``). Pad positions of ``lengths`` get log i = log 0 (no
    input) and log f = 0 (carry). Returns (y, {"C", "n", "m"} fp32)."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q, k, v, log_i, log_f = _mlstm_heads(params, x, cfg, engine, tp)
    if lengths is not None:
        valid = (torch.arange(s, device=x.device)[None, :] < lengths[:, None])[:, None, :]
        log_i = torch.where(valid, log_i, _LOG_ZERO)
        log_f = torch.where(valid, log_f, 0.0)
    c = min(_CHUNK, s)
    if s % c:
        raise ValueError(f"sequence length {s} not divisible by chunk {c}")
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    if state is None:
        carry = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device),
                 torch.zeros((b, h, hd), dtype=torch.float32, device=x.device),
                 torch.full((b, h), _LOG_ZERO, dtype=torch.float32, device=x.device))
    else:
        carry = (state["C"], state["n"], state["m"])
    hs = []
    for c0 in range(0, s, c):
        sl = slice(c0, c0 + c)
        carry, h_t = _mlstm_chunk(engine, carry, q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                  log_i[..., sl], log_f[..., sl], tri)
        hs.append(h_t)
    y = torch.cat(hs, dim=2).transpose(1, 2).reshape(b, s, d).to(x.dtype)
    return _out(params, y, x, engine, tp, d), {"C": carry[0], "n": carry[1], "m": carry[2]}


def mlstm_decode(params, x: torch.Tensor, state: dict, cfg: XLSTMConfig, engine: Engine):
    """The one-step recurrence. x: (B, 1, D); state: {"C", "n", "m"}."""
    b = x.shape[0]
    q, k, v, log_i, log_f = _mlstm_heads(params, x, cfg, engine)
    q, k, v = (t[:, :, 0].float() for t in (q, k, v))  # (B, H, hd)
    li, lf = log_i[..., 0], log_f[..., 0]  # (B, H)
    m_new = torch.maximum(lf + state["m"], li)
    fw = common.xla_exp(lf + state["m"] - m_new)
    iw = common.xla_exp(li - m_new)
    c_new = common.xla_fma(state["C"], fw[..., None, None],
                           iw[..., None, None] * (k[..., :, None] * v[..., None, :]))
    n_new = common.xla_fma(state["n"], fw[..., None], iw[..., None] * k)
    num = _f32_matmul(engine, q[..., None, :], c_new)[..., 0, :]
    qn = (n_new * q).sum(-1)
    denom = torch.maximum(qn.abs(), common.xla_exp(-m_new))
    y = (num / denom[..., None]).reshape(b, 1, -1).to(x.dtype)
    y = y * common.xla_sigmoid(common.dense_apply(params["ogate"], x, engine).float()).to(x.dtype)
    out = common.dense_apply(params["out"], y, engine)
    return out, {"C": c_new, "n": n_new, "m": m_new}


def mlstm_init_state(batch: int, cfg: XLSTMConfig, device) -> dict:
    h, hd = cfg.n_heads, cfg.head_dim
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), _LOG_ZERO, dtype=torch.float32, device=device),
    }


# -- sLSTM ---------------------------------------------------------------------------


def slstm_init(gen: torch.Generator, cfg: XLSTMConfig, dtype: torch.dtype, device) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    r = torch.randn((4, h, hd, hd), generator=gen, device=device) / math.sqrt(hd)
    return {
        "wx": common.dense_init(gen, d, 4 * d, dtype, device),  # z, i, f, o pre-activations
        # Recurrent weights, block-diagonal by head (xLSTM Sec. 2.2).
        "r": r.to(dtype),
        "out": common.dense_init(gen, d, d, dtype, device),
    }


def _slstm_cell(engine: Engine, wx_t, r, h_prev, c_prev, n_prev, m_prev, nheads: int,
                hd: int, masked: bool = False):
    """One sLSTM step in fp32. wx_t: (B, 4D); r: (4, H, hd, hd); the state
    leaves (B, H, hd). The recurrence is one (4, H)-batched fp32 product
    of each head's (B, hd) rows with its four hd x hd blocks.

    ``c = fw c_prev + iw z`` contracts into a fused multiply-add as XLA's
    compiled code does: on fw c_prev, except that in a ``masked`` scan step
    (the reference's ``where(keep, c, c_prev)``) XLA computes the carried c
    in a fusion of its own that contracts iw z, while h still reads the
    first. The returned c is the carried one."""
    rows = h_prev.transpose(0, 1)[None].expand(4, -1, -1, -1)  # (4, H, B, hd)
    rf = autodiff.summed_like(r.float(), r)  # a data-parallel sum stays on r's fp32 copy
    rh = _f32_matmul(engine, rows, rf).permute(2, 0, 1, 3)  # (B, 4, H, hd)
    pre = wx_t.reshape(wx_t.shape[0], 4, nheads, hd).float() + rh
    z = common.xla_tanh(pre[:, 0])
    log_i = pre[:, 1]
    log_f = -common.xla_softplus(-pre[:, 2])  # the sigmoid gate in log space
    o = common.xla_sigmoid(pre[:, 3])
    m_new = torch.maximum(log_f + m_prev, log_i)
    iw = common.xla_exp(log_i - m_new)
    fw = common.xla_exp(log_f + m_prev - m_new)
    c = common.xla_fma(fw, c_prev, iw * z)
    n = common.xla_fma(fw, n_prev, iw)
    h = o * c / torch.clamp(n, min=1e-6)
    if masked:
        c = common.xla_fma(iw, z, fw * c_prev)
    return h, c, n, m_new


def slstm_apply(params, x: torch.Tensor, cfg: XLSTMConfig, engine: Engine, *,
                state: dict | None = None, lengths: torch.Tensor | None = None, tp=None):
    """The sequential sLSTM over x (B, S, D): one cell step a position. A
    pad step of ``lengths`` leaves the carry untouched. Returns (y,
    {"h", "c", "n", "m"} fp32)."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    wx = tpl.whole_linear(x, params["wx"], engine, tp, 4 * d)  # (B, S, 4D)
    if state is None:
        zeros = torch.zeros((b, h, hd), dtype=torch.float32, device=x.device)
        carry = (zeros, zeros, zeros, torch.full_like(zeros, _LOG_ZERO))
    else:
        carry = (state["h"], state["c"], state["n"], state["m"])
    keep = None if lengths is None else (
        torch.arange(s, device=x.device)[:, None] < lengths[None, :])[:, :, None, None]
    hs = []
    for t in range(s):
        new = _slstm_cell(engine, wx[:, t], params["r"], *carry, h, hd, masked=keep is not None)
        hs.append(new[0])
        carry = new if keep is None else tuple(
            torch.where(keep[t], a, o) for a, o in zip(new, carry))
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return _out(params, y, x, engine, tp, d), dict(zip(("h", "c", "n", "m"), carry))


def slstm_decode(params, x: torch.Tensor, state: dict, cfg: XLSTMConfig, engine: Engine):
    wx = common.dense_apply(params["wx"], x, engine)[:, 0]
    h_new, c, n, m = _slstm_cell(engine, wx, params["r"], state["h"], state["c"], state["n"],
                                 state["m"], cfg.n_heads, cfg.head_dim)
    out = common.dense_apply(params["out"], h_new.reshape(x.shape[0], 1, -1).to(x.dtype),
                             engine)
    return out, {"h": h_new, "c": c, "n": n, "m": m}


def slstm_init_state(batch: int, cfg: XLSTMConfig, device) -> dict:
    z = torch.zeros((batch, cfg.n_heads, cfg.head_dim), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(), "m": torch.full_like(z, _LOG_ZERO)}
