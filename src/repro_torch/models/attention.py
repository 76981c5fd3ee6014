"""GQA attention (counterpart of ``repro.models.attention``): the training
forward over a whole sequence, and the serving paths over the paged KV
token pools.

- the full-sequence path (no pool; the training forward) attends over the
  fresh k/v with the online softmax of :func:`_online_attention` in
  ``kv_chunk`` key chunks, both products through the engine (forward and
  backward), as the reference's ``apply`` without a cache does. It writes
  no pages: the pool writes are in place and stay off the autograd path;
- prefill (whole prompt, from position 0) attends over the fresh k/v the
  same way and writes them into the pool;
- decode (one token per slot) reads the pool through the page table. On
  the ``"cuda"`` backend the paged flash-decode kernel walks each slot's
  pages itself; on ``"torch"`` the layer gathers the pages through
  ``read_idx`` and runs :func:`_online_attention`, as the reference's XLA
  backend does. The two differ under an fp8 policy exactly as the
  reference's two backends do: the gathered path runs its score and value
  products through the engine, which rounds q and the probabilities to
  E4M3, while the paged kernel computes in fp32. A model built with
  ``fused_decode=True`` on ``"torch"`` runs the kernel's plain version
  instead, which is the kernel's own semantics.

Fresh K/V are written into the layer's pool in place (the reference's
``.at[write_idx].set`` returns a new array; the port updates the pool it
owns). Pad rows and inactive slots write into the null page 0, which is
never read back as valid.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.precision import cast, put_rows_, take_rows
from repro_torch.engine import Engine
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import common

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
POS_SENTINEL = torch.iinfo(torch.int32).max // 2  # marks invalid key slots


class PagedInfo(NamedTuple):
    """Slot mappings for one step over the serving pools, shared by every
    layer (see ``repro.models.attention.PagedInfo``).

    write_idx: (B*Sq,) flat pool index of each fresh key/value.
    k_pos: key positions with POS_SENTINEL at invalid entries: (B, Sq) for
        prefill (the fresh keys), (B, L) for decode (the gathered pages).
    read_idx: (B, L) flat pool indices of each slot's pages in position
        order; set for a gathered decode step only.
    pages, seq_lens, active: the page table (B, P), decode positions (B,)
        and live-slot mask (B,) of a decode step, else None.
    page_size: tokens per page.
    fused: decode through the paged flash-decode attention (the kernel on
        ``"cuda"``, its plain version on ``"torch"``) instead of gathering
        the pages and running :func:`_online_attention`.
    """

    write_idx: torch.Tensor
    k_pos: torch.Tensor | None
    read_idx: torch.Tensor | None = None
    pages: torch.Tensor | None = None
    seq_lens: torch.Tensor | None = None
    active: torch.Tensor | None = None
    page_size: int = 0
    fused: bool = False


class AttnConfig(NamedTuple):
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    softcap: float | None = None
    window: int | None = None
    kv_chunk: int = 512


def init(gen: torch.Generator, d_model: int, cfg: AttnConfig, dtype, device):
    dq = cfg.n_heads * cfg.head_dim
    dkv = cfg.n_kv_heads * cfg.head_dim
    return {
        "q": common.dense_init(gen, d_model, dq, dtype, device),
        "k": common.dense_init(gen, d_model, dkv, dtype, device),
        "v": common.dense_init(gen, d_model, dkv, dtype, device),
        "o": common.dense_init(gen, dq, d_model, dtype, device),
    }


def _online_attention(q, k, v, q_pos, k_pos, cfg: AttnConfig, engine: Engine,
                      causal: bool = True):
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd); q_pos: (B|1, Sq);
    k_pos: (B|1, Sk), POS_SENTINEL = invalid. Online softmax over Sk chunks
    (one chunk for decode). Returns (B, Sq, Hq, hd) in q's dtype.

    The GQA group axis folds into the rows of both products: for each
    (batch, KV head) the G*Sq query rows share one key matrix, so the
    kernel sees (B, Hkv, G*Sq, hd) @ (B, Hkv, hd, C) with no repeated keys.
    Every output element is the same dot product the reference's
    (B, Hkv, G, Sq, hd) layout computes.
    """
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    hkv = cfg.n_kv_heads
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    q_pos = q_pos.reshape(-1, sq)
    k_pos = k_pos.reshape(-1, sk)

    qh = q.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4).reshape(b, hkv, g * sq, hd)
    kh = k.permute(0, 2, 1, 3)  # (B, Hkv, Sk, hd)
    vh = v.permute(0, 2, 1, 3)
    chunk = sk if sq == 1 else min(cfg.kv_chunk, sk)

    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        kc, vc = kh[:, :, c0:c0 + chunk], vh[:, :, c0:c0 + chunk]
        kp = k_pos[:, c0:c0 + chunk]
        c = kc.shape[2]
        s = engine.matmul(qh, kc.transpose(-1, -2))  # (B, Hkv, G*Sq, C)
        s = s.float().reshape(b, hkv, g, sq, c) * scale
        if cfg.softcap is not None:
            s = cfg.softcap * torch.tanh(s / cfg.softcap)
        mask = kp[:, None, :] != POS_SENTINEL  # (B|1, 1, C)
        if causal:
            mask = mask & (kp[:, None, :] <= q_pos[:, :, None])
        if cfg.window is not None:
            mask = mask & (kp[:, None, :] > q_pos[:, :, None] - cfg.window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_sum = l_sum * alpha + p.sum(-1)
        pv = engine.matmul(p.to(q.dtype).reshape(b, hkv, g * sq, c), vc)
        acc = acc * alpha[..., None] + pv.float().reshape(b, hkv, g, sq, hd)
        m = m_new
    out = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def apply(params, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig,
          engine: Engine, *, pool: dict | None = None,
          paged: PagedInfo | None = None) -> torch.Tensor:
    """One attention layer. x: (B, S, D); positions: (S,) or (B, S) absolute
    positions. With ``pool`` (the layer's {"kp", "vp"} flat (n_tok, Hkv, hd)
    token pools, updated in place) and ``paged``, the serving paths; with
    neither, the causal full-sequence path of the training forward."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = common.dense_apply(params["q"], x, engine).reshape(b, s, hq, hd)
    k = common.dense_apply(params["k"], x, engine).reshape(b, s, hkv, hd)
    v = common.dense_apply(params["v"], x, engine).reshape(b, s, hkv, hd)
    pos2d = positions if positions.dim() == 2 else positions[None]
    q = common.apply_rope(q, pos2d, cfg.rope_theta, cfg.rope_fraction)
    k = common.apply_rope(k, pos2d, cfg.rope_theta, cfg.rope_fraction)
    if pool is None:
        out = _online_attention(q, k, v, positions, positions, cfg, engine)
        return common.dense_apply(params["o"], out.reshape(b, s, hq * hd), engine)

    kp, vp = pool["kp"], pool["vp"]
    put_rows_(kp, paged.write_idx, cast(k.reshape(b * s, hkv, hd), kp.dtype))
    put_rows_(vp, paged.write_idx, cast(v.reshape(b * s, hkv, hd), vp.dtype))
    if paged.pages is not None and paged.fused:
        # Decode through the paged flash-decode attention: it walks each
        # slot's pages, dequantizes fp8 pages in the tile and computes in
        # fp32 (on "cuda" the kernel, on "torch" its plain version).
        out = kernel_ops.paged_decode_attention(
            q[:, 0], kp, vp, paged.pages, paged.seq_lens, paged.active,
            page_size=paged.page_size, window=cfg.window, softcap=cfg.softcap,
            backend=engine.backend,
        )[:, None]
    else:
        if paged.pages is not None:
            # Decode on the plain path: gather every slot's pages in
            # position order, as the reference's XLA backend does.
            compute = engine.policy.compute
            k = take_rows(kp, paged.read_idx).to(compute)
            v = take_rows(vp, paged.read_idx).to(compute)
        out = _online_attention(q, k, v, positions, paged.k_pos, cfg, engine)
    return common.dense_apply(params["o"], out.reshape(b, s, hq * hd), engine)


def init_paged_pool(n_tokens: int, cfg: AttnConfig, dtype, device) -> dict:
    """One layer's flat KV token pool (n_pages * page_size slots)."""
    shape = (n_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}
