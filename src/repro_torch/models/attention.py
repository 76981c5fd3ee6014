"""GQA attention (counterpart of ``repro.models.attention``): the training
forward over a whole sequence, the serving paths over the paged KV token
pools, and the ring-buffer cache of static-batch serving.

- the full-sequence path (no cache; the training forward) attends over the
  fresh k/v with the online softmax of :func:`_online_attention` in
  ``kv_chunk`` key chunks, both products through the engine (forward and
  backward), as the reference's ``apply`` without a cache does. It writes
  no pages: the pool writes are in place and stay off the autograd path;
- prefill (whole prompt, from position 0) attends over the fresh k/v the
  same way and writes them into the pool;
- chunked prefill (``paged.chunked``) writes the chunk's fresh k/v into
  the pool, gathers the slot's pages back through ``read_idx`` and attends
  over [gathered pages | fresh chunk], both products through the engine;
  the gathered entries at or past the chunk's start are masked, so no key
  counts twice;
- decode (one token per slot) reads the pool through the page table. On
  the ``"cuda"`` backend the paged flash-decode kernel walks each slot's
  pages itself; on ``"torch"`` the layer gathers the pages through
  ``read_idx`` and runs :func:`_online_attention`, as the reference's XLA
  backend does. The two differ under an fp8 policy exactly as the
  reference's two backends do: the gathered path runs its score and value
  products through the engine, which rounds q and the probabilities to
  E4M3, while the paged kernel computes in fp32. A model built with
  ``fused_decode=True`` on ``"torch"`` runs the kernel's plain version
  instead, which is the kernel's own semantics;
- the ring buffer (``cache``, static-batch serving, every sequence at one
  position): a prefill from position 0 attends over the fresh k/v and
  stores them; a decode step appends one token and attends over the whole
  buffer, its products through the engine.

Fresh K/V are written into the layer's pool or ring in place (the
reference's ``.at[].set`` and ``dynamic_update_slice`` return new arrays;
the port updates the tensors it owns). Pad rows and inactive slots write
into the null page 0, which is never read back as valid.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.precision import cast, put_rows_, take_rows
from repro_torch.distrib import tensor_parallel as tpl
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
        prefill (the fresh keys), (B, L) for decode (the gathered pages),
        (B, L + Sq) for chunked prefill.
    read_idx: (B, L) flat pool indices of each slot's pages in position
        order; set for a gathered decode step and for chunked prefill.
    pages, seq_lens, active: the page table (B, P), decode positions (B,)
        and live-slot mask (B,) of a decode step, else None.
    page_size: tokens per page.
    fused: decode through the paged flash-decode attention (the kernel on
        ``"cuda"``, its plain version on ``"torch"``) instead of gathering
        the pages and running :func:`_online_attention`.
    chunked: a chunked-prefill step: ``read_idx`` (B, L) is set and the
        layer attends over [gathered pages | fresh k/v], with ``k_pos``
        (B, L + Sq) covering both.
    slots, starts, lengths: (B,) each row's state row, the position of its
        first token and its valid tokens, for the recurrent layers' state
        rows (``models/transformer.py``); ``active`` then marks the rows
        whose state is committed.
    """

    write_idx: torch.Tensor
    k_pos: torch.Tensor | None
    read_idx: torch.Tensor | None = None
    pages: torch.Tensor | None = None
    seq_lens: torch.Tensor | None = None
    active: torch.Tensor | None = None
    page_size: int = 0
    fused: bool = False
    chunked: bool = False
    slots: torch.Tensor | None = None
    starts: torch.Tensor | None = None
    lengths: torch.Tensor | None = None


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
    (B, Hkv, G, Sq, hd) layout computes. On the CPU the softmax's exp, sum
    and rescales are XLA's compiled ones (``common.xla_*``; the last chunk's
    sum as the reference's zero-padded chunk), so the output is the
    reference's bit for bit where the products are.
    """
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    hkv = cfg.n_kv_heads
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    q_pos = q_pos.reshape(-1, sq)
    k_pos = k_pos.reshape(-1, sk)

    qh = q.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)  # (B, Hkv, G, Sq, hd)
    # On the CPU under autograd, the reference's layout: each group's
    # product apart and K and V broadcast over the groups, so that dK and
    # dV are each group's gradient in the compute format summed over them,
    # as the reference's. The forward bits are the same either way
    # (tests/test_torch_xla_sites.py); serving keeps the card's layout.
    grouped = g > 1 and common.xla_rounds(q, q.dtype) and torch.is_grad_enabled()
    if not grouped:
        qh = qh.reshape(b, hkv, g * sq, hd)
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
        kt = kc.transpose(-1, -2)
        s = engine.matmul(qh, kt[:, :, None] if grouped else kt)  # (B, Hkv, G*Sq | G, Sq, C)
        s = common.softcap(s.float().reshape(b, hkv, g, sq, c) * scale, cfg.softcap)
        mask = kp[:, None, :] != POS_SENTINEL  # (B|1, 1, C)
        if causal:
            mask = mask & (kp[:, None, :] <= q_pos[:, :, None])
        if cfg.window is not None:
            mask = mask & (kp[:, None, :] > q_pos[:, :, None] - cfg.window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = common.xla_exp(m - m_new)
        p = common.xla_exp(s - m_new[..., None])
        l_sum = common.xla_fma(l_sum, alpha, common.xla_sum(p, -1, chunk)[..., 0])
        pv = (engine.matmul(p.to(q.dtype), vc[:, :, None]) if grouped
              else engine.matmul(p.to(q.dtype).reshape(b, hkv, g * sq, c), vc))
        acc = common.xla_fma(acc, alpha[..., None], pv.float().reshape(b, hkv, g, sq, hd))
        m = m_new
    out = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def apply(params, x: torch.Tensor, positions: torch.Tensor, cfg: AttnConfig,
          engine: Engine, *, pool: dict | None = None,
          paged: PagedInfo | None = None, cache: dict | None = None,
          causal: bool = True, cross_kv: tuple | None = None, tp=None) -> torch.Tensor:
    """One attention layer. x: (B, S, D); positions: (S,) or (B, S) absolute
    positions. With ``pool`` (the layer's {"kp", "vp"} flat (n_tok, Hkv, hd)
    token pools, updated in place) and ``paged``, the serving paths; with
    ``cache`` (the layer's ring buffer, :func:`init_cache`, updated in
    place), static-batch serving; with neither, the full-sequence path of
    the training forward, causal unless ``causal=False`` (an encoder).

    ``cross_kv`` = (k, v, k_pos): an encoder-decoder's cross-attention
    over the encoder's keys and values (B, Se, Hkv, hd) in the compute
    format at positions k_pos (Se,), under a config without a window. Only
    q is projected here; neither q nor k is rotated, and the mask is not
    causal.

    ``tp`` (a ``tensor_parallel.TP``; the full-sequence path only): the
    params are this rank's pieces, and ``cross_kv`` holds k and v as the
    rank's k and v pieces give them."""
    b, s, _ = x.shape
    hd, dq = cfg.head_dim, cfg.n_heads * cfg.head_dim
    q = tpl.linear(x, params["q"], engine, tp, dq)  # TP: this rank's columns
    if cross_kv is not None:
        k, v, k_pos = cross_kv
    else:
        k = tpl.linear(x, params["k"], engine, tp, cfg.n_kv_heads * hd).reshape(b, s, -1, hd)
        v = tpl.linear(x, params["v"], engine, tp, cfg.n_kv_heads * hd).reshape(b, s, -1, hd)
        k_pos = positions
    gathered = False
    if q.shape[-1] != dq and k.shape[2] == cfg.n_kv_heads:
        # q split over the axis, K/V whole: this rank's query heads take
        # their groups' KV heads; where q's piece ends inside a head, q is
        # gathered and every head attended replicated.
        hq = q.shape[-1] // hd
        span = None if q.shape[-1] % hd else _local_kv(tp.index * hq, hq, cfg)
        if span is None:
            q, gathered = tpl.gather_from(q, tp), True
        else:
            k = tpl.grad_sum(k, tp)[:, :, span[0]:span[1]]
            v = tpl.grad_sum(v, tp)[:, :, span[0]:span[1]]
    hq = q.shape[-1] // hd
    q = q.reshape(b, s, hq, hd)
    if hq != cfg.n_heads or k.shape[2] != cfg.n_kv_heads:
        cfg = cfg._replace(n_heads=hq, n_kv_heads=k.shape[2])
    if cross_kv is not None:
        out = _online_attention(q, k, v, positions, k_pos, cfg, engine, causal=False)
    else:
        pos2d = positions if positions.dim() == 2 else positions[None]
        q = common.apply_rope(q, pos2d, cfg.rope_theta, cfg.rope_fraction)
        k = common.apply_rope(k, pos2d, cfg.rope_theta, cfg.rope_fraction)
        if cache is not None:
            out = _ring_attention(q, k, v, positions, cache, cfg, engine)
        elif pool is None:
            out = _online_attention(q, k, v, positions, positions, cfg, engine, causal=causal)
        else:
            out = _paged_attention(q, k, v, positions, pool, paged, cfg, engine)
    out = out.reshape(b, s, hq * hd)
    if gathered:
        out = tpl.split_to(out, tp)
    return tpl.out_linear(out, params["o"], engine, tp, dq)


def _local_kv(q0: int, hq_l: int, cfg: AttnConfig):
    """The KV heads [k0, k1) that query heads [q0, q0 + hq_l) use under GQA,
    or None where their groups are not uniform over those heads."""
    g = cfg.n_heads // cfg.n_kv_heads
    if hq_l % g == 0 and q0 % g == 0:
        return q0 // g, (q0 + hq_l) // g
    if g % hq_l == 0 and q0 // g == (q0 + hq_l - 1) // g:
        return q0 // g, q0 // g + 1
    return None


def _paged_attention(q, k, v, positions, pool: dict, paged: PagedInfo, cfg: AttnConfig,
                     engine: Engine) -> torch.Tensor:
    b, s, hkv, hd = k.shape
    kp, vp = pool["kp"], pool["vp"]
    put_rows_(kp, paged.write_idx, cast(k.reshape(b * s, hkv, hd), kp.dtype))
    put_rows_(vp, paged.write_idx, cast(v.reshape(b * s, hkv, hd), vp.dtype))
    if paged.pages is not None and paged.fused:
        # Decode through the paged flash-decode attention: it walks each
        # slot's pages, dequantizes fp8 pages in the tile and computes in
        # fp32 (on "cuda" the kernel, on "torch" its plain version).
        return kernel_ops.paged_decode_attention(
            q[:, 0], kp, vp, paged.pages, paged.seq_lens, paged.active,
            page_size=paged.page_size, window=cfg.window, softcap=cfg.softcap,
            backend=engine.backend,
        )[:, None]
    if paged.read_idx is not None:
        # Gather every slot's pages in position order: the plain decode (as
        # the reference's XLA backend does), or the earlier chunks of a
        # chunked prefill, ahead of the chunk's fresh keys.
        compute = engine.policy.compute
        gk = take_rows(kp, paged.read_idx).to(compute)
        gv = take_rows(vp, paged.read_idx).to(compute)
        if paged.chunked:
            k, v = torch.cat([gk, k.to(compute)], dim=1), torch.cat([gv, v.to(compute)], dim=1)
        else:
            k, v = gk, gv
    return _online_attention(q, k, v, positions, paged.k_pos, cfg, engine)


def _ring_attention(q, k, v, positions, cache: dict, cfg: AttnConfig,
                    engine: Engine) -> torch.Tensor:
    """The ring-buffer cache of static-batch serving, as the reference's
    ``apply`` with a cache: ``index`` counts ring writes, so the next write
    goes to ``index % max_len``. A prefill (S > 1, from position 0) stores
    the last ``max_len`` fresh k/v and attends over the fresh ones; a
    decode step stores its token and attends over the whole buffer, read
    back in the compute format."""
    s = k.shape[1]
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    max_len = ck.shape[1]
    if s > 1:
        keep = min(s, max_len)
        ck[:, :keep] = cast(k[:, -keep:], ck.dtype)
        cv[:, :keep] = cast(v[:, -keep:], cv.dtype)
        cpos[:keep] = positions[-keep:]
        cache["index"] += keep
        return _online_attention(q, k, v, positions, positions, cfg, engine)
    slot = cache["index"] % max_len
    ck[:, slot:slot + 1] = cast(k, ck.dtype)
    cv[:, slot:slot + 1] = cast(v, cv.dtype)
    cpos[slot:slot + 1] = positions
    cache["index"] += 1
    compute = engine.policy.compute
    return _online_attention(q, ck.to(compute), cv.to(compute), positions, cpos, cfg, engine)


def init_cache(batch: int, max_len: int, cfg: AttnConfig, dtype, device) -> dict:
    """One layer's ring buffer: K/V (B, max_len, Hkv, hd), the absolute
    position of each entry (POS_SENTINEL while unwritten) and the count of
    writes (a host integer: every sequence of the batch shares it)."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((max_len,), POS_SENTINEL, dtype=torch.int64, device=device),
            "index": 0}


def init_paged_pool(n_tokens: int, cfg: AttnConfig, dtype, device) -> dict:
    """One layer's flat KV token pool (n_pages * page_size slots)."""
    shape = (n_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}
