"""Flash attention on Hopper: the paged flash-decode kernel and the dense
flash-attention kernel, each with its launch wrapper and plain version.

:func:`paged_flash_decode` launches ``csrc/paged_decode.cu``, the port of
the TPU kernel ``repro/kernels/flash_attention.py::paged_flash_decode_pallas``:
one fresh query token per slot against the flat KV token pools, read
through the page table, with an online softmax across pages, dead pages
skipped and inactive slots returning zeros. The page walk is split across
blocks (:func:`decode_splits` picks the count from shapes) and the
partials are combined in split order inside the same launch;
:func:`paged_flash_decode_split_plain` is that algorithm in plain PyTorch,
for the tests.

:func:`paged_flash_decode_plain` is the same function with plain PyTorch
ops: it gathers every slot's pages through the page table in position
order and runs the softmax over them in fp32. The CPU path and the tests use
it, and ``chip_smoke.py`` holds the kernel against it on the card.

:func:`flash_attention` launches one of two ports of
``repro/kernels/flash_attention.py::flash_attention_pallas``, by the route
:func:`plan_flash` names from shapes and formats: ``csrc/flash_attention_tc.cu``
(wgmma fed by TMA; fp16 and bf16 with hd 64 or 128) or
``csrc/flash_attention.cu`` (fp32 on the CUDA cores; every other case):
dense online-softmax attention over (B, S, H, hd) tensors with a top-left
causal mask, softcap, GQA read in place and ragged lengths masked in the
kernel.
:func:`flash_attention_plain` runs the same online softmax over
``block_k`` key chunks in fp32, with p rounded to v's format before the PV
product as the kernel does, so the two differ only in the order of their
sums. Only the entry point ``ops.flash_attention`` calls them: as in the
JAX package, no model path runs the dense kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.precision import take_rows
from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# Launches of each CUDA kernel since the last reset (chip_smoke.py reads
# them): ``launches`` counts the paged decode, ``dense_launches`` the dense
# flash attention's SIMT kernel and ``dense_tc_launches`` its tensor-core
# kernel.
launches = _build.LaunchCount()
dense_launches = _build.LaunchCount()
dense_tc_launches = _build.LaunchCount()

_MAX_HEAD_DIM = 256
_DECODE_HEAD_DIMS = (8, 16, 32, 64, 128, 256)
_DECODE_GROUP = 4  # query heads a decode block (a head group)
_SMS = 132  # streaming multiprocessors of an H100 SXM
_DECODE_BLOCKS_PER_SM = 4  # decode blocks an SM holds at once, about
_DECODE_STEP_BYTES = 8192  # K bytes a decode step aims to bring into shared memory
_DECODE_MIN_SPLIT_PAGES = 16  # the shortest page walk worth a split of its own

# Per (device, units): the decode combine's ticket counters, zero between
# launches (the kernel's last split resets its own), made once.
_counters: dict = {}


def decode_splits(s: int, hkv: int, pages_per_slot: int, *, groups: int = 1) -> int:
    """Blocks that split one (slot, KV head, head group)'s page walk.

    From shapes alone (no device read, no host sync): as many splits as
    keep ``s * hkv * groups * splits`` blocks within one wave of the card
    (132 SMs, about four resident decode blocks each), but no split shorter
    than 16 pages, where a split's start and the combine cost more than its
    walk saves; 1 when the units alone fill the SMs. Each split walks
    ``ceil(pages_per_slot / splits)`` contiguous logical pages, and the
    count is the one that leaves no split empty.
    """
    units = s * hkv * groups
    if units >= _SMS:
        return 1
    wave = _SMS * _DECODE_BLOCKS_PER_SM // units
    want = max(1, min(wave, pages_per_slot // _DECODE_MIN_SPLIT_PAGES))
    per = -(-pages_per_slot // want)  # pages a split; the last may be shorter
    return -(-pages_per_slot // per)


def _decode_counters(device: torch.device, units: int) -> torch.Tensor:
    key = (device, units)
    if key not in _counters:
        _counters[key] = torch.zeros(units, dtype=torch.int32, device=device)
    return _counters[key]


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                       page_table: torch.Tensor, seq_lens: torch.Tensor,
                       active: torch.Tensor, *, page_size: int,
                       window: int | None = None,
                       softcap: float | None = None,
                       splits: int | None = None) -> torch.Tensor:
    """Launch the CUDA paged-decode kernel.

    q: (S, Hkv, G, hd) grouped queries (fp32, fp16 or bf16); k_pool/v_pool:
    (n_pages * page_size, Hkv, hd) in any storage format; page_table:
    (S, P) physical page ids (0 = NULL); seq_lens: (S,) decode positions;
    active: (S,) slots that decode. hd is a power of two from 8 to 256.
    ``splits`` overrides :func:`decode_splits` (the tests use it). Returns
    (S, Hkv, G, hd) in q's dtype. Calls on one device share a cached
    counter, so they must run on one stream.
    """
    tensors = (q, k_pool, v_pool, page_table, seq_lens, active)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("paged_flash_decode launches the CUDA kernel: every input must be on one card")
    s, hkv, g, hd = q.shape
    if k_pool.shape[1:] != (hkv, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match q {tuple(q.shape)}")
    if hd not in _DECODE_HEAD_DIMS:
        raise ValueError(f"the kernel takes hd in {_DECODE_HEAD_DIMS}, not {hd}")
    if k_pool.shape[0] % page_size:
        raise ValueError("pool length is not a whole number of pages")
    q = q.contiguous()
    k_pool, v_pool = k_pool.contiguous(), v_pool.contiguous()
    page_table = page_table.to(torch.int32).contiguous()
    seq_lens = seq_lens.to(torch.int32).contiguous()
    active = active.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if s == 0:
        return out
    pages = page_table.shape[1]
    groups = -(-g // _DECODE_GROUP)
    units = s * hkv * groups
    if splits is None:
        splits = decode_splits(s, hkv, pages, groups=groups)
    per_split = max(1, -(-pages // max(1, splits)))
    splits = max(1, -(-pages // per_split))
    row_bytes = hd * k_pool.element_size()
    per_step = max(1, min(per_split, _DECODE_STEP_BYTES // row_bytes // page_size))
    part_acc = part_ml = counters = None
    if splits > 1:
        part_acc = torch.empty((units, splits, _DECODE_GROUP, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((units, splits, _DECODE_GROUP, 2), dtype=torch.float32,
                              device=q.device)
        counters = _decode_counters(q.device, units)
    lib = _build.library()
    err = lib.paged_decode_launch(
        q.data_ptr(), _build.dtype_code(q), k_pool.data_ptr(), v_pool.data_ptr(),
        _build.dtype_code(k_pool), page_table.data_ptr(), seq_lens.data_ptr(),
        active.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (part_acc, part_ml, counters)),
        s, hkv, g, hd, pages, page_size,
        0 if window is None else int(window), splits, per_split, per_step,
        0.0 if softcap is None else float(softcap),
        1.0 / math.sqrt(hd), _build.stream_handle(q),
    )
    _build.check_launch(err, "paged_flash_decode")
    launches.n += 1
    return out


def paged_flash_decode_plain(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                             page_table: torch.Tensor, seq_lens: torch.Tensor,
                             active: torch.Tensor, *, page_size: int,
                             window: int | None = None,
                             softcap: float | None = None) -> torch.Tensor:
    """The paged decode with plain PyTorch ops, on any device: gather each
    slot's pages in position order, mask positions past the decode position
    (and outside the window), softmax in fp32. Same arguments and result as
    :func:`paged_flash_decode`, up to the order of fp32 sums."""
    s, hkv, g, hd = q.shape
    n_tok = page_table.shape[1] * page_size
    offs = torch.arange(page_size, device=q.device)
    read_idx = (page_table.long()[:, :, None] * page_size + offs).reshape(s, n_tok)
    k = take_rows(k_pool, read_idx).float().permute(0, 2, 3, 1)  # (S, Hkv, hd, T)
    v = take_rows(v_pool, read_idx).float().permute(0, 2, 1, 3)  # (S, Hkv, T, hd)
    pos = torch.arange(n_tok, device=q.device)[None]
    lens = seq_lens.long()[:, None]
    mask = pos <= lens
    if window is not None:
        mask &= pos > lens - window
    scores = torch.matmul(q.float(), k) * (1.0 / math.sqrt(hd))  # (S, Hkv, G, T)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    m = scores.amax(-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.exp(scores - m)
    out = torch.matmul(p, v) / p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.where(active.bool()[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_flash_decode_split_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor, page_table: torch.Tensor,
                                   seq_lens: torch.Tensor, active: torch.Tensor, *,
                                   page_size: int, splits: int, window: int | None = None,
                                   softcap: float | None = None) -> torch.Tensor:
    """The CUDA kernel's split algorithm with plain PyTorch ops, for the
    tests: the slot's pages cut into ``splits`` contiguous ranges of
    ``ceil(P / splits)`` pages, each range's unnormalised partial (m, l,
    acc) over its live pages (NULL, past the decode position or wholly
    outside the window: dead, as the kernel drops them), then the partials
    combined in split order (m = max m_i, l = sum l_i e^(m_i - m), acc
    likewise, out = acc / max(l, 1e-30)). A range with no live token gives
    m = NEG_INF, l = 0. Same arguments and result as :func:`paged_flash_decode`."""
    s, hkv, g, hd = q.shape
    pages = page_table.shape[1]
    per = max(1, -(-pages // max(1, splits)))
    offs = torch.arange(page_size, device=q.device)
    lens = seq_lens.long()[:, None]
    parts = []
    for p0 in range(0, pages, per):
        pt = page_table[:, p0:p0 + per].long()
        n_tok = pt.shape[1] * page_size
        read_idx = (pt[:, :, None] * page_size + offs).reshape(s, n_tok)
        k = take_rows(k_pool, read_idx).float().permute(0, 2, 3, 1)  # (S, Hkv, hd, T)
        v = take_rows(v_pool, read_idx).float().permute(0, 2, 1, 3)  # (S, Hkv, T, hd)
        base = (p0 + torch.arange(pt.shape[1], device=q.device))[None] * page_size
        live = (pt != 0) & (base <= lens)
        pos = p0 * page_size + torch.arange(n_tok, device=q.device)[None]
        mask = live.repeat_interleave(page_size, 1) & (pos <= lens)
        if window is not None:
            live_w = base + page_size - 1 > lens - window
            mask &= live_w.repeat_interleave(page_size, 1) & (pos > lens - window)
        scores = torch.matmul(q.float(), k) * (1.0 / math.sqrt(hd))  # (S, Hkv, G, T)
        if softcap is not None:
            scores = softcap * torch.tanh(scores / softcap)
        mask = mask[:, None, None, :]
        scores = torch.where(mask, scores, NEG_INF)
        m = scores.amax(-1, keepdim=True)
        p = torch.where(mask, torch.exp(scores - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True), torch.matmul(p, v)))
    m_all = parts[0][0]
    for m, _, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    l_sum = torch.zeros_like(m_all)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for m, l_i, acc_i in parts:
        w = torch.exp(m - m_all)
        l_sum = l_sum + l_i * w
        acc = acc + acc_i * w
    out = acc / l_sum.clamp(min=1e-30)
    out = torch.where(active.bool()[:, None, None, None], out, 0.0)
    return out.to(q.dtype)


def plan_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The dense flash attention's route for these operands, from shapes and
    formats alone: ``"tc"`` (``csrc/flash_attention_tc.cu``, wgmma fed by
    TMA) for fp16 and bf16 with hd 64 or 128, else ``"simt"``
    (``csrc/flash_attention.cu``, fp32 on the CUDA cores): fp32, and every
    other hd. hd 256 (gemma2) stays on the SIMT kernel: its fp32 output
    accumulator (128 registers a thread) beside the 64 of the score tile,
    and a 64 KB Q tile with two 128 KB K/V stages, do not fit one block."""
    del k, v  # one format and hd for all three (the wrapper checks)
    if q.dtype in (torch.float16, torch.bfloat16) and q.shape[-1] in (64, 128):
        return "tc"
    return "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float | None = None) -> torch.Tensor:
    """Launch the CUDA dense flash-attention kernel.

    q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd), one format among fp32, fp16
    and bf16, Hq a multiple of Hkv, hd <= 256. Returns (B, Sq, Hq, hd) in
    q's format. :func:`plan_flash` names the kernel; the tiles are each
    kernel's own (tensor cores: 128 query rows, 128 keys; SIMT: 64, 32).
    """
    tensors = (q, k, v)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("flash_attention launches the CUDA kernel: every input must be on one card")
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, hkv, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % hkv or hd > _MAX_HEAD_DIM or not (k.dtype == v.dtype == q.dtype):
        raise ValueError("the kernel takes Hq a multiple of Hkv, hd <= 256 and one format")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    tc = plan_flash(q, k, v) == "tc"
    lib = _build.library()
    launch = lib.flash_attention_tc_launch if tc else lib.flash_attention_launch
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _build.dtype_code(q),
        b, sq, sk, hq, hkv, hd, int(causal),
        0.0 if softcap is None else float(softcap), 1.0 / math.sqrt(hd),
        _build.stream_handle(q),
    )
    _build.check_launch(err, "flash_attention")
    (dense_tc_launches if tc else dense_launches).n += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, softcap: float | None = None,
                          block_k: int = 128) -> torch.Tensor:
    """The dense flash attention with plain PyTorch ops, on any device: the
    online softmax over ``block_k`` key chunks in fp32, p rounded to v's
    format before the PV product. Same arguments and result as
    :func:`flash_attention`, up to the order of fp32 sums. GQA folds the
    query heads of one KV head together, with no repeated keys."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)  # (B, Hkv, G, Sq, hd)
    kf = k.permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, Sk, hd)
    vf = v.permute(0, 2, 1, 3)[:, :, None]
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, hd), dtype=torch.float32, device=q.device)
    k_end = min(sk, sq) if causal else sk  # later chunks are masked for every row
    for k0 in range(0, k_end, block_k):
        kc = kf[..., k0:k0 + block_k, :].float()
        s = torch.matmul(qf, kc.transpose(-1, -2)) * scale  # (B, Hkv, G, Sq, C)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            k_pos = torch.arange(k0, k0 + kc.shape[-2], device=q.device)[None, :]
            s = torch.where(k_pos <= q_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
        pv = torch.matmul(p.to(v.dtype).float(), vf[..., k0:k0 + block_k, :].float())
        acc = acc * alpha + pv
        m = m_new
    out = acc / l_sum.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)
