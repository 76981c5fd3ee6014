"""Paged flash-decode attention on Hopper: launch wrapper and plain version.

:func:`paged_flash_decode` launches ``csrc/paged_decode.cu``, the port of
the TPU kernel ``repro/kernels/flash_attention.py::paged_flash_decode_pallas``:
one fresh query token per slot against the flat KV token pools, read
through the page table, with an online softmax across pages, dead pages
skipped and inactive slots returning zeros.

:func:`paged_flash_decode_plain` is the same function with plain PyTorch
ops: it gathers every slot's pages through the page table in position
order and runs the softmax over them in fp32. The CPU path and the tests use
it, and ``chip_smoke.py`` holds the kernel against it on the card.

The dense ``flash_attention_pallas`` of the JAX package is not ported yet
(it is off the serving path; see ROADMAP.md).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.precision import take_rows
from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# Launches of the CUDA kernel since the last reset (chip_smoke.py reads it).
launches = _build.LaunchCount()

_MAX_GROUP = 16
_MAX_HEAD_DIM = 256


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                       page_table: torch.Tensor, seq_lens: torch.Tensor,
                       active: torch.Tensor, *, page_size: int,
                       window: int | None = None,
                       softcap: float | None = None) -> torch.Tensor:
    """Launch the CUDA paged-decode kernel.

    q: (S, Hkv, G, hd) grouped queries (fp32, fp16 or bf16); k_pool/v_pool:
    (n_pages * page_size, Hkv, hd) in any storage format; page_table:
    (S, P) physical page ids (0 = NULL); seq_lens: (S,) decode positions;
    active: (S,) slots that decode. Returns (S, Hkv, G, hd) in q's dtype.
    """
    tensors = (q, k_pool, v_pool, page_table, seq_lens, active)
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError("paged_flash_decode launches the CUDA kernel: every input must be on one card")
    s, hkv, g, hd = q.shape
    if k_pool.shape[1:] != (hkv, hd) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} do not match q {tuple(q.shape)}")
    if g > _MAX_GROUP or hd > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes G <= {_MAX_GROUP} and hd <= {_MAX_HEAD_DIM}")
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
    lib = _build.library()
    err = lib.paged_decode_launch(
        q.data_ptr(), _build.dtype_code(q), k_pool.data_ptr(), v_pool.data_ptr(),
        _build.dtype_code(k_pool), page_table.data_ptr(), seq_lens.data_ptr(),
        active.data_ptr(), out.data_ptr(),
        s, hkv, g, hd, page_table.shape[1], page_size,
        0 if window is None else int(window),
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
