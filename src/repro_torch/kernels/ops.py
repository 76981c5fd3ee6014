"""Dispatch into the port's kernels: the counterpart of ``repro.kernels.ops``.

Each entry point takes ``backend``:

- ``"cuda"`` launches the hand-written kernel and requires CUDA tensors;
- ``"torch"`` runs the kernel's plain PyTorch version, on any device;
- ``None`` (the default) follows the tensors: a CUDA tensor goes to the
  kernel, a CPU tensor to the plain version.

Nothing falls back: a failing build or launch raises.

Each entry point also counts its call's operations and bytes into the
roofline recorders that are open (``repro_torch.roofline.cost``); with
none open that is one test of an empty list.
"""
from __future__ import annotations

import torch

from repro_torch.core import semiring
from repro_torch.core.precision import FP32_REF, PrecisionPolicy, cast
from repro_torch.core.semiring import GemmOp
from repro_torch.kernels.flash_attention import (
    flash_attention_plain,
    paged_flash_decode,
    paged_flash_decode_plain,
)
from repro_torch.kernels.flash_attention import flash_attention as flash_attention_cuda
from repro_torch.kernels.redmule_gemm import redmule_gemm, redmule_gemm_plain
from repro_torch.kernels.tuning import GemmRequest
from repro_torch.roofline import cost as _cost

BACKENDS = ("cuda", "torch")


def resolve_backend(backend: str | None, t: torch.Tensor) -> str:
    if backend is None:
        return "cuda" if t.is_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' launches the CUDA kernels and needs CUDA tensors")
    return backend


def gemm_op(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None = None, *,
            gop: GemmOp = semiring.MATMUL, policy: PrecisionPolicy = FP32_REF,
            out_dtype: torch.dtype | None = None, operand_quant: bool = True,
            backend: str | None = None,
            schedule: str | None = None, split: int | None = None,
            form: str | None = None, widen: bool | None = None) -> torch.Tensor:
    """Z = star(Y, star_k(circ(X, W))) under ``policy``.

    x: (..., M, K); w: (K, N) or (..., K, N); y: optional (M, N) or
    (..., M, N); leading dims broadcast, and an unbatched w is shared
    across the batch, never replicated. ``operand_quant`` casts x and w to
    the policy's forward storage format first; callers that quantized
    already pass False and their dtypes go to the kernel untouched. Y is
    carried in the accumulator format, so Z rounds once at the output cast.

    ``schedule``, ``split``, ``form`` and ``widen`` ask the kernel for a
    plan (``kernels/tuning.py``); None defers to ``REPRO_TORCH_GEMM_PLAN``,
    the autotune cache and the tables. They take the place of the
    reference's TPU tiles ``block_m/n/k``: the card's tiles are fixed in
    ``csrc/``. The plain version has no plan and ignores all four.
    """
    request = None
    if schedule is not None or split is not None or form is not None or widen is not None:
        request = GemmRequest(schedule, split, form, widen)
    out_dtype = policy.out if out_dtype is None else out_dtype
    backend = resolve_backend(backend, x)
    if operand_quant:
        x = cast(x, policy.storage_fwd)
        w = cast(w, policy.storage_fwd)
    if y is not None:
        y = y.to(policy.acc)
    if _cost._active:
        _cost.note("redmule_gemm", _cost.gemm_cost, x, w, y, gop=gop, policy=policy,
                   out_dtype=out_dtype)
    if backend == "torch":
        return redmule_gemm_plain(x, w, y, gop=gop, policy=policy, out_dtype=out_dtype)
    return redmule_gemm(x, w, y, gop=gop, policy=policy, out_dtype=out_dtype, request=request)


def matmul(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None = None, *,
           policy: PrecisionPolicy = FP32_REF, backend: str | None = None,
           **kw) -> torch.Tensor:
    """:func:`gemm_op` with the (mul, add) pair: x @ w (+ y) under ``policy``."""
    return gemm_op(x, w, y, gop=semiring.MATMUL, policy=policy, backend=backend, **kw)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, seq_lens: torch.Tensor,
                           active: torch.Tensor, *, page_size: int,
                           window: int | None = None, softcap: float | None = None,
                           backend: str | None = None,
                           splits: int | None = None) -> torch.Tensor:
    """Fused paged flash-decode attention over the flat KV token pools.

    q: (S, Hq, hd), one fresh query token per slot; pools:
    (n_pages * page_size, Hkv, hd); page_table: (S, P) (0 = NULL);
    seq_lens: (S,) position of the fresh token; active: (S,) live slots.
    Returns (S, Hq, hd) in q's dtype, zeros for inactive slots. GQA keeps
    the reference's grouping: q is viewed as (S, Hkv, G, hd), so KV pages
    are never repeated per query head.

    ``splits`` asks the kernel to split each page walk that many ways
    (``kernels/tuning.py``); None defers to ``REPRO_TORCH_DECODE_SPLITS``,
    the autotune cache and the table. It takes the place of the
    reference's TPU tiles ``pages_per_block`` and ``head_block``. The plain
    version walks the pages unsplit and ignores it.
    """
    if splits is not None and splits < 1:
        raise ValueError(f"splits must be positive, not {splits}")
    s, hq, hd = q.shape
    hkv = k_pool.shape[1]
    qg = q.reshape(s, hkv, hq // hkv, hd)
    if _cost._active:
        _cost.note("paged_decode", _cost.paged_decode_cost, q, k_pool, page_table, seq_lens,
                   active, page_size=page_size, window=window)
    if resolve_backend(backend, q) == "cuda":
        out = paged_flash_decode(qg, k_pool, v_pool, page_table, seq_lens, active,
                                 page_size=page_size, window=window, softcap=softcap,
                                 splits=splits)
    else:
        out = paged_flash_decode_plain(qg, k_pool, v_pool, page_table, seq_lens, active,
                                       page_size=page_size, window=window, softcap=softcap)
    return out.reshape(s, hq, hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, softcap: float | None = None,
                    block_q: int = 128, block_k: int = 128,
                    backend: str | None = None) -> torch.Tensor:
    """Fused dense attention. q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd).
    Returns (B, Sq, Hq, hd) in q's format.

    The causal mask is top-left aligned (key <= query position); ragged Sq
    and Sk are masked inside the kernel, and each query head reads its KV
    head (h // G) in place. ``block_q`` and ``block_k`` keep the reference's
    signature: they are its TPU tiles, of which the plain version takes
    ``block_k`` as its key chunk; the CUDA kernel uses its own tiles.
    """
    del block_q  # a TPU tile: neither the kernel nor the plain version has a query tile
    if _cost._active:
        _cost.note("flash_attention", _cost.flash_attention_cost, q, k, v, causal=causal)
    if resolve_backend(backend, q) == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, softcap=softcap)
    return flash_attention_plain(q, k, v, causal=causal, softcap=softcap, block_k=block_k)
