"""Dispatch into the port's kernels: the counterpart of ``repro.kernels.ops``.

Each entry point takes ``backend``:

- ``"cuda"`` launches the hand-written kernel and requires CUDA tensors;
- ``"torch"`` runs the kernel's plain PyTorch version, on any device;
- ``None`` (the default) follows the tensors: a CUDA tensor goes to the
  kernel, a CPU tensor to the plain version.

Nothing falls back: a failing build or launch raises.
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
            backend: str | None = None) -> torch.Tensor:
    """Z = star(Y, star_k(circ(X, W))) under ``policy``.

    x: (..., M, K); w: (K, N) or (..., K, N); y: optional (M, N) or
    (..., M, N); leading dims broadcast, and an unbatched w is shared
    across the batch, never replicated. ``operand_quant`` casts x and w to
    the policy's forward storage format first; callers that quantized
    already pass False and their dtypes go to the kernel untouched. Y is
    carried in the accumulator format, so Z rounds once at the output cast.
    """
    out_dtype = policy.out if out_dtype is None else out_dtype
    backend = resolve_backend(backend, x)
    if operand_quant:
        x = cast(x, policy.storage_fwd)
        w = cast(w, policy.storage_fwd)
    if y is not None:
        y = y.to(policy.acc)
    fn = redmule_gemm if backend == "cuda" else redmule_gemm_plain
    return fn(x, w, y, gop=gop, policy=policy, out_dtype=out_dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, seq_lens: torch.Tensor,
                           active: torch.Tensor, *, page_size: int,
                           window: int | None = None, softcap: float | None = None,
                           backend: str | None = None) -> torch.Tensor:
    """Fused paged flash-decode attention over the flat KV token pools.

    q: (S, Hq, hd), one fresh query token per slot; pools:
    (n_pages * page_size, Hkv, hd); page_table: (S, P) (0 = NULL);
    seq_lens: (S,) position of the fresh token; active: (S,) live slots.
    Returns (S, Hq, hd) in q's dtype, zeros for inactive slots. GQA keeps
    the reference's grouping: q is viewed as (S, Hkv, G, hd), so KV pages
    are never repeated per query head.
    """
    s, hq, hd = q.shape
    hkv = k_pool.shape[1]
    qg = q.reshape(s, hkv, hq // hkv, hd)
    fn = (paged_flash_decode if resolve_backend(backend, q) == "cuda"
          else paged_flash_decode_plain)
    out = fn(qg, k_pool, v_pool, page_table, seq_lens, active,
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
    if resolve_backend(backend, q) == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, softcap=softcap)
    return flash_attention_plain(q, k, v, causal=causal, softcap=softcap, block_k=block_k)
