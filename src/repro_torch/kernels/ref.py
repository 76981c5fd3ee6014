"""Plain oracle of the GEMM-Op engine and of dense attention (counterpart of
``repro.kernels.ref``), for the engine-against-oracle tests.

Semantics (paper Eq. 1 and Table 1):

    Z[m, n] = star( Y[m, n], star_k( circ(X[m, k], W[k, n]) ) )

Operands pass the input cast unit (storage -> compute) once, the reduction
runs in the accumulator format and the result passes the output cast
unit. This oracle rounds an fp32 operand once (f32 -> E4M3), where the
engine, like the reference's, rounds it twice (f32 -> fp16 -> E4M3; see
ROADMAP queue 3). The semiring path builds the whole (M, K, N) product, so
it is meant for test-sized inputs; the products are done by the
``*_plain`` helpers.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import semiring
from repro_torch.core.precision import FP32_REF, PrecisionPolicy
from repro_torch.core.semiring import GemmOp, Op


def _matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 (the operands widen exactly)."""
    return torch.matmul(a.float(), b.float())


def gemm_op_ref(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None,
                gop: GemmOp = semiring.MATMUL, policy: PrecisionPolicy = FP32_REF,
                backward: bool = False) -> torch.Tensor:
    """Reference GEMM-Op. x: (M, K), w: (K, N), y: (M, N) or None."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"expected 2-D operands, got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"inner dims disagree: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    cast_in = policy.cast_in_bwd if backward else policy.cast_in_fwd
    xc, wc = cast_in(x), cast_in(w)
    if gop.is_gemm:
        z = _matmul_plain(xc, wc).to(policy.acc)
        if y is not None:
            z = z + y.to(policy.acc)
        return policy.cast_out(z)
    circ = semiring.op_fn(gop.circ)
    # (M, K, N) circ product in the compute format, star over K in the
    # accumulator format.
    prod = circ(xc[:, :, None], wc[None, :, :]).to(policy.acc)
    if gop.star is Op.ADD:
        z = prod.sum(1)
    elif gop.star is Op.MIN:
        z = prod.amin(1)
    else:
        z = prod.amax(1)
    if y is not None:
        z = semiring.op_fn(gop.star)(y.to(policy.acc), z)
    return policy.cast_out(z)


def matmul_ref(x: torch.Tensor, w: torch.Tensor,
               policy: PrecisionPolicy = FP32_REF) -> torch.Tensor:
    return gemm_op_ref(x, w, None, semiring.MATMUL, policy)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, softcap: float | None = None) -> torch.Tensor:
    """Dense softmax attention. q: (BH, Sq, d); k/v: (BH, Sk, d). The causal
    mask is top-left aligned (key <= query position)."""
    sq, sk = q.shape[1], k.shape[1]
    s = _matmul_plain(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        mask = torch.arange(sk, device=q.device)[None, :] <= torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask[None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return _matmul_plain(p, v).to(q.dtype)
