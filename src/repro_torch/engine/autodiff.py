"""The engine's mixed-precision GEMM, forward only (the serving slice).

``mp_matmul`` keeps the reference's cast order (``repro/engine/autodiff.py``
``mp_matmul`` and ``_mp_core_fwd``): operands go to the compute format
first and then to the forward storage format, and the kernel widens them
back in the tile. For an fp32 input under an fp8 policy that is two
roundings (f32 -> fp16 -> E4M3), exactly as the reference does, so the two
packages agree bit for bit at the engine level.

A cast whose result is its input is skipped: a weight already stored in
E4M3 goes to fp16 and back unchanged, so it reaches the kernel as it is,
without a widened copy. That is what keeps fp8 weights at one byte an
element on the way through device memory.

Gradients (``torch.autograd.Function`` with the E5M2 x E4M3 backward GEMMs)
belong to the training slice; serving runs under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.core import semiring
from repro_torch.core.precision import cast, exact_widen
from repro_torch.kernels import ops as kernel_ops


def quantize_fwd(a: torch.Tensor, policy) -> torch.Tensor:
    """a -> compute -> forward storage, as the reference orders the casts."""
    if a.dtype == policy.storage_fwd and exact_widen(a.dtype, policy.compute):
        return a
    return cast(cast(a, policy.compute), policy.storage_fwd)


def mp_matmul(a: torch.Tensor, b: torch.Tensor, engine) -> torch.Tensor:
    """z = a @ b under the engine's policy, on the engine's backend."""
    pol = engine.policy
    return kernel_ops.gemm_op(
        quantize_fwd(a, pol), quantize_fwd(b, pol), None,
        gop=semiring.MATMUL, policy=pol, operand_quant=False,
        backend=engine.backend,
    )
