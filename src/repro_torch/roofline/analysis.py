"""Roofline terms of the port on one NVIDIA H100 (counterpart of
``repro.roofline.analysis``).

    compute term    = sum over calls of operations / the peak of their unit
    memory term     = bytes / 3.35 TB/s
    collective term = 0 (one card)

The reference reads FLOPs and bytes out of compiled XLA HLO and charges
collectives from the HLO text; neither carries over. The port counts each
kernel call from its logical shapes (``roofline/cost.py``) and sums the
calls with a recorder, so :func:`roofline_from_counts` takes the place of
``roofline_from_artifacts``. The :class:`Roofline` fields keep the
reference's names (``hlo_flops``, ``hlo_bytes``) for the counted
operations and bytes.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
card's full 700 W power limit: 3.35 TB/s of HBM3, 989 TFLOP/s fp16/bf16
and 1979 TFLOP/s fp8 on the tensor cores, 67 TFLOP/s fp32 outside them,
and 900 GB/s of NVLink 4 (450 GB/s each way).
A card set below 700 W runs slower under load; state its limit beside any
share of these peaks.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_S = 3.35e12  # device memory rate
FP16_FLOP_S = 989e12  # dense fp16/bf16 tensor-core peak
FP8_FLOP_S = 1979e12  # dense fp8 tensor-core peak
FP32_FLOP_S = 67e12  # fp32 peak outside the tensor cores
NVLINK_BYTES_S = 450e9  # NVLink 4: one direction of its 900 GB/s


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    n_chips: int

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return dict(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            bottleneck=self.bottleneck,
            hlo_flops=self.hlo_flops,
            hlo_bytes=self.hlo_bytes,
            coll_bytes=self.coll_bytes,
            n_chips=self.n_chips,
        )


def roofline_from_counts(counts) -> Roofline:
    """The roofline of the calls in ``counts`` (a ``cost.Counts``) on one
    card: each call's operations at its own unit's peak, every byte at the
    memory rate, and no collective."""
    return Roofline(
        compute_s=counts.compute_s,
        memory_s=counts.bytes / HBM_BYTES_S,
        collective_s=0.0,
        hlo_flops=counts.flops,
        hlo_bytes=counts.bytes,
        coll_bytes=0.0,
        n_chips=1,
    )


def model_flops_train(n_active_params: int, n_tokens: int) -> float:
    """6*N*D rule (fwd 2ND + bwd 4ND)."""
    return 6.0 * n_active_params * n_tokens


def model_flops_decode(n_active_params: int, n_tokens: int) -> float:
    """2*N per generated token."""
    return 2.0 * n_active_params * n_tokens
