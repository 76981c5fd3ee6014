"""Operation and byte counts of the port's kernel calls, from their logical
shapes (the counterpart of ``repro.roofline.hlo_cost``, which parses XLA
HLO and does not carry over).

One rule for each kernel, and the only place these rules live
(``chip_smoke.py``'s kernel line takes its bounds from here):

- **GEMM-Op** (``redmule_gemm``): 2·B·M·K·N operations. (mul, add) under a
  16-bit compute format runs at the tensor cores' fp8 peak when both
  operands are fp8, else their fp16 peak; a semiring pair, or fp32
  compute, at the fp32 peak. Bytes: each operand in the storage format it
  is handed over in, read once (a broadcast axis counted once), Y when
  present, and Z written once in its output format.
- **Paged decode**: the K and V bytes of every page that holds a live
  token of an active slot (inside the window, if any), q and the output,
  the page table, the lengths and the active mask. Operations: 4·Hq·hd a
  live token a slot (QK and PV), at the fp32 peak (the kernel computes in
  fp32 on the CUDA cores).
- **Dense flash attention**: 4·B·Hq·hd operations a (query, key) pair
  (the causal half with the diagonal when causal, top-left aligned), at
  the fp16 tensor-core peak for 16-bit inputs and the fp32 peak for fp32;
  q, k, v and the output, each once.
- **The GEMM's auxiliary passes** (the K-major copy, the split-K
  combine), measured alone: the bytes they read and write, each once
  (:func:`transfer_cost`). They belong to a schedule, so no GEMM count
  holds them.

The counts do not depend on the schedule that runs a call: no K-major
copy, split-K partial or fp8 → fp16 widening enters them, so a later
redesign of a kernel cannot move its own yardstick (``tests/
test_torch_roofline.py`` plans one call onto two schedules and compares).
Where the work depends on the data (the paged decode's lengths), the count
is what these inputs need, not the most they could.

:func:`recording` opens a recorder: a context manager whose
:class:`Counts` sums every call made through the entry points of
``kernels/ops.py`` (both backends) while it is open. Closed, the hook is
one test of a module global. A captured CUDA graph records nothing when it
is replayed, so a step's counts are the counts taken at its capture, or at
an eager run of it, times its replays (:meth:`Counts.times`). The paged
decode's lengths are read where they lie: on the host as they are, on the
card with one copy (which waits for the card: the recorder is a measuring
instrument, kept out of timed windows), and inside a graph capture, where
nothing can be read, at the page table's capacity (every page of every
slot live, no window), which :attr:`Counts.capacity_calls` counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Sequence

import torch

from repro_torch.core.precision import BF16, FP8_DTYPES, FP16, PrecisionPolicy
from repro_torch.core.semiring import GemmOp
from repro_torch.roofline.analysis import FP8_FLOP_S, FP16_FLOP_S, FP32_FLOP_S, HBM_BYTES_S


@dataclasses.dataclass(frozen=True)
class Cost:
    """Operations and bytes of one kernel call, and the peak rate of the
    unit its operations run on."""

    flops: float
    bytes: float
    peak: float  # operations per second

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BYTES_S

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger of the two terms."""
        return max(self.compute_s, self.memory_s)

    @property
    def bound_ms(self) -> float:
        return self.bound_s * 1e3

    @property
    def bound_by(self) -> str:
        return "bytes" if self.memory_s >= self.compute_s else "operations"


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of a view: an axis of stride 0
    (broadcast) is read once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


def gemm_peak(x_dtype: torch.dtype, w_dtype: torch.dtype, gop: GemmOp,
              policy: PrecisionPolicy) -> float:
    if gop.is_gemm and policy.compute in (FP16, BF16):
        fp8 = x_dtype in FP8_DTYPES and w_dtype in FP8_DTYPES
        return FP8_FLOP_S if fp8 else FP16_FLOP_S
    return FP32_FLOP_S


def gemm_cost(x: torch.Tensor, w: torch.Tensor, y: Optional[torch.Tensor] = None, *,
              gop: GemmOp, policy: PrecisionPolicy, out_dtype: torch.dtype) -> Cost:
    """One GEMM-Op call as ``redmule_gemm`` takes it: x (..., M, K), w (K, N)
    or (..., K, N), y optional (..., M, N), leading dims broadcast."""
    m, k = x.shape[-2:]
    n = w.shape[-1]
    batch = math.prod(torch.broadcast_shapes(
        x.shape[:-2], w.shape[:-2], () if y is None else y.shape[:-2]))
    out_bytes = batch * m * n * torch.empty((), dtype=out_dtype).element_size()
    nbytes = (_distinct_bytes(x) + _distinct_bytes(w)
              + (0 if y is None else _distinct_bytes(y)) + out_bytes)
    return Cost(2.0 * batch * m * k * n, float(nbytes), gemm_peak(x.dtype, w.dtype, gop, policy))


def _host_ints(t: torch.Tensor) -> Optional[list[int]]:
    """A small index tensor's values on the host, or None inside a CUDA
    graph capture (nothing can be read there)."""
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        return None
    return [int(v) for v in t.reshape(-1).tolist()]


def paged_decode_cost(q: torch.Tensor, k_pool: torch.Tensor, page_table: torch.Tensor,
                      seq_lens: torch.Tensor | Sequence[int],
                      active: torch.Tensor | Sequence[int] | None = None, *, page_size: int,
                      window: Optional[int] = None) -> Cost:
    """One paged-decode call: q (S, Hq, hd) or grouped (S, Hkv, G, hd); the
    flat pools (n_pages * page_size, Hkv, hd) (V as K); the page table
    (S, P); ``seq_lens`` the position of each slot's fresh token; ``active``
    the live slots (all when None)."""
    s, hd = q.shape[0], q.shape[-1]
    hq = q.numel() // (s * hd)
    hkv = k_pool.shape[1]
    lens = seq_lens if not isinstance(seq_lens, torch.Tensor) else _host_ints(seq_lens)
    act = active if not isinstance(active, torch.Tensor) else _host_ints(active)
    index_bytes = page_table.numel() * page_table.element_size()
    for t in (seq_lens, active):
        index_bytes += (t.numel() * t.element_size() if isinstance(t, torch.Tensor)
                        else 0 if t is None else 4 * len(t))
    if lens is None or (act is None and active is not None):
        pages = s * page_table.shape[1]  # inside a capture: the table's capacity
        tokens = pages * page_size
    else:
        live = [i for i in range(s) if act is None or act[i]]
        first = {i: 0 if window is None else max(0, lens[i] - window + 1) for i in live}
        pages = sum(lens[i] // page_size - first[i] // page_size + 1 for i in live)
        tokens = sum(lens[i] + 1 - first[i] for i in live)
    kv_bytes = 2 * pages * page_size * hkv * hd * k_pool.element_size()
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + index_bytes
    return Cost(4.0 * hq * hd * tokens, float(nbytes), FP32_FLOP_S)


def flash_attention_cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> Cost:
    """One dense attention call: q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd);
    the output in q's format."""
    b, sq, hq, hd = q.shape
    sk = k.shape[1]
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    nbytes = (2 * q.numel() * q.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size())
    peak = FP16_FLOP_S if q.dtype in (FP16, BF16) else FP32_FLOP_S
    return Cost(4.0 * b * hq * hd * pairs, float(nbytes), peak)


def transfer_cost(reads: Sequence[torch.Tensor], writes: Sequence[torch.Tensor]) -> Cost:
    """A pass that moves data and does next to no arithmetic: each tensor
    read or written once; its few operations are not counted."""
    return Cost(0.0, float(sum(_distinct_bytes(t) for t in (*reads, *writes))), FP32_FLOP_S)


@dataclasses.dataclass
class KernelCounts:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0
    compute_s: float = 0.0


class Counts:
    """Summed counts of the calls made while a recorder was open, by kernel
    (``redmule_gemm``, ``paged_decode``, ``flash_attention``)."""

    def __init__(self):
        self.kernels: dict[str, KernelCounts] = {}
        self.capacity_calls = 0  # paged decodes counted at capacity (in a capture)

    def add(self, kernel: str, cost: Cost, calls: int = 1) -> None:
        kc = self.kernels.setdefault(kernel, KernelCounts())
        kc.calls += calls
        kc.flops += cost.flops * calls
        kc.bytes += cost.bytes * calls
        kc.compute_s += cost.compute_s * calls

    def times(self, n: int) -> "Counts":
        """These counts n times over (a captured step and its replays)."""
        out = Counts()
        out.capacity_calls = self.capacity_calls * n
        for name, kc in self.kernels.items():
            out.kernels[name] = KernelCounts(kc.calls * n, kc.flops * n, kc.bytes * n,
                                             kc.compute_s * n)
        return out

    @property
    def calls(self) -> int:
        return sum(kc.calls for kc in self.kernels.values())

    @property
    def flops(self) -> float:
        return sum(kc.flops for kc in self.kernels.values())

    @property
    def bytes(self) -> float:
        return sum(kc.bytes for kc in self.kernels.values())

    @property
    def compute_s(self) -> float:
        return sum(kc.compute_s for kc in self.kernels.values())

    @property
    def memory_s(self) -> float:
        return self.bytes / HBM_BYTES_S

    def to_dict(self) -> dict:
        return {name: dataclasses.asdict(kc) for name, kc in sorted(self.kernels.items())}


_active: list[Counts] = []  # the open recorders, innermost last


@contextlib.contextmanager
def recording():
    """Open a recorder; yields the :class:`Counts` it fills. Recorders nest:
    a call counts in every open one."""
    counts = Counts()
    _active.append(counts)
    try:
        yield counts
    finally:
        _active.remove(counts)


def note(kernel: str, cost_fn, *args, **kw) -> None:
    """Count one call in every open recorder (the hook of ``kernels/ops.py``;
    the caller tests ``_active`` first, so a closed recorder costs nothing)."""
    cost = cost_fn(*args, **kw)
    capacity = kernel == "paged_decode" and any(
        isinstance(t, torch.Tensor) and t.is_cuda and torch.cuda.is_current_stream_capturing()
        for t in args[3:5])
    for counts in _active:
        counts.add(kernel, cost)
        counts.capacity_calls += capacity
