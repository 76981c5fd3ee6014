"""Collectives of the port over a :class:`~repro_torch.launch.mesh.Mesh`
(counterpart of ``repro.distrib.collectives``), on ``torch.distributed``.

Every function takes the mesh and an axis (a name or a tuple of names).
On an axis of size one it is the arithmetic of a group of one (a sum of
one term, a mean over one rank, a gather of one piece), and needs no
process group. On ``meta`` tensors (the dry run's, which have shapes and
no values) a collective moves nothing and gives the shapes it would.

``compressed_psum``: the fp8 (E5M2) gradient all-reduce with error
feedback, the paper's hybrid-FP8 role split (E5M2 carries gradients)
applied to the wire format of data-parallel reduction. Each rank scales
its tensor by a power of two into E5M2's range (the scaling itself is
lossless), rounds it to E5M2 and keeps the rounding residual for its next
call. The wire carries the E5M2 payload and one fp32 scale a rank (an
all-gather of 1 + 4/n bytes an element, where the reference's ``psum``
of the dequantized values moves fp32), and every rank sums the
dequantized pieces in rank order in fp32, so the replicas get the same
bits; at two ranks the sum has two terms and equals the reference's. As
in the reference, the train launcher does not call it.

The autograd functions carry the expert-parallel MoE layer's reductions
(``models/moe.py::apply_ep``), the pattern of Megatron's tensor-parallel
regions: :func:`sum_over` sums the experts' partial outputs over the
axis in their format, its backward the identity; :func:`copy_to` enters
the region, the identity forward and a sum of the gradients over the
axis backward (in fp32 for tensor parallelism); :func:`mean_over` averages a value every rank holds, the
gradient divided by the axis's size backward. ``distrib/tensor_parallel.py``
builds the tensor-parallel layers and FSDP's per-use gathers on them.

Every collective that moves data (an axis of more than one rank, ``meta``
tensors included) adds the bytes this rank puts on the wire to
:data:`traffic` under its ``tag``, on the ring model the dry run uses
(``launch/dryrun.py::_ring``): an all-reduce of P bytes over n ranks
2 (n - 1) / n P, an all-gather of pieces of P bytes (n - 1) P.
:func:`reset_traffic` clears it.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from repro_torch.core.precision import E5M2
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models.common import _log_values

E5M2_MAX = 57344.0  # E5M2's largest finite value
# jnp.log2 is log(x) / log(2.0); XLA folds the constant divisor into a
# product with its fp32 reciprocal.
_INV_LN2 = float(torch.tensor(1.0) / _log_values(torch.tensor(2.0)))


# tag -> wire bytes this process has sent (the ring model), and calls.
traffic: Counter = Counter()
traffic_calls: Counter = Counter()


def reset_traffic() -> None:
    traffic.clear()
    traffic_calls.clear()


def _count(tag: str, payload: int, n: int, kind: str) -> None:
    if n > 1:
        traffic[tag] += (2.0 * (n - 1) / n if kind == "all_reduce" else float(n - 1)) * payload
        traffic_calls[tag] += 1


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as flat bytes (the collectives' carrier for the
    fp8 formats, which gloo does not take)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def all_reduce(t: torch.Tensor, mesh, axis, *, op: str = "sum",
               tag: str = "all_reduce") -> torch.Tensor:
    """The sum (``op="mean"``: the mean; ``op="max"``: the largest value)
    of ``t`` over the axis, in ``t``'s format, as a new tensor."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduction {op!r}")
    n = mesh.axis_size(axis) if mesh is not None else 1
    out = t.contiguous().clone()
    _count(tag, out.numel() * out.element_size(), n, "all_reduce")
    if n > 1 and not t.is_meta:
        dist.all_reduce(out, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=mesh.group(axis))
    return out / n if op == "mean" else out


def all_gather(t: torch.Tensor, mesh, axis, *, tag: str = "all_gather") -> list[torch.Tensor]:
    """Every rank's ``t`` along the axis, in axis order, bit for bit (fp8
    included): the pieces must share shape and format."""
    n = mesh.axis_size(axis) if mesh is not None else 1
    if n == 1:
        return [t]
    _count(tag, t.numel() * t.element_size(), n, "all_gather")
    if t.is_meta:
        return [torch.empty_like(t) for _ in range(n)]
    flat = _bytes(t)
    pieces = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(pieces, flat, group=mesh.group(axis))
    return [p.view(t.dtype).reshape(t.shape) for p in pieces]


def gather_into(out: torch.Tensor, piece: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    """Fill ``out`` with every rank's ``piece`` along ``dim``, in axis order
    (the ZeRO-1 parameter gather); ``out`` keeps its own strides."""
    pieces = all_gather(piece, mesh, axis, tag="zero1_param_all_gather")
    c = piece.shape[dim]
    for i, p in enumerate(pieces):
        out.narrow(dim, i * c, c).copy_(p)
    return out


def _log2(x: torch.Tensor) -> torch.Tensor:
    """log2 of an fp32 tensor as XLA computes ``jnp.log2``: its compiled
    fp32 log (``models/common.py``) times the fp32 reciprocal of log(2),
    on every device. Where x lies within an ulp of a power of two, torch's
    ``log2`` (or an IEEE division) may round to the other side of the
    integer and halve or double the scale."""
    return _log_values(x) * _INV_LN2


def quantize_e5m2(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(E5M2 values, fp32 power-of-two scale) of an fp32 tensor, the
    reference's ``_quantize_e5m2``: scale = 2^floor(log2(57344 / absmax)),
    1 for an all-zero tensor."""
    absmax = x.abs().max()
    # A true division: torch's ``float / tensor`` multiplies by the
    # reciprocal, which rounds differently.
    ratio = torch.full((), E5M2_MAX, device=x.device) / torch.clamp(absmax, min=1e-30)
    scale = torch.where(absmax > 0, torch.exp2(torch.floor(_log2(ratio))),
                        torch.ones((), dtype=torch.float32, device=x.device))
    return (x * scale).to(E5M2), scale


def compressed_psum(x: torch.Tensor, mesh, axis, err: torch.Tensor):
    """The mean of ``x`` over the axis through E5M2 with error feedback.
    Returns (mean in x's format, new residual in err's format); ``err``
    has x's shape."""
    xf = x.float() + err.float()
    q, scale = quantize_e5m2(xf)
    deq = q.float() / scale
    new_err = xf - deq
    n = mesh.axis_size(axis) if mesh is not None else 1
    if n == 1:
        total = deq
    else:
        qs = all_gather(q, mesh, axis, tag="compressed_psum")
        scales = all_gather(scale.reshape(1), mesh, axis, tag="compressed_psum")
        total = qs[0].float() / scales[0]
        for qr, sr in zip(qs[1:], scales[1:]):
            total = total + qr.float() / sr
    return (total / n).to(x.dtype), new_err.to(err.dtype)


def psum_tree_compressed(grads, mesh, axis, err_tree):
    """:func:`compressed_psum` over every leaf. Returns (mean grads, new
    residual tree)."""
    pairs = [compressed_psum(g, mesh, axis, e) for g, e in zip(leaves(grads), leaves(err_tree))]
    return unflatten(grads, [p[0] for p in pairs]), unflatten(err_tree, [p[1] for p in pairs])


def init_error_tree(params):
    """Zero residuals in bf16 (half the footprint of fp32; the residual is
    small, so bf16's resolution suffices)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device), params)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        return all_reduce(x, mesh, axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, fp32, tag):
        ctx.mesh, ctx.axis, ctx.fp32, ctx.tag = mesh, axis, fp32, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g.float() if ctx.fp32 else g, ctx.mesh, ctx.axis, tag=ctx.tag)
        return total.to(g.dtype), None, None, None, None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n = mesh.axis_size(axis)
        return all_reduce(x, mesh, axis, op="mean", tag="scalars")

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _trivial(mesh, axis) -> bool:
    return mesh is None or mesh.axis_size(axis) == 1


def sum_over(x: torch.Tensor, mesh, axis, *, tag: str = "ep_sum") -> torch.Tensor:
    """psum: the sum over the axis in x's format; the identity backward."""
    return x if _trivial(mesh, axis) else _SumOver.apply(x, mesh, axis, tag)


def copy_to(x: torch.Tensor, mesh, axis, *, fp32: bool = False,
            tag: str = "ep_grad_all_reduce") -> torch.Tensor:
    """The identity; backward, the gradients' sum over the axis (in fp32,
    then cast back, with ``fp32``: tensor parallelism's rule)."""
    return x if _trivial(mesh, axis) else _CopyTo.apply(x, mesh, axis, fp32, tag)


def mean_over(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """pmean: the mean over the axis; backward, the gradient over the
    axis's size."""
    return x if _trivial(mesh, axis) else _MeanOver.apply(x, mesh, axis)
