"""Tensor parallelism and FSDP of the port's train step: the explicit
counterpart of what GSPMD inserts into the reference's train step from
``param_specs`` and ``fsdp_param_specs`` (``distrib/sharding.py``).

A rank holds its pieces of the weights (``sharding.local_params``) and
runs the layers on them; everything else is replicated over the 'model'
axis. The convention is Megatron's: a replicated activation carries its
*whole* gradient on every rank, a piece carries the gradient of its
piece. So a replicated leaf's gradient is the same on every TP rank and
the train step sums it over the data axes alone.

- :func:`column_linear`: a weight split by output columns on a replicated
  input. Forward the local GEMM; backward each rank's dX is a partial sum
  over its columns, made in fp32 by the GEMM-Op kernel, summed over the
  axis in fp32 and then cast to the compute format.
- :func:`row_linear`: a weight split by input rows on a split input.
  Forward the local GEMM emits fp32 partials (``out_dtype=policy.acc``),
  they are summed over the axis and cast to ``policy.out`` once, after
  the sum (the reference's all-reduce sits on the dot's fp32 result,
  ``jnp.matmul(..., preferred_element_type=acc)``, before its cast; a sum
  of 16-bit partials would round every output twice). Backward local.
- :func:`gather_from`: a split activation made whole (an all-gather);
  backward this rank's slice of the whole gradient. :func:`split_to`, its
  conjugate: this rank's slice of a replicated activation with no
  communication; backward an all-gather of the gradient pieces, so the
  replicated side gets its whole gradient. :func:`grad_sum`: the identity,
  backward the fp32 sum over the axis (a replicated tensor whose ranks
  each use a part of it, as GQA's replicated K/V heads).
- :func:`vocab_embed` and :func:`vocab_xent`: the vocab-parallel
  embedding and cross-entropy (Megatron's), over the table's rows and the
  logits' columns; only (B, c) values and the (B, c, V / 32) window sums
  of exp cross the wire, never logits.
- :func:`use_param`: FSDP's and ZeRO-3's per-use gather of a parameter
  split over the data axes. Forward ``gather_full``; backward the fp32
  sum of the gradient over those axes (gloo has no reduce-scatter: an
  all-reduce, then this rank's piece), or for a weight summed in its uses
  (:func:`summed_in_use`) just this rank's piece of the sum they made.
- :class:`DataSum` and :func:`embed_rows`: the data-parallel gradient of a
  weight summed inside its uses (``engine.autodiff.mark_summed``): each
  GEMM-Op's dW in fp32, summed over the data axes before its one cast, as
  GSPMD sums the reference's dot output; the embedding gather's
  cotangent rows and their token ids gathered over the data axes in rank
  order and scattered as one process scatters the global batch's.

Each GEMM here is the hybrid-FP8 core of ``engine/autodiff.py`` (E4M3
forward operands, E5M2 cotangents) on the GEMM-Op kernel, with the
collective inside the autograd Function. Every collective carries its
tag into ``collectives.traffic``, which ``launch/dryrun.py`` plans.
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch

from repro_torch.core import semiring
from repro_torch.core.precision import cast, take_rows
from repro_torch.distrib import collectives, sharding
from repro_torch.engine import autodiff
from repro_torch.models import common

NEG_ZERO = -0.0  # x + (-0.0) == x for every x, signed zeros included


class TP(NamedTuple):
    """The tensor-parallel axis of a mesh (of more than one rank)."""

    mesh: Any
    axis: str

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axis)


class DataSum(NamedTuple):
    """How a weight's gradient is summed over data axes inside its uses
    (``autodiff.mark_summed``): ``sum`` an fp32 partial over the axes,
    ``gather`` rows (dim 0) from every rank in axis order."""

    mesh: Any
    axes: tuple
    tag: str = "dp_grad_all_reduce"

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return collectives.all_reduce(t.float(), self.mesh, self.axes, tag=self.tag)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat(collectives.all_gather(t.contiguous(), self.mesh, self.axes,
                                                tag="dp_embed_all_gather"), dim=0)


# Leaves whose every use in a train step sums its own gradient over the
# data axes: the GEMM-Op weights (dense, attention, FFN, the experts, the
# heads and frontends' projections, sLSTM's recurrence through its fp32
# copy; not the fp32 router, whose gradient the step sums as it always
# did) and the embedding table (its gather, and the logits GEMM where it is
# tied). Norm scales and biases, convolutions and RG-LRU's lambda keep the
# step's sum of each rank's gradient.
_SUMMED_IN_USE = re.compile(r"(.*/)?(w|r|table|moe/(up|gate|down))$")


def summed_in_use(path: str) -> bool:
    """Whether the leaf at ``path`` has its data-parallel gradient summed
    inside its uses (the GEMM-Op weights and the embedding table)."""
    return bool(_SUMMED_IN_USE.match(path)) and not path.endswith("router/w")


def tp_of(mesh_ctx) -> TP | None:
    """The TP axis of a ``MeshCtx``, or None (no mesh, FSDP mode, or an
    axis of one rank)."""
    if mesh_ctx is None or mesh_ctx.mesh is None or mesh_ctx.tp_axis is None:
        return None
    if mesh_ctx.mesh.axis_size(mesh_ctx.tp_axis) == 1:
        return None
    return TP(mesh_ctx.mesh, mesh_ctx.tp_axis)


# -- the GEMMs ------------------------------------------------------------------------


def _sum32(t: torch.Tensor, tp: TP, tag: str) -> torch.Tensor:
    return collectives.all_reduce(t.float(), tp.mesh, tp.axis, tag=tag)


class _ColumnCore(torch.autograd.Function):
    """z = a @ b on a replicated a and b's column piece; backward the dX
    partials in fp32, summed over the axis, then cast."""

    @staticmethod
    def forward(ctx, a, b, engine, tp, summed):
        pol = engine.policy
        aq, bq = cast(a, pol.storage_fwd), cast(b, pol.storage_fwd)
        ctx.engine, ctx.tp, ctx.summed = engine, tp, summed
        ctx.save_for_backward(aq, bq)
        return autodiff._kernel_gemm(aq, bq, None, semiring.MATMUL, ctx.engine)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        pol = ctx.engine.policy
        need_a, need_b = ctx.needs_input_grad[:2]
        _, db = autodiff._mp_backward(ctx.engine, (False, need_b), aq, bq, g, ctx.summed)
        da = None
        if need_a:
            gq = cast(cast(g, pol.compute), pol.storage_bwd)
            part = autodiff._kernel_gemm(gq, autodiff._swap_last(bq), None, semiring.MATMUL,
                                         ctx.engine, out_dtype=pol.acc)
            part = autodiff._sum_to_shape(part, aq.shape)
            da = _sum32(part, ctx.tp, "tp_grad_all_reduce").to(pol.compute)
        return da, db, None, None, None


class _RowCore(torch.autograd.Function):
    """z = sum over the axis of a_r @ b_r (a's column piece, b's row
    piece): fp32 partials summed, then one cast to ``policy.out``."""

    @staticmethod
    def forward(ctx, a, b, engine, tp, summed):
        pol = engine.policy
        aq, bq = cast(a, pol.storage_fwd), cast(b, pol.storage_fwd)
        ctx.engine, ctx.summed = engine, summed
        ctx.save_for_backward(aq, bq)
        part = autodiff._kernel_gemm(aq, bq, None, semiring.MATMUL, engine, out_dtype=pol.acc)
        return cast(_sum32(part, tp, "tp_row_all_reduce"), pol.out)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        da, db = autodiff._mp_backward(ctx.engine, ctx.needs_input_grad[:2], aq, bq, g,
                                       ctx.summed)
        return da, db, None, None, None


def column_linear(x: torch.Tensor, p: dict, engine, tp: TP) -> torch.Tensor:
    """x (..., K) replicated @ this rank's columns of ``p["w"]`` (+ its
    bias piece): (..., N / tp) in ``policy.out``."""
    pol = engine.policy
    y = _ColumnCore.apply(autodiff._to_compute(x, pol), autodiff._to_compute(p["w"], pol),
                          engine, tp, autodiff.summed_by(p["w"]))
    return y if p.get("b") is None else y + p["b"].to(y.dtype)


def row_linear(x: torch.Tensor, p: dict, engine, tp: TP) -> torch.Tensor:
    """x (..., K / tp), this rank's columns, @ this rank's rows of
    ``p["w"]``, summed over the axis in fp32 and cast once; the bias (whole
    on every rank) added once, after the sum."""
    pol = engine.policy
    y = _RowCore.apply(autodiff._to_compute(x, pol), autodiff._to_compute(p["w"], pol),
                       engine, tp, autodiff.summed_by(p["w"]))
    return y if p.get("b") is None else y + p["b"].to(y.dtype)


def linear(x: torch.Tensor, p: dict, engine, tp: TP | None, full_out: int) -> torch.Tensor:
    """``dense_apply`` of a weight whose (K, N) may be split by columns:
    :func:`column_linear` where its piece is narrower than ``full_out``,
    the plain GEMM where it is whole."""
    if tp is None or p["w"].shape[-1] == full_out:
        return common.dense_apply(p, x, engine)
    return column_linear(x, p, engine, tp)


def out_linear(x: torch.Tensor, p: dict, engine, tp: TP | None, full_in: int) -> torch.Tensor:
    """``dense_apply`` of a weight whose rows may be split: ``x`` is then
    this rank's columns (:func:`row_linear`), else whole (the plain GEMM)."""
    if tp is None or p["w"].shape[0] == full_in:
        return common.dense_apply(p, x, engine)
    return row_linear(x, p, engine, tp)


def whole_linear(x: torch.Tensor, p: dict, engine, tp: TP | None, full_out: int) -> torch.Tensor:
    """``dense_apply`` whose output is needed whole: a column-split weight's
    piece (:func:`column_linear`) then :func:`gather_from`."""
    if tp is None or p["w"].shape[-1] == full_out:
        return common.dense_apply(p, x, engine)
    return gather_from(column_linear(x, p, engine, tp), tp)


# -- activations ------------------------------------------------------------------------


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, x.shape[dim]
        return torch.cat(collectives.all_gather(x.contiguous(), tp.mesh, tp.axis,
                                                tag="tp_all_gather"), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.tp.index * ctx.n, ctx.n), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        n = x.shape[dim] // tp.size
        return x.narrow(dim, tp.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(collectives.all_gather(g.contiguous(), ctx.tp.mesh, ctx.tp.axis,
                                                tag="tp_all_gather"), dim=ctx.dim), None, None


def gather_from(x: torch.Tensor, tp: TP, dim: int = -1) -> torch.Tensor:
    """The whole of an activation split over the axis along ``dim``; the
    backward keeps this rank's slice of the (whole) gradient."""
    return _Gather.apply(x, tp, dim % x.dim())


def split_to(x: torch.Tensor, tp: TP, dim: int = -1) -> torch.Tensor:
    """This rank's slice of a replicated activation along ``dim``; the
    backward all-gathers the gradient's slices."""
    return _Split.apply(x, tp, dim % x.dim())


def grad_sum(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The identity; backward the gradient summed over the axis in fp32."""
    return collectives.copy_to(x, tp.mesh, tp.axis, fp32=True, tag="tp_grad_all_reduce")


# -- the embedding gather ----------------------------------------------------------------


class _SummedRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, how):
        ctx.how, ctx.shape = how, table.shape
        ctx.save_for_backward(idx)
        return take_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        rows = ctx.how.gather(g.reshape(-1, g.shape[-1]))
        at = ctx.how.gather(idx.reshape(-1))
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return grad.index_put_((at,), rows, accumulate=True), None, None


def embed_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_rows(table, idx)``; for a table summed in its uses
    (``autodiff.summed_by``) the backward gathers every data rank's
    cotangent rows and ids in rank order and scatters them all, as one
    process scatters the global batch's (the same order, so the same
    fp16 sums), instead of summing each rank's scattered table."""
    how = autodiff.summed_by(table)
    if how is None:
        return take_rows(table, idx)
    return _SummedRows.apply(table, idx, how)


# -- vocab parallelism --------------------------------------------------------------------


def _psum(x: torch.Tensor, tp: TP, tag: str) -> torch.Tensor:
    """The sum over the axis; the identity backward."""
    return collectives.sum_over(x, tp.mesh, tp.axis, tag=tag)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, tp: TP,
                dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``tokens`` from a table whose rows are split over the
    axis (this rank's block), in ``dtype``: each rank takes the rows it
    holds (``take_rows``), puts -0.0 in the others and the ranks' rows are
    summed in fp32. Exactly one rank holds a token's row and -0.0 is the
    sum's identity (signed zeros and NaN included), so the result is the
    whole table's row bit for bit."""
    n_rows = table.shape[0]
    local = tokens - tp.index * n_rows
    held = (local >= 0) & (local < n_rows)
    x = embed_rows(table, local.clamp(0, n_rows - 1)).float()
    x = torch.where(held[..., None], x, NEG_ZERO)
    return _psum(x, tp, "tp_embed_all_reduce").to(dtype)


XENT_WINDOW = 32  # XLA's CPU reduce window


def vocab_xent(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
               tp: TP, width: int = 0) -> torch.Tensor:
    """sum over masked positions of logsumexp(z) - z[label], for logits
    (B, c, V / tp) fp32 holding this rank's block of the vocab: the max
    over the axis (its gradient stops, as ``logsumexp``'s), the sum of
    exp over it, and the label's logit from the one rank that holds it.
    The exp, log and sums are ``common``'s XLA-rounded ones (``width``: the
    chunk length the positions' sum is taken at, as ``chunked_xent``'s).
    The sum of exp gathers each rank's sums of 32-wide windows and sums
    them: on the CPU, where a rank holds whole windows (V / tp a multiple
    of 32: every split vocabulary of the configs at 2 ranks, all but
    phi3.5-moe's at 4), XLA's reduce sums the whole vocabulary in that
    order, so the loss is the one-process step's bit for bit."""
    v_local = logits.shape[-1]
    m = collectives.all_reduce(logits.detach().amax(-1), tp.mesh, tp.axis, op="max",
                               tag="tp_xent_all_reduce")
    e = common.xla_exp(logits - m[..., None])
    pad = -v_local % XENT_WINDOW  # split low and high, as XLA pads a reduce
    e = torch.nn.functional.pad(e, (pad // 2, pad - pad // 2))
    w = common.xla_sum(e.unflatten(-1, (-1, XENT_WINDOW)), -1)[..., 0]
    sum_exp = common.xla_sum(gather_from(w, tp), -1)[..., 0]
    logz = common.xla_log(sum_exp) + m
    local = labels - tp.index * v_local
    held = (local >= 0) & (local < v_local)
    ll = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    ll = _psum(torch.where(held, ll, 0.0), tp, "tp_xent_all_reduce")
    return common.xla_sum((logz - ll) * mask, None, width)


# -- FSDP and ZeRO-3 --------------------------------------------------------------------


def _spec_axes(spec, mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if any(a in sharding._names(p) for p in spec))


class _UseParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, spec, mesh, summed):
        ctx.spec, ctx.mesh, ctx.dtype, ctx.summed = spec, mesh, piece.dtype, summed
        return sharding.gather_full(piece, spec, mesh, tag="fsdp_param_all_gather")

    @staticmethod
    def backward(ctx, g):
        if not ctx.summed:
            g = collectives.all_reduce(g.float(), ctx.mesh, _spec_axes(ctx.spec, ctx.mesh),
                                       tag="fsdp_grad_all_reduce")
        return sharding.shard_of(g, ctx.spec, ctx.mesh).to(ctx.dtype), None, None, None


def use_param(piece: torch.Tensor, spec, mesh, summed: bool = False) -> torch.Tensor:
    """The whole parameter of a piece split over the data axes by ``spec``
    (the data-axis part of its spec, ``sharding.over_axes``); the
    gradient comes back as this rank's piece of its sum over those axes.
    ``summed``: a weight summed in its uses (:func:`summed_in_use`): the
    whole parameter is marked so (``autodiff.mark_summed``), and the
    gradient that comes back is already their sum."""
    if all(p is None for p in spec):
        return piece
    whole = _UseParam.apply(piece, spec, mesh, summed)
    if summed:
        autodiff.mark_summed(whole, DataSum(mesh, _spec_axes(spec, mesh), "fsdp_grad_all_reduce"))
    return whole
