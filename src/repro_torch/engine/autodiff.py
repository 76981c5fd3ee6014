"""Differentiable cores of the engine: the hybrid-FP8 GEMM and the tropical
(semiring) GEMM-Ops as ``torch.autograd.Function``s, the counterparts of
the reference's ``jax.custom_vjp``s (``repro/engine/autodiff.py``).

Both forward paths and every backward GEMM run through
``repro_torch.kernels.ops.gemm_op``: on the ``"cuda"`` backend that is the
hand-written GEMM-Op kernel, on ``"torch"`` its plain version.

GEMM (circ=mul, star=add), paper Sec. 4.2.3: the forward GEMM reads E4M3
operands; the backward GEMMs read the cotangent quantized to E5M2 beside
the saved E4M3 residuals (E5M2 x E4M3^T for g.W^T, E4M3^T x E5M2 for
X^T.g), with fp16 (compute-format) outputs. Transposed operands are views
that the kernel reads through their strides, never copies.

Cast order, kept from the reference: operands go to the compute format
outside the Function (a differentiable cast) and to the forward storage
format inside it, so the quantizer's gradient is straight-through. For an
fp32 input under an fp8 policy that is two roundings (f32 -> fp16 ->
E4M3), exactly as the reference does (ROADMAP queue 3), so the two
packages agree bit for bit at the engine level. A cast whose result is its
input is skipped: a weight already stored in E4M3 goes to fp16 and back
unchanged, so it reaches the kernel as it is, without a widened copy.

Data parallelism: a train step on a mesh marks each weight whose gradient
is summed over the data ranks (:func:`mark_summed`, with the step's
``distrib.tensor_parallel.DataSum``). A GEMM whose weight operand is such a
weight, or a view of one, emits that weight's gradient in the accumulator
format, sums it over the ranks in fp32 and casts it once to the gradient
format, inside its backward: GSPMD puts the reference's all-reduce on the
dot's fp32 result, before its one cast, and autograd would round a
gradient handed back in fp32 to its fp16 input before any later sum.

Semiring ops (star in {min, max}): tropical subgradients. The cotangent
goes to the arg-star lanes with JAX's own tie rules -- reduction ties split
it evenly (``reduce_min``/``reduce_max``), and a circ min/max tie splits it
half and half (``lax.min``/``lax.max``) -- so gradients equal ``jax.grad``
of a plain reference. The backward recomputes the circ products over K in
chunks of ``_BWD_K_CHUNK`` from the saved storage-format operands (never
the (M, K, N) block) and selects lanes by exact equality with the saved
accumulator-format reduction: exact, because min and max select values,
and both kernel backends round circ to the compute format before star.
"""
from __future__ import annotations

import torch

from repro_torch.core import semiring
from repro_torch.core.precision import cast, exact_widen
from repro_torch.core.semiring import GemmOp, Op
from repro_torch.kernels import ops as kernel_ops

# K-chunk of the tropical backward recompute: bounds the live selection
# block at (batch, M, _BWD_K_CHUNK, N) in the accumulator format.
_BWD_K_CHUNK = 64

_SUMMED = "_repro_data_sum"


def mark_summed(t: torch.Tensor, how) -> torch.Tensor:
    """Mark ``t`` (a parameter leaf of a train step, or FSDP's gathered
    whole parameter) as summed over the data ranks inside its uses;
    ``how.sum(x)`` sums an fp32 tensor over those ranks. Returns ``t``."""
    setattr(t, _SUMMED, how)
    return t


def summed_by(t: torch.Tensor):
    """The data sum of a marked tensor, or of the tensor ``t`` is a view
    of (``table.T``, an expert's columns); None for any other."""
    how = getattr(t, _SUMMED, None)
    if how is None and t._base is not None:
        how = getattr(t._base, _SUMMED, None)
    return how


def summed_like(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``t``, a copy of ``src`` in another format (sLSTM's fp32 recurrence
    weight), marked as ``src`` is: its GEMMs then sum its gradient."""
    how = summed_by(src)
    return t if how is None else mark_summed(t, how)


def _weight_grad(db: torch.Tensor, shape, summed, compute) -> torch.Tensor:
    """A weight's gradient in the gradient format: summed to its shape, and
    for a marked weight first summed over the data ranks (``db`` then in
    the accumulator format)."""
    db = _sum_to_shape(db, shape)
    if summed is not None:
        db = summed.sum(db)
    return db.to(compute)


def _swap_last(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _sum_to_shape(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum out broadcast batch dims so a gradient matches its primal's shape."""
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    extra = x.dim() - len(shape)
    if extra > 0:
        x = x.sum(dim=tuple(range(extra)))
    dims = tuple(i for i, (xs, s) in enumerate(zip(x.shape, shape)) if xs != s)
    if dims:
        x = x.sum(dim=dims, keepdim=True)
    return x.reshape(shape)


def _kernel_gemm(x, w, y, gop: GemmOp, engine, out_dtype=None):
    """One dispatch into the kernel layer. Operands arrive already in their
    storage formats (``operand_quant=False``): the engine layer owns the cast
    points, so the backward reuses the exact bytes the forward read."""
    return kernel_ops.gemm_op(x, w, y, gop=gop, policy=engine.policy, out_dtype=out_dtype,
                              operand_quant=False, backend=engine.backend)


def _to_compute(a: torch.Tensor, policy) -> torch.Tensor:
    """The differentiable cast to the compute format, skipped for an operand
    already in the forward storage format that the compute format holds
    exactly (compute -> storage would give back the same bits)."""
    if a.dtype == policy.storage_fwd and exact_widen(a.dtype, policy.compute):
        return a
    return cast(a, policy.compute)


def quantize_fwd(a: torch.Tensor, policy) -> torch.Tensor:
    """a -> compute -> forward storage, as the reference orders the casts."""
    return cast(_to_compute(a, policy), policy.storage_fwd)


def _mp_backward(engine, needs, aq, bq, g, summed=None):
    """(da, db) of z = aq @ bq under the engine's policy: both GEMMs read the
    cotangent in the backward storage format (E5M2 under hybrid FP8). With
    ``summed`` (bq's data sum) db is emitted in the accumulator format and
    summed over the data ranks before its one cast."""
    pol = engine.policy
    db_dtype = pol.compute if summed is None else pol.acc
    gq = cast(cast(g, pol.compute), pol.storage_bwd)
    da = db = None
    if needs[0]:
        da = _kernel_gemm(gq, _swap_last(bq), None, semiring.MATMUL, engine,
                          out_dtype=pol.compute)
        da = _sum_to_shape(da, aq.shape).to(pol.compute)
    if needs[1]:
        if bq.dim() == 2 and gq.dim() > 2:
            # Shared weight: dW = sum_batch x_b^T g_b = (rows flattened)^T @ g,
            # one unbatched GEMM instead of a batched GEMM and a reduction.
            kdim, n = aq.shape[-1], gq.shape[-1]
            db = _kernel_gemm(_swap_last(aq.reshape(-1, kdim)), gq.reshape(-1, n), None,
                              semiring.MATMUL, engine, out_dtype=db_dtype)
        else:
            db = _kernel_gemm(_swap_last(aq), gq, None, semiring.MATMUL, engine,
                              out_dtype=db_dtype)
        db = _weight_grad(db, bq.shape, summed, pol.compute)
    return da, db


class _MpCore(torch.autograd.Function):
    """z = a @ b on compute-format operands, with the hybrid-FP8 VJP."""

    @staticmethod
    def forward(ctx, a, b, engine, summed):
        pol = engine.policy
        aq, bq = cast(a, pol.storage_fwd), cast(b, pol.storage_fwd)
        ctx.engine, ctx.summed = engine, summed
        ctx.save_for_backward(aq, bq)
        return _kernel_gemm(aq, bq, None, semiring.MATMUL, engine)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        da, db = _mp_backward(ctx.engine, ctx.needs_input_grad[:2], aq, bq, g, ctx.summed)
        return da, db, None, None


class _MpCoreY(torch.autograd.Function):
    """z = a @ b + y, y folded into the accumulator (one rounding);
    dy is the cotangent, batch-summed to y's shape."""

    @staticmethod
    def forward(ctx, a, b, y, engine, summed):
        pol = engine.policy
        aq, bq = cast(a, pol.storage_fwd), cast(b, pol.storage_fwd)
        ctx.engine, ctx.summed = engine, summed
        ctx.y_meta = (tuple(y.shape), y.dtype)
        ctx.save_for_backward(aq, bq)
        return _kernel_gemm(aq, bq, y, semiring.MATMUL, engine)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        da, db = _mp_backward(ctx.engine, ctx.needs_input_grad[:2], aq, bq, g, ctx.summed)
        dy = None
        if ctx.needs_input_grad[2]:
            y_shape, y_dtype = ctx.y_meta
            dy = _sum_to_shape(g.to(ctx.engine.policy.acc), y_shape).to(y_dtype)
        return da, db, dy, None, None


def mp_matmul(a: torch.Tensor, b: torch.Tensor, engine) -> torch.Tensor:
    """z = a @ b under the engine's policy, on the engine's backend,
    differentiable with the hybrid-FP8 rule."""
    pol = engine.policy
    return _MpCore.apply(_to_compute(a, pol), _to_compute(b, pol), engine, summed_by(b))


# -- tropical VJP ----------------------------------------------------------------


def _circ_factors(circ: Op, xe, we):
    """(d circ/dx, d circ/dw) at broadcast operands xe (..., M, c, 1) and
    we (..., 1, c, N), in the accumulator format. min/max follow lax's
    balanced rule: a tie gives 0.5 to each side."""
    if circ is Op.ADD:
        return 1.0, 1.0
    if circ is Op.MUL:
        return we, xe
    half = (xe == we).float() * 0.5
    if circ is Op.MIN:
        fx = (xe < we).float() + half
    else:  # Op.MAX
        fx = (xe > we).float() + half
    return fx, 1.0 - fx


def _tropical_backward(gop: GemmOp, engine, xq, wq, r, g, summed=None):
    pol = engine.policy
    compute, acc = pol.compute, pol.acc
    xc, wc = xq.to(compute), wq.to(compute)
    # Gradient storage format on the way in, accumulator format for routing.
    gq = cast(cast(g, compute), pol.storage_bwd).to(acc)
    m, k = xc.shape[-2:]
    n = wc.shape[-1]
    batch = tuple(torch.broadcast_shapes(xc.shape[:-2], wc.shape[:-2]))
    xb = xc.expand(batch + (m, k))
    wb = wc if wc.dim() == 2 else wc.expand(batch + (k, n))
    rb = r.expand(batch + (m, n))
    gb = gq.expand(batch + (m, n))
    circ = semiring.op_fn(gop.circ)
    chunks = [(k0, min(k0 + _BWD_K_CHUNK, k)) for k0 in range(0, k, _BWD_K_CHUNK)]

    def select(k0, k1):
        xe = xb[..., :, k0:k1, None]  # (..., M, c, 1)
        we = wb[..., None, k0:k1, :]  # (..., 1, c, N)
        prod = circ(xe, we).to(acc)  # circ in the compute format
        return xe.to(acc), we.to(acc), (prod == rb[..., :, None, :]).to(acc)

    # Pass 1: count the arg-star lanes of each output, so that ties split
    # the cotangent evenly.
    cnt = torch.zeros(batch + (m, n), dtype=acc, device=r.device)
    for k0, k1 in chunks:
        cnt += select(k0, k1)[2].sum(-2)
    weight = gb / cnt.clamp(min=1.0)

    # Pass 2: route the weight to the selected lanes through d circ.
    dx = torch.empty(batch + (m, k), dtype=acc, device=r.device)
    dw = torch.empty(batch + (k, n), dtype=acc, device=r.device)
    for k0, k1 in chunks:
        xe, we, sel = select(k0, k1)
        contrib = sel * weight[..., :, None, :]  # (..., M, c, N)
        fx, fw = _circ_factors(gop.circ, xe, we)
        dx[..., :, k0:k1] = (contrib * fx).sum(-1)
        dw[..., k0:k1, :] = (contrib * fw).sum(-3)
    return _sum_to_shape(dx, xq.shape).to(compute), _weight_grad(dw, wq.shape, summed, compute)


class _TropicalCore(torch.autograd.Function):
    """r = star_k circ(x, w) in the accumulator format, with the tropical VJP."""

    @staticmethod
    def forward(ctx, x, w, gop, engine, summed):
        pol = engine.policy
        xq, wq = cast(x, pol.storage_fwd), cast(w, pol.storage_fwd)
        # Accumulator-format output: min/max select (never round), so the
        # saved reduction compares bit for bit with the backward recompute.
        r = _kernel_gemm(xq, wq, None, gop, engine, out_dtype=pol.acc)
        ctx.gop, ctx.engine, ctx.summed = gop, engine, summed
        ctx.save_for_backward(xq, wq, r)
        return r

    @staticmethod
    def backward(ctx, g):
        xq, wq, r = ctx.saved_tensors
        dx, dw = _tropical_backward(ctx.gop, ctx.engine, xq, wq, r, g, ctx.summed)
        return dx, dw, None, None, None


def gemm_op(x, w, y, op, engine) -> torch.Tensor:
    """Z = star(Y, star_k(circ(X, W))), differentiable in x, w and y.

    For the GEMM pair, Y folds into the kernel's accumulator (one rounding;
    dY = the cotangent). For the semiring ops the Y combination runs outside
    the Function with torch's own min/max (valid by associativity), whose
    gradients split ties half and half as JAX's do. The output cast is the
    cast unit's (an E4M3 output is not differentiable, as no training
    policy writes one).
    """
    gop = semiring.get(op) if isinstance(op, str) else op
    pol = engine.policy
    if gop.is_gemm:
        if y is None:
            return mp_matmul(x, w, engine)
        return _MpCoreY.apply(_to_compute(x, pol), _to_compute(w, pol), y, engine, summed_by(w))
    r = _TropicalCore.apply(_to_compute(x, pol), _to_compute(w, pol), gop, engine, summed_by(w))
    if y is not None:
        r = semiring.op_fn(gop.star)(y.to(r.dtype), r)
    return cast(r, pol.out)
