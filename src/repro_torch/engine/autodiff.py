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


def _mp_backward(engine, needs, aq, bq, g):
    """(da, db) of z = aq @ bq under the engine's policy: both GEMMs read the
    cotangent in the backward storage format (E5M2 under hybrid FP8)."""
    pol = engine.policy
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
                              semiring.MATMUL, engine, out_dtype=pol.compute)
        else:
            db = _kernel_gemm(_swap_last(aq), gq, None, semiring.MATMUL, engine,
                              out_dtype=pol.compute)
        db = _sum_to_shape(db, bq.shape).to(pol.compute)
    return da, db


class _MpCore(torch.autograd.Function):
    """z = a @ b on compute-format operands, with the hybrid-FP8 VJP."""

    @staticmethod
    def forward(ctx, a, b, engine):
        pol = engine.policy
        aq, bq = cast(a, pol.storage_fwd), cast(b, pol.storage_fwd)
        ctx.engine = engine
        ctx.save_for_backward(aq, bq)
        return _kernel_gemm(aq, bq, None, semiring.MATMUL, engine)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        da, db = _mp_backward(ctx.engine, ctx.needs_input_grad[:2], aq, bq, g)
        return da, db, None


class _MpCoreY(torch.autograd.Function):
    """z = a @ b + y, y folded into the accumulator (one rounding);
    dy is the cotangent, batch-summed to y's shape."""

    @staticmethod
    def forward(ctx, a, b, y, engine):
        pol = engine.policy
        aq, bq = cast(a, pol.storage_fwd), cast(b, pol.storage_fwd)
        ctx.engine = engine
        ctx.y_meta = (tuple(y.shape), y.dtype)
        ctx.save_for_backward(aq, bq)
        return _kernel_gemm(aq, bq, y, semiring.MATMUL, engine)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        da, db = _mp_backward(ctx.engine, ctx.needs_input_grad[:2], aq, bq, g)
        dy = None
        if ctx.needs_input_grad[2]:
            y_shape, y_dtype = ctx.y_meta
            dy = _sum_to_shape(g.to(ctx.engine.policy.acc), y_shape).to(y_dtype)
        return da, db, dy, None


def mp_matmul(a: torch.Tensor, b: torch.Tensor, engine) -> torch.Tensor:
    """z = a @ b under the engine's policy, on the engine's backend,
    differentiable with the hybrid-FP8 rule."""
    pol = engine.policy
    return _MpCore.apply(_to_compute(a, pol), _to_compute(b, pol), engine)


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


def _tropical_backward(gop: GemmOp, engine, xq, wq, r, g):
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
    return (_sum_to_shape(dx, xq.shape).to(compute),
            _sum_to_shape(dw, wq.shape).to(compute))


class _TropicalCore(torch.autograd.Function):
    """r = star_k circ(x, w) in the accumulator format, with the tropical VJP."""

    @staticmethod
    def forward(ctx, x, w, gop, engine):
        pol = engine.policy
        xq, wq = cast(x, pol.storage_fwd), cast(w, pol.storage_fwd)
        # Accumulator-format output: min/max select (never round), so the
        # saved reduction compares bit for bit with the backward recompute.
        r = _kernel_gemm(xq, wq, None, gop, engine, out_dtype=pol.acc)
        ctx.gop, ctx.engine = gop, engine
        ctx.save_for_backward(xq, wq, r)
        return r

    @staticmethod
    def backward(ctx, g):
        xq, wq, r = ctx.saved_tensors
        dx, dw = _tropical_backward(ctx.gop, ctx.engine, xq, wq, r, g)
        return dx, dw, None, None


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
        return _MpCoreY.apply(_to_compute(x, pol), _to_compute(w, pol), y, engine)
    r = _TropicalCore.apply(_to_compute(x, pol), _to_compute(w, pol), gop, engine)
    if y is not None:
        r = semiring.op_fn(gop.star)(y.to(r.dtype), r)
    return cast(r, pol.out)
