"""The RedMulE GEMM-Op kernel on Hopper, its launch wrapper, its planner
and its plain version.

:func:`redmule_gemm` launches the port of the TPU kernel
``repro/kernels/redmule_gemm.py::redmule_gemm_pallas``:
Z = star(Y, star_k circ(X, W)) for every Table-1 pair, operands in their
storage format, circ in the compute format, an fp32 accumulator, and the
output cast on the way out. :func:`plan_gemm` chooses one of three
schedules from the shapes, formats and strides alone:

- ``"tc"`` (``csrc/redmule_gemm_tc.cu``): wgmma fed by TMA, for (mul, add)
  on fp8 operands, or on fp16/bf16 operands already in the compute format,
  with more than :data:`SMALL_M_MAX` rows;
- ``"small_row"`` (``csrc/redmule_gemm_sr.cu``): weight streaming with
  split K, for the same pair on fp8 operands with at most
  :data:`SMALL_M_MAX` rows (the decode step);
- ``"simt"`` (``csrc/redmule_gemm.cu``): every other case, the six semiring
  pairs and the fp32 compute format among them.

The two tensor-core schedules read K-major operands; the plan names the
operands whose views are not, and the wrapper copies those with the K-major
copy kernel first. With more than one tensor-core tile in both directions,
fp8 operands are copied widened to fp16 (exact), so that each is widened
once, not once per tile. The source note in ``redmule_gemm.cu`` says what bounds
each schedule and how its numerics meet the reference's.

:func:`redmule_gemm_plain` computes the same function with plain PyTorch
ops. The CPU path and the tests use it, and ``chip_smoke.py`` holds the
kernels against it on the card. It widens the compute-format operands to
fp32; for the semiring pairs it scans K in chunks and never builds the
(M, K, N) product.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import semiring
from repro_torch.core.precision import BF16, E4M3, E5M2, FP8_DTYPES, FP16, PrecisionPolicy, cast
from repro_torch.core.semiring import GemmOp
from repro_torch.kernels import _build

# One per GEMM-Op call on the card, whatever its schedule (chip_smoke.py
# reads it per decode step, prefill and train step).
launches = _build.LaunchCount()
# One per launch of each schedule's kernel.
simt_launches = _build.LaunchCount()
tc_launches = _build.LaunchCount()
small_row_launches = _build.LaunchCount()
# Launches around a schedule: K-major copies and split-K combines.
aux_launches = _build.LaunchCount()

SCHEDULE_COUNTERS = {"simt": simt_launches, "tc": tc_launches, "small_row": small_row_launches}

# Rows at or below which fp8 (mul, add) takes the small-row schedule: the
# decode step's slots. Above it a 64-row wgmma tile is worth its zeros.
SMALL_M_MAX = 16
# The tensor-core tile (rows and columns of Z). The kernel widens each fp8
# tile to fp16 in shared memory, so with more than one tile in both
# directions every X tile would be widened once per column tile and every
# W tile once per row tile; the wrapper then widens both operands once
# instead (exact), and the kernel reads fp16 straight.
TC_TILE_M = TC_TILE_N = 128
SR_BLOCK_N = 64  # weight rows a small-row block streams
SR_STEP = 64  # K bytes a small-row warp covers per step; splits are multiples of it
# Split K until the small-row grid has two blocks for each of the H100's
# 132 SMs, keeping at least this much K in each split.
SR_MIN_BLOCKS = 2 * 132
SR_MIN_K_PER_SPLIT = 256
# Operand kinds of the tensor-core schedules (enum Kind in the .cu files).
MMA_KIND = {E4M3: 0, E5M2: 1, FP16: 2, BF16: 3}

_MAX_GRID_YZ = 65535
_MIN_TILE_M = 64  # the fewest rows a block of any schedule covers above SMALL_M_MAX
# Elements of one (batch, M, chunk, N) circ block in the plain semiring scan.
_PLAIN_CHUNK_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class Operand:
    """One operand as a schedule reads it: rows of K elements. For X the rows
    are M; for W (a K x N operand) they are N, so a K-major W has
    ``k_stride == 1``. Strides are in elements, ``batch_strides`` 0 where
    the operand broadcasts; ``byte_offset`` is its address modulo 16."""

    dtype: torch.dtype
    rows: int
    k: int
    row_stride: int
    k_stride: int
    batch_strides: tuple[int, int] = (0, 0)
    byte_offset: int = 0

    def kmajor(self) -> bool:
        """A K-major view with 16-byte-aligned rows of a whole number of
        16-byte groups: what TMA and the small-row loads read as it is."""
        es = self.dtype.itemsize
        return ((self.k_stride == 1 or self.k == 1)
                and self.k * es % 16 == 0
                and (self.rows <= 1 or self.row_stride * es % 16 == 0)
                and all(s * es % 16 == 0 for s in self.batch_strides)
                and self.byte_offset % 16 == 0)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    schedule: str  # "tc", "small_row" or "simt"
    copy_x: bool = False  # X goes through the K-major copy first
    copy_w: bool = False  # W goes through the K-major copy first
    widen: bool = False  # the copies widen fp8 operands to fp16
    split: int = 1  # K splits of the small-row schedule
    k_per_split: int = 0


def plan_gemm(m: int, n: int, k: int, batch: int, x: Operand, w: Operand, gop: GemmOp,
              policy: PrecisionPolicy) -> GemmPlan:
    """The schedule of one GEMM-Op call, from shapes, formats and strides
    alone. ``batch`` is the number of (b1, b2) batch entries."""
    fp8 = x.dtype in FP8_DTYPES and w.dtype in FP8_DTYPES
    sixteen = x.dtype == w.dtype == policy.compute
    if (not gop.is_gemm or k == 0 or policy.compute not in (FP16, BF16)
            or not (fp8 or sixteen)):
        return GemmPlan("simt")
    if fp8 and m <= SMALL_M_MAX:
        blocks = -(-n // SR_BLOCK_N) * batch
        split = 1
        while blocks * split < SR_MIN_BLOCKS and k // (2 * split) >= SR_MIN_K_PER_SPLIT:
            split *= 2
        k_per_split = -(-k // (split * SR_STEP)) * SR_STEP
        return GemmPlan("small_row", copy_w=not w.kmajor(), split=-(-k // k_per_split),
                        k_per_split=k_per_split)
    if fp8 and m > TC_TILE_M and n > TC_TILE_N:
        return GemmPlan("tc", copy_x=True, copy_w=True, widen=True)
    return GemmPlan("tc", copy_x=not x.kmajor(), copy_w=not w.kmajor())


def _broadcast(*shapes) -> tuple[int, ...]:
    """``torch.broadcast_shapes`` in plain Python: the wrapper runs once per
    GEMM on the host, where the library function costs tens of µs."""
    out: list[int] = []
    for shape in shapes:
        shape = tuple(shape)
        pad = len(shape) - len(out)
        if pad > 0:
            out = [1] * pad + out
        for i, d in enumerate(shape, len(out) - len(shape)):
            if d != out[i] and out[i] != 1 and d != 1:
                raise ValueError(f"shapes {shapes} do not broadcast")
            if out[i] == 1:
                out[i] = d
    return tuple(out)


def _batch_strides(t: torch.Tensor, batch: tuple[int, ...]) -> list[int]:
    """Element strides of ``t``'s leading dims aligned to the broadcast
    ``batch`` shape: 0 where ``t`` broadcasts (missing or size-1 dims)."""
    off = len(batch) - (t.dim() - 2)
    return [
        0 if i < off or t.shape[i - off] == 1 else t.stride(i - off)
        for i in range(len(batch))
    ]


def _collapse_batch(batch, operands):
    """Merge the broadcast batch dims into as few (size, strides) levels as
    the operands' strides allow. Returns [(size, [stride per operand])]."""
    dims = []
    per_op = [_batch_strides(t, batch) for t in operands]
    for i, size in enumerate(batch):
        if size == 1:
            continue
        strides = [s[i] for s in per_op]
        if dims and all(so == si * size for so, si in zip(dims[-1][1], strides)):
            dims[-1] = (dims[-1][0] * size, strides)
        else:
            dims.append((size, strides))
    return dims


def _fold_rows(t: torch.Tensor, batch: tuple[int, ...], rows: int) -> torch.Tensor | None:
    """``t`` (..., rows, c) broadcast to ``batch`` as one (prod(batch) * rows,
    c) view when its strides allow, else None. A weight shared across the
    batch then meets all rows in one GEMM: the decode step's (slots, 1,
    d_model) activations become 4 rows, not 4 batches of 1."""
    c = t.shape[-1]
    te = t.expand(batch + (rows, c))
    dims = [(s, st) for s, st in zip(te.shape[:-1], te.stride()[:-1]) if s != 1]
    for (_, outer), (size, inner) in zip(dims, dims[1:]):
        if outer != inner * size:
            return None
    row_stride = dims[-1][1] if dims else c
    return te.as_strided((math.prod(batch) * rows, c), (row_stride, te.stride(-1)))


@dataclasses.dataclass
class GemmCall:
    """One GEMM-Op call laid out for the kernels: X (b1, b2, m, k), W
    (b1, b2, k, n) and Y (b1, b2, m, n) as tensors and strides, and its plan."""

    x: torch.Tensor
    w: torch.Tensor
    y: torch.Tensor | None
    b1: int
    b2: int
    m: int
    n: int
    k: int
    sx: list[int]  # x: b1, b2, row, k strides
    sw: list[int]  # w: b1, b2, k, n strides
    sy: list[int]  # y: b1, b2, row, n strides (zeros without y)
    out_shape: tuple[int, ...]
    plan: GemmPlan

    def x_operand(self) -> Operand:
        return Operand(self.x.dtype, self.m, self.k, self.sx[2], self.sx[3],
                       (self.sx[0], self.sx[1]), self.x.data_ptr() % 16)

    def w_operand(self) -> Operand:
        return Operand(self.w.dtype, self.n, self.k, self.sw[3], self.sw[2],
                       (self.sw[0], self.sw[1]), self.w.data_ptr() % 16)


def plan_call(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None, *, gop: GemmOp,
              policy: PrecisionPolicy) -> GemmCall:
    """Lay one call out for the kernels and plan it; on any device, so the
    CPU tests reach every layout decision the card's wrapper makes.

    x: (..., M, K) and w: (K, N) or (..., K, N); y: optional (..., M, N).
    Leading dims broadcast. An unbatched w (2D, or all batch dims 1) is
    shared across the batch and never copied; x's batch folds into its rows
    when the strides allow. A batched w with broadcast axes is expanded, as
    the reference does."""
    m, k = x.shape[-2:]
    k2, n = w.shape[-2:]
    if k != k2:
        raise ValueError(f"inner dims disagree: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    batch = _broadcast(x.shape[:-2], w.shape[:-2], () if y is None else y.shape[:-2])
    out_shape = batch + (m, n)
    w_shared = w.dim() == 2 or all(d == 1 for d in w.shape[:-2])
    if w_shared:
        w = w.reshape(w.shape[-2:])
        xf = _fold_rows(x, batch, m) if batch else None
        yf = None if y is None or xf is None else _fold_rows(y.expand(batch + (m, n)), batch, m)
        if xf is not None and (y is None or yf is not None):
            x, y, m, batch = xf, yf, xf.shape[0], ()
    elif tuple(w.shape[:-2]) != batch:
        w = w.expand(batch + (k, n)).contiguous()
    if y is not None:
        y = y.expand(y.shape[:-2] + (m, n))
    operands = [x, w] + ([y] if y is not None else [])
    dims = _collapse_batch(batch, operands)
    if len(dims) > 2:
        # More batch levels than the kernels walk: lay x (and y) out densely.
        x = x.expand(batch + (m, k)).contiguous()
        if y is not None:
            y = y.expand(batch + (m, n)).contiguous()
        operands = [x, w] + ([y] if y is not None else [])
        dims = _collapse_batch(batch, operands)
    while len(dims) < 2:
        dims.insert(0, (1, [0] * len(operands)))
    (b1, s1), (b2, s2) = dims
    sy = [0, 0, 0, 0] if y is None else [s1[2], s2[2], y.stride(-2), y.stride(-1)]
    call = GemmCall(x, w, y, b1, b2, m, n, k,
                    [s1[0], s2[0], x.stride(-2), x.stride(-1)],
                    [s1[1], s2[1], w.stride(-2), w.stride(-1)], sy, out_shape, None)
    call.plan = plan_gemm(m, n, k, b1 * b2, call.x_operand(), call.w_operand(), gop, policy)
    return call


def kmajor_copy(t: torch.Tensor, b1: int, b2: int, rows: int, k: int, strides: list[int],
                widen: bool = False) -> tuple[torch.Tensor, list[int]]:
    """Launch the K-major copy kernel: one operand, given as rows of K
    through ``strides`` (b1, b2, row, k), into a fresh K-major buffer with
    rows padded to 16 bytes (the pad zeroed); with ``widen`` an fp8 operand
    becomes fp16 on the way (exact). A broadcast batch level stays
    broadcast. Returns the buffer and its (b1, b2, row, k) strides."""
    dtype = FP16 if widen else t.dtype
    kp = -(-k * dtype.itemsize // 16) * 16 // dtype.itemsize
    c1, c2 = (b1 if strides[0] else 1), (b2 if strides[1] else 1)
    buf = torch.empty((c1, c2, rows, kp), dtype=dtype, device=t.device)
    err = _build.library().kmajor_copy_launch(
        t.data_ptr(), buf.data_ptr(), t.element_size(), MMA_KIND[t.dtype] if widen else -1,
        c1, c2, rows, k, kp, strides[0], strides[1], strides[2], strides[3],
        _build.stream_handle(t))
    _counted(err, "kmajor_copy", aux_launches)
    return buf, [buf.stride(0) if c1 > 1 else 0, buf.stride(1) if c2 > 1 else 0, kp, 1]


def kmajor_copy_plain(t: torch.Tensor, b1: int, b2: int, rows: int, k: int,
                      strides: list[int], widen: bool = False) -> torch.Tensor:
    """The K-major copy's buffer with plain PyTorch ops, on any device."""
    dtype = FP16 if widen else t.dtype
    kp = -(-k * dtype.itemsize // 16) * 16 // dtype.itemsize
    c1, c2 = (b1 if strides[0] else 1), (b2 if strides[1] else 1)
    src = t.as_strided((c1, c2, rows, k), strides)
    buf = torch.zeros((c1, c2, rows, kp), dtype=dtype, device=t.device)
    if widen:
        buf[..., :k] = src.to(FP16)
    else:
        bits = torch.uint8 if dtype.itemsize == 1 else torch.int16
        buf[..., :k].view(bits).copy_(src.view(bits))
    return buf


def splitk_combine(ws: torch.Tensor, out: torch.Tensor, y: torch.Tensor | None = None,
                   b2: int = 1, sy: list[int] = (0, 0, 0, 0)) -> None:
    """Launch the split-K combine: ``out`` (contiguous, b1 * b2 batches of
    M x N) = Y + the sum of the (b1 * b2, split, M, N) fp32 partials ``ws``
    in split order, through the output cast. Y is read through its
    (b1, b2, row, column) strides ``sy``."""
    bz, split, m, n = ws.shape
    err = _build.library().redmule_splitk_combine_launch(
        ws.data_ptr(), None if y is None else y.data_ptr(),
        0 if y is None else _build.dtype_code(y), out.data_ptr(), _build.dtype_code(out),
        bz // b2, b2, m, n, split, *sy, _build.stream_handle(ws))
    _counted(err, "redmule_splitk_combine", aux_launches)


def splitk_combine_plain(ws: torch.Tensor, y: torch.Tensor | None,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Z from the small-row schedule's (batch, split, M, N) fp32 partials
    with plain PyTorch ops: summed in split order, then Y, then the cast."""
    acc = ws[:, 0]
    for s in range(1, ws.shape[1]):
        acc = acc + ws[:, s]
    if y is not None:
        acc = acc + y.float().reshape(acc.shape)
    return cast(acc, out_dtype)


def redmule_gemm(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None, *,
                 gop: GemmOp, policy: PrecisionPolicy,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the GEMM-Op kernels on CUDA tensors, on the schedule that
    :func:`plan_call` chooses. Takes what :func:`plan_call` takes; returns a
    contiguous (..., M, N) tensor in ``out_dtype``."""
    operands = [x, w] + ([y] if y is not None else [])
    if not all(t.is_cuda for t in operands) or len({t.device for t in operands}) != 1:
        raise ValueError("redmule_gemm launches the CUDA kernel: every operand must be on one card")
    c = plan_call(x, w, y, gop=gop, policy=policy)
    plan = c.plan
    out = torch.empty(c.out_shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if c.b1 * c.b2 > _MAX_GRID_YZ or -(-c.m // _MIN_TILE_M) > _MAX_GRID_YZ:
        raise ValueError(f"grid too large for batch {c.b1}x{c.b2} and M={c.m}")
    lib = _build.library()
    stream = _build.stream_handle(x)
    y_ptr = None if c.y is None else c.y.data_ptr()
    y_dt = 0 if c.y is None else _build.dtype_code(c.y)
    z_args = (out.data_ptr(), _build.dtype_code(out))
    counter = SCHEDULE_COUNTERS[plan.schedule]
    if plan.schedule == "simt":
        err = lib.redmule_gemm_launch(
            semiring.OP_CODE[gop.circ], semiring.OP_CODE[gop.star],
            _build.DTYPE_CODE[policy.compute],
            c.x.data_ptr(), _build.dtype_code(c.x), c.w.data_ptr(), _build.dtype_code(c.w),
            y_ptr, y_dt, *z_args, c.b1, c.b2, c.m, c.n, c.k, *c.sx, *c.sw, *c.sy, stream)
        _counted(err, "redmule_gemm[simt]", counter)
    else:
        xt, sx = c.x, c.sx
        if plan.copy_x:
            xt, sx = kmajor_copy(c.x, c.b1, c.b2, c.m, c.k, c.sx, plan.widen)
        # W in K-major terms: rows n, strides (b1, b2, n, k).
        wt, sw = c.w, [c.sw[0], c.sw[1], c.sw[3], c.sw[2]]
        if plan.copy_w:
            wt, sw = kmajor_copy(c.w, c.b1, c.b2, c.n, c.k, sw, plan.widen)
        kinds = (MMA_KIND[xt.dtype], MMA_KIND[wt.dtype])
        shape = (c.b1, c.b2, c.m, c.n, c.k)
        if plan.schedule == "tc":
            err = lib.redmule_gemm_tc_launch(
                *kinds, xt.data_ptr(), wt.data_ptr(), y_ptr, y_dt, *z_args, *shape,
                *sx[:3], *sw[:3], *c.sy, stream)
            _counted(err, "redmule_gemm[tc]", counter)
        else:
            ws = None
            if plan.split > 1:
                ws = torch.empty((c.b1 * c.b2, plan.split, c.m, c.n), dtype=torch.float32,
                                 device=x.device)
            err = lib.redmule_gemm_sr_launch(
                *kinds, xt.data_ptr(), wt.data_ptr(), y_ptr, y_dt, *z_args,
                None if ws is None else ws.data_ptr(), *shape, plan.split, plan.k_per_split,
                int(c.x_operand().kmajor()), *sx, *sw[:3], *c.sy, stream)
            _counted(err, "redmule_gemm[small_row]", counter)
            if ws is not None:
                splitk_combine(ws, out, c.y, c.b2, c.sy)
    launches.n += 1
    return out


def _counted(err: int, name: str, counter: _build.LaunchCount) -> None:
    _build.check_launch(err, name)
    counter.n += 1


def _star_reduce(op: semiring.Op, x: torch.Tensor, dim: int) -> torch.Tensor:
    if op is semiring.Op.ADD:
        return x.sum(dim)
    if op is semiring.Op.MIN:
        return x.amin(dim)
    return x.amax(dim)


def redmule_gemm_plain(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None, *,
                       gop: GemmOp, policy: PrecisionPolicy,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The GEMM-Op with plain PyTorch ops, on any device: the same operands,
    rules and result as :func:`redmule_gemm`, up to the order of the fp32
    sums for the (mul, add) pair (min and max are exact)."""
    compute = policy.compute
    xc = x.to(compute).float()
    wc = w.to(compute).float()
    if gop.is_gemm:
        z = torch.matmul(xc, wc)
        if y is not None:
            z = z + y.float()
        return cast(z, out_dtype)
    m, k = xc.shape[-2:]
    n = wc.shape[-1]
    batch = tuple(torch.broadcast_shapes(
        xc.shape[:-2], wc.shape[:-2], () if y is None else y.shape[:-2]))
    xb = xc.expand(batch + (m, k))
    wb = wc if wc.dim() == 2 else wc.expand(batch + (k, n))
    circ = semiring.op_fn(gop.circ)
    star = semiring.op_fn(gop.star)
    acc = torch.full(batch + (m, n), semiring.reduce_identity(gop.star),
                     dtype=torch.float32, device=xc.device)
    rows = max(1, acc.numel())
    chunk = max(1, min(k, _PLAIN_CHUNK_ELEMS // rows))
    for k0 in range(0, k, chunk):
        xs = xb[..., :, k0:k0 + chunk, None]  # (..., M, c, 1)
        ws = wb[..., None, k0:k0 + chunk, :]  # (..., 1, c, N)
        prod = circ(xs, ws).to(compute).float()  # circ in the compute format
        acc = star(acc, _star_reduce(gop.star, prod, -2))
    if y is not None:
        acc = star(y.float(), acc)
    return cast(acc, out_dtype)
