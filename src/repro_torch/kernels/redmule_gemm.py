"""The RedMulE GEMM-Op kernel on Hopper, its launch wrapper and its plain version.

:func:`redmule_gemm` launches ``csrc/redmule_gemm.cu``, the port of the TPU
kernel ``repro/kernels/redmule_gemm.py::redmule_gemm_pallas``:
Z = star(Y, star_k circ(X, W)) for every Table-1 pair, operands in their
storage format, circ in the compute format, an fp32 accumulator, and the
output cast on the way out. The source note in the ``.cu`` file says what
bounds it and how the design meets that.

:func:`redmule_gemm_plain` computes the same function with plain PyTorch
ops. The CPU path and the tests use it, and ``chip_smoke.py`` holds the
kernel against it on the card. It widens the compute-format operands to
fp32; for the semiring pairs it scans K in chunks and never builds the
(M, K, N) product.
"""
from __future__ import annotations

import torch

from repro_torch.core import semiring
from repro_torch.core.precision import PrecisionPolicy, cast
from repro_torch.core.semiring import GemmOp
from repro_torch.kernels import _build

# Launches of the CUDA kernel since the last reset (chip_smoke.py reads it).
launches = _build.LaunchCount()

_MAX_GRID_YZ = 65535
_BLOCK = 64  # output tile edge of the kernel (BM = BN)
# Elements of one (batch, M, chunk, N) circ block in the plain semiring scan.
_PLAIN_CHUNK_ELEMS = 1 << 22


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


def redmule_gemm(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor | None, *,
                 gop: GemmOp, policy: PrecisionPolicy,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Launch the CUDA GEMM-Op kernel on CUDA tensors.

    x: (..., M, K) and w: (K, N) or (..., K, N), each in a storage format;
    y: optional (..., M, N) in the accumulator format. Leading dims
    broadcast. An unbatched w (2D, or all batch dims 1) is shared across the
    batch with a batch stride of 0 and never copied; a batched w with
    broadcast axes is expanded, as the reference does. Transposed views are
    taken as they are, through their strides. Returns a contiguous
    (..., M, N) tensor in ``out_dtype``.
    """
    operands = [x, w] + ([y] if y is not None else [])
    if not all(t.is_cuda for t in operands) or len({t.device for t in operands}) != 1:
        raise ValueError("redmule_gemm launches the CUDA kernel: every operand must be on one card")
    m, k = x.shape[-2:]
    k2, n = w.shape[-2:]
    if k != k2:
        raise ValueError(f"inner dims disagree: x {tuple(x.shape)} @ w {tuple(w.shape)}")
    batch = tuple(torch.broadcast_shapes(
        x.shape[:-2], w.shape[:-2], () if y is None else y.shape[:-2]))
    w_shared = w.dim() == 2 or all(d == 1 for d in w.shape[:-2])
    if w_shared:
        w = w.reshape(w.shape[-2:])
    elif tuple(w.shape[:-2]) != batch:
        w = w.expand(batch + (k, n)).contiguous()
    if y is not None:
        y = y.expand(y.shape[:-2] + (m, n))
    operands = [x, w] + ([y] if y is not None else [])
    out = torch.empty(batch + (m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    dims = _collapse_batch(batch, operands)
    if len(dims) > 2:
        # More batch levels than the kernel walks: lay x (and y) out densely.
        x = x.expand(batch + (m, k)).contiguous()
        if y is not None:
            y = y.expand(batch + (m, n)).contiguous()
        operands = [x, w] + ([y] if y is not None else [])
        dims = _collapse_batch(batch, operands)
    while len(dims) < 2:
        dims.insert(0, (1, [0] * len(operands)))
    (b1, s1), (b2, s2) = dims
    if b1 * b2 > _MAX_GRID_YZ or -(-m // _BLOCK) > _MAX_GRID_YZ:
        raise ValueError(f"grid too large for batch {batch} and M={m}")
    if y is None:
        s1, s2 = s1 + [0], s2 + [0]
    lib = _build.library()
    err = lib.redmule_gemm_launch(
        semiring.OP_CODE[gop.circ], semiring.OP_CODE[gop.star],
        _build.DTYPE_CODE[policy.compute],
        x.data_ptr(), _build.dtype_code(x), w.data_ptr(), _build.dtype_code(w),
        None if y is None else y.data_ptr(), 0 if y is None else _build.dtype_code(y),
        out.data_ptr(), _build.dtype_code(out),
        b1, b2, m, n, k,
        s1[0], s2[0], x.stride(-2), x.stride(-1),
        s1[1], s2[1], w.stride(-2), w.stride(-1),
        s1[2], s2[2], 0 if y is None else y.stride(-2), 0 if y is None else y.stride(-1),
        _build.stream_handle(x),
    )
    _build.check_launch(err, "redmule_gemm")
    launches.n += 1
    return out


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
