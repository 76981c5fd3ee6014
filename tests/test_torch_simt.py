"""The GEMM-Op kernel's SIMT schedule, on the CPU: the planner's form and
K split at the shapes that reach it, the split-K combine's plain version
with the min and max stars, and the plain version of all six semiring
pairs against the JAX reference on operands with NaN, +-inf, +-0 and
values past E4M3's 464.

The CUDA forms themselves run only on the card (``chip_smoke.py`` phase
3c holds each against the plain version bit for bit); what they must
match is held here. min and max select and never round, so every
comparison is bitwise: NaN at the same positions, the same bits
elsewhere, the sign of a zero included (``jnp.minimum`` orders -0 below
+0, ``torch.minimum`` returns whichever zero comes first).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprec  # noqa: E402
from repro.core import semiring as jsemi  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import semiring as tsemi  # noqa: E402
from repro_torch.core.precision import BF16, E4M3, FP16, FP32, get_policy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import redmule_gemm as rg  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402

SEMIRINGS = [g.name for g in tsemi.TABLE1 if not g.is_gemm]


def _plan(m, n, k, dtype, op, policy, batch=1, w_kmajor=False):
    x = rg.Operand(dtype, m, k, k, 1)
    w = rg.Operand(dtype, n, k, 1, n) if not w_kmajor else rg.Operand(dtype, n, k, k, 1)
    return rg.plan_gemm(m, n, k, batch, x, w, tsemi.get(op), get_policy(policy))


# (m, n, k, operand format, op, policy, batch) -> (form, split, K a split)
PLANS = {
    "moe router, a draft-decode step": ((4, 32, 1024, FP32, "matmul", "fp32", 1),
                                        ("warp", 1, 1024)),
    "moe router, the catch-up": ((64, 32, 1024, FP32, "matmul", "fp32", 1), ("warp", 1, 1024)),
    "moe router, a train step's 2048 rows": ((2048, 32, 1024, FP32, "matmul", "fp32", 1),
                                             ("f32", 4, 256)),
    "apsp 64x4096x12800 e4m3": ((64, 12800, 4096, E4M3, "apsp", "redmule_hfp8", 1),
                                ("h2", 5, 832)),
    "closure squaring 4096^3 fp32": ((4096, 4096, 4096, FP32, "apsp", "fp32", 1),
                                     ("f32", 1, 4096)),
    "closure squaring 4096^3 fp16": ((4096, 4096, 4096, FP16, "max_capacity_path",
                                      "redmule_fp16", 1), ("h2", 1, 4096)),
    "fp32 matmul 64x4096x12800": ((64, 12800, 4096, FP32, "matmul", "fp32", 1), ("f32", 5, 832)),
    "bf16 semiring": ((256, 512, 2048, BF16, "max_critical_path", "tpu_bf16", 1),
                      ("h2", 8, 256)),
    "fp32 operands, fp16 compute (mul, add)": ((200, 300, 1000, FP32, "matmul", "redmule_hfp8",
                                                1), ("f32", 3, 336)),
    "tiny fp32": ((3, 7, 5, FP32, "apsp", "fp32", 1), ("warp", 1, 5)),
    "tiny e4m3": ((3, 7, 5, E4M3, "apsp", "redmule_hfp8", 1), ("h2", 1, 16)),
    "ragged e4m3, split across K": ((37, 70, 1000, E4M3, "apsp", "redmule_hfp8", 1),
                                    ("h2", 3, 336)),
    "ragged fp32, split across K": ((100, 200, 1001, FP32, "apsp", "fp32", 1), ("f32", 3, 336)),
    "batched fp32, no split": ((37, 70, 300, FP32, "apsp", "fp32", 3), ("f32", 1, 304)),
    "K = 0": ((64, 128, 0, FP32, "apsp", "fp32", 1), ("f32", 1, 0)),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_simt_form_and_split(case):
    args, want = PLANS[case]
    plan = _plan(*args)
    assert plan.schedule == "simt"
    assert (plan.form, plan.split, plan.k_per_split) == want
    m, n, k = args[:3]
    # Every split holds K, a whole number of staged steps (the tiled forms),
    # and none is empty.
    assert plan.form == "warp" or plan.k_per_split % rg.SIMT_BK == 0
    assert plan.split * plan.k_per_split >= k and (plan.split - 1) * plan.k_per_split < max(k, 1)


@pytest.mark.parametrize("w_kmajor", [False, True])
def test_simt_form_does_not_depend_on_the_weight_layout(w_kmajor):
    """Strides choose how a form stages its tiles, never the form."""
    plan = _plan(64, 12800, 4096, E4M3, "apsp", "redmule_hfp8", w_kmajor=w_kmajor)
    assert (plan.form, plan.split) == ("h2", 5)


def test_simt_tiles_come_nearest_one_resident_wave():
    """K is split until the grid comes nearest the table's blocks
    (``tuning.SIMT_SPLIT``: four resident blocks an SM, one wave), unless a
    split would hold less than its least K; with as many tiles as that, K
    stays whole."""
    rule = tuning.SIMT_SPLIT
    for m, n, k in [(64, 12800, 4096), (64, 1024, 65536), (512, 512, 512), (64, 128, 100000),
                    (64, 384, 4096), (4096, 4096, 4096), (2048, 4096, 1024)]:
        plan = _plan(m, n, k, E4M3, "apsp", "redmule_hfp8")
        tiles = -(-m // rg.SIMT_TILE_M) * -(-n // rg.SIMT_TILE_N)
        if tiles * 3 // 2 >= rule.blocks:
            assert plan.split == 1
        elif k // rule.min_k * tiles >= rule.blocks:
            assert abs(tiles * plan.split - rule.blocks) <= tiles / 2
        else:  # K bounds the split
            assert plan.k_per_split >= rule.min_k
            assert tiles * plan.split <= rule.blocks
            assert plan.k_per_split < 2 * rule.min_k


def _special_partials(rng, shape):
    ws = rng.standard_normal(shape).astype(np.float32)
    flat = ws.reshape(-1)
    idx = rng.choice(flat.size, 40, replace=False)
    flat[idx] = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0] * 8, np.float32)
    # Whole (batch, m, n) columns of zeros of both signs, so the result is a zero.
    ws[:, :, 0, :3] = np.where(rng.random((ws.shape[0], ws.shape[1], 3)) < 0.5, -0.0, 0.0)
    return torch.from_numpy(ws)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    assert torch.equal(gn, wn), "NaN positions differ"
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    assert torch.equal(got.view(bits)[~gn], want.view(bits)[~wn])


@pytest.mark.parametrize("out_dtype", [FP32, FP16])
@pytest.mark.parametrize("star", [tsemi.Op.MIN, tsemi.Op.MAX])
def test_splitk_combine_plain_min_max_any_split_order(star, out_dtype):
    rng = np.random.default_rng(5)
    ws = _special_partials(rng, (2, 4, 3, 5))
    y = torch.from_numpy(rng.standard_normal((2, 3, 5)).astype(np.float32))
    want = rg.splitk_combine_plain(ws, y, out_dtype, star)
    for order in itertools.permutations(range(4)):
        _same_bits(rg.splitk_combine_plain(ws[:, list(order)].contiguous(), y, out_dtype, star),
                   want)
    # NaN in any split (or in Y) propagates.
    assert torch.equal(torch.isnan(want.float()), torch.isnan(ws).any(1) | torch.isnan(y))
    # The zero columns: -0 below +0, whatever the order.
    z = rg.splitk_combine_plain(ws, None, FP32, star)[:, 0, :3]
    neg = torch.signbit(ws[:, :, 0, :3])
    fin = ~torch.isnan(z)
    assert (z[fin] == 0).all()
    want_neg = neg.any(1) if star is tsemi.Op.MIN else neg.all(1)
    assert torch.equal(torch.signbit(z)[fin], want_neg[fin])


ZERO_PAIRS = [(a, b) for a in (0.0, -0.0, 1.0, np.nan) for b in (0.0, -0.0, -1.0, np.nan)]


@pytest.mark.parametrize("op", ["min", "max"])
def test_minimum_maximum_order_zeros_and_nan_as_jnp(op):
    a = np.array([p[0] for p in ZERO_PAIRS], np.float32)
    b = np.array([p[1] for p in ZERO_PAIRS], np.float32)
    jfn, tfn = (jnp.minimum, tsemi.minimum) if op == "min" else (jnp.maximum, tsemi.maximum)
    for x, y in ((a, b), (b, a)):
        want = torch.from_numpy(np.array(jfn(jnp.asarray(x), jnp.asarray(y))))
        _same_bits(tfn(torch.from_numpy(x), torch.from_numpy(y)), want)


@pytest.mark.parametrize("op", ["min", "max"])
def test_star_reduce_orders_zeros_as_jnp(op):
    rng = np.random.default_rng(9)
    x = np.where(rng.random((64, 12)) < 0.5, -0.0, 0.0).astype(np.float32)
    x[:8] = np.abs(x[:8])  # rows of +0 only
    x[8:16] = -np.abs(x[8:16])  # rows of -0 only
    x[16:20, 3] = np.nan
    x[20:24, 5] = 1.0 if op == "min" else -1.0  # a non-zero that loses to the zeros
    jfn = jnp.min if op == "min" else jnp.max
    want = torch.from_numpy(np.array(jfn(jnp.asarray(x), axis=1)))
    star = tsemi.Op.MIN if op == "min" else tsemi.Op.MAX
    _same_bits(tsemi.star_reduce(star, torch.from_numpy(x), 1), want)


def _edge(rng, shape, zero_row=None, zero_col=None):
    """Normal values with NaN, +-inf, +-0, magnitudes past 464 and a row or
    column of zeros of both signs."""
    t = (rng.standard_normal(shape) * 4).astype(np.float32)
    flat = t.reshape(-1)
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 500.0, -600.0, -0.0], np.float32)
    flat[rng.choice(flat.size, specials.size, replace=False)] = specials
    if zero_row is not None:
        t[zero_row] = np.where(rng.random(shape[1]) < 0.5, -0.0, 0.0)
    if zero_col is not None:
        t[:, zero_col] = np.where(rng.random(shape[0]) < 0.5, -0.0, 0.0)
    return t


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
@pytest.mark.parametrize("op", SEMIRINGS)
def test_plain_semiring_matches_reference_on_edge_operands(op, policy, backend):
    rng = np.random.default_rng(sum(map(ord, op + policy)))
    x = _edge(rng, (6, 48), zero_row=2)
    w = _edge(rng, (48, 10), zero_col=4)
    y = _edge(rng, (6, 10))
    y[2, 4] = -0.0  # meets the zero row and column
    want = jops.gemm_op(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y), gop=jsemi.get(op),
                        policy=jprec.get_policy(policy), backend=backend)
    got = tops.gemm_op(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
                       gop=tsemi.get(op), policy=get_policy(policy))
    want = np.array(want)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    wt = torch.from_numpy(want.view(np.int32 if want.dtype.itemsize == 4 else np.int16))
    _same_bits(got, wt.view(got.dtype))
    # The edges are really exercised: NaN and zeros of both signs reach Z.
    zf = got.float()
    assert torch.isnan(zf).any() and (zf == 0).any()
