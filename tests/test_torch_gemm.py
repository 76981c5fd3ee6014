"""The port's GEMM-Op dispatch (plain path, CPU) against ``repro.kernels.ops``.

Same numpy inputs through both packages, for all seven Table-1 ops under
three policies and four operand layouts: 2D with Y, batched x with a shared
w, batched w broadcast over an axis, and a transposed-view w. The reference
runs its XLA path; a few tiny shapes also run its Pallas kernel in
interpret mode.

Tolerances: min and max select values and never round, so those ops are
bitwise. The (mul, add) pair sums in fp32 in another order than XLA, so it
is held to 1 ulp of a 16-bit output format and, for fp32 outputs, to
2 ulp at the output's largest magnitude: the sums run over K <= 70 terms,
and their order alone moves a few fp32 elements by more than 1 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprec  # noqa: E402
from repro.core import semiring as jsemi  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import semiring as tsemi  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import paged_flash_decode  # noqa: E402
from repro_torch.kernels.redmule_gemm import redmule_gemm  # noqa: E402

OPS = [g.name for g in jsemi.TABLE1]
POLICIES = ["fp32", "redmule_hfp8", "tpu_bf16"]
ULPS = {np.dtype(np.float32): 2.0, np.dtype(np.float16): 1.0}


def _layout(name, rng):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if name == "2d+y":
        return r(13, 70), r(70, 29), r(13, 29), False
    if name == "batched-shared-w":
        return r(3, 19, 33), r(33, 21), r(19, 21), False
    if name == "broadcast-w":
        return r(2, 3, 9, 17), r(2, 1, 17, 11), None, False
    if name == "transposed-w":
        return r(2, 9, 17), r(11, 17), None, True
    raise ValueError(name)


def _run_both(x, w, y, transposed, op, policy, backend="xla"):
    jw = jnp.asarray(w).T if transposed else jnp.asarray(w)
    tw = torch.from_numpy(w).T if transposed else torch.from_numpy(w)
    want = jops.gemm_op(
        jnp.asarray(x), jw, None if y is None else jnp.asarray(y),
        gop=jsemi.get(op), policy=jprec.get_policy(policy), backend=backend,
    )
    got = tops.gemm_op(
        torch.from_numpy(x), tw, None if y is None else torch.from_numpy(y),
        gop=tsemi.get(op), policy=tprec.get_policy(policy),
    )
    return np.asarray(want), got


def _assert_parity(want, got, op):
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    assert tuple(got.shape) == want.shape
    w = want.astype(np.float32)
    g = got.float().numpy()
    if op != "matmul":
        np.testing.assert_array_equal(g, w)
        return
    scale = np.abs(w).max()
    out_dt = np.dtype(np.float16) if want.dtype.itemsize == 2 else np.dtype(np.float32)
    ulp = float(np.spacing(out_dt.type(scale)))
    if want.dtype.name == "bfloat16":
        ulp = float(2.0 ** (np.floor(np.log2(scale)) - 7))
    ulps = ULPS.get(out_dt, 1.0)
    assert np.abs(g - w).max() <= ulps * ulp, (np.abs(g - w).max(), ulp)


@pytest.mark.parametrize("layout", ["2d+y", "batched-shared-w", "broadcast-w", "transposed-w"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("op", OPS)
def test_gemm_op_matches_reference_xla(op, policy, layout):
    x, w, y, transposed = _layout(layout, np.random.default_rng(len(layout)))
    want, got = _run_both(x, w, y, transposed, op, policy)
    _assert_parity(want, got, op)


@pytest.mark.parametrize("op,policy", [
    ("matmul", "redmule_hfp8"), ("apsp", "fp32"), ("max_capacity_path", "redmule_hfp8"),
])
def test_gemm_op_matches_reference_pallas_interpret(op, policy):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 11)).astype(np.float32)
    w = rng.standard_normal((11, 7)).astype(np.float32)
    y = rng.standard_normal((5, 7)).astype(np.float32)
    want, got = _run_both(x, w, y, False, op, policy, backend="pallas_interpret")
    _assert_parity(want, got, op)


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matmul_matches_reference_engine_bitwise(policy):
    """Engine-level parity keeps the reference's f32 -> compute -> storage
    cast order, double rounding included (ROADMAP queue 3)."""
    rng = np.random.default_rng(4)
    a = (rng.standard_normal((3, 6, 24)) * 40).astype(np.float32)
    b = rng.standard_normal((24, 10)).astype(np.float32)
    want = np.asarray(JEngine(policy=policy, backend="xla").matmul(jnp.asarray(a), jnp.asarray(b)))
    got = TEngine(policy=policy, backend="torch").matmul(torch.from_numpy(a), torch.from_numpy(b))
    if policy == "fp32":
        _assert_parity(want, got, "matmul")
    else:
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_fp8_weight_reaches_the_kernel_without_a_widened_copy():
    """An E4M3 weight under an E4M3 policy goes to the GEMM as it is (the
    f16 round trip is the identity), so fp8 weights stay one byte wide."""
    from repro_torch.engine import autodiff

    w = tprec.cast(torch.randn(8, 4), tprec.E4M3)
    assert autodiff.quantize_fwd(w, tprec.REDMULE_HFP8) is w
    assert autodiff.quantize_fwd(w.T, tprec.REDMULE_HFP8).data_ptr() == w.data_ptr()


def test_kernel_wrappers_refuse_cpu_tensors():
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    with pytest.raises(ValueError, match="on one card"):
        redmule_gemm(x, w, None, gop=tsemi.MATMUL, policy=tprec.FP32_REF,
                     out_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.gemm_op(x, w, backend="cuda")
    q = torch.randn(2, 1, 2, 8)
    pool = torch.randn(8, 1, 8)
    pt = torch.ones(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="on one card"):
        paged_flash_decode(q, pool, pool, pt, torch.zeros(2, dtype=torch.int32),
                           torch.ones(2, dtype=torch.int32), page_size=4)


def test_default_backend_follows_the_tensor_device():
    x, w = torch.randn(4, 8), torch.randn(8, 3)
    z = tops.gemm_op(x, w)  # CPU tensors -> the plain version
    torch.testing.assert_close(z, x @ w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "float8_e4m3fn", "float8_e5m2"])
def test_semiring_identities_match_reference(dtype):
    """Table 1 and the identities, including the no-inf clamp (e4m3fn: +-448)."""
    assert [g.name for g in tsemi.TABLE1] == [g.name for g in jsemi.TABLE1]
    for tg, jg in zip(tsemi.TABLE1, jsemi.TABLE1):
        assert (tg.circ.value, tg.star.value, tg.group) == (jg.circ.value, jg.star.value, jg.group)
        for op in (tg.circ, tg.star):
            jop = jsemi.Op(op.value)
            assert tsemi.reduce_identity(op) == jsemi.reduce_identity(jop)
            assert (tsemi.finite_identity(op, getattr(torch, dtype))
                    == jsemi.finite_identity(jop, jnp.dtype(dtype)))
    assert tsemi.finite_identity(tsemi.Op.MIN, torch.float8_e4m3fn) == 448.0
