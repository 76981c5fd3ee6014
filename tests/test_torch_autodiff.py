"""The port's engine gradients, closure and oracle against the JAX package's,
on the CPU.

Each test says what it is held to:

- *the reference engine*: ``jax.grad`` (or the forward) through
  ``repro.engine.Engine`` on the ``"xla"`` backend, which rounds an fp32
  operand twice under an fp8 policy (f32 -> fp16 -> E4M3) exactly as the
  port does (ROADMAP queue 3), so the two can agree bit for bit;
- *a plain jnp reference*: ``jax.grad`` of the semiring written with jnp
  min/max, whose tie rules the tropical VJP reproduces;
- *the oracle*: ``kernels/ref.py`` of either package, which rounds once.

The port runs its plain backend (``"torch"``) with the grid of
``tests/test_engine.py``. Tolerances: fp32 1e-5 relative (the order of
fp32 sums); fp16 outputs and gradients 2e-3 relative (one fp16 ulp from
the order of an fp32 sum before the output rounding), atol 1e-6 of the
largest value; E4M3/E5M2 storage changes no tolerance, since both
packages quantize the same values the same way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import semiring as jsemiring  # noqa: E402
from repro.core.precision import get_policy as jget_policy  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import semiring  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    DEFAULT_ENGINE,
    Engine,
    as_engine,
    current_engine,
    engine_scope,
)
from repro_torch.kernels import ref as tref  # noqa: E402

POLICIES = ("fp32", "redmule_fp16", "redmule_hfp8")
SHAPES_2D = [(5, 7, 9), (1, 33, 5), (13, 21, 19)]
BATCH_CASES = [
    ((3,), (13, 7, 9), False),   # batched x, shared 2D w
    ((3,), (5, 11, 6), True),    # batched x and w
    ((2, 3), (4, 9, 5), False),  # two batch dims, shared w
]
SEMIRING_OPS = [g.name for g in semiring.TABLE1 if not g.is_gemm]

_REFS = {
    "apsp": lambda x, w: jnp.min(x[..., :, :, None] + w[..., None, :, :], axis=-2),
    "max_critical_path": lambda x, w: jnp.max(x[..., :, :, None] + w[..., None, :, :], axis=-2),
    "max_reliability_path": lambda x, w: jnp.max(x[..., :, :, None] * w[..., None, :, :], axis=-2),
    "min_reliability_path": lambda x, w: jnp.min(x[..., :, :, None] * w[..., None, :, :], axis=-2),
    "min_spanning_tree": lambda x, w: jnp.min(
        jnp.maximum(x[..., :, :, None], w[..., None, :, :]), axis=-2),
    "max_capacity_path": lambda x, w: jnp.max(
        jnp.minimum(x[..., :, :, None], w[..., None, :, :]), axis=-2),
}


def _tol(policy):
    return 1e-5 if policy == "fp32" else 2e-3


def _close(got: torch.Tensor, want, rtol, name=""):
    w = np.asarray(want, np.float32)
    g = got.detach().float().numpy()
    assert g.shape == w.shape, name
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * scale, err_msg=name)


def _port_grads(fn, *arrays):
    """(value, grads) of sum(fn(*tensors).float() * cot) on the port, the
    last array being the cotangent."""
    *xs, cot = arrays
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    z = fn(*ts)
    (z.float() * torch.from_numpy(cot)).sum().backward()
    return z, [t.grad for t in ts]


def _ref_grads(fn, *arrays):
    *xs, cot = arrays
    z, vjp = jax.vjp(lambda *a: fn(*a), *(jnp.asarray(a) for a in xs))
    return z, vjp(jnp.asarray(cot).astype(z.dtype))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check_matmul(rng, policy, xs, ws, zs):
    x, w, cot = _rand(rng, *xs), _rand(rng, *ws), _rand(rng, *zs)
    eng, jeng = Engine(policy=policy, backend="torch"), JEngine(policy=policy, backend="xla")
    z, (dx, dw) = _port_grads(eng.matmul, x, w, cot)
    jz, (jdx, jdw) = _ref_grads(jeng.matmul, x, w, cot)
    assert z.dtype == tprec.get_policy(policy).out
    assert dx.dtype == dw.dtype == torch.float32  # back through the differentiable cast
    tol = _tol(policy)
    _close(z, jz, tol, "z")
    _close(dx, jdx, tol, "dx")
    _close(dw, jdw, tol, "dw")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("shape", SHAPES_2D, ids=lambda s: "x".join(map(str, s)))
def test_matmul_grads_match_reference_engine(shape, policy, rng):
    """Held to the reference engine: z, dx and dw of Engine.matmul, whose
    backward GEMMs read the cotangent in E5M2 under redmule_hfp8."""
    m, k, n = shape
    _check_matmul(rng, policy, (m, k), (k, n), (m, n))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", BATCH_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_batched_matmul_grads_match_reference_engine(case, policy, rng):
    """Held to the reference engine: a shared 2-D weight's dW is one
    flattened GEMM, a batched weight's is batched."""
    batch, (m, k, n), w_batched = case
    ws = batch + (k, n) if w_batched else (k, n)
    _check_matmul(rng, policy, batch + (m, k), ws, batch + (m, n))


@pytest.mark.parametrize("policy", POLICIES)
def test_gemm_with_y_grads_match_reference_engine(policy, rng):
    """Held to the reference engine: Y folds into the accumulator (one
    rounding) and dY is the cotangent summed over the broadcast batch."""
    x, w, y, cot = _rand(rng, 3, 5, 7), _rand(rng, 7, 4), _rand(rng, 5, 4), _rand(rng, 3, 5, 4)
    eng, jeng = Engine(policy=policy, backend="torch"), JEngine(policy=policy, backend="xla")
    z, (dx, dw, dy) = _port_grads(lambda a, b, c: eng.gemm_op(a, b, c, op="matmul"), x, w, y, cot)
    jz, (jdx, jdw, jdy) = _ref_grads(lambda a, b, c: jeng.gemm_op(a, b, c, op="matmul"),
                                     x, w, y, cot)
    tol = _tol(policy)
    for got, want, name in ((z, jz, "z"), (dx, jdx, "dx"), (dw, jdw, "dw"), (dy, jdy, "dy")):
        _close(got, want, tol, name)


@pytest.mark.parametrize("with_y", [False, True], ids=["no-y", "y"])
@pytest.mark.parametrize("op", SEMIRING_OPS)
def test_semiring_grads_match_reference_engine(op, with_y, rng):
    """Held to the reference engine and to a plain jnp reference (fp32):
    the tropical VJP routes the cotangent to the arg-star lanes; with y,
    torch's own min/max split the cotangent between y and the reduction."""
    m, k, n = 6, 11, 5
    x, w, y, cot = _rand(rng, m, k), _rand(rng, k, n), _rand(rng, m, n), _rand(rng, m, n)
    eng, jeng = Engine(backend="torch"), JEngine(policy="fp32", backend="xla")
    star = jsemiring.op_fn(jsemiring.get(op).star)
    if with_y:
        z, got = _port_grads(lambda a, b, c: eng.gemm_op(a, b, c, op=op), x, w, y, cot)
        jz, want = _ref_grads(lambda a, b, c: jeng.gemm_op(a, b, c, op=op), x, w, y, cot)
        _, plain = _ref_grads(lambda a, b, c: star(c, _REFS[op](a, b)), x, w, y, cot)
    else:
        z, got = _port_grads(lambda a, b: eng.gemm_op(a, b, op=op), x, w, cot)
        jz, want = _ref_grads(lambda a, b: jeng.gemm_op(a, b, op=op), x, w, cot)
        _, plain = _ref_grads(lambda a, b: _REFS[op](a, b), x, w, cot)
    _close(z, jz, 1e-6, "z")
    for g, r, p, name in zip(got, want, plain, "xwy"):
        _close(g, r, 1e-5, f"d{name} vs engine")
        _close(g, p, 1e-5, f"d{name} vs jnp")


@pytest.mark.parametrize("op", ["apsp", "max_capacity_path", "min_spanning_tree"])
def test_semiring_grads_split_ties_like_jax(op, rng):
    """Held to a plain jnp reference (1e-6: a split of 1/3 or 1/6 rounds in
    another order): integer data forces ties on the reduction (split
    evenly) and on a min/max circ (split half and half)."""
    x = rng.integers(0, 3, (4, 6)).astype(np.float32)
    w = rng.integers(0, 3, (6, 5)).astype(np.float32)
    cot = np.ones((4, 5), np.float32)
    eng = Engine(backend="torch")
    _, got = _port_grads(lambda a, b: eng.gemm_op(a, b, op=op), x, w, cot)
    _, want = _ref_grads(_REFS[op], x, w, cot)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_semiring_grads_batched_shared_w(rng):
    """Held to a plain jnp reference: batched x against a shared 2-D w, K = 70
    over two backward chunks of 64; dW sums over the batch."""
    x, w, cot = _rand(rng, 3, 5, 70), _rand(rng, 70, 4), np.ones((3, 5, 4), np.float32)
    eng = Engine(backend="torch")
    _, (dx, dw) = _port_grads(lambda a, b: eng.gemm_op(a, b, op="apsp"), x, w, cot)
    _, (jdx, jdw) = _ref_grads(_REFS["apsp"], x, w, cot)
    assert dw.shape == (70, 4)
    _close(dx, jdx, 1e-6, "dx")
    _close(dw, jdw, 1e-6, "dw")


@pytest.mark.parametrize("policy", ["redmule_fp16", "redmule_hfp8"])
def test_semiring_grads_quantized_policy(policy, rng):
    """Held to the reference engine: under a 16-bit or fp8 policy the
    subgradient follows the quantized forward's arg-min lanes, and the
    cotangent crosses in the backward storage format (E5M2 under hfp8)."""
    x, w, cot = _rand(rng, 6, 9), _rand(rng, 9, 5), _rand(rng, 6, 5)
    eng, jeng = Engine(policy=policy, backend="torch"), JEngine(policy=policy, backend="xla")
    z, got = _port_grads(lambda a, b: eng.gemm_op(a, b, op="apsp"), x, w, cot)
    jz, want = _ref_grads(lambda a, b: jeng.gemm_op(a, b, op="apsp"), x, w, cot)
    _close(z, jz, 0.0, "z")  # min selects a value: no rounding order to differ
    for g, r, name in zip(got, want, "xw"):
        _close(g, r, 1e-6, f"d{name}")


def _floyd_warshall(dist):
    fw = dist.copy()
    for k in range(dist.shape[0]):
        fw = np.minimum(fw, fw[:, k:k + 1] + fw[k:k + 1, :])
    return fw


def _random_graph(rng, v=16, p=0.25, inf=3e4):
    adj = rng.random((v, v)).astype(np.float32) * 10
    dist = np.where(rng.random((v, v)) < p, adj, np.float32(inf))
    np.fill_diagonal(dist, 0.0)
    return dist


def test_closure_matches_reference_and_floyd_warshall(rng):
    """Held to the reference engine's closure (equal) and to Floyd-Warshall."""
    dist = _random_graph(rng)
    got = Engine(backend="torch").closure(torch.from_numpy(dist), op="apsp")
    want = JEngine(policy="fp32").closure(jnp.asarray(dist), op="apsp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), _floyd_warshall(dist), rtol=1e-5, atol=1e-3)


def test_closure_early_exit_is_fixpoint(rng):
    dist = torch.from_numpy(_random_graph(rng, v=10))
    eng = Engine(backend="torch")
    a = eng.closure(dist, op="apsp")
    b = eng.closure(dist, op="apsp", max_steps=40)
    assert torch.equal(a, b)


def test_closure_max_capacity_matches_reference(rng):
    """(min, max) closure, batched: equal to the reference's; one more
    squaring step is a no-op."""
    v = 10
    caps = np.stack([np.where(rng.random((v, v)) < 0.3,
                              rng.random((v, v)).astype(np.float32) * 9 + 1, np.float32(0.0))
                     for _ in range(2)])
    eng = Engine(backend="torch")
    c = eng.closure(torch.from_numpy(caps), op="max_capacity_path")
    want = JEngine(policy="fp32").closure(jnp.asarray(caps), op="max_capacity_path")
    np.testing.assert_array_equal(c.numpy(), np.asarray(want))
    assert torch.equal(eng.gemm_op(c, c, c, op="max_capacity_path"), c)
    with pytest.raises(ValueError, match="square"):
        eng.closure(torch.zeros(3, 4))


@pytest.mark.parametrize("op", ["matmul", "apsp", "max_capacity_path"])
def test_engine_matches_the_oracle(op, rng):
    """Held to the port's oracle (fp32 policy: no rounding of the operands,
    so one rounding and two agree)."""
    x, w, y = _rand(rng, 13, 21), _rand(rng, 21, 19), _rand(rng, 13, 19)
    gop = semiring.get(op)
    got = Engine(backend="torch").gemm_op(torch.from_numpy(x), torch.from_numpy(w),
                                          torch.from_numpy(y), op=op)
    want = tref.gemm_op_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y), gop)
    _close(got, want.numpy(), 1e-5)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd-cast", "bwd-cast"])
@pytest.mark.parametrize("op", ["matmul", "apsp", "max_reliability_path"])
def test_oracle_matches_reference_oracle(op, backward, rng):
    """The port's oracle against ``repro.kernels.ref.gemm_op_ref`` under
    redmule_hfp8: both round each operand once (E4M3 forward, E5M2 with
    ``backward``), so they agree to the order of an fp32 sum (2e-3, an
    fp16 output ulp)."""
    x, w, y = _rand(rng, 8, 16), _rand(rng, 16, 8), _rand(rng, 8, 8)
    gop, jgop = semiring.get(op), jsemiring.get(op)
    pol, jpol = tprec.get_policy("redmule_hfp8"), jget_policy("redmule_hfp8")
    got = tref.gemm_op_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y),
                           gop, pol, backward=backward)
    want = jref.gemm_op_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(y), jgop, jpol,
                            backward=backward)
    assert got.dtype == pol.out
    _close(got, want, 2e-3)


def test_engine_scope_and_coercion():
    eng = Engine(policy="redmule_hfp8", backend="torch")
    assert current_engine() is DEFAULT_ENGINE
    assert DEFAULT_ENGINE.backend == "cuda"  # the port's default engine targets the card
    with engine_scope(eng) as e:
        assert e is eng and current_engine() is eng
        inner = as_engine("fp32")  # a bare policy keeps the ambient backend
        assert inner.backend == "torch" and inner.policy.name == "fp32"
        with engine_scope("redmule_fp16"):
            assert current_engine().policy.name == "redmule_fp16"
        assert current_engine() is eng
    assert current_engine() is DEFAULT_ENGINE
    assert eng.with_backend("cuda").backend == "cuda"
    assert eng.with_policy("fp32").policy is tprec.FP32_REF
    with pytest.raises(ValueError, match="unknown backend"):
        Engine(backend="xla")
    with pytest.raises(TypeError):
        as_engine(3)
