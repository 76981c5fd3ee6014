"""The port's ``distrib/collectives.py`` against ``repro.distrib.collectives``.

The reference runs its ``compressed_psum`` under ``jax.vmap`` with an
axis name (n shards on one CPU device); the port's runs on n processes
joined by gloo (``tests/test_torch_ranks.py``).

- The E5M2 scale, 2^floor(log2(57344 / absmax)), bit for bit with the
  reference's (eager and jitted) at absmax = 57344 / 2^k and three ulps
  either side for k in [-100, 120), where a log2 that rounds the other
  way halves or doubles the scale.
- Two ranks: the mean, the new residual and three rounds of error
  feedback bit for bit (a two-term sum has one order).
- Eight ranks: the residuals bit for bit; the mean within 4 ulps of the
  largest |mean| (the port sums the dequantized pieces in rank order,
  XLA in its own order), and the reference test's error-feedback
  property (``tests/test_multidevice.py``): a single round within 0.3 of
  the true mean, the cumulative bias of 8 rounds within 2.5 single
  rounds and a quarter of 8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.distrib import collectives as jcoll  # noqa: E402
from repro_torch.distrib import collectives as coll  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from test_torch_ranks import rank_feedback, rank_psum, run_ranks  # noqa: E402


def _edge_values() -> list:
    vals = []
    for k in range(-100, 120):
        base = np.float32(57344.0) / np.float32(2.0 ** k)
        for d in range(-3, 4):
            v = base
            for _ in range(abs(d)):
                v = np.nextafter(v, np.float32(np.inf if d > 0 else 0), dtype=np.float32)
            vals.append(np.float32(v))
    return vals


def test_e5m2_scale_matches_the_reference_at_powers_of_two():
    jq = jax.jit(jcoll._quantize_e5m2)
    for v in _edge_values():
        x = np.array([v, -v / 3, 0.5], np.float32)
        q, s = jcoll._quantize_e5m2(jnp.asarray(x))
        qj, sj = jq(jnp.asarray(x))
        tq, ts = coll.quantize_e5m2(torch.from_numpy(x))
        assert float(s) == float(sj) == float(ts), v
        np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), np.asarray(q).view(np.uint8))
    _, s = coll.quantize_e5m2(torch.zeros(4))
    assert float(s) == 1.0


def _inputs(n: int, rounds: int) -> np.ndarray:
    """(rounds, n, 64) fp32: normal draws whose absmax sits at 57344/2^k or
    an ulp beside it in half the rounds."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((rounds, n, 64)).astype(np.float32)
    edges = _edge_values()
    for t in range(0, rounds, 2):
        for r in range(n):
            x[t, r, 0] = edges[rng.integers(len(edges))] / np.float32(2.0 ** 16)
            x[t, r, 1:] *= abs(x[t, r, 0]) / (4 * np.abs(x[t, r, 1:]).max())
    return x


def _reference(x: np.ndarray, err0: np.ndarray):
    """Each round's (mean per shard, residual per shard) of the vmapped
    reference, residuals fed back."""
    f = jax.vmap(lambda xs, e: jcoll.compressed_psum(xs, "data", e), axis_name="data")
    err = jnp.asarray(err0)
    out = []
    for t in range(x.shape[0]):
        mean, err = f(jnp.asarray(x[t]), err)
        out.append((np.asarray(mean), np.asarray(err.astype(jnp.float32))))
    return out


def _ulp(a: np.ndarray) -> float:
    return float(np.spacing(np.float32(np.abs(a).max())))


def test_compressed_psum_two_ranks_bit_for_bit(tmp_path):
    x = _inputs(2, 4)
    want = _reference(x, np.zeros((2, 64), jnp.bfloat16))
    got = run_ranks(rank_psum, 2, tmp_path, x)
    first = _reference(x[-1:], np.zeros((2, 64), jnp.bfloat16))[0]
    for r, (rounds, tree_mean, tree_err) in enumerate(got):
        for (wm, we), (gm, ge) in zip(want, rounds):
            np.testing.assert_array_equal(gm, wm[r])
            np.testing.assert_array_equal(ge, we[r])
        np.testing.assert_array_equal(tree_mean, first[0][r])
        np.testing.assert_array_equal(tree_err, first[1][r])


def test_compressed_psum_eight_ranks_and_error_feedback(tmp_path):
    n, rounds = 8, 8
    x = np.random.default_rng(0).standard_normal((n, 1024)).astype(np.float32)
    got = run_ranks(rank_feedback, n, tmp_path, x, rounds, _inputs(n, 2), timeout=180)
    xs = _inputs(n, 2)
    want = _reference(xs, np.zeros((n, 64), jnp.bfloat16))
    for r, ((rounds_r, _, _), _) in enumerate(got):
        for (wm, we), (gm, ge) in zip(want, rounds_r):
            np.testing.assert_array_equal(ge, we[r])
            assert np.abs(gm - wm[r]).max() <= 4 * _ulp(wm[r])
    true_mean = x.mean(0)
    means = np.stack(got[0][1])
    for _, m in got[1:]:
        np.testing.assert_array_equal(np.stack(m), means)  # every rank the same bits
    single = float(np.abs(means[0] - true_mean).max())
    cum_bias = float(np.abs(means.sum(0) - rounds * true_mean).max())
    assert single < 0.3, single
    assert cum_bias < 2.5 * single, (cum_bias, single)
    assert cum_bias < 0.25 * rounds * single, (cum_bias, rounds * single)


def test_one_rank_axis_needs_no_group():
    """A mesh of one: the mean of one term, no process group."""
    mesh = make_mesh((1, 1), ("data", "model"))
    x = torch.randn(32, generator=torch.Generator().manual_seed(0))
    mean, err = coll.compressed_psum(x, mesh, "data", torch.zeros(32, dtype=torch.bfloat16))
    f = jax.vmap(lambda xs, e: jcoll.compressed_psum(xs, "data", e), axis_name="data")
    want, werr = f(jnp.asarray(x.numpy())[None], jnp.zeros((1, 32), jnp.bfloat16))
    np.testing.assert_array_equal(mean.numpy(), np.asarray(want)[0])
    np.testing.assert_array_equal(err.float().numpy(), np.asarray(werr.astype(jnp.float32))[0])
    assert coll.all_reduce(x, mesh, ("data", "model")) is not x
    assert coll.sum_over(x, mesh, "model") is x and coll.mean_over(x, None, "model") is x
