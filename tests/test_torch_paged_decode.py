"""The port's paged flash-decode (plain version, CPU) against the JAX
package's Pallas kernel in interpret mode.

The cases are the non-slow cases of ``tests/test_paged_decode.py``'s grid,
with its tolerances (2e-4 fp32, 2e-2 bf16, 8e-2 E4M3 pools), plus a
softcap case. Inactive slots must come back as exact zeros.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# (s, hq, hkv, hd, page_size, pages_per_slot, n_pages, dtype, window, inactive, tol)
GRID = [
    (4, 4, 2, 16, 8, 6, 16, "float32", None, (), 2e-4),
    (4, 4, 2, 16, 8, 6, 16, "bfloat16", None, (), 2e-2),
    (4, 4, 2, 16, 8, 6, 16, "float8_e4m3fn", None, (), 8e-2),
    (4, 4, 2, 16, 8, 6, 16, "float32", 20, (), 2e-4),
    (4, 4, 2, 16, 8, 6, 16, "bfloat16", 12, (), 2e-2),
    (3, 8, 1, 32, 4, 8, 12, "float8_e4m3fn", 9, (), 8e-2),
    (4, 4, 2, 16, 8, 6, 16, "float32", None, (1, 3), 2e-4),
    (6, 6, 3, 8, 4, 5, 24, "bfloat16", 10, (0, 4), 2e-2),
    (1, 8, 8, 32, 16, 4, 8, "bfloat16", None, (), 2e-2),
    (16, 4, 2, 16, 4, 4, 48, "float32", None, (5, 11), 2e-4),
]


def _ids(c):
    s, hq, hkv, hd, ps, p, n, dt, w, inact, _ = c
    return f"s{s}-h{hq}.{hkv}x{hd}-ps{ps}xP{p}-{dt}-w{w}-inact{len(inact)}"


def _make_case(rng, *, s, hq, hkv, hd, page_size, pages_per_slot, n_pages, dtype,
               window=None, inactive=()):
    """Random decode step as numpy arrays: shuffled physical pages, ragged
    lengths, out-of-window pages recycled to NULL."""
    q = rng.standard_normal((s, hq, hd)).astype(np.float32)
    k_pool = np.asarray(jnp.asarray(
        rng.standard_normal((n_pages * page_size, hkv, hd)), jnp.dtype(dtype)))
    v_pool = np.asarray(jnp.asarray(
        rng.standard_normal((n_pages * page_size, hkv, hd)), jnp.dtype(dtype)))
    avail = list(range(1, n_pages))
    rng.shuffle(avail)
    pt = np.zeros((s, pages_per_slot), np.int32)
    seq_lens = np.zeros(s, np.int32)
    active = np.ones(s, np.int32)
    idx = 0
    for si in range(s):
        n_pg = int(rng.integers(1, pages_per_slot + 1))
        for p in range(n_pg):
            pt[si, p] = avail[idx % len(avail)]
            idx += 1
        seq_lens[si] = int(rng.integers(0, n_pg * page_size))
        if window is not None:
            for p in range(n_pg):
                if (p + 1) * page_size - 1 <= seq_lens[si] - window:
                    pt[si, p] = 0
    active[list(inactive)] = 0
    return q, k_pool, v_pool, pt, seq_lens, active


def _both(case, *, page_size, window, softcap=None):
    want = jops.paged_decode_attention(
        *(jnp.asarray(a) for a in case), page_size=page_size, window=window,
        softcap=softcap, backend="pallas_interpret",
    )
    got = tops.paged_decode_attention(
        *(tensor_from_numpy(a) for a in case), page_size=page_size, window=window,
        softcap=softcap,
    )
    return np.asarray(want, np.float32), got.float().numpy()


def _assert_parity(want, got, active, tol):
    live = np.asarray(active, bool)
    np.testing.assert_allclose(got[live], want[live], rtol=tol, atol=tol)
    if (~live).any():
        assert float(np.abs(got[~live]).max()) == 0.0


@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_plain_matches_pallas_interpret(case):
    s, hq, hkv, hd, ps, p, n, dt, w, inact, tol = case
    arrs = _make_case(np.random.default_rng(0), s=s, hq=hq, hkv=hkv, hd=hd,
                      page_size=ps, pages_per_slot=p, n_pages=n, dtype=dt,
                      window=w, inactive=inact)
    want, got = _both(arrs, page_size=ps, window=w)
    _assert_parity(want, got, arrs[-1], tol)


def test_plain_softcap_matches_pallas_interpret():
    arrs = _make_case(np.random.default_rng(1), s=3, hq=4, hkv=2, hd=16, page_size=8,
                      pages_per_slot=4, n_pages=12, dtype="float32")
    want, got = _both(arrs, page_size=8, window=None, softcap=30.0)
    _assert_parity(want, got, arrs[-1], 2e-4)


def test_null_page_contents_never_matter():
    """Page 0 absorbs pad and inactive writes: poisoning it moves no bit."""
    q, kp, vp, pt, lens, act = _make_case(
        np.random.default_rng(2), s=4, hq=4, hkv=2, hd=16, page_size=8,
        pages_per_slot=5, n_pages=12, dtype="float32", window=16)
    assert (pt == 0).any()
    args = dict(page_size=8, window=16)
    base = tops.paged_decode_attention(*map(tensor_from_numpy, (q, kp, vp, pt, lens, act)), **args)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[:8], vp2[:8] = 1e4, -1e4
    got = tops.paged_decode_attention(*map(tensor_from_numpy, (q, kp2, vp2, pt, lens, act)), **args)
    assert torch.equal(base, got)
