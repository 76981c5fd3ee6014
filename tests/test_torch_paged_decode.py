"""The port's paged flash-decode (plain version, CPU) against the JAX
package's Pallas kernel in interpret mode.

The cases are the non-slow cases of ``tests/test_paged_decode.py``'s grid,
with its tolerances (2e-4 fp32, 2e-2 bf16, 8e-2 E4M3 pools), plus a
softcap case. Inactive slots must come back as exact zeros. The CUDA
kernel's split page walk (per-split partials, combined in split order) is
held against the same grid through its plain version, and the split
planner at the serving and long-context shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
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


# -- the CUDA kernel's split page walk, in plain PyTorch ------------------------

_WANT = {}  # the reference's output per grid case, computed once


def _grid_case(case):
    s, hq, hkv, hd, ps, p, n, dt, w, inact, tol = case
    arrs = _make_case(np.random.default_rng(0), s=s, hq=hq, hkv=hkv, hd=hd,
                      page_size=ps, pages_per_slot=p, n_pages=n, dtype=dt,
                      window=w, inactive=inact)
    key = GRID.index(case)
    if key not in _WANT:
        _WANT[key] = np.asarray(jops.paged_decode_attention(
            *(jnp.asarray(a) for a in arrs), page_size=ps, window=w,
            backend="pallas_interpret"), np.float32)
    return arrs, _WANT[key]


@pytest.mark.parametrize("splits", [1, 2, 3, "page"])
@pytest.mark.parametrize("case", GRID, ids=_ids)
def test_split_walk_matches_pallas_interpret(case, splits):
    """Per-split partials and the fixed-order combine (the kernel's
    algorithm) against the Pallas kernel: splits of 1, 2 and 3 and of one
    page each, the last leaving whole splits dead by length, by NULL pages
    and by the window in the grid's ragged and windowed cases."""
    s, hq, hkv, hd, ps, p, n, dt, w, inact, tol = case
    (q, kp, vp, pt, lens, act), want = _grid_case(case)
    t = [tensor_from_numpy(a) for a in (q, kp, vp, pt, lens, act)]
    qg = t[0].reshape(s, hkv, hq // hkv, hd)
    got = tfa.paged_flash_decode_split_plain(
        qg, *t[1:], page_size=ps, window=w, splits=p if splits == "page" else splits)
    _assert_parity(want, got.reshape(s, hq, hd).float().numpy(), act, tol)


def test_split_walk_all_dead_splits():
    """Splits with no live page (NULL entries, past the decode position,
    outside the window) contribute nothing: one page a split over a table
    where most splits are dead, against the Pallas kernel (fp32, 2e-4)."""
    rng = np.random.default_rng(4)
    s, hq, hkv, hd, ps, p = 3, 4, 2, 16, 4, 8
    q = rng.standard_normal((s, hq, hd)).astype(np.float32)
    kp, vp = (rng.standard_normal((25 * ps, hkv, hd)).astype(np.float32) for _ in range(2))
    pt = np.zeros((s, p), np.int32)
    pt[0, :2] = [3, 7]           # length 5: splits 2-7 dead by length (NULL and past it)
    pt[1, :] = np.arange(8, 16)  # length 31, window 6: splits 0-5 dead by the window
    pt[2, 4:6] = [20, 21]        # length 23: splits 0-3 NULL (recycled), 6-7 past it
    lens = np.array([5, 31, 23], np.int32)
    act = np.ones(s, np.int32)
    arrs = (q, kp, vp, pt, lens, act)
    for window in (None, 6):
        want = np.asarray(jops.paged_decode_attention(
            *(jnp.asarray(a) for a in arrs), page_size=ps, window=window,
            backend="pallas_interpret"), np.float32)
        t = [tensor_from_numpy(a) for a in arrs]
        got = tfa.paged_flash_decode_split_plain(
            t[0].reshape(s, hkv, hq // hkv, hd), *t[1:], page_size=ps, window=window, splits=p)
        _assert_parity(want, got.reshape(s, hq, hd).numpy(), act, 2e-4)


@pytest.mark.parametrize("s, hkv, pages, want", [
    (4, 8, 7, 1),      # the serve run: 7-page tables, too short to split
    (16, 8, 256, 4),   # long context: 128 units, four blocks an SM
    (4, 8, 64, 4),     # 64-page tables of 1024 tokens
    (1, 1, 4096, 256), # one long walk: 16 pages a split
    (32, 8, 512, 1),   # the units alone fill the 132 SMs
])
def test_decode_splits(s, hkv, pages, want):
    assert tfa.decode_splits(s, hkv, pages) == want


def test_decode_splits_never_leave_a_split_empty():
    for s in (1, 2, 4, 16, 64):
        for pages in (1, 2, 7, 16, 33, 64, 256, 1000):
            splits = tfa.decode_splits(s, 8, pages)
            per = -(-pages // splits)
            assert 1 <= splits <= pages and (splits - 1) * per < pages
            assert s * 8 * splits <= max(s * 8, 132 * 4)
