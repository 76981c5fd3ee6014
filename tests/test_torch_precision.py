"""The port's cast unit against the JAX package's casts, bit for bit.

Every non-NaN value must come out with the same bits. NaN must come out
where the reference gives NaN; the NaN payload bits themselves differ
between ml_dtypes and torch for some format pairs and carry no value, so
they are not compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprec  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402

FORMATS = {
    "fp32": jnp.float32, "fp16": jnp.float16, "bf16": jnp.bfloat16,
    "e4m3": jnp.float8_e4m3fn, "e5m2": jnp.float8_e5m2,
}
SPECIALS = [
    0.0, -0.0, 448.0, -448.0, 449.0, 463.9, 464.0, -464.0, 464.1, -464.1,
    480.0, -480.0, 1e4, -1e4, np.inf, -np.inf, np.nan, 57344.0, 61440.0,
    65504.0, 65520.0, 70000.0, -70000.0, 3e38,
    2.0 ** -6, 2.0 ** -7, 2.0 ** -9, -2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10,
    2.0 ** -14, 2.0 ** -16, 2.0 ** -17, 2.0 ** -24, 2.0 ** -25, 1e-7, 1e-40,
]


def _values():
    rng = np.random.default_rng(0)
    parts = [np.asarray(SPECIALS, np.float32)]
    for scale in (1e-3, 1.0, 30.0, 300.0, 3e4):
        parts.append((rng.standard_normal(500) * scale).astype(np.float32))
    return np.concatenate(parts)


def _assert_same(want: np.ndarray, got: torch.Tensor):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    bits = {1: np.uint8, 2: np.uint16, 4: np.uint32}[want.dtype.itemsize]
    gb = got.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[want.dtype.itemsize])
    gb = gb.numpy().view(bits)
    np.testing.assert_array_equal(gb[ok], np.asarray(want).view(bits)[ok])


@pytest.mark.parametrize("dst", list(FORMATS))
@pytest.mark.parametrize("src", list(FORMATS))
def test_cast_matches_reference_bitwise(src, dst):
    x = np.asarray(jnp.asarray(_values()).astype(FORMATS[src]))
    want = np.asarray(jnp.asarray(x).astype(FORMATS[dst]))
    got = tprec.cast(tensor_from_numpy(x), tprec.as_dtype(dst))
    assert got.dtype == tprec.as_dtype(dst)
    _assert_same(want, got)


@pytest.mark.parametrize("name", sorted(jprec.POLICIES))
def test_policy_casts_match_reference(name):
    jp, tp = jprec.get_policy(name), tprec.get_policy(name)
    assert tp.name == jp.name
    x = _values()
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _assert_same(np.asarray(jp.cast_in_fwd(xj)), tp.cast_in_fwd(xt))
    _assert_same(np.asarray(jp.cast_out(xj)), tp.cast_out(xt))
    for role in ("storage_fwd", "storage_bwd", "compute", "acc", "out", "param"):
        want = jnp.dtype(getattr(jp, role)).name
        assert str(getattr(tp, role)).removeprefix("torch.") == want


def test_e4m3_overflow_is_nan_not_saturation():
    """torch's own E4M3 cast saturates; the port's cast unit must not."""
    x = torch.tensor([464.0, 464.1, -480.0, float("inf"), -1e4, 448.0])
    bits = tprec.cast(x, tprec.E4M3).view(torch.uint8).tolist()
    assert bits == [0x7E, 0x7F, 0xFF, 0x7F, 0xFF, 0x7E]
    assert x.to(tprec.E4M3).view(torch.uint8).tolist()[1] == 0x7E  # torch saturates


def test_fp8_rows_round_trip_through_uint8_views():
    table = tprec.cast(torch.randn(8, 3), tprec.E4M3)
    rows = tprec.take_rows(table, torch.tensor([[5, 0]]))
    assert rows.dtype == tprec.E4M3 and rows.shape == (1, 2, 3)
    assert torch.equal(rows[0, 0].view(torch.uint8), table[5].view(torch.uint8))
    fresh = tprec.cast(torch.randn(2, 3), tprec.E4M3)
    tprec.put_rows_(table, torch.tensor([1, 6]), fresh)
    assert torch.equal(table[[1, 6]].view(torch.uint8), fresh.view(torch.uint8))


def test_every_fp16_casts_to_e5m2_like_the_reference():
    """The cotangent cast of the backward GEMMs (fp16 -> E5M2, the
    ``storage_bwd`` of the hybrid-FP8 policies) over all 65,536 fp16 bit
    patterns, against ml_dtypes: the same bits for every non-NaN value, NaN
    wherever the reference gives NaN (payloads are not compared)."""
    ml_dtypes = pytest.importorskip("ml_dtypes")
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    with np.errstate(invalid="ignore"):  # the NaN patterns
        want = bits.view(np.float16).astype(ml_dtypes.float8_e5m2)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.float16)
    got = tprec.cast(x, tprec.E5M2)
    assert got.dtype == tprec.E5M2
    _assert_same(want, got)
