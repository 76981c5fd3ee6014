"""The port's dense flash attention against the JAX package's, on the CPU.

The port's entry point ``ops.flash_attention`` runs its plain version here
(``backend="torch"``: the online softmax over ``block_k`` key chunks in
fp32, p rounded to v's format before the PV product); the reference runs
its Pallas kernel in interpret mode, which does the same arithmetic in its
(block_q, block_k) tiles. Both get the same numpy inputs.

Tolerances: fp32 1e-5 (atol and rtol; the two differ in the order of
fp32 sums, observed below 1e-6), bf16 3e-2 (the reference's own bf16
bound against its oracle: a p that lands on the other side of a bf16
rounding boundary moves an output by up to a bf16 ulp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.precision import BF16  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# (b, sq, sk, hq, hkv, hd, causal, softcap): the non-slow cases of
# tests/test_flash_attention.py, one ragged rectangular case (Sq and Sk
# not multiples of the blocks, Sq < Sk), and one with softcap.
CASES = [
    (2, 32, 32, 4, 2, 16, True, None),
    (2, 16, 64, 8, 2, 32, False, None),
    (1, 40, 72, 4, 4, 8, True, None),
    (1, 21, 45, 4, 1, 16, False, 30.0),
]


def _inputs(rng, b, sq, sk, hq, hkv, hd):
    return (rng.standard_normal((b, sq, hq, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_matches_reference_kernel(case, rng):
    b, sq, sk, hq, hkv, hd, causal, cap = case
    q, k, v = _inputs(rng, b, sq, sk, hq, hkv, hd)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                softcap=cap, block_q=16, block_k=16, backend="pallas_interpret")
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=causal, softcap=cap, block_q=16, block_k=16,
                               backend="torch")
    assert got.shape == (b, sq, hq, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_bf16_matches_reference_kernel(rng):
    q, k, v = _inputs(rng, 1, 32, 32, 4, 4, 16)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, block_q=16, block_k=16, backend="pallas_interpret")
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, block_q=16, block_k=16, backend="torch")
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


def test_block_shape_invariance(rng):
    """Key chunks of 8 and of 64 agree up to the order of fp32 sums (1e-5):
    the online softmax is associative."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, 1, 64, 64, 2, 2, 16))
    a = tops.flash_attention(q, k, v, block_q=8, block_k=8, backend="torch")
    b = tops.flash_attention(q, k, v, block_q=32, block_k=64, backend="torch")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_the_oracle(causal, rng):
    """The plain version against the port's dense-softmax oracle
    (``kernels/ref.py``), GQA expanded there by repeating KV heads (1e-5)."""
    b, sq, sk, hq, hkv, hd = 2, 24, 40, 6, 2, 8
    q, k, v = (torch.from_numpy(a) for a in _inputs(rng, b, sq, sk, hq, hkv, hd))
    got = tops.flash_attention(q, k, v, causal=causal, block_k=16, backend="torch")

    def heads(t):
        t = t.repeat_interleave(hq // t.shape[2], dim=2)
        return t.permute(0, 2, 1, 3).reshape(b * hq, t.shape[1], hd)

    want = tref.flash_attention_ref(heads(q), heads(k), heads(v), causal=causal)
    want = want.reshape(b, hq, sq, hd).permute(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_oracle_matches_the_reference_oracle(rng):
    """The port's oracle equals ``repro.kernels.ref.flash_attention_ref``
    (fp32, 1e-6: the same dense softmax)."""
    from repro.kernels import ref as jref

    q, k, v = (rng.standard_normal((3, 17, 8)).astype(np.float32) for _ in range(3))
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), softcap=20.0)
    got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                   softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError, match="on one card"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.flash_attention(q, k, k, backend="cuda")
    before = tfa.dense_launches.n
    tops.flash_attention(q, k, k)  # CPU tensors: the plain version, no launch
    assert tfa.dense_launches.n == before


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_plan_flash_routes(dtype, hd):
    """fp16 and bf16 at hd 64, 128 and 256 (gemma2, recurrentgemma) take the
    tensor-core kernel; fp32 takes the register-tiled CUDA-core kernel."""
    q = torch.zeros(1, 8, 4, hd, dtype=dtype)
    k = torch.zeros(1, 8, 2, hd, dtype=dtype)
    want = "tc" if dtype != torch.float32 else "simt"
    assert tfa.plan_flash(q, k, k) == want


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_tensor_core_instances_fit_a_block(hd):
    """Each tensor-core instance's Q tile and K/V stages within the 227 KB
    of shared memory a block may have: 128-key tiles at hd 64 (4 stages)
    and 128 (2), 64-key tiles at hd 256 (2 stages, 193 KB)."""
    t = tfa.tc_tile(hd)
    keys, stages = {64: (128, 4), 128: (128, 2), 256: (64, 2)}[hd]
    assert (t["rows"], t["keys"], t["stages"]) == (128, keys, stages)
    tiles = (hd // 64) * 128 * (128 + 2 * stages * keys)
    assert t["smem_bytes"] == 1024 + tiles + (1 + 4 * stages) * 8
    assert t["smem_bytes"] <= 227 * 1024
    if hd == 256:
        assert t["smem_bytes"] > 192 * 1024  # a 64 KB Q tile and two 64 KB stages
    with pytest.raises(ValueError):
        tfa.tc_tile(96)


@pytest.mark.parametrize("dtype, hd, width, loads", [
    (torch.float32, 32, 32, "cp.async"),
    (torch.float32, 64, 64, "cp.async"),
    (torch.float32, 128, 128, "cp.async"),
    (torch.float32, 256, 256, "cp.async"),
    (torch.float32, 80, 128, "widening"),
    (torch.float32, 8, 32, "widening"),
    (torch.float16, 96, 128, "widening"),
    (torch.bfloat16, 200, 256, "widening"),
])
def test_simt_instance_by_width(dtype, hd, width, loads):
    """The register-tiled kernel's instance: the smallest width that holds
    hd, 128 query rows a block (64 at width 256, so O stays in registers),
    64 keys a tile; fp32 at exactly its width loads by cp.async, every
    other case widens each element. Every instance fits a block."""
    t = tfa.simt_tile(dtype, hd)
    assert (t["width"], t["loads"], t["keys"]) == (width, loads, 64)
    assert t["rows"] == (64 if width == 256 else 128)
    assert t["smem_bytes"] <= 227 * 1024
    if dtype != torch.float32:
        q = torch.zeros(1, 4, 2, hd, dtype=dtype)
        assert tfa.plan_flash(q, q, q) == "simt"


def test_tensor_core_route_refuses_cpu_tensors():
    """Inputs the planner sends to the tensor cores, on the CPU: the CUDA
    wrapper raises, and the entry point takes the plain version without a
    launch on either route."""
    q = torch.zeros(1, 8, 2, 128, dtype=torch.float16)
    k = torch.zeros(1, 8, 1, 128, dtype=torch.float16)
    assert tfa.plan_flash(q, k, k) == "tc"
    with pytest.raises(ValueError, match="on one card"):
        tfa.flash_attention(q, k, k)
    before = (tfa.dense_tc_launches.n, tfa.dense_launches.n)
    out = tops.flash_attention(q, k, k)
    assert out.shape == q.shape and out.dtype == torch.float16
    assert (tfa.dense_tc_launches.n, tfa.dense_launches.n) == before


@pytest.mark.parametrize("dtype, hd, route", [(torch.float16, 256, "tc"), (torch.bfloat16, 256, "tc"),
                                              (torch.float32, 128, "simt"),
                                              (torch.float16, 80, "simt")])
def test_each_route_refuses_cpu_tensors(dtype, hd, route):
    """The new routes' inputs on the CPU (hd 256 on the tensor cores, fp32
    on the register-tiled kernel's cp.async instance, fp16 on its widening
    one): the CUDA wrapper raises before any launch; the entry point takes
    the plain version, which matches the oracle."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 24, 4, hd)).astype(np.float32)).to(dtype)
    k = torch.from_numpy(rng.standard_normal((1, 24, 2, hd)).astype(np.float32)).to(dtype)
    assert tfa.plan_flash(q, k, k) == route
    before = (tfa.dense_tc_launches.n, tfa.dense_launches.n)
    with pytest.raises(ValueError, match="on one card"):
        tfa.flash_attention(q, k, k)
    out = tops.flash_attention(q, k, k)
    assert (tfa.dense_tc_launches.n, tfa.dense_launches.n) == before
    def heads(t):  # (1, S, H, hd) -> (H, S, hd), the KV heads repeated for their groups
        t = t.float().repeat_interleave(4 // t.shape[2], dim=2)
        return t[0].transpose(0, 1)
    want = tref.flash_attention_ref(heads(q), heads(k), heads(k), causal=True)
    want = want.transpose(0, 1)[None]
    tol = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 2e-2}[dtype]
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), rtol=tol, atol=tol)
