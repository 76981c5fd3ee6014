"""Names of the reference that this slice's layers lacked, held against the
reference on the CPU: ``kernels/ops.matmul``, ``semiring.pad_value_for`` and
``GemmOp.uses_mxu`` (on the card: "takes a tensor-core schedule", held
against ``plan_gemm``'s choice for each op).

``ops.matmul`` is ``gemm_op`` with the (mul, add) pair, so it keeps
``tests/test_torch_gemm.py``'s bound: 1 ulp of a 16-bit output, 2 ulp of an
fp32 one at the output's largest magnitude (the fp32 sums' order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprec  # noqa: E402
from repro.core import semiring as jsemi  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.core import semiring as tsemi  # noqa: E402
from repro_torch.core.precision import E4M3, FP16  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import redmule_gemm as rg  # noqa: E402


@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8", "tpu_bf16"])
@pytest.mark.parametrize("with_y", [False, True])
def test_matmul_matches_the_reference(policy, with_y):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 13, 70)).astype(np.float32)
    w = rng.standard_normal((70, 29)).astype(np.float32)
    y = rng.standard_normal((13, 29)).astype(np.float32) if with_y else None
    want = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w),
                                  None if y is None else jnp.asarray(y),
                                  policy=jprec.get_policy(policy), backend="xla"))
    got = tops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                      None if y is None else torch.from_numpy(y),
                      policy=tprec.get_policy(policy))
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    w32, g32 = want.astype(np.float32), got.float().numpy()
    scale = np.abs(w32).max()
    if want.dtype.name == "bfloat16":
        ulp = float(2.0 ** (np.floor(np.log2(scale)) - 7))
    else:
        ulp = float(np.spacing(want.dtype.type(scale)))
    limit = (2.0 if want.dtype == np.float32 else 1.0) * ulp
    assert np.abs(g32 - w32).max() <= limit
    # The same function as gemm_op with the (mul, add) pair, bit for bit.
    same = tops.gemm_op(torch.from_numpy(x), torch.from_numpy(w),
                        None if y is None else torch.from_numpy(y), gop=tsemi.MATMUL,
                        policy=tprec.get_policy(policy))
    assert torch.equal(got, same)


@pytest.mark.parametrize("op", [g.name for g in jsemi.TABLE1])
def test_pad_value_for_matches_the_reference(op):
    want = jsemi.pad_value_for(jsemi.get(op))
    got = tsemi.pad_value_for(tsemi.get(op))
    assert got == tuple(float(v) for v in want)


@pytest.mark.parametrize("op", [g.name for g in jsemi.TABLE1])
def test_uses_mxu_matches_the_reference_and_the_plan(op):
    gop = tsemi.get(op)
    assert gop.uses_mxu == jsemi.get(op).uses_mxu
    # An op uses the tensor cores on the card iff plan_gemm puts it there, at
    # every shape band, for fp8 and compute-format operands.
    for dtype, policy in ((E4M3, "redmule_hfp8"), (FP16, "redmule_fp16")):
        for m in (4, 64, 2048):
            x, w = rg.Operand(dtype, m, 512, 512, 1), rg.Operand(dtype, 256, 512, 512, 1)
            plan = rg.plan_gemm(m, 256, 512, 1, x, w, gop, tprec.get_policy(policy))
            assert (plan.schedule in ("tc", "small_row")) == gop.uses_mxu, (dtype, m)
