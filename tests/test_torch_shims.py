"""The port's deprecated ``core/redmule`` shims and the last names of the
reference's surface (``engine`` names, ``PrecisionPolicy.fp8_storage``,
``AdamW.global_norm``, ``models/common.ACTIVATIONS``,
``serving.PagedKVCache``), held against the reference on the CPU. They
mirror ``tests/test_engine.py``'s shim tests: each shim warns with
``DeprecationWarning`` and gives the engine's bits; the deprecated
``set_default_backend`` is process-wide (seen from a thread spawned
after it), where ``engine_scope`` stays per-context.
"""
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import precision as jprec  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro_torch.core import precision as tprec  # noqa: E402
from repro_torch.engine import (  # noqa: E402
    BACKENDS,
    Engine,
    ambient_engine,
    closure,
    engine_scope,
    set_ambient_engine,
)


def _redmule():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.core import redmule
    return redmule


def test_shims_warn_and_give_the_engines_bits(rng):
    redmule = _redmule()
    x = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 3)).astype(np.float32))
    eng = Engine(policy="fp32", backend="torch")
    with pytest.warns(DeprecationWarning, match="mp_matmul"):
        z = redmule.mp_matmul(x, w, tprec.FP32_REF)
    assert torch.equal(z, eng.matmul(x, w))
    with pytest.warns(DeprecationWarning, match="gemm_op"):
        z = redmule.gemm_op(x, w, op="apsp", policy=tprec.FP32_REF)
    assert torch.equal(z, eng.gemm_op(x, w, op="apsp"))
    with pytest.warns(DeprecationWarning, match="linear"):
        z = redmule.linear(x, w, None, tprec.FP32_REF)
    assert torch.equal(z, eng.linear(x, w))
    hfp8 = Engine(policy="redmule_hfp8", backend="torch")
    with pytest.warns(DeprecationWarning):
        z = redmule.mp_matmul(x, w, tprec.REDMULE_HFP8)
    assert torch.equal(z, hfp8.matmul(x, w))
    cfg = redmule.RedMulEConfig(policy=tprec.REDMULE_HFP8)
    assert cfg.tile_cols == 16 and cfg.to_engine().policy is tprec.REDMULE_HFP8
    with pytest.warns(DeprecationWarning):
        z = redmule.gemm_op(x, w, op="max_capacity_path", config=cfg, policy="fp32")
    assert torch.equal(z, eng.gemm_op(x, w, op="max_capacity_path"))
    # The storage helpers, against the reference's.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.core import redmule as jredmule
    for name in ("redmule_hfp8", "redmule_fp16", "fp32"):
        pol, jpol = tprec.get_policy(name), jprec.get_policy(name)
        got = redmule.from_storage(redmule.to_fp8_storage(x, pol), pol)
        want = jredmule.from_storage(jredmule.to_fp8_storage(jnp.asarray(x.numpy()), jpol), jpol)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_shim_gemm_op_is_differentiable(rng):
    redmule = _redmule()
    x = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).requires_grad_()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        z = redmule.gemm_op(x, x.detach().T, op="apsp", policy=tprec.FP32_REF)
    (dx,) = torch.autograd.grad(z.sum(), [x])
    assert float(dx.abs().sum()) > 0


def test_set_default_backend_is_process_wide():
    redmule = _redmule()
    from repro_torch.kernels import ops as kernel_ops

    prev_engine, prev_default = ambient_engine(), redmule._process_default_backend
    try:
        assert redmule.default_backend() == "torch"
        assert redmule.set_default_backend("torch") is None
        seen = {}
        t = threading.Thread(target=lambda: seen.setdefault("b", redmule.default_backend()))
        t.start()
        t.join()
        assert seen["b"] == "torch" and redmule.default_backend() == "torch"

        def shim_call():
            real = kernel_ops.gemm_op

            def spy(*a, **k):
                seen["dispatched"] = k.get("backend")
                return real(*a, **k)

            kernel_ops.gemm_op = spy
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", DeprecationWarning)
                    redmule.gemm_op(torch.ones((2, 3)), torch.ones((3, 2)), op="apsp",
                                    policy="fp32")
            finally:
                kernel_ops.gemm_op = real

        t2 = threading.Thread(target=shim_call)
        t2.start()
        t2.join()
        assert seen["dispatched"] == "torch"
        with redmule.use_backend("cuda"):
            assert redmule.default_backend() == "cuda"
        with pytest.raises(ValueError):
            redmule.set_default_backend("xla")  # the reference's name: not a port backend
    finally:
        set_ambient_engine(prev_engine)
        redmule._process_default_backend = prev_default


def test_lazy_core_reexports_and_engine_names():
    import repro_torch.core as core

    assert core.get_policy("fp32").name == "fp32"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert callable(core.mp_matmul) and core.BACKENDS == BACKENDS == ("cuda", "torch")
    with pytest.raises(AttributeError):
        core.not_a_name
    assert ambient_engine() is None
    eng = Engine(policy="fp32", backend="torch")
    with engine_scope(eng):
        assert ambient_engine() is eng
    prev = set_ambient_engine(eng)
    assert prev is None and ambient_engine() is eng
    assert set_ambient_engine(None) is eng and ambient_engine() is None
    d = torch.tensor([[0.0, 1.0, 9.0], [9.0, 0.0, 1.0], [9.0, 9.0, 0.0]])
    assert torch.equal(closure(eng, d, "apsp"), eng.closure(d, "apsp"))


def test_the_last_names_match_the_reference():
    for name in tprec.POLICIES:
        assert tprec.get_policy(name).fp8_storage == jprec.get_policy(name).fp8_storage
    from repro_torch.models import common
    from repro_torch.optim import AdamW, global_norm
    from repro_torch.serving import PagedKVCache, StateStore

    assert PagedKVCache is StateStore
    grads = {"a": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(4) * -2]}
    want = JAdamW().global_norm(jax.tree.map(lambda t: jnp.asarray(t.numpy()), grads))
    assert float(AdamW().global_norm(grads)) == float(global_norm(grads)) == float(want)
    assert set(common.ACTIVATIONS) == set(jcommon.ACTIVATIONS)
    x = np.linspace(-4, 4, 101).astype(np.float32)
    for name, fn in common.ACTIVATIONS.items():
        got = fn(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.jit(jcommon.ACTIVATIONS[name])(jnp.asarray(x)))
        # fp32: XLA's compiled logistic and tanh on CPU tensors, bit for bit.
        np.testing.assert_array_equal(got, want)
