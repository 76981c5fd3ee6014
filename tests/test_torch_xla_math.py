"""The port's XLA-rounded fp32 transcendentals (``repro_torch.models.common``)
against ``jax.jit`` of the reference's functions on the CPU, bit for bit.

The inputs are 2^20 fp32 draws of N(0, 64) (|x| for log1p), a wide draw of
N(0, 1600) that reaches the clamps, overflow and the flushed denormals, and
the special values. torch's own functions differ from XLA's compiled ones
on 0.4-47% of the same draws (the counts are read below, so a torch that
came to round as XLA does would show). The gradients are torch's formulas
on these values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.models import common  # noqa: E402

SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-30, -1e-30, 1e-8, 4e-4, -4e-4, 7.99,
                    20.0, -20.0, 88.8, -87.8, 100.0, -100.0, 0.4142135, -0.4142135, -0.999999,
                    -1.0, -2.0], np.float32)
FUNCS = {
    "exp": (jnp.exp, common.xla_exp, torch.exp),
    "log1p": (jnp.log1p, common.xla_log1p, torch.log1p),
    "tanh": (jnp.tanh, common.xla_tanh, torch.tanh),
    "sigmoid": (jax.nn.sigmoid, common.xla_sigmoid, torch.sigmoid),
    "softplus": (jax.nn.softplus, common.xla_softplus, None),
}


def _differ(want, got) -> np.ndarray:
    want, got = np.asarray(want), got.numpy()
    return (want.view(np.int32) != got.view(np.int32)) & ~(np.isnan(want) & np.isnan(got))


def _draws(name: str, scale: float) -> np.ndarray:
    x = (np.random.default_rng(0).standard_normal(1 << 20) * scale).astype(np.float32)
    return np.abs(x) if name == "log1p" else x


@pytest.mark.parametrize("scale", [8.0, 40.0])
@pytest.mark.parametrize("name", list(FUNCS))
def test_matches_xla_compiled_cpu_bit_for_bit(name, scale):
    jfn, fn, torch_fn = FUNCS[name]
    x = _draws(name, scale)
    want = jax.jit(jfn)(x)
    assert not _differ(want, fn(torch.from_numpy(x))).any()
    if torch_fn is not None and scale == 8.0:
        # What the expansion buys: torch's own function parts from XLA's.
        assert _differ(want, torch_fn(torch.from_numpy(x))).mean() > 0.003


@pytest.mark.parametrize("name", list(FUNCS))
def test_special_values_match_xla(name):
    jfn, fn, _ = FUNCS[name]
    x = SPECIAL if name != "log1p" else SPECIAL[SPECIAL >= -1.0]
    assert not _differ(jax.jit(jfn)(x), fn(torch.from_numpy(x))).any()


@pytest.mark.parametrize("name", ["exp", "log1p", "tanh", "sigmoid"])
def test_gradient_is_torchs_formula_on_the_values(name):
    _, fn, torch_fn = FUNCS[name]
    x = torch.linspace(-3, 3, 97) if name != "log1p" else torch.linspace(0, 5, 97)
    x.requires_grad_(True)
    g = torch.randn(97, generator=torch.Generator().manual_seed(1))
    (fn(x) * g).sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    (torch_fn(xr) * g).sum().backward()
    # The values differ by an ulp or a few, which 1 - y^2 near |x| = 3
    # (about 0.01) magnifies a hundredfold.
    assert torch.allclose(x.grad, xr.grad, rtol=1e-4, atol=1e-7)


def test_other_formats_and_fma_keep_torchs_arithmetic():
    x = torch.randn(64, dtype=torch.float16)
    assert torch.equal(common.xla_exp(x), torch.exp(x))
    assert torch.equal(common.xla_tanh(x), torch.tanh(x))
    a, b, c = (torch.randn(256, dtype=torch.float64) for _ in range(3))
    assert torch.equal(common.xla_fma(a, b, c), a * b + c)
    af, bf, cf = (t.float() for t in (a, b, c))
    want = (af.double() * bf.double() + cf.double()).float()
    assert torch.equal(common.xla_fma(af, bf, cf), want)


def test_state_update_contracts_as_the_reference_scan():
    """One masked sLSTM scan step's carried c is the fused multiply-add on
    iw z, the output's on fw c_prev (XLA's two fusions): both packages'
    cells agree bit for bit with and without ``lengths``."""
    from repro.engine import Engine as JEngine
    from repro.models import xlstm as jxlstm
    from repro_torch.convert import tensor_from_numpy
    from repro_torch.engine import Engine
    from repro_torch.models import xlstm

    ccfg = jxlstm.XLSTMConfig(64, 4)
    p = jxlstm.slstm_init(jax.random.PRNGKey(0), ccfg, dtype=jnp.float32)
    tp = {k: {"w": tensor_from_numpy(np.asarray(v["w"]))} if isinstance(v, dict)
          else tensor_from_numpy(np.asarray(v)) for k, v in p.items()}
    je, te = JEngine(policy="fp32", backend="xla"), Engine(policy="fp32", backend="torch")
    rng = np.random.default_rng(3)
    x0, x = (rng.standard_normal((2, 4, 64)).astype(np.float32) for _ in range(2))
    state0 = jax.tree.map(np.asarray, jax.jit(lambda p, x: jxlstm.slstm_apply(p, x, ccfg, je)[1])(
        p, x0))
    for lens in (None, np.array([4, 2], np.int32)):
        y, st = jax.jit(lambda p, x, s, n: jxlstm.slstm_apply(p, x, ccfg, je, state=s,
                                                              lengths=n))(p, x, state0, lens)
        ty, tst = xlstm.slstm_apply(tp, torch.from_numpy(x), ccfg, te,
                                    state={k: torch.from_numpy(np.array(v)) for k, v in state0.items()},
                                    lengths=None if lens is None else torch.from_numpy(lens))
        assert not _differ(y, ty).any()
        for k in st:
            assert not _differ(st[k], tst[k]).any(), (k, lens)
