"""The port's XLA-rounded fp32 transcendentals (``repro_torch.models.common``)
against ``jax.jit`` of the reference's functions on the CPU, bit for bit.

The inputs are 2^20 fp32 draws of N(0, 64) (|x| for log1p and log), a wide
draw of N(0, 1600) that reaches the clamps, overflow and the flushed
denormals (and, for sin and cos, draws of N(0, 8000^2) and N(0, 10^60) for
the large-argument reduction), and the special values. torch's own
functions differ from XLA's compiled ones on 0.4-78% of the same draws
(the counts are read below, so a torch that came to round as XLA does
would show). The gradients are JAX's derivative rules on these values,
contracted as XLA compiles them; they are held here within 1e-4 of
torch's autograd, and bit for bit against ``jax.vjp`` in
tests/test_torch_xla_sites.py.

softmax and logsumexp are held bit for bit over rows of several widths
(XLA's compiled sum order included), and the sum alone over each dim of a
3-D draw. A general fp32 pow is not matched: XLA calls the C library's
powf, which parts from the fp64 power rounded once on 0.06% of 2^20 draws;
RoPE's frequencies, the one pow of the models, match on every config
(tests/test_torch_xla_sites.py).
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
    "log": (jnp.log, common.xla_log, torch.log),
    "sin": (jnp.sin, common.xla_sin, torch.sin),
    "cos": (jnp.cos, common.xla_cos, torch.cos),
}
POSITIVE = ("log1p", "log")


def _differ(want, got) -> np.ndarray:
    want, got = np.asarray(want), got.numpy()
    return (want.view(np.int32) != got.view(np.int32)) & ~(np.isnan(want) & np.isnan(got))


def _draws(name: str, scale: float) -> np.ndarray:
    x = (np.random.default_rng(0).standard_normal(1 << 20) * scale).astype(np.float32)
    return np.abs(x) if name in POSITIVE else x


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


@pytest.mark.parametrize("scale", [8000.0, 1e30])
@pytest.mark.parametrize("name", ["sin", "cos"])
def test_sin_cos_large_arguments_bit_for_bit(name, scale):
    jfn, fn, _ = FUNCS[name]
    x = _draws(name, scale)
    assert not _differ(jax.jit(jfn)(x), fn(torch.from_numpy(x))).any()


# Past 120 sin and cos take the 4/pi table; under 2^-12 they return x and 1.
TRIG_SPECIAL = np.array([2.0 ** -12, -2.0 ** -12, 2.4e-4, 0.7853981, 0.7853982, -0.7853982,
                         119.99999, 120.0, -120.0, 1e38, -3e38, 3.4028235e38, 1.1754944e-38,
                         1e-40, -1e-40], np.float32)


@pytest.mark.parametrize("name", list(FUNCS))
def test_special_values_match_xla(name):
    jfn, fn, _ = FUNCS[name]
    x = SPECIAL if name != "log1p" else SPECIAL[SPECIAL >= -1.0]
    if name in ("sin", "cos"):
        x = np.concatenate([x, TRIG_SPECIAL])
    assert not _differ(jax.jit(jfn)(x), fn(torch.from_numpy(x))).any()


@pytest.mark.parametrize("width", [8, 33, 1000, 1024, 32000])
@pytest.mark.parametrize("name", ["softmax", "logsumexp"])
def test_softmax_logsumexp_bit_for_bit(name, width):
    jfn, fn = {"softmax": (jax.nn.softmax, common.xla_softmax),
               "logsumexp": (jax.nn.logsumexp, common.xla_logsumexp)}[name]
    rows = max(4, (1 << 20) // width)
    x = (np.random.default_rng(1).standard_normal((rows, width)) * 4).astype(np.float32)
    x[0, :3] = -np.inf  # masked entries
    want = jax.jit(lambda a: jfn(a, axis=-1))(x)
    assert not _differ(want, fn(torch.from_numpy(x), -1)).any()
    # torch's own parts from XLA's on this draw.
    torch_fn = {"softmax": torch.softmax, "logsumexp": torch.logsumexp}[name]
    if width >= 1000:
        assert _differ(want, torch_fn(torch.from_numpy(x), -1)).mean() > 0.01


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_sum_in_xla_order(dim):
    x = (np.random.default_rng(2).standard_normal((40, 70, 300)) * 4).astype(np.float32)
    want = jax.jit(lambda a: jnp.sum(a, axis=dim, keepdims=True))(x)
    assert not _differ(want, common.xla_sum(torch.from_numpy(x), dim)).any()
    assert _differ(want, torch.from_numpy(x).sum(dim, keepdim=True)).mean() > 0.05
    y = x[0, :33]
    assert not _differ(jax.jit(jnp.sum)(y), common.xla_sum(torch.from_numpy(y), None)).any()


@pytest.mark.parametrize("name", ["softmax", "logsumexp"])
def test_reduction_gradients(name):
    """softmax takes torch's formula; logsumexp the reference's own, g / sum e
    times e, which gives jax.grad's bits."""
    x = (np.random.default_rng(3).standard_normal((16, 300)) * 4).astype(np.float32)
    g = np.random.default_rng(4).standard_normal((16, 300) if name == "softmax" else 16)
    g = g.astype(np.float32)
    jfn, fn, torch_fn = {"softmax": (jax.nn.softmax, common.xla_softmax, torch.softmax),
                         "logsumexp": (jax.nn.logsumexp, common.xla_logsumexp,
                                       torch.logsumexp)}[name]
    tx = torch.from_numpy(x).requires_grad_(True)
    (fn(tx, -1) * torch.from_numpy(g)).sum().backward()
    if name == "logsumexp":
        want = jax.jit(jax.grad(lambda a: jnp.sum(jfn(a, axis=-1) * g)))(x)
        assert not _differ(want, tx.grad).any()
    xr = torch.from_numpy(x).requires_grad_(True)
    (torch_fn(xr, -1) * torch.from_numpy(g)).sum().backward()
    assert torch.allclose(tx.grad, xr.grad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["exp", "log1p", "tanh", "sigmoid", "log", "sin", "cos"])
def test_gradient_is_torchs_formula_on_the_values(name):
    """The gradients are JAX's derivative rules on XLA's values, contracted
    as XLA compiles them (tanh's g (1 - y) + g (1 - y) y one fused
    multiply-add, the logistic's g (y (1 - y)), sin's and cos's with XLA's
    cos and sin; tests/test_torch_xla_sites.py holds them bit for bit
    against ``jax.vjp``); here each is held within 1e-4 of torch's own
    autograd on torch's values."""
    _, fn, torch_fn = FUNCS[name]
    x = torch.linspace(-3, 3, 97) if name not in POSITIVE else torch.linspace(0, 5, 97)
    if name == "log":
        x = torch.linspace(0.01, 5, 97)
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
    assert torch.equal(common.xla_sin(x), torch.sin(x))
    assert torch.equal(common.xla_softmax(x, -1), torch.softmax(x, -1))
    assert torch.equal(common.xla_logsumexp(x, -1), torch.logsumexp(x, -1))
    assert torch.equal(common.xla_sum(x, -1), x.sum(-1, keepdim=True))
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
