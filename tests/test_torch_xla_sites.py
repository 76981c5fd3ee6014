"""Each site of the port that evaluates an fp32 transcendental, against the
reference's own function under ``jax.jit`` on the CPU, from numpy draws.

On CPU tensors these sites call ``repro_torch.models.common``'s XLA-rounded
functions (exp, log, log1p, tanh, logistic, sin, cos, softmax, logsumexp)
and sum in XLA's compiled reduce order, so each is held bit for bit:

- the RG-LRU gates (``repro/models/rglru.py::_gates``), with diagonal gate
  weights so that both GEMMs are exact and the gates alone are compared;
- the chunked attention's online softmax under ``redmule_hfp8`` (whose
  GEMMs both packages compute alike), with and without the softcap, a
  window and a short last chunk; under fp32 the engine's fp32 GEMM keeps
  torch's order, which parts from XLA's dot on some shapes (the reading
  is stated at the case);
- the MoE router's probabilities and top-k (an exact router product),
  and its aux loss within an ulp;
- the softcap, fp32 silu and gelu;
- the chunk loss (``chunked_xent``) and its gradient, and the
  tensor-parallel cross-entropy (``vocab_xent``) at a mesh of one;
- RoPE: every config's frequencies, and the rotation in fp32, fp16, bf16.

On the CPU the sites' gradients are the reference's compiled ones too
(``jax.vjp`` under ``jax.jit``), bit for bit: the fp32 functions' (JAX's
derivative rules, contracted as XLA compiles them), fp16 silu and gelu,
RoPE's rotation, the RG-LRU's fp16 convolution (but for an element in a
few hundred, read at the case), and the chunked attention's (its K and V
broadcast over the query groups, each group's dK and dV in the compute
format summed over them, as the reference's). bf16 silu and gelu take
XLA's compiled bf16 gradient on every device, bit for bit on 2^20 draws
with the tails.

The card runs torch's functions, sums and autograd at the same sites;
``test_card_formulas_match_reference`` runs that code on CPU tensors
(``common.torch_rounding``) and holds it against the same reference
within the bounds stated there.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.engine import Engine as JEngine  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distrib import tensor_parallel as tpl  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import attention, common, moe, rglru  # noqa: E402
from repro_torch.training import loop  # noqa: E402

T = torch.from_numpy


def _differ(want, got) -> float:
    """The share of elements whose bits differ (NaNs equal)."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert want.shape == got.shape and want.dtype == got.dtype
    iv = {2: np.int16, 4: np.int32, 8: np.int64}[want.dtype.itemsize]
    diff = (want.view(iv) != got.view(iv))
    if want.dtype.kind == "f":
        diff &= ~(np.isnan(want) & np.isnan(got))
    return float(diff.mean()) if diff.size else 0.0


def _rng(seed=0):
    return np.random.default_rng(seed)


def _gates():
    """(reference, port) pairs of the RG-LRU's two gate outputs."""
    r = 64
    rng = _rng(1)
    xr = rng.standard_normal((2, 16, r)).astype(np.float32) * 2
    da, dx = (np.diag(rng.standard_normal(r)).astype(np.float32) for _ in range(2))
    lam = np.array(jnp.linspace(0.5, 4.0, r, dtype=jnp.float32))
    jp = {"gate_a": {"w": da}, "gate_x": {"w": dx}, "lam": lam}
    tp = {"gate_a": {"w": T(da)}, "gate_x": {"w": T(dx)}, "lam": T(lam)}
    ja, jb = jax.jit(lambda p, x: jrglru._gates(p, x, JEngine(policy="fp32", backend="xla")))(
        jp, xr)
    ta, tb = rglru._gates(tp, T(xr), Engine(policy="fp32", backend="torch"))
    return [(ja, ta), (jb, tb)]


def test_rglru_gates_bit_for_bit():
    for want, got in _gates():
        assert _differ(want, got) == 0.0
    assert not hasattr(rglru, "softplus")  # the gates call common.xla_softplus


ATTN_CASES = [  # (hd, sk, kv_chunk, softcap, window)
    (64, 48, 16, None, None),
    (64, 40, 512, 50.0, None),
    (64, 100, 64, None, None),  # a short last chunk: the reference pads it
    (64, 100, 512, 30.0, 24),
    (128, 300, 128, None, None),
]


def _attention(case, policy, seed):
    hd, sk, chunk, cap, window = case
    b, hq, hkv = 2, 4, 2
    dt = np.float32 if policy == "fp32" else np.float16
    rng = _rng(seed)
    q, k, v = (rng.standard_normal((b, sk, h, hd)).astype(dt) for h in (hq, hkv, hkv))
    pos = np.arange(sk, dtype=np.int32)[None]
    kw = dict(softcap=cap, window=window, kv_chunk=chunk)
    jc, tc = jattn.AttnConfig(hq, hkv, hd, **kw), attention.AttnConfig(hq, hkv, hd, **kw)
    want = jax.jit(lambda q, k, v: jattn._online_attention(
        q, k, v, pos, pos, jc, JEngine(policy=policy, backend="xla")))(q, k, v)
    got = attention._online_attention(T(q), T(k), T(v), T(pos), T(pos), tc,
                                      Engine(policy=policy, backend="torch"))
    return np.asarray(want), got


@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_hfp8_bit_for_bit(case):
    want, got = _attention(case, "redmule_hfp8", 2)
    assert _differ(want, got) == 0.0


@pytest.mark.parametrize("case, reading", [
    (ATTN_CASES[2], 0.0), (ATTN_CASES[4], 0.0),
    # The fp32 score and PV GEMMs of these shapes sum in torch's matmul
    # order, not XLA's dot order: 82% and 81% of the outputs read off, each
    # by a few ulps.
    (ATTN_CASES[0], 0.83), (ATTN_CASES[1], 0.82),
])
def test_chunked_attention_fp32(case, reading):
    want, got = _attention(case, "fp32", 3)
    assert _differ(want, got) <= reading
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def _router(t):
    """The reference's and the port's (top_p, top_i, aux) on t tokens, and
    the router's logits."""
    d, e, k = 32, 8, 2
    rng = _rng(4)
    x2 = rng.standard_normal((t, d)).astype(np.float32)
    w = np.zeros((d, e), np.float32)  # one term a logit: the product is exact
    w[rng.permutation(d)[:e], np.arange(e)] = rng.standard_normal(e).astype(np.float32) * 3
    jtop_p, jtop_i, jaux = jax.jit(lambda x: jmoe._router(
        {"router": {"w": w}}, x, jmoe.MoEConfig(e, k, d, 16)))(x2)
    ttop_p, ttop_i, taux = moe._router({"router": {"w": T(w)}}, T(x2), moe.MoEConfig(e, k, d, 16),
                                       Engine(policy="fp32", backend="torch"))
    return (jtop_p, jtop_i, jaux), (ttop_p, ttop_i, taux), (x2, w)


@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
@pytest.mark.parametrize("case", ATTN_CASES + [(64, 1, 512, 50.0, None)])
def test_attention_layouts_give_the_same_forward_bits(case, policy):
    """Under autograd the CPU computes each query group's products apart
    (K and V broadcast over the groups); without it, the card's layout
    (the groups folded into the rows). The outputs are the same bits."""
    hd, sk, chunk, cap, window = case
    b, hq, hkv = 2, 4, 2
    dt = np.float32 if policy == "fp32" else np.float16
    rng = _rng(15)
    q, k, v = (T(rng.standard_normal((b, sk, h, hd)).astype(dt)) for h in (hq, hkv, hkv))
    pos = T(np.arange(sk, dtype=np.int32)[None])
    cfg = attention.AttnConfig(hq, hkv, hd, softcap=cap, window=window, kv_chunk=chunk)
    engine = Engine(policy=policy, backend="torch")
    with torch.no_grad():
        folded = attention._online_attention(q, k, v, pos, pos, cfg, engine)
    grouped = attention._online_attention(q.requires_grad_(True), k, v, pos, pos, cfg, engine)
    assert torch.equal(folded, grouped.detach())


@pytest.mark.parametrize("t", [64, 50])
def test_router_probabilities_bit_for_bit(t):
    (jtop_p, jtop_i, jaux), (ttop_p, ttop_i, taux), (x2, w) = _router(t)
    assert _differ(jtop_i, ttop_i.int()) == 0.0
    assert _differ(jtop_p, ttop_p) == 0.0
    # The aux loss: E sum(me fe) with XLA's means. XLA sums the fused
    # products in an order that depends on what else the fusion outputs
    # (a tree here, a left fold when me and fe are outputs too); the port
    # folds left, an ulp apart on one draw in five. Its gradient does not
    # depend on that order.
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=2.5e-7, atol=0)
    want = jax.jit(lambda x: jax.nn.softmax(x @ w, axis=-1))(x2)
    assert _differ(want, common.xla_softmax(T(x2) @ T(w), -1)) == 0.0


@pytest.mark.parametrize("cap", [30.0, 50.0])
def test_softcap_bit_for_bit(cap):
    x = (_rng(5).standard_normal(1 << 16) * 40).astype(np.float32)
    want = jax.jit(lambda a: jcommon.softcap(a, cap))(x)
    assert _differ(want, common.softcap(T(x), cap)) == 0.0


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_fp32_activations_bit_for_bit(name):
    x = (_rng(6).standard_normal(1 << 16) * 4).astype(np.float32)
    jfn = {"silu": jax.nn.silu, "gelu": jcommon.gelu}[name]
    assert _differ(jax.jit(jfn)(x), common.ACTIVATIONS[name](T(x))) == 0.0


class _JLogits:
    def __init__(self, v):
        self.cfg = SimpleNamespace(vocab_size=v)

    def logits(self, params, h, engine=None):
        return h


class _TLogits(_JLogits):
    tp = None

    def logits(self, params, h, engine=None):
        return h


def _chunk_loss(s, chunk):
    """[(loss), (gradient)] pairs of ``chunked_xent`` over logits (2, s, 300)."""
    b, v = 2, 300
    rng = _rng(7)
    h = (rng.standard_normal((b, s, v)) * 4).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)

    def jloss(h):
        return jloop.chunked_xent(_JLogits(v), None, h, labels, mask, chunk=chunk)[0]

    want, jgrad = jax.jit(jax.value_and_grad(jloss))(h)
    th = T(h.copy()).requires_grad_(True)
    got, _ = loop.chunked_xent(_TLogits(v), None, th, T(labels).long(), T(mask), chunk=chunk)
    got.backward()
    return [(want, got), (jgrad, th.grad)]


@pytest.mark.parametrize("s, chunk", [(12, 512), (20, 8)])
def test_chunk_loss_and_gradient_bit_for_bit(s, chunk):
    """The loss is the sum over positions of logsumexp - the label's logit,
    chunk by chunk (the last chunk short, the reference pads it); the
    gradient is the reference's g / sum e times e."""
    for want, got in _chunk_loss(s, chunk):
        assert _differ(want, got) == 0.0


def _vocab_xent():
    """[(loss), (gradient)] pairs of ``vocab_xent`` at a mesh of one rank."""
    mesh = SimpleNamespace(axis_size=lambda axis: 1, axis_index=lambda axis: 0)
    b, c, v = 2, 16, 500
    rng = _rng(8)
    z = (rng.standard_normal((b, c, v)) * 4).astype(np.float32)
    labels = rng.integers(0, v, (b, c)).astype(np.int32)
    mask = (rng.random((b, c)) < 0.8).astype(np.float32)

    def jloss(z):
        logz = jax.nn.logsumexp(z, axis=-1)
        ll = jnp.sum(z * jax.nn.one_hot(labels, v, dtype=z.dtype), axis=-1)
        return jnp.sum((logz - ll) * mask)

    want, jgrad = jax.jit(jax.value_and_grad(jloss))(z)
    tz = T(z.copy()).requires_grad_(True)
    got = tpl.vocab_xent(tz, T(labels).long(), T(mask), tpl.TP(mesh, "model"), c)
    got.backward()
    return [(want, got), (jgrad, tz.grad)]


def test_vocab_parallel_xent_bit_for_bit():
    """``vocab_xent`` at a mesh of one rank is the chunk loss of the whole
    vocab: the same bits as the reference's, gradient included (500 is
    not a multiple of the 32-wide windows: the rank pads as XLA does)."""
    for want, got in _vocab_xent():
        assert _differ(want, got) == 0.0


def test_rope_frequencies_of_every_config_bit_for_bit():
    seen = set()
    for arch in ARCH_IDS:
        for smoke in (False, True):
            cfg = get_config(arch, smoke)
            seen.add((cfg.head_dim, cfg.rope_theta, cfg.rope_fraction))
    for hd, theta, frac in sorted(seen):
        want = jax.jit(lambda: jcommon.rope_freqs(hd, theta, frac)[0])()
        got, rot = common.rope_freqs(hd, theta, frac, "cpu")
        assert _differ(want, got) == 0.0, (hd, theta, frac)
        # What the rewrite buys: 1 / theta^x parts from theta^-x.
        if rot >= 64:
            e = torch.arange(0, rot, 2, dtype=torch.float32) / rot
            assert _differ(want, 1.0 / (theta ** e)) > 0.1


ROPE_CASES = [(128, 1e4, 1.0), (128, 5e5, 1.0), (128, 1e4, 0.5), (192, 1e4, 1.0)]


def _rope(dtype, hd, theta, frac):
    """The reference's and the port's RoPE at positions 0-63 and 3584-3647
    (bf16 read as int16)."""
    rng = _rng(9)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 64, 3, hd)), dtype))
    pos = np.stack([np.arange(64), np.arange(3584, 3648)]).astype(np.int32)
    want = np.asarray(jax.jit(lambda a, p: jcommon.apply_rope(a, p, theta, frac))(x, pos))
    tx = T(x.view(np.int16)).view(torch.bfloat16) if dtype is jnp.bfloat16 else T(x)
    got = common.apply_rope(tx, T(pos), theta, frac)
    if dtype is jnp.bfloat16:
        got = got.view(torch.int16)
        want = want.view(np.int16)
    return want, got


@pytest.mark.parametrize("dtype", [np.float32, np.float16, jnp.bfloat16])
@pytest.mark.parametrize("hd, theta, frac", ROPE_CASES)
def test_rope_bit_for_bit(dtype, hd, theta, frac):
    assert _differ(*_rope(dtype, hd, theta, frac)) == 0.0


# -- gradients -----------------------------------------------------------------------------


def _vjp(jfn, x, g):
    return np.asarray(jax.jit(lambda a, b: jax.vjp(jfn, a)[1](b)[0])(x, g))


def _grad(fn, x, g):
    t = T(x.copy()).requires_grad_(True)
    fn(t).backward(T(g))
    return t.grad


FP32_FUNCS = ["exp", "log", "log1p", "tanh", "sigmoid", "softplus", "sin", "cos", "silu",
              "gelu", "softcap"]


def _fp32_function(name):
    """[(values), (gradients)] pairs of an fp32 function on 2^16 draws."""
    rng = _rng(10)
    x = (rng.standard_normal(1 << 16) * 4).astype(np.float32)
    if name in ("log", "log1p"):
        x = np.abs(x) + np.float32(0.01)
    g = rng.standard_normal(1 << 16).astype(np.float32)
    jfn, fn = {
        "exp": (jnp.exp, common.xla_exp), "log": (jnp.log, common.xla_log),
        "log1p": (jnp.log1p, common.xla_log1p), "tanh": (jnp.tanh, common.xla_tanh),
        "sigmoid": (jax.nn.sigmoid, common.xla_sigmoid),
        "softplus": (jax.nn.softplus, common.xla_softplus), "sin": (jnp.sin, common.xla_sin),
        "cos": (jnp.cos, common.xla_cos), "silu": (jax.nn.silu, common.silu),
        "gelu": (jcommon.gelu, common.gelu),
        "softcap": (lambda a: jcommon.softcap(a, 30.0), lambda a: common.softcap(a, 30.0)),
    }[name]
    return [(jax.jit(jfn)(x), fn(T(x))), (_vjp(jfn, x, g), _grad(fn, x, g))]


@pytest.mark.parametrize("name", FP32_FUNCS)
def test_fp32_gradients_bit_for_bit(name):
    assert _differ(*_fp32_function(name)[1]) == 0.0


def _fp16_activation_gradient(name):
    rng = _rng(5)
    x = (rng.standard_normal(1 << 16) * 3).astype(np.float16)
    x[:4] = [-12.0, -20.0, 12.0, -100.0]  # past exp's fp16 range at -x
    g = rng.standard_normal(1 << 16).astype(np.float16)
    jfn = {"silu": jax.nn.silu, "gelu": jcommon.gelu}[name]
    return _vjp(jfn, x, g), _grad(common.ACTIVATIONS[name], x, g)


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_fp16_activation_gradients_bit_for_bit(name):
    assert _differ(*_fp16_activation_gradient(name)) == 0.0


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_bf16_activation_gradients_keep_torchs_autograd(name):
    """bf16 no longer keeps torch's autograd of the forward expansion (44%
    of silu's and 21% of gelu's gradients off, silu's NaN below -88.7): the
    gradient is XLA's compiled bf16 formula, every step rounded to bf16,
    and matches bit for bit, as the values do."""
    rng = _rng(5)
    x = np.asarray(jnp.asarray(rng.standard_normal(1 << 16) * 3, jnp.bfloat16))
    g = np.asarray(jnp.asarray(rng.standard_normal(1 << 16), jnp.bfloat16))
    jfn = {"silu": jax.nn.silu, "gelu": jcommon.gelu}[name]
    tx = T(x.view(np.int16).copy()).view(torch.bfloat16).requires_grad_(True)
    y = common.ACTIVATIONS[name](tx)
    y.backward(T(g.view(np.int16).copy()).view(torch.bfloat16))
    assert _differ(np.asarray(jax.jit(jfn)(x)).view(np.int16), y.detach().view(torch.int16)) == 0
    assert _differ(_vjp(jfn, x, g).view(np.int16), tx.grad.view(torch.int16)) == 0.0


def _bf16_activation(name):
    """[(values), (gradients)] of the bf16 activation, the reference's under
    ``jax.jit`` / ``jax.vjp`` and the port's, on 2^20 N(0, 64) draws rounded
    to bf16 with the tails to +-100 among them (exp(-x) overflows bf16
    below -88.7 and leaves a subnormal logistic down to -87.3), N(0, 1)
    cotangents; as int16 bit patterns."""
    rng = _rng(15)
    draws = rng.standard_normal(1 << 20) * 8
    draws[:12] = [-100, -90, -89, -88.5, -88, -87.5, -87, 100, 90, 89, 88, 87]
    x = np.array(jnp.asarray(draws, jnp.bfloat16))
    g = np.array(jnp.asarray(rng.standard_normal(1 << 20), jnp.bfloat16))
    jfn = {"silu": jax.nn.silu, "gelu": jcommon.gelu}[name]
    tx = T(x.view(np.int16).copy()).view(torch.bfloat16).requires_grad_(True)
    y = common.ACTIVATIONS[name](tx)
    y.backward(T(g.view(np.int16).copy()).view(torch.bfloat16))
    return [(np.asarray(jax.jit(jfn)(x)).view(np.int16), y.detach().view(torch.int16)),
            (_vjp(jfn, x, g).view(np.int16), tx.grad.view(torch.int16))]


@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_bf16_activations_bit_for_bit_to_the_tails(name):
    """Values and gradients bit for bit on every draw (bound 0, read 0), so
    the gradient is finite wherever the reference's is (autograd of the
    expansion gave NaN for silu at -89, -90 and -100)."""
    for want, got in _bf16_activation(name):
        assert _differ(want, got) == 0.0
    want, got = _bf16_activation(name)[1]
    want = want.view(jnp.bfloat16).astype(np.float32)
    assert np.isfinite(want).all() and torch.isfinite(got.view(torch.bfloat16)).all()


def _rope_gradient(dtype):
    rng = _rng(11)
    x = rng.standard_normal((2, 16, 4, 64)).astype(dtype)
    g = rng.standard_normal((2, 16, 4, 64)).astype(dtype)
    pos = np.stack([np.arange(16), np.arange(100, 116)]).astype(np.int32)
    want = _vjp(lambda a: jcommon.apply_rope(a, pos, 1e4), x, g)
    return want, _grad(lambda a: common.apply_rope(a, T(pos), 1e4), x, g)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_rope_gradient_bit_for_bit(dtype):
    assert _differ(*_rope_gradient(dtype)) == 0.0


CONV_SHAPES = [(2, 16, 64), (4, 64, 128), (2, 100, 32), (1, 7, 16)]


def _conv_gradient(shape):
    """[(dx), (dw)] pairs of the RG-LRU's fp16 convolution."""
    rng = _rng(12)
    x = rng.standard_normal(shape).astype(np.float16)
    w = (rng.standard_normal((4, shape[-1])) * 0.1).astype(np.float16)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float16)
    jdx, jdw = jax.jit(lambda x, w, g: jax.vjp(lambda a, b: jrglru._causal_conv(a, b)[0], x, w)[1](
        g))(x, w, g)
    tx, tw = (T(a.copy()).requires_grad_(True) for a in (x, w))
    rglru._causal_conv(tx, tw)[0].backward(T(g))
    return [(jdx, tx.grad), (jdw, tw.grad)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_rglru_fp16_conv_gradient_bit_for_bit(shape):
    """The windowed reduce (time past 32) reads its products in fp16, a
    single fold has them fused; dx sums the taps from the last. Read: one
    element of dw in 256 off at (2, 16, 64) and one of dx in 6400 at
    (2, 100, 32), by up to 4 fp16 ulps (an order inside XLA's loop not
    found); 0 at the others."""
    (jdx, dx), (jdw, dw) = _conv_gradient(shape)
    assert _differ(jdx, dx) <= 1 / 6400
    assert _differ(jdw, dw) <= 1 / 256


ATTN_GRAD_CASES = [ATTN_CASES[0], ATTN_CASES[1], (16, 16, 512, 50.0, None)]


def _attention_gradient(case):
    """[(dq), (dk), (dv)] pairs of the chunked attention under redmule_hfp8."""
    hd, sk, chunk, cap, window = case
    b, hq, hkv = 2, 4, 2
    rng = _rng(13)
    q, k, v = (rng.standard_normal((b, sk, h, hd)).astype(np.float16) for h in (hq, hkv, hkv))
    g = (rng.standard_normal((b, sk, hq, hd)) * 0.1).astype(np.float16)
    pos = np.arange(sk, dtype=np.int32)[None]
    kw = dict(softcap=cap, window=window, kv_chunk=chunk)
    jc, tc = jattn.AttnConfig(hq, hkv, hd, **kw), attention.AttnConfig(hq, hkv, hd, **kw)
    want = jax.jit(lambda q, k, v, g: jax.vjp(lambda *a: jattn._online_attention(
        *a, pos, pos, jc, JEngine(policy="redmule_hfp8", backend="xla")), q, k, v)[1](g))(
        q, k, v, g)
    tq, tk, tv = (T(a.copy()).requires_grad_(True) for a in (q, k, v))
    attention._online_attention(tq, tk, tv, T(pos), T(pos), tc,
                                Engine(policy="redmule_hfp8", backend="torch")).backward(T(g))
    return [(a, t.grad) for a, t in zip(want, (tq, tk, tv))]


@pytest.mark.parametrize("case", ATTN_GRAD_CASES)
def test_chunked_attention_hfp8_gradient_bit_for_bit(case):
    for want, got in _attention_gradient(case):
        assert _differ(want, got) == 0.0


# -- the card's formulas -----------------------------------------------------------------
#
# On the card every site runs torch's functions, sum orders and autograd.
# ``common.torch_rounding()`` runs that code on CPU tensors, and the cases
# below hold it against the same compiled reference: each output within
# ``bound`` of its largest element, max |want - got| / max |want|, or
# (rtol, atol) elementwise where a test held the site so before its CPU
# path took XLA's rounding (the activations, the softcap). The readings
# are stated at each bound.


def _floats(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach()
        return (a.view(torch.bfloat16) if a.dtype == torch.int16 else a).float().numpy()
    a = np.asarray(a)
    return (a.view(jnp.bfloat16) if a.dtype == np.int16 else a).astype(np.float32)


def _card_router(t):
    (jtop_p, jtop_i, jaux), (ttop_p, ttop_i, taux), _ = _router(t)
    assert _differ(jtop_i, ttop_i.int()) == 0.0
    return [(jtop_p, ttop_p), (jaux, taux)]


def _card_softcap(cap):
    x = (_rng(5).standard_normal(1 << 16) * 40).astype(np.float32)
    return [(jax.jit(lambda a: jcommon.softcap(a, cap))(x), common.softcap(T(x), cap))]


def _card_activation(name):
    x = (_rng(6).standard_normal(1 << 16) * 4).astype(np.float32)
    jfn = {"silu": jax.nn.silu, "gelu": jcommon.gelu}[name]
    return [(jax.jit(jfn)(x), common.ACTIVATIONS[name](T(x)))]


# name -> (pairs, bound, or (rtol, atol)).
CARD_SITES = {
    "rglru_gates": (_gates, 1e-6),  # read 6.0e-8
    **{f"attention_fp32_{i}": (lambda c=c: [_attention(c, "fp32", 3)], (0, 2e-6))  # read 8.3e-7
       for i, c in enumerate(ATTN_CASES)},
    # An fp16 ulp on one output in 10^4: read 1.6e-4.
    **{f"attention_hfp8_{i}": (lambda c=c: [_attention(c, "redmule_hfp8", 2)], 5e-4)
       for i, c in enumerate(ATTN_CASES)},
    **{f"router_{t}": (lambda t=t: _card_router(t), 1e-6) for t in (64, 50)},  # read 1.0e-7
    # test_torch_families' bound (read 1.1e-5 at |x| = 50).
    **{f"softcap_{c:g}": (lambda c=c: _card_softcap(c), (2.4e-7, 4e-6)) for c in (30.0, 50.0)},
    "silu": (lambda: _card_activation("silu"), (2e-6, 1e-6)),  # test_torch_shims' bound
    "gelu": (lambda: _card_activation("gelu"), (1.2e-7, 1e-6)),  # test_torch_families'
    **{f"chunk_loss_{s}": (lambda s=s, c=c: _chunk_loss(s, c), 1e-6)  # read 4.2e-7
       for s, c in [(12, 512), (20, 8)]},
    "vocab_xent": (_vocab_xent, 1e-6),  # read 3.0e-7
    # torch's frequencies and sin/cos, an ulp of the angle at position
    # 3600: read 1.8e-4 (fp32), 4.7e-4 (fp16), 3.6e-3 (bf16).
    **{f"rope_{np.dtype(dt).name}_{hd}_{th:g}_{fr:g}": (
        lambda a=(dt, hd, th, fr): [_rope(*a)], {np.float32: 5e-4, np.float16: 1e-3}.get(dt, 8e-3))
       for dt in (np.float32, np.float16, jnp.bfloat16) for hd, th, fr in ROPE_CASES},
    # torch's fp32 functions and autograd: read 4.1e-7 at most, but gelu's
    # gradient 3.5e-6.
    **{f"fp32_{n}": (lambda n=n: _fp32_function(n), 1e-5 if n == "gelu" else 1e-6)
       for n in FP32_FUNCS},
    # The same formulas; the card keeps silu's subnormal logistic between
    # -88.7 and -87.3, which the CPU flushes to zero as XLA does: read
    # 8.8e-37 (silu), 0 (gelu).
    **{f"bf16_{n}": (lambda n=n: _bf16_activation(n), (0.0, 1e-36)) for n in ("silu", "gelu")},
    "fp16_silu_gradient": (lambda: [_fp16_activation_gradient("silu")], 0.0),  # the same formula
    "fp16_gelu_gradient": (lambda: [_fp16_activation_gradient("gelu")], 4e-3),  # read 1.7e-3
    "rope_gradient_fp32": (lambda: [_rope_gradient(np.float32)], 4e-6),  # read 1.2e-6
    "rope_gradient_fp16": (lambda: [_rope_gradient(np.float16)], 0.0),  # read 0
    # autograd's fp16 sums of the taps: read 1.1e-3 (dx), 2.4e-3 (dw).
    **{f"conv_gradient_{'x'.join(map(str, sh))}": (lambda sh=sh: _conv_gradient(sh), 5e-3)
       for sh in CONV_SHAPES},
    # dK and dV summed over the query groups in fp32 before their one cast
    # (the card's layout): read 2.8e-3.
    **{f"attention_gradient_{i}": (lambda c=c: _attention_gradient(c), 6e-3)
       for i, c in enumerate(ATTN_GRAD_CASES)},
}


@pytest.mark.parametrize("site", list(CARD_SITES))
def test_card_formulas_match_reference(site):
    pairs, bound = CARD_SITES[site]
    with common.torch_rounding():
        pairs = pairs()
    for want, got in pairs:
        want, got = _floats(want), _floats(got)
        assert want.shape == got.shape and np.isfinite(got).all()
        if isinstance(bound, tuple):
            np.testing.assert_allclose(got, want, rtol=bound[0], atol=bound[1])
        else:
            assert np.abs(want - got).max() <= bound * np.abs(want).max()


def test_torch_rounding_takes_the_card_code():
    """Inside ``torch_rounding`` each site is torch's code bit for bit (so
    the cases above read the card's formulas), and outside it is not."""
    x = T((_rng(14).standard_normal((64, 300)) * 4).astype(np.float32))
    pos = torch.arange(4096)[None]
    sites = [
        (lambda: common.xla_exp(x), lambda: torch.exp(x)),
        (lambda: common.xla_softmax(x, -1), lambda: torch.softmax(x, -1)),
        (lambda: common.xla_logsumexp(x, -1), lambda: torch.logsumexp(x, -1)),
        (lambda: common.xla_sum(x, -1), lambda: x.sum(-1, keepdim=True)),
        (lambda: common.softcap(x, 30.0), lambda: 30.0 * torch.tanh(x / 30.0)),
        (lambda: common.silu(x), lambda: x * torch.sigmoid(x)),
        (lambda: common.rope_freqs(128, 5e5, 1.0, "cpu")[0],
         lambda: 1.0 / (5e5 ** (torch.arange(0, 128, 2, dtype=torch.float32) / 128))),
        (lambda: common.apply_rope(x.reshape(1, 64, 1, 300)[:, :, :, :256], pos[:, :64] * 60, 1e4),
         None),
    ]
    for site, plain in sites:
        xla = site()
        with common.torch_rounding():
            card = site()
        assert not torch.equal(xla, card)
        if plain is not None:
            assert torch.equal(card, plain())
