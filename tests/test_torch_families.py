"""The port's other attention-only decoders against the JAX package's, on
the CPU: chatglm3-6b and deepseek-coder-33b (untied heads; chatglm's
half-dim rotary and 16-way GQA, deepseek's 7-way), gemma2-2b (GeGLU, the
sqrt(d) embedding scale, attention and final softcaps, alternating
``attn_local``/``attn`` layers) and phi3.5-moe (dense MoE with an untied
head, serving only), each at SMOKE size.

Parameters come from the reference's ``Transformer.init`` through
``params_from_jax``; inputs are numpy draws from a seed. The port runs its
plain backend. Its gathered decode is held against the reference's XLA
backend, its paged decode attention (``fused_decode``, the kernel's plain
version) against the reference's Pallas kernel in interpret mode.

Tolerances, and why:

- logits under fp32: 1e-5 of max|logit|, the bound of the granite tests.
  The tanh of gemma's softcaps and gelu is XLA's rational approximation on
  the reference's side and torch's on the port's; the two differ by about
  an fp32 ulp, which these logits do not see above 1e-6;
- logits under redmule_hfp8 with E4M3 pages: 5e-2, the granite tests'
  bound (an fp16 ulp from the order of a sum can move an activation across
  an E4M3 boundary);
- the tanh-gelu alone (``common.gelu``): bit for bit in fp16 and bf16
  against the compiled reference (its layers run inside ``lax.scan`` and
  ``jit``). Op by op (the reference's remainder layers run so) XLA rounds
  0.044715 x^3 to fp16 before the add; the two then differ in 0.4% of the
  elements, by at most |x| 2^-10 (an ulp of the tanh's input, magnified
  where 1 + tanh is near 0). In fp32 the difference is XLA's
  tanh against torch's: within 1.2e-7 relative plus 1e-6 absolute
  (measured 9.5e-7 at |x| up to 12);
- ``ffn.apply`` (two or three GEMMs around the gelu): the plain GEMM sums
  in another order than XLA's dot, so a 16-bit output may round the other
  way: within one ulp of the format at the output's scale in fp16 and
  bf16, and 1e-5 relative in fp32.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import for_model as jfor_model  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.models import build  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.serving import generate_static as jgenerate_static  # noqa: E402
from repro.training import TrainState as JTrainState  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import common, ffn  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serving import Server, ServerConfig, SpecConfig  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402

ARCHS = ["chatglm3-6b", "deepseek-coder-33b", "gemma2-2b", "phi3.5-moe-42b-a6.6b"]
# (policy, kv pages, tolerance, reference backend)
CASES = {
    "fp32": ("fp32", "fp32", 1e-5, "xla"),
    "fp32-paged-kernel": ("fp32", "fp32", 1e-5, "pallas_interpret"),
    "hfp8": ("redmule_hfp8", "e4m3", 5e-2, "xla"),
}


@functools.lru_cache(maxsize=None)
def _models(arch, policy="fp32", kv="fp32", backend="xla", n_layers=None, fp8_params=False):
    """The reference on ``backend`` and the port's plain model with the
    decode path of the same semantics, on the reference's parameters."""
    kw = dict(policy=policy, kv_cache_dtype=kv, fp8_params=fp8_params)
    if n_layers is not None:
        kw["n_layers"] = n_layers
    cfg = dataclasses.replace(get_config(arch, smoke=True), backend=backend, **kw)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), **kw)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tmodel = tbuild(tcfg, device="cpu")
    if backend != "xla":
        tmodel = Transformer(tcfg, engine=tmodel.engine, device="cpu", fused_decode=True)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    return model, params, tmodel, tparams


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(want - got).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the training forward ---------------------------------------------------------

@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, policy):
    """Teacher-forced forward and logits of two 24-token rows (past gemma's
    window of 16); phi's aux loss (its MoE layers' load balance) to 1e-5
    relative, the others' an fp32 zero."""
    model, params, tmodel, tparams = _models(arch, policy)
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (2, 24)).astype(np.int32)
    h, want_aux = model.forward(params, {"tokens": jnp.asarray(toks)})
    want = np.asarray(model.logits(params, h))
    with torch.no_grad():
        th, aux = tmodel.forward(tparams, {"tokens": _t(toks).long()})
        got = tmodel.logits(tparams, th)
    assert got.shape == want.shape == (2, 24, model.cfg.vocab_size)
    if tmodel.cfg.is_moe:
        assert float(aux) > 0 and abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
    else:
        assert float(aux) == 0.0
    assert _rel(want, got) <= (1e-5 if policy == "fp32" else 5e-2)


# -- the serving entry points -------------------------------------------------------

PS, PPS = 4, 8  # page size, pages a slot


def _serve_pairs(model, params, tmodel, tparams):
    """Slot 0 prefilled whole (21 tokens), slot 1 in chunks of 8 (19
    tokens), three decode steps of both slots fed the reference's greedy
    tokens, one verify step (4 and 2 positions, commit=False) and the decode
    step after it, which reads the verify step's K/V back. Every position
    past 16 lies outside gemma's window. Returns (name, reference logits,
    port logits) of every call, valid rows only."""
    v = model.cfg.vocab_size
    pools = model.init_state_store(2, 2 * PPS + 1, PS)
    tpools = tmodel.init_state_store(2, 2 * PPS + 1, PS)
    pt = np.arange(1, 2 * PPS + 1, dtype=np.int32).reshape(2, PPS)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, v, n).astype(np.int32) for n in (21, 19)]
    out = []

    def prefill(name, toks, slot, start, n, chunked):
        nonlocal pools
        want, pools = model.prefill_cb(params, jnp.asarray(toks), pools, jnp.asarray(pt[slot]),
                                       jnp.int32(slot), jnp.int32(start), jnp.int32(n),
                                       page_size=PS, chunked=chunked)
        with torch.inference_mode():
            got = tmodel.prefill_cb(tparams, _t(toks), tpools, _t(pt[slot]), slot, start, n,
                                    page_size=PS, chunked=chunked)
        out.append((name, np.asarray(want), got))

    whole = np.zeros((1, 24), np.int32)
    whole[0, :21] = prompts[0]
    prefill("prefill", whole, 0, 0, 21, False)
    for start in (0, 8, 16):
        chunk = np.zeros((1, 8), np.int32)
        n = min(8, 19 - start)
        chunk[0, :n] = prompts[1][start:start + n]
        prefill(f"chunk@{start}", chunk, 1, start, n, True)

    lens = np.array([21, 19], np.int32)
    active = np.array([True, True])
    tok = rng.integers(0, v, (2, 1)).astype(np.int32)

    def decode(name):
        nonlocal pools
        want, pools = model.decode_cb(params, jnp.asarray(tok), pools, jnp.asarray(pt),
                                      jnp.asarray(lens), jnp.asarray(active), page_size=PS)
        with torch.inference_mode():
            got = tmodel.decode_cb(tparams, _t(tok), tpools, _t(pt), _t(lens), _t(active),
                                   page_size=PS)
        out.append((name, np.asarray(want), got))
        return np.asarray(want).argmax(-1).astype(np.int32)[:, None]

    for i in range(3):
        tok = decode(f"decode{i}")
        lens = lens + 1
    draft = rng.integers(0, v, (2, 4)).astype(np.int32)
    lengths = np.array([4, 2], np.int32)
    want, pools = model.verify_cb(params, jnp.asarray(draft), pools, jnp.asarray(pt),
                                  jnp.asarray(lens), jnp.asarray(lengths), jnp.asarray(active),
                                  page_size=PS, commit=False)
    with torch.inference_mode():
        got = tmodel.verify_cb(tparams, _t(draft), tpools, _t(pt), _t(lens), _t(lengths),
                               _t(active), page_size=PS, commit=False)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 4, v)
    for slot in (0, 1):
        out.append((f"verify[{slot}]", want[slot, :lengths[slot]], got[slot, :lengths[slot]]))
    lens = lens + lengths
    decode("decode after verify")
    return out


# The reference's Pallas decode (interpret mode) for the models that reach
# new branches of the paged decode (gemma2's window, softcap and hd; an
# untied head and chatglm's 16-way group); its XLA path for every model.
SERVE_CASES = [(arch, case) for arch in ARCHS for case in CASES
               if case != "fp32-paged-kernel" or arch in ("chatglm3-6b", "gemma2-2b")]


@pytest.mark.parametrize("arch,case", SERVE_CASES)
def test_serving_entry_points_match_reference(arch, case):
    policy, kv, tol, backend = CASES[case]
    for name, want, got in _serve_pairs(*_models(arch, policy, kv, backend)):
        assert got.shape == want.shape, name
        assert torch.isfinite(got).all(), name
        assert _rel(want, got) <= tol, (name, _rel(want, got))


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_prefill_matches_reference(arch):
    """The multi-row chunked prefill: two slots in (2, 8) steps from
    position 0, 8 and 16 (lengths 21 and 19), logits of both rows at each
    step, and a decode step over what the rows wrote, under fp32."""
    model, params, tmodel, tparams = _models(arch)
    v = model.cfg.vocab_size
    pools = model.init_state_store(2, 2 * PPS + 1, PS)
    tpools = tmodel.init_state_store(2, 2 * PPS + 1, PS)
    pt = np.arange(1, 2 * PPS + 1, dtype=np.int32).reshape(2, PPS)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, v, n).astype(np.int32) for n in (21, 19)]
    slots = np.array([0, 1], np.int32)
    active = np.array([True, True])
    for start in (0, 8, 16):
        toks = np.zeros((2, 8), np.int32)
        lengths = np.array([min(8, len(p) - start) for p in prompts], np.int32)
        for r, p in enumerate(prompts):
            toks[r, :lengths[r]] = p[start:start + lengths[r]]
        starts = np.full((2,), start, np.int32)
        want, pools = model.prefill_cb(params, jnp.asarray(toks), pools, jnp.asarray(pt),
                                       jnp.asarray(slots), jnp.asarray(starts),
                                       jnp.asarray(lengths), page_size=PS, chunked=True,
                                       active=jnp.asarray(active))
        with torch.inference_mode():
            got = tmodel.prefill_cb(tparams, _t(toks), tpools, _t(pt), _t(slots), _t(starts),
                                    _t(lengths), page_size=PS, chunked=True, active=_t(active))
        assert _rel(want, got) <= 1e-5, start
    lens = np.array([21, 19], np.int32)
    tok = np.array([[3], [4]], np.int32)
    want, _ = model.decode_cb(params, jnp.asarray(tok), pools, jnp.asarray(pt),
                              jnp.asarray(lens), jnp.asarray(active), page_size=PS)
    with torch.inference_mode():
        got = tmodel.decode_cb(tparams, _t(tok), tpools, _t(pt), _t(lens), _t(active),
                               page_size=PS)
    assert _rel(want, got) <= 1e-5


# -- gemma2: the window, the embedding scale, the final softcap ---------------------------

def test_gemma_local_layers_bind_past_the_window():
    """A 24-token prompt and decode steps past gemma SMOKE's window (16):
    the port follows the reference, and a copy of the model whose local
    layers see the whole sequence (window 10^6) gives other logits, so the
    window binds. The ring-buffer path (static batch) too: its local layers
    hold a 16-token ring, as the reference allocates it."""
    model, params, tmodel, tparams = _models("gemma2-2b")
    assert [c.window for c in tmodel.layer_cfgs] == [16, None]
    assert tmodel.kinds == ["attn_local", "attn"]
    wide = Transformer(dataclasses.replace(tmodel.cfg, sliding_window=10 ** 6),
                       engine=tmodel.engine, device="cpu")
    toks = np.random.default_rng(3).integers(0, 256, (2, 24)).astype(np.int32)
    with torch.no_grad():
        local = tmodel.logits(tparams, tmodel.forward(tparams, {"tokens": _t(toks).long()})[0])
        glob = wide.logits(tparams, wide.forward(tparams, {"tokens": _t(toks).long()})[0])
    assert float((local[:, :16] - glob[:, :16]).abs().max()) == 0.0
    assert float((local[:, 16:] - glob[:, 16:]).abs().max()) > 1e-2

    cache = model.init_cache(2, 32)
    tcache = tmodel.init_cache(2, 32)
    assert [c["k"].shape[1] for c in tcache["layers"]] == [16, 32]
    want, cache = model.prefill(params, {"tokens": jnp.asarray(toks)}, cache)
    with torch.inference_mode():
        got = tmodel.prefill(tparams, {"tokens": _t(toks)}, tcache)
    assert _rel(want, got) <= 1e-5
    for _ in range(3):
        tok = np.asarray(want).argmax(-1).astype(np.int32)
        want, cache = model.decode_step(params, jnp.asarray(tok), cache)
        with torch.inference_mode():
            got = tmodel.decode_step(tparams, _t(tok), tcache)
        assert _rel(want, got) <= 1e-5


@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8", "tpu_bf16"])
def test_gemma_embedding_scale_matches_reference(policy):
    """gemma's rows times sqrt(d_model) in the compute format, bit for bit;
    other models' rows unscaled."""
    model, params, tmodel, tparams = _models("gemma2-2b", policy)
    toks = np.arange(12, dtype=np.int32).reshape(2, 6) * 17
    want = np.asarray(model.embed(params, jnp.asarray(toks)).astype(jnp.float32))
    got = tmodel.embed(tparams, _t(toks).long())
    assert got.dtype == tmodel.policy.compute
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert tmodel.embed_scale == 8.0
    assert _models("chatglm3-6b")[2].embed_scale == 1.0


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_embed_scale_is_the_configs_own(arch, smoke):
    """The reference scales the embeddings when "gemma" is in the name; the
    port's configs carry that as ``embed_scale``, set exactly where the
    reference's rule fires, and a renamed config keeps its own."""
    cfg = tget_config(arch, smoke=smoke)
    assert cfg.embed_scale == ("gemma" in get_config(arch, smoke=smoke).name)
    renamed = dataclasses.replace(cfg, name="renamed", n_layers=1, d_model=64, n_heads=4,
                                  n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=32,
                                  n_experts=min(cfg.n_experts, 4),
                                  top_k=min(cfg.top_k, 2))
    model = tbuild(renamed, device="cpu")
    assert model.embed_scale == (8.0 if cfg.embed_scale else 1.0)


def test_final_softcap_matches_reference():
    """gemma's logits: the tied table's product in fp32, capped at 30 by
    cap * tanh(x / cap), within 1e-6 of max|logit| (the fp32 product sums
    in torch's order; read 2.5e-7); the cap binds on these inputs (|x| up
    to 60 before it). The cap alone is the compiled reference's bit for bit
    (x times cap's fp32 reciprocal, XLA's tanh), and within an ulp of the
    reference's op-by-op division."""
    model, params, tmodel, tparams = _models("gemma2-2b")
    h = np.random.default_rng(4).standard_normal((2, 3, 64)).astype(np.float32) * 300
    want = np.asarray(model.logits(params, jnp.asarray(h)))
    got = tmodel.logits(tparams, _t(h))
    raw = torch.from_numpy(h) @ tparams["embed"]["table"].T
    assert float(raw.abs().max()) > 30 and float(got.abs().max()) < 30
    assert _rel(want, got) <= 1e-6
    x = np.linspace(-200, 200, 4001, dtype=np.float32)
    np.testing.assert_allclose(common.softcap(_t(x), 30.0).numpy(),
                               np.asarray(jcommon.softcap(jnp.asarray(x), 30.0)),
                               rtol=2.4e-7, atol=4e-6)
    np.testing.assert_array_equal(common.softcap(_t(x), 30.0).numpy(),
                                  np.asarray(jax.jit(lambda a: jcommon.softcap(a, 30.0))(x)))
    xt = _t(x)
    assert common.softcap(xt, None) is xt


# -- gelu and the FFN kinds ---------------------------------------------------------

_DTYPES = {"fp32": (torch.float32, jnp.float32), "fp16": (torch.float16, jnp.float16),
           "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_gelu_matches_jax_tanh_gelu(dtype):
    tdt, jdt = _DTYPES[dtype]
    rng = np.random.default_rng(5)
    grid = np.concatenate([rng.standard_normal(50000).astype(np.float32) * 3,
                           np.linspace(-12, 12, 20001, dtype=np.float32)])
    xj = jnp.asarray(grid).astype(jdt)
    x32 = np.array(xj.astype(jnp.float32))  # the grid in the tested format
    got = common.gelu(torch.from_numpy(x32).to(tdt)).float().numpy()
    compiled = np.asarray(jax.jit(jcommon.gelu)(xj).astype(jnp.float32))
    eager = np.asarray(jcommon.gelu(xj).astype(jnp.float32))
    if tdt == torch.float32:
        # XLA's tanh and its fused 0.044715 x^3 + x, as compiled: bit for
        # bit; op by op (no fused multiply-add) within an ulp or so.
        np.testing.assert_array_equal(got, compiled)
        np.testing.assert_allclose(got, eager, rtol=1.2e-7, atol=1e-6)
        return
    np.testing.assert_array_equal(got, compiled)
    # Op by op, fp16 rounds 0.044715 x^3 before the add: the tanh's input
    # moves by an ulp, which 1 + tanh (near 0 for x < -2) magnifies; the
    # difference stays within |x| 2^-10 (measured |x| 2^-10.16), in 0.4% of
    # the elements.
    bound = np.abs(x32) * 2.0 ** -10 if tdt == torch.float16 else 0.0
    assert (np.abs(got - eager) <= bound).all()
    assert (got != eager).mean() < (0.005 if tdt == torch.float16 else 1e-12)


_FFN_POLICIES = {"fp32": "fp32", "fp16": "redmule_fp16", "bf16": "tpu_bf16"}


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("kind", ["geglu", "gelu", "relu"])
def test_ffn_kinds_match_reference(kind, dtype):
    """``ffn.apply`` of each kind the port gained against the reference's,
    compiled as its layers are, on the reference's parameters (fp32, fp16
    and bf16 compute). The ungated kinds have no ``gate``."""
    tdt, jdt = _DTYPES[dtype]
    policy = _FFN_POLICIES[dtype]
    p = jffn.init(jax.random.PRNGKey(7), 64, 128, kind, jdt)
    x = jnp.asarray(np.random.default_rng(6).standard_normal((2, 5, 64)) * 2).astype(jdt)
    want = np.asarray(jax.jit(lambda p, x: jffn.apply(p, x, kind, JEngine(policy=policy)))(p, x)
                      .astype(jnp.float32))
    tp = {n: {"w": tensor_from_numpy(np.asarray(w["w"]))} for n, w in p.items()}
    assert ("gate" in tp) == (kind == "geglu")
    with torch.no_grad():
        got = ffn.apply(tp, tensor_from_numpy(np.asarray(x)), kind,
                        Engine(policy=policy, backend="torch"))
    assert got.dtype == tdt
    got = got.float().numpy()
    if tdt == torch.float32:
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        # One ulp of the format at the output's scale (order of the GEMM sums).
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - (10 if dtype == "fp16" else 7))
        assert np.abs(got - want).max() <= ulp


def test_unknown_ffn_kind_raises():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        ffn.init(gen, 8, 16, torch.float32, "cpu", kind="swish")
    p = ffn.init(gen, 8, 16, torch.float32, "cpu", kind="relu")
    assert set(p) == {"up", "down"}
    with pytest.raises(ValueError):
        ffn.apply(p, torch.zeros(1, 8), "swish", Engine(policy="fp32", backend="torch"))


# -- params_from_jax ------------------------------------------------------------------

def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]).numpy()


def test_params_from_jax_maps_units_and_remainder():
    """A 3-layer gemma SMOKE is one ('attn_local', 'attn') unit and one
    remainder layer (kind 'attn_local'): units.b0 -> layer 0, units.b1 ->
    layer 1, rem.r0 -> layer 2, bit for bit; geglu keeps its gate; the
    three-layer port's forward follows the reference's."""
    model, params, tmodel, tparams = _models("gemma2-2b", n_layers=3)
    dec = params["decoder"]
    assert len(dec["rem"]) == 1 and tmodel.kinds == ["attn_local", "attn", "attn_local"]
    sources = [(dec["units"]["b0"], 0), (dec["units"]["b1"], 0), (dec["rem"]["r0"], None)]
    assert len(tparams["layers"]) == 3
    for layer, (src, u) in zip(tparams["layers"], sources):
        for path in (("attn", "q"), ("attn", "o"), ("ffn", "gate"), ("ffn", "up"),
                     ("ffn", "down")):
            w = np.asarray(src[path[0]][path[1]]["w"])
            w = w if u is None else w[u]
            np.testing.assert_array_equal(layer[path[0]][path[1]]["w"].numpy(), w)
    assert "head" not in tparams
    toks = np.random.default_rng(1).integers(0, 256, (1, 20)).astype(np.int32)
    want = np.asarray(model.logits(params, model.forward(params, {"tokens": jnp.asarray(toks)})[0]))
    with torch.no_grad():
        got = tmodel.logits(tparams, tmodel.forward(tparams, {"tokens": _t(toks).long()})[0])
    assert _rel(want, got) <= 1e-5


@pytest.mark.parametrize("fp8_params", [False, True])
def test_params_from_jax_carries_the_untied_head(fp8_params):
    """chatglm's head (d, V) bit for bit, K-major when stored in E4M3 (as
    every fp8 weight of the port); the port's own init makes the same
    structure, formats and shapes."""
    _, params, tmodel, tparams = _models("chatglm3-6b", "redmule_hfp8", "e4m3",
                                         fp8_params=fp8_params)
    want = np.asarray(params["head"]["w"])
    head = tparams["head"]["w"]
    assert head.shape == (64, 256)
    np.testing.assert_array_equal(_bits(head), want.view(_bits(head).dtype))
    assert (head.stride(0) == 1) == fp8_params
    own = tmodel.init(0)
    assert sorted(own) == sorted(tparams) == ["embed", "final_norm", "head", "layers"]
    assert own["head"]["w"].dtype == head.dtype and own["head"]["w"].shape == head.shape
    assert "gate" in own["layers"][0]["ffn"]


# -- training ----------------------------------------------------------------------------

LR = 1e-3


@pytest.mark.parametrize("policy,remat", [("fp32", "none"), ("redmule_hfp8", "block")])
def test_chatglm_train_steps_match_reference(policy, remat):
    """One and two AdamW steps of chatglm3-6b SMOKE from the reference's
    parameters on the same batches, at the bounds of
    tests/test_torch_training.py (fp32: loss and grad norm to 1e-5, every
    parameter to 2e-5; redmule_hfp8: the first loss to 1e-5, the grad norm
    to 5e-2, the update to 0.3 in relative norm). The untied head's two
    backward GEMMs run through the engine like every weight's."""
    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True), policy=policy, remat=remat)
    tcfg = dataclasses.replace(tget_config("chatglm3-6b", smoke=True), policy=policy,
                               remat=remat)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    jopt, opt = JAdamW(lr=LR), AdamW(lr=LR)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, jopt.init(params),
                         jnp.zeros((), jnp.int32))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    state = TrainState(0, tparams, opt.init(tparams), 0)
    jstep = jax.jit(jmake_train_step(model, jopt))
    step = make_train_step(tbuild(tcfg, device="cpu"), opt)
    data = jfor_model(cfg, seq_len=16, global_batch=4)
    start = leaves(state.params)
    for i in range(2):
        batch = data.batch(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert state.step == int(jstate.step) == i + 1 and state.skipped == 0
        want = leaves(params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg))
        got = leaves(state.params)
        loss_rel = abs(float(jm["loss"]) - float(m["loss"])) / abs(float(jm["loss"]))
        gn_rel = abs(float(jm["grad_norm"]) - float(m["grad_norm"])) / float(jm["grad_norm"])
        if policy == "fp32":
            assert loss_rel < 1e-5 and gn_rel < 1e-5
            for w, g in zip(want, got):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5)
            continue
        assert loss_rel < (1e-5 if i == 0 else 2e-3)
        assert gn_rel < 5e-2
        dj = torch.cat([(w.float() - s.float()).ravel() for w, s in zip(want, start)])
        dt = torch.cat([(g.float() - s.float()).ravel() for g, s in zip(got, start)])
        assert float((dj - dt).norm() / dj.norm()) < 0.3


def test_train_launcher_trains_gemma_and_refuses_moe():
    """gemma2 and phi3.5-moe train through the launcher, phi also with
    expert parallelism (``--moe-impl ep``, on a mesh of one: ``apply_ep``
    with every expert; at 2 x 8 tokens the capacity, 16 rows, drops
    nothing, so its first loss is the dense layer's within 1e-3 relative:
    the gates weight the rows in fp32 there, in the compute format in the
    dense layer). What the model refuses is an MoE implementation neither
    package has."""
    import dataclasses

    from repro_torch.launch import train as ttrain

    for arch in ("gemma2-2b", "phi3.5-moe-42b-a6.6b"):
        args = ttrain.parse_args(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                                  "--seq", "24", "--batch", "2", "--log-every", "1"])
        out = ttrain.train(args)
        assert len(out["history"]) == 2
        assert all(np.isfinite(h["loss"]) for h in out["history"])
    first = {}
    for impl in ("ep", "dense"):
        args = ttrain.parse_args(["--arch", "phi3.5-moe-42b-a6.6b", "--smoke", "--device", "cpu",
                                  "--steps", "1", "--seq", "8", "--batch", "2", "--moe-impl",
                                  impl])
        first[impl] = ttrain.train(args)["history"][0]["loss"]
    assert np.isfinite(first["ep"])
    assert abs(first["ep"] - first["dense"]) <= 1e-3 * abs(first["dense"])
    cfg = dataclasses.replace(tget_config("phi3.5-moe-42b-a6.6b", smoke=True), moe_impl="alltoall")
    with pytest.raises(ValueError, match="unknown MoE impl"):
        tbuild(cfg, device="cpu")


# -- the server ---------------------------------------------------------------------------

_PROMPTS = [[3, 5, 7, 9, 3, 5, 7, 9, 3, 5, 7, 9, 3, 5, 7, 9, 3, 5],
            [11, 4, 11, 4, 11, 4, 2, 8, 11, 4, 11, 4, 2, 8, 11, 4, 11],
            [1, 2, 3, 4, 5, 6, 7, 8]]


@pytest.mark.parametrize("arch", ["gemma2-2b", "phi3.5-moe-42b-a6.6b"])
def test_server_greedy_chain_matches_reference(arch):
    """Greedy tokens through the port's Server (whole-prompt prefill, then
    chunked at 4 with batched prefill) and through speculative decoding
    with the n-gram drafter equal the reference's static greedy chain, past
    gemma's window; gemma's profile has no window (its layers alternate),
    so its pages are kept, as the reference's are."""
    model, params, tmodel, tparams = _models(arch)
    assert tmodel.cb_profile().kv_window is None
    refs = [jgenerate_static(model, params, {"tokens": np.asarray([p], np.int32)},
                             max_new_tokens=12)[0][0].tolist() for p in _PROMPTS]
    base = dict(num_slots=2, page_size=4, max_seq_len=48)
    for kw in ({}, {"config": {"prefill_chunk": 4, "prefill_batch": True}},
               {"spec": SpecConfig(k=3, ngram_n=3)}):
        server = Server(tmodel, tparams, ServerConfig(**{**base, **kw.pop("config", {})}),
                        device="cpu", **kw)
        reqs = [server.submit(p, max_new_tokens=12) for p in _PROMPTS]
        server.run()
        for req, ref in zip(reqs, refs):
            assert req.out_tokens == ref, (kw, req.rid)
        assert server.cache.allocator.num_held == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_takes_the_new_archs(arch, capsys):
    from repro_torch.launch import serve

    server, results = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                                  "--requests", "2", "--prompt-len", "6", "--max-new", "3",
                                  "--num-slots", "2", "--page-size", "4"])
    assert len(results) == 2 and all(r.num_generated == 3 for r in results.values())
    assert server.model.cfg.name == tget_config(arch, smoke=True).name
    assert "continuous: 2 requests" in capsys.readouterr().out
