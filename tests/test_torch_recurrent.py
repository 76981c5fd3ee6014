"""The port's recurrent families against the JAX package's, on the CPU:
recurrentgemma-2b (RG-LRU with windowed local attention, MQA) and
xlstm-125m (mLSTM and sLSTM, no attention), each at SMOKE size.

Parameters come from the reference's ``init`` through ``params_from_jax``;
inputs are numpy draws from fixed seeds. The reference runs jitted (its
compiled rounding order) on its XLA backend, and on ``pallas_interpret``
for one case a family; the port runs its plain backend.

Tolerances, and why:

- the RG-LRU scan, bit for bit: the port follows ``associative_scan``'s
  odd/even tree and contracts each ``a2 b1 + b2`` into one fused
  multiply-add, as XLA's compiled CPU code does; the width-4 convolution's
  sum contracts likewise in fp32 and fp16, so it matches bit for bit too;
- the sLSTM cell's output and state, bit for bit under both policies: the
  port's plain path evaluates XLA's compiled exp, log1p, tanh and logistic
  (``models/common.py``) and contracts the state update's multiply-adds as
  XLA's compiled scan does;
- the RG-LRU cell's output and state, bit for bit under both policies:
  its gates evaluate XLA's compiled logistic, exp and softplus
  (``models/common.py``; read 1.1e-7 of the max with torch's before);
- the mLSTM cell's output and state, and the logits, under fp32: 1e-5 of
  the max (read: up to 3.4e-6). The mLSTM's einsums (``q C`` through the
  engine's fp32 GEMM), its normaliser's sum and ``cumsum`` sum in another
  order than XLA's;
- under redmule_hfp8 (E4M3 pages): outputs and logits bit for bit (read:
  0 at every case here). Every engine product is exact and both sides
  round its fp32 sum once to fp16; the fp32 ulps of the gates and state
  sums stay below the 16-bit outputs' rounding at these seeds. The fp32
  state rows under hfp8 keep the fp32 bound;
- token streams: equal, greedy, in fp32.
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
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.serving import generate_static as jgenerate_static  # noqa: E402
from repro.training import TrainState as JTrainState  # noqa: E402
from repro.training import make_paged_serve_steps  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import common, rglru, xlstm  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serving import Server, ServerConfig, SpecConfig, generate_static  # noqa: E402

ARCHS = ["recurrentgemma-2b", "xlstm-125m"]
FP32_TOL = 1e-5
TOL = {"fp32": FP32_TOL, "redmule_hfp8": 0.0}


def _kw(policy):
    return dict(policy=policy, kv_cache_dtype="fp32" if policy == "fp32" else "e4m3")


@functools.lru_cache(maxsize=None)
def _models(arch, policy="fp32", backend="xla", n_layers=None):
    """The reference on ``backend`` and the port's plain model (the paged
    decode's plain version where the reference runs its Pallas kernel), on
    the reference's parameters."""
    kw = _kw(policy)
    if n_layers is not None:
        kw["n_layers"] = n_layers
    cfg = dataclasses.replace(get_config(arch, smoke=True), backend=backend, **kw)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), **kw)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tmodel = Transformer(tcfg, engine=Engine(policy=policy, backend="torch"), device="cpu",
                         fused_decode=backend != "xla")
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the cells ----------------------------------------------------------------------------

_CELLS = {
    "rglru": (jrglru.init, jrglru.apply_scan, jrglru.apply_decode, jrglru.RGLRUConfig(64, 64),
              rglru.apply_scan, rglru.apply_decode),
    "mlstm": (jxlstm.mlstm_init, jxlstm.mlstm_apply, jxlstm.mlstm_decode,
              jxlstm.XLSTMConfig(64, 4), xlstm.mlstm_apply, xlstm.mlstm_decode),
    "slstm": (jxlstm.slstm_init, jxlstm.slstm_apply, jxlstm.slstm_decode,
              jxlstm.XLSTMConfig(64, 4), xlstm.slstm_apply, xlstm.slstm_decode),
}


def _cell_params(p):
    return {k: {"w": tensor_from_numpy(np.asarray(v["w"]))} if isinstance(v, dict)
            else tensor_from_numpy(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
@pytest.mark.parametrize("cell", list(_CELLS))
def test_cell_matches_reference(cell, policy):
    """A scan over 16 positions from a zero-input warm state, with rows of
    16 and 9 valid tokens (the pad steps must leave the state, and
    rglru's conv state is gathered at each row's boundary), then one
    decode step from the scan's state."""
    tols = (0.0, 0.0) if cell in ("slstm", "rglru") else (TOL[policy], FP32_TOL)
    _check_cell(cell, policy, *tols)


@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
def test_rglru_cell_card_formulas_match_reference(policy):
    """The RG-LRU cell as the card runs it (torch's logistic, exp and
    softplus: ``common.torch_rounding``), at the bounds it was held to
    before its gates took XLA's rounding: outputs within ``TOL``, the
    state within 1e-5 of the max (read 1.1e-7 under fp32)."""
    with common.torch_rounding():
        _check_cell("rglru", policy, TOL[policy], FP32_TOL)


def _check_cell(cell, policy, out_tol, state_tol):
    jinit, japply, jdecode, ccfg, apply, decode = _CELLS[cell]
    dt, ndt = (jnp.float32, np.float32) if policy == "fp32" else (jnp.float16, np.float16)
    je, te = JEngine(policy=policy, backend="xla"), Engine(policy=policy, backend="torch")
    p = jinit(jax.random.PRNGKey(0), ccfg, dtype=dt)
    tp = _cell_params(p)
    rng = np.random.default_rng(3)
    x0, x, xd = (rng.standard_normal((2, n, 64)).astype(ndt) for n in (16, 16, 1))
    lens = np.array([16, 9], np.int32)
    state0 = jax.tree.map(np.asarray, jax.jit(lambda p, x: japply(p, x, ccfg, je)[1])(p, x0))
    y, st = jax.jit(lambda p, x, s, n: japply(p, x, ccfg, je, state=s, lengths=n))(
        p, x, state0, lens)
    ty, tst = apply(tp, _t(x), ccfg, te, state=jax.tree.map(_t, state0), lengths=_t(lens))
    assert _rel(y, ty) <= out_tol
    for k in st:
        assert _rel(st[k], tst[k]) <= state_tol, k
    st = jax.tree.map(np.asarray, st)
    yd, std = jax.jit(lambda p, x, s: jdecode(p, x, s, ccfg, je))(p, xd, st)
    tyd, tstd = decode(tp, _t(xd), jax.tree.map(_t, st), ccfg, te)
    assert _rel(yd, tyd) <= out_tol
    for k in std:
        assert _rel(std[k], tstd[k]) <= state_tol, k


def test_associative_scan_is_the_references_bit_for_bit():
    """The odd/even tree with the fused combine against the compiled
    ``jax.lax.associative_scan``, at an odd length (37) and a power of two
    (64)."""
    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    rng = np.random.default_rng(0)
    for n in (37, 64):
        a = rng.uniform(0.5, 1.0, (2, n, 32)).astype(np.float32)
        b = rng.standard_normal((2, n, 32)).astype(np.float32)
        want = jax.jit(lambda a, b: jax.lax.associative_scan(combine, (a, b), axis=1)[1])(a, b)
        np.testing.assert_array_equal(rglru.associative_scan(_t(a), _t(b)).numpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_causal_conv_is_the_references_bit_for_bit(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 64)).astype(dtype)
    w = rng.standard_normal((4, 64)).astype(dtype)
    state = rng.standard_normal((2, 3, 64)).astype(np.float32)
    for s in (None, state):
        want = jax.jit(lambda x, w, s: jrglru._causal_conv(x, w, s))(x, w, s)
        got = rglru._causal_conv(_t(x), _t(w), None if s is None else _t(s))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32))


def test_mlstm_chunk_rule_raises_as_the_reference():
    """min(256, S) must divide S: a 288-token unchunked prompt (bucket 32)
    raises in both packages."""
    ccfg = jxlstm.XLSTMConfig(64, 4)
    p = jxlstm.mlstm_init(jax.random.PRNGKey(0), ccfg, dtype=jnp.float32)
    x = np.zeros((1, 288, 64), np.float32)
    with pytest.raises(ValueError, match="not divisible by chunk 256"):
        jxlstm.mlstm_apply(p, jnp.asarray(x), ccfg, JEngine(policy="fp32", backend="xla"))
    with pytest.raises(ValueError, match="not divisible by chunk 256"):
        xlstm.mlstm_apply(_cell_params(p), _t(x), ccfg, Engine(policy="fp32", backend="torch"))


def test_mlstm_gradient_stays_finite_over_a_full_chunk():
    """A 256-token chunk: the same outputs as the reference (fp32 bound),
    and finite gradients, where the reference's are NaN (its
    where(tri, exp(logw), 0) overflows above the diagonal and the backward
    multiplies 0 by inf; the port masks before the exp)."""
    ccfg = jxlstm.XLSTMConfig(64, 4)
    je, te = JEngine(policy="fp32", backend="xla"), Engine(policy="fp32", backend="torch")
    p = jxlstm.mlstm_init(jax.random.PRNGKey(0), ccfg, dtype=jnp.float32)
    x = np.random.default_rng(4).standard_normal((1, 256, 64)).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jxlstm.mlstm_apply(p, x, ccfg, je)[0], jnp.asarray(x))
    assert not np.isfinite(np.asarray(vjp(jnp.ones_like(want))[0])).all()
    tx = _t(x).requires_grad_()
    got = xlstm.mlstm_apply(_cell_params(p), tx, ccfg, te)[0]
    got.sum().backward()
    assert _rel(want, got.detach()) <= FP32_TOL
    assert torch.isfinite(tx.grad).all()


# -- the training forward and steps ----------------------------------------------------------

# (policy, reference backend); recurrentgemma at 5 layers and xlstm at 3
# (one stacked unit and the remainder layers).
FORWARD_CASES = [("fp32", "xla"), ("redmule_hfp8", "xla"), ("fp32", "pallas_interpret")]
DEPTH = {"recurrentgemma-2b": 5, "xlstm-125m": 3}


@pytest.mark.parametrize("policy,backend", FORWARD_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, policy, backend):
    model, params, tmodel, tparams = _models(arch, policy, backend, DEPTH[arch])
    toks = np.random.default_rng(1).integers(0, model.cfg.vocab_size, (2, 24)).astype(np.int32)
    h, aux = jax.jit(lambda p, t: model.forward(p, {"tokens": t}))(params, toks)
    want = np.asarray(model.logits(params, h))
    with torch.no_grad():
        th, taux = tmodel.forward(tparams, {"tokens": _t(toks).long()})
        got = tmodel.logits(tparams, th)
    assert got.shape == want.shape and float(aux) == float(taux) == 0.0
    assert _rel(want, got) <= TOL[policy]


LR = 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Two AdamW steps under fp32 with remat block, from the reference's
    parameters on the same batches: loss and grad norm to 1e-5 relative,
    every parameter to 2e-5 (the bounds of the dense decoders' tests),
    the gradients through the scans included."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), policy="fp32", remat="block")
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), policy="fp32", remat="block")
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    jopt, opt = JAdamW(lr=LR), AdamW(lr=LR)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, jopt.init(params),
                         jnp.zeros((), jnp.int32))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    from repro_torch.training import TrainState, make_train_step

    state = TrainState(0, tparams, opt.init(tparams), 0)
    jstep = jax.jit(jmake_train_step(model, jopt))
    step = make_train_step(tbuild(tcfg, device="cpu"), opt)
    data = jfor_model(cfg, seq_len=16, global_batch=2)
    for i in range(2):
        batch = data.batch(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert abs(float(jm["loss"]) - float(m["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(float(jm["grad_norm"]) - float(m["grad_norm"])) <= 1e-5 * float(
            jm["grad_norm"])
        want = leaves(params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg))
        for w, g in zip(want, leaves(state.params)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5)


# -- the serving entry points: state rows ---------------------------------------------------

PS, CHUNK = 4, 4


def _state_rows(arch, tmodel, pools, slot):
    """The reference's state rows of ``slot`` by port layer: unit u's layer
    j (stacked on a leading axis) is layer u * len(pattern) + j, then the
    remainder layers."""
    pattern = tmodel.pattern
    rows = {}
    for j in range(len(pattern)):
        st = pools["units"][f"b{j}"].get("state")
        for u in range(0 if st is None else next(iter(st.values())).shape[0]):
            rows[u * len(pattern) + j] = {k: np.asarray(v[u, slot]) for k, v in st.items()}
    n = tmodel.cfg.n_layers - len(pools["rem"])
    for i in range(len(pools["rem"])):
        st = pools["rem"][f"r{i}"].get("state")
        if st is not None:
            rows[n + i] = {k: np.asarray(v[slot]) for k, v in st.items()}
    return rows


def _same_rows(arch, tmodel, pools, tpools, slots, bound):
    for slot in slots:
        want = _state_rows(arch, tmodel, pools, slot)
        assert want and sorted(want) == [i for i, p in enumerate(tpools) if "state" in p]
        for i, leaves_ in want.items():
            for k, v in leaves_.items():
                assert _rel(v, tpools[i]["state"][k][slot]) <= bound, (slot, i, k)


@pytest.mark.parametrize("arch,backend", [("recurrentgemma-2b", "xla"),
                                          ("recurrentgemma-2b", "pallas_interpret"),
                                          ("xlstm-125m", "xla")])
def test_state_rows_after_prefill_and_decode_match_reference(arch, backend):
    """Slot 0's 18-token prompt prefilled serially in chunks of 4, slot 1's
    7 tokens whole; then both prompts again on fresh pools in (2, 4)
    batched steps (slot 1 a pad row once done); three decode steps of both
    slots; then slot 0 recycled: a new prompt from position 0 must reset
    its rows. Logits and every state row against the reference's
    ``make_paged_serve_steps`` after each phase (recurrentgemma's window of
    16 binds past position 16). On ``pallas_interpret`` the reference's
    decode runs its Pallas kernel and the port its plain version."""
    model, params, tmodel, tparams = _models(arch, "fp32", backend)
    full, chunk, batch, decode = map(jax.jit, make_paged_serve_steps(model, page_size=PS))
    v = model.cfg.vocab_size
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, v, n).astype(np.int32) for n in (18, 7, 6)]
    page_rows = np.array([[1, 2, 3, 4, 5, 6, 0, 0], [7, 8, 9, 10, 11, 12, 0, 0]], np.int32)
    pairs = []

    def run(j, tj, args, targs):
        out, pools = j(params, *args)
        with torch.inference_mode():
            got = tj(*targs)
        pairs.append((np.asarray(out), got))
        return pools

    def serial(pools, tpools, prompt, slot):
        for s0 in range(0, len(prompt), CHUNK):
            n = min(CHUNK, len(prompt) - s0)
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :n] = prompt[s0:s0 + n]
            pools = run(chunk, lambda *a: tmodel.prefill_cb(*a, page_size=PS, chunked=True),
                        (jnp.asarray(toks), pools, page_rows[slot], slot, s0, n),
                        (tparams, _t(toks).long(), tpools, _t(page_rows[slot]), slot, s0, n))
        return pools

    pools, tpools = model.init_state_store(2, 13, PS), tmodel.init_state_store(2, 13, PS)
    pools = serial(pools, tpools, prompts[0], 0)
    toks = np.zeros((1, 8), np.int32)
    toks[0, :7] = prompts[1]
    pools = run(full, lambda *a: tmodel.prefill_cb(*a, page_size=PS),
                (jnp.asarray(toks), pools, page_rows[1], 1, 0, 7),
                (tparams, _t(toks).long(), tpools, _t(page_rows[1]), 1, 0, 7))
    _same_rows(arch, tmodel, pools, tpools, (0, 1), FP32_TOL)
    pools, tpools = model.init_state_store(2, 13, PS), tmodel.init_state_store(2, 13, PS)
    for s0 in range(0, 20, CHUNK):
        lens = np.array([max(0, min(CHUNK, len(p) - s0)) for p in prompts[:2]], np.int32)
        toks = np.zeros((2, CHUNK), np.int32)
        for r, p in enumerate(prompts[:2]):
            toks[r, :lens[r]] = p[s0:s0 + lens[r]]
        slots, starts, active = np.array([0, 1], np.int32), np.full(2, s0, np.int32), lens > 0
        pools = run(batch, lambda *a: tmodel.prefill_cb(*a, page_size=PS, chunked=True,
                                                        active=_t(active)),
                    (jnp.asarray(toks), pools, page_rows, slots, starts, lens, active),
                    (tparams, _t(toks).long(), tpools, _t(page_rows), _t(slots), _t(starts),
                     _t(lens)))
    _same_rows(arch, tmodel, pools, tpools, (0, 1), FP32_TOL)
    seq = np.array([18, 7], np.int32)
    tok = np.array([[3], [5]], np.int32)
    active = np.array([True, True])
    for _ in range(3):
        pools = run(decode, lambda *a: tmodel.decode_cb(*a, page_size=PS),
                    (jnp.asarray(tok), pools, page_rows, seq, active),
                    (tparams, _t(tok).long(), tpools, _t(page_rows), _t(seq), _t(active)))
        tok = np.argmax(pairs[-1][0], -1).astype(np.int32)[:, None]
        seq = seq + 1
    _same_rows(arch, tmodel, pools, tpools, (0, 1), FP32_TOL)
    pools = serial(pools, tpools, prompts[2], 0)
    _same_rows(arch, tmodel, pools, tpools, (0, 1), FP32_TOL)
    for want, got in pairs:
        assert torch.isfinite(got).all()
        assert _rel(want, got) <= FP32_TOL


def test_recycled_slot_forgets_its_request():
    """A start-0 prefill into a used slot gives the state rows a fresh
    slot gets: the recycled rows equal a fresh store's, bit for bit."""
    _, _, tmodel, tparams = _models("xlstm-125m")
    prompt = _t(np.random.default_rng(2).integers(0, 256, (1, 8))).long()
    pr = torch.zeros(8, dtype=torch.int32)
    used, fresh = (tmodel.init_state_store(2, 3, PS) for _ in range(2))
    with torch.inference_mode():
        tmodel.prefill_cb(tparams, prompt.flip(1), used, pr, 1, 0, 8, page_size=PS)
        a = tmodel.prefill_cb(tparams, prompt, used, pr, 1, 0, 8, page_size=PS)
        b = tmodel.prefill_cb(tparams, prompt, fresh, pr, 1, 0, 8, page_size=PS)
    assert torch.equal(a, b)
    for pu, pf in zip(used, fresh):
        for k in pu["state"]:
            assert torch.equal(pu["state"][k], pf["state"][k]), k


# -- the server -----------------------------------------------------------------------------

def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab, size=n)) for n in lens]


@pytest.mark.parametrize("chunk", [4, None])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_matches_static_greedy(arch, chunk):
    """The reference's ``_cb_vs_static`` shapes (prompts of 5, 11, 7 and 9
    tokens, 6, 3, 8 and 5 new, 2 slots, pages of 4), chunked at 4 and
    whole: the port's Server and the port's static batch give the same
    greedy tokens in fp32, and (once) the reference's static batch too. xlstm holds no KV
    bytes and reserves no pages."""
    model, params, tmodel, tparams = _models(arch)
    prompts = _prompts(model.cfg.vocab_size, (5, 11, 7, 9))
    gens = (6, 3, 8, 5)
    server = Server(tmodel, tparams, ServerConfig(
        num_slots=2, page_size=4, max_seq_len=24, prefill_bucket=8, prefill_chunk=chunk),
        device="cpu")
    reqs = [server.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    results = server.run()
    for p, g, r in zip(prompts, gens, reqs):
        own, _ = generate_static(tmodel, tparams, {"tokens": torch.tensor([p])},
                                 max_new_tokens=g)
        assert results[r.rid].out_tokens == list(own[0]), len(p)
        if chunk is not None:
            ref, _ = jgenerate_static(model, params, {"tokens": jnp.asarray([p], jnp.int32)},
                                      max_new_tokens=g)
            assert list(own[0]) == list(ref[0]), len(p)
    assert server.cache.allocator.num_held == 0 and server.stats.nonfinite_steps == 0
    assert server.cache.state_bytes() > 0
    if arch == "xlstm-125m":
        assert server.cache.kv_bytes() == 0
        assert server.scheduler.worst_pages(24) == 0


def test_window_recycling_keeps_held_pages_within_the_reservation():
    """recurrentgemma (window 16) generating past its window with chunked
    prefill: out-of-window pages go back to the pool mid-request, the pages
    held never exceed the windowed reservation (window + chunk + 2 pages),
    and the tokens equal the reference's static batch."""
    model, params, tmodel, tparams = _models("recurrentgemma-2b")
    server = Server(tmodel, tparams, ServerConfig(
        num_slots=1, page_size=4, max_seq_len=64, prefill_bucket=8, prefill_chunk=8),
        device="cpu")
    (prompt,) = _prompts(model.cfg.vocab_size, (30,), seed=2)
    req = server.submit(prompt, max_new_tokens=30)
    max_held = 0
    while server.scheduler.has_work():
        server.step()
        max_held = max(max_held, server.cache.allocator.num_held)
    cap = server.scheduler.worst_pages(64)
    assert max_held <= cap < 16
    assert (server.cache.page_table == 0).all() and server.cache.allocator.num_held == 0
    ref, _ = jgenerate_static(model, params, {"tokens": jnp.asarray([prompt], jnp.int32)},
                              max_new_tokens=30)
    assert server.results[req.rid].out_tokens == list(ref[0])


def test_prefix_cache_turns_itself_off_for_state_rows():
    for arch in ARCHS:
        _, _, tmodel, tparams = _models(arch)
        server = Server(tmodel, tparams, ServerConfig(num_slots=1, page_size=4, max_seq_len=16,
                                                      prefix_cache=True), device="cpu")
        assert not server.prefix_cache and not server.scheduler.prefix_cache
    _, _, gemma, gparams = _models_dense()
    assert Server(gemma, gparams, ServerConfig(num_slots=1, page_size=4, max_seq_len=16,
                                               prefix_cache=True), device="cpu").prefix_cache


@functools.lru_cache(maxsize=None)
def _models_dense():
    tcfg = dataclasses.replace(tget_config("gemma2-2b", smoke=True), **_kw("fp32"))
    tmodel = tbuild(tcfg, device="cpu")
    return None, None, tmodel, tmodel.init(0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cb_profile_equals_the_references(arch):
    """Pages, window and state rows as the reference provisions them, for
    every registered arch (the window read from the attention layers
    alone: recurrentgemma's 2048; none for xlstm, which needs no pages)."""
    want = build(get_config(arch)).cb_profile()
    got = tbuild(tget_config(arch), device="cpu").cb_profile()
    assert tuple(got) == tuple(want)


def test_speculative_decoding_with_state_rows_builds_and_runs_a_round():
    """The servers that raised while speculation over state rows was not
    ported now build and run a round: recurrentgemma as the n-gram target
    (its verifier takes the commit pass), and recurrentgemma as the
    drafter of a dense target of its vocabulary (the drafter snapshots its
    rows). tests/test_torch_spec_state.py holds them to the reference."""
    _, _, tmodel, tparams = _models("recurrentgemma-2b")
    cfg = ServerConfig(num_slots=1, page_size=4, max_seq_len=16)
    _, _, gemma, gparams = _models_dense()
    for server in (Server(tmodel, tparams, cfg, device="cpu", spec=SpecConfig(k=2)),
                   Server(gemma, gparams, cfg, device="cpu", draft_model=tmodel,
                          draft_params=tparams)):
        server.submit([3, 5, 3, 5, 3], max_new_tokens=4)
        (req,) = server.run().values()
        assert req.num_generated == 4 and server.stats.spec_steps > 0
    assert server.verifier.needs_state_commit is False
    assert server.drafter._rows and server.drafter.profile.needs_kv_pages


def test_recurrentgemma_fp8_params_raise_in_both_packages():
    """E4M3 weights: the reference's conv has no promotion of E4M3 with
    fp16 and raises; so does the port."""
    kw = dict(policy="redmule_hfp8", fp8_params=True, kv_cache_dtype="e4m3")
    model = build(dataclasses.replace(get_config("recurrentgemma-2b", smoke=True), **kw))
    params = model.init(jax.random.PRNGKey(0))
    toks = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(Exception, match="float8_e4m3fn"):
        model.forward(params, {"tokens": toks})
    tmodel = tbuild(dataclasses.replace(tget_config("recurrentgemma-2b", smoke=True), **kw),
                    device="cpu")
    with pytest.raises(TypeError, match="fp8_params"):
        tmodel.forward(tmodel.init(0), {"tokens": torch.zeros((1, 8), dtype=torch.int64)})


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve, train

    server, results = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                                  "3", "--prompt-len", "6", "--max-new", "3", "--num-slots",
                                  "2", "--page-size", "4", "--chunked-prefill", "4",
                                  "--prefill-batch", "--prefix-cache"])
    assert len(results) == 3 and all(r.num_generated == 3 for r in results.values())
    assert not server.prefix_cache
    _, seqs = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--mode", "static",
                          "--requests", "2", "--prompt-len", "6", "--max-new", "3"])
    assert seqs.shape == (2, 3)
    out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--seq",
                      "16", "--batch", "2", "--log-every", "1"])
    assert len(out["history"]) == 2 and all(np.isfinite(h["loss"]) for h in out["history"])
    assert "MB state rows" in capsys.readouterr().out
