"""Speculative decoding of the port against the JAX package's
(``tests/test_spec.py`` case by case), on the CPU with the plain path.

The target is granite-3-8b SMOKE and the model drafter granite-moe SMOKE
(vocab 256 both), parameters from the reference's ``init`` copied across
with ``params_from_jax``, everything in fp32 with fp32 pages: there the
port's greedy tokens are the reference's bit for bit (the parity tests of
the serving slices). The load-bearing invariants:

1. the rejection sampler keeps the target's distribution (TV < 0.05 at
   N = 4000 draws, for drafter logits and for deterministic drafts), and
   its greedy decisions are the reference's bit for bit on the same logits;
2. greedy speculative output through the server is the reference's
   non-speculative chain, with the n-gram drafter and the MoE drafter;
3. rollback without snapshots: a drafter whose drafts were rejected gives,
   next round, the same logits bit for bit as one that never drafted over
   the same committed history; no page leaks in either store.

``verify_cb`` logits are held to 1e-5 of max|logit| (fp32, the bound of
``tests/test_torch_model.py``).
"""
import argparse
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import build  # noqa: E402
from repro.serving import Server as JServer  # noqa: E402
from repro.serving import ServerConfig as JServerConfig  # noqa: E402
from repro.serving import SpecConfig as JSpecConfig  # noqa: E402
from repro.serving import filter_logits as jfilter_logits  # noqa: E402
from repro.serving import generate_static as jgenerate_static  # noqa: E402
from repro.serving import speculative_sample as jspeculative_sample  # noqa: E402
from repro.serving.spec import NgramDrafter as JNgramDrafter  # noqa: E402
from repro.serving.spec.policy import effective_k as jeffective_k  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    FINISH_EOS,
    ModelDrafter,
    NgramDrafter,
    SamplingParams,
    Server,
    ServerConfig,
    SpecConfig,
    effective_k,
    filter_logits,
    speculative_sample,
)

FP32 = dict(policy="fp32", kv_cache_dtype="fp32")
CONFIG = dict(num_slots=4, page_size=8, max_seq_len=64)

# Prompts with internal repetition, so that the n-gram drafter fields
# proposals (the reference test's).
_PROMPTS = [
    [3, 5, 7, 9, 3, 5, 7, 9, 3, 5],
    [11, 4, 11, 4, 11, 4, 2],
    [1, 2, 3, 4, 5, 6, 7, 8],
]


def _pair(arch, seed):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **FP32)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), **FP32)
    tmodel = tbuild(tcfg, device="cpu")
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


@pytest.fixture(scope="module")
def target():
    return _pair("granite-3-8b", 0)


@pytest.fixture(scope="module")
def drafter():
    return _pair("granite-moe-1b-a400m", 1)


def _static_refs(model, params, prompts, max_new):
    """The reference's non-speculative greedy chain (static batch)."""
    return [jgenerate_static(model, params, {"tokens": np.asarray([p], np.int32)},
                             max_new_tokens=max_new)[0][0].tolist() for p in prompts]


def _server(target, **kw):
    _, _, tmodel, tparams = target
    return Server(tmodel, tparams, ServerConfig(**{**CONFIG, **kw.pop("config", {})}),
                  device="cpu", **kw)


def _assert_no_leaks(server):
    assert server.cache.allocator.num_held == 0
    assert (server.cache.page_table == 0).all()
    if isinstance(server.drafter, ModelDrafter):
        store = server.drafter.store
        assert store.allocator.num_held == 0
        assert (store.page_table == 0).all() and (store.seq_lens == 0).all()


# -- policy -------------------------------------------------------------------

def test_spec_config_validation():
    for bad in (dict(k=0), dict(ngram_n=0), dict(draft_chunk=0)):
        with pytest.raises(ValueError):
            SpecConfig(**bad)
    assert SpecConfig() == SpecConfig(k=4, ngram_n=3, draft_chunk=16)


def test_effective_k_clamps():
    assert effective_k(9, 4, remaining=100, capacity=100) == 4
    assert effective_k(2, 4, remaining=100, capacity=100) == 2
    assert effective_k(4, 4, remaining=3, capacity=100) == 2
    assert effective_k(4, 4, remaining=1, capacity=100) == 0
    assert effective_k(4, 4, remaining=100, capacity=1) == 1
    assert effective_k(4, 4, remaining=0, capacity=0) == 0
    for req in range(6):
        for rem in range(6):
            for cap in range(4):
                assert effective_k(req, 4, rem, cap) == jeffective_k(req, 4, rem, cap)


# -- n-gram proposer ----------------------------------------------------------

def test_ngram_lookup_proposes_repeated_continuation():
    prop = NgramDrafter(k=4, ngram_n=3).propose({0: [3, 5, 7, 9, 3, 5, 7, 9]},
                                                np.asarray([4]), None, None)
    assert prop.logits is None
    assert prop.counts[0] == 4 and prop.tokens[0].tolist() == [3, 5, 7, 9]


def test_ngram_lookup_backs_off_and_gives_up():
    d = NgramDrafter(k=4, ngram_n=3)
    prop = d.propose({0: [2, 9, 1, 5, 2]}, np.asarray([4]), None, None)
    assert prop.counts[0] == 4 and prop.tokens[0].tolist() == [9, 1, 5, 2]
    assert d.propose({0: [1, 2, 3, 4]}, np.asarray([4]), None, None).counts[0] == 0


@pytest.mark.parametrize("seed", range(3))
def test_ngram_proposals_match_reference(seed):
    """Random short-alphabet histories and draft counts: the reference's
    proposals, row for row."""
    rng = np.random.default_rng(seed)
    contexts = {s: [int(t) for t in rng.integers(0, 4, size=rng.integers(1, 20))]
                for s in range(6)}
    want = rng.integers(0, 5, size=6).astype(np.int32)
    got = NgramDrafter(k=4, ngram_n=3).propose(contexts, want, None, None)
    ref = JNgramDrafter(k=4, ngram_n=3).propose(contexts, want, None, None)
    np.testing.assert_array_equal(got.counts, ref.counts)
    np.testing.assert_array_equal(got.tokens, ref.tokens)


# -- rejection sampler --------------------------------------------------------

def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_speculative_sample_greedy_prefix_semantics():
    """Greedy rows accept exactly the drafts on the target's argmax chain
    and emit the argmax at the first mismatch or the bonus position."""
    v = 8
    tl = np.full((2, 3, v), -10.0, np.float32)
    tl[:, 0, 4] = tl[:, 1, 5] = tl[:, 2, 6] = 10.0  # argmax chain 4, 5, 6
    out, acc = speculative_sample(
        *_t(tl, np.asarray([[4, 5], [4, 3]], np.int32)), torch.Generator().manual_seed(0),
        *_t(np.zeros(2, np.float32), np.zeros(2, np.int32), np.ones(2, np.float32),
            np.asarray([3, 3], np.int32), np.ones(2, bool)))
    assert acc.tolist() == [2, 1]
    assert out[0, :3].tolist() == [4, 5, 6]  # all accepted, then the bonus argmax
    assert out[1, :2].tolist() == [4, 5]  # the correction replaces the miss


@pytest.mark.parametrize("seed", range(4))
def test_greedy_decisions_match_reference_bitwise(seed):
    """Random logits, drafts partly on the argmax chain, ragged lengths and
    an inactive row: the emitted tokens and accepted counts of greedy rows
    are the reference's."""
    rng = np.random.default_rng(seed)
    s, k, v = 6, 4, 50
    tl = rng.standard_normal((s, k + 1, v)).astype(np.float32)
    drafts = tl[:, :k].argmax(-1).astype(np.int32)
    miss = rng.random((s, k)) < 0.3
    drafts[miss] = rng.integers(0, v, size=int(miss.sum()))
    lengths = rng.integers(0, k + 2, size=s).astype(np.int32)
    active = lengths > 0
    active[0] = False
    sampling = (np.zeros(s, np.float32), np.zeros(s, np.int32), np.ones(s, np.float32))
    want, want_acc = jspeculative_sample(jnp.asarray(tl), jnp.asarray(drafts),
                                         jax.random.PRNGKey(seed),
                                         *map(jnp.asarray, sampling), jnp.asarray(lengths),
                                         jnp.asarray(active))
    got, acc = speculative_sample(*_t(tl, drafts), torch.Generator().manual_seed(seed),
                                  *_t(*sampling, lengths, active))
    want, want_acc = np.asarray(want), np.asarray(want_acc)
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    for row in range(s):
        n = int(want_acc[row]) + 1
        np.testing.assert_array_equal(got[row, :n].numpy(), want[row, :n])


def test_speculative_sample_zero_drafts_is_plain_decode():
    tl = np.full((1, 3, 8), -10.0, np.float32)
    tl[:, 0, 2] = 10.0
    out, acc = speculative_sample(
        *_t(tl, np.zeros((1, 2), np.int32)), torch.Generator().manual_seed(0),
        *_t(np.zeros(1, np.float32), np.zeros(1, np.int32), np.ones(1, np.float32),
            np.asarray([1], np.int32), np.ones(1, bool)))
    assert int(acc[0]) == 0 and int(out[0, 0]) == 2


@pytest.mark.parametrize("mode", ["model_q", "onehot_q"])
def test_speculative_sample_preserves_target_distribution(mode):
    """The first emitted token over N = 4000 independent rounds (one row
    each) follows the filtered target softmax (the reference's
    ``filter_logits``), with temperature and top-p on, for drafts drawn
    from the drafter's filtered softmax (q = that) and for drafts drawn
    uniformly and treated as deterministic (q = onehot(d))."""
    rng = np.random.default_rng(0)
    v, k, n = 8, 2, 4000
    tl = (rng.standard_normal((1, k + 1, v)) * 2).astype(np.float32)
    dl = (rng.standard_normal((1, k, v)) * 2).astype(np.float32)
    temp, tk, tp = np.asarray([0.7], np.float32), np.asarray([0], np.int32), \
        np.asarray([0.9], np.float32)
    expect = np.asarray(jax.nn.softmax(jfilter_logits(jnp.asarray(tl[:, 0]), temp, tk, tp)))[0]

    gen = torch.Generator().manual_seed(42)
    rep = lambda a: torch.from_numpy(np.repeat(a, n, axis=0))  # noqa: E731
    temps, tks, tps = rep(temp), rep(tk), rep(tp)
    if mode == "model_q":
        q = torch.softmax(filter_logits(torch.from_numpy(dl[0]), temps[:k], tks[:k], tps[:k]), -1)
        drafts = torch.multinomial(q, n, replacement=True, generator=gen).T
        draft_logits = rep(dl)
    else:
        drafts = torch.randint(0, v, (n, k), generator=gen)
        draft_logits = None
    out, _ = speculative_sample(rep(tl), drafts, gen, temps, tks, tps,
                                torch.full((n,), k + 1), torch.ones(n, dtype=torch.bool),
                                draft_logits=draft_logits)
    emp = np.bincount(out[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(emp - expect).sum()
    assert tv < 0.05, (mode, tv)


# -- verify_cb ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-8b", "granite-moe-1b-a400m"])
def test_verify_cb_matches_reference(arch):
    """Two slots prefilled (7 and 12 tokens), then one verify step of 5
    positions over three slots: ragged lengths, one slot sitting out.
    Logits at every valid position, and the next decode step's (which
    reads the verify step's K/V back), within 1e-5 of max|logit|."""
    model, params, tmodel, tparams = _pair(arch, 0)
    ps, n_pages, v = 4, 16, model.cfg.vocab_size
    pools = model.init_state_store(3, n_pages, ps)
    tpools = tmodel.init_state_store(3, n_pages, ps)
    rng = np.random.default_rng(0)
    pt = np.zeros((3, 5), np.int32)
    pt[0, :3], pt[1, :5], pt[2, :2] = [1, 2, 3], [4, 5, 6, 7, 8], [9, 10]
    for slot, n in ((0, 7), (1, 12)):
        toks = rng.integers(0, v, (1, 16)).astype(np.int32)
        _, pools = model.prefill_cb(params, jnp.asarray(toks), pools, jnp.asarray(pt[slot]),
                                    jnp.int32(slot), jnp.int32(0), jnp.int32(n), page_size=ps)
        with torch.inference_mode():
            tmodel.prefill_cb(tparams, torch.from_numpy(toks), tpools, torch.from_numpy(pt[slot]),
                              slot, 0, n, page_size=ps)
    tokens = rng.integers(0, v, (3, 5)).astype(np.int32)
    seq_lens = np.asarray([7, 12, 0], np.int32)
    lengths = np.asarray([5, 3, 0], np.int32)
    active = np.asarray([True, True, False])
    want, pools = model.verify_cb(params, *map(jnp.asarray, (tokens,)), pools, jnp.asarray(pt),
                                  jnp.asarray(seq_lens), jnp.asarray(lengths),
                                  jnp.asarray(active), page_size=ps, commit=False)
    with torch.inference_mode():
        got = tmodel.verify_cb(tparams, torch.from_numpy(tokens), tpools, torch.from_numpy(pt),
                               torch.from_numpy(seq_lens), torch.from_numpy(lengths),
                               torch.from_numpy(active), page_size=ps, commit=False)
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 5, v)
    for slot in (0, 1):
        w, g = want[slot, :lengths[slot]], got[slot, :lengths[slot]].numpy()
        assert np.abs(g - w).max() / np.abs(w).max() <= 1e-5
    # The next decode step reads every position the verify step wrote.
    lens = seq_lens + lengths
    dec_tok = np.asarray([[1], [2], [0]], np.int32)
    want, _ = model.decode_cb(params, jnp.asarray(dec_tok), pools, jnp.asarray(pt),
                              jnp.asarray(lens), jnp.asarray(active), page_size=ps)
    with torch.inference_mode():
        got = tmodel.decode_cb(tparams, torch.from_numpy(dec_tok), tpools, torch.from_numpy(pt),
                               torch.from_numpy(lens), torch.from_numpy(active), page_size=ps)
    want = np.asarray(want)[:2]
    assert np.abs(got[:2].numpy() - want).max() / np.abs(want).max() <= 1e-5


# -- greedy parity through the server -----------------------------------------------

@pytest.mark.parametrize("drafter_kind", ["ngram", "model"])
def test_spec_greedy_parity_vs_reference_static(target, drafter, drafter_kind):
    """Greedy speculative decoding emits the reference's non-speculative
    static chain token for token, whatever the drafter proposes; both
    stores end with no page held."""
    model, params, _, _ = target
    refs = _static_refs(model, params, _PROMPTS, max_new=16)
    if drafter_kind == "ngram":
        server = _server(target, spec=SpecConfig(k=4, ngram_n=3))
    else:
        _, _, dmodel, dparams = drafter
        server = _server(target, spec=SpecConfig(k=3), draft_model=dmodel, draft_params=dparams)
    reqs = [server.submit(p, max_new_tokens=16) for p in _PROMPTS]
    server.run()
    for req, ref in zip(reqs, refs):
        assert req.out_tokens == ref, req.rid
    assert server.stats.spec_steps > 0
    _assert_no_leaks(server)


def test_spec_stats_match_reference_server(target):
    """With the n-gram drafter (deterministic proposals) and greedy rows the
    port's rounds are the reference's: the same tokens, rounds, drafts
    fielded and accepted, decode tokens and slot steps."""
    model, params, _, _ = target
    jserver = JServer(model, params, JServerConfig(**CONFIG), spec=JSpecConfig(k=4, ngram_n=3))
    server = _server(target, spec=SpecConfig(k=4, ngram_n=3))
    for s in (jserver, server):
        for p in _PROMPTS:
            s.submit(p, max_new_tokens=16)
    want, got = jserver.run(), server.run()
    assert {r: q.out_tokens for r, q in got.items()} == {r: q.out_tokens for r, q in want.items()}
    assert {r: q.spec_accepted for r, q in got.items()} == {
        r: q.spec_accepted for r, q in want.items()}
    js, st = jserver.stats, server.stats
    for name in ("spec_steps", "spec_drafted", "spec_accepted", "decode_steps",
                 "decode_tokens", "slot_steps", "prefill_calls", "prefill_tokens"):
        assert getattr(st, name) == getattr(js, name), name
    assert st.acceptance_rate == js.acceptance_rate
    assert st.accepted_per_step == js.accepted_per_step


def test_spec_vocab_mismatch_rejected(target):
    tcfg = dataclasses.replace(tget_config("granite-moe-1b-a400m", smoke=True), vocab_size=512)
    with pytest.raises(ValueError, match="vocabulary"):
        _server(target, spec=SpecConfig(k=2), draft_model=tbuild(tcfg, device="cpu"),
                draft_params=None)


def test_draft_model_alone_takes_the_default_k(target, drafter):
    _, _, dmodel, dparams = drafter
    server = _server(target, draft_model=dmodel, draft_params=dparams)
    assert server.spec == SpecConfig() and isinstance(server.drafter, ModelDrafter)
    assert server.verifier.width == SpecConfig().k + 1


# -- server integration -------------------------------------------------------

def test_spec_eos_mid_round_matches_nonspec(target):
    """A token equal to eos finishes the request where the plain chain does;
    accepted tokens past it are dropped."""
    prompt = _PROMPTS[0]
    base = _server(target, config=dict(num_slots=2))
    ref = base.submit(prompt, max_new_tokens=16)
    base.run()
    assert len(ref.out_tokens) > 3
    eos = ref.out_tokens[3]
    base.reset()
    r1 = base.submit(prompt, max_new_tokens=16, eos_id=eos)
    base.run()
    spec = _server(target, config=dict(num_slots=2), spec=SpecConfig(k=4, ngram_n=3))
    r2 = spec.submit(prompt, max_new_tokens=16, eos_id=eos)
    spec.run()
    assert r2.out_tokens == r1.out_tokens
    assert r2.finish_reason == r1.finish_reason == FINISH_EOS
    _assert_no_leaks(spec)


def test_spec_per_request_k(target):
    """spec_k=1 caps one request's draft depth below the server's k; the
    tokens stay the plain chain."""
    model, params, _, _ = target
    server = _server(target, config=dict(num_slots=2), spec=SpecConfig(k=4, ngram_n=3))
    req = server.submit(_PROMPTS[0], max_new_tokens=8, spec_k=1)
    server.run()
    assert server.stats.spec_steps > 0
    assert server.stats.spec_drafted <= server.stats.spec_steps
    assert req.out_tokens == _static_refs(model, params, [_PROMPTS[0]], max_new=8)[0]


def test_spec_stats_accounting(target):
    server = _server(target, spec=SpecConfig(k=4, ngram_n=3), config=dict(async_depth=2))
    for p in _PROMPTS:
        server.submit(p, max_new_tokens=16)
    server.run()
    st = server.stats
    assert st.spec_steps == st.decode_steps > 0
    assert 0 <= st.spec_accepted <= st.spec_drafted
    assert st.acceptance_rate == st.spec_accepted / st.spec_drafted
    assert st.accepted_per_step == st.spec_accepted / st.spec_steps
    assert st.decode_tokens >= st.spec_steps
    assert st.spec_accepted > 0  # the repetitive prompts exercise acceptance
    assert sum(r.spec_accepted for r in server.results.values()) == st.spec_accepted
    # async_depth is 0 under speculation: every step was harvested at once.
    assert server.engine.num_inflight == 0 and st.nonfinite_steps == 0


def test_spec_sampled_matches_nonspec_distribution(target):
    """With temperature and top-k sampling, the speculative server's token
    frequencies over 60 seeds match the plain server's (equal laws, other
    random streams: a two-sample comparison)."""
    sp = SamplingParams(temperature=1.0, top_k=2)
    n_seeds = 60

    def collect(**kw):
        server = _server(target, config=dict(num_slots=2), **kw)
        toks = []
        for s in range(n_seeds):
            server.seed = s
            server.reset()
            req = server.submit(_PROMPTS[0], max_new_tokens=3, sampling=sp)
            server.run()
            toks.append(req.out_tokens)
        return np.asarray(toks)

    spec_t = collect(spec=SpecConfig(k=3, ngram_n=3))
    base_t = collect()
    # Position 0 comes from the prefill in both; 1 and 2 go through the
    # rejection sampler in the speculative server.
    for pos in (1, 2):
        for tok in np.union1d(spec_t[:, pos], base_t[:, pos]):
            f_spec, f_base = np.mean(spec_t[:, pos] == tok), np.mean(base_t[:, pos] == tok)
            assert abs(f_spec - f_base) < 0.3, (pos, tok, f_spec, f_base)


# -- drafter rollback -----------------------------------------------------------

def test_model_drafter_rollback_without_snapshot(drafter):
    """d1 drafts a round, the target then emits tokens that reject its first
    drafts, and d1 proposes again. d2 never drafted: it replays the same
    committed histories with the same chunking. Their next-round proposals
    (drafts and logits) are the same bit for bit, and so are the pools at
    every committed position: the stale draft K/V past the committed length
    (k = 4 leaves one past the 2-token extension) is never read."""
    _, _, dmodel, dparams = drafter
    kw = dict(num_slots=2, page_size=4, max_seq_len=48, k=4)
    d1, d2 = ModelDrafter(dmodel, dparams, **kw), ModelDrafter(dmodel, dparams, **kw)
    ctx = {0: [3, 5, 7, 9, 3, 5], 1: [11, 4, 11, 4]}
    want = np.asarray([4, 4], np.int32)
    params_list = [SamplingParams(), SamplingParams(temperature=1.0)]
    with torch.inference_mode():
        first = d1.propose(ctx, want, torch.Generator().manual_seed(0), params_list)
        ext = {s: [(int(first.tokens[s, 0]) + 1) % 256, 7] for s in ctx}  # rejects draft 1
        ctx2 = {s: ctx[s] + ext[s] for s in ctx}
        d2._replay(ctx)
        assert (d1.store.seq_lens == d2.store.seq_lens).all()
        got = d1.propose(ctx2, want, torch.Generator().manual_seed(1), params_list)
        ref = d2.propose(ctx2, want, torch.Generator().manual_seed(1), params_list)
    assert (d1.store.seq_lens == d2.store.seq_lens).all()
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert torch.equal(got.logits, ref.logits)
    for slot, n in enumerate(d1.store.seq_lens):
        idx = torch.cat([torch.arange(p * 4, p * 4 + 4)
                         for p in d1.store.page_table[slot][:(n + 3) // 4]])[:n]
        idx2 = torch.cat([torch.arange(p * 4, p * 4 + 4)
                          for p in d2.store.page_table[slot][:(n + 3) // 4]])[:n]
        for a, b in zip(d1.store.pools, d2.store.pools):
            assert torch.equal(a["kp"][idx], b["kp"][idx2])
            assert torch.equal(a["vp"][idx], b["vp"][idx2])
    d1.reset()
    assert d1.store.allocator.num_held == 0


# -- graphs and the launcher ----------------------------------------------------------

def test_spec_steps_capture_nothing_on_the_cpu(target, drafter):
    _, _, dmodel, dparams = drafter
    server = _server(target, spec=SpecConfig(k=3), draft_model=dmodel, draft_params=dparams)
    server.submit(_PROMPTS[0], max_new_tokens=4)
    server.run()
    for step in (server.verifier.step, server.drafter._catch_up, server.drafter._decode):
        assert step.graph is False and step.captures == step.replays == 0


def test_launcher_page_size_default_is_the_reference_one(monkeypatch):
    """Both launchers' ``--page-size`` default, the reference's read from
    the parser its ``main`` builds."""
    from repro.launch import serve as jserve

    class Parsed(Exception):
        pass

    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise Parsed(parse(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Parsed) as info:
        jserve.main([])
    monkeypatch.undo()
    ref = info.value.args[0]
    assert tserve.parse_args([]).page_size == ref.page_size == 8


@pytest.mark.parametrize("flags", [["--spec-k", "3"],
                                   ["--draft-model", "granite-moe-1b-a400m"]],
                         ids=["ngram", "model"])
def test_serve_launcher_spec_gate_on_the_cpu(flags, capsys):
    server, results = tserve.main(["--smoke", "--device", "cpu", "--requests", "3",
                                   "--prompt-len", "8", "--max-new", "6", "--spec-gate",
                                   *flags])
    out = capsys.readouterr().out
    assert len(results) == 3 and all(r.num_generated == 6 for r in results.values())
    assert "speculative: k=" in out and "spec gate passed" in out
    assert "greedy parity with non-speculative decode confirmed" in out


# -- greedy accounting (the card's parity check under fp8) ---------------------------

@pytest.mark.parametrize("drafter_kind", ["ngram", "model"])
def test_record_rows_keeps_the_emitted_tokens_rows(target, drafter, drafter_kind):
    """``record_rows`` keeps one row for every token after the first, in the
    plain and the speculative server, and each greedy token is its row's
    argmax (a rejected draft's row was replaced by the round that emitted
    the token); in fp32 the two runs' rows agree to 1e-5 of max|logit|."""
    from repro_torch.launch.spec_gate import greedy_accounting, record_rows

    kw = (dict(spec=SpecConfig(k=4)) if drafter_kind == "ngram" else
          dict(spec=SpecConfig(k=3), draft_model=drafter[2], draft_params=drafter[3]))
    runs = {}
    for name, skw in (("plain", {}), ("spec", kw)):
        server, rows = _server(target, **skw), {}
        record_rows(server, rows)
        for p in _PROMPTS:
            server.submit(p, max_new_tokens=12)
        runs[name] = ({r: q.out_tokens for r, q in server.run().items()}, rows)
    for tokens, rows in runs.values():
        assert sorted(rows) == sorted((r, i) for r, t in tokens.items() for i in range(1, 12))
        for (rid, i), row in rows.items():
            assert int(row.argmax()) == tokens[rid][i]
    (got, spec_rows), (want, plain_rows) = runs["spec"], runs["plain"]
    noise, splits, bad = greedy_accounting(got, want, spec_rows, plain_rows)
    assert got == want and splits == [] and bad == []
    assert noise <= 1e-5 * max(float(r.abs().max()) for r in plain_rows.values())


def test_greedy_accounting_tells_a_near_tie_from_a_fault():
    from repro_torch.launch.spec_gate import greedy_accounting

    plain_rows = {(0, 1): torch.tensor([0.0, 3.0, 0.0]),  # a clear margin
                  (0, 2): torch.tensor([2.0, 1.98, 0.0])}  # a near-tie
    spec_rows = {(0, 1): torch.tensor([0.0, 3.05, 0.0]), (0, 2): torch.tensor([1.98, 2.0, 0.0])}
    plain = {0: [7, 1, 0]}
    # A split at the near-tie, within the 0.05 by which the top-2 margin
    # moved at the matched index 1.
    noise, splits, bad = greedy_accounting({0: [7, 1, 1]}, plain, spec_rows, plain_rows)
    assert noise == pytest.approx(0.05) and splits == [(0, 2, pytest.approx(0.02))] and not bad
    # A wrong token at the same position, one the plain run ranked far
    # below its own: the plain top-2 gap there is small, its margin is not.
    _, splits, bad = greedy_accounting({0: [7, 1, 2]}, plain, spec_rows, plain_rows)
    assert bad == splits == [(0, 2, 2.0)]
    # A wrong token at a clear margin (nothing matched before it).
    _, splits, bad = greedy_accounting({0: [7, 2, 0]}, plain, spec_rows, plain_rows)
    assert bad == splits == [(0, 1, 3.0)]
    # A first token that differs comes from the prefill: never explained.
    _, _, bad = greedy_accounting({0: [6, 1, 0]}, plain, spec_rows, plain_rows)
    assert bad == [(0, 0, float("inf"))]
