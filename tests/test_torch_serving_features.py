"""The rest of the port's continuous-batching serving against the JAX
package: the page allocator's prefix index, the scheduler (priorities,
token budget, prefix cache, preemption), chunked and batched
``prefill_cb``, the ``Server`` under every feature, the static-batch
baseline and the launcher, all on the CPU with the plain path.

Parameters come from the reference's ``Transformer.init`` on granite SMOKE,
copied with ``params_from_jax``. Under fp32 the port's greedy tokens and
serving stats equal the reference's bit for bit. The model-level logits
are held to 1e-5 of max|logit| under fp32 and 5e-2 under redmule_hfp8
with E4M3 pages, the bounds of ``tests/test_torch_model.py`` and for its
reason. The E4M3 pools after each step must be the reference's bits; fp32
pools hold the K/V of an fp32 GEMM whose sum order differs between XLA and
torch on the CPU (a few fp32 ulps), and are held to the logits' 1e-5.
"""
import dataclasses
import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import build  # noqa: E402
from repro.serving import PagePool as JPagePool  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro.serving import Server as JServer  # noqa: E402
from repro.serving import ServerConfig as JServerConfig  # noqa: E402
from repro.serving import generate_static as jgenerate_static  # noqa: E402
from repro.serving import prefix_block_hashes as jprefix_block_hashes  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    FINISH_EOS,
    QUEUED,
    RUNNING,
    OutOfPagesError,
    PagePool,
    Request,
    SamplingParams,
    Scheduler,
    Server,
    ServerConfig,
    copy_kv_page,
    generate_static,
    prefix_block_hashes,
)
from repro_torch.serving.engine import P_BUCKETS, EngineCore  # noqa: E402


def _pair(policy="fp32", kv="fp32"):
    kw = dict(policy=policy, kv_cache_dtype=kv)
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), **kw)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tget_config("granite-3-8b", smoke=True), **kw)
    tmodel = tbuild(tcfg, device="cpu")
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, vocab, size=n)) for n in lens]


# -- the page allocator ---------------------------------------------------------

def _pool_state(pool):
    return (sorted(pool._refs.items()), list(pool._free), sorted(pool._hash_to_page.items()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_matches_reference(seed):
    """500 random alloc / incref / decref / publish / acquire operations:
    the same pages handed out, refcounts, free list and index as the
    reference's pool after every one."""
    rng = random.Random(seed)
    ref, got = JPagePool(num_pages=11, page_size=4), PagePool(num_pages=11, page_size=4)
    hashes = list(range(1000, 1012))
    for _ in range(500):
        op, held = rng.random(), sorted(ref._refs)
        if op < 0.3:
            n = rng.randint(1, 3)
            if n > ref.num_free:
                with pytest.raises(OutOfPagesError):
                    got.alloc(n)
                continue
            assert got.alloc(n) == ref.alloc(n)
        elif op < 0.4 and held:
            p = rng.choice(held)
            ref.incref([p])
            got.incref([p])
        elif op < 0.65 and held:
            p = rng.choice(held)
            ref.decref([p])
            got.decref([p])
        elif op < 0.85 and held:
            p, h = rng.choice(held), rng.choice(hashes)
            ref.publish(p, h)
            got.publish(p, h)
        else:
            h = rng.choice(hashes)
            assert got.lookup(h) == ref.lookup(h)
            assert got.acquire(h) == ref.acquire(h)
        assert _pool_state(got) == _pool_state(ref)
        assert (got.num_free, got.num_held, got.num_published) == (
            ref.num_free, ref.num_held, ref.num_published)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_block_hashes_match_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 3, 4, 17, 64):
        tokens = list(rng.integers(0, 50, size=n))
        for ps in (1, 4, 16):
            assert prefix_block_hashes(tokens, ps) == jprefix_block_hashes(tokens, ps)
    a = prefix_block_hashes([1, 2, 3, 4, 5, 6, 7, 8], 4)
    c = prefix_block_hashes([9, 9, 9, 9, 5, 6, 7, 8], 4)
    assert len(a) == 2 and a == prefix_block_hashes([1, 2, 3, 4, 5, 6, 7, 8, 9], 4)
    assert a[1] != c[1], "the same block after another prefix must differ"


def test_copy_kv_page_copies_rows_bitwise():
    """Copy-on-write of one page in every layer's pools, fp8 pools as bits."""
    pools = [{"kp": torch.randn(12, 2, 4).to(torch.float8_e4m3fn),
              "vp": torch.randn(12, 2, 4)} for _ in range(2)]
    before = [{k: v.clone() for k, v in p.items()} for p in pools]
    copy_kv_page(pools, 1, 2, page_size=4)
    for p, b in zip(pools, before):
        for k in ("kp", "vp"):
            bits = (lambda t: t.view(torch.uint8)) if p[k].dtype.itemsize == 1 else (lambda t: t)
            assert torch.equal(bits(p[k][8:12]), bits(b[k][4:8]))
            assert torch.equal(bits(p[k][:8]), bits(b[k][:8]))


# -- the scheduler ---------------------------------------------------------------

def _prefill_to(sched, req, n):
    """What the server does when the first n prompt tokens commit."""
    sched.ensure_pages(req, n)
    req.prefilled = n
    sched.publish_prefix(req)


def _sched_state(sched):
    return (
        [(r.rid, r.status, r.slot, list(r.pages), r.cached_tokens, list(r.pending_copies),
          r.preemptions, r.prefilled, r.age) for r in sorted(
              list(sched.queue) + list(sched.running.values()), key=lambda r: r.rid)],
        sched.preemptions, sched.prefix_hit_tokens, sched.prefix_prompt_tokens,
        sched.completed, _pool_state(sched.pool),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_matches_reference(seed):
    """The same random submits (priorities, shared prefixes), prefill
    progress, preemptions and finishes on both schedulers, with a token
    budget, the prefix cache and preemption on: the same admissions,
    slots, pages, cached tokens, copies and preemptions after every
    operation."""
    rng = random.Random(seed)
    kw = dict(num_slots=3, pages_per_slot=8, max_seq_len=32, token_budget=60,
              prefix_cache=True, preemption=True, aging_steps=3)
    ref = JScheduler(pool=JPagePool(num_pages=14, page_size=4), **kw)
    got = Scheduler(pool=PagePool(num_pages=14, page_size=4), **kw)
    system = [7, 1, 7, 2, 7, 3, 7, 4]
    for _ in range(120):
        op = rng.random()
        if op < 0.3:
            n = rng.randint(1, 12)
            prompt = (system[:rng.choice([0, 4, 8])] + [rng.randint(0, 9) for _ in range(n)])
            args = dict(prompt=prompt, max_new_tokens=rng.randint(1, 8),
                        priority=rng.randint(0, 3))
            ref.submit(JRequest(**args))
            got.submit(Request(**args))
        elif op < 0.55:
            slots_r, slots_g = [], []
            assert ([r.rid for r in got.admit(on_preempt=slots_g.append)]
                    == [r.rid for r in ref.admit(on_preempt=slots_r.append)])
            assert slots_g == slots_r
        elif op < 0.8 and ref.running:
            slot = rng.choice(sorted(ref.running))
            for s in (ref, got):
                req = s.running[slot]
                req.pending_copies = []
                if req.prefilling:
                    _prefill_to(s, req, min(req.prompt_len, req.prefilled + 4))
                else:
                    s.ensure_page(req, req.prompt_len + req.num_generated)
                    s.commit(req, 5)
                    if req.finish_reason is not None:
                        s.finish(req)
        assert _sched_state(got) == _sched_state(ref)


def _sched(num_pages=9, page_size=4, num_slots=2, **kw):
    return Scheduler(num_slots=num_slots, pool=PagePool(num_pages, page_size),
                     pages_per_slot=4, **kw)


def _case_admission_charges_only_uncached_suffix():
    prompt = [7] * 12

    def run(prefix_cache):
        sched = Scheduler(num_slots=2, pool=PagePool(num_pages=7, page_size=4),
                          pages_per_slot=4, max_seq_len=16, prefix_cache=prefix_cache)
        a = sched.submit(Request(prompt=list(prompt), max_new_tokens=4))
        assert sched.admit() == [a]
        _prefill_to(sched, a, 12)
        b = sched.submit(Request(prompt=list(prompt), max_new_tokens=4))
        return sched, a, b, sched.admit()

    sched, a, b, admitted = run(prefix_cache=True)
    assert admitted == [b]
    assert b.cached_tokens == 11 and len(b.pending_copies) == 1
    assert sched.pool.ref(a.pages[0]) == 2
    assert sched.prefix_hit_tokens == 11
    assert run(prefix_cache=False)[3] == []


def _case_priority_order_and_aging():
    sched = _sched(num_slots=1, max_seq_len=16, aging_steps=2)
    lo = sched.submit(Request(prompt=[1] * 4, max_new_tokens=2, priority=0))
    hi = sched.submit(Request(prompt=[2] * 4, max_new_tokens=2, priority=1))
    assert sched.admit() == [hi]
    assert sched.admit() == [] and sched.admit() == []
    assert sched.effective_priority(lo) == 1
    sched.finish(hi)
    hi2 = sched.submit(Request(prompt=[4] * 4, max_new_tokens=2, priority=1))
    lo2 = sched.submit(Request(prompt=[3] * 4, max_new_tokens=2, priority=0))
    assert sched.admit() == [lo]
    sched.finish(lo)
    assert sched.admit() == [hi2]
    sched.finish(hi2)
    assert sched.admit() == [lo2]


def _case_preemption_evicts_prefilling_lower_priority():
    sched = _sched(num_slots=1, max_seq_len=16, preemption=True)
    lo = sched.submit(Request(prompt=[1] * 8, max_new_tokens=4))
    (lo,) = sched.admit()
    _prefill_to(sched, lo, 4)
    hi = sched.submit(Request(prompt=[2] * 4, max_new_tokens=4, priority=3))
    reset_slots = []
    assert sched.admit(on_preempt=reset_slots.append) == [hi]
    assert lo.status == QUEUED and lo.slot is None and lo.pages == []
    assert lo.preemptions == 1 and sched.preemptions == 1
    assert reset_slots == [hi.slot]
    _prefill_to(sched, hi, 4)
    assert hi.decoding
    hi2 = sched.submit(Request(prompt=[3] * 4, max_new_tokens=4, priority=9))
    assert sched.admit() == [] and hi2.status == QUEUED
    assert sched.running.get(hi.slot) is hi


def _case_preemption_feasibility_no_pointless_eviction():
    sched = _sched(num_pages=5, page_size=4, num_slots=3, max_seq_len=16, preemption=True)
    d = sched.submit(Request(prompt=[1] * 4, max_new_tokens=4))
    (d,) = sched.admit()
    _prefill_to(sched, d, 4)
    lo = sched.submit(Request(prompt=[2] * 4, max_new_tokens=4))
    (lo,) = sched.admit()
    _prefill_to(sched, lo, 2)
    hi = sched.submit(Request(prompt=[3] * 8, max_new_tokens=8, priority=5))
    assert sched.admit() == [] and hi.status == QUEUED
    assert lo.status == RUNNING and lo.preemptions == 0
    assert sched.preemptions == 0


def _case_token_budget():
    sched = _sched(num_pages=32, num_slots=4, max_seq_len=16, token_budget=24)
    for _ in range(3):
        sched.submit(Request(prompt=[1] * 4, max_new_tokens=8))
    assert len(sched.admit()) == 2
    with pytest.raises(ValueError):
        _sched(num_pages=32, num_slots=4, max_seq_len=16, token_budget=10).submit(
            Request(prompt=[1] * 4, max_new_tokens=8))


def _case_finish_is_idempotent_after_slot_recycled():
    sched = _sched(num_slots=1, max_seq_len=16)
    a = sched.submit(Request(prompt=[1] * 4, max_new_tokens=2))
    (a,) = sched.admit()
    sched.ensure_pages(a, 4)
    sched.finish(a)
    b = sched.submit(Request(prompt=[2] * 4, max_new_tokens=2))
    (b,) = sched.admit()
    sched.ensure_pages(b, 4)
    sched.finish(a)
    assert sched.running.get(b.slot) is b and sched.num_free_slots == 0
    assert sched.pool.num_held == 1 and sched.completed == 1
    with pytest.raises(ValueError):
        sched.finish(Request(prompt=[3]))


def _case_preempt_refuses_a_decoding_request():
    sched = _sched(num_slots=1, max_seq_len=16, preemption=True)
    (a,) = [sched.submit(Request(prompt=[1] * 4, max_new_tokens=2))]
    sched.admit()
    _prefill_to(sched, a, 4)
    with pytest.raises(ValueError, match="not prefilling"):
        sched.preempt(a)


SCHEDULER_CASES = {
    "admission_charges_only_uncached_suffix": _case_admission_charges_only_uncached_suffix,
    "priority_order_and_aging": _case_priority_order_and_aging,
    "preemption_evicts_prefilling_lower_priority":
        _case_preemption_evicts_prefilling_lower_priority,
    "preemption_feasibility_no_pointless_eviction":
        _case_preemption_feasibility_no_pointless_eviction,
    "token_budget": _case_token_budget,
    "finish_is_idempotent_after_slot_recycled": _case_finish_is_idempotent_after_slot_recycled,
    "preempt_refuses_a_decoding_request": _case_preempt_refuses_a_decoding_request,
}


@pytest.mark.parametrize("case", list(SCHEDULER_CASES))
def test_scheduler_unit_cases(case):
    """The reference's scheduler unit cases (tests/test_serving.py), on the
    port's scheduler."""
    SCHEDULER_CASES[case]()


# -- the model: chunked and batched prefill_cb ----------------------------------

MODEL_CASES = {"fp32": ("fp32", "fp32", 1e-5), "hfp8": ("redmule_hfp8", "e4m3", 5e-2)}


@pytest.fixture(scope="module")
def model_pairs():
    return {case: _pair(pol, kv) for case, (pol, kv, _) in MODEL_CASES.items()}


def _rel(want, got):
    want = np.asarray(want, np.float32)
    return float(np.abs(want - got.float().numpy()).max() / np.abs(want).max())


def _assert_pools_equal(jpools, tpools):
    attn = jpools["units"]["b0"]["attn"]
    for i, layer in enumerate(tpools):
        for name in ("kp", "vp"):
            want = np.asarray(attn[name][i])
            got = layer[name]
            if want.dtype.itemsize == 1:
                np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                              want.view(np.uint8))
            else:
                assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


PS, N_PAGES = 4, 12


def _chunk_inputs(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (4, 8)).astype(np.int32)


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_chunked_prefill_cb_matches_reference(case, model_pairs):
    """Two chunks of one slot: the first from position 0, the second from
    position 8 over the pages the first wrote (5 valid tokens of 8)."""
    model, params, tmodel, tparams = model_pairs[case]
    tol = MODEL_CASES[case][2]
    toks = _chunk_inputs(model.cfg.vocab_size)
    page_row = np.array([3, 1, 4, 0, 0], np.int32)
    pools = model.init_state_store(2, N_PAGES, PS)
    tpools = tmodel.init_state_store(2, N_PAGES, PS)
    for start, n, row in ((0, 8, 0), (8, 5, 1)):
        want, pools = model.prefill_cb(
            params, jnp.asarray(toks[row:row + 1]), pools, jnp.asarray(page_row),
            jnp.int32(0), jnp.int32(start), jnp.int32(n), page_size=PS, chunked=True)
        with torch.inference_mode():
            got = tmodel.prefill_cb(tparams, torch.from_numpy(toks[row:row + 1]), tpools,
                                    torch.from_numpy(page_row), 0, start, n, page_size=PS,
                                    chunked=True)
        assert got.shape == (1, model.cfg.vocab_size) and torch.isfinite(got).all()
        assert _rel(want, got) <= tol, (start, _rel(want, got))
        _assert_pools_equal(pools, tpools)


def _batched_rows(p):
    """P rows: slot 1 continues from position 8 (3 tokens), slot 0 starts
    (6 tokens); the rest are inactive pads on a free slot."""
    page_rows = np.zeros((p, 5), np.int32)
    page_rows[0] = [2, 5, 6, 0, 0]
    page_rows[1] = [1, 3, 0, 0, 0]
    slots = np.array([1, 0] + [2] * (p - 2), np.int32)
    starts = np.array([8, 0] + [0] * (p - 2), np.int32)
    lengths = np.array([3, 6] + [0] * (p - 2), np.int32)
    active = np.array([True, True] + [False] * (p - 2))
    return page_rows, slots, starts, lengths, active


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_batched_prefill_cb_matches_reference(case, p, model_pairs):
    """One (P, 8) step with pad rows after a chunk of slot 1 from position
    0: logits of the active rows and the pools against the reference's,
    and each active row against the port's own single-row chunked step.
    That last comparison has the same bound: on the CPU the plain GEMM is
    ``torch.matmul``, whose blocking (and so the order of each sum) may
    change with the number of rows (8 against P * 8). On the card the
    tensor-core schedule keeps each output's K order, and ``chip_smoke.py``
    holds batched against serial bitwise."""
    model, params, tmodel, tparams = model_pairs[case]
    tol = MODEL_CASES[case][2]
    toks = _chunk_inputs(model.cfg.vocab_size, seed=1)[:p]
    page_rows, slots, starts, lengths, active = _batched_rows(p)
    pools = model.init_state_store(3, N_PAGES, PS)
    tpools = tmodel.init_state_store(3, N_PAGES, PS)
    first = _chunk_inputs(model.cfg.vocab_size, seed=2)[:1]
    _, pools = model.prefill_cb(params, jnp.asarray(first), pools, jnp.asarray(page_rows[0]),
                                jnp.int32(1), jnp.int32(0), jnp.int32(8), page_size=PS,
                                chunked=True)
    want, pools = model.prefill_cb(
        params, jnp.asarray(toks), pools, jnp.asarray(page_rows), jnp.asarray(slots),
        jnp.asarray(starts), jnp.asarray(lengths), page_size=PS, chunked=True,
        active=jnp.asarray(active))
    t = torch.from_numpy
    with torch.inference_mode():
        tmodel.prefill_cb(tparams, t(first), tpools, t(page_rows[0]), 1, 0, 8, page_size=PS,
                          chunked=True)
        serial_pools = [{k: v.clone() for k, v in layer.items()} for layer in tpools]
        got = tmodel.prefill_cb(tparams, t(toks), tpools, t(page_rows), t(slots), t(starts),
                                t(lengths), page_size=PS, chunked=True, active=t(active))
        serial = [tmodel.prefill_cb(tparams, t(toks[r:r + 1]), serial_pools, t(page_rows[r]),
                                    int(slots[r]), int(starts[r]), int(lengths[r]),
                                    page_size=PS, chunked=True) for r in range(2)]
    assert got.shape == (p, model.cfg.vocab_size)
    for r in range(2):
        assert _rel(np.asarray(want)[r:r + 1], got[r:r + 1]) <= tol
        assert _rel(serial[r].numpy(), got[r:r + 1]) <= tol
    _assert_pools_equal(pools, tpools)
    with pytest.raises(ValueError, match="chunked"):
        tmodel.prefill_cb(tparams, t(toks), tpools, t(page_rows), t(slots), t(starts),
                          t(lengths), page_size=PS, active=t(active))


# -- the server against the reference's -----------------------------------------

BASE = dict(num_slots=2, page_size=4, max_seq_len=24, prefill_bucket=8)


def _feed_all(server, prompts, gens, priorities=None):
    for i, (p, g) in enumerate(zip(prompts, gens)):
        server.submit(p, max_new_tokens=g, priority=0 if priorities is None else priorities[i])
    server.run()


def _plain(lens, gens, seed=0):
    def drive(server, vocab):
        prompts = _prompts(vocab, lens, seed)
        _feed_all(server, prompts, gens)
    return drive


def _prefix(server, vocab):
    """A shared 8-token prefix: a first wave, then a revival of a finished
    prompt (its pages free but published), copy-on-write of a page-aligned
    prompt, and a partial hit."""
    system = _prompts(vocab, (8,), seed=31)[0]
    a, e, b = [system + t for t in _prompts(vocab, (5, 8, 3), seed=32)]
    _feed_all(server, [a, e], [6, 4])
    _feed_all(server, [a, e, b], [6, 4, 5])


def _preempt(server, vocab):
    """A long low-priority prompt preempted by a later high-priority one,
    with aging lifting a third request."""
    long_p, short_p, mid_p = _prompts(vocab, (24, 5, 6), seed=41)
    server.submit(long_p, max_new_tokens=6, priority=0)
    server.step()
    server.submit(short_p, max_new_tokens=6, priority=5)
    server.submit(mid_p, max_new_tokens=4, priority=1)
    server.run()


SERVER_CASES = {
    "chunk4": (dict(prefill_chunk=4), _plain((5, 11, 7, 9), (6, 3, 8, 5))),
    "chunk1": (dict(prefill_chunk=1), _plain((5, 3), (4, 3), seed=3)),
    "chunk4_batch": (dict(num_slots=4, prefill_chunk=4, prefill_batch=True),
                     _plain((5, 11, 7, 9, 13, 6), (6, 3, 8, 5, 2, 4), seed=4)),
    "prefix_cache": (dict(num_slots=2, max_seq_len=32, prefill_chunk=4, prefix_cache=True),
                     _prefix),
    "prefix_cache_whole_prompt": (dict(num_slots=1, max_seq_len=32, prefix_cache=True),
                                  _prefix),
    "preemption": (dict(num_slots=1, max_seq_len=40, prefill_chunk=4, prefix_cache=True,
                        preemption=True, aging_steps=2), _preempt),
    "token_budget": (dict(num_slots=3, token_budget=30),
                     _plain((5, 11, 7, 9), (6, 3, 8, 5), seed=5)),
    "async1": (dict(async_depth=1), _plain((5, 11, 7, 9), (6, 3, 8, 5), seed=6)),
    "async2_chunk4": (dict(async_depth=2, prefill_chunk=4),
                      _plain((5, 11, 7, 9), (6, 3, 8, 5), seed=7)),
}
STATS = ("prefill_calls", "prefill_tokens", "decode_steps", "decode_tokens", "slot_steps",
         "prefix_hit_tokens", "prefix_prompt_tokens", "cow_copies", "preemptions")


@pytest.mark.parametrize("case", list(SERVER_CASES))
def test_server_matches_reference(case, fp32_pair):
    """Greedy tokens and serving stats equal to ``repro.serving.Server``'s
    under the same ServerConfig, bit for bit under fp32."""
    model, params, tmodel, tparams = fp32_pair
    kw, drive = SERVER_CASES[case]
    kw = {**BASE, **kw}
    ref = JServer(model, params, JServerConfig(**kw))
    drive(ref, model.cfg.vocab_size)
    server = Server(tmodel, tparams, ServerConfig(**kw), device="cpu")
    drive(server, model.cfg.vocab_size)
    assert sorted(server.results) == sorted(ref.results)
    for rid, r in ref.results.items():
        got = server.results[rid]
        assert (got.out_tokens, got.finish_reason, got.cached_tokens, got.preemptions) == (
            r.out_tokens, r.finish_reason, r.cached_tokens, r.preemptions), rid
    assert {k: getattr(server.stats, k) for k in STATS} == {
        k: getattr(ref.stats, k) for k in STATS}
    assert server.stats.prefix_hit_rate == ref.stats.prefix_hit_rate
    assert server.cache.allocator.num_held == 0 and server.engine.num_inflight == 0
    assert server.stats.nonfinite_steps == 0
    if case.startswith("prefix_cache"):
        s = server.stats
        assert s.cow_copies >= 1 and s.prefix_hit_tokens > 0
        revived = [server.results[rid] for rid in sorted(server.results)][2]
        assert revived.cached_tokens == 12  # all 3 full pages of 13 tokens, free but published
    if case == "preemption":
        assert server.stats.preemptions >= 1


# -- the port's own invariants (tests/test_async_engine.py) -----------------------

def _run(tmodel, tparams, prompts, gens, **kw):
    server = Server(tmodel, tparams, ServerConfig(**{**BASE, **kw}), device="cpu")
    reqs = [server.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    results = server.run()
    assert server.cache.allocator.num_held == 0 and server.engine.num_inflight == 0
    return server, [results[r.rid].out_tokens for r in reqs]


def test_async_depth_greedy_parity(fp32_pair):
    _, _, tmodel, tparams = fp32_pair
    prompts = _prompts(tmodel.cfg.vocab_size, (5, 11, 7, 9))
    gens = (6, 3, 8, 5)
    _, base = _run(tmodel, tparams, prompts, gens)
    for depth in (1, 2, 3):
        assert _run(tmodel, tparams, prompts, gens, async_depth=depth)[1] == base, depth
    # A page grows at every step of depth 2: page size 1.
    _, one = _run(tmodel, tparams, prompts, gens, page_size=1)
    assert _run(tmodel, tparams, prompts, gens, page_size=1, async_depth=2)[1] == one == base


def test_eos_overshoot_discarded(fp32_pair):
    _, _, tmodel, tparams = fp32_pair
    (prompt,) = _prompts(tmodel.cfg.vocab_size, (6,), seed=5)
    first = _run(tmodel, tparams, [prompt], [5], num_slots=1, max_seq_len=16)[1][0]
    eos = first[1]
    for depth in (1, 3):
        server = Server(tmodel, tparams, ServerConfig(
            num_slots=1, page_size=4, max_seq_len=16, prefill_bucket=8, async_depth=depth),
            device="cpu")
        req = server.submit(prompt, max_new_tokens=5, eos_id=eos)
        assert server.run()[req.rid].out_tokens == first[:first.index(eos) + 1], depth
        assert req.finish_reason == FINISH_EOS
        assert server.engine.num_inflight == 0 and server.cache.allocator.num_held == 0


def test_latency_marks_stamped_at_harvest(fp32_pair):
    _, _, tmodel, tparams = fp32_pair
    prompts = _prompts(tmodel.cfg.vocab_size, (5, 11, 7, 9), seed=6)
    gens = (6, 3, 8, 5)
    server = Server(tmodel, tparams, ServerConfig(**BASE, async_depth=2), device="cpu")
    reqs = {r.rid: r for r in (server.submit(p, max_new_tokens=g)
                               for p, g in zip(prompts, gens))}
    n_events = 0
    while server.scheduler.has_work():
        t0 = time.perf_counter()
        events = server.step()
        t1 = time.perf_counter()
        for ev in events:
            req = reqs[ev.rid]
            assert t0 <= req.t_last_token <= t1
            if ev.index == 0:
                assert t0 <= req.t_first_token <= t1
            n_events += 1
    server.run()
    assert n_events == sum(gens) and server.engine.num_inflight == 0
    assert server.ttft_percentiles() is not None


def test_config_validation_raises_as_the_reference(fp32_pair):
    model, params, tmodel, tparams = fp32_pair
    for kw, match in ((dict(async_depth=-1), "async_depth"),
                      (dict(prefill_batch=True), "prefill_chunk")):
        cfg = dict(num_slots=2, page_size=4, max_seq_len=24, **kw)
        with pytest.raises(ValueError, match=match):
            JServer(model, params, JServerConfig(**cfg))
        with pytest.raises(ValueError, match=match):
            Server(tmodel, tparams, ServerConfig(**cfg), device="cpu")
    assert [f.name for f in dataclasses.fields(ServerConfig)] == [
        f.name for f in dataclasses.fields(JServerConfig)]


def test_warmup_then_reset_keeps_the_pools(fp32_pair):
    _, _, tmodel, tparams = fp32_pair
    server = Server(tmodel, tparams, ServerConfig(**BASE, prefix_cache=True, prefill_chunk=4),
                    device="cpu")
    pools = server.cache.pools
    server.warmup([5, 9])
    assert server.stats.decode_steps == 0 and not server.results
    assert server.cache.allocator.num_held == 0 and server.cache.allocator.num_published == 0
    assert not server.scheduler.has_work() and server.engine.num_inflight == 0
    assert server.cache.pools is pools
    assert server.submit([1, 2, 3], max_new_tokens=2).rid == 0


def test_bucket_policy_and_fresh_with_steps_in_flight(fp32_pair):
    _, _, tmodel, tparams = fp32_pair
    server = Server(tmodel, tparams, ServerConfig(
        num_slots=6, page_size=4, max_seq_len=24, prefill_chunk=4, prefill_batch=True,
        async_depth=2), device="cpu")
    eng = server.engine
    assert P_BUCKETS == (1, 2, 4, 8)
    assert eng.allowed_buckets() == (1, 2, 4)
    assert [eng.bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    server.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    server.step()
    assert eng.num_inflight == 1
    with pytest.raises(RuntimeError, match="in flight"):
        eng.fresh()
    server.reset()
    assert eng.num_inflight == 0


def test_staged_inputs_keep_their_values():
    """One step's host arrays travel as one int32 buffer: float32 by its
    bits, bool as 0/1, integers as they are."""
    from repro_torch.serving.engine import _pack, _views

    arrays = {"f": np.array([0.5, -1.25, 1e-7, 0.0], np.float32),
              "b": np.array([True, False, True]),
              "i": np.arange(6, dtype=np.int32).reshape(2, 3)}
    words, layout = _pack(arrays)
    assert words.dtype == np.int32 and words.size == 13
    got = _views(torch.from_numpy(words), layout)
    assert torch.equal(got["f"], torch.from_numpy(arrays["f"]))
    assert (got["b"] != 0).tolist() == [True, False, True]
    assert torch.equal(got["i"], torch.from_numpy(arrays["i"]))


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=4, prefill_batch=True, async_depth=1)])
def test_sampling_parameters_reach_the_step(kw, fp32_pair):
    """Temperature 1 with top-k 1 must give the greedy tokens: the staged
    temperature and top-k reach every prefill and decode step (a lost
    top-k would sample the whole vocabulary)."""
    _, _, tmodel, tparams = fp32_pair
    prompts = _prompts(tmodel.cfg.vocab_size, (5, 11, 7), seed=12)
    outs = []
    for sampling in (SamplingParams(), SamplingParams(temperature=1.0, top_k=1)):
        server = Server(tmodel, tparams, ServerConfig(**{**BASE, "num_slots": 3, **kw}),
                        device="cpu")
        reqs = [server.submit(p, max_new_tokens=6, sampling=sampling) for p in prompts]
        results = server.run()
        outs.append([results[r.rid].out_tokens for r in reqs])
    assert outs[0] == outs[1]


def test_graph_decode_is_off_on_the_cpu(fp32_pair):
    """On the CPU the engine captures nothing, whatever ``graph_decode``
    says: the keyword is accepted and ignored."""
    _, _, tmodel, tparams = fp32_pair
    cfg = ServerConfig(**BASE)
    for flag in (True, False):
        eng = EngineCore(tmodel, tparams, cfg, graph_decode=flag)
        assert eng.graph_decode is False
    server, _ = _run(tmodel, tparams, _prompts(tmodel.cfg.vocab_size, (5, 6)), (3, 3))
    assert server.engine.graph_captures == server.engine.graph_replays == 0


# -- static-batch serving ---------------------------------------------------------

@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_generate_static_matches_reference(case, model_pairs):
    model, params, tmodel, tparams = model_pairs[case]
    tokens = np.stack(_prompts(model.cfg.vocab_size, (7, 7), seed=9)).astype(np.int32)
    want, _ = jgenerate_static(model, params, {"tokens": jnp.asarray(tokens)}, max_new_tokens=5)
    got, stats = generate_static(tmodel, tparams, {"tokens": torch.from_numpy(tokens)},
                                 max_new_tokens=5)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats.batch == 2 and stats.steady_steps == 3 and stats.decode_tok_s > 0


def test_continuous_matches_own_generate_static(fp32_pair):
    """Greedy continuous batching (chunked, batched, depth 1) gives each
    prompt the tokens the port's static path gives it alone."""
    _, _, tmodel, tparams = fp32_pair
    prompts = _prompts(tmodel.cfg.vocab_size, (5, 11, 7), seed=10)
    gens = (6, 3, 8)
    _, outs = _run(tmodel, tparams, prompts, gens, num_slots=3, prefill_chunk=4,
                   prefill_batch=True, async_depth=1)
    for p, g, out in zip(prompts, gens, outs):
        ref, _ = generate_static(tmodel, tparams, {"tokens": torch.tensor([p])},
                                 max_new_tokens=g)
        assert out == list(ref[0])


# -- the launcher -----------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--chunked-prefill", "4", "--prefill-batch", "--prefix-cache", "--async-depth", "1"],
    ["--chunked-prefill", "4", "--preempt", "--prefix-cache", "--priority", "1"],
    ["--mode", "static"],
])
def test_serve_launcher_on_the_cpu(flags, capsys):
    server, results = tserve.main(["--smoke", "--device", "cpu", "--requests", "4",
                                   "--prompt-len", "6", "--max-new", "3", *flags])
    out = capsys.readouterr().out
    if "static" in flags:
        assert server is None and results.shape == (4, 3)
        assert "steady-state decode" in out
        return
    assert len(results) == 4 and all(r.num_generated == 3 for r in results.values())
    assert "prefix cache: hit-rate" in out
    if "--preempt" in flags:
        assert "preemptions:" in out
