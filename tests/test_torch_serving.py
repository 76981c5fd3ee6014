"""The port's serving layer: greedy parity with the JAX package's Server,
the page allocator and admission units, and sampling-filter parity."""
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
from repro.serving.sampling import filter_logits as jfilter_logits  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.serving import SamplingParams, Server, ServerConfig  # noqa: E402
from repro_torch.serving.cache import NULL_PAGE, OutOfPagesError, PagePool  # noqa: E402
from repro_torch.serving.sampling import filter_logits, sample_logits  # noqa: E402
from repro_torch.serving.scheduler import FINISH_EOS, FINISH_LENGTH, Request, Scheduler  # noqa: E402


@pytest.fixture(scope="module")
def smoke_models():
    kw = dict(policy="fp32", kv_cache_dtype="fp32")
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), **kw)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tget_config("granite-3-8b", smoke=True), **kw)
    tmodel = tbuild(tcfg, device="cpu")
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


def test_greedy_tokens_equal_reference_server(smoke_models):
    """The case of test_paged_decode.py's serving parity test: the port's
    Server must emit exactly the reference Server's greedy tokens."""
    model, params, tmodel, tparams = smoke_models
    g = np.random.default_rng(7)
    prompts = [list(g.integers(0, model.cfg.vocab_size, size=n)) for n in (5, 9, 3)]
    ref = JServer(model, params, JServerConfig(
        num_slots=2, page_size=4, max_seq_len=24, prefill_bucket=8))
    ref_reqs = [ref.submit(p, max_new_tokens=6) for p in prompts]
    ref_out = ref.run()
    server = Server(tmodel, tparams, ServerConfig(
        num_slots=2, page_size=4, max_seq_len=24, prefill_bucket=8), device="cpu")
    reqs = [server.submit(p, max_new_tokens=6) for p in prompts]
    with torch.inference_mode():
        out = server.run()
    for r, rr in zip(reqs, ref_reqs):
        assert out[r.rid].out_tokens == ref_out[rr.rid].out_tokens
        assert out[r.rid].finish_reason == FINISH_LENGTH
    s = server.stats
    assert s.prefill_calls == 3 and s.decode_tokens == 3 * 5
    assert s.nonfinite_steps == 0 and 0 < s.utilization <= 1


def test_eos_finishes_a_request_and_frees_its_slot(smoke_models):
    _, _, tmodel, tparams = smoke_models
    prompt = [3, 1, 4, 1, 5]
    cfg = ServerConfig(num_slots=1, page_size=4, max_seq_len=16, prefill_bucket=8)
    with torch.inference_mode():
        probe = Server(tmodel, tparams, cfg, device="cpu")
        r = probe.submit(prompt, max_new_tokens=8)
        tokens = probe.run()[r.rid].out_tokens
        # EOS is the first token that did not occur before it, so the
        # request must stop exactly there.
        stop = next(i for i, t in enumerate(tokens) if i > 0 and t not in tokens[:i])
        server = Server(tmodel, tparams, cfg, device="cpu")
        a = server.submit(prompt, max_new_tokens=8, eos_id=tokens[stop])
        b = server.submit(prompt, max_new_tokens=2)
        events = list(server.stream())
    assert server.results[a.rid].out_tokens == tokens[:stop + 1]
    assert server.results[a.rid].finish_reason == FINISH_EOS
    assert server.results[b.rid].finish_reason == FINISH_LENGTH
    assert [e.rid for e in events if e.finished] == [a.rid, b.rid]
    assert server.cache.allocator.num_held == 0
    assert (server.cache.page_table == NULL_PAGE).all()


def test_page_pool_refcounts_and_null_page():
    pool = PagePool(num_pages=4, page_size=8)
    pages = pool.alloc(3)
    assert NULL_PAGE not in pages and pool.num_free == 0
    with pytest.raises(OutOfPagesError):
        pool.alloc(1)
    pool.incref([pages[0]])
    pool.decref([pages[0]])
    assert pool.ref(pages[0]) == 1 and pool.num_free == 0
    pool.decref(pages)
    assert pool.num_free == 3 and pool.num_held == 0
    with pytest.raises(ValueError):
        pool.decref([pages[0]])
    assert pool.pages_for(17) == 3
    with pytest.raises(ValueError):
        PagePool(num_pages=1, page_size=8)


def test_admission_reserves_worst_case_pages_in_fifo_order():
    pool = PagePool(num_pages=6, page_size=4)  # 5 allocatable pages
    sched = Scheduler(num_slots=3, pool=pool, pages_per_slot=4, max_seq_len=16)
    big = sched.submit(Request(prompt=[1] * 6, max_new_tokens=6))  # 12 tokens: 3 pages
    also_big = sched.submit(Request(prompt=[1] * 6, max_new_tokens=6))
    small = sched.submit(Request(prompt=[1], max_new_tokens=1))  # fits, but queued behind
    assert sched.admit() == [big]  # 3 reserved; 2 left < 3 for the next head
    assert sched.ensure_pages(big, 6) == [(0, 1), (1, 2)]
    assert sched.ensure_page(big, 7) is None and sched.ensure_page(big, 8) == (2, 3)
    assert sched.admit() == []  # FIFO: small waits behind also_big
    assert not sched.commit(big, 9)
    big.out_tokens += [0] * 4
    assert sched.commit(big, 9) and big.finish_reason == FINISH_LENGTH
    sched.finish(big)
    sched.finish(big)  # idempotent
    assert pool.num_free == 5
    assert sched.admit() == [also_big, small]
    with pytest.raises(ValueError):
        sched.submit(Request(prompt=[1] * 16))  # leaves no room to generate
    with pytest.raises(ValueError):
        sched.submit(Request(prompt=[]))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.5, 3, 0.5), (1.0, 0, 0.0), (1e-3, 1, 1.0),
])
def test_filter_logits_matches_reference(temperature, top_k, top_p):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 64)) * 3).astype(np.float32)
    t = np.full(3, temperature, np.float32)
    k = np.full(3, top_k, np.int32)
    p = np.full(3, top_p, np.float32)
    want = np.asarray(jfilter_logits(jnp.asarray(logits), jnp.asarray(t), jnp.asarray(k),
                                     jnp.asarray(p)))
    got = filter_logits(torch.from_numpy(logits), torch.from_numpy(t), torch.from_numpy(k),
                        torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sample_logits_greedy_rows_and_filtered_support():
    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    params = SamplingParams(temperature=0.9, top_k=3)
    t = torch.tensor([0.0, params.temperature, params.temperature, 0.0])
    k = torch.tensor([0, params.top_k, params.top_k, 0], dtype=torch.int32)
    p = torch.ones(4)
    for _ in range(20):
        toks = sample_logits(logits, gen, t, k, p)
        assert toks.dtype == torch.int32
        assert toks[0] == logits[0].argmax() and toks[3] == logits[3].argmax()
        for row in (1, 2):
            assert int(toks[row]) in logits[row].topk(3).indices.tolist()
