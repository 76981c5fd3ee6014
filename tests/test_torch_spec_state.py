"""Speculative decoding over recurrent state rows, the port against the JAX
package's, on the CPU: recurrentgemma-2b (RG-LRU with windowed local
attention) and xlstm-125m (mLSTM and sLSTM, no KV pages) SMOKE as
targets, xlstm-125m SMOKE as a model drafter.

Parameters come from the reference's ``init`` through ``params_from_jax``,
inputs are numpy draws from fixed seeds, and everything runs in fp32 with
fp32 pages on the port's plain path. Tolerances, and why:

- state rows and logits against the reference: 1e-5 of the max, the
  fp32 bound of ``tests/test_torch_recurrent.py`` (the mLSTM's einsums,
  normaliser and ``cumsum`` sum in another order than XLA's, and the
  RG-LRU keeps torch's transcendentals);
- the verify pass (``commit=False``) against the rows before it: bit for
  bit, since it writes every row back unchanged;
- greedy token streams: equal, token for token.
"""
import dataclasses
import functools

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
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import redmule_gemm as rg  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    GREEDY,
    ModelDrafter,
    Server,
    ServerConfig,
    SpecConfig,
    generate_static,
)

FP32 = dict(policy="fp32", kv_cache_dtype="fp32")
TOL = 1e-5
PS = 4
CONFIG = dict(num_slots=2, page_size=PS, max_seq_len=48)
MAX_NEW = 12


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **FP32)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), **FP32)
    tmodel = Transformer(tcfg, engine=Engine(policy="fp32", backend="torch"), device="cpu")
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


def _jit(fn):
    """The reference's entry point jitted (its compiled rounding order)."""
    static = ("page_size", "commit") if fn.__name__ == "verify_cb" else ("page_size",)
    return jax.jit(fn, static_argnames=static)


def _rel(want, got) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(want - got.numpy()).max() / max(np.abs(want).max(), 1e-30))


def _ref_rows(tmodel, pools, slot):
    """The reference's state rows of ``slot`` by port layer (unit u's layer
    j is layer u * len(pattern) + j, then the remainder layers)."""
    pattern, rows = tmodel.pattern, {}
    for j in range(len(pattern)):
        st = pools["units"][f"b{j}"].get("state") if pools["units"] else None
        for u in range(0 if st is None else next(iter(st.values())).shape[0]):
            rows[u * len(pattern) + j] = {k: np.asarray(v[u, slot]) for k, v in st.items()}
    n = tmodel.cfg.n_layers - len(pools["rem"])
    for i in range(len(pools["rem"])):
        st = pools["rem"][f"r{i}"].get("state")
        if st is not None:
            rows[n + i] = {k: np.asarray(v[slot]) for k, v in st.items()}
    return rows


def _rows(tpools):
    return [{k: v.clone() for k, v in p["state"].items()} for p in tpools if "state" in p]


# Two slots prefilled (9 and 14 tokens), then a verify row of 5 positions
# each; the commit pass clamps them to 3 and 1 (accepted 2 and 0).
_PREFILL = ((0, 9), (1, 14))
_VERIFY_LENGTHS = np.asarray([5, 5], np.int32)
_COMMIT_LENGTHS = np.asarray([3, 1], np.int32)


def _prefilled(arch):
    model, params, tmodel, tparams = _pair(arch)
    v = model.cfg.vocab_size
    pools = model.init_state_store(2, 16, PS)
    tpools = tmodel.init_state_store(2, 16, PS)
    pt = np.zeros((2, 7), np.int32)
    pt[0, :4], pt[1, :6] = [1, 2, 3, 4], [5, 6, 7, 8, 9, 10]
    rng = np.random.default_rng(3)
    for slot, n in _PREFILL:
        toks = rng.integers(0, v, (1, 16)).astype(np.int32)
        _, pools = _jit(model.prefill_cb)(params, jnp.asarray(toks), pools,
                                          jnp.asarray(pt[slot]), jnp.int32(slot), jnp.int32(0),
                                          jnp.int32(n), page_size=PS)
        with torch.inference_mode():
            tmodel.prefill_cb(tparams, torch.from_numpy(toks), tpools,
                              torch.from_numpy(pt[slot]), slot, 0, n, page_size=PS)
    tokens = rng.integers(0, v, (2, 5)).astype(np.int32)
    seq_lens = np.asarray([n for _, n in _PREFILL], np.int32)
    return model, params, tmodel, tparams, pools, tpools, pt, tokens, seq_lens


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-125m"])
def test_verify_keeps_state_rows_and_commit_matches_reference(arch):
    """The verify pass (``commit=False``) leaves every state row as it was,
    bit for bit, with logits at every position within 1e-5 of the
    reference's; the commit pass (``commit=True``, lengths clamped to
    accepted + 1) leaves the rows the reference's commit pass leaves, and
    the next decode step over them (which reads the rewritten K/V) gives
    the reference's logits."""
    model, params, tmodel, tparams, pools, tpools, pt, tokens, seq_lens = _prefilled(arch)
    active = np.ones((2,), bool)
    before = _rows(tpools)
    args = (jnp.asarray(pt), jnp.asarray(seq_lens))
    targs = (torch.from_numpy(pt), torch.from_numpy(seq_lens))
    want, _ = _jit(model.verify_cb)(params, jnp.asarray(tokens), pools, *args,
                                    jnp.asarray(_VERIFY_LENGTHS), jnp.asarray(active),
                                    page_size=PS, commit=False)
    with torch.inference_mode():
        got = tmodel.verify_cb(tparams, torch.from_numpy(tokens), tpools, *targs,
                               torch.from_numpy(_VERIFY_LENGTHS), torch.from_numpy(active),
                               page_size=PS, commit=False)
    assert _rel(want, got) <= TOL
    for a, b in zip(before, _rows(tpools)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    _, pools = _jit(model.verify_cb)(params, jnp.asarray(tokens), pools, *args,
                                     jnp.asarray(_COMMIT_LENGTHS), jnp.asarray(active),
                                     page_size=PS, commit=True)
    with torch.inference_mode():
        tmodel.verify_cb(tparams, torch.from_numpy(tokens), tpools, *targs,
                         torch.from_numpy(_COMMIT_LENGTHS), torch.from_numpy(active),
                         page_size=PS, commit=True)
    for slot in (0, 1):
        for i, leaves in _ref_rows(tmodel, pools, slot).items():
            for k, v in leaves.items():
                assert _rel(v, tpools[i]["state"][k][slot]) <= TOL, (slot, i, k)
    lens = seq_lens + _COMMIT_LENGTHS
    dec = np.asarray([[7], [11]], np.int32)
    want, _ = _jit(model.decode_cb)(params, jnp.asarray(dec), pools, jnp.asarray(pt),
                                    jnp.asarray(lens), jnp.asarray(active), page_size=PS)
    with torch.inference_mode():
        got = tmodel.decode_cb(tparams, torch.from_numpy(dec), tpools, torch.from_numpy(pt),
                               torch.from_numpy(lens), torch.from_numpy(active), page_size=PS)
    assert _rel(want, got) <= TOL


def test_commit_pass_takes_the_verify_pass_schedules(monkeypatch):
    """Under redmule_hfp8 the commit pass's GEMMs are the verify pass's, the
    same shapes through the same plans (schedule, copies): the K/V it
    rewrites come from the same kernels as those the verify pass attended
    to."""
    cfg = dataclasses.replace(tget_config("recurrentgemma-2b", smoke=True),
                              policy="redmule_hfp8", kv_cache_dtype="e4m3")
    tmodel = Transformer(cfg, engine=Engine(policy=cfg.policy, backend="torch"), device="cpu",
                         fused_decode=True)
    tparams = tmodel.init(0)
    plans = []
    orig = ops.redmule_gemm_plain

    def record(x, w, y, *, gop, policy, out_dtype):
        plans.append((tuple(x.shape), tuple(w.shape), rg.plan_call(x, w, y, gop=gop,
                                                                     policy=policy).plan))
        return orig(x, w, y, gop=gop, policy=policy, out_dtype=out_dtype)

    monkeypatch.setattr(ops, "redmule_gemm_plain", record)
    pools = tmodel.init_state_store(4, 16, PS)
    pt = torch.arange(1, 13, dtype=torch.int32).reshape(4, 3)
    seq_lens = torch.tensor([4, 2, 0, 6], dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    tokens = torch.randint(0, cfg.vocab_size, (4, 5), generator=torch.Generator().manual_seed(0))
    runs = []
    for lengths, commit in (([5, 5, 0, 5], False), ([3, 1, 0, 5], True)):
        with torch.inference_mode():
            tmodel.verify_cb(tparams, tokens, pools, pt, seq_lens,
                             torch.tensor(lengths, dtype=torch.int32), active, page_size=PS,
                             commit=commit)
        runs.append(plans[:])
        plans.clear()
    verify, commit = runs
    assert verify and verify == commit


# -- greedy parity through the server ---------------------------------------------------

_PROMPTS = ([3, 5, 7, 9, 3, 5, 7, 9, 3, 5], [11, 4, 11, 4, 11, 4, 2], [1, 2, 3, 4, 5, 6, 7, 8])


def _port_static(tmodel, tparams):
    return [generate_static(tmodel, tparams, {"tokens": torch.tensor([p])},
                            max_new_tokens=MAX_NEW)[0][0].tolist() for p in _PROMPTS]


def _run(server):
    for p in _PROMPTS:
        server.submit(p, max_new_tokens=MAX_NEW)
    return {rid: r.out_tokens for rid, r in server.run().items()}


@pytest.mark.parametrize("arch,drafter", [("recurrentgemma-2b", "ngram"),
                                          ("xlstm-125m", "ngram"),
                                          ("xlstm-125m", "model")])
def test_spec_greedy_with_state_rows_matches_static_and_reference(arch, drafter):
    """Greedy speculative output through the port's server equals the port's
    own static greedy chain and the reference's speculative server, token
    for token, with the same rounds, drafts fielded and accepted (the
    drafter: xlstm-125m on other parameters, seed 1, whose greedy drafts
    are all rejected, so every round restores the snapshot). Nothing is
    left held."""
    model, params, tmodel, tparams = _pair(arch)
    jkw, kw = {"spec": JSpecConfig(k=3)}, {"spec": SpecConfig(k=3)}
    if drafter == "model":
        dmodel, dparams, tdmodel, tdparams = _pair("xlstm-125m", 1)
        jkw |= {"draft_model": dmodel, "draft_params": dparams}
        kw |= {"draft_model": tdmodel, "draft_params": tdparams}
    server = Server(tmodel, tparams, ServerConfig(**CONFIG), device="cpu", **kw)
    got = _run(server)
    jserver = JServer(model, params, JServerConfig(**CONFIG), **jkw)
    want = _run(jserver)
    assert got == want
    assert [got[r] for r in sorted(got)] == _port_static(tmodel, tparams)
    for name in ("spec_steps", "spec_drafted", "spec_accepted", "decode_tokens"):
        assert getattr(server.stats, name) == getattr(jserver.stats, name), name
    assert server.stats.spec_steps > 0 and server.stats.spec_drafted > 0
    if drafter == "ngram":
        assert server.stats.spec_accepted > 0
    assert server.cache.allocator.num_held == 0


def test_spec_with_its_own_parameters_as_drafter_accepts_every_draft():
    """xlstm-125m drafting for itself: greedy drafts are the target's own
    chain, so every draft is accepted, the commit pass takes full lengths,
    and the output is the static chain."""
    _, _, tmodel, tparams = _pair("xlstm-125m")
    server = Server(tmodel, tparams, ServerConfig(**CONFIG), device="cpu",
                    spec=SpecConfig(k=3), draft_model=tmodel, draft_params=tparams)
    got = _run(server)
    assert [got[r] for r in sorted(got)] == _port_static(tmodel, tparams)
    assert server.stats.acceptance_rate == 1.0


def test_drafter_state_rows_after_a_round_equal_a_caught_up_drafter():
    """d1 drafts a round (k = 4: three draft decode steps commit its state
    rows in place, then the snapshot is restored); d2 only catches up on
    the same histories. Their state rows are the same bit for bit, and so
    are their next proposals."""
    _, _, tmodel, tparams = _pair("xlstm-125m", 1)
    kw = dict(num_slots=2, page_size=PS, max_seq_len=48, k=4)
    d1, d2 = ModelDrafter(tmodel, tparams, **kw), ModelDrafter(tmodel, tparams, **kw)
    ctx = {0: [3, 5, 7, 9, 3, 5], 1: [11, 4, 11, 4]}
    want = np.asarray([4, 4], np.int32)
    with torch.inference_mode():
        first = d1.propose(ctx, want, torch.Generator().manual_seed(0), [GREEDY] * 2)
        d2._replay(ctx)
        assert all(torch.equal(a, b) for a, b in zip(d1._rows, d2._rows))
        ctx2 = {s: ctx[s] + [int(first.tokens[s, 0]) ^ 1, 7] for s in ctx}
        got = d1.propose(ctx2, want, torch.Generator().manual_seed(1), [GREEDY] * 2)
        ref = d2.propose(ctx2, want, torch.Generator().manual_seed(1), [GREEDY] * 2)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert torch.equal(got.logits, ref.logits)
    assert all(torch.equal(a, b) for a, b in zip(d1._rows, d2._rows))
    assert d1.store.kv_bytes() == 0 and d1.store.allocator.num_held == 0


def test_spec_recycles_window_pages_within_the_reservation():
    """recurrentgemma's local attention (window 16 at smoke size) on a
    40-token prompt in chunks of 8, 16 new tokens with k = 3: the verify
    pass writes past the committed length, and the pages held never exceed
    the windowed reservation, below the request's span; the tokens are the
    plain server's."""
    _, _, tmodel, tparams = _pair("recurrentgemma-2b")
    motif = [int(t) for t in np.random.default_rng(9).integers(0, 256, 8)]
    prompt, total = (motif * 5)[:40], 56
    cfg = ServerConfig(num_slots=2, page_size=PS, max_seq_len=total, prefill_chunk=8)
    out = {}
    for name, spec in (("plain", None), ("spec", SpecConfig(k=3))):
        server = Server(tmodel, tparams, cfg, device="cpu", spec=spec)
        req = server.submit(prompt, max_new_tokens=16)
        held = []
        while server.scheduler.has_work():
            server.step()
            held.append(server.cache.allocator.num_held)
        out[name] = req.out_tokens
    assert out["spec"] == out["plain"] and server.stats.spec_accepted > 0
    cap, span = server.scheduler.worst_pages(total), server.cache.allocator.pages_for(total)
    assert max(held) <= cap < span
