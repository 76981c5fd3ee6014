"""Speculative decoding over state rows under redmule_hfp8, the port against
the JAX package's, on the CPU: xlstm-125m SMOKE with E4M3 pages, the three
prompts of ``tests/test_torch_spec_state.py``, 12 new tokens, k = 3
(parameters from the reference's ``init`` through ``params_from_jax``).

Under fp32 the port's speculative streams are the reference's token for
token (``test_torch_spec_state.py``). Under redmule_hfp8 the model's entry
points are bitwise against the reference's at these inputs, but its fp32
state rows differ by about an ulp of XLA's exp, log1p and sigmoid, which
one E4M3 rounding can turn into a greedy near-tie flip. So:

- plain serving, and speculation with the target's own parameters as the
  drafter, give the reference's tokens, token for token;
- the n-gram drafter's stream is the reference's up to its first
  divergence, and at a divergence the reference preferred its token by a
  margin no larger than the largest change, between the two packages, of
  a top-2 margin of the verify rows at the positions where the streams
  still agree (``launch/spec_gate.py::greedy_accounting``, the port's rows
  against the reference's).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config  # noqa: E402
from repro.models import build  # noqa: E402
from repro.serving import Server as JServer  # noqa: E402
from repro.serving import ServerConfig as JServerConfig  # noqa: E402
from repro.serving import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.launch.spec_gate import greedy_accounting, record_rows  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serving import Server, ServerConfig, SpecConfig  # noqa: E402

HFP8 = dict(policy="redmule_hfp8", kv_cache_dtype="e4m3")
CONFIG = dict(num_slots=2, page_size=4, max_seq_len=48)
MAX_NEW = 12
PROMPTS = ([3, 5, 7, 9, 3, 5, 7, 9, 3, 5], [11, 4, 11, 4, 11, 4, 2], [1, 2, 3, 4, 5, 6, 7, 8])


@functools.lru_cache(maxsize=None)
def _pair():
    cfg = dataclasses.replace(get_config("xlstm-125m", smoke=True), **HFP8)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tget_config("xlstm-125m", smoke=True), **HFP8)
    tmodel = Transformer(tcfg, engine=Engine(policy="redmule_hfp8", backend="torch"),
                         device="cpu")
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


def _run(server):
    for p in PROMPTS:
        server.submit(p, max_new_tokens=MAX_NEW)
    return {rid: r.out_tokens for rid, r in server.run().items()}


def _record_reference_rows(jserver, rows: dict) -> None:
    """``record_rows`` for the reference's server: the verify logits row each
    emitted token after the first was sampled from, keyed (rid, index)."""
    verify = jserver.verifier.verify

    def verify_rows(params, tokens, pools, page_table, seq_lens, lengths, active):
        logits, pools = verify(params, tokens, pools, page_table, seq_lens, lengths, active)
        host, lens = np.asarray(logits, np.float32), np.asarray(lengths)
        for slot, req in jserver.scheduler.running.items():
            for j in range(int(lens[slot])):
                rows[(req.rid, req.num_generated + j)] = torch.from_numpy(host[slot, j].copy())
        return logits, pools

    jserver.verifier.verify = verify_rows


@pytest.mark.parametrize("drafter", ["none", "own parameters"])
def test_plain_and_own_parameter_spec_match_the_reference(drafter):
    model, params, tmodel, tparams = _pair()
    jkw, kw = {}, {}
    if drafter == "own parameters":
        jkw = {"spec": JSpecConfig(k=3), "draft_model": model, "draft_params": params}
        kw = {"spec": SpecConfig(k=3), "draft_model": tmodel, "draft_params": tparams}
    server = Server(tmodel, tparams, ServerConfig(**CONFIG), device="cpu", **kw)
    jserver = JServer(model, params, JServerConfig(**CONFIG), **jkw)
    got, want = _run(server), _run(jserver)
    assert got == want
    for name in ("spec_steps", "spec_drafted", "spec_accepted", "decode_tokens"):
        assert getattr(server.stats, name) == getattr(jserver.stats, name), name
    if drafter != "none":
        assert server.stats.spec_steps > 0 and server.stats.spec_accepted > 0


def test_ngram_spec_parts_from_the_reference_only_within_the_row_noise():
    model, params, tmodel, tparams = _pair()
    server = Server(tmodel, tparams, ServerConfig(**CONFIG), device="cpu",
                    spec=SpecConfig(k=3, ngram_n=3))
    jserver = JServer(model, params, JServerConfig(**CONFIG), spec=JSpecConfig(k=3, ngram_n=3))
    rows, jrows = {}, {}
    record_rows(server, rows)
    _record_reference_rows(jserver, jrows)
    got, want = _run(server), _run(jserver)
    assert set(got) == set(want) and server.stats.spec_accepted > 0
    noise, splits, unexplained = greedy_accounting(got, want, rows, jrows)
    assert not unexplained, (noise, splits)
    for rid, first, margin in splits:
        # Equal up to the first divergence, and a near-tie there.
        assert got[rid][:first] == want[rid][:first] and 0 < margin <= noise
    # Where no request parts, the streams are the reference's outright.
    if not splits:
        assert got == want
