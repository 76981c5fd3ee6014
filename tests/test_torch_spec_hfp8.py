"""Speculative decoding over state rows under redmule_hfp8, the port against
the JAX package's, on the CPU: xlstm-125m SMOKE with E4M3 pages, the three
prompts of ``tests/test_torch_spec_state.py``, 12 new tokens, k = 3
(parameters from the reference's ``init`` through ``params_from_jax``).

Under fp32 the port's speculative streams are the reference's token for
token (``test_torch_spec_state.py``). Under redmule_hfp8 they are too: the
port's plain path rounds xlstm's exp, log1p, tanh and logistic as XLA's
compiled code does (``models/common.py``), so the verify rows the greedy
decisions read are the reference's bit for bit, and a near-tie between two
tokens falls the same way in both packages:

- plain serving, and speculation with the target's own parameters as the
  drafter, give the reference's tokens and counters;
- so does the n-gram drafter, whose stream (before the XLA-rounded
  functions) parted from the reference's at a near-tie of 0.00098.

The plain and own-parameter runs take the reference's streams from a
subprocess with ``PYTHONHASHSEED=0``: run in processes of their own, three
at a time, the reference's own-parameter stream parted at a near tie in
1 of 36 runs, and in 2 of 33 with single-threaded XLA
(``--xla_cpu_multi_thread_eigen=false``); with the hash seed fixed it was
the same in 33 of 33, and it is the port's.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

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


# The reference's serving runs (tokens and counters) in a subprocess, by
# drafter: "none" and "own parameters".
_REFERENCE = """
import dataclasses, json
import jax
from repro.configs import get_config
from repro.models import build
from repro.serving import Server, ServerConfig, SpecConfig

cfg = dataclasses.replace(get_config("xlstm-125m", smoke=True), **HFP8)
model = build(cfg)
params = model.init(jax.random.PRNGKey(0))
result = {}
for drafter in ("none", "own parameters"):
    kw = {}
    if drafter == "own parameters":
        kw = {"spec": SpecConfig(k=3), "draft_model": model, "draft_params": params}
    server = Server(model, params, ServerConfig(**CONFIG), **kw)
    for p in PROMPTS:
        server.submit(p, max_new_tokens=MAX_NEW)
    out = {rid: r.out_tokens for rid, r in server.run().items()}
    result[drafter] = {"tokens": sorted(out.items()),
                       "stats": {n: getattr(server.stats, n) for n in STATS}}
print("RESULT " + json.dumps(result))
"""
STATS = ("spec_steps", "spec_drafted", "spec_accepted", "decode_tokens")


@functools.lru_cache(maxsize=None)
def _reference_runs() -> dict:
    """The reference server's tokens and counters by drafter, run where its
    stream is pinned (the module docstring)."""
    code = "\n".join(f"{k} = {v!r}" for k, v in dict(
        HFP8=HFP8, CONFIG=CONFIG, MAX_NEW=MAX_NEW, PROMPTS=PROMPTS, STATS=STATS).items())
    code += _REFERENCE
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
    return {drafter: ({rid: toks for rid, toks in out["tokens"]}, out["stats"])
            for drafter, out in json.loads(line[len("RESULT "):]).items()}


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
    _, _, tmodel, tparams = _pair()
    kw = {}
    if drafter == "own parameters":
        kw = {"spec": SpecConfig(k=3), "draft_model": tmodel, "draft_params": tparams}
    server = Server(tmodel, tparams, ServerConfig(**CONFIG), device="cpu", **kw)
    want, want_stats = _reference_runs()[drafter]
    got = _run(server)
    assert got == want
    for name in STATS:
        assert getattr(server.stats, name) == want_stats[name], name
    if drafter != "none":
        assert server.stats.spec_steps > 0 and server.stats.spec_accepted > 0


def test_ngram_spec_matches_the_reference_with_its_verify_rows():
    model, params, tmodel, tparams = _pair()
    server = Server(tmodel, tparams, ServerConfig(**CONFIG), device="cpu",
                    spec=SpecConfig(k=3, ngram_n=3))
    jserver = JServer(model, params, JServerConfig(**CONFIG), spec=JSpecConfig(k=3, ngram_n=3))
    rows, jrows = {}, {}
    record_rows(server, rows)
    _record_reference_rows(jserver, jrows)
    got, want = _run(server), _run(jserver)
    assert got == want and server.stats.spec_accepted > 0
    for name in ("spec_steps", "spec_drafted", "spec_accepted", "decode_tokens"):
        assert getattr(server.stats, name) == getattr(jserver.stats, name), name
    assert rows.keys() == jrows.keys()
    for key, row in rows.items():
        assert torch.equal(row, jrows[key]), key
    # The gate's accounting of the two streams finds no split and no noise.
    assert greedy_accounting(got, want, rows, jrows) == (0.0, [], [])
