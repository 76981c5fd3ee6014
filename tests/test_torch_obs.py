"""Observability of the port (``repro_torch.obs`` and its wiring through the
serving stack and the launcher) against the JAX package's ``repro.obs``,
on the CPU with the plain path.

- the registry: the same observations give the reference's ``snapshot()``
  and ``to_prometheus()`` text, string for string;
- the tracer: the same calls give the reference's Chrome events (the
  timestamps aside), and ``scripts/validate_trace.py`` (loaded by path, not
  edited) accepts them and rejects broken ones;
- the server at granite-3-8b SMOKE under fp32 (parameters from the
  reference's ``init``, fp32 pages), on a chunked-prefill workload with one
  step in flight and on a speculative one (n-gram drafts): the reference's
  tokens, its counters and gauges but the seconds, its histogram counts
  and its trace's event sequence without ``ts``/``dur``/``wait_s``; tokens
  equal with the tracer on and off; a full span chain per request;
  ``reset()`` zeroing all but the step profiler; the launcher's
  ``--trace-out``/``--metrics-out``/``--profile LOGDIR``.
"""
import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.obs as jobs  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models import build  # noqa: E402
from repro.serving import Server as JServer  # noqa: E402
from repro.serving import ServerConfig as JServerConfig  # noqa: E402
from repro.serving import SpecConfig as JSpecConfig  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.serving import Server, ServerConfig, SpecConfig  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FP32 = dict(policy="fp32", kv_cache_dtype="fp32")
PROMPTS = [[3, 5, 7, 9, 3, 5, 7, 9, 3, 5], [11, 4, 11, 4, 11, 4, 2], [1, 2, 3, 4, 5, 6, 7, 8],
           [9, 8, 7, 9, 8, 7, 9, 8, 7, 9, 8]]
# The two workloads: chunked prefill with one step in flight, and
# speculative rounds (n-gram drafts) after chunked prefill.
WORKLOADS = {
    "chunked": dict(config=dict(prefill_chunk=4, async_depth=1), spec=None),
    "spec": dict(config=dict(prefill_chunk=4), spec=3),
}
CONFIG = dict(num_slots=2, page_size=8, max_seq_len=32)
# The port's one metric the reference lacks.
PORT_ONLY = {"serving_nonfinite_steps_total"}


def _validator():
    spec = importlib.util.spec_from_file_location("validate_trace",
                                                  ROOT / "scripts" / "validate_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the registry ----------------------------------------------------------------

def _feed(mod, seed):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", "requests")
    g = reg.gauge("queue_depth")
    h = reg.histogram("latency_seconds", help="one step")
    acc = reg.histogram("accepted", bounds=list(range(5)))
    for _ in range(50):
        c.inc(float(rng.integers(0, 3)))
        g.set(float(rng.integers(0, 9)))
        h.observe(float(rng.lognormal(-7, 2)))
        acc.observe(int(rng.integers(0, 7)))
    h.observe(1e-5)  # on an edge: le semantics
    h.observe(1e9)  # past the last edge
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_registry_snapshot_and_prometheus_match_the_reference(seed):
    want, got = _feed(jobs, seed), _feed(tobs, seed)
    assert json.dumps(got.snapshot(), sort_keys=True) == json.dumps(want.snapshot(),
                                                                    sort_keys=True)
    assert got.to_prometheus() == want.to_prometheus()
    assert tobs.log_bounds() == jobs.log_bounds()


def test_registry_rules_match_the_reference():
    for mod in (jobs, tobs):
        reg = mod.MetricsRegistry()
        reg.counter("a")
        with pytest.raises(TypeError):
            reg.gauge("a")
        reg.histogram("h", bounds=[1, 2])
        with pytest.raises(ValueError):
            reg.histogram("h", bounds=[1, 3])
        with pytest.raises(ValueError):
            reg.counter("a").inc(-1)
    h = tobs.Histogram("x", bounds=[1.0, 2.0, 4.0])
    for v in (0.5, 1.0, 3.0, 3.5, 9.0):
        h.observe(v)
    assert h.counts == [2, 0, 2, 1] and h.percentile(50) == 4.0 and h.percentile(100) == 9.0


# -- the tracer ------------------------------------------------------------------

def _drive(mod):
    t = mod.JsonTracer()
    t.begin(mod.PID_REQUESTS, 3, "request", rid=3)
    t.instant(mod.PID_REQUESTS, 3, "admitted", slot=0)
    t.begin(mod.PID_DEVICE, mod.DEVICE_TID, "decode.dispatch", slots=2)
    t.end(mod.PID_DEVICE, mod.DEVICE_TID, "decode.dispatch")
    t.complete(mod.PID_DEVICE, mod.DEVICE_INFLIGHT_TID, "decode.complete", 0.0, 1e-3, slots=2)
    t.end(mod.PID_REQUESTS, 3, "request")
    return t


def _untimed(events):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")} for ev in events]


def test_tracer_chrome_and_jsonl_formats_match_the_reference(tmp_path):
    want, got = _drive(jobs), _drive(tobs)
    assert _untimed(got.events) == _untimed(want.events)
    assert (tobs.PID_REQUESTS, tobs.PID_DEVICE, tobs.DEVICE_TID, tobs.DEVICE_INFLIGHT_TID) == (
        jobs.PID_REQUESTS, jobs.PID_DEVICE, jobs.DEVICE_TID, jobs.DEVICE_INFLIGHT_TID)
    doc = got.to_chrome({"arch": "x"})
    assert set(doc) == set(want.to_chrome({"arch": "x"})) == {"traceEvents", "displayTimeUnit",
                                                              "metadata"}
    assert tobs.write_trace(got, str(tmp_path / "t.jsonl")) == "jsonl"
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert [json.loads(x)["name"] for x in lines] == [e["name"] for e in got.events]
    assert tobs.write_trace(got, str(tmp_path / "t.json"), meta={"a": 1}) == "chrome"
    assert _validator().validate(str(tmp_path / "t.json")) == []
    null = tobs.NullTracer()
    assert not null.enabled and isinstance(null, tobs.Tracer) and isinstance(got, tobs.Tracer)


def _ev(name, ph, ts, tid=0, **kw):
    return {"name": name, "ph": ph, "pid": 2, "tid": tid, "ts": ts, **kw}


@pytest.mark.parametrize("events, problem", [
    ([_ev("a", "B", 5), _ev("a", "E", 4)], "ts"),
    ([_ev("a", "B", 1), _ev("b", "E", 2)], "b"),
    ([_ev("a", "B", 1)], "open"),
    ([_ev("a", "Q", 1)], "phase"),
    ([{"name": "finished", "ph": "i", "pid": 1, "tid": 0, "ts": 1}], "request"),
])
def test_validator_rejects_broken_traces(events, problem):
    v = _validator()
    errors = v.validate_events(events) + v.validate_request_chains(events)
    assert errors and any(problem in e for e in errors), errors


# -- the server against the reference's ---------------------------------------------

@pytest.fixture(scope="module")
def target():
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), **FP32)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tget_config("granite-3-8b", smoke=True), **FP32)
    return model, params, tbuild(tcfg, device="cpu"), params_from_jax(
        jax.tree.map(np.asarray, params), tcfg)


def _run(server, max_new=6):
    for p in PROMPTS:
        server.submit(p, max_new_tokens=max_new)
    results = server.run()
    return {rid: r.out_tokens for rid, r in results.items()}


def _port(target, workload, tracer):
    w = WORKLOADS[workload]
    spec = None if w["spec"] is None else SpecConfig(k=w["spec"], ngram_n=3)
    return Server(target[2], target[3], ServerConfig(**CONFIG, **w["config"]), device="cpu",
                  spec=spec, tracer=tracer)


def _reference(target, workload, tracer):
    w = WORKLOADS[workload]
    spec = None if w["spec"] is None else JSpecConfig(k=w["spec"], ngram_n=3)
    return JServer(target[0], target[1], JServerConfig(**CONFIG, **w["config"]), spec=spec,
                   tracer=tracer)


@pytest.fixture(scope="module")
def runs(target):
    """Each workload through the reference's server and the port's, traced,
    and through the port's untraced."""
    out = {}
    for name in WORKLOADS:
        jserver = _reference(target, name, jobs.JsonTracer())
        server = _port(target, name, tobs.JsonTracer())
        plain = _port(target, name, None)
        out[name] = (jserver, _run(jserver), server, _run(server), _run(plain))
    return out


def _events(tracer):
    return [(ev["name"], ev["ph"], ev["pid"], ev["tid"],
             {k: v for k, v in ev.get("args", {}).items() if k != "wait_s"})
            for ev in tracer.events]


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_server_tokens_match_the_reference_and_tracing_changes_none(runs, workload):
    _, want, server, got, untraced = runs[workload]
    assert got == want
    assert untraced == got
    if workload == "spec":
        assert server.stats.spec_steps > 0 and server.stats.spec_drafted > 0
    else:
        assert server.engine.profiler is server.profiler


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_server_registry_matches_the_reference(runs, workload):
    jserver, _, server, _, _ = runs[workload]
    want, got = jserver.metrics.snapshot(), server.metrics.snapshot()
    for kind in ("counters", "gauges"):
        assert set(got[kind]) - PORT_ONLY == set(want[kind]), kind
        for name, value in want[kind].items():
            if "seconds" not in name:
                assert got[kind][name] == value, name
    assert got["counters"]["serving_nonfinite_steps_total"] == 0
    assert set(got["histograms"]) == set(want["histograms"])
    for name, h in want["histograms"].items():
        assert got["histograms"][name]["count"] == h["count"], name
        if "seconds" not in name:
            assert got["histograms"][name]["counts"] == h["counts"], name
    s = server.stats
    assert s.decode_tokens == got["counters"]["serving_decode_tokens_total"] > 0
    assert s.decode_s == got["counters"]["serving_decode_seconds_total"] > 0
    assert s.prefill_calls == jserver.stats.prefill_calls > 0
    if workload == "spec":
        assert got["histograms"]["serving_verify_seconds"]["count"] == s.spec_steps
        assert got["histograms"]["serving_draft_seconds"]["count"] == s.spec_steps


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_server_trace_matches_the_reference_and_validates(runs, workload):
    jserver, _, server, _, _ = runs[workload]
    assert _events(server.tracer) == _events(jserver.tracer)
    names = {ev["name"] for ev in server.tracer.events}
    want = {"request", "queued", "prefill_chunk", "decode", "admitted", "finished",
            "prefill_chunk.dispatch", "prefill_chunk.complete"}
    want |= ({"spec_round", "draft", "verify", "commit"} if workload == "spec"
             else {"decode.dispatch", "decode.complete"})
    assert want <= names
    v = _validator()
    assert v.validate_events(server.tracer.events) == []
    assert v.validate_request_chains(server.tracer.events) == []
    finished = {ev["tid"] for ev in server.tracer.events
                if ev["name"] == "finished" and ev["pid"] == tobs.PID_REQUESTS}
    assert finished == set(range(len(PROMPTS)))  # every request has its chain checked
    waits = [ev["args"]["wait_s"] for ev in server.tracer.events if ev["ph"] == "X"]
    assert waits and all(w >= 0 for w in waits)


def test_reset_zeroes_everything_but_the_profiler(target):
    server = _port(target, "chunked", tobs.JsonTracer())
    _run(server)
    records = dict(server.profiler.records)
    assert records and server.tracer.events
    server.reset()
    snap = server.metrics.snapshot()
    assert all(v == 0 for v in snap["counters"].values())
    assert all(v == 0 for v in snap["gauges"].values())
    assert all(h["count"] == 0 for h in snap["histograms"].values())
    assert server.tracer.events == [] and server.stats.decode_steps == 0
    assert server.profiler.records == records
    # After the reset the same run gives the same tokens, and the warm-up's
    # first calls stay the warm-up's: no record starts over.
    first = {k: r.compile_s for k, r in records.items()}
    _run(server)
    assert {k: r.compile_s for k, r in server.profiler.records.items() if k in first} == first


def test_launcher_writes_trace_metrics_and_profile_on_the_cpu(tmp_path, capsys):
    trace, metrics, logdir = tmp_path / "t.json", tmp_path / "m.json", tmp_path / "prof"
    server, results = tserve.main([
        "--smoke", "--device", "cpu", "--requests", "3", "--prompt-len", "6", "--max-new", "3",
        "--num-slots", "2", "--page-size", "4", "--chunked-prefill", "4",
        "--trace-out", str(trace), "--metrics-out", str(metrics), "--profile", str(logdir)])
    out = capsys.readouterr().out
    assert "trace:" in out and "metrics: snapshot" in out and "step profile" in out
    assert _validator().validate(str(trace)) == []
    doc = json.loads(metrics.read_text())
    assert doc["arch"] == "granite-3-8b" and "step_profile" in doc
    assert doc["counters"]["serving_decode_tokens_total"] == server.stats.decode_tokens
    assert doc["counters"]["serving_requests_finished_total"] == len(results) == 3
    assert (logdir / tobs.profiler.TRACE_FILE).exists()
    prom = tmp_path / "m.prom"
    tserve.main(["--smoke", "--device", "cpu", "--requests", "2", "--prompt-len", "6",
                 "--max-new", "2", "--metrics-out", str(prom), "--backend", "torch"])
    assert "# TYPE serving_decode_tokens_total counter" in prom.read_text()
    with pytest.raises(ValueError, match="needs the card"):
        tserve.main(["--smoke", "--device", "cpu", "--backend", "cuda"])


def test_device_capture_passes_through_without_a_logdir(tmp_path):
    with tobs.device_capture(None) as prof:
        assert prof is None
    with tobs.device_capture(str(tmp_path / "d")) as prof:
        torch.ones(4).sum()
    assert prof is not None and (tmp_path / "d" / "device_trace.json").exists()
    assert math.isfinite(sum(e.self_cpu_time_total for e in prof.key_averages()))


def test_time_by_name_matches_key_averages():
    """The launcher's profile summary reads the profiler's raw events; its
    host operators' own times are ``key_averages()``'s."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(32, 32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(50):
            a = torch.softmax(a * 1e-3, -1) + 1
    _, host = tserve.time_by_name(prof)
    want = {e.key: (e.self_cpu_time_total, e.count) for e in prof.key_averages()
            if e.self_cpu_time_total > 0}
    got = {name: (us, n) for us, n, name in host}
    assert {k: n for k, (_, n) in got.items()} == {k: n for k, (_, n) in want.items()}
    for name, (us, _) in want.items():
        assert got[name][0] == pytest.approx(us, rel=1e-9), name
