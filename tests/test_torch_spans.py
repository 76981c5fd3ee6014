"""The port's profiler spans (``repro_torch.obs.span``) and the engine's
step seconds, on the CPU with the plain path:

- a chunked served run under a host profile records the serving loop's,
  the engine core's and the model's spans, nested as ``PERF.md`` names
  them, and gives the tokens of a run without a profiler;
- with one step in flight, a slow prefill is charged to the prefill
  seconds and none of it to a decode step;
- the tracer's Unix epoch puts its events on the profiler's clock;
- the launcher's span table (``time_by_span``) and ``--trace-out``'s epoch;
- a train step's forward, backward and optimizer spans.
"""
import dataclasses
import json
import time
import types

import pytest

torch = pytest.importorskip("torch")

import repro_torch.obs as tobs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serving import Server, ServerConfig  # noqa: E402

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

PROMPTS = [[3, 5, 7, 9, 3, 5, 7, 9, 3, 5], [11, 4, 11, 4, 11, 4, 2], [1, 2, 3, 4, 5, 6, 7, 8]]
CONFIG = dict(num_slots=2, page_size=4, max_seq_len=24, prefill_chunk=4, async_depth=1)
# Where each span opens: the innermost span around it (None: at the top).
PARENTS = {
    "server.schedule": {None},
    "server.harvest": {None},
    "engine.stage": {"server.schedule"},
    "engine.prefill": {"server.schedule"},
    "engine.prefill_chunk": {"server.schedule"},
    "engine.decode": {"server.schedule"},
    "engine.sample": {"server.schedule"},
    "engine.wait": {"server.harvest"},
    "attn": {"engine.prefill", "engine.prefill_chunk", "engine.decode"},
    "ffn": {"engine.prefill", "engine.prefill_chunk", "engine.decode"},
    "moe.router": {"engine.prefill", "engine.prefill_chunk", "engine.decode"},
    "moe.experts": {"engine.prefill", "engine.prefill_chunk", "engine.decode"},
    "head": {"engine.prefill", "engine.prefill_chunk", "engine.decode"},
}


@pytest.fixture(scope="module", params=["granite-3-8b", "phi3.5-moe-42b-a6.6b"])
def model(request):
    cfg = dataclasses.replace(get_config(request.param, smoke=True), policy="fp32",
                              kv_cache_dtype="fp32")
    m = build(cfg, device="cpu")
    return m, m.init(0)


def _serve(model, **config):
    m, params = model
    server = Server(m, params, ServerConfig(**(CONFIG | config)), device="cpu")
    for p in PROMPTS:
        server.submit(p, max_new_tokens=5)
    return server, {rid: r.out_tokens for rid, r in server.run().items()}


def _spans(prof):
    """(name, innermost enclosing span's name or None) of every span of a
    finished host profile, the names cut at ``[``."""
    events = sorted((e.start_ns(), -e.end_ns(), e.name().partition("[")[0])
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CPU and tobs.is_span(e.name()))
    out, stack = [], []  # stack: [end, name]
    for start, neg_end, name in events:
        while stack and stack[-1][0] <= start:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append([-neg_end, name])
    return out


@pytest.mark.parametrize("batched", [False, True])
def test_served_run_records_the_spans_nested_as_named(model, batched):
    _, want = _serve(model, prefill_batch=batched)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        server, got = _serve(model, prefill_batch=batched)
    assert got == want  # the spans change no token
    spans = _spans(prof)
    seen = {name for name, _ in spans}
    for name, parent in spans:
        assert parent in PARENTS[name], (name, parent)
    ffn = {"moe.router", "moe.experts"} if model[0].cfg.n_experts else {"ffn"}
    prefill = "engine.prefill" if batched else "engine.prefill_chunk"
    assert {"server.schedule", "server.harvest", prefill, "engine.stage", "engine.decode",
            "engine.sample", "engine.wait", "attn", "head"} | ffn <= seen
    assert not seen & {"gemm.plan", "gemm.kmajor_copy", "gemm.launch"}  # the plain path
    names = {e.name() for e in prof.profiler.kineto_results.events() if tobs.is_span(e.name())}
    # A batched server dispatches a lone prefilling request as one row.
    batches = {n for n in names if n.startswith("engine.prefill[")}
    rows = {n for n in names if n.startswith("engine.prefill_chunk[")}
    assert all(n.startswith("engine.prefill[P=") and n.endswith(",chunk=4]") for n in batches)
    assert all(n.startswith("engine.prefill_chunk[n=") for n in rows) and rows
    assert bool(batches) == batched, batches
    harvested = server.stats.decode_steps + server.metrics.histogram(
        "serving_prefill_chunk_seconds").count
    assert sum(name == "engine.wait" for name, _ in spans) == harvested


def test_a_slow_prefill_is_charged_to_prefill_seconds_alone(model, monkeypatch):
    """With one step in flight the harvest of a decode step follows the
    next step's prefill dispatch; the charge of each step is its own, so a
    prefill slowed by 50 ms lands in the prefill seconds, not in the decode
    step harvested after it. The 50 ms pass on the engine's clock, which
    otherwise ticks a microsecond a reading, so that no load on the
    machine moves the charges."""
    from repro_torch.serving import engine

    m, _ = model
    fast = m.prefill_cb
    now = [0.0]

    def perf_counter():
        now[0] += 1e-6
        return now[0]

    def prefill_cb(*args, **kw):
        now[0] += 0.05
        return fast(*args, **kw)

    monkeypatch.setattr(engine, "time", types.SimpleNamespace(perf_counter=perf_counter))
    monkeypatch.setattr(m, "prefill_cb", prefill_cb)
    server, _ = _serve(model)
    snap = server.metrics.snapshot()
    chunks = snap["histograms"]["serving_prefill_chunk_seconds"]
    decode = snap["histograms"]["serving_decode_step_seconds"]
    assert chunks["count"] == server.stats.prefill_calls > 0
    assert server.stats.prefill_s >= 0.05 * chunks["count"]
    assert chunks["min"] >= 0.05
    assert decode["count"] == server.stats.decode_steps > 0
    assert decode["max"] < 0.05, decode["max"]


def test_tracer_epoch_puts_events_on_the_profilers_clock():
    tracer = tobs.JsonTracer()
    time.sleep(0.01)  # the events come after the epoch
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        tracer.begin(tobs.PID_DEVICE, tobs.DEVICE_TID, "decode.dispatch")
        with tobs.span("engine.stage"):
            pass
        apart = time.time_ns() - t0  # the two opened together, but for a preemption
        tracer.end(tobs.PID_DEVICE, tobs.DEVICE_TID, "decode.dispatch")
    begin = next(ev for ev in tracer.events if ev["ph"] == "B")
    got = tracer.epoch_unix_ns + 1e3 * begin["ts"]
    (want,) = [e.start_ns() for e in prof.profiler.kineto_results.events()
               if e.name() == "engine.stage"]
    assert abs(got - want) < 1e6 + apart, (got - want) / 1e6
    before = time.time_ns()
    tracer.reset()
    assert before <= tracer.epoch_unix_ns <= time.time_ns()


def test_time_by_span_sums_each_spans_inclusive_time():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for n in range(3):
            with tobs.span("server.schedule"):
                with tobs.span(f"engine.prefill[P={2 ** n},chunk=8]"):
                    torch.ones(64, 64).sum()
                with tobs.span("not.a.span"):
                    pass
    want = {}
    for e in prof.profiler.kineto_results.events():
        if tobs.is_span(e.name()):
            row = want.setdefault(e.name(), [0, 0])
            row[0] += e.duration_ns() / 1e3
            row[1] += 1
    rows = tserve.time_by_span(prof)
    assert {name: n for _, n, name in rows} == {name: n for name, (_, n) in want.items()}
    for us, _, name in rows:
        assert us == pytest.approx(want[name][0], rel=1e-12), name
    assert [n for _, n, _ in rows].count(3) == 1 and len(rows) == 4
    assert rows[0][2] == "server.schedule" and rows[0][0] >= sum(r[0] for r in rows[1:])
    assert not tobs.is_span("not.a.span") and not tobs.is_span("aten::mm")


def test_launcher_prints_the_spans_and_writes_the_epoch(tmp_path, capsys):
    trace = tmp_path / "t.json"
    tserve.main(["--smoke", "--device", "cpu", "--requests", "3", "--prompt-len", "6",
                 "--max-new", "3", "--num-slots", "2", "--page-size", "4",
                 "--chunked-prefill", "4", "--async-depth", "1", "--profile",
                 "--trace-out", str(trace)])
    out = capsys.readouterr().out
    table = out[out.index("program spans"):].splitlines()[1:]
    rows = {line.split()[-1]: line.split() for line in table if line.startswith("  ")
            and tobs.is_span(line.split()[-1])}
    assert {"server.schedule", "server.harvest", "engine.decode", "attn", "ffn"} <= set(rows)
    ms, _, calls, us = rows["server.harvest"][:4]
    n = int(calls[:-1])  # the ms column has two decimals, the us column one
    assert float(us) == pytest.approx(1e3 * float(ms) / n, abs=5 / n + 0.05)
    meta = json.loads(trace.read_text())["metadata"]
    assert abs(meta["epoch_unix_ns"] - time.time_ns()) < 600e9


@pytest.mark.parametrize("remat", ["none", "block"])
def test_a_train_step_records_its_three_spans(remat):
    """Forward, backward and optimizer spans at the top of a train step;
    the model's spans open in the forward (and, recomputed under remat, in
    the backward)."""
    from repro_torch.launch import train

    args = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "8", "--batch", "2",
            "--log-every", "1", "--remat", remat]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = train.main(args)
    assert [h["step"] for h in out["history"]] == [1, 2]
    spans = _spans(prof)
    count = {name: sum(n == name for n, _ in spans)
             for name in ("train.forward", "train.backward", "train.optimizer")}
    assert count == dict.fromkeys(count, 2), count
    parents = {name: {p for n, p in spans if n == name} for name in [*count, "attn", "ffn"]}
    assert all(parents[name] == {None} for name in count), parents
    within = {"train.forward"} | ({"train.backward"} if remat == "block" else set())
    assert parents["attn"] == parents["ffn"] == within, parents
