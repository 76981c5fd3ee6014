"""Request-lifecycle and device-step tracing of the port (a copy of
``repro.obs.trace``: the Chrome trace-event and JSONL formats are the
reference's byte for byte, so ``scripts/validate_trace.py`` checks the
port's traces unchanged).

Two tracers share one protocol (``begin`` / ``end`` / ``instant`` /
``reset``):

:class:`NullTracer` — the default. Every method is a no-op and
``enabled`` is False so instrumented hot paths can skip building the
argument dicts entirely; an instrumented server with the NullTracer is
behaviourally (bitwise, for greedy outputs) identical to the
pre-instrumentation server because tracing never touches the sampling
generator, the device tensors, or the scheduler.

:class:`JsonTracer` — records Chrome trace-event duration (B/E) and
instant (i) events with microsecond timestamps relative to the tracer's
epoch. Spans are emitted *as they happen* (B at entry, E at exit), so per
track the event stream is timestamp-monotonic and nesting is exactly the
call structure — which is what ``scripts/validate_trace.py`` checks. The
recorded events export two ways:

- ``write_chrome(path)`` — a ``{"traceEvents": [...]}`` JSON document
  loadable in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``;
  process/thread metadata events name the tracks.
- ``write_jsonl(path)`` — one event object per line, for ad-hoc grep/jq
  pipelines over long runs.

Track layout:

- ``pid == PID_REQUESTS``: one thread per request, ``tid == rid``. Span
  taxonomy per request: ``request`` (submit -> finish) containing
  ``queued`` (one per admission wait, re-opened on preemption),
  ``prefill_chunk`` (one per chunk), and ``decode`` (first token ->
  finish), plus ``admitted`` / ``preempted`` / ``finished`` instants
  carrying prefix-hit, preemption and speculative annotations.
- ``pid == PID_DEVICE``, ``tid == DEVICE_TID`` ("steps"): host-side span
  per device-step *dispatch* (``prefill_full.dispatch`` /
  ``prefill_chunk.dispatch`` / ``prefill_batch.dispatch`` /
  ``decode.dispatch``, plus the synchronous ``spec_round`` with nested
  ``draft`` / ``verify`` / ``commit`` phases). The dispatch span
  covers only the host time to enqueue the work on the card's stream (a
  decode step: its staged copy and one graph replay).
- ``pid == PID_DEVICE``, ``tid == DEVICE_INFLIGHT_TID`` ("in flight"):
  one Chrome *complete* ("X") event per harvested step
  (``<kind>.complete``), backdated to its dispatch time and spanning
  dispatch -> result consumed. The gap between a dispatch span ending and
  its complete event ending IS the overlap window dispatch-ahead buys —
  Perfetto renders the two tracks stacked so the overlap reads directly.
  Harvest order is FIFO in dispatch order, so this track stays
  timestamp-monotonic even though events are emitted at harvest time.

The tracer's timestamps count from its epoch on ``time.perf_counter()``;
``JsonTracer.epoch_unix_ns`` is ``time.time_ns()`` read beside it, so an
event's Unix time is ``epoch_unix_ns + 1e3 * ts``: the clock of a
``torch.profiler`` trace, whose events carry Unix nanoseconds.

``span`` is the other kind of record, and no tracer sees it: a named
range of host time that only a ``torch.profiler`` profile recording host
activity keeps (and ``torch.autograd.profiler.emit_nvtx`` turns into NVTX
ranges). The serving loop, the engine core, the model, the GEMM-Op's host
wrapper and the train step open spans under the fixed names of
:data:`SPAN_NAMES` (``PERF.md`` says what each covers); with no profiler
running a span costs a fraction of a microsecond.
"""
from __future__ import annotations

import json
import time
from typing import Optional, Protocol, runtime_checkable

import torch

PID_REQUESTS = 1
PID_DEVICE = 2
DEVICE_TID = 0
DEVICE_INFLIGHT_TID = 1

_PROCESS_NAMES = {PID_REQUESTS: "requests", PID_DEVICE: "device"}


# The program's span names. ``engine.prefill[P=p,chunk=c]`` and
# ``engine.prefill_chunk[n=n]`` carry their step's shape after the name.
SPAN_NAMES = (
    "server.schedule", "server.harvest",
    "engine.stage", "engine.prefill", "engine.prefill_chunk", "engine.decode", "engine.sample",
    "engine.wait",
    "attn", "moe.router", "moe.experts", "ffn", "head",
    "gemm.plan", "gemm.kmajor_copy", "gemm.launch",
    "train.forward", "train.backward", "train.optimizer",
)


def is_span(name: str) -> bool:
    """Whether a profiler event's name is one of the program's spans."""
    return name.partition("[")[0] in SPAN_NAMES


# ``span(name)``: a context manager that opens a profiler range called
# ``name`` on this thread (``torch.profiler``'s fast record function, which
# records no argument). Inside a CUDA graph's capture the range is the
# host's alone; a replay opens none.
span = torch._C._profiler._RecordFunctionFast


@runtime_checkable
class Tracer(Protocol):
    """The tracing surface the serving stack is instrumented against."""

    enabled: bool

    def begin(self, pid: int, tid: int, name: str, **args) -> None: ...

    def end(self, pid: int, tid: int, name: str, **args) -> None: ...

    def instant(self, pid: int, tid: int, name: str, **args) -> None: ...

    def complete(self, pid: int, tid: int, name: str, start_s: float,
                 dur_s: float, **args) -> None: ...

    def reset(self) -> None: ...


class NullTracer:
    """Zero-overhead default: all methods no-ops, ``enabled`` is False so
    callers can skip even building kwargs for hot-path events."""

    enabled = False

    def begin(self, pid, tid, name, **args):
        pass

    def end(self, pid, tid, name, **args):
        pass

    def instant(self, pid, tid, name, **args):
        pass

    def complete(self, pid, tid, name, start_s, dur_s, **args):
        pass

    def reset(self):
        pass


class JsonTracer:
    """In-memory trace recorder with Chrome trace-event / JSONL export."""

    enabled = True

    def __init__(self):
        self._t0 = time.perf_counter()
        self.epoch_unix_ns = time.time_ns()
        self.events: list[dict] = []
        self._named_tracks: set[tuple[int, int]] = set()

    # -- recording ---------------------------------------------------------
    def _ts(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6  # us

    def _track_meta(self, pid: int, tid: int) -> None:
        """Name the process/thread lazily on a track's first event so the
        Perfetto sidebar reads 'requests / req 3' instead of bare ids."""
        if (pid, tid) in self._named_tracks:
            return
        self._named_tracks.add((pid, tid))
        pname = _PROCESS_NAMES.get(pid, f"pid {pid}")
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": tid, "ts": 0,
                            "args": {"name": pname}})
        if pid == PID_REQUESTS:
            tname = f"req {tid}"
        elif tid == DEVICE_INFLIGHT_TID:
            tname = "in flight"
        else:
            tname = "steps"
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "ts": 0,
                            "args": {"name": tname}})

    def _emit(self, ph: str, pid: int, tid: int, name: str, args: dict) -> None:
        self._track_meta(pid, tid)
        ev = {"name": name, "ph": ph, "pid": int(pid), "tid": int(tid),
              "ts": self._ts()}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def begin(self, pid, tid, name, **args):
        self._emit("B", pid, tid, name, args)

    def end(self, pid, tid, name, **args):
        self._emit("E", pid, tid, name, args)

    def instant(self, pid, tid, name, **args):
        ev_args = args or None
        self._track_meta(pid, tid)
        ev = {"name": name, "ph": "i", "pid": int(pid), "tid": int(tid),
              "ts": self._ts(), "s": "t"}  # thread-scoped instant
        if ev_args:
            ev["args"] = ev_args
        self.events.append(ev)

    def complete(self, pid, tid, name, start_s, dur_s, **args):
        """One Chrome complete ("X") event with an explicit start and
        duration — emitted after the fact, which is how the async engine
        records a device step it only learns the extent of at harvest
        time. ``start_s`` is a ``time.perf_counter()`` value (the same
        clock as the tracer epoch); events before the epoch clamp to 0."""
        self._track_meta(pid, tid)
        ts = max(0.0, (start_s - self._t0) * 1e6)
        ev = {"name": name, "ph": "X", "pid": int(pid), "tid": int(tid),
              "ts": ts, "dur": max(0.0, dur_s * 1e6)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def reset(self) -> None:
        """Drop every recorded event and re-arm the epoch — called by
        ``Server.reset()`` so warm-up activity (kernel builds, graph
        captures) never pollutes the exported trace of a timed run."""
        self.events = []
        self._named_tracks = set()
        self._t0 = time.perf_counter()
        self.epoch_unix_ns = time.time_ns()

    # -- export ------------------------------------------------------------
    def to_chrome(self, meta: Optional[dict] = None) -> dict:
        doc = {"traceEvents": list(self.events), "displayTimeUnit": "ms"}
        if meta:
            doc["metadata"] = meta
        return doc

    def write_chrome(self, path: str, meta: Optional[dict] = None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(meta), f)
            f.write("\n")

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev))
                f.write("\n")
