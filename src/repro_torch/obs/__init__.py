"""repro_torch.obs: observability for the port's serving stack (the
counterpart of ``repro.obs``, with the same names and formats).

- ``trace``: request-lifecycle and device-step tracing, exported as
  Chrome trace events or JSONL (Perfetto-loadable; ``scripts/
  validate_trace.py`` checks them), and ``span``, the named host ranges
  that a ``torch.profiler`` profile records;
- ``metrics``: the process-local registry (counters, gauges, log-bucket
  histograms) with JSON and Prometheus export, the single source of every
  serving figure (``ServerStats`` is a view over it);
- ``profiler``: per-step wall clock keyed by (kind, shape bucket), first
  call apart, and ``device_capture``, a ``torch.profiler`` window exported
  as a Chrome trace;
- ``export``: the flush plumbing.

The server is instrumented against the ``Tracer`` protocol with a
zero-overhead ``NullTracer`` default: tracing off builds no event
arguments and changes no token (a tested invariant).

    from repro_torch.obs import JsonTracer
    tracer = JsonTracer()
    server = Server(model, params, cfg, tracer=tracer)
    ...
    tracer.write_chrome("trace.json")   # open in https://ui.perfetto.dev
    print(server.metrics.to_prometheus())
"""
from repro_torch.obs.export import metrics_doc, write_metrics, write_trace
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    log_bounds,
)
from repro_torch.obs.profiler import StepProfiler, device_capture
from repro_torch.obs.trace import (
    DEVICE_INFLIGHT_TID,
    DEVICE_TID,
    PID_DEVICE,
    PID_REQUESTS,
    SPAN_NAMES,
    JsonTracer,
    NullTracer,
    Tracer,
    is_span,
    span,
)

__all__ = [
    "Counter",
    "DEVICE_INFLIGHT_TID",
    "DEVICE_TID",
    "Gauge",
    "Histogram",
    "JsonTracer",
    "MetricsRegistry",
    "NullTracer",
    "PID_DEVICE",
    "PID_REQUESTS",
    "SPAN_NAMES",
    "StepProfiler",
    "Tracer",
    "device_capture",
    "is_span",
    "log_bounds",
    "metrics_doc",
    "span",
    "write_metrics",
    "write_trace",
]
