"""Snapshot/flush plumbing of the port (``repro.obs.export``): one place that
knows file formats.

- ``write_trace(tracer, path)`` — Chrome trace-event JSON (``.json``,
  Perfetto-loadable) or JSONL (``.jsonl``), chosen by suffix.
- ``write_metrics(registry, path)`` — JSON snapshot (counters/gauges/
  histograms + optional profiler summary and metadata), or Prometheus
  text exposition when the suffix is ``.prom`` / ``.txt``.
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profiler import StepProfiler
from repro_torch.obs.trace import JsonTracer


def write_trace(tracer: JsonTracer, path: str,
                meta: Optional[dict] = None) -> str:
    """Flush a JsonTracer to ``path``; returns the format written."""
    if path.endswith(".jsonl"):
        tracer.write_jsonl(path)
        return "jsonl"
    tracer.write_chrome(path, meta=meta)
    return "chrome"


def metrics_doc(registry: MetricsRegistry, *,
                profiler: Optional[StepProfiler] = None,
                meta: Optional[dict] = None) -> dict:
    doc = dict(meta or {})
    doc.update(registry.snapshot())
    if profiler is not None:
        doc["step_profile"] = profiler.summary()
    return doc


def write_metrics(registry: MetricsRegistry, path: str, *,
                  profiler: Optional[StepProfiler] = None,
                  meta: Optional[dict] = None) -> str:
    """Flush a registry to ``path``; returns the format written."""
    if path.endswith((".prom", ".txt")):
        with open(path, "w") as f:
            f.write(registry.to_prometheus())
        return "prometheus"
    with open(path, "w") as f:
        json.dump(metrics_doc(registry, profiler=profiler, meta=meta), f,
                  indent=1, sort_keys=True)
        f.write("\n")
    return "json"
