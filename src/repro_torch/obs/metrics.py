"""Process-local metrics registry of the port: counters, gauges, log-bucket
histograms (a copy of ``repro.obs.metrics``, pure Python: the same names,
``le`` semantics, percentile rule and export formats, held string for
string against the reference by ``tests/test_torch_obs.py``).

The registry is the **single source of truth** for every serving statistic:
``ServerStats`` is a read-only view over it and the launcher's
``--metrics-out`` dumps its snapshot. Two export formats:

- ``snapshot()`` — a JSON-able dict (counters, gauges, histograms with
  bucket counts and histogram-derived p50/p95).
- ``to_prometheus()`` — Prometheus text exposition (counter/gauge lines,
  cumulative ``_bucket{le=...}`` histogram series), so a scrape endpoint
  needs nothing beyond serving this string.

Histograms use logarithmic buckets by default (``log_bounds``: upper edges
``10us * 2^i``), which keeps relative error bounded by the bucket factor
across six decades of latency — the quantile estimate returned by
``Histogram.percentile`` is the upper edge of the bucket containing the
rank, clamped to the observed max, so it agrees with an exact percentile
over the same samples to within one bucket.
"""
from __future__ import annotations

import bisect
import math
from typing import Optional, Sequence


def log_bounds(lo: float = 1e-5, factor: float = 2.0, n: int = 26
               ) -> tuple[float, ...]:
    """Upper bucket edges ``lo * factor**i`` — default 10us..~336s."""
    return tuple(lo * factor ** i for i in range(n))


class Counter:
    """Monotonic float counter (``inc`` only; ``reset`` rewinds to 0)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n

    def reset(self) -> None:
        self.value = 0.0


class Gauge:
    """Last-write-wins value (mirrors of scheduler-owned counters live
    here: the scheduler is the authority, the gauge is the exposition)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed-bound histogram with one overflow bucket.

    ``bounds`` are inclusive upper edges (Prometheus ``le`` semantics: an
    observation equal to an edge lands in that edge's bucket); values above
    the last edge land in the overflow (+Inf) bucket.
    """

    kind = "histogram"

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None,
                 help: str = ""):
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in (bounds or log_bounds()))
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram {name}: bounds must be strictly "
                             f"increasing, got {self.bounds}")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        """Upper edge of the bucket holding the q-th percentile rank,
        clamped to the observed max (None when empty). Within one bucket
        of the exact percentile by construction."""
        if not self.count:
            return None
        rank = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                upper = self.bounds[i] if i < len(self.bounds) else self.max
                return min(float(upper), float(self.max))
        return float(self.max)  # unreachable; defensive

    def cumulative(self) -> list[tuple[str, int]]:
        """Prometheus-style cumulative (le, count) pairs ending at +Inf."""
        out = []
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            out.append((repr(b), cum))
        out.append(("+Inf", self.count))
        return out

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None


class MetricsRegistry:
    """Name -> metric map with get-or-create accessors.

    Re-requesting a name returns the existing metric; requesting it as a
    different kind (or a histogram with different bounds) raises — a name
    means one thing process-wide.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help=help, **kw)
            self._metrics[name] = m
            return m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name} already registered as {m.kind}, "
                f"requested {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:
        h = self._get(Histogram, name, help, bounds=bounds)
        if bounds is not None and tuple(float(b) for b in bounds) != h.bounds:
            raise ValueError(f"histogram {name} already registered with "
                             f"different bounds")
        return h

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def reset(self) -> None:
        """Zero every registered metric in place (definitions survive, so
        handles cached by instrumented code stay valid) — the hook
        ``Server.reset()`` uses to exclude warm-up activity (kernel builds,
        graph captures)."""
        for m in self._metrics.values():
            m.reset()

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        counters, gauges, hists = {}, {}, {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                counters[name] = m.value
            elif isinstance(m, Gauge):
                gauges[name] = m.value
            else:
                hists[name] = {
                    "count": m.count, "sum": m.sum,
                    "min": m.min, "max": m.max,
                    "bounds": list(m.bounds), "counts": list(m.counts),
                    "p50": m.percentile(50), "p95": m.percentile(95),
                    "p99": m.percentile(99),
                }
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def to_prometheus(self) -> str:
        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, (Counter, Gauge)):
                lines.append(f"{name} {m.value:g}")
            else:
                for le, cum in m.cumulative():
                    lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + "\n"
