"""The reduction from a ``torch.profiler`` window to what the per-layer
metrics read: device time by kernel name, the device's busy time as the
union of its operations' intervals, and the breakdown of the result line
(the device operations that took most time, and the longest idle gaps by
what the host was doing).

The reduction works on plain lists of ``(name, start_ns, end_ns)``, so
the tests can hand it synthetic events; :func:`events_of` takes them out
of a finished profiler the way ``repro_torch/launch/serve.py``'s
``time_by_name`` does, from the raw Kineto events (``key_averages()``
builds an event tree that costs far more on a serve window).
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import re

Event = tuple[str, int, int]  # (name, start ns, end ns)


def profiler(device: str, host: bool):
    """A ``torch.profiler.profile`` of the device's activity (on the card),
    and with ``host`` of the host's operators too. Recording the host's
    operators slows its eager work, so only a profile without them reads
    the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device != "cpu" else []
    return profile(activities=acts + ([ProfilerActivity.CPU] if host or not acts else []))


def events_of(prof) -> tuple[list[Event], list[Event]]:
    """(device events, host events) of a finished ``torch.profiler.profile``:
    every operation on the card (kernels, copies, sets) and every host
    event, each as (name, start ns, end ns)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if dur > 0:
                dev.append((e.name(), start, start + dur))
        elif e.device_type() == DeviceType.CPU:
            host.append((e.name(), start, start + max(dur, 0)))
    return dev, host


def union_ns(intervals: list[tuple[int, int]]) -> int:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def label_gaps(host: list[Event], gap_list: list[tuple[int, int]]) -> dict[str, int]:
    """Idle nanoseconds by what the host was doing: each gap is labelled by
    the innermost host event open at its middle (the latest to start), or
    "host idle" where none is open."""
    out: dict[str, int] = collections.Counter()
    events = sorted(host, key=lambda h: h[1])
    heap: list = []  # (-start, end, name) of the events started so far
    i = 0
    for s, e in sorted(gap_list, key=lambda g: g[0] + g[1]):
        t = (s + e) // 2
        while i < len(events) and events[i][1] <= t:
            heapq.heappush(heap, (-events[i][1], events[i][2], events[i][0]))
            i += 1
        while heap and heap[0][1] <= t:  # ended: no later middle lies inside it
            heapq.heappop(heap)
        out[heap[0][2] if heap else "host idle"] += e - s
    return out


@dataclasses.dataclass
class Window:
    """A traced window reduced: its length and busy time, and device time
    by operation name."""

    window_ns: int
    busy_ns: int
    by_name: dict[str, int]
    device_ops: list[list]
    idle_gaps: list[list]

    @property
    def window_s(self) -> float:
        return self.window_ns / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def time_s(self, patterns) -> float:
        """Device seconds of the operations whose name matches any of
        ``patterns`` (regular expressions, searched)."""
        rx = re.compile("|".join(patterns))
        return sum(ns for name, ns in self.by_name.items() if rx.search(name)) / 1e9


def reduce(dev: list[Event], host: list[Event], lo_ns: int, hi_ns: int, top: int = 10) -> Window:
    """The window [lo_ns, hi_ns) of a trace: device operations clipped to
    it, their union, device time by name, the ``top`` operations by time
    and the ``top`` host activities by the idle time they spanned (each
    idle gap labelled by the innermost host event open at its middle)."""
    clipped = [(n, max(s, lo_ns), min(e, hi_ns)) for n, s, e in dev if e > lo_ns and s < hi_ns]
    by_name: dict[str, int] = collections.Counter()
    for n, s, e in clipped:
        by_name[n] += e - s
    spans = [(s, e) for _, s, e in clipped]
    idle = label_gaps(host, gaps(spans, lo_ns, hi_ns))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return Window(hi_ns - lo_ns, union_ns(spans), dict(by_name),
                  [[n[:160], ns / 1e9] for n, ns in ops], [[n[:160], ns / 1e9] for n, ns in longest])


def _span(prof) -> tuple[list[Event], list[Event], int, int]:
    dev, host = events_of(prof)
    lo = min(e[1] for e in dev + host)
    hi = max(e[2] for e in dev + host)
    print(f"trace: {len(dev)} device events, {len(host)} host events over {(hi - lo) / 1e9:.3f} s")
    return dev, host, lo, hi


def summarize(prof, labels=None) -> Window:
    """A finished profiler's window, from its first event to its last; with
    ``labels`` (a second finished profiler, of host and device) the idle
    gaps of the breakdown are those of ``labels``' window, labelled by its
    host events."""
    win = reduce(*_span(prof))
    if labels is not None:
        win.idle_gaps = reduce(*_span(labels)).idle_gaps
    return win
