"""Wall-clock profiling of the serving stack's device steps (the port's
``repro.obs.profiler``).

:class:`StepProfiler` keys every measurement by ``(kind, shape_bucket)``
and attributes the **first** call of a key apart from every later call.
In the reference that first call holds the jit compile; in the port the
kernels are built before the clocks start (``launch/serve.py`` calls
``_build.library()`` first), and the first call of a key holds what a
step shape does once: the decode graph's eager warm-up and capture, and
the caching allocator's growth to the step's working set. The record
keeps the reference's field name, ``compile_s``, for that first call.
That separation is why ``Server.reset()`` deliberately does NOT clear the
profiler: the warm-up makes each shape's first call, and the timed run
after the reset reuses the captured graph and the grown pools, so the
profiler's first-call memory keeps the attribution honest across the
reset. A key that first appears in a timed run (a shape the warm-up did
not cover) shows up with its own first call, the usual cause of a
latency spike.

:func:`device_capture` is the opt-in escalation: a context manager around
``torch.profiler.profile`` (CPU and, on the card, CUDA activities) that
records the wrapped window only and exports it as a Chrome trace into a
log directory (Perfetto-loadable; kernel rows carry the CUDA kernels'
names, ``redmule_gemm_*`` and ``paged_decode_*`` among them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

TRACE_FILE = "device_trace.json"


@dataclasses.dataclass
class StepRecord:
    """Aggregate timing of one (kind, shape_bucket) device step."""

    kind: str
    bucket: str
    calls: int = 0
    compile_s: float = 0.0  # first call: graph capture, allocator growth, run
    steady_s: float = 0.0  # every later call, summed
    steady_max_s: float = 0.0

    @property
    def steady_calls(self) -> int:
        return max(0, self.calls - 1)

    @property
    def steady_mean_s(self) -> float:
        n = self.steady_calls
        return self.steady_s / n if n else 0.0


class StepProfiler:
    """Per-(kind, shape-bucket) wall-clock accounting of device steps."""

    def __init__(self):
        self.records: dict[tuple[str, str], StepRecord] = {}

    def record(self, kind: str, bucket, seconds: float) -> None:
        key = (kind, str(bucket))
        rec = self.records.get(key)
        if rec is None:
            rec = self.records[key] = StepRecord(kind=kind, bucket=str(bucket))
        rec.calls += 1
        if rec.calls == 1:
            rec.compile_s = seconds
        else:
            rec.steady_s += seconds
            rec.steady_max_s = max(rec.steady_max_s, seconds)

    @contextlib.contextmanager
    def step(self, kind: str, bucket):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(kind, bucket, time.perf_counter() - t0)

    def summary(self) -> dict[str, dict]:
        """JSON-able view keyed ``kind[bucket]``, first call and steady split."""
        out = {}
        for (kind, bucket), r in sorted(self.records.items()):
            out[f"{kind}[{bucket}]"] = {
                "calls": r.calls,
                "compile_s": r.compile_s,
                "steady_calls": r.steady_calls,
                "steady_s": r.steady_s,
                "steady_mean_s": r.steady_mean_s,
                "steady_max_s": r.steady_max_s,
            }
        return out

    def format_summary(self) -> str:
        lines = ["step profile (first call = capture and allocator growth):"]
        for key, s in self.summary().items():
            lines.append(
                f"  {key}: first {s['compile_s'] * 1e3:.1f} ms, "
                f"steady {s['steady_mean_s'] * 1e6:.0f} us/call "
                f"x {s['steady_calls']}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.records = {}


@contextlib.contextmanager
def device_capture(logdir: Optional[str], *, enabled: bool = False):
    """Opt-in ``torch.profiler`` capture of the wrapped window. Yields the
    profiler (its ``key_averages()`` give time by kernel), or None when
    ``logdir`` is None and ``enabled`` is False: then it is a passthrough, so
    call sites can wrap unconditionally. With ``logdir`` the window is
    exported as a Chrome trace to ``logdir/device_trace.json`` (the
    directory is made). A profiler that fails to start or to export raises:
    a capture that was asked for never degrades to a run without one."""
    if not logdir and not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
