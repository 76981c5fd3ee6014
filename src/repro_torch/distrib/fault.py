"""Fault-tolerance scaffolding for multi-host deployments (a copy of
``repro.distrib.fault``, which is pure Python; the port keeps its own).

What one host can enforce is implemented and tested (anomaly guard in
the train step, atomic resumable checkpoints, elastic re-sharding on
restore, stateless data addressing). What needs a real multi-host runtime
is provided as deployable hooks with documented semantics:

  - Heartbeat: each host touches <dir>/host_<k> every ``interval``; a
    coordinator (or any peer) calls ``stale_hosts`` and triggers
    checkpoint-restart excluding dead hosts. With stateless data addressing
    and mesh-agnostic restore, a restart at a smaller host count is just
    `train.py --resume` with a new mesh (elastic scale-down).
  - Straggler mitigation: per-step wall-time EWMA; a host whose step time
    exceeds ``threshold``x the fleet median flags itself for eviction at the
    next checkpoint boundary (synchronous SPMD cannot drop a straggler
    mid-step; the knob that matters is restart cost, which the async
    checkpointer keeps at seconds).
"""
from __future__ import annotations

import os
import time


class Heartbeat:
    def __init__(self, directory: str, host_index: int, interval_s: float = 10.0):
        self.dir = directory
        self.host = host_index
        self.interval = interval_s
        self._last = 0.0
        os.makedirs(directory, exist_ok=True)

    def path(self, host: int | None = None) -> str:
        return os.path.join(self.dir, f"host_{self.host if host is None else host}")

    def beat(self, step: int):
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        with open(self.path(), "w") as f:
            f.write(f"{step} {now}")

    def stale_hosts(self, n_hosts: int, timeout_s: float = 60.0) -> list[int]:
        now = time.time()
        stale = []
        for h in range(n_hosts):
            p = self.path(h)
            if not os.path.exists(p) or now - os.path.getmtime(p) > timeout_s:
                stale.append(h)
        return stale


class StragglerMonitor:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.0):
        self.alpha = alpha
        self.threshold = threshold
        self.ewma: float | None = None

    def record(self, step_time_s: float, fleet_median_s: float | None = None) -> bool:
        """Returns True when this host should flag itself as a straggler."""
        self.ewma = (
            step_time_s
            if self.ewma is None
            else (1 - self.alpha) * self.ewma + self.alpha * step_time_s
        )
        ref = fleet_median_s if fleet_median_s is not None else self.ewma
        return step_time_s > self.threshold * max(ref, 1e-9)
