#!/usr/bin/env python3
"""Where a served step's host time goes, by the program's spans, on one
NVIDIA card: a benchmark cell's closed loop (``perfbench/``'s own set-up
of the cell: the configuration, the weights drawn on the card, the server
warmed), run untraced for ``--warm`` seconds, then ``--steps`` server
steps under a profile of host and card.

    python scripts/profile_serve_spans.py [--workload phi3.5-moe.serve-16clients] \\
        [--seed N] [--warm 20] [--steps 40] [--out build/spans.json]

Prints, for the steps that dispatched a prefill and for those that did
not: the mean wall time untraced and traced; each span's inclusive
milliseconds a step, its calls a step and microseconds a call; the share
of the step's wall time that its top-level spans cover (``server.schedule``
and ``server.harvest``); which span each span opened in; the GEMM-Op's host
microseconds a call (``_MpCore``, torch's label of the engine's GEMM-Op
call, casts included, and each ``gemm.*`` span); and the profile's span
count a step. Writes the same as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="phi3.5-moe.serve-16clients")
    ap.add_argument("--seed", type=int, default=2147483700)
    ap.add_argument("--warm", type=float, default=20.0, help="untraced seconds of the loop")
    ap.add_argument("--steps", type=int, default=40, help="server steps under the profile")
    ap.add_argument("--out", default="build/spans.json")
    return ap.parse_args(argv)


class Loop:
    """A closed loop of the cell's clients against its server."""

    def __init__(self, server, reqs, clients: int):
        self.server, self.reqs = server, reqs
        for _ in range(clients):
            self.submit()

    def submit(self) -> None:
        prompt, n = next(self.reqs)
        self.server.submit(prompt, max_new_tokens=n)

    def step(self) -> tuple[int, int]:
        """One server step; returns its (start, end) in Unix ns, the
        profiler's clock."""
        t0 = time.time_ns()
        events = self.server.step()
        t1 = time.time_ns()
        for ev in events:
            if ev.finished:
                self.submit()
        return t0, t1


def _nest(events):
    """[name, start, end, innermost span open around it or None, own ns,
    that span's row] of host events given as (start, -end, name): an
    event's own time is its duration less its children's."""
    from repro_torch.obs import is_span

    out, stack = [], []  # stack: rows of ``out`` still open
    for start, neg_end, name in sorted(events):
        end = -neg_end
        while stack and stack[-1][2] <= start:
            stack.pop()
        around = next((r for r in reversed(stack) if is_span(r[0])), None)
        parent = around[0].partition("[")[0] if around else None
        if stack:
            stack[-1][4] -= end - start
        row = [name, start, end, parent, end - start, around]
        out.append(row)
        stack.append(row)
    return out


def reduce(events, steps, top: int = 15) -> dict:
    """The traced steps by kind, those that dispatched a prefill step and
    the others: ``steps`` is [(start, end)] in the profiler's clock,
    ``events`` the main thread's host events as (start, -end, name)."""
    from repro_torch.obs import is_span

    windows = sorted(steps)
    by_step = collections.defaultdict(list)
    j = 0
    for row in sorted(_nest(events), key=lambda r: r[1]):
        while j < len(windows) and windows[j][1] < row[1]:
            j += 1
        if j < len(windows) and windows[j][0] <= row[1]:
            by_step[j].append(row)
    kinds = {True: [], False: []}
    for i in range(len(windows)):
        kinds[any(r[0].startswith("engine.prefill") for r in by_step[i])].append(i)
    out = {}
    for prefill, idx in kinds.items():
        if not idx:
            continue
        n = len(idx)
        wall = sum(windows[i][1] - windows[i][0] for i in idx)
        spans = collections.defaultdict(lambda: [0, 0])
        own = collections.defaultdict(lambda: [0, 0])
        parents = collections.Counter()
        first = {}  # (span, parent) -> its first occurrence's times against the parent's, us
        covered = 0
        for i in idx:
            for name, start, end, parent, own_ns, around in by_step[i]:
                key = "engine.prefill_chunk" if name.startswith("engine.prefill_chunk") else name
                own[key][0] += own_ns
                own[key][1] += 1
                if not is_span(name):
                    continue
                spans[key][0] += end - start
                spans[key][1] += 1
                parents[(name.partition("[")[0], parent)] += 1
                if around is not None:
                    first.setdefault((name.partition("[")[0], parent),
                                     [(start - around[1]) / 1e3, (end - around[2]) / 1e3])
                if parent is None:
                    covered += end - start
        mp = [r[2] - r[1] for i in idx for r in by_step[i] if r[0] == "_MpCore"]

        def table(rows):
            return {k: {"ms_a_step": ns / n / 1e6, "calls_a_step": c / n,
                        "us_a_call": ns / c / 1e3 if c else None}
                    for k, (ns, c) in sorted(rows.items(), key=lambda kv: -kv[1][0])}

        out["prefill" if prefill else "no_prefill"] = {
            "steps": n, "wall_ms": wall / n / 1e6, "top_spans_share": covered / wall,
            "spans_a_step": sum(c for _, c in spans.values()) / n,
            "spans": table(spans),
            "own_time_top": table(dict(sorted(own.items(), key=lambda kv: -kv[1][0])[:top])),
            "gemm_op_us_a_call": sum(mp) / len(mp) / 1e3 if mp else None,
            "gemm_op_calls_a_step": len(mp) / n,
            "parents": [[c, p, k, first.get((c, p))]
                        for (c, p), k in sorted(parents.items(), key=str)],
        }
    return out


def report(doc: dict) -> None:
    print(f"card {doc['card']}, torch {doc['torch']}, {doc['workload']} seed {doc['seed']}")
    for kind, u in doc["untraced_ms"].items():
        print(f"untraced, steps that {kind}: {u['steps']} steps, mean {u['mean']} ms")
    for kind, r in doc["traced"].items():
        gemm = r["gemm_op_us_a_call"]
        print(f"traced {kind}: {r['steps']} steps, {r['wall_ms']:.2f} ms a step, top-level spans "
              f"{100 * r['top_spans_share']:.2f}% of it, {r['spans_a_step']:.0f} spans a step; "
              f"GEMM-Op (_MpCore) {gemm or 0:.1f} us a call, "
              f"{r['gemm_op_calls_a_step']:.0f} a step")
        for title, rows in (("spans, inclusive", r["spans"]), ("own time", r["own_time_top"])):
            print(f"  {title}: ms a step, calls a step, us a call")
            for k, v in rows.items():
                print(f"  {v['ms_a_step']:10.3f} {v['calls_a_step']:9.1f} "
                      f"{v['us_a_call'] or 0:10.1f}  {k[:80]}")
        print("  nesting (span < parent: count [first one's start and end against the "
              "parent's, us]): " + ", ".join(f"{c}<{p}:{k} {f}" for c, p, k, f in r["parents"]))


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from perfbench import manifest
    from perfbench.kinds import serve_closed

    if not torch.cuda.is_available():
        print("profile_serve_spans: needs a CUDA card", file=sys.stderr)
        return 1
    bench = manifest.Manifest(ROOT)
    cell = bench.workload(args.workload)
    cfg, mix = bench.config(cell["config"]), manifest.traffic(cell["traffic"])
    _, _, reqs, server = serve_closed._setup(cfg, mix, args.seed, "cuda")
    loop = Loop(server, reqs, int(mix["clients"]))
    hist = server.metrics.histogram("serving_prefill_chunk_seconds")
    untraced = {True: [], False: []}
    t_end = time.perf_counter() + args.warm
    while time.perf_counter() < t_end:
        n = hist.count
        s, e = loop.step()
        untraced[hist.count > n].append((e - s) / 1e6)
    torch.cuda.synchronize()
    steps = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            steps.append(loop.step())
        torch.cuda.synchronize()
    tid = _main_tid(prof)
    events = [(e.start_ns(), -e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.start_thread_id() == tid]
    doc = {"card": torch.cuda.get_device_name(0), "workload": args.workload,
           "seed": args.seed, "torch": torch.__version__,
           "untraced_ms": {("harvested a prefill" if k else "harvested none"):
                           {"steps": len(v), "mean": sum(v) / len(v) if v else None}
                           for k, v in untraced.items()},
           "traced": reduce(events, steps)}
    report(doc)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(doc, indent=1) + "\n")
    return 0


def _main_tid(prof) -> int:
    """The thread that opened the most ``server.schedule`` spans."""
    tids = collections.Counter(e.start_thread_id() for e in prof.profiler.kineto_results.events()
                               if e.name() == "server.schedule")
    return tids.most_common(1)[0][0]


if __name__ == "__main__":
    sys.exit(main())
