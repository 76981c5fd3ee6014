#!/usr/bin/env python3
"""Host time a call of the port's GEMM-Op entry point on one NVIDIA card.

    PYTHONPATH=src python scripts/bench_gemm_host.py [--label NAME] [--calls N]
        [--against OLDER/src]

``ops.gemm_op`` at granite-3-8b's decode shape (4 x 4096 x 12800, E4M3
operands already in storage format, a K-major weight as ``fp8_params``
stores it, redmule_hfp8, the small-row schedule): the host clock around N
back-to-back calls, after 20 warm ones. The small-row kernel runs for
about 27 µs and the wrapper plans on the host for longer, so the calls
are host-bound and the mean is the host's cost a call (the planner, the
layout, the launch). Rows:

- ``plan only``: ``redmule_gemm.plan_call`` alone, no launch (the
  planner's share of ``table``, with less of the launch's noise);
- ``table``: no plan asked for (the path every model call takes);
- ``autotune cache``: ``REPRO_AUTOTUNE=1`` with the shape already in the
  cache (a temporary file; the first call sweeps it);
- ``explicit plan``: ``schedule="small_row", split=2`` passed in.

The last two need ``repro_torch.kernels.tuning``; on an older checkout
(point ``PYTHONPATH`` at its ``src``) only the first two run. Five
repetitions a row; prints one JSON line a row, with the card's name and
power limit. Host times spread by tens of µs from one process to the
next, so ``--against`` compares with an older checkout inside one
process: both packages are imported (the older first, then dropped from
``sys.modules`` with its modules kept, each with its own kernel library)
and their ``plan only`` and ``table`` rows are timed in turns, 20 blocks
of N calls each, the first tree alternating; one more JSON line a row
gives both trees' block means and the median of the pairs' differences.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def _host_us(call, n: int) -> float:
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _import_port(src: str | None = None):
    """A fresh import of the port's (ops, redmule_gemm, semiring,
    get_policy), from ``src`` when given, else from ``PYTHONPATH``. Earlier
    copies are dropped from ``sys.modules`` first (their modules live on
    where they are referenced), and so is the copy from ``src`` after."""
    for name in [n for n in sys.modules if n.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    if src is not None:
        sys.path.insert(0, src)
    try:
        from repro_torch.core import semiring
        from repro_torch.core.precision import get_policy
        from repro_torch.kernels import ops, redmule_gemm
    finally:
        if src is not None:
            sys.path.remove(src)
            for name in [n for n in sys.modules if n.split(".")[0] == "repro_torch"]:
                del sys.modules[name]
    return ops, redmule_gemm, semiring, get_policy


def _in_turns(calls: dict, n: int, blocks: int = 20) -> dict:
    """Block means (µs a call) of each labelled call, timed in turns."""
    for call in calls.values():
        _host_us(call, 50)
    means = {label: [] for label in calls}
    labels = list(calls)
    for b in range(blocks):
        for label in labels if b % 2 == 0 else labels[::-1]:
            means[label].append(_host_us(calls[label], n))
    return means


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--label", default="this tree")
    parser.add_argument("--calls", type=int, default=2000)
    parser.add_argument("--against", metavar="SRC",
                        help="an older checkout's src, timed in this process in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm_host: CUDA is not available")
    from repro_torch.core import semiring
    from repro_torch.core.precision import E4M3, cast, get_policy
    from repro_torch.kernels import ops, redmule_gemm

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = cast(torch.randn((4, 4096), generator=gen, device="cuda"), E4M3)
    w = cast(torch.randn((12800, 4096), generator=gen, device="cuda") * 4096 ** -0.5, E4M3).T
    policy = get_policy("redmule_hfp8")

    def gemm(**kw):
        return lambda: ops.gemm_op(x, w, gop=semiring.MATMUL, policy=policy,
                                   operand_quant=False, backend="cuda", **kw)

    def plan():
        return redmule_gemm.plan_call(x, w, None, gop=semiring.MATMUL, policy=policy)

    rows = [("plan only", plan, None), ("table", gemm(), None)]
    tuning = None
    if importlib.util.find_spec("repro_torch.kernels.tuning") is not None:
        from repro_torch.kernels import tuning
        rows += [("autotune cache", gemm(), "1"),
                 ("explicit plan", gemm(schedule="small_row", split=2), None)]
    card = _card()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(tmp, "plans.json")
        for name, call, autotune in rows:
            if autotune:
                os.environ["REPRO_AUTOTUNE"] = autotune
            if tuning is not None:
                tuning.reset_cache()  # the wrappers read the environment once
            reps = [_host_us(call, args.calls) for _ in range(5)]
            os.environ.pop("REPRO_AUTOTUNE", None)
            print(json.dumps({"tree": args.label, "row": name, "host_us_a_call": reps,
                              "shape": "4x4096x12800 e4m3", "card": card}), flush=True)
        os.environ.pop("REPRO_AUTOTUNE_CACHE")
    if args.against:
        older = _import_port(args.against)
        this = _import_port()
        trees = {}
        for tree, (t_ops, t_rg, t_semiring, t_policy) in (("older", older), ("this", this)):
            pol, gop = t_policy("redmule_hfp8"), t_semiring.MATMUL
            trees[tree] = {
                "plan only": lambda t_rg=t_rg, pol=pol, gop=gop: t_rg.plan_call(
                    x, w, None, gop=gop, policy=pol),
                "table": lambda t_ops=t_ops, pol=pol, gop=gop: t_ops.gemm_op(
                    x, w, gop=gop, policy=pol, operand_quant=False, backend="cuda"),
            }
        for row in ("plan only", "table"):
            means = _in_turns({tree: trees[tree][row] for tree in trees}, args.calls)
            diffs = [a - b for a, b in zip(means["this"], means["older"])]
            print(json.dumps({"tree": args.label, "against": args.against, "row": row,
                              "in_turns_us": means, "median_diff_us": statistics.median(diffs),
                              "shape": "4x4096x12800 e4m3", "card": card}), flush=True)


if __name__ == "__main__":
    main()
