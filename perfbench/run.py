"""One run of one benchmark cell on the card(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It pins the program's plan switches,
draws the cell's weights and traffic from ``--seed``, warms every shape
the cell uses (set-up), measures for ``--seconds`` seconds, checks what
the timed path produced against the plain reference, and prints one JSON
line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines
of standard error). Without a card, with fewer cards than the cell asks
for, or when JAX or the JAX package was loaded, it prints no result and
exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # The checkout's root (for ``perfbench``) and its ``src`` (for the
    # program), in place of this file's own directory.
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def passed(checks: dict) -> bool:
    """A count of tokens checked is held to its least; every other number
    to its greatest."""
    return all(c["value"] >= c["limit"] if name.endswith("_checked") else c["value"] <= c["limit"]
               for name, c in checks.items())


def result_line(res: dict, cell: dict, bench, trace: bool, device: dict) -> dict:
    from perfbench import manifest

    metrics = {}
    if trace:
        run = {"trace": res["trace"], "observed": res["observed"], "shape": res["shape"]}
        for m in bench.metrics("per_layer", cell):
            value = manifest.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device |= {"busy_s": res["trace"].busy_s, "window_s": res["trace"].window_s}
    else:
        for m in bench.metrics("end_to_end", cell):
            value = res["end_to_end"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": passed(res["checks"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = {"device_ops": res["trace"].device_ops,
                             "idle_gaps": res["trace"].idle_gaps}
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    from perfbench import env

    env.pin()
    import torch

    from perfbench import manifest, yardstick

    bench = manifest.Manifest(ROOT)
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['name']} needs {cell['chips']} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfg = bench.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    res = manifest.kind(mix["kind"]).run(
        cfg, mix, args.seed, args.seconds, trace=bool(args.trace), device="cuda",
        limits=manifest.limits(cell["name"]), t_start=T_START)
    found = env.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the benchmark runs the port "
              "without JAX or the JAX package", file=sys.stderr)
        return 3
    res["shape"] = yardstick.model_shape(cfg)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    line = result_line(res, cell, bench, bool(args.trace), device)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
