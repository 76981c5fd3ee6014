"""The readings a serve cell's limits are set from, on the card at the
cell's own size (not part of a benchmark run):

    python3 perfbench/controls.py --workload <cell> --seeds 11 12 13 [--seconds 20] \
        [--fault one_slot] [--out readings.jsonl]

For each seed the program's loop runs ``--seconds`` at the cell's own
load, and one JSON line gives the check's numbers (``perfbench/kinds/
serve_closed.py``: the worst checked request's mean logit gap, the mean
and widest gap over every checked token, the count) for the program
(``program``) and, on the same prompts and tokens, for each control: the
reference one precision below the stated E4M3, read at each position as
the gap of the token the control puts first: int4 operands and KV
(``int4``) and E5M2 operands and KV (``e5m2``). With ``--fault`` the
program runs with that fault of ``perfbench/faults.py`` planted, and the
line gives the check's numbers for the broken program alone.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]

CONTROLS = {"int4": {"operand": "int4", "out": "fp16"}, "e5m2": {"operand": "e5m2", "out": "fp16"}}


def serve_readings(cfg: dict, mix: dict, seed: int, seconds: float, device: str,
                   fault: str | None = None) -> dict:
    import contextlib

    import torch

    from perfbench import faults
    from perfbench.kinds import serve_closed as sc
    from perfbench.reference import decoder as ref

    with faults.planted(fault) if fault else contextlib.nullcontext():
        out, served = sc.serve(cfg, mix, seed, seconds, trace=False, device=device,
                               t_start=time.perf_counter())
    seqs, starts, tokens = sc.picked(served, seed)
    stated = sc.reference_logits(cfg, served["params"], seqs, starts, sc.reference_precision(cfg),
                                 cfg["deployment"].get("kv_format"), device)
    res = {"requests_finished": out["attempted"], "out_tok_s": out["end_to_end"]["out_tok_s"],
           "program": sc.gap_summary(sc.gap_sd(stated, [torch.tensor(t, device=device)
                                                        for t in tokens]))}
    if fault:
        return res | {"fault": fault}
    for name, prec in CONTROLS.items():
        lower = sc.reference_logits(cfg, served["params"], seqs, starts, ref.Precision(**prec),
                                    prec["operand"], device)
        res[name] = sc.gap_summary(sc.gap_sd(stated, [c.argmax(-1) for c in lower]))
        del lower
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from perfbench import env

    env.pin()
    import torch

    from perfbench import manifest

    if not torch.cuda.is_available():
        print("controls.py reads the card", file=sys.stderr)
        return 2
    bench = manifest.Manifest(ROOT)
    cell = bench.workload(args.workload)
    cfg = bench.config(cell["config"])
    mix = manifest.traffic(cell["traffic"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = serve_readings(cfg, mix, seed, args.seconds, "cuda", args.fault)
        line = json.dumps({"workload": cell["name"], "seed": seed,
                           "seconds": time.perf_counter() - t0, **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
