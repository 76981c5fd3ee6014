#!/usr/bin/env python3
"""Time one checkout of the port's GEMM-Op small-row schedule, its K-major
copy and its decode serving on one NVIDIA card, so that two checkouts can be
compared in one call.

    PYTHONPATH=<checkout>/src python scripts/bench_small_row.py [--label NAME] [--serve N]

The package is the one ``PYTHONPATH`` names (an older checkout's ``src``
too); the harness is this repository's ``chip_smoke.py``, whose timer
(``time_ms``: CUDA events around a CUDA-graph replay), copy shapes
(``COPY_ROWS``) and serve run (phase 8's ``serve_run`` and phase 12's
``_feature_run``) it calls. It uses only the package's interfaces that
such checkouts share. Rows:

- the small-row GEMM (redmule_hfp8, E4M3 operands, fp16 out) at granite-3-8b's
  decode shapes (4 rows: q/o 4096 x 4096, k/v 4096 x 1024, gate/up 4096 x
  12800, down 12800 x 4096, the logits through ``table.T``), the MoE
  drafter's decode down (16384 x 1024) and seamless's decode FFN down
  (8192 x 1024), each on the planner's split, with and without Y, and
  deepseek's gate/up (7168 x 19200), internvl2's down (28672 x 8192) and
  phi3.5-moe's dense-MoE down (102400 x 4096) without: the device time of
  one call (the kernel and, on a checkout whose small-row splits end in a
  second launch, that combine too), its launches, and a hash of the
  output's bits (equal across checkouts wherever their splits agree);
- the K-major copy at ``COPY_ROWS``, each bitwise against its plain version;
- with ``--serve N``: granite-3-8b at full depth (``_serve_model``), N times
  phase 8's run (decode tok/s with the graph's capture in the decode
  seconds) and N times a warmed-up run (``_feature_run``: decode tok/s, the
  decode graph's busy share, the device ms of one decode replay).

Bound: each byte read once and written once at 3.35 TB/s (against
operations at the fp8 tensor-core peak, 1979 TFLOP/s, for the GEMM). Prints
one JSON line a row, the serve runs' log lines, and one JSON line with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_S = 3.35e12
FP8_FLOP_S = 1979e12


def harness():
    """This repository's chip_smoke.py, imported after the package under
    test, so that its ``repro_torch`` imports resolve to that package."""
    import repro_torch  # noqa: F401  (the package under test, first)

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def gemm_row(cs, label, x, w, y, iters=50):
    from repro_torch.core import semiring
    from repro_torch.core.precision import FP16, get_policy
    from repro_torch.kernels import redmule_gemm as rg

    kw = dict(gop=semiring.MATMUL, policy=get_policy("redmule_hfp8"), out_dtype=FP16)
    plan = rg.plan_call(x, w, y, gop=kw["gop"], policy=kw["policy"]).plan
    counters = (rg.small_row_launches, rg.aux_launches)
    before = [c.n for c in counters]
    got = rg.redmule_gemm(x, w, y, **kw)
    launches = [c.n - b for c, b in zip(counters, before)]
    err = cs.rel_err(got, rg.redmule_gemm_plain(x, w, y, **kw))
    if not err <= cs.GEMM_TOL[got.dtype]:
        raise AssertionError(f"{label}: {err:.3g} off the plain version")
    m, k = x.shape
    n = w.shape[-1]
    operands = (x, w, got) + ((y,) if y is not None else ())
    nbytes = sum(t.numel() * t.element_size() for t in operands)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, 2.0 * m * k * n / FP8_FLOP_S * 1e3
    print(json.dumps({
        "row": label, "schedule": plan.schedule, "split": plan.split,
        "kernel_launches": launches[0], "aux_launches": launches[1],
        "ms": cs.time_ms(lambda: rg.redmule_gemm(x, w, y, **kw), iters=iters, graph=True),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "rel_err": err,
        "bits": hashlib.sha256(got.view(torch.int16).cpu().numpy()).hexdigest()[:16],
    }), flush=True)


def copy_rows(cs, gen):
    from repro_torch.core.precision import E4M3, E5M2
    from repro_torch.kernels import redmule_gemm as rg

    for label, (a, b), fmt, route in cs.COPY_ROWS:
        src = torch.randn((a, b), generator=gen, device="cuda").to(E4M3 if fmt == "e4m3" else E5M2)
        args = ((src, 1, 1, b, a, [0, 0, 1, b], True) if route == "tile"
                else (src, 1, 1, a, b, [0, 0, b, 1], True))
        got = rg.kmajor_copy(*args)[0]
        if not torch.equal(got.view(torch.int16), rg.kmajor_copy_plain(*args).view(torch.int16)):
            raise AssertionError(f"copy {label}: differs from its plain version")
        nbytes = src.numel() * src.element_size() + got.numel() * got.element_size()
        print(json.dumps({
            "row": f"copy {label}", "ms": cs.time_ms(lambda: rg.kmajor_copy(*args), graph=True),
            "bound_ms": nbytes / HBM_BYTES_S * 1e3, "bound_by": "bytes",
        }), flush=True)


def serve_runs(cs, n: int) -> None:
    cfg, model, params = cs._serve_model()
    for i in range(n):
        server, _, wall, _ = cs.serve_run(cfg, model, params)
        s = server.stats
        cs.log(f"phase 8 run {i}: decode {s.decode_tok_s:.1f} tok/s of stream seconds, decode "
               f"{s.decode_s:.3f} s "
               f"(capture included) over {s.decode_steps} steps, prefill {s.prefill_s:.3f} s, "
               f"wall {wall:.3f} s")
    prompts = cs._serve_prompts(cfg)
    for i in range(n):
        cs._feature_run(f"warmed-up graph run {i}", model, params, prompts)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="", help="a name printed with the card line")
    ap.add_argument("--serve", type=int, default=0, help="serve runs of each kind (0: none)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_small_row: needs a CUDA card")
    cs = harness()
    import repro_torch
    from repro_torch.core.precision import E4M3, FP16, cast

    print(f"package: {Path(repro_torch.__file__).parent}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def q(fmt, *shape, scale=1.0):
        return cast(cast(torch.randn(shape, generator=gen, device="cuda") * scale, FP16), fmt)

    with torch.inference_mode():
        x4096, x12800 = q(E4M3, 4, 4096), q(E4M3, 4, 12800)
        for label, x, n in (("granite q/o 4x4096x4096", x4096, 4096),
                            ("granite k/v 4x4096x1024", x4096, 1024),
                            ("granite gate/up 4x4096x12800", x4096, 12800),
                            ("granite down 4x12800x4096", x12800, 4096),
                            ("moe decode down 4x16384x1024", q(E4M3, 4, 16384), 1024),
                            ("seamless decode FFN down 4x8192x1024", q(E4M3, 4, 8192), 1024)):
            w = q(E4M3, n, x.shape[1], scale=0.02).T  # K-major, as the E4M3 weights are kept
            gemm_row(cs, label, x, w, None)
            gemm_row(cs, label + " + Y", x, w,
                     torch.randn(4, n, generator=gen, device="cuda").half())
        gemm_row(cs, "granite logits 4x4096x49155 (table.T)", x4096,
                 q(E4M3, 49155, 4096, scale=0.02).T, None, iters=20)
        for label, k, n in (("deepseek decode gate/up 4x7168x19200", 7168, 19200),
                            ("internvl2 decode down 4x28672x8192", 28672, 8192),
                            ("phi moe decode down 4x102400x4096", 102400, 4096)):
            gemm_row(cs, label, q(E4M3, 4, k), q(E4M3, n, k, scale=0.01).T, None, iters=10)
        copy_rows(cs, gen)
        if args.serve:
            serve_runs(cs, args.serve)
    print(json.dumps({"card": card, "label": args.label, "torch": torch.__version__}))


if __name__ == "__main__":
    main()
