#!/usr/bin/env python3
"""Time the GEMM-Op kernel's SIMT schedule on one NVIDIA card.

    PYTHONPATH=src python scripts/bench_simt.py [--plain] [--label NAME]

Rows, each checked against the plain version (``redmule_gemm_plain``) on
the same inputs before it is timed: the semiring pairs bit for bit (NaN
positions, then the bits elsewhere), (mul, add) within 1e-5 of the
output's largest magnitude:

- the MoE router, fp32 (mul, add), 4 x 1024 x 32 (a draft-decode step)
  and 64 x 1024 x 32 (the drafter's catch-up), beside ``torch.matmul``;
- apsp (add, min) 64 x 4096 x 12800 on E4M3 operands under redmule_hfp8;
- one squaring of a 4096-node closure, D' = min(D, D (+) D), under fp32
  (apsp) and under redmule_fp16 (max_capacity_path: (min, max));
- fp32 (mul, add) 64 x 4096 x 12800, the fp32 policy's widest product,
  beside ``torch.matmul`` (TF32 off);
- ``Engine.closure`` of a 4096-node graph under fp32 (apsp): ms and the
  number of squarings, checked bit for bit against Floyd-Warshall in plain
  torch on the card. Edge weights are integers in [1, 16] and missing
  edges 1e6, so every path sum is exact in fp32.

Kernel times are CUDA-graph replays (the card's time alone); the closure is
timed on the host clock around a synchronised call. Bound: each operand
byte read once and the output written once at 3.35 TB/s, against
2 * M * K * N operations at the fp32 CUDA-core peak (67 TFLOP/s). ``--plain``
also times the plain versions (seconds at the 4096 shapes). The script
uses only the wrappers' common signatures, so it times an older checkout
of the package too (point ``PYTHONPATH`` at its ``src``). Prints one JSON
line a row and one with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12


def time_ms(fn, iters: int, graph: bool = True) -> float:
    """Mean device time of one call by CUDA events; with ``graph``, over a
    replay of a CUDA graph that captured ``iters`` calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for _ in range(iters):
            fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same positions and the same bits everywhere else."""
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    if not torch.equal(gn, wn):
        return False
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    return torch.equal(got.view(bits)[~gn], want.view(bits)[~wn])


def row(label, x, w, y, op, policy, *, plain, iters, library=False):
    from repro_torch.core import semiring
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import redmule_gemm as rg

    gop, pol = semiring.get(op), get_policy(policy)
    kw = dict(gop=gop, policy=pol, out_dtype=pol.out)
    plan = rg.plan_call(x, w, y, gop=gop, policy=pol).plan
    got = rg.redmule_gemm(x, w, y, **kw)
    want = rg.redmule_gemm_plain(x, w, y, **kw)
    torch.cuda.synchronize()
    if gop.is_gemm:
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        ok = err <= 1e-5
    else:
        err = float((got.float() - want.float()).nan_to_num().abs().max())
        ok = same_bits(got, want)
    if not ok:
        raise AssertionError(f"{label}: the kernel disagrees with the plain version ({err:.3g})")
    ms = time_ms(lambda: rg.redmule_gemm(x, w, y, **kw), iters)
    m, k = x.shape[-2:]
    n = w.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, got))
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, 2.0 * m * k * n / FP32_FLOP_S * 1e3
    out = {"row": label, "schedule": plan.schedule, "form": getattr(plan, "form", ""),
           "split": plan.split, "ms": ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "rel_err" if gop.is_gemm else "max_abs_err": err}
    if library:
        out["library_ms"] = time_ms(lambda: torch.matmul(x, w), iters)
    if plain:
        out["plain_ms"] = time_ms(lambda: rg.redmule_gemm_plain(x, w, y, **kw), 1, graph=False)
    print(json.dumps(out), flush=True)


def graph_4096(gen, v=4096, p=4.0 / 4096):
    """A random directed graph: each edge present with probability ``p``,
    integer weights in [1, 16], 1e6 where there is none, 0 on the
    diagonal."""
    w = torch.randint(1, 17, (v, v), generator=gen, device="cuda").float()
    present = torch.rand((v, v), generator=gen, device="cuda") < p
    d = torch.where(present, w, torch.full_like(w, 1e6))
    d.fill_diagonal_(0.0)
    return d


def floyd_warshall(d: torch.Tensor) -> torch.Tensor:
    d = d.clone()
    for k in range(d.shape[0]):
        torch.minimum(d, d[:, k:k + 1] + d[k:k + 1, :], out=d)
    return d


def closure_row(gen, *, plain):
    from repro_torch.engine import Engine
    from repro_torch.kernels import redmule_gemm as rg

    d = graph_4096(gen)
    eng = Engine(policy="fp32", backend="cuda")
    got = eng.closure(d, "apsp")
    torch.cuda.synchronize()
    launches = rg.launches.n
    t0 = time.perf_counter()
    got = eng.closure(d, "apsp")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    steps = rg.launches.n - launches
    t0 = time.perf_counter()
    want = floyd_warshall(d)
    torch.cuda.synchronize()
    fw_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("closure V=4096: the kernels' closure differs from Floyd-Warshall")
    out = {"row": "closure apsp V=4096 fp32", "ms": ms, "steps": steps,
           "floyd_warshall_ms": fw_ms, "unreachable": int((got >= 1e6).sum())}
    if plain:
        t0 = time.perf_counter()
        Engine(policy="fp32", backend="torch").closure(d, "apsp")
        torch.cuda.synchronize()
        out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plain", action="store_true", help="also time the plain versions")
    ap.add_argument("--label", default="", help="a name printed with the card line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_simt: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.precision import E4M3, cast

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *s, scale=1.0: torch.randn(s, generator=gen, device="cuda") * scale  # noqa: E731
    plain = args.plain
    router_w = rand(1024, 32, scale=0.02)
    row("moe router 4x1024x32 fp32", rand(4, 1024), router_w, None, "matmul", "fp32",
        plain=plain, iters=100, library=True)
    row("moe router 64x1024x32 fp32", rand(64, 1024), router_w, None, "matmul", "fp32",
        plain=plain, iters=100, library=True)
    row("apsp 64x4096x12800 e4m3", cast(rand(64, 4096).half(), E4M3),
        cast(rand(4096, 12800, scale=4096 ** -0.5), E4M3), None, "apsp", "redmule_hfp8",
        plain=plain, iters=10)
    d = graph_4096(gen)
    row("apsp 4096x4096x4096 fp32 (a closure squaring)", d, d, d, "apsp", "fp32",
        plain=plain, iters=3)
    c = rand(4096, 4096).half()
    row("max_capacity_path 4096x4096x4096 fp16", c, c, c, "max_capacity_path",
        "redmule_fp16", plain=plain, iters=3)
    del d, c
    row("matmul 64x4096x12800 fp32", rand(64, 4096), rand(4096, 12800, scale=4096 ** -0.5),
        None, "matmul", "fp32", plain=plain, iters=10, library=True)
    closure_row(gen, plain=plain)
    print(json.dumps({"card": card, "label": args.label, "torch": torch.__version__}))


if __name__ == "__main__":
    main()
