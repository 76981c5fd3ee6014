#!/usr/bin/env python3
"""Time the port's two attention kernels on one NVIDIA card.

    PYTHONPATH=src python scripts/bench_attention.py [--out FILE]

- the paged flash decode (``kernels.flash_attention.paged_flash_decode``)
  at the serving shape of ``chip_smoke.py`` (4 slots, lengths 70/40/100/65,
  a 7-page table) and at a long-context shape (16 slots of 4096 tokens,
  256 pages each, 134 MB of E4M3 pages, beyond the 50 MB L2): Hq 32, Hkv 8,
  hd 128, page 16, fp16 queries. Times are CUDA-graph replays of 100 calls
  (the card's time alone) and eager calls (the wrapper's host work
  included), beside the plain version and a gather of the pages plus
  ``scaled_dot_product_attention``;
- the dense flash attention (``kernels.flash_attention.flash_attention``)
  at granite-3-8b's training shape, B1 S2048 Hq32 Hkv8 hd128, causal,
  fp16 (the tensor-core kernel) and fp32 (the register-tiled CUDA-core
  kernel), and at Hq16 Hkv8 hd256 in fp16 (the tensor cores' 64-key
  instance; the SIMT kernel before it had one), each beside
  ``scaled_dot_product_attention``, with its route.

It uses only the wrappers' common signatures, so the same script times
an older checkout of the package (point ``PYTHONPATH`` at its ``src``).
``--splits 1,2,4`` also times the paged decode at each given split count
(graph replays; the wrapper's ``splits=`` override, which older checkouts
lack). Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch
import torch.nn.functional as F


def time_ms(fn, iters: int = 100, graph: bool = False) -> float:
    """Mean device time of one call by CUDA events; with ``graph``, over a
    replay of a CUDA graph that captured ``iters`` calls."""
    for _ in range(3):
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


def decode_case(seed: int, s: int, lens: list[int], pages_per_slot: int, *, hq=32, hkv=8,
                hd=128, ps=16):
    """A decode step on the card: random E4M3 pools, shuffled physical pages
    (page 0 is NULL), each slot's pages up to its decode position."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = s * pages_per_slot + 1
    q = torch.randn((s, hq, hd), generator=gen, device="cuda").half()
    kp, vp = (torch.randn((n_pages * ps, hkv, hd), generator=gen, device="cuda")
              .to(torch.float8_e4m3fn) for _ in range(2))
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda").int() + 1
    pt = torch.zeros((s, pages_per_slot), dtype=torch.int32, device="cuda")
    for i, n in enumerate(lens):
        used = n // ps + 1
        pt[i, :used] = perm[i * pages_per_slot:i * pages_per_slot + used]
    seq = torch.tensor(lens, dtype=torch.int32, device="cuda")
    act = torch.ones(s, dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, seq, act


def bench_decode(label: str, case, splits: list[int]) -> dict:
    from repro_torch.core.precision import take_rows
    from repro_torch.kernels.flash_attention import paged_flash_decode, paged_flash_decode_plain

    q, kp, vp, pt, seq, act = case
    s, hq, hd = q.shape
    hkv, ps = kp.shape[1], 16
    args = (q.reshape(s, hkv, hq // hkv, hd), kp, vp, pt, seq, act)
    got = paged_flash_decode(*args, page_size=ps)
    want = paged_flash_decode_plain(*args, page_size=ps)
    n_tok = pt.shape[1] * ps
    read_idx = (pt.long()[:, :, None] * ps + torch.arange(ps, device="cuda")).reshape(s, n_tok)
    mask = (torch.arange(n_tok, device="cuda")[None] <= seq.long()[:, None])[:, None, None, :]

    def gather_sdpa():
        k = take_rows(kp, read_idx).half().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
        v = take_rows(vp, read_idx).half().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v, attn_mask=mask)

    sweep = {n: time_ms(lambda: paged_flash_decode(*args, page_size=ps, splits=n), graph=True)
             for n in splits if n <= pt.shape[1]}
    lens = seq.tolist()
    live_tokens = sum((n // ps + 1) * ps for n in lens)
    nbytes = (2 * live_tokens * hkv * hd * kp.element_size() + 2 * q.numel() * q.element_size()
              + pt.numel() * 4 + 2 * s * 4)
    return {
        "kernel": "paged_flash_decode", "shape": label,
        "ms_graph": time_ms(lambda: paged_flash_decode(*args, page_size=ps), graph=True),
        "ms_eager": time_ms(lambda: paged_flash_decode(*args, page_size=ps)),
        "plain_ms": time_ms(lambda: paged_flash_decode_plain(*args, page_size=ps), iters=10),
        "library_ms": time_ms(gather_sdpa, iters=10),
        "bound_ms": nbytes / 3.35e12 * 1e3, "bytes": nbytes,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms_graph_by_splits": sweep,
    }


def bench_dense(dtype=torch.float16, hq=32, hkv=8, hd=128) -> dict:
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
        plan_flash,
    )

    b, s = 1, 2048
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, s, hq, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    route = plan_flash(q, k, v)
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    qt = q.transpose(1, 2)
    kt, vt = (t.repeat_interleave(hq // hkv, dim=2).transpose(1, 2) for t in (k, v))
    flops = 4.0 * b * hq * hd * s * (s + 1) / 2
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    # fp32 has no tensor-core form that keeps its numerics: the CUDA cores'
    # fp32 peak; fp16 and bf16 the tensor cores' 989 TFLOP/s.
    peak = 67e12 if dtype == torch.float32 else 989e12
    name = str(dtype).removeprefix("torch.")
    return {
        "kernel": "flash_attention", "route": route,
        "shape": f"B{b} S{s} Hq{hq} Hkv{hkv} hd{hd} causal {name}",
        "ms_graph": time_ms(lambda: flash_attention(q, k, v), iters=20, graph=True),
        "ms_eager": time_ms(lambda: flash_attention(q, k, v), iters=20),
        "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v), iters=5),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), iters=20),
        "bound_ms": max(flops / peak, nbytes / 3.35e12) * 1e3,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the JSON line to this file")
    ap.add_argument("--splits", default="", help="comma-separated split counts to time the "
                    "paged decode at, besides the planner's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    splits = [int(n) for n in args.splits.split(",") if n]
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        rows = [
            bench_decode("S4 Hq32 Hkv8 hd128 ps16 e4m3, lengths 70/40/100/65, 7-page table",
                         decode_case(2, 4, [70, 40, 100, 65], 7), splits),
            bench_decode("S16 Hq32 Hkv8 hd128 ps16 e4m3, 4096 tokens a slot, 256 pages",
                         decode_case(3, 16, [4095] * 16, 256), splits),
            bench_dense(),
            # fp32 on the register-tiled kernel (csrc/flash_attention.cu), and
            # hd 256 in fp16 on the tensor cores.
            bench_dense(torch.float32),
            bench_dense(torch.float16, hq=16, hkv=8, hd=256),
        ]
    for r in rows:
        assert all(math.isfinite(v) for v in r.values() if isinstance(v, float)), r
    line = json.dumps({"card": card, "rows": rows})
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
