#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the port's CUDA sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together);
3. the GEMM-Op kernel against its plain PyTorch version, on the card:
   all seven Table-1 ops, ragged, batched, broadcast and transposed
   operands, and the serving path's shapes (phase 13's verify and MoE
   drafter shapes among them), each with the schedule it takes and the
   share of its outputs that differ from the plain version;
   then each schedule (tensor cores, small rows, SIMT) at its edges: the
   rows around the small-row threshold, K-major and strided operands (the
   latter through the K-major copy), K not a multiple of 128, the E5M2
   pairs, the 16-bit forms; two exact-sum cases that must be bitwise
   equal, a planted dropped K tile per schedule that must fail, a decode
   GEMM run twice that must give the same bits, and the two auxiliary
   kernels (K-major copy, split-K combine) bitwise against their plain
   versions;
3c. the SIMT schedule's three forms (warp, f32, h2): every Table-1 pair
   under fp32 and redmule_hfp8 on operands with NaN, +-inf, +-0 and values
   past 464, at ragged shapes with K split across a boundary, transposed
   views, K = 1001 and a batch stride of 0 (NaN positions, then bits); a
   planted dropped K split per tiled form that must fail; the MoE router
   bit for bit eager and replayed; and the semiring paths at full size,
   read on the counters: ``Engine.closure`` of a 4096-node graph under fp32
   (apsp) and redmule_fp16 (max_capacity_path) against Floyd-Warshall bit
   for bit, and ``Engine.gemm_op`` apsp 64x4096x12800 under redmule_hfp8;
4. the paged flash-decode kernel against its plain version, then its split
   page walk at its edges: 64-page tables with lengths ending in the first
   split, on a split boundary and in the last, whole splits dead by
   length, by NULL pages and by the window, an inactive slot and softcap
   with splits, the long-context shape (16 slots of 4096 tokens), and one
   case run twice, which must give the same bits; the grid includes phase
   13's drafter shape (hd 64, 16/8 heads);
5. the dense flash-attention kernel against its plain version (granite's
   and gemma2's shapes in fp32, fp16 and bf16, a ragged non-causal case,
   and the tensor-core kernel's edges: Sq not a multiple of 128,
   non-causal with Sk != Sq, hd 64, softcap), each case on the route
   ``plan_flash`` names (granite's fp16 and bf16 on the tensor cores, fp32
   on the SIMT kernel), read by the two kernels' launch counters; the
   error read row by row, and a planted dropped key must fail each case;
   then its main path: one call of the entry point ``ops.flash_attention``
   on the tensor cores;
6. the GEMM-Op kernel on the training path's backward operand pairs
   (E5M2 x E4M3^T and E4M3^T x E5M2, fp16 out, at the train run's shapes,
   the tied unembedding's K = 49155 included), and the fp16 -> E5M2
   cotangent cast on the card against the CPU;
7. slice parity: granite-3-8b at full width with 2 layers, one prefill of
   two prompts and 4 decode steps, kernels ("cuda") against the plain path
   ("torch") on the card, under fp32 and under redmule_hfp8;
8. serve: granite-3-8b at full width and depth (40 layers) under
   redmule_hfp8 with E4M3 weights and KV pages, 8 requests through the
   port's ``Server`` (traced: phase 18(b)) with the decode step as a CUDA
   graph, with the kernels' launch counts read around every prefill and
   around the decode step's eager warm-up and its capture (a replay ticks
   no counter; the replays must equal the decode steps): each decode GEMM
   on the small-row schedule, each prefill GEMM on the tensor cores but the
   last token's logits, one paged-decode launch a layer a decode step (and
   its split count);
12. serving features, right after phase 8 on its model: (a) the decode
    graph against the eager decode step at dispatch depths 0, 1 and 2,
    tokens and every decode step's logits bitwise; (b) chunked prefill at
    32, serial and batched (P, 32), bitwise, every chunk step read on the
    launch counters (dense layers and attention products on the tensor
    cores, the logits on small rows) and the schedule of each GEMM shape
    printed; (c) the prefix cache behind a 48-token system prompt (hits
    and a copy on write counted); (d) a 512-token low-priority prompt
    preempted mid-prefill and resumed through the prefix cache to the
    tokens it gives alone; (e) at 2 layers under fp32, chunked, batched
    and prefix-hit prefill within 1e-4 of the whole prompt and the same
    greedy tokens from four servers. Each run prints decode tok/s,
    prefill s, wall, peak memory and the decode graph's busy share;
13. speculative decoding, right after phase 12 on its model: (a) the
    rejection sampler on the card, TV < 0.05 at N = 4000 for drafter
    logits and deterministic drafts, greedy rows' decisions equal to the
    CPU's; (b) at full width with 2 layers, granite-3-8b's ``verify_cb``
    and the MoE drafter's (granite-moe-1b-a400m) prefill, catch-up and
    decode, kernels against the plain path at phase 7's bounds (but the
    drafter's catch-up under redmule_hfp8 at 3e-3, with the router gate
    behind its difference logged); (c) the
    new shapes in phases 3, 4 and 11; (d) granite-3-8b at 40 layers with
    k = 4: 8 requests of repeated motifs, 32 new tokens each, plain with
    the decode graph, then speculative with the n-gram drafter and with
    granite-moe-1b-a400m at 24 layers (E4M3 weights and pages) as the
    drafter: each graph (verify, drafter catch-up, drafter decode)
    captured once, verify replays equal to rounds, each graph step's
    launches read at its warm-up and capture (verify GEMMs on the tensor
    cores; drafter decode GEMMs on small rows but the fp32 routers, SIMT;
    one paged decode a layer a draft step); decode tok/s against the plain
    graph, acceptance, accepted a round, verify replay ms, drafter round
    ms, peak memory; greedy tokens against the plain run's with the
    divergence accounting, which a planted off-by-one (draft i + 1 judged
    by ``logits[:, i + 1]``) must fail at this depth; the model drafter
    at temperature 1.0 with an acceptance above 0; (e) fp32 at 2 layers:
    greedy speculative tokens equal to plain decode with both drafters and
    no pages left held, and the planted off-by-one must fail that check;
14. the other attention-only decoders, after phase 13, each built, run
    and freed in turn (chatglm3-6b, deepseek-coder-33b, gemma2-2b,
    phi3.5-moe-42b-a6.6b): (a) at full width with 2 layers (gemma2's one
    local and one global), phase 7's run, kernels against the plain path
    under fp32 (1e-4) and redmule_hfp8 (0), with the GEMM calls by shape
    and schedule; (b) at full depth through the serve launcher with phase
    8's flags (decode tok/s, prefill s, TTFT p50, peak memory), then the
    decode graph against the eager step, tokens and decode logits bit for
    bit; each run's launches read alone, a decode step's by shape at its
    warm-up and capture; gemma2's 4600-token request in chunks of 512 at
    26 layers, and at 2 layers kernels against plain under fp32 (1e-4) and
    redmule_hfp8 (8.5e-3), the same tokens and the decode logits within
    the bound, which the decode called without the window must leave, so
    the local layers' window binds in the chunked prefill and the decode
    kernel; (c) the new decode shapes in the kernel line (11), the
    softcapped ones beside a compiled ``flex_attention``; (d) after phase 10: chatglm3-6b's train parity at 2 layers
    (phase 9's bounds), chatglm3-6b at 4 layers, deepseek-coder-33b at 2
    and gemma2-2b at the depth whose training state fits (26) through the
    train launcher;
15. the recurrent families, after phase 14, each built, run and freed in
    turn: (a) recurrentgemma-2b at 3 layers and xlstm-125m at 2, full
    width, kernels against plain under fp32 (1e-4) and redmule_hfp8 (0)
    over phase 7's whole, chunked and batched runs and a recycled slot,
    where a planted fault (the recycled rows not reset at position 0) must
    leave each bound; (b) both through the serve launcher at full depth
    with phase 8's flags (E4M3 weights for xlstm only), the decode graph
    against eager bit for bit, xlstm with no paged decode, no KV bytes and
    no pages; (c) recurrentgemma's 3000-token request in chunks of 512
    with 64 new tokens, its pages within the windowed reservation, and at
    3 layers under fp32 kernels against plain, which the decode called
    without the window must leave; (d) after phase 14(d): granite-moe's
    train parity at 2 layers with the aux loss, then through the train
    launcher xlstm-125m (4 of its 12 layers), recurrentgemma-2b and phi3.5-moe at
    the depth that fits, granite-moe (24 layers), with each scan's share
    of its train step; the new shapes in the kernel line (11);
16. speculative decoding over recurrent state rows, after phase 15: (a)
    at full width and one unit of each pattern under fp32 (recurrentgemma
    3 layers, xlstm 2), greedy speculative tokens equal to the plain
    decode graph's, with n-gram drafts and (xlstm) an xlstm drafter on
    the target's own parameters (acceptance >= 0.9) and on seed 1's; (b)
    both at full depth through the serve launcher with phase 15(b)'s flags
    and ``--spec-k 4`` (xlstm also with ``--draft-model xlstm-125m``), the
    counters zeroed before and read after: decode tok/s against the plain
    graph on the same prompts, acceptance, the verify, commit and drafter
    replay ms and the drafter's snapshot clone and restore ms (CUDA
    events), each graph captured once and replayed once a round, the
    greedy tokens within the launcher gate's accounting, the xlstm
    drafter on the target's own parameters, and recurrentgemma's
    3000-token request with speculation holding its pages within the
    windowed reservation; the verify and commit shapes in the kernel line;
17. the encoder-decoder and VLM families, after phase 16, each built, run
    and freed in turn: (a) seamless-m4t-large-v2 and internvl2-76b at full
    width with 2 layers, kernels against plain under fp32 (1e-4) and
    redmule_hfp8 (0): ``forward``, ``prefill`` and 4 decode steps, and
    ``generate_static``'s tokens under redmule_hfp8; (b) the static serve
    launcher at full width (4 requests of 64 tokens, 16 new, E4M3 weights
    and KV), internvl2 at the depth its weights fit beside
    ``ENCDEC_SPARE``: prefill s, decode tok/s, peak memory; (c) after
    phase 15(d), seamless at 24 + 24 layers and internvl2 at the depth
    whose training state fits through the train launcher; the new shapes
    in the kernel line (11);
18. observability (``repro_torch.obs``): (a) before phase 8, granite-3-8b
    at full width with 2 layers, phase 8's prompts traced and untraced: the
    same tokens and decode-graph replays, the trace through
    ``scripts/validate_trace.py`` (a process of its own), and an eager run
    under a roofline recorder (``roofline/cost.py``) counting every kernel
    call; (b) phase 8's server carries a ``JsonTracer``: its registry
    against its stats and the run (one idle wait a harvest, a step
    observation a step, a TTFT a request), its trace validated, the host's
    wait share read from the "in flight" track; after phase 12, the serve
    run with the tracer off, on, on, off (decode tok/s, the same tokens);
    phase 14(b)'s first launcher call (chatglm3-6b, full depth) with
    ``--trace-out``, ``--metrics-out`` and ``--profile LOGDIR`` into
    ``build/chip_smoke_obs/``: the trace validated, the metrics' counters
    equal to the printed stats, the profile naming the ``redmule_gemm`` and
    ``paged_decode`` kernels; (c) every bound of the kernel line is
    ``roofline/cost.py``'s count;
19. the paper's workloads, after phase 17(c): (a) each example's
    ``main`` (``repro_torch.examples``) on the card with its own asserts,
    the GEMM-Op launches read around each (the semiring examples all on
    the SIMT schedule); (b) every GEMM of ``paper_tinyml.training_gemms``
    for ResNet8, MobileNetV2 and TinyTransformer under redmule_fp16 and
    redmule_hfp8 through ``Engine.matmul``, within ``GEMM_TOL`` of the
    plain backend, timed as graph replays beside its recorded bound and
    ``torch.matmul``; one summed kernel-line row a network, policy and schedule;
9. train parity: granite-3-8b at full width with 2 layers, one step's loss
   and gradients at the train run's batch (2 x 1024) on the kernels' path
   against the plain path on the card, under fp32 and redmule_hfp8 (bound
   0: the same bits);
10. train: granite-3-8b at full width and 4 layers under redmule_hfp8,
    remat "block", batch 2 x 1024, 4 steps through the train launcher,
    with the GEMM (by schedule) and attention launches read per step: every
    GEMM on the tensor cores;
11. the kernel line: each kernel's launches, error, time, bound, plain time
    and one library call's time at its main path's shapes (the GEMM at
    every (mul, add) shape of both paths, phase 12's chunked and batched
    prefill included, with ``torch._scaled_mm`` beside
    ``torch.matmul`` where its shape rules allow, and its schedule; the
    SIMT forms at the router's two shapes, phase 3c's semiring paths and
    phase 7's widest fp32 product, and the split-K combine with min; the
    paged decode at the serving and the long-context shape, as CUDA-graph
    replays with eager calls beside; the dense attention with its route;
    phase 14's and phase 15's shapes).

The last line is ``{"ok": true, "device": {...}}``. The script imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

GEMM_TOL = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 1.6e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def _timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"{label}: {time.perf_counter() - t0:.1f} s")
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def time_ms(fn, iters: int = 20, graph: bool = False, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls.
    With ``graph`` the calls are captured once in a CUDA graph and the
    graph is replayed, so the time is the card's alone: the GEMM wrapper
    plans on the host for longer than its small-row kernels run, which
    eager calls would time instead."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        del g
        return start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ulp_spread(got: torch.Tensor, want: torch.Tensor) -> tuple[float, int]:
    """(share of elements whose bits differ, worst distance in ulps) of two
    16-bit float tensors: the bit patterns mapped to ordered integers."""
    def ordered(t):
        b = t.contiguous().view(torch.int16).int() & 0xFFFF
        return torch.where(b >= 0x8000, -(b & 0x7FFF), b)
    d = (ordered(got) - ordered(want)).abs()
    return float((d != 0).float().mean()), int(d.max())


# -- phase 1 ---------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port's smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    return smi


# -- phase 2 ---------------------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("  " + line.strip())


# -- phase 3 ---------------------------------------------------------------------


def _gemm_check(label, x, w, y, gop, policy):
    from repro_torch.kernels import ops

    got = ops.gemm_op(x, w, y, gop=gop, policy=policy, backend="cuda")
    want = ops.gemm_op(x, w, y, gop=gop, policy=policy, backend="torch")
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if gop.is_gemm:
        err = rel_err(got, want)
        tol = GEMM_TOL[got.dtype]
        if not err <= tol:
            raise AssertionError(f"{label}: max|dz|/max|z| = {err:.3g} > {tol}")
    else:
        err = float((got.float() - want.float()).nan_to_num().abs().max())
        if not same_bits(got, want):
            raise AssertionError(f"{label}: min/max op not bitwise (NaN positions, then bits), "
                                 f"max|dz| = {err}")
    return err


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """NaN at the same positions, and the same bits everywhere else (the
    sign of a zero included): ``torch.equal`` on floats fails on any NaN
    and takes -0 for +0."""
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(gn, wn):
        return False
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    return torch.equal(got.view(bits)[~gn], want.view(bits)[~wn])


def phase_gemm() -> float:
    from repro_torch.core import semiring
    from repro_torch.core.precision import get_policy

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    worst = 0.0
    n = 0
    for pol_name in ("fp32", "redmule_hfp8"):
        pol = get_policy(pol_name)
        for gop in semiring.TABLE1:
            cases = {
                "2d": (rand(37, 129), rand(129, 70), None),
                "2d+y": (rand(37, 129), rand(129, 70), rand(37, 70)),
                "batched-x shared-w": (rand(3, 37, 129), rand(129, 70), rand(37, 70)),
                "broadcast-w": (rand(2, 3, 37, 129), rand(2, 1, 129, 70), None),
                "transposed-w": (rand(2, 37, 129), rand(70, 129).T, None),
            }
            for label, (x, w, y) in cases.items():
                e = _gemm_check(f"{pol_name}/{gop.name}/{label}", x, w, y, gop, pol)
                n += 1
                if gop.is_gemm and pol_name == "redmule_hfp8":
                    worst = max(worst, e)
    # The MoE router (phase 13): fp32 on the SIMT schedule, the catch-up's 64 rows.
    _gemm_check("fp32/matmul/moe router 64x1024x32", rand(64, 1024), rand(1024, 32, scale=0.02),
                None, semiring.MATMUL, get_policy("fp32"))
    n += 1
    bf16 = get_policy("tpu_bf16")
    for label, (x, w) in {"2d": (rand(37, 129), rand(129, 70)),
                          "transposed-w": (rand(5, 37, 129), rand(70, 129).T)}.items():
        _gemm_check(f"tpu_bf16/matmul/{label}", x, w, None, semiring.MATMUL, bf16)
        n += 1
    # The serving path's shapes under redmule_hfp8: decode and prefill rows
    # of the widest layer, the tied logits on a transposed table, and the
    # two attention products (GQA group folded into the rows).
    hfp8 = get_policy("redmule_hfp8")
    table = rand(49155, 4096, scale=0.02)
    k = rand(1, 96, 8, 128).permute(0, 2, 3, 1)  # (B, Hkv, hd, T) strided view
    # A chunk step at chunk 32 over a 7-page row attends over [112 gathered
    # | 32 fresh] keys, concatenated and permuted as the layer does.
    chunk_k = torch.cat([rand(1, 112, 8, 128), rand(1, 32, 8, 128)], 1).permute(0, 2, 3, 1)
    chunk_v = torch.cat([rand(1, 112, 8, 128), rand(1, 32, 8, 128)], 1).permute(0, 2, 1, 3)
    verify_k = torch.cat([rand(4, 128, 8, 128), rand(4, 5, 8, 128)], 1)
    main = {
        "decode 4x4096x12800": (rand(4, 4096), rand(4096, 12800, scale=4096 ** -0.5)),
        "prefill 64x4096x12800": (rand(64, 4096), rand(4096, 12800, scale=4096 ** -0.5)),
        "logits 1x4096x49155 (table.T)": (rand(1, 4096), table.T),
        "scores (1,8)x384x128x96": (rand(1, 8, 4 * 96, 128), k),
        "values (1,8)x384x96x128": (torch.rand(1, 8, 4 * 96, 96, generator=gen, device=dev),
                                    rand(1, 8, 96, 128)),
        "chunk scores (1,8)x128x128x144": (rand(1, 8, 4 * 32, 128), chunk_k),
        "chunk values (1,8)x128x144x128": (
            torch.rand(1, 8, 4 * 32, 144, generator=gen, device=dev), chunk_v),
        "batched prefill (4,32)x4096x12800": (rand(4, 32, 4096),
                                              rand(4096, 12800, scale=4096 ** -0.5)),
        # Phase 13's speculative shapes: the verify step's 20 rows (4 slots x
        # 5 positions, on the tensor cores) and its two attention products
        # over 8-page rows (128 gathered keys and 5 fresh); the MoE drafter's
        # expert GEMMs (decode on small rows, catch-up at 64 rows) and logits.
        "verify 20x4096x12800": (rand(20, 4096), rand(4096, 12800, scale=4096 ** -0.5)),
        "verify 20x4096x1024 (k, v)": (rand(20, 4096), rand(4096, 1024, scale=4096 ** -0.5)),
        "verify 20x4096x4096 (q, o)": (rand(20, 4096), rand(4096, 4096, scale=4096 ** -0.5)),
        "verify logits 20x4096x49155 (table.T)": (rand(20, 4096), table.T),
        "verify scores (4,8)x20x128x133": (rand(4, 8, 4 * 5, 128), verify_k.permute(0, 2, 3, 1)),
        "verify values (4,8)x20x133x128": (
            torch.rand(4, 8, 4 * 5, 133, generator=gen, device=dev), verify_k.permute(0, 2, 1, 3)),
        "moe decode 4x1024x16384": (rand(4, 1024), rand(1024, 16384, scale=1024 ** -0.5)),
        "moe decode 4x16384x1024": (rand(4, 16384), rand(16384, 1024, scale=512 ** -0.5)),
        "moe catch-up 64x1024x16384": (rand(64, 1024), rand(1024, 16384, scale=1024 ** -0.5)),
        "drafter logits 4x1024x49155 (table.T)": (rand(4, 1024),
                                                  rand(49155, 1024, scale=0.02).T),
    }
    for label, (x, w) in main.items():
        worst = max(worst, _gemm_check(f"redmule_hfp8/matmul/{label}", x, w, None,
                                       semiring.MATMUL, hfp8))
        _log_spread(f"redmule_hfp8/matmul/{label}", x, w, hfp8)
        n += 1
    log(f"gemm: {n} cases agree (min/max bitwise; worst hfp8 matmul max|dz|/max|z| {worst:.3g})")
    return worst


def _log_spread(label, x, w, policy, out_dtype=None) -> None:
    """Print the schedule of a main-path shape and how its output bits
    spread around the plain version's: the share of elements that differ
    and the worst difference in output ulps."""
    from repro_torch.core import semiring
    from repro_torch.core.precision import cast
    from repro_torch.kernels.redmule_gemm import plan_call, redmule_gemm, redmule_gemm_plain

    xq, wq = cast(x, policy.storage_fwd), cast(w, policy.storage_fwd)
    kw = dict(gop=semiring.MATMUL, policy=policy, out_dtype=out_dtype or policy.out)
    plan = plan_call(xq, wq, None, gop=semiring.MATMUL, policy=policy).plan
    share, ulps = ulp_spread(redmule_gemm(xq, wq, None, **kw),
                             redmule_gemm_plain(xq, wq, None, **kw))
    log(f"  {label}: schedule {plan.schedule} (K-major copies x {plan.copy_x}, w {plan.copy_w}, "
        f"split {plan.split}); {share:.2%} of outputs differ from the plain version, "
        f"worst {ulps} ulp")


# -- phase 3b --------------------------------------------------------------------


def _exact_operand(gen, *shape):
    """E4M3 values in {-1, 0, 1}: with K <= 2048 every partial sum is an
    integer below 2^11, exact in any order and in any accumulator width the
    tensor cores keep, so the kernel must give the plain version's bits."""
    from repro_torch.core.precision import E4M3

    return torch.randint(-1, 2, shape, generator=gen, device=gen.device).float().to(E4M3)


def phase_gemm_schedules() -> None:
    """Each GEMM schedule at its edges against the plain version: the rows
    around the small-row threshold, K-major and strided weights (the
    latter through the K-major copy), K that is not a multiple of 128 (and
    one that is not of 16), the backward E5M2 pairs, the 16-bit wgmma
    forms; two exact cases that must match bitwise; a planted dropped K
    tile per schedule that must fail; and a decode GEMM run twice that must
    give the same bits (the split-K partials are combined in a fixed order)."""
    from repro_torch.core import semiring
    from repro_torch.core.precision import E4M3, E5M2, FP16, cast, get_policy
    from repro_torch.kernels import redmule_gemm as rg

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(7)
    hfp8 = get_policy("redmule_hfp8")

    def q(fmt, *shape, scale=1.0):
        return cast(cast(torch.randn(shape, generator=gen, device=dev) * scale, FP16), fmt)

    def run(x, w, policy, out_dtype=None):
        kw = dict(gop=semiring.MATMUL, policy=policy, out_dtype=out_dtype or policy.out)
        return rg.redmule_gemm(x, w, None, **kw), rg.redmule_gemm_plain(x, w, None, **kw)

    def expect_plan(label, x, w, policy, schedule, copies):
        plan = rg.plan_call(x, w, None, gop=semiring.MATMUL, policy=policy).plan
        if (plan.schedule, (plan.copy_x, plan.copy_w)) != (schedule, copies):
            raise AssertionError(f"{label}: planned {plan}, expected {schedule} "
                                 f"with copies {copies}")
        return plan

    cases = []
    for m in (1, 4, 16, 17, 64, 256):
        sched = "small_row" if m <= rg.SMALL_M_MAX else "tc"
        wide = m > rg.TC_TILE_M  # N = 1000: both operands widened to fp16 by the copy
        cases += [
            (f"M{m} K4096 K-major w", q(E4M3, m, 4096), q(E4M3, 1000, 4096, scale=0.02).T,
             hfp8, None, sched, (wide, wide)),
            (f"M{m} K4000 strided w", q(E4M3, m, 4000), q(E4M3, 4000, 1000, scale=0.02),
             hfp8, None, sched, (wide, True)),
            (f"M{m} K1000 strided w", q(E4M3, m, 1000), q(E4M3, 1000, 1000, scale=0.02),
             hfp8, None, sched, (sched == "tc", True)),
        ]
    cases += [
        ("E5M2 x E4M3^T M4 (small rows)", q(E5M2, 4, 4096, scale=0.01),
         q(E4M3, 1024, 4096, scale=0.02).T, hfp8, FP16, "small_row", (False, False)),
        ("E5M2 x E4M3^T 96x1000x1280", q(E5M2, 96, 1280, scale=0.01),
         q(E4M3, 1000, 1280, scale=0.02).T, hfp8, FP16, "tc", (False, False)),
        ("E5M2 x E4M3^T 256x1000x1280 (widened)", q(E5M2, 256, 1280, scale=0.01),
         q(E4M3, 1000, 1280, scale=0.02).T, hfp8, FP16, "tc", (True, True)),
        ("E4M3^T x E5M2 1000x256x1280", q(E4M3, 256, 1000).T, q(E5M2, 256, 1280, scale=0.01),
         hfp8, FP16, "tc", (True, True)),
        ("fp16 wgmma 200x1000x300", torch.randn(200, 1000, generator=gen, device=dev).half(),
         torch.randn(1000, 300, generator=gen, device=dev).half(), get_policy("redmule_fp16"),
         None, "tc", (False, True)),
        ("bf16 wgmma 200x1000x300", torch.randn(200, 1000, generator=gen, device=dev).bfloat16(),
         torch.randn(300, 1000, generator=gen, device=dev).bfloat16().T, get_policy("tpu_bf16"),
         None, "tc", (False, False)),
    ]
    worst = 0.0
    for label, x, w, pol, out, sched, copies in cases:
        expect_plan(label, x, w, pol, sched, copies)
        got, want = run(x, w, pol, out)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        if not torch.isfinite(got.float()).all() or not err <= GEMM_TOL[got.dtype]:
            raise AssertionError(f"schedules {label}: max|dz|/max|z| = {err:.3g} > "
                                 f"{GEMM_TOL[got.dtype]}")
        worst = max(worst, err)
    log(f"gemm schedules: {len(cases)} edge cases agree (worst max|dz|/max|z| {worst:.3g})")

    # Exact sums: bitwise, one case per tensor-core schedule (and the
    # widened operands of the tensor-core one).
    for label, m, sched in (("tensor cores", 64, "tc"), ("tensor cores, widened", 256, "tc"),
                            ("small rows", 4, "small_row")):
        x, w = _exact_operand(gen, m, 2048), _exact_operand(gen, 1000, 2048).T
        wide = sched == "tc" and m > rg.TC_TILE_M
        expect_plan(f"exact {label}", x, w, hfp8, sched, (wide, wide))
        got, want = run(x, w, hfp8)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"exact sums on the {label} schedule differ from "
                                 "the plain version")
    log("gemm schedules: the exact-sum cases (E4M3 in {-1, 0, 1}, K 2048) bitwise equal")

    # A planted dropped K tile per schedule: the plain version without one
    # 128-wide block of K must read outside GEMM_TOL.
    fp32 = get_policy("fp32")
    planted = {}
    for sched, m, pol in (("small_row", 4, hfp8), ("tc", 64, hfp8), ("tc", 256, hfp8),
                          ("simt", 37, fp32)):
        x = q(E4M3, m, 4096) if pol is hfp8 else torch.randn(m, 4096, generator=gen, device=dev)
        w = q(E4M3, 1000, 4096, scale=0.02).T if pol is hfp8 else \
            torch.randn(4096, 1000, generator=gen, device=dev)
        wide = sched == "tc" and m > rg.TC_TILE_M
        expect_plan(f"planted {sched}", x, w, pol, sched, (wide, wide))
        sched += " widened" if wide else ""
        got = run(x, w, pol)[0]
        x_drop = x.clone()
        x_drop.view(torch.uint8 if x.element_size() == 1 else torch.int32)[:, 1024:1152] = 0
        want = run(x_drop, w, pol)[1]
        torch.cuda.synchronize()
        planted[sched] = rel_err(got, want)
        if not planted[sched] > GEMM_TOL[got.dtype]:
            raise AssertionError(f"a dropped K tile on the {sched} schedule reads "
                                 f"{planted[sched]:.3g}, within GEMM_TOL {GEMM_TOL[got.dtype]}")
    log("gemm schedules: a planted dropped K tile fails every schedule ("
        + ", ".join(f"{k} {v:.3g}" for k, v in planted.items()) + ")")

    # Determinism: decode GEMMs with split K, twice, the same bits.
    for n in (12800, 1024):
        x, w = q(E4M3, 4, 4096), q(E4M3, n, 4096, scale=0.02).T
        plan = expect_plan(f"repeat N{n}", x, w, hfp8, "small_row", (False, False))
        a, b = run(x, w, hfp8)[0], run(x, w, hfp8)[0]
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
            raise AssertionError(f"decode GEMM 4x4096x{n} gave different bits on two runs")
        log(f"gemm schedules: decode 4x4096x{n} (split {plan.split}) gives the same bits twice")

    # The auxiliary kernels against their plain versions, bitwise.
    for fmt in (E4M3, E5M2):
        w = q(fmt, 300, 1000)
        for widen in (False, True):
            args = (w, 1, 1, 1000, 300, [0, 0, 1, 1000], widen)
            got, want = rg.kmajor_copy(*args)[0], rg.kmajor_copy_plain(*args)
            bits = torch.int16 if widen else torch.uint8
            if not torch.equal(got.view(bits), want.view(bits)):
                raise AssertionError(f"the K-major copy of {fmt} (widen {widen}) differs from "
                                     "its plain version")
    ws = torch.randn(1, 16, 4, 1000, generator=gen, device=dev)
    y = torch.randn(4, 1000, generator=gen, device=dev)
    z = torch.empty(1, 4, 1000, dtype=FP16, device=dev)
    rg.splitk_combine(ws, z, y, 1, [0, 0, 1000, 1])
    if not torch.equal(z.view(torch.int16), rg.splitk_combine_plain(ws, y, FP16).view(torch.int16)):
        raise AssertionError("the split-K combine differs from its plain version")
    log("gemm schedules: K-major copy and split-K combine bitwise equal to their plain versions")


# -- phase 3c --------------------------------------------------------------------

SIMT_V = 4096  # nodes of the closures' graphs


def _edge_operand(gen, *shape, zero_row=None, zero_col=None):
    """Normal values with planted specials (NaN, +-inf, +-0, magnitudes past
    E4M3's 464, which the reference's E4M3 cast makes NaN) and a row or
    column of zeros of both signs, so that min and max meet zeros to order."""
    t = torch.randn(shape, generator=gen, device="cuda") * 4
    flat = t.view(-1)
    specials = torch.tensor([math.nan, math.inf, -math.inf, 0.0, -0.0, 500.0, -600.0, 1e4,
                             -0.0, 0.0], device="cuda")
    flat[torch.randperm(flat.numel(), generator=gen, device="cuda")[:len(specials)]] = specials

    def zeros(n):
        neg = torch.rand(n, generator=gen, device="cuda") < 0.5
        return torch.where(neg, -torch.zeros(n, device="cuda"), torch.zeros(n, device="cuda"))

    if zero_row is not None:
        t[..., zero_row, :] = zeros(shape[-1])
    if zero_col is not None:
        t[..., :, zero_col] = zeros(shape[-2])
    return t


def _same_nonfinite_close(got, want) -> float:
    """(mul, add) on edge operands: raises unless NaN and +-inf sit at the
    same positions; returns the finite rest's max|dz|/max|z|."""
    g, w = got.float(), want.float()
    for special in (torch.isnan, lambda t: t == math.inf, lambda t: t == -math.inf):
        if not torch.equal(special(g), special(w)):
            raise AssertionError("NaN or inf positions differ")
    fin = torch.isfinite(w)
    return rel_err(g[fin], w[fin])


def _floyd_warshall(d: torch.Tensor, circ, star) -> torch.Tensor:
    """d* by Floyd-Warshall in plain torch on the card: d = star(d, circ(d[:, k], d[k, :]))."""
    d = d.clone()
    for k in range(d.shape[0]):
        d = star(d, circ(d[:, k:k + 1], d[k:k + 1, :]))
    return d


def _closure_graph(gen, op: str):
    """A random directed graph of SIMT_V nodes with about 4 edges a node.
    apsp (fp32): integer weights in [1, 16], 1e6 for a missing edge and 0
    on the diagonal, so every path sum is exact. max_capacity_path (fp16):
    integer capacities in [1, 64], 0 for a missing edge."""
    v = SIMT_V
    w = torch.randint(1, 17 if op == "apsp" else 65, (v, v), generator=gen, device="cuda").float()
    present = torch.rand((v, v), generator=gen, device="cuda") < 4.0 / v
    if op == "apsp":
        d = torch.where(present, w, torch.full_like(w, 1e6))
        d.fill_diagonal_(0.0)
        return d
    return torch.where(present, w, torch.zeros_like(w)).half()


def _simt_path(label, run, readings: dict) -> object:
    """Run ``run`` with the GEMM's counters set to 0 and record, after it,
    the launches of each SIMT form and the auxiliary (combine) launches."""
    from repro_torch.kernels import redmule_gemm as rg

    _reset_launch_counts()
    for c in rg.simt_form_launches.values():
        c.reset()
    out = run()
    torch.cuda.synchronize()
    readings[label] = {"gemm": rg.launches.n, "aux": rg.aux_launches.n,
                       **{f: c.n for f, c in rg.simt_form_launches.items()}}
    return out


def phase_simt() -> dict:
    """Phase 3c: the SIMT schedule's three forms (warp, f32, h2) at their
    edges and on the semiring paths.

    Every Table-1 pair under fp32 and redmule_hfp8 on edge operands (NaN,
    +-inf, +-0, past 464; zeros of both signs in a row of X and a column
    of W; Y with the same), at shapes that take each form: the warp form,
    (lanes over N for an N-contiguous W, over K for a transposed one),
    tiles with K split across a ragged boundary (M, N and K ragged),
    transposed views with K = 1001 (not a 16-byte row: the element loads),
    and a batch stride of 0. The semiring pairs must give the plain
    version's NaN positions and its bits elsewhere; (mul, add) its NaN and
    inf positions and the rest within GEMM_TOL. Then a planted dropped K
    split per tiled form must fail; the MoE router's two shapes give the
    same bits in an eager call and a graph replay; and the semiring paths
    at full size, each read on the counters: ``Engine.closure`` of a
    4096-node graph under fp32 (apsp, the f32 form) and under redmule_fp16
    (max_capacity_path, the h2 form), both against Floyd-Warshall bit for
    bit, and ``Engine.gemm_op`` apsp 64x4096x12800 under redmule_hfp8 (the
    h2 form, K split 4, the min combine) against the plain engine.
    Returns the paths' launch readings for the kernel line."""
    from repro_torch.core import semiring
    from repro_torch.core.precision import cast, get_policy
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.kernels import redmule_gemm as rg

    gen = torch.Generator(device="cuda").manual_seed(17)
    e = functools.partial(_edge_operand, gen)
    seen, n = set(), 0
    for pol_name in ("fp32", "redmule_hfp8"):
        pol = get_policy(pol_name)
        for gop in semiring.TABLE1:
            if gop.is_gemm and pol_name != "fp32":
                continue  # the tensor cores take it (phase 3b)
            cases = {
                "37x1000x70": (e(37, 1000, zero_row=3), e(1000, 70, zero_col=5), None),
                "37x1000x70, W^T": (e(37, 1000, zero_row=3), e(70, 1000, zero_row=5).T, None),
                "100x1000x200 +y, split": (e(100, 1000, zero_row=70), e(1000, 200, zero_col=130),
                                           e(100, 200)),
                "transposed 100x1001x200": (e(1001, 100, zero_col=7).T,
                                            e(200, 1001, zero_row=9).T, None),
                "batch stride 0 (3)x37x300x70": (e(1, 37, 300, zero_row=1),
                                                 e(3, 300, 70, zero_col=2), e(37, 70)),
            }
            for label, (x, w, y) in cases.items():
                name = f"simt {pol_name}/{gop.name}/{label}"
                xq, wq = cast(x, pol.storage_fwd), cast(w, pol.storage_fwd)
                plan = rg.plan_call(xq, wq, None if y is None else y.float(), gop=gop,
                                    policy=pol).plan
                seen.add((plan.form, plan.split > 1))
                got = ops.gemm_op(x, w, y, gop=gop, policy=pol, backend="cuda")
                want = ops.gemm_op(x, w, y, gop=gop, policy=pol, backend="torch")
                torch.cuda.synchronize()
                if gop.is_gemm:
                    try:
                        err = _same_nonfinite_close(got, want)
                    except AssertionError as exc:
                        raise AssertionError(f"{name}: {exc}") from None
                    if not err <= GEMM_TOL[got.dtype]:
                        raise AssertionError(f"{name}: max|dz|/max|z| {err:.3g}")
                elif not same_bits(got, want):
                    raise AssertionError(f"{name} ({plan.form}, split {plan.split}): not the "
                                         "plain version's NaN positions and bits")
                n += 1
    for want in (("warp", False), ("f32", True), ("h2", True), ("f32", False), ("h2", False)):
        if want not in seen:
            raise AssertionError(f"simt edges: no case took form {want[0]} with split "
                                 f"{'> 1' if want[1] else '1'} ({sorted(seen)})")
    log(f"simt: {n} edge cases (NaN, +-inf, +-0, past 464) give the plain version's NaN "
        f"positions and bits (forms and splits taken: {sorted(seen)})")

    # A planted dropped K split per tiled form: the plain version without
    # the second (last) split's K range must differ.
    rand = lambda *sh: torch.randn(sh, generator=gen, device="cuda")  # noqa: E731
    planted = {}
    for pol_name, op in (("redmule_hfp8", "apsp"), ("fp32", "apsp"), ("fp32", "matmul")):
        pol, gop = get_policy(pol_name), semiring.get(op)
        x, w = cast(rand(100, 1000), pol.storage_fwd), cast(rand(1000, 200), pol.storage_fwd)
        plan = rg.plan_call(x, w, None, gop=gop, policy=pol).plan
        if plan.split < 2:
            raise AssertionError(f"planted split {pol_name}/{op}: planned {plan}")
        kw = dict(gop=gop, policy=pol, out_dtype=pol.out)
        got = rg.redmule_gemm(x, w, None, **kw)
        kept = (plan.split - 1) * plan.k_per_split
        want = rg.redmule_gemm_plain(x[:, :kept], w[:kept], None, **kw)
        torch.cuda.synchronize()
        key = f"{plan.form} {pol_name}/{op}"
        planted[key] = rel_err(got, want) if gop.is_gemm else float(
            (got != want).float().mean())
        if (planted[key] <= GEMM_TOL[got.dtype]) if gop.is_gemm else same_bits(got, want):
            raise AssertionError(f"a dropped K split on the {key} form passes the check")
    log("simt: a planted dropped K split fails every tiled form (" + ", ".join(
        f"{k} {v:.3g}" for k, v in planted.items()) + "; error or share of outputs that differ)")

    # The router: an eager call and a graph replay, the same bits.
    fp32 = get_policy("fp32")
    kw = dict(gop=semiring.MATMUL, policy=fp32, out_dtype=torch.float32)
    router_w = rand(1024, 32) * 0.02
    for rows in (4, 64):
        x = rand(rows, 1024)
        eager = rg.redmule_gemm(x, router_w, None, **kw)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            replayed = rg.redmule_gemm(x, router_w, None, **kw)
        g.replay()
        torch.cuda.synchronize()
        plan = rg.plan_call(x, router_w, None, gop=semiring.MATMUL, policy=fp32).plan
        if not torch.equal(eager.view(torch.int32), replayed.view(torch.int32)):
            raise AssertionError(f"router {rows}x1024x32: a graph replay differs from the eager "
                                 "call")
        err = rel_err(eager, rg.redmule_gemm_plain(x, router_w, None, **kw))
        if not err <= GEMM_TOL[torch.float32]:
            raise AssertionError(f"router {rows}x1024x32: {err:.3g} from the plain version")
        log(f"simt: router {rows}x1024x32 ({plan.form} form) gives the same bits eager and "
            f"replayed, {err:.3g} from the plain version")
        del g

    # The semiring paths at full size.
    readings = {}
    for op, pol_name in (("apsp", "fp32"), ("max_capacity_path", "redmule_fp16")):
        gop = semiring.get(op)
        d = _closure_graph(gen, op)
        eng = Engine(policy=pol_name, backend="cuda")
        t0 = time.perf_counter()
        got = _simt_path(f"closure {op}", lambda: eng.closure(d, op), readings)
        ms = (time.perf_counter() - t0) * 1e3
        if op != "apsp":  # the closure's diagonal: the circ identity
            d.fill_diagonal_(semiring.finite_identity(gop.circ, d.dtype))
        want = _floyd_warshall(d, semiring.op_fn(gop.circ), semiring.op_fn(gop.star))
        torch.cuda.synchronize()
        if not same_bits(got, want):
            raise AssertionError(f"closure {op} V={SIMT_V} ({pol_name}) differs from "
                                 "Floyd-Warshall")
        r = readings[f"closure {op}"]
        log(f"simt: Engine.closure {op} V={SIMT_V} under {pol_name}: {r['gemm']} squarings in "
            f"{ms:.1f} ms (host clock), SIMT forms {({f: r[f] for f in rg.SIMT_FORMS})}, equal "
            f"to Floyd-Warshall bit for bit")
    hfp8, apsp = get_policy("redmule_hfp8"), semiring.get("apsp")
    x, w = rand(64, 4096), rand(4096, 12800) * 4096 ** -0.5
    plan = rg.plan_call(cast(x, hfp8.storage_fwd), cast(w, hfp8.storage_fwd), None, gop=apsp,
                        policy=hfp8).plan
    got = _simt_path("gemm_op apsp", lambda: Engine(policy=hfp8, backend="cuda").gemm_op(
        x, w, op="apsp"), readings)
    want = Engine(policy=hfp8, backend="torch").gemm_op(x, w, op="apsp")
    if not same_bits(got, want):
        raise AssertionError("Engine.gemm_op apsp 64x4096x12800 redmule_hfp8 differs from the "
                             "plain engine")
    r = readings["gemm_op apsp"]
    if r["h2"] != 1 or r["aux"] != 1:
        raise AssertionError(f"Engine.gemm_op apsp 64x4096x12800: launches {r}, expected one "
                             "h2 launch and one combine")
    log(f"simt: Engine.gemm_op apsp 64x4096x12800 under redmule_hfp8 ({plan.form} form, split "
        f"{plan.split}, one min combine) equal to the plain engine bit for bit")
    return {"simt_paths": readings}


# -- phase 4 ---------------------------------------------------------------------

# (s, hq, hkv, hd, page_size, pages_per_slot, n_pages, page dtype, window,
#  inactive): the non-slow cases of the JAX package's paged-decode parity grid.
DECODE_GRID = [
    (4, 4, 2, 16, 8, 6, 16, torch.float32, None, ()),
    (4, 4, 2, 16, 8, 6, 16, torch.bfloat16, None, ()),
    (4, 4, 2, 16, 8, 6, 16, torch.float8_e4m3fn, None, ()),
    (4, 4, 2, 16, 8, 6, 16, torch.float32, 20, ()),
    (4, 4, 2, 16, 8, 6, 16, torch.bfloat16, 12, ()),
    (3, 8, 1, 32, 4, 8, 12, torch.float8_e4m3fn, 9, ()),
    (4, 4, 2, 16, 8, 6, 16, torch.float32, None, (1, 3)),
    (6, 6, 3, 8, 4, 5, 24, torch.bfloat16, 10, (0, 4)),
    (1, 8, 8, 32, 16, 4, 8, torch.bfloat16, None, ()),
    (16, 4, 2, 16, 4, 4, 48, torch.float32, None, (5, 11)),
]

# The kernel and its plain version read the same pages dequantized to fp32
# and compute in fp32, so they differ only by the order of their sums and
# the output's one rounding to q's dtype: a few ulps of that dtype, whatever
# the page format (atol and rtol alike). A dropped or repeated token moves
# an output of these cases by about |v| / length, 1e-2 or more.
DECODE_TOL = {torch.float32: 1e-5, torch.float16: 2e-3}


def make_decode_case(rng, *, s, hq, hkv, hd, page_size, pages_per_slot, n_pages,
                     dtype, window=None, inactive=(), q_dtype=torch.float32,
                     seq_lens=None):
    """A random decode step: shuffled physical pages and ragged lengths;
    pages wholly behind the window go back to NULL as the allocator does."""
    q = torch.from_numpy(rng.standard_normal((s, hq, hd)).astype(np.float32)).to(q_dtype)
    pools = [torch.from_numpy(rng.standard_normal((n_pages * page_size, hkv, hd))
                              .astype(np.float32)).to(dtype) for _ in range(2)]
    avail = list(range(1, n_pages))
    rng.shuffle(avail)
    pt = np.zeros((s, pages_per_slot), np.int32)
    lens = np.zeros(s, np.int32)
    active = np.ones(s, np.int32)
    idx = 0
    for si in range(s):
        if seq_lens is None:
            n_pg = int(rng.integers(1, pages_per_slot + 1))
            lens[si] = int(rng.integers(0, n_pg * page_size))
        else:
            lens[si] = seq_lens[si]
            n_pg = lens[si] // page_size + 1
        for p in range(n_pg):
            pt[si, p] = avail[idx % len(avail)]
            idx += 1
        if window is not None:
            for p in range(n_pg):
                if (p + 1) * page_size - 1 <= lens[si] - window:
                    pt[si, p] = 0
    active[list(inactive)] = 0
    to = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return q.cuda(), pools[0].cuda(), pools[1].cuda(), to(pt), to(lens), to(active)


def phase_decode() -> None:
    from repro_torch.kernels import ops

    rng = np.random.default_rng(0)
    cases = [(c, None) for c in DECODE_GRID]
    cases.append(((3, 4, 2, 16, 8, 4, 12, torch.float32, None, ()), 30.0))  # softcap
    cases.append(((4, 32, 8, 128, 16, 7, 29, torch.float8_e4m3fn, None, ()), None))
    # Phase 13's drafter decode: granite-moe's heads (G = 2, hd 64), E4M3
    # pages of 16 in 9-page rows (128 + k tokens a slot).
    cases.append(((4, 16, 8, 64, 16, 9, 37, torch.float8_e4m3fn, None, ()), None))
    worst = {dt: 0.0 for dt in DECODE_TOL}
    for (s, hq, hkv, hd, ps, pps, npg, dt, win, inact), cap in cases:
        q, kp, vp, pt, lens, act = make_decode_case(
            rng, s=s, hq=hq, hkv=hkv, hd=hd, page_size=ps, pages_per_slot=pps,
            n_pages=npg, dtype=dt, window=win, inactive=inact,
            q_dtype=torch.float16 if hd in (64, 128) else torch.float32)
        kw = dict(page_size=ps, window=win, softcap=cap)
        got = ops.paged_decode_attention(q, kp, vp, pt, lens, act, backend="cuda", **kw)
        want = ops.paged_decode_attention(q, kp, vp, pt, lens, act, backend="torch", **kw)
        torch.cuda.synchronize()
        live = act.bool()
        err = float((got[live].float() - want[live].float()).abs().max())
        tol = DECODE_TOL[got.dtype]
        label = f"s{s} h{hq}/{hkv}x{hd} ps{ps} {dt} -> {got.dtype} w{win} cap{cap}"
        if not torch.allclose(got[live].float(), want[live].float(), rtol=tol, atol=tol):
            raise AssertionError(f"paged decode {label}: max|d| {err:.3g} > tol {tol}")
        if (~live).any() and float(got[~live].float().abs().max()) != 0.0:
            raise AssertionError(f"paged decode {label}: inactive slots are not exact zeros")
        worst[got.dtype] = max(worst[got.dtype], err)
    log(f"paged decode: {len(cases)} cases agree (worst max|d|: fp32 out "
        f"{worst[torch.float32]:.3g} within {DECODE_TOL[torch.float32]}, fp16 out "
        f"{worst[torch.float16]:.3g} within {DECODE_TOL[torch.float16]}; inactive slots zero)")
    _decode_split_cases(rng)


def _decode_check(label, case, *, splits, plain, window=None, softcap=None):
    """The paged decode kernel with ``splits`` (None: the planner's) against
    ``plain`` on one case; returns the kernel's output."""
    q, kp, vp, pt, lens, act = case
    s, hq, hd = q.shape
    qg = q.reshape(s, kp.shape[1], hq // kp.shape[1], hd)
    kw = dict(page_size=16, window=window, softcap=softcap)
    from repro_torch.kernels import flash_attention as fa

    got = fa.paged_flash_decode(qg, kp, vp, pt, lens, act, splits=splits, **kw)
    want = plain(qg, kp, vp, pt, lens, act, **kw)
    torch.cuda.synchronize()
    live = act.bool()
    err = float((got[live].float() - want[live].float()).abs().max())
    tol = DECODE_TOL[got.dtype]
    if not torch.allclose(got[live].float(), want[live].float(), rtol=tol, atol=tol):
        raise AssertionError(f"paged decode {label}, splits {splits}: max|d| {err:.3g} > tol {tol}")
    if (~live).any() and float(got[~live].float().abs().max()) != 0.0:
        raise AssertionError(f"paged decode {label}, splits {splits}: inactive slots are not zeros")
    return got, err


def _long_decode_case(seed=3, s=16, tokens=4096):
    """The long-context decode step on the card: ``s`` slots of ``tokens``
    tokens each (page 16, Hq 32 / Hkv 8, hd 128, E4M3 pages, fp16 queries,
    shuffled physical pages; 134 MB of pages at the defaults)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pps = tokens // 16
    n_pages = s * pps + 1
    q = torch.randn((s, 32, 128), generator=gen, device="cuda").half()
    kp, vp = (torch.randn((n_pages * 16, 8, 128), generator=gen, device="cuda")
              .to(torch.float8_e4m3fn) for _ in range(2))
    pt = (torch.randperm(n_pages - 1, generator=gen, device="cuda").int() + 1).reshape(s, pps)
    lens = torch.full((s,), tokens - 1, dtype=torch.int32, device="cuda")
    return q, kp, vp, pt, lens, torch.ones(s, dtype=torch.int32, device="cuda")


def _decode_split_cases(rng) -> None:
    """The split page walk at its edges: page 16, Hq 32 / Hkv 8, hd 128,
    E4M3 pages, fp16 queries, 64-page tables split in four (16 pages, 256
    tokens a split), with the planner's count and one page a split beside."""
    from repro_torch.kernels import flash_attention as fa

    gather = fa.paged_flash_decode_plain

    def case(lens, inactive=()):
        return make_decode_case(rng, s=len(lens), hq=32, hkv=8, hd=128, page_size=16,
                                pages_per_slot=64, n_pages=64 * len(lens) + 1,
                                dtype=torch.float8_e4m3fn, inactive=inactive,
                                q_dtype=torch.float16, seq_lens=lens)

    worst, n = 0.0, 0
    # Lengths ending in the first split, on its last and the next one's first
    # token, and in the last split: slot 0's splits 1-3 are dead by length.
    bounds = case([10, 255, 256, 1023])
    for splits in (None, 4, 64):
        got, err = _decode_check("split boundaries", bounds, splits=splits, plain=gather)
        worst, n = max(worst, err), n + 1
    first, _ = _decode_check("split boundaries", bounds, splits=4, plain=gather)
    second, _ = _decode_check("split boundaries", bounds, splits=4, plain=gather)
    if not torch.equal(first, second):
        raise AssertionError("paged decode: two runs of one split case differ in their bits")
    # A whole split of NULL pages (slot 0's pages 16-31), held against the
    # plain split walk, which drops NULL pages as the kernel does.
    nulls = case([1023, 700])
    nulls[3][0, 16:32] = 0
    walk = functools.partial(fa.paged_flash_decode_split_plain, splits=4)
    for splits in (None, 4):
        _, err = _decode_check("a split of NULL pages", nulls, splits=splits, plain=walk)
        worst, n = max(worst, err), n + 1
    # Whole splits outside the window (slot 0: splits 0 and 1), pages kept.
    for splits in (None, 4):
        _, err = _decode_check("splits outside the window", case([1023, 900]), splits=splits,
                               plain=gather, window=300)
        worst, n = max(worst, err), n + 1
    # An inactive slot with several splits; softcap with splits.
    _, err = _decode_check("an inactive slot", case([1023, 600, 1000, 40], inactive=(2,)),
                           splits=4, plain=gather)
    worst, n = max(worst, err), n + 1
    _, err = _decode_check("softcap", case([1000, 500]), splits=4, plain=gather, softcap=30.0)
    worst, n = max(worst, err), n + 1
    # The long-context shape, with the planner's split count.
    long = _long_decode_case()
    _, err = _decode_check("long context", long, splits=None, plain=gather)
    worst, n = max(worst, err), n + 1
    planned = fa.decode_splits(16, 8, 256)
    log(f"paged decode splits: {n} cases agree (worst max|d| {worst:.3g} within "
        f"{DECODE_TOL[torch.float16]}; a split case twice gives the same bits; the planner "
        f"splits the 64-page tables of 4 and 2 slots {fa.decode_splits(4, 8, 64)} and "
        f"{fa.decode_splits(2, 8, 64)} ways, the long context {planned} ways)")


# -- phase 5 ---------------------------------------------------------------------

# (label, B, Sq, Sk, Hq, Hkv, hd, causal, softcap, formats): granite-3-8b's
# training shape, gemma2-2b's (hd 256, softcap 50) and a ragged
# non-causal case with Sq != Sk.
FLASH_CASES = [
    ("granite", 1, 2048, 2048, 32, 8, 128, True, None,
     (torch.float32, torch.float16, torch.bfloat16)),
    ("gemma2", 1, 1024, 1024, 8, 4, 256, True, 50.0, (torch.float32, torch.bfloat16)),
    ("ragged non-causal", 2, 77, 300, 4, 2, 64, False, None, (torch.float16,)),
    # The tensor-core kernel's edges: Sq not a multiple of its 128-row
    # tiles, non-causal with Sk != Sq at hd 128, hd 64, softcap.
    ("ragged Sq", 1, 300, 300, 32, 8, 128, True, None, (torch.float16, torch.bfloat16)),
    ("non-causal Sk != Sq", 2, 77, 300, 4, 2, 128, False, None, (torch.float16, torch.bfloat16)),
    ("hd 64", 1, 1000, 1000, 8, 8, 64, True, None, (torch.float16, torch.bfloat16)),
    ("softcap", 1, 300, 300, 8, 2, 128, True, 30.0, (torch.float16, torch.bfloat16)),
]

# The kernel and its plain version compute scores, softmax and PV in fp32
# on the same inputs and round p to v's format at the same point, so they
# differ by the order of their sums (and exp/tanh within an ulp or two), the
# output's one rounding, and, rarely, a p that lands on the other side of a
# rounding boundary of v's format. The error is therefore read row by row
# (one query position of one head): max|got - want| over the row's hd
# outputs over max|want| there, so the limit scales with the row's outputs
# (about 0.03 at 2048 keys, where an absolute limit would be loose). In fp16
# and bf16 the limit is two ulps at the row's max (2^-9 and 2^-6); in fp32
# it is 1e-4, for the order of sums over up to 2048 keys. A dropped key
# moves a row by about 1 / sqrt(e * length) of it, 0.01-0.03 at 2048 keys:
# each case also plants one and requires that its error exceed the limit.
FLASH_TOL = {torch.float32: 1e-4, torch.float16: 2.0 ** -9, torch.bfloat16: 2.0 ** -6}


def row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst row's max|got - want| over its max|want| (rows on the last
    axis but one)."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float((d / want.float().abs().amax(-1).clamp(min=1e-30)).max())


def dropped_key_delta(q, k, v, *, causal, softcap, key):
    """How much dropping key ``key`` moves each output: fp32 attention with
    an explicit mask without that key, less the same with it."""
    g = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(g, dim=2).transpose(1, 2) for t in (k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    keep = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        keep = keep.tril()
    out = []
    for m in (keep, keep.index_fill(1, torch.tensor([key], device=s.device), False)):
        out.append(torch.matmul(torch.softmax(s.masked_fill(~m, float("-inf")), -1), vf))
    return (out[1] - out[0]).transpose(1, 2)


def _flash_inputs(gen, b, sq, sk, hq, hkv, hd, dtype):
    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rand(b, sq, hq, hd), rand(b, sk, hkv, hd), rand(b, sk, hkv, hd)


def phase_flash() -> dict:
    """The dense flash-attention kernel against its plain version, then its
    main path: one call of the entry point ``ops.flash_attention`` on CUDA
    tensors at granite's shape (no model path runs the dense kernel, in
    the JAX package or here), read by its own launch counter."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {dt: 0.0 for dt in FLASH_TOL}
    planted = {dt: math.inf for dt in FLASH_TOL}
    routes = {"tc": 0, "simt": 0}
    n = 0
    for label, b, sq, sk, hq, hkv, hd, causal, cap, formats in FLASH_CASES:
        for dt in formats:
            q, k, v = _flash_inputs(gen, b, sq, sk, hq, hkv, hd, dt)
            before = (fa.dense_tc_launches.n, fa.dense_launches.n)
            got = fa.flash_attention(q, k, v, causal=causal, softcap=cap)
            ran = (fa.dense_tc_launches.n - before[0], fa.dense_launches.n - before[1])
            want = fa.flash_attention_plain(q, k, v, causal=causal, softcap=cap)
            torch.cuda.synchronize()
            name = f"flash attention {label} B{b} S{sq}/{sk} H{hq}/{hkv}x{hd} {dt}"
            route = fa.plan_flash(q, k, v)
            if ran != ((1, 0) if route == "tc" else (0, 1)):
                raise AssertionError(f"{name}: planned route {route}, launches (tc, simt) {ran}")
            if label == "granite" and route != ("simt" if dt == torch.float32 else "tc"):
                raise AssertionError(f"{name}: granite's {dt} case is planned on {route}")
            routes[route] += 1
            if got.shape != want.shape or got.dtype != dt:
                raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{dt}")
            err, tol = row_err(got, want), FLASH_TOL[dt]
            if not err <= tol:
                raise AssertionError(f"{name}: worst row max|d|/max|want| {err:.3g} > tol {tol:.3g}")
            delta = dropped_key_delta(q, k, v, causal=causal, softcap=cap, key=sk // 2)
            fault = row_err(got, (want.float() + delta).to(dt))
            if not fault > tol:
                raise AssertionError(f"{name}: a dropped key reads {fault:.3g}, within tol {tol:.3g}")
            worst[dt], planted[dt] = max(worst[dt], err), min(planted[dt], fault)
            n += 1
            del delta
    log(f"flash attention: {n} cases agree, {routes['tc']} on the tensor cores and "
        f"{routes['simt']} on the SIMT kernel as planned (worst row max|d|/max|want|: " + ", ".join(
            f"{str(dt).removeprefix('torch.')} {worst[dt]:.3g} within {FLASH_TOL[dt]:.3g}, "
            f"a dropped key {planted[dt]:.3g}" for dt in FLASH_TOL) + ")")

    q, k, v = _flash_inputs(gen, 1, 2048, 2048, 32, 8, 128, torch.float16)
    fa.dense_launches.reset()
    fa.dense_tc_launches.reset()
    out = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launched = (fa.dense_tc_launches.n, fa.dense_launches.n)
    if launched != (1, 0) or not torch.isfinite(out).all():
        raise AssertionError(f"flash attention entry point: launches (tc, simt) {launched}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    log(f"flash attention entry point: 1 launch on the tensor cores, output "
        f"{tuple(out.shape)} finite")
    return {"dense": launched[0]}


# -- phase 6 ---------------------------------------------------------------------


def _backward_pairs(gen) -> dict:
    """The backward GEMM pairs of the train run under redmule_hfp8
    (d_model 4096, d_ff 12800, 2 x 1024 tokens; the tied unembedding per
    cross-entropy chunk of 2 x 512 rows): E5M2 cotangents beside E4M3
    residuals, transposed operands as views, fp16 outputs."""
    from repro_torch.core.precision import E4M3, E5M2, FP16, cast

    def rand(fmt, *shape, scale=1.0):
        t = torch.randn(shape, generator=gen, device="cuda") * scale
        return cast(cast(t, FP16), fmt)

    w_up = rand(E4M3, 4096, 12800, scale=4096 ** -0.5)
    x = rand(E4M3, 2048, 4096)
    g_up = rand(E5M2, 2048, 12800, scale=1e-2)
    table = rand(E4M3, 49155, 4096, scale=0.02)
    h = rand(E4M3, 1024, 4096)
    g_logits = rand(E5M2, 1024, 49155, scale=1e-3)
    return {
        "dX = g.W^T, E5M2 x E4M3^T 2048x12800x4096": (g_up, w_up.T),
        "dW = X^T.g, E4M3^T x E5M2 4096x2048x12800": (x.T, g_up),
        "dh = g.table, E5M2 x E4M3 1024x49155x4096 (tied unembedding)": (g_logits, table),
        "dtable = h^T.g, E4M3^T x E5M2 4096x1024x49155": (h.T, g_logits),
    }


def phase_backward_gemm() -> None:
    """The GEMM-Op kernel on the training path's backward operand pairs,
    against its plain version, at the train run's shapes."""
    from repro_torch.core import semiring
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels.redmule_gemm import redmule_gemm, redmule_gemm_plain

    pol = get_policy("redmule_hfp8")
    kw = dict(gop=semiring.MATMUL, policy=pol, out_dtype=pol.compute)
    worst = 0.0
    pairs = _backward_pairs(torch.Generator(device="cuda").manual_seed(4))
    for label, (a, b) in pairs.items():
        got = redmule_gemm(a, b, None, **kw)
        want = redmule_gemm_plain(a, b, None, **kw)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        if got.dtype != pol.compute or not torch.isfinite(got).all() or not err <= GEMM_TOL[got.dtype]:
            raise AssertionError(f"backward gemm {label}: max|dz|/max|z| = {err:.3g} "
                                 f"(tol {GEMM_TOL[got.dtype]}, dtype {got.dtype})")
        worst = max(worst, err)
    log(f"backward gemm pairs: {len(pairs)} cases agree (worst max|dz|/max|z| {worst:.3g} "
        f"within {GEMM_TOL[torch.float16]})")
    _check_e5m2_cast()


def _check_e5m2_cast() -> None:
    """The cotangent cast (fp16 -> E5M2) of all 65,536 fp16 bit patterns on
    the card against the same cast on the CPU (which the CPU tests hold
    against ml_dtypes): the same bits, NaN as NaN."""
    from repro_torch.core.precision import E5M2, FP16, cast

    x = torch.from_numpy(np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.int16))
    x = x.view(FP16)
    cpu = cast(x, E5M2)
    card = cast(x.cuda(), E5M2).cpu()
    nan_cpu, nan_card = torch.isnan(cpu.float()), torch.isnan(card.float())
    same = torch.equal(cpu.view(torch.uint8)[~nan_cpu], card.view(torch.uint8)[~nan_cpu])
    if not torch.equal(nan_cpu, nan_card) or not same:
        raise AssertionError("the fp16 -> E5M2 cast differs between the card and the CPU")
    log(f"E5M2 cast: 65536 fp16 patterns agree with the CPU ({int(nan_cpu.sum())} NaN)")


# -- phase 7 ---------------------------------------------------------------------


def _slice_run(model, params, prompts, page_table, forced=None, steps=4, ps=16):
    """One prefill per prompt, then ``steps`` decode steps; decode inputs are
    ``forced`` (the kernels' own choices) when given, so every path runs
    one token sequence and only the numerics differ."""
    pools = model.init_state_store(len(prompts), 17, ps)
    out = []
    for slot, p in enumerate(prompts):
        toks = torch.zeros((1, 64), dtype=torch.int64, device="cuda")
        toks[0, :len(p)] = torch.from_numpy(p)
        out.append(model.prefill_cb(params, toks, pools, page_table[slot], slot, 0, len(p),
                                    page_size=ps))
    seq_lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device="cuda")
    active = torch.ones(len(prompts), dtype=torch.bool, device="cuda")
    tokens = torch.stack([o[0].argmax() for o in out])[:, None]
    chosen = [tokens]
    for i in range(steps):
        if forced is not None:
            tokens = forced[i]
        out.append(model.decode_cb(params, tokens, pools, page_table, seq_lens, active,
                                   page_size=ps))
        tokens = out[-1].argmax(-1, keepdim=True)
        chosen.append(tokens)
        seq_lens = seq_lens + 1
    torch.cuda.synchronize()
    return out, chosen


def _chunk_run(model, params, prompts, page_table, ps=16) -> list:
    """The prompts of :func:`_slice_run` prefilled in chunks of 32: prompt
    0 alone (its second chunk attends over the pages its first wrote), then
    both prompts on fresh pools in (2, 32) steps, the shorter one a pad row
    once it is done. Returns the real rows' logits of every step."""
    out = []
    pools = model.init_state_store(len(prompts), 17, ps)
    first = torch.from_numpy(prompts[0]).to("cuda")[None]
    for c in range(0, first.shape[1], 32):
        n = min(32, first.shape[1] - c)
        out.append(model.prefill_cb(params, first[:, c:c + 32], pools, page_table[0], 0, c, n,
                                    page_size=ps, chunked=True))
    pools = model.init_state_store(len(prompts), 17, ps)
    lay = lambda *v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    for c in range(0, max(map(len, prompts)), 32):
        toks = torch.zeros((len(prompts), 32), dtype=torch.int64, device="cuda")
        lens = [max(0, min(32, len(p) - c)) for p in prompts]
        for i, p in enumerate(prompts):
            toks[i, :lens[i]] = torch.from_numpy(p[c:c + lens[i]])
        active = lay(*lens) > 0
        logits = model.prefill_cb(params, toks, pools, page_table, lay(*range(len(prompts))),
                                  lay(*[c] * len(prompts)), lay(*lens), page_size=ps,
                                  chunked=True, active=active)
        out.append(logits[active])
    torch.cuda.synchronize()
    return out


@contextlib.contextmanager
def _recording_plans(calls: collections.Counter):
    """Count the GEMM-Op calls planned while the context is open by (M, K,
    N after batch folding, schedule, SIMT form)."""
    from repro_torch.kernels import redmule_gemm as rg

    plan_call = rg.plan_call

    def recording(*args, **kw):
        c = plan_call(*args, **kw)
        calls[(c.m, c.k, c.n, c.plan.schedule, c.plan.form)] += 1
        return c

    rg.plan_call = recording
    try:
        yield calls
    finally:
        rg.plan_call = plan_call


# Phase 7's policies and bounds on max|dlogit|/max|logit|, the kernels'
# path against the plain path at 2 layers (phase 14(a) holds the other
# decoders to them). Under redmule_hfp8 with E4M3 weights the two paths
# agree bit for bit: every E4M3 product is exact in fp16, both sides sum
# in fp32 and round once to fp16, and the run is deterministic. Its bound
# is therefore 0: any difference means one side changed its arithmetic,
# and one E4M3 rounding flipped by it reaches the logits.
SLICE_PARITY = (("fp32", "fp32", False, 1e-4), ("redmule_hfp8", "e4m3", True, 0.0))


def _kernels_against_plain(arch, pol, kv, fp8_params, bound, calls, label,
                           gathered=False) -> None:
    """``arch`` at full width, 2 layers, under ``pol``: the kernels' path
    against the plain path on the card, fed the same tokens, over
    whole-prompt prefill and 4 decode steps and over chunked and batched
    prefill, within ``bound``. The plain path runs the paged attention's
    plain version (fp32 over dequantized pages, the kernel's semantics);
    with ``gathered`` the plain gathered decode, which rounds q and the
    probabilities to E4M3 in its engine GEMMs under an fp8 policy, is
    printed beside it (and bound under fp32). ``calls`` records the
    kernels' GEMM calls of the whole-prompt run by (M, K, N, schedule,
    form)."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.models import build
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(get_config(arch), n_layers=2, policy=pol, kv_cache_dtype=kv,
                              fp8_params=fp8_params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (64, 32)]
    page_table = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    page_table[0, :5] = torch.arange(1, 6)
    page_table[1, :3] = torch.arange(6, 9)
    cuda_model = build(cfg, device="cuda")
    params = cuda_model.init(0)
    plain = Engine(policy=pol, backend="torch")
    paths = {"plain": Transformer(cfg, engine=plain, device="cuda", fused_decode=True)}
    if gathered:
        paths["plain, gathered decode"] = Transformer(cfg, engine=plain, device="cuda")
    with _recording_plans(calls):
        got, chosen = _slice_run(cuda_model, params, prompts, page_table)
    forced = chosen[:-1]  # decode step i was fed chosen[i]
    if not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"{label} {pol}: non-finite logits on the kernels' path")
    errs = {}
    for name, model in paths.items():
        want, _ = _slice_run(model, params, prompts, page_table, forced=forced)
        errs[name] = ([rel_err(a, b) for a, b in zip(got[:2], want[:2])],
                      [rel_err(a, b) for a, b in zip(got[2:], want[2:])])
    for name, (pre, dec) in errs.items():
        log(f"{label} {pol} vs {name}: max|dlogit|/max|logit| prefill {max(pre):.3g}, "
            f"decode {max(dec):.3g}")
    worst = max(max(errs["plain"][0]), max(errs["plain"][1]))
    # Chunked and batched prefill: both attention products over
    # [gathered pages | fresh chunk] through the GEMM-Op kernel, and the
    # (2, 32)-row dense layers, against the plain path.
    got_c = _chunk_run(cuda_model, params, prompts, page_table)
    if not all(torch.isfinite(g).all() for g in got_c):
        raise AssertionError(f"{label} {pol}: non-finite chunked-prefill logits")
    chunk_err = max(rel_err(a, b) for a, b in
                    zip(got_c, _chunk_run(paths["plain"], params, prompts, page_table)))
    log(f"{label} {pol} vs plain, chunked and batched prefill (chunk 32): "
        f"max|dlogit|/max|logit| {chunk_err:.3g}")
    worst = max(worst, chunk_err)
    if gathered and pol == "fp32":
        worst = max(worst, max(errs["plain, gathered decode"][1]))
    if not worst <= bound:
        raise AssertionError(f"{label} {pol}: {worst:.3g} > {bound}")
    log(f"{label} {pol}: {worst:.3g} within {bound:g}")
    del cuda_model, paths, params
    torch.cuda.empty_cache()


def phase_slice_parity() -> dict:
    """granite-3-8b at full width, 2 layers, kernels against plain under
    fp32 and redmule_hfp8 (``SLICE_PARITY``), the gathered decode printed
    beside (the JAX package's XLA and Pallas decode paths differ the same
    way; tests/test_torch_model.py holds each of the port's two paths
    against the reference's path of the same semantics). Returns the fp32
    run's SIMT calls of its widest product (the 64-row prefill's 64 x 4096
    x 12800), for the kernel line."""
    fp32_calls = collections.Counter()
    for pol, kv, fp8p, bound in SLICE_PARITY:
        _kernels_against_plain("granite-3-8b", pol, kv, fp8p, bound,
                               fp32_calls if pol == "fp32" else collections.Counter(),
                               "slice parity", gathered=True)
    log("slice parity fp32: the kernels' GEMMs by (M, K, N, schedule, form): "
        + ", ".join(f"{k} x{v}" for k, v in sorted(fp32_calls.items())))
    return {"fp32_wide": fp32_calls[(64, 4096, 12800, "simt", "f32")]}


# -- phase 8 ---------------------------------------------------------------------


# What each serve step reading holds: GEMM-Op calls, paged-decode launches,
# then the GEMM's launches by schedule and its auxiliary launches.
READING = ("gemm", "paged decode", "simt", "tensor-core", "small-row", "aux")
# The serve run's server, beside its prompts' longest length + MAX_NEW.
SERVE_CONFIG = dict(num_slots=4, page_size=16, prefill_bucket=32)
MAX_NEW = 16


def _launch_counts() -> tuple:
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels import redmule_gemm as rg

    return (rg.launches.n, flash_attention.launches.n, rg.simt_launches.n, rg.tc_launches.n,
            rg.small_row_launches.n, rg.aux_launches.n)


def _reset_launch_counts() -> None:
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels import redmule_gemm as rg

    for counter in (rg.launches, flash_attention.launches, rg.simt_launches, rg.tc_launches,
                    rg.small_row_launches, rg.aux_launches):
        counter.reset()


def _count_launches(engine, readings: dict) -> None:
    """Record the kernels' launch counts (``READING``) over each prefill that
    ``engine`` dispatches and each eager run of its decode step: the
    difference of the counters around the call (the wrappers count on the
    host as they launch). With the decode graph the eager runs are the
    warm-up and the capture; a replay launches the captured kernels without
    their wrappers and ticks no counter, so replays are counted apart."""
    def counted(kind, fn):
        def run(*args, **kw):
            before = _launch_counts()
            out = fn(*args, **kw)
            readings[kind].append(tuple(a - b for a, b in zip(_launch_counts(), before)))
            return out
        return run

    engine.dispatch_prefill = counted("prefill", engine.dispatch_prefill)
    engine.decode_step.forward = counted("decode", engine.decode_step.forward)


def _one_reading(kind: str, readings: list, expect: tuple) -> tuple:
    """The launch counts of every ``kind`` reading, all of which must be
    ``expect`` (every entry of ``READING`` but the auxiliary launches)."""
    seen = sorted({r[:-1] for r in readings})
    if seen != [expect]:
        raise AssertionError(f"serve: {READING[:-1]} launches per {kind}: {seen}, "
                             f"expected {expect} every time")
    return expect


def _serve_model():
    """granite-3-8b at full width and depth under redmule_hfp8 with E4M3
    weights and KV pages: phases 8 and 12 share it (about 8 GB)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config("granite-3-8b"), policy="redmule_hfp8",
                              kv_cache_dtype="e4m3", fp8_params=True)
    t0 = time.perf_counter()
    model = build(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    log(f"serve: granite-3-8b {cfg.n_layers} layers d{cfg.d_model}, E4M3 weights made "
        f"in {time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def _serve_prompts(cfg) -> list:
    from repro_torch.launch.serve import mixed_prompt_lens

    rng = np.random.default_rng(0)
    return [list(rng.integers(0, cfg.vocab_size, size=n)) for n in mixed_prompt_lens(64, 8)]


def phase_serve(cfg, model, params) -> dict:
    from repro_torch.kernels import flash_attention, redmule_gemm
    from repro_torch.obs import JsonTracer, write_trace
    from repro_torch.serving import SamplingParams, Server, ServerConfig

    prompts = _serve_prompts(cfg)
    max_new = MAX_NEW
    torch.cuda.reset_peak_memory_stats()
    server = Server(model, params, ServerConfig(
        **SERVE_CONFIG, max_seq_len=max(map(len, prompts)) + max_new), seed=0,
        tracer=JsonTracer())
    for i, p in enumerate(prompts):
        sampling = SamplingParams(temperature=0.8) if i == 5 else SamplingParams()
        server.submit(p, max_new_tokens=max_new, sampling=sampling)
    readings = {"prefill": [], "decode": []}
    eng = server.engine
    _count_launches(eng, readings)
    _reset_launch_counts()
    t0 = time.perf_counter()
    results = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gemm_n, decode_n = redmule_gemm.launches.n, flash_attention.launches.n
    s = server.stats
    if len(results) != len(prompts):
        raise AssertionError(f"serve: {len(results)} of {len(prompts)} requests finished")
    for rid, r in results.items():
        if r.num_generated != max_new or r.finish_reason != "length":
            raise AssertionError(f"serve: request {rid} gave {r.num_generated} tokens ({r.finish_reason})")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"serve: request {rid} sampled a token outside the vocabulary")
    if s.nonfinite_steps:
        raise AssertionError(f"serve: {s.nonfinite_steps} steps had non-finite logits")
    # The decode step is captured once, at the first decode step, after an
    # eager warm-up: two eager runs of it, then one replay a step.
    if (eng.graph_captures, len(readings["decode"])) != (1, 2):
        raise AssertionError(f"serve: {eng.graph_captures} decode-graph captures and "
                             f"{len(readings['decode'])} eager decode runs, expected 1 and 2")
    if eng.graph_replays != s.decode_steps:
        raise AssertionError(f"serve: {eng.graph_replays} graph replays for {s.decode_steps} "
                             "decode steps")
    # Every dense layer is one GEMM launch: 7 a layer (q, k, v, o, gate, up,
    # down) plus the logits; a prefill adds its two attention products a
    # layer, and a decode step its one paged-decode launch a layer. Every
    # decode GEMM has 4 rows (the slots) and runs on the small-row schedule;
    # every prefill GEMM runs on the tensor cores but the logits of the
    # prompt's last token, one row, which takes the small-row schedule.
    n_layers = cfg.n_layers
    if len(readings["prefill"]) != s.prefill_calls:
        raise AssertionError(f"serve: {len(readings['prefill'])} prefills read, "
                             f"{s.prefill_calls} run")
    per_decode = _one_reading("decode step (warm-up and capture)", readings["decode"],
                              (7 * n_layers + 1, n_layers, 0, 0, 7 * n_layers + 1))
    per_prefill = _one_reading("prefill", readings["prefill"],
                               (9 * n_layers + 1, 0, 0, 9 * n_layers, 1))
    totals = tuple(sum(r[i] for v in readings.values() for r in v) for i in range(len(READING)))
    if (gemm_n, decode_n) != totals[:2]:
        raise AssertionError(f"serve: launches gemm {gemm_n}, paged decode {decode_n} over the run "
                             "differ from the sum over its readings")
    aux = {kind: sorted({r[-1] for r in readings[kind]}) for kind in readings}
    mem = torch.cuda.max_memory_allocated()
    log(f"serve: {len(results)} requests, {s.decode_tokens} decode tokens in {s.decode_steps} "
        f"steps, {s.prefill_calls} prefills; decode {s.decode_tok_s:.1f} tok/s, "
        f"prefill {s.prefill_s:.3f} s, decode {s.decode_s:.3f} s (capture included), "
        f"wall {wall:.3f} s, utilization {s.utilization:.0%}, max memory {mem / 1e9:.2f} GB")
    log(f"serve: decode graph captured once, replayed {eng.graph_replays} times "
        f"(= {s.decode_steps} decode steps); launches gemm {gemm_n}, paged decode {decode_n}; "
        f"read at the decode step's warm-up and capture: gemm {per_decode[0]}, paged decode "
        f"{per_decode[1]}; at each of {s.prefill_calls} prefills: gemm {per_prefill[0]}, "
        f"paged decode {per_prefill[1]}")
    log(f"serve: gemm schedules (simt, tensor-core, small-row) at each decode step "
        f"{per_decode[2:]}, at each prefill {per_prefill[2:]}; auxiliary launches per decode "
        f"step {aux['decode']} (split-K combines), per prefill {aux['prefill']} (K-major copies)")
    slots, pages = server.engine.cache.page_table.shape
    g = cfg.n_heads // cfg.n_kv_heads
    splits = flash_attention.decode_splits(slots, cfg.n_kv_heads, pages, groups=-(-g // 4))
    log(f"serve: paged decode page walk split {splits} way(s) ({slots} slots x "
        f"{cfg.n_kv_heads} KV heads, {pages}-page tables)")
    log(f"serve: request 0 tokens {results[0].out_tokens}")
    # Phase 18(b): the traced run's registry against its stats, and its trace.
    registry = _check_registry("obs (b) serve", server, results, s.prefill_calls)
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    write_trace(server.tracer, str(OBS_DIR / "serve_trace.json"))
    checked = _validate_trace(OBS_DIR / "serve_trace.json")
    log(f"obs (b) serve, 40 layers, traced: {registry}; {len(server.tracer.events)} events, "
        f"{checked}; {_host_wait(server.tracer.events)}")
    del server
    torch.cuda.empty_cache()
    return {"gemm": gemm_n, "decode": decode_n, "graph_replays": eng.graph_replays,
            "gemm_per_decode_step": per_decode[0], "gemm_per_prefill": per_prefill[0],
            "decode_per_decode_step": per_decode[1], "decode_per_prefill": per_prefill[1],
            "serve_tc": totals[3], "serve_small_row": totals[4],
            "serve_combines": sum(r[-1] for r in readings["decode"])}


# -- phase 12 --------------------------------------------------------------------


def _record_decode_rows(server, rows: dict) -> None:
    """Keep each decode step's logits row of each active request, keyed by
    (rid, index of the token it samples) (``record_rows`` of the port's
    launcher gate)."""
    from repro_torch.launch.spec_gate import record_rows

    record_rows(server, rows)


def _time_runs(step, spans: list, attr: str = "run") -> None:
    """CUDA events around each run of a GraphStep (a replay of its graph,
    or with ``graph`` False its eager step): its device time; with
    ``attr`` around each call of that method of ``step`` instead."""
    run = getattr(step, attr)

    def timed(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    setattr(step, attr, timed)


def _feature_run(label, model, params, prompts, *, graph=True, drive=None, setup=None,
                 tracer=None, **cfg_kw):
    """One warmed-up greedy run of ``prompts`` (``drive`` submits and runs
    them instead when given) through a Server with the serve run's sizing
    and ``cfg_kw``. The launch counters are zeroed after the warm-up, and
    ``setup`` sees the server then, just before the timed run. Prints
    decode tok/s, prefill s, wall, peak memory and, with the graph, the
    device's busy share of the decode steps (the replays' device time over
    the decode seconds; the eager sampling after each replay is left out,
    so it is a lower bound)."""
    from repro_torch.serving import Server, ServerConfig

    kw = {**SERVE_CONFIG, "max_seq_len": max(map(len, prompts)) + MAX_NEW, **cfg_kw}
    server = Server(model, params, ServerConfig(**kw), seed=0, tracer=tracer)
    server.engine.graph_decode = graph
    rows, spans = {}, []
    _record_decode_rows(server, rows)
    _time_runs(server.engine.decode_step, spans)
    server.warmup(sorted({len(p) for p in prompts}))
    rows.clear()
    spans.clear()
    replays0 = server.engine.graph_replays
    _reset_launch_counts()
    if setup is not None:
        setup(server)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if drive is not None:
        drive(server)
    else:
        for p in prompts:
            server.submit(p, max_new_tokens=MAX_NEW)
        server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = server.stats
    results = dict(server.results)
    if s.nonfinite_steps:
        raise AssertionError(f"{label}: {s.nonfinite_steps} steps had non-finite logits")
    busy = ""
    if graph:
        if server.engine.graph_replays - replays0 != s.decode_steps:
            raise AssertionError(f"{label}: {server.engine.graph_replays - replays0} replays for "
                                 f"{s.decode_steps} decode steps")
        dev_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
        busy = f", decode graph busy {dev_s / s.decode_s:.1%} of the decode steps"
    log(f"{label}: decode {s.decode_tok_s:.1f} tok/s, prefill {s.prefill_s:.3f} s, "
        f"wall {wall:.3f} s, max memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
        f"{s.decode_steps} decode steps, {s.prefill_calls} prefill steps{busy}")
    return server, results, rows


def _tokens(results) -> dict:
    return {rid: r.out_tokens for rid, r in results.items()}


def _same_tokens(label, got: dict, want: dict) -> None:
    if got != want:
        bad = sorted(rid for rid in want if got.get(rid) != want[rid])
        raise AssertionError(f"{label}: tokens differ from the reference run at requests {bad}")


def _same_rows(label, rows, want) -> None:
    if rows.keys() != want.keys():
        raise AssertionError(f"{label}: decode steps sampled other (request, token) pairs")
    bad = [k for k in want if not torch.equal(rows[k], want[k])]
    if bad:
        raise AssertionError(f"{label}: decode logits differ in bits at {len(bad)} of "
                             f"{len(want)} (request, token) rows, first {bad[0]}")


def _graph_against_eager(model, params, prompts) -> None:
    """(a) The decode graph against the eager decode step at depths 0-2."""
    _, eager, eager_rows = _feature_run("features (a) eager, depth 0", model, params, prompts,
                                        graph=False)
    for depth in (0, 1, 2):
        label = f"features (a) graph, depth {depth}"
        _, res, rows = _feature_run(label, model, params, prompts, async_depth=depth)
        _same_tokens(label, _tokens(res), _tokens(eager))
        _same_rows(label, rows, eager_rows)
    log(f"features (a): graph at depths 0-2 gives the eager run's tokens and decode logits bit "
        f"for bit ({len(eager_rows)} rows)")


def _chunked_and_batched(model, params, prompts) -> dict:
    """(b) Chunked prefill (chunk 32), serial and batched: the same tokens
    and decode logits. Every chunk step of the two timed runs, serial or
    (P, 32), must run its dense layers and both attention products on the
    tensor cores and its logits on small rows, read from the launch
    counters around it. Prints the schedule and calls of each GEMM shape of
    each timed run, whose tensor-core calls must add up to the run's
    tensor-core launches. Returns the calls of the kernel line's chunk
    shapes over both timed runs and the tensor-core launches a chunk step."""
    from repro_torch.kernels import redmule_gemm as rg

    n_layers = model.cfg.n_layers
    readings, seen = [], collections.Counter()
    plan_call = rg.plan_call

    def timed_run(label, **kw):
        calls = collections.Counter()

        def recording(x, w, y, **pkw):
            c = plan_call(x, w, y, **pkw)
            p = c.plan
            calls[(tuple(x.shape), tuple(w.shape), p.schedule, p.split, p.copy_x, p.copy_w)] += 1
            return c

        def setup(server):  # after the warm-up, with the counters at 0
            eng = server.engine
            for name in ("dispatch_prefill", "dispatch_prefill_batch"):
                def counted(*args, _fn=getattr(eng, name), **ckw):
                    before = _launch_counts()
                    _fn(*args, **ckw)
                    readings.append(tuple(a - b for a, b in zip(_launch_counts(), before)))
                setattr(eng, name, counted)
            rg.plan_call = recording

        try:
            _, res, rows = _feature_run(label, model, params, prompts, setup=setup,
                                        prefill_chunk=32, **kw)
        finally:
            rg.plan_call = plan_call
        tc_calls = sum(n for key, n in calls.items() if key[2] == "tc")
        if tc_calls != rg.tc_launches.n:
            raise AssertionError(f"{label}: {tc_calls} tensor-core calls planned, "
                                 f"{rg.tc_launches.n} launched")
        for (xs, ws, sched, split, cx, cw), n in sorted(calls.items()):
            log(f"{label}: GEMM x{list(xs)} w{list(ws)}: {sched}, split {split}, copies "
                f"x {cx} w {cw}; {n} calls")
        for key, n in calls.items():
            seen[key[:2]] += n
        return res, rows, len(readings)

    serial, serial_rows, n_serial = timed_run("features (b) chunk 32, serial")
    batched, batched_rows, n_steps = timed_run("features (b) chunk 32, batched",
                                               prefill_batch=True)
    _same_tokens("features (b) batched", _tokens(batched), _tokens(serial))
    _same_rows("features (b) batched", batched_rows, serial_rows)
    per_step = _one_reading("chunk step", readings, (9 * n_layers + 1, 0, 0, 9 * n_layers, 1))
    log(f"features (b): batched prefill gives serial chunked prefill's tokens and decode logits "
        f"bit for bit; each of {n_serial} serial and {n_steps - n_serial} batched chunk steps "
        f"ran gemm {per_step[0]} (tensor cores {per_step[3]}, small rows {per_step[4]})")
    return {"chunk_scores": seen[((1, 8, 128, 128), (1, 8, 128, 144))],
            "chunk_values": seen[((1, 8, 128, 144), (1, 8, 144, 128))],
            "chunk_dense": seen[((4, 32, 4096), (4096, 12800))],
            "tc_per_chunk_step": per_step[3]}


def _prefix_cache(model, params, cfg) -> None:
    """(c) 8 requests behind one 48-token system prompt."""
    rng = np.random.default_rng(3)
    system = list(rng.integers(0, cfg.vocab_size, size=48))
    first = system + list(rng.integers(0, cfg.vocab_size, size=16))  # page-aligned, 4 pages
    others = [system + list(rng.integers(0, cfg.vocab_size, size=n))
              for n in (5, 20, 33, 7, 40, 12)] + [first]

    def drive(server):
        server.submit(first, max_new_tokens=MAX_NEW)
        server.run()
        for p in others:
            server.submit(p, max_new_tokens=MAX_NEW)
        server.run()

    server, res, _ = _feature_run("features (c) prefix cache", model, params, [first, *others],
                                  drive=drive, prefix_cache=True)
    s = server.stats
    if len(res) != 8 or any(r.num_generated != MAX_NEW for r in res.values()):
        raise AssertionError("features (c): not every request finished")
    if s.prefix_hit_tokens < 7 * 48 or s.cow_copies < 1:
        raise AssertionError(f"features (c): {s.prefix_hit_tokens} prefix-hit tokens, "
                             f"{s.cow_copies} copies on write")
    log(f"features (c): prefix hits {s.prefix_hit_tokens} of {s.prefix_prompt_tokens} prompt "
        f"tokens ({s.prefix_hit_rate:.0%}), {s.cow_copies} copy on write; the page-aligned "
        f"repeat gave {'the same' if res[7].out_tokens == res[0].out_tokens else 'other'} tokens "
        "as its first run (E4M3 pages against fresh fp16 keys)")


def _preemption(model, params, cfg) -> None:
    """(d) A low-priority 512-token prompt preempted mid-prefill by a
    high-priority arrival, resumed through the prefix cache."""
    rng = np.random.default_rng(4)
    victim = list(rng.integers(0, cfg.vocab_size, size=512))
    shorts = [list(rng.integers(0, cfg.vocab_size, size=32)) for _ in range(3)]
    urgent = list(rng.integers(0, cfg.vocab_size, size=40))
    state = {}

    def drive(server):
        for p in shorts:
            server.submit(p, max_new_tokens=48)
        state["victim"] = server.submit(victim, max_new_tokens=MAX_NEW)
        for _ in range(3):
            server.step()
        if not state["victim"].prefilling or server.scheduler.num_free_slots:
            raise AssertionError("features (d): the victim is not prefilling with every slot busy")
        server.submit(urgent, max_new_tokens=8, priority=5)
        server.run()

    kw = dict(prefill_chunk=32, prefix_cache=True, preemption=True)
    server, res, _ = _feature_run("features (d) preemption", model, params,
                                  [victim, *shorts, urgent], drive=drive, **kw)
    v = state["victim"]
    if server.stats.preemptions < 1 or v.preemptions < 1 or v.cached_tokens <= 0:
        raise AssertionError(f"features (d): {server.stats.preemptions} preemptions, the victim "
                             f"{v.preemptions}, resumed with {v.cached_tokens} cached tokens")
    server.reset()
    alone = server.submit(victim, max_new_tokens=MAX_NEW)
    server.run()
    if server.results[alone.rid].out_tokens != res[v.rid].out_tokens:
        raise AssertionError("features (d): the resumed victim's tokens differ from its run alone")
    log(f"features (d): {v.preemptions} preemption(s); the victim resumed with "
        f"{v.cached_tokens} cached tokens and gave its tokens alone")


def _fp32_parity() -> None:
    """(e) granite-3-8b at full width with 2 layers under fp32 with fp32
    pages: chunked, batched and prefix-hit prefill against the whole-prompt
    prefill on the kernels' path (last-token logits within phase 7's fp32
    bound of 1e-4), and the greedy tokens of four servers."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2, policy="fp32",
                              kv_cache_dtype="fp32")
    model = build(cfg, device="cuda")
    params = model.init(0)
    dev = model.device
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 96))).to(dev)
    pools = model.init_state_store(4, 22, 16)
    rows = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    rows[0, :6] = torch.arange(1, 7)
    rows[1, :6] = torch.arange(7, 13)
    rows[2, :6] = torch.arange(13, 19)
    rows[3, :6] = torch.tensor([1, 2, 3, 19, 20, 21])  # shares slot 0's first 48 tokens
    want = model.prefill_cb(params, prompt, pools, rows[0], 0, 0, 96, page_size=16)
    got = {}
    for c in range(3):
        chunk = prompt[:, 32 * c:32 * c + 32]
        got["chunked"] = model.prefill_cb(params, chunk, pools, rows[1], 1, 32 * c, 32,
                                          page_size=16, chunked=True)
        pair = torch.cat([chunk, torch.zeros_like(chunk)])
        lay = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
        got["batched"] = model.prefill_cb(
            params, pair, pools, torch.stack([rows[2], rows[0]]), lay(2, 3), lay(32 * c, 0),
            lay(32, 0), page_size=16, chunked=True, active=lay(1, 0).bool())[:1]
    got["prefix hit"] = model.prefill_cb(params, prompt[:, 48:], pools, rows[3], 3, 48, 48,
                                         page_size=16, chunked=True)
    errs = {k: rel_err(v, want) for k, v in got.items()}
    log("features (e) fp32, 2 layers: last-token logits against the whole prompt: "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
    if not max(errs.values()) <= 1e-4:
        raise AssertionError(f"features (e): {errs} beyond 1e-4")
    system = list(rng.integers(0, cfg.vocab_size, size=48))
    prompts = [system + list(rng.integers(0, cfg.vocab_size, size=n)) for n in (40, 17, 48, 3)]
    runs = {"whole prompt": {}, "chunk 32": dict(prefill_chunk=32),
            "chunk 32, batched": dict(prefill_chunk=32, prefill_batch=True),
            "prefix cache": dict(prefix_cache=True)}
    tokens = {}
    for label, kw in runs.items():
        def drive(server):
            server.submit(prompts[0], max_new_tokens=MAX_NEW)
            server.run()
            for p in prompts[1:]:
                server.submit(p, max_new_tokens=MAX_NEW)
            server.run()
        server, res, _ = _feature_run(f"features (e) fp32 {label}", model, params, prompts,
                                      drive=drive, **kw)
        tokens[label] = _tokens(res)
        if label == "prefix cache" and server.stats.prefix_hit_tokens < 3 * 48:
            raise AssertionError("features (e): the prefix cache was not hit")
    for label, t in tokens.items():
        _same_tokens(f"features (e) fp32 {label}", t, tokens["whole prompt"])
    log("features (e): chunked, batched and prefix-hit runs give the whole-prompt run's tokens")
    del model, params, pools
    torch.cuda.empty_cache()


def phase_serving_features(cfg, model, params) -> dict:
    """Phase 12: the rest of serving at full width and depth (phase 8's
    model), then fp32 parity at 2 layers."""
    prompts = _serve_prompts(cfg)
    _graph_against_eager(model, params, prompts)
    counts = _chunked_and_batched(model, params, prompts)
    _prefix_cache(model, params, cfg)
    _preemption(model, params, cfg)
    _fp32_parity()
    return counts


# -- phase 13 --------------------------------------------------------------------

SPEC_K = 4
SPEC_MAX_NEW = 32
SPEC_DRAFTER = "granite-moe-1b-a400m"
# Phase 13(b)'s bounds on max|dlogit|/max|logit|, kernels against the plain
# path: phase 7's, but for the MoE drafter's catch-up under redmule_hfp8.
# Its router is an fp32 GEMM (as in the reference) on fp16 activations and
# fp32 weights, whose products are not exact: the SIMT kernel sums them in
# another order than the plain path's torch.matmul, a router probability
# moves by an ulp, and now and then its fp16 gate rounds the other way. The
# catch-up read 8.67e-4 on the card; its bound is a few times that, and the
# phase logs the router call, row and gate behind the difference. The
# drafter's prefill and decode keep bound 0.
SPEC_PARITY_BOUND = {"fp32": 1e-4, "redmule_hfp8": 0.0}
MOE_CATCH_UP_HFP8_BOUND = 3e-3


def _spec_sampler() -> None:
    """(a) The rejection sampler on the card: the first emitted token over
    N = 4000 rounds follows the filtered target softmax (TV < 0.05) for
    drafter logits and for deterministic drafts; on greedy rows the
    accepted counts and tokens equal the sampler's on the CPU, and the
    last token is the plain sampler's argmax on the CPU, bit for bit."""
    from repro_torch.serving.sampling import filter_logits, sample_logits
    from repro_torch.serving.spec import speculative_sample

    rng = np.random.default_rng(0)
    v, k, n = 8, 2, 4000
    tl = torch.from_numpy((rng.standard_normal((1, k + 1, v)) * 2).astype(np.float32))
    dl = torch.from_numpy((rng.standard_normal((1, k, v)) * 2).astype(np.float32))
    temp, tk, tp = torch.tensor([0.7]), torch.tensor([0]), torch.tensor([0.9])
    expect = torch.softmax(filter_logits(tl[:, 0], temp, tk, tp), -1)[0].numpy()
    dev = "cuda"
    rep = lambda t: t.repeat_interleave(n, 0).to(dev)  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(42)
    tvs = {}
    for mode in ("model q", "onehot q"):
        if mode == "model q":
            q = torch.softmax(filter_logits(dl[0], temp.repeat(k), tk.repeat(k), tp.repeat(k)), -1)
            drafts = torch.multinomial(q.to(dev), n, replacement=True, generator=gen).T
            draft_logits = rep(dl)
        else:
            drafts = torch.randint(0, v, (n, k), generator=gen, device=dev)
            draft_logits = None
        out, _ = speculative_sample(rep(tl), drafts, gen, rep(temp), rep(tk), rep(tp),
                                    torch.full((n,), k + 1, device=dev),
                                    torch.ones(n, dtype=torch.bool, device=dev),
                                    draft_logits=draft_logits)
        emp = np.bincount(out[:, 0].cpu().numpy(), minlength=v) / n
        tvs[mode] = 0.5 * float(np.abs(emp - expect).sum())
        if not tvs[mode] < 0.05:
            raise AssertionError(f"spec (a) {mode}: TV {tvs[mode]:.4f} >= 0.05")
    # Greedy rows at the serve shape: 4 slots, k = 4, the full vocabulary.
    s, v = 6, 49155
    logits = torch.from_numpy(rng.standard_normal((s, SPEC_K + 1, v)).astype(np.float32))
    drafts = logits[:, :SPEC_K].argmax(-1)
    miss = torch.from_numpy(rng.random((s, SPEC_K)) < 0.3)
    drafts = torch.where(miss, torch.from_numpy(rng.integers(0, v, (s, SPEC_K))), drafts)
    lengths = torch.tensor([5, 5, 3, 1, 0, 4])
    active = lengths > 0
    zeros, ones = torch.zeros(s), torch.ones(s)
    args = (zeros, zeros.long(), ones, lengths, active)
    got, acc = speculative_sample(logits.to(dev), drafts.to(dev), gen,
                                  *(a.to(dev) for a in args))
    want, want_acc = speculative_sample(logits, drafts, torch.Generator().manual_seed(0), *args)
    got, acc = got.cpu(), acc.cpu()
    if not torch.equal(acc, want_acc):
        raise AssertionError(f"spec (a): greedy accepted counts {acc} on the card, {want_acc} "
                             "on the CPU")
    plain = [int(sample_logits(logits[r, int(acc[r])][None], torch.Generator(), zeros[:1],
                               zeros[:1].long(), ones[:1])[0]) for r in range(s)]
    for r in range(s):
        if not torch.equal(got[r, :acc[r] + 1], want[r, :acc[r] + 1]) or int(got[r, acc[r]]) != plain[r]:
            raise AssertionError(f"spec (a): greedy row {r} differs from the CPU's decisions")
    log(f"spec (a): rejection sampler on the card, TV {tvs['model q']:.4f} (model q), "
        f"{tvs['onehot q']:.4f} (onehot q) at N = {n}, below 0.05; greedy rows' accepted counts "
        f"{acc.tolist()} and tokens equal to the CPU's and to the plain sampler's argmax")


def _verify_logits(model, params, prompts, width, ps=16):
    """Each prompt but its last ``width`` tokens prefilled into its own
    slot, then one ``verify_cb`` over the held-back tokens of every slot
    (the target's verify step at width 5, the drafter's catch-up at 16).
    Returns the valid rows' logits, one (width, V) block a slot."""
    n = len(prompts)
    pps = max(-(-len(p) // ps) for p in prompts)
    pt = torch.arange(1, n * pps + 1, dtype=torch.int32, device="cuda").reshape(n, pps)
    pools = model.init_state_store(n, n * pps + 1, ps)
    for slot, p in enumerate(prompts):
        head = torch.from_numpy(p[:-width]).to("cuda")[None]
        model.prefill_cb(params, head, pools, pt[slot], slot, 0, head.shape[1], page_size=ps)
    toks = torch.stack([torch.from_numpy(p[-width:]) for p in prompts]).to("cuda")
    lay = lambda v: torch.tensor(v, dtype=torch.int32, device="cuda")  # noqa: E731
    logits = model.verify_cb(params, toks, pools, pt, lay([len(p) - width for p in prompts]),
                             lay([width] * n), torch.ones(n, dtype=torch.bool, device="cuda"),
                             page_size=ps, commit=False)
    torch.cuda.synchronize()
    return list(logits)


def _recording_routers(calls: list):
    """Record each MoE router call's (top-k probabilities, top-k experts)
    in ``calls`` while the context is open."""
    from repro_torch.models import moe

    router = moe._router

    def recording(params, x2, cfg, engine, aux=True):
        out = router(params, x2, cfg, engine, aux)
        calls.append((out[0].float().clone(), out[1].clone()))
        return out

    @contextlib.contextmanager
    def ctx():
        moe._router = recording
        try:
            yield
        finally:
            moe._router = router

    return ctx()


def _gate_witness(got: list, want: list, n_experts: int, n_layers: int,
                  dtype: torch.dtype) -> str:
    """Where the two paths' MoE gates part: the first router call and row
    whose top-k experts or gates in ``dtype`` (the policy's output format,
    in which the gates multiply the experts' outputs) differ, with the
    router probabilities there."""
    name = str(dtype).removeprefix("torch.")
    if len(got) != len(want):
        return f"{len(got)} router calls against {len(want)}"
    dp = 0.0
    for c, ((pa, ia), (pb, ib)) in enumerate(zip(got, want)):
        ga = torch.zeros((pa.shape[0], n_experts), device=pa.device).scatter_(1, ia, pa)
        gb = torch.zeros_like(ga).scatter_(1, ib, pb)
        dp = max(dp, float((ga - gb).abs().max()))
        rows = (ga.to(dtype) != gb.to(dtype)).any(-1).nonzero()
        if len(rows):
            r = int(rows[0])
            flip = (ga[r].to(dtype) != gb[r].to(dtype)).nonzero()[:, 0].tolist()
            same = sorted(ia[r].tolist()) == sorted(ib[r].tolist())
            return (f"router call {c} (layer {c % n_layers}), row {r} of {pa.shape[0]}: "
                    f"{'the same' if same else 'different'} top-{ia.shape[1]} experts, "
                    f"{len(rows)} row(s) with a differing {name} gate; expert(s) {flip}: "
                    f"probability {[float(ga[r, e]) for e in flip]} (kernels) against "
                    f"{[float(gb[r, e]) for e in flip]} (plain), {name} gate "
                    f"{[float(ga[r, e].to(dtype)) for e in flip]} against "
                    f"{[float(gb[r, e].to(dtype)) for e in flip]}; max|dp| over the row "
                    f"{float((ga[r] - gb[r]).abs().max()):.3g}")
    return f"no {name} gate differs; max|dp| over every router call {dp:.3g}"


def _spec_parity() -> None:
    """(b) granite-3-8b's ``verify_cb`` (width 5) and the MoE drafter's
    prefill, catch-up (``verify_cb`` at width 16) and decode at full width
    with 2 layers: the kernels' path against the plain path on the card,
    fed the same tokens, at phase 7's bounds (the drafter's catch-up under
    redmule_hfp8 at ``MOE_CATCH_UP_HFP8_BOUND``, with the router gate
    behind its difference logged)."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.models import build
    from repro_torch.models.transformer import Transformer

    rng = np.random.default_rng(11)
    page_table = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    page_table[0, :5] = torch.arange(1, 6)
    page_table[1, :3] = torch.arange(6, 9)
    worst, bad = {}, {}
    for arch, width in (("granite-3-8b", 5), (SPEC_DRAFTER, 16)):
        prompts = [rng.integers(0, 49155, size=n) for n in (64, 32)]
        for pol, kv, fp8p in (("fp32", "fp32", False), ("redmule_hfp8", "e4m3", True)):
            cfg = dataclasses.replace(get_config(arch), n_layers=2, policy=pol,
                                      kv_cache_dtype=kv, fp8_params=fp8p)
            cuda_model = build(cfg, device="cuda")
            params = cuda_model.init(0)
            plain = Transformer(cfg, engine=Engine(policy=pol, backend="torch"), device="cuda",
                                fused_decode=True)
            routers = ([], [])
            with _recording_routers(routers[0]):
                got = _verify_logits(cuda_model, params, prompts, width)
            with _recording_routers(routers[1]):
                want = _verify_logits(plain, params, prompts, width)
            step = "verify_cb" if arch != SPEC_DRAFTER else "catch-up"
            errs = {step: [rel_err(a, b) for a, b in zip(got, want)]}
            if arch == SPEC_DRAFTER:
                got, chosen = _slice_run(cuda_model, params, prompts, page_table)
                want, _ = _slice_run(plain, params, prompts, page_table, forced=chosen[:-1])
                if not all(torch.isfinite(g).all() for g in got):
                    raise AssertionError(f"spec (b) {arch} {pol}: non-finite logits")
                errs["prefill"] = [rel_err(a, b) for a, b in zip(got[:2], want[:2])]
                errs["decode"] = [rel_err(a, b) for a, b in zip(got[2:], want[2:])]
            label = f"spec (b) {arch} {pol}"
            log(f"{label}: max|dlogit|/max|logit| " + ", ".join(
                f"{k} {max(v):.3g} ({sum(e == 0 for e in v)}/{len(v)} blocks bitwise)"
                for k, v in errs.items()))
            if routers[0]:
                log(f"{label}: routers over the prefills and the catch-up, kernels against "
                    "plain: " + _gate_witness(*routers, cfg.n_experts, cfg.n_layers,
                                              cuda_model.policy.out))
            for name, v in errs.items():
                bound = (MOE_CATCH_UP_HFP8_BOUND if (arch, pol, name) == (
                    SPEC_DRAFTER, "redmule_hfp8", "catch-up") else SPEC_PARITY_BOUND[pol])
                worst[(arch, pol, name)] = (max(v), bound)
                if not max(v) <= bound:
                    bad[(arch, pol, name)] = (max(v), bound)
            del cuda_model, plain, params
            torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"spec (b): beyond the bounds, (error, bound): {bad}")
    log(f"spec (b): verify_cb and the MoE drafter's prefill, catch-up and decode within "
        f"phase 7's bounds (fp32 1e-4, redmule_hfp8 0; the MoE drafter's catch-up under "
        f"redmule_hfp8 {MOE_CATCH_UP_HFP8_BOUND:g}, for its fp32 router): (error, bound) "
        + ", ".join(f"{'/'.join(k)} ({e:.3g}, {b:g})" for k, (e, b) in worst.items()))


def _spec_prompts(vocab: int) -> list:
    """The spec launcher's workload: 8 prompts around 64 tokens, each a
    motif repeated three times, which prompt lookup can draft from."""
    from repro_torch.launch.serve import mixed_prompt_lens

    rng = np.random.default_rng(7)
    prompts = []
    for n in mixed_prompt_lens(64, 8):
        motif = list(rng.integers(0, vocab, size=max(2, n // 3)))
        prompts.append((motif * 3)[:max(n, 6)])
    return prompts


def _drafter(policy="redmule_hfp8", kv="e4m3", fp8_params=True, n_layers=None):
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config(SPEC_DRAFTER)
    cfg = dataclasses.replace(cfg, policy=policy, kv_cache_dtype=kv, fp8_params=fp8_params,
                              n_layers=n_layers or cfg.n_layers)
    model = build(cfg, device="cuda")
    return model, model.init(1)


def _count_forwards(step, label: str, readings: dict) -> None:
    """Record, over each eager run of a GraphStep's forward (its warm-up and
    its capture), the kernels' launch counts (``READING``) and the GEMM
    calls by (x shape, w shape). A replay ticks no counter."""
    from repro_torch.kernels import redmule_gemm as rg

    forward = step.forward

    def counted(d, pools):
        calls, plan_call = collections.Counter(), rg.plan_call

        def recording(x, w, y, **kw):
            calls[(tuple(x.shape), tuple(w.shape))] += 1
            return plan_call(x, w, y, **kw)

        rg.plan_call = recording
        before = _launch_counts()
        try:
            out = forward(d, pools)
        finally:
            rg.plan_call = plan_call
        readings.setdefault(label, []).append(
            (tuple(a - b for a, b in zip(_launch_counts(), before)), calls))
        return out

    step.forward = counted


def _spec_run(label, model, params, prompts, *, spec=None, drafter=None, sampling=None,
              rows=None, readings=None, graph=True, max_new=SPEC_MAX_NEW, setup=None):
    """One warmed-up run of ``prompts`` (``max_new`` tokens each) through a
    Server with the serve run's sizing: plain with the decode graph, or
    speculative. ``rows`` collects each (request, token index)'s logits row
    (the decode steps', or the verify steps' rows that emitted a token);
    ``readings`` the graph steps' eager forwards; ``setup`` sees the server
    before its warm-up. Returns (server, results, info)."""
    from repro_torch.launch.spec_gate import record_rows
    from repro_torch.serving import Server, ServerConfig

    dmodel, dparams = drafter or (None, None)
    server = Server(model, params, ServerConfig(
        **SERVE_CONFIG, max_seq_len=max(map(len, prompts)) + max_new), seed=0, spec=spec,
        draft_model=dmodel, draft_params=dparams)
    steps, spans, rounds = {}, [], []
    step_spans = collections.defaultdict(list)
    if rows is not None:
        record_rows(server, rows)
    if spec is None:
        _time_runs(server.engine.decode_step, spans)
    else:
        steps["verify"] = server.verifier.step
        if server.verifier.commit is not None:
            steps["commit"] = server.verifier.commit
        if dmodel is not None:
            steps |= {"catch-up": server.drafter._catch_up, "draft decode": server.drafter._decode}
        for name, step in steps.items():
            step.graph = graph  # before the first round: nothing is captured yet
            if readings is not None:
                _count_forwards(step, name, readings)
            _time_runs(step, step_spans[name])
        if dmodel is not None and server.drafter._rows:
            for name in ("snapshot", "restore"):
                _time_runs(server.drafter, step_spans[name], name)
        propose = server.drafter.propose

        def timed_propose(*args):
            t0 = time.perf_counter()
            out = propose(*args)
            rounds.append(time.perf_counter() - t0)
            return out

        server.drafter.propose = timed_propose
    if setup is not None:
        setup(server)
    server.warmup(sorted({len(p) for p in prompts}))
    for acc in (spans, rounds, *step_spans.values()):
        acc.clear()
    if rows is not None:
        rows.clear()
    replays0 = {name: step.replays for name, step in steps.items()}
    graph_replays0 = server.engine.graph_replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for p in prompts:
        server.submit(p, max_new_tokens=max_new, **({} if sampling is None else
                                                     {"sampling": sampling}))
    results = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = server.stats
    if s.nonfinite_steps:
        raise AssertionError(f"{label}: {s.nonfinite_steps} steps had non-finite logits")
    if len(results) != len(prompts) or any(r.num_generated != max_new for r in results.values()):
        raise AssertionError(f"{label}: not every request gave {max_new} tokens")
    replays = {name: step.replays - replays0[name] for name, step in steps.items()}
    info = {"tok_s": s.decode_tok_s, "wall": wall, "replays": replays,
            "mem": torch.cuda.max_memory_allocated()}
    line = (f"{label}: decode {s.decode_tok_s:.1f} tok/s, decode {s.decode_s:.3f} s over "
            f"{s.decode_steps} steps, prefill {s.prefill_s:.3f} s, wall {wall:.3f} s, "
            f"max memory {info['mem'] / 1e9:.2f} GB")
    if spec is None:
        if server.engine.graph_replays - graph_replays0 != s.decode_steps:
            raise AssertionError(f"{label}: decode replays differ from decode steps")
        info["replay_ms"] = sum(a.elapsed_time(b) for a, b in spans) / max(len(spans), 1)
        line += f", decode replay {info['replay_ms']:.3f} ms"
    elif graph:
        for name, step in steps.items():
            if step.captures != 1:
                raise AssertionError(f"{label}: the {name} graph was captured {step.captures} "
                                     "times, expected once")
        for name in ("verify", "commit"):
            if replays.get(name, s.spec_steps) != s.spec_steps:
                raise AssertionError(f"{label}: {replays[name]} {name} replays for "
                                     f"{s.spec_steps} speculative rounds")
        if "draft decode" in replays and replays["draft decode"] != (SPEC_K - 1) * s.spec_steps:
            raise AssertionError(f"{label}: {replays['draft decode']} draft decode replays for "
                                 f"{s.spec_steps} rounds of k - 1 = {SPEC_K - 1}")
    elif any(step.captures or step.replays for step in steps.values()):
        raise AssertionError(f"{label}: an eager run captured or replayed a graph")
    if spec is not None:
        step_ms = {name: sum(a.elapsed_time(b) for a, b in sp) / max(len(sp), 1)
                   for name, sp in step_spans.items()}
        info |= {"acceptance": s.acceptance_rate, "accepted_per_round": s.accepted_per_step,
                 "rounds": s.spec_steps, "verify_ms": step_ms["verify"], "step_ms": step_ms,
                 "draft_ms": 1e3 * sum(rounds) / max(len(rounds), 1)}
        what = "replay" if graph else "eager step"
        line += (f"; {s.spec_steps} rounds, acceptance {s.acceptance_rate:.1%} "
                 f"({s.spec_accepted}/{s.spec_drafted}), {s.accepted_per_step:.3f} accepted a "
                 f"round; device ms per {what}: " + ", ".join(
                     f"{k} {v:.3f}" for k, v in step_ms.items())
                 + f"; drafter round {info['draft_ms']:.3f} ms (host clock); replays {replays}")
        _no_leaks(label, server)
    log(line)
    return server, results, info


def _no_leaks(label, server) -> None:
    stores = [server.cache]
    if hasattr(server.drafter, "store"):
        stores.append(server.drafter.store)
    for store in stores:
        if store.allocator.num_held or store.page_table.any() or store.seq_lens.any():
            raise AssertionError(f"{label}: pages or lengths left held after the run")


def _one_forward(label, readings, expect) -> tuple:
    """The launch counts of a graph step's two eager forwards (its warm-up
    and capture), which must both be ``expect`` (``READING`` without the
    auxiliary launches)."""
    seen = sorted({r[:-1] for r, _ in readings})
    if len(readings) != 2 or seen != [expect]:
        raise AssertionError(f"spec (d) {label}: {READING[:-1]} per forward {seen} over "
                             f"{len(readings)} eager forwards, expected {expect} twice")
    return expect


def _plant_off_by_one(server) -> None:
    """A planted fault: draft i + 1 judged by the logits after it,
    ``logits[:, i + 1]`` (the last position's logits repeated)."""
    sample = server.verifier.sample
    server.verifier.sample = lambda logits, dl, gen: sample(
        torch.cat([logits[:, 1:], logits[:, -1:]], dim=1), dl, gen)


def _greedy_accounting(label, spec_res, plain_res, spec_rows, plain_rows, *,
                       planted=False, held=True) -> None:
    """Tokens against the plain run's, with the launcher gate's
    ``greedy_accounting``: at each request's first divergence the plain
    run's margin for its own token over the emitted one must not exceed
    the largest verify/decode change of a top-2 margin at the matched
    positions. A ``planted`` fault must fail it. With ``held`` False the
    accounting is read and logged, not held."""
    from repro_torch.launch.spec_gate import greedy_accounting

    noise, splits, bad = greedy_accounting(_tokens(spec_res), _tokens(plain_res), spec_rows,
                                           plain_rows)
    what = (f"{len(plain_res) - len(splits)} of {len(plain_res)} requests give the plain run's "
            f"tokens; the largest verify/decode change of a top-2 margin at matched positions "
            f"{noise:.4g}; divergences (request, index, the plain run's margin for its token) "
            f"{splits}")
    if not held:
        log(f"{label} (read, not held): {what}; {len(bad)} split(s) above the noise")
        return
    if planted != bool(bad):
        raise AssertionError(f"{label}: " + (
            f"the planted fault passed the accounting: {what}" if planted else
            f"divergences with a margin above the noise {bad}: {what}"))
    log(f"{label}: {what}; " + (f"{len(bad)} unexplained, so the accounting flags the planted "
                                "fault" if planted else "each margin within the noise"))


def _spec_serve(cfg, model, params) -> dict:
    """(d) granite-3-8b at full width and depth (phase 8's model), 8
    requests of repeated motifs, 32 new tokens each: plain with the decode
    graph, then speculative with k = 4 and the n-gram drafter and with
    granite-moe-1b-a400m at full width and depth (E4M3 weights and pages)
    as the drafter, greedy; then the model drafter at temperature 1.0.
    Returns the launches of the speculative graphs' GEMM shapes and paged
    decodes on this path, for the kernel line."""
    from repro_torch.serving import SamplingParams, SpecConfig

    prompts = _spec_prompts(cfg.vocab_size)
    n_layers = cfg.n_layers
    plain_rows, readings = {}, {}
    _, plain, plain_info = _spec_run("spec (d) plain decode graph", model, params, prompts,
                                     rows=plain_rows)
    dmodel, dparams = _drafter()
    dl = dmodel.cfg.n_layers
    log(f"spec (d): drafter {SPEC_DRAFTER}, {dl} layers d{dmodel.cfg.d_model}, "
        f"{dmodel.cfg.n_experts} experts top {dmodel.cfg.top_k}, E4M3 weights and pages")
    infos, forwards = {}, collections.Counter()
    for name, drafter in (("ngram", None), ("model", (dmodel, dparams))):
        rows, rd = {}, {}
        server, res, info = _spec_run(f"spec (d) k={SPEC_K} {name} drafter", model, params,
                                      prompts, spec=SpecConfig(k=SPEC_K), drafter=drafter,
                                      rows=rows, readings=rd)
        infos[name] = info
        _greedy_accounting(f"spec (d) {name} drafter, greedy", res, plain, rows, plain_rows)
        steps = {"verify": server.verifier.step}
        if name == "model":
            # The three graphs against the same steps run eagerly on the card.
            eager_rows = {}
            _, eager, _ = _spec_run("spec (d) model drafter, eager steps", model, params,
                                    prompts, spec=SpecConfig(k=SPEC_K), drafter=drafter,
                                    rows=eager_rows, graph=False)
            _same_tokens("spec (d) eager steps", _tokens(eager), _tokens(res))
            _same_rows("spec (d) eager steps", eager_rows, rows)
            log(f"spec (d): the verify, catch-up and drafter decode graphs give the eager "
                f"steps' tokens and verify logits bit for bit ({len(rows)} rows)")
            steps |= {"catch-up": server.drafter._catch_up, "draft decode": server.drafter._decode}
            # Temperature 1.0 on the same server (its graphs kept).
            server.reset()
            for p in prompts:
                server.submit(p, max_new_tokens=SPEC_MAX_NEW, sampling=SamplingParams(1.0))
            server.run()
            s = server.stats
            if not s.acceptance_rate > 0:
                raise AssertionError("spec (d): the model drafter's temperature-1.0 acceptance "
                                     "rate is 0")
            log(f"spec (d) model drafter, temperature 1.0: acceptance {s.acceptance_rate:.1%} "
                f"({s.spec_accepted}/{s.spec_drafted}), {s.accepted_per_step:.3f} accepted a "
                f"round over {s.spec_steps} rounds, decode {s.decode_tok_s:.1f} tok/s")
        for step, recs in rd.items():
            readings.setdefault(step, []).extend(recs)
            # Every eager forward and every replay (warm-ups included)
            # launches the same kernels.
            total = len(recs) + steps[step].replays
            for key, c in recs[0][1].items():
                forwards[key] += c * total
            forwards[("paged decode", step)] += recs[0][0][1] * total
        _no_leaks(f"spec (d) {name}", server)
        del server
    # The planted off-by-one at full depth: the accounting must flag it.
    rows = {}
    _, res, _ = _spec_run("spec (d) planted off-by-one, ngram drafter", model, params, prompts,
                          spec=SpecConfig(k=SPEC_K), rows=rows, setup=_plant_off_by_one)
    _greedy_accounting("spec (d) planted off-by-one", res, plain, rows, plain_rows, planted=True)
    per = {"verify": _one_forward("verify", readings["verify"][:2],
                                  (9 * n_layers + 1, 0, 0, 9 * n_layers + 1, 0)),
           "catch-up": _one_forward("catch-up", readings["catch-up"],
                                    (10 * dl + 1, 0, dl, 9 * dl + 1, 0)),
           "draft decode": _one_forward("draft decode", readings["draft decode"],
                                        (8 * dl + 1, dl, dl, 0, 7 * dl + 1))}
    if len(readings["verify"]) != 4 or sorted({r[:-1] for r, _ in readings["verify"]}) != [
            per["verify"]]:
        raise AssertionError("spec (d): the two servers' verify forwards differ")
    log(f"spec (d): per verify step gemm {per['verify'][0]} (tensor cores {per['verify'][3]}, "
        f"small rows {per['verify'][4]}, simt {per['verify'][2]}); per drafter decode step "
        f"gemm {per['draft decode'][0]} (small rows {per['draft decode'][4]}, simt "
        f"{per['draft decode'][2]}: the fp32 routers) and {per['draft decode'][1]} paged "
        f"decodes; per catch-up step gemm {per['catch-up'][0]} (tensor cores "
        f"{per['catch-up'][3]}, simt {per['catch-up'][2]})")
    for name in ("ngram", "model"):
        i = infos[name]
        log(f"spec (d) {name} drafter against the plain decode graph: {i['tok_s']:.1f} against "
            f"{plain_info['tok_s']:.1f} decode tok/s ({i['tok_s'] / plain_info['tok_s']:.2f}x), "
            f"wall {i['wall']:.3f} against {plain_info['wall']:.3f} s; acceptance "
            f"{i['acceptance']:.1%}, {i['accepted_per_round']:.3f} accepted a round; verify "
            f"replay {i['verify_ms']:.3f} ms against a decode replay of "
            f"{plain_info['replay_ms']:.3f} ms; drafter round {i['draft_ms']:.3f} ms; max "
            f"memory {i['mem'] / 1e9:.2f} GB")
    del dmodel, dparams
    torch.cuda.empty_cache()
    pages = -(-(max(map(len, prompts)) + SPEC_MAX_NEW) // SERVE_CONFIG["page_size"])
    return {"spec_calls": forwards, "spec_ctx": pages * SERVE_CONFIG["page_size"] + SPEC_K + 1,
            "spec_draft_decode": forwards[("paged decode", "draft decode")],
            "spec_verify_per_step": per["verify"][0],
            "spec_draft_per_step": per["draft decode"][0],
            "spec_draft_paged_per_step": per["draft decode"][1]}


def _spec_fp32_parity() -> None:
    """(e) granite-3-8b at full width with 2 layers under fp32 with fp32
    pages: greedy speculative decoding with the n-gram drafter and with
    the MoE drafter (also 2 layers, fp32) gives the plain decode graph's
    tokens; no pages left in either store. A planted off-by-one (draft
    i + 1 judged by the logits after it, ``logits[:, i + 1]``) must fail
    that check."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serving import SpecConfig

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2, policy="fp32",
                              kv_cache_dtype="fp32")
    model = build(cfg, device="cuda")
    params = model.init(0)
    drafter = _drafter("fp32", "fp32", False, n_layers=2)
    prompts = _spec_prompts(cfg.vocab_size)
    _, plain, _ = _spec_run("spec (e) fp32 plain", model, params, prompts)
    want = _tokens(plain)
    for name, d in (("ngram", None), ("model", drafter)):
        _, res, _ = _spec_run(f"spec (e) fp32 {name} drafter", model, params, prompts,
                              spec=SpecConfig(k=SPEC_K), drafter=d)
        _same_tokens(f"spec (e) fp32 {name} drafter", _tokens(res), want)
    # The planted off-by-one.
    from repro_torch.serving import Server, ServerConfig

    server = Server(model, params, ServerConfig(
        **SERVE_CONFIG, max_seq_len=max(map(len, prompts)) + SPEC_MAX_NEW), seed=0,
        spec=SpecConfig(k=SPEC_K))
    _plant_off_by_one(server)
    for p in prompts:
        server.submit(p, max_new_tokens=SPEC_MAX_NEW)
    try:
        _same_tokens("spec (e) planted off-by-one", _tokens(server.run()), want)
    except AssertionError as e:
        log(f"spec (e): the planted off-by-one fails the parity check ({e})")
    else:
        raise AssertionError("spec (e): the planted off-by-one passed the greedy parity check")
    log("spec (e): fp32 at 2 layers, greedy speculative decoding with both drafters gives the "
        "plain decode graph's tokens; no pages left in either store")
    del model, params, drafter, server
    torch.cuda.empty_cache()


def phase_spec(cfg, model, params) -> dict:
    """Phase 13: speculative decoding, right after phase 12 on its model."""
    _spec_sampler()
    _spec_parity()
    counts = _spec_serve(cfg, model, params)
    _spec_fp32_parity()
    return counts


# -- phase 14 --------------------------------------------------------------------

FAMILIES = ("chatglm3-6b", "deepseek-coder-33b", "gemma2-2b", "phi3.5-moe-42b-a6.6b")
# gemma2's long request: a prompt past its window of 4096, prefilled in
# chunks of 512, so the local layers' window binds in the chunked prefill
# and in the decode kernel.
GEMMA_LONG, GEMMA_CHUNK = 4600, 512
# Its check at 2 layers, kernels against plain: (policy, KV pages, E4M3
# weights, bound on max|dlogit|/max|logit| over the decode steps). fp32
# keeps phase 7's bound. Under redmule_hfp8 the two paths' sums over ~4600
# keys round to fp16 in another order, and an fp16 ulp that crosses an
# E4M3 boundary before the next product reaches the logits, so phase 7's
# bound of 0 does not carry over: the bound lies between the sound
# reading and the planted window fault's (PERF.md, phase 14).
GEMMA_LONG_PARITY = (("fp32", "fp32", False, 1e-4), ("redmule_hfp8", "e4m3", True, 8.5e-3))
# The launcher flags of the families' serve runs (phase 8's workload).
FAMILY_SERVE_ARGS = ["--fp8-kv", "--fp8-params", "--policy", "redmule_hfp8", "--page-size",
                     "16", "--prompt-len", "64", "--requests", "8", "--max-new", str(MAX_NEW),
                     "--num-slots", "4"]


@contextlib.contextmanager
def _recording_decodes(calls: collections.Counter):
    """Count the paged-decode kernel's launches made through the model path
    while the context is open, by (Hq, Hkv, hd, window, softcap)."""
    from repro_torch.kernels import ops

    launch = ops.paged_flash_decode

    def recording(q, *args, window=None, softcap=None, **kw):
        _, hkv, g, hd = q.shape
        calls[(hkv * g, hkv, hd, window, softcap)] += 1
        return launch(q, *args, window=window, softcap=softcap, **kw)

    ops.paged_flash_decode = recording
    try:
        yield calls
    finally:
        ops.paged_flash_decode = launch


def _family_parity(arch: str) -> None:
    """(a) ``arch`` at full width with 2 layers (gemma2's one ``attn_local``
    and one ``attn``): phase 7's run and bounds (``SLICE_PARITY``), with
    the kernels' GEMM calls by (M, K, N, schedule, form)."""
    for pol, kv, fp8p, bound in SLICE_PARITY:
        calls = collections.Counter()
        _kernels_against_plain(arch, pol, kv, fp8p, bound, calls, f"families (a) {arch}")
        log(f"families (a) {arch} {pol}: the kernels' GEMMs by (M, K, N, schedule, form): "
            + ", ".join(f"{k} x{v}" for k, v in sorted(calls.items(), key=str)))


@contextlib.contextmanager
def _reading_servers(readings: dict, calls: collections.Counter,
                     decodes: collections.Counter):
    """Read every Server warmed up while the context is open, from its
    warm-up on: ``_count_launches`` (``READING`` around each prefill and
    each eager run of the decode step), and beside each eager decode step
    the GEMM calls (``calls``, by shape) and paged-decode launches
    (``decodes``, by shape and branch) it added. A launcher builds its
    server and warms it up inside ``main``, so the readers go in there."""
    from repro_torch.serving import Server

    warmup = Server.warmup

    def reading(server, *args, **kw):
        eng = server.engine
        _count_launches(eng, readings)
        forward = eng.decode_step.forward

        def by_shape(*a, **k):
            c0, d0 = collections.Counter(calls), collections.Counter(decodes)
            out = forward(*a, **k)
            readings["decode shapes"].append((calls - c0, decodes - d0))
            return out

        eng.decode_step.forward = by_shape
        return warmup(server, *args, **kw)

    Server.warmup = reading
    try:
        yield readings
    finally:
        Server.warmup = warmup


def _family_serve(arch: str, serve_args=FAMILY_SERVE_ARGS, obs: bool = False) -> tuple:
    """(b) ``arch`` at full width and depth through the serve launcher
    (``FAMILY_SERVE_ARGS``: E4M3 weights and pages, the decode graph), with
    the launch counters zeroed just before it and read at its decode
    step's warm-up and capture (a replay ticks no counter): the GEMM calls
    and paged-decode launches a decode step, by shape. Then the same
    prompts through two servers on the launcher's model, the decode step as
    the graph and eager: the same greedy tokens and every decode step's
    logits bit for bit. Returns the launcher's server (its model and
    parameters live) and the run's counts for the kernel line. With ``obs``
    the launcher also writes its trace, metrics and profile (phase 18(b)),
    which ``_obs_launcher_checks`` reads."""
    from repro_torch.kernels import flash_attention, redmule_gemm
    from repro_torch.launch import serve

    paths = {}
    if obs:
        base = OBS_DIR / arch
        paths = {"trace": base / "trace.json", "metrics": base / "metrics.json",
                 "profile": base / "profile"}
        base.mkdir(parents=True, exist_ok=True)
        serve_args = [*serve_args, "--trace-out", str(paths["trace"]), "--metrics-out",
                      str(paths["metrics"]), "--profile", str(paths["profile"])]

    calls, decodes = collections.Counter(), collections.Counter()
    readings = {"prefill": [], "decode": [], "decode shapes": []}
    torch.cuda.reset_peak_memory_stats()
    with _recording_plans(calls), _recording_decodes(decodes), \
            _reading_servers(readings, calls, decodes):
        _reset_launch_counts()
        t0 = time.perf_counter()
        server, results = serve.main(["--arch", arch, *serve_args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gemm_n, decode_n = redmule_gemm.launches.n, flash_attention.launches.n
    if obs:
        _obs_launcher_checks(arch, server, paths)
    mem = torch.cuda.max_memory_allocated()
    cfg, s, eng = server.model.cfg, server.stats, server.engine
    if len(results) != 8 or any(r.num_generated != MAX_NEW for r in results.values()):
        raise AssertionError(f"families (b) {arch}: {len(results)} requests finished, "
                             f"{[r.num_generated for r in results.values()]} tokens")
    graph_ok = eng.graph_captures == 1 and eng.graph_replays >= s.decode_steps
    if s.nonfinite_steps or not eng.graph_decode or not graph_ok:
        raise AssertionError(f"families (b) {arch}: {s.nonfinite_steps} non-finite steps, "
                             f"{eng.graph_captures} captures, {eng.graph_replays} replays for "
                             f"{s.decode_steps} decode steps")
    if not all(0 <= t < cfg.vocab_size for r in results.values() for t in r.out_tokens):
        raise AssertionError(f"families (b) {arch}: a token outside the vocabulary")
    # The decode step runs eagerly twice (warm-up, capture); both readings
    # must agree, and each attention layer launches the paged decode once a
    # step (a recurrent layer none).
    n_attn = sum(acfg is not None for acfg in server.model.layer_cfgs)
    shapes = readings["decode shapes"]
    if len(shapes) != 2 or shapes[0] != shapes[1] or len(readings["decode"]) != 2:
        raise AssertionError(f"families (b) {arch}: {len(shapes)} eager decode steps read, "
                             f"expected 2 alike: {shapes}")
    step_calls, step_decodes = shapes[0]
    per_step = readings["decode"][0]
    if (sum(step_calls.values()), sum(step_decodes.values())) != per_step[:2] or \
            per_step[1] != n_attn:
        raise AssertionError(f"families (b) {arch}: a decode step's launches {per_step[:2]}, "
                             f"by shape {sum(step_calls.values())} and "
                             f"{sum(step_decodes.values())}, for {n_attn} attention layers")
    if (sum(calls.values()), sum(decodes.values())) != (gemm_n, decode_n):
        raise AssertionError(f"families (b) {arch}: launches gemm {gemm_n}, paged decode "
                             f"{decode_n} differ from the calls recorded by shape "
                             f"{sum(calls.values())}, {sum(decodes.values())}")
    ttft = server.ttft_percentiles()
    step_ms = 1e3 * s.decode_s / s.decode_steps
    log(f"families (b) {arch}{' (profiled and traced)' if obs else ''}: "
        f"{cfg.n_layers} layers d{cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.2f} B parameters in "
        f"{'E4M3' if cfg.fp8_params else server.model.dtype}; KV pools "
        f"{server.cache.kv_bytes() / 1e6:.1f} MB, state rows {server.cache.state_bytes() / 1e6:.1f} "
        f"MB; decode {s.decode_tok_s:.1f} tok/s "
        f"({step_ms:.2f} ms a step, {s.decode_steps} steps), prefill {s.prefill_s:.3f} s, TTFT p50 "
        f"{ttft[0] * 1e3:.1f} ms, peak memory {mem / 1e9:.2f} GB; launcher wall {wall:.1f} s "
        f"(weights, warm-up and capture included); launches gemm {gemm_n}, paged decode "
        f"{decode_n}; read at the decode step's warm-up and capture: gemm {per_step[0]}, paged "
        f"decode {per_step[1]} "
        + str({f"window {w} softcap {c}": n for (*_, w, c), n in step_decodes.items()}))
    prompts = [results[rid].prompt for rid in sorted(results)]
    model, params = server.model, server.params
    _, graph, graph_rows = _feature_run(f"families (b) {arch} graph", model, params, prompts)
    _, eager, eager_rows = _feature_run(f"families (b) {arch} eager", model, params, prompts,
                                        graph=False)
    label = f"families (b) {arch}: the decode graph against eager decode"
    _same_tokens(label, _tokens(graph), _tokens(eager))
    _same_rows(label, graph_rows, eager_rows)
    _same_tokens(f"families (b) {arch}: the launcher's run against the graph run",
                 _tokens(results), _tokens(graph))
    log(f"{label}: the same greedy tokens and decode logits bit for bit ({len(eager_rows)} "
        f"rows; the launcher's run gave the same tokens)")
    return server, {"calls": calls, "decodes": decodes, "step_calls": step_calls,
                    "step_decodes": step_decodes}


@contextlib.contextmanager
def _window_dropped():
    """A planted fault for the long request's check: the paged decode
    called without the local layers' window."""
    from repro_torch.kernels import ops

    launch = ops.paged_flash_decode

    def faulty(q, *args, window=None, **kw):
        return launch(q, *args, window=None, **kw)

    ops.paged_flash_decode = faulty
    try:
        yield
    finally:
        ops.paged_flash_decode = launch


def _gemma_long_parity(cfg, prompt, pol, kv, fp8p, bound) -> collections.Counter:
    """gemma2 at 2 layers (one local, one global) under ``pol``, the long
    request with the decode step eager: the kernels' path against the plain
    path, the same greedy tokens and every decode step's logits within
    ``bound``; the kernels' path with the window dropped from the decode
    (``_window_dropped``) must leave it. Returns the kernels' run's
    paged-decode launches by shape and branch, its warm-up left out."""
    from repro_torch.engine import Engine
    from repro_torch.models import build
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(cfg, n_layers=2, policy=pol, kv_cache_dtype=kv, fp8_params=fp8p)
    short = build(cfg, device="cuda")
    sparams = short.init(0)
    plain = Transformer(cfg, engine=Engine(policy=pol, backend="torch"), device="cuda",
                        fused_decode=True)
    label = f"families (b) gemma2-2b 2 layers {pol}, long request"
    decodes = collections.Counter()
    with _recording_decodes(decodes):
        _, got, got_rows = _feature_run(f"{label}, kernels", short, sparams, [prompt],
                                        graph=False, prefill_chunk=GEMMA_CHUNK,
                                        setup=lambda server: decodes.clear())
    _, want, want_rows = _feature_run(f"{label}, plain", plain, sparams, [prompt],
                                      graph=False, prefill_chunk=GEMMA_CHUNK)
    with _window_dropped():
        _, _, bad_rows = _feature_run(f"{label}, kernels, window dropped", short, sparams,
                                      [prompt], graph=False, prefill_chunk=GEMMA_CHUNK)
    _same_tokens(f"{label}, kernels against plain", _tokens(got), _tokens(want))
    err = max(rel_err(got_rows[k], want_rows[k]) for k in want_rows)
    planted = max(rel_err(bad_rows[k], want_rows[k]) for k in want_rows)
    log(f"{label}: tokens {got[0].out_tokens} equal the plain path's; decode logits "
        f"max|dlogit|/max|logit| {err:.3g} over {len(want_rows)} rows, {planted:.3g} with the "
        f"window dropped from the decode (bound {bound:g}); windowed decode launches "
        f"{decodes[(8, 4, 256, cfg.sliding_window, cfg.attn_softcap)]}")
    if not err <= bound:
        raise AssertionError(f"{label}: {err:.3g} > {bound}")
    if not planted > bound:
        raise AssertionError(f"{label}: the planted window fault ({planted:.3g}) passes the "
                             f"bound {bound}")
    del short, sparams, plain
    torch.cuda.empty_cache()
    return decodes


def _gemma_long(model, params) -> collections.Counter:
    """(b) gemma2's 4600-token request, chunked at 512, at full depth (the
    decode graph); then at 2 layers the kernels' path against the plain
    path (``_gemma_long_parity``) under ``GEMMA_LONG_PARITY``. The local
    layers' window binds in the chunked prefill and in the decode kernel,
    launched eagerly at 2 layers. Returns the redmule_hfp8 run's
    paged-decode launches (E4M3 pages, the serve run's format)."""
    prompt = list(np.random.default_rng(7).integers(0, model.cfg.vocab_size, size=GEMMA_LONG))
    _, res, _ = _feature_run(f"families (b) gemma2-2b {model.cfg.n_layers} layers, a "
                             f"{GEMMA_LONG}-token prompt in chunks of {GEMMA_CHUNK}", model,
                             params, [prompt], prefill_chunk=GEMMA_CHUNK)
    log(f"families (b) gemma2-2b long request tokens {res[0].out_tokens}")
    decodes = {pol: _gemma_long_parity(model.cfg, prompt, pol, kv, fp8p, bound)
               for pol, kv, fp8p, bound in GEMMA_LONG_PARITY}
    return decodes["redmule_hfp8"]


def phase_families() -> dict:
    """Phase 14: the other attention-only decoders (chatglm3-6b,
    deepseek-coder-33b, gemma2-2b, phi3.5-moe), each built, run and freed
    in turn (one large model fits beside nothing else). Returns each serve
    run's counts (``_family_serve``) and the long request's, for the
    kernel line."""
    runs = {}
    for arch in FAMILIES:
        # A server's decode graph and its engine reference each other, so
        # the models of earlier servers go only when the collector runs:
        # collect before each model, so its peak memory is its own.
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _family_parity(arch)
        server, runs[arch] = _family_serve(arch, obs=arch == FAMILIES[0])
        if arch == "gemma2-2b":
            runs["gemma2-2b long"] = _gemma_long(server.model, server.params)
        del server
        log(f"families {arch}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return {"families": runs}


def _train_depth(cfg, spare: float = 10e9) -> int:
    """The most layers of ``cfg`` whose training state fits the card: 24
    bytes a parameter at the optimizer step (fp16 weights, gradients and
    their clipped copy, the fp32 moments twice, the new weights) and
    ``spare`` bytes for activations and the logits chunks."""
    total = torch.cuda.get_device_properties(0).total_memory
    for n in range(cfg.n_layers, 0, -1):
        if dataclasses.replace(cfg, n_layers=n).param_count() * 24 + spare <= total:
            return n
    raise AssertionError(f"{cfg.name}: not one layer's training state fits the card")


def _launcher_train(label: str, arch: str, layers: int | None = None, **depth) -> dict:
    """``arch`` through the train launcher (redmule_hfp8, remat block,
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens, ``TRAIN_STEPS`` steps) at
    ``layers``, or at the depth whose training state fits the card
    (``_train_depth(**depth)``; its full depth if it does): every step
    finite and none skipped. Returns the launcher's history."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    full = get_config(arch)
    n = layers or _train_depth(full, **depth)
    if n < full.n_layers and layers is None:
        log(f"{label} {arch}: {n} of {full.n_layers} layers fit the card's training state")
    gc.collect()
    torch.cuda.empty_cache()
    args = train.parse_args([
        "--arch", arch, "--layers", str(n), "--seq", str(TRAIN_SEQ), "--batch",
        str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS), "--policy", "redmule_hfp8",
        "--remat", "block", "--log-every", "1", "--seed", "0"])
    out = train.train(args)
    hist = out["history"]
    if len(hist) != TRAIN_STEPS or out["state"].skipped != 0:
        raise AssertionError(f"{label} {arch}: {len(hist)} steps, "
                             f"{out['state'].skipped} skipped")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError(f"{label} {arch}: non-finite loss or grad norm: {hist}")
    schedules = sorted({(h["gemm_simt_launches"], h["gemm_tc_launches"],
                         h["gemm_small_row_launches"]) for h in hist})
    log(f"{label} {arch}: {n} layers d{full.d_model}, redmule_hfp8, remat block, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens; ms per step {[round(h['ms'], 1) for h in hist]} "
        f"(steady mean {np.mean([h['ms'] for h in hist[1:]]):.1f}); losses "
        f"{[round(h['loss'], 4) for h in hist]}; skipped 0; max memory "
        f"{out['max_memory_bytes'] / 1e9:.2f} GB; GEMM launches a step by schedule (simt, "
        f"tensor-core, small-row) {schedules}")
    del out
    torch.cuda.empty_cache()
    return hist


def phase_families_train() -> None:
    """(d) chatglm3-6b's train parity at 2 layers (phase 9's bounds; its
    untied head's dW is a 4096 x 2048 x 65024 E4M3^T x E5M2 product), then
    through the train launcher chatglm3-6b at 4 layers, deepseek-coder-33b
    at 2 (its 62 layers' training state is ~0.8 TB) and gemma2-2b at the
    depth that fits (its full 26 if it does)."""
    phase_train_parity("chatglm3-6b")
    for arch, layers in (("chatglm3-6b", 4), ("deepseek-coder-33b", 2), ("gemma2-2b", None)):
        _launcher_train("families (d)", arch, layers)


# -- phase 15 --------------------------------------------------------------------

# The recurrent families: recurrentgemma-2b (RG-LRU with windowed local
# attention, one KV head for 10 query heads) and xlstm-125m (mLSTM and
# sLSTM, no attention), then MoE training.
RECURRENT = ("recurrentgemma-2b", "xlstm-125m")
# (a) at full width, one unit of the block pattern: (policy, KV pages, E4M3
# weights, bound on max|dlogit|/max|logit|), kernels against plain.
# recurrentgemma takes no E4M3 weights (the JAX package's conv refuses
# them; ROADMAP queue 3). fp32 keeps phase 7's bound, and so does
# both models under redmule_hfp8 (0: the same bits). The scans and gates
# are the same torch ops on both paths; xlstm's fp32 state products (the
# reference's einsums, sLSTM's recurrence) take the GEMM-Op kernel's fp32
# SIMT schedule against torch.matmul and sum in another order, but no
# such fp32 ulp moved a 16-bit rounding at these shapes (PERF.md, phase
# 15), so any difference means one side changed its arithmetic.
RECURRENT_LAYERS = {"recurrentgemma-2b": 3, "xlstm-125m": 2}
RECURRENT_PARITY = {
    "recurrentgemma-2b": (("fp32", "fp32", False, 1e-4), ("redmule_hfp8", "e4m3", False, 0.0)),
    "xlstm-125m": (("fp32", "fp32", False, 1e-4), ("redmule_hfp8", "e4m3", True, 0.0)),
}
# (b) the serve launcher with phase 8's flags, E4M3 weights for xlstm only.
RECURRENT_SERVE_ARGS = {
    "recurrentgemma-2b": [a for a in FAMILY_SERVE_ARGS if a != "--fp8-params"],
    "xlstm-125m": FAMILY_SERVE_ARGS,
}
# (c) recurrentgemma's long request: past its window of 2048, in chunks.
RG_LONG, RG_CHUNK, RG_LONG_NEW = 3000, 512, 64
# (d) granite-moe's train parity at 2 layers, the aux loss in the loss:
# fp32 keeps phase 9's bounds. Under redmule_hfp8 the router's fp32 GEMM
# (SIMT kernel against torch.matmul) moves a probability by an ulp, now
# and then an fp16 gate, and through E4M3 activations and E5M2 cotangents
# (two mantissa bits) single tensors' gradients move by up to their own
# size: on the CPU at this width a 1e-7 relative change of the router
# weights moved them by up to 0.57 and the loss by 2.7e-5 (PERF.md, phase
# 15). So under redmule_hfp8 the loss and the global grad norm are held
# (read 5.5e-6 and 7.6e-4 on the card) and the per-tensor error is read,
# not held (None).
MOE_TRAIN_PARITY_BOUND = {"fp32": (1e-5, 1e-4, 1e-3), "redmule_hfp8": (1e-4, 5e-3, None)}


@contextlib.contextmanager
def _no_reset(model):
    """A planted fault in ``model``'s recurrent layers: a prefill from
    position 0 continues from the slot's stored rows instead of the init
    state."""
    recurrent = model._recurrent

    def faulty(cell, p, h, engine, store, paged, decode):
        if paged is not None and not decode:
            paged = paged._replace(starts=paged.starts + 1)
        return recurrent(cell, p, h, engine, store, paged, decode)

    model._recurrent = faulty
    try:
        yield
    finally:
        del model._recurrent


def _recycle_run(model, params, prompts, page_table, ps=16) -> list:
    """Slot 0 serves prompt 0 (a whole-prompt prefill and 2 decode steps),
    then is recycled for the first 4 tokens of prompt 1 from position 0
    (few enough that a stale state would not have decayed: the random
    models forget about half of it a token): the second request's logits
    (its prefill and 2 decode steps, fed fixed tokens)."""
    prompts = [prompts[0], prompts[1][:4]]
    pools = model.init_state_store(1, 17, ps)
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    for p in prompts:
        toks = torch.zeros((1, 64), dtype=torch.int64, device="cuda")
        toks[0, :len(p)] = torch.from_numpy(p)
        out = [model.prefill_cb(params, toks, pools, page_table[0], 0, 0, len(p), page_size=ps)]
        seq = torch.tensor([len(p)], dtype=torch.int32, device="cuda")
        for t in (7, 11):
            tok = torch.full((1, 1), t, dtype=torch.int64, device="cuda")
            out.append(model.decode_cb(params, tok, pools, page_table[:1], seq, active,
                                       page_size=ps))
            seq = seq + 1
    torch.cuda.synchronize()
    return out


def _recurrent_parity(arch: str) -> list:
    """(a) ``arch`` at full width, one unit of its pattern, kernels against
    plain (the paged attention's plain version) under
    ``RECURRENT_PARITY``: phase 7's whole-prompt prefill and 4 decode
    steps, its chunked and batched prefill (state rows carried between
    chunks, a pad row's rows untouched) and a recycled slot. A planted
    fault, the recycled slot's rows not reset at position 0, must leave
    each bound. Returns the failed checks (every policy runs first)."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.models import build
    from repro_torch.models.transformer import Transformer

    rng = np.random.default_rng(1)
    base = dataclasses.replace(get_config(arch), n_layers=RECURRENT_LAYERS[arch])
    prompts = [rng.integers(0, base.vocab_size, size=n) for n in (64, 32)]
    page_table = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    page_table[0, :5] = torch.arange(1, 6)
    page_table[1, :3] = torch.arange(6, 9)
    failed = []
    for pol, kv, fp8p, bound in RECURRENT_PARITY[arch]:
        label = f"recurrent (a) {arch} {base.n_layers} layers {pol}"
        cfg = dataclasses.replace(base, policy=pol, kv_cache_dtype=kv, fp8_params=fp8p)
        model = build(cfg, device="cuda")
        params = model.init(0)
        plain = Transformer(cfg, engine=Engine(policy=pol, backend="torch"), device="cuda",
                            fused_decode=True)
        calls = collections.Counter()
        with _recording_plans(calls):
            got, chosen = _slice_run(model, params, prompts, page_table)
        want, _ = _slice_run(plain, params, prompts, page_table, forced=chosen[:-1])
        got_c = _chunk_run(model, params, prompts, page_table)
        want_c = _chunk_run(plain, params, prompts, page_table)
        got_r = _recycle_run(model, params, prompts, page_table)
        want_r = _recycle_run(plain, params, prompts, page_table)
        if not all(torch.isfinite(g).all() for g in got + got_c + got_r):
            raise AssertionError(f"{label}: non-finite logits on the kernels' path")
        errs = {name: max(rel_err(a, b) for a, b in zip(g, w)) for name, g, w in (
            ("whole prefill and decode", got, want), ("chunked and batched prefill", got_c, want_c),
            ("recycled slot", got_r, want_r))}
        with _no_reset(model):
            bad = _recycle_run(model, params, prompts, page_table)
        planted = max(rel_err(a, b) for a, b in zip(bad, want_r))
        log(f"{label}: kernels against plain, max|dlogit|/max|logit| "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; a recycled row not reset {planted:.3g} (bound {bound:g}); the kernels' GEMMs "
            "by (M, K, N, schedule, form): "
            + ", ".join(f"{k} x{v}" for k, v in sorted(calls.items(), key=str)))
        if not max(errs.values()) <= bound < planted:
            failed.append(f"{label}: {max(errs.values()):.3g} and the planted fault "
                          f"{planted:.3g} against the bound {bound}")
        del model, params, plain
        torch.cuda.empty_cache()
    return failed


def _rg_long(model, params) -> collections.Counter:
    """(c) recurrentgemma's 3000-token request in chunks of 512, 64 new
    tokens, at full depth (the decode graph): the pages it holds never
    exceed its windowed reservation (window + chunk + 2 pages) and stay
    below the request's full span, so out-of-window pages went back to the
    pool mid-request. Then at 3 layers under fp32 the kernels' path
    against the plain path, decode eager: the same tokens and decode logits
    within phase 7's bound, which the decode called without the window
    must leave. Returns the 3-layer kernels' run's paged-decode launches."""
    from repro_torch.engine import Engine
    from repro_torch.models import build
    from repro_torch.models.transformer import Transformer

    cfg = model.cfg
    prompt = list(np.random.default_rng(7).integers(0, cfg.vocab_size, size=RG_LONG))
    total = RG_LONG + RG_LONG_NEW
    held = []

    def drive(server):
        server.submit(prompt, max_new_tokens=RG_LONG_NEW)
        while server.scheduler.has_work():
            server.step()
            held.append(server.cache.allocator.num_held)
        server.run()

    label = f"recurrent (c) recurrentgemma-2b {cfg.n_layers} layers"
    server, res, _ = _feature_run(f"{label}, a {RG_LONG}-token prompt in chunks of {RG_CHUNK}",
                                  model, params, [prompt], drive=drive, prefill_chunk=RG_CHUNK,
                                  max_seq_len=total)
    cap, span = server.scheduler.worst_pages(total), server.cache.allocator.pages_for(total)
    (out,) = res.values()
    log(f"{label}: {out.num_generated} tokens {out.out_tokens[:8]}...; pages held at most "
        f"{max(held)} (reservation {cap} = window {cfg.sliding_window} + chunk {RG_CHUNK} + 2 "
        f"pages of 16; the request spans {span})")
    if out.num_generated != RG_LONG_NEW or not max(held) <= cap < span:
        raise AssertionError(f"{label}: {out.num_generated} tokens, {max(held)} pages held "
                             f"against a reservation of {cap} and a span of {span}")
    short_cfg = dataclasses.replace(cfg, n_layers=3, policy="fp32", kv_cache_dtype="fp32",
                                    fp8_params=False)
    short = build(short_cfg, device="cuda")
    sparams = short.init(0)
    plain = Transformer(short_cfg, engine=Engine(policy="fp32", backend="torch"),
                        device="cuda", fused_decode=True)
    label = "recurrent (c) recurrentgemma-2b 3 layers fp32, long request"
    decodes = collections.Counter()
    with _recording_decodes(decodes):
        _, got, got_rows = _feature_run(f"{label}, kernels", short, sparams, [prompt],
                                        graph=False, prefill_chunk=RG_CHUNK,
                                        setup=lambda server: decodes.clear())
    _, want, want_rows = _feature_run(f"{label}, plain", plain, sparams, [prompt], graph=False,
                                      prefill_chunk=RG_CHUNK)
    with _window_dropped():
        _, _, bad_rows = _feature_run(f"{label}, kernels, window dropped", short, sparams,
                                      [prompt], graph=False, prefill_chunk=RG_CHUNK)
    bound = RECURRENT_PARITY["recurrentgemma-2b"][0][-1]
    _same_tokens(f"{label}, kernels against plain", _tokens(got), _tokens(want))
    err = max(rel_err(got_rows[k], want_rows[k]) for k in want_rows)
    planted = max(rel_err(bad_rows[k], want_rows[k]) for k in want_rows)
    log(f"{label}: tokens equal the plain path's; decode logits max|dlogit|/max|logit| "
        f"{err:.3g} over {len(want_rows)} rows, {planted:.3g} with the window dropped from the "
        f"decode (bound {bound:g}); windowed decode launches {sum(decodes.values())}")
    if not err <= bound < planted:
        raise AssertionError(f"{label}: {err:.3g} and planted {planted:.3g} against {bound}")
    del short, sparams, plain
    torch.cuda.empty_cache()
    return decodes


def phase_recurrent() -> dict:
    """Phase 15 (a)-(c): each recurrent model's parity at one unit
    (``_recurrent_parity``), then its serve run at full depth through the
    launcher (``_family_serve``: the decode graph captures the state rows'
    in-place commits; xlstm launches no paged decode and holds no KV
    bytes), and recurrentgemma's long request (``_rg_long``). Returns the
    serve runs' counts for the kernel line."""
    runs, failed = {}, []
    for arch in RECURRENT:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        failed += _recurrent_parity(arch)
        server, runs[arch] = _family_serve(arch, RECURRENT_SERVE_ARGS[arch])
        if not server.cache.state_bytes() or server.prefix_cache:
            raise AssertionError(f"recurrent (b) {arch}: no state rows, or a prefix cache")
        if arch == "xlstm-125m" and (server.cache.kv_bytes() or sum(runs[arch]["decodes"].values())
                                     or server.scheduler.worst_pages(256)):
            raise AssertionError("recurrent (b) xlstm-125m: KV bytes, pages or paged decodes")
        if arch == "recurrentgemma-2b":
            runs["recurrentgemma-2b long"] = _rg_long(server.model, server.params)
        del server
        log(f"recurrent {arch}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("recurrent (a): " + "; ".join(failed))
    return {"recurrent": runs}


def phase_recurrent_train() -> dict:
    """Phase 15 (d): granite-moe's train parity at 2 layers (the aux loss
    in the loss, ``MOE_TRAIN_PARITY_BOUND``), then through the train
    launcher xlstm-125m at 4 layers, granite-moe-1b-a400m at full depth and
    recurrentgemma-2b and phi3.5-moe at the depth that fits. Returns
    granite-moe's GEMM calls by shape (the router's backward pair), for the
    kernel line."""
    from repro_torch.configs import get_config

    phase_train_parity("granite-moe-1b-a400m", MOE_TRAIN_PARITY_BOUND)
    moe_calls = collections.Counter()
    rg = get_config("recurrentgemma-2b")
    # recurrentgemma's tied 256000 x 2560 table: the update's fp32
    # temporaries of it (2.6 GB each) fragment the pool, and at 26 layers
    # the fourth step ran out of memory on an H100 with 5.1 GB reserved
    # but free (PERF.md, phase 15): four such copies more are kept spare.
    # xlstm at 4 of its 12 layers: its host-bound sLSTM step took ~20 s at
    # 12 (PERF.md, PR 19), cut to keep the script near half its time limit.
    for arch, layers, depth in (("xlstm-125m", 4, {}),
                                ("recurrentgemma-2b", None,
                                 {"spare": 10e9 + 16 * rg.vocab_size * rg.d_model}),
                                ("granite-moe-1b-a400m", 24, {}),
                                ("phi3.5-moe-42b-a6.6b", None, {})):
        calls = moe_calls if arch == "granite-moe-1b-a400m" else collections.Counter()
        with _recording_plans(calls):
            hist = _launcher_train("recurrent (d)", arch, layers, **depth)
        if arch in RECURRENT:
            n = layers or _train_depth(get_config(arch), **depth)
            _scan_share(arch, float(np.mean([h["ms"] for h in hist[1:]])), n)
    return {"moe_train_calls": moe_calls}


def _scan_share(arch: str, step_ms: float, n_layers: int) -> None:
    """The share of a train step that the sequential scans take, the
    fused-kernel candidates of ROADMAP queue 2: sLSTM's whole cell (1024
    steps of host-launched kernels) or RG-LRU's associative scan alone, at
    the train batch (2 x 1024) under redmule_hfp8, its forward and its
    forward with backward timed apart on the host clock to a synchronise,
    summed over the kind's layers of the ``n_layers`` trained as remat
    block runs them (the forward twice, the backward once)."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.models import rglru, xlstm

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(15)
    eng = Engine(policy="redmule_hfp8", backend="cuda")
    b, s = TRAIN_BATCH, TRAIN_SEQ
    if arch == "xlstm-125m":
        kind, ccfg = "slstm", xlstm.XLSTMConfig(cfg.d_model, cfg.n_heads)
        p = xlstm.slstm_init(gen, ccfg, torch.float16, "cuda")
        x = torch.randn((b, s, cfg.d_model), generator=gen, device="cuda").half()

        def run(x):
            return xlstm.slstm_apply(p, x, ccfg, eng)[0]
    else:
        kind = "rglru"
        a = torch.rand((b, s, cfg.d_rnn), generator=gen, device="cuda")
        x = torch.randn((b, s, cfg.d_rnn), generator=gen, device="cuda")

        def run(x):
            return rglru.associative_scan(a, x)
    n = sum(k == kind for k in (cfg.block_pattern[i % len(cfg.block_pattern)]
                                for i in range(n_layers)))

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        fwd = timed(lambda: run(x))
    xg = x.detach().requires_grad_()
    both = timed(lambda: run(xg).float().sum().backward())
    share = n * (fwd + both) / step_ms
    log(f"recurrent (d) {arch}: the {kind} scan at {b}x{s}, forward {fwd:.1f} ms, forward and "
        f"backward {both:.1f} ms; x {n} layers under remat block {n * (fwd + both):.0f} ms of a "
        f"{step_ms:.0f} ms step ({share:.0%})")


# -- phase 16 --------------------------------------------------------------------

# Speculative decoding over recurrent state rows: recurrentgemma-2b and
# xlstm-125m as targets (n-gram drafting; the verifier's commit pass scans
# the accepted tokens into their rows), xlstm-125m as a drafter on the
# target's own parameters and on seed 1's (its rows snapshot and restored
# around the draft steps). (b)'s launcher flags: phase 15(b)'s and k = 4.
SPEC_STATE_ARGS = {arch: [*RECURRENT_SERVE_ARGS[arch], "--spec-k", str(SPEC_K)]
                   for arch in RECURRENT}
SPEC_STATE_DRAFTER = "xlstm-125m"


def _state_drafters(model, params, seed: int = 1) -> list:
    """(name, drafter) pairs of an xlstm target: the n-gram drafter, then
    the target itself, then a model of its config on ``seed``'s
    parameters."""
    from repro_torch.models import build

    other = build(model.cfg, device="cuda")
    return [("ngram", None), ("xlstm drafter, the target's parameters", (model, params)),
            (f"xlstm drafter, seed {seed}", (other, other.init(seed)))]


def _spec_state_parity() -> None:
    """(a) each recurrent target at full width and one unit of its pattern
    (recurrentgemma 3 layers: two RG-LRU and its local attention; xlstm 2)
    under fp32 with fp32 pages, the graphs on: greedy speculative tokens
    equal to the plain decode graph's, token for token, with the n-gram
    drafter and (xlstm) both xlstm drafters; the drafter on the target's
    own parameters accepts nearly every draft."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serving import SpecConfig

    for arch in RECURRENT:
        cfg = dataclasses.replace(get_config(arch), n_layers=RECURRENT_LAYERS[arch],
                                  policy="fp32", kv_cache_dtype="fp32")
        model = build(cfg, device="cuda")
        params = model.init(0)
        prompts = _spec_prompts(cfg.vocab_size)
        label = f"spec-state (a) {arch} {cfg.n_layers} layers fp32"
        _, plain, _ = _spec_run(f"{label} plain", model, params, prompts)
        drafters = _state_drafters(model, params) if arch == SPEC_STATE_DRAFTER else [
            ("ngram", None)]
        for name, drafter in drafters:
            _, res, info = _spec_run(f"{label} {name}", model, params, prompts,
                                     spec=SpecConfig(k=SPEC_K), drafter=drafter)
            _same_tokens(f"{label} {name}", _tokens(res), _tokens(plain))
            if "target's" in name and not info["acceptance"] >= 0.9:
                raise AssertionError(f"{label} {name}: acceptance {info['acceptance']:.1%}")
        log(f"{label}: greedy speculative tokens equal the plain decode graph's with "
            + ", ".join(n for n, _ in drafters))
        del model, params, drafters
        gc.collect()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _reading_spec_servers(found: list, readings: dict, rows: dict):
    """Hook every Server warmed up while the context is open (a launcher
    builds its server inside ``main``): CUDA events around each graph
    step's run (verify, commit, drafter catch-up and decode) and the
    drafter's snapshot and restore, each step's eager forwards read on the
    counters (``_count_forwards``), the verify rows kept (``record_rows``),
    and the pages held after each step. What the warm-up ran is dropped;
    ``found`` receives (server, spans, held, steps, each step's replays
    after the warm-up)."""
    from repro_torch.launch.spec_gate import record_rows
    from repro_torch.serving import Server

    warmup = Server.warmup

    def reading(server, *args, **kw):
        spans, held = collections.defaultdict(list), []
        steps = {"verify": server.verifier.step}
        if server.verifier.commit is not None:
            steps["commit"] = server.verifier.commit
        if hasattr(server.drafter, "store"):
            steps |= {"catch-up": server.drafter._catch_up, "draft decode": server.drafter._decode}
            if server.drafter._rows:
                for name in ("snapshot", "restore"):
                    _time_runs(server.drafter, spans[name], name)
        for name, step in steps.items():
            _count_forwards(step, name, readings)
            _time_runs(step, spans[name])
        record_rows(server, rows)
        step = server.step

        def stepped():
            out = step()
            held.append(server.cache.allocator.num_held)
            return out

        server.step = stepped
        out = warmup(server, *args, **kw)
        rows.clear()
        held.clear()
        for sp in spans.values():
            sp.clear()
        found.append((server, spans, held, steps, {n: st.replays for n, st in steps.items()}))
        return out

    Server.warmup = reading
    try:
        yield found
    finally:
        Server.warmup = warmup


def _launcher_spec(arch: str, extra: list, calls: collections.Counter) -> dict:
    """``arch`` at full depth through the serve launcher with
    ``SPEC_STATE_ARGS`` and ``extra``, the launch counters zeroed just
    before it and read just after, then the launcher's prompts through a
    plain server with the decode graph on its model: decode tok/s against
    the plain graph, acceptance, each step's replay ms and the snapshot's
    clone and restore ms (CUDA events), pages held, and the greedy tokens
    against the plain run's within the launcher gate's accounting (the
    verify step and plain decode compute differently under redmule_hfp8).
    Returns the run's readings."""
    from repro_torch.kernels import flash_attention, redmule_gemm
    from repro_torch.launch import serve

    found, readings, rows = [], {}, {}
    label = f"spec-state (b) {arch} " + (" ".join(extra) or "ngram")
    with _recording_plans(calls), _reading_spec_servers(found, readings, rows):
        _reset_launch_counts()
        t0 = time.perf_counter()
        server, results = serve.main(["--arch", arch, *SPEC_STATE_ARGS[arch], *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gemm_n, decode_n = redmule_gemm.launches.n, flash_attention.launches.n
    (srv, spans, held, steps, base), = found
    s = srv.stats
    if len(results) != 8 or any(r.num_generated != MAX_NEW for r in results.values()) or \
            s.nonfinite_steps or not s.spec_steps:
        raise AssertionError(f"{label}: {len(results)} requests, {s.nonfinite_steps} "
                             f"non-finite steps, {s.spec_steps} rounds")
    for name, step in steps.items():
        want = s.spec_steps * (SPEC_K - 1 if name == "draft decode" else 1)
        replays = step.replays - base[name]
        if step.captures != 1 or (name != "catch-up" and replays != want):
            raise AssertionError(f"{label}: the {name} graph captured {step.captures} times, "
                                 f"replayed {replays} for {s.spec_steps} rounds")
    ms = {k: sum(a.elapsed_time(b) for a, b in v) / max(len(v), 1) for k, v in spans.items()}
    prompts = [results[rid].prompt for rid in sorted(results)]
    plain_rows = {}
    _, plain, plain_info = _spec_run(f"{label}: plain decode graph", srv.model, srv.params,
                                     prompts, rows=plain_rows, max_new=MAX_NEW)
    # xlstm's splits come a few tokens in, too early for the matched
    # positions to bound the verify/decode noise (its chunked mLSTM and
    # sLSTM round otherwise than its decode step under redmule_hfp8, and a
    # random model's greedy margins are smaller than that): its accounting
    # is read, and its token parity is held at full depth under fp32
    # (``_xlstm_fp32``).
    _greedy_accounting(label, results, plain, rows, plain_rows,
                       held=arch != SPEC_STATE_DRAFTER)
    per = {name: sorted({r[:-1] for r, _ in recs}) for name, recs in readings.items()}
    # Every eager forward and every replay of a step launch the same kernels.
    forwards = collections.Counter()
    for name, recs in readings.items():
        for key, c in recs[0][1].items():
            forwards[key] += c * (len(recs) + steps[name].replays)
    log(f"{label}: decode {s.decode_tok_s:.1f} tok/s against the plain graph's "
        f"{plain_info['tok_s']:.1f} ({s.decode_tok_s / plain_info['tok_s']:.2f}x); acceptance "
        f"{s.acceptance_rate:.1%} ({s.spec_accepted}/{s.spec_drafted}), {s.accepted_per_step:.3f} "
        f"a round over {s.spec_steps} rounds; device ms a run: "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" (plain decode replay {plain_info['replay_ms']:.3f}); pages held at most "
        f"{max(held)}; launches gemm {gemm_n}, paged decode {decode_n}; per eager forward "
        f"{READING[:-1]}: {per}; launcher wall {wall:.1f} s")
    out = {"ms": ms, "per": per, "tok_s": s.decode_tok_s, "plain_tok_s": plain_info["tok_s"],
           "acceptance": s.acceptance_rate, "gemm": gemm_n, "decode": decode_n,
           "forwards": forwards,
           "state_bytes": srv.drafter.store.state_bytes() if hasattr(srv.drafter, "store")
           else srv.cache.state_bytes()}
    if arch == SPEC_STATE_DRAFTER and not extra:
        _, _, out["own"] = _spec_run(f"{label}: xlstm drafter, the target's parameters",
                                     srv.model, srv.params, prompts, spec=_spec_config(),
                                     drafter=(srv.model, srv.params), max_new=MAX_NEW)
        if not out["own"]["acceptance"] > 0:
            raise AssertionError(f"{label}: own-parameter acceptance 0")
        out["fp32"] = _xlstm_fp32(prompts)
    if arch == "recurrentgemma-2b":
        out["long"] = _rg_long_spec(srv.model, srv.params)
    del srv, server
    return out


def _xlstm_fp32(prompts) -> dict:
    """xlstm at full depth under fp32 (0.3 GB of weights) on (b)'s prompts:
    greedy speculative tokens equal to the plain decode graph's with the
    n-gram drafter and the xlstm drafter on the target's own parameters
    (whose drafts are then the target's chain: acceptance held at 0.9,
    the commit pass taking full lengths) and on seed 1's. Returns each
    run's readings."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config(SPEC_STATE_DRAFTER), policy="fp32",
                              kv_cache_dtype="fp32")
    model = build(cfg, device="cuda")
    params = model.init(0)
    label = f"spec-state (b) {cfg.name} {cfg.n_layers} layers fp32"
    _, plain, _ = _spec_run(f"{label} plain", model, params, prompts, max_new=MAX_NEW)
    out = {}
    for name, drafter in _state_drafters(model, params):
        _, res, out[name] = _spec_run(f"{label} {name}", model, params, prompts,
                                      spec=_spec_config(), drafter=drafter, max_new=MAX_NEW)
        _same_tokens(f"{label} {name}", _tokens(res), _tokens(plain))
    own = out["xlstm drafter, the target's parameters"]["acceptance"]
    if not own >= 0.9:
        raise AssertionError(f"{label}: own-parameter acceptance {own:.1%}")
    log(f"{label}: greedy speculative tokens equal the plain decode graph's with "
        + ", ".join(out) + f"; own-parameter acceptance {own:.1%}")
    del model, params
    torch.cuda.empty_cache()
    return out


def _spec_config():
    from repro_torch.serving import SpecConfig

    return SpecConfig(k=SPEC_K)


def _rg_long_spec(model, params) -> dict:
    """recurrentgemma's 3000-token request (phase 15(c)'s) with k = 4 n-gram
    speculation, in chunks of 512: the verify pass writes up to k + 1
    positions past the committed length, and the pages held never exceed
    the windowed reservation, below the request's span."""
    from repro_torch.serving import Server, ServerConfig

    prompt = list(np.random.default_rng(7).integers(0, model.cfg.vocab_size, size=RG_LONG))
    total = RG_LONG + RG_LONG_NEW
    server = Server(model, params, ServerConfig(**SERVE_CONFIG, prefill_chunk=RG_CHUNK,
                                                max_seq_len=total), seed=0,
                    spec=_spec_config())
    server.submit(prompt, max_new_tokens=RG_LONG_NEW)
    held = []
    t0 = time.perf_counter()
    while server.scheduler.has_work():
        server.step()
        held.append(server.cache.allocator.num_held)
    wall = time.perf_counter() - t0
    (out,) = server.results.values()
    cap, span = server.scheduler.worst_pages(total), server.cache.allocator.pages_for(total)
    label = f"spec-state (b) recurrentgemma-2b {model.cfg.n_layers} layers, long request"
    log(f"{label}: {out.num_generated} tokens in {server.stats.spec_steps} rounds (acceptance "
        f"{server.stats.acceptance_rate:.1%}), wall {wall:.2f} s; pages held at most "
        f"{max(held)} (reservation {cap}, the request spans {span})")
    if out.num_generated != RG_LONG_NEW or not max(held) <= cap < span:
        raise AssertionError(f"{label}: {out.num_generated} tokens, {max(held)} pages held "
                             f"against a reservation of {cap} and a span of {span}")
    return {"held": max(held), "cap": cap, "span": span}


def phase_spec_state() -> dict:
    """Phase 16: (a) parity at one unit; (b) each target at full depth
    through the launcher, xlstm also with the xlstm drafter. Returns the
    GEMM calls by shape of (b)'s runs and their readings, for the kernel
    line."""
    _spec_state_parity()
    calls, runs = collections.Counter(), {}
    for arch, extra in (("recurrentgemma-2b", []), ("xlstm-125m", []),
                        ("xlstm-125m", ["--draft-model", SPEC_STATE_DRAFTER])):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        runs[(arch, bool(extra))] = _launcher_spec(arch, extra, calls)
        log(f"spec-state {arch} {' '.join(extra)}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return {"spec_state_calls": calls, "spec_state": runs}


# -- phase 17 --------------------------------------------------------------------

# The encoder-decoder and VLM families, static-batch as in the reference:
# seamless-m4t-large-v2 (24 encoder and 24 decoder layers, cross-attention,
# LayerNorm, gelu, a tied 256206-row table) and internvl2-76b (80 layers at
# d 8192, 256 image patches ahead of the tokens, GQA groups of 8).
ENCDEC = ("seamless-m4t-large-v2", "internvl2-76b")
# (b) the launcher: 4 requests of 64 tokens, 16 new (falls back to static).
ENCDEC_SERVE_ARGS = ["--fp8-kv", "--fp8-params", "--policy", "redmule_hfp8", "--requests", "4",
                     "--prompt-len", "64", "--max-new", str(MAX_NEW)]
# Room kept beside the E4M3 weights at serving: the prefill's K-major fp16
# copy of a weight (internvl2's largest, 28672 x 8192, 0.47 GB) and its
# activations, the ring, the CUDA context and the kernel library.
ENCDEC_SPARE = 6e9


def _encdec_batch(cfg, b: int, s: int, seed: int) -> dict:
    """Tokens and the stub frontends on the card, drawn as the serve
    launcher draws them."""
    from repro_torch.launch.serve import frontend_inputs

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)),
             **frontend_inputs(cfg, b, s, rng)}
    return {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


def _static_run(model, params, batch, max_len, forced=None, steps=4) -> tuple:
    """``prefill`` then ``steps`` decode steps on a ring of ``max_len``
    positions (the VLM's patches counted), fed ``forced`` tokens when given;
    returns (logits of every step, the tokens chosen)."""
    cross = batch["frames"].shape[1] if "frames" in batch else 0
    cache = model.init_cache(batch["tokens"].shape[0], max_len, cross_len=cross)
    out = [model.prefill(params, batch, cache)[:, -1]]
    chosen = [out[0].argmax(-1, keepdim=True)]
    for i in range(steps):
        tok = chosen[-1] if forced is None else forced[i]
        out.append(model.decode_step(params, tok, cache)[:, 0])
        chosen.append(out[-1].argmax(-1, keepdim=True))
    torch.cuda.synchronize()
    return out, chosen


def _encdec_parity(arch: str) -> collections.Counter:
    """(a) ``arch`` at full width with 2 layers (seamless: 2 encoder and 2
    decoder layers), kernels against plain under phase 7's policies and
    bounds (``SLICE_PARITY``): the teacher-forced ``forward`` over 2 x 64
    tokens and its frames or patches, and ``prefill`` with 4 decode steps
    fed the kernels' tokens; under redmule_hfp8 (E4M3 cross K/V read back
    at decode) ``generate_static``'s tokens too. Returns the redmule_hfp8
    run's GEMM calls by (M, K, N, schedule, form)."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.models import build
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import generate_static

    hfp8_calls = collections.Counter()
    for pol, kv, fp8p, bound in SLICE_PARITY:
        base = get_config(arch)
        cfg = dataclasses.replace(base, n_layers=2, policy=pol, kv_cache_dtype=kv,
                                  fp8_params=fp8p,
                                  n_encoder_layers=min(base.n_encoder_layers, 2))
        model = build(cfg, device="cuda")
        params = model.init(0)
        plain = Transformer(cfg, engine=Engine(policy=pol, backend="torch"), device="cuda")
        batch = _encdec_batch(cfg, 2, 64, seed=3)
        max_len = cfg.n_frontend_tokens + 64 + 8
        calls = hfp8_calls if pol == "redmule_hfp8" else collections.Counter()
        with _recording_plans(calls):
            got_f = model.logits(params, model.forward(params, batch)[0])
            got, chosen = _static_run(model, params, batch, max_len)
        want_f = plain.logits(params, plain.forward(params, batch)[0])
        want, _ = _static_run(plain, params, batch, max_len, forced=chosen[:-1])
        if not all(torch.isfinite(g).all() for g in [got_f, *got]):
            raise AssertionError(f"encdec (a) {arch} {pol}: non-finite logits")
        errs = {"forward": rel_err(got_f, want_f),
                "prefill and decode": max(rel_err(a, b) for a, b in zip(got, want))}
        line = ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        if pol == "redmule_hfp8":
            seqs = [generate_static(m, params, batch, max_new_tokens=8)[0] for m in (model, plain)]
            if not np.array_equal(*seqs):
                raise AssertionError(f"encdec (a) {arch} {pol}: generate_static's tokens differ")
            line += "; generate_static's 2 x 8 tokens equal"
        log(f"encdec (a) {arch} 2 layers {pol}: kernels against plain, max|dlogit|/max|logit| "
            f"{line} (bound {bound:g})")
        if not max(errs.values()) <= bound:
            raise AssertionError(f"encdec (a) {arch} {pol}: {errs} against {bound}")
        del model, plain, params
        torch.cuda.empty_cache()
    log(f"encdec (a) {arch} redmule_hfp8: the kernels' GEMMs by (M, K, N, schedule, form): "
        + ", ".join(f"{k} x{v}" for k, v in sorted(hfp8_calls.items(), key=str)))
    return hfp8_calls


def _serve_depth(cfg) -> tuple:
    """The depth at which ``cfg``'s E4M3 weights (one byte a parameter),
    ``ENCDEC_SPARE`` beside them, fit the card, with the reckoning."""
    total = torch.cuda.get_device_properties(0).total_memory
    for n in range(cfg.n_layers, 0, -1):
        need = dataclasses.replace(cfg, n_layers=n).param_count() + ENCDEC_SPARE
        if need <= total:
            return n, (f"{n} of {cfg.n_layers} layers: {need / 1e9:.1f} GB (E4M3 weights "
                       f"{(need - ENCDEC_SPARE) / 1e9:.1f} GB, {ENCDEC_SPARE / 1e9:.0f} GB "
                       f"spare) of the card's {total / 1e9:.1f} GB")
    raise AssertionError(f"{cfg.name}: not one layer's E4M3 weights fit the card")


def _encdec_serve(arch: str, calls: collections.Counter) -> dict:
    """(b) ``arch`` at full width through the serve launcher
    (``ENCDEC_SERVE_ARGS``; the launcher falls back to static mode and
    passes the stub frontends), at the depth whose weights fit
    (``_serve_depth``: internvl2's 80 layers if they do), the launch
    counters zeroed just before and read just after: prefill s, decode
    tok/s, peak memory, and the tokens inside the vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, redmule_gemm
    from repro_torch.launch import serve

    n, reckoning = _serve_depth(get_config(arch))
    log(f"encdec (b) {arch}: serving depth {reckoning}")
    stats = []
    generate = serve.generate_static

    def recorded(*args, **kw):
        out = generate(*args, **kw)
        stats.append(out[1])
        return out

    serve.generate_static = recorded
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with _recording_plans(calls):
            _reset_launch_counts()
            t0 = time.perf_counter()
            _, seqs = serve.main(["--arch", arch, "--layers", str(n), *ENCDEC_SERVE_ARGS])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        serve.generate_static = generate
    gemm_n, decode_n = redmule_gemm.launches.n, flash_attention.launches.n
    (st,) = stats
    vocab = get_config(arch).vocab_size
    if seqs.shape != (4, MAX_NEW) or not ((0 <= seqs) & (seqs < vocab)).all():
        raise AssertionError(f"encdec (b) {arch}: tokens {seqs.shape} outside the vocabulary")
    mem = torch.cuda.max_memory_allocated()
    log(f"encdec (b) {arch} {n} layers: prefill {st.prefill_s:.3f} s, first decode "
        f"{st.first_decode_s:.3f} s, decode {st.decode_tok_s:.1f} tok/s "
        f"({1e3 * st.steady_s / max(st.steady_steps, 1):.1f} ms a step over {st.steady_steps}), "
        f"peak memory {mem / 1e9:.2f} GB; launches gemm {gemm_n}, paged decode {decode_n}; "
        f"launcher wall {wall:.1f} s (weights made, build included)")
    if decode_n:
        raise AssertionError(f"encdec (b) {arch}: {decode_n} paged decodes on the static path")
    return {"layers": n, "prefill_s": st.prefill_s, "tok_s": st.decode_tok_s, "mem": mem,
            "gemm": gemm_n}


def phase_encdec() -> dict:
    """Phase 17 (a) and (b), each model built, run and freed in turn.
    Returns the GEMM calls by arch and shape of (b)'s runs, for the kernel
    line."""
    calls, runs = {}, {}
    for arch in ENCDEC:
        t0 = time.perf_counter()
        _encdec_parity(arch)
        calls[arch] = collections.Counter()
        runs[arch] = _encdec_serve(arch, calls[arch])
        log(f"encdec {arch}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return {"encdec_calls": calls, "encdec": runs}


def phase_encdec_train() -> None:
    """Phase 17 (c): through the train launcher (2 x 1024 tokens,
    redmule_hfp8, remat block) seamless at 24 encoder and 24 decoder
    layers (256 decoder tokens a row: the ``seq // enc_dec_ratio`` rule)
    and internvl2 at the depth whose training state fits (256 patches
    ahead of each row's 1024 tokens)."""
    for arch, layers in (("seamless-m4t-large-v2", 24), ("internvl2-76b", None)):
        _launcher_train("encdec (c)", arch, layers)


# -- phase 9 ---------------------------------------------------------------------

# The train run of phase 10; phase 9 holds one step at its batch.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 1024, 2, 4

# Bounds of the train-parity phase, relative: (loss, grad norm, worst
# per-tensor |dg| / |g| in norm). Under redmule_hfp8 both paths give the
# same bits (PERF.md): every product is exact in fp32 and both round its
# fp32 sum once to fp16, so any difference means one path changed its
# arithmetic, and the bound is 0, as in serving parity.
TRAIN_PARITY_BOUND = {"fp32": (1e-5, 1e-4, 1e-3), "redmule_hfp8": (0.0, 0.0, 0.0)}


def _leaf_names(tree, prefix="") -> list:
    """Dotted names of a parameter tree's tensors, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def _step_grads(model, params, tokens, backend):
    """Loss and gradients of one train step's loss function on ``backend``."""
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.training import make_loss_fn

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = make_loss_fn(model, backend=backend)(live, {"tokens": tokens})
    grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def phase_train_parity(arch: str = "granite-3-8b", bounds=None) -> None:
    """``arch`` at full width, 2 layers, remat "block", one step's loss
    and gradients on the train run's 2 x 1024 tokens (so every forward and
    backward GEMM shape of phase 10 is compared): the kernels' path ("cuda": every
    forward GEMM and both backward GEMMs of each on the GEMM-Op kernel)
    against the plain path ("torch") on the card, from the same parameters
    and batch, under fp32 and redmule_hfp8."""
    from repro_torch.configs import get_config
    from repro_torch.data import for_model
    from repro_torch.models import build
    from repro_torch.optim import global_norm

    for pol, (b_loss, b_gnorm, b_grad) in (bounds or TRAIN_PARITY_BOUND).items():
        cfg = dataclasses.replace(get_config(arch), n_layers=2, policy=pol, remat="block")
        model = build(cfg, device="cuda")
        params = model.init(0)
        tokens = for_model(cfg, TRAIN_SEQ, TRAIN_BATCH, seed=1).batch(0)["tokens"]
        tokens = torch.from_numpy(tokens).cuda().long()
        loss, grads = _step_grads(model, params, tokens, "cuda")
        want_loss, want = _step_grads(model, params, tokens, "torch")
        gnorm, want_gnorm = float(global_norm(grads)), float(global_norm(want))
        per_tensor = [float((g.float() - w.float()).norm() / w.float().norm().clamp(min=1e-30))
                      for g, w in zip(grads, want)]
        worst_max = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                        for g, w in zip(grads, want))
        d_loss = abs(loss - want_loss) / abs(want_loss)
        d_gnorm = abs(gnorm - want_gnorm) / want_gnorm
        names = _leaf_names(params)
        worst = sorted(range(len(grads)), key=lambda i: -per_tensor[i])[:3]
        log(f"train parity {arch} {pol}: worst tensors " + ", ".join(
            f"{names[i]} {tuple(grads[i].shape)} |dg|/|g| {per_tensor[i]:.3g} "
            f"(|g| {float(want[i].float().norm()):.3g})" for i in worst))
        log(f"train parity {arch} {pol}: loss {loss:.6f} vs {want_loss:.6f} (rel {d_loss:.3g}), "
            f"grad norm {gnorm:.6f} vs {want_gnorm:.6f} (rel {d_gnorm:.3g}), worst per-tensor "
            f"|dg|/|g| {max(per_tensor):.3g} (max|dg|/max|g| {worst_max:.3g}) over {len(grads)} "
            f"tensors; bounds {b_loss:g} / {b_gnorm:g} / {b_grad}")
        if not all(np.isfinite([loss, want_loss, gnorm, want_gnorm])):
            raise AssertionError(f"train parity {arch} {pol}: non-finite loss or grad norm")
        if not (d_loss <= b_loss and d_gnorm <= b_gnorm
                and (b_grad is None or max(per_tensor) <= b_grad)):
            raise AssertionError(f"train parity {arch} {pol}: outside its bounds")
        del model, params, grads, want
        torch.cuda.empty_cache()


# -- phase 10 --------------------------------------------------------------------

# GEMM launches a train step makes at 4 layers, 1024 tokens a row, remat
# "block" and cross-entropy chunks of 512: the forward runs 11 GEMMs a
# layer (q, k, v, o, gate, up, down, and the score and value products of
# each of 2 key chunks) and one logits GEMM a chunk (2); the backward
# recomputes all 46 (block and chunk remat) and runs 2 GEMMs for each.
GEMM_PER_TRAIN_STEP = 4 * (11 * TRAIN_LAYERS + 2)


def phase_train() -> dict:
    """granite-3-8b at full width and 4 layers under redmule_hfp8 with remat
    "block", batch 2 x 1024 tokens, 4 steps through the train launcher's
    function, with both kernels' counters set to 0 before and read after."""
    from repro_torch.kernels import flash_attention, redmule_gemm
    from repro_torch.launch import train

    args = train.parse_args([
        "--arch", "granite-3-8b", "--layers", str(TRAIN_LAYERS), "--seq", str(TRAIN_SEQ),
        "--batch", str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS), "--policy", "redmule_hfp8",
        "--remat", "block", "--log-every", "1", "--seed", "0",
    ])
    redmule_gemm.launches.reset()
    flash_attention.dense_launches.reset()
    flash_attention.dense_tc_launches.reset()
    flash_attention.launches.reset()
    out = train.train(args)
    gemm_n = redmule_gemm.launches.n
    dense_n = flash_attention.dense_launches.n + flash_attention.dense_tc_launches.n
    paged_n = flash_attention.launches.n
    hist = out["history"]
    if len(hist) != TRAIN_STEPS or out["state"].skipped != 0:
        raise AssertionError(f"train: {len(hist)} steps, {out['state'].skipped} skipped")
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist):
        raise AssertionError(f"train: non-finite loss or grad norm: {hist}")
    per_step = sorted({h["gemm_launches"] for h in hist})
    if per_step != [GEMM_PER_TRAIN_STEP] or gemm_n != GEMM_PER_TRAIN_STEP * TRAIN_STEPS:
        raise AssertionError(f"train: GEMM launches per step {per_step} (total {gemm_n}), "
                             f"expected {GEMM_PER_TRAIN_STEP} each")
    # Every training GEMM has 1024 rows or more: all on the tensor cores.
    schedules = sorted({(h["gemm_simt_launches"], h["gemm_tc_launches"],
                         h["gemm_small_row_launches"]) for h in hist})
    if schedules != [(0, GEMM_PER_TRAIN_STEP, 0)]:
        raise AssertionError(f"train: GEMM launches per step by schedule (simt, tensor-core, "
                             f"small-row) {schedules}, expected (0, {GEMM_PER_TRAIN_STEP}, 0)")
    aux = sorted({h["gemm_aux_launches"] for h in hist})
    if dense_n or paged_n or any(h["dense_attention_launches"] or h["dense_attention_tc_launches"]
                                 for h in hist):
        raise AssertionError(f"train: attention kernels launched ({dense_n} dense, {paged_n} paged); "
                             "the training attention runs its products through the GEMM")
    steady = [h["ms"] for h in hist[1:]]
    ms = float(np.mean(steady))
    tok_s = out["tokens_per_step"] / (ms / 1e3)
    mem = out["max_memory_bytes"]
    log(f"train: granite-3-8b {TRAIN_LAYERS} layers d4096, redmule_hfp8, remat block, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} tokens; losses {[round(h['loss'], 4) for h in hist]}, "
        f"grad norms {[round(h['grad_norm'], 4) for h in hist]}, skipped 0")
    log(f"train: ms per step {[round(h['ms'], 1) for h in hist]} (steady mean {ms:.1f} ms, "
        f"{tok_s:.1f} tokens/s); max memory {mem / 1e9:.2f} GB; launches per step: gemm "
        f"{per_step[0]}, dense attention 0 (total gemm {gemm_n}); by schedule (simt, "
        f"tensor-core, small-row) {schedules[0]}; K-major copies {aux}")
    return {"gemm": gemm_n, "gemm_per_step": per_step[0], "ms_per_step": ms,
            "copies": sum(h["gemm_aux_launches"] for h in hist)}


# -- phase 18 --------------------------------------------------------------------

# Where phase 18 writes its traces, metrics and profile (``build/`` is ignored).
OBS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_obs"


def _validate_trace(path: Path) -> str:
    """``scripts/validate_trace.py`` on ``path`` in a process of its own (the
    script as it is, not imported); raises unless it exits 0."""
    script = Path(__file__).resolve().parent / "scripts" / "validate_trace.py"
    r = subprocess.run([sys.executable, str(script), str(path)], capture_output=True, text=True,
                       timeout=120)
    if r.returncode != 0:
        raise AssertionError(f"validate_trace {path.name}: exit {r.returncode}: "
                             f"{(r.stdout + r.stderr).strip()[:2000]}")
    return r.stdout.strip()


def _host_wait(events: list) -> str:
    """From the "in flight" track (one complete event a harvested step,
    dispatch to result), by step kind: the host's blocking wait on the
    steps' events, their dispatch-to-harvest seconds, and the wait's share
    of them. Steps harvested together overlap on the track, so only a
    kind's own share is read."""
    from repro_torch.obs import DEVICE_INFLIGHT_TID, PID_DEVICE

    kinds = collections.defaultdict(lambda: [0.0, 0.0, 0])
    for e in events:
        if e["ph"] == "X" and e["pid"] == PID_DEVICE and e["tid"] == DEVICE_INFLIGHT_TID:
            k = kinds[e["name"].removesuffix(".complete")]
            k[0] += e["args"]["wait_s"]
            k[1] += e["dur"] / 1e6
            k[2] += 1
    if not kinds:
        raise AssertionError("no step on the trace's in-flight track")
    return "host wait on the in-flight track: " + "; ".join(
        f"{kind} {w:.4f} s of {d:.4f} s over {n} steps ({w / max(d, 1e-12):.1%})"
        for kind, (w, d, n) in sorted(kinds.items()))


def _check_registry(label: str, server, results: dict, n_prefills: int) -> str:
    """The registry's histograms and request counters against the stats view
    and the run: one idle observation a harvest, one step observation a
    prefill and a decode step, a TTFT a request. Returns a summary."""
    snap = server.metrics.snapshot()
    c, h, s = snap["counters"], snap["histograms"], server.stats
    want = {
        ("counter", "serving_decode_tokens_total"): s.decode_tokens,
        ("counter", "serving_decode_steps_total"): s.decode_steps,
        ("counter", "serving_prefill_calls_total"): s.prefill_calls,
        ("counter", "serving_requests_submitted_total"): len(results),
        ("counter", "serving_requests_finished_total"): len(results),
        ("histogram", "serving_decode_step_seconds"): s.decode_steps,
        ("histogram", "serving_prefill_chunk_seconds"): n_prefills,
        ("histogram", "engine_idle_seconds"): s.decode_steps + n_prefills,
        ("histogram", "serving_ttft_seconds"): len(results),
    }
    got = {(kind, name): (c[name] if kind == "counter" else h[name]["count"])
           for kind, name in want}
    if got != want:
        raise AssertionError(f"{label}: registry {got} against the run {want}")
    if c["serving_nonfinite_steps_total"] or snap["gauges"]["engine_inflight"]:
        raise AssertionError(f"{label}: non-finite steps or steps left in flight: {snap}")
    idle = h["engine_idle_seconds"]
    return (f"registry = stats and run ({len(results)} requests, {s.decode_steps} decode steps, "
            f"{n_prefills} prefill steps); host waits p50 {idle['p50']:.6f} s, "
            f"p95 {idle['p95']:.6f} s, sum {idle['sum']:.4f} s")


def phase_obs_slice() -> None:
    """(a) granite-3-8b at full width with 2 layers (redmule_hfp8, E4M3
    weights and pages, the decode graph): phase 8's prompts through a
    traced and an untraced server give the same tokens bit for bit and the
    same decode-graph replays; the trace passes ``validate_trace.py``. Then
    the same prompts with the decode step eager and a roofline recorder
    open: the same tokens again, and the run's kernel calls counted
    (``roofline/cost.py``), its bound beside the run's seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.obs import JsonTracer, write_trace
    from repro_torch.roofline import analysis, cost
    from repro_torch.serving import Server, ServerConfig

    cfg = dataclasses.replace(get_config("granite-3-8b"), policy="redmule_hfp8",
                              kv_cache_dtype="e4m3", fp8_params=True, n_layers=2)
    model = build(cfg, device="cuda")
    params = model.init(0)
    prompts = _serve_prompts(cfg)
    config = ServerConfig(**SERVE_CONFIG, max_seq_len=max(map(len, prompts)) + MAX_NEW)
    runs = {}
    for label, tracer, graph in (("traced", JsonTracer(), True), ("untraced", None, True),
                                 ("eager, counted", None, False)):
        server = Server(model, params, config, seed=0, tracer=tracer)
        server.engine.graph_decode = graph
        for p in prompts:
            server.submit(p, max_new_tokens=MAX_NEW)
        with cost.recording() if not graph else contextlib.nullcontext() as counts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = server.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs[label] = (server, _tokens(results), wall, counts)
    (traced, toks, _, _), (untraced, toks_off, _, _) = runs["traced"], runs["untraced"]
    eager, toks_eager, wall, counts = runs["eager, counted"]
    _same_tokens("obs (a): traced against untraced", toks, toks_off)
    _same_tokens("obs (a): the counted eager run against the graph run", toks_eager, toks)
    if traced.engine.graph_replays != untraced.engine.graph_replays or \
            traced.engine.graph_replays != traced.stats.decode_steps:
        raise AssertionError(f"obs (a): {traced.engine.graph_replays} replays traced, "
                             f"{untraced.engine.graph_replays} untraced, "
                             f"{traced.stats.decode_steps} decode steps")
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    path = OBS_DIR / "slice_trace.json"
    write_trace(traced.tracer, str(path))
    checked = _validate_trace(path)
    log(f"obs (a): 2 layers, traced and untraced: the same tokens and "
        f"{traced.engine.graph_replays} decode-graph replays each; "
        f"{len(traced.tracer.events)} events, {checked}; {_host_wait(traced.tracer.events)}")
    roof = analysis.roofline_from_counts(counts)
    if counts.capacity_calls or counts.kernels["paged_decode"].calls != \
            cfg.n_layers * eager.stats.decode_steps:
        raise AssertionError(f"obs (a): recorded {counts.to_dict()}, "
                             f"{counts.capacity_calls} at capacity")
    log(f"obs (a): eager run counted (roofline/cost.py): "
        + ", ".join(f"{k} {v.calls} calls, {v.flops / 1e9:.2f} GFLOP, {v.bytes / 1e9:.3f} GB"
                    for k, v in counts.kernels.items())
        + f"; bound {roof.step_s * 1e3:.3f} ms ({roof.bottleneck}) against {wall * 1e3:.1f} ms "
          f"of wall (lengths read from the card at each decode, so the wall is not a timing)")
    del traced, untraced, eager, runs, model, params
    gc.collect()
    torch.cuda.empty_cache()


def _timed_tracer():
    """A ``JsonTracer`` that sums the host seconds spent inside its event
    calls (``.host_s``, ``.calls``): the tracer's own cost, read directly
    rather than from the spread of two runs' rates, and zeroed with the
    events at ``reset()``. The two clock reads around each call are charged
    to it, so the sum errs high."""
    from repro_torch.obs import JsonTracer

    class TimedTracer(JsonTracer):
        host_s, calls = 0.0, 0

        def reset(self):  # ``Server.reset()`` after the warm-up drops its share too
            super().reset()
            self.host_s, self.calls = 0.0, 0

    def timed(method):
        def call(self, *a, **kw):
            t0 = time.perf_counter()
            method(self, *a, **kw)
            self.host_s += time.perf_counter() - t0
            self.calls += 1
        return call

    for name in ("begin", "end", "instant", "complete"):
        setattr(TimedTracer, name, timed(getattr(JsonTracer, name)))
    return TimedTracer()


def phase_obs_serve(cfg, model, params) -> None:
    """(b) On phase 8's model (40 layers): the serve run of phase 12's
    sizing with the tracer off, on, on, off, in turns: the same tokens and
    replays, decode tok/s with the tracer on against off, and the host
    seconds spent inside the tracer's calls against the decode seconds."""
    prompts = _serve_prompts(cfg)
    rates, tokens = {"on": [], "off": []}, []
    for state in ("off", "on", "on", "off"):
        server, results, _ = _feature_run(f"obs (b) tracer {state}", model, params, prompts,
                                          tracer=_timed_tracer() if state == "on" else None)
        rates[state].append(server.stats.decode_tok_s)
        tokens.append(_tokens(results))
        if state == "on":
            t, s = server.tracer, server.stats
            events = sum(e["ph"] in "BEiX" for e in t.events)
            steps = max(s.decode_steps, 1)
            log(f"obs (b) tracer on: {events} events ({events / steps:.1f} a decode step); "
                f"tracer host time {t.host_s * 1e3:.3f} ms in {t.calls} calls "
                f"({t.host_s / max(t.calls, 1) * 1e6:.2f} us a call, "
                f"{t.host_s / steps * 1e6:.1f} us a decode step, "
                f"{t.host_s / max(s.decode_s + s.prefill_s, 1e-12):.3%} of the run's "
                f"{(s.decode_s + s.prefill_s) * 1e3:.1f} ms of prefill and decode); "
                f"{_host_wait(t.events)}")
        del server
    for t in tokens[1:]:
        _same_tokens("obs (b): tracer on against off", t, tokens[0])
    log(f"obs (b): decode tok/s tracer off {[round(r, 1) for r in rates['off']]}, on "
        f"{[round(r, 1) for r in rates['on']]} (the same tokens in all four runs)")


def _obs_launcher_checks(arch: str, server, paths: dict) -> None:
    """(b) The full-depth launcher call of phase 14(b) that wrote a trace,
    metrics and a profile: the trace passes ``validate_trace.py`` (a
    process of its own), the metrics' counters are the printed stats, the
    profile's Chrome trace names the GEMM and paged-decode kernels."""
    label = f"obs (b) launcher {arch}"
    checked = _validate_trace(paths["trace"])
    doc = json.loads(paths["metrics"].read_text())
    s = server.stats
    for name, value in (("serving_decode_tokens_total", s.decode_tokens),
                        ("serving_decode_steps_total", s.decode_steps),
                        ("serving_prefill_calls_total", s.prefill_calls),
                        ("serving_prefill_tokens_total", s.prefill_tokens),
                        ("serving_slot_steps_total", s.slot_steps),
                        ("serving_decode_seconds_total", s.decode_s)):
        if doc["counters"][name] != value:
            raise AssertionError(f"{label}: metrics {name} {doc['counters'][name]}, stats {value}")
    prof = paths["profile"] / "device_trace.json"
    text = prof.read_text()
    missing = [k for k in ("redmule_gemm", "paged_decode") if k not in text]
    if missing:
        raise AssertionError(f"{label}: the profile names no {missing} kernel")
    trace = json.loads(paths["trace"].read_text())["traceEvents"]
    log(f"{label}: {checked}; trace {paths['trace'].stat().st_size / 1e3:.1f} kB, metrics "
        f"{paths['metrics'].stat().st_size / 1e3:.1f} kB, profile {prof.stat().st_size / 1e6:.1f} "
        f"MB naming redmule_gemm and paged_decode; metrics counters = the printed stats; "
        f"{_host_wait(trace)}")


# -- phase 19 --------------------------------------------------------------------


def phase_examples() -> None:
    """(a) Every example's ``main`` on the card with its own asserts, the
    GEMM-Op kernel's launches read around each by schedule: quickstart,
    train_tinyml (300 steps under fp32, redmule_fp16 and redmule_hfp8),
    graph_shortest_paths (the SIMT min-plus closure), viterbi_decode (the
    max-plus chain and its VJP), serve_decode (granite-3-8b SMOKE through
    ``Server``, internvl2-76b SMOKE through ``generate_static``) and
    train_lm (xlstm-125m SMOKE, 3 steps)."""
    from repro_torch.examples import (
        graph_shortest_paths,
        quickstart,
        serve_decode,
        train_lm,
        train_tinyml,
        viterbi_decode,
    )
    from repro_torch.kernels import redmule_gemm as rg

    runs = [("quickstart", quickstart.main, []),
            ("train_tinyml", train_tinyml.main, []),
            ("graph_shortest_paths", graph_shortest_paths.main, []),
            ("viterbi_decode", viterbi_decode.main, []),
            ("serve_decode granite-3-8b", serve_decode.main, ["--arch", "granite-3-8b"]),
            ("serve_decode internvl2-76b", serve_decode.main, ["--arch", "internvl2-76b"]),
            ("train_lm", train_lm.main, ["--smoke", "--steps", "3", "--log-every", "1"])]
    for label, fn, argv in runs:
        before = (rg.launches.n, rg.simt_launches.n, rg.tc_launches.n, rg.small_row_launches.n)
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        after = (rg.launches.n, rg.simt_launches.n, rg.tc_launches.n, rg.small_row_launches.n)
        n = [a - b for a, b in zip(after, before)]
        if n[0] <= 0:
            raise AssertionError(f"examples {label}: no GEMM-Op launch on the card")
        semiring_example = label in ("graph_shortest_paths", "viterbi_decode")
        if semiring_example and n[1] != n[0]:
            raise AssertionError(f"examples {label}: {n} launches, not all on the SIMT schedule")
        extra = f"; accuracies {out}" if label == "train_tinyml" else ""
        log(f"examples {label}: asserts held in {time.perf_counter() - t0:.1f} s; GEMM-Op calls "
            f"{n[0]} (simt {n[1]}, tensor-core {n[2]}, small-row {n[3]}){extra}")
    gc.collect()
    torch.cuda.empty_cache()


PAPER_NETWORKS = ("RESNET8", "MOBILENETV2", "TINY_TRANSFORMER")


def phase_paper_gemms() -> list:
    """(b) Every GEMM of ``paper_tinyml.training_gemms`` for ResNet8,
    MobileNetV2 and TinyTransformer (forward, dW, dX; X (M, N) and W (N, K),
    N the reduction) under redmule_fp16 and redmule_hfp8 through
    ``Engine.matmul`` on the kernel, within ``GEMM_TOL`` of the plain
    backend on the same operands. Each is timed as a graph replay three
    ways: ``Engine.matmul`` (the operand casts included), the kernel alone
    on the cast operands, and ``torch.matmul`` on fp16 operands; its bound
    is the kernel call's count, recorded (``roofline/cost.py``). Returns
    one kernel-line row a network, policy and schedule (each naming its
    schedule's source): the sums over those GEMMs, with the launches of the
    checked ``Engine.matmul`` calls (one a GEMM)."""
    from repro_torch.configs import paper_tinyml
    from repro_torch.core import semiring
    from repro_torch.core.precision import cast
    from repro_torch.engine import Engine
    from repro_torch.kernels import redmule_gemm as rg
    from repro_torch.roofline import cost

    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for net in PAPER_NETWORKS:
        gemms = paper_tinyml.training_gemms(getattr(paper_tinyml, net))
        for policy in ("redmule_fp16", "redmule_hfp8"):
            eng = Engine(policy=policy, backend="cuda")
            plain = eng.with_backend("torch")
            pol = eng.policy
            # Summed by the schedule each GEMM was planned on: one row a
            # schedule, each naming its own kernel source.
            tots = collections.defaultdict(collections.Counter)
            for g in gemms:
                x = torch.randn((g.M, g.N), generator=gen, device="cuda")
                w = torch.randn((g.N, g.K), generator=gen, device="cuda") * g.N ** -0.5
                xs, ws = cast(x, pol.storage_fwd), cast(w, pol.storage_fwd)
                kw = dict(gop=semiring.MATMUL, policy=pol, out_dtype=pol.out)
                tot = tots[rg.plan_call(xs, ws, None, gop=semiring.MATMUL, policy=pol)
                           .plan.schedule]
                launches0 = rg.launches.n
                got = eng.matmul(x, w)
                tot["launches"] += rg.launches.n - launches0
                tot["gemms"] += 1
                want = plain.matmul(x, w)
                err = rel_err(got, want)
                tot["max_abs_err"] = max(tot["max_abs_err"],
                                         float((got.float() - want.float()).abs().max()))
                if not err <= GEMM_TOL[got.dtype]:
                    raise AssertionError(f"paper {net} {g.name} {policy}: max|dz|/max|z| = "
                                         f"{err:.3g} > {GEMM_TOL[got.dtype]}")
                with cost.recording() as counts:
                    eng.matmul(x, w)
                bound = max(counts.compute_s, counts.memory_s) * 1e3
                x16, w16 = x.half(), w.half()
                tot["engine_ms"] += time_ms(lambda: eng.matmul(x, w), iters=10, graph=True)
                tot["ms"] += time_ms(lambda: rg.redmule_gemm(xs, ws, None, **kw), iters=10,
                                     graph=True)
                tot["plain_ms"] += time_ms(lambda: rg.redmule_gemm_plain(xs, ws, None, **kw),
                                           iters=2, warmup=1)
                tot["library_ms"] += time_ms(lambda: torch.matmul(x16, w16), iters=10,
                                             graph=True)
                tot["bound_ms"] += bound
                tot["compute_ms"] += counts.compute_s * 1e3
                tot["memory_ms"] += counts.memory_s * 1e3
                tot["gflop"] += counts.flops / 1e9
            for schedule, tot in sorted(tots.items()):
                rows.append({
                    "name": f"redmule_gemm[paper {net} training GEMMs ({tot['gemms']} of "
                            f"{len(gemms)}, {schedule} schedule), {policy}, summed]",
                    "route": "cuda", "source": GEMM_SOURCE[schedule],
                    "replaces": "src/repro/kernels/redmule_gemm.py:110",
                    "launches": tot["launches"], "max_abs_err": tot["max_abs_err"],
                    "ms": tot["ms"], "engine_ms": tot["engine_ms"], "plain_ms": tot["plain_ms"],
                    "bound_ms": tot["bound_ms"],
                    "bound_by": "bytes" if tot["memory_ms"] >= tot["compute_ms"] else
                                "operations",
                    "library_ms": tot["library_ms"], "gflop": tot["gflop"],
                })
            total = sum(tots.values(), collections.Counter())
            log(f"paper {net} {policy}: {len(gemms)} GEMMs within GEMM_TOL (max|d| "
                f"{max(t['max_abs_err'] for t in tots.values()):.3g}); schedules "
                f"{ {k: t['gemms'] for k, t in sorted(tots.items())} }; kernel "
                f"{total['ms']:.4f} ms summed, Engine.matmul {total['engine_ms']:.4f} ms, "
                f"torch.matmul {total['library_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms; "
                f"bound {total['bound_ms']:.5f} ms ({total['gflop']:.3f} GFLOP); "
                f"{total['launches']} launches")
    return rows


# -- phase 11 --------------------------------------------------------------------


GEMM_SOURCE = {"tc": "src/repro_torch/csrc/redmule_gemm_tc.cu",
               "small_row": "src/repro_torch/csrc/redmule_gemm_sr.cu",
               "simt": "src/repro_torch/csrc/redmule_gemm.cu"}


def _scaled_mm_ms(x, w, out_dtype):
    """``torch._scaled_mm`` (unit scales) on the same fp8 operands, laid out
    as it requires outside the timed call (row-major A with M padded to 16,
    column-major B), or None where its shape rules refuse the GEMM: 2D
    only, K and N multiples of 16, not E5M2 x E5M2."""
    from repro_torch.core.precision import E5M2, FP8_DTYPES

    m, k = x.shape[-2:]
    n = w.shape[-1]
    if (x.dim() != 2 or w.dim() != 2 or k % 16 or n % 16 or x.dtype not in FP8_DTYPES
            or w.dtype not in FP8_DTYPES or x.dtype == w.dtype == E5M2):
        return None
    mp = -(-m // 16) * 16
    a = torch.zeros((mp, k), dtype=x.dtype, device=x.device)
    a[:m] = x
    b = w if w.stride(0) == 1 else w.t().contiguous().t()
    one = torch.ones((), device=x.device)
    return time_ms(lambda: torch._scaled_mm(a, b, one, one, out_dtype=out_dtype), graph=True)


def _gemm_row(label, x, w, out_dtype, launches, policy="redmule_hfp8", op="matmul", y=None,
              **extra):
    """One row of the kernel line, (mul, add) under redmule_hfp8 unless
    ``op`` and ``policy`` say otherwise: the kernel on its planned schedule
    (held within GEMM_TOL of the plain version, a semiring pair to its NaN
    positions and bits; device time from a CUDA-graph replay), the plain
    version, and for (mul, add) torch.matmul on the widened fp16 operands
    (on the fp32 ones under fp32) and torch._scaled_mm on the fp8 ones.
    Bound: ``roofline/cost.py``'s GEMM-Op count of the call."""
    from repro_torch.core import semiring
    from repro_torch.core.precision import FP32, get_policy
    from repro_torch.kernels import redmule_gemm as rg
    from repro_torch.roofline import cost

    pol, gop = get_policy(policy), semiring.get(op)
    kw = dict(gop=gop, policy=pol, out_dtype=out_dtype)
    plan = rg.plan_call(x, w, y, gop=gop, policy=pol).plan
    aux0 = rg.aux_launches.n
    got = rg.redmule_gemm(x, w, y, **kw)
    aux = rg.aux_launches.n - aux0
    want = rg.redmule_gemm_plain(x, w, y, **kw)
    err = rel_err(got, want)
    if gop.is_gemm and not err <= GEMM_TOL[got.dtype]:
        raise AssertionError(f"redmule_gemm[{label}]: max|dz|/max|z| = {err:.3g} > "
                             f"{GEMM_TOL[got.dtype]}")
    if not gop.is_gemm and not same_bits(got, want):
        raise AssertionError(f"redmule_gemm[{label}]: not bitwise against the plain version")
    big = x.numel() * w.shape[-1] > 1 << 32
    ms = time_ms(lambda: rg.redmule_gemm(x, w, y, **kw), iters=5 if big else 20, graph=True)
    # Eager calls, timed the same way: where this exceeds ``ms`` the wrapper's
    # host work (planning, allocation, the ctypes launch) paces the calls.
    eager_ms = time_ms(lambda: rg.redmule_gemm(x, w, y, **kw), iters=5 if big else 20)
    # The plain semiring scan at 4096^3 takes seconds a call: one, after one.
    slow = big and not gop.is_gemm
    plain_ms = time_ms(lambda: rg.redmule_gemm_plain(x, w, y, **kw), iters=1 if slow else 5,
                       warmup=1 if slow else 3)
    library_ms = scaled_ms = None
    if gop.is_gemm:
        x16, w16 = (x, w) if pol.compute == FP32 else (x.half(), w.half())
        library_ms = time_ms(lambda: torch.matmul(x16, w16), iters=5 if big else 20, graph=True)
        scaled_ms = _scaled_mm_ms(x, w, out_dtype)
    bound = cost.gemm_cost(x, w, y, gop=gop, policy=pol, out_dtype=out_dtype)
    share, ulps = ulp_spread(got, want) if got.element_size() == 2 else (
        float((got != want).float().mean()), None)
    return {
        "name": f"redmule_gemm[{label}]", "route": "cuda", "source": GEMM_SOURCE[plan.schedule],
        "replaces": "src/repro/kernels/redmule_gemm.py:110",
        "launches": launches, **extra, "schedule": plan.schedule, "split": plan.split,
        **({"form": plan.form} if plan.form else {}), "aux_launches_per_call": aux,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "share_differ": share, "worst_ulps": ulps,
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound.bound_ms,
        "bound_by": bound.bound_by, "library_ms": library_ms, "scaled_mm_ms": scaled_ms,
        "tflop_s": bound.flops / ms / 1e9,
    }


def _gemm_entries(counts) -> list:
    """The GEMM-Op kernel at every (mul, add) shape of the serving and
    training paths, each on the schedule the planner gives it there, and the
    two auxiliary kernels (K-major copy, split-K combine)."""
    from repro_torch.core.precision import E4M3, E5M2, FP16, cast

    gen = torch.Generator(device="cuda").manual_seed(1)

    def q(fmt, *shape, scale=1.0):
        return cast(cast(torch.randn(shape, generator=gen, device="cuda") * scale, FP16), fmt)

    sr, tc, train = counts["serve_small_row"], counts["serve_tc"], counts["train_gemm"]
    per_decode = {"launches_per_decode_step": counts["gemm_per_decode_step"]}
    per_prefill = {"launches_per_prefill": counts["gemm_per_prefill"]}
    per_step = {"launches_per_train_step": counts["train_gemm_per_step"]}
    table = q(E4M3, 49155, 4096, scale=0.02)
    k_pages = q(E4M3, 1, 96, 8, 128).permute(0, 2, 3, 1)  # (B, Hkv, hd, T) strided view
    chunk_keys = q(E4M3, 1, 144, 8, 128).permute(0, 2, 3, 1)
    per_chunk = {"tc_launches_per_chunk_step": counts["tc_per_chunk_step"]}
    entries = [
        _gemm_row("decode 4x4096x12800", q(E4M3, 4, 4096), q(E4M3, 12800, 4096, scale=0.02).T,
                  FP16, sr, **per_decode),
        _gemm_row("decode 4x4096x1024 (k, v)", q(E4M3, 4, 4096),
                  q(E4M3, 1024, 4096, scale=0.02).T, FP16, sr, **per_decode),
        _gemm_row("decode logits 4x4096x49155 (table.T)", q(E4M3, 4, 4096), table.T, FP16, sr,
                  **per_decode),
        _gemm_row("prefill 64x4096x12800", q(E4M3, 64, 4096),
                  q(E4M3, 12800, 4096, scale=0.02).T, FP16, tc, **per_prefill),
        _gemm_row("prefill scores (1,8)x384x128x96", q(E4M3, 1, 8, 384, 128), k_pages, FP16, tc,
                  **per_prefill),
        _gemm_row("prefill values (1,8)x384x96x128", q(E4M3, 1, 8, 384, 96),
                  k_pages.transpose(-1, -2), FP16, tc, **per_prefill),
        # Chunked prefill at chunk 32 over phase 12's 7-page rows: 112
        # gathered keys and the chunk's 32, and a batched step's dense layer
        # at P = 4 ((4, 32) rows fold into 128). Launches: the shape's calls
        # in phase 12(b)'s two timed runs.
        _gemm_row("chunk scores (1,8)x128x128x144", q(E4M3, 1, 8, 128, 128), chunk_keys,
                  FP16, counts["chunk_scores"], **per_chunk),
        _gemm_row("chunk values (1,8)x128x144x128", q(E4M3, 1, 8, 128, 144),
                  chunk_keys.transpose(-1, -2), FP16, counts["chunk_values"], **per_chunk),
        _gemm_row("batched prefill 128x4096x12800 (P=4 x 32)", q(E4M3, 128, 4096),
                  q(E4M3, 12800, 4096, scale=0.02).T, FP16, counts["chunk_dense"], **per_chunk),
        _gemm_row("train forward 2048x4096x12800", q(E4M3, 2048, 4096),
                  q(E4M3, 4096, 12800, scale=4096 ** -0.5), FP16, train, **per_step),
    ]
    for label, (a, b) in _backward_pairs(torch.Generator(device="cuda").manual_seed(6)).items():
        entries.append(_gemm_row(f"backward {label}", a, b, FP16, train, **per_step))
    entries += _spec_gemm_entries(counts, q, table)
    del table
    entries += [_copy_entry(counts), _combine_entry(counts)]
    return entries


def _spec_gemm_entries(counts, q, table) -> list:
    """Phase 13's GEMM shapes: the verify step (20 rows) and the MoE
    drafter's expert GEMMs and logits. Launches: each shape's calls on
    phase 13(d)'s path, the graphs' warm-ups, captures and replays."""
    from repro_torch.core.precision import E4M3, FP16, FP32

    calls, ctx = counts["spec_calls"], counts["spec_ctx"]
    per_verify = {"launches_per_verify_step": counts["spec_verify_per_step"]}
    per_draft = {"launches_per_draft_decode_step": counts["spec_draft_per_step"]}
    keys = q(E4M3, 4, ctx, 8, 128).permute(0, 2, 3, 1)  # (B, Hkv, hd, T) strided view
    d_table = q(E4M3, 49155, 1024, scale=0.02)
    router_w = torch.randn((1024, 32), generator=torch.Generator(device="cuda").manual_seed(3),
                           device="cuda") * 0.02
    dense = (4, 5, 4096)
    rows = [
        _gemm_row("verify 20x4096x12800", q(E4M3, 20, 4096), q(E4M3, 12800, 4096, scale=0.02).T,
                  FP16, calls[(dense, (4096, 12800))], **per_verify),
        _gemm_row("verify 20x4096x1024 (k, v)", q(E4M3, 20, 4096),
                  q(E4M3, 1024, 4096, scale=0.02).T, FP16, calls[(dense, (4096, 1024))],
                  **per_verify),
        _gemm_row("verify 20x4096x4096 (q, o)", q(E4M3, 20, 4096),
                  q(E4M3, 4096, 4096, scale=0.02).T, FP16, calls[(dense, (4096, 4096))],
                  **per_verify),
        _gemm_row("verify logits 20x4096x49155 (table.T)", q(E4M3, 20, 4096), table.T, FP16,
                  calls[(dense, (4096, 49155))], **per_verify),
        _gemm_row(f"verify scores (4,8)x20x128x{ctx}", q(E4M3, 4, 8, 20, 128), keys, FP16,
                  calls[((4, 8, 20, 128), (4, 8, 128, ctx))], **per_verify),
        _gemm_row(f"verify values (4,8)x20x{ctx}x128", q(E4M3, 4, 8, 20, ctx),
                  keys.transpose(-1, -2), FP16, calls[((4, 8, 20, ctx), (4, 8, ctx, 128))],
                  **per_verify),
        _gemm_row("moe decode up/gate 4x1024x16384", q(E4M3, 4, 1024),
                  q(E4M3, 16384, 1024, scale=0.03).T, FP16, calls[((4, 1024), (1024, 16384))],
                  **per_draft),
        _gemm_row("moe decode down 4x16384x1024", q(E4M3, 4, 16384),
                  q(E4M3, 1024, 16384, scale=0.04).T, FP16, calls[((4, 16384), (16384, 1024))],
                  **per_draft),
        _gemm_row("moe catch-up up/gate 64x1024x16384", q(E4M3, 64, 1024),
                  q(E4M3, 16384, 1024, scale=0.03).T, FP16, calls[((64, 1024), (1024, 16384))]),
        _gemm_row("drafter decode logits 4x1024x49155 (table.T)", q(E4M3, 4, 1024), d_table.T,
                  FP16, calls[((4, 1, 1024), (1024, 49155))], **per_draft),
        # The MoE router: fp32, as in the reference, on the SIMT schedule.
        _gemm_row("moe decode router 4x1024x32, fp32", q(FP32, 4, 1024), router_w, FP32,
                  calls[((4, 1024), (1024, 32))], policy="fp32", **per_draft),
        _gemm_row("moe catch-up router 64x1024x32, fp32", q(FP32, 64, 1024), router_w, FP32,
                  calls[((64, 1024), (1024, 32))], policy="fp32"),
    ]
    del d_table
    return rows


def _copy_entry(counts):
    """The K-major copy at the train run's forward weight (4096 x 12800
    E4M3, N contiguous), widened to a (12800, 4096) fp16 buffer as the
    tensor-core schedule takes it above one row tile; bound by its bytes
    read and written once, beside ``t().contiguous()`` after ``half()``."""
    from repro_torch.core.precision import E4M3
    from repro_torch.kernels import redmule_gemm as rg
    from repro_torch.roofline import cost

    gen = torch.Generator(device="cuda").manual_seed(8)
    w = torch.randn((4096, 12800), generator=gen, device="cuda").to(E4M3)
    args = (w, 1, 1, 12800, 4096, [0, 0, 1, 12800], True)
    got = rg.kmajor_copy(*args)[0]
    want = rg.kmajor_copy_plain(*args)
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("the K-major copy differs from its plain version at the train shape")
    ms = time_ms(lambda: rg.kmajor_copy(*args), graph=True)
    plain_ms = time_ms(lambda: rg.kmajor_copy_plain(*args), iters=5)
    library_ms = time_ms(lambda: w.half().t().contiguous(), graph=True)
    bound = cost.transfer_cost([w], [got])
    return {
        "name": "kmajor_copy[4096x12800 e4m3 -> K-major fp16]", "route": "cuda",
        "source": "src/repro_torch/csrc/redmule_gemm_sr.cu",
        "replaces": "src/repro/kernels/redmule_gemm.py:110",
        "launches": counts["train_copies"], "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.bound_ms, "bound_by": bound.bound_by,
        "library_ms": library_ms,
    }


def _combine_entry(counts):
    """The split-K combine at the decode step's q projection (4 x 4096, 8
    splits of fp32 partials, fp16 out), bound by its bytes, beside
    ``sum`` over the split axis."""
    from repro_torch.core.precision import FP16
    from repro_torch.kernels import redmule_gemm as rg
    from repro_torch.roofline import cost

    gen = torch.Generator(device="cuda").manual_seed(9)
    ws = torch.randn((1, 8, 4, 4096), generator=gen, device="cuda")
    out = torch.empty((1, 4, 4096), dtype=FP16, device="cuda")
    rg.splitk_combine(ws, out)
    want = rg.splitk_combine_plain(ws, None, FP16)
    if not torch.equal(out.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("the split-K combine differs from its plain version")
    ms = time_ms(lambda: rg.splitk_combine(ws, out), graph=True)
    plain_ms = time_ms(lambda: rg.splitk_combine_plain(ws, None, FP16))
    library_ms = time_ms(lambda: ws.sum(1), graph=True)
    bound = cost.transfer_cost([ws], [out])
    return {
        "name": "splitk_combine[8 x 4x4096 fp32 -> fp16]", "route": "cuda",
        "source": "src/repro_torch/csrc/redmule_gemm_sr.cu",
        "replaces": "src/repro/kernels/redmule_gemm.py:110",
        "launches": counts["serve_combines"], "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound.bound_ms, "bound_by": bound.bound_by,
        "library_ms": library_ms,
    }


def _simt_entries(counts) -> list:
    """The SIMT schedule's rows off the model paths, each with the launches
    of its path (phase 3c's semiring paths; phase 7's fp32 run): apsp
    64x4096x12800 on E4M3 (h2, K split), one squaring of the 4096-node
    closures under fp32 (apsp, f32) and redmule_fp16 (max_capacity_path,
    h2), fp32 (mul, add) at the fp32 policy's widest product (f32, K split),
    and the split-K combine with min, bitwise against its plain version."""
    from repro_torch.core import semiring
    from repro_torch.core.precision import E4M3, FP16, FP32, cast
    from repro_torch.kernels import redmule_gemm as rg
    from repro_torch.roofline import cost

    paths = counts["simt_paths"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rand = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    d = _closure_graph(gen, "apsp")
    c = _closure_graph(gen, "max_capacity_path")
    rows = [
        _gemm_row("apsp 64x4096x12800 e4m3", cast(rand(64, 4096).half(), E4M3),
                  cast(rand(4096, 12800) * 4096 ** -0.5, E4M3), FP16,
                  paths["gemm_op apsp"]["h2"], op="apsp"),
        _gemm_row("apsp 4096x4096x4096 fp32 (closure squaring)", d, d, FP32,
                  paths["closure apsp"]["f32"], policy="fp32", op="apsp", y=d),
        _gemm_row("max_capacity_path 4096x4096x4096 fp16 (closure squaring)", c, c, FP16,
                  paths["closure max_capacity_path"]["h2"], policy="redmule_fp16",
                  op="max_capacity_path", y=c.float()),
        _gemm_row("fp32 64x4096x12800", rand(64, 4096), rand(4096, 12800) * 4096 ** -0.5, FP32,
                  counts["fp32_wide"], policy="fp32"),
    ]
    del d, c
    ws = rand(1, 4, 64, 12800)
    out = torch.empty((1, 64, 12800), dtype=FP16, device="cuda")
    rg.splitk_combine(ws, out, star=semiring.Op.MIN)
    if not same_bits(out, rg.splitk_combine_plain(ws, None, FP16, semiring.Op.MIN)):
        raise AssertionError("the min split-K combine differs from its plain version")
    bound = cost.transfer_cost([ws], [out])
    rows.append({
        "name": "splitk_combine[min, 4 x 64x12800 fp32 -> fp16]", "route": "cuda",
        "source": "src/repro_torch/csrc/redmule_gemm_sr.cu",
        "replaces": "src/repro/kernels/redmule_gemm.py:110",
        "launches": paths["gemm_op apsp"]["aux"], "max_abs_err": 0.0,
        "ms": time_ms(lambda: rg.splitk_combine(ws, out, star=semiring.Op.MIN), graph=True),
        "plain_ms": time_ms(lambda: rg.splitk_combine_plain(ws, None, FP16, semiring.Op.MIN)),
        "bound_ms": bound.bound_ms, "bound_by": bound.bound_by,
        "library_ms": time_ms(lambda: ws.amin(1), graph=True),
    })
    return rows


def _decode_row(counts, label, case, seed_note, window=None, softcap=None):
    """One paged-decode row: the kernel on the planner's split count, as a
    CUDA-graph replay (the card's time) and eager calls (the wrapper's host
    work included), beside the plain version and a gather of the pages plus
    ``scaled_dot_product_attention``, or with a softcap, which SDPA does not
    take, ``flex_attention`` (``_gather_flex``). Bound: ``roofline/cost.py``'s
    paged-decode count of these inputs."""
    import torch.nn.functional as F

    from repro_torch.core.precision import take_rows
    from repro_torch.kernels.flash_attention import (
        decode_splits,
        paged_flash_decode,
        paged_flash_decode_plain,
    )
    from repro_torch.roofline import cost

    q, kp, vp, pt, lens, act = case
    s, hq, hd = q.shape
    hkv, ps = kp.shape[1], 16
    qg = q.reshape(s, hkv, hq // hkv, hd)
    args = (qg, kp, vp, pt, lens, act)
    kw = dict(page_size=ps, window=window, softcap=softcap)
    got = paged_flash_decode(*args, **kw)
    want = paged_flash_decode_plain(*args, **kw)
    if not torch.allclose(got.float(), want.float(), rtol=DECODE_TOL[got.dtype],
                          atol=DECODE_TOL[got.dtype]):
        raise AssertionError(f"paged decode at {label} disagrees with its plain version")
    ms = time_ms(lambda: paged_flash_decode(*args, **kw), iters=100, graph=True)
    eager_ms = time_ms(lambda: paged_flash_decode(*args, **kw), iters=100)
    plain_ms = time_ms(lambda: paged_flash_decode_plain(*args, **kw), iters=5)

    n_tok = pt.shape[1] * ps
    read_idx = (pt.long()[:, :, None] * ps + torch.arange(ps, device="cuda")).reshape(s, n_tok)
    pos = torch.arange(n_tok, device="cuda")[None]
    mask = pos <= lens.long()[:, None]
    if window is not None:
        mask &= pos > lens.long()[:, None] - window
    mask = mask[:, None, None, :]

    def gather_sdpa():
        k = take_rows(kp, read_idx).half().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
        v = take_rows(vp, read_idx).half().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v, attn_mask=mask)

    library = gather_sdpa
    if softcap is not None:
        library = _gather_flex(q, kp, vp, read_idx, lens, window, softcap)
    library_err = float((library()[:, :, 0].float() - want.reshape(s, hq, hd).float())
                        .abs().max())
    library_ms = time_ms(library, iters=5)
    bound = cost.paged_decode_cost(q, kp, pt, lens, act, page_size=ps, window=window)
    return {
        "name": f"paged_flash_decode[{label}]", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/flash_attention.py:163",
        "launches": counts["decode"],
        "launches_per_decode_step": counts["decode_per_decode_step"],
        "launches_per_prefill": counts["decode_per_prefill"], "shape_note": seed_note,
        "splits": decode_splits(s, hkv, pt.shape[1], groups=-(-(hq // hkv) // 4)),
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound.bound_ms,
        "bound_by": bound.bound_by, "library_ms": library_ms, "library_max_abs_err": library_err,
        "library": "gather + " + ("flex_attention (softcap score_mod, compiled)"
                                  if softcap is not None else "scaled_dot_product_attention"),
    }


def _gather_flex(q, kp, vp, read_idx, lens, window, softcap):
    """The softcapped decode as one library call, which SDPA cannot give: a
    gather of the pages (as the SDPA rows time it) and ``flex_attention``
    compiled, the cap as its ``score_mod``, the lengths and the window as
    its block mask, the KV heads shared through ``enable_gqa``. Inductor
    writes its caches under ``build/``, beside the kernels'."""
    import os

    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    from repro_torch.core.precision import take_rows

    build = Path(__file__).resolve().parent / "build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    last = lens.long()

    def mask_mod(b, h, q_idx, kv_idx):
        live = kv_idx <= last[b]
        return live if window is None else live & (kv_idx > last[b] - window)

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    s = q.shape[0]
    n_tok = read_idx.shape[1]
    block_mask = create_block_mask(mask_mod, B=s, H=None, Q_LEN=1, KV_LEN=n_tok,
                                   device="cuda")
    flex = torch.compile(flex_attention, dynamic=False)

    def call():
        k = take_rows(kp, read_idx).half().permute(0, 2, 1, 3)
        v = take_rows(vp, read_idx).half().permute(0, 2, 1, 3)
        return flex(q[:, :, None, :], k, v, score_mod=score_mod, block_mask=block_mask,
                    enable_gqa=True)

    return call


def _decode_entries(counts) -> list:
    """The paged decode at the serving shape (phase 8's: 4 slots, lengths
    70/40/100/65, a 7-page table) and at the long-context shape (16 slots
    of 4096 tokens, 134 MB of E4M3 pages, beyond the 50 MB L2)."""
    rng = np.random.default_rng(2)
    serve = make_decode_case(
        rng, s=4, hq=32, hkv=8, hd=128, page_size=16, pages_per_slot=7, n_pages=29,
        dtype=torch.float8_e4m3fn, q_dtype=torch.float16, seq_lens=[70, 40, 100, 65])
    drafter = make_decode_case(
        rng, s=4, hq=16, hkv=8, hd=64, page_size=16, pages_per_slot=9, n_pages=37,
        dtype=torch.float8_e4m3fn, q_dtype=torch.float16, seq_lens=[70, 40, 100, 65])
    drafter_counts = {"decode": counts["spec_draft_decode"],
                      "decode_per_decode_step": counts["spec_draft_paged_per_step"],
                      "decode_per_prefill": 0}
    return [
        _decode_row(counts, "S4 Hq32 Hkv8 hd128 ps16 e4m3", serve, "the serve run's shape"),
        _decode_row(counts, "S16x4096 Hq32 Hkv8 hd128 ps16 e4m3", _long_decode_case(),
                    "long context, off the serve run"),
        _decode_row(drafter_counts, "S4 Hq16 Hkv8 hd64 ps16 e4m3", drafter,
                    "phase 13's drafter decode shape"),
    ]


def _family_entries(counts) -> list:
    """Phase 14's new decode shapes, one row each: the untied heads' and
    gemma2's tied logits (phi's 32064 columns end in half a 128-column
    tile), the dense-MoE's 102400-wide up/gate and its down, phi's fp32
    router, the widest dense decode layers of d 7168 and d 2304, and the
    paged decode at deepseek's 56/8 and chatglm's 32/2 heads and gemma2's
    hd 256 with softcap 50, windowed (its local layers) and not (its
    global ones), at lengths past the window. Each row reads its model's
    serve run alone (``_family_serve``): its launches over the run and a
    decode step's, by shape; the windowed row adds the long request's
    launches at 2 layers apart."""
    from repro_torch.core.precision import E4M3, FP16, FP32, cast

    runs = counts["families"]
    gen = torch.Generator(device="cuda").manual_seed(11)

    def q(fmt, *shape, scale=1.0):
        return cast(cast(torch.randn(shape, generator=gen, device="cuda") * scale, FP16), fmt)

    def w(k, n):  # a K-major E4M3 weight (K, N), as cfg.fp8_params stores it
        return q(E4M3, n, k, scale=k ** -0.5).T

    def gemm_counts(arch, m, k, n):
        run = runs[arch]
        return (sum(v for key, v in run["calls"].items() if key[:3] == (m, k, n)),
                {"launches_per_decode_step": sum(
                    v for key, v in run["step_calls"].items() if key[:3] == (m, k, n)),
                 "model": arch})

    rows = []
    for arch, label, k, n in (
            ("deepseek-coder-33b", "deepseek decode logits 4x7168x32256 (head)", 7168, 32256),
            ("chatglm3-6b", "chatglm decode logits 4x4096x65024 (head)", 4096, 65024),
            ("phi3.5-moe-42b-a6.6b", "phi decode logits 4x4096x32064 (head, ragged N)", 4096,
             32064),
            ("phi3.5-moe-42b-a6.6b", "phi moe decode up/gate 4x4096x102400", 4096, 102400),
            ("phi3.5-moe-42b-a6.6b", "phi moe decode down 4x102400x4096", 102400, 4096),
            ("deepseek-coder-33b", "deepseek decode 4x7168x19200 (gate, up)", 7168, 19200),
            ("gemma2-2b", "gemma decode 4x2304x9216 (gate, up)", 2304, 9216)):
        launches, extra = gemm_counts(arch, 4, k, n)
        rows.append(_gemm_row(label, q(E4M3, 4, k), w(k, n), FP16, launches, **extra))
    table = q(E4M3, 256000, 2304, scale=0.02)
    launches, extra = gemm_counts("gemma2-2b", 4, 2304, 256000)
    rows.append(_gemm_row("gemma decode logits 4x2304x256000 (table.T)", q(E4M3, 4, 2304),
                          table.T, FP16, launches, **extra))
    del table
    router = torch.randn((4096, 16), generator=gen, device="cuda") * 0.02
    launches, extra = gemm_counts("phi3.5-moe-42b-a6.6b", 4, 4096, 16)
    rows.append(_gemm_row("phi moe decode router 4x4096x16, fp32", q(FP32, 4, 4096), router,
                          FP32, launches, policy="fp32", **extra))
    rng = np.random.default_rng(12)
    serve_lens, long_lens = [70, 40, 100, 65], [4600, 4200, 5000, 300]
    for arch, label, hq, hkv, hd, window, cap, lens in (
            ("deepseek-coder-33b", "S4 Hq56 Hkv8 hd128 ps16 e4m3 (deepseek)", 56, 8, 128, None,
             None, serve_lens),
            ("chatglm3-6b", "S4 Hq32 Hkv2 hd128 ps16 e4m3 (chatglm)", 32, 2, 128, None, None,
             serve_lens),
            ("gemma2-2b", "S4 Hq8 Hkv4 hd256 ps16 e4m3 window 4096 softcap 50 (gemma local)", 8,
             4, 256, 4096, 50.0, long_lens),
            ("gemma2-2b", "S4 Hq8 Hkv4 hd256 ps16 e4m3 softcap 50 (gemma global)", 8, 4, 256,
             None, 50.0, long_lens)):
        pps = max(lens) // 16 + 1
        case = make_decode_case(rng, s=4, hq=hq, hkv=hkv, hd=hd, page_size=16,
                                pages_per_slot=pps, n_pages=4 * pps + 1, dtype=E4M3,
                                q_dtype=FP16, seq_lens=lens, window=window)
        key = (hq, hkv, hd, window, cap)
        c = {"decode": runs[arch]["decodes"][key],
             "decode_per_decode_step": runs[arch]["step_decodes"][key], "decode_per_prefill": 0}
        row = _decode_row(c, label, case, f"phase 14's decode, lengths {lens}",
                          window=window, softcap=cap)
        row["model"] = arch
        if window is not None:
            row["long_request_launches"] = runs["gemma2-2b long"][key]
        rows.append(row)
    return rows


def _recurrent_entries(counts) -> list:
    """Phase 15's new shapes, one row each, with launches read from its
    runs: recurrentgemma's decode GEMMs (an RG-LRU projection, the geglu
    FFN's up and down, the tied 256000-column logits; its fp16 weights are
    cast to E4M3 in each call, row-major, the tied table's transpose
    K-major), xlstm's mLSTM chunk products at the serve prefill's 64-token
    chunk (q C, q k^T and w v, batched over the 4 heads, E4M3) and its
    sLSTM recurrence (fp32, batched over the 4 gates and 4 heads) at
    decode, granite-moe's fp32 router backward pair at 2 x 1024 tokens
    (g W^T and X^T g), and the paged decode at recurrentgemma's one KV head
    for 10 query heads, hd 256, window 2048, at lengths past the window."""
    from repro_torch.core.precision import E4M3, FP16, FP32, cast

    runs = counts["recurrent"]
    gen = torch.Generator(device="cuda").manual_seed(13)

    def q(fmt, *shape, scale=1.0):
        return cast(cast(torch.randn(shape, generator=gen, device="cuda") * scale, FP16), fmt)

    def serve_counts(arch, m, k, n, schedule=None):
        def match(key):
            return key[:3] == (m, k, n) and schedule in (None, key[3])

        run = runs[arch]
        return (sum(v for key, v in run["calls"].items() if match(key)),
                {"launches_per_decode_step": sum(
                    v for key, v in run["step_calls"].items() if match(key)),
                 "model": arch})

    rows = []
    rg = "recurrentgemma-2b"
    for label, k, n in (("rglru decode projection 4x2560x2560", 2560, 2560),
                        ("recurrentgemma decode geglu up/gate 4x2560x7680", 2560, 7680),
                        ("recurrentgemma decode geglu down 4x7680x2560", 7680, 2560)):
        launches, extra = serve_counts(rg, 4, k, n)
        rows.append(_gemm_row(label, q(E4M3, 4, k), q(E4M3, k, n, scale=k ** -0.5), FP16,
                              launches, **extra))
    table = q(E4M3, 256000, 2560, scale=0.02)
    launches, extra = serve_counts(rg, 4, 2560, 256000)
    rows.append(_gemm_row("recurrentgemma decode logits 4x2560x256000 (table.T)",
                          q(E4M3, 4, 2560), table.T, FP16, launches, **extra))
    del table
    for label, m, k, n in (("mlstm prefill q.C (1x4)x64x192x192", 64, 192, 192),
                           ("mlstm prefill q.k^T (1x4)x64x192x64", 64, 192, 64),
                           ("mlstm prefill w.v (1x4)x64x64x192", 64, 64, 192)):
        launches, extra = serve_counts("xlstm-125m", m, k, n, "tc")
        rows.append(_gemm_row(label, q(E4M3, 1, 4, m, k), q(E4M3, 1, 4, k, n), FP16, launches,
                              **extra))
    # The recurrence reads each head's rows once for its four gates: x is
    # broadcast over the gate axis, as the model passes it.
    launches, extra = serve_counts("xlstm-125m", 4, 192, 192)
    rows.append(_gemm_row("slstm decode recurrence (4x4)x4x192x192, fp32",
                          q(FP32, 1, 4, 4, 192).expand(4, 4, 4, 192),
                          q(FP32, 4, 4, 192, 192, scale=192 ** -0.5), FP32, launches,
                          policy="fp32", **extra))
    moe = counts["moe_train_calls"]
    t, d, e = TRAIN_BATCH * TRAIN_SEQ, 1024, 32
    x = q(FP32, t, d)
    g = q(FP32, t, e, scale=1e-3)
    router = torch.randn((d, e), generator=gen, device="cuda") * 0.02
    for label, a, b in ((f"moe router backward g.W^T {t}x{e}x{d}, fp32", g, router.T),
                        (f"moe router backward X^T.g {d}x{t}x{e}, fp32", x.T, g)):
        launches = sum(v for key, v in moe.items() if key[:3] == (a.shape[0], a.shape[1],
                                                                  b.shape[1]))
        rows.append(_gemm_row(label, a, b, FP32, launches, policy="fp32",
                              model="granite-moe-1b-a400m (train)"))
    rng = np.random.default_rng(14)
    lens = [3000, 2600, 2200, 300]
    pps = max(lens) // 16 + 1
    case = make_decode_case(rng, s=4, hq=10, hkv=1, hd=256, page_size=16, pages_per_slot=pps,
                            n_pages=4 * pps + 1, dtype=E4M3, q_dtype=FP16, seq_lens=lens,
                            window=2048)
    key = (10, 1, 256, 2048, None)
    c = {"decode": runs[rg]["decodes"][key],
         "decode_per_decode_step": runs[rg]["step_decodes"][key], "decode_per_prefill": 0}
    row = _decode_row(c, "S4 Hq10 Hkv1 hd256 ps16 e4m3 window 2048 (recurrentgemma, MQA)", case,
                      f"phase 15's decode, lengths {lens}", window=2048)
    row["model"] = rg
    row["long_request_launches"] = sum(runs["recurrentgemma-2b long"].values())
    rows.append(row)
    return rows


def _spec_state_entries(counts) -> list:
    """Phase 16's new shapes, one row each, launches read from (b)'s runs
    (each graph step's eager forwards and replays, by shape): recurrentgemma's
    verify and commit GEMMs at 4 slots x 5 positions (its fp16 weights cast
    to E4M3 in the call, row-major), and xlstm's sLSTM recurrence (fp32) in
    the verify, commit and drafter steps."""
    from repro_torch.core.precision import E4M3, FP16, FP32, cast

    runs = counts["spec_state"]
    gen = torch.Generator(device="cuda").manual_seed(16)

    def q(fmt, *shape, scale=1.0):
        return cast(cast(torch.randn(shape, generator=gen, device="cuda") * scale, FP16), fmt)

    rg = runs[("recurrentgemma-2b", False)]["forwards"]
    rows = []
    for label, k, n in (("rglru verify/commit projection 20x2560x2560", 2560, 2560),
                        ("recurrentgemma verify/commit geglu up/gate 20x2560x7680", 2560, 7680),
                        ("recurrentgemma verify/commit geglu down 20x7680x2560", 7680, 2560)):
        rows.append(_gemm_row(label, q(E4M3, 20, k), q(E4M3, k, n, scale=k ** -0.5), FP16,
                              rg[((4, 5, k), (k, n))], model="recurrentgemma-2b (spec k=4)"))
    table = q(E4M3, 256000, 2560, scale=0.02)
    rows.append(_gemm_row("recurrentgemma verify/commit logits 20x2560x256000 (table.T)",
                          q(E4M3, 20, 2560), table.T, FP16, rg[((4, 5, 2560), (2560, 256000))],
                          model="recurrentgemma-2b (spec k=4)"))
    del table
    launches = sum(c for run in (runs[("xlstm-125m", False)], runs[("xlstm-125m", True)])
                   for (x, w), c in run["forwards"].items() if w == (4, 4, 192, 192))
    rows.append(_gemm_row("slstm spec recurrence (4x4)x4x192x192, fp32 (verify, commit, drafter)",
                          q(FP32, 1, 4, 4, 192).expand(4, 4, 4, 192),
                          q(FP32, 4, 4, 192, 192, scale=192 ** -0.5), FP32, launches,
                          policy="fp32", model="xlstm-125m (spec k=4)"))
    return rows


def _encdec_entries(counts) -> list:
    """Phase 17's new shapes, one row each, launches read from (b)'s
    launcher runs by (M, K, N): seamless's encoder and cross-attention
    products at prefill (the 4 x 16 heads of hd 64, non-causal; the cross
    values over the 256 frames), its decode FFN and its tied 256206-column
    logits (2001.6 tiles of 128), and internvl2's 4 x 8192 x 28672 decode
    rows, its untied 128256-column head and its GQA group of 8 (hd 128)
    over the 336-position ring."""
    from repro_torch.core.precision import E4M3, FP16, cast

    calls = counts["encdec_calls"]  # by arch: (4, 8192, 1024) is both models' shape
    gen = torch.Generator(device="cuda").manual_seed(17)

    def q(fmt, *shape, scale=1.0):
        return cast(cast(torch.randn(shape, generator=gen, device="cuda") * scale, FP16), fmt)

    def w(k, n):  # a K-major E4M3 weight (K, N), as cfg.fp8_params stores it
        return q(E4M3, n, k, scale=k ** -0.5).T

    def n_calls(arch, m, k, n):
        return sum(v for key, v in calls[arch].items() if key[:3] == (m, k, n))

    sm, iv = ENCDEC
    ring = 256 + 64 + MAX_NEW
    rows = []
    for label, b, h, m, k, n in (("seamless encoder scores (4,16)x256x64x256", 4, 16, 256, 64,
                                  256),
                                 ("seamless encoder values (4,16)x256x256x64", 4, 16, 256, 256,
                                  64),
                                 ("seamless cross scores (4,16)x64x64x256", 4, 16, 64, 64, 256),
                                 ("seamless cross values (4,16)x64x256x64", 4, 16, 64, 256, 64),
                                 (f"internvl2 decode scores (4,8)x8x128x{ring} (GQA group 8)", 4,
                                  8, 8, 128, ring),
                                 (f"internvl2 decode values (4,8)x8x{ring}x128", 4, 8, 8, ring,
                                  128)):
        arch = sm if "seamless" in label else iv
        rows.append(_gemm_row(label, q(E4M3, b, h, m, k), q(E4M3, b, h, k, n), FP16,
                              n_calls(arch, m, k, n), model=arch))
    for label, k, n, model in (("seamless decode ffn up 4x1024x8192", 1024, 8192, sm),
                               ("seamless decode ffn down 4x8192x1024", 8192, 1024, sm),
                               ("internvl2 decode 4x8192x28672 (gate, up)", 8192, 28672, iv),
                               ("internvl2 decode down 4x28672x8192", 28672, 8192, iv),
                               ("internvl2 decode logits 4x8192x128256 (head)", 8192, 128256,
                                iv)):
        rows.append(_gemm_row(label, q(E4M3, 4, k), w(k, n), FP16, n_calls(model, 4, k, n),
                              model=model))
    table = q(E4M3, 256206, 1024, scale=0.02)
    rows.append(_gemm_row("seamless decode logits 4x1024x256206 (table.T, ragged N)",
                          q(E4M3, 4, 1024), table.T, FP16, n_calls(sm, 4, 1024, 256206),
                          model=sm))
    del table
    return rows


def _flash_entry(counts):
    """The dense flash attention at granite's training shape in fp16
    (causal), on the route ``plan_flash`` names (the tensor cores), as a
    CUDA-graph replay with eager calls beside, bound by ``roofline/cost.py``'s
    count, beside ``scaled_dot_product_attention`` on the same q and the KV
    heads expanded for it."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
        plan_flash,
    )
    from repro_torch.roofline import cost

    b, s, hq, hkv, hd = 1, 2048, 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = _flash_inputs(gen, b, s, s, hq, hkv, hd, torch.float16)
    route = plan_flash(q, k, v)
    got = flash_attention(q, k, v)
    want = flash_attention_plain(q, k, v)
    ms = time_ms(lambda: flash_attention(q, k, v), graph=True)
    eager_ms = time_ms(lambda: flash_attention(q, k, v))
    plain_ms = time_ms(lambda: flash_attention_plain(q, k, v), iters=5)
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound = cost.flash_attention_cost(q, k, v, causal=True)
    source = {"tc": "flash_attention_tc.cu", "simt": "flash_attention.cu"}[route]
    return {
        "name": f"flash_attention[B{b} S{s} Hq{hq} Hkv{hkv} hd{hd} causal fp16]", "route": "cuda",
        "source": f"src/repro_torch/csrc/{source}", "schedule": route,
        "replaces": "src/repro/kernels/flash_attention.py:254",
        "launches": counts["dense"],
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": bound.bound_ms,
        "bound_by": bound.bound_by, "library_ms": library_ms,
        "tflop_s": bound.flops / ms / 1e9,
    }


def _log_entry(e) -> None:
    lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
    extra = ""
    if "split" in e:
        smm = "none" if e["scaled_mm_ms"] is None else f"{e['scaled_mm_ms']:.4f} ms"
        form = f" {e['form']}" if "form" in e else ""
        extra = (f"; schedule {e['schedule']}{form} (split {e['split']}, "
                 f"{e['aux_launches_per_call']} "
                 f"auxiliary launches a call), eager calls {e['eager_ms']:.4f} ms, "
                 f"_scaled_mm {smm}, {e['tflop_s']:.1f} TFLOP/s, "
                 f"{e['share_differ']:.2%} of outputs differ"
                 + ("" if e["worst_ulps"] is None else f", worst {e['worst_ulps']} ulp"))
    elif "eager_ms" in e:
        extra = f"; eager calls {e['eager_ms']:.4f} ms"
        if "splits" in e:
            extra += f", {e['splits']} split(s), {e['shape_note']}"
        if "schedule" in e:
            extra += f", route {e['schedule']}, {e['tflop_s']:.1f} TFLOP/s"
    log(f"{e['name']}: {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} ms by {e['bound_by']}, "
        f"plain {e['plain_ms']:.4f} ms, library {lib}, max|d| {e['max_abs_err']:.3g}{extra})")


def phase_kernel_line(counts, paper_rows=()) -> list:
    entries = [*_gemm_entries(counts), *_simt_entries(counts), *_decode_entries(counts),
               _flash_entry(counts), *_family_entries(counts), *_recurrent_entries(counts),
               *_spec_state_entries(counts), *_encdec_entries(counts), *paper_rows]
    for e in entries:
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']} was not launched on its main path")
        _log_entry(e)
    return entries


def main() -> int:
    t0 = time.perf_counter()
    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        phase_build()
        phase_gemm()
        phase_gemm_schedules()
        counts = phase_simt()
        phase_decode()
        counts |= phase_flash()
        phase_backward_gemm()
        counts |= phase_slice_parity()
        _timed("phase 18(a)", phase_obs_slice)
        cfg, model, params = _serve_model()
        counts |= phase_serve(cfg, model, params)
        counts |= phase_serving_features(cfg, model, params)
        _timed("phase 18(b) tracer on/off", phase_obs_serve, cfg, model, params)
        counts |= phase_spec(cfg, model, params)
        del model, params
        torch.cuda.empty_cache()
        counts |= phase_families()
        counts |= phase_recurrent()
        counts |= phase_spec_state()
        counts |= phase_encdec()
    phase_train_parity()
    train = phase_train()
    phase_families_train()
    counts |= phase_recurrent_train()
    phase_encdec_train()
    _timed("phase 19(a)", phase_examples)
    with torch.inference_mode():
        paper_rows = _timed("phase 19(b)", phase_paper_gemms)
    counts |= {"train_gemm": train["gemm"], "train_gemm_per_step": train["gemm_per_step"],
               "train_copies": train["copies"]}
    with torch.inference_mode():
        entries = phase_kernel_line(counts, paper_rows)
    log(f"card: {card}; the whole run {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
