#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the port's CUDA sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together);
3. the GEMM-Op kernel against its plain PyTorch version, on the card:
   all seven Table-1 ops, ragged, batched, broadcast and transposed
   operands, and the serving path's shapes, each with the schedule it
   takes and the share of its outputs that differ from the plain version;
   then each schedule (tensor cores, small rows, SIMT) at its edges: the
   rows around the small-row threshold, K-major and strided operands (the
   latter through the K-major copy), K not a multiple of 128, the E5M2
   pairs, the 16-bit forms; two exact-sum cases that must be bitwise
   equal, a planted dropped K tile per schedule that must fail, a decode
   GEMM run twice that must give the same bits, and the two auxiliary
   kernels (K-major copy, split-K combine) bitwise against their plain
   versions;
4. the paged flash-decode kernel against its plain version, then its split
   page walk at its edges: 64-page tables with lengths ending in the first
   split, on a split boundary and in the last, whole splits dead by
   length, by NULL pages and by the window, an inactive slot and softcap
   with splits, the long-context shape (16 slots of 4096 tokens), and one
   case run twice, which must give the same bits;
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
   port's ``Server``, with the kernels' launch counts read around every
   prefill and decode step: each decode GEMM on the small-row schedule,
   each prefill GEMM on the tensor cores but the last token's logits, one
   paged-decode launch a layer a decode step (and its split count);
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
    every (mul, add) shape of both paths, with ``torch._scaled_mm`` beside
    ``torch.matmul`` where its shape rules allow, and its schedule; the
    paged decode at the serving and the long-context shape, as CUDA-graph
    replays with eager calls beside; the dense attention with its route).

The last line is ``{"ok": true, "device": {...}}``. The script imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
FP16_FLOP_S = 989e12  # H100 SXM dense fp16 tensor-core peak
FP8_FLOP_S = 1979e12  # H100 SXM dense fp8 tensor-core peak
FP32_FLOP_S = 67e12  # H100 SXM fp32 peak outside the tensor cores

GEMM_TOL = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 1.6e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))


def mma_peak(*operands: torch.Tensor) -> float:
    """The tensor-core peak for these (mul, add) operands: fp8 when every
    operand is fp8 (E4M3 or E5M2, exact products summed in fp32, as the
    fp8 tensor cores do), else fp16."""
    from repro_torch.core.precision import FP8_DTYPES

    return FP8_FLOP_S if all(t.dtype in FP8_DTYPES for t in operands) else FP16_FLOP_S


def time_ms(fn, iters: int = 20, graph: bool = False) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls.
    With ``graph`` the calls are captured once in a CUDA graph and the
    graph is replayed, so the time is the card's alone: the GEMM wrapper
    plans on the host for longer than its small-row kernels run, which
    eager calls would time instead."""
    for _ in range(3):
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
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got.float(), want.float()):
            raise AssertionError(f"{label}: min/max op not bitwise, max|dz| = {err}")
    return err


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
    main = {
        "decode 4x4096x12800": (rand(4, 4096), rand(4096, 12800, scale=4096 ** -0.5)),
        "prefill 64x4096x12800": (rand(64, 4096), rand(4096, 12800, scale=4096 ** -0.5)),
        "logits 1x4096x49155 (table.T)": (rand(1, 4096), table.T),
        "scores (1,8)x384x128x96": (rand(1, 8, 4 * 96, 128), k),
        "values (1,8)x384x96x128": (torch.rand(1, 8, 4 * 96, 96, generator=gen, device=dev),
                                    rand(1, 8, 96, 128)),
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
    worst = {dt: 0.0 for dt in DECODE_TOL}
    for (s, hq, hkv, hd, ps, pps, npg, dt, win, inact), cap in cases:
        q, kp, vp, pt, lens, act = make_decode_case(
            rng, s=s, hq=hq, hkv=hkv, hd=hd, page_size=ps, pages_per_slot=pps,
            n_pages=npg, dtype=dt, window=win, inactive=inact,
            q_dtype=torch.float16 if hd == 128 else torch.float32)
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
        out.append(model.prefill_cb(params, toks, pools, page_table[slot], 0, len(p),
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


def phase_slice_parity() -> None:
    """granite-3-8b at full width, 2 layers: the kernels' path against the
    plain path on the card, fed the same tokens. The bound holds the plain
    path with the paged attention's plain version (fp32 over dequantized
    pages, the kernel's semantics). The plain gathered decode, which rounds
    q and the probabilities to E4M3 in its engine GEMMs under an fp8
    policy, is printed beside it; the JAX package's XLA and Pallas decode
    paths differ the same way (tests/test_torch_model.py holds each of the
    port's two paths against the reference's path of the same semantics).

    Under redmule_hfp8 with E4M3 weights the two paths agree bit for bit:
    every E4M3 product is exact in fp16, both sides sum in fp32 and round
    once to fp16, and the run is deterministic. Its bound is therefore 0:
    any difference means one side changed its arithmetic, and one E4M3
    rounding flipped by it reaches the logits."""
    from repro_torch.configs import get_config
    from repro_torch.engine import Engine
    from repro_torch.models import build
    from repro_torch.models.transformer import Transformer

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 49155, size=n) for n in (64, 32)]
    page_table = torch.zeros((2, 8), dtype=torch.int32, device="cuda")
    page_table[0, :5] = torch.arange(1, 6)
    page_table[1, :3] = torch.arange(6, 9)
    for pol, kv, fp8p, bound in (("fp32", "fp32", False, 1e-4),
                                 ("redmule_hfp8", "e4m3", True, 0.0)):
        cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2, policy=pol,
                                  kv_cache_dtype=kv, fp8_params=fp8p)
        cuda_model = build(cfg, device="cuda")
        params = cuda_model.init(0)
        plain = Engine(policy=pol, backend="torch")
        fused = Transformer(cfg, engine=plain, device="cuda", fused_decode=True)
        gather = Transformer(cfg, engine=plain, device="cuda")
        got, chosen = _slice_run(cuda_model, params, prompts, page_table)
        forced = chosen[:-1]  # decode step i was fed chosen[i]
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"slice parity {pol}: non-finite logits on the kernels' path")
        errs = {}
        for name, model in (("plain", fused), ("plain, gathered decode", gather)):
            want, _ = _slice_run(model, params, prompts, page_table, forced=forced)
            errs[name] = ([rel_err(a, b) for a, b in zip(got[:2], want[:2])],
                          [rel_err(a, b) for a, b in zip(got[2:], want[2:])])
        for name, (pre, dec) in errs.items():
            log(f"slice parity {pol} vs {name}: max|dlogit|/max|logit| prefill "
                f"{max(pre):.3g}, decode {max(dec):.3g}")
        worst = max(max(errs["plain"][0]), max(errs["plain"][1]))
        if pol == "fp32":
            worst = max(worst, max(errs["plain, gathered decode"][1]))
        if not worst <= bound:
            raise AssertionError(f"slice parity {pol}: {worst:.3g} > {bound}")
        log(f"slice parity {pol}: {worst:.3g} within {bound:g}")
        del cuda_model, fused, gather, params
        torch.cuda.empty_cache()


# -- phase 8 ---------------------------------------------------------------------


# What each serve step reading holds: GEMM-Op calls, paged-decode launches,
# then the GEMM's launches by schedule and its auxiliary launches.
READING = ("gemm", "paged decode", "simt", "tensor-core", "small-row", "aux")


def _launch_counts() -> tuple:
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels import redmule_gemm as rg

    return (rg.launches.n, flash_attention.launches.n, rg.simt_launches.n, rg.tc_launches.n,
            rg.small_row_launches.n, rg.aux_launches.n)


def _count_launches(engine, readings: dict) -> None:
    """Record the kernels' launch counts (``READING``) over each prefill and
    each decode step that ``engine`` dispatches: the difference of the
    counters around the dispatch (the wrappers count on the host as they
    launch)."""
    def counted(kind, dispatch):
        def run(**kw):
            before = _launch_counts()
            dispatch(**kw)
            readings[kind].append(tuple(a - b for a, b in zip(_launch_counts(), before)))
        return run

    engine.dispatch_prefill = counted("prefill", engine.dispatch_prefill)
    engine.dispatch_decode = counted("decode", engine.dispatch_decode)


def _one_reading(kind: str, readings: list, expect: tuple) -> tuple:
    """The launch counts of every ``kind`` step, all of which must be
    ``expect`` (every entry of ``READING`` but the auxiliary launches)."""
    seen = sorted({r[:-1] for r in readings})
    if seen != [expect]:
        raise AssertionError(f"serve: {READING[:-1]} launches per {kind}: {seen}, "
                             f"expected {expect} every time")
    return expect


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, redmule_gemm
    from repro_torch.launch.serve import mixed_prompt_lens
    from repro_torch.models import build
    from repro_torch.serving import SamplingParams, Server, ServerConfig

    cfg = dataclasses.replace(get_config("granite-3-8b"), policy="redmule_hfp8",
                              kv_cache_dtype="e4m3", fp8_params=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    log(f"serve: granite-3-8b {cfg.n_layers} layers d{cfg.d_model}, E4M3 weights made "
        f"in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in mixed_prompt_lens(64, 8)]
    max_new = 16
    server = Server(model, params, ServerConfig(
        num_slots=4, page_size=16, max_seq_len=max(map(len, prompts)) + max_new,
        prefill_bucket=32), seed=0)
    for i, p in enumerate(prompts):
        sampling = SamplingParams(temperature=0.8) if i == 5 else SamplingParams()
        server.submit(p, max_new_tokens=max_new, sampling=sampling)
    readings = {"prefill": [], "decode": []}
    _count_launches(server.engine, readings)
    for counter in (redmule_gemm.launches, flash_attention.launches, redmule_gemm.simt_launches,
                    redmule_gemm.tc_launches, redmule_gemm.small_row_launches,
                    redmule_gemm.aux_launches):
        counter.reset()
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
    # Every dense layer is one GEMM launch: 7 a layer (q, k, v, o, gate, up,
    # down) plus the logits; a prefill adds its two attention products a
    # layer, and a decode step its one paged-decode launch a layer. Every
    # decode GEMM has 4 rows (the slots) and runs on the small-row schedule;
    # every prefill GEMM runs on the tensor cores but the logits of the
    # prompt's last token, one row, which takes the small-row schedule.
    n_layers = cfg.n_layers
    if (len(readings["decode"]), len(readings["prefill"])) != (s.decode_steps, s.prefill_calls):
        raise AssertionError(f"serve: {len(readings['decode'])} decode steps and "
                             f"{len(readings['prefill'])} prefills read, {s.decode_steps} and "
                             f"{s.prefill_calls} run")
    per_decode = _one_reading("decode step", readings["decode"],
                              (7 * n_layers + 1, n_layers, 0, 0, 7 * n_layers + 1))
    per_prefill = _one_reading("prefill", readings["prefill"],
                               (9 * n_layers + 1, 0, 0, 9 * n_layers, 1))
    totals = tuple(sum(r[i] for v in readings.values() for r in v) for i in range(len(READING)))
    if (gemm_n, decode_n) != totals[:2]:
        raise AssertionError(f"serve: launches gemm {gemm_n}, paged decode {decode_n} over the run "
                             "differ from the sum over its steps")
    aux = {kind: sorted({r[-1] for r in readings[kind]}) for kind in readings}
    mem = torch.cuda.max_memory_allocated()
    log(f"serve: {len(results)} requests, {s.decode_tokens} decode tokens in {s.decode_steps} "
        f"steps, {s.prefill_calls} prefills; decode {s.decode_tok_s:.1f} tok/s, "
        f"prefill {s.prefill_s:.3f} s, decode {s.decode_s:.3f} s, wall {wall:.3f} s, "
        f"utilization {s.utilization:.0%}, max memory {mem / 1e9:.2f} GB")
    log(f"serve: launches gemm {gemm_n}, paged decode {decode_n}; measured at each of "
        f"{s.decode_steps} decode steps: gemm {per_decode[0]}, paged decode {per_decode[1]}; "
        f"at each of {s.prefill_calls} prefills: gemm {per_prefill[0]}, "
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
    del server, model, params
    torch.cuda.empty_cache()
    return {"gemm": gemm_n, "decode": decode_n,
            "gemm_per_decode_step": per_decode[0], "gemm_per_prefill": per_prefill[0],
            "decode_per_decode_step": per_decode[1], "decode_per_prefill": per_prefill[1],
            "serve_tc": totals[3], "serve_small_row": totals[4],
            "serve_combines": sum(r[-1] for r in readings["decode"])}


# -- phase 9 ---------------------------------------------------------------------

# The train run of phase 10; phase 9 holds one step at its batch.
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 1024, 2, 4

# Bounds of the train-parity phase, relative: (loss, grad norm, worst
# per-tensor |dg| / |g| in norm). Under redmule_hfp8 both paths give the
# same bits (PERF.md): every product is exact in fp32 and both round its
# fp32 sum once to fp16, so any difference means one path changed its
# arithmetic, and the bound is 0, as in serving parity.
TRAIN_PARITY_BOUND = {"fp32": (1e-5, 1e-4, 1e-3), "redmule_hfp8": (0.0, 0.0, 0.0)}


def _step_grads(model, params, tokens, backend):
    """Loss and gradients of one train step's loss function on ``backend``."""
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.training import make_loss_fn

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = make_loss_fn(model, backend=backend)(live, {"tokens": tokens})
    grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def phase_train_parity() -> None:
    """granite-3-8b at full width, 2 layers, remat "block", one step's loss
    and gradients on the train run's 2 x 1024 tokens (so every forward and
    backward GEMM shape of phase 10 is compared): the kernels' path ("cuda": every
    forward GEMM and both backward GEMMs of each on the GEMM-Op kernel)
    against the plain path ("torch") on the card, from the same parameters
    and batch, under fp32 and redmule_hfp8."""
    from repro_torch.configs import get_config
    from repro_torch.data import for_model
    from repro_torch.models import build
    from repro_torch.optim import global_norm

    for pol, (b_loss, b_gnorm, b_grad) in TRAIN_PARITY_BOUND.items():
        cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=2, policy=pol,
                                  remat="block")
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
        log(f"train parity {pol}: loss {loss:.6f} vs {want_loss:.6f} (rel {d_loss:.3g}), "
            f"grad norm {gnorm:.6f} vs {want_gnorm:.6f} (rel {d_gnorm:.3g}), worst per-tensor "
            f"|dg|/|g| {max(per_tensor):.3g} (max|dg|/max|g| {worst_max:.3g}) over {len(grads)} "
            f"tensors; bounds {b_loss:g} / {b_gnorm:g} / {b_grad:g}")
        if not all(np.isfinite([loss, want_loss, gnorm, want_gnorm])):
            raise AssertionError(f"train parity {pol}: non-finite loss or grad norm")
        if not (d_loss <= b_loss and d_gnorm <= b_gnorm and max(per_tensor) <= b_grad):
            raise AssertionError(f"train parity {pol}: outside its bounds")
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


def _gemm_row(label, x, w, out_dtype, launches, **extra):
    """One (mul, add) row of the kernel line under redmule_hfp8: the kernel
    on its planned schedule (device time from a CUDA-graph replay), the
    plain version, torch.matmul on the widened fp16 operands and
    torch._scaled_mm on the fp8 ones. Bound: each operand byte read once
    and the output written once at 3.35 TB/s, against 2*M*K*N operations
    (per batch) at the fp8 tensor-core peak."""
    from repro_torch.core import semiring
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import redmule_gemm as rg

    pol = get_policy("redmule_hfp8")
    kw = dict(gop=semiring.MATMUL, policy=pol, out_dtype=out_dtype)
    plan = rg.plan_call(x, w, None, gop=semiring.MATMUL, policy=pol).plan
    aux0 = rg.aux_launches.n
    got = rg.redmule_gemm(x, w, None, **kw)
    aux = rg.aux_launches.n - aux0
    want = rg.redmule_gemm_plain(x, w, None, **kw)
    big = x.numel() * w.shape[-1] > 1 << 32
    ms = time_ms(lambda: rg.redmule_gemm(x, w, None, **kw), iters=5 if big else 20, graph=True)
    # Eager calls, timed the same way: where this exceeds ``ms`` the wrapper's
    # host work (planning, allocation, the ctypes launch) paces the calls.
    eager_ms = time_ms(lambda: rg.redmule_gemm(x, w, None, **kw), iters=5 if big else 20)
    plain_ms = time_ms(lambda: rg.redmule_gemm_plain(x, w, None, **kw), iters=5)
    x16, w16 = x.half(), w.half()
    library_ms = time_ms(lambda: torch.matmul(x16, w16), iters=5 if big else 20, graph=True)
    scaled_ms = _scaled_mm_ms(x, w, out_dtype)
    m, k = x.shape[-2:]
    n = w.shape[-1]
    batch = got.numel() // (m * n)
    nbytes = sum(t.numel() * t.element_size() for t in (x, w, got))
    ops = 2.0 * batch * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / mma_peak(x, w) * 1e3
    share, ulps = ulp_spread(got, want)
    return {
        "name": f"redmule_gemm[{label}]", "route": "cuda", "source": GEMM_SOURCE[plan.schedule],
        "replaces": "src/repro/kernels/redmule_gemm.py:110",
        "launches": launches, **extra, "schedule": plan.schedule, "split": plan.split,
        "aux_launches_per_call": aux,
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "share_differ": share, "worst_ulps": ulps,
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "scaled_mm_ms": scaled_ms,
        "tflop_s": ops / ms / 1e9,
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
        _gemm_row("train forward 2048x4096x12800", q(E4M3, 2048, 4096),
                  q(E4M3, 4096, 12800, scale=4096 ** -0.5), FP16, train, **per_step),
    ]
    for label, (a, b) in _backward_pairs(torch.Generator(device="cuda").manual_seed(6)).items():
        entries.append(_gemm_row(f"backward {label}", a, b, FP16, train, **per_step))
    del table
    entries += [_copy_entry(counts), _combine_entry(counts)]
    return entries


def _copy_entry(counts):
    """The K-major copy at the train run's forward weight (4096 x 12800
    E4M3, N contiguous), widened to a (12800, 4096) fp16 buffer as the
    tensor-core schedule takes it above one row tile; bound by its bytes
    read and written once, beside ``t().contiguous()`` after ``half()``."""
    from repro_torch.core.precision import E4M3
    from repro_torch.kernels import redmule_gemm as rg

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
    t_bytes = 3 * w.numel() / HBM_BYTES_S * 1e3
    return {
        "name": "kmajor_copy[4096x12800 e4m3 -> K-major fp16]", "route": "cuda",
        "source": "src/repro_torch/csrc/redmule_gemm_sr.cu",
        "replaces": "src/repro/kernels/redmule_gemm.py:110",
        "launches": counts["train_copies"], "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bytes, "bound_by": "bytes",
        "library_ms": library_ms,
    }


def _combine_entry(counts):
    """The split-K combine at the decode step's q projection (4 x 4096, 8
    splits of fp32 partials, fp16 out), bound by its bytes, beside
    ``sum`` over the split axis."""
    from repro_torch.core.precision import FP16
    from repro_torch.kernels import redmule_gemm as rg

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
    t_bytes = (ws.numel() * 4 + out.numel() * 2) / HBM_BYTES_S * 1e3
    return {
        "name": "splitk_combine[8 x 4x4096 fp32 -> fp16]", "route": "cuda",
        "source": "src/repro_torch/csrc/redmule_gemm_sr.cu",
        "replaces": "src/repro/kernels/redmule_gemm.py:110",
        "launches": counts["serve_combines"], "max_abs_err": 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": t_bytes, "bound_by": "bytes",
        "library_ms": library_ms,
    }


def _apsp_entry():
    """One semiring pair on the SIMT schedule, off every model path, timed
    for PERF.md: apsp at 64x4096x12800 on E4M3, bitwise against the plain
    version, bound by its operations at the CUDA cores' fp32 peak."""
    from repro_torch.core import semiring
    from repro_torch.core.precision import cast, get_policy
    from repro_torch.kernels.redmule_gemm import redmule_gemm, redmule_gemm_plain

    pol = get_policy("redmule_hfp8")
    gen = torch.Generator(device="cuda").manual_seed(1)
    m, k, n = 64, 4096, 12800
    xq = cast(torch.randn((m, k), generator=gen, device="cuda").half(), pol.storage_fwd)
    wq = cast(torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5, pol.storage_fwd)
    kw = dict(gop=semiring.get("apsp"), policy=pol, out_dtype=pol.out)
    got = redmule_gemm(xq, wq, None, **kw)
    want = redmule_gemm_plain(xq, wq, None, **kw)
    ms = time_ms(lambda: redmule_gemm(xq, wq, None, **kw), graph=True)
    plain_ms = time_ms(lambda: redmule_gemm_plain(xq, wq, None, **kw), iters=5)
    nbytes = xq.numel() + wq.numel() + got.numel() * got.element_size()
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, 2.0 * m * k * n / FP32_FLOP_S * 1e3
    return {
        "name": f"redmule_gemm[apsp {m}x{k}x{n}]", "route": "cuda",
        "source": GEMM_SOURCE["simt"], "replaces": "src/repro/kernels/redmule_gemm.py:110",
        "launches": 0, "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None,
    }


def _decode_row(counts, label, case, seed_note):
    """One paged-decode row: the kernel on the planner's split count, as a
    CUDA-graph replay (the card's time) and eager calls (the wrapper's host
    work included), beside the plain version and a gather of the pages plus
    ``scaled_dot_product_attention``. Bound: the live pages' K and V bytes,
    q, out, the page table and the lengths, each moved once, at 3.35 TB/s,
    against 4 * Hq * (len + 1) * hd operations a slot at the fp32 peak."""
    import torch.nn.functional as F

    from repro_torch.core.precision import take_rows
    from repro_torch.kernels.flash_attention import (
        decode_splits,
        paged_flash_decode,
        paged_flash_decode_plain,
    )

    q, kp, vp, pt, lens, act = case
    s, hq, hd = q.shape
    hkv, ps = kp.shape[1], 16
    qg = q.reshape(s, hkv, hq // hkv, hd)
    args = (qg, kp, vp, pt, lens, act)
    got = paged_flash_decode(*args, page_size=ps)
    want = paged_flash_decode_plain(*args, page_size=ps)
    if not torch.allclose(got.float(), want.float(), rtol=DECODE_TOL[got.dtype],
                          atol=DECODE_TOL[got.dtype]):
        raise AssertionError(f"paged decode at {label} disagrees with its plain version")
    ms = time_ms(lambda: paged_flash_decode(*args, page_size=ps), iters=100, graph=True)
    eager_ms = time_ms(lambda: paged_flash_decode(*args, page_size=ps), iters=100)
    plain_ms = time_ms(lambda: paged_flash_decode_plain(*args, page_size=ps), iters=5)

    n_tok = pt.shape[1] * ps
    read_idx = (pt.long()[:, :, None] * ps + torch.arange(ps, device="cuda")).reshape(s, n_tok)
    mask = (torch.arange(n_tok, device="cuda")[None] <= lens.long()[:, None])[:, None, None, :]

    def gather_sdpa():
        k = take_rows(kp, read_idx).half().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
        v = take_rows(vp, read_idx).half().permute(0, 2, 1, 3).repeat_interleave(hq // hkv, 1)
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v, attn_mask=mask)

    library_ms = time_ms(gather_sdpa, iters=5)
    lens_list = lens.tolist()
    live_pages = sum(int(n) // ps + 1 for n in lens_list)
    nbytes = (2 * live_pages * ps * hkv * hd * kp.element_size()
              + 2 * q.numel() * q.element_size() + pt.numel() * 4 + 2 * s * 4)
    flops = sum(4.0 * hq * (int(n) + 1) * hd for n in lens_list)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return {
        "name": f"paged_flash_decode[{label}]", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/flash_attention.py:163",
        "launches": counts["decode"],
        "launches_per_decode_step": counts["decode_per_decode_step"],
        "launches_per_prefill": counts["decode_per_prefill"], "shape_note": seed_note,
        "splits": decode_splits(s, hkv, pt.shape[1], groups=-(-(hq // hkv) // 4)),
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def _decode_entries(counts) -> list:
    """The paged decode at the serving shape (phase 8's: 4 slots, lengths
    70/40/100/65, a 7-page table) and at the long-context shape (16 slots
    of 4096 tokens, 134 MB of E4M3 pages, beyond the 50 MB L2)."""
    rng = np.random.default_rng(2)
    serve = make_decode_case(
        rng, s=4, hq=32, hkv=8, hd=128, page_size=16, pages_per_slot=7, n_pages=29,
        dtype=torch.float8_e4m3fn, q_dtype=torch.float16, seq_lens=[70, 40, 100, 65])
    return [
        _decode_row(counts, "S4 Hq32 Hkv8 hd128 ps16 e4m3", serve, "the serve run's shape"),
        _decode_row(counts, "S16x4096 Hq32 Hkv8 hd128 ps16 e4m3", _long_decode_case(),
                    "long context, off the serve run"),
    ]


def _flash_entry(counts):
    """The dense flash attention at granite's training shape in fp16
    (causal), on the route ``plan_flash`` names (the tensor cores), as a
    CUDA-graph replay with eager calls beside, bound by its operations at
    the fp16 tensor-core peak, beside ``scaled_dot_product_attention`` on
    the same q and the KV heads expanded for it."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
        plan_flash,
    )

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
    flops = 4.0 * b * hq * hd * s * (s + 1) / 2  # two products over the causal half
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP16_FLOP_S * 1e3
    source = {"tc": "flash_attention_tc.cu", "simt": "flash_attention.cu"}[route]
    return {
        "name": f"flash_attention[B{b} S{s} Hq{hq} Hkv{hkv} hd{hd} causal fp16]", "route": "cuda",
        "source": f"src/repro_torch/csrc/{source}", "schedule": route,
        "replaces": "src/repro/kernels/flash_attention.py:254",
        "launches": counts["dense"],
        "max_abs_err": float((got.float() - want.float()).abs().max()),
        "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "tflop_s": flops / ms / 1e9,
    }


def _log_entry(e) -> None:
    lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
    extra = ""
    if "split" in e:
        smm = "none" if e["scaled_mm_ms"] is None else f"{e['scaled_mm_ms']:.4f} ms"
        extra = (f"; schedule {e['schedule']} (split {e['split']}, {e['aux_launches_per_call']} "
                 f"auxiliary launches a call), eager calls {e['eager_ms']:.4f} ms, "
                 f"_scaled_mm {smm}, {e['tflop_s']:.1f} TFLOP/s, "
                 f"{e['share_differ']:.2%} of outputs differ, worst {e['worst_ulps']} ulp")
    elif "eager_ms" in e:
        extra = f"; eager calls {e['eager_ms']:.4f} ms"
        if "splits" in e:
            extra += f", {e['splits']} split(s), {e['shape_note']}"
        if "schedule" in e:
            extra += f", route {e['schedule']}, {e['tflop_s']:.1f} TFLOP/s"
    log(f"{e['name']}: {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} ms by {e['bound_by']}, "
        f"plain {e['plain_ms']:.4f} ms, library {lib}, max|d| {e['max_abs_err']:.3g}{extra})")


def phase_kernel_line(counts) -> list:
    entries = [*_gemm_entries(counts), *_decode_entries(counts), _flash_entry(counts)]
    for e in entries:
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']} was not launched on its main path")
        _log_entry(e)
    # The semiring pairs share the kernel but are off the serving and
    # training paths, so they stay out of the kernel line; one pair is
    # timed for PERF.md.
    apsp = _apsp_entry()
    if apsp["max_abs_err"] != 0.0:
        raise AssertionError(f"{apsp['name']}: not bitwise against the plain version")
    _log_entry(apsp)
    return entries


def main() -> int:
    card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        phase_build()
        phase_gemm()
        phase_gemm_schedules()
        phase_decode()
        counts = phase_flash()
        phase_backward_gemm()
        phase_slice_parity()
        counts |= phase_serve()
    phase_train_parity()
    train = phase_train()
    counts |= {"train_gemm": train["gemm"], "train_gemm_per_step": train["gemm_per_step"],
               "train_copies": train["copies"]}
    with torch.inference_mode():
        entries = phase_kernel_line(counts)
    log(f"card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
