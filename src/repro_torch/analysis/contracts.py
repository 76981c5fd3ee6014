"""Serving-step contracts of every decoder-only architecture, the counterpart of
``repro.analysis.contracts``.

The reference abstract-traces each step (``jax.eval_shape``,
``jax.make_jaxpr``). torch has no trace of that kind, so the port runs each
step once, eagerly, at the reference's geometry (4 slots, page 8, 4 pages a
slot, chunk 8, verify width 4) on a model built from the arch's config
(SMOKE on the CPU), and holds the reference's five contracts:

1. **static shapes**: each step runs at a fixed input signature and returns
   fp32 logits of the documented shape;
2. **pools preserved**: the pools after the step have exactly the input's
   structure, shapes and dtypes (a step that grew or retyped a pool would
   make a new graph capture and new kernel plans every call);
3. **kernel iff backend**: the CUDA launch counters (``_build.LaunchCount``
   of the GEMM and the paged decode) rise on ``backend="cuda"`` and stay 0
   on ``"torch"``; this replaces "``pallas_call`` iff pallas";
4. **fp8 storage discipline**: with ``kv_cache_dtype="e4m3"`` every KV pool
   leaf stays E4M3 in and out, and any fp8-storage policy accumulates in
   fp32;
5. **bounded signatures**: the batched-prefill row bucketing maps every
   group size into ``P_BUCKETS``.

On the card, ``graphs=True`` also captures the decode and verify steps once
each as a CUDA graph (``serving.engine.GraphStep``) and holds the replay's
logits equal to the eager step's, bit for bit, from the same pools. The
optional HBM budget reads ``roofline/cost.py``'s recorder over one eager
decode step in place of the reference's compiled-HLO cost.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.precision import E4M3, FP8_DTYPES
from repro_torch.engine import Engine
from repro_torch.kernels import flash_attention, redmule_gemm
from repro_torch.models.transformer import Transformer
from repro_torch.roofline import cost
from repro_torch.serving.engine import P_BUCKETS, EngineCore, GraphStep, stage

NUM_SLOTS = 4
PAGE_SIZE = 8
PAGES_PER_SLOT = 4
NUM_PAGES = NUM_SLOTS * PAGES_PER_SLOT + 1  # + the null page
CHUNK = 8
FULL_PREFILL = 16
VERIFY_T = 4  # draft depth k=3 -> k+1 scored positions

STEP_KINDS = ("prefill_full", "prefill_chunk", "prefill_batch", "decode", "verify")
GRAPH_STEPS = ("decode", "verify")
_KV_LEAVES = ("kp", "vp")


@dataclasses.dataclass(frozen=True)
class ContractViolation:
    arch: str
    backend: str
    step: str
    contract: str
    detail: str

    def __str__(self) -> str:
        return f"{self.arch} [{self.backend}] {self.step}: {self.contract} — {self.detail}"


def launch_counts() -> dict[str, int]:
    """The kernels' launch counters: GEMM-Op calls and paged decodes."""
    return {"gemm": redmule_gemm.launches.n, "paged_decode": flash_attention.launches.n}


def leaf_specs(pools) -> list[tuple[str, tuple, torch.dtype]]:
    """(path, shape, dtype) of every pool tensor, in order."""
    out = []
    for i, layer in enumerate(pools):
        for name, leaf in layer.items():
            for key, t in (leaf.items() if isinstance(leaf, dict) else [("", leaf)]):
                out.append((f"[{i}].{name}{'.' + key if key else ''}", tuple(t.shape), t.dtype))
    return out


def kv_leaves(pools):
    for i, layer in enumerate(pools):
        for name in _KV_LEAVES:
            if name in layer:
                yield f"[{i}].{name}", layer[name]


class _BucketProbe:
    """The one field ``EngineCore``'s bucketing reads, so the contract runs
    the real policy methods (borrowed below)."""

    allowed_buckets = EngineCore.allowed_buckets
    bucket_for = EngineCore.bucket_for

    def __init__(self, num_slots: int):
        self.config = dataclasses.make_dataclass("Cfg", [("num_slots", int)])(num_slots)


def check_bucket_policy(num_slots: int = NUM_SLOTS) -> list[str]:
    """Every prefill group size 1..num_slots must bucket into ``P_BUCKETS``;
    the distinct signatures are at most ``len(P_BUCKETS)``."""
    probe = _BucketProbe(num_slots)
    problems: list[str] = []
    allowed = probe.allowed_buckets()
    if not set(allowed) <= set(P_BUCKETS):
        problems.append(f"allowed buckets {allowed} escape P_BUCKETS {P_BUCKETS}")
    seen = set()
    for n in range(1, num_slots + 1):
        b = probe.bucket_for(n)
        seen.add(b)
        if b not in P_BUCKETS:
            problems.append(f"group size {n} bucketed to {b} ∉ P_BUCKETS")
    if len(seen) > len(P_BUCKETS):
        problems.append(f"{len(seen)} distinct batched-prefill signatures > "
                        f"len(P_BUCKETS) = {len(P_BUCKETS)}")
    return problems


def build_model(arch: str, *, backend: str, fp8_kv: bool = False, smoke: bool = True):
    """(cfg, model, params) for one arch under its config's policy, on the
    card for ``"cuda"``, else on the CPU, parameters from seed 0."""
    cfg = get_config(arch, smoke=smoke)
    if fp8_kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="e4m3")
    device = "cuda" if backend == "cuda" else "cpu"
    model = Transformer(cfg, engine=Engine(policy=cfg.policy, backend=backend), device=device,
                        fused_decode=backend == "torch")
    return cfg, model, model.init(0)


def step_fns(model, params, vocab: int, seed: int = 0) -> dict:
    """step name -> (forward(inputs, pools), host inputs, logits shape). The
    inputs are fixed-shape numpy arrays; ``forward`` reads them as device
    tensors."""
    rng = np.random.default_rng(seed)
    tok = lambda *shape: rng.integers(1, vocab, shape).astype(np.int32)  # noqa: E731
    rows = np.arange(1, NUM_PAGES).reshape(NUM_SLOTS, PAGES_PER_SLOT).astype(np.int32)
    p_max = EngineCore.allowed_buckets(_BucketProbe(NUM_SLOTS))[-1]
    ps = PAGE_SIZE
    s = NUM_SLOTS

    def prefill(chunked, slot, start, n):
        return lambda d, pools: model.prefill_cb(params, d["tokens"].long(), pools,
                                                 d["page_row"], slot, start, n, page_size=ps,
                                                 chunked=chunked)

    return {
        "prefill_full": (prefill(False, 0, 0, FULL_PREFILL),
                         {"tokens": tok(1, FULL_PREFILL), "page_row": rows[0]}, (1, vocab)),
        "prefill_chunk": (prefill(True, 1, CHUNK, CHUNK - 2),
                          {"tokens": tok(1, CHUNK), "page_row": rows[1]}, (1, vocab)),
        "prefill_batch": (
            lambda d, pools: model.prefill_cb(
                params, d["tokens"].long(), pools, d["page_rows"], d["slots"], d["starts"],
                d["lengths"], page_size=ps, chunked=True, active=d["active"] != 0),
            {"tokens": tok(p_max, CHUNK), "page_rows": rows[:p_max],
             "slots": np.arange(p_max, dtype=np.int32),
             "starts": np.zeros(p_max, np.int32),
             "lengths": np.array([CHUNK, 5, 3, CHUNK][:p_max], np.int32),
             "active": np.ones(p_max, np.int32)},
            (p_max, vocab)),
        "decode": (
            lambda d, pools: model.decode_cb(params, d["tokens"].long(), pools,
                                             d["page_table"], d["seq_lens"], d["active"] != 0,
                                             page_size=ps),
            {"tokens": tok(s, 1), "page_table": rows,
             "seq_lens": np.array([FULL_PREFILL, CHUNK + 5, 4, 20][:s], np.int32),
             "active": np.array([1, 1, 0, 1][:s], np.int32)},
            (s, vocab)),
        "verify": (
            lambda d, pools: model.verify_cb(params, d["tokens"].long(), pools,
                                             d["page_table"], d["seq_lens"], d["lengths"],
                                             d["active"] != 0, page_size=ps, commit=False),
            {"tokens": tok(s, VERIFY_T), "page_table": rows,
             "seq_lens": np.array([FULL_PREFILL, CHUNK + 5, 4, 20][:s], np.int32),
             "lengths": np.array([VERIFY_T, VERIFY_T, 2, 0][:s], np.int32),
             "active": np.array([1, 1, 1, 0][:s], np.int32)},
            (s, VERIFY_T, vocab)),
    }


def _device_inputs(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def _snapshot(pools) -> list:
    return [{k: ({kk: t.clone() for kk, t in v.items()} if isinstance(v, dict) else v.clone())
             for k, v in layer.items()} for layer in pools]


def _restore(pools, snap) -> None:
    for layer, saved in zip(pools, snap):
        for k, v in layer.items():
            if isinstance(v, dict):
                for kk, t in v.items():
                    t.copy_(saved[k][kk])
            else:
                v.copy_(saved[k])


def graph_matches_eager(forward, arrays: dict, pools, device) -> str | None:
    """Capture ``forward`` once as a CUDA graph over static inputs and hold
    the replay's logits equal to an eager call's from the same pools; None
    when they are equal, else what differs."""
    step = GraphStep(forward, arrays, device, graph=True)
    staged, _ = stage(arrays, pinned=True)
    snap = _snapshot(pools)
    step.load(staged, pools)  # an eager warm-up on zeroed inputs, then the capture
    _restore(pools, snap)
    replayed = step.run().clone()
    _restore(pools, snap)
    eager = forward(step.inputs, pools)
    torch.cuda.synchronize()
    if not torch.equal(replayed, eager):
        diff = (replayed.float() - eager.float()).abs().max()
        return f"graph replay's logits differ from the eager step's by {float(diff):.3g}"
    return None


def check_arch(arch: str, *, backend: Optional[str] = None, fp8_kv: bool = False,
               smoke: bool = True, hbm_budget_bytes: Optional[float] = None,
               steps: Sequence[str] = STEP_KINDS, graphs: bool = False,
               built=None) -> list[ContractViolation]:
    """All step contracts for one arch; an empty list is clean. ``backend``
    defaults to the card's when there is one. ``built`` takes an already
    built ``(cfg, model, params)`` (a full-width model on the card), whose
    backend and KV format then hold. The encoder-decoder and VLM families
    are vacuously clean: they serve static-batch, with no paged step."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "torch"
    cfg, model, params = built or build_model(arch, backend=backend, fp8_kv=fp8_kv,
                                              smoke=smoke)
    bname = model.engine.backend
    out: list[ContractViolation] = []

    def bad(step, contract, detail):
        out.append(ContractViolation(arch, bname, step, contract, detail))

    if not model.supports_cb():
        return out
    policy = model.engine.policy
    if policy.storage_fwd in FP8_DTYPES and policy.acc != torch.float32:
        bad("*", "fp8-accumulation", f"policy {policy.name} stores fp8 but accumulates in "
                                     f"{policy.acc}, not fp32")
    pools = model.init_state_store(NUM_SLOTS, NUM_PAGES, PAGE_SIZE)
    fp8_pools = cfg.kv_cache_dtype == "e4m3"

    def check_kv(step):
        if fp8_pools:
            for path, t in kv_leaves(pools):
                if t.dtype != E4M3:
                    bad(step, "fp8-storage", f"KV leaf {path} is {t.dtype}, expected e4m3")

    check_kv("pools")
    sig = leaf_specs(pools)
    kv_pages = model.cb_profile().needs_kv_pages
    fns = step_fns(model, params, cfg.vocab_size)
    for step in steps:
        forward, arrays, want_shape = fns[step]
        before = launch_counts()
        try:
            with torch.inference_mode():
                logits = forward(_device_inputs(arrays, model.device), pools)
        except Exception as e:  # noqa: BLE001 — report, don't crash the CLI
            bad(step, "static-shapes", f"the step failed: {e!r}")
            continue
        after = launch_counts()
        if tuple(logits.shape) != want_shape:
            bad(step, "static-shapes", f"logits shape {tuple(logits.shape)}, contract says "
                                       f"{want_shape}")
        if logits.dtype != torch.float32:
            bad(step, "static-shapes", f"logits dtype {logits.dtype}, contract says float32 "
                                       "(sampling filters assume it)")
        got = leaf_specs(pools)
        if got != sig:
            diff = [f"{g} != {w}" for g, w in zip(got, sig) if g != w] or [
                f"{len(got)} leaves vs {len(sig)}"]
            bad(step, "pools-preserved", "output pools differ from input: " + "; ".join(diff[:3]))
        check_kv(step)
        rose = {k: after[k] - before[k] for k in after}
        want = {"gemm": bname == "cuda",
                "paged_decode": bname == "cuda" and step == "decode" and kv_pages}
        for kernel, expected in want.items():
            if (rose[kernel] > 0) != expected:
                bad(step, "kernel-iff-backend",
                    f"{rose[kernel]} {kernel} launches with backend={bname}")
        if graphs and bname == "cuda" and step in GRAPH_STEPS:
            with torch.inference_mode():
                problem = graph_matches_eager(forward, arrays, pools, model.device)
            if problem:
                bad(step, "static-shapes", problem)
    for problem in check_bucket_policy(NUM_SLOTS):
        bad("prefill_batch", "bounded-signatures", problem)
    if hbm_budget_bytes is not None and "decode" in steps:
        got = step_hbm_bytes(model, params, pools, cfg.vocab_size)
        if got > hbm_budget_bytes:
            bad("decode", "hbm-budget", f"{got / 1e6:.2f} MB a step > budget "
                                        f"{hbm_budget_bytes / 1e6:.2f} MB")
    return out


def step_hbm_bytes(model, params, pools, vocab: int) -> float:
    """Bytes one eager decode step moves through its kernel calls, by
    ``roofline/cost.py``'s counts (each operand read once, each output
    written once)."""
    forward, arrays, _ = step_fns(model, params, vocab)["decode"]
    with torch.inference_mode(), cost.recording() as counts:
        forward(_device_inputs(arrays, model.device), pools)
    return counts.bytes


def cb_archs() -> list[str]:
    """The archs served by continuous batching (the decoder-only families)."""
    cfgs = {a: get_config(a, smoke=True) for a in ARCH_IDS}
    return [a for a, c in cfgs.items()
            if not c.is_encoder_decoder and c.family not in ("vlm", "audio")]


def _needs_kv_pages(arch: str) -> bool:
    cfg = get_config(arch, smoke=True)
    model = Transformer(cfg, engine=Engine(policy=cfg.policy, backend="torch"), device="cpu")
    return model.supports_cb() and model.cb_profile().needs_kv_pages


def check_zoo(*, backends: Sequence[str] = ("torch",), archs: Optional[Sequence[str]] = None,
              fp8_kv_variants: bool = True, hbm_budget_bytes: Optional[float] = None,
              graphs: bool = False) -> tuple[list[ContractViolation], int]:
    """Every contract over the zoo at SMOKE size. Returns (violations,
    cells), a cell being one (arch, backend, variant) checked."""
    violations: list[ContractViolation] = []
    checked = 0
    for arch in (archs if archs is not None else cb_archs()):
        for backend in backends:
            violations += check_arch(arch, backend=backend, hbm_budget_bytes=hbm_budget_bytes,
                                     graphs=graphs)
            checked += 1
            if fp8_kv_variants and _needs_kv_pages(arch):
                violations += check_arch(arch, backend=backend, fp8_kv=True, graphs=graphs)
                checked += 1
    return violations, checked
