"""Plan selection for the port's kernels on Hopper: the counterpart of
``repro.kernels.tuning``.

The reference chooses TPU tiles (``block_m/n/k`` of the GEMM,
``pages_per_block/head_block`` of the paged decode). On the card each
kernel's tiles are ``constexpr`` in ``csrc/``; what a call can still choose
is its plan:

- GEMM: the schedule (``"tc"``, ``"small_row"`` or ``"simt"``), the K split
  of the small-row and SIMT schedules, the SIMT form (``"warp"``, ``"f32"``,
  ``"h2"``), and whether the fp8 tensor-core path widens both operands to
  fp16 up front (``widen``) or each tile in shared memory;
- paged decode: the splits of each (slot, KV head, head group)'s page walk.

The reference's three-level policy:

1. Explicit arguments (``ops.gemm_op(schedule=, split=, form=, widen=)``,
   ``ops.paged_decode_attention(splits=)``) win, then the environment:
   ``REPRO_TORCH_GEMM_PLAN`` (any of
   ``schedule=small_row,split=8,form=f32,widen=1``) and
   ``REPRO_TORCH_DECODE_SPLITS`` (an int). A malformed value raises as an
   argument and warns, then falls back, from the environment. A field that
   one call's kernels cannot take (``small_row`` for 16-bit operands, a
   split of the tensor-core schedule) is dropped for that call, and the
   table decides it. The environment is read once a process
   (:func:`settings`); :func:`reset_cache` reads it again.
2. With ``REPRO_AUTOTUNE=1`` and nothing requested, the first call of each
   shape times every plan its kernels accept (:func:`gemm_candidates`,
   :func:`decode_candidates`) with CUDA events around a graph replay of a
   few launches after a warm one, and keeps the fastest in a
   JSON cache: ``$REPRO_AUTOTUNE_CACHE``, else
   ``~/.cache/repro_torch/plans.json``, read once a process and written
   atomically. A candidate that fails to launch, or whose result leaves the
   table plan's by more than the order of its sums allows, raises. While a
   stream captures a CUDA graph nothing is timed or written: the call takes
   the cached plan or the table's.
3. Otherwise the rules below, by band of M. No rule depends on the
   operands' byte width yet, so none is keyed by it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import NamedTuple

import torch

SMS = 132  # streaming multiprocessors of an H100 SXM


class SplitRule(NamedTuple):
    """Split K until the grid has ``blocks`` blocks, keeping at least
    ``min_k`` of K in each split."""

    blocks: int
    min_k: int


class DecodeRule(NamedTuple):
    """Split each page walk until ``blocks_per_sm`` decode blocks fill every
    SM once, but no split walks fewer than ``min_pages`` pages."""

    blocks_per_sm: int
    min_pages: int


# -- GEMM bands of M (fp8 (mul, add)) ------------------------------------------------
# Rows at or below which fp8 (mul, add) takes the small-row schedule: the
# decode step's slots. Above it a 64-row wgmma tile is worth its zeros.
SMALL_M_MAX = 16
# fp32 products of at most this many outputs take the SIMT warp form (the
# MoE router); more take the tiled forms.
SIMT_WARP_MAX_OUTPUTS = 4096

# -- Split rules ---------------------------------------------------------------------
# Small-row split-K (fp8 only): two blocks for each SM. plan_gemm caps the
# split at the kernel's largest cluster (redmule_gemm.SR_MAX_CLUSTER): the
# splits of an output tile fold through a cluster's shared memory.
SMALL_ROW_SPLIT = SplitRule(2 * SMS, 256)
# SIMT split-K. Four tiled blocks are resident on an SM (launch bounds), so
# K is split until the grid comes nearest one full wave: 100 tiles take 5
# splits (500 blocks, at most 4 an SM).
SIMT_SPLIT = SplitRule(4 * SMS, 256)
# Paged-decode splits: about four resident decode blocks an SM; a split
# shorter than 16 pages costs more in its start and the combine than its
# walk saves.
DECODE_SPLIT = DecodeRule(4, 16)

SCHEDULES = ("tc", "small_row", "simt")
FORMS = ("warp", "f32", "h2")
GEMM_PLAN_ENV = "REPRO_TORCH_GEMM_PLAN"
DECODE_SPLITS_ENV = "REPRO_TORCH_DECODE_SPLITS"
# Split counts the autotuner tries (each normalised to the kernel's step).
SPLIT_CANDIDATES = (1, 2, 3, 4, 5, 6, 8, 12, 16, 24, 32, 64)
MAX_GRID_YZ = 65535
_REPEATS = 10  # launches a candidate's timed graph replays


@dataclasses.dataclass(frozen=True)
class GemmRequest:
    """The plan fields a caller asks for; None leaves one to the next level."""

    schedule: str | None = None
    split: int | None = None
    form: str | None = None
    widen: bool | None = None

    def __post_init__(self):
        if self.schedule is not None and self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r}; expected one of {SCHEDULES}")
        if self.form is not None and self.form not in FORMS:
            raise ValueError(f"unknown SIMT form {self.form!r}; expected one of {FORMS}")
        if self.split is not None and (not isinstance(self.split, int) or self.split < 1):
            raise ValueError(f"split must be a positive int, not {self.split!r}")

    def over(self, other: "GemmRequest") -> "GemmRequest":
        """This request's fields, the other's where this leaves one open."""
        if other is NO_REQUEST:
            return self
        return GemmRequest(*(other_f if f is None else f for f, other_f in (
            (self.schedule, other.schedule), (self.split, other.split),
            (self.form, other.form), (self.widen, other.widen))))


NO_REQUEST = GemmRequest()


def request_of(plan) -> GemmRequest:
    """The request that gives exactly ``plan`` (a ``redmule_gemm.GemmPlan``)."""
    return GemmRequest(plan.schedule, plan.split, plan.form or None, plan.widen)


# -- The environment -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Settings:
    """The environment's switches, as :func:`settings` read them."""

    gemm: GemmRequest  # REPRO_TORCH_GEMM_PLAN (NO_REQUEST when unset or malformed)
    decode_splits: int | None  # REPRO_TORCH_DECODE_SPLITS (None when unset or malformed)
    autotune: bool  # REPRO_AUTOTUNE == "1"
    cache_path: str  # REPRO_AUTOTUNE_CACHE, else ~/.cache/repro_torch/plans.json


_settings: Settings | None = None


def _parse_env(name: str, parse, fallback):
    raw = os.environ.get(name, "")
    if not raw:
        return fallback
    try:
        return parse(raw)
    except (ValueError, TypeError) as e:
        warnings.warn(f"ignoring malformed {name}={raw!r} ({e}); using the table", stacklevel=3)
        return fallback


def _parse_gemm_plan(raw: str) -> GemmRequest:
    fields = {}
    for part in raw.split(","):
        name, sep, value = part.strip().partition("=")
        if not sep or name not in ("schedule", "split", "form", "widen") or name in fields:
            raise ValueError("expected name=value pairs of schedule, split, form, widen")
        if name == "split":
            fields[name] = int(value)
        elif name == "widen":
            if value not in ("0", "1"):
                raise ValueError("widen takes 0 or 1")
            fields[name] = value == "1"
        else:
            fields[name] = value
    return GemmRequest(**fields)


def _parse_splits(raw: str) -> int:
    n = int(raw)
    if n < 1:
        raise ValueError("splits must be positive")
    return n


def settings() -> Settings:
    """The environment's switches, read once a process (every GEMM call
    asks); :func:`reset_cache` reads them again."""
    global _settings
    if _settings is None:
        _settings = Settings(
            _parse_env(GEMM_PLAN_ENV, _parse_gemm_plan, NO_REQUEST),
            _parse_env(DECODE_SPLITS_ENV, _parse_splits, None),
            os.environ.get("REPRO_AUTOTUNE") == "1",
            default_cache_path())
    return _settings


def default_cache_path() -> str:
    return os.environ.get(
        "REPRO_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch", "plans.json"))


# -- The table rules -----------------------------------------------------------------


def simt_form(m: int, n: int, batch: int, gop, policy) -> str:
    """The table's SIMT form: warps for fp32 products with few outputs,
    packed 16-bit tiles for the semiring pairs under a 16-bit compute
    format, fp32 tiles otherwise."""
    if policy.compute == torch.float32 and batch * m * n <= SIMT_WARP_MAX_OUTPUTS:
        return "warp"
    if not gop.is_gemm and policy.compute in (torch.float16, torch.bfloat16):
        return "h2"
    return "f32"


def decode_splits(s: int, hkv: int, pages_per_slot: int, *, groups: int = 1) -> int:
    """The table's paged-decode splits, from shapes alone: as many as keep
    ``s * hkv * groups * splits`` blocks within one wave (132 SMs, the
    rule's resident blocks each), but none walking fewer than the rule's
    pages; 1 when the units alone fill the SMs. The count is the one that
    leaves no split empty."""
    rule = DECODE_SPLIT
    units = s * hkv * groups
    if units >= SMS:
        return 1
    wave = SMS * rule.blocks_per_sm // units
    want = max(1, min(wave, pages_per_slot // rule.min_pages))
    return effective_splits(pages_per_slot, want)


def effective_splits(pages: int, splits: int) -> int:
    """The split count the decode kernel runs for ``splits`` asked: each
    split walks ceil(pages / splits) pages and none is left empty."""
    per = max(1, -(-pages // max(1, splits)))
    return max(1, -(-pages // per))


# -- Candidates ----------------------------------------------------------------------


def gemm_candidates(call, gop, policy) -> list:
    """Every plan the kernels accept for one laid-out call
    (``redmule_gemm.plan_call``'s result), the table's first: each schedule
    the call's formats allow, the K splits of ``SPLIT_CANDIDATES`` made
    multiples of the kernel's step, the SIMT forms its compute format
    takes (warps up to ``SIMT_WARP_MAX_OUTPUTS`` outputs), both fp8
    widenings of the tensor cores, within the grid's y and z limits."""
    from repro_torch.kernels import redmule_gemm as rg

    m, n, k, batch = call.m, call.n, call.k, call.b1 * call.b2
    x, w = call.x_operand(), call.w_operand()
    plans = [call.plan]
    for schedule in rg.schedules_for(m, k, x, w, gop, policy):
        if schedule == "tc":
            widths = (False, True) if rg.fp8_pair(x, w) else (False,)
            reqs = [GemmRequest("tc", widen=wide) for wide in widths]
        elif schedule == "small_row":
            reqs = [GemmRequest("small_row", split=s) for s in SPLIT_CANDIDATES]
        else:
            reqs = []
            for form in rg.simt_forms_for(m, n, batch, gop, policy):
                splits = (1,) if form == "warp" else SPLIT_CANDIDATES
                reqs += [GemmRequest("simt", split=s, form=form) for s in splits]
        for req in reqs:
            plan = rg.plan_gemm(m, n, k, batch, x, w, gop, policy, request=req)
            if plan not in plans and plan.split <= MAX_GRID_YZ:
                plans.append(plan)
    return plans


def decode_candidates(pages: int, table: int) -> list[int]:
    """Every distinct split count of a page walk of ``pages`` pages, the
    table's first: 1 up to 64 splits, or one page each."""
    out = [table]
    for want in range(1, min(pages, 64) + 1):
        n = effective_splits(pages, want)
        if n not in out and n <= MAX_GRID_YZ:
            out.append(n)
    return out


# -- The autotune cache --------------------------------------------------------------

_caches: dict[str, dict] = {}
# Decoded cache hits by (path, the call's layout): a warm call builds no
# key string and decodes no entry.
_memo: dict[tuple, object] = {}
_device_names: dict[int, str] = {}
# Candidates timed since the last reset (a warm cache times none).
timed = 0


def _cache(path: str) -> dict:
    """The cache at ``path``, read from disk once a process."""
    if path not in _caches:
        try:
            with open(path) as f:
                _caches[path] = json.load(f)
        except (OSError, ValueError):
            _caches[path] = {}
    return _caches[path]


def reset_cache() -> None:
    """Forget the caches and the environment read so far: the next call
    reads both again."""
    global _settings
    _settings = None
    _caches.clear()
    _memo.clear()


def _save_cache(path: str, cache: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _device_name(t: torch.Tensor) -> str:
    index = t.device.index or 0
    if index not in _device_names:
        _device_names[index] = torch.cuda.get_device_name(index).replace(" ", "_")
    return _device_names[index]


def gemm_key(call, gop, policy) -> str:
    """Device, op, policy, operand formats, whether each operand is
    K-major, and B x M x N x K."""
    x, w = call.x_operand(), call.w_operand()
    return (f"{_device_name(call.x)}/gemm/{gop.name}/{policy.name}/"
            f"{str(x.dtype)[6:]}x{str(w.dtype)[6:]}/kmajor{int(x.kmajor())}{int(w.kmajor())}/"
            f"{call.b1 * call.b2}x{call.m}x{call.n}x{call.k}")


def decode_key(q: torch.Tensor, k_pool: torch.Tensor, pages: int, page_size: int,
               window: int | None) -> str:
    """Device, S, Hq, Hkv, hd, page size, pages a slot, KV format and window."""
    s, hkv, g, hd = q.shape
    return (f"{_device_name(q)}/paged_decode/S{s}xHq{hkv * g}xHkv{hkv}xhd{hd}/"
            f"ps{page_size}xP{pages}/{str(k_pool.dtype)[6:]}/w{window or 0}")


def plan_label(plan) -> str:
    """A GEMM plan as the cache and the logs write it."""
    if plan.schedule == "tc":
        return "tc" + (" widened" if plan.widen else "")
    if plan.schedule == "small_row":
        return f"small_row split {plan.split}"
    return f"simt {plan.form} split {plan.split}"


def lookup(key: str, path: str | None = None) -> dict | None:
    return _cache(path or settings().cache_path).get(key)


def _store(key: str, entry: dict, path: str | None) -> None:
    path = path or settings().cache_path
    cache = _cache(path)
    cache[key] = entry
    _save_cache(path, cache)


def time_ms(fn, repeats: int = _REPEATS) -> float:
    """Device ms a launch of ``fn``: CUDA events around a graph replay of
    ``repeats`` launches, after one warm launch and one warm replay. The
    wrapper's host planning outlasts a small-row kernel, so timing eager
    launches would time the host."""
    global timed
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    timed += 1
    return start.elapsed_time(end) / repeats


def _check_candidate(label: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    """A candidate's result against the table plan's: the same non-finite
    pattern, and the rest within ``tol`` of the largest magnitude (0 for
    the exact min/max pairs)."""
    g, r = got.float(), want.float()
    same_nan = torch.equal(torch.isnan(g), torch.isnan(r))
    fin = torch.isfinite(r)
    if not same_nan or not torch.equal(g[~fin & ~torch.isnan(r)], r[~fin & ~torch.isnan(r)]):
        raise RuntimeError(f"autotune candidate {label} gives other non-finite values")
    if fin.any():
        scale = r[fin].abs().max().clamp(min=1e-30)
        err = float((g[fin] - r[fin]).abs().max() / scale)
        if err > tol:
            raise RuntimeError(f"autotune candidate {label} is {err:.3g} off the table "
                               f"plan's result (limit {tol:.3g})")


# The order of a split's fp32 sums moves a result by a few ulps of its
# format at most (GEMM_TOL of chip_smoke.py); min and max are exact.
RESULT_TOL = {torch.float32: 1e-5, torch.float16: 2e-3, torch.bfloat16: 1.6e-2}


def autotune_gemm(x, w, y, call, *, gop, policy, out_dtype, path: str | None = None):
    """The fastest plan of one call, timed on its operands and cached. ``call``
    is ``plan_call``'s layout with the table's plan."""
    from repro_torch.kernels.redmule_gemm import SR_MAX_CLUSTER, GemmPlan, redmule_gemm

    path = path or settings().cache_path
    memo = (path, call.x.device.index, gop.name, policy.name, call.x.dtype, call.w.dtype,
            *call.sx, *call.sw, call.b1 * call.b2, call.m, call.n, call.k,
            call.x.data_ptr() % 16, call.w.data_ptr() % 16)
    if memo in _memo:
        return _memo[memo]
    key = gemm_key(call, gop, policy)
    hit = lookup(key, path)
    # A cached small-row split past the cluster cap (cached before the cap)
    # is timed again.
    if hit is not None and not (hit["plan"]["schedule"] == "small_row"
                                and hit["plan"]["split"] > SR_MAX_CLUSTER):
        _memo[memo] = plan = GemmPlan(**hit["plan"])
        return plan
    if torch.cuda.is_current_stream_capturing():
        return call.plan
    tol = 0.0 if not gop.is_gemm else RESULT_TOL.get(out_dtype, 1e-5)
    want = redmule_gemm(x, w, y, gop=gop, policy=policy, out_dtype=out_dtype,
                        request=request_of(call.plan))
    times = {}
    best, best_ms = call.plan, float("inf")
    for plan in gemm_candidates(call, gop, policy):
        req = request_of(plan)
        label = plan_label(plan)

        def run(req=req):
            return redmule_gemm(x, w, y, gop=gop, policy=policy, out_dtype=out_dtype, request=req)

        _check_candidate(label, run(), want, tol)
        times[label] = ms = time_ms(run)
        if ms < best_ms:
            best, best_ms = plan, ms
    _store(key, {"plan": dataclasses.asdict(best), "ms": times,
                 "table": plan_label(call.plan), "at": time.time()}, path)
    _memo[memo] = best
    return best


def autotune_decode(run, q, k_pool, active, pages: int, page_size: int,
                    window: int | None, table: int, path: str | None = None) -> int:
    """The fastest split count of one paged-decode shape, timed on this
    call's pages and lengths and cached by shape. ``run(splits)`` launches
    the kernel. A step with no active slot (a graph's warm-up on zeroed
    inputs) walks no page, so it takes the table's count and caches
    nothing."""
    key = decode_key(q, k_pool, pages, page_size, window)
    hit = lookup(key, path)
    if hit is not None:
        return hit["splits"]
    if torch.cuda.is_current_stream_capturing() or not bool(active.any()):
        return table
    want = run(table)
    times = {}
    best, best_ms = table, float("inf")
    for splits in decode_candidates(pages, table):
        _check_candidate(f"splits {splits}", run(splits), want, RESULT_TOL.get(q.dtype, 1e-5))
        times[str(splits)] = ms = time_ms(lambda: run(splits))
        if ms < best_ms:
            best, best_ms = splits, ms
    _store(key, {"splits": best, "ms": times, "table": table, "at": time.time()}, path)
    return best
