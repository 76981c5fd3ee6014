"""The continuous-batching server of the port (counterpart of
``repro.serving.server``, with its tracer, metrics registry and step
profiler: :class:`ServerStats` is a read-only view over the registry).

The :class:`~repro_torch.serving.engine.EngineCore` owns the device (the
StateStore, the steps, the sampling generator, the last-token tensor, the
decode graph and the window of dispatched steps); the :class:`Server` owns
the requests (scheduler, admission, prompts, commits and streaming).

One :meth:`Server.step`:

  1. admit queued requests into free slots (pages and budget permitting),
     mapping cached prefixes and possibly preempting;
  2. dispatch one prompt chunk per prefilling request: one single-row step
     each, or (``prefill_batch``) every prefilling slot packed into one
     ``(P, chunk)`` step, P bucketed to {1, 2, 4, 8}. The final chunk
     samples the request's first token on the device;
  3. dispatch ONE decode step over every slot; its tokens merge into the
     engine's last-token tensor, so the next decode can be dispatched
     without waiting for this one;
  4. harvest the oldest steps in flight down to ``async_depth``: commit
     tokens and prefix pages, stamp latency marks, emit
     :class:`TokenEvent`s.

With ``spec`` (or a ``draft_model``) step 3 is a speculative round
instead (:meth:`Server._spec_decode_once`): a drafter proposes up to k
tokens a slot, the target verifies k + 1 positions of every slot in one
step, and rejection sampling commits the accepted drafts and one token of
the target's. A round is host-synchronous, so the dispatch depth is 0
under speculation whatever ``async_depth`` says.

At ``async_depth=0`` every step is harvested in the iteration that
dispatched it. The dispatch sequence does not depend on the depth, so
greedy outputs are the same at every depth. Host bookkeeping is
optimistic at dispatch (page growth, seq_lens, per-request dispatch
cursors) and authoritative at harvest (committed tokens, prefix
publishing, latency marks, finishes). An EOS learnt at harvest may leave
up to ``async_depth`` stale decode steps in flight; their tokens are
discarded, and their writes touched only the finished request's own
frontier page.

Recurrent models (recurrentgemma, xlstm) keep per-slot state rows in the
StateStore beside or instead of KV pages; the prefix cache turns itself
off for them, a model without attention holds no pages at all, and where
every attention layer is windowed, pages that slide out of the window go
back to the pool mid-request. Under speculative decoding a target with
state rows takes a commit pass after each round's rejection sampling (the
verify pass leaves its rows as they were), and a model drafter with state
rows snapshots them around its draft steps (``spec/drafter.py``).

Observability is the reference's (``repro_torch.obs``): each request is a
``request`` span on its own track, holding ``queued`` (reopened on a
preemption), one ``prefill_chunk`` a committed chunk and ``decode`` (first
token to finish), with the instants ``admitted``, ``preempted`` and
``finished``; a speculative round is a synchronous ``spec_round`` span on
the device track with ``draft``, ``verify`` and ``commit`` inside it (the
commit phase holds the state-row commit pass and the round's one copy to
the host). Tracing is off by default (``NullTracer``), and off it builds
no event argument.

The static-batch path (:func:`generate_static`) lives here too: the
ring-buffer baseline that ``launch/serve.py --mode static`` runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.transformer import resolve_device
from repro_torch.obs import (
    DEVICE_TID,
    PID_DEVICE,
    PID_REQUESTS,
    MetricsRegistry,
    NullTracer,
    StepProfiler,
)
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.sampling import GREEDY, SamplingParams, sample_logits, stack_params
from repro_torch.serving.scheduler import RUNNING, Request, Scheduler
from repro_torch.serving.spec import ModelDrafter, NgramDrafter, SpecConfig, Verifier, effective_k


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Sizing of the serving engine (all shapes derive from these)."""

    num_slots: int = 4  # concurrent decode lanes (the fixed batch)
    page_size: int = 16  # tokens per KV page
    max_seq_len: int = 256  # per-request prompt + generation cap
    # Total pages including the null page; default: every slot's worst case.
    num_pages: Optional[int] = None
    token_budget: Optional[int] = None  # cap on sum(max_total) in flight
    prefill_bucket: int = 32  # unchunked prompts pad up to a multiple of this
    # Chunked prefill: prompts advance one fixed-size chunk per step,
    # interleaved with decode steps. None = whole-prompt prefill.
    prefill_chunk: Optional[int] = None
    # Prefix caching: published full prompt pages are shared (refcounted,
    # copy-on-write on a partial tail) into later requests with the same
    # prompt prefix.
    prefix_cache: bool = False
    # A queued higher-priority request may evict a strictly lower-priority
    # request that is still prefilling.
    preemption: bool = False
    # Admission passes a queued request waits per priority level gained.
    aging_steps: int = 32
    # Device steps that may be in flight before the host waits for the
    # oldest. 0 = synchronous; greedy outputs are the same at every depth.
    async_depth: int = 0
    # Pack every prefilling slot into one (P, prefill_chunk) step, P
    # bucketed to {1, 2, 4, 8} (clamped to num_slots). Needs prefill_chunk.
    prefill_batch: bool = False

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    def bucket(self, prompt_len: int) -> int:
        if self.prefill_chunk is not None:
            return self.prefill_chunk
        b = self.prefill_bucket
        return -(-prompt_len // b) * b


class TokenEvent(NamedTuple):
    """One streamed token, emitted when it is harvested."""

    rid: int
    token: int
    index: int  # position within the generated sequence
    finished: bool
    finish_reason: Optional[str]


class ServerStats:
    """Read-only view over the server's :class:`MetricsRegistry` — the
    registry is the single source of truth (one set of counters feeds the
    launcher report, the benchmark rows, the Prometheus exposition and the
    JSON snapshot); this class keeps the field names every caller already
    uses. Constructible standalone (fresh registry) for tests."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._m = registry if registry is not None else MetricsRegistry()

    def _c(self, name: str) -> float:
        return self._m.counter(name).value

    @property
    def prefill_calls(self) -> int:
        return int(self._c("serving_prefill_calls_total"))

    @property
    def prefill_tokens(self) -> int:
        """Valid prompt tokens prefilled."""
        return int(self._c("serving_prefill_tokens_total"))

    @property
    def decode_steps(self) -> int:
        return int(self._c("serving_decode_steps_total"))

    @property
    def decode_tokens(self) -> int:
        """Tokens sampled for *active* slots."""
        return int(self._c("serving_decode_tokens_total"))

    @property
    def slot_steps(self) -> int:
        """decode_steps * num_slots (capacity offered)."""
        return int(self._c("serving_slot_steps_total"))

    @property
    def prefill_s(self) -> float:
        return self._c("serving_prefill_seconds_total")

    @property
    def decode_s(self) -> float:
        return self._c("serving_decode_seconds_total")

    # Prefix cache: prompt tokens satisfied from published pages vs all
    # prompt tokens admitted (a preempted request's resume counts again).
    # The scheduler's counters are the authority; gauges mirror them.
    @property
    def prefix_hit_tokens(self) -> int:
        return int(self._m.gauge("serving_prefix_hit_tokens").value)

    @property
    def prefix_prompt_tokens(self) -> int:
        return int(self._m.gauge("serving_prefix_prompt_tokens").value)

    @property
    def cow_copies(self) -> int:
        """Copy-on-write page copies performed."""
        return int(self._c("serving_cow_copies_total"))

    @property
    def preemptions(self) -> int:
        """Prefilling requests evicted back to the queue."""
        return int(self._m.gauge("serving_preemptions").value)

    # Speculative decoding: verify rounds run, drafts fielded, drafts the
    # rejection sampler accepted.
    @property
    def spec_steps(self) -> int:
        return int(self._c("serving_spec_steps_total"))

    @property
    def spec_drafted(self) -> int:
        return int(self._c("serving_spec_drafted_total"))

    @property
    def spec_accepted(self) -> int:
        return int(self._c("serving_spec_accepted_total"))

    @property
    def nonfinite_steps(self) -> int:
        """Steps whose live logits held inf or NaN (the port's own counter)."""
        return int(self._c("serving_nonfinite_steps_total"))

    @property
    def utilization(self) -> float:
        """Fraction of offered decode-lane steps that produced a token —
        the serving analogue of the paper's CE-array utilization. Under
        speculative decoding one lane-step can emit several tokens, so
        this can exceed 1.0 — that surplus IS the speedup."""
        return self.decode_tokens / self.slot_steps if self.slot_steps else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Fraction of fielded draft tokens the target accepted."""
        if not self.spec_drafted:
            return 0.0
        return self.spec_accepted / self.spec_drafted

    @property
    def accepted_per_step(self) -> float:
        """Mean accepted draft tokens per speculative verify round (the
        emitted tokens per round are this + 1)."""
        if not self.spec_steps:
            return 0.0
        return self.spec_accepted / self.spec_steps

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from the prefix cache."""
        if not self.prefix_prompt_tokens:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_prompt_tokens

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s


@dataclasses.dataclass
class _DispatchState:
    """Per-request host cursor of work dispatched (``req.prefilled`` and
    ``req.out_tokens`` advance only at harvest). ``epoch`` is
    ``req.preemptions`` at install: a step dispatched before a preemption
    carries the old epoch, and its harvest is skipped."""

    prefilled: int
    generated: int
    epoch: int


class Server:
    """Continuous-batching inference server over the engine's StateStore.
    The model's engine decides the path: on the ``"cuda"`` backend every
    GEMM and the decode attention launch the port's kernels, and the decode
    step is a CUDA graph.

    ``device`` is the card by default; it raises when CUDA is absent unless
    the caller asks for ``"cpu"``, and the model must live there.

    ``spec`` turns on speculative decoding with the n-gram drafter, or with
    ``draft_model``/``draft_params`` (a model sharing the target's
    vocabulary, on the same device) as the drafter; a ``draft_model``
    without ``spec`` takes the default :class:`SpecConfig`.

    ``tracer`` (default the zero-overhead ``NullTracer``), ``metrics`` (the
    registry, always on: it holds the stats) and ``profiler`` are the
    reference's observability hooks (``repro_torch.obs``)."""

    def __init__(self, model, params, config: Optional[ServerConfig] = None, *,
                 seed: int = 0, device="cuda", spec: Optional[SpecConfig] = None,
                 draft_model=None, draft_params=None, tracer=None,
                 metrics: Optional[MetricsRegistry] = None,
                 profiler: Optional[StepProfiler] = None):
        if config is None:
            config = ServerConfig()
        if config.async_depth < 0:
            raise ValueError("async_depth must be >= 0")
        if config.prefill_batch and config.prefill_chunk is None:
            raise ValueError("prefill_batch packs (P, prefill_chunk) steps and needs a fixed "
                             "chunk shape: set prefill_chunk")
        device = resolve_device(device)
        if model.device.type != device.type:
            raise ValueError(f"the model lives on {model.device}, the server on {device}")
        self.tracer = tracer if tracer is not None else NullTracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.profiler = profiler if profiler is not None else StepProfiler()
        self._bind_metrics()
        self.model = model
        self.params = params
        self.config = config
        self.profile = model.cb_profile()
        # Prefix caching shares KV pages only: a model with state rows cannot
        # skip prefill positions (their state updates would be skipped too),
        # and one without pages has nothing to share, so it turns itself off.
        self.prefix_cache = (config.prefix_cache and self.profile.needs_kv_pages
                             and not self.profile.has_state_rows)
        if draft_model is not None and spec is None:
            spec = SpecConfig()
        self.engine = EngineCore(model, params, config, self.profile, seed=seed,
                                 tracer=self.tracer, metrics=self.metrics,
                                 profiler=self.profiler)
        self.spec = spec
        self.drafter = self.verifier = None
        if spec is not None:
            if draft_model is not None:
                if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                    raise ValueError("drafter and target must share a vocabulary: "
                                     f"{draft_model.cfg.vocab_size} != {model.cfg.vocab_size}")
                if draft_model.device.type != device.type:
                    raise ValueError(f"the drafter lives on {draft_model.device}, the server "
                                     f"on {device}")
                self.drafter = ModelDrafter(
                    draft_model, draft_params, num_slots=config.num_slots,
                    page_size=config.page_size, max_seq_len=config.max_seq_len, k=spec.k,
                    draft_chunk=spec.draft_chunk, metrics=self.metrics)
            else:
                self.drafter = NgramDrafter(k=spec.k, ngram_n=spec.ngram_n,
                                            metrics=self.metrics)
            self.verifier = Verifier(model, params, num_slots=config.num_slots, k=spec.k,
                                     page_size=config.page_size,
                                     pages_per_slot=config.pages_per_slot,
                                     metrics=self.metrics)
        self._fresh_state()

    def _bind_metrics(self) -> None:
        """Resolve the registry handles the step loop increments. Names are
        the reference's public metric surface; the step seconds and
        ``serving_nonfinite_steps_total`` (the port's addition) belong to the
        engine core, which the spec round charges through
        ``EngineCore.charge_decode``. Handles survive ``metrics.reset()``
        (metrics zero in place)."""
        m = self.metrics
        self._c_prefill_calls = m.counter(
            "serving_prefill_calls_total", "prefill chunk advances committed")
        self._c_prefill_tokens = m.counter(
            "serving_prefill_tokens_total", "valid prompt tokens prefilled")
        self._c_decode_steps = m.counter(
            "serving_decode_steps_total", "decode/spec rounds run")
        self._c_decode_tokens = m.counter(
            "serving_decode_tokens_total", "tokens sampled for active slots")
        self._c_slot_steps = m.counter(
            "serving_slot_steps_total", "decode lane-steps offered")
        self._c_cow = m.counter(
            "serving_cow_copies_total", "copy-on-write page copies")
        self._c_spec_steps = m.counter(
            "serving_spec_steps_total", "speculative verify rounds")
        self._c_spec_drafted = m.counter(
            "serving_spec_drafted_total", "draft tokens fielded")
        self._c_spec_accepted = m.counter(
            "serving_spec_accepted_total", "draft tokens accepted")
        self._g_prefix_hit = m.gauge(
            "serving_prefix_hit_tokens",
            "prompt tokens served from the prefix cache (scheduler mirror)")
        self._g_prefix_prompt = m.gauge(
            "serving_prefix_prompt_tokens",
            "prompt tokens admitted (scheduler mirror)")
        self._g_preemptions = m.gauge(
            "serving_preemptions", "preemptions (scheduler mirror)")
        self._h_ttft = m.histogram(
            "serving_ttft_seconds", help="submit -> first token, queue incl.")
        self._h_itl = m.histogram(
            "serving_inter_token_seconds",
            help="gap between a request's consecutive emitted tokens")
        self._h_queue_wait = m.histogram(
            "serving_queue_wait_seconds",
            help="enqueue (submit or preemption) -> admission")
        self._h_acc_round = m.histogram(
            "serving_spec_accepted_per_round", bounds=list(range(33)),
            help="accepted drafts per decoding row per verify round")

    @property
    def cache(self):
        """The engine's StateStore (page table, seq_lens, pools)."""
        return self.engine.cache

    @property
    def seed(self) -> int:
        return self.engine.seed

    @seed.setter
    def seed(self, value: int) -> None:
        self.engine.seed = value

    def _fresh_state(self, pools=None) -> None:
        cfg = self.config
        # Metrics and trace events reset with the rest of the serving state,
        # so warm-up counters never leak into a timed run's report; the step
        # profiler survives, so a shape's first call stays with the warm-up.
        self.metrics.reset()
        self.tracer.reset()
        self.engine.fresh(pools=pools)
        self.scheduler = Scheduler(
            num_slots=cfg.num_slots, pool=self.cache.allocator,
            pages_per_slot=cfg.pages_per_slot, max_seq_len=cfg.max_seq_len,
            token_budget=cfg.token_budget, kv_reserve_tokens=self.engine.reserve_tokens_cap(),
            prefix_cache=self.prefix_cache, preemption=cfg.preemption,
            aging_steps=cfg.aging_steps, metrics=self.metrics,
        )
        self.stats = ServerStats(self.metrics)
        self.results: dict[int, Request] = {}
        self._slot_req: dict[int, Request] = {}  # slot -> running request
        self._disp: dict[int, _DispatchState] = {}  # rid -> dispatch cursor
        if self.drafter is not None:
            self.drafter.reset()

    def reset(self) -> None:
        """Drop all serving state; keep the pools (stale K/V are never read
        back as valid) and with them the decode graph. Steps in flight are
        harvested first and their events discarded. The metrics zero in
        place and the trace events go; the step profiler stays."""
        self._drain([])
        self._fresh_state(pools=self.cache.pools)

    # -- request intake ----------------------------------------------------
    def submit(self, prompt: Iterable[int], *, max_new_tokens: int = 32,
               sampling: SamplingParams = GREEDY, eos_id: Optional[int] = None,
               priority: int = 0, spec_k: Optional[int] = None) -> Request:
        req = self.scheduler.submit(Request(
            prompt=[int(t) for t in prompt], max_new_tokens=max_new_tokens,
            sampling=sampling, eos_id=eos_id, priority=priority, spec_k=spec_k,
        ))
        req.t_submit = req.t_queued = time.perf_counter()
        t = self.tracer
        if t.enabled:
            t.begin(PID_REQUESTS, req.rid, "request", rid=req.rid, prompt_len=req.prompt_len,
                    max_new_tokens=req.max_new_tokens, priority=priority)
            t.begin(PID_REQUESTS, req.rid, "queued")
        return req

    # -- the step loop -----------------------------------------------------
    @torch.inference_mode()
    def step(self) -> list[TokenEvent]:
        """One scheduler iteration: admit, dispatch one prefill chunk per
        prefilling request (batched with ``prefill_batch``) and one decode
        over every slot, then harvest down to ``async_depth``. Returns the
        tokens harvested (possibly none while work is in flight). Runs under
        ``torch.inference_mode``: serving records no autograd graph."""
        events: list[TokenEvent] = []
        for req in self.scheduler.admit(on_preempt=self._on_preempt):
            self._install(req)
        # The scheduler's counters are the authority; the gauges mirror them.
        self._g_prefix_hit.set(self.scheduler.prefix_hit_tokens)
        self._g_prefix_prompt.set(self.scheduler.prefix_prompt_tokens)
        self._g_preemptions.set(self.scheduler.preemptions)
        prefilling = [req for req in self.scheduler.running.values()
                      if self._dispatch_prefilling(req)]
        dispatched = 0
        if prefilling:
            if self.config.prefill_batch:
                dispatched += self._dispatch_prefill_batched(prefilling)
            else:
                for req in prefilling:
                    self._dispatch_prefill_serial(req)
                    dispatched += 1
        if self.spec is not None:
            # A speculative round is host-synchronous: harvest the prefill
            # steps first (committing first tokens), so the round sees the
            # state a synchronous server would.
            self._drain(events)
            if any(r.decoding for r in self.scheduler.running.values()):
                self._spec_decode_once(events)
            return events
        decoding = self._decode_candidates()
        if decoding:
            self._dispatch_decode(decoding)
            dispatched += 1
        while self.engine.num_inflight > self.config.async_depth:
            self._harvest_one(events)
        if not dispatched and self.engine.num_inflight:
            # Everything admissible is in flight: consume one result so the
            # loop always moves toward the drain.
            self._harvest_one(events)
        return events

    def run(self) -> dict[int, Request]:
        """Drain the queue; returns {rid: finished Request}."""
        while self.scheduler.has_work():
            self.step()
        self._drain([])  # EOS-overshoot leftovers; their commits are stale
        return dict(self.results)

    def stream(self):
        """Generator over TokenEvents until all submitted work finishes."""
        while self.scheduler.has_work():
            yield from self.step()
        tail: list[TokenEvent] = []
        self._drain(tail)
        yield from tail

    def ttft_percentiles(self, qs=(50, 95)) -> Optional[tuple[float, ...]]:
        """Submit -> first-token wall seconds at the given percentiles over
        finished requests (queueing included); None before any finished."""
        ttft = [r.t_first_token - r.t_submit for r in self.results.values()
                if r.t_first_token is not None]
        if not ttft:
            return None
        return tuple(float(np.percentile(ttft, q)) for q in qs)

    def warmup(self, prompt_lens: Iterable[int], max_new_tokens: int = 2) -> None:
        """Run every prefill bucket the given prompt lengths hit and the
        decode step once (on the card: build the kernels and capture the
        decode graph), then reset, so a timed run right after measures the
        steady state."""
        seen: set[int] = set()
        for pl in prompt_lens:
            tb = self.config.bucket(pl)
            if tb in seen:
                continue
            seen.add(tb)
            self.submit([1] * pl, max_new_tokens=max_new_tokens)
        self.run()
        self.reset()

    # -- internals ---------------------------------------------------------
    def _gen_cap(self, req: Request) -> int:
        """Tokens this request may generate in total: dispatch stops exactly
        where ``scheduler.commit`` will declare FINISH_LENGTH."""
        return max(0, min(req.max_new_tokens, req.max_total - req.prompt_len))

    def _dispatch_prefilling(self, req: Request) -> bool:
        ds = self._disp.get(req.rid)
        return ds is not None and ds.prefilled < req.prompt_len

    def _decode_candidates(self) -> list:
        out = []
        for slot, req in self.scheduler.running.items():
            ds = self._disp.get(req.rid)
            if ds is None or ds.prefilled < req.prompt_len:
                continue
            if ds.generated >= self._gen_cap(req):
                continue
            out.append((slot, req, ds))
        return out

    def _mirror_pages(self, req: Request, grown) -> None:
        for idx, page in grown:
            self.cache.set_page(req.slot, idx, page)

    def _grow_pages(self, req: Request, end_position: int) -> None:
        """Pages for writes at positions < ``end_position`` (none for a
        model without KV pages), mirrored into the page table."""
        if self.profile.needs_kv_pages:
            self._mirror_pages(req, self.scheduler.ensure_pages(req, end_position))

    def _recycle_window(self, req: Request) -> None:
        """Return the request's pages that have slid wholly out of the
        attention window to the pool, and NULL their page-table entries
        (only for a model whose every attention layer is windowed)."""
        window = self.profile.kv_window
        if window is None:
            return
        freed = self.scheduler.release_out_of_window(req, int(self.cache.seq_lens[req.slot]),
                                                     window)
        self.cache.clear_pages(req.slot, freed)

    def _on_preempt(self, slot: int) -> None:
        """The scheduler evicted this slot's request: NULL its page-table
        row and drop its dispatch cursor (its steps in flight carry the old
        epoch and are skipped at harvest)."""
        self.cache.reset_slot(slot)
        if self.drafter is not None:
            self.drafter.release_slot(slot)
        req = self._slot_req.pop(slot, None)
        if req is not None:
            self._disp.pop(req.rid, None)
            req.t_queued = time.perf_counter()
            t = self.tracer
            if t.enabled:
                t.instant(PID_REQUESTS, req.rid, "preempted", prefilled=req.prefilled, slot=slot)
                t.begin(PID_REQUESTS, req.rid, "queued")

    def _install(self, req: Request) -> None:
        """Wire a newly admitted request into the device state: mirror its
        prefix pages, run the copy-on-write copies, and start its committed
        length at the cached prefix."""
        now = time.perf_counter()
        req.t_admit = now
        self._h_queue_wait.observe(now - req.t_queued)
        self._slot_req[req.slot] = req
        self._disp[req.rid] = _DispatchState(prefilled=req.prefilled,
                                             generated=len(req.out_tokens),
                                             epoch=req.preemptions)
        t = self.tracer
        if t.enabled:
            t.end(PID_REQUESTS, req.rid, "queued")
            t.instant(PID_REQUESTS, req.rid, "admitted", slot=req.slot,
                      prefix_hit_tokens=req.cached_tokens, cow_copies=len(req.pending_copies),
                      preemptions=req.preemptions)
        self._mirror_pages(req, list(enumerate(req.pages)))
        for src, dst in req.pending_copies:
            self.engine.copy_page(src, dst)
            self._c_cow.inc()
        req.pending_copies = []
        self.cache.seq_lens[req.slot] = req.prefilled

    # -- dispatch (optimistic host state) ----------------------------------
    def _dispatch_prefill_serial(self, req: Request) -> None:
        """Dispatch one prompt chunk of one slot. A prefix-hit request starts
        at its first uncached position and gathers the mapped pages back,
        so it always takes the chunked step, even with chunked prefill off
        (the suffix then runs as one bucketed chunk)."""
        cfg = self.config
        ds = self._disp[req.rid]
        start = ds.prefilled
        if cfg.prefill_chunk is None:
            n = req.prompt_len - start
            tb = cfg.bucket(n)
            kind = "prefill_chunk" if start > 0 else "prefill_full"
        else:
            n = min(cfg.prefill_chunk, req.prompt_len - start)
            tb = cfg.prefill_chunk
            kind = "prefill_chunk"
        self._grow_pages(req, start + n)
        toks = np.zeros((1, tb), np.int32)
        toks[0, :n] = req.prompt[start:start + n]
        final = start + n == req.prompt_len
        self.engine.dispatch_prefill(
            kind=kind, tokens=toks, page_row=self.cache.page_table[req.slot], slot=req.slot,
            start=start, n=n, bucket=tb, sampling=req.sampling if final else None,
            payload=[(req, ds.epoch, start, n, final)], rid=req.rid,
        )
        ds.prefilled = start + n
        if final:
            ds.generated += 1  # the final chunk samples the first token
        self.cache.seq_lens[req.slot] = ds.prefilled
        self._recycle_window(req)

    def _dispatch_prefill_batched(self, prefilling: list) -> int:
        """Dispatch every prefilling request's next chunk as (P, chunk)
        steps, P bucketed to the engine's allowed set. Pad rows are inactive
        and carry a slot id apart from the group's active slots (the
        reference's rule: a pad's masked state write-back must not race a
        real row's; here it writes the old last token back). Returns the
        number of steps dispatched."""
        cfg = self.config
        chunk = cfg.prefill_chunk
        max_b = self.engine.allowed_buckets()[-1]
        dispatched = 0
        for i in range(0, len(prefilling), max_b):
            group = prefilling[i:i + max_b]
            if len(group) == 1:
                # A lone prefilling request takes the serial (1, chunk) step.
                self._dispatch_prefill_serial(group[0])
                dispatched += 1
                continue
            p = self.engine.bucket_for(len(group))
            toks = np.zeros((p, chunk), np.int32)
            page_rows = np.zeros((p, cfg.pages_per_slot), np.int32)
            slots = np.zeros((p,), np.int32)
            starts = np.zeros((p,), np.int32)
            lengths = np.zeros((p,), np.int32)
            active = np.zeros((p,), bool)
            final_mask = np.zeros((p,), bool)
            sampling_list = [GREEDY] * p
            rows = []
            used = set()
            for r, req in enumerate(group):
                ds = self._disp[req.rid]
                start = ds.prefilled
                n = min(chunk, req.prompt_len - start)
                self._grow_pages(req, start + n)
                toks[r, :n] = req.prompt[start:start + n]
                page_rows[r] = self.cache.page_table[req.slot]
                slots[r] = req.slot
                starts[r] = start
                lengths[r] = n
                active[r] = True
                final = start + n == req.prompt_len
                final_mask[r] = final
                sampling_list[r] = req.sampling
                used.add(req.slot)
                rows.append((req, ds.epoch, start, n, final))
            pad_slots = [s for s in range(cfg.num_slots) if s not in used]
            for r in range(len(group), p):
                slots[r] = pad_slots[0]  # pads may share a slot between them
            self.engine.dispatch_prefill_batch(
                tokens=toks, page_rows=page_rows, slots=slots, starts=starts, lengths=lengths,
                active=active, final_mask=final_mask, sampling_list=sampling_list,
                payload=rows, rids=[req.rid for req in group],
            )
            dispatched += 1
            for req, _, start, n, final in rows:
                ds = self._disp[req.rid]
                ds.prefilled = start + n
                if final:
                    ds.generated += 1
                self.cache.seq_lens[req.slot] = ds.prefilled
                self._recycle_window(req)
        return dispatched

    def _dispatch_decode(self, decoding: list) -> None:
        n = self.config.num_slots
        active = np.zeros((n,), bool)
        params_list = [GREEDY] * n
        rows = []
        for slot, req, ds in decoding:
            self._grow_pages(req, int(self.cache.seq_lens[slot]) + 1)
            active[slot] = True
            params_list[slot] = req.sampling
            rows.append((slot, req, ds.epoch))
        self.engine.dispatch_decode(active=active, params_list=params_list, payload=rows)
        for slot, req, ds in decoding:
            ds.generated += 1
            self.cache.seq_lens[slot] += 1
            self._recycle_window(req)

    # -- speculative decoding ------------------------------------------------
    def _spec_decode_once(self, events: list[TokenEvent]) -> None:
        """One speculative round over every decoding slot: draft up to k,
        verify k + 1 positions in one fixed-shape step, rejection-sample,
        then commit the accepted drafts and one token of the target's a row.

        The target's K/V written past the accepted prefix needs no undo:
        ``seq_lens`` does not advance over it, so it is never read back, and
        the next round overwrites it. The target's state rows take the
        verifier's commit pass, over accepted + 1 tokens a row, before the
        round's one copy to the host. The drafter rolls itself back
        (``drafter.py``). Window recycling keeps the reference's rule: the
        verify pass writes at the committed length and past it, and only
        pages wholly below the committed length less the window go back to
        the pool, after the round."""
        spec = self.spec
        decoding = [(slot, req) for slot, req in self.scheduler.running.items()
                    if req.decoding]
        n = self.config.num_slots
        want = np.zeros((n,), np.int32)
        active = np.zeros((n,), bool)
        contexts: dict[int, list[int]] = {}
        params_list = [GREEDY] * n
        for slot, req in decoding:
            committed = int(self.cache.seq_lens[slot])
            remaining = min(req.max_new_tokens - req.num_generated,
                            req.max_total - req.prompt_len - req.num_generated)
            want[slot] = effective_k(spec.k if req.spec_k is None else req.spec_k, spec.k,
                                     remaining, req.max_total - 1 - committed)
            active[slot] = True
            contexts[slot] = req.prompt + req.out_tokens
            params_list[slot] = req.sampling
        t = self.tracer
        if t.enabled:
            t.begin(PID_DEVICE, DEVICE_TID, "spec_round", slots=n, decoding=len(decoding),
                    k=spec.k)
            t.begin(PID_DEVICE, DEVICE_TID, "draft")
        t0 = time.perf_counter()
        gen = self.engine.generator
        proposal = self.drafter.propose(contexts, want, gen, params_list)
        if t.enabled:
            t.end(PID_DEVICE, DEVICE_TID, "draft")
        k_eff = np.minimum(want, proposal.counts)
        lengths = np.where(active, k_eff + 1, 0).astype(np.int32)
        tokens = np.zeros((n, spec.k + 1), np.int32)
        for slot, req in decoding:
            tokens[slot, 0] = req.out_tokens[-1]
            m = int(k_eff[slot])
            tokens[slot, 1:1 + m] = proposal.tokens[slot, :m]
            self._grow_pages(req, int(self.cache.seq_lens[slot]) + m + 1)
        if t.enabled:
            t.begin(PID_DEVICE, DEVICE_TID, "verify", width=spec.k + 1, rows=len(decoding))
        logits = self.verifier.verify(self.cache.pools, tokens, self.cache.page_table,
                                      self.cache.seq_lens, lengths, active, params_list)
        out, acc, finite = self.verifier.sample(logits, proposal.logits, gen)
        if t.enabled:
            t.end(PID_DEVICE, DEVICE_TID, "verify")
            t.begin(PID_DEVICE, DEVICE_TID, "commit")
        if self.verifier.needs_state_commit:
            self.verifier.commit_state(self.cache.pools, acc)
        res = torch.cat([out.flatten(), acc, finite.to(torch.int32)[None]]).cpu().numpy()
        out, acc = res[:out.numel()].reshape(out.shape), res[out.numel():-1]
        dt = time.perf_counter() - t0
        if t.enabled:
            t.end(PID_DEVICE, DEVICE_TID, "commit")
            t.end(PID_DEVICE, DEVICE_TID, "spec_round")
        self.verifier.observe()  # the verify step's time, read after the copy above
        self.engine.charge_decode(dt, bool(res[-1]))
        self.profiler.record("spec_round", n, dt)
        self._c_decode_steps.inc()
        self._c_slot_steps.inc(n)
        self._c_spec_steps.inc()
        for slot, req in decoding:
            a = int(acc[slot])
            self._c_spec_drafted.inc(int(k_eff[slot]))
            self._c_spec_accepted.inc(a)
            self._h_acc_round.observe(a)
            req.spec_accepted += a
            ds = self._disp.get(req.rid)
            emitted = 0
            for j in range(a + 1):
                self._commit(req, int(out[slot, j]), events)
                emitted += 1
                if req.finish_reason is not None:
                    break  # accepted tokens past EOS are discarded
            self._c_decode_tokens.inc(emitted)
            if req.finish_reason is None:
                if ds is not None:
                    ds.generated += emitted
                self.cache.seq_lens[slot] += a + 1
                self._recycle_window(req)

    # -- harvest (authoritative commits) -----------------------------------
    def _drain(self, events: list[TokenEvent]) -> None:
        while self._harvest_one(events):
            pass

    def _harvest_one(self, events: list[TokenEvent]) -> bool:
        """Consume the oldest step in flight: commit its tokens and prefix
        state and emit TokenEvents. Rows whose request was preempted (old
        epoch) or already finished (EOS overshoot) are discarded. Returns
        False when nothing was in flight."""
        res = self.engine.harvest_one()
        if res is None:
            return False
        rec, toks = res
        if rec.kind == "decode":
            committed = 0
            for slot, req, epoch in rec.payload:
                if req.status != RUNNING or req.preemptions != epoch or req.slot != slot:
                    continue
                self._commit(req, int(toks[slot]), events)
                committed += 1
            self._c_decode_steps.inc()
            self._c_slot_steps.inc(self.config.num_slots)
            self._c_decode_tokens.inc(committed)
        else:
            t = self.tracer
            for i, (req, epoch, start, n, final) in enumerate(rec.payload):
                if req.status != RUNNING or req.preemptions != epoch:
                    continue
                if t.enabled:
                    t.begin(PID_REQUESTS, req.rid, "prefill_chunk", start=start, tokens=n)
                    t.end(PID_REQUESTS, req.rid, "prefill_chunk")
                req.prefilled = start + n
                self.scheduler.publish_prefix(req)
                self._c_prefill_calls.inc()
                self._c_prefill_tokens.inc(n)
                if final:
                    self._commit(req, int(toks[i]), events)
        return True

    def _commit(self, req: Request, token: int, events: list[TokenEvent]) -> None:
        """Commit one harvested token; latency marks are stamped here, where
        its value reaches the host, never at dispatch."""
        now = time.perf_counter()
        t = self.tracer
        if req.t_first_token is None:
            req.t_first_token = now
            self._h_ttft.observe(now - req.t_submit)
            if t.enabled:
                t.begin(PID_REQUESTS, req.rid, "decode")
        elif req.t_last_token is not None:
            self._h_itl.observe(now - req.t_last_token)
        req.t_last_token = now
        finished = self.scheduler.commit(req, token)
        events.append(TokenEvent(rid=req.rid, token=token, index=req.num_generated - 1,
                                 finished=finished, finish_reason=req.finish_reason))
        if finished:
            slot = req.slot
            req.t_finish = now
            self.scheduler.finish(req)
            self.cache.reset_slot(slot)
            if self.drafter is not None:
                self.drafter.release_slot(slot)
            self.results[req.rid] = req
            self._slot_req.pop(slot, None)
            self._disp.pop(req.rid, None)
            if t.enabled:
                t.instant(PID_REQUESTS, req.rid, "finished", finish_reason=req.finish_reason,
                          generated=req.num_generated)
                t.end(PID_REQUESTS, req.rid, "decode")
                t.end(PID_REQUESTS, req.rid, "request", prefix_hit_tokens=req.cached_tokens,
                      spec_accepted=req.spec_accepted, generated=req.num_generated)


# -- static-batch reference path ---------------------------------------------

class StaticStats(NamedTuple):
    prefill_s: float
    first_decode_s: float  # the first decode step, excluded from tok/s
    steady_s: float
    steady_steps: int
    batch: int

    @property
    def decode_tok_s(self) -> float:
        if not self.steady_steps or not self.steady_s:
            return 0.0
        return self.batch * self.steady_steps / self.steady_s


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate_static(model, params, batch: dict, *, max_new_tokens: int,
                    sampling: SamplingParams = GREEDY, seed: int = 0):
    """Static-batch generation on the ring-buffer cache: every sequence
    shares one position, and the batch runs ``max_new_tokens`` steps
    whatever each sequence needs. batch: {"tokens": (B, T)} on the model's
    device, with the VLM's "vis_embeds" (B, P, d) or the encoder-decoder's
    "frames" (B, Se, d). The ring holds the image prefix too (P + T +
    max_new_tokens positions: the reference's launcher sizes it without P,
    so its decode steps overwrite the patches), and the cross K/V Se
    frames. Returns (generated (B, max_new_tokens) numpy array,
    :class:`StaticStats`); steady-state tok/s excludes the prefill and the
    first decode step."""
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = model.device
    prefix = batch["vis_embeds"].shape[1] if "vis_embeds" in batch else 0
    cross = batch["frames"].shape[1] if "frames" in batch else 0
    cache = model.init_cache(b, prefix + t + max_new_tokens, cross_len=cross)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sp = {k: torch.from_numpy(v).to(dev) for k, v in stack_params([sampling] * b).items()}

    def pick(logits):
        return sample_logits(logits, gen, **sp)[:, None]

    t0 = time.perf_counter()
    tok = pick(model.prefill(params, batch, cache)[:, -1])
    _wait(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    first_decode_s = steady_s = 0.0
    steady_steps = 0
    for i in range(max_new_tokens - 1):
        t0 = time.perf_counter()
        tok = pick(model.decode_step(params, tok.long(), cache)[:, 0])
        _wait(dev)
        dt = time.perf_counter() - t0
        if i == 0:
            first_decode_s = dt
        else:
            steady_s += dt
            steady_steps += 1
        out.append(tok)
    seqs = torch.cat(out, dim=1).cpu().numpy()
    return seqs, StaticStats(prefill_s, first_decode_s, steady_s, steady_steps, b)
