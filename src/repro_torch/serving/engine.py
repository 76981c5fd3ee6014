"""The serving engine core of the port: device steps with a window of
dispatched steps, the per-slot last-token tensor, the sampling generator,
and the decode step replayed as a CUDA graph (counterpart of
``repro.serving.engine.EngineCore``, with its tracer, metrics and step
profiler).

A ``dispatch_*`` call enqueues a step on the current stream and returns;
:meth:`EngineCore.harvest_one` waits for the oldest step only, never for
the whole stream. The server lets up to ``async_depth`` steps stay in
flight, so the host schedules step t+1 while the card runs step t. Every
step runs in dispatch order on one stream, which is what makes the host's
optimistic bookkeeping at dispatch safe (see ``repro.serving.engine``).

On the card a step never waits for the card at dispatch:

- **Inputs.** Every host array a step reads (tokens, page rows, the page
  table, sequence lengths, the active mask and the sampling parameters) is
  copied at dispatch into one pinned staging buffer owned by that step,
  which goes to the card with one ``non_blocking`` copy and is released
  only when the step is harvested. This is the reference's aliasing rule
  (``engine.py:329-335``): the server mutates its numpy mirrors right after
  dispatch, and the copy must have read them first.
- **Outputs.** Each step enqueues a ``non_blocking`` copy of its sampled
  tokens and its finite flag into pinned host memory and records a
  ``torch.cuda.Event`` after it; the harvest waits on that event.

**The decode graph.** ``jax.jit`` makes the reference's fixed-shape decode
step one cheap dispatch; the port's counterpart captures ``decode_cb`` as a
``torch.cuda.CUDAGraph`` on the ``"cuda"`` backend and replays it once a
step (a :class:`GraphStep`). The graph reads static device buffers (the
page table, sequence lengths and active mask, refreshed by each step's one
staged copy, and the last-token tensor) and holds the addresses of the
pools and parameters. It is captured at the first decode step after one
eager warm-up call on zeroed inputs (every slot inactive, so the warm-up
writes only the null page), which builds what the kernels make lazily:
the kernel library and the decode combine's ticket counters. A ``fresh``
that keeps the pools keeps the graph; new pools capture again. Sampling
and the last-token merge run eagerly after the replay. A graph that fails
to capture or to replay raises: there is no eager fallback.
``graph_decode=False`` runs the same step eagerly on the card (the tests
and ``chip_smoke.py`` compare the two); on the CPU nothing is captured and
the keyword is ignored.

The speculative steps (the verify step, the model drafter's catch-up and
decode) are fixed-shape too, each a :class:`GraphStep` of its own.

**Observability** (the reference's, ``repro/serving/engine.py``): each
dispatch is a ``<kind>.dispatch`` span on the device "steps" track (the
host's enqueue only), and each harvest records the host's wait on the
step's event (``engine_idle_seconds``), charges the step's seconds to
``serving_prefill_seconds_total`` or ``serving_decode_seconds_total`` and
their step histograms and to the :class:`~repro_torch.obs.StepProfiler`,
and emits a ``<kind>.complete`` event on the "in flight" track, backdated
to the dispatch. Nothing here synchronises the card beyond the harvest's
wait on its event, and with the default ``NullTracer`` no event argument
is built.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.obs import (
    DEVICE_INFLIGHT_TID,
    DEVICE_TID,
    PID_DEVICE,
    MetricsRegistry,
    NullTracer,
    StepProfiler,
)
from repro_torch.serving.cache import StateStore, copy_kv_page
from repro_torch.serving.sampling import GREEDY, sample_logits, stack_params

# Allowed P of a batched prefill step: bucketing the row count bounds the
# number of step shapes.
P_BUCKETS = (1, 2, 4, 8)


@dataclasses.dataclass
class InflightStep:
    """One dispatched step whose results the host has not read yet."""

    kind: str  # prefill_full | prefill_chunk | prefill_batch | decode
    bucket: int  # profiler shape bucket (chunk size, P*chunk, or num_slots)
    t_dispatch: float
    out: torch.Tensor  # host int32: the sampled tokens (if any), then the finite flag
    done: Optional[torch.cuda.Event]  # recorded after ``out``'s copy (on the card)
    staged: torch.Tensor  # the step's pinned inputs, held until its harvest
    n_tokens: int  # sampled tokens at the head of ``out``
    payload: Any
    trace_args: Optional[dict]  # the dispatch's span arguments (None untraced)


def _pack(arrays: dict[str, np.ndarray]) -> tuple[np.ndarray, dict]:
    """Host arrays as one int32 word array (float32 by its bits, bool as
    0/1) and each array's (offset, shape, float32 or not)."""
    layout, words, off = {}, [], 0
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        f32 = a.dtype == np.float32
        layout[name] = (off, a.shape, f32)
        words.append((a.view(np.int32) if f32 else a.astype(np.int32, copy=False)).ravel())
        off += a.size
    return np.concatenate(words), layout


def stage(arrays: dict[str, np.ndarray], pinned: bool):
    """Copy host arrays into one int32 staging buffer (pinned for the card)
    and return it with its layout. The buffer is the caller's own: it is not
    written again, and the caller holds it until the copy that reads it has
    run."""
    words, layout = _pack(arrays)
    staged = torch.empty(words.shape, dtype=torch.int32, pin_memory=pinned)
    staged.numpy()[:] = words
    return staged, layout


class GraphStep:
    """A fixed-shape device step over static inputs: the decode step of
    :class:`EngineCore` and the speculative steps (the verify step, the
    drafter's catch-up and decode).

    ``forward(inputs, pools)`` reads ``inputs``, views of one static int32
    buffer laid out like ``arrays``. :meth:`load` copies a step's staged
    inputs into that buffer (one ``non_blocking`` copy), capturing the
    graph first where it has none for these pools (it holds the pools' and
    parameters' addresses, so other pools capture again). :meth:`run`
    replays the graph, or with ``graph=False`` runs ``forward`` eagerly on
    the same buffer. A capture or replay that fails raises."""

    def __init__(self, forward, arrays: dict[str, np.ndarray], device, *, graph: bool):
        words, self.layout = _pack(arrays)
        self.buf = torch.zeros(words.shape, dtype=torch.int32, device=device)
        self.inputs = _views(self.buf, self.layout)
        self.forward = forward
        self.graph = graph
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_pools = self._pools = self._out = None
        self.captures = self.replays = 0

    def load(self, staged: torch.Tensor, pools) -> None:
        if self.graph and (self._graph is None or pools is not self._graph_pools):
            self._capture(pools)
        self._pools = pools
        self.buf.copy_(staged, non_blocking=True)

    def _capture(self, pools) -> None:
        """Run ``forward`` once eagerly on zeroed inputs (no slot active:
        only the null page is written), which builds what the kernels make
        lazily (the kernel library, the decode combine's ticket counters),
        then capture it as a CUDA graph."""
        self.buf.zero_()
        self.forward(self.inputs, pools)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.forward(self.inputs, pools)
        self._graph, self._out, self._graph_pools = graph, out, pools
        self.captures += 1

    def run(self) -> torch.Tensor:
        """The step on the loaded inputs; with the graph its output is the
        graph's own tensor, rewritten by the next replay."""
        if not self.graph:
            return self.forward(self.inputs, self._pools)
        self._graph.replay()
        self.replays += 1
        return self._out


def _views(buf: torch.Tensor, layout: dict) -> dict[str, torch.Tensor]:
    """Views of a packed buffer by name: float32 arrays by their bits, the
    others as int32 (a bool array as 0/1: compare with 0 where it is used,
    so that a view of a static buffer stays a view)."""
    out = {}
    for name, (off, shape, f32) in layout.items():
        t = buf[off:off + int(np.prod(shape))].view(shape)
        out[name] = t.view(torch.float32) if f32 else t
    return out


class EngineCore:
    """Device-stepping core of the continuous-batching server."""

    def __init__(self, model, params, config, profile=None, *, seed: int = 0,
                 graph_decode: bool = True, tracer=None,
                 metrics: Optional[MetricsRegistry] = None,
                 profiler: Optional[StepProfiler] = None):
        # ``profile`` is the model's serving profile (CBProfile); the step
        # profiler is ``profiler``.
        self.model = model
        self.params = params
        self.config = config
        self.profile = profile if profile is not None else model.cb_profile()
        self.seed = seed
        self.device = model.device
        self._on_card = self.device.type == "cuda"
        self.cache: Optional[StateStore] = None
        self._inflight: collections.deque[InflightStep] = collections.deque()
        n = config.num_slots
        self.decode_step = GraphStep(self._decode_forward, self._decode_arrays(
            np.zeros((n, config.pages_per_slot), np.int32), np.zeros((n,), np.int32),
            np.zeros((n,), bool), [GREEDY] * n), self.device, graph=False)
        self.graph_decode = graph_decode
        self._last_tok = torch.zeros((n, 1), dtype=torch.int64, device=self.device)
        self.tracer = tracer if tracer is not None else NullTracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.profiler = profiler if profiler is not None else StepProfiler()
        m = self.metrics
        self._g_inflight = m.gauge(
            "engine_inflight", "device steps dispatched but not yet harvested")
        self._h_idle = m.histogram(
            "engine_idle_seconds",
            help="host blocking wait per harvest (0 when the step already "
                 "finished — the overlap window covered it)")
        self._c_prefill_s = m.counter(
            "serving_prefill_seconds_total", "wall seconds in prefill steps")
        self._c_decode_s = m.counter(
            "serving_decode_seconds_total", "wall seconds in decode rounds")
        self._h_chunk = m.histogram(
            "serving_prefill_chunk_seconds", help="one prefill step")
        self._h_decode_step = m.histogram(
            "serving_decode_step_seconds",
            help="one decode round over all slots (incl. sampling sync)")
        self._c_nonfinite = m.counter(
            "serving_nonfinite_steps_total", "steps whose live logits held inf or NaN")

    # -- the decode graph --------------------------------------------------
    @property
    def graph_decode(self) -> bool:
        """Whether the decode step is a CUDA graph (only on the ``"cuda"``
        backend; set False before the first decode step to run it eagerly)."""
        return self.decode_step.graph

    @graph_decode.setter
    def graph_decode(self, value: bool) -> None:
        self.decode_step.graph = bool(value) and self.model.engine.backend == "cuda"

    @property
    def graph_captures(self) -> int:
        return self.decode_step.captures

    @property
    def graph_replays(self) -> int:
        return self.decode_step.replays

    # -- state lifecycle ---------------------------------------------------
    @torch.inference_mode()
    def fresh(self, pools=None) -> None:
        """(Re)build the StateStore and the per-run device state; ``pools``
        reuses existing pools (and with them the decode graph). Raises with
        steps in flight: harvest them first."""
        if self._inflight:
            raise RuntimeError(f"engine reset with {len(self._inflight)} steps in flight; "
                               "harvest them first")
        cfg = self.config
        self.cache = StateStore.build(
            self.model, num_slots=cfg.num_slots, num_pages=self.resolved_num_pages(),
            page_size=cfg.page_size, pages_per_slot=cfg.pages_per_slot, pools=pools,
        )
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._last_tok.zero_()
        self._t_last_harvest = 0.0
        self._g_inflight.set(0)

    # -- pool sizing -------------------------------------------------------
    def reserve_tokens_cap(self) -> Optional[int]:
        """Tokens a request keeps page-resident at once; None = the whole
        sequence."""
        cfg, prof = self.config, self.profile
        if not prof.needs_kv_pages:
            return 0
        if prof.kv_window is not None and cfg.prefill_chunk is not None:
            return min(cfg.max_seq_len, prof.kv_window + cfg.prefill_chunk + 2 * cfg.page_size)
        return None

    def resolved_num_pages(self) -> int:
        cfg = self.config
        if cfg.num_pages is not None:
            return cfg.num_pages
        cap = self.reserve_tokens_cap()
        per_slot = -(-min(cfg.max_seq_len, cap if cap is not None else cfg.max_seq_len)
                     // cfg.page_size)
        return max(cfg.num_slots * per_slot + 1, 2)

    # -- P-bucketing -------------------------------------------------------
    def allowed_buckets(self) -> tuple[int, ...]:
        """P buckets usable here: the standard set clamped to the slot count
        (pad rows need slot ids apart from the active rows')."""
        return tuple(b for b in P_BUCKETS if b <= self.config.num_slots) or (1,)

    def bucket_for(self, n_rows: int) -> int:
        """Smallest allowed bucket covering ``n_rows``."""
        for b in self.allowed_buckets():
            if b >= n_rows:
                return b
        return self.allowed_buckets()[-1]

    # -- device helpers ----------------------------------------------------
    def copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write page copy, queued behind the steps already in
        flight."""
        copy_kv_page(self.cache.pools, src, dst, page_size=self.config.page_size)

    @property
    def num_inflight(self) -> int:
        return len(self._inflight)

    def _stage(self, arrays: dict[str, np.ndarray]):
        """:func:`stage` for a step, which holds the buffer until its harvest."""
        return stage(arrays, self._on_card)

    @property
    def generator(self) -> torch.Generator:
        """The sampling generator (re-seeded by :meth:`fresh`)."""
        return self._gen

    @staticmethod
    def _decode_arrays(page_table, seq_lens, active, params_list) -> dict:
        return {"page_table": page_table, "seq_lens": seq_lens, "active": active,
                **stack_params(params_list)}

    def _to_device(self, staged: torch.Tensor, layout: dict) -> dict[str, torch.Tensor]:
        return _views(staged.to(self.device, non_blocking=True), layout)

    def _sample(self, logits: torch.Tensor, dev: dict) -> torch.Tensor:
        return sample_logits(logits, self._gen, temperature=dev["temperature"],
                             top_k=dev["top_k"], top_p=dev["top_p"])

    def _record(self, kind: str, bucket: int, t0: float, toks, finite: torch.Tensor, staged,
                payload, targs: Optional[dict]) -> None:
        """Queue the step's results for the host: its tokens and finite
        flag, copied to pinned memory behind the step, and an event; close
        the dispatch span."""
        flag = finite.to(torch.int32)[None]
        out_dev = flag if toks is None else torch.cat([toks.to(torch.int32), flag])
        done = None
        if self._on_card:
            out = torch.empty(out_dev.shape, dtype=torch.int32, pin_memory=True)
            out.copy_(out_dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            out = out_dev
        if targs is not None:
            self.tracer.end(PID_DEVICE, DEVICE_TID, f"{kind}.dispatch")
        self._inflight.append(InflightStep(kind, bucket, t0, out, done, staged,
                                           0 if toks is None else toks.shape[0], payload, targs))
        self._g_inflight.set(len(self._inflight))

    # -- dispatch ----------------------------------------------------------
    def dispatch_prefill(self, *, kind: str, tokens: np.ndarray, page_row: np.ndarray,
                         slot: int, start: int, n: int, bucket: int, sampling=None,
                         payload=None, rid: int = -1) -> None:
        """Enqueue one single-row prefill step (``prefill_full`` or
        ``prefill_chunk``). ``sampling`` marks the final chunk: its first
        token is sampled on the card and goes into the last-token tensor,
        so a decode can be dispatched against it."""
        targs = None
        if self.tracer.enabled:
            targs = {"rid": rid, "slot": slot, "start": start, "tokens": n, "bucket": bucket}
            self.tracer.begin(PID_DEVICE, DEVICE_TID, f"{kind}.dispatch", **targs)
        t0 = time.perf_counter()
        arrays = {"tokens": tokens, "page_row": page_row}
        if sampling is not None:
            arrays |= stack_params([sampling])
        staged, layout = self._stage(arrays)
        dev = self._to_device(staged, layout)
        logits = self.model.prefill_cb(
            self.params, dev["tokens"], self.cache.pools, dev["page_row"], slot, start, n,
            page_size=self.config.page_size, chunked=kind == "prefill_chunk",
        )
        toks = None
        if sampling is not None:
            toks = self._sample(logits, dev)
            self._last_tok[slot, 0] = toks[0]
        self._record(kind, bucket, t0, toks, torch.isfinite(logits).all(), staged, payload,
                     targs)

    def dispatch_prefill_batch(self, *, tokens: np.ndarray, page_rows: np.ndarray,
                               slots: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                               active: np.ndarray, final_mask: np.ndarray, sampling_list,
                               payload=None, rids=None) -> None:
        """Enqueue one (P, chunk) multi-slot prefill step. Every row is
        sampled in one call; only rows whose chunk completes the prompt
        (``final_mask``) go into the last-token tensor."""
        p, chunk = tokens.shape
        bucket = p * chunk  # the GEMMs' rows
        targs = None
        if self.tracer.enabled:
            targs = {"rows": int(active.sum()), "P": p, "chunk": chunk, "bucket": bucket}
            if rids is not None:
                targs["rids"] = list(rids)
            self.tracer.begin(PID_DEVICE, DEVICE_TID, "prefill_batch.dispatch", **targs)
        t0 = time.perf_counter()
        staged, layout = self._stage({
            "tokens": tokens, "page_rows": page_rows, "slots": slots, "starts": starts,
            "lengths": lengths, "active": active, "final": final_mask,
            **stack_params(sampling_list)})
        dev = self._to_device(staged, layout)
        logits = self.model.prefill_cb(
            self.params, dev["tokens"], self.cache.pools, dev["page_rows"], dev["slots"],
            dev["starts"], dev["lengths"], page_size=self.config.page_size, chunked=True,
            active=dev["active"],
        )
        toks = self._sample(logits, dev)
        slots_dev = dev["slots"].long()
        last = self._last_tok[:, 0]
        last.scatter_(0, slots_dev, torch.where(dev["final"] != 0, toks.long(), last[slots_dev]))
        finite = (torch.isfinite(logits).all(-1) | (dev["active"] == 0)).all()
        self._record("prefill_batch", bucket, t0, toks, finite, staged, payload, targs)

    def _decode_forward(self, d: dict, pools) -> torch.Tensor:
        """``decode_cb`` on the static decode inputs: the body of the decode
        graph, and the eager step."""
        return self.model.decode_cb(
            self.params, self._last_tok, pools, d["page_table"], d["seq_lens"],
            d["active"] != 0, page_size=self.config.page_size)

    def dispatch_decode(self, *, active: np.ndarray, params_list, payload=None) -> None:
        """Enqueue one decode step over every slot. Input tokens come from the
        device last-token tensor; sampled tokens of active slots merge back
        into it for the next decode."""
        n = self.config.num_slots
        targs = None
        if self.tracer.enabled:
            targs = {"slots": n, "decoding": int(active.sum())}
            self.tracer.begin(PID_DEVICE, DEVICE_TID, "decode.dispatch", **targs)
        t0 = time.perf_counter()
        staged, _ = self._stage(self._decode_arrays(self.cache.page_table, self.cache.seq_lens,
                                                    active, params_list))
        self.decode_step.load(staged, self.cache.pools)
        logits = self.decode_step.run()
        d = self.decode_step.inputs
        toks = self._sample(logits, d)
        act = d["active"] != 0
        self._last_tok.copy_(torch.where(act[:, None], toks[:, None].long(), self._last_tok))
        finite = (torch.isfinite(logits).all(-1) | ~act).all()
        self._record("decode", n, t0, toks, finite, staged, payload, targs)

    # -- harvest -----------------------------------------------------------
    def charge_decode(self, dt: float, finite: bool) -> None:
        """Charge one decode round of ``dt`` wall seconds, and count it as
        non-finite unless ``finite``: the harvest of a decode step and the
        server's synchronous spec round both report through here."""
        self._c_nonfinite.inc(int(not finite))
        self._c_decode_s.inc(dt)
        self._h_decode_step.observe(dt)

    def harvest_one(self):
        """Wait for the oldest dispatched step and return ``(step, tokens)``
        (tokens as numpy, None for a non-final prefill chunk); None when
        nothing is in flight. Each step is charged the wall time from
        max(its dispatch, the previous harvest) to the moment its results
        reached the host, so the charges sum to the elapsed wall time when
        the card is saturated. The wait on the step's event is the host's
        only block, and ``engine_idle_seconds`` observes it."""
        if not self._inflight:
            return None
        rec = self._inflight.popleft()
        t_wait = time.perf_counter()
        if rec.done is not None:
            rec.done.synchronize()
        out = rec.out.numpy()
        toks = out[:rec.n_tokens].copy() if rec.n_tokens else None
        t_done = time.perf_counter()
        self._h_idle.observe(t_done - t_wait)
        dt = t_done - max(rec.t_dispatch, self._t_last_harvest)
        self._t_last_harvest = t_done
        if rec.kind.startswith("prefill"):
            self._c_nonfinite.inc(int(not out[-1]))
            self._c_prefill_s.inc(dt)
            self._h_chunk.observe(dt)
        else:
            self.charge_decode(dt, bool(out[-1]))
        self.profiler.record(rec.kind, rec.bucket, dt)
        if rec.trace_args is not None:
            self.tracer.complete(
                PID_DEVICE, DEVICE_INFLIGHT_TID, f"{rec.kind}.complete",
                rec.t_dispatch, t_done - rec.t_dispatch,
                wait_s=round(t_done - t_wait, 6), **rec.trace_args)
        self._g_inflight.set(len(self._inflight))
        return rec, toks
