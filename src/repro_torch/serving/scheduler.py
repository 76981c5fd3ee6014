"""Continuous-batching scheduler of the port: request queue, priorities with
aging, prefix-cache-aware admission, preemption, slot recycling and
chunked-prefill progress (counterpart of ``repro.serving.scheduler``; its
metrics handles are plain counters here).

    QUEUED --admit--> RUNNING(prefilling -> decoding) --finish--> FINISHED
             ^            | (preempt: prefilling only)
             +------------+

A request is admitted when (a) a decode slot is free, (b) the page pool
can cover its worst case on top of what running requests may still claim,
and (c) the in-flight token budget has room. Reserving the worst case at
admission means a running request never fails a page allocation.

With prefix caching on, admission first maps the longest published prefix
of the prompt into the request at refcount+1 and charges only the uncached
suffix. When the match ends inside a page (the whole prompt is cached and
its last token must be recomputed for its logits), that page is copied on
write: a fresh page is allocated and the server copies the cached rows
into it.

Requests carry a ``priority`` (higher runs first; FIFO within a level).
With preemption on, a head that cannot be admitted evicts a strictly
lower-priority request that is still prefilling; with prefix caching its
committed full pages stay in the index, so its resume is mostly a cache
hit. Aging guards against starvation: effective priority = priority +
age // aging_steps, where age counts the admission passes spent waiting.

Admission is in priority order without skipping: if the head does not
fit, nothing behind it jumps ahead. Pages are allocated lazily as
positions are written (``ensure_pages``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

from repro_torch.serving.cache import PagePool, prefix_block_hashes
from repro_torch.serving.sampling import GREEDY, SamplingParams

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"

FINISH_EOS = "eos"
FINISH_LENGTH = "length"


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""

    prompt: list[int]
    max_new_tokens: int = 32
    sampling: SamplingParams = GREEDY
    eos_id: Optional[int] = None
    # Higher runs first; FIFO within a level.
    priority: int = 0
    # Speculative decoding: this request's draft depth, None for the
    # server's SpecConfig.k (it can lower k, never raise it).
    spec_k: Optional[int] = None
    rid: Optional[int] = None  # assigned by Scheduler.submit

    out_tokens: list[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    # Page per table index; recycled (out-of-window) entries become None.
    pages: list[Optional[int]] = dataclasses.field(default_factory=list)
    status: str = QUEUED
    finish_reason: Optional[str] = None
    max_total: int = 0  # prompt + generation cap, clamped to the cache
    # Prompt tokens committed to the pools; a prefix hit starts it at
    # cached_tokens (those positions are mapped, not recomputed).
    prefilled: int = 0
    # Prompt tokens served from the prefix cache at the last admission.
    cached_tokens: int = 0
    # (src, dst) page copies the server runs before prefilling (copy on
    # write of a partly used shared page).
    pending_copies: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    _block_hashes: Optional[list[int]] = None  # memoized per page size
    age: int = 0  # admission passes spent waiting (drives aging)
    preemptions: int = 0  # times preempted back to QUEUED
    # Wall-clock marks (set by the server). t_queued is the last entry into
    # QUEUED: the submit, or a preemption.
    t_submit: float = 0.0
    t_queued: float = 0.0
    t_admit: float = 0.0
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_finish: Optional[float] = None
    spec_accepted: int = 0  # drafts accepted over every speculative round

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def num_generated(self) -> int:
        return len(self.out_tokens)

    @property
    def prefilling(self) -> bool:
        return self.status == RUNNING and self.prefilled < self.prompt_len

    @property
    def decoding(self) -> bool:
        return self.status == RUNNING and self.prefilled >= self.prompt_len

    @property
    def live_pages(self) -> list[int]:
        return [p for p in self.pages if p is not None]


class Scheduler:
    def __init__(self, *, num_slots: int, pool: PagePool, pages_per_slot: int,
                 max_seq_len: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 kv_reserve_tokens: Optional[int] = None,
                 prefix_cache: bool = False,
                 preemption: bool = False,
                 aging_steps: int = 32):
        self.pool = pool
        self.pages_per_slot = pages_per_slot
        slot_cap = pages_per_slot * pool.page_size
        self.max_seq_len = min(max_seq_len or slot_cap, slot_cap)
        # Cap on sum(max_total) over running requests (None: pages bind).
        self.token_budget = token_budget
        # Tokens a request keeps page-resident at once: None = the full
        # sequence, 0 = no KV pages, a window bound for windowed models.
        self.kv_reserve_tokens = kv_reserve_tokens
        self.prefix_cache = prefix_cache
        self.preemption = preemption
        self.aging_steps = max(1, aging_steps)
        self.queue: list[Request] = []
        self.running: dict[int, Request] = {}
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self._rids = itertools.count()
        self.completed = 0
        self.preemptions = 0
        # Prefix-cache accounting over admissions (a resumed request counts
        # again: its hit is a real saving).
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0

    # -- introspection -----------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    @property
    def num_free_slots(self) -> int:
        return len(self._free_slots)

    def effective_priority(self, req: Request) -> int:
        """Priority after aging: one level per ``aging_steps`` admission
        passes spent waiting."""
        return req.priority + req.age // self.aging_steps

    def worst_pages(self, max_total: int) -> int:
        """Worst-case simultaneous page demand of one request."""
        if self.kv_reserve_tokens is not None:
            max_total = min(max_total, self.kv_reserve_tokens)
        return self.pool.pages_for(max_total)

    def _reserved_unallocated(self) -> int:
        """Pages running requests may still claim (worst case minus held;
        mapped prefix pages count as held)."""
        return sum(max(0, self.worst_pages(r.max_total) - len(r.live_pages))
                   for r in self.running.values())

    def _inflight_tokens(self) -> int:
        return sum(r.max_total for r in self.running.values())

    # -- queue -------------------------------------------------------------
    def submit(self, request: Request) -> Request:
        if request.prompt_len < 1:
            raise ValueError("empty prompt")
        request.max_total = min(request.prompt_len + request.max_new_tokens, self.max_seq_len)
        if request.prompt_len >= self.max_seq_len:
            raise ValueError(
                f"prompt of {request.prompt_len} tokens leaves no room to "
                f"generate under max_seq_len={self.max_seq_len}"
            )
        worst = self.worst_pages(request.max_total)
        if worst > self.pool.num_pages - 1:
            raise ValueError(f"request needs {worst} pages; pool has {self.pool.num_pages - 1}")
        if self.token_budget is not None and request.max_total > self.token_budget:
            raise ValueError(
                f"request of {request.max_total} tokens exceeds the "
                f"token budget of {self.token_budget}"
            )
        if request.rid is None:
            request.rid = next(self._rids)
        request.status = QUEUED
        self.queue.append(request)
        return request

    # -- prefix cache ------------------------------------------------------
    def _hashes(self, req: Request) -> list[int]:
        if req._block_hashes is None:
            req._block_hashes = prefix_block_hashes(req.prompt, self.pool.page_size)
        return req._block_hashes

    def _match_prefix(self, req: Request):
        """Acquire the longest published prefix of the prompt. Returns
        (shared full pages, copy-on-write source page or None, cached token
        count). The prompt's last token always stays uncached, so the final
        chunk produces the first token's logits; when that cap lands inside
        a matched block, the block becomes the copy-on-write source."""
        if not (self.prefix_cache and req.prompt_len > 1):
            return [], None, 0
        ps = self.pool.page_size
        acquired: list[int] = []
        for h in self._hashes(req):
            p = self.pool.acquire(h)
            if p is None:
                break
            acquired.append(p)
        if not acquired:
            return [], None, 0
        n_full = min(len(acquired), (req.prompt_len - 1) // ps)
        partial_tokens = 0
        cow_src = None
        if len(acquired) > n_full:
            # Block n_full is published but only partly usable.
            partial_tokens = (req.prompt_len - 1) - n_full * ps
            if partial_tokens > 0:
                cow_src = acquired[n_full]
                self.pool.decref(acquired[n_full + 1:])
            else:
                self.pool.decref(acquired[n_full:])
        return acquired[:n_full], cow_src, n_full * ps + partial_tokens

    def publish_prefix(self, req: Request) -> None:
        """Publish the request's committed full prompt pages (a page whose
        hash is indexed already is left alone). The server calls this after
        each prefill chunk commits."""
        if not self.prefix_cache:
            return
        ps = self.pool.page_size
        hashes = self._hashes(req)
        n_full = min(req.prefilled, req.prompt_len) // ps
        for i in range(min(n_full, len(hashes))):
            if i < len(req.pages) and req.pages[i] is not None:
                self.pool.publish(req.pages[i], hashes[i])

    # -- admission ---------------------------------------------------------
    def admit(self, on_preempt: Optional[Callable[[int], None]] = None) -> list[Request]:
        """Move queue heads (priority order, aged) into free slots while
        pages and budget allow, preempting strictly lower-priority
        prefilling requests for the head when enabled. Suffix pages are not
        allocated here: prefill chunks call ``ensure_pages``.
        ``on_preempt(slot)`` lets the server reset the victim's page-table
        row."""
        admitted = []
        # Priorities and ages are fixed within one pass: sort once, and
        # again only when a preemption puts its victim back in the queue.
        key = lambda r: (-self.effective_priority(r), r.rid)  # noqa: E731
        self.queue.sort(key=key)
        while self.queue:
            req = self.queue[0]
            ok = self._try_admit(req)
            while not ok and self.preemption and self._preempt_one(req, on_preempt):
                self.queue.sort(key=key)
                ok = self._try_admit(req)
            if not ok:
                for r in self.queue:
                    r.age += 1
                break
            self.queue.pop(0)
            admitted.append(req)
        return admitted

    def _try_admit(self, req: Request) -> bool:
        """Check slot, budget and pages for one request and install it when
        everything fits. Prefix pages are acquired first, so the free-page
        check charges only the uncached suffix."""
        if not self._free_slots:
            return False
        if (self.token_budget is not None
                and self._inflight_tokens() + req.max_total > self.token_budget):
            return False
        shared, cow_src, cached = self._match_prefix(req)
        suffix = max(0, self.worst_pages(req.max_total) - len(shared))
        if cow_src is not None:
            suffix = max(suffix, 1)  # the copy comes from the free list
        if self.pool.num_free - self._reserved_unallocated() < suffix:
            self.pool.decref(shared + ([cow_src] if cow_src is not None else []))
            return False
        req.slot = self._free_slots.pop()
        req.pages = list(shared)
        req.pending_copies = []
        if cow_src is not None:
            (dst,) = self.pool.alloc(1)
            req.pages.append(dst)
            req.pending_copies.append((cow_src, dst))
            self.pool.decref([cow_src])
        req.cached_tokens = cached
        req.prefilled = cached
        req.status = RUNNING
        self.running[req.slot] = req
        self.prefix_hit_tokens += cached
        self.prefix_prompt_tokens += req.prompt_len
        return True

    # -- preemption --------------------------------------------------------
    def _matchable_prefix_pages(self, req: Request) -> int:
        """Published full pages the prompt could map, by index lookup only:
        the optimistic prefix credit when judging a preemption."""
        if not (self.prefix_cache and req.prompt_len > 1):
            return 0
        n = 0
        for h in self._hashes(req):
            if self.pool.lookup(h) is None:
                break
            n += 1
        return min(n, (req.prompt_len - 1) // self.pool.page_size)

    def _preempt_one(self, for_req: Request,
                     on_preempt: Optional[Callable[[int], None]]) -> bool:
        """Evict the lowest-effective-priority prefilling request strictly
        below ``for_req`` (the most recent on ties). False when there is no
        such victim, or when evicting all of them still could not admit
        ``for_req``: no committed prefill is thrown away for nothing."""
        cand = self.effective_priority(for_req)
        victims = [r for r in self.running.values()
                   if r.prefilling and self.effective_priority(r) < cand]
        if not victims:
            return False
        suffix = max(0, self.worst_pages(for_req.max_total)
                     - self._matchable_prefix_pages(for_req))
        potential_free = self.pool.num_free + sum(len(v.live_pages) for v in victims)
        victim_ids = {id(v) for v in victims}
        reserved_wo = sum(max(0, self.worst_pages(r.max_total) - len(r.live_pages))
                          for r in self.running.values() if id(r) not in victim_ids)
        if potential_free - reserved_wo < suffix:
            return False
        if self.token_budget is not None and (
                self._inflight_tokens() - sum(v.max_total for v in victims)
                + for_req.max_total > self.token_budget):
            return False
        victim = min(victims, key=lambda r: (self.effective_priority(r), -r.rid))
        self.preempt(victim, on_preempt)
        return True

    def preempt(self, req: Request, on_preempt: Optional[Callable[[int], None]] = None) -> None:
        """Evict a prefilling request back to QUEUED. Its pages are
        dereferenced; with prefix caching its committed full prompt pages
        stay indexed. Its age is kept, so a request preempted again and
        again climbs the priority order."""
        if not req.prefilling:
            raise ValueError(
                f"request {req.rid} is not prefilling (status={req.status}); "
                "only prefilling requests can be preempted"
            )
        slot = req.slot
        del self.running[slot]
        self._free_slots.append(slot)
        self.pool.decref(req.live_pages)
        req.pages = []
        req.pending_copies = []
        req.prefilled = 0
        req.cached_tokens = 0
        req.slot = None
        req.status = QUEUED
        req.preemptions += 1
        self.preemptions += 1
        self.queue.append(req)
        if on_preempt is not None:
            on_preempt(slot)

    # -- token commit / paging / recycling ---------------------------------
    def commit(self, req: Request, token: int) -> bool:
        """Record one sampled token; True when the request finished (EOS,
        generation cap, or cache capacity)."""
        req.out_tokens.append(token)
        if req.eos_id is not None and token == req.eos_id:
            req.finish_reason = FINISH_EOS
        elif (req.num_generated >= req.max_new_tokens
              or req.prompt_len + req.num_generated >= req.max_total):
            req.finish_reason = FINISH_LENGTH
        return req.finish_reason is not None

    def ensure_pages(self, req: Request, end_position: int) -> list[tuple[int, int]]:
        """Grow the request's pages to cover writes at positions <
        ``end_position``; returns the (index, page) pairs appended."""
        need = self.pool.pages_for(end_position)
        grown = []
        while len(req.pages) < need:
            (page,) = self.pool.alloc(1)
            grown.append((len(req.pages), page))
            req.pages.append(page)
        return grown

    def ensure_page(self, req: Request, position: int) -> Optional[tuple[int, int]]:
        """Single-position form of ``ensure_pages`` (decode's one write)."""
        grown = self.ensure_pages(req, position + 1)
        return grown[0] if grown else None

    def release_out_of_window(self, req: Request, seq_len: int, window: int) -> list[int]:
        """Decref pages every position of which has slid out of the
        attention window (only legal when every attention layer is
        windowed). Returns the freed table indices."""
        ps = self.pool.page_size
        freed = []
        for idx, page in enumerate(req.pages):
            if page is None:
                continue
            if (idx + 1) * ps - 1 < seq_len - window:
                self.pool.decref([page])
                req.pages[idx] = None
                freed.append(idx)
        return freed

    def finish(self, req: Request) -> None:
        """Release the request's slot and pages; idempotent."""
        if req.status == FINISHED:
            return
        if req.slot is None or self.running.get(req.slot) is not req:
            raise ValueError(f"request {req.rid} is not running (status={req.status})")
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        self.pool.decref(req.live_pages)
        req.pages = []
        req.status = FINISHED
        self.completed += 1
