"""Continuous-batching scheduler of the port: FIFO admission that reserves
each request's worst-case pages, lazy page growth, token commits and
finishes (counterpart of ``repro.serving.scheduler`` without priorities,
prefix caching or preemption).

    QUEUED --admit--> RUNNING(prefilling -> decoding) --finish--> FINISHED

A request is admitted when a decode slot is free and the pool can cover
its worst case on top of what running requests may still claim, so a
running request never fails a page allocation. Admission is in order
without skipping: if the head does not fit, nothing behind it jumps ahead.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.serving.cache import PagePool
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
    rid: Optional[int] = None  # assigned by Scheduler.submit

    out_tokens: list[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    pages: list[int] = dataclasses.field(default_factory=list)
    status: str = QUEUED
    finish_reason: Optional[str] = None
    max_total: int = 0  # prompt + generation cap, clamped to the cache
    prefilled: int = 0  # prompt tokens committed to the pools

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def num_generated(self) -> int:
        return len(self.out_tokens)

    @property
    def decoding(self) -> bool:
        return self.status == RUNNING and self.prefilled >= self.prompt_len


class Scheduler:
    def __init__(self, *, num_slots: int, pool: PagePool, pages_per_slot: int,
                 max_seq_len: Optional[int] = None):
        self.pool = pool
        self.pages_per_slot = pages_per_slot
        slot_cap = pages_per_slot * pool.page_size
        self.max_seq_len = min(max_seq_len or slot_cap, slot_cap)
        self.queue: list[Request] = []
        self.running: dict[int, Request] = {}
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self._rids = itertools.count()

    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    def worst_pages(self, max_total: int) -> int:
        return self.pool.pages_for(max_total)

    def _reserved_unallocated(self) -> int:
        """Pages running requests may still claim (worst case minus held)."""
        return sum(max(0, self.worst_pages(r.max_total) - len(r.pages))
                   for r in self.running.values())

    def submit(self, request: Request) -> Request:
        if request.prompt_len < 1:
            raise ValueError("empty prompt")
        if request.prompt_len >= self.max_seq_len:
            raise ValueError(
                f"prompt of {request.prompt_len} tokens leaves no room to "
                f"generate under max_seq_len={self.max_seq_len}"
            )
        request.max_total = min(request.prompt_len + request.max_new_tokens, self.max_seq_len)
        worst = self.worst_pages(request.max_total)
        if worst > self.pool.num_pages - 1:
            raise ValueError(f"request needs {worst} pages; pool has {self.pool.num_pages - 1}")
        if request.rid is None:
            request.rid = next(self._rids)
        request.status = QUEUED
        self.queue.append(request)
        return request

    def admit(self) -> list[Request]:
        """Move queue heads into free slots while pages allow. Pages are
        not allocated here: prefill and decode call ``ensure_pages``."""
        admitted = []
        while self.queue and self._free_slots:
            req = self.queue[0]
            need = self.worst_pages(req.max_total)
            if self.pool.num_free - self._reserved_unallocated() < need:
                break
            self.queue.pop(0)
            req.slot = self._free_slots.pop()
            req.pages = []
            req.prefilled = 0
            req.status = RUNNING
            self.running[req.slot] = req
            admitted.append(req)
        return admitted

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

    def finish(self, req: Request) -> None:
        """Release the request's slot and pages; idempotent."""
        if req.status == FINISHED:
            return
        if req.slot is None or self.running.get(req.slot) is not req:
            raise ValueError(f"request {req.rid} is not running (status={req.status})")
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        self.pool.decref(req.pages)
        req.pages = []
        req.status = FINISHED
