"""The serving StateStore of the port: per-layer KV token pools on the
device, a host-side refcounting page allocator, and the host mirrors of
the page table and sequence lengths (counterpart of ``repro.serving.cache``
without the prefix index).

Token t of a slot lives at ``pool[page_table[slot, t // page_size] *
page_size + t % page_size]``. Page 0 is the **null page**: never handed
out, it absorbs the K/V writes of prompt padding and inactive slots, and
its contents are never read back as valid.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

NULL_PAGE = 0


class OutOfPagesError(RuntimeError):
    """An allocation exceeded the free list. Admission reserves each
    request's worst case, so a running request never meets this."""


class PagePool:
    """Host-side free-list allocator over ``num_pages`` pages with a
    refcount per allocated page (page 0 is never handed out)."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))
        self._refs: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_held(self) -> int:
        return len(self._refs)

    def ref(self, page: int) -> int:
        """Current refcount of a page (0 when free)."""
        return self._refs.get(page, 0)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache slots."""
        return max(0, -(-n_tokens // self.page_size))

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPagesError(
                f"requested {n} pages, {len(self._free)} free "
                f"(of {self.num_pages - 1} allocatable)"
            )
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def incref(self, pages: list[int]) -> None:
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not currently allocated")
            self._refs[p] += 1

    def decref(self, pages: list[int]) -> None:
        """Drop one reference per page; the last drop frees the page."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not currently allocated")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)


@dataclasses.dataclass
class StateStore:
    """Device KV pools + the host mirror of the page table and sequence
    lengths (numpy, mutated in place by the server between steps)."""

    pools: Any  # one {"kp", "vp"} dict of tensors per layer
    page_table: np.ndarray  # (num_slots, pages_per_slot) int32
    seq_lens: np.ndarray  # (num_slots,) int32
    allocator: PagePool

    @classmethod
    def build(cls, model, *, num_slots: int, num_pages: int, page_size: int,
              pages_per_slot: int) -> "StateStore":
        return cls(
            pools=model.init_state_store(num_slots, num_pages, page_size),
            page_table=np.zeros((num_slots, pages_per_slot), np.int32),
            seq_lens=np.zeros((num_slots,), np.int32),
            allocator=PagePool(num_pages, page_size),
        )

    @property
    def num_slots(self) -> int:
        return self.page_table.shape[0]

    def set_page(self, slot: int, index: int, page: int) -> None:
        self.page_table[slot, index] = page

    def reset_slot(self, slot: int) -> None:
        self.page_table[slot] = NULL_PAGE
        self.seq_lens[slot] = 0

    def kv_bytes(self) -> int:
        """Device bytes held by the KV token pools."""
        return sum(t.numel() * t.element_size() for pool in self.pools for t in pool.values())
