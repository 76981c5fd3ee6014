"""The serving StateStore of the port: per-layer KV token pools on the
device, the recurrent layers' per-slot state rows, a host-side refcounting
page allocator with a content-addressable prefix index, and the host
mirrors of the page table and sequence lengths (counterpart of
``repro.serving.cache``).

Token t of a slot lives at ``pool[page_table[slot, t // page_size] *
page_size + t % page_size]``. Page 0 is the **null page**: never handed
out, it absorbs the K/V writes of prompt padding and inactive slots, and
its contents are never read back as valid.

Prefix caching makes the pool content-addressable: full pages written
during prefill are published under the chained hash of their token blocks
(:func:`prefix_block_hashes`). A later request with the same prompt prefix
maps the published pages into its page table at refcount+1 instead of
prefilling them again; a page whose refcount drops to zero keeps its index
entry while it sits on the free list, and loses it only when the allocator
hands the physical page out again. K/V depend only on the token prefix
(attention is causal), so the chain of token blocks is the whole key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.precision import FP8_DTYPES

NULL_PAGE = 0


def prefix_block_hashes(tokens: Sequence[int], page_size: int) -> list[int]:
    """Chained hashes of the prompt's full token blocks: block i is keyed on
    (hash of blocks < i, its ``page_size`` token ids), so equal hashes mean
    equal whole prefixes. A partial tail block is never hashed."""
    hashes: list[int] = []
    parent: Optional[int] = None
    for i in range(len(tokens) // page_size):
        block = tuple(int(t) for t in tokens[i * page_size:(i + 1) * page_size])
        parent = hash((parent, block))
        hashes.append(parent)
    return hashes


def copy_kv_page(pools, src: int, dst: int, *, page_size: int) -> None:
    """Copy one page's token rows onto another in every layer's K and V pool,
    in place: the copy-on-write of a shared partial page. fp8 pools move as
    their ``uint8`` bits. The reference does this copy with
    ``dynamic_update_slice`` outside any kernel; on the card it is one
    device copy a pool, queued on the current stream after the steps that
    wrote the source page."""
    s, d = src * page_size, dst * page_size
    for pool in pools:
        for t in _kv_leaves(pool):
            bits = t.view(torch.uint8) if t.dtype in FP8_DTYPES else t
            bits[d:d + page_size].copy_(bits[s:s + page_size])


def _kv_leaves(pool: dict) -> list:
    """A layer's KV token pools ("kp", "vp"); a recurrent layer has none."""
    return [t for name, t in pool.items() if name in ("kp", "vp")]


class OutOfPagesError(RuntimeError):
    """An allocation exceeded the free list. Admission reserves each
    request's worst case, so a running request never meets this."""


class PagePool:
    """Host-side refcounting free-list allocator over ``num_pages`` pages,
    plus the prefix index (page 0 is never handed out).

    ``alloc`` hands pages out at refcount 1, prefix sharing takes them at
    refcount+1 (``acquire``), and ``decref`` frees a page when its last
    reference drops. ``publish`` indexes a held page under its block hash;
    the entry outlives the refcount until the page is reused. Reuse prefers
    unpublished pages, then evicts the least recently freed published one.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))
        self._refs: dict[int, int] = {}
        self._hash_to_page: dict[int, int] = {}
        self._page_to_hash: dict[int, int] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_held(self) -> int:
        return len(self._refs)

    @property
    def num_published(self) -> int:
        return len(self._hash_to_page)

    def ref(self, page: int) -> int:
        """Current refcount of a page (0 when free)."""
        return self._refs.get(page, 0)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache slots."""
        return max(0, -(-n_tokens // self.page_size))

    def _pop_free(self) -> int:
        # An unpublished page first (LIFO), else evict the least recently
        # freed published page, so resident prefixes live longest.
        for i in range(len(self._free) - 1, -1, -1):
            if self._free[i] not in self._page_to_hash:
                return self._free.pop(i)
        return self._free.pop(0)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise OutOfPagesError(
                f"requested {n} pages, {len(self._free)} free "
                f"(of {self.num_pages - 1} allocatable)"
            )
        pages = []
        for _ in range(n):
            p = self._pop_free()
            self._evict(p)  # its contents are about to be overwritten
            self._refs[p] = 1
            pages.append(p)
        return pages

    def incref(self, pages: list[int]) -> None:
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not currently allocated")
            self._refs[p] += 1

    def decref(self, pages: list[int]) -> None:
        """Drop one reference per page; the last drop frees the page (its
        index entry, if any, survives until the page is reused)."""
        for p in pages:
            if p not in self._refs:
                raise ValueError(f"page {p} is not currently allocated")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)

    free = decref

    # -- prefix index ------------------------------------------------------
    def publish(self, page: int, block_hash: int) -> None:
        """Index a held page under its block hash. The first writer wins: a
        hash already indexed is left as it is, so a published page is never
        written again."""
        if page not in self._refs:
            raise ValueError(f"page {page} is not currently allocated")
        if block_hash in self._hash_to_page:
            return
        self._evict(page)  # one page indexes at most one block
        self._hash_to_page[block_hash] = page
        self._page_to_hash[page] = block_hash

    def lookup(self, block_hash: int) -> Optional[int]:
        """The page published under ``block_hash``, refcounts untouched."""
        return self._hash_to_page.get(block_hash)

    def acquire(self, block_hash: int) -> Optional[int]:
        """Take one reference on the page published under ``block_hash``,
        reviving it from the free list at refcount 0; None on a miss."""
        p = self._hash_to_page.get(block_hash)
        if p is None:
            return None
        if p in self._refs:
            self._refs[p] += 1
        else:
            self._free.remove(p)
            self._refs[p] = 1
        return p

    def _evict(self, page: int) -> None:
        h = self._page_to_hash.pop(page, None)
        if h is not None:
            del self._hash_to_page[h]


@dataclasses.dataclass
class StateStore:
    """Device pools (KV pages and recurrent state rows) + the host mirror
    of the page table and sequence lengths (numpy, mutated in place by the
    server between steps). ``seq_lens`` counts the tokens committed per
    slot (mid chunked prefill, the prefix prefilled so far). Page-table
    entries recycled out of a sliding window are NULL."""

    pools: Any  # per layer: {"kp", "vp"} token pools, or {"state": {leaf: rows}}
    page_table: np.ndarray  # (num_slots, pages_per_slot) int32
    seq_lens: np.ndarray  # (num_slots,) int32
    allocator: PagePool

    @classmethod
    def build(cls, model, *, num_slots: int, num_pages: int, page_size: int,
              pages_per_slot: int, pools=None) -> "StateStore":
        """``pools`` reuses existing device pools (``Server.reset``) instead
        of allocating fresh zeros: stale K/V are never read back as valid,
        and a stale state row is replaced by the next start-0 prefill."""
        return cls(
            pools=(pools if pools is not None
                   else model.init_state_store(num_slots, num_pages, page_size)),
            page_table=np.zeros((num_slots, pages_per_slot), np.int32),
            seq_lens=np.zeros((num_slots,), np.int32),
            allocator=PagePool(num_pages, page_size),
        )

    @property
    def num_slots(self) -> int:
        return self.page_table.shape[0]

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    @property
    def page_size(self) -> int:
        return self.allocator.page_size

    def set_page(self, slot: int, index: int, page: int) -> None:
        self.page_table[slot, index] = page

    def clear_pages(self, slot: int, indices: list[int]) -> None:
        """NULL out recycled (out-of-window) page-table entries."""
        for i in indices:
            self.page_table[slot, i] = NULL_PAGE

    def reset_slot(self, slot: int) -> None:
        self.page_table[slot] = NULL_PAGE
        self.seq_lens[slot] = 0

    def kv_bytes(self) -> int:
        """Device bytes held by the KV token pools."""
        return sum(t.numel() * t.element_size() for pool in self.pools
                   for t in _kv_leaves(pool))

    def state_bytes(self) -> int:
        """Device bytes held by the recurrent layers' per-slot state rows."""
        return sum(t.numel() * t.element_size() for pool in self.pools
                   for t in pool.get("state", {}).values())


# The reference's transitional name of the store (its first version held KV
# pages only).
PagedKVCache = StateStore
