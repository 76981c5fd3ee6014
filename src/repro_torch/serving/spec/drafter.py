"""Draft-token proposers for speculative decoding (counterpart of
``repro.serving.spec.drafter``). Both share one interface (``propose``,
``release_slot``, ``reset``).

:class:`NgramDrafter`: prompt-lookup self-drafting, with no extra model:
propose what followed the most recent earlier occurrence of the history's
n-gram suffix. Its proposals are deterministic, so the rejection sampler
takes q = onehot(d) (``DraftProposal.logits is None``).

:class:`ModelDrafter`: a second, smaller model with its own
:class:`~repro_torch.serving.cache.StateStore` (its own page pool),
paired with the target's slots by index. Each round it (1) catches up on
the committed tokens it has not consumed yet with multi-token
``verify_cb`` steps, then (2) runs k - 1 single-token ``decode_cb``
steps, sampling each draft from its own filtered distribution. On the
card both steps are CUDA graphs over static inputs, and the drafts are
sampled and fed back on the card.

Rollback. The reference snapshots the drafter's pools before drafting and
restores them after, which costs nothing because JAX arrays are
immutable. The port's pools are updated in place. Its KV pages are not
copied: the draft steps write K/V at positions base .. base + k - 2 while
the ``seq_lens`` mirror stays at base, and every read masks at the
committed length; the next round's catch-up rewrites those positions with
the tokens the target really emitted before anything reads them as valid.
Recurrent state rows have no such mask, and the draft steps commit them
in place (inside the decode graph), so a drafter with state rows clones
every row leaf before its k - 1 draft steps and copies the clones back
into the same storage after them: the graphs hold the leaves' addresses,
so the leaves are never rebound. The catch-up (``verify_cb`` with
``commit=True``) then scans the tokens the target emitted into them.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.serving.cache import StateStore
from repro_torch.serving.engine import GraphStep, stage
from repro_torch.serving.sampling import GREEDY, sample_logits, stack_params


def _draft_histogram(metrics):
    """Per-round draft wall-clock histogram, when a MetricsRegistry is wired
    in (duck-typed, as in the reference). Both drafters end their round on
    the host (the n-gram lookup is host code; the model drafter's round ends
    in one copy of its drafts), so the host clock times the whole round."""
    if metrics is None:
        return None
    return metrics.histogram("serving_draft_seconds",
                             help="Wall-clock of one drafter.propose round")


class DraftProposal(NamedTuple):
    """One round of proposals for every slot (fixed shapes)."""

    tokens: np.ndarray  # (S, k) int32, right-padded
    counts: np.ndarray  # (S,) int32 drafts fielded per row
    logits: Optional[torch.Tensor]  # (S, k, V) fp32 drafter logits, or None


class NgramDrafter:
    """Prompt-lookup self-drafting over each request's own history. For a
    history ending in suffix g (the longest n-gram, n <= ngram_n, that also
    occurs earlier), propose the tokens that followed g's most recent
    earlier occurrence; no match at any n means no proposals, and the row
    runs the verify step as a plain one-token decode."""

    def __init__(self, *, k: int, ngram_n: int = 3, metrics=None):
        self.k = k
        self.ngram_n = ngram_n
        self._h_draft = _draft_histogram(metrics)

    def propose(self, contexts, want, generator, params_list) -> DraftProposal:
        t0 = time.perf_counter()
        n_slots = len(want)
        tokens = np.zeros((n_slots, self.k), np.int32)
        counts = np.zeros((n_slots,), np.int32)
        for slot, hist in contexts.items():
            m = int(want[slot])
            if m <= 0 or len(hist) < 2:
                continue
            cont = self._lookup(hist, m)
            counts[slot] = len(cont)
            tokens[slot, :len(cont)] = cont
        if self._h_draft is not None:
            self._h_draft.observe(time.perf_counter() - t0)
        return DraftProposal(tokens=tokens, counts=counts, logits=None)

    def _lookup(self, hist, m: int) -> list[int]:
        for n in range(min(self.ngram_n, len(hist) - 1), 0, -1):
            suffix = hist[-n:]
            # The most recent earlier occurrence, ending strictly before the
            # history's end so that it has a continuation.
            for j in range(len(hist) - n - 1, -1, -1):
                if hist[j:j + n] == suffix:
                    cont = hist[j + n:j + n + m]
                    if cont:
                        return [int(t) for t in cont]
        return []

    def release_slot(self, slot: int) -> None:  # stateless
        pass

    def reset(self) -> None:
        pass


class ModelDrafter:
    """A small model proposing drafts from its own StateStore, whose pool
    holds ``max_seq_len + k`` tokens a slot (draft-time writes run up to
    k - 1 past the committed length; a model without attention holds no
    pages). On the CPU nothing is captured; on the card ``graph = False``
    on both steps, set before the first round, runs them eagerly. A model
    with state rows snapshots them around the draft steps
    (:meth:`snapshot`, :meth:`restore`)."""

    def __init__(self, model, params, *, num_slots: int, page_size: int, max_seq_len: int,
                 k: int, draft_chunk: int = 16, metrics=None):
        self._h_draft = _draft_histogram(metrics)
        self.model = model
        self.params = params
        self.k = k
        self.page_size = page_size
        # A steady round replays at most k + 1 tokens (the accepted drafts
        # and the target's token): never chunk below that, or every round
        # pays two catch-up steps.
        self.chunk = max(int(draft_chunk), k + 1)
        self.profile = model.cb_profile()
        width = -(-(max_seq_len + k) // page_size)
        num_pages = num_slots * width + 1 if self.profile.needs_kv_pages else 2
        self.store = StateStore.build(model, num_slots=num_slots, num_pages=num_pages,
                                      page_size=page_size, pages_per_slot=width)
        # Each recurrent layer's state-row leaves, in place for the snapshot.
        self._rows = [leaf for pool in self.store.pools if "state" in pool
                      for leaf in pool["state"].values()]
        self._pages: dict[int, list[int]] = {s: [] for s in range(num_slots)}
        self._on_card = model.device.type == "cuda"
        graph = model.engine.backend == "cuda"
        n, dev = num_slots, model.device
        zeros = lambda *shape: np.zeros(shape, np.int32)  # noqa: E731
        self._catch_up = GraphStep(self._catch_up_forward, {
            "tokens": zeros(n, self.chunk), "page_table": zeros(n, width),
            "seq_lens": zeros(n), "lengths": zeros(n), "active": zeros(n), "done": zeros(n)},
            dev, graph=graph)
        self._decode = GraphStep(self._decode_forward, {
            "page_table": zeros(n, width), "seq_lens": zeros(n), "active": zeros(n),
            **stack_params([GREEDY] * n)}, dev, graph=graph)
        # The decode step's input tokens: the drafts sampled on the card.
        self._tok = torch.zeros((n, 1), dtype=torch.int64, device=dev)
        self._staged: list[torch.Tensor] = []

    # -- the two steps -------------------------------------------------------
    def _catch_up_forward(self, d: dict, pools) -> torch.Tensor:
        return self.model.verify_cb(self.params, d["tokens"], pools, d["page_table"],
                                    d["seq_lens"], d["lengths"], d["active"] != 0,
                                    page_size=self.page_size, commit=True)

    def _decode_forward(self, d: dict, pools) -> torch.Tensor:
        return self.model.decode_cb(self.params, self._tok, pools, d["page_table"],
                                    d["seq_lens"], d["active"] != 0, page_size=self.page_size)

    def _load(self, step: GraphStep, arrays: dict) -> None:
        staged, _ = stage(arrays, self._on_card)
        self._staged.append(staged)  # held until the round ends in a host copy
        step.load(staged, self.store.pools)

    # -- slot lifecycle ------------------------------------------------------
    def release_slot(self, slot: int) -> None:
        """The target's request left this slot: free the drafter's pages
        and zero its consumed length."""
        if self._pages[slot]:
            self.store.allocator.decref(self._pages[slot])
            self._pages[slot] = []
        self.store.reset_slot(slot)

    def reset(self) -> None:
        for slot in range(self.store.num_slots):
            self.release_slot(slot)

    def snapshot(self) -> list[torch.Tensor]:
        """Clones of the state-row leaves (none without state rows)."""
        return [leaf.clone() for leaf in self._rows]

    def restore(self, snap: list[torch.Tensor]) -> None:
        """Copy a :meth:`snapshot` back into the leaves' own storage."""
        for leaf, saved in zip(self._rows, snap):
            leaf.copy_(saved)

    def _ensure_pages(self, slot: int, end_position: int) -> None:
        if not self.profile.needs_kv_pages:
            return
        need = self.store.allocator.pages_for(end_position)
        pages = self._pages[slot]
        while len(pages) < need:
            (pg,) = self.store.allocator.alloc(1)
            self.store.set_page(slot, len(pages), pg)
            pages.append(pg)

    # -- proposing -----------------------------------------------------------
    def propose(self, contexts, want, generator: torch.Generator, params_list) -> DraftProposal:
        """contexts: {slot: committed history (prompt + emitted)}; want: (S,)
        drafts asked per row; params_list: each slot's SamplingParams, which
        the drafts are drawn with (so q is the distribution the rejection
        sampler assumes). Returns a fixed-shape proposal; the round ends in
        one copy of the drafts to the host."""
        t0 = time.perf_counter()
        store, k = self.store, self.k
        n_slots = store.num_slots
        self._staged = []
        q0 = self._replay(contexts)

        base = store.seq_lens.copy()
        drafting = np.zeros((n_slots,), bool)
        for slot in contexts:
            if int(want[slot]) > 0:
                drafting[slot] = True
                self._ensure_pages(slot, int(base[slot]) + k - 1)  # writes at base .. base+k-2
        sp = stack_params(params_list)

        def load_decode(offset):
            self._load(self._decode, {"page_table": store.page_table,
                                      "seq_lens": base + offset, "active": drafting, **sp})

        load_decode(0)
        d = self._decode.inputs
        sample = lambda logits: sample_logits(  # noqa: E731
            logits, generator, temperature=d["temperature"], top_k=d["top_k"], top_p=d["top_p"])
        cur = sample(q0)
        drafts, logits_per_pos = [cur], [q0]
        snap = self.snapshot()
        for i in range(1, k):
            if i > 1:
                load_decode(i - 1)
            self._tok.copy_(cur[:, None])
            logits = self._decode.run().clone()  # the graph's tensor is rewritten next step
            logits_per_pos.append(logits)
            cur = sample(logits)
            drafts.append(cur)
        self.restore(snap)
        tokens = torch.stack(drafts, dim=1).cpu().numpy()
        self._staged = []
        counts = np.where(drafting, np.minimum(want, k), 0).astype(np.int32)
        if self._h_draft is not None:
            self._h_draft.observe(time.perf_counter() - t0)
        return DraftProposal(tokens=tokens.astype(np.int32), counts=counts,
                             logits=torch.stack(logits_per_pos, dim=1))

    def _replay(self, contexts) -> torch.Tensor:
        """Catch up on the committed tokens not consumed yet, in chunks of
        ``self.chunk``; returns each row's logits at its last position, the
        distribution its first draft is drawn from."""
        store = self.store
        n_slots, chunk = store.num_slots, self.chunk
        targets = {slot: len(hist) for slot, hist in contexts.items()}
        q0 = torch.zeros((n_slots, self.model.cfg.vocab_size), dtype=torch.float32,
                         device=self.model.device)
        while True:
            toks = np.zeros((n_slots, chunk), np.int32)
            lengths = np.zeros((n_slots,), np.int32)
            act = np.zeros((n_slots,), bool)
            done_rows = np.zeros((n_slots,), bool)
            for slot, hist in contexts.items():
                have = int(store.seq_lens[slot])
                todo = targets[slot] - have
                if todo <= 0:
                    continue
                m = min(todo, chunk)
                toks[slot, :m] = hist[have:have + m]
                lengths[slot] = m
                act[slot] = True
                done_rows[slot] = m == todo
                self._ensure_pages(slot, have + m)
            if not act.any():
                return q0
            self._load(self._catch_up, {"tokens": toks, "page_table": store.page_table,
                                        "seq_lens": store.seq_lens, "lengths": lengths,
                                        "active": act, "done": done_rows})
            logits = self._catch_up.run()
            # Rows whose replay ends here: their logits at the last valid
            # position, the next token's distribution.
            d = self._catch_up.inputs
            last = (d["lengths"].long() - 1).clamp(min=0)
            last = torch.gather(logits, 1, last[:, None, None].expand(-1, 1, logits.shape[-1]))
            q0 = torch.where((d["done"] != 0)[:, None], last[:, 0].float(), q0)
            store.seq_lens += lengths
