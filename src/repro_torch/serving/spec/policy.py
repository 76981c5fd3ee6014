"""Speculation policy: the configuration and the per-request draft count
(a copy of ``repro.serving.spec.policy``).

``k`` fixes the verify step's shape: every step verifies k + 1 positions
whatever a row fields, and everything per request folds into
:func:`effective_k`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Sizing of the speculative decode loop.

    k: drafts proposed (and verified) per step; the verify step's token
        width is k + 1. A request's ``spec_k`` can lower it, never raise it.
    ngram_n: longest n-gram the prompt-lookup drafter matches on (it backs
        off to shorter grams before giving up).
    draft_chunk: token width of the model drafter's catch-up steps (it
        replays the tokens it has not seen yet in chunks of this size,
        never below k + 1).
    """

    k: int = 4
    ngram_n: int = 3
    draft_chunk: int = 16

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")
        if self.ngram_n < 1:
            raise ValueError(f"SpecConfig.ngram_n must be >= 1, got {self.ngram_n}")
        if self.draft_chunk < 1:
            raise ValueError(f"SpecConfig.draft_chunk must be >= 1, got {self.draft_chunk}")


def effective_k(requested: int, k_max: int, remaining: int, capacity: int) -> int:
    """Drafts one request fields this step: at most the configured
    ``k_max``, the request's remaining token budget less one (the round's
    last token always comes from the target), and the cache ``capacity``
    left past its committed length. 0 runs the row through the verify step
    as a plain one-token decode."""
    return max(0, min(requested, k_max, remaining - 1, capacity))
