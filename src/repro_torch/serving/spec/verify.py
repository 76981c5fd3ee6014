"""The target side of speculative decoding (counterpart of
``repro.serving.spec.verify``).

:class:`Verifier` owns the fixed-shape verify step, ``Transformer.verify_cb``
over (num_slots, k + 1) tokens: every slot's row [last token | drafts]
runs through the target in one step, with logits at every position. On
the card the step is a CUDA graph (:class:`~repro_torch.serving.engine.GraphStep`),
captured at the first round after one eager warm-up on zeroed inputs, as
the decode step is; each round refreshes its static inputs with one
staged copy. The rejection sampler then runs eagerly on the graph's
logits. Fresh K/V of every fielded position go through the page table;
what lies past the prefix the server then commits is never read back as
valid, which is the whole KV rollback.

Recurrent state rows cannot roll back so: the verify pass leaves them as
they were (``commit=False``), and a target that holds them
(``needs_state_commit``) takes the reference's second pass,
:meth:`Verifier.commit_state`: the same step with ``commit=True`` and each
row's length clamped to accepted + 1, which scans exactly the tokens the
round consumed into the rows and rewrites their K/V. It is a second
:class:`GraphStep` with its own capture; its inputs are the verify step's
static buffer, copied on the card, with the clamped lengths written over
them there, so the pass needs no host round trip.

With a metrics registry, each verify step is observed into
``serving_verify_seconds`` as in the reference. The reference blocks on
the step's logits for that; the port adds no wait: on the card two CUDA
events bracket the step, and :meth:`Verifier.observe` reads their interval
after the round's one copy to the host (the card is idle when the step is
enqueued, because the drafter's round ends in a copy too, so the interval
is the step's wall time); on the CPU the step runs synchronously and is
timed on the host clock.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.serving.engine import GraphStep, stage
from repro_torch.serving.sampling import GREEDY, stack_params
from repro_torch.serving.spec.rejection import speculative_sample


class Verifier:
    """The verify step and the rejection sampler. On the CPU nothing is
    captured; on the card ``step.graph = False``, set before the first
    round, runs the step eagerly (the tests and ``chip_smoke.py`` compare
    the two)."""

    def __init__(self, model, params, *, num_slots: int, k: int, page_size: int,
                 pages_per_slot: int, metrics=None):
        # Duck-typed MetricsRegistry (no repro_torch.obs import on the hot path).
        self._h_verify = None if metrics is None else metrics.histogram(
            "serving_verify_seconds", help="Wall-clock of one fixed-shape verify step")
        self._timing = None
        self.model = model
        self.params = params
        self.page_size = page_size
        self.width = k + 1
        self._on_card = model.device.type == "cuda"
        n = num_slots
        arrays = self._arrays(
            np.zeros((n, self.width), np.int32), np.zeros((n, pages_per_slot), np.int32),
            np.zeros((n,), np.int32), np.zeros((n,), np.int32), np.zeros((n,), bool),
            [GREEDY] * n)
        graph = model.engine.backend == "cuda"
        self.step = GraphStep(self._forward, arrays, model.device, graph=graph)
        # Only a target that holds recurrent state rows needs the commit pass.
        self.needs_state_commit = model.cb_profile().has_state_rows
        self.commit = (GraphStep(self._commit_forward, arrays, model.device, graph=graph)
                       if self.needs_state_commit else None)

    @staticmethod
    def _arrays(tokens, page_table, seq_lens, lengths, active, params_list) -> dict:
        return {"tokens": tokens, "page_table": page_table, "seq_lens": seq_lens,
                "lengths": lengths, "active": active, **stack_params(params_list)}

    def _forward(self, d: dict, pools) -> torch.Tensor:
        return self.model.verify_cb(self.params, d["tokens"], pools, d["page_table"],
                                    d["seq_lens"], d["lengths"], d["active"] != 0,
                                    page_size=self.page_size, commit=False)

    def _commit_forward(self, d: dict, pools) -> torch.Tensor:
        return self.model.verify_cb(self.params, d["tokens"], pools, d["page_table"],
                                    d["seq_lens"], d["lengths"], d["active"] != 0,
                                    page_size=self.page_size, commit=True)

    def verify(self, pools, tokens: np.ndarray, page_table: np.ndarray, seq_lens: np.ndarray,
               lengths: np.ndarray, active: np.ndarray, params_list) -> torch.Tensor:
        """One verify step; returns the logits (S, k + 1, V) (with the graph,
        its own tensor, valid until the next round)."""
        staged, _ = stage(self._arrays(tokens, page_table, seq_lens, lengths, active,
                                       params_list), self._on_card)
        self._staged = staged  # read by the copy in flight; released next round
        self.step.load(staged, pools)
        if self._h_verify is None:
            return self.step.run()
        if self._on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            logits = self.step.run()
            end.record()
            self._timing = (start, end)
        else:
            t0 = time.perf_counter()
            logits = self.step.run()
            self._timing = time.perf_counter() - t0
        return logits

    def observe(self) -> None:
        """Observe the last verify step's time into ``serving_verify_seconds``
        (no-op without a registry). Call it once the round's results have
        reached the host: on the card it reads the step's CUDA events."""
        if self._timing is None:
            return
        t, self._timing = self._timing, None
        self._h_verify.observe(t if isinstance(t, float) else t[0].elapsed_time(t[1]) / 1e3)

    def sample(self, logits: torch.Tensor, draft_logits: Optional[torch.Tensor],
               generator: torch.Generator):
        """Rejection-sample the round just verified (its inputs are the
        step's static buffer). ``draft_logits`` None means deterministic
        drafts. Returns (out_tokens (S, k + 1), n_accepted (S,), finite):
        the last a device bool, whether every active row's logits are
        finite."""
        d = self.step.inputs
        active = d["active"] != 0
        out, acc = speculative_sample(logits, d["tokens"][:, 1:], generator, d["temperature"],
                                      d["top_k"], d["top_p"], d["lengths"], active,
                                      draft_logits=draft_logits)
        finite = (torch.isfinite(logits).flatten(1).all(-1) | ~active).all()
        return out, acc, finite

    def commit_state(self, pools, n_accepted: torch.Tensor) -> None:
        """Scan the tokens this round consumed into the state rows, in
        place: the verify step's inputs with ``lengths = accepted + 1`` on
        each active row (0 elsewhere). The verify row's token i (the last
        committed token, then the drafts) is the input at position
        seq_lens + i; the round's last emitted token is fed next round."""
        self.commit.load(self.step.buf, pools)
        d = self.commit.inputs
        d["lengths"].copy_(torch.where(d["active"] != 0, n_accepted.to(torch.int32) + 1, 0))
        self.commit.run()
