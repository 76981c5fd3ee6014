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
valid, which is the whole KV rollback. The port's models keep no state
rows, so no commit pass follows (the reference's ``commit_state``).
"""
from __future__ import annotations

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
                 pages_per_slot: int):
        self.model = model
        self.params = params
        self.page_size = page_size
        self.width = k + 1
        self._on_card = model.device.type == "cuda"
        n = num_slots
        self.step = GraphStep(self._forward, self._arrays(
            np.zeros((n, self.width), np.int32), np.zeros((n, pages_per_slot), np.int32),
            np.zeros((n,), np.int32), np.zeros((n,), np.int32), np.zeros((n,), bool),
            [GREEDY] * n), model.device, graph=model.engine.backend == "cuda")

    @staticmethod
    def _arrays(tokens, page_table, seq_lens, lengths, active, params_list) -> dict:
        return {"tokens": tokens, "page_table": page_table, "seq_lens": seq_lens,
                "lengths": lengths, "active": active, **stack_params(params_list)}

    def _forward(self, d: dict, pools) -> torch.Tensor:
        return self.model.verify_cb(self.params, d["tokens"], pools, d["page_table"],
                                    d["seq_lens"], d["lengths"], d["active"] != 0,
                                    page_size=self.page_size, commit=False)

    def verify(self, pools, tokens: np.ndarray, page_table: np.ndarray, seq_lens: np.ndarray,
               lengths: np.ndarray, active: np.ndarray, params_list) -> torch.Tensor:
        """One verify step; returns the logits (S, k + 1, V) (with the graph,
        its own tensor, valid until the next round)."""
        staged, _ = stage(self._arrays(tokens, page_table, seq_lens, lengths, active,
                                       params_list), self._on_card)
        self._staged = staged  # read by the copy in flight; released next round
        self.step.load(staged, pools)
        return self.step.run()

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
