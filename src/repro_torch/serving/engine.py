"""The serving engine core of the port: device steps, the per-slot
last-token tensor, the sampling generator, and the queue of dispatched
steps (counterpart of ``repro.serving.engine.EngineCore``).

A ``dispatch_*`` call enqueues the model step and the sampling on the
device and returns; :meth:`EngineCore.harvest_one` copies the oldest
step's sampled tokens to the host, which is where the host waits. The
server harvests every step in the iteration that dispatched it (the
reference's ``async_depth=0``), so the port's outputs follow the
reference's synchronous order.

Host mirrors are copied at dispatch: ``torch.from_numpy`` shares memory
with the numpy page table and sequence lengths, which the server mutates
right after dispatch (the reference's aliasing rule, ``engine.py:329-335``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.serving.cache import StateStore
from repro_torch.serving.sampling import sample_logits, stack_params


@dataclasses.dataclass
class InflightStep:
    """One dispatched step whose tokens the host has not read yet."""

    kind: str  # prefill_full | decode
    t_dispatch: float
    toks: torch.Tensor  # sampled tokens on the device
    finite: torch.Tensor  # device bool: the step's live logits were all finite
    payload: Any


class EngineCore:
    """Device-stepping core of the continuous-batching server."""

    def __init__(self, model, params, config, *, seed: int = 0):
        self.model = model
        self.params = params
        self.config = config
        self.seed = seed
        self.device = model.device
        self.cache: Optional[StateStore] = None
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.nonfinite_steps = 0

    def resolved_num_pages(self) -> int:
        cfg = self.config
        if cfg.num_pages is not None:
            return cfg.num_pages
        per_slot = -(-cfg.max_seq_len // cfg.page_size)
        return max(cfg.num_slots * per_slot + 1, 2)

    def fresh(self) -> None:
        """(Re)build the StateStore and the per-run device state."""
        cfg = self.config
        self.cache = StateStore.build(
            self.model, num_slots=cfg.num_slots, num_pages=self.resolved_num_pages(),
            page_size=cfg.page_size, pages_per_slot=cfg.pages_per_slot,
        )
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self._last_tok = torch.zeros((cfg.num_slots, 1), dtype=torch.int64, device=self.device)
        self._inflight: collections.deque[InflightStep] = collections.deque()
        self._t_last_harvest = 0.0
        self.prefill_s = self.decode_s = 0.0
        self.nonfinite_steps = 0

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        # .copy(): on the CPU from_numpy would alias the live host mirror.
        return torch.from_numpy(a.copy()).to(self.device)

    def _sample(self, logits, params_list):
        sp = {k: torch.from_numpy(v).to(self.device) for k, v in stack_params(params_list).items()}
        return sample_logits(logits, self._gen, **sp)

    def dispatch_prefill(self, *, tokens: np.ndarray, page_row: np.ndarray, slot: int,
                         start: int, n: int, sampling, payload=None) -> None:
        """Enqueue one whole-prompt prefill of one slot and the sampling of
        its first token, which goes into the last-token tensor so a decode
        can be dispatched against it."""
        t0 = time.perf_counter()
        logits = self.model.prefill_cb(
            self.params, self._to_device(tokens), self.cache.pools,
            self._to_device(page_row), start, n, page_size=self.config.page_size,
        )
        toks = self._sample(logits, [sampling])
        self._last_tok[slot, 0] = toks[0]
        self._inflight.append(InflightStep(
            "prefill_full", t0, toks, torch.isfinite(logits).all(), payload))

    def dispatch_decode(self, *, active: np.ndarray, params_list, payload=None) -> None:
        """Enqueue one decode step over every slot; inputs come from the
        device last-token tensor, and sampled tokens of active slots merge
        back into it."""
        t0 = time.perf_counter()
        active_dev = self._to_device(active)
        logits = self.model.decode_cb(
            self.params, self._last_tok, self.cache.pools,
            self._to_device(self.cache.page_table), self._to_device(self.cache.seq_lens),
            active_dev, page_size=self.config.page_size,
        )
        toks = self._sample(logits, params_list)
        self._last_tok = torch.where(active_dev[:, None], toks[:, None].long(), self._last_tok)
        finite = torch.isfinite(logits[active_dev]).all()
        self._inflight.append(InflightStep("decode", t0, toks, finite, payload))

    def harvest_one(self):
        """Wait for the oldest dispatched step and return ``(step, tokens)``
        as a numpy array; None when nothing is in flight. Each step is
        charged the wall time from max(its dispatch, the previous harvest)
        to the moment its tokens reached the host."""
        if not self._inflight:
            return None
        rec = self._inflight.popleft()
        toks = rec.toks.cpu().numpy()
        if not bool(rec.finite):
            self.nonfinite_steps += 1
        t_done = time.perf_counter()
        dt = t_done - max(rec.t_dispatch, self._t_last_harvest)
        self._t_last_harvest = t_done
        if rec.kind == "decode":
            self.decode_s += dt
        else:
            self.prefill_s += dt
        return rec, toks
