"""The continuous-batching server of the port (counterpart of
``repro.serving.server`` for whole-prompt prefill at dispatch depth 0).

One :meth:`Server.step`:

  1. admit queued requests into free slots (pages permitting);
  2. prefill each newly admitted request's whole prompt, padded up to a
     multiple of ``prefill_bucket``; the step samples its first token;
  3. run ONE decode step over every slot, active or not (one fixed shape);
  4. harvest: copy the sampled tokens to the host, commit them, finish
     requests at their length or EOS, and emit :class:`TokenEvent`s.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.transformer import resolve_device
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.scheduler import RUNNING, Request, Scheduler


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Sizing of the serving engine (all shapes derive from these)."""

    num_slots: int = 4  # concurrent decode lanes (the fixed batch)
    page_size: int = 16  # tokens per KV page
    max_seq_len: int = 256  # per-request prompt + generation cap
    # Total pages including the null page; default: every slot's worst case.
    num_pages: Optional[int] = None
    prefill_bucket: int = 32  # prompts pad up to a multiple of this

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq_len // self.page_size)

    def bucket(self, prompt_len: int) -> int:
        b = self.prefill_bucket
        return -(-prompt_len // b) * b


class TokenEvent(NamedTuple):
    """One streamed token, emitted when it is harvested."""

    rid: int
    token: int
    index: int  # position within the generated sequence
    finished: bool
    finish_reason: Optional[str]


@dataclasses.dataclass
class ServerStats:
    """Plain counters of one run."""

    prefill_calls: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0  # tokens sampled for active slots
    slot_steps: int = 0  # decode_steps * num_slots
    prefill_s: float = 0.0
    decode_s: float = 0.0
    nonfinite_steps: int = 0  # steps whose live logits held inf or NaN

    @property
    def utilization(self) -> float:
        """Fraction of offered decode-lane steps that produced a token."""
        return self.decode_tokens / self.slot_steps if self.slot_steps else 0.0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0


class Server:
    """Continuous-batching inference server over the engine's StateStore.
    The model's engine decides the path: on the ``"cuda"`` backend every
    GEMM and the decode attention launch the port's kernels.

    ``device`` is the card by default; it raises when CUDA is absent unless
    the caller asks for ``"cpu"``, and the model must live there."""

    def __init__(self, model, params, config: Optional[ServerConfig] = None, *,
                 seed: int = 0, device="cuda"):
        device = resolve_device(device)
        if model.device.type != device.type:
            raise ValueError(f"the model lives on {model.device}, the server on {device}")
        self.model = model
        self.params = params
        self.config = config if config is not None else ServerConfig()
        profile = model.cb_profile()
        if profile.has_state_rows or profile.kv_window is not None:
            raise NotImplementedError(
                "the port's StateStore holds full-length KV pages only (no state rows, no window)")
        self.engine = EngineCore(model, params, self.config, seed=seed)
        self.engine.fresh()
        self.scheduler = Scheduler(
            num_slots=self.config.num_slots, pool=self.cache.allocator,
            pages_per_slot=self.config.pages_per_slot, max_seq_len=self.config.max_seq_len,
        )
        self.stats = ServerStats()
        self.results: dict[int, Request] = {}
        # Tokens dispatched per running request; committed tokens lag by
        # the steps still in flight.
        self._generated: dict[int, int] = {}

    @property
    def cache(self):
        return self.engine.cache

    def submit(self, prompt: Iterable[int], *, max_new_tokens: int = 32,
               sampling: SamplingParams = GREEDY, eos_id: Optional[int] = None) -> Request:
        return self.scheduler.submit(Request(
            prompt=[int(t) for t in prompt], max_new_tokens=max_new_tokens,
            sampling=sampling, eos_id=eos_id,
        ))

    @torch.inference_mode()
    def step(self) -> list[TokenEvent]:
        """One scheduler iteration: admit, prefill the admitted, decode
        every slot, harvest. Returns the tokens harvested. Runs under
        ``torch.inference_mode``: serving records no autograd graph."""
        events: list[TokenEvent] = []
        for req in self.scheduler.admit():
            self._dispatch_prefill(req)
        decoding = [(slot, req) for slot, req in self.scheduler.running.items()
                    if req.decoding and self._generated[req.rid] < self._gen_cap(req)]
        if decoding:
            self._dispatch_decode(decoding)
        while self._harvest_one(events):
            pass
        self._sync_stats()
        return events

    def run(self) -> dict[int, Request]:
        """Drain the queue; returns {rid: finished Request}."""
        while self.scheduler.has_work():
            self.step()
        return dict(self.results)

    def stream(self):
        """Generator over TokenEvents until all submitted work finishes."""
        while self.scheduler.has_work():
            yield from self.step()

    # -- internals ---------------------------------------------------------
    def _gen_cap(self, req: Request) -> int:
        return max(0, min(req.max_new_tokens, req.max_total - req.prompt_len))

    def _mirror_pages(self, req: Request, grown) -> None:
        for idx, page in grown:
            self.cache.set_page(req.slot, idx, page)

    def _dispatch_prefill(self, req: Request) -> None:
        n = req.prompt_len
        self._mirror_pages(req, self.scheduler.ensure_pages(req, n))
        toks = np.zeros((1, self.config.bucket(n)), np.int32)
        toks[0, :n] = req.prompt
        self.engine.dispatch_prefill(
            tokens=toks, page_row=self.cache.page_table[req.slot], slot=req.slot,
            start=0, n=n, sampling=req.sampling, payload=req,
        )
        req.prefilled = n
        self._generated[req.rid] = 1  # the prefill samples the first token
        self.cache.seq_lens[req.slot] = n

    def _dispatch_decode(self, decoding) -> None:
        n = self.config.num_slots
        active = np.zeros((n,), bool)
        params_list = [GREEDY] * n
        for slot, req in decoding:
            grown = self.scheduler.ensure_page(req, int(self.cache.seq_lens[slot]))
            if grown is not None:
                self._mirror_pages(req, [grown])
            active[slot] = True
            params_list[slot] = req.sampling
        self.engine.dispatch_decode(active=active, params_list=params_list,
                                    payload=list(decoding))
        for slot, req in decoding:
            self._generated[req.rid] += 1
            self.cache.seq_lens[slot] += 1

    def _harvest_one(self, events: list[TokenEvent]) -> bool:
        res = self.engine.harvest_one()
        if res is None:
            return False
        rec, toks = res
        if rec.kind == "decode":
            committed = 0
            for slot, req in rec.payload:
                if req.status != RUNNING or req.slot != slot:
                    continue
                self._commit(req, int(toks[slot]), events)
                committed += 1
            self.stats.decode_steps += 1
            self.stats.slot_steps += self.config.num_slots
            self.stats.decode_tokens += committed
        else:
            req = rec.payload
            self.stats.prefill_calls += 1
            self.stats.prefill_tokens += req.prompt_len
            if req.status == RUNNING:
                self._commit(req, int(toks[0]), events)
        return True

    def _commit(self, req: Request, token: int, events: list[TokenEvent]) -> None:
        finished = self.scheduler.commit(req, token)
        events.append(TokenEvent(rid=req.rid, token=token, index=req.num_generated - 1,
                                 finished=finished, finish_reason=req.finish_reason))
        if finished:
            slot = req.slot
            self.scheduler.finish(req)
            self.cache.reset_slot(slot)
            self.results[req.rid] = req
            self._generated.pop(req.rid, None)

    def _sync_stats(self) -> None:
        self.stats.prefill_s = self.engine.prefill_s
        self.stats.decode_s = self.engine.decode_s
        self.stats.nonfinite_steps = self.engine.nonfinite_steps

