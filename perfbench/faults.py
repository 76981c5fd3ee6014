"""Faults planted in the program's timed path underneath a run, each as a
serve cell can have it: a token altered where it is produced, a step that
leaves its state (the KV cache) unchanged, half of the decode batch left
out (its rows handed the other half's logits), and one slot's rows
handed another slot's logits. The benchmark's tests plant them on the
CPU, and ``controls.py --fault`` on the card, to see the check fail.
Planted before set-up, so the decode graph captures them."""
from __future__ import annotations

import contextlib

import torch


def altered_token(patch) -> None:
    from repro_torch.serving import engine

    real = engine.sample_logits
    patch(engine, "sample_logits", lambda logits, *a, **k: (
        (real(logits, *a, **k) + 1) % logits.shape[-1]).to(torch.int32))


def unchanged_state(patch) -> None:
    from repro_torch.models import attention

    patch(attention, "put_rows_", lambda table, idx, rows: None)


def _decode_logits(patch, alter) -> None:
    from repro_torch.models.transformer import Transformer

    real = Transformer.decode_cb
    patch(Transformer, "decode_cb", lambda self, *a, **k: alter(real(self, *a, **k)))


def half_batch(patch) -> None:
    def alter(logits):
        n = logits.shape[0] // 2
        return torch.cat([logits[:n], logits[:logits.shape[0] - n]])
    _decode_logits(patch, alter)


def one_slot(patch) -> None:
    _decode_logits(patch, lambda logits: torch.cat([logits[1:2], logits[1:]]))


FAULTS = {f.__name__: f for f in (altered_token, unchanged_state, half_batch, one_slot)}


@contextlib.contextmanager
def planted(name: str):
    """Fault ``name`` in place while the block runs."""
    undo = []

    def patch(obj, attr, new):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)
    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
