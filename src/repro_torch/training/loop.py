"""The training step of the port: loss, gradients, metrics and the anomaly
guard (counterpart of ``repro.training.loop``).

The cross-entropy runs over sequence chunks of ``XENT_CHUNK`` positions,
each under ``torch.utils.checkpoint``, so the (B, S, vocab) fp32 logits
never all live at once: each chunk's logits are made in the forward, freed,
and made again in the backward, as the reference's ``jax.checkpoint`` of
its chunk does.

There is no loss scaling, as in the reference: an fp16 gradient that
overflows gives a non-finite norm, and the anomaly guard skips that
update.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.engine import Engine
from repro_torch.optim import global_norm

AUX_LOSS_WEIGHT = 0.01
XENT_CHUNK = 512


def _shift_labels(tokens: torch.Tensor):
    """Next-token labels and mask (the last position is unsupervised)."""
    labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:]), torch.zeros_like(tokens[:, -1:])],
                     dim=1).float()
    return labels, mask


def chunked_xent(model, params, h: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 chunk: int = XENT_CHUNK, engine: Engine | None = None):
    """(sum of the cross-entropy over masked positions, number of them),
    chunk by chunk over the sequence with each chunk recomputed in the
    backward."""
    s = h.shape[1]
    c = min(chunk, s)

    def chunk_loss(h_c, y_c, m_c):
        logits = model.logits(params, h_c, engine)  # (B, c, V) fp32
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, y_c[..., None])[..., 0]
        return ((logz - ll) * m_c).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, s, c):
        sl = slice(s0, s0 + c)
        total = total + checkpoint(chunk_loss, h[:, sl], labels[:, sl], mask[:, sl],
                                   use_reentrant=False)
    return total, mask.sum()


def make_loss_fn(model, *, backend: str | None = None) -> Callable:
    """loss_fn(params, batch) -> (loss, {"xent", "aux"}) on the model's
    engine, with ``backend`` swapping its execution backend alone."""
    eng = model.engine.with_backend(backend) if backend else model.engine

    def loss_fn(params, batch):
        h, aux = model.forward(params, batch, engine=eng)
        labels, mask = _shift_labels(batch["tokens"])
        total, denom = chunked_xent(model, params, h, labels, mask, engine=eng)
        loss = total / denom.clamp(min=1.0)
        return loss + AUX_LOSS_WEIGHT * aux, {"xent": loss, "aux": aux}

    return loss_fn


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any
    # Fault tolerance: the number of steps the anomaly guard skipped.
    skipped: int


def make_train_step(model, optimizer, *, grad_accum: int = 1,
                    backend: str | None = None) -> Callable:
    """train_step(state, batch) -> (state, metrics).

    ``batch`` ("tokens", and the stub "frames" or "vis_embeds" of the
    encoder-decoder and VLM families) may hold numpy arrays; they go to the
    model's device.
    When the global gradient norm or the loss is not finite, the anomaly
    guard keeps the parameters and moments (no update is computed) and
    counts the step in ``skipped``; the step counter advances either way.
    grad_accum: split the batch into that many micro-batches and average
    their gradients (summed in the parameters' format, as the reference
    does). The state is not modified: each step returns new parameters and
    moments.
    """
    loss_fn = make_loss_fn(model, backend=backend)

    def grad_fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves(live))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, grads)

    def train_step(state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        batch["tokens"] = batch["tokens"].long()
        if grad_accum > 1:
            loss, grads = 0.0, tree_map(torch.zeros_like, state.params)
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])
                     for k, v in batch.items()}
            for i in range(grad_accum):
                lv, metrics, g = grad_fn(state.params, {k: v[i] for k, v in micro.items()})
                loss = loss + lv
                grads = tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        else:
            loss, metrics, grads = grad_fn(state.params, batch)

        gnorm = global_norm(grads)
        if not bool(torch.isfinite(gnorm) & torch.isfinite(loss)):
            new_params, new_opt, skipped = state.params, state.opt_state, state.skipped + 1
        else:
            new_params, new_opt = optimizer.update(state.params, grads, state.opt_state,
                                                   state.step, gnorm)
            skipped = state.skipped
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, skipped=skipped)
        return TrainState(state.step + 1, new_params, new_opt, skipped), metrics

    return train_step
