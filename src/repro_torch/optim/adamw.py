"""AdamW with decoupled weight decay, global-norm clipping and fp32 moments
(counterpart of ``repro.optim.adamw``).

Every hyperparameter and every scalar of the update (bias corrections,
clip scale, learning rate) is computed in fp32, as the reference does, and
the update itself runs in fp32 and is cast back to each parameter's format.
The update is functional: it returns new parameters and moments and
leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core.tree import leaves, tree_map

_F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    sq = [x.float().square().sum() for x in leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[int], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device)  # noqa: E731
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def _lr(self, step: int) -> torch.Tensor:
        return self.lr(step) if callable(self.lr) else _f32(self.lr)

    @torch.no_grad()
    def update(self, params, grads, state, step: int, gnorm: torch.Tensor):
        """(new params, new moments) after the update of step ``step``
        (0-based); ``gnorm`` is ``global_norm(grads)``, which the train
        step has already computed for its anomaly guard. Scalars are 0-d
        fp32 tensors; torch treats those on the host as scalars beside
        tensors on the card."""
        step_f = _f32(step + 1)
        if self.clip_norm is not None:
            scale = torch.clamp(_f32(self.clip_norm) / torch.clamp(gnorm, min=1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        b1, b2 = _f32(self.b1), _f32(self.b2)
        c1, c2 = _f32(1 - self.b1), _f32(1 - self.b2)
        mu = tree_map(lambda m, g: b1 * m + c1 * g.float(), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + c2 * g.float().square(), state["nu"], grads)
        bc1, bc2 = 1 - b1 ** step_f, 1 - b2 ** step_f
        lr, wd, eps = self._lr(step), _f32(self.weight_decay), _f32(self.eps)

        def upd(p, m, v):
            u = (m / bc1) / ((v / bc2).sqrt() + eps) + wd * p.float()
            return (p.float() - lr * u).to(p.dtype)

        return tree_map(upd, params, mu, nu), {"mu": mu, "nu": nu}


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine decay to ``floor * peak_lr``."""
    def lr(step: int) -> torch.Tensor:
        s = _f32(step)
        warm = peak_lr * (s + 1) / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)

    return lr
