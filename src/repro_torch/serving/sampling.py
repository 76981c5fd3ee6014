"""Token sampling for the serving step: greedy + temperature/top-k/top-p
(counterpart of ``repro.serving.sampling``).

One function over the whole decode batch: per-slot parameters arrive as
tensors so requests with different settings share one step. Temperature 0
means greedy (argmax); top_k 0 and top_p 1.0 disable their filters. The
random draw uses a ``torch.Generator`` (Gumbel-max), so its bits differ
from the reference's ``jax.random``; the greedy path and the filtered
distribution are the same.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = -1e30


class SamplingParams(NamedTuple):
    """Per-request sampling settings (host-side; stacked into tensors)."""

    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # 0 => no top-k filter
    top_p: float = 1.0  # 1.0 => no nucleus filter


GREEDY = SamplingParams()


def stack_params(params_list) -> dict[str, np.ndarray]:
    """Stack per-slot SamplingParams into the arrays sample_logits takes."""
    return {
        "temperature": np.asarray([p.temperature for p in params_list], np.float32),
        "top_k": np.asarray([p.top_k for p in params_list], np.int32),
        "top_p": np.asarray([p.top_p for p in params_list], np.float32),
    }


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scaled logits with the top-k / top-p filtered entries at
    NEG_INF. logits: (S, V); parameters: (S,) tensors."""
    v = logits.shape[-1]
    scaled = logits.float() / temperature.clamp(min=1e-6)[:, None]
    # top-k: drop everything below the k-th largest logit (ties survive).
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k.clamp(1, v), torch.full_like(top_k, v))
    kth = torch.gather(sorted_desc, -1, (k - 1).long()[:, None])
    scaled = torch.where(scaled < kth, NEG_INF, scaled)
    # top-p: smallest prefix of the sorted distribution with mass >= top_p;
    # the first sorted column always survives.
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    keep[:, 0] = True
    thresh = torch.where(keep, sorted_desc, torch.inf).amin(-1, keepdim=True)
    return torch.where(scaled < thresh, NEG_INF, scaled)


def sample_logits(logits: torch.Tensor, generator: torch.Generator,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """One token per row. Rows with temperature <= 0 take the argmax; the
    random draw happens for every row (one fixed shape) and is discarded
    there. Returns (S,) int32."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    scaled = filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)
