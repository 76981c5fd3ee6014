"""Exact rejection sampling for speculative decoding (counterpart of
``repro.serving.spec.rejection``).

The emitted tokens of every request are distributed as if the target had
decoded alone through the plain sampler:

- p and q are the distributions the plain sampler draws from:
  :func:`~repro_torch.serving.sampling.filter_logits` (temperature, top-k,
  top-p) on the target's and the drafter's logits, then softmax. Draft d_i
  is accepted with probability min(1, p_i(d_i) / q_i(d_i)); at the first
  rejection the token is drawn from the residual normalize(max(p_i - q_i,
  0)) (Leviathan et al., 2023);
- greedy rows (temperature <= 0) take the deterministic case: a draft is
  accepted iff it is the target's argmax, and the last token is the
  argmax at the first mismatch (or at the bonus position), so greedy
  speculative decoding emits the plain greedy chain;
- the n-gram drafter's proposals are deterministic, q = onehot(d): with
  ``draft_logits=None`` the test is u < p(d) and the residual
  normalize(p - onehot(d)).

Random draws come from an explicit ``torch.Generator`` (uniforms for the
tests, Gumbel-max for the draws), so their bits differ from the
reference's ``jax.random``; the decisions on greedy rows do not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.serving.sampling import filter_logits

_EPS = 1e-30


def _filtered_probs(logits, temperature, top_k, top_p) -> torch.Tensor:
    """softmax(filter_logits) over an (S, T, V) stack, parameters per row."""
    s, t, v = logits.shape
    flat = filter_logits(logits.reshape(s * t, v), temperature.repeat_interleave(t),
                         top_k.repeat_interleave(t), top_p.repeat_interleave(t))
    return torch.softmax(flat, dim=-1).reshape(s, t, v)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[s, idx[s]] over a's second axis: (S, T, ...) -> (S, ...)."""
    idx = idx.long().reshape(-1, 1, *([1] * (a.dim() - 2))).expand(-1, 1, *a.shape[2:])
    return torch.gather(a, 1, idx)[:, 0]


def speculative_sample(target_logits, draft_tokens, generator, temperature, top_k, top_p,
                       lengths, active, draft_logits=None):
    """Accept or reject one round of drafts against the verify logits.

    target_logits: (S, T, V), position i judges draft i + 1 and the last is
    the bonus position; draft_tokens: (S, T - 1), right-padded;
    temperature, top_k, top_p: (S,); lengths: (S,) drafts fielded + 1 (0
    for rows sitting out); active: (S,) bool; draft_logits: (S, T - 1, V)
    the drafter's logits the drafts were sampled from, or None for
    deterministic drafts (q = onehot(d)).

    Returns (out_tokens (S, T) int32, n_accepted (S,) int32): row s emits
    ``out_tokens[s, :n_accepted[s] + 1]``, the accepted drafts and one
    token of the target's (the residual draw at the first rejection, the
    bonus draw when every draft survived). Entries past that are garbage.
    """
    s, t, v = target_logits.shape
    kmax = t - 1
    dev = target_logits.device
    k_eff = (lengths.long() - 1).clamp(0, kmax)
    greedy_row = temperature <= 0.0
    drafts = draft_tokens.long()

    p = _filtered_probs(target_logits, temperature, top_k, top_p)
    tgt_argmax = target_logits.float().argmax(-1)
    p_at_d = torch.gather(p[:, :kmax], 2, drafts[..., None])[..., 0]
    if draft_logits is None:
        q_at_d = torch.ones((s, kmax), dtype=torch.float32, device=dev)
    else:
        q = _filtered_probs(draft_logits, temperature, top_k, top_p)
        q_at_d = torch.gather(q, 2, drafts[..., None])[..., 0]

    u = torch.rand((s, kmax), generator=generator, device=dev)
    accept = torch.where(greedy_row[:, None], drafts == tgt_argmax[:, :kmax],
                         u < p_at_d / q_at_d.clamp(min=_EPS))
    idx = torch.arange(kmax, device=dev)[None, :]
    accept = accept & (idx < k_eff[:, None])
    # Accepted count = length of the all-accepted prefix.
    n_acc = torch.cumprod(accept.long(), dim=1).sum(1)

    # The last token: the residual at the first rejected position, or the
    # bonus draw from p when every fielded draft survived.
    p_a = _take(p, n_acc)
    d_idx = n_acc.clamp(0, kmax - 1)
    d_a = _take(drafts, d_idx)
    q_a = (F.one_hot(d_a, v).to(p_a.dtype) if draft_logits is None else _take(q, d_idx))
    bonus = n_acc >= k_eff
    final = torch.where(bonus[:, None], p_a, (p_a - q_a).clamp(min=0.0))
    # An all-zero residual (p <= q everywhere, up to rounding) falls back to
    # p: the acceptance probability there was ~1, and a draw must not come
    # from a degenerate distribution.
    final = torch.where(final.sum(-1, keepdim=True) > _EPS, final, p_a)
    gumbel = -torch.log(-torch.log(
        torch.rand(final.shape, generator=generator, device=dev).clamp(min=1e-20)))
    sampled = (torch.log(final.clamp(min=_EPS)) + gumbel).argmax(-1)
    greedy_tok = _take(tgt_argmax, n_acc)
    final_tok = torch.where(greedy_row, greedy_tok, sampled)

    out_idx = torch.arange(t, device=dev)[None, :]
    padded = F.pad(drafts, (0, 1))
    out = torch.where(out_idx == n_acc[:, None], final_tok[:, None], padded)
    n_acc = torch.where(active.bool(), n_acc, torch.zeros_like(n_acc))
    return out.to(torch.int32), n_acc.to(torch.int32)
