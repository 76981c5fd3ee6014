"""Speculative decoding on the paged continuous-batching server
(counterpart of ``repro.serving.spec``).

A drafter (a second, smaller model with its own StateStore, or n-gram
prompt lookup) proposes k tokens per request per round; the target
verifies all k + 1 positions in one fixed-shape step (the chunked prefill
lifted to every slot); exact rejection sampling keeps the target's
distribution, and greedy speculative decoding emits the plain greedy
chain.
"""
from repro_torch.serving.spec.drafter import DraftProposal, ModelDrafter, NgramDrafter
from repro_torch.serving.spec.policy import SpecConfig, effective_k
from repro_torch.serving.spec.rejection import speculative_sample
from repro_torch.serving.spec.verify import Verifier

__all__ = [
    "DraftProposal",
    "ModelDrafter",
    "NgramDrafter",
    "SpecConfig",
    "Verifier",
    "effective_k",
    "speculative_sample",
]
