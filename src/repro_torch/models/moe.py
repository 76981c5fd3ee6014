"""Mixture-of-Experts FFN, the ``dense`` implementation (counterpart of
``repro.models.moe``): every expert runs on every token, and the router's
gates weight the results. ``impl="ep"`` (expert parallelism over a mesh)
is not ported. Training takes the load-balancing aux loss (``aux=True``)
and differentiates through the router; serving leaves it out.

The arithmetic is the reference's ``apply_dense``: the router in fp32
(softmax, top-k, the top-k probabilities renormalised), the gate matrix
with one term per expert, all experts' up and gate projections as one wide
GEMM each, ``silu`` in fp32 cast back to the compute format, the gates cast
to that format before they multiply, and the down projection as one GEMM.
The reference's router is a plain ``jnp.matmul``; here it runs through the
engine under the fp32 policy on the model's backend (on the card the
GEMM-Op kernel's SIMT schedule, on the CPU its plain version).

Layout: the reference keeps ``up``/``gate`` as (E, d, f) and ``down`` as
(E, f, d), and reshapes them to (d, E*f) and (E*f, d) inside every call.
The port stores them in those GEMM shapes once (column e*f + j of ``up``
is expert e's column j, as the reference's transpose gives it), through
:func:`~repro_torch.models.common.kmajor_weight` like every other weight,
so no step copies an expert weight.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision import cast
from repro_torch.engine import Engine
from repro_torch.models import common


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    impl: str = "dense"  # dense | ep
    act: str = "swiglu"


def init(gen: torch.Generator, cfg: MoEConfig, dtype: torch.dtype, device) -> dict:
    """Router (d, E) in fp32; ``up``/``gate`` (d, E*f) and ``down`` (E*f, d)
    in ``dtype``, with the reference's scales (1/sqrt(d) in, 1/sqrt(f) out)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def weight(rows, cols, scale):
        w = torch.randn((rows, cols), generator=gen, device=device) * scale
        return common.kmajor_weight(cast(w, dtype))

    return {
        "router": {"w": torch.randn((d, e), generator=gen, device=device) * 0.02},
        "up": weight(d, e * f, 1.0 / math.sqrt(d)),
        "gate": weight(d, e * f, 1.0 / math.sqrt(d)),
        "down": weight(e * f, d, 1.0 / math.sqrt(f)),
    }


def _router(params, x2: torch.Tensor, cfg: MoEConfig, engine: Engine, aux: bool = True):
    """x2: (T, d) -> (top-k probs (T, k), top-k ids (T, k), aux loss or
    None)."""
    logits = engine.with_policy("fp32").matmul(x2.float(), params["router"]["w"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    if not aux:
        return top_p, top_i, None
    # Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e.
    me = probs.mean(0)
    fe = F.one_hot(top_i, cfg.n_experts).float().sum(1).mean(0)
    return top_p, top_i, cfg.n_experts * (me * fe).sum()


def apply_dense(params, x: torch.Tensor, cfg: MoEConfig, engine: Engine, *, aux: bool = True):
    """x: (B, S, d). Returns (y (B, S, d) in the policy's output format,
    aux loss). ``aux=False`` leaves the aux loss out (None), as XLA drops it
    from the reference's jitted serving steps, which do not use it."""
    if cfg.act != "swiglu":
        raise NotImplementedError(f"MoE activation {cfg.act!r} is not ported yet")
    b, s, d = x.shape
    e, f = cfg.n_experts, cfg.d_ff
    x2 = x.reshape(b * s, d)
    top_p, top_i, aux = _router(params, x2, cfg, engine, aux)
    # Gate matrix (T, E): each chosen expert's probability, zeros elsewhere
    # (one term per expert, so it is the reference's one-hot sum exactly).
    # Out of place, so the gradient reaches the router in training.
    gates = torch.zeros((b * s, e), dtype=torch.float32, device=x.device).scatter(1, top_i, top_p)
    up_all = engine.matmul(x2, params["up"])  # (T, E*f), all experts at once
    gate_all = engine.matmul(x2, params["gate"])
    h = common.silu(gate_all.float()).to(up_all.dtype) * up_all
    h = h.reshape(-1, e, f) * gates[..., None].to(h.dtype)
    y = engine.matmul(h.reshape(-1, e * f), params["down"])
    return y.reshape(b, s, d), aux


def check_impl(cfg: MoEConfig) -> None:
    """Raise unless the port has ``cfg.impl`` (only ``"dense"``)."""
    if cfg.impl == "ep":
        raise NotImplementedError(
            "MoE impl 'ep' (expert parallelism) needs a device mesh; it comes with the "
            "distrib queue of ROADMAP.md (queue 1, item 6)")
    if cfg.impl != "dense":
        raise ValueError(f"unknown MoE impl {cfg.impl!r}")


def apply(params, x: torch.Tensor, cfg: MoEConfig, engine: Engine, *, aux: bool = True):
    check_impl(cfg)
    return apply_dense(params, x, cfg, engine, aux=aux)
