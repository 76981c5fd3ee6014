"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``), with the
reference's two implementations. Training takes the load-balancing aux
loss (``aux=True``) and differentiates through the router; serving leaves
it out.

``dense``: every expert runs on every token, and the router's gates weight
the results. The arithmetic is the reference's ``apply_dense``: the router
in fp32 (softmax, top-k, the top-k probabilities renormalised), the gate
matrix with one term per expert, all experts' up and gate projections as
one wide GEMM each, ``silu`` in fp32 cast back to the compute format, the
gates cast to that format before they multiply, and the down projection
as one GEMM. Under tensor parallelism (``tp``, the experts over the
'model' axis) each rank runs its block of experts: up and gate are
column-parallel over their (d, E*f) columns, the gates' columns of its
experts are its slice of the (replicated) gate matrix, and down is
row-parallel, its partial y summed over the axis in fp32
(``distrib/tensor_parallel.py``). The reference's router is a plain ``jnp.matmul``; here it
runs through the engine under the fp32 policy on the model's backend (on
the card the GEMM-Op kernel's SIMT schedule, on the CPU its plain
version). The reference's dense path applies ``silu`` whatever the
config's ``act`` (``repro/models/moe.py:89``); the port raises for
another activation there (no config has one).

``ep``: expert parallelism over a mesh axis (``apply_ep``). Each rank
holds a contiguous block of whole experts and the tokens of its data
shard, replicated over the expert axis. It routes its tokens, sorts the
assignments by expert (a stable sort, as ``jnp.argsort``), takes a window
of ``cap`` assignments for each local expert, runs that expert's FFN on
the gathered rows through ``Engine.matmul`` (the GEMM-Op kernel on the
card), weights the rows by their probabilities in fp32 and adds them back
with ``index_add_``; assignments past an expert's capacity are dropped.
One sum over the axis in the input's format combines the ranks
(``distrib/collectives.py``; its backward is the identity, and the layer's
input takes the matching sum of gradients backward), and the aux loss is
the mean over the axis. Without a mesh, ``impl="ep"`` computes
``apply_dense``, as the reference's ``apply`` does.

Layout: the reference keeps ``up``/``gate`` as (E, d, f) and ``down`` as
(E, f, d), and reshapes them to (d, E*f) and (E*f, d) inside every call.
The port stores them in those GEMM shapes once (column e*f + j of ``up``
is expert e's column j, as the reference's transpose gives it), through
:func:`~repro_torch.models.common.kmajor_weight` like every other weight,
so no step copies an expert weight. An expert's block is a slice of
them: ``up``/``gate`` columns are contiguous K-major blocks; ``down``
rows e*f .. of a K-major (E*f, d) view are K-major with a row pitch of
E*f, which the GEMM's tensor-core and small-row schedules read in place
(16-byte aligned at every config's f), so no call copies them for their
layout.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.precision import cast
from repro_torch.distrib import collectives, compat
from repro_torch.distrib import tensor_parallel as tpl
from repro_torch.engine import Engine
from repro_torch.models import common
from repro_torch.obs import span


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


def _global_mean(m: torch.Tensor, dp) -> torch.Tensor:
    """The mean of ``m`` over the data ranks (equal token counts a rank),
    with the identity backward: each rank's gradient is then the global
    loss's over its own tokens times the ranks' count, which the train
    step's division of the aux loss by that count takes back out."""
    mesh, axes = dp
    whole = collectives.all_reduce(m.detach(), mesh, axes, op="mean", tag="scalars")
    return m + (whole - m.detach())


def _router(params, x2: torch.Tensor, cfg: MoEConfig, engine: Engine, aux: bool = True,
            dp=None):
    """x2: (T, d) -> (top-k probs (T, k), top-k ids (T, k), aux loss or
    None). ``dp`` = (mesh, data axes): the aux loss's expert shares are the
    global batch's, as the reference's over its whole batch."""
    logits = engine.with_policy("fp32").matmul(x2.float(), params["router"]["w"])
    probs = common.xla_softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    if not aux:
        return top_p, top_i, None
    # Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e.
    me = common.xla_mean(probs, 0)
    fe = common.xla_mean(F.one_hot(top_i, cfg.n_experts).float().sum(1), 0)
    if dp is not None:
        me, fe = _global_mean(me, dp), _global_mean(fe, dp)
    return top_p, top_i, cfg.n_experts * common.xla_sum(me * fe, -1)[0]


def apply_dense(params, x: torch.Tensor, cfg: MoEConfig, engine: Engine, *, aux: bool = True,
                tp=None, dp=None):
    """x: (B, S, d). Returns (y (B, S, d) in the policy's output format,
    aux loss). ``aux=False`` leaves the aux loss out (None), as XLA drops it
    from the reference's jitted serving steps, which do not use it. With
    ``tp`` the expert weights may be this rank's block of experts; with
    ``dp`` (mesh, data axes) x is this rank's rows of the global batch."""
    if cfg.act != "swiglu":
        raise NotImplementedError(
            f"dense MoE with act {cfg.act!r}: the reference's dense path applies silu "
            "whatever the act, and its EP path honours it; no config has another act")
    b, s, d = x.shape
    e, f = cfg.n_experts, cfg.d_ff
    x2 = x.reshape(b * s, d)
    with span("moe.router"):
        top_p, top_i, aux = _router(params, x2, cfg, engine, aux, dp)
        # Gate matrix (T, E): each chosen expert's probability, zeros
        # elsewhere (one term per expert, so it is the reference's one-hot
        # sum exactly). Out of place, so the gradient reaches the router in
        # training.
        gates = torch.zeros((b * s, e), dtype=torch.float32,
                            device=x.device).scatter(1, top_i, top_p)
    with span("moe.experts"):
        # (T, E*f), all experts at once (under TP this rank's block of them).
        up_all = tpl.linear(x2, {"w": params["up"]}, engine, tp, e * f)
        gate_all = tpl.linear(x2, {"w": params["gate"]}, engine, tp, e * f)
        e_l = up_all.shape[1] // f
        if e_l != e:
            gates = tpl.split_to(gates, tp, dim=1)
        h = common.silu(gate_all.float()).to(up_all.dtype) * up_all
        h = (h.reshape(-1, e_l, f) * gates[..., None].to(h.dtype)).reshape(-1, e_l * f)
        y = tpl.out_linear(h, {"w": params["down"]}, engine, tp, e * f)
    return y.reshape(b, s, d), aux


def _expert_ffn(up_w, gate_w, down_w, x: torch.Tensor, cfg: MoEConfig, engine: Engine):
    """One expert's FFN on its gathered rows: SwiGLU (``silu`` in fp32 cast
    back), or ``gelu(g) * h`` for another ``act``, as the reference's."""
    h = engine.matmul(x, up_w)
    g = engine.matmul(x, gate_w)
    if cfg.act == "swiglu":
        h = common.silu(g.float()).to(h.dtype) * h
    else:
        h = common.gelu(g) * h
    return engine.matmul(h, down_w)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Rows a local expert takes: the reference's
    ``_ceil_to(int(t * k / E * capacity_factor) or 1, 8)``."""
    return _ceil_to(int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor) or 1, 8)


def apply_ep(params, x: torch.Tensor, cfg: MoEConfig, engine: Engine, mesh, ep_axis, *,
             aux: bool = True):
    """Expert-parallel MoE over ``ep_axis`` of ``mesh``, one rank's body:
    ``params`` holds this rank's block of experts (``distrib.sharding``'s
    expert specs) and x (B_l, S, d) this rank's data shard (split over the
    data axes by the caller). Returns (y (B_l, S, d), aux loss or None)."""
    b, s, d = x.shape
    t = b * s
    f = cfg.d_ff
    e_local = params["up"].shape[1] // f
    n_shards = compat.axis_size(mesh, ep_axis)
    shard = compat.axis_index(mesh, ep_axis)
    e_total = e_local * n_shards
    if e_total != cfg.n_experts:
        raise ValueError(f"{e_local} local experts on {n_shards} ranks, the config has "
                         f"{cfg.n_experts}")
    x2 = collectives.copy_to(x.reshape(t, d), mesh, ep_axis)
    with span("moe.router"):
        top_p, top_i, aux_loss = _router(params, x2, cfg, engine, aux)
    # Flatten the assignments and sort them by expert, stably.
    flat_e = top_i.reshape(-1)
    flat_p = top_p.reshape(-1)
    flat_t = torch.arange(t, device=x.device).repeat_interleave(cfg.top_k)
    order = torch.argsort(flat_e, stable=True)
    sp, st = flat_p[order], flat_t[order]
    # Assignments an expert (``bincount``, with a static shape).
    counts = torch.zeros(e_total, dtype=flat_e.dtype, device=x.device).index_add(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    cap = capacity(t, cfg)
    # Padded so that every window of cap assignments lies inside.
    sp = torch.cat([sp, sp.new_zeros(cap)])
    st = torch.cat([st, st.new_zeros(cap)])
    window = torch.arange(cap, device=x.device)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    with span("moe.experts"):
        for j in range(e_local):
            eg = shard * e_local + j  # the global expert id
            idx = starts[eg] + window
            valid = window < counts[eg]
            tok = torch.where(valid, st[idx], 0)
            cols = slice(j * f, (j + 1) * f)
            yj = _expert_ffn(params["up"][:, cols], params["gate"][:, cols],
                             params["down"][cols], x2.index_select(0, tok), cfg,
                             engine).float()
            yj = yj * (sp[idx] * valid)[:, None]
            out = out.index_add(0, tok, torch.where(valid[:, None], yj, 0.0))
    # The sum over the expert ranks in the input's format (the reference
    # sums in bf16 to halve the wire bytes; each token's partial sums
    # were taken in fp32 locally).
    y = collectives.sum_over(out.to(x.dtype), mesh, ep_axis)
    if aux_loss is not None:
        aux_loss = collectives.mean_over(aux_loss, mesh, ep_axis)
    return y.reshape(b, s, d), aux_loss


def check_impl(cfg: MoEConfig) -> None:
    """Raise unless ``cfg.impl`` is ``"dense"`` or ``"ep"``."""
    if cfg.impl not in ("dense", "ep"):
        raise ValueError(f"unknown MoE impl {cfg.impl!r}")


def apply(params, x: torch.Tensor, cfg: MoEConfig, engine: Engine, *, aux: bool = True,
          mesh=None, ep_axis=None, tp=None, dp_axes=None):
    """``apply_ep`` for ``impl="ep"`` on a mesh with an expert axis, else
    ``apply_dense`` (the reference's rule; ``tp`` its tensor parallelism,
    ``dp_axes`` the data axes its batch is split over)."""
    check_impl(cfg)
    if cfg.impl == "ep" and mesh is not None and ep_axis is not None:
        return apply_ep(params, x, cfg, engine, mesh, ep_axis, aux=aux)
    dp = ((mesh, dp_axes) if aux and mesh is not None and dp_axes
          and mesh.axis_size(dp_axes) > 1 else None)
    return apply_dense(params, x, cfg, engine, aux=aux, tp=tp, dp=dp)
