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

On a mesh (``mesh_ctx``) every rank runs the step on its data shard and
its pieces of the parameters (``distrib.sharding.executed_param_specs``:
tensor parallelism over 'model' with the experts over it, FSDP, ZeRO-3;
the layers in ``distrib/tensor_parallel.py``); with no mesh, or on a
mesh of one, each reduction below is the identity:

- the loss is the reference's mean over the *global* batch: each rank
  divides its cross-entropy sum by the count of supervised positions
  summed over the data axes, so ranks with different counts weigh right;
  a mean of per-rank means would not. The aux loss is the mean of the
  ranks' aux losses: under expert parallelism each over its own tokens,
  as the reference's EP body computes it; the dense MoE's over the global
  batch on every rank (``models/moe.py``), as the reference's is;
- the gradients are summed over the data axes in fp32 (the gradient of
  the global loss; ``dist.all_reduce``, as GSPMD's reduction), and the
  router's also over the expert axis under expert parallelism, where each
  rank holds the share of its own experts' gates. A leaf split over
  'model' needs no sum over it, and a replicated leaf's gradient is the
  same on every TP rank (the column-parallel backward sums dX), so
  neither is summed over 'model'. A leaf split over the data axes (FSDP,
  ZeRO-3) was gathered per use, and its gradient summed over them there.
  The GEMM-Op weights and the embedding table
  (``tensor_parallel.summed_in_use``) are summed inside their uses: the
  step marks them (``engine.autodiff.mark_summed``), each GEMM's dW is
  summed in fp32 before its one cast to the 16-bit gradient format, where
  GSPMD puts the reference's all-reduce, and the embedding gather
  scatters every rank's cotangent rows as one process would; the step
  sums the other leaves (norms, biases, convolutions, RG-LRU's lambda,
  the routers) as before;
- the global norm counts every piece of a split leaf once (the squares
  summed over the leaf's axes) and every replicated leaf once;
- ZeRO-1: each rank keeps the moments of its slice of each leaf (the
  first dimension the data ranks divide, ``distrib.sharding.zero1_specs``),
  updates that slice of the parameters and all-gathers the slices. AdamW
  is elementwise, so the parameters are the unsharded update's bit for
  bit.

For ``torch.profiler`` a step is three spans (:func:`repro_torch.obs.span`):
``train.forward`` (the loss), ``train.backward`` (the gradients) and
``train.optimizer`` (the global norm and the update).
"""
from __future__ import annotations

import re
from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.distrib import collectives, sharding, tensor_parallel
from repro_torch.engine import Engine, autodiff
from repro_torch.models import common
from repro_torch.obs import span
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
        if logits.shape[-1] != model.cfg.vocab_size:  # this rank's block of the vocab
            return tensor_parallel.vocab_xent(logits, y_c, m_c, model.tp, c)
        logz = common.xla_logsumexp(logits, dim=-1)
        ll = logits.gather(-1, y_c[..., None])[..., 0]
        return common.xla_sum((logz - ll) * m_c, None, c)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, s, c):
        sl = slice(s0, s0 + c)
        total = total + checkpoint(chunk_loss, h[:, sl], labels[:, sl], mask[:, sl],
                                   use_reentrant=False)
    return total, mask.sum()


def _loss_terms(model, params, batch, eng):
    """(cross-entropy sum, supervised positions, aux loss) of ``batch``."""
    params = model.use_top(params)
    h, aux = model.forward(params, batch, engine=eng)
    labels, mask = _shift_labels(batch["tokens"])
    total, denom = chunked_xent(model, params, h, labels, mask, engine=eng)
    return total, denom, aux


def make_loss_fn(model, *, backend: str | None = None) -> Callable:
    """loss_fn(params, batch) -> (loss, {"xent", "aux"}) on the model's
    engine, with ``backend`` swapping its execution backend alone."""
    eng = model.engine.with_backend(backend) if backend else model.engine

    def loss_fn(params, batch):
        total, denom, aux = _loss_terms(model, params, batch, eng)
        loss = total / denom.clamp(min=1.0)
        return loss + AUX_LOSS_WEIGHT * aux, {"xent": loss, "aux": aux}

    return loss_fn


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any
    # Fault tolerance: the number of steps the anomaly guard skipped.
    skipped: int


def _mesh_of(model, mesh_ctx):
    """(mesh context, mesh or None, data axes, data ranks) of a step."""
    mc = mesh_ctx if mesh_ctx is not None else getattr(model, "mesh_ctx", None)
    mesh = mc.mesh if mc is not None else None
    dp = tuple(mc.dp_axes or ()) if mesh is not None else ()
    return mc, mesh, dp, mesh.axis_size(dp) if mesh is not None else 1


def make_train_step(model, optimizer, *, grad_accum: int = 1,
                    backend: str | None = None, mesh_ctx=None) -> Callable:
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

    ``mesh_ctx`` (default the model's): on a mesh, ``batch`` is this rank's
    data shard, ``state`` this rank's (:func:`init_train_state`), and the
    step runs the reductions of the module docstring. With no mesh, or on a
    mesh of one, every reduction is the identity and the step is the
    single-process one.
    """
    mc, mesh, dp, n_dp = _mesh_of(model, mesh_ctx)
    moe_cfg = getattr(model, "moe_cfg", None)
    ep = mc.ep_axis if mesh is not None and moe_cfg is not None and moe_cfg.impl == "ep" else None
    eng = model.engine.with_backend(backend) if backend else model.engine
    router_axes = dp + ((ep,) if ep is not None else ())
    cache: dict = {}

    def reduce(g: torch.Tensor, axes) -> torch.Tensor:
        if mesh is None or not axes or mesh.axis_size(axes) == 1:
            return g
        return collectives.all_reduce(g.float(), mesh, axes, tag="dp_grad_all_reduce").to(g.dtype)

    def plan(params) -> None:
        """Each leaf's sum over the data axes: the step's own (``axes``),
        or inside its uses (``summed``), or none."""
        paths = [p for p, _ in sharding.leaf_paths(params)]
        specs = sharding.spec_leaves(leaf_specs(params, model.cfg, mc))
        split = [_axes_of(sp, mesh) for sp in specs]
        # Sum over the data axes unless the per-use gather did (FSDP, ZeRO-3).
        axes = [() if set(dp) & set(ax) else router_axes if _is_router(p) else dp
                for p, ax in zip(paths, split)]
        cache["summed"] = [n_dp > 1 and a == dp and tensor_parallel.summed_in_use(p)
                           for p, a in zip(paths, axes)]
        cache["axes"] = [() if sm else a for a, sm in zip(axes, cache["summed"])]
        cache["split"] = split
        cache["dims"] = zero1_dims(params, model.cfg, mc)

    def grad_fn(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        how = tensor_parallel.DataSum(mesh, dp)
        for t, sm in zip(leaves(live), cache["summed"]):
            if sm:
                autodiff.mark_summed(t, how)
        with span("train.forward"):
            total, denom, aux = _loss_terms(model, live, batch, eng)
            count = collectives.all_reduce(denom, mesh, dp, tag="scalars").clamp(min=1.0)
            loss = total / count + AUX_LOSS_WEIGHT * aux / n_dp
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves(live))
        xent = collectives.all_reduce(total.detach(), mesh, dp, tag="scalars") / count
        aux = collectives.all_reduce(aux.detach(), mesh, dp, tag="scalars") / n_dp
        return xent + AUX_LOSS_WEIGHT * aux, {"xent": xent, "aux": aux}, list(grads)

    def train_step(state: TrainState, batch):
        batch = _on_device(batch, model.device)
        if not cache:
            plan(state.params)
        if grad_accum > 1:
            loss, grads = 0.0, [torch.zeros_like(p) for p in leaves(state.params)]
            for mb in _micro(batch, grad_accum):
                lv, metrics, g = grad_fn(state.params, mb)
                loss = loss + lv
                grads = [a + b for a, b in zip(grads, g)]
            loss = loss / grad_accum
            grads = [g / grad_accum for g in grads]
        else:
            loss, metrics, grads = grad_fn(state.params, batch)
        grads = [reduce(g, axes) for g, axes in zip(grads, cache["axes"])]
        with span("train.optimizer"):
            gnorm = _split_norm(grads, cache["split"], mesh)
            if not bool(torch.isfinite(gnorm) & torch.isfinite(loss)):
                new_params, new_opt, skipped = state.params, state.opt_state, state.skipped + 1
            else:
                new_params, new_opt = zero1_update(optimizer, state.params,
                                                   unflatten(state.params, grads),
                                                   state.opt_state, state.step, gnorm,
                                                   cache["dims"], mesh, dp)
                skipped = state.skipped
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, skipped=skipped)
        return TrainState(state.step + 1, new_params, new_opt, skipped), metrics

    return train_step


def leaf_specs(params, cfg, mesh_ctx, moments: bool = False) -> Any:
    """The executed specs of a rank's ``params`` (its moments' ZeRO-1 specs
    with ``moments``), in ``params``' structure, from the config's whole
    shapes: the pieces' own shapes do not say how they were cut."""
    from repro_torch.models import meta_params

    full = meta_params(cfg)
    specs = sharding.executed_param_specs(full, cfg, mesh_ctx)
    _, _, dp, n_dp = _mesh_of(None, mesh_ctx)
    if moments and n_dp > 1:
        specs = sharding.zero1_specs(specs, full, dp, n_dp)
    by_path = dict(zip((p for p, _ in sharding.leaf_paths(full)), sharding.spec_leaves(specs)))
    return sharding.map_with_path(lambda path, _: by_path[path], params)


def _on_dp(spec, dp) -> bool:
    return any(set(sharding._names(p)) & set(dp) for p in spec)


def _axes_of(spec, mesh) -> tuple:
    """The mesh axes a spec splits its leaf over, in the mesh's order."""
    if mesh is None:
        return ()
    named = {a for p in spec for a in sharding._names(p)}
    return tuple(a for a in mesh.axis_names if a in named)


def _split_norm(grads, split, mesh) -> torch.Tensor:
    """The global norm of gradients held as pieces: each group of leaves
    split over the same axes has its squares summed over those axes, so
    every piece counts once and every replicated leaf once."""
    if not any(split):
        return global_norm(grads)
    groups: dict = {}
    for g, axes in zip(grads, split):
        groups.setdefault(axes, []).append(g.float().square().sum())
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for axes, sq in groups.items():
        part = torch.stack(sq).sum()
        total = total + (collectives.all_reduce(part, mesh, axes, tag="scalars") if axes else part)
    return total.sqrt()


def _on_device(batch, device) -> dict:
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    batch["tokens"] = batch["tokens"].long()
    return batch


def _micro(batch: dict, n: int):
    micro = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[i] for k, v in micro.items()} for i in range(n)]


def _is_router(path: str) -> bool:
    return bool(re.match(r".*moe/router/w$", path))


def zero1_dims(params, cfg, mesh_ctx) -> list:
    """For each leaf of this rank's ``params``, the dimension whose slices
    the data ranks hold under ZeRO-1, or None (a leaf too small to split,
    a single data rank, or a leaf already split over the data axes: FSDP
    and ZeRO-3 keep their moments on the pieces)."""
    mc, _, dp, n_dp = _mesh_of(None, mesh_ctx)
    if n_dp == 1:
        return [None] * len(leaves(params))
    executed = sharding.spec_leaves(leaf_specs(params, cfg, mc))
    specs = sharding.spec_leaves(leaf_specs(params, cfg, mc, moments=True))
    return [None if _on_dp(e, dp) else sharding.split_dim(s, dp)
            for e, s in zip(executed, specs)]


def _slice(t: torch.Tensor, dim, mesh, dp) -> torch.Tensor:
    if dim is None:
        return t
    c = t.shape[dim] // mesh.axis_size(dp)
    return t.narrow(dim, mesh.axis_index(dp) * c, c)


def zero1_update(optimizer, params, grads, opt_state, step: int, gnorm: torch.Tensor, dims: list,
                 mesh, dp_axes):
    """The ZeRO-1 update: each leaf's slice along its dimension in ``dims``
    (None: the whole leaf) updated with this rank's moments of it, then the
    slices gathered over ``dp_axes`` into the leaf's own layout. Returns
    (new params, new moments of the slices)."""
    flat = leaves(params)
    p_sl = unflatten(params, [_slice(p, d, mesh, dp_axes) for p, d in zip(flat, dims)])
    g_sl = unflatten(params, [_slice(g, d, mesh, dp_axes) for g, d in zip(leaves(grads), dims)])
    new_sl, new_opt = optimizer.update(p_sl, g_sl, opt_state, step, gnorm)
    new = [q if d is None else collectives.gather_into(torch.empty_like(p), q, mesh, dp_axes, d)
           for p, q, d in zip(flat, leaves(new_sl), dims)]
    return unflatten(params, new), new_opt


def init_train_state(model, optimizer, params, *, mesh_ctx=None) -> TrainState:
    """This rank's initial state: ``params`` as it holds them (its block of
    experts on a mesh: ``distrib.sharding.local_params``) and fresh moments
    of its ZeRO-1 slices (the whole leaves with one data rank)."""
    mc, mesh, dp, _ = _mesh_of(model, mesh_ctx)
    dims = zero1_dims(params, model.cfg, mc)
    sliced = unflatten(params, [_slice(p, d, mesh, dp) for p, d in zip(leaves(params), dims)])
    return TrainState(0, params, optimizer.init(sliced), 0)


def state_specs(state: TrainState, cfg, mesh_ctx) -> TrainState:
    """The spec of every leaf of a rank's state on the full (single-process)
    shapes: the parameters' executed specs, the moments' ZeRO-1 specs, the
    counters none (``checkpoint.manager``'s ``shardings=``)."""
    pspecs = leaf_specs(state.params, cfg, mesh_ctx)
    mspecs = leaf_specs(state.params, cfg, mesh_ctx, moments=True)
    return TrainState(None, pspecs, {"mu": mspecs, "nu": mspecs}, None)
