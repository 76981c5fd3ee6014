"""Sharding rules of the port: a spec for every leaf of a parameter, batch
or cache tree, from its path (counterpart of ``repro.distrib.sharding``).

A spec is a tuple with one entry per dimension of the leaf's logical
shape: None (replicated), an axis name, or a tuple of axis names (split
over their product, major to minor), the entries of a ``PartitionSpec``.
A dimension split over n ranks is cut into n contiguous, equal pieces;
:func:`shard_of` cuts a rank's piece.

The rules are the reference's regex table (first match wins), stated on
the port's parameter paths (``layers/3/attn/q/w``, ``embed/table``;
the port keeps no stacked layer axis) and layouts:

  - QKV / FFN up and gate column-parallel (d, F) -> (None, 'model'); O /
    FFN down row-parallel (F, d) -> ('model', None);
  - embeddings vocab-sharded; GQA K/V projections replicated where the
    KV heads do not divide over the TP size;
  - MoE experts over 'model' (EP): the port stores ``up``/``gate`` as
    (d, E*f) and ``down`` as (E*f, d), expert e in columns (rows)
    e*f .. e*f + f - 1 (``convert.moe_params_from_jax``), so the
    reference's ('model', None, None) on (E, d, f) is a split of the E*f
    axis into contiguous blocks of whole experts;
  - the RG-LRU channel dimension over 'model'.

A K-major fp8 weight is the (K, N) view of an (N, K) tensor: its spec is
on the logical (K, N) shape, as every other weight's.

The port executes every spec here (:func:`executed_param_specs`): data
parallelism with ZeRO-1 moments, tensor parallelism over the mesh's
'model' axis with the experts over it too (``param_specs``), FSDP (every
leaf over the whole mesh, ``fsdp_param_specs``) and ZeRO-3 (the TP specs
extended over the data axes, ``zero1_specs`` on the parameters). The
layers that run on the pieces are in ``distrib/tensor_parallel.py``.
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch

Spec = tuple


def leaf_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a nested dict/list tree, in leaf order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return [pl for i, v in enumerate(tree) for pl in leaf_paths(v, f"{prefix}{i}/")]
    return [] if tree is None else [(prefix[:-1], tree)]


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict/list tree, in its structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix[:-1], tree)


def _rules(cfg, tp: int) -> list[tuple[str, Spec]]:
    """(regex, spec) on the port's paths and layouts; first match wins."""
    def col(n):
        return (None, "model") if n % tp == 0 else (None, None)

    def row(n):
        return ("model", None) if n % tp == 0 else (None, None)

    q_dim = cfg.n_heads * cfg.head_dim
    ep_ok = cfg.is_moe and cfg.n_experts % tp == 0
    return [
        (r".*embed/table$", row(cfg.vocab_size)),
        (r".*head/w$", col(cfg.vocab_size)),
        (r".*(attn|cross)/q/w$", col(q_dim)),
        (r".*(attn|cross)/[kv]/w$", (None, "model") if cfg.n_kv_heads % tp == 0 else (None, None)),
        (r".*(attn|cross)/o/w$", row(q_dim)),
        # MoE experts: EP over 'model', whole experts a piece.
        (r".*moe/router/w$", (None, None)),
        (r".*moe/(up|gate)$", (None, "model") if ep_ok else (None, None)),
        (r".*moe/down$", ("model", None) if ep_ok else (None, None)),
        (r".*ffn/(up|gate)/w$", col(cfg.d_ff)),
        (r".*ffn/down/w$", row(cfg.d_ff)),
        # xLSTM
        (r".*cell/qkv/w$", col(cfg.d_model)),
        (r".*cell/ifg/w$", (None, None)),
        (r".*cell/ogate/w$", col(cfg.d_model)),
        (r".*cell/wx/w$", col(cfg.d_model)),
        (r".*cell/r$", (None, None, None, None)),
        # RG-LRU: channel-sharded recurrence
        (r".*cell/(in_x|in_gate)/w$", col(cfg.d_rnn)),
        (r".*cell/(gate_a|gate_x)/w$", col(cfg.d_rnn)),
        (r".*cell/conv_w$", col(cfg.d_rnn)),
        (r".*cell/lam$", ("model",) if cfg.d_rnn % tp == 0 else (None,)),
        (r".*cell/out/w$", row(cfg.d_rnn)),
        (r".*(vis_proj|enc_proj)/w$", col(cfg.d_model)),
        (r".*norm.*", (None,)),  # any norm's scale and bias
        (r".*", (None,)),  # fallback: replicate
    ]


def _fit(parts: tuple, rank: int) -> Spec:
    """A spec cut or padded with None to ``rank`` entries."""
    return tuple(parts[:rank]) + (None,) * max(0, rank - len(parts))


def param_specs(params: Any, cfg, tp: int) -> Any:
    """The spec tree of ``params`` (tensors, or anything with ``.shape``)
    under tensor parallelism of size ``tp`` over 'model'."""
    rules = [(re.compile(rx), spec) for rx, spec in _rules(cfg, tp)]

    def leaf_spec(path, leaf):
        spec = next(s for rx, s in rules if rx.match(path))
        return _fit(spec, len(leaf.shape))

    return map_with_path(leaf_spec, params)


def executed_param_specs(params: Any, cfg, mesh_ctx) -> Any:
    """The specs the port executes on ``mesh_ctx`` (the reference's
    programs): with no mesh every leaf replicated; with ``tp_axis`` None
    (FSDP) :func:`fsdp_param_specs` over the data axes, the whole mesh;
    else :func:`param_specs` at the TP size with 'model' named
    ``tp_axis``, extended over the data axes for ZeRO-3
    (``mesh_ctx.zero3``)."""
    if mesh_ctx is None or mesh_ctx.mesh is None:
        return map_with_path(lambda _, leaf: (None,) * len(leaf.shape), params)
    mesh, dp = mesh_ctx.mesh, tuple(mesh_ctx.dp_axes or ())
    if mesh_ctx.tp_axis is None:
        specs = fsdp_param_specs(params, dp, mesh.axis_size(dp))
        return _map_specs(lambda spec, _: _drop_ones(spec, mesh), specs, specs)
    tp_axis = mesh_ctx.tp_axis
    specs = param_specs(params, cfg, mesh.axis_size(tp_axis))
    if tp_axis != "model":
        specs = _map_specs(lambda spec, _: tuple(tp_axis if s == "model" else s for s in spec),
                           specs, specs)
    if getattr(mesh_ctx, "zero3", False) and mesh.axis_size(dp) > 1:
        specs = zero1_specs(specs, params, dp, mesh.axis_size(dp))
    return _map_specs(lambda spec, _: _drop_ones(spec, mesh), specs, specs)


def _drop_ones(spec: Spec, mesh) -> Spec:
    """``spec`` without the axes of one rank (a split over them is none)."""
    def part(p):
        names = tuple(a for a in _names(p) if mesh.shape[a] > 1)
        return None if not names else names[0] if len(names) == 1 else names

    return tuple(part(p) for p in spec)


def over_axes(spec: Spec, axes) -> Spec:
    """``spec`` with every entry that is not over ``axes`` replaced by None
    (the data-axis part of an FSDP or ZeRO-3 spec, which a layer gathers
    per use)."""
    want = set(_names(axes))
    return tuple(p if p is not None and set(_names(p)) <= want else None for p in spec)


def batch_specs(batch_tree: Any, dp_axes) -> Any:
    """Every batch input split over the data axes on dim 0."""
    return map_with_path(lambda _, leaf: (dp_axes,) + (None,) * (len(leaf.shape) - 1),
                         batch_tree)


def cache_specs(cache_tree: Any, cfg, dp_axes, tp: int, batch_size: int, n_dp: int) -> Any:
    """Static-batch caches (``Transformer.init_cache``): batch over the data
    axes (where it divides), KV heads over 'model' where they divide, else
    the KV sequence (the flash-decoding layout) so the cache is never
    replicated across 'model'; state rows over the batch."""
    kv_shardable = cfg.n_kv_heads % tp == 0
    batch_ok = batch_size % max(n_dp, 1) == 0 and batch_size >= n_dp
    b_ax = dp_axes if batch_ok else None

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        rank = len(shape)
        if re.search(r"(^|/)(k|v|cross_k|cross_v)$", path):
            s_len = shape[-3]
            if kv_shardable:
                return (b_ax, None, "model", None)
            if s_len % tp == 0 and s_len >= tp:
                return (b_ax, "model", None, None)
            return (b_ax, None, None, None)
        if re.search(r"state/(C|n|m|h|c|conv)$", path) or (rank >= 1 and shape[0] == batch_size):
            return (b_ax,) + (None,) * (rank - 1)
        return (None,) * rank

    return map_with_path(leaf_spec, cache_tree)


def fsdp_param_specs(params: Any, axes, n_total: int) -> Any:
    """Fully sharded (ZeRO-3) specs: every leaf splits its largest dimension
    that ``n_total`` divides over ``axes``, the whole mesh."""
    def leaf_spec(path, leaf):
        parts = [None] * len(leaf.shape)
        for i, d in sorted(enumerate(leaf.shape), key=lambda t: -t[1]):
            if d % n_total == 0 and d >= n_total:
                parts[i] = axes
                break
        return tuple(parts)

    return map_with_path(leaf_spec, params)


def _names(part) -> tuple:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def zero1_specs(specs: Any, shapes: Any, dp_axes, n_dp: int) -> Any:
    """ZeRO-1: the optimizer moments split over the data axes too. Each
    leaf's first unsplit dimension that ``n_dp`` divides goes over
    ``dp_axes``; a spec already over a data axis is kept."""
    dp_set = set(_names(dp_axes))

    def extend(spec, leaf):
        shape = tuple(leaf.shape)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if any(dp_set & set(_names(p)) for p in parts):
            return tuple(parts)
        for i, (ax, dim) in enumerate(zip(parts, shape)):
            if ax is None and dim % n_dp == 0 and dim >= n_dp:
                parts[i] = dp_axes
                break
        return tuple(parts)

    return _map_specs(extend, specs, shapes)


def _is_spec(x) -> bool:
    """A spec (a plain tuple) or a :class:`NamedSharding`: a leaf of a spec
    tree."""
    return isinstance(x, NamedSharding) or (isinstance(x, tuple) and not hasattr(x, "_fields"))


def spec_leaves(specs) -> list:
    """The specs of a spec tree in leaf order (a spec is a plain tuple, not
    a container; None stands for a leaf without one)."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in spec_leaves(v)]
    if isinstance(specs, list) or (isinstance(specs, tuple) and not _is_spec(specs)):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def _map_specs(fn, specs, tree):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, specs[k], tree[k]) for k in specs}
    if isinstance(specs, list):
        return [_map_specs(fn, s, t) for s, t in zip(specs, tree)]
    if isinstance(specs, tuple) and not _is_spec(specs):
        return type(specs)(*(_map_specs(fn, s, t) for s, t in zip(specs, tree)))
    return None if specs is None else fn(specs, tree)


def piece_slices(shape, spec: Spec, mesh, coords: dict | None = None) -> tuple:
    """The (start, stop) of each dimension of the piece that ``spec`` gives
    the rank at ``coords`` (default this rank's)."""
    coords = mesh.coords if coords is None else coords
    out = []
    for dim, part in zip(shape, _fit(spec, len(shape))):
        names = _names(part)
        n, idx = 1, 0
        for a in names:
            n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"dimension {dim} does not split over {names} ({n} ranks)")
        c = dim // n
        out.append((idx * c, idx * c + c))
    return tuple(out)


def shard_of(tensor: torch.Tensor, spec: Spec, mesh, coords: dict | None = None) -> torch.Tensor:
    """The rank's piece of ``tensor`` under ``spec``: a view (narrowed on
    the logical shape, so a K-major weight's piece keeps its strides)."""
    for d, (a, b) in enumerate(piece_slices(tensor.shape, spec, mesh, coords)):
        if b - a != tensor.shape[d]:
            tensor = tensor.narrow(d, a, b - a)
    return tensor


def split_dim(spec: Spec, axes) -> int | None:
    """The dimension that ``spec`` splits over ``axes`` (or over a tuple
    holding them), else None."""
    want = set(_names(axes))
    for i, part in enumerate(spec):
        if part is not None and want and want <= set(_names(part)):
            return i
    return None


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``): cuts this
    rank's piece of a full tensor."""

    mesh: Any
    spec: Spec

    def shard(self, tensor: torch.Tensor) -> torch.Tensor:
        return shard_of(tensor, self.spec, self.mesh)


def tree_shardings(spec_tree: Any, mesh) -> Any:
    return _map_specs(lambda s, _: NamedSharding(mesh, s), spec_tree, spec_tree)


def bytes_per_rank(tree: Any, specs: Any, mesh, itemsize=None) -> int:
    """The largest piece of ``tree`` a rank holds under ``specs``, in bytes
    (the pieces are equal, so any rank's): each leaf's element count over
    its split, times its element size (or ``itemsize``)."""
    total = 0
    for (_, leaf), spec in zip(leaf_paths(tree), spec_leaves(specs)):
        n = 1
        for dim, part in zip(leaf.shape, _fit(spec, len(leaf.shape))):
            split = 1
            for a in _names(part):
                split *= mesh.shape[a]
            n *= dim // split
        size = itemsize if itemsize is not None else leaf.dtype.itemsize
        total += n * size
    return total


def _owned(piece: torch.Tensor) -> torch.Tensor:
    """A piece as a tensor of its own, in the layout of the tensor it was
    cut from (a K-major weight's piece stays K-major)."""
    out = torch.empty_strided(piece.shape, _dense_strides(piece), dtype=piece.dtype,
                              device=piece.device)
    return out.copy_(piece)


def _dense_strides(t: torch.Tensor, shape=None) -> tuple:
    """Contiguous strides of ``shape`` (default ``t``'s) in the order of
    ``t``'s own strides (largest first), so a (K, N) view of an (N, K)
    tensor stays K-major."""
    shape = tuple(t.shape) if shape is None else tuple(shape)
    order = sorted(range(t.dim()), key=lambda i: -t.stride(i))
    strides = [0] * t.dim()
    step = 1
    for i in reversed(order):
        strides[i] = step
        step *= shape[i]
    return tuple(strides)


def local_params(params: Any, cfg, mesh_ctx) -> Any:
    """This rank's parameters cut from the full ones under
    :func:`executed_param_specs`: each split leaf's piece as a tensor of
    its own (a K-major fp8 weight's piece K-major), every replicated leaf
    as it is."""
    specs = executed_param_specs(params, cfg, mesh_ctx)
    flat = [t if all(s is None for s in spec) else _owned(shard_of(t, spec, mesh_ctx.mesh))
            for (_, t), spec in zip(leaf_paths(params), spec_leaves(specs))]
    it = iter(flat)
    return map_with_path(lambda _p, _t: next(it), params)


def gather_full(piece: torch.Tensor, spec: Spec, mesh, *,
                tag: str = "gather_full") -> torch.Tensor:
    """The full tensor of which every rank holds the piece ``spec`` gives it
    (a collective over the spec's axes: every rank of them calls it)."""
    from repro_torch.distrib import collectives

    axes = tuple(a for part in spec for a in _names(part))
    if not axes:
        return piece
    axes = tuple(a for a in mesh.axis_names if a in axes)  # the mesh's order
    shape = list(piece.shape)
    for d, part in enumerate(_fit(spec, piece.dim())):
        for a in _names(part):
            shape[d] *= mesh.shape[a]
    out = torch.empty_strided(tuple(shape), _dense_strides(piece, shape), dtype=piece.dtype,
                              device=piece.device)
    for r, p in zip(mesh.group_ranks(axes), collectives.all_gather(piece, mesh, axes, tag=tag)):
        view = out
        for d, (a, b) in enumerate(piece_slices(shape, spec, mesh, mesh.coords_of(r))):
            view = view.narrow(d, a, b - a)
        view.copy_(p)
    return out
