"""Dry run of every (arch x shape x mesh) cell on the production meshes
(counterpart of ``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out build/dryrun]

The reference lowers and compiles each cell with XLA against 512
placeholder devices. The port has no compiler to lower to, so its dry run
is a check of shapes and bytes, on the abstract mesh
(``launch/mesh.py``: 16 x 16, or 2 x 16 x 16 multi-pod), with nothing
allocated:

- the model is built on the ``meta`` device (shapes, no storage):
  ``n_params``;
- each rank's bytes of parameters, optimizer moments, batch and cache
  under the specs of ``distrib/sharding.py`` (``--sharding tp``: tensor
  and expert parallelism over 'model' with ZeRO-1 moments unless
  ``--no-zero1``; ``fsdp``: every leaf over the whole mesh; ``zero3``: TP
  with the parameters also over the data axes), against the H100's 80 GB;
- operations and bytes of one step of one data-parallel replica (the
  rank's batch, the whole model, as the port runs it today): the step runs
  on ``meta`` tensors under ``roofline/cost.py``'s recorder, which counts
  every kernel call from its shapes;
- the collectives the port issues, each rank's bytes on the wire (a
  ring: 2 (n-1)/n of the payload for an all-reduce, (n-1)/n for an
  all-gather), under the tags of ``distrib/collectives.py``'s
  ``traffic`` counter. A train cell's are counted from the executed
  specs and the activations' shapes: its layers' (tensor-parallel sums
  and gathers, FSDP's per-use gathers and gradient sums, the
  expert-parallel sums; ``layer_traffic``), the step's gradient sums
  over the data axes, ZeRO-1 gather and scalars (``step_traffic``), and
  the GEMM weights' and embedding table's sums inside their uses (one a
  GEMM use, the embedding's rows gathered; ``use_sum_traffic``). The
  tests hold the executed step's counter against them. A prefill or
  decode cell (serving runs on one rank) keeps the plan: one fp32
  all-reduce of a (tokens, d_model) activation a row-parallel weight,
  the sum in the format the train step's row-parallel GEMMs sum in;
- the roofline on one H100 (``roofline/analysis.py``'s peaks): the
  replica's counts over the TP size (the planned split), the collectives
  at NVLink's one-way rate; and its bottleneck.

What cannot run on ``meta`` is counted from shapes instead:

- ``torch.Generator`` has no ``meta`` device: the meta model draws no
  numbers (``Transformer.init``);
- the train step's anomaly guard reads its norm with ``bool()``, which a
  meta tensor refuses: the dry run runs the loss and its gradients
  (``make_loss_fn``, ``torch.autograd.grad``) and not the guard or the
  AdamW update (elementwise passes, no kernel call);
- depth, batch and length: layers of one kind issue the same calls, and
  every call's operations and bytes are affine in the batch, so the step
  runs at zero and one unit of the block pattern (and encoder layer), at
  batch 1 and 2, and the counts are extrapolated to the cell
  (``step_counts``: expert parallelism at the cell's batch; a prefill,
  quadratic in its length, at 2048, 4096 and 6144 tokens; xlstm's sLSTM
  layers, a Python loop over positions, at 1 and 2 positions).

``long_500k`` is skipped exactly where ``configs.cell_is_runnable`` says.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from repro_torch.core.precision import get_policy
from repro_torch.core.tree import leaves
from repro_torch.distrib import sharding as shd
from repro_torch.distrib import tensor_parallel as tpl
from repro_torch.launch.mesh import (
    dp_axes_of,
    make_mesh,
    make_production_mesh,
    n_dp_of,
    tp_size_of,
)
from repro_torch.models import (
    MeshCtx,
    build,
    decode_input_specs,
    meta_params,
    train_input_specs,
)
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import cost
from repro_torch.training import make_loss_fn

HBM_BYTES = 80e9  # one H100's device memory
META = torch.device("meta")


def _apply_overrides(cfg, args):
    over = {}
    if getattr(args, "moe_impl", None):
        over["moe_impl"] = args.moe_impl
    if getattr(args, "remat", None):
        over["remat"] = args.remat
    if getattr(args, "policy", None):
        over["policy"] = args.policy
    if getattr(args, "kv_dtype", None):
        over["kv_cache_dtype"] = args.kv_dtype
    return dataclasses.replace(cfg, **over) if over else cfg


def _meta_batch(cfg, batch: int, seq: int) -> dict:
    out = {k: torch.empty(s, dtype=d, device=META) for k, (s, d) in
           train_input_specs(cfg, batch, seq).items()}
    out["tokens"] = out["tokens"].long()
    return out


def _run_step(cfg, kind: str, batch: int, seq: int, mesh_ctx) -> cost.Counts:
    """One step of one replica on ``meta`` tensors, counted."""
    model = build(cfg, mesh_ctx, device=META, backend="torch")
    params = model.init(0)
    with cost.recording() as counts, torch.inference_mode(kind != "train"):
        if kind == "train":
            live = [p.requires_grad_() for p in leaves(params) if p.is_floating_point()]
            loss, _ = make_loss_fn(model)(params, _meta_batch(cfg, batch, seq))
            torch.autograd.grad(loss, live, allow_unused=True)
        elif kind == "prefill":
            dec = max(seq // cfg.enc_dec_ratio, 1) if cfg.is_encoder_decoder else seq
            cache = model.init_cache(batch, dec + cfg.n_frontend_tokens,
                                     cross_len=seq if cfg.is_encoder_decoder else 0)
            model.prefill(params, _meta_batch(cfg, batch, seq), cache)
        else:
            cache = model.init_cache(batch, seq, cross_len=seq if cfg.is_encoder_decoder else 0)
            cache["pos"] = seq - 1
            model.decode_step(params, torch.empty((batch, 1), dtype=torch.long, device=META),
                              cache)
    return counts


def _combo(terms) -> cost.Counts:
    """sum of coef * counts over ``terms``, kernel by kernel."""
    out = cost.Counts()
    for coef, c in terms:
        for name, kc in c.kernels.items():
            o = out.kernels.setdefault(name, cost.KernelCounts())
            o.calls += coef * kc.calls
            o.flops += coef * kc.flops
            o.bytes += coef * kc.bytes
            o.compute_s += coef * kc.compute_s
    return out


_CACHE: dict = {}
# Prefill lengths counted directly: multiples of the attention's 512-key
# chunk, and of the encoder-decoder's 4 frames a token.
_PREFILL_UNIT = 2048


def _depth_counts(cfg, kind: str, batch: int, seq: int, mesh_ctx) -> cost.Counts:
    """Counts at the config's depth: c(u, e), at u units of the block
    pattern (with its remainder layers) and e encoder layers, is affine in
    u and e, so c(N, E) = c(u0, e0) + (N - u0) (c(u0 + 1, e0) - c(u0, e0))
    + (E - e0) (c(u0, e0 + 1) - c(u0, e0)). The base is (0, 0) but for
    the frontend families, whose base keeps a decoder unit and an encoder
    layer (u0 = e0 = 1): without a decoder layer no gradient reaches the
    encoder or the image projection, and without an encoder layer an
    encoder-decoder has no encoder and no cross-attention."""
    key = (cfg, kind, batch, seq, mesh_ctx is not None)
    if key in _CACHE:
        return _CACHE[key]
    p = len(cfg.block_pattern)
    n_units, rem = divmod(cfg.n_layers, p)
    enc = cfg.n_encoder_layers
    u0 = min(n_units, 1) if cfg.family in ("vlm", "audio") else 0
    e0 = min(enc, 1)

    def at(units, enc_layers):
        c = dataclasses.replace(cfg, n_layers=units * p + rem, n_encoder_layers=enc_layers)
        return _run_step(c, kind, batch, seq, mesh_ctx)

    base = at(u0, e0)
    terms = [(1, base), (n_units - u0, at(u0 + 1, e0)), (-(n_units - u0), base)]
    if enc > e0:
        terms += [(enc - e0, at(u0, e0 + 1)), (-(enc - e0), base)]
    _CACHE[key] = out = _combo(terms)
    return out


def _bilinear(f, batch: int, seq: int) -> cost.Counts:
    """f(B, S) at the cell from f at B, S in {1, 2}, for counts affine in
    each."""
    f11, f21, f12, f22 = f(1, 1), f(2, 1), f(1, 2), f(2, 2)
    b, s = batch - 1, seq - 1
    return _combo([(1, f11), (b, f21), (-b, f11), (s, f12), (-s, f11),
                   (b * s, f22), (-b * s, f21), (-b * s, f12), (b * s, f11)])


def step_counts(cfg, kind: str, batch: int, seq: int, mesh_ctx=None) -> cost.Counts:
    """The counts of one replica's step. Every count is affine in the
    batch (B): counted at B = 1 and 2 and extrapolated, so both meshes
    share the runs. Expert parallelism (``mesh_ctx``: a mesh of one) is
    counted at the cell's batch (its capacity rounds to 8 rows). xlstm's sLSTM layers run a step a position
    in a Python loop, too slow on ``meta`` at 4096 to 32768 positions: one
    sLSTM layer's counts (a model of that layer alone, less the model of
    none) are affine in B and in the sequence S and in their product, so
    they are counted at B, S in {1, 2} and extrapolated, and the rest of
    the model is counted without them."""
    if mesh_ctx is not None:
        return _depth_counts(cfg, kind, batch, seq, mesh_ctx)

    def at_batch(c, s):
        one = _depth_counts(c, kind, 1, s, None)
        return _combo([(1, one), (batch - 1, _depth_counts(c, kind, 2, s, None)),
                       (-(batch - 1), one)])

    def in_batch(c, s):
        if kind != "prefill" or s % _PREFILL_UNIT or s <= 3 * _PREFILL_UNIT:
            return at_batch(c, s)
        # A prefill attends every query to every key chunk: its counts are
        # quadratic in the length, counted at 1, 2 and 3 units and
        # interpolated (Lagrange) at the cell's.
        t = s // _PREFILL_UNIT
        weights = ((t - 2) * (t - 3) // 2, -(t - 1) * (t - 3), (t - 1) * (t - 2) // 2)
        return _combo([(w, at_batch(c, i * _PREFILL_UNIT)) for i, w in enumerate(weights, 1)])

    p = len(cfg.block_pattern)
    kinds = [cfg.block_pattern[i % p] for i in range(cfg.n_layers)]
    n_s = kinds.count("slstm")
    if not n_s or kind == "decode":
        return in_batch(cfg, seq)
    rest = dataclasses.replace(cfg, n_layers=cfg.n_layers - n_s,
                               block_pattern=tuple(k for k in cfg.block_pattern if k != "slstm"))
    alone = dataclasses.replace(cfg, block_pattern=("slstm",))

    def layer(b, s):
        return _combo([(1, _run_step(dataclasses.replace(alone, n_layers=1), kind, b, s, None)),
                       (-1, _run_step(dataclasses.replace(alone, n_layers=0), kind, b, s, None))])

    return _combo([(1, in_batch(rest, seq)), (n_s, _bilinear(layer, batch, seq))])


def _ring(payload: float, n: int, kind: str) -> float:
    """Bytes a rank puts on the wire for a ring collective of ``payload``
    bytes over ``n`` ranks."""
    if n <= 1:
        return 0.0
    return (2.0 if kind == "all_reduce" else 1.0) * (n - 1) / n * payload


def mesh_context(mesh, mode: str) -> MeshCtx:
    """The executed context of a sharding mode: ``tp`` (TP and EP over
    'model', ZeRO-1 moments), ``zero3`` (the TP pieces over the data axes
    too) or ``fsdp`` (every axis data-parallel, ``tp_axis=None``)."""
    if mode == "fsdp":
        return MeshCtx(mesh=mesh, dp_axes=tuple(mesh.axis_names), ep_axis=None, tp_axis=None)
    return MeshCtx(mesh=mesh, dp_axes=dp_axes_of(mesh), ep_axis="model", zero3=mode == "zero3")


def layer_traffic(cfg, params, mesh_ctx, batch: int, seq: int) -> dict:
    """One rank's wire bytes by tag of the collectives the layers issue in
    the loss and its gradients, on ``batch`` rows of ``seq`` positions,
    counted from the executed specs of ``params`` (the whole shapes) and
    the activations' shapes, as ``distrib/tensor_parallel.py`` places them:

    - a column-parallel weight (its columns over the TP axis) sums its
      input's gradient in fp32 in the backward (none for the frontends'
      inputs, which take no gradient); where its output is needed whole
      (xLSTM's qkv and wx, the frontends' projections) it is gathered;
    - a row-parallel weight (its rows over the axis) sums its fp32
      partial outputs in the forward;
    - attention with its query heads split and K/V whole takes its
      groups' KV heads (their gradients summed in fp32), or, where the
      split ends inside a head, gathers q and slices the output (whose
      gradient is gathered); the RG-LRU gathers its conv output for its
      gates; xLSTM's gated output is sliced for a split ogate or out; the
      dense MoE slices its gate matrix to its experts (its gradient
      gathered) and takes the router's expert shares over the data ranks;
    - vocab parallelism: one fp32 sum of the embedded rows, and three
      fp32 sums of (rows, positions) values a cross-entropy chunk;
    - expert parallelism: the input's gradient summed, the output summed
      (the compute format), the aux loss averaged;
    - FSDP and ZeRO-3: every leaf split over the data axes gathered per
      use and its gradient summed in fp32 over them.

    A layer's forward collectives run twice under ``remat="block"`` (the
    backward runs the block again), a cross-entropy chunk's always (each
    chunk is checkpointed). The expert-parallel output sum and aux mean
    end their block and save nothing for the backward, and torch's
    checkpoint stops its rerun at the last saved tensor: they run once."""
    mesh, tp_axis = mesh_ctx.mesh, mesh_ctx.tp_axis
    tp = mesh.axis_size(tp_axis) if tp_axis is not None else 1
    pol = get_policy(cfg.policy)
    o, c = pol.out.itemsize, pol.compute.itemsize
    again = 2 if cfg.remat == "block" else 1
    d, hd = cfg.d_model, cfg.head_dim
    inputs = train_input_specs(cfg, batch, seq)
    n_tok = batch * inputs["tokens"][0][1]
    n_vis = batch * cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    n_dec, n_enc = n_tok + n_vis, batch * seq if cfg.is_encoder_decoder else 0
    paths = [p for p, _ in shd.leaf_paths(params)]
    specs = dict(zip(paths, shd.spec_leaves(shd.executed_param_specs(params, cfg, mesh_ctx))))
    out: dict = {}

    def reduce(tag, nbytes, n, times=1):
        out[tag] = out.get(tag, 0.0) + times * _ring(nbytes, n, "all_reduce")

    def gather(tag, whole, n, times=1):
        out[tag] = out.get(tag, 0.0) + times * _ring(whole, n, "all_gather")

    def split(path, dim):
        sp = specs.get(path)
        return tp > 1 and sp is not None and tp_axis in shd._names(sp[dim])

    def linear(path, rows, k, n, grad_in=True, whole=False, times=again):
        if split(path, 1):
            if grad_in:
                reduce("tp_grad_all_reduce", rows * k * 4, tp)
            if whole:
                gather("tp_all_gather", rows * n * o, tp, times)
        elif split(path, 0):
            reduce("tp_row_all_reduce", rows * n * 4, tp, times)

    def attention(pre, rows, kv_rows):
        dq, dkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
        linear(f"{pre}/q/w", rows, d, dq)
        linear(f"{pre}/k/w", kv_rows, d, dkv)
        linear(f"{pre}/v/w", kv_rows, d, dkv)
        if split(f"{pre}/q/w", 1) and not split(f"{pre}/k/w", 1):
            hq, g = dq // tp // hd, cfg.n_heads // cfg.n_kv_heads
            if (dq // tp) % hd == 0 and (hq % g == 0 or g % hq == 0):
                reduce("tp_grad_all_reduce", kv_rows * dkv * 4, tp, 2)
            else:
                gather("tp_all_gather", rows * dq * o, tp, again + 1)
        linear(f"{pre}/o/w", rows, dq, d)

    def ffn(pre, rows):
        linear(f"{pre}/up/w", rows, d, cfg.d_ff)
        if f"{pre}/gate/w" in specs:
            linear(f"{pre}/gate/w", rows, d, cfg.d_ff)
        linear(f"{pre}/down/w", rows, cfg.d_ff, d)

    def moe(pre, rows):
        if cfg.moe_impl == "ep" and mesh_ctx.ep_axis is not None:
            n_ep = mesh.axis_size(mesh_ctx.ep_axis)
            reduce("ep_grad_all_reduce", rows * d * c, n_ep)
            reduce("ep_sum", rows * d * c, n_ep)  # once: see below
            reduce("scalars", 4, n_ep)
            return
        ef = cfg.n_experts * cfg.d_ff
        linear(f"{pre}/up", rows, d, ef)
        linear(f"{pre}/gate", rows, d, ef)
        if split(f"{pre}/up", 1):
            gather("tp_all_gather", rows * cfg.n_experts * 4, tp)
        linear(f"{pre}/down", rows, ef, d)
        reduce("scalars", cfg.n_experts * 4, mesh.axis_size(mesh_ctx.dp_axes or ()), 2 * again)

    def cell(pre, kind, rows):
        if kind == "rglru":
            if split(f"{pre}/lam", 0):
                r = cfg.d_rnn
                linear(f"{pre}/in_gate/w", rows, d, r)
                linear(f"{pre}/in_x/w", rows, d, r)
                gather("tp_all_gather", rows * r * o, tp, again)
                linear(f"{pre}/gate_a/w", rows, r, r)
                linear(f"{pre}/gate_x/w", rows, r, r)
                linear(f"{pre}/out/w", rows, r, d)
            return
        if kind == "mlstm":
            linear(f"{pre}/qkv/w", rows, d, 3 * d, whole=True)
        else:
            linear(f"{pre}/wx/w", rows, d, 4 * d, whole=True)
        og = f"{pre}/ogate/w" in specs and split(f"{pre}/ogate/w", 1)
        if og or split(f"{pre}/out/w", 0):  # the cells' output sliced
            gather("tp_all_gather", rows * d * c, tp)
        if f"{pre}/ogate/w" in specs:
            linear(f"{pre}/ogate/w", rows, d, d)
        if og and not split(f"{pre}/out/w", 0):
            gather("tp_all_gather", rows * d * c, tp, again)
        linear(f"{pre}/out/w", rows, d, d)

    # The embedding, the frontends and the logits (outside the blocks).
    if split("embed/table", 0):
        reduce("tp_embed_all_reduce", n_tok * d * 4, tp)
    if n_vis:
        linear("vis_proj/w", n_vis, d, d, grad_in=False, whole=True, times=1)
    if n_enc:
        linear("enc_proj/w", n_enc, d, d, grad_in=False, whole=True, times=1)
    if split("embed/table" if cfg.tie_embeddings else "head/w", 0 if cfg.tie_embeddings else 1):
        reduce("tp_grad_all_reduce", n_tok * d * 4, tp)
        reduce("tp_xent_all_reduce", n_tok * 4, tp, 2 * 2)
        windows = -(-cfg.vocab_size // tp // tpl.XENT_WINDOW) * tp
        gather("tp_all_gather", n_tok * windows * 4, tp, 2)
    # The blocks.
    for j in range(cfg.n_encoder_layers):
        attention(f"encoder/{j}/attn", n_enc, n_enc)
        if cfg.d_ff > 0:
            ffn(f"encoder/{j}/ffn", n_enc)
    p = len(cfg.block_pattern)
    for i in range(cfg.n_layers):
        kind, pre = cfg.block_pattern[i % p], f"layers/{i}"
        if kind in ("attn", "attn_local"):
            attention(f"{pre}/attn", n_dec, n_dec)
        else:
            cell(f"{pre}/cell", kind, n_dec)
        if cfg.is_encoder_decoder:
            attention(f"{pre}/cross", n_dec, n_enc)
        if cfg.d_ff > 0:
            (moe if cfg.is_moe else ffn)(f"{pre}/{'moe' if cfg.is_moe else 'ffn'}", n_dec)
    # FSDP's and ZeRO-3's per-use gathers (a block's leaves gathered again
    # in its backward under remat).
    dp = tuple(mesh_ctx.dp_axes or ())
    if tp_axis is None or mesh_ctx.zero3:
        for (path, leaf), spec in zip(shd.leaf_paths(params), specs.values()):
            axes = {a for q in shd.over_axes(spec, dp) for a in shd._names(q)}
            if not axes:
                continue
            n = mesh.axis_size(tuple(a for a in mesh.axis_names if a in axes))
            piece = shd.bytes_per_rank(leaf, spec, mesh)
            times = again if path.startswith(("layers/", "encoder/")) else 1
            gather("fsdp_param_all_gather", piece * n, n, times)
            if tpl.summed_in_use(path):  # summed in its uses
                for tag, v in use_sum_traffic(cfg, path, leaf, piece // leaf.element_size() * n * 4,
                                              n, batch, seq, "fsdp_grad_all_reduce").items():
                    out[tag] = out.get(tag, 0.0) + v
            else:
                reduce("fsdp_grad_all_reduce", piece // leaf.element_size() * n * 4, n)
    return {k: v for k, v in out.items() if v}


def step_traffic(cfg, params, mesh_ctx, zero1: bool = True) -> dict:
    """The train step's own collectives from the specs (``training/
    loop.py``): each leaf's fp32 gradient summed over the data axes (the
    router's also over the expert axis; none for a leaf split over them,
    whose per-use gather summed it, nor for one summed in its uses,
    :func:`use_sum_traffic`), the ZeRO-1 gather of each sliced leaf, and
    the scalars (the supervised count, loss and aux sums; one squared-norm
    sum for each set of axes a leaf is split over)."""
    from repro_torch.training import loop

    mesh, dp = mesh_ctx.mesh, tuple(mesh_ctx.dp_axes or ())
    n_dp = mesh.axis_size(dp)
    specs = shd.spec_leaves(shd.executed_param_specs(params, cfg, mesh_ctx))
    dims = loop.zero1_dims(params, cfg, mesh_ctx)
    ep = cfg.is_moe and cfg.moe_impl == "ep" and mesh_ctx.ep_axis is not None
    out = {"dp_grad_all_reduce": 0.0, "zero1_param_all_gather": 0.0,
           "scalars": 3 * _ring(4, n_dp, "all_reduce")}
    groups = set()
    for (path, leaf), spec, dim in zip(shd.leaf_paths(params), specs, dims):
        axes = loop._axes_of(spec, mesh)
        groups.add(axes)
        piece = shd.bytes_per_rank(leaf, spec, mesh)
        if not set(axes) & set(dp) and not (n_dp > 1 and tpl.summed_in_use(path)):
            n = n_dp * (mesh.axis_size(mesh_ctx.ep_axis) if ep and loop._is_router(path) else 1)
            out["dp_grad_all_reduce"] += _ring(piece // leaf.element_size() * 4, n, "all_reduce")
        if dim is not None and zero1:
            out["zero1_param_all_gather"] += _ring(piece, n_dp, "all_gather")
    out["scalars"] += sum(_ring(4, mesh.axis_size(a), "all_reduce") for a in groups if a)
    return {k: v for k, v in out.items() if v}


_ROW_PARALLEL = r".*((attn|cross)/o/w|ffn/down/w|cell/out/w)$"


def use_sum_traffic(cfg, path: str, leaf, fp32_bytes: int, n: int, batch: int, seq: int,
                    tag: str) -> dict:
    """The wire bytes of summing one leaf's gradient over ``n`` data ranks
    inside its uses (``tensor_parallel.summed_in_use``), its gradient
    ``fp32_bytes`` in fp32: each GEMM use's fp32 sum (the head, and the
    tied table, are used once a cross-entropy chunk; sLSTM's recurrence
    weight once a position), and the embedding gather's all-gather of the
    cotangent rows and their int64 token ids."""
    from repro_torch.training import loop

    s = train_input_specs(cfg, batch, seq)["tokens"][0][1]
    chunks = -(-s // min(loop.XENT_CHUNK, s))
    out = {}
    if path == "embed/table":
        row = cfg.d_model * leaf.element_size()
        out["dp_embed_all_gather"] = _ring(n * batch * s * (row + 8), n, "all_gather")
        uses = chunks if cfg.tie_embeddings else 0
    elif path == "head/w":
        uses = chunks
    elif path.endswith("/r"):
        uses = s
    else:
        uses = 1
    if uses:
        out[tag] = uses * _ring(fp32_bytes, n, "all_reduce")
    return out


def train_collectives(cfg, params, mesh_ctx, batch: int, seq: int, zero1: bool = True) -> dict:
    """Each rank's wire bytes by tag of a train step at ``mesh_ctx`` on
    ``batch`` rows of ``seq`` positions: the step's own
    (``step_traffic``), its layers' (``layer_traffic``), and the sums
    over the data axes inside the uses of the leaves the step leaves to
    them (``use_sum_traffic``)."""
    from repro_torch.training import loop

    out = step_traffic(cfg, params, mesh_ctx, zero1)
    parts = [layer_traffic(cfg, params, mesh_ctx, batch, seq)]
    mesh, dp = mesh_ctx.mesh, tuple(mesh_ctx.dp_axes or ())
    n_dp = mesh.axis_size(dp)
    if n_dp > 1:
        specs = shd.spec_leaves(shd.executed_param_specs(params, cfg, mesh_ctx))
        for (path, leaf), spec in zip(shd.leaf_paths(params), specs):
            if tpl.summed_in_use(path) and not set(loop._axes_of(spec, mesh)) & set(dp):
                piece = shd.bytes_per_rank(leaf, spec, mesh)
                parts.append(use_sum_traffic(cfg, path, leaf, piece // leaf.element_size() * 4,
                                             n_dp, batch, seq, "dp_grad_all_reduce"))
    for part in parts:
        for tag, v in part.items():
            out[tag] = out.get(tag, 0.0) + v
    return {k: v for k, v in out.items() if v}


def _serving_collectives(cfg, params, pspecs, mesh, tp, tokens, fsdp) -> dict:
    """Each rank's planned wire bytes of a prefill or decode step (the
    module docstring)."""
    out = {}
    if fsdp:
        held = shd.bytes_per_rank(params, pspecs, mesh)
        out["fsdp_param_all_gather"] = _ring(held * mesh.size, mesh.size, "all_gather")
    if cfg.is_moe and cfg.moe_impl == "ep" and tp > 1 and not fsdp:
        act = get_policy(cfg.policy).compute.itemsize
        out["ep_sum"] = _ring(tokens * cfg.d_model * act, tp, "all_reduce") * cfg.n_layers
    if tp > 1 and not fsdp:
        rows = sum(1 for path, spec in zip([p for p, _ in shd.leaf_paths(params)],
                                           shd.spec_leaves(pspecs))
                   if re.match(_ROW_PARALLEL, path) and spec and spec[0] == "model")
        out["tp_row_all_reduce"] = _ring(tokens * cfg.d_model * 4, tp, "all_reduce") * rows
    return out


def lower_cell(arch: str, shape: str, mesh, *, args=None):
    """(plan, meta) of one cell on ``mesh``; plan None when the cell is
    skipped (meta then says why)."""
    cfg = get_config(arch)
    if args is not None:
        cfg = _apply_overrides(cfg, args)
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    seq, batch, kind = SHAPES[shape]
    mode = getattr(args, "sharding", "tp") if args is not None else "tp"
    no_zero1 = bool(getattr(args, "no_zero1", False)) if args is not None else False
    fsdp = mode == "fsdp"
    mesh_ctx = mesh_context(mesh, mode)
    if fsdp:
        dp_axes, tp, n_dp = tuple(mesh.axis_names), 1, mesh.size
    else:
        dp_axes, tp, n_dp = dp_axes_of(mesh), tp_size_of(mesh), n_dp_of(mesh)
    model = build(cfg, device=META, backend="torch")
    params = meta_params(cfg)
    if fsdp:
        pspecs = shd.fsdp_param_specs(params, dp_axes, mesh.size)
    else:
        pspecs = shd.param_specs(params, cfg, tp)
        if mode == "zero3":
            pspecs = shd.zero1_specs(pspecs, params, dp_axes, n_dp)
    local_batch = batch // n_dp if batch % n_dp == 0 and batch >= n_dp else batch
    meta = {
        "arch": arch, "shape": shape, "kind": kind, "seq": seq, "batch": batch,
        "local_batch": local_batch, "sharding": mode,
        "engine": {"policy": model.engine.policy.name, "backend": "cuda"},
        "mesh": dict(mesh.shape),
        "n_params": int(sum(p.numel() for p in leaves(params))),
    }
    return {"cfg": cfg, "kind": kind, "seq": seq, "batch": batch, "local_batch": local_batch,
            "params": params, "pspecs": pspecs, "dp_axes": dp_axes, "tp": tp, "n_dp": n_dp,
            "fsdp": fsdp, "zero1": not no_zero1, "mesh_ctx": mesh_ctx, "mode": mode}, meta


def run_cell(arch: str, shape: str, *, multi_pod: bool, args=None) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_kind = "multi_pod" if multi_pod else "single_pod"
    t0 = time.perf_counter()
    plan, meta = lower_cell(arch, shape, mesh, args=args)
    if plan is None:
        return dict(meta, status="skipped", mesh_kind=mesh_kind)
    cfg, kind, params, pspecs = plan["cfg"], plan["kind"], plan["params"], plan["pspecs"]
    dp_axes, tp, n_dp = plan["dp_axes"], plan["tp"], plan["n_dp"]
    seq, b = plan["seq"], plan["local_batch"]
    mem = {"param_bytes": shd.bytes_per_rank(params, pspecs, mesh)}
    if kind == "train":
        mom = (pspecs if plan["fsdp"] or not plan["zero1"]
               else shd.zero1_specs(pspecs, params, dp_axes, n_dp))
        mem["moment_bytes"] = 2 * shd.bytes_per_rank(params, mom, mesh, itemsize=4)
    specs = train_input_specs(cfg, plan["batch"], seq)
    batch_ok = plan["batch"] % n_dp == 0 and plan["batch"] >= n_dp
    mem["batch_bytes"] = shd.bytes_per_rank(
        specs, shd.batch_specs(specs, dp_axes if batch_ok else None), mesh)
    if kind == "decode":
        cache = decode_input_specs(cfg, plan["batch"], seq)["cache"]
        mem["cache_bytes"] = shd.bytes_per_rank(
            cache, shd.cache_specs(cache, cfg, dp_axes, tp, plan["batch"], n_dp), mesh)
    mem["total_bytes"] = sum(mem.values())
    mem["fits_80GB"] = mem["total_bytes"] <= HBM_BYTES
    # Expert parallelism counted on a mesh of one (every expert on the rank,
    # the capacity of the whole expert set), then split over the TP size as
    # the rest: each rank runs E / tp of the experts.
    ep_ctx = (MeshCtx(mesh=make_mesh((1, 1), ("data", "model")), dp_axes=("data",),
                      ep_axis="model")
              if cfg.is_moe and cfg.moe_impl == "ep" and not plan["fsdp"] else None)
    counts = step_counts(cfg, kind, b, seq, ep_ctx)
    dec = max(seq // cfg.enc_dec_ratio, 1) if cfg.is_encoder_decoder else seq
    tokens = b * (1 if kind == "decode" else dec + cfg.n_frontend_tokens)
    if kind == "train":
        coll = train_collectives(cfg, params, plan["mesh_ctx"], b, seq, plan["zero1"])
    else:
        coll = _serving_collectives(cfg, params, pspecs, mesh, tp, tokens, plan["fsdp"])
    coll_bytes = float(sum(coll.values()))
    split = tp
    roof = ra.Roofline(compute_s=counts.compute_s / split,
                       memory_s=counts.bytes / split / ra.HBM_BYTES_S,
                       collective_s=coll_bytes / ra.NVLINK_BYTES_S,
                       hlo_flops=counts.flops / split, hlo_bytes=counts.bytes / split,
                       coll_bytes=coll_bytes, n_chips=mesh.size)
    return dict(
        meta, status="ok", mesh_kind=mesh_kind, n_chips=mesh.size,
        count_s=round(time.perf_counter() - t0, 3),
        memory=mem,
        replica_counts={"calls": counts.calls, "flops": counts.flops, "bytes": counts.bytes,
                        "by_kernel": counts.to_dict()},
        collectives=coll,
        roofline=roof.to_dict(),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--moe-impl", choices=("dense", "ep"))
    ap.add_argument("--sharding", choices=("tp", "fsdp", "zero3"), default="tp")
    ap.add_argument("--remat", choices=("none", "block"))
    ap.add_argument("--policy")
    ap.add_argument("--kv-dtype")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
            if args.tag:
                tag += f"__{args.tag}"
            try:
                res = run_cell(arch, shape, multi_pod=mp, args=args)
            except Exception as e:  # a failure here is a bug in the port
                failures += 1
                res = dict(arch=arch, shape=shape, status="FAILED",
                           mesh_kind="multi_pod" if mp else "single_pod",
                           error=f"{type(e).__name__}: {e}", traceback=traceback.format_exc())
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(res, f, indent=2)
            status = res["status"]
            if status == "ok":
                r = res["roofline"]
                extra = (f" flops={r['hlo_flops']:.3g} coll={r['coll_bytes']:.3g}B"
                         f" mem={res['memory']['total_bytes'] / 1e9:.1f}GB"
                         f" bottleneck={r['bottleneck']} counted={res['count_s']}s")
            elif status == "skipped":
                extra = f" ({res.get('skipped', '')})"
            else:
                extra = f" {res.get('error', '')}"
            print(f"[{status:7s}] {tag}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} dry-run cells FAILED")
    return 0


if __name__ == "__main__":
    main()
