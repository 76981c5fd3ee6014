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
- the collectives the port's own plan issues, each rank's bytes on the
  wire (a ring: 2 (n-1)/n of the payload for an all-reduce, (n-1)/n for
  an all-gather): the gradients' all-reduce over the data axes, the
  ZeRO-1 parameter gather, the expert-parallel sum (``--moe-impl ep``,
  forward and backward), and, as planned for tensor parallelism, one
  all-reduce of a (tokens, d_model) activation for each row-parallel
  weight a layer, forward (and backward for training);
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
from repro_torch.launch.mesh import (
    dp_axes_of,
    make_mesh,
    make_production_mesh,
    n_dp_of,
    tp_size_of,
)
from repro_torch.models import MeshCtx, build, decode_input_specs, train_input_specs
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


def meta_params(cfg) -> dict:
    """The parameter tree of ``cfg`` on ``meta`` at full depth, from one
    unit of its block pattern (and one encoder layer): layer i is the
    unit's layer i % len(pattern), the same shapes and formats that
    ``Transformer.init`` gives it (leaves shared between layers)."""
    p = len(cfg.block_pattern)
    unit = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, p),
                               n_encoder_layers=min(cfg.n_encoder_layers, 1))
    params = build(unit, device=META, backend="torch").init(0)
    params["layers"] = [params["layers"][i % p] for i in range(cfg.n_layers)]
    if cfg.n_encoder_layers:
        params["encoder"] = params["encoder"][:1] * cfg.n_encoder_layers
    return params


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


_ROW_PARALLEL = r".*((attn|cross)/o/w|ffn/down/w|cell/out/w|embed/table)$"


def _collectives(cfg, kind, params, pspecs, mesh, tp, n_dp, tokens, zero1, fsdp):
    """Each rank's wire bytes a step, by collective, under the port's plan."""
    act = get_policy(cfg.policy).compute.itemsize
    out = {}
    train = kind == "train"
    if train and n_dp > 1:
        # fp32 gradient sums over the data axes of every leaf the rank holds.
        grads = shd.bytes_per_rank(params, pspecs, mesh, itemsize=4)
        out["dp_grad_all_reduce"] = _ring(grads, n_dp, "all_reduce")
        if zero1 and not fsdp:
            held = shd.bytes_per_rank(params, pspecs, mesh)
            out["zero1_param_all_gather"] = _ring(held, n_dp, "all_gather")
    if fsdp:
        held = shd.bytes_per_rank(params, pspecs, mesh)
        out["fsdp_param_all_gather"] = _ring(held * mesh.size, mesh.size, "all_gather") * (
            2 if train else 1)
    if cfg.is_moe and cfg.moe_impl == "ep" and tp > 1 and not fsdp:
        n_moe = cfg.n_layers
        out["ep_sum"] = _ring(tokens * cfg.d_model * act, tp, "all_reduce") * n_moe * (
            2 if train else 1)
    if tp > 1 and not fsdp:
        rows = sum(1 for path, spec in zip([p for p, _ in shd.leaf_paths(params)],
                                           shd.spec_leaves(pspecs))
                   if re.match(_ROW_PARALLEL, path) and spec and spec[0] == "model")
        out["tp_row_all_reduce"] = _ring(tokens * cfg.d_model * act, tp, "all_reduce") * rows * (
            2 if train else 1)
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
    if fsdp:
        dp_axes, tp, n_dp = tuple(mesh.axis_names), 1, mesh.size
        mesh_ctx = MeshCtx(mesh=mesh, dp_axes=dp_axes, ep_axis=None)
    else:
        dp_axes, tp, n_dp = dp_axes_of(mesh), tp_size_of(mesh), n_dp_of(mesh)
        mesh_ctx = MeshCtx(mesh=mesh, dp_axes=dp_axes, ep_axis="model")
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
    coll = _collectives(cfg, kind, params, pspecs, mesh, tp, n_dp, tokens, plan["zero1"],
                        plan["fsdp"])
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
