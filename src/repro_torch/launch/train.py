"""Training launcher of the port: mesh, data, train step, checkpoint and
restart.

Runs on the card by default (every GEMM of the forward and both backward
GEMMs of every matmul on the hand-written GEMM-Op kernel); ``--device cpu``
runs the plain PyTorch path. ``--backend torch`` runs the plain path on
the card, for comparison.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --layers 4 --seq 1024 --batch 2 --steps 4 --policy redmule_hfp8 [--profile]
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
      --seq 1024 --batch 2 --steps 4 --policy redmule_hfp8
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 2 --seq 16 --batch 4 --log-every 1

Every registered arch trains: the dense and MoE decoders (the MoE
layers' aux loss in the loss) and the recurrent recurrentgemma-2b and
xlstm-125m.

Several processes (``torchrun``, which sets ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``) make a mesh: ``--mesh`` gives its shape over (data, model)
or (pod, data, model), by default (world, 1), as the reference's
``make_mesh_from_args``. The process group is NCCL on the card (one card a
process, ``cuda:LOCAL_RANK``) and gloo with ``--device cpu``. Each rank
takes its data shard of every global batch, runs tensor parallelism over
the 'model' axis on every layer (its pieces of ``param_specs``, the
experts among them; ``distrib/tensor_parallel.py``), and keeps the ZeRO-1
slices of the moments (``training/loop.py``); checkpoints are written
whole by rank 0 and read back at any mesh and world size. Each rank beats
its own ``Heartbeat`` under ``<ckpt-dir>/hb`` and a ``StragglerMonitor``
marks slow steps in the step line. As in the reference's launcher there
is no sharding flag: FSDP and ZeRO-3 are reached through
``make_train_step`` with their ``MeshCtx`` (``tp_axis=None``;
``zero3=True``), and sized by the dry run (``--sharding``).

  torchrun --nproc_per_node 2 -m repro_torch.launch.train --smoke \
      --device cpu --mesh 2,1 --steps 2 --seq 16 --batch 4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.precision import POLICIES
from repro_torch.data import for_model
from repro_torch.distrib import sharding as shd
from repro_torch.distrib.fault import Heartbeat, StragglerMonitor
from repro_torch.kernels import _build, flash_attention, redmule_gemm
from repro_torch.launch.mesh import dp_axes_of, make_mesh
from repro_torch.launch.serve import print_device_time
from repro_torch.models import MeshCtx, build
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training import init_train_state, make_train_step, state_specs


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced CPU-test config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--policy", choices=sorted(POLICIES), default=None,
                    help="precision policy (default: the config's)")
    ap.add_argument("--remat", choices=("none", "block"), default=None,
                    help="recompute each block in the backward (default: the config's)")
    ap.add_argument("--moe-impl", choices=("dense", "ep"), default="",
                    help="MoE implementation (default: the config's; 'ep' shards the "
                         "experts over the mesh's 'model' axis)")
    ap.add_argument("--mesh", default="",
                    help="mesh shape over (data, model) or (pod, data, model), e.g. 2,1 "
                         "(default: world,1)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's)")
    ap.add_argument("--backend", choices=("cuda", "torch"), default=None,
                    help="GEMM engine of the step (default: cuda on the card, torch on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the steps with torch.profiler and print device time by kernel")
    return ap.parse_args(argv)


def make_mesh_from_args(args, world: int, rank: int):
    """The mesh of ``--mesh`` (default (world, 1)), which must hold every
    process."""
    dims = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else (world, 1)
    axes = ("pod", "data", "model")[3 - len(dims):]
    mesh = make_mesh(dims, axes, rank=rank)
    if mesh.size != world:
        raise ValueError(f"--mesh {args.mesh} holds {mesh.size} ranks, the world has {world}")
    return mesh


def _init_world(args):
    """(world, rank, device) from torchrun's variables; the process group
    when the world has several processes."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None and world > 1:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if world > 1 and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                world_size=world, rank=rank)
    return world, rank, device


def train(args) -> dict:
    """Train ``args.steps`` steps (from the latest checkpoint with
    ``--resume``). Returns {"cfg", "state", "history", "tokens_per_step",
    "max_memory_bytes", "mesh"}; each history entry holds the step's loss,
    grad norm, wall ms (ending in a read of the loss, so the card has
    finished), whether the straggler monitor flagged it, and the launches
    of the GEMM-Op and dense flash-attention kernels."""
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(
        cfg, policy=args.policy or cfg.policy, remat=args.remat or cfg.remat,
        n_layers=args.layers or cfg.n_layers,
    )
    if args.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=args.moe_impl)
    world, rank, device = _init_world(args)
    mesh = make_mesh_from_args(args, world, rank)
    dp_axes = dp_axes_of(mesh)
    mesh_ctx = MeshCtx(mesh=mesh, dp_axes=dp_axes, ep_axis="model")
    model = build(cfg, mesh_ctx, device=device)
    backend = args.backend or model.engine.backend
    on_card = model.device.type == "cuda"
    if backend == "cuda":
        t0 = time.perf_counter()
        _build.library()  # build the kernels before the clocks start
        print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    if on_card:
        torch.cuda.reset_peak_memory_stats(model.device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    params = shd.local_params(model.init(args.seed), cfg, mesh_ctx)
    state = init_train_state(model, opt, params, mesh_ctx=mesh_ctx)
    shardings = shd.tree_shardings(state_specs(state, cfg, mesh_ctx), mesh)
    if args.resume and args.ckpt_dir:
        step, restored = ckpt.restore_latest(args.ckpt_dir, state, shardings=shardings)
        if restored is not None:
            state = restored
            print(f"resumed from step {step}")
    print(f"engine: policy={model.policy.name} backend={backend} device={model.device} "
          f"layers={cfg.n_layers} remat={cfg.remat} batch={args.batch} seq={args.seq} "
          f"mesh={mesh.shape} rank={rank} moe={cfg.moe_impl if cfg.is_moe else '-'}")

    n_dp, dp_idx = mesh.axis_size(dp_axes), mesh.axis_index(dp_axes)
    if args.batch % n_dp:
        raise ValueError(f"--batch {args.batch} does not split over {n_dp} data ranks")
    rows = slice(dp_idx * args.batch // n_dp, (dp_idx + 1) * args.batch // n_dp)
    data = for_model(cfg, args.seq, args.batch, seed=args.seed)
    step_fn = make_train_step(model, opt, backend=backend, mesh_ctx=mesh_ctx)
    saver = ckpt.AsyncSaver()
    hb = Heartbeat(os.path.join(args.ckpt_dir, "hb"), rank) if args.ckpt_dir else None
    straggler = StragglerMonitor()
    history = []
    it = data.iterate(start=state.step)
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        prof.start()
    # Launches per step: GEMM-Op calls, each GEMM schedule's kernel, the
    # GEMM's auxiliary launches (K-major copies, split-K combines), the
    # copies by route, and the dense flash attention (SIMT and tensor-core
    # kernels).
    counters = {
        "gemm_launches": redmule_gemm.launches,
        "gemm_tc_launches": redmule_gemm.tc_launches,
        "gemm_small_row_launches": redmule_gemm.small_row_launches,
        "gemm_simt_launches": redmule_gemm.simt_launches,
        "gemm_aux_launches": redmule_gemm.aux_launches,
        **{f"gemm_copy_{route}_launches": c for route, c in redmule_gemm.copy_launches.items()},
        "dense_attention_launches": flash_attention.dense_launches,
        "dense_attention_tc_launches": flash_attention.dense_tc_launches,
    }
    t_run = time.perf_counter()
    try:
        for i in range(state.step, args.steps):
            batch = {k: v[rows] for k, v in next(it).items()}
            before = {name: c.n for name, c in counters.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the card
            ms = (time.perf_counter() - t0) * 1e3
            slow = straggler.record(ms / 1e3)
            history.append({
                "step": i + 1, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                "skipped": state.skipped, "ms": ms, "straggler": slow,
                **{name: c.n - before[name] for name, c in counters.items()},
            })
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                h = history[-1]
                print(f"step {i + 1:6d} loss {loss:.4f} gnorm {h['grad_norm']:.3f} "
                      f"({ms:.0f} ms/step, skipped {state.skipped}"
                      f"{', STRAGGLER' if slow else ''})", flush=True)
            if hb is not None:
                hb.beat(i)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                saver.save(args.ckpt_dir, i + 1, state, shardings=shardings)
    finally:
        it.close()
        saver.wait()
        if prof is not None:
            prof.stop()
    if prof is not None:
        print_device_time(prof, time.perf_counter() - t_run)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state, shardings=shardings)
    print("done")
    return {
        "cfg": cfg, "state": state, "history": history, "mesh": mesh,
        "tokens_per_step": args.batch * args.seq,
        "max_memory_bytes": torch.cuda.max_memory_allocated(model.device) if on_card else None,
    }


def main(argv=None) -> dict:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
