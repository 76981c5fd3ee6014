"""Training launcher of the port, on one card: data, train step, checkpoint
and restart.

Runs on the card by default (every GEMM of the forward and both backward
GEMMs of every matmul on the hand-written GEMM-Op kernel); ``--device cpu``
runs the plain PyTorch path. ``--backend torch`` runs the plain path on
the card, for comparison.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --layers 4 --seq 1024 --batch 2 --steps 4 --policy redmule_hfp8 [--profile]
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 2 --seq 16 --batch 4 --log-every 1

The reference's mesh, ZeRO sharding and heartbeat are not ported (one
card; ROADMAP queue 7).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.precision import POLICIES
from repro_torch.data import for_model
from repro_torch.kernels import _build, flash_attention, redmule_gemm
from repro_torch.launch.serve import print_device_time
from repro_torch.models import build
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training import TrainState, make_train_step


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


def train(args) -> dict:
    """Train ``args.steps`` steps (from the latest checkpoint with
    ``--resume``). Returns {"cfg", "state", "history", "tokens_per_step",
    "max_memory_bytes"}; each history entry holds the step's loss, grad
    norm, wall ms (ending in a read of the loss, so the card has finished)
    and the launches of the GEMM-Op and dense flash-attention kernels."""
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(
        cfg, policy=args.policy or cfg.policy, remat=args.remat or cfg.remat,
        n_layers=args.layers or cfg.n_layers,
    )
    model = build(cfg, device=args.device)
    backend = args.backend or model.engine.backend
    on_card = model.device.type == "cuda"
    if backend == "cuda":
        t0 = time.perf_counter()
        _build.library()  # build the kernels before the clocks start
        print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    if on_card:
        torch.cuda.reset_peak_memory_stats(model.device)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    params = model.init(args.seed)
    state = TrainState(0, params, opt.init(params), 0)
    if args.resume and args.ckpt_dir:
        step, restored = ckpt.restore_latest(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            print(f"resumed from step {step}")
    print(f"engine: policy={model.policy.name} backend={backend} device={model.device} "
          f"layers={cfg.n_layers} remat={cfg.remat} batch={args.batch} seq={args.seq}")

    data = for_model(cfg, args.seq, args.batch, seed=args.seed)
    step_fn = make_train_step(model, opt, backend=backend)
    saver = ckpt.AsyncSaver()
    history = []
    it = data.iterate(start=state.step)
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=activities)
        prof.start()
    # Launches per step: GEMM-Op calls, each GEMM schedule's kernel, the
    # GEMM's auxiliary launches (K-major copies, split-K combines) and the
    # dense flash attention (SIMT and tensor-core kernels).
    counters = {
        "gemm_launches": redmule_gemm.launches,
        "gemm_tc_launches": redmule_gemm.tc_launches,
        "gemm_small_row_launches": redmule_gemm.small_row_launches,
        "gemm_simt_launches": redmule_gemm.simt_launches,
        "gemm_aux_launches": redmule_gemm.aux_launches,
        "dense_attention_launches": flash_attention.dense_launches,
        "dense_attention_tc_launches": flash_attention.dense_tc_launches,
    }
    t_run = time.perf_counter()
    try:
        for i in range(state.step, args.steps):
            batch = next(it)
            before = {name: c.n for name, c in counters.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the card
            ms = (time.perf_counter() - t0) * 1e3
            history.append({
                "step": i + 1, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                "skipped": state.skipped, "ms": ms,
                **{name: c.n - before[name] for name, c in counters.items()},
            })
            if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
                h = history[-1]
                print(f"step {i + 1:6d} loss {loss:.4f} gnorm {h['grad_norm']:.3f} "
                      f"({ms:.0f} ms/step, skipped {state.skipped})", flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                saver.save(args.ckpt_dir, i + 1, state)
    finally:
        it.close()
        saver.wait()
        if prof is not None:
            prof.stop()
    if prof is not None:
        print_device_time(prof, time.perf_counter() - t_run)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, state)
    print("done")
    return {
        "cfg": cfg, "state": state, "history": history,
        "tokens_per_step": args.batch * args.seq,
        "max_memory_bytes": torch.cuda.max_memory_allocated(model.device) if on_card else None,
    }


def main(argv=None) -> dict:
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
