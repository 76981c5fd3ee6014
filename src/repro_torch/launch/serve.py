"""Serving launcher of the port: continuous batching over the paged KV pools.

Runs on the card by default (the hand-written kernels on every GEMM and
the decode attention); ``--device cpu`` runs the plain PyTorch path.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --fp8-kv --fp8-params --policy redmule_hfp8 --prompt-len 64 [--profile]
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.precision import POLICIES
from repro_torch.kernels import _build
from repro_torch.models import build
from repro_torch.serving import SamplingParams, Server, ServerConfig


def mixed_prompt_lens(base: int, n: int) -> list[int]:
    """Deterministic mixed-length workload around ``base`` (>=2 tokens),
    the same as the reference launcher's."""
    cycle = [base, max(2, base // 2), base + base // 2, max(2, base - 2)]
    return [cycle[i % len(cycle)] for i in range(n)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced CPU-test config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--fp8-kv", action="store_true", help="store the KV pages in E4M3")
    ap.add_argument("--fp8-params", action="store_true", help="store the weights in E4M3")
    ap.add_argument("--policy", choices=sorted(POLICIES), default=None,
                    help="precision policy (default: the config's)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the run with torch.profiler and print device time by kernel")
    return ap.parse_args(argv)


# Name fragments of the port's own CUDA kernels (csrc/*.cu).
_PORT_KERNELS = ("redmule_gemm", "kmajor_", "splitk_combine", "paged_decode",
                 "flash_attention")


def print_device_time(prof, wall_s: float, top: int = 8) -> None:
    """Device time by kernel name from a torch.profiler trace, the card's
    busy share of the traced wall time, and host time by operator. Only
    the kernels' own rows count as device time: an operator that launches
    kernels (the forward of an autograd Function, say) reports their device
    time as its own too."""
    from torch.autograd import DeviceType

    rows = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"profile: device busy {busy_us / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms wall "
          f"({busy_us / 1e4 / wall_s:.1f}%)")
    # The top rows, then the port's own kernels that fall below them.
    for i, (us, count, name) in enumerate(rows):
        if i < top or any(k in name for k in _PORT_KERNELS):
            print(f"  {us / 1e3:10.2f} ms {100 * us / max(busy_us, 1e-9):5.1f}% {count:7d}x  "
                  f"{name[:90]}")
    # The host side: operators by their own CPU time (the profiler's
    # bookkeeping inflates every one of them alike).
    host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), reverse=True)
    host_us = sum(r[0] for r in host)
    print(f"profile: host operators {host_us / 1e3:.1f} ms of self CPU time")
    for us, count, name in host[:top]:
        print(f"  {us / 1e3:10.2f} ms {100 * us / max(host_us, 1e-9):5.1f}% {count:7d}x  "
              f"{name[:90]}")


def main(argv=None):
    """Serve ``--requests`` random prompts; returns (server, results)."""
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    cfg = dataclasses.replace(
        cfg,
        policy=args.policy or cfg.policy,
        kv_cache_dtype="e4m3" if args.fp8_kv else cfg.kv_cache_dtype,
        fp8_params=args.fp8_params or cfg.fp8_params,
        n_layers=args.layers or cfg.n_layers,
    )
    model = build(cfg, device=args.device)
    if model.engine.backend == "cuda":
        t0 = time.perf_counter()
        _build.library()  # build the kernels before the clocks start
        print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    params = model.init(args.seed)
    print(f"engine: policy={model.policy.name} backend={model.engine.backend} "
          f"device={model.device} kv_dtype={cfg.kv_cache_dtype} "
          f"fp8_params={cfg.fp8_params} layers={cfg.n_layers}")

    rng = np.random.default_rng(args.seed)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n))
               for n in mixed_prompt_lens(args.prompt_len, args.requests)]
    server = Server(model, params, ServerConfig(
        num_slots=args.num_slots, page_size=args.page_size,
        max_seq_len=max(len(p) for p in prompts) + args.max_new,
        prefill_bucket=min(32, max(8, args.prompt_len)),
    ), seed=args.seed, device=args.device)
    print(f"state store: {server.cache.allocator.num_pages} pages x {args.page_size} "
          f"tokens ({server.cache.kv_bytes() / 1e6:.2f} MB kv)")
    sampling = SamplingParams(args.temperature)
    for p in prompts:
        server.submit(p, max_new_tokens=args.max_new, sampling=sampling)
    t0 = time.perf_counter()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if model.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            results = server.run()  # the last harvest waits for the card
    else:
        results = server.run()
    wall = time.perf_counter() - t0
    s = server.stats
    print(f"continuous: {len(results)} requests, {s.decode_tokens} decode tokens in "
          f"{s.decode_steps} steps over {args.num_slots} slots")
    print(f"decode: {s.decode_tok_s:.1f} tok/s, prefill {s.prefill_s:.3f} s, "
          f"decode {s.decode_s:.3f} s, wall {wall:.3f} s, utilization {s.utilization:.0%}")
    if args.profile:
        print_device_time(prof, wall)
    for rid in sorted(results):
        r = results[rid]
        print(f"  req {rid}: prompt {r.prompt_len:>3} -> {r.num_generated} tokens "
              f"({r.finish_reason}): {r.out_tokens}")
    return server, results


if __name__ == "__main__":
    main()
