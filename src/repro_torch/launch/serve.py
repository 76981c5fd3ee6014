"""Serving launcher of the port: continuous batching over the paged KV pools
(the default), or ``--mode static``, the ring-buffer static-batch baseline.

Runs on the card by default (the hand-written kernels on every GEMM and
the decode attention, the decode step replayed as a CUDA graph);
``--device cpu`` runs the plain PyTorch path. The continuous path warms up
every step shape first (on the card: builds the kernels and captures the
decode graph), so its tok/s is the steady state; the static path times its
first decode step apart.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \\
      --fp8-kv --fp8-params --policy redmule_hfp8 --prompt-len 64 --page-size 16 [--profile]
  PYTHONPATH=src python -m repro_torch.launch.serve --fp8-kv --fp8-params \\
      --policy redmule_hfp8 --prompt-len 64 --page-size 16 --trace-out trace.json \\
      --metrics-out metrics.json --profile LOGDIR
  PYTHONPATH=src python -m repro_torch.launch.serve --fp8-kv --fp8-params \\
      --policy redmule_hfp8 --prompt-len 64 --page-size 16 --spec-k 4 \\
      --draft-model granite-moe-1b-a400m --spec-gate
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --chunked-prefill 4 --prefill-batch --prefix-cache --async-depth 1
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --mode static
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m --smoke --device cpu

The recurrent models serve from per-slot state rows (xlstm-125m holds no
KV pages at all), with speculative decoding too (``--spec-k``, or
``--draft-model xlstm-125m`` for xlstm); recurrentgemma-2b takes no
``--fp8-params``, which raises at its first step as the JAX package's
model does. The encoder-decoder (seamless-m4t-large-v2) and VLM
(internvl2-76b) families serve static-batch only, as in the reference:
the launcher falls back to ``--mode static`` for them and passes their
stub frontends, random frames or image patches made from ``--seed`` as
the data pipeline makes them.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \
      --fp8-kv --fp8-params --policy redmule_hfp8 --requests 4 --prompt-len 64

Observability, as in the reference's launcher: ``--trace-out PATH`` writes
the timed run's request-lifecycle trace (Chrome trace events, or JSONL for
``.jsonl``; ``scripts/validate_trace.py`` checks it), ``--metrics-out
PATH`` the registry's snapshot with the step profile (JSON, or Prometheus
text for ``.prom``/``.txt``), and ``--profile`` prints device time by
kernel from ``torch.profiler``; ``--profile LOGDIR`` also writes that
window's Chrome trace into LOGDIR. The three instrument the continuous
server; under static mode they are inert. ``--backend torch`` runs the
plain path on the card (the default is the device's: cuda on the card,
torch on the CPU).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.precision import POLICIES
from repro_torch.kernels import _build
from repro_torch.models import build
from repro_torch.obs import JsonTracer, device_capture, write_metrics, write_trace
from repro_torch.serving import SamplingParams, Server, ServerConfig, SpecConfig, generate_static
from repro_torch.launch.spec_gate import record_rows, run_gate


def mixed_prompt_lens(base: int, n: int) -> list[int]:
    """Deterministic mixed-length workload around ``base`` (>=2 tokens),
    the same as the reference launcher's."""
    cycle = [base, max(2, base // 2), base + base // 2, max(2, base - 2)]
    return [cycle[i % len(cycle)] for i in range(n)]


def frontend_inputs(cfg, batch: int, prompt_len: int, rng: np.random.Generator) -> dict:
    """The stub modality inputs of a static batch, fp16 draws from ``rng``
    as ``data/pipeline.py`` makes them: an encoder-decoder's frames
    (batch, prompt_len * enc_dec_ratio, d), the decoder length being the
    frames' over the ratio, and a VLM's ``n_frontend_tokens`` patches."""
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal((batch, prompt_len * cfg.enc_dec_ratio, cfg.d_model),
                                            dtype=np.float32).astype(np.float16)
    if cfg.family == "vlm":
        out["vis_embeds"] = rng.standard_normal((batch, cfg.n_frontend_tokens, cfg.d_model),
                                                dtype=np.float32).astype(np.float16)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced CPU-test config")
    ap.add_argument("--mode", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--fp8-kv", action="store_true", help="store the KV pages in E4M3")
    ap.add_argument("--fp8-params", action="store_true", help="store the weights in E4M3")
    ap.add_argument("--policy", choices=sorted(POLICIES), default=None,
                    help="precision policy (default: the config's)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's)")
    ap.add_argument("--chunked-prefill", type=int, default=0, metavar="N",
                    help="split prompts into N-token chunks interleaved with decode steps "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--async-depth", type=int, default=0, metavar="D",
                    help="dispatch up to D device steps ahead before the host waits for the "
                         "oldest (0 = synchronous; greedy outputs are the same at every depth)")
    ap.add_argument("--prefill-batch", action="store_true",
                    help="pack all prefilling slots into one (P, chunk) step, P bucketed to "
                         "{1,2,4,8}; requires --chunked-prefill")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share published prompt pages across requests (refcounted, "
                         "copy-on-write); every prompt then opens with one shared system "
                         "prefix, so the cache has something to hit")
    ap.add_argument("--priority", type=int, default=0,
                    help="priority of the submitted requests (higher runs first)")
    ap.add_argument("--preempt", action="store_true",
                    help="let higher-priority requests evict lower-priority ones that are "
                         "still prefilling; the second half of the requests then arrives at "
                         "priority+5 after the first half has started prefilling")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens a round and verify them in one "
                         "target step (0 = off); without --draft-model the drafter is n-gram "
                         "prompt lookup")
    ap.add_argument("--draft-model", choices=ARCH_IDS, default=None,
                    help="the draft model (its own StateStore; its vocabulary must be the "
                         "target's; --fp8-kv, --fp8-params, --policy and --page-size apply to "
                         "it too); implies --spec-k 4 if unset")
    ap.add_argument("--spec-ngram", type=int, default=3, metavar="N",
                    help="longest n-gram of prompt-lookup self-drafting")
    ap.add_argument("--spec-gate", action="store_true",
                    help="check that greedy speculative output equals a non-speculative run's "
                         "tokens (on the card under an fp8 policy: that every divergence lies "
                         "within the verify/decode logit noise, see launch/spec_gate.py) and "
                         "that the acceptance rate is above 0 (for a model drafter under "
                         "greedy, acceptance is read from a temperature-1.0 pass: two random "
                         "models share no greedy chain)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=("cuda", "torch"), default=None,
                    help="GEMM and attention backend (default: cuda on the card, torch on the "
                         "CPU; torch on the card runs the plain path there)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a request-lifecycle trace of the timed run: Chrome trace-event "
                         "JSON (open in ui.perfetto.dev) or JSONL when PATH ends in .jsonl")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot (counters, gauges, latency histograms, "
                         "step profile): JSON, or Prometheus text when PATH ends in .prom/.txt")
    ap.add_argument("--profile", nargs="?", const="", default=None, metavar="LOGDIR",
                    help="trace the timed run with torch.profiler and print device time by "
                         "kernel; with LOGDIR also write its Chrome trace there")
    return ap.parse_args(argv)


# Name fragments of the port's own CUDA kernels (csrc/*.cu).
_PORT_KERNELS = ("redmule_gemm", "kmajor_", "splitk_combine", "paged_decode",
                 "flash_attention")


def time_by_name(prof) -> tuple[list, list]:
    """(device rows, host rows), each (total µs, count, name) in descending
    order, from a finished torch.profiler window's raw events: every
    kernel (and copy) on the card by name, and every host operator by its
    own time, its children's on the same thread subtracted. This is what
    ``key_averages()`` gives as ``self_device_time_total`` and
    ``self_cpu_time_total``, without the event tree it builds, which costs
    about 40 times as much on a serve run's hundreds of thousands of
    events."""
    from torch.autograd import DeviceType

    dev, host, threads = {}, {}, collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0:
                row = dev.setdefault(e.name(), [0, 0])
                row[0] += e.duration_ns()
                row[1] += 1
        elif e.device_type() == DeviceType.CPU:
            threads[e.start_thread_id()].append((e.start_ns(), -e.end_ns(), e.name()))
    for events in threads.values():
        events.sort()
        stack = []  # [end, name, own ns]

        def close(item):
            row = host.setdefault(item[1], [0, 0])
            row[0] += item[2]
            row[1] += 1

        for start, neg_end, name in events:
            while stack and stack[-1][0] <= start:
                close(stack.pop())
            if stack:
                stack[-1][2] -= -neg_end - start
            stack.append([-neg_end, name, -neg_end - start])
        while stack:
            close(stack.pop())
    def rows(table):
        return sorted(((ns / 1e3, n, name) for name, (ns, n) in table.items() if ns > 0),
                      reverse=True)
    return rows(dev), rows(host)


def print_device_time(prof, wall_s: float, top: int = 8) -> None:
    """Device time by kernel name from a torch.profiler trace, the card's
    busy share of the traced wall time, and host time by operator
    (:func:`time_by_name`). Only the kernels' own rows count as device
    time."""
    rows, host = time_by_name(prof)
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
    host_us = sum(r[0] for r in host)
    print(f"profile: host operators {host_us / 1e3:.1f} ms of self CPU time")
    for us, count, name in host[:top]:
        print(f"  {us / 1e3:10.2f} ms {100 * us / max(host_us, 1e-9):5.1f}% {count:7d}x  "
              f"{name[:90]}")


def main(argv=None):
    """Serve ``--requests`` random prompts; returns (server, results), or
    (None, generated tokens) under ``--mode static``."""
    args = parse_args(argv)
    def config(arch):
        cfg = get_config(arch, smoke=args.smoke)
        return dataclasses.replace(
            cfg,
            policy=args.policy or cfg.policy,
            kv_cache_dtype="e4m3" if args.fp8_kv else cfg.kv_cache_dtype,
            fp8_params=args.fp8_params or cfg.fp8_params,
        )

    cfg = config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    model = build(cfg, device=args.device, backend=args.backend)
    if args.mode == "continuous" and not model.supports_cb():
        print(f"note: {cfg.name} ({cfg.family}) serves static-batch only; falling back to "
              "--mode static")
        args.mode = "static"
    if model.engine.backend == "cuda":
        t0 = time.perf_counter()
        _build.library()  # build the kernels before the clocks start
        print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    params = model.init(args.seed)
    print(f"engine: policy={model.policy.name} backend={model.engine.backend} "
          f"device={model.device} kv_dtype={cfg.kv_cache_dtype} "
          f"fp8_params={cfg.fp8_params} layers={cfg.n_layers}")

    spec = draft_model = draft_params = None
    if args.mode == "continuous" and (args.spec_k > 0 or args.draft_model is not None):
        spec = SpecConfig(k=args.spec_k or 4, ngram_n=args.spec_ngram)
        if args.draft_model is not None:
            dcfg = config(args.draft_model)
            draft_model = build(dcfg, device=args.device, backend=args.backend)
            draft_params = draft_model.init(args.seed + 1)
            print(f"drafter: {dcfg.name} layers={dcfg.n_layers} policy={draft_model.policy.name} "
                  f"kv_dtype={dcfg.kv_cache_dtype} fp8_params={dcfg.fp8_params}")
    elif args.spec_k > 0 or args.draft_model is not None:
        print("note: speculative decoding rides the continuous server; --spec-k/--draft-model "
              "are inert under static mode")

    rng = np.random.default_rng(args.seed)
    sampling = SamplingParams(args.temperature, args.top_k, args.top_p)
    if args.mode == "static":
        if args.trace_out or args.metrics_out or args.profile is not None:
            print("note: --trace-out/--metrics-out/--profile instrument the continuous server; "
                  "they are inert under static mode")
        tokens = rng.integers(0, cfg.vocab_size, size=(args.requests, args.prompt_len))
        batch = {"tokens": tokens, **frontend_inputs(cfg, args.requests, args.prompt_len, rng)}
        if model.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        seqs, stats = generate_static(
            model, params, {k: torch.from_numpy(v).to(model.device) for k, v in batch.items()},
            max_new_tokens=args.max_new, sampling=sampling, seed=args.seed)
        shapes = ", ".join(f"{k} {tuple(v.shape)}" for k, v in batch.items())
        print(f"static: {args.requests} seqs x {args.max_new} tokens, {shapes} (prefill "
              f"{stats.prefill_s:.3f} s, first decode {stats.first_decode_s:.3f} s)")
        if model.device.type == "cuda":
            print(f"peak memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        print(f"steady-state decode: {stats.decode_tok_s:.1f} tok/s over "
              f"{stats.steady_steps} steps")
        print(seqs)
        return None, seqs

    lens = mixed_prompt_lens(args.prompt_len, args.requests)
    if args.prefix_cache:
        # Shared-system-prompt shape: one common prefix and unique tails.
        sys_prompt = list(rng.integers(0, cfg.vocab_size, size=args.prompt_len))
        prompts = [sys_prompt + list(rng.integers(0, cfg.vocab_size, size=n)) for n in lens]
    elif spec is not None and draft_model is None:
        # Repeated-motif prompts, the traffic prompt lookup feeds on (a random
        # prompt repeats no n-gram until the greedy chain falls into a loop).
        prompts = []
        for n in lens:
            motif = list(rng.integers(0, cfg.vocab_size, size=max(2, n // 3)))
            prompts.append((motif * 3)[:max(n, 6)])
    else:
        prompts = [list(rng.integers(0, cfg.vocab_size, size=n)) for n in lens]
    server = Server(model, params, ServerConfig(
        num_slots=args.num_slots, page_size=args.page_size,
        max_seq_len=max(len(p) for p in prompts) + args.max_new,
        prefill_bucket=min(32, max(8, args.prompt_len)),
        prefill_chunk=args.chunked_prefill or None, prefix_cache=args.prefix_cache,
        preemption=args.preempt, async_depth=args.async_depth,
        prefill_batch=args.prefill_batch,
    ), seed=args.seed, device=args.device, spec=spec, draft_model=draft_model,
        draft_params=draft_params, tracer=JsonTracer() if args.trace_out else None)
    print(f"state store: {server.cache.allocator.num_pages} pages x {args.page_size} "
          f"tokens ({server.cache.kv_bytes() / 1e6:.2f} MB kv, "
          f"{server.cache.state_bytes() / 1e6:.2f} MB state rows)")
    if spec is not None and args.async_depth:
        print("note: --async-depth is inert under speculative decoding: a round is "
              "host-synchronous, so the dispatch depth is 0")
    if args.preempt and not args.chunked_prefill:
        print("note: --preempt is inert without --chunked-prefill: a whole-prompt prefill "
              "finishes in the step that admits it, so no request is ever prefilling")
    server.warmup([len(p) for p in prompts])
    spec_rows = {}
    if spec is not None and args.spec_gate:
        record_rows(server, spec_rows)

    def submit(p, priority):
        server.submit(p, max_new_tokens=args.max_new, sampling=sampling, priority=priority)

    def serve():
        if args.preempt:
            # Priority burst: the first half starts prefilling at the base
            # priority, then the second half arrives above it.
            half = max(1, len(prompts) // 2)
            for p in prompts[:half]:
                submit(p, args.priority)
            server.step()
            for p in prompts[half:]:
                submit(p, args.priority + 5)
        else:
            for p in prompts:
                submit(p, args.priority)
        return server.run()  # the last harvest waits for the card

    with device_capture(args.profile or None, enabled=args.profile is not None) as prof:
        t0 = time.perf_counter()
        results = serve()
        wall = time.perf_counter() - t0  # the profiler's teardown left out
    s = server.stats
    print(f"continuous: {len(results)} requests, {s.decode_tokens} decode tokens in "
          f"{s.decode_steps} steps over {args.num_slots} slots"
          + (f", prefill chunk {args.chunked_prefill}" if args.chunked_prefill else ""))
    print(f"decode: {s.decode_tok_s:.1f} tok/s, prefill {s.prefill_s:.3f} s, "
          f"decode {s.decode_s:.3f} s, wall {wall:.3f} s, utilization {s.utilization:.0%}")
    ttft = server.ttft_percentiles()
    if ttft is not None:
        print(f"ttft: p50 {ttft[0] * 1e3:.1f} ms, p95 {ttft[1] * 1e3:.1f} ms")
    if server.prefix_cache:
        print(f"prefix cache: hit-rate {s.prefix_hit_rate:.0%} ({s.prefix_hit_tokens}/"
              f"{s.prefix_prompt_tokens} prompt tokens), {s.cow_copies} cow copies")
    if args.preempt:
        print(f"preemptions: {s.preemptions}")
    if spec is not None:
        drafter = (f"model:{args.draft_model}" if draft_model is not None
                   else f"ngram(n={spec.ngram_n})")
        print(f"speculative: k={spec.k} drafter={drafter} acceptance {s.acceptance_rate:.0%} "
              f"({s.spec_accepted}/{s.spec_drafted} drafts), {s.accepted_per_step:.2f} "
              f"accepted/round over {s.spec_steps} rounds")
    if model.device.type == "cuda":
        eng = server.engine
        print(f"decode graph: {eng.graph_captures} capture(s), {eng.graph_replays} replays "
              f"(warm-up included)")
        if spec is not None:
            steps = {"verify": server.verifier.step}
            if draft_model is not None:
                steps |= {"drafter catch-up": server.drafter._catch_up,
                          "drafter decode": server.drafter._decode}
            print("speculative graphs: " + ", ".join(
                f"{k} {v.captures} capture(s) {v.replays} replays" for k, v in steps.items())
                + " (warm-up included)")
    if prof is not None:
        print_device_time(prof, wall)
        if args.profile:
            print(f"profile: device trace -> {args.profile}")
    for rid in sorted(results):
        r = results[rid]
        print(f"  req {rid}: prompt {r.prompt_len:>3} -> {r.num_generated} tokens "
              f"({r.finish_reason}): {r.out_tokens}")
    # Flush the observability files before the spec gate: its reference run
    # and reset() would wipe the timed run's metrics and trace.
    run_meta = {"arch": args.arch, "mode": args.mode, "requests": args.requests,
                "seed": args.seed}
    if args.trace_out:
        fmt = write_trace(server.tracer, args.trace_out, meta=run_meta)
        print(f"trace: {len(server.tracer.events)} events -> {args.trace_out} "
              f"({fmt}; chrome format opens in ui.perfetto.dev)")
    if args.metrics_out:
        fmt = write_metrics(server.metrics, args.metrics_out, profiler=server.profiler,
                            meta=run_meta)
        print(f"metrics: snapshot -> {args.metrics_out} ({fmt})")
    if args.trace_out or args.metrics_out or args.profile is not None:
        print(server.profiler.format_summary())
    if spec is not None and args.spec_gate:
        run_gate(args, server, model, params, prompts, results, sampling, spec_rows,
                 model_drafter=draft_model is not None)
    return server, results


if __name__ == "__main__":
    main()
