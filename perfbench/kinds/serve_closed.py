"""A closed loop of clients against the program's continuous-batching
server (``repro_torch.serving.Server``: ``submit`` and ``step``, through
the engine core's chunked and batched prefill and the decode graph's
replays), timed on the host's clock, and its check against the plain
reference.

Set-up: the kernels built or loaded, the weights drawn on the device,
the server made, every (P, chunk) prefill step and the decode step run
once (the decode graph captured), then the ramp-in: every client's first
request sent, and the window opens when each has its first token.

The window: ``seconds`` of the loop. A token is stamped when
``Server.step`` returns it. ``out_tok_s`` counts every token harvested in
the window over its length. The closed loop keeps every slot full, so
the cell measures the server at its capacity: its tails, the 95th
percentiles of submit -> first token (over the requests whose first
token came in the window) and of the gaps between two consecutive tokens
of one request (both in the window), are per-layer readings.

With ``trace`` the loop runs on after the window for a traced slice of
``TRACE_S`` seconds under a profile of the card's activity alone, which
the per-layer metrics, ``busy_s`` and ``window_s`` read (a profile of the
host as well slows the host's eager work and so reads the card idler),
then for ``LABEL_S`` seconds under a profile of host and card, which only
labels the breakdown's idle gaps by what the host was doing.

Every run prints on standard error where the window's host time went:
the main thread's CPU seconds against the wall seconds of the steps with
and without a prefill chunk, the machine's steal time and the process's
involuntary context switches over the window; and the window's two tails.

The check, once the window has closed and the server is freed: the
longest finished request and, for every slot, one request it finished,
drawn from the seed, go through the reference, prompt and served tokens
at once; every served token is scored by how far its reference logit
lies below the reference's best at that position, in standard deviations
of that position's reference logits. The run compares the worst
request's mean gap (``worst_request_gap_sd``), so that a fault confined
to one slot is not averaged away over the others, and prints the mean
and the widest gap over all of them beside it.
"""
from __future__ import annotations

import gc
import os
import resource
import sys
import time

import numpy as np
import torch

from perfbench import generate, program, traces as tr, weights
from perfbench.reference import decoder as ref
from perfbench.yardstick import causal_pairs

TRACE_S = 4.0
LABEL_S = 2.0


def _setup(cfg: dict, mix: dict, seed: int, device: str):
    from repro_torch.kernels import _build
    from repro_torch.models import build
    from repro_torch.serving import Server, ServerConfig

    model = build(program.model_config(cfg), device=device)
    if model.engine.backend == "cuda":
        _build.library()
    params = weights.make(cfg, seed, device)
    reqs = generate.ServeRequests(mix, cfg["vocab_size"], seed)
    dep = cfg["deployment"]
    server = Server(model, params, ServerConfig(
        num_slots=int(mix["clients"]), page_size=int(dep["page_size"]),
        max_seq_len=reqs.max_seq_len, prefill_chunk=int(mix["prefill_chunk"]),
        prefill_batch=True, async_depth=int(mix["async_depth"])), seed=seed, device=device)
    # Every (P, chunk) prefill step the loop can dispatch, and the decode
    # step (its graph captured), once; reset keeps the pools and the graph.
    chunk = int(mix["prefill_chunk"])
    for p in server.engine.allowed_buckets()[::-1]:
        for _ in range(p):
            server.submit([1] * chunk, max_new_tokens=2)
        server.run()
    server.reset()
    return model, params, reqs, server


def run(cfg: dict, mix: dict, seed: int, seconds: float, *, trace: bool, device: str,
        limits: dict, t_start: float) -> dict:
    out, served = serve(cfg, mix, seed, seconds, trace=trace, device=device, t_start=t_start)
    out["checks"] = check(cfg, served, seed, limits, device)
    return out


def _host_clock() -> dict:
    """The process's own clocks and counters, and the machine's steal time."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"process_cpu_s": time.process_time(), "involuntary_switches": ru.ru_nivcsw,
           "steal_s": float("nan")}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        out["steal_s"] = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def serve(cfg: dict, mix: dict, seed: int, seconds: float, *, trace: bool, device: str,
          t_start: float) -> tuple[dict, dict]:
    """The timed loop; returns (its readings, what it served: the weights
    it was handed, and each finished request's prompt, tokens and slot),
    the program's state freed."""
    model, params, reqs, server = _setup(cfg, mix, seed, device)
    # What set-up made stays; the collector's passes skip it from here on,
    # as a serving process freezes its heap after warming up.
    gc.collect()
    gc.freeze()
    clients = int(mix["clients"])
    info: dict[int, tuple[int, float]] = {}  # rid -> (prompt length, submit time)
    request: dict[int, object] = {}
    slot: dict[int, int] = {}
    first: dict[int, float] = {}
    last: dict[int, float] = {}
    finished: list[int] = []
    ttft, itl = [], []
    out_tokens = 0
    t0 = t_end = None
    sl = {"t": None, "prof": None, "phase": None, "before": None, "lens": [], "first": 0,
          "pairs": 0.0}

    def submit(now: float) -> None:
        prompt, n = next(reqs)
        r = server.submit(prompt, max_new_tokens=n)
        info[r.rid] = (len(prompt), now)
        request[r.rid] = r

    for _ in range(clients):
        submit(time.perf_counter())
    # Server steps in the window by whether they carried a prefill chunk:
    # wall seconds and the main thread's CPU seconds.
    spans: dict[bool, list[float]] = {False: [], True: []}
    cpu: dict[bool, float] = {False: 0.0, True: 0.0}
    while True:
        n_prefill = server.metrics.histogram(program.PREFILL_STEPS).count
        t_step, c_step = time.perf_counter(), time.thread_time()
        events = server.step()
        now = time.perf_counter()
        in_win = t0 is not None and t_end is None
        if in_win:
            kind = server.metrics.histogram(program.PREFILL_STEPS).count > n_prefill
            spans[kind].append(now - t_step)
            cpu[kind] += time.thread_time() - c_step
        in_slice = sl["phase"] == "metrics"
        for ev in events:
            rid = ev.rid
            if ev.index == 0:
                first[rid] = now
                slot[rid] = -1 if request[rid].slot is None else request[rid].slot
                if in_win:
                    ttft.append(now - info[rid][1])
                if in_slice:
                    sl["first"] += 1
                    sl["pairs"] += causal_pairs(0, info[rid][0])
            else:
                if in_win and last[rid] >= t0:
                    itl.append(now - last[rid])
                if in_slice:
                    sl["lens"].append(info[rid][0] + ev.index - 1)
            last[rid] = now
            out_tokens += in_win
            if ev.finished:
                finished.append(rid)
                submit(now)
        if t0 is None:
            if len(first) >= clients:
                t0 = now
                setup_s = now - t_start
                before = program.serve_counters(server)
                host_before = _host_clock()
        elif t_end is None:
            if now - t0 >= seconds:
                t_end = now
                after = program.serve_counters(server)
                host_after = _host_clock()
                if not trace:
                    break
                # The traced slices follow the window, so that the
                # profiler's cost stays out of what the window measured.
                program.sync(device)
                sl["before"] = program.serve_counters(server)
                sl["prof"] = tr.profiler(device, host=False)
                sl["prof"].start()
                sl["phase"], sl["t"] = "metrics", time.perf_counter()
        elif sl["phase"] == "metrics" and time.perf_counter() - sl["t"] >= TRACE_S:
            program.sync(device)
            sl["prof"].stop()
            sl["after"] = program.serve_counters(server)
            sl["metrics"] = sl["prof"]
            sl["prof"] = tr.profiler(device, host=True)
            sl["prof"].start()
            sl["phase"], sl["t"] = "labels", time.perf_counter()
        elif sl["phase"] == "labels" and time.perf_counter() - sl["t"] >= LABEL_S:
            program.sync(device)
            sl["prof"].stop()
            break
    program.sync(device)
    window_s = t_end - t0
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    won = program.delta(after, before)
    host = program.delta(host_after, host_before)
    in_window = sum(1 for rid in finished if t0 <= last[rid] <= t_end)
    print(f"serve: {in_window} requests finished in the {window_s:.1f} s window, "
          f"{len(ttft)} first tokens, {out_tokens} tokens, {len(finished)} finished in all")
    print(f"host: in the {window_s:.3f} s window, {len(spans[True])} steps with a prefill chunk "
          f"took {sum(spans[True]):.3f} s wall and {cpu[True]:.3f} s of the main thread's CPU, "
          f"{len(spans[False])} without took {sum(spans[False]):.3f} s wall and "
          f"{cpu[False]:.3f} s CPU; {won['prefill_tokens']:.0f} prompt tokens in "
          f"{won['prefill_steps']:.0f} prefill steps harvested; process CPU "
          f"{host['process_cpu_s']:.3f} s, machine steal "
          f"{host['steal_s']:.2f} s, {host['involuntary_switches']} involuntary switches",
          file=sys.stderr)
    if ttft and itl:
        print(f"tails: in the window ttft p95 {1e3 * np.percentile(ttft, 95):.1f} ms over "
              f"{len(ttft)} requests, itl p95 {1e3 * np.percentile(itl, 95):.1f} ms over "
              f"{len(itl)} gaps", file=sys.stderr)
    results = {rid: list(server.results[rid].out_tokens) for rid in finished}
    prompts = {rid: server.results[rid].prompt for rid in finished}
    failed = sum(1 for rid in finished
                 if t0 <= last[rid] <= t_end and server.results[rid].finish_reason != "length")
    del server, model, request
    gc.unfreeze()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    out = {
        "attempted": in_window,
        "failed": failed,
        "window_s": window_s, "setup_s": setup_s, "memory_peak_bytes": peak,
        "end_to_end": {"out_tok_s": out_tokens / window_s, "setup_s": setup_s},
        "host": host | {"step_wall_s": {k: sum(v) for k, v in spans.items()},
                        "step_cpu_s": cpu},
    }
    if trace:
        out["trace"] = tr.summarize(sl["metrics"], labels=sl["prof"])
        out["observed"] = {
            "window": won, "step_s": spans, "ttft_s": ttft, "itl_s": itl,
            "slice": program.delta(sl["after"], sl["before"]),
            "slice_decode_lens": sl["lens"], "slice_first_tokens": sl["first"],
            "slice_prompt_pairs": sl["pairs"], "slots": clients,
            "page_size": int(cfg["deployment"]["page_size"]),
            "pages_per_slot": -(-reqs.max_seq_len // int(cfg["deployment"]["page_size"])),
        }
    served = {"params": params, "prompts": prompts, "results": results, "finished": finished,
              "slots": {rid: slot[rid] for rid in finished},
              "ramp": set(sorted(info)[:clients]),
              "nonfinite_steps": won["nonfinite_steps"]}
    return out, served


def sample(finished: list[int], lengths: dict[int, int], slots: dict[int, int],
           seed: int, ramp: set[int] = frozenset()) -> list[int]:
    """The longest finished request, and for every slot one other request
    it finished, drawn from the seed: one past the ramp-in where the slot
    has one (the ramp-in's outputs are cut short)."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (lengths[r], -r))
    rng = np.random.default_rng([int(seed), 1])
    by_slot: dict[int, list[int]] = {}
    for r in sorted(finished, key=lambda r: r in ramp):
        if r != longest and (r not in ramp or slots[r] not in by_slot):
            by_slot.setdefault(slots[r], []).append(r)
    return [longest] + [int(rng.choice(by_slot[k])) for k in sorted(by_slot)]


def layer_weights_of(params: dict, cfg: dict):
    """Layer i's weights in fp32, as the reference takes them, from the
    drawn groups the program was handed."""
    def get(i: int) -> dict:
        lp = params["layers"][i]
        w = {"norm1": lp["norm1"]["scale"].float(), "norm2": lp["norm2"]["scale"].float()}
        w |= {k: lp["attn"][k]["w"].float() for k in ("q", "k", "v", "o")}
        if "moe" in lp:
            w |= {"router": lp["moe"]["router"]["w"].float(),
                  **{k: lp["moe"][k].float() for k in ("up", "gate", "down")}}
        else:
            w |= {k: lp["ffn"][k]["w"].float() for k in ("up", "gate", "down")}
        return w
    return get


def reference_logits(cfg: dict, params: dict, seqs: list[list[int]], starts: list[int],
                     prec: ref.Precision, kv_fmt: str | None, device: str) -> list[torch.Tensor]:
    """The reference's logits at the positions that predict each
    sequence's tokens from ``starts[i]`` on."""
    top = {"embed": params["embed"]["table"], "final_norm": params["final_norm"]["scale"].float()}
    if "head" in params:
        top["head"] = params["head"]["w"]
    ids = [torch.tensor(s, dtype=torch.long, device=device) for s in seqs]
    with ref.fp32_products():
        return ref.served_logits(layer_weights_of(params, cfg), top, ref.Arch.of(cfg), ids,
                                 starts, prec, kv_fmt)


def gap_sd(logits: list[torch.Tensor], tokens: list[torch.Tensor]) -> list[np.ndarray]:
    """For each request, how far each token's reference logit lies below
    the reference's best at its position, in standard deviations of the
    logits there."""
    out = []
    for lg, tok in zip(logits, tokens):
        best = lg.max(-1).values
        out.append(((best - lg.gather(-1, tok.long()[:, None])[:, 0]) / lg.std(-1)).cpu().numpy())
    return out


def gap_summary(gaps: list[np.ndarray]) -> dict:
    """The worst request's mean gap, the mean and the widest gap over every
    token, and the count of tokens."""
    gaps = [g for g in gaps if g.size]
    if not gaps:
        return {"worst_request": float("inf"), "mean": float("inf"), "widest": float("inf"),
                "tokens": 0, "not_first": 0.0}
    every = np.concatenate(gaps)
    return {"worst_request": float(max(g.mean() for g in gaps)), "mean": float(every.mean()),
            "widest": float(every.max()), "tokens": int(every.size),
            "not_first": float((every > 0).mean())}


def picked(served: dict, seed: int) -> tuple[list[list[int]], list[int], list[list[int]]]:
    """The requests checked (:func:`sample`): (prompt + served ids, prompt
    lengths, served ids)."""
    pr, rs, fin = served["prompts"], served["results"], served["finished"]
    rids = sample(fin, {r: len(pr[r]) + len(rs[r]) for r in fin}, served["slots"], seed,
                  served["ramp"])
    return [list(pr[r]) + rs[r] for r in rids], [len(pr[r]) for r in rids], [rs[r] for r in rids]


def check(cfg: dict, served: dict, seed: int, limits: dict, device: str) -> dict:
    seqs, starts, tokens = picked(served, seed)
    logits = reference_logits(cfg, served["params"], seqs, starts, reference_precision(cfg),
                              cfg["deployment"].get("kv_format"), device)
    g = gap_summary(gap_sd(logits, [torch.tensor(t, device=device) for t in tokens]))
    print(f"serve check: {g['tokens']} tokens of {len(seqs)} requests, worst request's mean gap "
          f"{g['worst_request']:.4f} sd, mean {g['mean']:.4f} sd, widest {g['widest']:.4f} sd, "
          f"{g['not_first']:.3f} of them not the reference's first")
    out = {"worst_request_gap_sd": {"value": g["worst_request"],
                                    "limit": limits["worst_request_gap_sd"]},
           "tokens_checked": {"value": g["tokens"], "limit": limits["tokens_checked"]}}
    if served["nonfinite_steps"]:
        out["nonfinite_steps"] = {"value": served["nonfinite_steps"], "limit": 0}
    return out


def reference_precision(cfg: dict) -> ref.Precision:
    dep = cfg["deployment"]
    return ref.Precision(dep["operand_format"], dep["compute_format"])
