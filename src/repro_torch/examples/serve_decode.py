"""Continuous-batching serving demo (the port of ``examples/serve_decode.py``):
mixed-length requests stream through the serving StateStore (paged KV
pools for attention layers, per-slot state rows for recurrent layers),
each with its own sampling settings, while the decode batch stays one
fixed shape (on the card, one CUDA graph). The encoder-decoder and VLM
families serve static-batch, on a :func:`~repro_torch.models.make_batch`
batch.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch granite-3-8b
  PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch recurrentgemma-2b \\
      --chunked-prefill 8                        # hybrid, chunked prompts
  PYTHONPATH=src python -m repro_torch.examples.serve_decode --fp8-kv   # E4M3 KV pages

Each model is its arch's reduced (smoke) configuration on random weights
from seed 0, as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.examples import device_args
from repro_torch.models import build, make_batch
from repro_torch.serving import SamplingParams, Server, ServerConfig, generate_static


def _options(ap) -> None:
    ap.add_argument("--arch", choices=ARCH_IDS, default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--num-slots", type=int, default=2)
    ap.add_argument("--fp8-kv", action="store_true",
                    help="store the KV pages in E4M3 (paper fp8 storage)")
    ap.add_argument("--chunked-prefill", type=int, default=0, metavar="N",
                    help="N-token prefill chunks interleaved with decode")


def main(argv=None):
    """Returns the server and its results, or (None, the generated tokens)
    for a static-batch family."""
    args, device, _ = device_args(__doc__.splitlines()[0], argv, _options)
    cfg = get_config(args.arch, smoke=True)
    if args.fp8_kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="e4m3")
    model = build(cfg, device=device)
    params = model.init(0)
    rng = np.random.default_rng(1)

    if not model.supports_cb():
        # Only the encoder-decoder and VLM families serve static-batch.
        print(f"{cfg.name}: not decoder-only; static-batch decode")
        batch = make_batch(cfg, args.requests, args.prompt_len,
                           generator=torch.Generator(device=device).manual_seed(1), device=device)
        seqs, stats = generate_static(model, params, batch, max_new_tokens=args.gen)
        print(seqs)
        print(f"{stats.decode_tok_s:.1f} tok/s steady-state decode (first decode excluded)")
        return None, seqs

    server = Server(model, params, ServerConfig(
        num_slots=args.num_slots, page_size=8, max_seq_len=args.prompt_len + args.gen,
        prefill_bucket=8, prefill_chunk=args.chunked_prefill or None,
    ), device=device)
    print(f"arch={cfg.name} kv_dtype={cfg.kv_cache_dtype} "
          f"kv pool={server.cache.kv_bytes() / 1e6:.2f} MB "
          f"({server.cache.allocator.num_pages} pages x 8 tokens), "
          f"state rows={server.cache.state_bytes() / 1e6:.2f} MB")

    # Mixed lengths, mixed sampling: even requests greedy, odd ones sampled.
    lens = [max(2, args.prompt_len - 3 * (i % 3)) for i in range(args.requests)]
    server.warmup(lens)  # every step shape once (on the card: the decode graph)
    for i, plen in enumerate(lens):
        sampling = (SamplingParams() if i % 2 == 0
                    else SamplingParams(temperature=0.8, top_k=40, top_p=0.95))
        server.submit(rng.integers(0, cfg.vocab_size, size=plen),
                      max_new_tokens=args.gen, sampling=sampling)
    # Tokens stream out as each decode step samples them, interleaved across
    # requests in arrival order: that is continuous batching.
    for ev in server.stream():
        tag = f" <- {ev.finish_reason}" if ev.finished else ""
        print(f"req {ev.rid} token[{ev.index}] = {ev.token}{tag}")

    s = server.stats
    print(f"\n{len(server.results)} requests done: {s.decode_tok_s:.1f} tok/s of the decode "
          f"steps' own seconds (warm-up excluded), utilization {s.utilization:.0%}")
    return server, dict(server.results)


if __name__ == "__main__":
    main()
