"""Deterministic synthetic LM data pipeline: the port's copy of
``repro.data.pipeline`` (numpy only; the same seed gives the same batches,
bit for bit).

Properties a 1000-node deployment needs and this pipeline has:
  - stateless addressing: batch ``i`` is a pure function of (seed, i), so any
    worker can reproduce any shard at any time — restart/elastic-safe, no
    data server to fail;
  - per-host sharding: each host materializes only its slice of the global
    batch (``host_slice``), with identical semantics to the global batch;
  - background prefetch with a bounded queue (double buffering).

The token stream is a mixture of structured sequences (Markov-ish integer
walks) rather than uniform noise, so cross-entropy has learnable signal and
the end-to-end examples show a decreasing loss.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # host sharding
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """batch(i) -> dict of numpy arrays for host ``host_index``."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig | None = None):
        if cfg.global_batch % cfg.host_count:
            raise ValueError(
                f"global_batch {cfg.global_batch} not divisible by "
                f"host_count {cfg.host_count}"
            )
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.local_batch = cfg.global_batch // cfg.host_count

    def _tokens(self, rng: np.random.Generator, n: int, s: int) -> np.ndarray:
        """Structured stream: x_{t+1} = (a*x_t + b + noise) % V."""
        v = self.cfg.vocab_size
        a = rng.integers(2, 7, size=(n, 1))
        b = rng.integers(0, v, size=(n, 1))
        x = np.empty((n, s), np.int64)
        x[:, 0] = rng.integers(0, v, size=n)
        noise = (rng.random((n, s)) < 0.05) * rng.integers(0, v, size=(n, s))
        for t in range(1, s):
            x[:, t] = (a[:, 0] * x[:, t - 1] + b[:, 0] + noise[:, t]) % v
        return x.astype(np.int32)

    def batch(self, index: int) -> dict:
        cfg = self.cfg
        # Stateless: rng determined by (seed, index, host).
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, index, cfg.host_index])
        )
        n, s = self.local_batch, cfg.seq_len
        mc = self.model_cfg
        out = {}
        if mc is not None and mc.family == "audio":
            dec = max(s // mc.enc_dec_ratio, 1)
            out["tokens"] = self._tokens(rng, n, dec)
            out["frames"] = rng.standard_normal(
                (n, s, mc.d_model), dtype=np.float32
            ).astype(np.float16)
        else:
            out["tokens"] = self._tokens(rng, n, s)
        if mc is not None and mc.family == "vlm":
            out["vis_embeds"] = rng.standard_normal(
                (n, mc.n_frontend_tokens, mc.d_model), dtype=np.float32
            ).astype(np.float16)
        return out

    def iterate(self, start: int = 0, prefetch: int = 2):
        """Prefetching iterator, resumable from ``start`` (checkpoint the
        step counter and the stream resumes exactly)."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            i = start
            while not stop.is_set():
                try:
                    q.put(self.batch(i), timeout=0.5)
                    i += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def for_model(cfg: ModelConfig, seq_len: int, global_batch: int, seed: int = 0,
              host_index: int = 0, host_count: int = 1) -> SyntheticLM:
    return SyntheticLM(
        DataConfig(cfg.vocab_size, seq_len, global_batch, seed, host_index, host_count),
        cfg,
    )
