"""The one general generator of the benchmark's traffic: it reads a mix's
parameters (``perfbench/traffic/<mix>.json``) and the run's seed, and
hands the program only the inputs it generates.

Every seed gets the same set of sizes in another order, so that two
seeds differ in the order of the work and in its token ids, never in its
amount: lengths are drawn by quantile, ``block`` requests at a time, each
block holding the same ``block`` quantiles of the prompt and the output
distributions, paired and ordered by the seed.

Kind ``serve_closed``: a closed loop of ``clients`` clients, each sending
its next request when its last one finishes (the load model of a tool
that keeps N requests in flight). Prompt and output lengths are normal,
``{"mean", "sd"}`` tokens each (at least 1), prompt ids uniform over the
vocabulary, greedy, no EOS. The clients' first requests are the ramp-in:
client i's output is cut to (i + 1) / clients of its draw, so the clients
fall out of step before the window opens.
"""
from __future__ import annotations

from statistics import NormalDist

import numpy as np


def quantile_lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the mid-quantiles of a normal ``dist``, at least 1."""
    nd = NormalDist(dist["mean"], dist["sd"])
    return np.array([max(1, round(nd.inv_cdf((i + 0.5) / n))) for i in range(n)], dtype=np.int64)


class ServeRequests:
    """The request stream of a ``serve_closed`` mix for one seed: an
    endless sequence of (prompt ids, output tokens), the first ``clients``
    of them the ramp-in."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        if mix["kind"] != "serve_closed":
            raise ValueError(f"not a serve_closed mix: {mix['kind']}")
        self.mix, self.vocab = mix, vocab
        self.rng = np.random.default_rng(seed)
        self.block = int(mix["block"])
        self.prompts = quantile_lengths(mix["prompt_tokens"], self.block)
        self.outputs = quantile_lengths(mix["output_tokens"], self.block)
        self.n = 0
        self._pending: list[tuple[int, int]] = []

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, int]:
        if not self._pending:
            self._pending = list(zip(self.rng.permutation(self.prompts).tolist(),
                                     self.rng.permutation(self.outputs).tolist()))
        p, o = self._pending.pop()
        clients = int(self.mix["clients"])
        if self.n < clients:
            o = max(1, round(o * (self.n + 1) / clients))
        self.n += 1
        return self.rng.integers(0, self.vocab, size=p, dtype=np.int64), int(o)

    @property
    def max_seq_len(self) -> int:
        return int(self.prompts.max() + self.outputs.max())

