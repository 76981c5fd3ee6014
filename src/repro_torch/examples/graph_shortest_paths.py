"""All-pairs shortest paths with GEMM-Ops (paper Table 1, 'APSP'; the port
of ``examples/graph_shortest_paths.py``).

The min-plus semiring matmul is one relaxation step; ``Engine.closure``
runs the repeated-squaring fixpoint (at most ceil(log2 V) + 1 engine calls,
with an early exit) in one library call. This is the graph-analytics use
case RedMulE's GEMM-Ops target (drone path planning, Sec. 2.4). Verified
against a dense Floyd-Warshall. On the card each squaring launches the
GEMM-Op kernel's SIMT schedule.

  PYTHONPATH=src python -m repro_torch.examples.graph_shortest_paths [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine import Engine
from repro_torch.examples import device_args, tensor

V = 48
INF = np.float32(3.0e4)  # large-M representable in fp16 too


def graph(seed: int = 7):
    """The reference's random sparse-ish weighted digraph: (weights, mask)."""
    rng = np.random.default_rng(seed)
    adj = rng.random((V, V)).astype(np.float32) * 10
    mask = rng.random((V, V)) < 0.15
    return adj, mask


def floyd_warshall(dist: np.ndarray) -> np.ndarray:
    fw = dist.copy()
    for k in range(len(fw)):
        fw = np.minimum(fw, fw[:, k:k + 1] + fw[k:k + 1, :])
    return fw


def main(argv=None) -> dict:
    _, device, backend = device_args(__doc__.splitlines()[0], argv)
    adj, mask = graph()
    dist = np.where(mask, adj, INF)
    np.fill_diagonal(dist, 0.0)
    fw = floyd_warshall(dist)

    # Engine: the min-plus closure D* (repeated squaring to the fixpoint).
    eng = Engine(policy="fp32", backend=backend)
    d = eng.closure(tensor(dist, device), op="apsp")
    print(f"closure mean distance: {float(torch.clamp(d, max=float(INF)).mean()):.3f}")
    err = float(np.max(np.abs(d.cpu().numpy() - fw)))
    print(f"max |engine - floyd_warshall| = {err:.2e}")
    assert err < 1e-3
    print("OK — APSP via Engine.closure matches Floyd-Warshall")

    off = ~np.eye(V, dtype=bool)
    # Maximum-capacity path (Group 2: circ=min, star=max): same call, another
    # semiring. The diagonal seed (the empty path) is +inf-like, so report
    # the off-diagonal mean.
    cap = np.where(mask, adj, np.float32(0.0))
    c = eng.closure(tensor(cap, device), op="max_capacity_path").cpu().numpy()
    cap_mean = float(np.minimum(c, INF)[off].mean())
    print(f"max-capacity closure via (min, max) semiring — mean bottleneck capacity "
          f"{cap_mean:.3f}")
    # Minimum spanning bottleneck (Group 2: circ=max, star=min): the (max,
    # min) closure gives the minimax edge weight between every pair.
    bot = np.where(mask, adj, INF)
    b = eng.closure(tensor(bot, device), op="min_spanning_tree").cpu().numpy()
    bot_mean = float(np.minimum(b, INF)[off].mean())
    print(f"min-spanning-bottleneck closure via (max, min) semiring — mean minimax weight "
          f"{bot_mean:.3f}")
    return {"apsp_err": err, "apsp": d.cpu().numpy(), "capacity": c, "bottleneck": b}


if __name__ == "__main__":
    main()
