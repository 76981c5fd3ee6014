"""Viterbi decoding on the engine's differentiable max-plus path (the port
of ``examples/viterbi_decode.py``).

The Viterbi recursion is a chain of max-plus GEMM-Ops (Table 1
'max_critical_path': circ=add, star=max):

    alpha_{t}[j] = max_i ( alpha_{t-1}[i] + trans[i, j] ) + emit[t, j]

so the best-path score is ``max(alpha_T)``. Because ``Engine.gemm_op`` is
differentiable through tropical subgradients, the *gradient* of the best
score recovers the decode:

    d score / d emit[t, s]  = 1  iff state s at time t lies on the argmax
                                  path  (the backpointer table, for free)
    d score / d trans[i, j] = number of times edge i->j is used

Verified against a classic numpy Viterbi with explicit backpointers. On
the card the chain and its VJP launch the GEMM-Op kernel's SIMT schedule;
the same chain on the plain backend must decode the same path.

  PYTHONPATH=src python -m repro_torch.examples.viterbi_decode [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine import Engine
from repro_torch.examples import device_args, tensor

T, S = 12, 6  # time steps, states


def scores(seed: int = 3):
    """The reference's log transition (S, S) and emission (T, S) scores."""
    rng = np.random.default_rng(seed)
    trans = rng.standard_normal((S, S)).astype(np.float32)
    emit = rng.standard_normal((T, S)).astype(np.float32)
    return trans, emit


def best_score(eng: Engine, trans: torch.Tensor, emit: torch.Tensor) -> torch.Tensor:
    """Max-plus forward chain through the engine; the Viterbi score."""
    alpha = emit[0][None, :]  # (1, S)
    for t in range(1, T):
        # alpha (add, max) trans, then the emission as an elementwise add.
        alpha = eng.gemm_op(alpha, trans, op="max_critical_path")
        alpha = alpha + emit[t][None, :]
    return alpha.max()


def score_and_grads(eng: Engine, trans: np.ndarray, emit: np.ndarray, device):
    tr = tensor(trans, device).requires_grad_()
    em = tensor(emit, device).requires_grad_()
    score = best_score(eng, tr, em)
    d_trans, d_emit = torch.autograd.grad(score, (tr, em))
    return float(score.detach()), d_trans.cpu().numpy(), d_emit.cpu().numpy()


def numpy_viterbi(trans: np.ndarray, emit: np.ndarray):
    alpha = emit[0].copy()
    bp = np.zeros((T, S), np.int64)
    for t in range(1, T):
        sc = alpha[:, None] + trans  # (S_prev, S)
        bp[t] = np.argmax(sc, axis=0)
        alpha = np.max(sc, axis=0) + emit[t]
    path = np.zeros(T, np.int64)
    path[-1] = int(np.argmax(alpha))
    for t in range(T - 1, 0, -1):
        path[t - 1] = bp[t, path[t]]
    return float(np.max(alpha)), path


def main(argv=None) -> dict:
    _, device, backend = device_args(__doc__.splitlines()[0], argv)
    trans, emit = scores()
    score, d_trans, d_emit = score_and_grads(Engine(policy="fp32", backend=backend), trans,
                                             emit, device)
    # The gradient with respect to the emissions is one-hot a time step: the path.
    path_from_grad = np.argmax(d_emit, axis=1)
    ref_score, ref_path = numpy_viterbi(trans, emit)
    print(f"engine best score : {score:.4f}")
    print(f"numpy  best score : {ref_score:.4f}")
    print(f"path from gradient: {path_from_grad.tolist()}")
    print(f"path from numpy   : {ref_path.tolist()}")
    if not (abs(score - ref_score) < 1e-4 and (path_from_grad == ref_path).all()):
        raise AssertionError(f"score {score} / path {path_from_grad} off the numpy "
                             f"reference's {ref_score} / {ref_path}")
    # Each time step's emission gradient sums to 1 (one state a step).
    np.testing.assert_allclose(d_emit.sum(axis=1), 1.0, atol=1e-5)
    # Edge-usage counts from d_trans match the decoded path's transitions.
    edge_counts = np.zeros((S, S), np.float32)
    for t in range(1, T):
        edge_counts[ref_path[t - 1], ref_path[t]] += 1.0
    np.testing.assert_allclose(d_trans, edge_counts, atol=1e-5)
    # The same chain on the plain backend (the reference runs its Pallas path).
    score_p, _, d_emit_p = score_and_grads(Engine(policy="fp32", backend="torch"), trans,
                                           emit, device)
    if not (abs(score_p - ref_score) < 1e-4 and (np.argmax(d_emit_p, axis=1) == ref_path).all()):
        raise AssertionError("the plain backend's score or path is off the numpy reference's")
    print(f"OK — gradient of the max-plus score decodes the Viterbi path (backpointer "
          f"routing as a VJP), on the {backend} and plain backends")
    return {"score": score, "d_trans": d_trans, "d_emit": d_emit, "path": path_from_grad}


if __name__ == "__main__":
    main()
