"""Quickstart: the RedMulE engine in five minutes (the port of
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. One ``Engine`` handle: GEMM and GEMM-Ops (paper Table 1) as methods.
2. Hybrid-FP8 mixed precision: E4M3 forward / E5M2 backward, FP16-class
   internal compute, the paper's scheme as a drop-in matmul.
3. The hand-written kernel against its plain version (the reference
   checks its Pallas kernel in interpret mode against XLA); on the CPU
   both sides are the plain version.
4. Differentiable semiring ops and the closure (APSP in one call).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine import Engine
from repro_torch.examples import device_args, tensor


def main(argv=None) -> dict:
    _, device, backend = device_args(__doc__.splitlines()[0], argv)
    print("=== 1. GEMM-Ops (Table 1) through one Engine ===")
    rng = np.random.default_rng(0)
    x = tensor(rng.random((6, 8)).astype(np.float32), device)
    w = tensor(rng.random((8, 5)).astype(np.float32), device)
    y = tensor(rng.random((6, 5)).astype(np.float32), device)
    eng = Engine(policy="fp32", backend=backend)
    for op in ("matmul", "apsp", "max_capacity_path"):
        z = eng.gemm_op(x, w, y, op=op)
        print(f"  {op:18s} -> shape {tuple(z.shape)}, z[0,0] = {float(z[0, 0]):.4f}")

    print("\n=== 2. Hybrid-FP8 training rule ===")
    a = tensor(rng.standard_normal((4, 16)).astype(np.float32), device).requires_grad_()
    b = tensor(rng.standard_normal((16, 4)).astype(np.float32), device).requires_grad_()
    hfp8 = Engine(policy="redmule_hfp8", backend=backend)
    loss = (hfp8.matmul(a, b) ** 2).sum()  # in the output format, as the reference sums
    loss.backward()
    print(f"  forward consumes E4M3 operands; loss = {float(loss.detach()):.3f}")
    print(f"  backward consumed E5M2 grads;   |da| = {float(a.grad.norm()):.3f}")

    print(f"\n=== 3. The {backend} backend against the plain version ===")
    fp16 = Engine(policy="redmule_fp16", backend=backend)
    z_kernel = fp16.gemm_op(x, w, y, op="apsp")
    z_plain = fp16.with_backend("torch").gemm_op(x, w, y, op="apsp")
    err = float((z_kernel.float() - z_plain.float()).abs().max())
    print(f"  {backend} vs plain max abs diff: {err:.2e}")
    assert err < 1e-2

    print("\n=== 4. Differentiable semirings + closure ===")
    # d(min-plus matmul)/dx routes the cotangent along the argmin lanes: the
    # backpointers of the shortest-path DP (see viterbi_decode).
    xg = x.clone().requires_grad_()
    eng.gemm_op(xg, w, op="apsp").sum().backward()
    nonzeros = int((xg.grad != 0).sum())
    print(f"  apsp is differentiable: grad nonzeros = {nonzeros}")
    # The closure runs repeated min-plus squaring to the fixpoint in one call.
    inf = 3e4
    adj = np.where(rng.random((8, 8)) < 0.4, rng.random((8, 8)) * 9 + 1, inf)
    dist = eng.closure(tensor(adj.astype(np.float32), device), op="apsp")
    mean = float(torch.clamp(dist, max=inf).mean())
    print(f"  closure(adj) mean distance: {mean:.3f}")
    print("\nOK")
    return {"kernel_vs_plain": err, "apsp_grad_nonzeros": nonzeros, "closure_mean": mean}


if __name__ == "__main__":
    main()
