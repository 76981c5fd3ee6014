"""Paper-faithful TinyML training: hybrid-FP8 vs FP16 vs FP32 (Sec. 5.2.2-3;
the port of ``examples/train_tinyml.py``).

Trains a ResNet8-class MLP (the paper's conv layers are im2col GEMMs; here
the GEMMs *are* the model) on a synthetic classification task under three
RedMulE precision policies, demonstrating the paper's central claim: hybrid
FP8 (E4M3 forward, E5M2 backward, FP16-class internal) trains to about FP32
quality. On the card every forward GEMM and both backward GEMMs of each
layer launch the GEMM-Op kernel.

  PYTHONPATH=src python -m repro_torch.examples.train_tinyml [--device cpu]

The initial weights and the data come from ``torch.Generator`` seeds, not
the reference's ``jax.random`` keys, so the numbers differ from the
reference script's; the claim they are held to is the same.
"""
from __future__ import annotations

import math

import torch

from repro_torch.engine import Engine
from repro_torch.examples import device_args

DIMS = [64, 128, 128, 10]  # ResNet8-scale GEMM stack
STEPS, BATCH, LR = 300, 64, 0.05
POLICIES = ("fp32", "redmule_fp16", "redmule_hfp8")


def init(gen: torch.Generator) -> list[torch.Tensor]:
    return [torch.randn((a, b), generator=gen, device=gen.device) / math.sqrt(a)
            for a, b in zip(DIMS[:-1], DIMS[1:])]


def forward(params, x: torch.Tensor, engine: Engine) -> torch.Tensor:
    h = x
    for i, w in enumerate(params):
        h = engine.matmul(h, w)
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def loss_fn(params, x: torch.Tensor, y: torch.Tensor, engine: Engine) -> torch.Tensor:
    logits = forward(params, x, engine).float()
    return (torch.logsumexp(logits, -1) - logits.gather(-1, y[:, None])[:, 0]).mean()


def train_step(params, x: torch.Tensor, y: torch.Tensor, engine: Engine):
    """One SGD step; returns (new params, loss), as the reference's step."""
    leaves = [p.detach().requires_grad_() for p in params]
    loss = loss_fn(leaves, x, y, engine)
    grads = torch.autograd.grad(loss, leaves)
    return [p.detach() - LR * g for p, g in zip(leaves, grads)], loss.detach()


def labels(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """The class of each row: argmax of its projection (a linearly separable
    10-class problem)."""
    return (x[:, :, None] * proj[None]).sum(1).argmax(-1)


def make_data(gen: torch.Generator):
    proj = torch.randn((DIMS[0], 10), generator=gen, device=gen.device)

    def batch(g: torch.Generator):
        x = torch.randn((BATCH, DIMS[0]), generator=g, device=g.device)
        return x, labels(x, proj)
    return batch


def run(policy_name: str, device: torch.device, backend: str, seed: int = 0,
        steps: int = STEPS) -> tuple[float, float]:
    engine = Engine(policy=policy_name, backend=backend)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    params = init(gen(seed))
    batch_fn = make_data(gen(99))
    data = gen(seed + 1)
    loss = None
    for _ in range(steps):
        x, y = batch_fn(data)
        params, loss = train_step(params, x, y, engine)
    x, y = batch_fn(gen(12345))
    with torch.no_grad():
        acc = float((forward(params, x, engine).argmax(-1) == y).float().mean())
    return float(loss), acc


def main(argv=None) -> dict:
    args, device, backend = device_args(
        __doc__.splitlines()[0], argv,
        lambda ap: ap.add_argument("--steps", type=int, default=STEPS))
    print(f"{'policy':16s} {'final loss':>10s} {'accuracy':>9s}")
    results = {}
    for name in POLICIES:
        loss, acc = run(name, device, backend, steps=args.steps)
        results[name] = acc
        print(f"{name:16s} {loss:10.4f} {acc:9.1%}")
    # The paper's claim: hybrid-FP8 training retains accuracy.
    if not results["redmule_hfp8"] > results["fp32"] - 0.05:
        raise AssertionError(f"hybrid FP8 lost accuracy: {results}")
    print("\nOK — hybrid-FP8 training matches FP32 within 5% accuracy "
          "(paper Sec. 4.2.3 / Fig. 10)")
    return results


if __name__ == "__main__":
    main()
