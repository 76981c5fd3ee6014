#!/usr/bin/env python3
"""How far the port's one-process train-step gradients lie from the JAX
package's, leaf by leaf, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/probe_port_grads.py \\
        [--arch granite-3-8b --arch recurrentgemma-2b ...] [--seq 16] \\
        [--batch 4] [--policy redmule_hfp8] [--leaves] [--sites]

For each SMOKE config: the reference's ``jax.grad`` of its loss at its
initial parameters (``PRNGKey(0)``) on its pipeline's first batch of
``--batch`` rows of ``--seq`` tokens, against the gradients the port's
first train step (``make_train_step``, one process) takes from the same
parameters and batch. Prints both losses, the share of fp16 gradient elements whose
bits differ, the worst difference in fp16 ulps, and the worst fp32 leaf's
|d| over its largest; ``--leaves`` adds a line a leaf. The last line is
one JSON object of the figures by arch. Run it against an older checkout
with ``PYTHONPATH=<that checkout>/src`` (the reference is the same
package in both).

``--sites`` first prints, for each fp32 function the models call, the
share of 2^20 N(0, 64) draws (rows of 1024 for softmax and logsumexp)
whose value and whose gradient (``jax.vjp`` against autograd, cotangents
N(0, 1)) differ in bits from the reference's under ``jax.jit``: torch's
own function against the port's. Then the same for the bf16 silu and gelu
(the draws rounded to bf16, the tails to +-100 among them), with torch's
autograd of the port's forward expansion in place of torch's function,
the draws whose gradient the reference keeps finite and autograd does
not, and what XLA compiles for the gradient: its arithmetic steps, how
many of them round to bf16, and its fused multiply-adds.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import numpy as np
import torch

from repro.configs import get_config
from repro.data import for_model
from repro.models import build
from repro.training.loop import make_loss_fn
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves
from repro_torch.distrib import sharding as tshd
from repro_torch.models import build as tbuild
from repro_torch.optim import AdamW
from repro_torch.training import init_train_state, make_train_step

ARCHS = ("granite-3-8b", "recurrentgemma-2b", "gemma2-2b")


class _FirstGrads:
    """An optimizer that keeps the gradients of its first update."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, params, grads, state, step, gnorm):
        if self.grads is None:
            self.grads = grads
        return self.opt.update(params, grads, state, step, gnorm)


def _ordered(x: np.ndarray) -> np.ndarray:
    i = x.view(np.int16).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFF), i)


def probe(arch: str, seq: int, batch_rows: int, policy: str, per_leaf: bool) -> dict:
    cfg = dataclasses.replace(get_config(arch, smoke=True), policy=policy)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), policy=policy)
    batch = jax.tree.map(np.asarray, for_model(cfg, seq_len=seq,
                                               global_batch=batch_rows).batch(0))
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    loss, want = jax.jit(jax.value_and_grad(lambda p, b: make_loss_fn(model)(p, b)[0]))(
        params, batch)

    init = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    ref = params_from_jax(jax.tree.map(np.asarray, want), tcfg)
    tmodel = tbuild(tcfg, device="cpu")
    opt = _FirstGrads(AdamW(lr=1e-3))
    step = make_train_step(tmodel, opt)
    _, metrics = step(init_train_state(tmodel, opt, init), batch)
    tloss = float(metrics["loss"])

    differ = total = worst = 0
    worst32 = 0.0
    for (path, _), got, exp in zip(tshd.leaf_paths(init), leaves(opt.grads), leaves(ref)):
        got, exp = got.detach().numpy(), exp.detach().numpy()
        assert got.dtype == exp.dtype and got.shape == exp.shape, path
        if got.dtype == np.float16:
            n, w = int(np.sum(got != exp)), int(np.abs(_ordered(got) - _ordered(exp)).max())
            differ, total, worst = differ + n, total + got.size, max(worst, w)
            line = f"  {path:40s} fp16 {n / got.size:8.2%} off, worst {w} ulps"
        else:
            e = float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))
            worst32 = max(worst32, e)
            line = f"  {path:40s} {got.dtype} worst |d| / max {e:.3e}"
        if per_leaf:
            print(line)
    share = differ / max(total, 1)
    print(f"{arch} {policy} {batch_rows}x{seq}: loss {tloss!r} (reference {float(loss)!r}); "
          f"{differ} of {total} fp16 gradient elements ({share:.2%}) off, worst {worst} ulps; "
          f"fp32 leaves worst {worst32:.3e} of their largest")
    return {"loss": tloss, "ref_loss": float(loss), "fp16_off": differ, "fp16_total": total,
            "share": share, "worst_ulps": worst, "fp32_worst": worst32}


def _share(want, got) -> float:
    want, got = np.asarray(want), got.detach().numpy()
    return float(np.mean((want.view(np.int32) != got.view(np.int32))
                         & ~(np.isnan(want) & np.isnan(got))))


def sites() -> None:
    import math

    import jax.numpy as jnp

    from repro.models import common as jc
    from repro_torch.models import common as tc

    gelu_c = math.sqrt(2.0 / math.pi)
    funcs = {  # name: (reference, torch's own, the port's)
        "exp": (jnp.exp, torch.exp, tc.xla_exp),
        "log": (jnp.log, torch.log, tc.xla_log),
        "log1p": (jnp.log1p, torch.log1p, tc.xla_log1p),
        "tanh": (jnp.tanh, torch.tanh, tc.xla_tanh),
        "logistic": (jax.nn.sigmoid, torch.sigmoid, tc.xla_sigmoid),
        "softplus": (jax.nn.softplus, torch.nn.functional.softplus, tc.xla_softplus),
        "sin": (jnp.sin, torch.sin, tc.xla_sin),
        "cos": (jnp.cos, torch.cos, tc.xla_cos),
        "silu": (jax.nn.silu, lambda t: t * torch.sigmoid(t), tc.silu),
        "gelu": (jc.gelu, lambda t: t * (0.5 * (1.0 + torch.tanh(
            gelu_c * (t + 0.044715 * (t * t * t))))), tc.gelu),
        "softcap 30": (lambda a: jc.softcap(a, 30.0), lambda t: 30.0 * torch.tanh(t / 30.0),
                       lambda t: tc.softcap(t, 30.0)),
        "softmax": (lambda a: jax.nn.softmax(a, axis=-1), lambda t: torch.softmax(t, -1),
                    lambda t: tc.xla_softmax(t, -1)),
        "logsumexp": (lambda a: jax.nn.logsumexp(a, axis=-1), lambda t: torch.logsumexp(t, -1),
                      lambda t: tc.xla_logsumexp(t, -1)),
    }
    rng = np.random.default_rng(0)
    x0 = (rng.standard_normal(1 << 20) * 8).astype(np.float32)
    for name, (jfn, tfn, pfn) in funcs.items():
        x = np.abs(x0) if name in ("log", "log1p") else x0
        x = x.reshape(1024, 1024) if name in ("softmax", "logsumexp") else x
        want, vjp = jax.jit(lambda a: jax.vjp(jfn, a))(x)
        g = rng.standard_normal(np.shape(want)).astype(np.float32)
        gwant = jax.jit(lambda a, c: jax.vjp(jfn, a)[1](c)[0])(x, g)
        row = [name]
        for fn in (tfn, pfn):
            t = torch.from_numpy(x.copy()).requires_grad_(True)
            y = fn(t)
            y.backward(torch.from_numpy(g))
            row += [_share(want, y), _share(gwant, t.grad)]
        print("site {:11s} value off: torch {:.2%}, port {:.2%}; gradient off: torch {:.2%}, "
              "port {:.2%}".format(row[0], row[1], row[3], row[2], row[4]))


def bf16_sites() -> None:
    import re

    import jax.numpy as jnp

    from repro.models import common as jc
    from repro_torch.models import common as tc

    rng = np.random.default_rng(1)
    draws = rng.standard_normal(1 << 20) * 8
    draws[:12] = [-100, -90, -89, -88.5, -88, -87.5, -87, 100, 90, 89, 88, 87]
    x = np.array(jnp.asarray(draws, jnp.bfloat16))
    g = np.array(jnp.asarray(rng.standard_normal(1 << 20), jnp.bfloat16))

    def bf16(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)

    autograd = {"silu": tc._silu16_values, "gelu": lambda t: tc._gelu16_values(t)[0]}
    for name, jfn in (("silu", jax.nn.silu), ("gelu", jc.gelu)):
        vjp = jax.jit(lambda a, b: jax.vjp(jfn, a)[1](b)[0])
        hlo = vjp.lower(x, g).compile().as_text()
        ops = "multiply|add|subtract|divide|negate|exponential|tanh"
        steps = re.findall(rf"= f32\[\d+\]\{{0\}} ({ops})\(", hlo)
        rounded = len(re.findall(r"= bf16\[\d+\]\{0\} convert\(", hlo))
        fmas = len(re.findall(r"fma|fused-multiply-add", hlo))
        want = np.asarray(jax.jit(jfn)(x)).view(np.int16)
        gwant = np.asarray(vjp(x, g))
        finite = np.isfinite(gwant.astype(np.float32))
        row = []
        for fn in (autograd[name], tc.ACTIVATIONS[name]):
            t = bf16(x).requires_grad_(True)
            y = fn(t)
            y.backward(bf16(g))
            got = t.grad.view(torch.int16).numpy()
            row += [float(np.mean(y.detach().view(torch.int16).numpy() != want)),
                    float(np.mean(got != gwant.view(np.int16))),
                    int(np.sum(finite & ~np.isfinite(t.grad.float().numpy())))]
        print(f"site bf16 {name}: XLA's gradient has {len(steps)} fp32 steps, {rounded} "
              f"rounded to bf16, {fmas} fused multiply-adds; value off: autograd {row[0]:.2%}, "
              f"port {row[3]:.2%}; gradient off: autograd {row[1]:.2%}, port {row[4]:.2%}; "
              f"non-finite where the reference is finite: autograd {row[2]}, port {row[5]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--policy", default="redmule_hfp8")
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--sites", action="store_true")
    args = ap.parse_args()
    torch.manual_seed(0)
    if args.sites:
        sites()
        bf16_sites()
    out = {a: probe(a, args.seq, args.batch, args.policy, args.leaves)
           for a in (args.arch or ARCHS)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
