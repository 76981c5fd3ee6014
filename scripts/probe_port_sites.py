#!/usr/bin/env python3
"""Where the port's train-step forward and backward first part from the
JAX package's, site by site, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/probe_port_sites.py \\
        [--arch gemma2-2b] [--layers 2] [--seq 16] [--batch 4] \\
        [--policy redmule_hfp8] [--all]

Both models' sites are tapped at the same module functions (the
reference's through ``jax.debug.callback`` in a ``jax.custom_vjp``
identity, the port's through an autograd identity), named in the order the
forward calls them: the embedding's rows, every norm, every dense layer's
output (q, k, v, o, gate, up, down), the attention and FFN outputs, the
activation and the logits. The reference's loss and gradient are taken
under ``jax.jit(jax.value_and_grad(...))`` as ``probe_port_grads.py``
takes them, the port's by its one-process train step, from the same
parameters and batch. Each site prints the share of its forward value's
bits and of its cotangent's bits that differ, forward sites in call order
and then cotangents in the order the backward reaches them; the first
site that parts is named on the last line but one. The taps must not move
the reference's compiled rounding: the script also takes the reference's
gradients without them and prints whether they are the same bits.
``--all`` prints every site, not only those up to the first that parts
in each direction. The last line is one JSON object of the findings.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import jax
import numpy as np
import torch

from repro.configs import get_config
from repro.data import for_model
from repro.models import attention as jattn
from repro.models import build
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.training.loop import make_loss_fn
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.optim import AdamW
from repro_torch.training import init_train_state, make_train_step

# (module attribute, site label): the functions tapped on both sides.
SITES = (("embed_apply", "embed"), ("norm_apply", "norm"), ("dense_apply", "dense"),
         ("unembed_apply", "unembed"), ("gelu", "gelu"), ("silu", "silu"),
         ("softcap", "softcap"))
MODULE_SITES = (("apply", "attention"), ("apply", "ffn"))


class Recorder:
    """Forward values and cotangents by site name; names from call order."""

    def __init__(self):
        self.fwd, self.bwd, self.order, self.count = {}, {}, [], {}

    def name(self, label: str) -> str:
        n = self.count.get(label, 0)
        self.count[label] = n + 1
        name = f"{label}#{n}"
        self.order.append(name)
        return name


def _jax_tap(rec: Recorder, label: str):
    name = rec.name(label)

    def put(store, key):
        return lambda v: store.__setitem__(key, np.asarray(v))

    @jax.custom_vjp
    def tap(x):
        return x

    def fwd(x):
        jax.debug.callback(put(rec.fwd, name), x)
        return x, None

    def bwd(_, g):
        jax.debug.callback(put(rec.bwd, name), g)
        return (g,)

    tap.defvjp(fwd, bwd)
    return tap


class _TorchTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rec, name):
        rec.fwd[name] = x.detach().clone()
        ctx.rec, ctx.name = rec, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.rec.bwd[ctx.name] = g.detach().clone()
        return g, None, None


def _tapped(fn, rec: Recorder, label: str, jax_side: bool):
    def first(out, tap):
        if isinstance(out, tuple):
            return (tap(out[0]),) + out[1:]
        return tap(out)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if jax_side:
            return first(out, _jax_tap(rec, label))
        name = rec.name(label)
        return first(out, lambda t: _TorchTap.apply(t, rec, name)
                     if torch.is_tensor(t) and t.is_floating_point() else t)

    return wrapped


@contextlib.contextmanager
def tapping(rec: Recorder, jax_side: bool):
    common, attn, ffn = (jcommon, jattn, jffn) if jax_side else (tcommon, tattn, tffn)
    saved = []
    for attr, label in SITES:
        if hasattr(common, attr):
            saved.append((common, attr, getattr(common, attr)))
            setattr(common, attr, _tapped(getattr(common, attr), rec, label, jax_side))
    for mod, (attr, label) in zip((attn, ffn), MODULE_SITES):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, _tapped(getattr(mod, attr), rec, label, jax_side))
    try:
        yield rec
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _bits(a: np.ndarray) -> np.ndarray:
    iv = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize]
    return a.view(iv)


def _share(want, got) -> float | None:
    """The share of elements whose bits differ (NaNs equal); None where the
    two sides' shapes or formats part."""
    want = np.asarray(want)
    got = got.detach().float().numpy() if got.dtype == torch.bfloat16 else got.detach().numpy()
    if want.dtype != got.dtype and str(want.dtype) == "bfloat16":
        want = want.astype(np.float32)
    if want.size != got.size or want.dtype != got.dtype:
        return None
    want, got = want.reshape(-1), got.reshape(-1)
    diff = _bits(want) != _bits(got)
    if want.dtype.kind == "f":
        diff &= ~(np.isnan(want) & np.isnan(got))
    return float(diff.mean()) if diff.size else 0.0


def probe(arch: str, layers: int, seq: int, batch_rows: int, policy: str, show_all: bool):
    cfg = dataclasses.replace(get_config(arch, smoke=True), policy=policy, n_layers=layers)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), policy=policy, n_layers=layers)
    batch = jax.tree.map(np.asarray, for_model(cfg, seq_len=seq,
                                               global_batch=batch_rows).batch(0))
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))

    def grads():
        return jax.jit(jax.value_and_grad(lambda p, b: make_loss_fn(model)(p, b)[0]))(
            params, batch)

    _, plain_grads = grads()
    jrec = Recorder()
    with tapping(jrec, jax_side=True):
        loss, want = grads()
    same = all(np.array_equal(_bits(np.asarray(a)), _bits(np.asarray(b)))
               for a, b in zip(jax.tree.leaves(plain_grads), jax.tree.leaves(want)))

    init = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    tmodel = tbuild(tcfg, device="cpu")
    opt = AdamW(lr=1e-3)
    step = make_train_step(tmodel, opt)
    trec = Recorder()
    with tapping(trec, jax_side=False):
        _, metrics = step(init_train_state(tmodel, opt, init), batch)
    print(f"{arch} {layers} layers {policy} {batch_rows}x{seq}: loss {float(metrics['loss'])!r} "
          f"(reference {float(loss)!r}); the taps leave the reference's gradients "
          f"{'the same bits' if same else 'MOVED'}")

    first = {}
    for kind, jstore, tstore, order in (
            ("forward", jrec.fwd, trec.fwd, jrec.order),
            ("cotangent", jrec.bwd, trec.bwd, list(reversed(jrec.order)))):
        for name in order:
            if name not in jstore or name not in tstore:
                side = "the port" if name in jstore else "the reference"
                print(f"  {kind:9s} {name:14s} not recorded on {side}")
                continue
            share = _share(jstore[name], tstore[name])
            shape = tuple(np.shape(jstore[name]))
            label = "layout differs" if share is None else f"{share:8.2%} of bits off"
            if show_all or kind not in first:
                print(f"  {kind:9s} {name:14s} {str(shape):18s} {label}")
            if share and kind not in first:
                first[kind] = name
    print(f"first site apart: forward {first.get('forward')}, cotangent "
          f"{first.get('cotangent')}")
    return {"loss": float(metrics["loss"]), "ref_loss": float(loss), "taps_neutral": same,
            "first_forward": first.get("forward"), "first_cotangent": first.get("cotangent")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--policy", default="redmule_hfp8")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()
    torch.manual_seed(0)
    out = probe(args.arch, args.layers, args.seq, args.batch, args.policy, args.all)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
