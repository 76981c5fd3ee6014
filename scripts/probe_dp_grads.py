#!/usr/bin/env python3
"""Where the JAX package's data-parallel step rounds each gradient: the
gradient of the reference's loss on one CPU device against the same on a
(2, 1) ("data", "model") mesh of two host devices, leaf by leaf.

    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python scripts/probe_dp_grads.py [--arch granite-3-8b] \\
        [--seq 16] [--mode dp|fsdp] [--policy redmule_hfp8]

Prints, for each leaf, its format, the share of its elements that differ
from the one-device gradient and the worst difference (fp16 ulps, or fp32
|d| over the leaf's largest), then the all-reduces of the compiled mesh
step with the op each sums (``dot_general``: a dW dot's fp32 result). The
batch is 4 rows of ``--seq`` tokens; ``--mode fsdp`` splits the
parameters over 'data' (``fsdp_param_specs``), ``dp`` replicates them.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import numpy as np

from repro.configs import get_config
from repro.data import for_model
from repro.distrib import sharding as shd
from repro.launch.mesh import make_mesh
from repro.models import build
from repro.models.transformer import MeshCtx
from repro.training.loop import make_loss_fn


def _ordered(x: np.ndarray) -> np.ndarray:
    i = x.view(np.int16).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFF), i)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--mode", choices=("dp", "fsdp"), default="dp")
    ap.add_argument("--policy", default="redmule_hfp8")
    args = ap.parse_args()
    if len(jax.devices()) < 2:
        raise SystemExit("needs two devices: XLA_FLAGS=--xla_force_host_platform_device_count=2")
    cfg = dataclasses.replace(get_config(args.arch, smoke=True), policy=args.policy)
    batch = jax.tree.map(np.asarray, for_model(cfg, seq_len=args.seq, global_batch=4).batch(0))
    one = build(cfg)
    params = one.init(jax.random.PRNGKey(0))

    def grad(model):
        return jax.grad(lambda p, b: make_loss_fn(model)(p, b)[0])

    want = jax.jit(grad(one))(params, batch)
    mesh = make_mesh((2, 1), ("data", "model"))
    model = build(cfg, MeshCtx(mesh=mesh, dp_axes=("data",), ep_axis="model"))
    shapes = jax.eval_shape(lambda: params)
    specs = (shd.param_specs(shapes, cfg, 1) if args.mode == "dp"
             else shd.fsdp_param_specs(shapes, ("data",), 2))
    pshard = shd.tree_shardings(specs, mesh)
    bshard = shd.tree_shardings(shd.batch_specs(jax.eval_shape(lambda: batch), ("data",)), mesh)
    step = jax.jit(grad(model), in_shardings=(pshard, bshard), out_shardings=pshard)
    got = step(params, batch)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.float16:
            worst = f"{int(np.abs(_ordered(a) - _ordered(b)).max())} fp16 ulps"
        else:
            worst = f"{float(np.abs(a - b).max() / np.abs(b).max()):.3g} of the largest"
        print(f"{jax.tree_util.keystr(path):60s} {str(a.dtype):8s} {str(a.shape):16s} "
              f"differ {np.mean(a != b):.4f}, worst {worst}")
    print("all-reduces of the mesh step:")
    for line in step.lower(params, batch).compile().as_text().splitlines():
        if " all-reduce(" in line:
            op = line.split('op_name="')[1].split('"')[0] if 'op_name="' in line else "?"
            print(f"  {line.split('=')[1].split('all-reduce(')[0].strip()[:80]} <- {op[-90:]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
