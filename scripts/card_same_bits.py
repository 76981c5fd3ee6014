#!/usr/bin/env python3
"""One train-step loss and gradient per (arch, policy) on the card, hashed,
so that two checkouts can be compared bit for bit (SMOKE configs, seed 0
parameters, 2 x 64 tokens from a fixed generator; fp32, redmule_hfp8 and
the two bf16-compute policies tpu_bf16 and tpu_hfp8, or the policies
named as arguments). Equal lines mean the two checkouts' card paths
compute the same function.

    PYTHONPATH=src python scripts/card_same_bits.py [POLICY ...]
    PYTHONPATH=<older checkout>/src python scripts/card_same_bits.py [POLICY ...]

Needs a card; prints "arch policy loss hash" a line.
"""
import dataclasses
import hashlib
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.core.tree import leaves, tree_map
from repro_torch.models import build
from repro_torch.training import make_loss_fn

ARCHS = ("granite-3-8b", "gemma2-2b", "recurrentgemma-2b", "granite-moe-1b-a400m",
         "chatglm3-6b", "xlstm-125m")
POLICIES = tuple(sys.argv[1:]) or ("fp32", "redmule_hfp8", "tpu_bf16", "tpu_hfp8")
for arch in ARCHS:
    for policy in POLICIES:
        cfg = dataclasses.replace(get_config(arch, smoke=True), policy=policy)
        model = build(cfg, device="cuda")
        params = model.init(0)
        live = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda", generator=gen)
        loss, _ = make_loss_fn(model)(live, {"tokens": tokens})
        ls = [p for p in leaves(live) if p.requires_grad]
        grads = torch.autograd.grad(loss, ls, allow_unused=True)
        h = hashlib.sha256(loss.detach().float().cpu().numpy().tobytes())
        for g in grads:
            if g is not None:
                h.update(g.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        print(arch, policy, f"{loss.item():.9g}", h.hexdigest()[:16], flush=True)
print(torch.cuda.get_device_name(0), file=sys.stderr)
