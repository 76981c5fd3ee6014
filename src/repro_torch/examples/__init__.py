"""The reference's examples as modules of the port, each with
``main(argv=None)``: on the card by default (the GEMM-Op kernel on every
engine call, the SIMT schedule for the semiring pairs), on the CPU's plain
path with ``--device cpu``, and without a card and without ``--device cpu``
they raise. Each keeps its reference script's asserts.

  PYTHONPATH=src python -m repro_torch.examples.quickstart
  PYTHONPATH=src python -m repro_torch.examples.train_tinyml
  PYTHONPATH=src python -m repro_torch.examples.graph_shortest_paths
  PYTHONPATH=src python -m repro_torch.examples.viterbi_decode
  PYTHONPATH=src python -m repro_torch.examples.serve_decode --arch granite-3-8b
  PYTHONPATH=src python -m repro_torch.examples.train_lm --smoke --steps 2 --seq 16 --batch 4
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.models.transformer import resolve_device


def device_args(description: str, argv=None, extra=None):
    """Parse ``--device`` (default ``cuda``) and any ``extra(parser)``
    options; returns (args, device, engine backend)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return args, device, "cuda" if device.type == "cuda" else "torch"


def tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)
