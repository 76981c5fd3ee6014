"""Model construction of the port (counterpart of ``repro.models.registry``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.engine import Engine
from repro_torch.models.transformer import Transformer, resolve_device


def build(cfg: ModelConfig, *, device="cuda") -> Transformer:
    """The model for ``cfg`` on ``device`` (default the card; raises when
    CUDA is absent and the CPU was not asked for), under ``cfg.policy``.
    On the card every GEMM and the decode attention launch the kernels;
    on the CPU the model runs the plain path."""
    device = resolve_device(device)
    backend = "cuda" if device.type == "cuda" else "torch"
    return Transformer(cfg, engine=Engine(policy=cfg.policy, backend=backend), device=device)
