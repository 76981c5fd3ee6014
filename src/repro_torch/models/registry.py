"""Model construction of the port (counterpart of ``repro.models.registry``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.engine import Engine
from repro_torch.models.transformer import Transformer, resolve_device


def build(cfg: ModelConfig, *, device="cuda", backend: Optional[str] = None) -> Transformer:
    """The model for ``cfg`` on ``device`` (default the card; raises when
    CUDA is absent and the CPU was not asked for), under ``cfg.policy``.
    ``backend`` defaults to the device's: on the card every GEMM and the
    decode attention launch the kernels (``"cuda"``), on the CPU the model
    runs the plain path (``"torch"``); ``"torch"`` on the card runs the
    plain path there, and ``"cuda"`` without the card raises."""
    device = resolve_device(device)
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend 'cuda' launches the kernels and needs the card")
    return Transformer(cfg, engine=Engine(policy=cfg.policy, backend=backend), device=device)


def input_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Each model input's (shape, dtype) for a batch of ``seq`` positions, as
    the reference's ``train_input_specs`` gives them: tokens, a VLM's stub
    patch embeddings, an encoder-decoder's stub frames (its decoder then
    holds ``seq // enc_dec_ratio`` tokens)."""
    shapes = {"tokens": ((batch, seq), torch.int32)}
    if cfg.family == "vlm":
        shapes["vis_embeds"] = ((batch, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio":
        shapes["tokens"] = ((batch, max(seq // cfg.enc_dec_ratio, 1)), torch.int32)
        shapes["frames"] = ((batch, seq, cfg.d_model), torch.bfloat16)
    return shapes


def make_batch(cfg: ModelConfig, batch: int, seq: int, *,
               generator: Optional[torch.Generator] = None, device="cuda") -> dict:
    """A concrete random batch (for smoke runs and the examples): tokens
    uniform in [0, vocab), the stub frontends standard normal, with the
    shapes and dtypes of :func:`input_shapes`. Drawn from ``generator``
    (default: seed 0 on ``device``) on the generator's device and moved to
    ``device`` (the card by default; raises without CUDA unless the CPU
    was asked for). ``torch.Generator`` draws other numbers than
    ``jax.random`` from one seed, so only shapes, dtypes and ranges match
    the reference's batch."""
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, (shape, dtype) in input_shapes(cfg, batch, seq).items():
        if dtype == torch.int32:
            t = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=gen.device,
                              dtype=torch.int32)
        else:
            t = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
        out[name] = t.to(device)
    return out
