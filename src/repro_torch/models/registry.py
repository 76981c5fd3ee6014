"""Model construction of the port and the canonical input specs of each
(arch x shape) cell (counterpart of ``repro.models.registry``).

The spec functions return :class:`ShapeDtype` records, the counterpart of
``jax.ShapeDtypeStruct``: no tensor is allocated. Modality frontends are
stubs, as in the reference: the VLM takes precomputed patch embeddings,
the audio model precomputed frame embeddings, both (B, n, d_model).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.configs import SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.engine import Engine
from repro_torch.models.transformer import MeshCtx, Transformer, resolve_device


def build(cfg: ModelConfig, mesh_ctx: Optional[MeshCtx] = None, *, device="cuda",
          backend: Optional[str] = None) -> Transformer:
    """The model for ``cfg`` on ``device`` (default the card; raises when
    CUDA is absent and the CPU was not asked for), under ``cfg.policy``,
    with ``mesh_ctx``'s expert parallelism for ``moe_impl="ep"`` (without
    one, "ep" computes the dense MoE, as in the reference).
    ``backend`` defaults to the device's: on the card every GEMM and the
    decode attention launch the kernels (``"cuda"``), on the CPU the model
    runs the plain path (``"torch"``); ``"torch"`` on the card runs the
    plain path there, and ``"cuda"`` without the card raises."""
    device = resolve_device(device)
    if backend is None:
        backend = "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend 'cuda' launches the kernels and needs the card")
    return Transformer(cfg, engine=Engine(policy=cfg.policy, backend=backend), device=device,
                       mesh_ctx=mesh_ctx)


def meta_params(cfg) -> dict:
    """The parameter tree of ``cfg`` on ``meta`` at full depth, from one
    unit of its block pattern (and one encoder layer): layer i is the
    unit's layer i % len(pattern), the same shapes and formats that
    ``Transformer.init`` gives it (leaves shared between layers): what the
    dry run sizes and what the specs of a rank's pieces are cut from."""
    p = len(cfg.block_pattern)
    unit = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, p),
                               n_encoder_layers=min(cfg.n_encoder_layers, 1))
    params = build(unit, device="meta", backend="torch").init(0)
    params["layers"] = [params["layers"][i % p] for i in range(cfg.n_layers)]
    if cfg.n_encoder_layers:
        params["encoder"] = params["encoder"][:1] * cfg.n_encoder_layers
    return params


class ShapeDtype(NamedTuple):
    """A tensor's shape and format without the tensor."""

    shape: tuple
    dtype: torch.dtype


def batch_shapes(cfg: ModelConfig, shape_name: str) -> dict:
    """The integers of one cell: its kind, batch and sequence (and an
    encoder-decoder's decoder length)."""
    seq, batch, kind = SHAPES[shape_name]
    out = {"kind": kind, "batch": batch, "seq": seq}
    if cfg.family == "audio":
        out["dec_seq"] = max(seq // cfg.enc_dec_ratio, 1)
    return out


def train_input_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Each model input's (shape, dtype) for a batch of ``seq`` positions:
    tokens, a VLM's stub patch embeddings, an encoder-decoder's stub frames
    (its decoder then holds ``seq // enc_dec_ratio`` tokens)."""
    specs = {"tokens": ShapeDtype((batch, seq), torch.int32)}
    if cfg.family == "vlm":
        specs["vis_embeds"] = ShapeDtype((batch, cfg.n_frontend_tokens, cfg.d_model),
                                         torch.bfloat16)
    if cfg.family == "audio":
        specs["tokens"] = ShapeDtype((batch, max(seq // cfg.enc_dec_ratio, 1)), torch.int32)
        specs["frames"] = ShapeDtype((batch, seq, cfg.d_model), torch.bfloat16)
    return specs


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return ShapeDtype(tuple(tree.shape), tree.dtype)
    return ShapeDtype((), torch.int64)  # the cache's host position


def decode_input_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Specs of a static-batch decode step: one new token a row, and the
    cache of ``Transformer.init_cache(batch, cache_len)`` (with
    ``cache_len`` cross positions for an encoder-decoder), made on the
    ``meta`` device."""
    model = build(cfg, device="meta", backend="torch")
    cross = cache_len if cfg.is_encoder_decoder else 0
    return {"tokens": ShapeDtype((batch, 1), torch.int32),
            "cache": _spec_tree(model.init_cache(batch, cache_len, cross_len=cross))}


def make_batch(cfg: ModelConfig, batch: int, seq: int, *,
               generator: Optional[torch.Generator] = None, device="cuda") -> dict:
    """A concrete random batch (for smoke runs and the examples): tokens
    uniform in [0, vocab), the stub frontends standard normal, with the
    shapes and dtypes of :func:`train_input_specs`. Drawn from ``generator``
    (default: seed 0 on ``device``) on the generator's device and moved to
    ``device`` (the card by default; raises without CUDA unless the CPU
    was asked for). ``torch.Generator`` draws other numbers than
    ``jax.random`` from one seed, so only shapes, dtypes and ranges match
    the reference's batch."""
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, (shape, dtype) in train_input_specs(cfg, batch, seq).items():
        if dtype == torch.int32:
            t = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=gen.device,
                              dtype=torch.int32)
        else:
            t = torch.randn(shape, generator=gen, device=gen.device).to(dtype)
        out[name] = t.to(device)
    return out
