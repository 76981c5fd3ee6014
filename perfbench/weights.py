"""The weights of a cell, made by the benchmark from ``--seed`` on the
device, in the format the deployment serves them in, and handed
to the program and to the plain reference alike.

Each kind of weight is one group: the same leaf of every layer stacked in
one tensor, drawn with a ``torch.Generator`` of its own (seeded from the
run's seed and the group's name) in a few large calls, so that any group
can be drawn again bit for bit. Scales follow the
program's own initialisation: 1/sqrt(fan-in) for a projection, 1/sqrt(d_ff)
for an expert's down projection, 0.02 for the embedding table and the
router, ones for the norms.

The program's parameter tree (``repro_torch.models.Transformer``) is
built from views of the groups: ``embed.table`` (V, d); per layer
``norm1.scale``, ``attn.{q,k,v,o}.w``, ``norm2.scale`` and ``ffn.{up,
gate,down}.w`` or ``moe.{router.w, up, gate, down}`` (the experts as one
(d, E*f) and one (E*f, d) matrix, column e*f + j of up being expert e's
column j); ``final_norm.scale``; ``head.w`` (d, V) when untied. An fp8
matrix is the (K, N) view of a contiguous (N, K) tensor, the K-major
layout the program serves fp8 weights in; other matrices are row-major.
"""
from __future__ import annotations

import math
import zlib

import torch

CHUNK = 1 << 27  # elements drawn per call

FORMATS = {"e4m3": torch.float8_e4m3fn, "fp16": torch.float16, "bf16": torch.bfloat16,
           "fp32": torch.float32}


def groups(cfg: dict) -> dict[str, tuple[tuple[int, ...], float, str, bool]]:
    """name -> (leaf shape (K, N) or (N,), scale (0: ones), format, stacked
    over the layers) of every weight group of a decoder configuration."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    hd = d // cfg["num_attention_heads"]
    hq, hkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    f, e = cfg["intermediate_size"], cfg.get("num_local_experts", 0)
    w = cfg["deployment"]["weight_format"]
    out = {"embed": ((v, d), 0.02, w, False),
           "norm1": ((d,), 0.0, "fp32", True),
           "q": ((d, hq), 1 / math.sqrt(d), w, True), "k": ((d, hkv), 1 / math.sqrt(d), w, True),
           "v": ((d, hkv), 1 / math.sqrt(d), w, True), "o": ((hq, d), 1 / math.sqrt(hq), w, True),
           "norm2": ((d,), 0.0, "fp32", True)}
    if e:
        out |= {"router": ((d, e), 0.02, "fp32", True),
                "up": ((d, e * f), 1 / math.sqrt(d), w, True),
                "gate": ((d, e * f), 1 / math.sqrt(d), w, True),
                "down": ((e * f, d), 1 / math.sqrt(f), w, True)}
    else:
        out |= {"up": ((d, f), 1 / math.sqrt(d), w, True),
                "gate": ((d, f), 1 / math.sqrt(d), w, True),
                "down": ((f, d), 1 / math.sqrt(f), w, True)}
    out["final_norm"] = ((d,), 0.0, "fp32", False)
    if not cfg["tie_word_embeddings"]:
        out["head"] = ((d, v), 1 / math.sqrt(d), w, False)
    return out


def _kmajor(shape, fmt: str) -> bool:
    return len(shape) == 2 and FORMATS[fmt].itemsize == 1


def draw(cfg: dict, name: str, seed: int, device) -> torch.Tensor:
    """Group ``name`` drawn from ``seed``: (L, *storage) when stacked, where
    an fp8 matrix's storage is (N, K); the same bits on every call."""
    shape, scale, fmt, stacked = groups(cfg)[name]
    store = shape[::-1] if _kmajor(shape, fmt) else shape
    full = ((cfg["num_hidden_layers"],) if stacked else ()) + tuple(store)
    out = torch.empty(full, dtype=FORMATS[fmt], device=device)
    if scale == 0.0:
        return out.fill_(1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + zlib.crc32(name.encode())) % (1 << 63))
    flat = out.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - i)
        flat[i:i + n].copy_(torch.randn(n, generator=gen, device=device).mul_(scale))
    return out


def leaf(group: torch.Tensor, cfg: dict, name: str, layer: int | None = None) -> torch.Tensor:
    """The (K, N) or (N,) leaf of ``group`` (layer ``layer`` of a stacked one)."""
    shape, _, fmt, _ = groups(cfg)[name]
    t = group if layer is None else group[layer]
    return t.T if _kmajor(shape, fmt) else t


def make(cfg: dict, seed: int, device) -> dict:
    """The program's parameter tree, views of the drawn groups."""
    drawn = {name: draw(cfg, name, seed, device) for name in groups(cfg)}

    def get(name, i=None):
        return leaf(drawn[name], cfg, name, i)

    layers = []
    for i in range(cfg["num_hidden_layers"]):
        lp = {"norm1": {"scale": get("norm1", i)},
              "attn": {k: {"w": get(k, i)} for k in ("q", "k", "v", "o")},
              "norm2": {"scale": get("norm2", i)}}
        if "router" in drawn:
            lp["moe"] = {"router": {"w": get("router", i)},
                         **{k: get(k, i) for k in ("up", "gate", "down")}}
        else:
            lp["ffn"] = {k: {"w": get(k, i)} for k in ("up", "gate", "down")}
        layers.append(lp)
    params = {"embed": {"table": get("embed")}, "layers": layers,
              "final_norm": {"scale": get("final_norm")}}
    if "head" in drawn:
        params["head"] = {"w": get("head")}
    return params

