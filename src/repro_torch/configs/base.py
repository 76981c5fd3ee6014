"""Model configuration dataclass: a copy of ``repro.configs.base``.

The port keeps its own copy so that it imports nothing of the JAX package.
Each architecture file next to this module exposes ``CONFIG`` (the exact
published dims) and ``SMOKE`` (a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # Per-layer kinds, repeating over the depth: "attn", "attn_local",
    # "mlstm", "slstm", "rglru". Remainder layers (n_layers % len(pattern))
    # are instantiated unstacked.
    block_pattern: tuple = ("attn",)

    # Attention details
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # chatglm 2d-RoPE: 0.5
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # for "attn_local" layers

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "dense"  # dense | ep
    capacity_factor: float = 1.25

    # Encoder-decoder (audio family)
    n_encoder_layers: int = 0
    # decoder tokens per encoder frame ratio (train shapes): dec_len = S // r
    enc_dec_ratio: int = 4

    # Frontend stubs (vlm / audio): number of prefix embeddings supplied by
    # input_specs() instead of a modality tower.
    n_frontend_tokens: int = 0

    # Recurrent dims
    d_rnn: int = 0  # rglru width (0 -> d_model)

    # Misc
    norm: str = "rmsnorm"
    act: str = "swiglu"
    tie_embeddings: bool = True
    supports_500k: bool = False  # sub-quadratic context handling

    # Precision / engine
    policy: str = "tpu_bf16"
    backend: str = "xla"  # the JAX engine backend; the port takes its own
    kv_cache_dtype: str = "bf16"  # "e4m3" enables the paper's fp8 storage
    fp8_params: bool = False  # store weight matrices in E4M3 (paper's
    # fp8-storage/16-bit-compute split applied to parameters; halves
    # weight HBM reads — the decode-path optimization in §Perf)
    remat: str = "none"  # none | block (activation checkpoint each block)

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        n_dec = self.n_layers
        kinds = [
            self.block_pattern[i % len(self.block_pattern)] for i in range(n_dec)
        ]
        for kind in kinds:
            if kind in ("attn", "attn_local"):
                attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
            elif kind == "mlstm":
                attn = d * d * 3 + d * d * 2  # qkv + ogate/out
            elif kind == "slstm":
                attn = d * d * 4 + 4 * self.n_heads * hd * hd + d * d
            elif kind == "rglru":
                r = self.d_rnn
                attn = d * r * 2 + 2 * r * r + r * d
            else:
                raise ValueError(kind)
            if self.is_moe:
                ff = self.n_experts * (3 * d * f) + d * self.n_experts
            elif f > 0:
                n_mats = 3 if self.act in ("swiglu", "geglu") else 2
                ff = n_mats * d * f
            else:
                ff = 0
            total += attn + ff
        if self.is_encoder_decoder:
            # encoder blocks + decoder cross-attention
            attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
            n_mats = 3 if self.act in ("swiglu", "geglu") else 2
            total += self.n_encoder_layers * (attn + n_mats * d * f)
            total += n_dec * attn  # cross-attn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full_ff = self.n_layers * (self.n_experts * 3 * d * f)
        act_ff = self.n_layers * (self.top_k * 3 * d * f)
        return self.param_count() - full_ff + act_ff
