"""chatglm3-6b [dense]: 28L d4096 32H GQA kv=2 d_ff=13696 vocab=65024.

RoPE applied to half the head dim (2d/partial rotary), GQA. [arXiv:2406.12793]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=65024,
    rope_fraction=0.5, act="swiglu", tie_embeddings=False,
    remat="block",
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    rope_fraction=0.5, act="swiglu", tie_embeddings=False,
)
