"""phi3.5-moe-42b-a6.6b [moe]: 32L d4096 32H GQA kv=8 d_ff=6400 vocab=32064,
16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, moe_impl="dense", act="swiglu",
    tie_embeddings=False,
    remat="block",
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
    n_experts=4, top_k=2, moe_impl="dense", act="swiglu",
    tie_embeddings=False,
)
