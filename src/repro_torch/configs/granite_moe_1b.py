"""granite-moe-1b-a400m [moe]: 24L d1024 16H GQA kv=8 d_ff=512 vocab=49155,
32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]

It shares granite-3-8b's vocabulary, which makes it the zoo's draft model
for granite-3-8b under speculative decoding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=512, vocab_size=49155,
    n_experts=32, top_k=8, moe_impl="dense", act="swiglu",
    tie_embeddings=True,
    remat="block",
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256,
    n_experts=8, top_k=4, moe_impl="dense", act="swiglu",
)
