"""gemma2-2b [dense]: 26L d2304 8H GQA kv=4 d_ff=9216 vocab=256000.

Alternating local (window 4096) / global attention, logit softcapping.
[arXiv:2408.00118]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304,
    n_heads=8, n_kv_heads=4, d_ff=9216, vocab_size=256000,
    head_dim=256, block_pattern=("attn_local", "attn"),
    sliding_window=4096, attn_softcap=50.0, final_softcap=30.0,
    act="geglu", tie_embeddings=True, embed_scale=True,
    remat="block",
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    block_pattern=("attn_local", "attn"), sliding_window=16,
    attn_softcap=50.0, final_softcap=30.0, act="geglu", embed_scale=True,
)
