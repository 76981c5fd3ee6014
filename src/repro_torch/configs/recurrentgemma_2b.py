"""recurrentgemma-2b [hybrid]: 26L d2560 10H GQA kv=1 d_ff=7680 vocab=256000.

RG-LRU recurrence + local attention, 2 recurrent : 1 attention, window 2048.
Bounded state -> runs long_500k. [arXiv:2402.19427]

The reference scales the embedding rows by sqrt(d_model) because "gemma"
is in the name; the port's configs say so with ``embed_scale``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000,
    head_dim=256, block_pattern=("rglru", "rglru", "attn_local"),
    sliding_window=2048, d_rnn=2560, act="geglu", supports_500k=True,
    tie_embeddings=True, embed_scale=True,
    remat="block",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=256, head_dim=16,
    block_pattern=("rglru", "rglru", "attn_local"), sliding_window=16,
    d_rnn=64, act="geglu", supports_500k=True, embed_scale=True,
)
