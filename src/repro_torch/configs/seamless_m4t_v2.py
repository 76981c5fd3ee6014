"""seamless-m4t-large-v2 [audio]: 24L d1024 16H kv=16 d_ff=8192 vocab=256206.

Encoder-decoder; the speech frontend is a STUB: the data pipeline and the
serve launcher provide random frame embeddings (B, S, d) to the encoder;
the text decoder cross-attends. Train shapes: decoder length = seq_len // enc_dec_ratio.
[arXiv:2308.11596]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=8192, vocab_size=256206,
    n_encoder_layers=24, enc_dec_ratio=4, act="gelu", norm="layernorm",
    tie_embeddings=True,
    remat="block",
)

SMOKE = ModelConfig(
    name="seamless-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    n_encoder_layers=2, enc_dec_ratio=4, act="gelu", norm="layernorm",
)
