"""internvl2-76b [vlm]: 80L d8192 64H GQA kv=8 d_ff=28672 vocab=128256.

InternViT frontend is a STUB: the data pipeline and the serve launcher
provide 256 random patch embeddings per sample as a prefix to the LM backbone (Llama3-70B dims).
[arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=28672, vocab_size=128256,
    n_frontend_tokens=256, act="swiglu", tie_embeddings=False,
    rope_theta=500000.0,
    remat="block",
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    n_frontend_tokens=8, act="swiglu", tie_embeddings=False,
)
