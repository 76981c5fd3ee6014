"""xlstm-125m [ssm]: 12L d768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks.

Attention-free; mLSTM matrix memory + sLSTM scalar memory alternate 1:1.
O(1) decode state -> runs long_500k. [arXiv:2405.04517]

Note: the published 125M config uses projection-factor block sandwiches; our
assembler folds them into the cell in/out projections, instantiating 78M
params at the same (12L, d768, 4H) skeleton — wiring simplification recorded
in docs/DESIGN.md, cell math (stabilized exponential gating) faithful.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    block_pattern=("mlstm", "slstm"), supports_500k=True,
    tie_embeddings=True,
    remat="block",
)

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256,
    block_pattern=("mlstm", "slstm"), supports_500k=True,
)
