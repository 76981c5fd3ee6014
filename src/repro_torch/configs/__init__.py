"""Architecture config registry of the port: ``--arch <id>`` resolves here.

The port covers every language model of the JAX package: the dense
granite-3-8b, chatglm3-6b, deepseek-coder-33b and gemma2-2b, the
dense-MoE granite-moe-1b-a400m (granite-3-8b's draft model) and
phi3.5-moe-42b-a6.6b, the recurrent recurrentgemma-2b (RG-LRU with
windowed local attention) and xlstm-125m (mLSTM and sLSTM), the
encoder-decoder seamless-m4t-large-v2 (stub audio frames, LayerNorm) and
the VLM internvl2-76b (stub image patches). ``paper_tinyml`` holds the
paper's TinyML GEMM tables (ResNet8, MobileNetV2, TinyTransformer).
"""
from __future__ import annotations

from repro_torch.configs import (
    chatglm3_6b,
    deepseek_coder_33b,
    gemma2_2b,
    granite3_8b,
    granite_moe_1b,
    internvl2_76b,
    phi35_moe,
    recurrentgemma_2b,
    seamless_m4t_v2,
    xlstm_125m,
)
from repro_torch.configs.base import ModelConfig

_ARCHS = {
    "granite-3-8b": granite3_8b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "chatglm3-6b": chatglm3_6b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "gemma2-2b": gemma2_2b,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "recurrentgemma-2b": recurrentgemma_2b,
    "xlstm-125m": xlstm_125m,
    "seamless-m4t-large-v2": seamless_m4t_v2,
    "internvl2-76b": internvl2_76b,
}

ARCH_IDS = tuple(_ARCHS)

# Input-shape set shared by all LM-family archs: name -> (seq_len, batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported yet; the port knows {list(ARCH_IDS)}"
        )
    mod = _ARCHS[arch]
    return mod.SMOKE if smoke else mod.CONFIG


def cell_is_runnable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """Whether (arch x shape) is a runnable dry-run cell: ``long_500k``
    needs sub-quadratic context."""
    if shape == "long_500k" and not cfg.supports_500k:
        return False, (
            "long_500k needs sub-quadratic context; full-attention arch skipped"
        )
    return True, ""
