"""Architecture config registry of the port: ``--arch <id>`` resolves here.

The port covers every language model of the JAX package: the dense
granite-3-8b, chatglm3-6b, deepseek-coder-33b and gemma2-2b, the
dense-MoE granite-moe-1b-a400m (granite-3-8b's draft model) and
phi3.5-moe-42b-a6.6b, the recurrent recurrentgemma-2b (RG-LRU with
windowed local attention) and xlstm-125m (mLSTM and sLSTM), the
encoder-decoder seamless-m4t-large-v2 (stub audio frames, LayerNorm) and
the VLM internvl2-76b (stub image patches). The JAX package's
``paper_tinyml`` configs are not ported.
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


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported yet; the port knows {list(ARCH_IDS)}"
        )
    mod = _ARCHS[arch]
    return mod.SMOKE if smoke else mod.CONFIG
