"""Architecture config registry of the port: ``--arch <id>`` resolves here.

The first slice of the port covers the dense decoder granite-3-8b only;
every other architecture of the JAX package raises.
"""
from __future__ import annotations

from repro_torch.configs import granite3_8b
from repro_torch.configs.base import ModelConfig

_ARCHS = {"granite-3-8b": granite3_8b}

ARCH_IDS = tuple(_ARCHS)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported yet; the port knows {list(ARCH_IDS)}"
        )
    mod = _ARCHS[arch]
    return mod.SMOKE if smoke else mod.CONFIG
