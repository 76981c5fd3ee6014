"""Parameters of the JAX reference, turned into the port's parameter dict.

The reference's ``Transformer.init`` stacks the repeated layer unit on a
leading axis (``decoder.units.b0``, made by ``jax.vmap``); the port keeps
one dict per layer. The caller hands over the reference's tree with every
leaf already a numpy array (``jax.tree.map(np.asarray, params)``), so this
module needs neither JAX nor the reference package. ml_dtypes leaves
(bfloat16, float8_e4m3fn, float8_e5m2) travel bit for bit through a
same-width unsigned-integer view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import kmajor_weight

# ml_dtypes' names for the formats numpy has no native type for.
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy (or ml_dtypes) array as a torch tensor of the same format."""
    a = np.ascontiguousarray(a)
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is None:
        return torch.from_numpy(a.copy()).to(device)
    np_bits, torch_dtype = view
    return torch.from_numpy(a.view(np_bits).copy()).view(torch_dtype).to(device)


def params_from_jax(tree, cfg: ModelConfig, device="cpu") -> dict:
    """The port's parameters from the reference's ``Transformer.init`` tree
    (numpy leaves) for a dense decoder with block pattern ("attn",)."""
    if tuple(cfg.block_pattern) != ("attn",) or tree["decoder"]["rem"]:
        raise NotImplementedError("params_from_jax covers the ('attn',) decoder stack")
    unit = tree["decoder"]["units"]["b0"]

    def t(a):
        return tensor_from_numpy(a, device)

    def weight(a):
        return {"w": kmajor_weight(t(a))}

    def layer(i):
        return {
            "norm1": {"scale": t(unit["norm1"]["scale"][i])},
            "attn": {n: weight(unit["attn"][n]["w"][i]) for n in ("q", "k", "v", "o")},
            "norm2": {"scale": t(unit["norm2"]["scale"][i])},
            "ffn": {n: weight(unit["ffn"][n]["w"][i]) for n in ("up", "gate", "down")},
        }

    return {
        "embed": {"table": t(tree["embed"]["table"])},
        "layers": [layer(i) for i in range(cfg.n_layers)],
        "final_norm": {"scale": t(tree["final_norm"]["scale"])},
    }
