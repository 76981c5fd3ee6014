"""Parameters of the JAX reference, turned into the port's parameter dict.

The reference's ``Transformer.init`` stacks the repeated unit of its block
pattern on a leading axis (``decoder.units.b{j}``, made by ``jax.vmap``)
and keeps the remainder layers apart; the port keeps one dict per layer.
The caller hands over the reference's tree with every leaf already a numpy
array (``jax.tree.map(np.asarray, params)``), so this
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
    (numpy leaves), for every family the port covers, of any block
    pattern. A recurrent layer's ``cell`` is carried across as
    it is: rglru's ``in_x``, ``in_gate``, ``conv_w``, ``gate_a``,
    ``gate_x``, ``lam`` and ``out``, mlstm's ``qkv``, ``ifg``, ``ogate``
    and ``out``, slstm's ``wx``, ``r`` (4, H, hd, hd) and ``out``, in
    their formats (E4M3 under fp8 parameters). The reference stacks its units, ``decoder.units.b{j}``
    holding the j-th layer of every unit on a leading axis, then keeps the
    ``n_layers % len(pattern)`` remainder layers as ``decoder.rem.r{i}``;
    unit u's layer j becomes port layer ``u * len(pattern) + j`` and
    remainder layer i the ``i``-th after the units. An untied ``head`` is
    carried across like every weight. An MoE layer's router stays fp32
    (d, E); its experts' ``up`` and ``gate`` (E, d, f) become (d, E*f) and
    ``down`` (E, f, d) becomes (E*f, d), the shapes the reference's
    ``apply_dense`` reshapes them to in every call (``models/moe.py``
    stores them so). Every norm carries its leaves (LayerNorm's ``bias``
    beside the scale). An encoder-decoder's ``encoder`` stack (pattern
    ("attn",)) becomes the list ``encoder``, its decoder layers keep
    ``norm_x`` and ``cross``, and ``enc_final_norm``, ``enc_proj`` and
    the VLM's ``vis_proj`` come across as they are."""

    def t(a):
        return tensor_from_numpy(a, device)

    def weight(a):
        return {"w": kmajor_weight(t(a))}

    def norm(p):
        return {n: t(a) for n, a in p.items()}

    def layer(p):
        out = {"norm1": norm(p["norm1"])}
        if "attn" in p:
            out["attn"] = {n: weight(p["attn"][n]["w"]) for n in ("q", "k", "v", "o")}
        else:
            # A recurrent cell: its projections ({"w"} dicts) as weights, its
            # other leaves (rglru's conv_w and lam, slstm's r) as they are.
            out["cell"] = {n: weight(v["w"]) if isinstance(v, dict) else t(v)
                           for n, v in p["cell"].items()}
        if "cross" in p:
            out["norm_x"] = norm(p["norm_x"])
            out["cross"] = {n: weight(p["cross"][n]["w"]) for n in ("q", "k", "v", "o")}
        if "moe" in p:
            out["moe"] = moe_params_from_jax(p["moe"], device)
        elif "ffn" in p:
            out["ffn"] = {n: weight(w["w"]) for n, w in p["ffn"].items()}
        if "norm2" in p:
            out["norm2"] = norm(p["norm2"])
        return out

    def stack(st, n_layers, pattern):
        n_units, n_rem = divmod(n_layers, len(pattern))
        if len(st["rem"]) != n_rem:
            raise ValueError(f"the tree has {len(st['rem'])} remainder layers, the config "
                             f"{n_rem}")
        layers = [layer(_map_leaves(st["units"][f"b{j}"], lambda a: a[u]))
                  for u in range(n_units) for j in range(len(pattern))]
        return layers + [layer(st["rem"][f"r{i}"]) for i in range(n_rem)]

    out = {
        "embed": {"table": t(tree["embed"]["table"])},
        "layers": stack(tree["decoder"], cfg.n_layers, tuple(cfg.block_pattern)),
        "final_norm": norm(tree["final_norm"]),
    }
    if "encoder" in tree:
        out["encoder"] = stack(tree["encoder"], cfg.n_encoder_layers, ("attn",))
        out["enc_final_norm"] = norm(tree["enc_final_norm"])
    for name in ("head", "enc_proj", "vis_proj"):
        if name in tree:
            out[name] = weight(tree[name]["w"])
    return out


def _map_leaves(tree, fn):
    """``fn`` on every array of a nested dict of arrays."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def moe_params_from_jax(p, device="cpu") -> dict:
    """One MoE layer of the reference's ``moe.init`` (numpy leaves) in the
    port's layout: router (d, E) fp32, ``up``/``gate`` (E, d, f) as
    (d, E*f) with expert e in columns e*f .. e*f + f - 1, ``down`` (E, f, d)
    as (E*f, d); fp8 weights K-major, as every weight of the port."""
    e, d, f = p["up"].shape
    return {
        "router": {"w": tensor_from_numpy(p["router"]["w"], device)},
        **{n: kmajor_weight(tensor_from_numpy(p[n].transpose(1, 0, 2).reshape(d, e * f), device))
           for n in ("up", "gate")},
        "down": kmajor_weight(tensor_from_numpy(p["down"].reshape(e * f, d), device)),
    }
