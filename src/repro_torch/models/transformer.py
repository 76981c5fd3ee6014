"""The model of the port: a decoder of attention layers, recurrent layers
or both, each with a dense or dense-MoE FFN, behind an optional encoder
(the encoder-decoder family) or image prefix (the VLM family), for
training and for continuous-batching and static-batch serving
(counterpart of ``repro.models.transformer.Transformer``).

Parameters are a plain dict of tensors: ``embed.table``, one dict per
layer under ``layers`` (the reference stacks them on a leading axis for
``lax.scan``; the port runs a Python loop over a list), and
``final_norm.scale``, and ``head.w`` (d, V) when the embeddings are
untied. A layer holds ``attn`` or a recurrent ``cell``, then ``ffn``, or
``moe`` when the config has experts (``models/moe.py``); a config with
``d_ff == 0`` (xlstm) gives its layers no FFN and no second norm.

Layer ``i`` has the kind ``block_pattern[i % len(block_pattern)]``, the
order the reference's stacked units and remainder layers give: ``attn``
(global) or ``attn_local`` (``cfg.sliding_window``), each with the
config's attention softcap, or a recurrent cell: ``rglru``
(``models/rglru.py``), ``mlstm`` or ``slstm`` (``models/xlstm.py``).
gemma's embeddings are scaled by sqrt(d_model) (``cfg.embed_scale``; the
reference keys it on the name), and ``cfg.final_softcap`` caps the fp32
logits. With ``cfg.remat == "block"`` the training forward recomputes
each block in the backward pass (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint`` of its scan body does; the forward returns
the sum of the MoE layers' aux losses. ``cfg.norm`` is RMSNorm or
LayerNorm (scale and bias) for every norm of the model.

The encoder-decoder family (seamless-m4t; ``cfg.n_encoder_layers > 0``)
runs its stub audio frames (B, Se, d) through ``enc_proj``, an encoder of
``n_encoder_layers`` non-causal attention layers and ``enc_final_norm``;
each decoder layer then adds a cross-attention block (``norm_x``,
``cross`` {q, k, v, o}) between its self-attention and its FFN. The VLM
family (internvl2) puts its stub image patches (B, P, d) through
``vis_proj`` ahead of the token embeddings and drops them from the final
hidden states. Both serve through the static-batch path only, as in the
reference: ``init_state_store`` raises for them, and with it ``Server``.

Serving state: an attention layer keeps its KV token pool, a recurrent
layer ``{"state": rows}``, one fp32 (num_slots, ...) tensor per state
leaf. A prefill chunk gathers each row's state at its slot (the init
state where the chunk starts at position 0, so a recycled slot forgets
its last request), runs the masked scan and commits the active rows; a
decode step commits the active rows in place, which the decode graph
captures.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import E4M3, as_dtype, cast
from repro_torch.distrib import sharding
from repro_torch.distrib import tensor_parallel as tpl
from repro_torch.engine import Engine
from repro_torch.models import attention, common, ffn, moe, rglru, xlstm
from repro_torch.models.attention import AttnConfig, PagedInfo
from repro_torch.obs import span

Params = dict[str, Any]

ATTN_KINDS = {"attn", "attn_local"}
RECURRENT_KINDS = {"rglru", "mlstm", "slstm"}


class CBProfile(NamedTuple):
    """What the serving StateStore must provision for a model: KV pages
    (any attention layer), a window when every attention layer is
    ``attn_local`` (out-of-window pages are recycled and admission reserves
    only a window's worth), and state rows (any recurrent layer: the
    prefix cache is then off)."""

    needs_kv_pages: bool
    kv_window: int | None
    has_state_rows: bool = False


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """The distribution context of the training step's layers, which run
    explicit collectives (``distrib/tensor_parallel.py``, the MoE's expert
    parallelism): a :class:`~repro_torch.launch.mesh.Mesh` and the roles
    of its axes. ``tp_axis`` None is FSDP: the whole mesh is
    data-parallel (``dp_axes`` every axis), every parameter is split over
    it and gathered per use. ``zero3`` splits the TP pieces over the data
    axes too, gathered per use likewise."""

    mesh: Any = None
    dp_axes: Any = None  # batch-sharding axes, e.g. ("pod", "data")
    ep_axis: str | None = None  # expert-parallel axis, e.g. "model"
    tp_axis: str | None = "model"  # tensor-parallel axis; None = FSDP
    zero3: bool = False

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return self.mesh.shape[self.tp_axis]


class _Cell(NamedTuple):
    """A recurrent kind's functions and config."""

    init: Any
    apply: Any  # the scan: (params, x, cfg, engine, state=, lengths=) -> (y, state)
    decode: Any  # one step: (params, x, state, cfg, engine) -> (y, state)
    init_state: Any  # (batch, cfg, device) -> state
    cfg: Any


def _map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a params tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, sp) for v, sp in zip(tree, specs)]
    return fn(tree, specs)


def _row_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (B,) mask broadcast over a (B, ...) state leaf."""
    return mask.reshape(mask.shape + (1,) * (leaf.dim() - 1))


class Transformer:
    """On the ``"cuda"`` backend decode always runs the paged flash-decode
    kernel. On ``"torch"`` it gathers the pages through the page table and
    runs the engine's online softmax (the reference's XLA path), or, with
    ``fused_decode=True``, runs the paged kernel's plain version (the
    kernel's semantics, as a reference for it). The flag is for the plain
    backend only and raises on ``"cuda"``."""

    def __init__(self, cfg: ModelConfig, *, engine: Engine, device,
                 fused_decode: bool = False, mesh_ctx: MeshCtx | None = None):
        if (cfg.family not in ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
                or not set(cfg.block_pattern) <= ATTN_KINDS | RECURRENT_KINDS
                or cfg.norm not in ("rmsnorm", "layernorm")):
            raise NotImplementedError(
                f"{cfg.name}: the port covers the families dense, moe, hybrid, ssm, audio and "
                "vlm, the layers 'attn', 'attn_local', 'rglru', 'mlstm' and 'slstm', and "
                "RMSNorm and LayerNorm"
            )
        self.cfg = cfg
        self.engine = engine
        self.mesh_ctx = mesh_ctx or MeshCtx()
        self.tp = tpl.tp_of(self.mesh_ctx)  # the training path's TP axis, or None
        self._use_specs = None  # FSDP/ZeRO-3 per-use gathers, made on first use
        self.policy = engine.policy
        self.device = torch.device(device)
        self.dtype = E4M3 if cfg.fp8_params else self.policy.compute
        self.kv_dtype = as_dtype(cfg.kv_cache_dtype)
        if fused_decode and engine.backend == "cuda":
            raise ValueError("fused_decode is for the plain backend; the 'cuda' backend "
                             "always decodes through the paged kernel")
        self.fused_decode = engine.backend == "cuda" or fused_decode
        self.pattern = tuple(cfg.block_pattern)
        self.kinds = [self.pattern[i % len(self.pattern)] for i in range(cfg.n_layers)]
        self.layer_cfgs = [self.attn_cfg(kind) if kind in ATTN_KINDS else None
                           for kind in self.kinds]
        # The encoder's self-attention and the decoder's cross-attention.
        self.enc_cfg = self.attn_cfg("attn") if cfg.is_encoder_decoder else None
        xl_cfg = xlstm.XLSTMConfig(cfg.d_model, cfg.n_heads)
        self.cells = {
            "rglru": _Cell(rglru.init, rglru.apply_scan, rglru.apply_decode, rglru.init_state,
                           rglru.RGLRUConfig(cfg.d_model, cfg.d_rnn)),
            "mlstm": _Cell(xlstm.mlstm_init, xlstm.mlstm_apply, xlstm.mlstm_decode,
                           xlstm.mlstm_init_state, xl_cfg),
            "slstm": _Cell(xlstm.slstm_init, xlstm.slstm_apply, xlstm.slstm_decode,
                           xlstm.slstm_init_state, xl_cfg),
        }
        self.embed_scale = math.sqrt(cfg.d_model) if cfg.embed_scale else 1.0
        self.moe_cfg = moe.MoEConfig(
            cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff, cfg.capacity_factor,
            cfg.moe_impl, cfg.act,
        ) if cfg.is_moe else None
        if self.moe_cfg is not None:
            moe.check_impl(self.moe_cfg)

    def attn_cfg(self, kind: str) -> AttnConfig:
        """The attention config of a layer of ``kind``: ``attn_local``
        layers carry the sliding window, both kinds the softcap."""
        cfg = self.cfg
        return AttnConfig(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, rope_fraction=cfg.rope_fraction,
            softcap=cfg.attn_softcap,
            window=cfg.sliding_window if kind == "attn_local" else None,
        )

    # -- parameters ---------------------------------------------------------
    def init(self, seed: int) -> Params:
        """Random parameters from ``seed``, made on the model's device (the
        draws differ from the reference's ``jax.random``; tests copy the
        reference's parameters with :func:`repro_torch.convert.params_from_jax`)."""
        cfg, dev = self.cfg, self.device
        # torch.Generator has no meta device, and a CPU one would draw every
        # number: a meta model (the dry run's, which allocates nothing)
        # takes shapes alone.
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        d = cfg.d_model
        params: Params = {
            "embed": common.embed_init(gen, cfg.vocab_size, d, self.dtype, dev),
            "layers": [self._init_layer(gen, kind, acfg, cfg.is_encoder_decoder)
                       for kind, acfg in zip(self.kinds, self.layer_cfgs)],
            "final_norm": common.norm_init(d, dev, cfg.norm),
        }
        if not cfg.tie_embeddings:
            params["head"] = common.dense_init(gen, d, cfg.vocab_size, self.dtype, dev)
        if cfg.family == "vlm":
            params["vis_proj"] = common.dense_init(gen, d, d, self.dtype, dev)
        if cfg.is_encoder_decoder:
            params["encoder"] = [self._init_layer(gen, "attn", self.enc_cfg, False)
                                 for _ in range(cfg.n_encoder_layers)]
            params["enc_final_norm"] = common.norm_init(d, dev, cfg.norm)
            params["enc_proj"] = common.dense_init(gen, d, d, self.dtype, dev)
        return params

    def _init_layer(self, gen, kind: str, acfg, cross: bool) -> Params:
        cfg, dev = self.cfg, self.device
        layer = {"norm1": common.norm_init(cfg.d_model, dev, cfg.norm)}
        if acfg is not None:
            layer["attn"] = attention.init(gen, cfg.d_model, acfg, self.dtype, dev)
        else:
            cell = self.cells[kind]
            layer["cell"] = cell.init(gen, cell.cfg, self.dtype, dev)
        if cross:
            layer["norm_x"] = common.norm_init(cfg.d_model, dev, cfg.norm)
            layer["cross"] = attention.init(gen, cfg.d_model, self.enc_cfg, self.dtype, dev)
        if cfg.d_ff > 0:
            layer["norm2"] = common.norm_init(cfg.d_model, dev, cfg.norm)
            if cfg.is_moe:
                layer["moe"] = moe.init(gen, self.moe_cfg, self.dtype, dev)
            else:
                layer["ffn"] = ffn.init(gen, cfg.d_model, cfg.d_ff, self.dtype, dev, cfg.act)
        return layer

    # -- blocks ---------------------------------------------------------------
    def _norm(self, p, x):
        return common.norm_apply(p, x, self.cfg.norm)

    def _block(self, i: int, lp, x, positions, engine: Engine, *, store=None,
               paged: PagedInfo | None = None, decode: bool = False, aux: bool = False,
               enc=None):
        """Layer ``i``: its attention or recurrent cell, its cross-attention
        (an encoder-decoder's; ``enc`` = (encoder output or None, its
        positions)), then its FFN. ``store`` is the layer's serving state
        (the KV pool with ``paged``, the ring buffer or state rows of
        static-batch serving without it; None in training). Returns (x, the
        MoE aux loss or None)."""
        tp = self.tp if store is None else None  # serving runs on one rank
        if store is None:
            lp = self._use(lp, ("layers", i))
        h = self._norm(lp["norm1"], x)
        acfg = self.layer_cfgs[i]
        if acfg is not None:
            with span("attn"):
                h = attention.apply(lp["attn"], h, positions, acfg, engine,
                                    pool=store if paged is not None else None, paged=paged,
                                    cache=store if paged is None else None, tp=tp)
        else:
            h = self._recurrent(self.cells[self.kinds[i]], lp["cell"], h, engine, store, paged,
                                decode)
        x = x + h
        if "cross" in lp:
            x = x + self._cross(lp["cross"], self._norm(lp["norm_x"], x), positions, engine,
                                store, enc, tp)
        aux_loss = None
        if "norm2" in lp:
            h2 = self._norm(lp["norm2"], x)
            if "moe" in lp:
                mc = self.mesh_ctx
                h2, aux_loss = moe.apply(lp["moe"], h2, self.moe_cfg, engine, aux=aux,
                                         mesh=mc.mesh, ep_axis=mc.ep_axis, tp=tp,
                                         dp_axes=mc.dp_axes if store is None else None)
            else:
                with span("ffn"):
                    h2 = ffn.apply(lp["ffn"], h2, self.cfg.act, engine, tp=tp,
                                   d_ff=self.cfg.d_ff)
            x = x + h2
        return x, aux_loss

    # -- FSDP and ZeRO-3 -------------------------------------------------------
    def _use(self, tree, path: tuple):
        """``tree`` (a layer's, or the whole model's) with every leaf that
        the mesh context splits over the data axes gathered whole for this
        use (``tensor_parallel.use_param``); leaves already whole pass."""
        specs = self.use_specs()
        if specs is None:
            return tree
        for k in path:
            specs = specs[k]
        mesh = self.mesh_ctx.mesh
        return _map2(lambda t, sp: t if sp is None or tuple(t.shape) == sp[1]
                     else tpl.use_param(t, sp[0], mesh, summed=sp[2]), tree, specs)

    def use_specs(self):
        """The data-axis part of every leaf's executed spec where some leaf
        has one (FSDP, ZeRO-3), else None: a tree of (spec, whole shape,
        whether its uses sum its gradient: ``summed_in_use``), None for a
        leaf held whole over the data axes."""
        mc = self.mesh_ctx
        if mc.mesh is None or not (mc.tp_axis is None or mc.zero3):
            return None
        if self._use_specs is None:
            from repro_torch.models.registry import meta_params

            full = meta_params(self.cfg)
            specs = sharding.executed_param_specs(full, self.cfg, mc)
            dp = tuple(mc.dp_axes or ())
            mesh = mc.mesh
            out = []
            for (path, t), sp in zip(sharding.leaf_paths(full), sharding.spec_leaves(specs)):
                on_dp = sharding.over_axes(sp, dp)
                # The gathered leaf: whole over the data axes, TP's piece else.
                shape = tuple(n if q is not None else n // mesh.axis_size(sharding._names(p))
                              for n, p, q in zip(t.shape, sp, on_dp))
                out.append(None if all(p is None for p in on_dp) else
                           (on_dp, shape, tpl.summed_in_use(path)))
            it = iter(out)
            self._use_specs = sharding.map_with_path(lambda _p, _t: next(it), full)
        return self._use_specs

    def use_top(self, params):
        """``params`` with the leaves outside the layers (embeddings, head,
        final norm, frontends) gathered for this step under FSDP/ZeRO-3;
        the layers' leaves are gathered in their blocks."""
        if self.use_specs() is None:
            return params
        return {k: v if k in ("layers", "encoder") else self._use(v, (k,))
                for k, v in params.items()}

    def _cross(self, p, h, positions, engine: Engine, store, enc, tp=None):
        """The cross-attention block over the encoder's output (the
        reference's ``_apply_block``). Given the encoder output, its K and
        V are projected, stored rounded to the KV format in the static
        cache's ``cross_k``/``cross_v`` (a prefill), and attended in the
        compute format unrounded; without it (a decode step) they are read
        back from the cache."""
        enc_out, enc_pos = enc
        compute = engine.policy.compute
        if enc_out is None:
            ck, cv = store["cross_k"].to(compute), store["cross_v"].to(compute)
        else:
            acfg = self.enc_cfg
            shape = enc_out.shape[:2] + (-1, acfg.head_dim)
            kv_cols = acfg.n_kv_heads * acfg.head_dim
            ck = tpl.linear(enc_out, p["k"], engine, tp, kv_cols).reshape(shape)
            cv = tpl.linear(enc_out, p["v"], engine, tp, kv_cols).reshape(shape)
            if store is not None:
                store["cross_k"].copy_(cast(ck, store["cross_k"].dtype))
                store["cross_v"].copy_(cast(cv, store["cross_v"].dtype))
            ck, cv = ck.to(compute), cv.to(compute)
        return attention.apply(p, h, positions, self.enc_cfg, engine, cross_kv=(ck, cv, enc_pos),
                               tp=tp)

    def _enc_block(self, j: int, lp, x, positions, engine: Engine):
        """Encoder layer ``j``: non-causal self-attention, then its FFN."""
        lp = self._use(lp, ("encoder", j))
        x = x + attention.apply(lp["attn"], self._norm(lp["norm1"], x), positions, self.enc_cfg,
                                engine, causal=False, tp=self.tp)
        if "norm2" in lp:
            x = x + ffn.apply(lp["ffn"], self._norm(lp["norm2"], x), self.cfg.act, engine,
                              tp=self.tp, d_ff=self.cfg.d_ff)
        return x

    def _encode(self, params, frames: torch.Tensor, engine: Engine, remat: bool = False):
        """The encoder on stub frame embeddings (B, Se, d): ``enc_proj`` on
        the frames in the compute format, the encoder layers, then
        ``enc_final_norm``. Returns (output, positions (Se,))."""
        d = self.cfg.d_model
        x = tpl.whole_linear(frames.to(engine.policy.compute), params["enc_proj"], engine,
                             self.tp, d)
        pos = torch.arange(frames.shape[1], device=x.device)
        for j, lp in enumerate(params["encoder"]):
            if remat:
                x = checkpoint(self._enc_block, j, lp, x, pos, engine, use_reentrant=False)
            else:
                x = self._enc_block(j, lp, x, pos, engine)
        return self._norm(params["enc_final_norm"], x), pos

    def _frontends(self, params, batch, x, engine: Engine, remat: bool = False):
        """The stub modality inputs of ``batch``: the VLM's ``vis_proj``
        patches (B, P, d) put ahead of the token embeddings ``x``, and the
        encoder-decoder's ``frames`` through the encoder. Returns (x, enc),
        enc = (encoder output, positions) or None."""
        if self.cfg.family == "vlm":
            vis = tpl.whole_linear(batch["vis_embeds"].to(engine.policy.compute),
                                   params["vis_proj"], engine, self.tp, self.cfg.d_model)
            x = torch.cat([vis, x], dim=1)
        enc = (self._encode(params, batch["frames"], engine, remat)
               if self.cfg.is_encoder_decoder else None)
        return x, enc

    def _recurrent(self, cell: _Cell, p, h, engine: Engine, store, paged, decode: bool):
        """One recurrent cell under every mode (the reference's
        ``_recurrent_block``). Training (no store): the scan. Static batch
        (no ``paged``): a prefill scans from the init state, a decode step
        carries every batch row; the new state replaces ``store["state"]``.
        Serving: a decode step runs every slot and commits the active rows
        in place; a prefill chunk gathers each row's state at its slot (the
        init state where it starts at position 0), runs the masked scan
        and commits the active rows."""
        if store is None:
            return cell.apply(p, h, cell.cfg, engine, tp=self.tp)[0]
        rows = store["state"]
        if paged is None:
            out, store["state"] = (cell.decode(p, h, rows, cell.cfg, engine) if decode
                                   else cell.apply(p, h, cell.cfg, engine))
            return out
        if decode:
            out, new = cell.decode(p, h, rows, cell.cfg, engine)
            for k, leaf in rows.items():
                leaf.copy_(torch.where(_row_mask(paged.active, leaf), new[k], leaf))
            return out
        old = {k: leaf.index_select(0, paged.slots) for k, leaf in rows.items()}
        init = cell.init_state(h.shape[0], cell.cfg, h.device)
        fresh = paged.starts == 0
        state = {k: torch.where(_row_mask(fresh, v), init[k], v) for k, v in old.items()}
        out, new = cell.apply(p, h, cell.cfg, engine, state=state, lengths=paged.lengths)
        for k, leaf in rows.items():
            leaf.index_copy_(0, paged.slots,
                             torch.where(_row_mask(paged.active, leaf), new[k], old[k]))
        return out

    def _run_stack(self, params, x, positions, pools, paged: PagedInfo, decode: bool = False):
        for i, (lp, pool) in enumerate(zip(params["layers"], pools)):
            x, _ = self._block(i, lp, x, positions, self.engine, store=pool, paged=paged,
                               decode=decode)
        return x

    def embed(self, params, tokens: torch.Tensor, engine: Engine | None = None) -> torch.Tensor:
        """The rows of the embedding table in the compute format, times
        sqrt(d_model) under ``cfg.embed_scale`` (the scale rounded to that format first, as
        the reference's weakly typed product rounds it; a host scalar, so
        the decode graph captures no copy)."""
        compute = (engine or self.engine).policy.compute
        table = params["embed"]["table"]
        if self.tp is not None and table.shape[0] != self.cfg.vocab_size:
            x = tpl.vocab_embed(table, tokens, self.tp, compute)
        else:
            x = tpl.embed_rows(table, tokens).to(compute)
        if self.embed_scale != 1.0:
            x = x * float(torch.tensor(self.embed_scale, dtype=compute))
        return x

    def logits(self, params, h: torch.Tensor, engine: Engine | None = None) -> torch.Tensor:
        """fp32 logits through the tied table or the untied head, then the
        final softcap, in the reference's order. Under TP with the vocab
        split, this rank's block of the vocab's logits (column-parallel)."""
        eng = engine or self.engine
        w = params["embed"]["table"].T if self.cfg.tie_embeddings else params["head"]["w"]
        with span("head"):
            if self.tp is not None and w.shape[1] != self.cfg.vocab_size:
                out = tpl.column_linear(h, {"w": w}, eng, self.tp)
            elif self.cfg.tie_embeddings:
                out = common.unembed_apply(params["embed"], h, eng)
            else:
                out = common.dense_apply(params["head"], h, eng)
            return common.softcap(out.float(), self.cfg.final_softcap)

    # -- training -------------------------------------------------------------
    def forward(self, params, batch, *, engine: Engine | None = None):
        """Teacher-forced forward. batch: {"tokens": (B, S) int64}, with
        "vis_embeds" (B, P, d) for the VLM and "frames" (B, Se, d) for the
        encoder-decoder. Returns (hidden (B, S, d) of the tokens after the
        final norm, aux loss): the sum of the MoE layers' load-balancing
        losses, an fp32 zero without experts. Recurrent layers run their
        scans. ``engine`` overrides the model's engine for this call (the
        step factories' plumbing)."""
        eng = engine or self.engine
        remat = self.cfg.remat == "block"
        tokens = batch["tokens"]
        params = self.use_top(params)
        x, enc = self._frontends(params, batch, self.embed(params, tokens, eng), eng, remat)
        positions = torch.arange(x.shape[1], device=tokens.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lp in enumerate(params["layers"]):
            if remat:
                x, layer_aux = checkpoint(self._block, i, lp, x, positions, eng, aux=True,
                                          enc=enc, use_reentrant=False)
            else:
                x, layer_aux = self._block(i, lp, x, positions, eng, aux=True, enc=enc)
            if layer_aux is not None:
                aux = aux + layer_aux
        h = self._norm(params["final_norm"], x)
        return h[:, x.shape[1] - tokens.shape[1]:], aux

    # -- serving state --------------------------------------------------------
    def cb_profile(self) -> CBProfile:
        """The reference's rule, read from the attention layers alone: KV
        pages when there is one, a window only when every one is
        ``attn_local`` (recurrentgemma's are; gemma2 alternates, so it gets
        none and keeps every page of a request), and state rows when a
        recurrent layer is present (xlstm has no attention: no pages)."""
        attn_kinds = [k for k in self.pattern if k in ATTN_KINDS]
        window = None
        if attn_kinds and all(k == "attn_local" for k in attn_kinds) and self.cfg.sliding_window:
            window = self.cfg.sliding_window
        return CBProfile(needs_kv_pages=bool(attn_kinds), kv_window=window,
                         has_state_rows=any(k in RECURRENT_KINDS for k in self.pattern))

    def supports_cb(self) -> bool:
        """Continuous batching covers the decoder-only families; the
        encoder-decoder and VLM families need their modality inputs and
        stay static-batch, as in the reference."""
        return not self.cfg.is_encoder_decoder and self.cfg.family not in ("vlm", "audio")

    def init_state_store(self, num_slots: int, num_pages: int, page_size: int):
        """Each layer's serving state: an attention layer's flat KV token
        pool (num_pages * page_size slots, shaped by its own attention
        config; page 0 is the serving layer's null page), a recurrent
        layer's ``{"state": rows}``, one fp32 (num_slots, ...) tensor per
        state leaf. Raises ``NotImplementedError`` where
        :meth:`supports_cb` is false."""
        if not self.supports_cb():
            raise NotImplementedError(
                f"{self.cfg.name}: continuous batching covers the decoder-only families "
                f"(family={self.cfg.family}); use the static-batch path (generate_static)")
        n_tok = num_pages * page_size
        return [attention.init_paged_pool(n_tok, acfg, self.kv_dtype, self.device)
                if acfg is not None else
                {"state": self.cells[kind].init_state(num_slots, self.cells[kind].cfg,
                                                      self.device)}
                for kind, acfg in zip(self.kinds, self.layer_cfgs)]

    def prefill_cb(self, params, tokens: torch.Tensor, pools, page_row: torch.Tensor,
                   slot, start, length, *, page_size: int, chunked: bool = False,
                   active: torch.Tensor | None = None) -> torch.Tensor:
        """One prefill chunk of one slot, or (with a rank-2 ``page_row``) one
        chunk for each of P slots at once; the pools are updated in place.

        Single-row form. tokens: (1, Tb) right-padded; page_row: (P,) the
        slot's page ids; slot: its state row; start, length: host integers,
        the absolute position of the first token (0 resets the slot's state
        rows) and the valid tokens. With ``chunked`` the layers also gather
        the earlier chunks' K/V back through the page table and attend over
        [gathered | fresh]. Pad rows write the null page and are masked as
        keys. Returns logits (1, V) at the last valid token.

        Multi-row form (always chunked). tokens: (P, Tb); page_row: (P, Pps);
        slot, start, length: (P,) tensors; ``active``: (P,) bool marking
        the real rows. Each row gathers its own pages and appends its own
        chunk, so a row's math is that of the single-row chunked step;
        inactive pad rows write the null page. Returns logits (P, V) at each
        row's last valid token."""
        if page_row.dim() == 2:
            if not chunked:
                raise ValueError("multi-row prefill_cb is always chunked (each row gathers its "
                                 "own committed K/V through its page row); pass chunked=True")
            return self._prefill_cb_batched(params, tokens, pools, page_row, slot, start,
                                            length, active, page_size=page_size)
        b, s = tokens.shape
        dev = tokens.device
        tok = torch.arange(s, dtype=torch.int64, device=dev)
        pos = start + tok
        valid = tok < length
        page_idx = (pos // page_size).clamp(0, page_row.shape[0] - 1)
        write_idx = torch.where(valid, page_row.long()[page_idx] * page_size + pos % page_size, 0)
        k_pos = torch.where(valid, pos, attention.POS_SENTINEL)[None]
        read_idx = None
        if chunked:
            read_idx = self._read_idx(page_row[None], page_size)
            lpos = torch.arange(read_idx.shape[1], device=dev)[None]
            read_pos = torch.where(lpos < start, lpos, attention.POS_SENTINEL)
            k_pos = torch.cat([read_pos, k_pos], dim=1)
        # repro: allow[RPR106] slot, start and length are host ints in the single-row form
        row = lambda v: torch.full((1,), int(v), dtype=torch.int64, device=dev)  # noqa: E731
        paged = PagedInfo(write_idx=write_idx, k_pos=k_pos, read_idx=read_idx,
                          page_size=page_size, chunked=chunked, slots=row(slot),
                          starts=row(start), lengths=row(length),
                          active=torch.ones((1,), dtype=torch.bool, device=dev))
        x = self.embed(params, tokens)
        x = self._run_stack(params, x, pos[None].expand(b, s), pools, paged)
        x = self._norm(params["final_norm"], x)
        return self.logits(params, x[:, length - 1:length])[:, 0]

    def _prefill_cb_batched(self, params, tokens, pools, page_rows, slots, starts, lengths,
                            active, *, page_size: int) -> torch.Tensor:
        """Multi-row body of :meth:`prefill_cb` (see its docstring)."""
        x = self._chunk_rows(params, tokens, pools, page_rows, slots, starts, lengths, active,
                             page_size=page_size)
        b, s = tokens.shape
        last = (lengths.long() - 1).clamp(0, s - 1)
        x_last = torch.gather(x, 1, last[:, None, None].expand(b, 1, x.shape[-1]))
        return self.logits(params, x_last)[:, 0]

    def verify_cb(self, params, tokens: torch.Tensor, pools, page_table: torch.Tensor,
                  seq_lens: torch.Tensor, lengths: torch.Tensor, active: torch.Tensor, *,
                  page_size: int, commit: bool) -> torch.Tensor:
        """The slot-batched multi-token verify step of speculative decoding:
        the multi-row chunked :meth:`prefill_cb` over every slot, with
        logits at every position.

        tokens: (S, T) each slot's row [last committed token, draft_1 ..
        draft_k], right-padded; page_table: (S, P); seq_lens: (S,) tokens
        committed per slot (the first fresh position); lengths: (S,) valid
        tokens per row (0 for rows sitting the round out); active: (S,).
        Each row gathers its committed K/V through its page row and attends
        causally over [gathered | fresh]. Fresh K/V are written through the
        page table; what lies past the prefix the host later commits is
        never read back as valid (the masks stop at ``seq_lens``) and is
        rewritten by the next step, so rejected drafts need no undo.
        Returns logits (S, T, V): ``[:, i]`` is the distribution after token
        i, which judges draft i + 1.

        ``commit`` is the reference's switch for recurrent state rows: each
        row continues from its slot's state and scans exactly ``lengths``
        tokens, and only ``commit=True`` writes the active rows back. The
        verify pass runs with ``commit=False`` (every state row stays as it
        was, bit for bit); the commit pass re-runs the same step with
        ``lengths`` clamped to accepted + 1, which scans the accepted
        tokens in and rewrites their K/V with the same shapes, so through
        the same GEMM schedules."""
        slots = torch.arange(tokens.shape[0], device=tokens.device)
        x = self._chunk_rows(params, tokens, pools, page_table, slots, seq_lens, lengths,
                             active, page_size=page_size, commit=commit)
        return self.logits(params, x)

    def _chunk_rows(self, params, tokens, pools, page_rows, slots, starts, lengths, active, *,
                    page_size: int, commit: bool = True) -> torch.Tensor:
        """The stack over (P, Tb) rows, each a chunk of its own slot's
        sequence from ``starts``: writes the fresh K/V, commits the active
        rows' state rows (with ``commit``) and returns the final hidden
        states (P, Tb, d) after the final norm."""
        b, s = tokens.shape
        dev = tokens.device
        act = (torch.ones((b,), dtype=torch.bool, device=dev) if active is None
               else active.bool())
        starts, lengths = starts.long(), lengths.long()
        tok = torch.arange(s, dtype=torch.int64, device=dev)
        pos = starts[:, None] + tok[None, :]  # (P, Tb) absolute positions
        valid = (tok[None, :] < lengths[:, None]) & act[:, None]
        page_idx = (pos // page_size).clamp(0, page_rows.shape[1] - 1)
        page = torch.gather(page_rows.long(), 1, page_idx)
        write_idx = torch.where(valid, page * page_size + pos % page_size, 0).reshape(b * s)
        fresh_pos = torch.where(valid, pos, attention.POS_SENTINEL)
        read_idx = self._read_idx(page_rows, page_size)
        lpos = torch.arange(read_idx.shape[1], device=dev)[None]
        read_pos = torch.where(lpos < starts[:, None], lpos, attention.POS_SENTINEL)
        paged = PagedInfo(write_idx=write_idx, k_pos=torch.cat([read_pos, fresh_pos], dim=1),
                          read_idx=read_idx, page_size=page_size, chunked=True,
                          slots=slots.long(), starts=starts, lengths=lengths,
                          active=act if commit else torch.zeros_like(act))
        x = self.embed(params, tokens)
        x = self._run_stack(params, x, pos, pools, paged)
        return self._norm(params["final_norm"], x)

    @staticmethod
    def _read_idx(page_rows: torch.Tensor, page_size: int) -> torch.Tensor:
        """(B, P * page_size) flat pool indices of each row's pages in
        position order."""
        offs = torch.arange(page_size, device=page_rows.device)
        return (page_rows.long()[:, :, None] * page_size + offs).reshape(page_rows.shape[0], -1)

    def decode_cb(self, params, tokens: torch.Tensor, pools, page_table: torch.Tensor,
                  seq_lens: torch.Tensor, active: torch.Tensor, *,
                  page_size: int) -> torch.Tensor:
        """One-token decode of every slot. tokens: (S, 1); page_table: (S, P);
        seq_lens: (S,) the new token's position; active: (S,) bool. Inactive
        rows write the null page, keep their state rows and give discarded
        logits. Returns (S, V)."""
        n_slots = tokens.shape[0]
        dev = tokens.device
        lens = seq_lens.long()
        slots = torch.arange(n_slots, device=dev)
        cur = (lens // page_size).clamp(max=page_table.shape[1] - 1)
        cur_page = page_table.long()[slots, cur]
        write_idx = torch.where(active, cur_page * page_size + lens % page_size, 0)
        read_idx = k_pos = None
        if not self.fused_decode:
            read_idx = self._read_idx(page_table, page_size)
            lpos = torch.arange(read_idx.shape[1], device=dev)[None]
            k_pos = torch.where(lpos <= lens[:, None], lpos, attention.POS_SENTINEL)
        paged = PagedInfo(
            write_idx=write_idx, k_pos=k_pos, read_idx=read_idx, pages=page_table,
            seq_lens=seq_lens, active=active, page_size=page_size,
            fused=self.fused_decode,
        )
        x = self.embed(params, tokens)
        x = self._run_stack(params, x, lens[:, None], pools, paged, decode=True)
        x = self._norm(params["final_norm"], x)
        return self.logits(params, x)[:, 0]


    # -- static-batch serving (ring-buffer cache) -----------------------------
    def init_cache(self, batch: int, max_len: int, cross_len: int = 0) -> dict:
        """The cache of static-batch serving: a ring buffer an attention
        layer, of ``max_len`` positions (a local layer's of at most its
        window, as the reference allocates it; a VLM's ``max_len`` counts
        its image prefix), a recurrent layer's state a batch row, and the
        batch's shared position. With ``cross_len`` (an encoder-decoder's
        frames) each layer also holds its cross-attention K/V (B,
        cross_len, Hkv, hd) in the KV format, at positions ``enc_pos``."""
        layers = []
        for kind, acfg in zip(self.kinds, self.layer_cfgs):
            if acfg is not None:
                c = attention.init_cache(batch, min(max_len, acfg.window or max_len), acfg,
                                         self.kv_dtype, self.device)
            else:
                c = {"state": self.cells[kind].init_state(batch, self.cells[kind].cfg,
                                                          self.device)}
            if cross_len:
                shape = (batch, cross_len, self.enc_cfg.n_kv_heads, self.enc_cfg.head_dim)
                c["cross_k"] = torch.zeros(shape, dtype=self.kv_dtype, device=self.device)
                c["cross_v"] = torch.zeros(shape, dtype=self.kv_dtype, device=self.device)
            layers.append(c)
        return {"pos": 0, "layers": layers,
                "enc_pos": torch.arange(max(cross_len, 1), device=self.device)}

    def prefill(self, params, batch, cache: dict) -> torch.Tensor:
        """Run the prompt through the decoder, filling the cache in place.
        batch: {"tokens": (B, S)}, with the VLM's "vis_embeds" or the
        encoder-decoder's "frames" (the cache's ``cross_len`` frames).
        Returns logits (B, 1, V) at the last position."""
        tokens = batch["tokens"]
        x, enc = self._frontends(params, batch, self.embed(params, tokens), self.engine)
        positions = cache["pos"] + torch.arange(x.shape[1], device=tokens.device)
        for i, (lp, c) in enumerate(zip(params["layers"], cache["layers"])):
            x, _ = self._block(i, lp, x, positions, self.engine, store=c, enc=enc)
        x = self._norm(params["final_norm"], x)
        cache["pos"] += x.shape[1]
        return self.logits(params, x[:, -1:])

    def decode_step(self, params, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """One-token decode of the whole batch. tokens: (B, 1). Returns
        logits (B, 1, V); the cache is updated in place (an
        encoder-decoder's cross K/V are read from it)."""
        x = self.embed(params, tokens)
        positions = cache["pos"] + torch.arange(1, device=tokens.device)
        enc = (None, cache["enc_pos"]) if self.cfg.is_encoder_decoder else None
        for i, (lp, c) in enumerate(zip(params["layers"], cache["layers"])):
            x, _ = self._block(i, lp, x, positions, self.engine, store=c, decode=True, enc=enc)
        x = self._norm(params["final_norm"], x)
        cache["pos"] += 1
        return self.logits(params, x)


def resolve_device(device) -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU, and an error, not a silent CPU run, when CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return device

