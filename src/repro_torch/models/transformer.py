"""The decoder-only transformer of the port, dense or with a dense-MoE FFN,
for training and for continuous-batching serving (counterpart of
``repro.models.transformer.Transformer``).

Parameters are a plain dict of tensors: ``embed.table``, one dict per
layer under ``layers`` (the reference stacks them on a leading axis for
``lax.scan``; the port runs a Python loop over a list), and
``final_norm.scale``, and ``head.w`` (d, V) when the embeddings are
untied. A layer holds ``ffn``, or ``moe`` when the config has experts
(``models/moe.py``; serving only so far: MoE training raises).

Layer ``i`` has the kind ``block_pattern[i % len(block_pattern)]``, the
order the reference's stacked units and remainder layers give: ``attn``
(global) or ``attn_local`` (``cfg.sliding_window``), each with the
config's attention softcap, and every path takes the layer's own
attention config. gemma2's embeddings are scaled by sqrt(d_model)
(``cfg.embed_scale``; the reference keys it on the name), and
``cfg.final_softcap`` caps the fp32 logits. With ``cfg.remat == "block"`` the training forward
recomputes each block in the backward pass (``torch.utils.checkpoint``),
as the reference's ``jax.checkpoint`` of its scan body does. Other
families (recurrent, encoder-decoder, VLM, LayerNorm) raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import E4M3, as_dtype
from repro_torch.engine import Engine
from repro_torch.models import attention, common, ffn, moe
from repro_torch.models.attention import AttnConfig, PagedInfo

Params = dict[str, Any]

ATTN_KINDS = {"attn", "attn_local"}


class CBProfile(NamedTuple):
    """What the serving StateStore must provision for a model."""

    needs_kv_pages: bool
    kv_window: int | None
    has_state_rows: bool = False


class Transformer:
    """On the ``"cuda"`` backend decode always runs the paged flash-decode
    kernel. On ``"torch"`` it gathers the pages through the page table and
    runs the engine's online softmax (the reference's XLA path), or, with
    ``fused_decode=True``, runs the paged kernel's plain version (the
    kernel's semantics, as a reference for it). The flag is for the plain
    backend only and raises on ``"cuda"``."""

    def __init__(self, cfg: ModelConfig, *, engine: Engine, device,
                 fused_decode: bool = False):
        if (cfg.family not in ("dense", "moe") or not set(cfg.block_pattern) <= ATTN_KINDS
                or cfg.is_encoder_decoder or cfg.norm != "rmsnorm"):
            raise NotImplementedError(
                f"{cfg.name}: the port covers the dense decoder-only family and its "
                "dense-MoE variant (layers 'attn' and 'attn_local', RMSNorm) so far"
            )
        self.cfg = cfg
        self.engine = engine
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
        self.layer_cfgs = [self.attn_cfg(kind) for kind in self.kinds]
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
        gen = torch.Generator(device=dev).manual_seed(seed)
        params: Params = {
            "embed": common.embed_init(gen, cfg.vocab_size, cfg.d_model, self.dtype, dev),
            "layers": [],
            "final_norm": common.norm_init(cfg.d_model, dev),
        }
        for acfg in self.layer_cfgs:
            params["layers"].append({
                "norm1": common.norm_init(cfg.d_model, dev),
                "attn": attention.init(gen, cfg.d_model, acfg, self.dtype, dev),
                "norm2": common.norm_init(cfg.d_model, dev),
                **({"moe": moe.init(gen, self.moe_cfg, self.dtype, dev)} if cfg.is_moe
                   else {"ffn": ffn.init(gen, cfg.d_model, cfg.d_ff, self.dtype, dev,
                                         cfg.act)}),
            })
        if not cfg.tie_embeddings:
            params["head"] = common.dense_init(gen, cfg.d_model, cfg.vocab_size, self.dtype, dev)
        return params

    # -- blocks ---------------------------------------------------------------
    def _block(self, lp, x, positions, engine: Engine, acfg: AttnConfig, pool=None,
               paged=None, cache=None):
        h = common.norm_apply(lp["norm1"], x)
        x = x + attention.apply(lp["attn"], h, positions, acfg, engine,
                                pool=pool, paged=paged, cache=cache)
        h2 = common.norm_apply(lp["norm2"], x)
        if "moe" in lp:
            return x + moe.apply(lp["moe"], h2, self.moe_cfg, engine, aux=False)[0]
        return x + ffn.apply(lp["ffn"], h2, self.cfg.act, engine)

    def _run_stack(self, params, x, positions, pools, paged: PagedInfo):
        for lp, pool, acfg in zip(params["layers"], pools, self.layer_cfgs):
            x = self._block(lp, x, positions, self.engine, acfg, pool, paged)
        return x

    def embed(self, params, tokens: torch.Tensor, engine: Engine | None = None) -> torch.Tensor:
        """The rows of the embedding table in the compute format, times
        sqrt(d_model) under ``cfg.embed_scale`` (the scale rounded to that format first, as
        the reference's weakly typed product rounds it; a host scalar, so
        the decode graph captures no copy)."""
        compute = (engine or self.engine).policy.compute
        x = common.embed_apply(params["embed"], tokens).to(compute)
        if self.embed_scale != 1.0:
            x = x * float(torch.tensor(self.embed_scale, dtype=compute))
        return x

    def logits(self, params, h: torch.Tensor, engine: Engine | None = None) -> torch.Tensor:
        """fp32 logits through the tied table or the untied head, then the
        final softcap, in the reference's order."""
        eng = engine or self.engine
        if self.cfg.tie_embeddings:
            out = common.unembed_apply(params["embed"], h, eng)
        else:
            out = common.dense_apply(params["head"], h, eng)
        return common.softcap(out.float(), self.cfg.final_softcap)

    # -- training -------------------------------------------------------------
    def forward(self, params, batch, *, engine: Engine | None = None):
        """Teacher-forced forward. batch: {"tokens": (B, S) int64}. Returns
        (hidden (B, S, d) after the final norm, aux loss); the dense decoder
        has no auxiliary loss, so aux is an fp32 zero. ``engine`` overrides
        the model's engine for this call (the step factories' plumbing)."""
        if self.cfg.is_moe:
            raise NotImplementedError(
                f"{self.cfg.name}: MoE training (the aux loss in the loss) is not ported yet; "
                "the port serves MoE models only")
        eng = engine or self.engine
        tokens = batch["tokens"]
        x = self.embed(params, tokens, eng)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for lp, acfg in zip(params["layers"], self.layer_cfgs):
            if self.cfg.remat == "block":
                x = checkpoint(self._block, lp, x, positions, eng, acfg, use_reentrant=False)
            else:
                x = self._block(lp, x, positions, eng, acfg)
        x = common.norm_apply(params["final_norm"], x)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # -- serving state --------------------------------------------------------
    def cb_profile(self) -> CBProfile:
        """The reference's rule: a window only when every attention layer is
        ``attn_local`` (gemma2 alternates, so it gets none and keeps every
        page of a request)."""
        window = None
        if all(k == "attn_local" for k in self.pattern) and self.cfg.sliding_window:
            window = self.cfg.sliding_window
        return CBProfile(needs_kv_pages=True, kv_window=window)

    def init_state_store(self, num_slots: int, num_pages: int, page_size: int):
        """One flat KV token pool per layer (num_pages * page_size slots;
        page 0 is the serving layer's null page), shaped by the layer's own
        attention config."""
        n_tok = num_pages * page_size
        return [attention.init_paged_pool(n_tok, acfg, self.kv_dtype, self.device)
                for acfg in self.layer_cfgs]

    def prefill_cb(self, params, tokens: torch.Tensor, pools, page_row: torch.Tensor,
                   slot, start, length, *, page_size: int, chunked: bool = False,
                   active: torch.Tensor | None = None) -> torch.Tensor:
        """One prefill chunk of one slot, or (with a rank-2 ``page_row``) one
        chunk for each of P slots at once; the pools are updated in place.

        Single-row form. tokens: (1, Tb) right-padded; page_row: (P,) the
        slot's page ids; slot: its state row (the port's models keep none);
        start, length: host integers, the absolute position of the first
        token and the valid tokens. With ``chunked`` the layers also gather
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
            return self._prefill_cb_batched(params, tokens, pools, page_row, start, length,
                                            active, page_size=page_size)
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
        paged = PagedInfo(write_idx=write_idx, k_pos=k_pos, read_idx=read_idx,
                          page_size=page_size, chunked=chunked)
        x = self.embed(params, tokens)
        x = self._run_stack(params, x, pos[None].expand(b, s), pools, paged)
        x = common.norm_apply(params["final_norm"], x)
        return self.logits(params, x[:, length - 1:length])[:, 0]

    def _prefill_cb_batched(self, params, tokens, pools, page_rows, starts, lengths, active, *,
                            page_size: int) -> torch.Tensor:
        """Multi-row body of :meth:`prefill_cb` (see its docstring)."""
        x = self._chunk_rows(params, tokens, pools, page_rows, starts, lengths, active,
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

        ``commit`` is the reference's switch for recurrent state rows (the
        pass that scans the accepted tokens into them). The port's models
        keep none, so it changes nothing; a model with state rows raises."""
        if commit and self.cb_profile().has_state_rows:
            raise NotImplementedError("the state-row commit pass is not ported yet")
        x = self._chunk_rows(params, tokens, pools, page_table, seq_lens, lengths, active,
                             page_size=page_size)
        return self.logits(params, x)

    def _chunk_rows(self, params, tokens, pools, page_rows, starts, lengths, active, *,
                    page_size: int) -> torch.Tensor:
        """The stack over (P, Tb) rows, each a chunk of its own slot's
        sequence from ``starts``: writes the fresh K/V and returns the final
        hidden states (P, Tb, d) after the final norm."""
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
                          read_idx=read_idx, page_size=page_size, chunked=True)
        x = self.embed(params, tokens)
        x = self._run_stack(params, x, pos, pools, paged)
        return common.norm_apply(params["final_norm"], x)

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
        rows write the null page and give discarded logits. Returns (S, V)."""
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
        x = self._run_stack(params, x, lens[:, None], pools, paged)
        x = common.norm_apply(params["final_norm"], x)
        return self.logits(params, x)[:, 0]


    # -- static-batch serving (ring-buffer cache) -----------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """The ring-buffer cache of static-batch serving: one buffer a layer,
        of ``max_len`` positions (a local layer's of at most its window, as
        the reference allocates it), and the batch's shared position."""
        return {"pos": 0, "layers": [
            attention.init_cache(batch, min(max_len, acfg.window or max_len), acfg,
                                 self.kv_dtype, self.device)
            for acfg in self.layer_cfgs]}

    def prefill(self, params, batch, cache: dict) -> torch.Tensor:
        """Run the prompt through the decoder, filling the cache in place.
        batch: {"tokens": (B, S)}. Returns logits (B, 1, V) at the last
        position."""
        tokens = batch["tokens"]
        x = self.embed(params, tokens)
        positions = cache["pos"] + torch.arange(tokens.shape[1], device=tokens.device)
        for lp, c, acfg in zip(params["layers"], cache["layers"], self.layer_cfgs):
            x = self._block(lp, x, positions, self.engine, acfg, cache=c)
        x = common.norm_apply(params["final_norm"], x)
        cache["pos"] += tokens.shape[1]
        return self.logits(params, x[:, -1:])

    def decode_step(self, params, tokens: torch.Tensor, cache: dict) -> torch.Tensor:
        """One-token decode of the whole batch. tokens: (B, 1). Returns
        logits (B, 1, V); the cache is updated in place."""
        x = self.embed(params, tokens)
        positions = cache["pos"] + torch.arange(1, device=tokens.device)
        for lp, c, acfg in zip(params["layers"], cache["layers"], self.layer_cfgs):
            x = self._block(lp, x, positions, self.engine, acfg, cache=c)
        x = common.norm_apply(params["final_norm"], x)
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

