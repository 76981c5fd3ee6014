"""The dense decoder-only transformer of the port, for training and for
continuous-batching serving (counterpart of
``repro.models.transformer.Transformer``).

Parameters are a plain dict of tensors: ``embed.table``, one dict per
layer under ``layers`` (the reference stacks them on a leading axis for
``lax.scan``; the port runs a Python loop over a list), and
``final_norm.scale``. With ``cfg.remat == "block"`` the training forward
recomputes each block in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of its
scan body does. Other families (MoE, recurrent, sliding-window-only,
encoder-decoder, VLM) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import E4M3, as_dtype
from repro_torch.engine import Engine
from repro_torch.models import attention, common, ffn
from repro_torch.models.attention import AttnConfig, PagedInfo

Params = dict[str, Any]


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
        # gemma's embedding scale (keyed on the name, as in the reference),
        # its final softcap and sliding windows are not ported yet.
        if (cfg.family != "dense" or tuple(cfg.block_pattern) != ("attn",)
                or cfg.is_moe or cfg.is_encoder_decoder or cfg.norm != "rmsnorm"
                or not cfg.tie_embeddings or "gemma" in cfg.name
                or cfg.final_softcap is not None or cfg.sliding_window is not None):
            raise NotImplementedError(
                f"{cfg.name}: the port covers the dense decoder-only family "
                "(pattern ('attn',), RMSNorm, tied embeddings) so far"
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
        self.attn_cfg = AttnConfig(
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, rope_fraction=cfg.rope_fraction,
            softcap=cfg.attn_softcap,
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
        for _ in range(cfg.n_layers):
            params["layers"].append({
                "norm1": common.norm_init(cfg.d_model, dev),
                "attn": attention.init(gen, cfg.d_model, self.attn_cfg, self.dtype, dev),
                "norm2": common.norm_init(cfg.d_model, dev),
                "ffn": ffn.init(gen, cfg.d_model, cfg.d_ff, self.dtype, dev),
            })
        return params

    # -- blocks ---------------------------------------------------------------
    def _block(self, lp, x, positions, engine: Engine, pool=None, paged=None):
        h = common.norm_apply(lp["norm1"], x)
        x = x + attention.apply(lp["attn"], h, positions, self.attn_cfg, engine,
                                pool=pool, paged=paged)
        h2 = common.norm_apply(lp["norm2"], x)
        return x + ffn.apply(lp["ffn"], h2, self.cfg.act, engine)

    def _run_stack(self, params, x, positions, pools, paged: PagedInfo):
        for lp, pool in zip(params["layers"], pools):
            x = self._block(lp, x, positions, self.engine, pool, paged)
        return x

    def embed(self, params, tokens: torch.Tensor, engine: Engine | None = None) -> torch.Tensor:
        compute = (engine or self.engine).policy.compute
        return common.embed_apply(params["embed"], tokens).to(compute)

    def logits(self, params, h: torch.Tensor, engine: Engine | None = None) -> torch.Tensor:
        return common.unembed_apply(params["embed"], h, engine or self.engine).float()

    # -- training -------------------------------------------------------------
    def forward(self, params, batch, *, engine: Engine | None = None):
        """Teacher-forced forward. batch: {"tokens": (B, S) int64}. Returns
        (hidden (B, S, d) after the final norm, aux loss); the dense decoder
        has no auxiliary loss, so aux is an fp32 zero. ``engine`` overrides
        the model's engine for this call (the step factories' plumbing)."""
        eng = engine or self.engine
        tokens = batch["tokens"]
        x = self.embed(params, tokens, eng)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for lp in params["layers"]:
            if self.cfg.remat == "block":
                x = checkpoint(self._block, lp, x, positions, eng, use_reentrant=False)
            else:
                x = self._block(lp, x, positions, eng)
        x = common.norm_apply(params["final_norm"], x)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    # -- serving state --------------------------------------------------------
    def cb_profile(self) -> CBProfile:
        return CBProfile(needs_kv_pages=True, kv_window=None)

    def init_state_store(self, num_slots: int, num_pages: int, page_size: int):
        """One flat KV token pool per layer (num_pages * page_size slots;
        page 0 is the serving layer's null page)."""
        n_tok = num_pages * page_size
        return [attention.init_paged_pool(n_tok, self.attn_cfg, self.kv_dtype, self.device)
                for _ in range(self.cfg.n_layers)]

    def prefill_cb(self, params, tokens: torch.Tensor, pools, page_row: torch.Tensor,
                   start: int, length: int, *, page_size: int) -> torch.Tensor:
        """Whole-prompt prefill of one slot. tokens: (1, Tb) right-padded;
        page_row: (P,) the slot's page ids; start: absolute position of the
        first token; length: valid tokens. Pad rows write the null page and
        are masked as keys. Returns logits (1, V) at the last valid token;
        the pools are updated in place."""
        b, s = tokens.shape
        dev = tokens.device
        tok = torch.arange(s, dtype=torch.int64, device=dev)
        pos = start + tok
        valid = tok < length
        page_idx = (pos // page_size).clamp(0, page_row.shape[0] - 1)
        write_idx = torch.where(valid, page_row.long()[page_idx] * page_size + pos % page_size, 0)
        k_pos = torch.where(valid, pos, attention.POS_SENTINEL)[None]
        paged = PagedInfo(write_idx=write_idx, k_pos=k_pos, page_size=page_size)
        x = self.embed(params, tokens)
        x = self._run_stack(params, x, pos[None].expand(b, s), pools, paged)
        x = common.norm_apply(params["final_norm"], x)
        return self.logits(params, x[:, length - 1:length])[:, 0]

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
            n_tok = page_table.shape[1] * page_size
            offs = torch.arange(page_size, device=dev)
            read_idx = (page_table.long()[:, :, None] * page_size + offs).reshape(n_slots, n_tok)
            lpos = torch.arange(n_tok, device=dev)[None]
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

