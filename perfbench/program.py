"""What the benchmark takes from the program (``repro_torch``): its model
built to a configuration file, the registry counters it reads, and the
names of its kernels. Imported only where a run drives the program."""
from __future__ import annotations

import dataclasses

# The GEMM-Op's kernels (csrc/redmule_gemm*.cu, the SIMT forms' templates
# in csrc/redmule_simt.cuh) with its auxiliary passes: the K-major copies
# and the split-K combine.
GEMM_KERNELS = (r"redmule_gemm_sr_kernel", r"redmule_gemm_tc_kernel", r"\bwarp_n_kernel",
                r"\bwarp_kernel", r"\btile_kernel", r"splitk_combine_kernel", r"kmajor_\w*kernel")
PAGED_DECODE_KERNELS = (r"paged_decode_kernel",)

# Registry names of the serving counters and of the prefill step histogram
# (its count is the prefill steps harvested).
SERVE_COUNTERS = {
    "decode_steps": "serving_decode_steps_total",
    "decode_tokens": "serving_decode_tokens_total",
    "slot_steps": "serving_slot_steps_total",
    "decode_s": "serving_decode_seconds_total",
    "prefill_s": "serving_prefill_seconds_total",
    "prefill_tokens": "serving_prefill_tokens_total",
    "nonfinite_steps": "serving_nonfinite_steps_total",
}
PREFILL_STEPS = "serving_prefill_chunk_seconds"


def model_config(cfg: dict):
    """The program's ``ModelConfig`` for a configuration file: the arch's
    own (its kind of layers, norm and activation), with every size, the
    depth and the deployment's formats taken from the file. Raises where
    the arch is not the plain decoder the reference implements."""
    from repro_torch.configs import get_config

    base = get_config(cfg["arch"])
    if (tuple(base.block_pattern) != ("attn",) or base.act != "swiglu" or base.norm != "rmsnorm"
            or base.attn_softcap or base.final_softcap or base.embed_scale
            or base.rope_fraction != 1.0 or base.is_encoder_decoder):
        raise ValueError(f"{cfg['arch']}: the reference covers decoders of global attention, "
                         "RMSNorm and SwiGLU alone")
    dep = cfg["deployment"]
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return dataclasses.replace(
        base, n_layers=cfg["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"], head_dim=d // h, d_rnn=d,
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        n_experts=cfg.get("num_local_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
        tie_embeddings=cfg["tie_word_embeddings"], rope_theta=float(cfg["rope_theta"]),
        policy=dep["policy"], kv_cache_dtype=dep.get("kv_format", base.kv_cache_dtype),
        fp8_params=dep["weight_format"] == "e4m3", moe_impl=dep.get("moe_impl", base.moe_impl))


def serve_counters(server) -> dict[str, float]:
    m = server.metrics
    out = {k: m.counter(name).value for k, name in SERVE_COUNTERS.items()}
    out["prefill_steps"] = m.histogram(PREFILL_STEPS).count
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def sync(device: str) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
