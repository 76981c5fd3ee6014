"""The yardstick of the benchmark: the H100's peaks and the operation and
byte counts of the work a cell's tokens need, from the configuration's
shapes alone.

A frozen copy of the rules of ``src/repro_torch/roofline/cost.py`` and
the peaks of ``src/repro_torch/roofline/analysis.py``, kept here so that
a later change to the program cannot move its own yardstick
(``perfbench/tests/test_pb_yardstick.py`` holds them equal to the
program's on a few shapes). Nothing here is counted from kernel launches:
a roofline reads the same work whatever kernel implements it.

- **GEMM-Op**: 2*M*K*N operations; (mul, add) with both operands in fp8
  and a 16-bit compute format runs at the fp8 tensor-core peak, a 16-bit
  operand at the fp16 peak, fp32 compute at the fp32 peak. Bytes: each
  operand in the format it is handed over in, read once, and Z written
  once in its output format.
- **Paged decode**: the K and V bytes of every page that holds a live
  token of an active slot, q and the output, the page table, the lengths
  and the active mask. 4*Hq*hd operations a live token, at the fp32 peak.
- **GEMM work a step needs**: every weight matrix read once a step and
  each token's rows once; a MoE token needs its ``top_k`` routed experts
  and the router, and a step reads the weights of at most ``E`` and at
  least ``min(E, top_k * rows)`` experts, which is what is counted. The
  work is the same whatever dispatch the program runs (its dense
  dispatch multiplies every expert).
- **Model FLOPs** (MFU): 2 operations a weight a token for the weights a
  token uses (a MoE token its ``top_k`` routed experts only), plus the
  causal attention's 4*Hq*hd a (query, key) pair.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at
the card's full 700 W.
"""
from __future__ import annotations

import dataclasses

HBM_BYTES_S = 3.35e12  # device memory rate
FP16_FLOP_S = 989e12  # dense fp16/bf16 tensor-core peak
FP8_FLOP_S = 1979e12  # dense fp8 tensor-core peak
FP32_FLOP_S = 67e12  # fp32 peak outside the tensor cores

BYTES = {"e4m3": 1, "e5m2": 1, "fp16": 2, "bf16": 2, "fp32": 4, "int32": 4, "bool": 1}


@dataclasses.dataclass(frozen=True)
class Cost:
    """Operations and bytes of some work, and the peak of the unit its
    operations run on."""

    flops: float
    bytes: float
    peak: float

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger of the two terms."""
        return max(self.flops / self.peak, self.bytes / HBM_BYTES_S)


def gemm_peak(x_fmt: str, w_fmt: str, compute: str) -> float:
    if compute in ("fp16", "bf16"):
        fp8 = BYTES[x_fmt] == 1 and BYTES[w_fmt] == 1
        return FP8_FLOP_S if fp8 else FP16_FLOP_S
    return FP32_FLOP_S


def gemm_cost(m: int, k: int, n: int, *, x_fmt: str, w_fmt: str, out_fmt: str,
              compute: str, batch: int = 1) -> Cost:
    """One (mul, add) GEMM-Op call: X (batch, M, K) times W (K, N)."""
    nbytes = batch * (m * k * BYTES[x_fmt] + m * n * BYTES[out_fmt]) + k * n * BYTES[w_fmt]
    return Cost(2.0 * batch * m * k * n, float(nbytes), gemm_peak(x_fmt, w_fmt, compute))


def paged_decode_cost(lens: list[int], *, n_heads: int, n_kv_heads: int, head_dim: int,
                      page_size: int, kv_fmt: str, q_fmt: str, slots: int,
                      pages_per_slot: int) -> Cost:
    """One paged-decode call over ``slots`` slots whose active ones have
    their fresh token at the positions ``lens`` (no window)."""
    pages = sum(p // page_size + 1 for p in lens)
    tokens = sum(p + 1 for p in lens)
    kv = 2 * pages * page_size * n_kv_heads * head_dim * BYTES[kv_fmt]
    q_out = 2 * slots * n_heads * head_dim * BYTES[q_fmt]
    index = slots * pages_per_slot * BYTES["int32"] + slots * (BYTES["int32"] + BYTES["bool"])
    return Cost(4.0 * n_heads * head_dim * tokens, float(kv + q_out + index), FP32_FLOP_S)


@dataclasses.dataclass(frozen=True)
class Linear:
    """One weight matrix of a layer or of the model, as the GEMM-Op gets it."""

    name: str
    k: int
    n: int
    w_fmt: str
    compute: str  # the compute format of its GEMM ("fp32" for the router)
    x_fmt: str
    out_fmt: str
    experts: int = 0  # a MoE expert's matrix: the layer holds this many


def decoder_linears(shape: dict) -> list[Linear]:
    """Every GEMM weight of a decoder of attention layers and a SwiGLU FFN
    or MoE FFN, the head included, with its count over the model
    (``shape``: see :func:`model_shape`). A MoE's experts appear as one
    expert's (d, f) up and gate and (f, d) down, with ``experts`` = E."""
    d, hd = shape["d_model"], shape["head_dim"]
    hq, hkv, f = shape["n_heads"], shape["n_kv_heads"], shape["d_ff"]
    w, op, out, comp = shape["w_fmt"], shape["x_fmt"], shape["out_fmt"], shape["compute"]
    e = shape.get("n_experts", 0)
    layer = [Linear("q", d, hq * hd, w, comp, op, out), Linear("k", d, hkv * hd, w, comp, op, out),
             Linear("v", d, hkv * hd, w, comp, op, out), Linear("o", hq * hd, d, w, comp, op, out)]
    if e:
        layer += [Linear("router", d, e, "fp32", "fp32", "fp32", "fp32"),
                  Linear("up", d, f, w, comp, op, out, e), Linear("gate", d, f, w, comp, op, out, e),
                  Linear("down", f, d, w, comp, op, out, e)]
    else:
        layer += [Linear("up", d, f, w, comp, op, out), Linear("gate", d, f, w, comp, op, out),
                  Linear("down", f, d, w, comp, op, out)]
    head = Linear("head", d, shape["vocab_size"], w, comp, op, "fp32")
    return [dataclasses.replace(lin, name=f"layer.{lin.name}") for lin in layer] + [head]


def model_shape(cfg) -> dict:
    """The sizes the counts need, from a configuration file's dict
    (``perfbench/configs/*.json``): its published widths, the depth it
    runs and the formats its deployment states."""
    dep = cfg["deployment"]
    return {
        "n_layers": cfg["num_hidden_layers"], "d_model": cfg["hidden_size"],
        "n_heads": cfg["num_attention_heads"], "n_kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg["hidden_size"] // cfg["num_attention_heads"],
        "d_ff": cfg["intermediate_size"], "vocab_size": cfg["vocab_size"],
        "n_experts": cfg.get("num_local_experts", 0), "top_k": cfg.get("num_experts_per_tok", 0),
        "w_fmt": dep["weight_format"], "x_fmt": dep["operand_format"],
        "out_fmt": dep["compute_format"], "compute": dep["compute_format"],
        "kv_fmt": dep.get("kv_format", dep["compute_format"]),
    }


def gemm_bound_s(shape: dict, *, steps: int, tokens: int, head_rows: int) -> float:
    """The least time of the GEMM-Op work of ``steps`` forward steps that
    carry ``tokens`` tokens in all, ``head_rows`` of which need logits:
    every weight read once a step, each token's rows once, a MoE token's
    rows through its ``top_k`` experts, and of each expert matrix the
    copies that ``min(E, top_k * tokens / steps)`` experts hold read once a
    step (exact where every step carries at least E / top_k rows, as the
    serve cell's full slots and prefill chunks do). Each weight's calls
    are bounded together (the sum of their operations against the sum of
    their bytes), which is at most the sum of the calls' own bounds, so
    the share it gives never reads high."""
    if steps == 0:
        return 0.0
    total = 0.0
    for lin in decoder_linears(shape):
        in_layer = lin.name.startswith("layer.")
        reps, rows = (shape["n_layers"], tokens) if in_layer else (1, head_rows)
        copies = 1.0
        if lin.experts:
            rows *= shape["top_k"]
            copies = min(lin.experts, shape["top_k"] * tokens / steps)
        flops = 2.0 * rows * lin.k * lin.n
        nbytes = (steps * copies * lin.k * lin.n * BYTES[lin.w_fmt]
                  + rows * (lin.k * BYTES[lin.x_fmt] + lin.n * BYTES[lin.out_fmt]))
        peak = gemm_peak(lin.x_fmt, lin.w_fmt, lin.compute)
        total += reps * Cost(flops, float(nbytes), peak).bound_s
    return total


def active_weights(shape: dict) -> float:
    """Weights a token multiplies: the attention projections, the FFN (a
    MoE token its ``top_k`` experts and the router) and the head."""
    d, hd, f = shape["d_model"], shape["head_dim"], shape["d_ff"]
    attn = d * (shape["n_heads"] + 2 * shape["n_kv_heads"]) * hd + shape["n_heads"] * hd * d
    if shape.get("n_experts"):
        ffn = shape["top_k"] * 3 * d * f + d * shape["n_experts"]
    else:
        ffn = 3 * d * f
    return float(shape["n_layers"] * (attn + ffn) + d * shape["vocab_size"])


def attention_flops(shape: dict, pairs: float) -> float:
    """Causal attention's operations over ``pairs`` (query, key) pairs a
    layer: QK and PV, 2*hd each a head."""
    return 4.0 * shape["n_layers"] * shape["n_heads"] * shape["head_dim"] * pairs


def causal_pairs(start: int, n: int) -> float:
    """(query, key) pairs of ``n`` queries at positions start .. start+n-1,
    each over the keys at or before it."""
    return float(n * start + n * (n + 1) // 2)
