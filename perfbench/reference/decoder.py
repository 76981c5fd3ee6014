"""The plain reference of the benchmark's decoder configurations: plain
PyTorch, no kernel, no cache and no batching of requests, independent of
the program (it imports nothing of ``repro_torch`` and reads none of its
state). It takes the weights the benchmark drew and the tokens it made.

The architecture is the one the configuration files state: pre-norm
decoder layers of RMSNorm (eps 1e-6, fp32 scale), grouped-query attention
with RoPE on interleaved pairs (theta from the file), a causal softmax
over 1/sqrt(head_dim)-scaled scores, then a SwiGLU FFN, or a MoE FFN whose
fp32 router takes the softmax over the experts, keeps the top k and
renormalises them, and whose experts are SwiGLU FFNs; a final RMSNorm and
the head (the tied table's transpose or an untied matrix).

Precision, as the configuration states it: the arithmetic is fp32, and
every matrix product (the projections, the experts, the head and the
attention's two products) is the RedMulE GEMM-Op of the file's policy:
its operands rounded to the stated operand format (E4M3), fp32 sums, and
the product rounded to the compute format (fp16). The router is an fp32
product, as the configuration runs it, and keys and values are rounded
to the stated KV format before attention. :class:`Precision` with
``int4`` operands is the control: the same reference one precision
below, each operand rounded to 4-bit integers with a scale for each row
(each column of the right operand) along the contraction; with ``e5m2``
operands, the second control (one mantissa bit less than E4M3).

``torch.backends.cuda.matmul.allow_tf32`` is switched off while the
reference runs, so an fp32 product is fp32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

FP8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
HALF = {"fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32}


def round_to(x: torch.Tensor, fmt: str, dim: int) -> torch.Tensor:
    """``x`` (fp32) rounded to ``fmt``: an fp8 format by a plain cast, as the
    GEMM-Op stores an operand; ``int4`` symmetric with one scale for each
    slice along ``dim`` (its largest magnitude over 7)."""
    if fmt in FP8:
        return x.to(FP8[fmt]).float()
    if fmt == "int4":
        s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 7.0
        return torch.round(x / s).clamp(-7, 7) * s
    if fmt == "fp32":
        return x
    raise ValueError(fmt)


@dataclasses.dataclass(frozen=True)
class Precision:
    """The formats of a GEMM-Op: its operands and its product's output."""

    operand: str = "e4m3"
    out: str = "fp16"

    def out_round(self, z: torch.Tensor) -> torch.Tensor:
        return z.to(HALF[self.out]).float()


def gemm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as the GEMM-Op computes it: each
    operand rounded along the contraction, fp32 sums, the product rounded
    to the output format."""
    return prec.out_round(round_to(a, prec.operand, -1) @ round_to(b, prec.operand, -2))


@contextlib.contextmanager
def fp32_products():
    """Plain fp32 products on the card while the reference runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@dataclasses.dataclass(frozen=True)
class Arch:
    d: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    n_layers: int
    n_experts: int
    top_k: int
    rope_theta: float
    eps: float = 1e-6

    @classmethod
    def of(cls, cfg: dict) -> "Arch":
        d, h = cfg["hidden_size"], cfg["num_attention_heads"]
        return cls(d, h, cfg["num_key_value_heads"], d // h, cfg["intermediate_size"],
                   cfg["vocab_size"], cfg["num_hidden_layers"], cfg.get("num_local_experts", 0),
                   cfg.get("num_experts_per_tok", 0), float(cfg["rope_theta"]))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, hd) rotated on its interleaved pairs at positions pos (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = pos.float()[:, None] * inv  # (S, hd/2)
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).flatten(-2)


def attention(x: torch.Tensor, w: dict, arch: Arch, prec: Precision,
              kv_fmt: str | None = None) -> torch.Tensor:
    """Causal GQA self-attention of one batch of sequences x (B, S, d) from
    position 0; K and V rounded to ``kv_fmt`` where the deployment stores
    them so."""
    b, s, _ = x.shape
    hd, hq, hkv = arch.head_dim, arch.n_heads, arch.n_kv_heads
    pos = torch.arange(s, device=x.device)
    q = rope(gemm(x, w["q"], prec).view(b, s, hq, hd), pos, arch.rope_theta)
    k = rope(gemm(x, w["k"], prec).view(b, s, hkv, hd), pos, arch.rope_theta)
    v = gemm(x, w["v"], prec).view(b, s, hkv, hd)
    if kv_fmt is not None:
        k, v = round_to(k, kv_fmt, -1), round_to(v, kv_fmt, -1)
    g = hq // hkv
    q = q.permute(0, 2, 1, 3)  # (B, Hq, S, hd)
    k = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    scores = gemm(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    # The second product takes exp(s - max), at most 1, and the sum divides
    # after it, as a flash attention computes the softmax.
    e = torch.exp(scores - scores.amax(-1, keepdim=True).detach())
    out = gemm(e, v, prec) / e.sum(-1, keepdim=True)
    out = out.permute(0, 2, 1, 3).reshape(b, s, hq * hd)
    return gemm(out, w["o"], prec)


def swiglu(x: torch.Tensor, up, gate, down, prec: Precision, weight=None) -> torch.Tensor:
    h = F.silu(gemm(x, gate, prec)) * gemm(x, up, prec)
    return gemm(h if weight is None else h * weight, down, prec)


def moe(x: torch.Tensor, w: dict, arch: Arch, prec: Precision) -> torch.Tensor:
    """x (T, d): the routed experts only, each on the tokens routed to it."""
    f = arch.d_ff
    probs = torch.softmax(x @ w["router"], dim=-1)
    top_p, top_i = torch.topk(probs, arch.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(arch.n_experts):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        cols = slice(e * f, (e + 1) * f)
        y.index_add_(0, rows, swiglu(x[rows], w["up"][:, cols], w["gate"][:, cols],
                                     w["down"][cols], prec, top_p[rows, slot][:, None]))
    return y


def block(x: torch.Tensor, w: dict, arch: Arch, prec: Precision,
          kv_fmt: str | None = None) -> torch.Tensor:
    """One decoder layer on x (B, S, d)."""
    x = x + attention(rms_norm(x, w["norm1"], arch.eps), w, arch, prec, kv_fmt)
    h = rms_norm(x, w["norm2"], arch.eps)
    if arch.n_experts:
        return x + moe(h.reshape(-1, arch.d), w, arch, prec).view(x.shape)
    return x + swiglu(h, w["up"], w["gate"], w["down"], prec)


def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along the first axis; an fp8 table through its bytes."""
    if table.element_size() == 1:
        return table.view(torch.uint8)[idx].view(table.dtype)
    return table[idx]


def head_weight(top: dict) -> torch.Tensor:
    return top["head"] if "head" in top else top["embed"].T


@torch.no_grad()
def served_logits(layer_weights, top: dict, arch: Arch, seqs: list[torch.Tensor],
                  starts: list[int], prec: Precision, kv_fmt: str | None) -> list[torch.Tensor]:
    """fp32 logits of each sequence of token ids ``seqs[i]`` at positions
    ``starts[i] - 1`` .. end - 2, the ones that predict its tokens from
    ``starts[i]`` on. ``layer_weights(i)`` gives layer i's fp32 weights
    ({norm1, q, k, v, o, norm2, and up, gate, down, router}); the layers run
    one at a time over every sequence, so one layer's fp32 weights are
    alive at once."""
    xs = [rows(top["embed"], s).float()[None] for s in seqs]
    for i in range(arch.n_layers):
        w = layer_weights(i)
        xs = [block(x, w, arch, prec, kv_fmt) for x in xs]
        del w
    hw = head_weight(top).float()
    out = []
    for x, st in zip(xs, starts):
        h = rms_norm(x[0, st - 1:-1], top["final_norm"], arch.eps)
        out.append(gemm(h, hw, prec))
    return out
