"""The frozen yardstick: the same counts and peaks as the program's
``roofline/cost.py`` and ``roofline/analysis.py`` today, and the trace
and metric arithmetic on synthetic events."""
import pytest
import torch

from perfbench import manifest, traces, yardstick as ys
from repro_torch.core import semiring
from repro_torch.core.precision import E4M3, FP16, FP32, get_policy
from repro_torch.roofline import analysis, cost

HFP8 = get_policy("redmule_hfp8")


def _meta(*shape, dtype=E4M3):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_peaks_are_the_programs():
    assert (ys.HBM_BYTES_S, ys.FP16_FLOP_S, ys.FP8_FLOP_S, ys.FP32_FLOP_S) == (
        analysis.HBM_BYTES_S, analysis.FP16_FLOP_S, analysis.FP8_FLOP_S, analysis.FP32_FLOP_S)


@pytest.mark.parametrize("m, k, n, dtype, out, policy", [
    (16, 4096, 102400, E4M3, FP16, "redmule_hfp8"),  # phi's decode up/gate, all experts
    (2048, 102400, 4096, E4M3, FP16, "redmule_hfp8"),  # a P = 8 prefill's down
    (4096, 4096, 49155, E4M3, FP16, "redmule_hfp8"),  # granite's tied head
    (16, 4096, 16, FP32, FP32, "fp32"),  # the router
])
def test_gemm_rule_equals_the_programs(m, k, n, dtype, out, policy):
    fmt = {E4M3: "e4m3", FP16: "fp16", FP32: "fp32"}
    mine = ys.gemm_cost(m, k, n, x_fmt=fmt[dtype], w_fmt=fmt[dtype], out_fmt=fmt[out],
                        compute="fp32" if policy == "fp32" else "fp16")
    theirs = cost.gemm_cost(_meta(m, k, dtype=dtype), _meta(n, k, dtype=dtype).T,
                            gop=semiring.MATMUL, policy=get_policy(policy), out_dtype=out)
    assert (mine.flops, mine.bytes, mine.peak) == (theirs.flops, theirs.bytes, theirs.peak)
    assert mine.bound_s == theirs.bound_s


def test_paged_decode_rule_equals_the_programs():
    lens = [70, 40, 100, 65, 300, 5]
    q = torch.empty((6, 32, 128), dtype=FP16)
    pool = _meta(200 * 16, 8, 128)
    table = torch.zeros((6, 56), dtype=torch.int32)
    theirs = cost.paged_decode_cost(q, pool, table, torch.tensor(lens, dtype=torch.int32),
                                    torch.ones(6, dtype=torch.bool), page_size=16)
    mine = ys.paged_decode_cost(lens, n_heads=32, n_kv_heads=8, head_dim=128, page_size=16,
                                kv_fmt="e4m3", q_fmt="fp16", slots=6, pages_per_slot=56)
    assert (mine.flops, mine.bytes, mine.peak) == (theirs.flops, theirs.bytes, theirs.peak)


def test_union_gaps_and_labels():
    spans = [(0, 10), (5, 20), (30, 40), (35, 38), (50, 60)]
    assert traces.union_ns(spans) == 20 + 10 + 10
    assert traces.gaps(spans, 0, 70) == [(20, 30), (40, 50), (60, 70)]
    host = [("outer", 0, 100), ("aten::mm", 18, 32), ("sync", 55, 69)]
    assert traces.label_gaps(host, [(20, 30), (40, 50), (60, 70)]) == {
        "aten::mm": 10, "outer": 10, "sync": 10}
    assert traces.label_gaps([], [(0, 5)]) == {"host idle": 5}


def test_reduce_clips_to_the_window_and_ranks_by_time():
    dev = [("redmule_gemm_sr_kernel<0>", 0, 40), ("paged_decode_kernel<1>", 40, 50),
           ("redmule_gemm_tc_kernel<2>", 60, 90), ("elementwise", 95, 130)]
    w = traces.reduce(dev, [("aten::where", 50, 60)], 0, 100)
    assert w.window_ns == 100 and w.busy_ns == 40 + 10 + 30 + 5
    assert w.device_ops[0] == ["redmule_gemm_sr_kernel<0>", 40e-9]
    assert w.idle_gaps[0] == ["aten::where", 10e-9]
    assert w.time_s([r"redmule_gemm_sr_kernel", r"redmule_gemm_tc_kernel"]) == 70e-9


def _shape():
    from perfbench.tests import sizes

    return ys.model_shape(sizes.phi(d=4096, vocab=32064, layers=32) | {
        "num_local_experts": 16, "intermediate_size": 6400, "num_attention_heads": 32,
        "num_key_value_heads": 8})


def test_serve_readers_on_a_synthetic_slice():
    shape = _shape()
    slice_ = {"decode_steps": 10, "decode_tokens": 160, "prefill_steps": 0, "prefill_tokens": 0}
    bound = ys.gemm_bound_s(shape, steps=10, tokens=160, head_rows=160)
    # Weight bytes once a step: the decode step is bound by its bytes.
    weights = sum(lin.k * lin.n * ys.BYTES[lin.w_fmt] * (32 if lin.name.startswith("layer.")
                                                         else 1)
                  for lin in ys.decoder_linears(shape))
    assert bound >= 10 * weights / ys.HBM_BYTES_S
    ns = int(round(bound * 2e9))  # the kernels took twice the bound
    run = {"shape": shape, "trace": traces.reduce(
        [("redmule_gemm_sr_kernel", 0, ns)], [], 0, 4 * ns),
        "observed": {"slice": slice_, "slice_first_tokens": 0, "slice_prompt_pairs": 0.0,
                     "slice_decode_lens": [100] * 160, "slots": 16, "page_size": 16,
                     "pages_per_slot": 56, "window": {}, "step_s": {False: [], True: []}}}
    assert manifest.metric("gemm_roofline.serve").read(run) == pytest.approx(50.0, rel=1e-6)
    assert manifest.metric("idle_share.serve").read(run) == pytest.approx(75.0)
    assert manifest.metric("paged_decode_roofline.serve").read(run) is None  # no decode kernel
    flops = 2.0 * (ys.active_weights(shape)) * 160 + ys.attention_flops(shape, 160 * 101)
    want = 100.0 * flops / (run["trace"].window_s * ys.FP8_FLOP_S)
    assert manifest.metric("mfu.serve").read(run) == pytest.approx(want, rel=1e-9)


def test_the_gemm_bound_counts_routed_experts():
    shape = _shape()
    dense = shape | {"n_experts": 0, "d_ff": 16 * 6400}
    # A prefill step of 8192 tokens: the routed work is 2 of 16 experts'
    # FLOPs, so the MoE's bound is far under the one a dense dispatch needs.
    moe = ys.gemm_bound_s(shape, steps=1, tokens=8192, head_rows=32)
    assert moe < 0.3 * ys.gemm_bound_s(dense, steps=1, tokens=8192, head_rows=32)
    # One decode token a step reads only its two experts' weights.
    one = ys.gemm_bound_s(shape, steps=1, tokens=1, head_rows=1)
    sixteen = ys.gemm_bound_s(shape, steps=1, tokens=16, head_rows=16)
    assert one < 0.25 * sixteen
    assert ys.causal_pairs(0, 4) == 10 and ys.causal_pairs(4, 2) == 4 + 4 + 1 + 2
