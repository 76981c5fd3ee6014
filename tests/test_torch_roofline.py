"""The port's roofline (``repro_torch.roofline``): the operation and byte
counts of its kernel calls, their independence from the schedule that runs
a call, the recorder, and the roofline terms against the reference's
``repro.roofline.analysis``.

The six bounds below are the kernel table's in ``PERF.md`` (H100 SXM
peaks: 3.35 TB/s, 989 / 1979 TFLOP/s fp16 / fp8, 67 TFLOP/s fp32), which
``chip_smoke.py`` computed ad hoc before ``roofline/cost.py`` held the
rules; the counts reproduce them at the table's printed precision.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import semiring  # noqa: E402
from repro_torch.core.precision import E4M3, FP16, FP32, get_policy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import redmule_gemm as rg  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.roofline import analysis, cost  # noqa: E402

HFP8 = get_policy("redmule_hfp8")
MATMUL = semiring.MATMUL


def _meta(*shape, dtype=E4M3):
    return torch.empty(shape, dtype=dtype, device="meta")


def _gemm(m, k, n, policy=HFP8, dtype=E4M3, out=FP16):
    # W as the model holds it: (N, K) rows, handed over as the (K, N) view.
    return cost.gemm_cost(_meta(m, k, dtype=dtype), _meta(n, k, dtype=dtype).T, gop=MATMUL,
                          policy=policy, out_dtype=out)


def _serve_decode_case():
    """The kernel line's serving decode: 4 slots at lengths 70/40/100/65,
    7-page tables of 16 tokens, fp16 q, E4M3 pages."""
    q = torch.empty((4, 32, 128), dtype=FP16)
    pool = _meta(29 * 16, 8, 128)
    table = torch.zeros((4, 7), dtype=torch.int32)
    lens = torch.tensor([70, 40, 100, 65], dtype=torch.int32)
    return q, pool, table, lens, torch.ones(4, dtype=torch.int32)


@pytest.mark.parametrize("label, make, digits, want, by", [
    ("decode 4x4096x12800", lambda: _gemm(4, 4096, 12800), 4, 0.0157, "bytes"),
    ("prefill 64x4096x12800", lambda: _gemm(64, 4096, 12800), 4, 0.0162, "bytes"),
    ("verify 20x4096x12800", lambda: _gemm(20, 4096, 12800), 4, 0.0158, "bytes"),
    ("router 4x1024x32 fp32", lambda: cost.gemm_cost(
        _meta(4, 1024, dtype=FP32), _meta(1024, 32, dtype=FP32), gop=MATMUL,
        policy=get_policy("fp32"), out_dtype=FP32), 5, 0.00004, "bytes"),
    ("paged decode S4 Hq32 Hkv8 hd128", lambda: cost.paged_decode_cost(
        *_serve_decode_case(), page_size=16), 4, 0.0002, "bytes"),
    ("dense B1 S2048 Hq32 Hkv8 hd128", lambda: cost.flash_attention_cost(
        _meta(1, 2048, 32, 128, dtype=FP16), _meta(1, 2048, 8, 128, dtype=FP16),
        _meta(1, 2048, 8, 128, dtype=FP16), causal=True), 4, 0.0348, "operations"),
])
def test_counts_reproduce_the_kernel_tables_bounds(label, make, digits, want, by):
    c = make()
    assert round(c.bound_ms, digits) == want, (label, c.bound_ms)
    assert c.bound_by == by


def test_gemm_count_rules():
    c = _gemm(4, 4096, 12800)
    assert c.flops == 2 * 4 * 4096 * 12800 and c.peak == analysis.FP8_FLOP_S
    assert c.bytes == 4 * 4096 + 4096 * 12800 + 4 * 12800 * 2
    # fp16 operands take the fp16 tensor-core peak; a semiring pair the fp32 peak.
    assert _gemm(64, 64, 64, policy=get_policy("redmule_fp16"), dtype=FP16).peak == \
        analysis.FP16_FLOP_S
    apsp = cost.gemm_cost(_meta(64, 64), _meta(64, 64), gop=semiring.get("apsp"), policy=HFP8,
                          out_dtype=FP16)
    assert apsp.peak == analysis.FP32_FLOP_S
    # A broadcast operand is read once; Y adds its bytes.
    w = _meta(64, 32)
    x = _meta(1, 16, 64).expand(8, 16, 64)
    y = _meta(8, 16, 32, dtype=FP32)
    c = cost.gemm_cost(x, w, y, gop=MATMUL, policy=HFP8, out_dtype=FP16)
    assert c.flops == 2 * 8 * 16 * 64 * 32
    assert c.bytes == 16 * 64 + 64 * 32 + 8 * 16 * 32 * 4 + 8 * 16 * 32 * 2


@pytest.mark.parametrize("case", ["rows over the small-row threshold", "K-major or not"])
def test_one_call_planned_onto_two_schedules_counts_the_same(case, monkeypatch):
    """The counts read shapes and formats, never the plan: the 20-row verify
    GEMM on the tensor cores and on the small-row schedule (the threshold a
    later redesign may move), and a weight read as it lies against one that
    takes the K-major copy, give one count."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((20, 256), generator=gen).to(E4M3)
    w_rows = torch.randn((512, 256), generator=gen).to(E4M3)
    kw = dict(gop=MATMUL, policy=HFP8)
    if case == "rows over the small-row threshold":
        calls = [(x, w_rows.T)]
        plans = [rg.plan_call(x, w_rows.T, None, **kw).plan]
        monkeypatch.setattr(tuning, "SMALL_M_MAX", 32)
        plans.append(rg.plan_call(x, w_rows.T, None, **kw).plan)
        calls.append((x, w_rows.T))
        assert [p.schedule for p in plans] == ["tc", "small_row"]
    else:
        w_cols = w_rows.T.contiguous()  # the same (K, N) values, N contiguous
        calls = [(x, w_rows.T), (x, w_cols)]
        plans = [rg.plan_call(a, b, None, **kw).plan for a, b in calls]
        assert [p.copy_w for p in plans] == [False, True]
    counts = [cost.gemm_cost(a, b, gop=MATMUL, policy=HFP8, out_dtype=FP16) for a, b in calls]
    assert counts[0] == counts[1]
    torch.testing.assert_close(*(rg.redmule_gemm_plain(a, b, None, out_dtype=FP16, **kw).float()
                                 for a, b in calls), rtol=0, atol=0)


def test_paged_decode_counts_live_pages_in_the_window_and_active_slots():
    q, pool, table, lens, active = _serve_decode_case()
    full = cost.paged_decode_cost(q, pool, table, lens, active, page_size=16)
    pages = sum(n // 16 + 1 for n in (70, 40, 100, 65))
    index = table.numel() * 4 + 4 * 4 + 4 * 4
    assert full.bytes == 2 * pages * 16 * 8 * 128 + 2 * q.numel() * 2 + index
    assert full.flops == sum(4.0 * 32 * 128 * (n + 1) for n in (70, 40, 100, 65))
    # A window of 32: the tokens n-31..n, on the pages that hold them.
    win = cost.paged_decode_cost(q, pool, table, [70, 40, 100, 65], [1, 1, 1, 1],
                                 page_size=16, window=32)
    assert win.flops == 4.0 * 32 * 128 * 32 * 4
    assert win.bytes - (2 * q.numel() * 2 + table.numel() * 4 + 32) == \
        2 * 16 * 8 * 128 * sum(n // 16 - (n - 31) // 16 + 1 for n in (70, 40, 100, 65))
    idle = cost.paged_decode_cost(q, pool, table, lens, torch.tensor([1, 0, 1, 1]),
                                  page_size=16)
    assert idle.flops == full.flops - 4.0 * 32 * 128 * 41


def test_the_recorder_counts_a_decode_step_and_costs_nothing_closed():
    """granite-3-8b SMOKE on the CPU, decoding through the paged kernel's
    plain version (``fused_decode``, the card's route): a prefill and two
    decode steps with the recorder open count every GEMM-Op call and paged
    decode through ``kernels/ops.py``; closed, nothing is recorded."""
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), policy="fp32",
                              kv_cache_dtype="fp32")
    model = Transformer(cfg, engine=Engine(policy="fp32", backend="torch"), device="cpu",
                        fused_decode=True)
    params = model.init(0)
    calls = []
    gemm_op = ops.gemm_op

    def counting(*args, **kw):
        calls.append(1)
        return gemm_op(*args, **kw)

    from repro_torch.serving import Server, ServerConfig

    server = Server(model, params, ServerConfig(num_slots=2, page_size=8, max_seq_len=32),
                    device="cpu")
    server.submit([1, 2, 3, 4, 5], max_new_tokens=3)
    ops.gemm_op = counting
    try:
        with cost.recording() as counts:
            server.run()
    finally:
        ops.gemm_op = gemm_op
    assert not cost._active
    assert counts.kernels["redmule_gemm"].calls == len(calls) > 0
    # Two decode steps, one paged decode a layer each.
    assert counts.kernels["paged_decode"].calls == 2 * cfg.n_layers
    assert counts.capacity_calls == 0
    assert counts.flops > 0 and counts.bytes > 0
    twice = counts.times(2)
    assert twice.flops == 2 * counts.flops and twice.calls == 2 * counts.calls
    roof = analysis.roofline_from_counts(counts)
    assert roof.n_chips == 1 and roof.collective_s == 0
    assert roof.step_s == max(roof.compute_s, roof.memory_s)
    assert roof.memory_s == counts.bytes / analysis.HBM_BYTES_S


def test_roofline_and_model_flops_match_the_reference():
    assert [f.name for f in dataclasses.fields(analysis.Roofline)] == \
        [f.name for f in dataclasses.fields(janalysis.Roofline)]
    for terms in [(1.0, 2.0, 0.0), (3.0, 2.0, 0.5), (0.1, 0.1, 4.0)]:
        args = (*terms, 1e12, 2e9, 3e6, 1)
        got, want = analysis.Roofline(*args), janalysis.Roofline(*args)
        assert got.to_dict() == want.to_dict() and got.step_s == want.step_s
    rng = np.random.default_rng(0)
    for n, d in rng.integers(1, 10 ** 9, size=(4, 2)):
        assert analysis.model_flops_train(int(n), int(d)) == janalysis.model_flops_train(n, d)
        assert analysis.model_flops_decode(int(n), int(d)) == janalysis.model_flops_decode(n, d)
