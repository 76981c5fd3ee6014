"""The GEMM-Op host wrapper's spans (``gemm.plan``, ``gemm.kmajor_copy``,
``gemm.launch``) under a host profile, on the card: they run only where
the wrapper launches the kernels. Skips without a card; on the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_spans_card.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from test_torch_spans import _spans  # noqa: E402

GEMM_SPANS = {"gemm.plan", "gemm.kmajor_copy", "gemm.launch"}
MODEL_SPANS = {"attn", "ffn", "moe.router", "moe.experts", "head"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
def test_gemm_spans_appear_under_a_host_profile(card):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import Engine
    from repro_torch.kernels import redmule_gemm as rg

    eng = Engine(policy="redmule_hfp8", backend="cuda")
    x = torch.randn(64, 512, device="cuda", dtype=torch.float16)
    w = torch.randn(512, 256, device="cuda", dtype=torch.float16)  # N-major: copied
    eng.matmul(x, w)  # builds the kernels
    torch.cuda.synchronize()
    calls = 3
    before = rg.launches.n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            eng.matmul(x, w)
        torch.cuda.synchronize()
    assert rg.launches.n - before == calls
    spans = _spans(prof)
    count = {name: sum(n == name for n, _ in spans) for name in GEMM_SPANS}
    assert count["gemm.plan"] == count["gemm.launch"] == calls, count
    assert count["gemm.kmajor_copy"] >= calls, count
    assert all(parent is None for name, parent in spans if name in GEMM_SPANS)


@pytest.mark.card
def test_a_served_prefill_nests_the_gemm_spans_in_the_models(card):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serving import Server, ServerConfig

    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b", smoke=True),
                              policy="redmule_hfp8")
    model = build(cfg, device="cuda")
    server = Server(model, model.init(0), ServerConfig(
        num_slots=2, page_size=16, max_seq_len=64, prefill_chunk=16, async_depth=1,
        prefill_batch=True), device="cuda")
    prompts = [list(range(3, 40)), list(range(5, 30))]
    server.warmup([len(p) for p in prompts])
    for p in prompts:
        server.submit(p, max_new_tokens=4)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.run()
        torch.cuda.synchronize()
    spans = _spans(prof)
    gemm = [(name, parent) for name, parent in spans if name in GEMM_SPANS]
    assert {name for name, _ in gemm} >= {"gemm.plan", "gemm.launch"}
    # The decode step is a graph replay: every GEMM-Op call here is eager.
    assert all(parent in MODEL_SPANS for _, parent in gemm), set(gemm)
    assert "engine.prefill" in {name for name, _ in spans}
