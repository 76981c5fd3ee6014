"""The plain reference agrees with itself, and with the program wherever
both compute in fp32 (the same architecture to the last bit of the
argmax), at sizes a CPU run holds."""
import time

import pytest
import torch

from perfbench import weights
from perfbench.kinds import serve_closed as sc
from perfbench.reference import decoder as ref
from perfbench.tests import sizes

FP32 = {"policy": "fp32", "weight_format": "fp32", "operand_format": "fp32",
        "compute_format": "fp32", "kv_format": "fp32", "page_size": 16}


@pytest.mark.parametrize("experts", [4, 0])
def test_a_prefix_reads_the_same_logits_alone(experts):
    cfg = sizes.phi() | {"num_local_experts": experts}
    params = weights.make(cfg, 5, "cpu")
    ids = torch.randint(0, cfg["vocab_size"], (40,), generator=torch.Generator().manual_seed(0))
    full, prefix = sc.reference_logits(cfg, params, [ids.tolist(), ids[:25].tolist()], [10, 10],
                                       sc.reference_precision(cfg), "e4m3", "cpu")
    torch.testing.assert_close(full[:15], prefix, rtol=0, atol=0)


def test_the_program_at_fp32_serves_the_references_first_tokens():
    cfg = sizes.phi()
    cfg["deployment"] = cfg["deployment"] | FP32
    out, served = sc.serve(cfg, sizes.SERVE_MIX, 9, 1.5, trace=False, device="cpu",
                           t_start=time.perf_counter())
    checks = sc.check(cfg, served, 9, {"worst_request_gap_sd": 0.0, "tokens_checked": 10}, "cpu")
    assert checks["worst_request_gap_sd"]["value"] == 0.0 and checks["tokens_checked"]["value"] >= 10


def test_int4_rounds_each_slice_to_its_own_scale():
    x = torch.tensor([[1.0, -0.5, 0.1], [100.0, 3.0, -70.0]])
    q = ref.round_to(x, "int4", -1)
    assert q[0, 0] == 1.0 and q[1, 0] == 100.0
    steps = q / (x.abs().amax(-1, keepdim=True) / 7)
    torch.testing.assert_close(steps, steps.round())
    assert steps.abs().max() <= 7
    assert ref.round_to(torch.tensor([0.3]), "e4m3", -1) == torch.tensor([0.3]).to(
        torch.float8_e4m3fn).float()
