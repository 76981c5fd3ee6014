"""The result line's keys and order, how ``correct`` is read from the
checks, and the runs that must print no result."""
import json
import shutil
import subprocess
import sys

import pytest

from perfbench import manifest, run, traces
from perfbench.tests.conftest import ROOT

CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def _res(trace: bool) -> dict:
    res = {"attempted": 5, "failed": 0, "memory_peak_bytes": 1,
           "end_to_end": {"out_tok_s": 2.0, "setup_s": 3.0},
           "checks": {"worst_request_gap_sd": {"value": 0.3, "limit": 0.9},
                      "tokens_checked": {"value": 2000, "limit": 1000}}}
    if trace:
        ns = 10**9
        res["trace"] = traces.reduce([("redmule_gemm_sr_kernel", 0, ns),
                                      ("paged_decode_kernel", ns, 2 * ns)], [], 0, 4 * ns)
        res["observed"] = {
            "window": {"decode_tokens": 150, "slot_steps": 160},
            "step_s": {False: [0.03] * 10, True: [0.3]}, "ttft_s": [0.5] * 5,
            "itl_s": [0.03] * 100,
            "slice": {"decode_steps": 10, "decode_tokens": 150, "prefill_steps": 1,
                      "prefill_tokens": 256},
            "slice_decode_lens": [600] * 150, "slice_first_tokens": 1,
            "slice_prompt_pairs": 256 * 257 / 2, "slots": 16, "page_size": 16,
            "pages_per_slot": 64}
        res["shape"] = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                        "head_dim": 16, "d_ff": 96, "vocab_size": 256, "n_experts": 4,
                        "top_k": 2, "w_fmt": "e4m3", "x_fmt": "e4m3", "out_fmt": "fp16",
                        "compute": "fp16", "kv_fmt": "e4m3"}
    return res


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace):
    bench = manifest.Manifest(ROOT)
    cell = bench.workload("phi3.5-moe.serve-16clients")
    dev = {"platform": "gpu", "kind": "card", "count": 1, "memory_peak_bytes": 1}
    line = json.loads(json.dumps(run.result_line(_res(trace), cell, bench, trace, dev)))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True
    names = {m["name"] for m in bench.metrics("per_layer" if trace else "end_to_end", cell)}
    assert set(line["metrics"]) == names
    for name, m in line["metrics"].items():
        assert set(name) <= CHARS and set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_correct_reads_each_check_against_its_limit():
    assert run.passed({"worst_request_gap_sd": {"value": 0.3, "limit": 0.8},
                       "tokens_checked": {"value": 700, "limit": 300}})
    assert not run.passed({"worst_request_gap_sd": {"value": 0.9, "limit": 0.8}})
    assert not run.passed({"tokens_checked": {"value": 10, "limit": 300}})
    assert not run.passed({"nonfinite_steps": {"value": 1, "limit": 0}})


def _no_result(cwd, script):
    out = subprocess.run([sys.executable, script, "--workload", "phi3.5-moe.serve-16clients",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=cwd, capture_output=True, text=True, env={"PATH": "/usr/bin:/bin",
                                                                      "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_no_card_no_result():
    _no_result(ROOT, "perfbench/run.py")


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(tmp_path, "perfbench/run.py")
