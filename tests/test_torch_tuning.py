"""The port's plan-selection layer (``repro_torch.kernels.tuning``), on the CPU.

- With no argument and no environment variable every call gets the plan
  that ``PERF.md``'s kernel table records for it (the tables are the old
  constants, moved).
- Explicit arguments win over ``REPRO_TORCH_GEMM_PLAN`` /
  ``REPRO_TORCH_DECODE_SPLITS``, which win over the tables; a malformed
  value warns and falls back; a field a call's kernels cannot take is
  dropped for that call; the environment is read once a process.
- The autotuner's candidates stay within what the kernels accept; its
  cache key, atomic write and one read a process; nothing is timed while
  a stream captures (the capture test monkeypatched: no card here).
- ``ops``' plan arguments reach the kernel wrappers.
"""
import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import semiring  # noqa: E402
from repro_torch.core.precision import BF16, E4M3, FP16, FP32, get_policy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import redmule_gemm as rg  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels.tuning import GemmRequest  # noqa: E402

HFP8 = get_policy("redmule_hfp8")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in (tuning.GEMM_PLAN_ENV, tuning.DECODE_SPLITS_ENV, "REPRO_AUTOTUNE",
                 "REPRO_AUTOTUNE_CACHE"):
        monkeypatch.delenv(name, raising=False)
    tuning.reset_cache()
    yield
    tuning.reset_cache()  # no later test keeps this one's environment


def _kmajor(dtype, rows, k):
    return rg.Operand(dtype, rows, k, k, 1)


def _plan(m, k, n, *, dtype=E4M3, policy=HFP8, op="matmul", batch=1, request=None):
    return rg.plan_gemm(m, n, k, batch, _kmajor(dtype, m, k), _kmajor(dtype, n, k),
                        semiring.get(op), policy, request=request)


# (label, M, K, N, format, policy, op, batch) -> (schedule, split, form, widen): the
# kernel table's rows (M x K x N).
PINNED_GEMMS = {
    "granite decode 4x4096x12800": ((4, 4096, 12800, E4M3, HFP8, "matmul", 1),
                                    ("small_row", 2, "", False)),
    "moe decode down 4x16384x1024": ((4, 16384, 1024, E4M3, HFP8, "matmul", 1),
                                     ("small_row", 16, "", False)),
    "gemma2 decode 4x2304x9216": ((4, 2304, 9216, E4M3, HFP8, "matmul", 1),
                                  ("small_row", 2, "", False)),
    "rglru 4x2560x2560": ((4, 2560, 2560, E4M3, HFP8, "matmul", 1), ("small_row", 8, "", False)),
    "recurrentgemma geglu up 4x2560x7680": ((4, 2560, 7680, E4M3, HFP8, "matmul", 1),
                                            ("small_row", 4, "", False)),
    "recurrentgemma geglu down 4x7680x2560": ((4, 7680, 2560, E4M3, HFP8, "matmul", 1),
                                              ("small_row", 8, "", False)),
    "seamless ffn up 4x1024x8192": ((4, 1024, 8192, E4M3, HFP8, "matmul", 1),
                                    ("small_row", 4, "", False)),
    "seamless ffn down 4x8192x1024": ((4, 8192, 1024, E4M3, HFP8, "matmul", 1),
                                      ("small_row", 16, "", False)),
    "internvl2 gate/up 4x8192x28672": ((4, 8192, 28672, E4M3, HFP8, "matmul", 1),
                                       ("small_row", 1, "", False)),
    "internvl2 down 4x28672x8192": ((4, 28672, 8192, E4M3, HFP8, "matmul", 1),
                                    ("small_row", 4, "", False)),
    "fp32 64x4096x12800": ((64, 4096, 12800, FP32, get_policy("fp32"), "matmul", 1),
                           ("simt", 5, "f32", False)),
    "apsp 64x4096x12800 e4m3": ((64, 4096, 12800, E4M3, HFP8, "apsp", 1), ("simt", 5, "h2", False)),
    "router backward X^T.g 1024x2048x32": ((1024, 2048, 32, FP32, get_policy("fp32"), "matmul", 1),
                                           ("simt", 8, "f32", False)),
    "router 4x1024x32": ((4, 1024, 32, FP32, get_policy("fp32"), "matmul", 1),
                         ("simt", 1, "warp", False)),
    "train forward 2048x4096x12800": ((2048, 4096, 12800, E4M3, HFP8, "matmul", 1),
                                      ("tc", 1, "", True)),
    "prefill 64x4096x12800": ((64, 4096, 12800, E4M3, HFP8, "matmul", 1), ("tc", 1, "", False)),
    "verify 20x4096x12800": ((20, 4096, 12800, E4M3, HFP8, "matmul", 1), ("tc", 1, "", False)),
}


@pytest.mark.parametrize("label", list(PINNED_GEMMS))
def test_default_gemm_plans_are_the_kernel_tables(label):
    (m, k, n, dtype, policy, op, batch), want = PINNED_GEMMS[label]
    plan = _plan(m, k, n, dtype=dtype, policy=policy, op=op, batch=batch)
    assert (plan.schedule, plan.split, plan.form, plan.widen) == want
    if want[1] > 1:
        step = rg.SR_STEP if want[0] == "small_row" else rg.SIMT_BK
        assert plan.k_per_split % step == 0 and (plan.split - 1) * plan.k_per_split < k
    if want[3]:  # widened: both operands through the copy (+2 launches)
        assert plan.copy_x and plan.copy_w


# (S, Hq, Hkv, hd, pages a slot) -> splits: the serve run's 7-page tables,
# 16 slots of 4096 tokens, gemma2's hd-256 decode (5000 tokens) and
# recurrentgemma's MQA (a group of 10 on blocks of 4; 3000 tokens).
PINNED_DECODES = {"serve": ((4, 32, 8, 7), 1), "S16 x 4096": ((16, 32, 8, 256), 4),
                  "gemma2": ((4, 8, 4, 313), 19), "recurrentgemma": ((4, 10, 1, 188), 11)}


@pytest.mark.parametrize("label", list(PINNED_DECODES))
def test_default_decode_splits_are_the_kernel_tables(label):
    (s, hq, hkv, pages), want = PINNED_DECODES[label]
    groups = -(-(hq // hkv) // fa._DECODE_GROUP)
    assert fa.decode_splits is tuning.decode_splits
    assert fa.decode_splits(s, hkv, pages, groups=groups) == want


def test_explicit_beats_env_beats_table(monkeypatch):
    x, w = torch.randn(4, 4096).to(E4M3), torch.randn(12800, 4096).to(E4M3).T
    kw = dict(gop=semiring.MATMUL, policy=HFP8)
    assert rg.plan_call(x, w, None, **kw).plan.split == 2  # the table
    monkeypatch.setenv(tuning.GEMM_PLAN_ENV, "split=8")
    tuning.reset_cache()
    assert rg.plan_call(x, w, None, **kw).plan.split == 8  # the environment
    plan = rg.plan_call(x, w, None, request=GemmRequest(split=16), **kw).plan
    assert (plan.schedule, plan.split) == ("small_row", 16)  # the argument
    # Field by field: the argument's schedule, the environment's split.
    plan = rg.plan_call(x, w, None, request=GemmRequest(schedule="simt"), **kw).plan
    assert (plan.schedule, plan.form, plan.split) == ("simt", "f32", 8)
    monkeypatch.setenv(tuning.GEMM_PLAN_ENV, "schedule=tc,widen=1")
    tuning.reset_cache()
    plan = rg.plan_call(x, w, None, **kw).plan
    assert (plan.schedule, plan.widen, plan.copy_x, plan.copy_w) == ("tc", True, True, True)
    monkeypatch.setenv(tuning.DECODE_SPLITS_ENV, "3")
    tuning.reset_cache()
    assert tuning.settings().decode_splits == 3


def test_fields_a_call_cannot_take_are_dropped():
    # small rows for 16-bit operands, a split of the tensor cores, warps
    # past their outputs, h2 for (mul, add), widening 16-bit operands.
    fp16 = get_policy("redmule_fp16")
    assert _plan(4, 4096, 1024, dtype=FP16, policy=fp16,
                 request=GemmRequest(schedule="small_row")).schedule == "tc"
    assert _plan(64, 4096, 1024, request=GemmRequest(split=4)).split == 1
    assert _plan(64, 4096, 1024, dtype=FP32, policy=get_policy("fp32"),
                 request=GemmRequest(form="warp")).form == "f32"
    assert _plan(4, 64, 64, dtype=FP16, policy=fp16,
                 request=GemmRequest(schedule="simt", form="h2")).form == "f32"
    assert not _plan(256, 256, 256, dtype=BF16, policy=get_policy("tpu_bf16"),
                     request=GemmRequest(widen=True)).widen
    # ... and a semiring pair stays on the SIMT schedule whatever is asked.
    assert _plan(4, 64, 64, op="apsp", request=GemmRequest(schedule="tc")).schedule == "simt"


@pytest.mark.parametrize("raw", ["split=0", "schedule=fast", "split=four", "widen=yes", "tc"])
def test_malformed_env_warns_and_falls_back(raw, monkeypatch):
    monkeypatch.setenv(tuning.GEMM_PLAN_ENV, raw)
    with pytest.warns(UserWarning, match=tuning.GEMM_PLAN_ENV):
        assert tuning.settings().gemm is tuning.NO_REQUEST
    assert _plan(4, 4096, 12800).split == 2
    monkeypatch.setenv(tuning.DECODE_SPLITS_ENV, "-2")
    tuning.reset_cache()
    with pytest.warns(UserWarning, match=tuning.DECODE_SPLITS_ENV):
        assert tuning.settings().decode_splits is None


def test_malformed_arguments_raise():
    for bad in (dict(schedule="fast"), dict(split=0), dict(form="wide")):
        with pytest.raises(ValueError):
            GemmRequest(**bad)
        with pytest.raises(ValueError):  # on the plain path too
            ops.gemm_op(torch.randn(4, 8), torch.randn(8, 4), **bad)
    q, pool = torch.randn(2, 4, 8), torch.randn(16, 2, 8)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, pool, pool, torch.ones(2, 2, dtype=torch.int32),
                                   torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=bool),
                                   page_size=8, splits=0)


def _call(m, k, n, dtype, policy, op="matmul", w_kmajor=True):
    x = torch.zeros((m, k)).to(dtype)
    w = torch.zeros((n, k)).to(dtype).T if w_kmajor else torch.zeros((k, n)).to(dtype)
    return rg.plan_call(x, w, None, gop=semiring.get(op), policy=policy)


@pytest.mark.parametrize("case", [
    (4, 4096, 12800, E4M3, "redmule_hfp8", "matmul", True),
    (4, 16384, 1024, E4M3, "redmule_hfp8", "matmul", False),
    (16, 1000, 96, E4M3, "redmule_hfp8", "matmul", True),
    (300, 512, 640, E4M3, "redmule_hfp8", "matmul", True),
    (64, 4096, 1280, FP32, "fp32", "matmul", True),
    (4, 1024, 32, FP32, "fp32", "matmul", False),
    (64, 4096, 1280, E4M3, "redmule_hfp8", "apsp", True),
    (64, 100, 64, FP16, "redmule_fp16", "matmul", True),
])
def test_candidates_stay_within_the_kernels_limits(case):
    m, k, n, dtype, pol, op, w_kmajor = case
    policy = get_policy(pol)
    call = _call(m, k, n, dtype, policy, op, w_kmajor)
    plans = tuning.gemm_candidates(call, semiring.get(op), policy)
    assert plans[0] == call.plan and len(plans) == len(set(plans))
    x, w = call.x_operand(), call.w_operand()
    for p in plans:
        assert p.schedule in rg.schedules_for(m, k, x, w, semiring.get(op), policy)
        if p.schedule == "small_row":
            assert dtype == E4M3 and m <= rg.SR_MAX_M and p.k_per_split % rg.SR_STEP == 0
        elif p.schedule == "simt":
            assert p.form in rg.simt_forms_for(m, n, 1, semiring.get(op), policy)
            if p.form == "warp":
                assert p.split == 1 and m * n <= tuning.SIMT_WARP_MAX_OUTPUTS
            else:
                assert p.k_per_split % rg.SIMT_BK == 0
        else:
            assert p.split == 1 and (not p.widen or dtype == E4M3)
        assert 1 <= p.split <= tuning.MAX_GRID_YZ and (p.split - 1) * p.k_per_split < max(k, 1)
        # Each candidate is a plan a request reaches, and the same one again.
        again = rg.plan_gemm(m, n, k, 1, x, w, semiring.get(op), policy,
                             request=tuning.request_of(p))
        assert again == p
    assert len(plans) > 1 or call.plan.schedule == "tc"


def test_decode_candidates_are_every_distinct_split():
    got = tuning.decode_candidates(313, 19)
    assert got[0] == 19 and len(got) == len(set(got))
    assert all(tuning.effective_splits(313, n) == n for n in got)
    assert 1 in got and 64 in got or max(got) <= 64
    assert tuning.decode_candidates(7, 1) == [1, 2, 3, 4, 7]


def test_cache_key_atomic_write_and_one_read_a_process(tmp_path, monkeypatch):
    monkeypatch.setattr(tuning, "_device_name", lambda t: "H100")
    call = _call(4, 4096, 1024, E4M3, HFP8, w_kmajor=False)
    key = tuning.gemm_key(call, semiring.MATMUL, HFP8)
    assert key == "H100/gemm/matmul/redmule_hfp8/float8_e4m3fnxfloat8_e4m3fn/kmajor10/1x4x1024x4096"
    q = torch.zeros(4, 8, 4, 256, dtype=FP16)
    assert tuning.decode_key(q, torch.zeros(1, dtype=E4M3), 313, 16, 4096) == (
        "H100/paged_decode/S4xHq32xHkv8xhd256/ps16xP313/float8_e4m3fn/w4096")
    path = str(tmp_path / "sub" / "plans.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    tuning.reset_cache()
    assert tuning.default_cache_path() == tuning.settings().cache_path == path
    tuning._store(key, {"plan": dataclasses.asdict(call.plan)}, None)
    assert json.load(open(path))[key]["plan"]["split"] == call.plan.split
    assert os.listdir(tmp_path / "sub") == ["plans.json"]  # the tmp file was renamed
    reads = []
    real_open = open
    monkeypatch.setattr("builtins.open", lambda *a, **k: reads.append(a[0]) or real_open(*a, **k))
    tuning.reset_cache()
    for _ in range(3):
        assert tuning.lookup(key)["plan"]["split"] == call.plan.split
    assert reads == [path]
    # The default path is the port's own, never the reference's file.
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert tuning.default_cache_path().endswith(os.path.join(".cache", "repro_torch",
                                                              "plans.json"))


def test_no_timing_or_write_while_a_stream_captures(tmp_path, monkeypatch):
    monkeypatch.setattr(tuning, "_device_name", lambda t: "H100")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    path = str(tmp_path / "plans.json")
    call = _call(4, 4096, 12800, E4M3, HFP8)
    before = tuning.timed
    plan = tuning.autotune_gemm(None, None, None, call, gop=semiring.MATMUL, policy=HFP8,
                                out_dtype=FP16, path=path)
    assert plan == call.plan
    q, pool, live = torch.zeros(4, 8, 4, 128), torch.zeros(1, dtype=E4M3), torch.ones(4)
    splits = tuning.autotune_decode(lambda n: pytest.fail("launched"), q, pool, live, 7, 16,
                                    None, 1, path=path)
    assert splits == 1 and tuning.timed == before and not os.path.exists(path)
    # A cached plan is read during a capture.
    tuning._store(tuning.gemm_key(call, semiring.MATMUL, HFP8),
                  {"plan": dataclasses.asdict(dataclasses.replace(call.plan, split=4,
                                                                  k_per_split=1024))}, path)
    plan = tuning.autotune_gemm(None, None, None, call, gop=semiring.MATMUL, policy=HFP8,
                                out_dtype=FP16, path=path)
    assert plan.split == 4 and tuning.timed == before
    # Outside a capture, a decode with no active slot (a graph's warm-up)
    # times nothing and caches nothing either.
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert tuning.autotune_decode(lambda n: pytest.fail("launched"), q, pool, torch.zeros(4),
                                  7, 16, None, 1, path=path) == 1
    assert tuning.lookup(tuning.decode_key(q, pool, 7, 16, None), path) is None


def test_the_environment_is_read_once_a_process(monkeypatch):
    x, w = torch.randn(4, 4096).to(E4M3), torch.randn(12800, 4096).to(E4M3).T
    kw = dict(gop=semiring.MATMUL, policy=HFP8)
    assert rg.plan_call(x, w, None, **kw).plan.split == 2
    monkeypatch.setenv(tuning.GEMM_PLAN_ENV, "split=8")
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    # Read already: a call keeps the switches of the first read ...
    assert rg.plan_call(x, w, None, **kw).plan.split == 2
    assert not tuning.settings().autotune
    # ... until reset_cache() reads the environment again.
    tuning.reset_cache()
    assert rg.plan_call(x, w, None, **kw).plan.split == 8
    assert tuning.settings().autotune


def test_ops_plan_arguments_reach_the_kernel_wrappers(monkeypatch):
    """``ops.gemm_op``'s plan arguments reach the GEMM wrapper as one
    request (none when none is given), and ``ops.paged_decode_attention``'s
    splits reach the decode wrapper (the wrappers recorded, their plain
    versions computing)."""
    requests, seen = [], []

    def gemm(x, w, y, *, request=None, **kw):
        requests.append(request)
        return rg.redmule_gemm_plain(x, w, y, **kw)

    def decode(*args, splits=None, **kw):
        seen.append(splits)
        return fa.paged_flash_decode_plain(*args, **kw)

    x, w = torch.randn(4, 64), torch.randn(64, 32)
    want = ops.matmul(x, w, backend="torch")
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, t: "cuda")
    monkeypatch.setattr(ops, "redmule_gemm", gemm)
    monkeypatch.setattr(ops, "paged_flash_decode", decode)
    assert torch.equal(ops.gemm_op(x, w, schedule="simt", split=3, form="f32"), want)
    assert torch.equal(ops.matmul(x, w, widen=True), want)
    ops.gemm_op(x, w)
    assert requests == [GemmRequest("simt", 3, "f32", None), GemmRequest(widen=True), None]
    q, pool = torch.randn(2, 4, 8), torch.randn(24, 2, 8)
    args = (q, pool, pool, torch.tensor([[1, 0], [2, 0]], dtype=torch.int32),
            torch.tensor([3, 5], dtype=torch.int32), torch.ones(2, dtype=bool))
    for splits in (2, None):
        out = ops.paged_decode_attention(*args, page_size=8, splits=splits)
        assert out.shape == q.shape and torch.isfinite(out).all()
    assert seen == [2, None]
