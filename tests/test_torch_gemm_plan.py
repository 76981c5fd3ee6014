"""The GEMM-Op wrapper's planner, on the CPU: which schedule and which
K-major copies each call gets, from shapes, formats and strides alone.

The kernels themselves run only on the card (``chip_smoke.py``); what
surrounds them is pure Python and is held here: the planner on the
layouts that the serving and training paths really hand the wrapper
(recorded from a smoke-size model's prefill, decode and train step), the
batch folding and broadcasting it relies on, the plain versions of the
two auxiliary kernels, the K-major weight layout of fp8 parameters, and
the exact-sum operands that ``chip_smoke.py`` holds bitwise.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import semiring  # noqa: E402
from repro_torch.core.precision import BF16, E4M3, E5M2, FP16, cast, get_policy  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import redmule_gemm as rg  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

HFP8 = get_policy("redmule_hfp8")
MATMUL = semiring.MATMUL


def _e4(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return cast(torch.randn(shape, generator=g), E4M3)


def _plan(x, w, y=None, gop=MATMUL, policy=HFP8):
    return rg.plan_call(x, w, y, gop=gop, policy=policy).plan


def _route(plan):
    return plan.schedule, plan.copy_x, plan.copy_w


# The call sites of the serving and training paths, each with the layout the
# path hands the wrapper: (x, w, expected (schedule, copy x, copy w)).
def _call_sites():
    w_kmajor = common.dense_init(torch.Generator().manual_seed(0), 64, 96, E4M3, "cpu")["w"]
    w_train = cast(torch.randn(64, 96), E4M3)  # an fp32 parameter cast per step: (K, N) rows
    table = _e4(300, 64)
    k_cache = _e4(1, 48, 2, 32).permute(0, 2, 1, 3)  # (B, Hkv, T, hd) view of (B, T, Hkv, hd)
    g = cast(torch.randn(128, 96), E5M2)
    x = _e4(128, 64)
    return {
        "decode dense (E4M3 weight, K-major)": (_e4(4, 1, 64), w_kmajor,
                                                ("small_row", False, False)),
        "prefill dense (E4M3 weight, K-major)": (_e4(1, 32, 64), w_kmajor, ("tc", False, False)),
        "train dense forward (W rows N-contiguous)": (_e4(2, 16, 64), w_train, ("tc", False, True)),
        "decode tied logits (table.T)": (_e4(4, 1, 64), table.T, ("small_row", False, False)),
        "train tied logits (table.T)": (_e4(64, 64), table.T, ("tc", False, False)),
        "attention scores (k^T view)": (_e4(1, 2, 64, 32), k_cache.transpose(-1, -2),
                                        ("tc", False, False)),
        "attention values (v, N-contiguous)": (_e4(1, 2, 64, 48), k_cache, ("tc", False, True)),
        "backward dX = g.W^T": (g, w_train.T, ("tc", False, False)),
        "backward dW = X^T.g": (x.T, g, ("tc", True, True)),
        # K = the vocabulary, 49155 in granite: not a whole number of 16-byte
        # groups, so the cotangent is copied as well as the table.
        "backward dh = g.table": (cast(torch.randn(64, 300), E5M2), table, ("tc", True, True)),
    }


@pytest.mark.parametrize("site", list(_call_sites()))
def test_main_path_call_sites_route_by_their_strides(site):
    x, w, want = _call_sites()[site]
    assert _route(_plan(x, w)) == want


@pytest.mark.parametrize("op", [g.name for g in semiring.TABLE1 if not g.is_gemm])
def test_semiring_pairs_take_the_simt_schedule(op):
    plan = _plan(_e4(4, 64), _e4(96, 64).T, gop=semiring.get(op))
    assert _route(plan) == ("simt", False, False)


@pytest.mark.parametrize("case", ["fp32 policy", "fp16 x E4M3", "fp16 storage, bf16 compute",
                                  "fp32 storage, fp16 compute"])
def test_inexact_or_fp32_products_take_the_simt_schedule(case):
    x, w, policy = {
        "fp32 policy": (torch.randn(64, 64), torch.randn(64, 96), get_policy("fp32")),
        "fp16 x E4M3": (torch.randn(64, 64).half(), _e4(64, 96), HFP8),
        "fp16 storage, bf16 compute": (torch.randn(64, 64).half(), torch.randn(64, 96).half(),
                                       get_policy("tpu_bf16")),
        "fp32 storage, fp16 compute": (torch.randn(64, 64), torch.randn(64, 96), HFP8),
    }[case]
    assert _plan(x, w, policy=policy).schedule == "simt"


@pytest.mark.parametrize("dtype,policy", [(FP16, "redmule_fp16"), (BF16, "tpu_bf16")])
def test_16bit_operands_in_the_compute_format_take_the_tensor_cores(dtype, policy):
    x, w = torch.randn(4, 64).to(dtype), torch.randn(96, 64).to(dtype).T
    assert _route(_plan(x, w, policy=get_policy(policy))) == ("tc", False, False)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64])
def test_the_row_threshold(m):
    want = "small_row" if m <= tuning.SMALL_M_MAX else "tc"
    assert _plan(_e4(m, 4096), _e4(1000, 4096).T).schedule == want


@pytest.mark.parametrize("m,n", [(64, 160), (128, 160), (129, 160), (2048, 160), (2048, 128),
                                 (384, 96)])
def test_fp8_operands_over_many_tiles_are_widened_once(m, n):
    plan = _plan(_e4(m, 256), _e4(n, 256).T)
    wide = m > rg.TC_TILE_M and n > rg.TC_TILE_N
    assert (plan.schedule, plan.copy_x, plan.copy_w, plan.widen) == ("tc", wide, wide, wide)
    # 16-bit operands are never widened.
    x16, w16 = torch.randn(m, 256).half(), torch.randn(n, 256).half().T
    assert not _plan(x16, w16, policy=get_policy("redmule_fp16")).widen


@pytest.mark.parametrize("n,k,split", [(12800, 4096, 2), (4096, 4096, 8), (1024, 4096, 16),
                                       (4096, 12800, 8), (49155, 4096, 1), (1000, 1000, 2)])
def test_small_row_split_fills_the_card_at_the_decode_shapes(n, k, split):
    plan = rg.plan_gemm(4, n, k, 1, rg.Operand(E4M3, 4, k, k, 1),
                        rg.Operand(E4M3, n, k, k, 1), MATMUL, HFP8)
    assert plan.split == split
    assert plan.k_per_split % rg.SR_STEP == 0 and (plan.split - 1) * plan.k_per_split < k
    blocks = -(-n // rg.SR_BLOCK_N) * plan.split
    rule = tuning.SMALL_ROW_SPLIT
    assert blocks >= rule.blocks or plan.k_per_split <= 2 * rule.min_k


# The small-row rows of PERF.md's kernel table: (batch, M, K, N).
KERNEL_TABLE_SMALL_ROWS = [
    (1, 4, 4096, 12800), (1, 4, 4096, 1024), (1, 4, 4096, 4096), (1, 4, 12800, 4096),
    (1, 4, 4096, 49155), (1, 4, 1024, 16384), (1, 4, 16384, 1024), (1, 4, 1024, 49155),
    (1, 4, 7168, 32256), (1, 4, 4096, 65024), (1, 4, 4096, 32064), (1, 4, 2304, 256000),
    (1, 4, 4096, 102400), (1, 4, 102400, 4096), (1, 4, 7168, 19200), (1, 4, 2304, 9216),
    (1, 4, 2560, 2560), (1, 4, 2560, 7680), (1, 4, 7680, 2560), (1, 4, 2560, 256000),
    (32, 8, 128, 336), (32, 8, 336, 128), (1, 4, 1024, 8192), (1, 4, 8192, 1024),
    (1, 4, 1024, 256206), (1, 4, 8192, 28672), (1, 4, 28672, 8192), (1, 4, 8192, 128256),
    (1, 16, 4096, 1024), (1, 1, 4096, 1024),
]


@pytest.mark.parametrize("batch,m,k,n", KERNEL_TABLE_SMALL_ROWS)
def test_small_row_plans_split_at_most_a_cluster_and_name_no_combine(batch, m, k, n):
    """Every small-row plan of the kernel table's shapes, by the table's rule
    and by every split a caller may request, splits at most the cluster cap
    (the split blocks of a tile fold through a cluster's shared memory) and
    launches no split-K combine."""
    x, w = rg.Operand(E4M3, m, k, k, 1), rg.Operand(E4M3, n, k, k, 1)
    plans = [rg.plan_gemm(m, n, k, batch, x, w, MATMUL, HFP8)]
    plans += [rg.plan_gemm(m, n, k, batch, x, w, MATMUL, HFP8,
                           request=tuning.GemmRequest("small_row", split=s))
              for s in tuning.SPLIT_CANDIDATES]
    for plan in plans:
        assert plan.schedule == "small_row" and not plan.combines
        assert 1 <= plan.split <= rg.SR_MAX_CLUSTER == 16
        assert plan.k_per_split % rg.SR_STEP == 0 and (plan.split - 1) * plan.k_per_split < k


def test_the_simt_splits_keep_the_combine():
    x = rg.Operand(torch.float32, 64, 4096, 4096, 1)
    plan = rg.plan_gemm(64, 12800, 4096, 1, x, rg.Operand(torch.float32, 12800, 4096, 1, 12800),
                        MATMUL, get_policy("fp32"))
    assert (plan.schedule, plan.form, plan.split, plan.combines) == ("simt", "f32", 5, True)


def _copy_args(t, rows, k, strides, widen=True):
    return (t, 1, 1, rows, k, strides, widen)


@pytest.mark.parametrize("case", ["forward weight", "dW X^T", "dW dZ^T", "K-major X",
                                  "K-major fp16", "rows off 16 bytes", "base off 16 bytes",
                                  "no unit stride", "batched"])
def test_copy_route(case):
    """The K-major copy's kernel for each source: the tile kernel where the
    rows are the unit-stride axis and each K row is 16-byte aligned, the
    row widening for K-major fp8, the element-wise kernel for the rest."""
    w = _e4(64, 96)  # (K, N) row-major: N the unit-stride axis
    x = _e4(32, 64)
    t, rows, k, strides, widen, route = {
        "forward weight": (w, 96, 64, [0, 0, 1, 96], True, "tile"),
        "dW X^T": (x, 64, 32, [0, 0, 1, 64], True, "tile"),
        "dW dZ^T": (cast(torch.randn(32, 96), E5M2), 96, 32, [0, 0, 1, 96], True, "tile"),
        "K-major X": (x, 32, 64, [0, 0, 64, 1], True, "rows"),
        "K-major fp16": (torch.randn(32, 64).half(), 32, 64, [0, 0, 64, 1], False, "elements"),
        "rows off 16 bytes": (_e4(64, 100), 100, 64, [0, 0, 1, 100], True, "elements"),
        "base off 16 bytes": (_e4(64, 112)[:, 1:97], 96, 64, [0, 0, 1, 112], True, "elements"),
        "no unit stride": (_e4(64, 192)[:, ::2], 96, 64, [0, 0, 2, 192], True, "elements"),
        "batched": (_e4(2, 64, 96), 96, 64, [64 * 96, 0, 1, 96], False, "tile"),
    }[case]
    b1 = 2 if case == "batched" else 1
    assert rg.copy_route(t, b1, 1, rows, k, strides, widen) == route
    assert list(rg.COPY_ROUTES) == ["tile", "rows", "elements"]  # enum CopyRoute's order


@pytest.mark.parametrize("case", ["row stride not 16-byte", "K not 16-byte", "k stride 2",
                                  "batch stride not 16-byte", "address offset", "K-major"])
def test_operand_kmajor_rule(case):
    op = {
        "row stride not 16-byte": rg.Operand(E4M3, 8, 64, 72 + 1, 1),
        "K not 16-byte": rg.Operand(E4M3, 8, 60, 64, 1),
        "k stride 2": rg.Operand(E4M3, 8, 64, 128, 2),
        "batch stride not 16-byte": rg.Operand(E4M3, 8, 64, 64, 1, (0, 520)),
        "address offset": rg.Operand(E4M3, 8, 64, 64, 1, (0, 0), 8),
        "K-major": rg.Operand(FP16, 8, 64, 64, 1, (4096, 512)),
    }[case]
    assert op.kmajor() == (case == "K-major")


def test_decode_activations_fold_into_rows_and_a_broadcast_x_does_not():
    w = _e4(96, 64).T
    call = rg.plan_call(_e4(4, 1, 64), w, None, gop=MATMUL, policy=HFP8)
    assert (call.m, call.b1, call.b2, call.out_shape) == (4, 1, 1, (4, 1, 96))
    # A y shared by the batch folds too, as rows 0 apart.
    call = rg.plan_call(_e4(4, 1, 64), w, torch.zeros(1, 96), gop=MATMUL, policy=HFP8)
    assert (call.m, call.b1 * call.b2, call.sy[2]) == (4, 1, 0)
    # An x shared by a batched y cannot: the kernels walk the batch.
    call = rg.plan_call(_e4(4, 64), w, torch.zeros(3, 4, 96), gop=MATMUL, policy=HFP8)
    assert (call.m, call.b1 * call.b2, call.out_shape) == (4, 3, (3, 4, 96))


@pytest.mark.parametrize("shapes", [((2, 1, 3), (4, 1), ()), ((), (5,), (1,)),
                                    ((1,), (3, 1, 1)), ((7, 1), (1, 6))])
def test_broadcast_matches_torch(shapes):
    assert rg._broadcast(*shapes) == tuple(torch.broadcast_shapes(*shapes))


def test_broadcast_refuses_what_torch_refuses():
    with pytest.raises(ValueError):
        rg._broadcast((2, 3), (4, 3))


@pytest.mark.parametrize("es", [1, 2])
def test_kmajor_copy_plain_transposes_exactly_and_zeroes_the_pad(es):
    w = _e4(2, 37, 21) if es == 1 else torch.randn(2, 37, 21).half()
    # W (b, K=37, N=21) read as rows of N: strides (b, row=n, k).
    buf = rg.kmajor_copy_plain(w, 2, 1, 21, 37, [w.stride(0), 0, 1, 21])
    kp = -(-37 * es // 16) * 16 // es
    assert buf.shape == (2, 1, 21, kp)
    assert torch.equal(buf[:, 0, :, :37].float(), w.transpose(-1, -2).float())
    assert not buf[..., 37:].float().any()


@pytest.mark.parametrize("fmt", [E4M3, E5M2])
def test_kmajor_copy_plain_widens_fp8_exactly(fmt):
    w = cast(torch.randn(2, 37, 21) * 4, fmt)
    buf = rg.kmajor_copy_plain(w, 2, 1, 21, 37, [w.stride(0), 0, 1, 21], widen=True)
    assert buf.dtype == FP16 and buf.shape == (2, 1, 21, 40)  # 37 fp16 padded to 16 bytes
    assert torch.equal(buf[:, 0, :, :37].float(), w.transpose(-1, -2).float())
    assert not buf[..., 37:].float().any()


def test_splitk_combine_plain_sums_in_split_order():
    ws = torch.tensor([[[[1e8, 1.0]]], [[[-1e8, 1.0]]], [[[1.0, 1.0]]]]).permute(1, 0, 2, 3)
    got = rg.splitk_combine_plain(ws.contiguous(), None, torch.float32)
    assert got.tolist() == [[[1.0, 3.0]]]  # (1e8 + -1e8) + 1, not 1e8 + (-1e8 + 1)


def test_fp8_weights_are_made_kmajor_with_the_same_values():
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    w8 = common.dense_init(gen(), 64, 96, E4M3, "cpu")["w"]
    w16 = common.dense_init(gen(), 64, 96, FP16, "cpu")["w"]
    assert w8.shape == (64, 96) and w8.stride() == (1, 64)
    assert w16.is_contiguous()
    want = cast(torch.randn((64, 96), generator=gen()) / 8, E4M3)  # the same draw, 1/sqrt(64)
    assert torch.equal(w8.view(torch.uint8), want.view(torch.uint8))


def test_params_from_jax_gives_kmajor_fp8_weights():
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), fp8_params=True)
    rng = np.random.default_rng(0)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    dq, dkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32).astype(np.float16)

    tree = {
        "embed": {"table": w(cfg.vocab_size, d)},
        "final_norm": {"scale": np.ones(d, np.float32)},
        "decoder": {"rem": {}, "units": {"b0": {
            "norm1": {"scale": np.ones((L, d), np.float32)},
            "norm2": {"scale": np.ones((L, d), np.float32)},
            "attn": {n: {"w": w(L, d if n != "o" else dq, s)} for n, s in
                     (("q", dq), ("k", dkv), ("v", dkv), ("o", d))},
            "ffn": {"up": {"w": w(L, d, f)}, "gate": {"w": w(L, d, f)}, "down": {"w": w(L, f, d)}},
        }}},
    }
    tree16 = params_from_jax(tree, cfg)
    for i, layer in enumerate(tree16["layers"]):
        for name, p in list(layer["attn"].items()) + list(layer["ffn"].items()):
            src = (tree["decoder"]["units"]["b0"]["attn"] | tree["decoder"]["units"]["b0"]["ffn"])
            assert p["w"].is_contiguous()  # 16-bit weights keep their layout
            np.testing.assert_array_equal(p["w"].numpy(), src[name]["w"][i])
    # An E4M3 tree: the same bytes, presented K-major.
    q = cast(torch.from_numpy(tree["decoder"]["units"]["b0"]["ffn"]["up"]["w"]).float(), E4M3)
    tree8 = dict(tree)
    units = dict(tree["decoder"]["units"]["b0"])
    units["ffn"] = dict(units["ffn"], up={"w": q.view(torch.uint8).numpy().view(_ml_e4m3())})
    tree8["decoder"] = {"rem": {}, "units": {"b0": units}}
    up = params_from_jax(tree8, cfg)["layers"][1]["ffn"]["up"]["w"]
    assert up.dtype == E4M3 and up.shape == (d, f) and up.stride() == (1, d)
    assert torch.equal(up.view(torch.uint8), q[1].view(torch.uint8))


def _ml_e4m3():
    ml = pytest.importorskip("ml_dtypes")
    return ml.float8_e4m3fn


def _exact_operand():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._exact_operand


def test_exact_sum_operands_sum_the_same_in_every_order():
    make = _exact_operand()
    gen = torch.Generator().manual_seed(0)
    x, w = make(gen, 8, 2048), make(gen, 96, 2048).T
    assert set(x.float().unique().tolist()) <= {-1.0, 0.0, 1.0}
    kw = dict(gop=MATMUL, policy=HFP8, out_dtype=FP16)
    want = rg.redmule_gemm_plain(x, w, None, **kw)
    assert want.float().abs().max() < 2 ** 11
    for seed in range(3):
        perm = torch.randperm(2048, generator=torch.Generator().manual_seed(seed))
        got = rg.redmule_gemm_plain(x[:, perm], w[perm], None, **kw)
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # And summed one product at a time, in reverse order.
    prods = x.float()[:, :, None] * w.float()[None]
    acc = torch.zeros(8, 96)
    for k in reversed(range(2048)):
        acc = acc + prods[:, k]
    assert torch.equal(cast(acc, FP16).view(torch.int16), want.view(torch.int16))


class _Recorder:
    """Records the plan of every GEMM that reaches the plain version."""

    def __init__(self, monkeypatch):
        self.plans = []
        orig = ops.redmule_gemm_plain

        def record(x, w, y, *, gop, policy, out_dtype):
            self.plans.append(rg.plan_call(x, w, y, gop=gop, policy=policy).plan)
            return orig(x, w, y, gop=gop, policy=policy, out_dtype=out_dtype)

        monkeypatch.setattr(ops, "redmule_gemm_plain", record)

    def take(self):
        plans, self.plans = self.plans, []
        return plans


def _smoke_model(**kw):
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), policy="redmule_hfp8",
                              **kw)
    return Transformer(cfg, engine=Engine(policy=cfg.policy, backend="torch"), device="cpu",
                       fused_decode=True)


def test_serving_steps_route_as_on_the_card(monkeypatch):
    """A prefill of a 32-token bucket and a 4-slot decode step of the smoke
    model with E4M3 weights: every decode GEMM on the small-row schedule,
    every prefill GEMM on the tensor cores but the last token's logits, and
    no weight copied."""
    model = _smoke_model(kv_cache_dtype="e4m3", fp8_params=True)
    params = model.init(0)
    rec = _Recorder(monkeypatch)
    n_layers, ps = model.cfg.n_layers, 4
    pools = model.init_state_store(4, 40, ps)
    page_row = torch.arange(1, 10, dtype=torch.int32)
    with torch.inference_mode():
        tokens = torch.randint(0, model.cfg.vocab_size, (1, 32))
        model.prefill_cb(params, tokens, pools, page_row, 0, 0, 30, page_size=ps)
        prefill = rec.take()
        pt = torch.arange(1, 37, dtype=torch.int32).reshape(4, 9)
        model.decode_cb(params, torch.randint(0, model.cfg.vocab_size, (4, 1)), pools, pt,
                        torch.tensor([30, 5, 9, 0], dtype=torch.int32),
                        torch.ones(4, dtype=torch.bool), page_size=ps)
        decode = rec.take()
    assert len(decode) == 7 * n_layers + 1
    assert all(_route(p) == ("small_row", False, False) for p in decode)
    assert len(prefill) == 9 * n_layers + 1
    assert [p.schedule for p in prefill].count("small_row") == 1  # the last token's logits
    assert all(p.schedule == "tc" for p in prefill[:-1])
    # Only the attention values product (v, N-contiguous) is copied.
    assert sum(p.copy_x or p.copy_w for p in prefill) == n_layers


def test_train_step_routes_every_gemm_to_the_tensor_cores(monkeypatch):
    """One loss and gradient of the smoke model (head_dim 32, so the
    attention products' weight gradients have more rows than the small-row
    threshold, as at full width): every forward and backward GEMM plans
    the tensor-core schedule."""
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.training import make_loss_fn

    model = _smoke_model(head_dim=32, remat="block")
    params = model.init(0)
    rec = _Recorder(monkeypatch)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 32))
    loss, _ = make_loss_fn(model)(live, {"tokens": tokens})
    torch.autograd.grad(loss, leaves(live))
    plans = rec.take()
    assert plans and all(p.schedule == "tc" for p in plans)
