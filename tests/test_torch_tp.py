"""The tensor-parallel layer pieces of ``distrib/tensor_parallel.py`` at tp 2,
two gloo processes (one spawn, ``tests/test_torch_ranks.py::rank_tp_layers``)
against the same functions computed whole in this process, on the CPU.

- ``column_linear`` (the output columns split; backward the dX partials
  summed in fp32), ``row_linear`` (the input rows split; the fp32
  partials summed, one cast), ``gather_from`` and ``split_to``: forward
  and gradients within 1e-6 of max|value| under fp32 (the sums split in
  two, in another order);
- ``vocab_embed``: the rows bit for bit, signed zeros included (-0.0 is
  the rank sum's identity), and the table pieces' gradients;
- ``vocab_xent``: the loss and the logits' gradient within 1e-6;
- the row-parallel sum under redmule_hfp8 is made in fp32 and rounded to
  fp16 once: on operands whose two partial sums are 2049 and 1 the
  output is the one-process product's 2050 bit for bit, where summing
  fp16-rounded partials would give 2048.
"""
import numpy as np
import pytest
import torch

from repro_torch.engine import Engine
from test_torch_ranks import rank_tp_layers, run_ranks


def _case():
    rng = np.random.default_rng(0)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    table = f32(10, 4)
    table[3, 1], table[7, 2], table[2, 0] = -0.0, 0.0, -0.0
    x8 = np.zeros((1, 32), np.float32)
    w8 = np.zeros((32, 2), np.float32)
    x8[0, :8], x8[0, 8], x8[0, 16] = 16.0, 1.0, 1.0  # rank 0's partial 2049, rank 1's 1
    w8[:8, 0], w8[8, 0], w8[16, 0] = 16.0, 1.0, 1.0
    w8[:, 1] = rng.integers(-4, 5, 32)
    return {"x": f32(2, 5, 8), "w": f32(8, 6), "g_col": f32(2, 5, 6),
            "xr": f32(2, 5, 8), "wr": f32(8, 6), "g_row": f32(2, 5, 6), "g_x": f32(2, 5, 8),
            "table": table, "tokens": np.array([[3, 7, 2, 9], [0, 5, 3, 4]]),
            "g_emb": f32(2, 4, 4), "logits": f32(2, 3, 10) * 3,
            "labels": np.array([[1, 6, 9], [5, 0, 4]]),
            "mask": np.array([[1, 1, 0], [1, 1, 1]], np.float32), "x8": x8, "w8": w8}


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    return run_ranks(rank_tp_layers, 2, tmp_path_factory.mktemp("tp_layers"), case, timeout=120)


def _close(got, want, tol=1e-6):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _grads(fn, arrays, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out.detach().numpy(), [t.numpy() for t in torch.autograd.grad(
        (out * torch.from_numpy(g)).sum(), ts)]


def _half(a, r, dim):
    n = a.shape[dim] // 2
    return np.take(a, range(r * n, (r + 1) * n), axis=dim)


def test_column_and_row_linear_match_one_process(case, ranks):
    eng = Engine(policy="fp32", backend="torch")
    y, (dx, dw) = _grads(eng.matmul, [case["x"], case["w"]], case["g_col"])
    yr, (dxr, dwr) = _grads(eng.matmul, [case["xr"], case["wr"]], case["g_row"])
    for r, out in enumerate(ranks):
        got, (gx, gw) = out["column"]
        _close(got, _half(y, r, -1))
        _close(gx, dx)  # the dX partials summed over the axis
        _close(gw, _half(dw, r, 1))
        got, (gx, gw) = out["row"]
        _close(got, yr)  # the fp32 partials summed
        _close(gx, _half(dxr, r, -1))
        _close(gw, _half(dwr, r, 0))


def test_gather_and_split_match_one_process(case, ranks):
    x, g = case["x"], case["g_x"]
    for r, out in enumerate(ranks):
        got, (gx,) = out["gather"]
        _close(got, x * x)
        _close(gx, _half(2 * x * g, r, -1))  # this rank's slice of the whole gradient
        got, (gx,) = out["split"]
        _close(got, _half(x * x, r, -1))
        _close(gx, 2 * x * g)  # the slices' gradients gathered whole


def test_vocab_embed_is_bit_for_bit(case, ranks):
    table = torch.from_numpy(case["table"]).requires_grad_()
    rows = table[torch.from_numpy(case["tokens"])]
    want_bits = rows.detach().view(torch.int32).numpy()
    grad = torch.autograd.grad((rows * torch.from_numpy(case["g_emb"])).sum(), table)[0].numpy()
    assert (want_bits == np.int32(-2 ** 31)).any()  # a -0.0 row element is carried
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["embed_bits"], want_bits)
        np.testing.assert_array_equal(out["embed_grad"], _half(grad, r, 0))


def test_vocab_xent_matches_one_process(case, ranks):
    logits = torch.from_numpy(case["logits"]).requires_grad_()
    labels, mask = torch.from_numpy(case["labels"]), torch.from_numpy(case["mask"])
    ll = logits.gather(-1, labels[..., None])[..., 0]
    loss = ((torch.logsumexp(logits, -1) - ll) * mask).sum()
    grad = torch.autograd.grad(loss, logits)[0].numpy()
    for r, out in enumerate(ranks):
        got, g = out["xent"]
        assert abs(got - float(loss.detach())) <= 1e-6 * abs(float(loss.detach()))
        _close(g, _half(grad, r, -1))


def test_row_parallel_output_is_rounded_once_after_an_fp32_sum(case, ranks):
    eng = Engine(policy="redmule_hfp8", backend="torch")
    x8, w8 = torch.from_numpy(case["x8"]), torch.from_numpy(case["w8"])
    want = eng.matmul(x8, w8)
    assert want.dtype == torch.float16 and float(want[0, 0]) == 2050.0
    # Partials rounded to fp16 before the sum: 2049 -> 2048, then 2048 + 1 -> 2048.
    parts = [eng.matmul(x8[:, h * 16:(h + 1) * 16], w8[h * 16:(h + 1) * 16]) for h in (0, 1)]
    assert float((parts[0] + parts[1])[0, 0]) == 2048.0
    for out in ranks:
        np.testing.assert_array_equal(out["row_hfp8"], want.float().numpy())


@pytest.mark.parametrize("arch", __import__("repro_torch.configs", fromlist=["ARCH_IDS"]).ARCH_IDS)
def test_executed_specs_on_a_1_2_mesh_are_param_specs_at_full_width(arch):
    """On (1, 2) the port executes ``param_specs(..., tp=2)`` for every leaf
    of every arch at full width (on ``meta``); FSDP splits every leaf whose
    largest dimension divides over the whole mesh, and ZeRO-3 adds the data
    axis to the TP specs."""
    from repro_torch.configs import get_config
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import MeshCtx

    cfg = get_config(arch)
    params = dryrun.meta_params(cfg)
    mesh = make_mesh((1, 2), ("data", "model"))
    tp = MeshCtx(mesh=mesh, dp_axes=("data",), ep_axis="model")
    assert shd.executed_param_specs(params, cfg, tp) == shd.param_specs(params, cfg, 2)
    mesh22 = make_mesh((2, 2), ("data", "model"))
    fsdp = MeshCtx(mesh=mesh22, dp_axes=("data", "model"), ep_axis=None, tp_axis=None)
    assert shd.executed_param_specs(params, cfg, fsdp) == shd.fsdp_param_specs(
        params, ("data", "model"), 4)
    z3 = MeshCtx(mesh=mesh22, dp_axes=("data",), ep_axis="model", zero3=True)

    def names(tree):  # a part over one axis, named alone or in a tuple
        return [tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in sp)
                for sp in shd.spec_leaves(tree)]

    assert names(shd.executed_param_specs(params, cfg, z3)) == names(shd.zero1_specs(
        shd.param_specs(params, cfg, 2), params, ("data",), 2))
    # No mesh, or a mesh of one: every leaf whole.
    one = MeshCtx(mesh=make_mesh((1, 1), ("data", "model")), dp_axes=("data",), ep_axis="model")
    for ctx in (None, one):
        assert all(all(p is None for p in sp) for sp in
                   shd.spec_leaves(shd.executed_param_specs(params, cfg, ctx)))


@pytest.mark.parametrize("mode", ["tp", "zero3", "fsdp"])
def test_bytes_per_rank_is_what_local_params_allocates(mode):
    """The dry run's ``bytes_per_rank`` under the executed specs equals the
    bytes of the pieces ``local_params`` cuts for a rank, for every arch at
    full width on the 16 x 16 mesh (on ``meta``: nothing allocated)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core.tree import leaves
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(rank=17)
    ctx = dryrun.mesh_context(mesh, mode)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = dryrun.meta_params(cfg)
        local = shd.local_params(params, cfg, ctx)
        held = sum(t.numel() * t.element_size() for t in leaves(local))
        specs = shd.executed_param_specs(params, cfg, ctx)
        assert held == shd.bytes_per_rank(params, specs, mesh), (arch, mode)
        assert held < sum(t.numel() * t.element_size() for t in leaves(params))
