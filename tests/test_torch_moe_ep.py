"""The port's expert-parallel MoE (``models/moe.py::apply_ep``) against
the reference's (``repro.models.moe``), on the CPU.

The reference's EP body ``_ep_local`` runs at n shards under
``jax.vmap(..., axis_name="model")`` on one device, its expert blocks
stacked on the shard axis; the port's runs on n gloo processes
(``tests/test_torch_ranks.py``), each with its block of whole experts cut from
the (d, E*f) / (E*f, d) layout. The inputs are made with numpy from a
seed and the parameters by the reference's ``moe.init``, carried across
by ``convert.moe_params_from_jax``.

Bounds:
- one rank (the reference's ``apply_ep`` on a 1 x 1 mesh, jitted, as
  every reference call here): bit for bit
  under redmule_hfp8 (E4M3 weights, fp16 activations, where every product
  is exact and each sum rounds once), 3e-7 of max|y| under fp32 (the
  router's and the experts' fp32 sums in torch's order, not XLA's); the
  aux loss to 1e-6 relative;
- 2 and 4 ranks, capacity factor 8 (nothing dropped) and 1.0 (tokens
  dropped once an expert fills; ``argsort`` stable in both, so the same
  ones): fp32 within 3e-7 of max|y|, redmule_hfp8 within one fp16 ulp of
  max|y| (the ranks' fp16 partial outputs summed in another order);
- the ``gelu`` branch (``act != "swiglu"``) at 2 ranks within the same
  bounds (the dense path raises for it);
- gradients of sum(y * g) + aux, fp32, capacity factor 8: the input's
  and each rank's expert blocks' against the vmapped reference's and
  against ``apply_dense``'s, the router's summed over the ranks, within
  1e-5 of each gradient's largest magnitude;
- ``impl="ep"`` without a mesh is ``apply_dense`` bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.engine import Engine as JEngine  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.convert import moe_params_from_jax  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from test_torch_ranks import rank_ep_jobs, run_ranks  # noqa: E402

FORMATS = {"fp32": (jnp.float32, np.float32), "redmule_hfp8": (jnp.float8_e4m3fn, np.float16)}


def _case(policy, cf, act="swiglu", seed=0):
    wdt, xdt = FORMATS[policy]
    cfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=64, capacity_factor=cf,
                         impl="ep", act=act)
    params = jmoe.init(jax.random.PRNGKey(seed), cfg, dtype=wdt)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32).astype(xdt)
    g = rng.standard_normal((4, 16, 64)).astype(np.float32)
    return cfg, params, x, g, moe_params_from_jax(jax.tree.map(np.asarray, params))


def _stacked(params, n):
    e = params["up"].shape[0]
    return {"router": {"w": jnp.broadcast_to(params["router"]["w"],
                                              (n,) + params["router"]["w"].shape)},
            **{k: params[k].reshape(n, e // n, *params[k].shape[1:])
               for k in ("up", "gate", "down")}}


def _reference(cfg, params, x, g, policy, n, grads=False):
    """The vmapped EP body at n shards: (y, aux), and with ``grads`` the
    gradients of the mean over shards of sum(y * g) + aux (x's, the
    router's summed over shards, each shard's expert blocks)."""
    eng = JEngine(policy=policy, backend="xla")
    body = jax.vmap(lambda p, xx: jmoe._ep_local(p, xx, cfg, eng, "model"),
                    in_axes=(0, None), axis_name="model")
    stacked = _stacked(params, n)
    y, aux = jax.jit(body)(stacked, jnp.asarray(x))
    if not grads:
        return np.asarray(y[0], np.float32), float(aux[0])

    def loss(p, xx):
        yy, aa = body(p, xx)
        return jnp.mean(jnp.sum(yy.astype(jnp.float32) * g, axis=(1, 2, 3)) + aa)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(stacked, jnp.asarray(x))
    return np.asarray(y[0], np.float32), float(aux[0]), gx, gp


def _bound(policy, want):
    if policy == "fp32":
        return 3e-7 * np.abs(want).max()
    return float(np.spacing(np.float16(np.abs(want).max())))


@pytest.mark.parametrize("policy", list(FORMATS))
def test_one_rank_matches_the_reference_apply_ep(policy):
    cfg, params, x, _, tparams = _case(policy, 1.0)
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    eng = JEngine(policy=policy, backend="xla")
    want, waux = jax.jit(lambda p, xx: jmoe.apply_ep(p, xx, cfg, eng, jmesh, ("data",), "model"))(
        params, jnp.asarray(x))
    mesh = make_mesh((1, 1), ("data", "model"))
    got, aux = moe.apply_ep(tparams, torch.from_numpy(x), moe.MoEConfig(*cfg),
                            Engine(policy=policy, backend="torch"), mesh, "model")
    want = np.asarray(want, np.float32)
    if policy == "redmule_hfp8":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        assert np.abs(got.numpy() - want).max() <= _bound(policy, want)
    assert abs(float(aux) - float(waux)) <= 1e-6 * abs(float(waux))
    # The same layer through apply() with the mesh, and capacity-limited:
    # tokens were dropped, so it is not the dense layer.
    same, _ = moe.apply(tparams, torch.from_numpy(x), moe.MoEConfig(*cfg),
                        Engine(policy=policy, backend="torch"), mesh=mesh, ep_axis="model")
    assert torch.equal(same, got)
    dense, _ = moe.apply_dense(tparams, torch.from_numpy(x), moe.MoEConfig(*cfg),
                               Engine(policy=policy, backend="torch"))
    assert not torch.equal(dense, got)


def test_ep_without_a_mesh_is_dense():
    for policy in FORMATS:
        cfg, _, x, _, tparams = _case(policy, 1.0)
        eng = Engine(policy=policy, backend="torch")
        got, aux = moe.apply(tparams, torch.from_numpy(x), moe.MoEConfig(*cfg), eng)
        want, waux = moe.apply_dense(tparams, torch.from_numpy(x), moe.MoEConfig(*cfg), eng)
        assert torch.equal(got, want) and torch.equal(aux, waux)


def test_capacity_matches_the_reference_arithmetic():
    for t, k, e, cf in ((16, 2, 8, 1.0), (16, 2, 8, 8.0), (2048, 2, 16, 1.25), (2048, 8, 32, 1.25),
                        (3, 1, 64, 1.0), (640, 8, 32, 1.25)):
        cfg = moe.MoEConfig(e, k, 8, 8, cf, "ep")
        assert moe.capacity(t, cfg) == jmoe._ceil_to(int(t * k / e * cf) or 1, 8)


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_match_the_vmapped_reference(n, tmp_path):
    """fp32 and redmule_hfp8, capacity factor 8 and 1.0, and at 2 ranks the
    gelu branch, in one spawn; the fp32 gradients at capacity factor 8."""
    cases = [(p, cf, "swiglu") for p in FORMATS for cf in (8.0, 1.0)]
    if n == 2:
        cases += [(p, 8.0, "gelu") for p in FORMATS]
    made = [_case(p, cf, act) for p, cf, act in cases]
    jobs = [(tp, x, tuple(cfg), p, g, p == "fp32" and cf == 8.0 and act == "swiglu")
            for (cfg, _, x, g, tp), (p, cf, act) in zip(made, cases)]
    got = run_ranks(rank_ep_jobs, n, tmp_path, jobs, timeout=180)
    for i, ((cfg, params, x, g, tp), (policy, cf, act)) in enumerate(zip(made, cases)):
        want, waux = _reference(cfg, params, x, g, policy, n)
        for r in range(n):
            out = got[r][i]
            assert np.abs(out["y"] - want).max() <= _bound(policy, want), (policy, cf, act, r)
            assert abs(out["aux"] - waux) <= 1e-6 * abs(waux)
        if cf == 1.0:  # tokens dropped: not the dense layer
            dense, _ = moe.apply_dense(tp, torch.from_numpy(x), moe.MoEConfig(*cfg),
                                       Engine(policy=policy, backend="torch"))
            assert np.abs(dense.float().numpy() - want).max() > 10 * _bound(policy, want)
        if jobs[i][-1]:
            _check_grads(cfg, params, x, g, n, [got[r][i]["grads"] for r in range(n)])
        if act == "gelu" and policy == "fp32":
            # The dense path keeps its raise for another act (the reference's
            # dense path applies silu whatever the act).
            with pytest.raises(NotImplementedError, match="silu"):
                moe.apply_dense(tp, torch.from_numpy(x), moe.MoEConfig(*cfg),
                                Engine("fp32", "torch"))


def _close(got, want):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _check_grads(cfg, params, x, g, n, per_rank):
    _, _, gx, gp = _reference(cfg, params, x, g, "fp32", n, grads=True)
    e, f = cfg.n_experts, cfg.d_ff
    el = e // n
    router = sum(r[1] for r in per_rank)
    _close(router, np.asarray(gp["router"]["w"]).sum(0))
    for r, (gxr, _, up, gate, down) in enumerate(per_rank):
        _close(gxr, gx)
        for name, got in (("up", up), ("gate", gate)):
            want = np.asarray(gp[name][r]).transpose(1, 0, 2).reshape(64, el * f)
            _close(got, want)
        _close(down, np.asarray(gp["down"][r]).reshape(el * f, 64))
    # ... and against the dense layer's gradients (nothing dropped).
    eng = JEngine(policy="fp32", backend="xla")

    def dense_loss(p, xx):
        y, aux = jmoe.apply_dense(p, xx, cfg, eng)
        return jnp.sum(y.astype(jnp.float32) * g) + aux

    dp, dx = jax.jit(jax.grad(dense_loss, argnums=(0, 1)))(params, jnp.asarray(x))
    _close(router, dp["router"]["w"])
    _close(per_rank[0][0], dx)
    up_all = np.concatenate([r[2] for r in per_rank], axis=1)
    _close(up_all, np.asarray(dp["up"]).transpose(1, 0, 2).reshape(64, e * f))


def test_expert_blocks_need_no_kmajor_copy():
    """A local expert's weights as ``apply_ep`` slices them from E4M3
    K-major (d, E*f) / (E*f, d) weights: the ``up``/``gate`` column block
    is a contiguous K-major block, the ``down`` row block a K-major view
    with a row pitch of E*f; the GEMM plan reads both in place (no K-major
    copy of W) at a decode-sized M, and at capacity rows it copies only
    to widen, as it does any fp8 GEMM of that size (the phi3.5-moe ratios
    f / d and E, at a width the CPU builds quickly)."""
    from repro_torch.core.precision import E4M3, get_policy
    from repro_torch.core.semiring import MATMUL
    from repro_torch.kernels import redmule_gemm as rg
    from repro_torch.models.common import kmajor_weight

    e, d, f = 16, 256, 400
    up = kmajor_weight(torch.zeros((d, e * f)).to(E4M3))
    down = kmajor_weight(torch.zeros((e * f, d)).to(E4M3))
    pol = get_policy("redmule_hfp8")
    for j in (0, 5, e - 1):
        cols = slice(j * f, (j + 1) * f)
        for w in (up[:, cols], down[cols]):
            assert w.stride(0) == 1  # K-major
            for m, widen in ((8, False), (64, False), (320, True)):
                x = torch.zeros((m, w.shape[0])).to(E4M3)
                plan = rg.plan_call(x, w, None, gop=MATMUL, policy=pol).plan
                assert plan.widen == widen and plan.copy_w == widen, (j, m, plan)
                whole = rg.plan_call(x, w.contiguous().T.contiguous().T, None, gop=MATMUL,
                                     policy=pol).plan
                assert whole == plan  # the same plan as an unsliced K-major weight
