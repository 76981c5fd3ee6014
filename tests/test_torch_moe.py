"""The port's dense-MoE FFN and the granite-moe decoder against the JAX
package's, on the CPU with the plain path.

Parameters come from the reference's ``moe.init`` and ``Transformer.init``,
copied across with ``convert.py``; inputs are made with numpy from a seed.
``apply_dense`` is held to 1e-5 of max|y| under fp32 (the router's fp32
GEMM and the expert GEMMs sum in another order in torch than in XLA), and
bit for bit under redmule_hfp8 with E4M3 weights, where every product is
exact and the sums round once. ``impl="ep"`` is held here without a mesh
and on a mesh of one; ``tests/test_torch_moe_ep.py`` holds it on several
ranks. The router picks its experts by
``torch.topk`` against ``jax.lax.top_k``: a near-tie between two experts'
probabilities could pick another expert, so the seeds are fixed up front
(0-3, not chosen after the fact) and fp32 keeps such ties far apart; no
flip happens on them. The granite-moe smoke model's ``prefill_cb`` and
``decode_cb`` logits are held as the dense decoder's are in
``tests/test_torch_model.py``: 1e-5 of max|logit| under fp32, 5e-2 under
redmule_hfp8 with E4M3 pages (a one-ulp fp16 difference from a sum's order
can cross an E4M3 rounding boundary).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.models import build  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import moe_params_from_jax, params_from_jax  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import moe  # noqa: E402

CFG = jmoe.MoEConfig(n_experts=8, top_k=4, d_model=64, d_ff=64)
# policy -> (reference weight format, input format, bound on max|dy|/max|y|)
POLICIES = {"fp32": (jnp.float32, np.float32, 1e-5),
            "redmule_hfp8": (jnp.float8_e4m3fn, np.float16, 0.0)}


def _layer(seed, policy, cfg=CFG):
    wdt, xdt, _ = POLICIES[policy]
    params = jmoe.init(jax.random.PRNGKey(seed), cfg, dtype=wdt)
    x = np.random.default_rng(seed).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    return params, x.astype(xdt), moe_params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", list(POLICIES))
def test_apply_dense_matches_reference(policy, seed):
    params, x, tparams = _layer(seed, policy)
    want, aux = jmoe.apply_dense(params, jnp.asarray(x), CFG, JEngine(policy=policy, backend="xla"))
    got, taux = moe.apply_dense(tparams, torch.from_numpy(x), moe.MoEConfig(*CFG),
                                Engine(policy=policy, backend="torch"))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= POLICIES[policy][2], err
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)


def test_dense_routes_topk_only():
    """The reference's test (shape, finite, positive aux), and y against a
    loop over each token's chosen experts alone: an expert outside the top
    k contributes nothing."""
    params, x, tparams = _layer(0, "fp32")
    cfg = moe.MoEConfig(*CFG)
    eng = Engine(policy="fp32", backend="torch")
    xt = torch.from_numpy(x)
    y, aux = moe.apply_dense(tparams, xt, cfg, eng)
    assert y.shape == xt.shape and torch.isfinite(y).all() and float(aux) > 0
    x2 = xt.reshape(-1, cfg.d_model)
    probs = torch.softmax(x2 @ tparams["router"]["w"], -1)
    f = cfg.d_ff
    want = torch.zeros_like(x2)
    for t in range(x2.shape[0]):
        top_p, top_i = torch.topk(probs[t], cfg.top_k)
        for p, e in zip(top_p / top_p.sum(), top_i.tolist()):
            cols = slice(e * f, (e + 1) * f)
            h = (torch.nn.functional.silu(x2[t] @ tparams["gate"][:, cols])
                 * (x2[t] @ tparams["up"][:, cols]))
            want[t] += p * (h @ tparams["down"][cols])
    torch.testing.assert_close(y.reshape(-1, cfg.d_model), want, rtol=1e-5, atol=1e-5)


def test_ep_raises():
    """``impl="ep"`` computes what the reference computes instead of raising:
    without a mesh the dense layer (the reference's ``apply`` falls back to
    ``apply_dense``), bit for bit with the port's own and within the dense
    bound of the reference's; on a mesh of one the reference's EP body
    (``apply_ep`` on a 1 x 1 mesh, jitted), within 3e-7 of max|y| under
    fp32. What still raises is an impl neither package has."""
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro_torch.launch.mesh import make_mesh

    params, x, tparams = _layer(0, "fp32")
    jcfg = CFG._replace(impl="ep")
    cfg = moe.MoEConfig(*jcfg)
    eng, jeng = Engine(policy="fp32", backend="torch"), JEngine(policy="fp32", backend="xla")
    xt = torch.from_numpy(x)
    got, aux = moe.apply(tparams, xt, cfg, eng)
    dense, daux = moe.apply_dense(tparams, xt, cfg, eng)
    assert torch.equal(got, dense) and torch.equal(aux, daux)
    want, waux = jmoe.apply(params, jnp.asarray(x), jcfg, jeng)
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    mesh = make_mesh((1, 1), ("data", "model"))
    got, aux = moe.apply(tparams, xt, cfg, eng, mesh=mesh, ep_axis="model")
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    want, waux = jax.jit(lambda p, xx: jmoe.apply(p, xx, jcfg, jeng, mesh=jmesh, dp_axes=("data",),
                                                  ep_axis="model"))(params, jnp.asarray(x))
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= 3e-7 * np.abs(want).max()
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown MoE impl"):
        moe.apply(tparams, xt, cfg._replace(impl="alltoall"), eng)


def _models(policy, kv, fp8_params):
    kw = dict(policy=policy, kv_cache_dtype=kv, fp8_params=fp8_params)
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True), **kw)
    tcfg = dataclasses.replace(tget_config("granite-moe-1b-a400m", smoke=True), **kw)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tmodel = tbuild(tcfg, device="cpu")
    return model, params, tmodel, params_from_jax(jax.tree.map(np.asarray, params), tcfg)


@pytest.mark.parametrize("fp8_params", [False, True])
def test_layout_round_trip_through_convert(fp8_params):
    """``params_from_jax`` lays each expert's weights into the (d, E*f) and
    (E*f, d) GEMM shapes bit for bit, fp8 ones K-major, and the port's own
    init makes the same structure, formats and strides."""
    model, params, tmodel, tparams = _models("redmule_hfp8", "e4m3", fp8_params)
    m = params["decoder"]["units"]["b0"]["moe"]
    e, f = model.cfg.n_experts, model.cfg.d_ff
    bits = torch.uint8 if fp8_params else torch.int16

    def same(t, a):
        a = np.asarray(a)
        np.testing.assert_array_equal(t.contiguous().view(bits).numpy(),
                                      a.view(np.uint8 if fp8_params else np.int16))

    own = tmodel.init(0)["layers"][0]["moe"]
    for i, layer in enumerate(tparams["layers"]):
        lm = layer["moe"]
        assert "ffn" not in layer
        assert lm["router"]["w"].dtype == torch.float32
        np.testing.assert_array_equal(lm["router"]["w"].numpy(), np.asarray(m["router"]["w"][i]))
        for ex in range(e):
            cols = slice(ex * f, (ex + 1) * f)
            same(lm["up"][:, cols], m["up"][i, ex])
            same(lm["gate"][:, cols], m["gate"][i, ex])
            same(lm["down"][cols], m["down"][i, ex])
        for name in ("up", "gate", "down"):
            assert lm[name].stride(0) == (1 if fp8_params else lm[name].shape[1])
            assert (own[name].shape, own[name].dtype, own[name].stride()) == (
                lm[name].shape, lm[name].dtype, lm[name].stride())


@pytest.mark.parametrize("case", [("fp32", "fp32", False, 1e-5),
                                  ("redmule_hfp8", "e4m3", True, 5e-2)],
                         ids=["fp32", "hfp8-fp8-params"])
def test_smoke_model_prefill_and_decode_match_reference(case):
    """One 7-token prefill in slot 0, then three decode steps with slot 1
    inactive, each fed the reference's greedy token."""
    policy, kv, fp8_params, tol = case
    model, params, tmodel, tparams = _models(policy, kv, fp8_params)
    ps, n_pages = 4, 13
    pools = model.init_state_store(2, n_pages, ps)
    tpools = tmodel.init_state_store(2, n_pages, ps)
    toks = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (1, 8)).astype(np.int32)
    page_row = np.array([1, 2, 3, 0, 0, 0], np.int32)
    want, pools = model.prefill_cb(params, jnp.asarray(toks), pools, jnp.asarray(page_row),
                                   jnp.int32(0), jnp.int32(0), jnp.int32(7), page_size=ps)
    with torch.inference_mode():
        got = tmodel.prefill_cb(tparams, torch.from_numpy(toks), tpools,
                                torch.from_numpy(page_row), 0, 0, 7, page_size=ps)
    pairs = [(np.asarray(want)[0], got[0])]
    pt = np.zeros((2, 6), np.int32)
    pt[0, :3] = [1, 2, 3]
    lens = np.array([7, 0], np.int32)
    active = np.array([True, False])
    tok = np.array([[5], [0]], np.int32)
    for _ in range(3):
        want, pools = model.decode_cb(params, jnp.asarray(tok), pools, jnp.asarray(pt),
                                      jnp.asarray(lens), jnp.asarray(active), page_size=ps)
        with torch.inference_mode():
            got = tmodel.decode_cb(tparams, torch.from_numpy(tok), tpools, torch.from_numpy(pt),
                                   torch.from_numpy(lens), torch.from_numpy(active),
                                   page_size=ps)
        pairs.append((np.asarray(want)[0], got[0]))
        tok = np.array([[int(np.argmax(pairs[-1][0]))], [0]], np.int32)
        lens = lens + active
    for want, got in pairs:
        assert torch.isfinite(got).all()
        want = np.asarray(want, np.float32)
        assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= tol


def test_moe_training_and_train_launcher_raise(monkeypatch):
    """MoE training runs with either implementation. ``moe_impl="ep"``
    builds (no mesh: the dense layer), and the train launcher's
    ``--moe-impl ep`` trains on a mesh of one with ``apply_ep`` (every layer
    of every step) and, under fp32, the same losses as a train step on the
    model built on that mesh; that step, from the reference's parameters
    on its batches, gives the reference's losses (its jitted step on its
    model built on a 1 x 1 mesh, as its launcher builds it) within 1e-5
    relative; an impl the port does not have raises at build."""
    from repro.data.pipeline import for_model as jfor_model
    from repro.launch.mesh import make_mesh as jmake_mesh
    from repro.models.transformer import MeshCtx as JMeshCtx
    from repro.optim import AdamW as JAdamW
    from repro.training import TrainState as JTrainState
    from repro.training import make_train_step as jmake_train_step
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import MeshCtx
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.training import TrainState, make_train_step

    cfg = dataclasses.replace(tget_config("granite-moe-1b-a400m", smoke=True), moe_impl="ep",
                              policy="fp32")
    assert tbuild(cfg, device="cpu").moe_cfg.impl == "ep"
    with pytest.raises(ValueError, match="unknown MoE impl"):
        tbuild(dataclasses.replace(cfg, moe_impl="alltoall"), device="cpu")
    calls = []
    real = moe.apply_ep
    monkeypatch.setattr(moe, "apply_ep", lambda *a, **k: calls.append(1) or real(*a, **k))
    args = ["--arch", "granite-moe-1b-a400m", "--smoke", "--device", "cpu", "--steps", "2",
            "--seq", "8", "--batch", "2", "--policy", "fp32", "--lr", "1e-3"]
    out = train.main([*args, "--moe-impl", "ep"])
    assert len(calls) == 2 * cfg.n_layers
    mesh_ctx = MeshCtx(mesh=make_mesh((1, 1), ("data", "model")), dp_axes=("data",),
                       ep_axis="model")
    model = tbuild(cfg, mesh_ctx, device="cpu")
    opt = AdamW(lr=cosine_schedule(1e-3, 20, 2))
    params = model.init(0)
    state, step = TrainState(0, params, opt.init(params), 0), make_train_step(model, opt)
    from repro_torch.data import for_model

    data = for_model(cfg, 8, 2, seed=0)
    for i, h in enumerate(out["history"]):
        state, m = step(state, data.batch(i))
        assert float(m["loss"]) == h["loss"]
    jcfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True), moe_impl="ep",
                               policy="fp32")
    jmodel = build(jcfg, JMeshCtx(mesh=jmake_mesh((1, 1), ("data", "model")),
                                  dp_axes=("data",), ep_axis="model"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt, opt = JAdamW(lr=1e-3), AdamW(lr=1e-3)
    jstate = JTrainState(jnp.zeros((), jnp.int32), jparams, jopt.init(jparams),
                         jnp.zeros((), jnp.int32))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    state, step = TrainState(0, params, opt.init(params), 0), make_train_step(model, opt)
    jstep = jax.jit(jmake_train_step(jmodel, jopt))
    jdata = jfor_model(jcfg, seq_len=8, global_batch=2)
    for i in range(2):
        jstate, jm = jstep(jstate, jdata.batch(i))
        state, m = step(state, jdata.batch(i))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    out = train.main([*args, "--moe-impl", "dense"])
    assert len(out["history"]) == 2 and all(np.isfinite(h["loss"]) for h in out["history"])


LR = 1e-3


@pytest.mark.parametrize("policy,remat", [("fp32", "none"), ("redmule_hfp8", "block")])
def test_moe_train_steps_match_reference(policy, remat):
    """Two AdamW steps of the granite-moe smoke decoder from the
    reference's parameters on the same batches, the aux loss (the router's
    load balance, weighted 0.01) in the loss and its gradient through the
    router's fp32 GEMM and the gates. fp32: loss, aux and grad norm to
    1e-5 relative, every parameter to 2e-5 (the dense decoders' bounds);
    redmule_hfp8: the first loss and aux to 1e-5, the second loss to 2e-3,
    the grad norm to 5e-2 and the update to 0.3 in relative norm (the
    dense decoders' hfp8 bounds: E5M2 cotangents round in another order)."""
    from repro.data.pipeline import for_model as jfor_model
    from repro.optim import AdamW as JAdamW
    from repro.training import TrainState as JTrainState
    from repro.training import make_train_step as jmake_train_step
    from repro_torch.core.tree import leaves
    from repro_torch.optim import AdamW
    from repro_torch.training import TrainState, make_train_step

    kw = dict(policy=policy, remat=remat)
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m", smoke=True), **kw)
    tcfg = dataclasses.replace(tget_config("granite-moe-1b-a400m", smoke=True), **kw)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    jopt, opt = JAdamW(lr=LR), AdamW(lr=LR)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, jopt.init(params),
                         jnp.zeros((), jnp.int32))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    state = TrainState(0, tparams, opt.init(tparams), 0)
    jstep = jax.jit(jmake_train_step(model, jopt))
    step = make_train_step(tbuild(tcfg, device="cpu"), opt)
    data = jfor_model(cfg, seq_len=16, global_batch=4)
    start = leaves(state.params)
    for i in range(2):
        batch = data.batch(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert state.skipped == 0 and float(m["aux"]) > 0
        rel = {k: abs(float(jm[k]) - float(m[k])) / abs(float(jm[k]))
               for k in ("loss", "aux", "grad_norm")}
        want = leaves(params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg))
        got = leaves(state.params)
        if policy == "fp32":
            assert max(rel.values()) < 1e-5, rel
            for w, g in zip(want, got):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5)
            continue
        assert rel["loss"] < (1e-5 if i == 0 else 2e-3) and rel["grad_norm"] < 5e-2, rel
        if i == 0:
            assert rel["aux"] < 1e-5, rel
        dj = torch.cat([(w.float() - s.float()).ravel() for w, s in zip(want, start)])
        dt = torch.cat([(g.float() - s.float()).ravel() for g, s in zip(got, start)])
        assert float((dj - dt).norm() / dj.norm()) < 0.3
