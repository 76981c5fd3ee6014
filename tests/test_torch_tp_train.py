"""Tensor parallelism in the port's train step (``training.make_train_step``
over a (1, 2) mesh: ``distrib/tensor_parallel.py`` on every layer), two gloo
processes against the reference's jitted train step on the global batch,
on the CPU. One spawn (``tests/test_torch_ranks.py::rank_tp_train``).

Each job runs 2 AdamW steps under fp32 from the reference's initial
parameters (carried across by ``convert.py``) on its batches: granite
(the vocab 49155 does not split over 2, so the tied table stays whole),
gemma2 (the tied table vocab-parallel, the softcaps, local and global
layers), chatglm (an untied head), deepseek (7 heads of 8 columns: q's
split falls inside a head, so q is gathered and o's input is this rank's
slice; the one KV head whole), phi3.5-moe (dense MoE: each rank runs its
block of experts) and granite-moe with ``--moe-impl ep`` and dense. The
bounds are ``tests/test_torch_dp_train.py``'s: loss, aux and grad norm
within 1e-5 relative, every parameter within 2e-5, both moments within
2e-5 of the leaf's largest; the ranks agree bit for bit. Each rank's
replicated leaves (norms, k/v where the KV heads do not divide) get the
same gradient on both ranks before any sum (the column-parallel backward
sums dX), and the first step's collective bytes by tag equal the dry
run's count of the same step, which it makes from the specs and the
activations' shapes (``launch/dryrun.py::train_collectives``).

One granite job under redmule_hfp8 is held against the port's own
one-process step: the TP step sums the row-parallel GEMMs' fp32 partials
and the column-parallel dX partials after the kernel's own sums, so an
fp32 ulp can move one E4M3 or E5M2 rounding of a later operand. Its
bounds: loss and grad norm within 1e-5 relative, parameters within
2e-3 absolute (AdamW's first steps move a weight by about the learning
rate, 1e-3, whatever its gradient's size, so a gradient element whose
operand rounding flips can move it by up to 2 lr) and moments within
1e-2 of the leaf's largest (an E4M3 step is 1/8 of its value, and the
first moment keeps a tenth of it). On this data no rounding moves: the
parameters agree bit for bit and the moments within 2e-7.

The train launcher with ``--mesh 1,2`` on granite (2 steps) gives the
one-process launcher's losses within 1e-5 and its state within 1e-5, and
its checkpoint (written whole by rank 0) restores bit for bit at world 1
and on a (2, 1) mesh.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import for_model  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import build  # noqa: E402
from repro.models.transformer import MeshCtx  # noqa: E402
from repro.optim import AdamW  # noqa: E402
from repro.training import TrainState, make_train_step  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.launch import dryrun, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh as tmake_mesh  # noqa: E402
from repro_torch.models import MeshCtx as TMeshCtx  # noqa: E402
from test_torch_ranks import rank_tp_train, run_ranks  # noqa: E402

LR = 1e-3
# name -> (arch, MoE impl) of the jobs over (1, 2).
JOBS = {"granite": ("granite-3-8b", "dense"), "gemma2": ("gemma2-2b", "dense"),
        "chatglm": ("chatglm3-6b", "dense"), "deepseek": ("deepseek-coder-33b", "dense"),
        "phi": ("phi3.5-moe-42b-a6.6b", "dense"), "granite_moe_ep": ("granite-moe-1b-a400m", "ep"),
        "granite_moe": ("granite-moe-1b-a400m", "dense")}
COMMON = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu", "--policy", "fp32",
          "--steps", "2", "--seq", "16", "--batch", "4", "--log-every", "1", "--lr", "1e-3"]
RUNS = {"tp": [*COMMON, "--mesh", "1,2"]}


def reference_steps(arch, impl, policy="fp32"):
    """The reference's metrics and state after 2 steps, and the spawn's
    inputs: the port's initial parameters and the batches."""
    kw = dict(policy=policy, moe_impl=impl)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), **kw)
    # EP: the reference's model on a 1 x 1 mesh, so its apply_ep drops the
    # same assignments (the capacity of all its experts).
    ctx = (MeshCtx(mesh=make_mesh((1, 1), ("data", "model")), dp_axes=("data",),
                   ep_axis="model") if impl == "ep" else None)
    model = build(cfg, ctx)
    params = model.init(jax.random.PRNGKey(0))
    opt = AdamW(lr=LR)
    state = TrainState(jnp.zeros((), jnp.int32), params, opt.init(params),
                       jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step(model, opt))
    data = for_model(cfg, seq_len=16, global_batch=4)
    batches = [jax.tree.map(np.asarray, data.batch(i)) for i in range(2)]
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "aux", "grad_norm")})
    conv = [params_from_jax(jax.tree.map(np.asarray, t), tcfg)
            for t in (state.params, state.opt_state["mu"], state.opt_state["nu"])]
    return {"init": params_from_jax(jax.tree.map(np.asarray, params), tcfg),
            "batches": batches, "metrics": metrics, "state": conv}


def port_one_process(arch, policy, params, batches):
    """The port's own one-process step (no mesh): metrics, and the state
    after the first step and after the last."""
    from repro_torch.models import build as tbuild
    from repro_torch.optim import AdamW as TAdamW
    from repro_torch.training import init_train_state
    from repro_torch.training import make_train_step as tmake_train_step

    cfg = dataclasses.replace(tget_config(arch, smoke=True), policy=policy)
    model = tbuild(cfg, device="cpu")
    opt = TAdamW(lr=LR)
    state = init_train_state(model, opt, params)
    step = tmake_train_step(model, opt)
    metrics, states = [], []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(m[k]) for k in ("loss", "aux", "grad_norm")})
        states.append([leaves(t) for t in (state.params, state.opt_state["mu"],
                                           state.opt_state["nu"])])
    return {"metrics": metrics, "state": states[-1], "first": states[0]}


def check_job(outs, ref, name, param_tol=2e-5, moment_tol=2e-5, metric_tol=1e-5):
    """Each rank's metrics and gathered state against ``ref`` (metrics and
    [params, mu, nu] leaves), and the ranks against each other bit for bit."""
    for out in outs:
        for got, want in zip(out["metrics"], ref["metrics"]):
            assert got["skipped"] == 0
            rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "aux", "grad_norm")
                   if want[k] != 0 or got[k] != 0}
            assert max(rel.values()) < metric_tol, (name, rel)
        full = out["full"]
        n = len(leaves(ref["state"][0]))
        assert full[0] == 2 and full[-1] == 0 and len(full) == 2 + 3 * n
        params, mu, nu = full[1:1 + n], full[1 + n:1 + 2 * n], full[1 + 2 * n:1 + 3 * n]
        for got, want in zip(params, leaves(ref["state"][0])):
            np.testing.assert_allclose(got, want.float().numpy(), rtol=0, atol=param_tol)
        for tree, ref_tree in ((mu, ref["state"][1]), (nu, ref["state"][2])):
            for got, want in zip(tree, leaves(ref_tree)):
                w = want.float().numpy()
                assert got.shape == w.shape
                assert np.abs(got - w).max() <= moment_tol * np.abs(w).max(), name
    for a, b in zip(outs[0]["full"], outs[1]["full"]):  # the ranks agree bit for bit
        np.testing.assert_array_equal(a, b)


def check_replicated_and_traffic(outs, arch, mode, shape, impl, policy="fp32", batch=4):
    """Both ranks' replicated leaves' gradients equal bit for bit, and the
    first step's collective bytes equal the dry run's count."""
    if mode == "tp" and shape[0] == 1:  # both ranks hold the same rows
        a, b = outs[0]["replicated"], outs[1]["replicated"]
        assert a.keys() == b.keys() and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cfg = dataclasses.replace(tget_config(arch, smoke=True), policy=policy, moe_impl=impl)
    mesh = tmake_mesh(shape, ("data", "model"))
    ctx = (TMeshCtx(mesh=mesh, dp_axes=("data", "model"), ep_axis=None, tp_axis=None)
           if mode == "fsdp" else
           TMeshCtx(mesh=mesh, dp_axes=("data",), ep_axis="model", zero3=mode == "zero3"))
    want = dryrun.train_collectives(cfg, dryrun.meta_params(cfg), ctx,
                                    batch // mesh.axis_size(ctx.dp_axes), 16)
    for out in outs:
        got = out["traffic"]
        assert got.keys() == want.keys(), (arch, mode, sorted(got), sorted(want))
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-9 * want[k], (arch, mode, k, got[k], want[k])


@pytest.fixture(scope="module")
def reference():
    out = {name: reference_steps(arch, impl) for name, (arch, impl) in JOBS.items()}
    g = out["granite"]
    tcfg = tget_config("granite-3-8b", smoke=True)
    init8 = params_from_jax(jax.tree.map(np.asarray, build(dataclasses.replace(
        get_config("granite-3-8b", smoke=True), policy="redmule_hfp8")).init(
        jax.random.PRNGKey(0))), dataclasses.replace(tcfg, policy="redmule_hfp8"))
    out["granite_hfp8"] = {"init": init8, "batches": g["batches"],
                           **port_one_process("granite-3-8b", "redmule_hfp8", init8,
                                              g["batches"])}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    d = tmp_path_factory.mktemp("tp_train")
    jobs = {name: (arch, "tp", (1, 2), impl, "fp32", reference[name]["init"],
                   reference[name]["batches"]) for name, (arch, impl) in JOBS.items()}
    ref8 = reference["granite_hfp8"]
    jobs["granite_hfp8"] = ("granite-3-8b", "tp", (1, 2), "dense", "redmule_hfp8",
                            ref8["init"], ref8["batches"])
    return str(d), run_ranks(rank_tp_train, 2, d, jobs, LR, RUNS, str(d), timeout=240)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_single")
    return train.main([*COMMON, "--ckpt-dir", str(d / "tp")])


@pytest.mark.parametrize("name", list(JOBS))
def test_tp_steps_match_the_reference(name, ranks, reference):
    outs = [out[name] for out in ranks[1]]
    check_job(outs, reference[name], name)
    arch, impl = JOBS[name]
    check_replicated_and_traffic(outs, arch, "tp", (1, 2), impl)


def test_tp_pieces_are_the_param_specs(ranks, reference):
    """Every rank holds only its pieces: each leaf's shape is the whole
    shape cut by ``param_specs`` at tp 2 (gemma2: the table's rows too)."""
    from repro_torch.distrib import sharding as shd

    for name in JOBS:
        cfg = tget_config(JOBS[name][0], smoke=True)
        whole = reference[name]["init"]
        specs = shd.spec_leaves(shd.param_specs(whole, cfg, 2))
        want = [tuple(n // 2 if p == "model" else n for n, p in zip(t.shape, sp))
                for t, sp in zip(leaves(whole), specs)]
        assert any(w != tuple(t.shape) for w, t in zip(want, leaves(whole)))
        for out in ranks[1]:
            assert out[name]["local"] == want, name


def test_tp_under_hfp8_matches_one_process(ranks, reference):
    outs = [out["granite_hfp8"] for out in ranks[1]]
    check_job(outs, reference["granite_hfp8"], "granite_hfp8", param_tol=2e-3,
              moment_tol=1e-2)


def test_launcher_mesh_1_2_and_its_checkpoint(ranks, single):
    d, outs = ranks
    want_losses = [h["loss"] for h in single["history"]]
    want = [t.float().numpy() if isinstance(t, torch.Tensor) else t
            for t in leaves(single["state"])]
    for out in outs:
        got = out["tp"]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        for g, w in zip(got["full"], want):
            if isinstance(w, np.ndarray):
                assert g.shape == w.shape and np.abs(g - w).max() <= 1e-5
            else:
                assert g == w
        # Restored on a (2, 1) mesh: the same state bit for bit.
        for g, w in zip(got["restored_21"], got["full"]):
            np.testing.assert_array_equal(g, w)
    # Restored at world 1.
    step, restored = ckpt.restore_latest(os.path.join(d, "tp"), single["state"])
    assert step == 2
    for g, w in zip(leaves(restored), outs[0]["tp"]["full"]):
        got = g.float().numpy() if isinstance(g, torch.Tensor) else g
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got, w)
        else:
            assert got == w
