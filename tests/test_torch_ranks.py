"""Multi-process runs for the port's distributed tests: ``run_ranks`` spawns
one process a rank, joins them into a gloo process group through a
``FileStore`` in the test's temporary directory, and returns what each
rank's function returned. A rank that raises, or a run that outlasts its
timeout, fails the test with the rank's traceback.

The ranks' bodies live here, beside it: a spawned process imports the
module of the function it runs, and this one imports neither JAX nor the
JAX package, so the ranks start in a couple of seconds. The tests compute
the reference's side in their own process. The one test here holds the
harness itself: a rank that raises fails the run with its traceback.
"""
import os
import traceback

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.distrib import collectives as coll
from repro_torch.launch.mesh import make_mesh


def _entry(fn, rank, world, store, out_dir, args):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save({"ok": result}, path)
    except BaseException:  # noqa: BLE001 - carried to the parent as text
        torch.save({"error": traceback.format_exc()}, path)
        raise SystemExit(1)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """[fn(rank, world, *args) for every rank], each run in its own process."""
    out_dir = os.path.join(str(tmp_path), f"ranks_{fn.__name__}_{world}")
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results, errors = [], []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pt")
        got = torch.load(path, weights_only=False) if os.path.exists(path) else {}
        if "error" in got:
            errors.append(f"rank {r}:\n{got['error']}")
        results.append(got.get("ok"))
    if errors or hung:
        raise AssertionError(f"ranks {hung} outlasted {timeout} s\n" * bool(hung)
                             + "\n".join(errors))
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"exit codes {[p.exitcode for p in procs]}")
    return results


def _rank_raises(rank, world):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return dist.get_world_size()


def test_run_ranks_carries_a_failing_ranks_traceback(tmp_path):
    with pytest.raises(AssertionError, match="rank 1 fails on purpose"):
        run_ranks(_rank_raises, 2, tmp_path, timeout=60)


# -- collectives ---------------------------------------------------------


def rank_psum(rank, world, x):
    mesh = make_mesh((world,), ("data",))
    err = coll.init_error_tree({"g": torch.zeros(x.shape[-1])})["g"]
    assert err.dtype == torch.bfloat16 and mesh.rank == rank
    out = []
    for t in range(x.shape[0]):
        mean, err = coll.compressed_psum(torch.from_numpy(x[t, rank]), mesh, "data", err)
        out.append((mean.numpy(), err.float().numpy()))
    # The tree form on the last round's input.
    tree, new = coll.psum_tree_compressed({"a": [torch.from_numpy(x[-1, rank])]}, mesh, "data",
                                          {"a": [torch.zeros(x.shape[-1], dtype=torch.bfloat16)]})
    return out, tree["a"][0].numpy(), new["a"][0].float().numpy()


def rank_feedback(rank, world, x, rounds, xs):
    mesh = make_mesh((world,), ("data",))
    err = torch.zeros(x.shape[-1], dtype=torch.bfloat16)
    means = []
    for _ in range(rounds):
        mean, err = coll.compressed_psum(torch.from_numpy(x[rank]), mesh, "data", err)
        means.append(mean.numpy())
    return rank_psum(rank, world, xs), means


# -- expert parallelism ------------------------------------------------------


def rank_ep(rank, world, params, x, cfg_fields, policy, g, with_grad=True):
    """apply_ep on this rank's experts of ``params`` (the port's full
    layout) over a (1, world) mesh: (y, aux, grads of sum(y * g) + aux
    with respect to x, the router and the rank's expert blocks)."""
    from repro_torch.engine import Engine
    from repro_torch.models import moe

    cfg = moe.MoEConfig(*cfg_fields)
    mesh = make_mesh((1, world), ("data", "model"))
    cols = slice(rank * cfg.d_ff * cfg.n_experts // world,
                 (rank + 1) * cfg.d_ff * cfg.n_experts // world)
    local = {"router": {"w": params["router"]["w"].clone()}, "up": params["up"][:, cols],
             "gate": params["gate"][:, cols], "down": params["down"][cols]}
    leaves = [local["router"]["w"], local["up"], local["gate"], local["down"]]
    xt = torch.from_numpy(x)
    if with_grad:
        for t in [xt, *leaves]:
            t.requires_grad_()
    y, aux = moe.apply_ep(local, xt, cfg, Engine(policy=policy, backend="torch"), mesh, "model")
    out = {"y": y.detach().float().numpy(), "aux": float(aux.detach())}
    if with_grad:
        loss = (y.float() * torch.from_numpy(g)).sum() + aux
        grads = torch.autograd.grad(loss, [xt, *leaves])
        out["grads"] = [t.float().numpy() for t in grads]
    return out


def rank_ep_jobs(rank, world, jobs):
    return [rank_ep(rank, world, *job) for job in jobs]


# -- data parallelism, ZeRO-1, checkpoints, the launcher ----------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype.itemsize == 1 else t


def _gathered(state, cfg, mesh) -> list:
    """Every leaf of a rank's train state gathered whole (numpy), the
    counters as they are."""
    from repro_torch.core.tree import leaves
    from repro_torch.distrib import sharding as shd
    from repro_torch.models import MeshCtx
    from repro_torch.training import loop

    ctx = MeshCtx(mesh=mesh, dp_axes=("data",), ep_axis="model")
    specs = loop.state_specs(state, cfg, ctx)
    full = [shd.gather_full(t, s, mesh) if s is not None else t
            for t, s in zip(leaves(state), shd.spec_leaves(specs))]
    return [t.float().numpy() if isinstance(t, torch.Tensor) else t for t in full]


def rank_steps(rank, world, jobs, lr):
    """The mesh train step from given parameters: for each job (name ->
    (arch, mesh shape, MoE impl, the port's full parameters, global
    batches)) the smoke config under fp32, AdamW at ``lr``, this rank's
    block of experts and its rows of each batch. Returns each job's
    metrics a step and its final state gathered whole."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.distrib import sharding as shd
    from repro_torch.models import MeshCtx, build
    from repro_torch.optim import AdamW
    from repro_torch.training import init_train_state, make_train_step

    out = {}
    for name, (arch, shape, impl, params, batches) in jobs.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), policy="fp32", moe_impl=impl)
        mesh = make_mesh(shape, ("data", "model"))
        ctx = MeshCtx(mesh=mesh, dp_axes=("data",), ep_axis="model")
        model = build(cfg, ctx, device="cpu")
        opt = AdamW(lr=lr)
        state = init_train_state(model, opt, shd.local_params(params, cfg, ctx), mesh_ctx=ctx)
        step = make_train_step(model, opt, mesh_ctx=ctx)
        n, i = mesh.axis_size("data"), mesh.axis_index("data")
        metrics = []
        for batch in batches:
            b = len(batch["tokens"]) // n
            state, m = step(state, {k: v[i * b:(i + 1) * b] for k, v in batch.items()})
            metrics.append({k: float(m[k]) for k in ("loss", "aux", "grad_norm", "skipped")})
        out[name] = {"metrics": metrics, "full": _gathered(state, cfg, mesh)}
    return out


def rank_train(rank, world, ckpt_dir, runs, jobs, lr):
    """Two-rank training checks (``tests/test_torch_dp_train.py``): ZeRO-1's
    update against the unsharded one, the mesh train steps of ``jobs``
    (``rank_steps``), then each launcher run of ``runs`` (name -> argv),
    its losses, its state gathered whole, and the heartbeat files."""
    import os

    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    from repro_torch.training import loop

    out = {}
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((64, 32), generator=gen).to(torch.bfloat16),
              "v": torch.randn((7, 3), generator=gen),
              "k": torch.randn((32, 48), generator=gen).to(torch.float8_e4m3fn).T}  # K-major
    # (The E4M3 leaf's gradient in fp32: torch's CPU kernels do not scale fp8.)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen).to(
        torch.float32 if p.dtype.itemsize == 1 else p.dtype), params)
    opt, gnorm = AdamW(lr=1e-2), torch.tensor(3.0)
    mesh = make_mesh((world, 1), ("data", "model"))
    dims = [0, None, 0]
    sliced = opt.init({"w": params["w"][:32], "v": params["v"], "k": params["k"][:24]})
    full_p, full_s, p_new = params, opt.init(params), params
    for step in range(3):
        full_p, full_s = opt.update(full_p, grads, full_s, step, gnorm)
        p_new, sliced = loop.zero1_update(opt, p_new, grads, sliced, step, gnorm, dims, mesh,
                                          ("data",))
    out["zero1_same"] = all(torch.equal(_bits(a), _bits(b))
                            for a, b in zip(leaves(p_new), leaves(full_p)))
    out["zero1_kmajor"] = p_new["k"].stride() == params["k"].stride()
    out["steps"] = rank_steps(rank, world, jobs, lr)

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    for name, args in runs.items():
        res = train.main([*args, "--ckpt-dir", os.path.join(ckpt_dir, name)])
        st = res["state"]
        out[name] = {"losses": [h["loss"] for h in res["history"]],
                     "full": _gathered(st, res["cfg"], res["mesh"]),
                     "local": [tuple(t.shape) for t in leaves(st.params)],
                     "hb": sorted(os.listdir(os.path.join(ckpt_dir, name, "hb")))}
    return out


# -- tensor parallelism and FSDP --------------------------------------------------


def rank_tp_layers(rank, world, case):
    """The layer pieces of ``distrib/tensor_parallel.py`` over a (1, world)
    mesh on this rank's pieces of the whole inputs in ``case`` (numpy):
    each function's output and the gradients of sum(out * g) with respect
    to its inputs (this rank's pieces)."""
    from repro_torch.distrib import tensor_parallel as tpl
    from repro_torch.engine import Engine

    tp = tpl.TP(make_mesh((1, world), ("data", "model")), "model")
    eng = Engine(policy="fp32", backend="torch")

    def piece(a, dim):
        a = torch.from_numpy(a)
        n = a.shape[dim] // world
        return a.narrow(dim, rank * n, n).clone().requires_grad_()

    def run(fn, inputs, g):
        out = fn(*inputs)
        grads = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(), inputs)
        return out.detach().numpy(), [t.numpy() for t in grads]

    out = {}
    x, w, g = case["x"], case["w"], case["g_col"]
    xt = torch.from_numpy(x).requires_grad_()
    out["column"] = run(lambda a, b: tpl.column_linear(a, {"w": b}, eng, tp),
                        [xt, piece(w, 1)], g[..., rank * g.shape[-1] // world:
                                             (rank + 1) * g.shape[-1] // world])
    out["row"] = run(lambda a, b: tpl.row_linear(a, {"w": b}, eng, tp),
                     [piece(case["xr"], -1), piece(case["wr"], 0)], case["g_row"])
    out["gather"] = run(lambda a: tpl.gather_from(a, tp).square(), [piece(x, -1)], case["g_x"])
    out["split"] = run(lambda a: tpl.split_to(a, tp).square(),
                       [torch.from_numpy(x).requires_grad_()],
                       case["g_x"][..., rank * x.shape[-1] // world:
                                    (rank + 1) * x.shape[-1] // world])
    # The embedding: bits of the rows, and the table piece's gradient.
    table = piece(case["table"], 0)
    emb = tpl.vocab_embed(table, torch.from_numpy(case["tokens"]), tp, torch.float32)
    out["embed_bits"] = emb.detach().view(torch.int32).numpy()
    out["embed_grad"] = torch.autograd.grad((emb * torch.from_numpy(case["g_emb"])).sum(),
                                            table)[0].numpy()
    logits = piece(case["logits"], -1)
    loss = tpl.vocab_xent(logits, torch.from_numpy(case["labels"]),
                          torch.from_numpy(case["mask"]), tp)
    out["xent"] = (float(loss), torch.autograd.grad(loss, logits)[0].numpy())
    # The row-parallel sum under redmule_hfp8: fp32 partials, one rounding.
    h8 = Engine(policy="redmule_hfp8", backend="torch")
    xr8, wr8 = case["x8"], case["w8"]
    k = xr8.shape[-1] // world
    out["row_hfp8"] = tpl.row_linear(torch.from_numpy(xr8[..., rank * k:(rank + 1) * k]),
                                     {"w": torch.from_numpy(wr8[rank * k:(rank + 1) * k])},
                                     h8, tp).float().numpy()
    return out


def _tp_ctx(mode, shape):
    from repro_torch.models import MeshCtx

    mesh = make_mesh(shape, ("data", "model"))
    if mode == "fsdp":
        return MeshCtx(mesh=mesh, dp_axes=("data", "model"), ep_axis=None, tp_axis=None)
    return MeshCtx(mesh=mesh, dp_axes=("data",), ep_axis="model", zero3=mode == "zero3")


def _replicated_grads(model, ctx, state, batch) -> dict:
    """The gradients of this rank's replicated leaves (every spec entry
    None) at the state, before any sum over the data axes."""
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.distrib import sharding as shd
    from repro_torch.training import loop

    live = tree_map(lambda p: p.detach().requires_grad_(), state.params)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    b["tokens"] = b["tokens"].long()
    total, denom, aux = loop._loss_terms(model, live, b, model.engine)
    grads = torch.autograd.grad(total / denom + loop.AUX_LOSS_WEIGHT * aux, leaves(live))
    specs = shd.spec_leaves(loop.leaf_specs(state.params, model.cfg, ctx))
    return {p: g.numpy() for (p, _), g, sp in zip(shd.leaf_paths(state.params), grads, specs)
            if all(s is None for s in sp) and not loop._is_router(p)}


class _FirstGrads:
    """An optimizer that keeps the gradients of its first update (this
    rank's ZeRO-1 slices or FSDP pieces, after the train step's sums over
    the data axes) and leaves the update to ``opt``."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, params, grads, state, step, gnorm):
        if self.grads is None:
            self.grads = grads
        return self.opt.update(params, grads, state, step, gnorm)


def rank_dp_grads(rank, world, jobs, lr):
    """The mesh train step from given parameters, for each job (name ->
    (arch, mode "dp" | "fsdp" | "zero3", mesh shape, policy, the port's
    full parameters, global batches)): AdamW steps at ``lr`` on this rank's
    rows. Returns each job's metrics a step, the first step's summed
    gradients gathered whole in their own formats, and the final state
    gathered whole."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.distrib import sharding as shd
    from repro_torch.models import build
    from repro_torch.optim import AdamW
    from repro_torch.training import init_train_state, make_train_step, state_specs

    out = {}
    for name, (arch, mode, shape, policy, params, batches) in jobs.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), policy=policy)
        ctx = _tp_ctx("tp" if mode == "dp" else mode, shape)
        model = build(cfg, ctx, device="cpu")
        opt = _FirstGrads(AdamW(lr=lr))
        state = init_train_state(model, opt, shd.local_params(params, cfg, ctx), mesh_ctx=ctx)
        step = make_train_step(model, opt, mesh_ctx=ctx)
        n, i = ctx.mesh.axis_size(ctx.dp_axes), ctx.mesh.axis_index(ctx.dp_axes)
        metrics = []
        for b in batches:
            rows = {k: v[i * len(v) // n:(i + 1) * len(v) // n] for k, v in b.items()}
            state, m = step(state, rows)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "skipped")})
        specs = state_specs(state, cfg, ctx)
        grads = [shd.gather_full(g, s, ctx.mesh) if s is not None else g
                 for g, s in zip(leaves(opt.grads), shd.spec_leaves(specs.opt_state["mu"]))]
        full = [shd.gather_full(t, s, ctx.mesh) if s is not None else t
                for t, s in zip(leaves(state), shd.spec_leaves(specs))]
        out[name] = {"metrics": metrics, "grads": [g.numpy() for g in grads],
                     "full": [t.float().numpy() if isinstance(t, torch.Tensor) else t
                              for t in full]}
    return out


def rank_tp_train(rank, world, jobs, lr, runs=None, ckpt_dir=None):
    """The mesh train step from given parameters, for each job (name ->
    (arch, mode "tp" | "fsdp" | "zero3", mesh shape, MoE impl, policy, the
    port's full parameters, global batches)): 2 AdamW steps at ``lr`` on
    this rank's rows. Returns each job's metrics a step, its state after
    the first step and the final state gathered whole, its pieces' shapes,
    the first step's collective bytes by tag, and the replicated leaves'
    gradients at the initial state.
    Then each launcher run of ``runs`` (name -> argv) with its losses and
    state, and its checkpoint restored on a (2, 1) mesh."""
    import dataclasses
    import os

    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch import train
    from repro_torch.models import build
    from repro_torch.optim import AdamW
    from repro_torch.training import init_train_state, make_train_step, state_specs

    def gathered(state, cfg, ctx):
        specs = state_specs(state, cfg, ctx)
        full = [shd.gather_full(t, s, ctx.mesh) if s is not None else t
                for t, s in zip(leaves(state), shd.spec_leaves(specs))]
        return [t.float().numpy() if isinstance(t, torch.Tensor) else t for t in full]

    out = {}
    for name, (arch, mode, shape, impl, policy, params, batches) in jobs.items():
        cfg = dataclasses.replace(get_config(arch, smoke=True), policy=policy, moe_impl=impl)
        ctx = _tp_ctx(mode, shape)
        model = build(cfg, ctx, device="cpu")
        opt = AdamW(lr=lr)
        state = init_train_state(model, opt, shd.local_params(params, cfg, ctx), mesh_ctx=ctx)
        step = make_train_step(model, opt, mesh_ctx=ctx)
        n, i = ctx.mesh.axis_size(ctx.dp_axes), ctx.mesh.axis_index(ctx.dp_axes)
        rows = [{k: v[i * len(v) // n:(i + 1) * len(v) // n] for k, v in b.items()}
                for b in batches]
        res = {"replicated": _replicated_grads(model, ctx, state, rows[0]), "metrics": []}
        for t, b in enumerate(rows):
            coll.reset_traffic()
            state, m = step(state, b)
            if t == 0:
                res["traffic"] = dict(coll.traffic)
                res["first"] = gathered(state, cfg, ctx)
            res["metrics"].append({k: float(m[k]) for k in ("loss", "aux", "grad_norm",
                                                             "skipped")})
        res["local"] = [tuple(t.shape) for t in leaves(state.params)]
        res["full"] = gathered(state, cfg, ctx)
        out[name] = res

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    for name, args in (runs or {}).items():
        d = os.path.join(ckpt_dir, name)
        res = train.main([*args, "--ckpt-dir", d])
        st, cfg = res["state"], res["cfg"]
        ctx = _tp_ctx("tp", tuple(res["mesh"].shape.values()))
        got = {"losses": [h["loss"] for h in res["history"]], "full": gathered(st, cfg, ctx)}
        # The checkpoint restored on a (2, 1) mesh: this rank's pieces, gathered.
        ctx2 = _tp_ctx("tp", (world, 1))
        model2 = build(cfg, ctx2, device="cpu")
        like = init_train_state(model2, AdamW(lr=1e-3),
                                shd.local_params(model2.init(0), cfg, ctx2), mesh_ctx=ctx2)
        sh = shd.tree_shardings(state_specs(like, cfg, ctx2), ctx2.mesh)
        from repro_torch.checkpoint import manager as ckpt

        _, restored = ckpt.restore_latest(d, like, shardings=sh)
        got["restored_21"] = gathered(restored, cfg, ctx2)
        out[name] = got
    return out
