"""Data parallelism, ZeRO-1 and expert parallelism in the port's training
(``training/loop.py``, ``launch/train.py``, ``checkpoint/manager.py``),
two gloo processes against the reference's train step and against one
process on the global batch, on the CPU.

One spawn of two ranks (``tests/test_torch_ranks.py::rank_train``) runs:

- ZeRO-1's update (``loop.zero1_update``: each rank updates its slice of
  a bf16 leaf, an fp32 leaf too small to split and a K-major E4M3 leaf,
  then gathers) against AdamW's unsharded update on the same gradients,
  three steps: bit for bit, the K-major layout kept;
- the train launcher with ``--mesh 2,1`` on the granite smoke decoder
  (data parallelism, ZeRO-1 moments), and with ``--mesh 1,2 --moe-impl
  ep`` on the granite-moe smoke decoder (its 8 experts 4 a rank, and
  tensor parallelism over the same axis on every other layer: each rank
  holds half of the table, q, k, v, o and the expert blocks), 2 steps
  each under fp32, each saving its checkpoint (rank 0 writes it whole).

Against the same launcher in this process (a mesh of one, the global
batch; ``--moe-impl ep`` then runs ``apply_ep`` with every expert), the
reference's own bounds (``tests/test_multidevice.py``: loss 1e-2,
parameters 3e-2) tightened to what the arithmetic allows under fp32:
losses within 1e-5 relative and every parameter and moment within 1e-5
(the gradients' sums split over two ranks, in another order). The
checkpoint saved at world 2 restores at world 1 bit for bit, and every
rank beat its own heartbeat.

The same spawn runs the mesh train step (``training.make_train_step``
with a mesh context) from the reference's initial parameters, carried
across by ``convert.py``, on the reference's batches: data parallelism
with ZeRO-1 (granite smoke, ``(2, 1)``) and expert parallelism (granite-moe
smoke, ``--moe-impl ep``, ``(1, 2)``), 2 AdamW steps under fp32. Against
the reference's jitted ``repro.training.make_train_step`` on the global
batch (for EP, on its model built on a 1 x 1 mesh, so its ``apply_ep``
drops the same assignments), with the bounds of the one-process parity
test ``tests/test_torch_moe.py::test_moe_train_steps_match_reference``:
loss, aux loss and grad norm within 1e-5 relative, every parameter
within 2e-5, and both moments within 2e-5 of the largest of the leaf's.
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
from repro_torch.launch import train  # noqa: E402
from test_torch_ranks import rank_train, run_ranks  # noqa: E402

COMMON = ["--smoke", "--device", "cpu", "--policy", "fp32", "--steps", "2", "--seq", "16",
          "--batch", "4", "--log-every", "1", "--lr", "1e-3"]
RUNS = {
    "dp": ["--arch", "granite-3-8b", *COMMON, "--mesh", "2,1"],
    "ep": ["--arch", "granite-moe-1b-a400m", *COMMON, "--moe-impl", "ep", "--mesh", "1,2"],
}


# name -> (arch, the port's mesh, MoE impl) of the mesh train steps.
JOBS = {"dp": ("granite-3-8b", (2, 1), "dense"), "ep": ("granite-moe-1b-a400m", (1, 2), "ep")}
LR = 1e-3


@pytest.fixture(scope="module")
def reference():
    """For each job: the port's initial parameters and the batches (the
    spawn's input), and the reference's metrics and state a step."""
    out = {}
    for name, (arch, _, impl) in JOBS.items():
        kw = dict(policy="fp32", moe_impl=impl)
        cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
        tcfg = dataclasses.replace(tget_config(arch, smoke=True), **kw)
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
        out[name] = {"job": (arch, JOBS[name][1], impl,
                             params_from_jax(jax.tree.map(np.asarray, params), tcfg), batches),
                     "metrics": metrics, "state": conv}
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    d = tmp_path_factory.mktemp("dp_train")
    jobs = {name: ref["job"] for name, ref in reference.items()}
    return str(d), run_ranks(rank_train, 2, d, str(d), RUNS, jobs, LR, timeout=240)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    d = tmp_path_factory.mktemp("single")
    return {name: train.main([a for a in args if a not in ("--mesh", "2,1", "1,2")]
                             + ["--ckpt-dir", str(d / name)])
            for name, args in RUNS.items()}


def test_zero1_update_is_the_unsharded_update_bit_for_bit(ranks):
    for out in ranks[1]:
        assert out["zero1_same"] and out["zero1_kmajor"]


def _state_arrays(state) -> list:
    return [t.float().numpy() if isinstance(t, torch.Tensor) else t for t in leaves(state)]


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_steps_match_one_process(name, ranks, single):
    outs = [out[name] for out in ranks[1]]
    want_losses = [h["loss"] for h in single[name]["history"]]
    want = _state_arrays(single[name]["state"])
    for out in outs:
        np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-5)
        assert len(out["full"]) == len(want)
        for got, w in zip(out["full"], want):
            if isinstance(w, np.ndarray):
                assert got.shape == w.shape
                assert np.abs(got - w).max() <= 1e-5, name
            else:
                assert got == w
    for a, b in zip(outs[0]["full"], outs[1]["full"]):  # the ranks agree bit for bit
        np.testing.assert_array_equal(a, b)
    local = outs[0]["local"]
    whole = [tuple(t.shape) for t in leaves(single[name]["state"].params)]
    if name == "ep":  # tensor and expert parallelism: each rank holds half of every split leaf
        from repro_torch.distrib import sharding as shd

        specs = shd.spec_leaves(shd.param_specs(single[name]["state"].params,
                                                single[name]["cfg"], 2))
        assert local == [tuple(n // 2 if p == "model" else n for n, p in zip(w, sp))
                         for w, sp in zip(whole, specs)]
        # The table, and q, k, v, o and the expert blocks up, gate, down a layer.
        assert sum(a != b for a, b in zip(local, whole)) == 1 + 7 * 2
    else:
        assert local == whole


@pytest.mark.parametrize("name", list(JOBS))
def test_mesh_steps_match_the_reference(name, ranks, reference):
    ref = reference[name]
    outs = [out["steps"][name] for out in ranks[1]]
    for out in outs:
        for got, want in zip(out["metrics"], ref["metrics"]):
            assert got["skipped"] == 0
            rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "aux", "grad_norm")
                   if want[k] != 0 or got[k] != 0}
            assert max(rel.values()) < 1e-5, (name, rel)
        # The full state: step, params, mu, nu, skipped.
        full = out["full"]
        n = len(leaves(ref["state"][0]))
        assert full[0] == 2 and full[-1] == 0 and len(full) == 2 + 3 * n
        params, mu, nu = full[1:1 + n], full[1 + n:1 + 2 * n], full[1 + 2 * n:1 + 3 * n]
        for got, want in zip(params, leaves(ref["state"][0])):
            np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=2e-5)
        for tree, ref_tree in ((mu, ref["state"][1]), (nu, ref["state"][2])):
            for got, want in zip(tree, leaves(ref_tree)):
                w = want.numpy()
                assert got.shape == w.shape
                assert np.abs(got - w).max() <= 2e-5 * np.abs(w).max(), name
    for a, b in zip(outs[0]["full"], outs[1]["full"]):  # the ranks agree bit for bit
        np.testing.assert_array_equal(a, b)


def test_checkpoint_saved_at_world_two_restores_at_world_one(ranks, single):
    d, outs = ranks
    for name in RUNS:
        like = single[name]["state"]
        step, restored = ckpt.restore_latest(os.path.join(d, name), like)
        assert step == 2
        for got, want in zip(_state_arrays(restored), outs[0][name]["full"]):
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want)
            else:
                assert got == want


def test_every_rank_beats_its_heartbeat_and_the_mesh_must_hold_the_world(ranks):
    for out in ranks[1]:
        for name in RUNS:
            assert out[name]["hb"] == ["host_0", "host_1"]
    args = train.parse_args(["--mesh", "2,1"])
    with pytest.raises(ValueError, match="holds 2 ranks"):
        train.make_mesh_from_args(args, world=1, rank=0)
    mesh = train.make_mesh_from_args(train.parse_args([]), world=4, rank=3)
    assert mesh.shape == {"data": 4, "model": 1} and mesh.coords == {"data": 3, "model": 0}
