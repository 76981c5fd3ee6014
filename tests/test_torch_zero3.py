"""ZeRO-3 and TP with ZeRO-1 over a (2, 2) mesh in the port's train step:
four gloo processes (one spawn, ``tests/test_torch_ranks.py::rank_tp_train``)
on the granite smoke decoder against the reference's jitted train step on
the global batch, on the CPU, with ``tests/test_torch_tp_train.py``'s
bounds (loss, aux and grad norm within 1e-5 relative, parameters within
2e-5, moments within 2e-5 of the leaf's largest; every rank's gathered
state bit for bit the same; the first step's collective bytes by tag equal
the dry run's count of the step).

- ``zero3``: the TP pieces split over 'data' too (``zero1_specs`` on the
  parameters), each gathered per use over 'data' and its gradient summed
  there; the moments on the pieces;
- ``tp``: tensor parallelism over 'model', data parallelism over 'data'
  with the ZeRO-1 moments (each data rank's slice of each TP piece), on
  granite and on granite-moe (the dense MoE, its experts over 'model' and
  its aux loss's expert shares over the global batch).
"""
import pytest

from test_torch_ranks import rank_tp_train, run_ranks
from test_torch_tp_train import LR, check_job, check_replicated_and_traffic, reference_steps

MODES = ("zero3", "tp")
# name -> (arch, mode).
JOBS = {"zero3": ("granite-3-8b", "zero3"), "tp": ("granite-3-8b", "tp"),
        "tp_moe": ("granite-moe-1b-a400m", "tp")}


@pytest.fixture(scope="module")
def reference():
    return {arch: reference_steps(arch, "dense") for arch in {a for a, _ in JOBS.values()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    d = tmp_path_factory.mktemp("zero3")
    jobs = {name: (arch, mode, (2, 2), "dense", "fp32", reference[arch]["init"],
                   reference[arch]["batches"]) for name, (arch, mode) in JOBS.items()}
    return run_ranks(rank_tp_train, 4, d, jobs, LR, timeout=240)


@pytest.mark.parametrize("name", list(JOBS))
def test_mesh_steps_match_the_reference(name, ranks, reference):
    arch, mode = JOBS[name]
    outs = [out[name] for out in ranks]
    check_job(outs[:2], reference[arch], name)
    check_job(outs[2:], reference[arch], name)
    check_replicated_and_traffic(outs, arch, mode, (2, 2), "dense")


def test_zero3_pieces_are_split_over_both_axes(ranks, reference):
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import MeshCtx

    cfg = get_config("granite-3-8b", smoke=True)
    whole = reference["granite-3-8b"]["init"]
    for mode in MODES:
        ctx = MeshCtx(mesh=make_mesh((2, 2), ("data", "model")), dp_axes=("data",),
                      ep_axis="model", zero3=mode == "zero3")
        specs = shd.spec_leaves(shd.executed_param_specs(whole, cfg, ctx))
        want = [tuple(b - a for a, b in shd.piece_slices(t.shape, sp, ctx.mesh))
                for t, sp in zip(leaves(whole), specs)]
        for out in ranks:
            assert out[mode]["local"] == want
        on_data = sum(any("data" in shd._names(p) for p in sp) for sp in specs)
        assert (on_data > 0) == (mode == "zero3")
