"""Tensor parallelism over (1, 2) on the recurrent, encoder-decoder and VLM
families, and FSDP over (2, 1), in the port's train step: two gloo
processes (one spawn, ``tests/test_torch_ranks.py::rank_tp_train``)
against the reference's jitted train step on the global batch, on the
CPU, with ``tests/test_torch_tp_train.py``'s checks: loss, aux and grad
norm within 1e-5 relative; the ranks bit for bit; the replicated leaves'
gradients equal on both TP ranks; the first step's collective bytes equal
the dry run's count. FSDP keeps that file's state bounds (parameters
within 2e-5, moments within 2e-5 of the leaf's largest).

The four families' own one-process step already differs from the
reference by more than those state bounds: AdamW's first steps move a
weight by about the learning rate whatever its gradient's size
(``tests/test_torch_encdec.py``), so where a gradient element is near
zero its fp32 ulps move the step by a share of lr; and the fp32 backward
keeps torch's formulas and sum orders where XLA's are not matched
(RMSNorm's rsqrt, the RG-LRU scan's and convolution's gradients; its
gates' forward is XLA's bit for bit). Their TP runs are held to the
reference at parameters within 1e-3 absolute (lr) and moments within
8e-4 of the leaf's largest (read: 5.8e-4 for internvl2's table, 6.3e-4
for recurrentgemma's second moment; with torch's transcendentals 8.1e-4
and 8.0e-4, under bounds of 2e-3 and 1e-3), and to the port's own
one-process step on the same parameters and batches: the TP step
differs from it only in the order of its fp32 sums, so a fault of the
tensor parallelism alone, on a leaf as small as xLSTM's ``ifg`` or the
RG-LRU's ``lam``, cannot hide inside the family's gap to the reference.
There both steps' metrics are held within 1e-5 relative and the state
after the first step, which carries the first gradients whole (mu = 0.1
g, nu = 0.001 g^2), within ``test_torch_dp_train.py``'s 2e-5 of each
moment leaf's largest (read: 2.8e-6 at most, recurrentgemma's). Its
parameters are held within 2e-4 (read: 1.85e-4, one element of
internvl2's table whose gradient, 1e-8, is a cancellation at the fp32
noise of its row: Adam's first step moves a weight by lr g / (|g| +
eps), so where an element's gradient is near eps fp32 noise in g moves
the step by a share of lr; 8.0e-5 with torch's transcendentals); the
second step's state inherits that and is held to the reference's
bounds alone.

- recurrentgemma-2b: the RG-LRU's channels split (in_x, in_gate, the conv
  and ``lam`` a rank's channels; gate_a and gate_x on the gathered conv
  output), its MQA attention with the one KV head whole;
- xlstm-125m: the fused qkv and wx projections column-split across their
  parts and gathered, the cells replicated, ogate and out on this rank's
  slice;
- seamless-m4t-large-v2: the encoder's and the decoder's layers and the
  cross-attention over the replicated encoder output, enc_proj gathered;
- internvl2-76b: vis_proj gathered ahead of the token embeddings, an
  untied head;
- granite-3-8b and granite-moe-1b-a400m (the dense MoE, whose aux loss
  takes its expert shares over the global batch, as the reference's)
  under FSDP (``tp_axis=None``: every leaf split over the whole mesh,
  gathered per use, its gradient summed there), 2 rows a rank.
"""
import numpy as np
import pytest

from test_torch_ranks import rank_tp_train, run_ranks
from test_torch_tp_train import (
    LR,
    check_job,
    check_replicated_and_traffic,
    port_one_process,
    reference_steps,
)

# name -> (arch, mode, mesh shape).
JOBS = {"recurrentgemma": ("recurrentgemma-2b", "tp", (1, 2)),
        "xlstm": ("xlstm-125m", "tp", (1, 2)),
        "seamless": ("seamless-m4t-large-v2", "tp", (1, 2)),
        "internvl2": ("internvl2-76b", "tp", (1, 2)),
        "fsdp": ("granite-3-8b", "fsdp", (2, 1)),
        "fsdp_moe": ("granite-moe-1b-a400m", "fsdp", (2, 1))}


@pytest.fixture(scope="module")
def reference():
    out = {name: reference_steps(arch, "dense") for name, (arch, _, _) in JOBS.items()}
    for name, (arch, mode, _) in JOBS.items():
        if mode == "tp":  # the port's own one-process step on the same inputs
            ref = out[name]
            ref["one"] = port_one_process(arch, "fp32", ref["init"], ref["batches"])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    d = tmp_path_factory.mktemp("tp_families")
    jobs = {name: (arch, mode, shape, "dense", "fp32", reference[name]["init"],
                   reference[name]["batches"]) for name, (arch, mode, shape) in JOBS.items()}
    return run_ranks(rank_tp_train, 2, d, jobs, LR, timeout=240)


@pytest.mark.parametrize("name", list(JOBS))
def test_mesh_steps_match_the_reference(name, ranks, reference):
    outs = [out[name] for out in ranks]
    arch, mode, shape = JOBS[name]
    tol = {} if mode == "fsdp" else {"param_tol": 1e-3, "moment_tol": 8e-4}
    check_job(outs, reference[name], name, **tol)
    check_replicated_and_traffic(outs, arch, mode, shape, "dense")


@pytest.mark.parametrize("name", [n for n, (_, mode, _) in JOBS.items() if mode == "tp"])
def test_tp_steps_match_one_process(name, ranks, reference):
    one = reference[name]["one"]
    n = len(one["first"][0])
    for out in (r[name] for r in ranks):
        for got, want in zip(out["metrics"], one["metrics"]):
            for k in ("loss", "aux", "grad_norm"):
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (name, k, got[k], want[k])
        first = out["first"]
        assert first[0] == 1 and len(first) == 2 + 3 * n
        for i, (got, want) in enumerate(zip(first[1:], (t for part in one["first"]
                                                        for t in part))):
            w = want.float().numpy()
            bound = 2e-4 if i < n else 2e-5 * np.abs(w).max()
            assert got.shape == w.shape and np.abs(got - w).max() <= bound, (name, i)


def test_fsdp_ranks_hold_only_their_pieces(ranks, reference):
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch.mesh import make_mesh

    whole = reference["fsdp"]["init"]
    specs = shd.spec_leaves(shd.fsdp_param_specs(whole, ("data", "model"), 2))
    mesh = make_mesh((2, 1), ("data", "model"))
    want = [tuple(b - a for a, b in shd.piece_slices(t.shape, sp, mesh))
            for t, sp in zip(leaves(whole), specs)]
    assert sum(w != tuple(t.shape) for w, t in zip(want, leaves(whole))) == len(want)
    for out in ranks:
        assert out["fsdp"]["local"] == want
    assert get_config("granite-3-8b", smoke=True).n_layers == 2
