"""Data-parallel gradient sums under redmule_hfp8: each weight's gradient is
summed over the data ranks in fp32 and cast once, as GSPMD sums the
reference's.

The reference's side, in a subprocess with two host devices: its loss's
gradient on the global batch (granite-3-8b SMOKE, 4 x 16 tokens) on one
device, and on a (2, 1) ("data", "model") mesh with the parameters
replicated (DP) and split over 'data' (FSDP). GSPMD puts the all-reduce
on each dW dot's fp32 result, before its cast to fp16, so every fp16 GEMM
weight's gradient on the mesh equals the one-device gradient bit for bit;
the fp32 norm scales differ by the order of their fp32 sums (up to a few
hundred fp32 ulps of values near 1e-9, below 1e-6 of each leaf's
largest). Under DP its tied table's gather gradient is each device's fp16
scatter summed in fp16 (0.74% of its elements off the one-device gradient
here, up to 12 fp16 ulps); under FSDP it is the one-device gradient.

The port's side, two gloo ranks (``tests/test_torch_ranks.py::
rank_dp_grads``) over (2, 1) in DP (with ZeRO-1) and FSDP, from the
reference's initial parameters: the first step's summed gradients must
equal the port's one-process step's on the global batch as the
reference's mesh gradients equal its one-device ones: every fp16 leaf bit
for bit (the table included: the port gathers the embedding's cotangent
rows and scatters them in the global batch's order), every fp32 leaf
within 1e-6 of its largest. Before the repair each rank rounded its dW
to fp16 before the sum, and the GEMM weights' gradients parted from the
one-process step's. The port's one-process step is not the reference's
bit for bit under redmule_hfp8 (0.14% of its fp16 gradient elements off,
up to 12 ulps, all in the tied table's scatter; 53% before its
transcendentals and their gradients took XLA's rounding: an E4M3 or E5M2
rounding that flips moves a gradient by up to its own size;
``scripts/probe_port_grads.py``), so the two packages' gradients are
compared through that relation rather than element by element.

recurrentgemma (``scripts/probe_dp_grads.py --arch recurrentgemma-2b``):
GSPMD sums every GEMM weight's dW in fp32 before its cast, but each
device's conv_w gradient is its own fp16 reduce and the devices' sums
are added in fp16 (cast first), and lam's and the norms' are fp32
partial sums; the port's DP and FSDP steps keep those leaves to the
step's sum of each rank's gradient, so they hold the same relation to
its one-process step.

Then 3 steps against the port's one-process steps, with
``tests/test_torch_tp_train.py``'s hfp8 bounds: loss and grad norm within
1e-5 relative, parameters within 2e-3, moments within 1e-2 of the leaf's
largest; the two ranks bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import for_model  # noqa: E402
from repro.models import build  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import leaves  # noqa: E402
from repro_torch.distrib import sharding as tshd  # noqa: E402
from test_torch_ranks import _FirstGrads, rank_dp_grads, run_ranks  # noqa: E402

ARCH, POLICY, LR, STEPS = "granite-3-8b", "redmule_hfp8", 1e-3, 3
RG = "recurrentgemma-2b"
MODES = ("dp", "fsdp")
FP32_TOL = 1e-6  # of a leaf's largest: the order of fp32 sums

# The reference's gradients on one device and on the two meshes, each leaf
# compared: (path, dtype, share of elements that differ, worst fp16 ulps
# or fp32 |d| over the leaf's largest).
_REFERENCE = """
import dataclasses, json
import jax, numpy as np
from repro.configs import get_config
from repro.data.pipeline import for_model
from repro.distrib import sharding as shd
from repro.launch.mesh import make_mesh
from repro.models import build
from repro.models.transformer import MeshCtx
from repro.training.loop import make_loss_fn


def ordered(x):
    i = x.view(np.int16).astype(np.int64)
    return np.where(i < 0, -(i & 0x7fff), i)


out = {}
for arch in ARCHS:
    cfg = dataclasses.replace(get_config(arch, smoke=True), policy=POLICY)
    batch = jax.tree.map(np.asarray, for_model(cfg, seq_len=16, global_batch=4).batch(0))
    one = build(cfg)
    params = one.init(jax.random.PRNGKey(0))
    grad = lambda m: jax.grad(lambda p, b: make_loss_fn(m)(p, b)[0])
    want = jax.jit(grad(one))(params, batch)
    mesh = make_mesh((2, 1), ("data", "model"))
    model = build(cfg, MeshCtx(mesh=mesh, dp_axes=("data",), ep_axis="model"))
    shapes = jax.eval_shape(lambda: params)
    bshard = shd.tree_shardings(shd.batch_specs(jax.eval_shape(lambda: batch), ("data",)), mesh)
    for mode, specs in (("dp", shd.param_specs(shapes, cfg, 1)),
                        ("fsdp", shd.fsdp_param_specs(shapes, ("data",), 2))):
        pshard = shd.tree_shardings(specs, mesh)
        got = jax.jit(grad(model), in_shardings=(pshard, bshard), out_shardings=pshard)(
            params, batch)
        rows = []
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree.leaves(want)):
            a, b = np.asarray(a), np.asarray(b)
            if a.dtype == np.float16:
                worst = int(np.abs(ordered(a) - ordered(b)).max())
            else:
                worst = float(np.abs(a - b).max() / np.abs(b).max())
            rows.append((jax.tree_util.keystr(path), str(a.dtype), float(np.mean(a != b)), worst))
        out[mode if arch == ARCHS[0] else arch + ":" + mode] = rows
print("RESULT " + json.dumps(out))
"""


def ulps16(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in fp16 ulps, through the ordered integers of the bits."""
    def ordered(x):
        i = x.view(np.int16).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.fixture(scope="module")
def reference():
    """The reference's mesh gradients against its one-device ones."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    code = _REFERENCE.replace("ARCHS", repr((ARCH, RG))).replace("POLICY", repr(POLICY))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The port's one-process steps and its two ranks' DP and FSDP steps,
    from the reference's initial parameters on the same batches."""
    from repro_torch.models import build as tbuild
    from repro_torch.optim import AdamW
    from repro_torch.training import init_train_state, make_train_step

    def one_process(arch, steps):
        cfg = dataclasses.replace(get_config(arch, smoke=True), policy=POLICY)
        tcfg = dataclasses.replace(tget_config(arch, smoke=True), policy=POLICY)
        init = params_from_jax(
            jax.tree.map(np.asarray, build(cfg).init(jax.random.PRNGKey(0))), tcfg)
        data = for_model(cfg, seq_len=16, global_batch=4)
        batches = [jax.tree.map(np.asarray, data.batch(i)) for i in range(steps)]
        model = tbuild(tcfg, device="cpu")
        opt = _FirstGrads(AdamW(lr=LR))
        state = init_train_state(model, opt, init)
        step = make_train_step(model, opt)
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "skipped")})
        one = {"metrics": metrics, "grads": [g.numpy() for g in leaves(opt.grads)],
               "full": [t.float().numpy() if isinstance(t, torch.Tensor) else t
                        for t in leaves(state)]}
        return one, init, batches

    one, init, batches = one_process(ARCH, STEPS)
    rg_one, rg_init, rg_batches = one_process(RG, 1)
    jobs = {mode: (ARCH, mode, (2, 1), POLICY, init, batches) for mode in MODES}
    jobs.update({RG + ":" + mode: (RG, mode, (2, 1), POLICY, rg_init, rg_batches)
                 for mode in MODES})
    ranks = run_ranks(rank_dp_grads, 2, tmp_path_factory.mktemp("dp_hfp8"), jobs, LR,
                      timeout=240)
    return {"one": one, "ranks": ranks, "paths": [p for p, _ in tshd.leaf_paths(init)],
            RG: {"one": rg_one, "paths": [p for p, _ in tshd.leaf_paths(rg_init)]}}


@pytest.mark.parametrize("mode", MODES)
def test_reference_mesh_gradients_are_its_one_device_ones(mode, reference):
    """The probe's finding: GSPMD sums each dW in fp32 before its cast."""
    rows = reference[mode]
    weights = [r for r in rows if r[1] == "float16" and "table" not in r[0]]
    assert weights and all(share == 0.0 for _, _, share, _ in weights), weights
    norms = [r for r in rows if r[1] == "float32"]
    assert norms and all(worst <= FP32_TOL for *_, worst in norms), norms
    table = next(r for r in rows if "table" in r[0])
    assert table[2] == 0.0 if mode == "fsdp" else table[3] <= 16, table


@pytest.mark.parametrize("mode", MODES)
def test_summed_gradients_are_the_one_process_ones(mode, port):
    """Each leaf's gradient after the sums over the data axes, against the
    one-process step's on the global batch: fp16 bit for bit, fp32 within
    the order of its sums; the two ranks alike."""
    outs = [r[mode] for r in port["ranks"]]
    for a, b in zip(outs[0]["grads"], outs[1]["grads"]):
        np.testing.assert_array_equal(a, b)
    differ, total, worst = 0, 0, 0
    for path, got, want in zip(port["paths"], outs[0]["grads"], port["one"]["grads"]):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if got.dtype == np.float16:
            differ += int(np.sum(got != want))
            total += got.size
            worst = max(worst, int(ulps16(got, want).max()))
        else:
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= FP32_TOL, (path, err)
    assert differ == 0, (f"{mode}: {differ} of {total} fp16 gradient elements "
                         f"({differ / total:.2%}) differ, up to {worst} ulps")


@pytest.mark.parametrize("mode", MODES)
def test_steps_match_one_process(mode, port):
    outs = [r[mode] for r in port["ranks"]]
    one = port["one"]
    for out in outs:
        for got, want in zip(out["metrics"], one["metrics"]):
            assert got["skipped"] == 0
            for k in ("loss", "grad_norm"):
                assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), (mode, k, got, want)
        full, ref = out["full"], one["full"]
        n = (len(full) - 2) // 3
        assert len(full) == len(ref) == 2 + 3 * n and full[0] == STEPS
        for got, want in zip(full[1:1 + n], ref[1:1 + n]):
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
        for got, want in zip(full[1 + n:], ref[1 + n:]):
            assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), mode
    for a, b in zip(outs[0]["full"], outs[1]["full"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_reference_recurrentgemma_conv_gradient_is_cast_first(mode, reference):
    """recurrentgemma: GSPMD sums the GEMM weights' dW in fp32 before their
    cast, but each device's conv_w gradient is its own fp16 reduce, and the
    devices' fp16 sums are added in fp16 (69.9% and 73.8% of the two conv
    leaves off the one-device gradient, up to 88 ulps); lam and the norm
    scales are fp32 partial sums."""
    rows = reference[RG + ":" + mode]
    weights = [r for r in rows if r[1] == "float16" and "table" not in r[0]
               and "conv_w" not in r[0]]
    assert weights and all(share == 0.0 for _, _, share, _ in weights), weights
    conv = [r for r in rows if "conv_w" in r[0]]
    assert len(conv) == 2 and all(0.0 < share and worst <= 128 for _, _, share, worst in conv)
    fp32 = [r for r in rows if r[1] == "float32"]
    assert any("lam" in r[0] for r in fp32) and all(w <= FP32_TOL for *_, w in fp32), fp32


@pytest.mark.parametrize("mode", MODES)
def test_recurrentgemma_summed_gradients(mode, port):
    """The port's recurrentgemma DP and FSDP gradients against its
    one-process ones, as the reference's mesh against its one device: GEMM
    weights and the table bit for bit, conv_w each rank's fp16 gradient
    summed (cast first, as GSPMD's), lam and the norms within the order of
    their fp32 sums."""
    outs = [r[RG + ":" + mode] for r in port["ranks"]]
    for a, b in zip(outs[0]["grads"], outs[1]["grads"]):
        np.testing.assert_array_equal(a, b)
    one = port[RG]["one"]
    conv = 0
    for path, got, want in zip(port[RG]["paths"], outs[0]["grads"], one["grads"]):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if "conv_w" in path:
            conv += 1
            assert ulps16(got, want).max() <= 128, path
        elif got.dtype == np.float16:
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            assert np.abs(got - want).max() <= FP32_TOL * np.abs(want).max(), path
    assert conv == 2
