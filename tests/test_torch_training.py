"""The port's training path against the JAX package's, on the CPU.

Both trainers start from the reference's ``Transformer.init`` parameters
on granite-3-8b SMOKE (copied with ``params_from_jax``), zero moments and
the same numpy batches, and take one and two steps of AdamW (lr 1e-3).
The port runs its plain backend; the reference runs ``"xla"``.

Tolerances, and why:

- fp32: the two differ in the order of fp32 sums only. Loss and grad norm
  agree to 1e-5 relative (observed ~1e-7); every parameter after the
  update to 2e-5 absolute (observed 2.7e-6 with updates of ~1e-3).
- redmule_hfp8: the first forward is the same arithmetic (loss to 1e-5).
  The gradients are not: an elementwise derivative that rounds in fp16 at
  other points in the two frameworks (silu's, fused by XLA) differs by an
  fp16 ulp, which moves a value across an E5M2 rounding boundary (E5M2's
  step is 25% of the value); the flip feeds the next backward GEMM, and
  the differences grow toward the first layer. The redmule_fp16 policy,
  with the same model but 16-bit gradients, keeps every gradient within
  ~2e-3 of the reference's. So under hfp8 the grad norm is held to 5e-2
  relative (observed 6.5e-3 and 1.4e-2 at the two steps), the update of
  all parameters together to 0.3 in relative norm (observed 0.19 and
  0.16), at most 10% of the elements may move by more than half a step
  from the reference's (observed 1% and 2%), and the second loss to 2e-3
  relative (observed 5.7e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.pipeline import for_model as jfor_model  # noqa: E402
from repro.models import build  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.training import TrainState as JTrainState  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tree import leaves, tree_map  # noqa: E402
from repro_torch.data import for_model  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.training import TrainState, make_train_step  # noqa: E402

LR = 1e-3


def _trainers(policy, remat):
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), policy=policy, remat=remat)
    tcfg = dataclasses.replace(tget_config("granite-3-8b", smoke=True), policy=policy, remat=remat)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    jopt, opt = JAdamW(lr=LR), AdamW(lr=LR)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, jopt.init(params),
                         jnp.zeros((), jnp.int32))
    tmodel = tbuild(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    state = TrainState(0, tparams, opt.init(tparams), 0)
    jstep = jax.jit(jmake_train_step(model, jopt))
    return cfg, tcfg, (jstep, jstate), (make_train_step(tmodel, opt), state)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(a))


@pytest.mark.parametrize("policy,remat", [("fp32", "none"), ("fp32", "block"),
                                          ("redmule_hfp8", "block")])
def test_train_steps_match_reference(policy, remat):
    cfg, tcfg, (jstep, jstate), (step, state) = _trainers(policy, remat)
    data = jfor_model(cfg, seq_len=16, global_batch=4)
    start = leaves(state.params)
    for i in range(2):
        batch = data.batch(i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert state.step == int(jstate.step) == i + 1 and state.skipped == 0
        want = leaves(params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg))
        got = leaves(state.params)
        assert [t.dtype for t in got] == [t.dtype for t in want]
        if policy == "fp32":
            assert _rel(jm["loss"], m["loss"]) < 1e-5
            assert _rel(jm["grad_norm"], m["grad_norm"]) < 1e-5
            for w, g in zip(want, got):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5)
            continue
        assert _rel(jm["loss"], m["loss"]) < (1e-5 if i == 0 else 2e-3)
        assert _rel(jm["grad_norm"], m["grad_norm"]) < 5e-2
        dj = torch.cat([(w.float() - s.float()).ravel() for w, s in zip(want, start)])
        dt = torch.cat([(g.float() - s.float()).ravel() for g, s in zip(got, start)])
        assert float((dj - dt).norm() / dj.norm()) < 0.3
        assert float(((dj - dt).abs() > 0.5 * LR).float().mean()) < 0.1


def test_data_batches_equal_the_reference_bit_for_bit():
    cfg = tget_config("granite-3-8b", smoke=True)
    ours = for_model(cfg, seq_len=32, global_batch=4, seed=7)
    ref = jfor_model(get_config("granite-3-8b", smoke=True), seq_len=32, global_batch=4, seed=7)
    for i in (0, 1, 5):
        a, b = ours.batch(i)["tokens"], ref.batch(i)["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)
    it = ours.iterate(start=5)
    assert np.array_equal(next(it)["tokens"], ref.batch(5)["tokens"])
    it.close()


def _port(policy="fp32", remat="none"):
    tcfg = dataclasses.replace(tget_config("granite-3-8b", smoke=True), policy=policy, remat=remat)
    model = tbuild(tcfg, device="cpu")
    opt = AdamW(lr=LR)
    params = model.init(0)
    return tcfg, model, opt, TrainState(0, params, opt.init(params), 0)


def test_anomaly_guard_skips_nan_and_keeps_the_state():
    tcfg, model, opt, state = _port()
    step = make_train_step(model, opt)
    data = for_model(tcfg, 16, 4)
    good, _ = step(state, data.batch(0))
    # Tokens are integers, so poison a parameter instead: the gradient norm
    # becomes NaN and the guard must keep the (poisoned) state as it was.
    bad_params = tree_map(lambda p: p.clone(), good.params)
    bad_params["layers"][0]["attn"]["q"]["w"][0, 0] = float("nan")
    bad = good._replace(params=bad_params)
    new, m = step(bad, data.batch(1))
    assert not torch.isfinite(m["grad_norm"])
    assert new.skipped == good.skipped + 1 and new.step == good.step + 1
    assert new.params is bad.params and new.opt_state is bad.opt_state
    # and a good batch after a skip trains on
    after, m2 = step(good, data.batch(1))
    assert after.skipped == 0 and torch.isfinite(m2["loss"])


def test_checkpoint_resume_is_bit_exact(tmp_path):
    """2 steps, save, restore into a fresh state, 1 more step == 3 straight
    steps, every leaf bit for bit (parameters, moments and counters)."""
    tcfg, model, opt, state = _port("redmule_hfp8", "block")
    step = make_train_step(model, opt)
    data = for_model(tcfg, 16, 4)
    straight = state
    for i in range(3):
        straight, _ = step(straight, data.batch(i))
    s = state
    for i in range(2):
        s, _ = step(s, data.batch(i))
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path), 2, s)
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 2
    fresh = _port("redmule_hfp8", "block")[3]
    at, restored = ckpt.restore_latest(str(tmp_path), fresh)
    assert at == 2 and restored.step == 2 and restored.skipped == 0
    resumed, _ = step(restored, data.batch(2))
    assert resumed.step == straight.step == 3
    for a, b in zip(leaves(resumed), leaves(straight)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


def test_grad_accumulation_matches_one_batch():
    """Two micro-batches average to the gradient of the whole batch (fp32:
    the loss to 1e-6, the update to 1e-6 absolute)."""
    tcfg, model, opt, state = _port()
    batch = for_model(tcfg, 16, 4).batch(0)
    one, m1 = make_train_step(model, opt)(state, batch)
    two, m2 = make_train_step(model, opt, grad_accum=2)(state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    for a, b in zip(leaves(one.params), leaves(two.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_train_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule under test is the one without it")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1", "--seq", "8", "--batch", "2"])


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    args = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "16", "--batch", "4",
            "--log-every", "1", "--policy", "redmule_hfp8", "--remat", "block",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    out = train.main(args)
    hist = out["history"]
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in hist)
    assert all(h["gemm_launches"] == 0 for h in hist)  # the CPU runs the plain versions
    assert ckpt.latest_step(str(tmp_path)) == 2
    printed = capsys.readouterr().out
    assert "backend=torch device=cpu" in printed and "done" in printed
    resumed = train.main(args[:4] + ["3"] + args[5:] + ["--resume"])
    assert [h["step"] for h in resumed["history"]] == [3]


def _tinyml_loss(policy, steps=300, batch=64, lr=0.05, dims=(64, 128, 128, 10)):
    """The MLP of ``examples/train_tinyml.py`` trained with plain SGD through
    the port's engine; returns the mean loss over the last 20 steps."""
    rng = np.random.default_rng(0)
    engine = Engine(policy=policy, backend="torch")
    ws = [torch.from_numpy((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32))
          for a, b in zip(dims[:-1], dims[1:])]
    proj = rng.standard_normal((dims[0], 10)).astype(np.float32)
    data = np.random.default_rng(99)
    losses = []
    for _ in range(steps):
        x = data.standard_normal((batch, dims[0])).astype(np.float32)
        y = torch.from_numpy(np.argmax(x @ proj, -1))
        live = [w.requires_grad_() for w in ws]
        h = torch.from_numpy(x)
        for i, w in enumerate(live):
            h = engine.matmul(h, w)
            if i < len(live) - 1:
                h = torch.relu(h)
        loss = torch.nn.functional.cross_entropy(h.float(), y)
        grads = torch.autograd.grad(loss, live)
        ws = [(w - lr * g.float()).detach() for w, g in zip(live, grads)]
        losses.append(float(loss.detach()))
    return float(np.mean(losses[-20:]))


def test_hybrid_fp8_trains_as_well_as_fp32():
    """The claim of ``examples/train_tinyml.py`` (paper Sec. 4.2.3): an MLP
    trained with hybrid FP8 (E4M3 forward, E5M2 backward, fp16 compute)
    ends within 5% of FP32's loss (observed 0.992 against 0.981)."""
    fp32 = _tinyml_loss("fp32")
    hfp8 = _tinyml_loss("redmule_hfp8")
    assert fp32 < 1.0  # it learned
    assert abs(hfp8 - fp32) <= 0.05 * fp32, (hfp8, fp32)
