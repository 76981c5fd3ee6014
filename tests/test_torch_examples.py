"""The paper's TinyML workloads and the examples in the port
(``repro_torch.configs.paper_tinyml``, ``repro_torch.examples``,
``repro_torch.models.make_batch``) against the JAX package's, on the CPU
with the plain path.

- ``paper_tinyml``: the reference's GEMM tables, entry for entry;
- the APSP, max-capacity and bottleneck closures, and the Viterbi score,
  path and gradients: the reference's on the same inputs (fp32: min, max
  and add are exact, so bit for bit);
- one train_tinyml SGD step from the same numpy weights and batch: the
  reference's loss and weights, under fp32 within 1e-6 of their largest
  (fp32 sums in another order; read: 1.0e-7), under redmule_hfp8 bit for
  bit (every fp8 product is exact in fp16 and both sides round once);
- ``make_batch``: the reference's keys, shapes, dtypes and ranges for
  every family (``torch.Generator`` cannot draw ``jax.random``'s numbers),
  and the VLM's and encoder-decoder's logits on one numpy-made batch in
  those dtypes within 1e-5 of the reference's;
- every example's ``main`` on the CPU with its own asserts, and raising
  without a card unless ``--device cpu`` is given.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs import paper_tinyml as jtiny  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.models import build  # noqa: E402
from repro.models import make_batch as jmake_batch  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import paper_tinyml as tiny  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    graph_shortest_paths,
    quickstart,
    serve_decode,
    train_lm,
    train_tinyml,
    viterbi_decode,
)
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import make_batch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _reference_example(name):
    """A reference example script loaded by path (its work runs under
    ``__main__`` only, so loading it defines its functions)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the paper's GEMM tables -------------------------------------------------------

def test_paper_tinyml_tables_match_the_reference():
    astuple = dataclasses.astuple
    for name in ("RESNET8", "MOBILENETV2", "TINY_TRANSFORMER"):
        got, want = getattr(tiny, name), getattr(jtiny, name)
        assert [astuple(g) for g in got] == [astuple(g) for g in want], name
        assert [astuple(g) for g in tiny.training_gemms(got)] == \
            [astuple(g) for g in jtiny.training_gemms(want)], name
    assert [astuple(g) for g in tiny._mnv2_blocks(0.5, 64)] == \
        [astuple(g) for g in jtiny._mnv2_blocks(0.5, 64)]
    assert (tiny.RESNET8_IM2COL_SW_CYCLES, tiny.RESNET8_OTHER_SW_CYCLES) == (
        jtiny.RESNET8_IM2COL_SW_CYCLES, jtiny.RESNET8_OTHER_SW_CYCLES)
    # The paper's convention: N is the reduction, X (M, N) and W (N, K).
    conv1 = tiny.RESNET8[0]
    assert (conv1.M, conv1.N, conv1.K) == (1024, 27, 16)
    assert len(tiny.training_gemms(tiny.RESNET8)) == 3 * len(tiny.RESNET8)


# -- the semiring examples -----------------------------------------------------------

def test_graph_closures_match_the_reference(capsys):
    got = graph_shortest_paths.main(["--device", "cpu"])
    assert "OK" in capsys.readouterr().out and got["apsp_err"] < 1e-3
    adj, mask = graph_shortest_paths.graph()
    inf = graph_shortest_paths.INF
    dist = np.where(mask, adj, inf)
    np.fill_diagonal(dist, 0.0)
    eng = JEngine(policy="fp32")
    for key, op, a in (("apsp", "apsp", dist),
                       ("capacity", "max_capacity_path", np.where(mask, adj, np.float32(0))),
                       ("bottleneck", "min_spanning_tree", np.where(mask, adj, inf))):
        want = np.asarray(eng.closure(jnp.asarray(a), op=op))
        np.testing.assert_array_equal(got[key], want, err_msg=key)


def test_viterbi_score_path_and_gradients_match_the_reference(capsys):
    got = viterbi_decode.main(["--device", "cpu"])
    assert "OK" in capsys.readouterr().out
    trans, emit = viterbi_decode.scores()
    eng = JEngine(policy="fp32")

    # The reference script's chain (the script runs at import, so it is
    # written out here as it stands there).
    def best_score(trans_, emit_):
        alpha = emit_[0][None, :]
        for t in range(1, viterbi_decode.T):
            alpha = eng.gemm_op(alpha, trans_, op="max_critical_path") + emit_[t][None, :]
        return jnp.max(alpha)

    score, (d_trans, d_emit) = jax.value_and_grad(best_score, argnums=(0, 1))(
        jnp.asarray(trans), jnp.asarray(emit))
    assert got["score"] == float(score)
    np.testing.assert_array_equal(got["d_trans"], np.asarray(d_trans))
    np.testing.assert_array_equal(got["d_emit"], np.asarray(d_emit))
    np.testing.assert_array_equal(got["path"], np.argmax(np.asarray(d_emit), axis=1))


# -- train_tinyml ---------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fp32", "redmule_hfp8"])
def test_train_tinyml_step_matches_the_reference(policy):
    ref = _reference_example("train_tinyml")
    rng = np.random.default_rng(0)
    dims = train_tinyml.DIMS
    assert dims == ref.DIMS and (train_tinyml.BATCH, train_tinyml.LR) == (ref.BATCH, ref.LR)
    params = [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
              for a, b in zip(dims[:-1], dims[1:])]
    x = rng.standard_normal((ref.BATCH, dims[0])).astype(np.float32)
    proj = rng.standard_normal((dims[0], 10)).astype(np.float32)
    y = train_tinyml.labels(torch.from_numpy(x), torch.from_numpy(proj)).numpy()
    np.testing.assert_array_equal(y, np.argmax(x @ proj, axis=-1))  # the reference's rule
    jeng = JEngine(policy=policy)

    def loss_fn(ps):
        logits = ref.forward(ps, jnp.asarray(x), jeng).astype(jnp.float32)
        return jnp.mean(jax.nn.logsumexp(logits, -1)
                        - jnp.take_along_axis(logits, jnp.asarray(y)[:, None], -1)[:, 0])

    want_loss, grads = jax.value_and_grad(loss_fn)([jnp.asarray(p) for p in params])
    want = [p - ref.LR * np.asarray(g) for p, g in zip(params, grads)]
    got, loss = train_tinyml.train_step([torch.from_numpy(p) for p in params],
                                        torch.from_numpy(x), torch.from_numpy(y),
                                        Engine(policy=policy, backend="torch"))
    tol = {"fp32": 1e-6, "redmule_hfp8": 0.0}[policy]
    assert abs(float(loss) - float(want_loss)) <= tol * abs(float(want_loss))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= tol * np.abs(w).max()


def test_train_tinyml_holds_the_papers_claim(capsys):
    results = train_tinyml.main(["--device", "cpu"])
    assert results["redmule_hfp8"] > results["fp32"] - 0.05
    assert "OK" in capsys.readouterr().out


# -- make_batch -------------------------------------------------------------------------

_TORCH_DTYPE = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_matches_the_reference_shapes(arch):
    cfg = tget_config(arch, smoke=True)
    want = jmake_batch(get_config(arch, smoke=True), 2, 16, jax.random.PRNGKey(0))
    got = make_batch(cfg, 2, 16, generator=torch.Generator().manual_seed(0), device="cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == _TORCH_DTYPE[w.dtype.type], name
    toks = got["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    again = make_batch(cfg, 2, 16, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("arch", ["internvl2-76b", "seamless-m4t-large-v2"])
def test_make_batch_dtypes_drive_both_models_alike(arch):
    """One numpy batch in make_batch's dtypes (int32 tokens, bf16 frontends)
    through both models' teacher-forced forward, fp32."""
    fp32 = dict(policy="fp32", kv_cache_dtype="fp32")
    jcfg = dataclasses.replace(get_config(arch, smoke=True), **fp32)
    model = build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(tget_config(arch, smoke=True), **fp32)
    tmodel = tbuild(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    batch = make_batch(tcfg, 2, 16, generator=torch.Generator().manual_seed(3), device="cpu")
    jbatch = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16) if v.is_floating_point()
              else jnp.asarray(v.numpy()) for k, v in batch.items()}
    h, _ = jax.jit(model.forward)(params, jbatch)
    want = np.asarray(jax.jit(model.logits)(params, h), np.float32)
    with torch.inference_mode():
        got = tmodel.logits(tparams, tmodel.forward(tparams, batch)[0]).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# -- the examples' mains ---------------------------------------------------------------

def test_quickstart_runs_on_the_cpu(capsys):
    got = quickstart.main(["--device", "cpu"])
    assert got["kernel_vs_plain"] == 0.0 and got["apsp_grad_nonzeros"] > 0
    assert capsys.readouterr().out.rstrip().endswith("OK")


@pytest.mark.parametrize("arch", ["granite-3-8b", "internvl2-76b"])
def test_serve_decode_runs_on_the_cpu(arch):
    server, out = serve_decode.main(["--device", "cpu", "--arch", arch, "--gen", "3"])
    if server is None:
        assert out.shape == (4, 3)
    else:
        assert len(out) == 4 and all(r.num_generated == 3 for r in out.values())


def test_train_lm_wraps_the_launcher():
    out = train_lm.main(["--device", "cpu", "--smoke", "--steps", "1", "--seq", "16",
                         "--batch", "2"])
    assert out["cfg"].name.startswith("xlstm") and len(out["history"]) == 1
    assert np.isfinite(out["history"][0]["loss"])


@pytest.mark.parametrize("module", [quickstart, train_tinyml, graph_shortest_paths,
                                    viterbi_decode, serve_decode, train_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_examples_default_to_the_card(module):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule under test is the one without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main([])
