"""Guards of the PyTorch port's boundaries.

- No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  the JAX package (``repro`` or ``repro.*``; ``repro_torch`` is the port).
- Library calls that compute a kernel's whole function (``torch.matmul``
  and its kin, the ``@`` operator, ``scaled_dot_product_attention``)
  appear only inside the kernels' plain versions, and ``torch.compile``
  nowhere.
- The entry points run on the card by default and raise, rather than run
  on the CPU, when CUDA is absent and the caller did not ask for the CPU.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}
TORCH_PRODUCTS = {"matmul", "mm", "bmm", "einsum"}


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield node.lineno, arg.value.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, root) for line, root in _imported_roots(tree) if root in FORBIDDEN_ROOTS]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_covers_every_subpackage():
    """The scans walk the whole package: observability, the roofline, the
    examples, the plan tables, the analysis passes, the perf model, the
    scale-out layer, the mesh, the dry run and the deprecated shims
    included."""
    seen = {p.relative_to(PORT).parts[0] for p in _port_files() if PORT in p.parents}
    assert {"obs", "roofline", "examples", "serving", "kernels", "configs", "analysis",
            "distrib"} <= seen
    for name in ("obs/trace.py", "obs/metrics.py", "obs/profiler.py", "obs/export.py",
                 "roofline/analysis.py", "roofline/cost.py", "configs/paper_tinyml.py",
                 "examples/train_tinyml.py", "examples/viterbi_decode.py", "kernels/tuning.py",
                 "core/perfmodel.py", "analysis/__init__.py", "analysis/__main__.py",
                 "analysis/cli.py", "analysis/contracts.py", "analysis/rules.py",
                 "analysis/tiles.py", "distrib/__init__.py", "distrib/collectives.py",
                 "distrib/compat.py", "distrib/fault.py", "distrib/sharding.py",
                 "launch/mesh.py", "launch/dryrun.py", "core/redmule.py"):
        assert PORT / name in _port_files(), name


def test_the_scan_sees_a_forbidden_import():
    tree = ast.parse("import jax.numpy as jnp\nfrom repro.core import semiring\n"
                     "from repro_torch.core import semiring\n")
    roots = [root for _, root in _imported_roots(tree)]
    assert roots == ["jax", "repro", "repro_torch"]


def _library_calls_outside_plain_versions(tree: ast.AST):
    """(line, call) of every library call outside a ``*_plain`` function."""
    found = []

    def visit(node, inside_plain):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside_plain = inside_plain or node.name.endswith("_plain")
        if isinstance(node, ast.Attribute):
            on_torch = getattr(node.value, "id", None) == "torch"
            if node.attr == "compile" and on_torch:
                found.append((node.lineno, "torch.compile"))
            elif not inside_plain and (
                    (on_torch and node.attr in TORCH_PRODUCTS)
                    or node.attr == "scaled_dot_product_attention"):
                found.append((node.lineno, node.attr))
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult) and not inside_plain:
            found.append((node.lineno, "@"))
        for child in ast.iter_child_nodes(node):
            visit(child, inside_plain)

    visit(tree, False)
    return found


def test_the_library_call_scan_sees_a_call():
    tree = ast.parse("def f(a, b):\n    return torch.matmul(a, b) + a @ b\n"
                     "def f_plain(a, b):\n    return torch.matmul(a, b)\n")
    assert _library_calls_outside_plain_versions(tree) == [(2, "matmul"), (2, "@")]


def test_library_calls_only_in_plain_versions():
    for path in sorted(PORT.rglob("*.py")):
        calls = _library_calls_outside_plain_versions(ast.parse(path.read_text()))
        assert not calls, f"{path.relative_to(ROOT)}: {calls}"


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule under test is the one without it")


def test_build_and_server_default_to_the_card():
    _require_no_cuda()
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serving import Server

    cfg = get_config("granite-3-8b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(cfg)
    model = build(cfg, device="cpu")
    assert model.engine.backend == "torch"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(model, model.init(0))


def test_serve_launcher_defaults_to_the_card():
    _require_no_cuda()
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke", "--requests", "1"])


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    server, results = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                                  "--prompt-len", "6", "--max-new", "3", "--num-slots", "2",
                                  "--page-size", "4"])
    assert len(results) == 3
    assert all(r.num_generated == 3 for r in results.values())
    assert "continuous: 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("change", [
    # seamless-m4t-large-v2's and internvl2-76b's smoke configs' own fields
    {"family": "audio", "n_encoder_layers": 2, "norm": "layernorm", "act": "gelu"},
    {"family": "vlm", "n_frontend_tokens": 8, "tie_embeddings": False},
    {"norm": "layernorm"}, {"family": "vlm"}, {"n_encoder_layers": 2},
])
def test_encdec_and_vlm_refuse_continuous_batching_as_the_reference_does(change):
    """What stays unported of the encoder-decoder and VLM families is what
    the reference refuses too: continuous batching. Their arch ids resolve
    and their models build, but ``init_state_store``, and with it
    ``Server``, raise ``NotImplementedError``. A LayerNorm
    decoder-only model serves continuously and matches the reference."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.serving import Server

    for arch in ("seamless-m4t-large-v2", "internvl2-76b"):
        assert get_config(arch).name == arch
    cfg = dataclasses.replace(get_config("granite-3-8b", smoke=True), **change)
    model = build(cfg, device="cpu")
    if not model.supports_cb():
        with pytest.raises(NotImplementedError, match="static-batch"):
            model.init_state_store(2, 4, 4)
        with pytest.raises(NotImplementedError, match="static-batch"):
            Server(model, params=None, device="cpu")
        return
    jax = pytest.importorskip("jax")
    import numpy as np

    from repro.configs import get_config as jget_config
    from repro.models import build as jbuild
    from repro_torch.convert import params_from_jax

    fp32 = dict(policy="fp32", kv_cache_dtype="fp32")
    cfg = dataclasses.replace(cfg, **fp32)
    model = build(cfg, device="cpu")
    jcfg = dataclasses.replace(jget_config("granite-3-8b", smoke=True), **change, **fp32)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    h, _ = jax.jit(jmodel.forward)(jparams, {"tokens": tokens})
    want = np.asarray(jax.jit(jmodel.logits)(jparams, h), np.float32)
    with torch.inference_mode():
        got = model.logits(params, model.forward(params, {
            "tokens": torch.from_numpy(tokens).long()})[0]).numpy()
    # fp32 sums in another order (tests/test_torch_encdec.py states why).
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    server = Server(model, params, device="cpu")
    server.submit([1, 2, 3], max_new_tokens=2)
    assert len(server.run()) == 1


def test_moe_expert_parallel_impl_raises():
    """The MoE family builds with the dense implementation and with expert
    parallelism (``moe_impl="ep"``: the dense layer without a mesh, as in
    the reference); an implementation neither package has raises."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    assert build(cfg, device="cpu").moe_cfg.impl == "dense"
    assert build(dataclasses.replace(cfg, moe_impl="ep"), device="cpu").moe_cfg.impl == "ep"
    with pytest.raises(ValueError, match="unknown MoE impl"):
        build(dataclasses.replace(cfg, moe_impl="alltoall"), device="cpu")
