"""The port's static analysis (``repro_torch.analysis``), on the CPU.

- Each ``RPR1xx`` rule fires on a torch-idiom snippet, and only a pragma
  with a reason silences it (a bare pragma is RPR100 and silences nothing).
- The port's tree lints clean.
- The plan-table validator passes on ``kernels/tuning.py``, and catches a
  seeded bad table, an unknown table and a ``csrc`` constant that parts
  from its Python mirror.
- The serving-step contracts pass on ``"torch"`` for granite-3-8b,
  recurrentgemma-2b and xlstm-125m at SMOKE size, and catch a seeded step
  that retypes a pool.
- The CLI's exit codes: 0 clean, 1 findings, 2 internal error.
"""
import shutil
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import cli, contracts, rules, tiles  # noqa: E402
from repro_torch.kernels import redmule_gemm as rg  # noqa: E402
from repro_torch.kernels import tuning  # noqa: E402
from repro_torch.kernels._build import CSRC  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# rule -> (path the snippet lints as, a snippet that fires it, its line)
SNIPPETS = {
    "RPR101": ("src/repro_torch/models/x.py", "def f(a, cache=[]):\n    return a\n", 1),
    "RPR102": ("src/repro_torch/serving/x.py",
               "DEFAULT = ServerConfig()\n", 1),
    "RPR103": ("src/repro_torch/serving/x.py", "_live = {}\n", 1),
    "RPR104": ("src/repro_torch/kernels/x.py", "def f(a):\n    assert a > 0\n", 2),
    "RPR105": ("src/repro_torch/serving/x.py",
               "def f(cache):\n    return torch.from_numpy(cache.page_table)\n", 2),
    "RPR106": ("src/repro_torch/serving/engine.py",
               "def dispatch_decode(self, logits):\n    return logits.argmax().item()\n", 2),
}


@pytest.mark.parametrize("rule", list(SNIPPETS))
def test_each_rule_fires_and_only_a_reasoned_pragma_silences_it(rule):
    path, src, line = SNIPPETS[rule]
    found = rules.lint_source(src, path)
    assert [(f.rule, f.line) for f in found] == [(rule, line)]
    lines = src.splitlines()
    reasoned = lines[:]
    reasoned[line - 1] += f"  # repro: allow[{rule}] checked by the caller"
    assert rules.lint_source("\n".join(reasoned), path) == []
    bare = lines[:]
    bare[line - 1] += f"  # repro: allow[{rule}]"
    assert sorted(f.rule for f in rules.lint_source("\n".join(bare), path)) == sorted(
        ["RPR100", rule])


@pytest.mark.parametrize("snippet", [
    "def dispatch_decode(self, t):\n    return t.tolist()\n",
    "def dispatch_decode(self, t):\n    return t.cpu()\n",
    "def dispatch_decode(self, t):\n    return t.numpy()\n",
    "def dispatch_decode(self, t):\n    torch.cuda.synchronize()\n",
    "def dispatch_decode(self, ev):\n    ev.synchronize()\n",
    "def dispatch_decode(self, t):\n    return float(t)\n",
    "def dispatch_decode(self, t):\n    def inner():\n        return int(t)\n    return inner\n",
])
def test_every_host_sync_of_a_hot_path_fires(snippet):
    assert [f.rule for f in rules.lint_source(snippet, "src/repro_torch/serving/engine.py")] == [
        "RPR106"]
    # Outside a registered hot path the same call is fine.
    assert rules.lint_source(snippet.replace("dispatch_decode", "harvest_one"),
                             "src/repro_torch/serving/engine.py") == []


@pytest.mark.parametrize("call", ["torch.as_tensor", "torch.asarray", "torch.from_numpy"])
def test_mirror_wrappers_fire_without_a_copy(call):
    path = "src/repro_torch/serving/cache.py"
    assert [f.rule for f in rules.lint_source(f"x = {call}(c.seq_lens)\n", path)] == ["RPR105"]
    assert rules.lint_source(f"x = {call}(c.seq_lens.copy())\n", path) == []
    assert rules.lint_source(f"x = {call}(c.seq_lens)\n", "src/repro_torch/models/x.py") == []


def test_the_ports_tree_lints_clean():
    findings = rules.lint_paths([str(ROOT / "src" / "repro_torch")])
    assert findings == [], "\n".join(map(str, findings))
    # Every pragma the tree carries has a reason.
    for path in rules.iter_python_files([str(ROOT / "src" / "repro_torch")]):
        for ln, (rule, reason, _) in rules._allow_pragmas(path.read_text().splitlines()).items():
            assert reason, (path, ln, rule)


def test_the_hot_paths_name_the_ports_functions():
    for suffix, names in rules.HOT_PATHS.items():
        src = (ROOT / "src" / suffix).read_text()
        for name in names:
            assert f"def {name}(" in src, (suffix, name)


def test_the_validator_passes_on_the_tables():
    assert tiles.validate_tuning_tables() == []
    assert tiles.discover_tables() == ["DECODE_SPLIT", "SIMT_SPLIT", "SMALL_ROW_SPLIT"]


def test_the_validator_catches_a_seeded_bad_table(monkeypatch):
    monkeypatch.setattr(tuning, "SMALL_ROW_SPLIT", tuning.SplitRule(264, 200))
    monkeypatch.setattr(tuning, "BOGUS_SPLIT", tuning.SplitRule(1, 64), raising=False)
    monkeypatch.setattr(tuning, "SMALL_M_MAX", 32)
    found = {(f.table, f.detail.split(" ")[0]) for f in tiles.validate_tuning_tables()}
    assert ("SMALL_ROW_SPLIT", "least") in found  # 200 is no multiple of SR_STEP
    assert ("BOGUS_SPLIT", "table") in found  # unknown to the validator
    assert ("SMALL_M_MAX", "band") in found  # past the kernel's 16 rows
    assert any(t == "plan_gemm" for t, _ in found)  # 17-32 rows planned on small rows


def test_the_validator_catches_a_mismatched_csrc_constant(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    src = (csrc / "redmule_gemm_sr.cu").read_text()
    (csrc / "redmule_gemm_sr.cu").write_text(
        src.replace("constexpr int SR_STEP = 64;", "constexpr int SR_STEP = 32;"))
    found = tiles.validate_tuning_tables(csrc=csrc)
    assert [(f.table, f.entry) for f in found] == [("csrc", "redmule_gemm.SR_STEP")]
    src = (csrc / "paged_decode.cu").read_text()
    (csrc / "paged_decode.cu").write_text(src.replace("constexpr int GB = 4;", "constexpr int GB = 8;"))
    assert ("csrc", "flash_attention._DECODE_GROUP") in {
        (f.table, f.entry) for f in tiles.validate_tuning_tables(csrc=csrc)}


def test_the_copy_tile_and_the_cluster_cap_mirror_the_sources(tmp_path):
    """The K-major copy's tile and the small-row cluster cap against
    ``csrc/``'s constants."""
    sr = tiles.csrc_constants(CSRC / "redmule_gemm_sr.cu")
    assert (sr["COPY_TILE_K"], sr["COPY_TILE_BYTES"], sr["SR_MAX_CLUSTER"]) == (
        rg.COPY_TILE_K, rg.COPY_TILE_BYTES, rg.SR_MAX_CLUSTER) == (128, 128, 16)
    assert tiles.copy_smem_bytes(sr) == 3 * 128 * 128 <= tiles.STATIC_SMEM
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    src = (csrc / "redmule_gemm_sr.cu").read_text()
    (csrc / "redmule_gemm_sr.cu").write_text(
        src.replace("constexpr int SR_MAX_CLUSTER = 16;", "constexpr int SR_MAX_CLUSTER = 8;")
        .replace("constexpr int COPY_TILE_BYTES = 128;", "constexpr int COPY_TILE_BYTES = 64;"))
    found = {(f.table, f.entry) for f in tiles.validate_tuning_tables(csrc=csrc)}
    assert {("csrc", "redmule_gemm.SR_MAX_CLUSTER"), ("csrc", "redmule_gemm.COPY_TILE_BYTES"),
            ("csrc", "COPY_TILE")} <= found


def test_the_shared_memory_mirrors_read_the_sources():
    tc = tiles.csrc_constants(CSRC / "redmule_gemm_tc.cu")
    assert tiles.tc_smem_bytes(tc, True) == 230448 <= tiles.SMEM_PER_BLOCK
    assert tiles.sr_smem_bytes(tiles.csrc_constants(CSRC / "redmule_gemm_sr.cu")) == 2 * 8 * 2064
    assert tiles.csrc_constants(CSRC / "redmule_simt.cuh")["XP"] == 68


@pytest.mark.parametrize("arch", ["granite-3-8b", "recurrentgemma-2b", "xlstm-125m"])
def test_contracts_pass_on_the_plain_backend(arch):
    assert contracts.check_arch(arch, backend="torch") == []
    if arch != "xlstm-125m":
        assert contracts.check_arch(arch, backend="torch", fp8_kv=True) == []


def test_contracts_catch_a_step_that_retypes_a_pool(monkeypatch):
    real = contracts.step_fns

    def retyping(model, params, vocab, seed=0):
        fns = real(model, params, vocab, seed)
        forward, arrays, shape = fns["decode"]

        def bad(d, pools):
            out = forward(d, pools)
            pools[0]["kp"] = pools[0]["kp"].to(torch.float16)
            return out

        fns["decode"] = (bad, arrays, shape)
        return fns

    monkeypatch.setattr(contracts, "step_fns", retyping)
    found = contracts.check_arch("granite-3-8b", backend="torch", fp8_kv=True)
    assert {(v.step, v.contract) for v in found} >= {("decode", "pools-preserved"),
                                                     ("decode", "fp8-storage")}


def test_contracts_catch_a_kernel_launch_on_the_plain_backend(monkeypatch):
    real = contracts.launch_counts
    calls = iter(range(1000))
    monkeypatch.setattr(contracts, "launch_counts",
                        lambda: {k: v + next(calls) for k, v in real().items()})
    found = contracts.check_arch("xlstm-125m", backend="torch", steps=("decode",))
    assert [v.contract for v in found] == ["kernel-iff-backend", "kernel-iff-backend"]


def test_the_bucket_policy_is_bounded():
    assert contracts.check_bucket_policy(4) == []
    assert contracts.check_bucket_policy(16) == []


def test_cli_exit_codes(tmp_path, capsys):
    assert cli.main(["--no-contracts", str(ROOT / "src" / "repro_torch" / "kernels")]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""\
        def f(a, cache={}):
            return a
    """))
    assert cli.main(["--no-contracts", "--no-tiles", str(bad)]) == 1
    assert "RPR101" in capsys.readouterr().out
    assert cli.main(["--no-lint", "--no-tiles", "--archs", "no-such-arch"]) == 2
    assert cli.main(["--list-rules"]) == 0
    assert "RPR106" in capsys.readouterr().out
    assert cli.main(["--no-lint", "--no-tiles", "--archs", "xlstm-125m",
                     "--hbm-budget-mb", "1e-6"]) == 1
