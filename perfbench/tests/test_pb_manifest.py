"""BENCHMARK.json and the files it names: every entry resolves to a file
by name, and every name, unit and text keeps to the benchmark's rules."""
import json
import re

import pytest

from perfbench import manifest

ROOT = manifest.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
WIDTHS = {"hidden_size", "intermediate_size", "moe_intermediate_size", "head_dim",
          "num_experts_per_tok", "num_attention_heads", "num_key_value_heads"}


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[k]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    bench = manifest.Manifest(ROOT)
    w = bench.workload(cell)
    cfg = bench.config(w["config"])
    assert cfg["name"] == w["config"]
    mix = manifest.traffic(w["traffic"])
    assert hasattr(manifest.kind(mix["kind"]), "run")
    limits = manifest.limits(cell)
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    e2e = {m["name"] for m in bench.metrics("end_to_end", w)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = bench.metrics("per_layer", w)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_resolves_by_name(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = manifest.metric(metric)
    assert callable(mod.read) and mod.MOVES == entry["moves"]
    assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_states_its_cut(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("perfbench/")
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert key not in WIDTHS and not key.endswith(("_dim", "_rank")), key
        assert cfg["published"][key] != cfg[key]


def test_end_to_end_sources_and_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
