"""The benchmark's readers of the engine's step seconds
(``perfbench/metrics/{prefill_stream_ms,decode_stream_ms,step_gap_share}.serve.py``),
each loaded by its path as ``perfbench.manifest.metric`` loads it, on
synthetic ``run`` dicts: what the serve kind puts in ``observed``."""
import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
NAMES = ("prefill_stream_ms.serve", "decode_stream_ms.serve", "step_gap_share.serve")


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}",
                                                  ROOT / "perfbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(window, steps):
    return {"observed": {"window": window, "step_s": steps}}


# A window's registry deltas and its Server.step walls, by whether the
# step carried a prefill chunk.
WINDOW = {"decode_steps": 1500, "decode_tokens": 23600, "slot_steps": 24000,
          "decode_s": 40.5, "prefill_s": 9.0, "prefill_tokens": 44000, "prefill_steps": 40,
          "nonfinite_steps": 0}
STEPS = {False: [0.03] * 1460, True: [0.26] * 40}


def test_prefill_stream_ms_is_a_prefill_steps_mean_span():
    assert _reader(NAMES[0]).read(_run(WINDOW, STEPS)) == pytest.approx(1e3 * 9.0 / 40)


def test_decode_stream_ms_is_a_decode_steps_mean_span():
    assert _reader(NAMES[1]).read(_run(WINDOW, STEPS)) == pytest.approx(27.0)


def test_step_gap_share_is_the_loops_time_outside_the_steps_spans():
    wall = 0.03 * 1460 + 0.26 * 40
    want = 100 * (1 - 49.5 / wall)
    assert _reader(NAMES[2]).read(_run(WINDOW, STEPS)) == pytest.approx(want)
    # Spans that fill the loop leave no gap.
    full = WINDOW | {"decode_s": 0.03 * 1460, "prefill_s": 0.26 * 40}
    assert _reader(NAMES[2]).read(_run(full, STEPS)) == pytest.approx(0, abs=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_finds_nothing_where_the_window_holds_no_step(name):
    empty = {"decode_steps": 0, "decode_tokens": 0, "slot_steps": 0}
    assert _reader(name).read(_run(empty, {False: [], True: []})) is None


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_has_its_benchmark_entry(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert entry["source"] == "program_counter" and entry["moves"] == "out_tok_s"
    assert entry["workloads"] == ["phi3.5-moe.serve-16clients"]
    assert _reader(name).MOVES == entry["moves"]
