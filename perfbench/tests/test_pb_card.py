"""One short run of each cell through the entry point, on the card: the
result line's keys, the device it names and ``correct``. Skips on a
machine without a card; run on the card with
``python -m pytest perfbench/tests/test_pb_card.py``."""
import json
import subprocess
import sys

import pytest

from perfbench import manifest
from perfbench.tests.conftest import ROOT

CELLS = [w["name"] for w in manifest.Manifest(ROOT).data["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(2**31 + 41), "--seconds", "5", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["correct"], line["checks"]
