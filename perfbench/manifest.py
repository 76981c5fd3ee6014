"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix (``perfbench/traffic/<mix>.json``),
its limits (``perfbench/limits/<cell>.json``), the driver of the mix's kind
(``perfbench/kinds/<kind>.py``) and each per-layer metric's reader
(``perfbench/metrics/<metric>.py``). Adding a cell, a mix or a metric adds
files and entries; no file here changes."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, section: str, cell: dict) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it, and those that list no cell (for a per-layer metric:
        every cell that reports the end-to-end metric it moves)."""
        e2e = {m["name"] for m in self.metrics("end_to_end", cell)} if section == "per_layer" else None
        out = []
        for m in self.data[section]:
            if "workloads" in m:
                if cell["name"] in m["workloads"]:
                    out.append(m)
            elif e2e is None or m["moves"] in e2e:
                out.append(m)
        return out


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def kind(name: str):
    return importlib.import_module(f"perfbench.kinds.{name}")


def metric(name: str):
    """The reader of per-layer metric ``name`` (its file's ``read``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
