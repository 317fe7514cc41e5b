"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix. The configuration's file is
the one ``configs`` gives; the traffic mix is ``benchmark/traffic/<traffic>
.json`` (its ``runner`` names the module in ``benchmark/runners/`` that
runs it); the cell's correctness limits are ``benchmark/limits/<cell>.json``;
a per-layer metric's reader is ``benchmark/metrics/<metric>.py``. Adding a
cell, a mix or a metric adds files and entries; it edits none.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def applies(metric: dict, cell: str) -> bool:
    """A metric is reported in a cell its ``workloads`` list, or in every
    cell where it has none."""
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One workload of the manifest with everything it needs."""

    def __init__(self, manifest: dict, name: str):
        self.manifest = manifest
        self.entry = _by_name(manifest["workloads"], name, "workload")
        self.name = name
        self.config_entry = _by_name(manifest["configs"], self.entry["config"],
                                     "configuration")
        with open(ROOT / self.config_entry["file"]) as f:
            self.config = json.load(f)
        with open(BENCH / "traffic" / f"{self.entry['traffic']}.json") as f:
            self.traffic = json.load(f)
        with open(BENCH / "limits" / f"{name}.json") as f:
            self.limits = json.load(f)["limits"]
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in manifest["per_layer"] if applies(m, name)]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def reader(metric: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_names(group: str) -> list[str]:
    """The kernel names of a group: the union of the ``kernels`` lists of
    every ``benchmark/kernels/<group>/*.json``."""
    names = []
    for p in sorted((BENCH / "kernels" / group).glob("*.json")):
        with open(p) as f:
            names += json.load(f)["kernels"]
    return names
