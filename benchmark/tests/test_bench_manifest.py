"""BENCHMARK.json keeps to its rules and every cell's files are found."""
import json
import re

import pytest

from benchmark.core.manifest import BENCH, ROOT, Cell, kernel_names, load_manifest, reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")

M = load_manifest()


def test_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len(M["command"]) <= 32 and all(LINE.match(w) for w in M["command"])
    for p in M["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and ".." not in p


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    assert len(set(names)) == len(names)
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in M["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in M["per_layer"]:
        assert LINE.match(m["layer"])


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(cell):
    c = Cell(M, cell)
    assert (ROOT / c.config_entry["file"]).is_file()
    assert str(c.config_entry["file"]).startswith("benchmark/")
    assert (BENCH / "runners" / f"{c.traffic['runner']}.py").is_file()
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(reader(m["name"]))


def test_every_config_used_and_kernels_listed():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        with open(ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
    assert "raster_fwd_kernel" in kernel_names("raster")
