"""BENCHMARK.json keeps to the contract's form, and every name it gives
has its file."""
import json
import re

import pytest

from gpubench import harness

BENCH = harness.load_manifest(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ONE_LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(ONE_LINE.match(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert ONE_LINE.match(w["why"]) and w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert ONE_LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_name_has_its_file():
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"].startswith("gpubench/")
        assert cfg["reduced"] == c["reduced"]
    for name in CELLS:
        spec = harness.cell_spec(BENCH, name)
        assert spec["limits"]
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(harness.ROOT, m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    spec = harness.cell_spec(BENCH, cell)
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
