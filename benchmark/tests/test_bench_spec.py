"""``BENCHMARK.json``: every entry resolves to its files by name, and names,
units and sizes keep to the benchmark's contract."""
import json
import os
import re

import pytest

from benchmark import spec as spec_mod
from benchmark.spec import Spec

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def data():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(data):
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= data["run_seconds"] <= 51
    assert 1 <= len(data["paths"]) <= 16
    for p in data["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(data["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_keep_to_the_contract(data):
    names = set()
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(data["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    cells = set()
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
        cells.add(w["name"])
    assert {w["config"] for w in data["workloads"]} == names
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    seen = set()
    for m in data["end_to_end"] + data["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in data["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_resolves_by_name(data):
    spec = Spec(ROOT)
    for w in data["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == cell.config_entry["reduced"]
        assert hasattr(cell.request_module(), "Session")
        assert set(cell.limits["numbers"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.end_to_end:
            assert callable(spec.end_to_end_module(m["name"]).read)
        for m in cell.per_layer:
            assert callable(spec.metric_module(m["name"]).read)
            assert m["moves"] in e2e


def test_benchmark_files_only_name_allowed_characters():
    base = os.path.dirname(spec_mod.__file__)
    for dirpath, _, files in os.walk(base):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel
