"""``BENCHMARK.json`` against the contract's shape, and every file it
names present."""

import json
import re

import pytest

from benchmark.spec import Spec
from benchmark.tests.tiny import REPO

DOC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(DOC) == KEYS
    assert DOC["command"] == ["python3", "benchmark/run.py"]
    assert DOC["paths"] == ["benchmark"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10
    runs = 2 + 14 * 24
    assert runs * (DOC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        names.append(w["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in DOC["end_to_end"]}


@pytest.mark.parametrize("workload", [w["name"] for w in DOC["workloads"]])
def test_every_cell_finds_its_files(workload):
    spec = Spec(REPO)
    cell = spec.cell(workload)
    cfg = spec.config(cell["config"])
    assert {"source", "assumed", "reduced", "guarantees", "limits"} <= set(cfg)
    assert set(cfg["reduced"]) == set(
        next(c for c in DOC["configs"] if c["name"] == cell["config"])["reduced"])
    spec.traffic(cell["traffic"])
    e2e = {m["name"] for m in spec.end_to_end(workload)}
    for m in spec.per_layer(workload):
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]))
