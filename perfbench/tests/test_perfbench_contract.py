"""BENCHMARK.json and the files it names: every name, unit and text within
the format's limits, every cell's files found by name, every metric's
reader agreeing with its entry, and the time a full check of 24 cells
takes within its budget of 12 hours."""
from __future__ import annotations

import json
import os
import re

import pytest

from perfbench import cells, check

ROOT = os.path.dirname(cells.HERE)
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS \
        + [c["name"] for c in BENCH["configs"]] \
        + [w["traffic"] for w in BENCH["workloads"]] \
        + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_check_time_fits():
    n = 24        # the most cells the benchmark may hold
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    c = cells.load(ROOT, cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert TEXT.match(entry["why"]) and entry["chips"] in (1, 4)
    assert c.workload["config"] == entry["config"]
    assert c.workload["traffic"] == entry["traffic"]
    assert set(c.workload["limits"]) == set(check.NUMBERS)
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer
    conf = next(x for x in BENCH["configs"] if x["name"] == entry["config"])
    assert conf["file"] == f"perfbench/configs/{entry['config']}.json"
    assert c.config["reduced"] == conf["reduced"]
    assert TEXT.match(conf["source"]) and TEXT.match(conf["why"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_reader_agrees(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = cells.load(ROOT, CELLS[0]).reader(metric)
    assert (reader.LAYER, reader.MOVES, reader.UNIT) == (
        entry["layer"], entry["moves"], entry["unit"])
    assert callable(reader.read)


def test_configs_used_once():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
