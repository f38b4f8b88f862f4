"""``BENCHMARK.json`` against the benchmark's rules, every cell loaded
from its files, and a new cell, configuration, mix and metric picked up
from new files alone."""
import json
import re
import shutil

import pytest

from bench import spec
from conftest import HERE, ROOT, with_held

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the benchmark with its held cells put back, as a later PR would
ALL = with_held()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    # a full check of 24 cells must fit its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24


@pytest.mark.parametrize("BENCH", [BENCH, ALL], ids=["benchmark", "held"])
def test_names_units_and_keys(BENCH):
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in seen
        seen.add(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in seen
        seen.add(w["name"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])
    names = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", names)) <= set(names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        # each cell the metric lists reports the metric it moves; without
        # a list, the metric is theirs
        for w in m.get("workloads", names):
            assert spec.reports(e2e[m["moves"]], w) or "workloads" not in m
            assert spec.reports(m, w, BENCH) == spec.reports(
                e2e[m["moves"]], w) or "workloads" in m
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_every_cell_loads_from_its_files(cell):
    c = spec.load(cell, benchmark=ALL)
    assert c.config["deployment"]["instances"] >= 2
    assert {"sample", "gap_limit", "min_tokens"} <= set(c.check)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert all(m["moves"] in names for m in c.per_layer)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    """A copy of the benchmark's folder gains a configuration, a mix, a
    cell and a metric as new files; no file that was there changes."""
    base = tmp_path / "perfbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "minicpm-2b.json").read_text())
    cfg["deployment"]["slots"] = 16
    (base / "configs" / "minicpm-2b-16.json").write_text(json.dumps(cfg))
    (base / "traffic" / "chat-light.json").write_text(json.dumps(
        {"arrival": {"kind": "poisson", "rate": 3.0},
         "lengths": {"kind": "table2", "mix": "light"},
         "warm_seconds": 4.0}))
    (base / "cells" / "minicpm-2b-16.chat-light.json").write_text(
        json.dumps({"config": "minicpm-2b-16", "traffic": "chat-light",
                    "check": {"sample": 4, "gap_limit": 1.0,
                              "min_tokens": 100}}))
    (base / "metrics" / "steps_per_s.py").write_text(
        "def read(run):\n    return len(run.steps()) / run.seconds\n")
    bench = dict(ALL)
    bench["configs"] = ALL["configs"] + [dict(
        ALL["configs"][1], name="minicpm-2b-16",
        file="perfbench/configs/minicpm-2b-16.json")]
    bench["workloads"] = ALL["workloads"] + [{
        "name": "minicpm-2b-16.chat-light", "config": "minicpm-2b-16",
        "traffic": "chat-light", "chips": 1, "why": "a test cell"}]
    bench["per_layer"] = ALL["per_layer"] + [{
        "name": "steps_per_s", "unit": "1/s", "better": "higher",
        "source": "program_span", "layer": "cluster loop",
        "moves": "output_tokens_per_s",
        "workloads": ["minicpm-2b-16.chat-light"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("minicpm-2b-16.chat-light", base=base)
    assert cell.config["deployment"]["slots"] == 16
    assert cell.traffic["lengths"]["mix"] == "light"
    assert "steps_per_s" in [m["name"] for m in cell.per_layer]
    assert spec.reader("steps_per_s", base=base)(
        type("R", (), {"steps": lambda self: [1, 2], "seconds": 4.0})()) \
        == 0.5
    assert all(p.read_bytes() == b for p, b in before.items())
