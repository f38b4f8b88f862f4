"""Finds a cell's files by name: ``cells/<cell>.json`` names its
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<mix>.json``); ``BENCHMARK.json`` at the root of the checkout
says which metrics the cell reports, and each metric's reader is
``metrics/<metric>.py``.  A new cell, configuration, mix or metric is a
new file and an entry in ``BENCHMARK.json``, never an edit of a file that
is there."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    check: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def reports(metric: Dict, cell: str, bench: Optional[Dict] = None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list; without the list, an end-to-end metric is every cell's, and a
    per-layer one (given the whole ``bench``) is every cell's that reports
    the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric and bench is not None:
        moved = next(m for m in bench["end_to_end"]
                     if m["name"] == metric["moves"])
        return reports(moved, cell)
    return True


def load(name: str, base: Path = HERE, benchmark=None) -> Cell:
    """The cell ``name`` of ``benchmark`` (a path or the parsed file;
    ``BENCHMARK.json`` beside ``base`` by default), from its files."""
    bench = (benchmark if isinstance(benchmark, dict)
             else _json(benchmark or base.parent / "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    cell = _json(base / "cells" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"cells/{name}.json and BENCHMARK.json disagree "
                         f"on the configuration or the traffic")
    return Cell(name=name, chips=entry["chips"],
                config_name=cell["config"],
                config=_json(base / "configs" / f"{cell['config']}.json"),
                traffic_name=cell["traffic"],
                traffic=_json(base / "traffic" / f"{cell['traffic']}.json"),
                check=cell["check"],
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, name, bench)])


def reader(metric: str, base: Path = HERE) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
