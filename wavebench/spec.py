"""Finds a cell's pieces by name.

BENCHMARK.json, at the root of the checkout, names the cells, the
configurations, the traffic mixes and the metrics.  Everything that belongs
to one of them is a file of its own under wavebench/, found by that name:

    configs/<config>.json     the deployment as it is run
    traffic/<mix>.json        the mix's parameters; "generator" names
                              its code, generators/<generator>.py
    limits/<cell>.json        the numbers `correct` compares, each with its
                              limit
    metrics/<metric>.py       the reader of one per-layer metric
    roofline/<kernel>.json    a kernel's frozen bytes and operations
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{_name('config', name)}.json")


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{_name('traffic', name)}.json")


def limits(cell: str) -> Dict[str, float]:
    return _json(HERE / "limits" / f"{_name('workload', cell)}.json")


def roofline(kernel: str) -> dict:
    return _json(HERE / "roofline" / f"{_name('kernel', kernel)}.json")


def peaks() -> dict:
    return _json(HERE / "roofline" / "peaks.json")


def generator(name: str) -> ModuleType:
    return importlib.import_module(
        f"wavebench.generators.{_name('generator', name)}")


def metric_reader(name: str) -> ModuleType:
    """metrics/<name>.py, loaded by path (metric names hold dots)."""
    path = HERE / "metrics" / f"{_name('metric', name)}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"wavebench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries this cell reports: an
    end-to-end metric in the cells its `workloads` lists, or in every cell
    without one; a per-layer metric in the cells its `workloads` lists, or
    without one in every cell that reports the metric it `moves`."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer
