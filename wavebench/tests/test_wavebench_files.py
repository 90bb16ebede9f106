"""BENCHMARK.json and the files it names: every configuration, mix, limit
and metric loads by its name, and every name and unit keeps to the allowed
characters."""

import json
import re

import pytest

from wavebench import spec

BENCH = spec.benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "wavebench.run"]
    assert BENCH["paths"] == ["wavebench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_loads_by_name(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    assert spec.NAME.fullmatch(name)
    assert entry["file"] == f"wavebench/configs/{name}.json"
    cfg = spec.config(name)
    assert cfg["name"] == name
    assert cfg["reduced"] == entry["reduced"] == []
    assert LINE.fullmatch(entry["source"]) and LINE.fullmatch(entry["why"])
    assert any(w["config"] == name for w in BENCH["workloads"])


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_pieces_load_by_name(name):
    w = spec.workload(BENCH, name)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert spec.NAME.fullmatch(w["traffic"]) and w["chips"] == 1
    assert LINE.fullmatch(w["why"])
    mix = spec.traffic(w["traffic"])
    spec.generator(mix["generator"])
    limits = spec.limits(name)
    assert limits and all(v > 0 for v in limits.values())
    e2e, layer = spec.cell_metrics(BENCH, name)
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2
    assert layer and all(m["moves"] in names for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_names_units_and_sources(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    assert spec.NAME.fullmatch(m["name"]) and spec.UNIT.fullmatch(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.fullmatch(m["layer"])
        assert callable(spec.metric_reader(metric).read)


def test_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in METRICS] + WORKLOADS + [
        c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)


def test_bad_names_are_refused():
    with pytest.raises(ValueError):
        spec.config("../BENCHMARK")
    with pytest.raises(ValueError):
        spec.traffic("a b")
