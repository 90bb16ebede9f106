"""The port's telemetry (wavetpu_torch/obs/: registry, tracing, metrics,
telemetry, report) against wavetpu's on the same inputs, on the CPU.

The contract: the same updates give a byte-equal Prometheus exposition
and an equal JSON snapshot; span records carry the same keys and parent
links; a telemetry dir holds the same files; `trace-report` prints the
same text over the same trace; the solver instruments keep wavetpu's
metric names and label sets (an unmodified `wavetpu router` scrape must
read a port replica).
"""

import json
import os

import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.obs import metrics as jmetrics
from wavetpu.obs import registry as jregistry
from wavetpu.obs import report as jreport
from wavetpu.obs import telemetry as jtelemetry
from wavetpu.obs import tracing as jtracing
from wavetpu.solver import leapfrog as jleapfrog
from wavetpu_torch import cli
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.obs import (
    metrics, perf, registry, report, telemetry, tracing,
)
from wavetpu_torch.solver import leapfrog, sharded


def _updates(reg):
    c = reg.counter("wavetpu_solves_total", "completed solve entry points",
                    ("path",))
    c.inc(path="leapfrog")
    c.inc(2, path="kfused")
    g = reg.gauge("wavetpu_last_solve_gcells_per_s",
                  "throughput of the most recent solve", ("path",))
    g.set(37.05, path="leapfrog")
    g.set(1e-9, path='we"ird\\path\n')
    h = reg.histogram("wavetpu_solve_gbps", "per-solve modeled-GB/s",
                      ("path",), buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v, path="sharded")
    reg.counter("wavetpu_plain_total", "no labels").inc(3.25)
    reg.gauge("wavetpu_neg", "negative").dec(4)


def test_registry_exposition_and_snapshot_equal_wavetpus():
    ours, ref = registry.MetricsRegistry(), jregistry.MetricsRegistry()
    _updates(ours)
    _updates(ref)
    assert ours.render_prometheus() == ref.render_prometheus()
    assert ours.snapshot() == ref.snapshot()
    assert json.dumps(ours.snapshot()) == json.dumps(ref.snapshot())
    assert ours.names() == ref.names()


def test_registry_exemplars_render_as_wavetpus():
    ours, ref = registry.MetricsRegistry(), jregistry.MetricsRegistry()
    for reg in (ours, ref):
        h = reg.histogram("wavetpu_req_seconds", "x", ("tier",),
                          buckets=(0.1, 1.0))
        h.observe(0.05, exemplar={"request_id": "r-1"}, tier="gold")
        h.observe(0.5, tier="gold")
    # The exemplar carries its own wall timestamp: compare with it fixed.
    a = ours.render_prometheus(openmetrics=True).splitlines()
    b = ref.render_prometheus(openmetrics=True).splitlines()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.rsplit(" ", 1)[0] == y.rsplit(" ", 1)[0] or x == y


def _span_tree(mod, path):
    mod.configure(path)
    try:
        with mod.span("outer", who="parent"):
            with mod.span("inner") as attrs:
                attrs["found"] = 42
            mod.event("ping", n=1)
            h = mod.begin_span("cli.solve", n=8)
            mod.end_span(h, final_step=3)
    finally:
        mod.disable()
    return [json.loads(line) for line in open(path)]


def test_span_records_have_wavetpus_keys_and_links(tmp_path):
    ours = _span_tree(tracing, str(tmp_path / "ours.jsonl"))
    ref = _span_tree(jtracing, str(tmp_path / "ref.jsonl"))
    assert [r["kind"] for r in ours] == [r["kind"] for r in ref]
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        assert a["type"] == b["type"] and a["attrs"] == b["attrs"]

    def links(recs):
        kind_of = {r["span_id"]: r["kind"] for r in recs}
        return [(r["kind"], kind_of.get(r["parent_id"])) for r in recs]

    assert links(ours) == links(ref)


def test_w3c_trace_context_matches_wavetpu():
    tid, sid = tracing.mint_trace_id(), tracing.mint_span_id()
    header = tracing.format_traceparent(tid, sid)
    assert header == jtracing.format_traceparent(tid, sid)
    assert tracing.parse_traceparent(header) == \
        jtracing.parse_traceparent(header)
    for bad in (None, "", "00-zz-11-01", "ff-" + "0" * 32 + "-" + "1" * 16
                + "-01"):
        assert tracing.parse_traceparent(bad) == \
            jtracing.parse_traceparent(bad)


def test_span_opens_a_record_function_range(tmp_path):
    """With torch loaded a span opens torch.profiler.record_function(kind),
    so the profiler's trace shows the application span."""
    tracing.configure(str(tmp_path / "t.jsonl"))
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracing.span("probe.kind"):
                torch.ones(4).sum()
    finally:
        tracing.disable()
    assert "probe.kind" in {e.key for e in prof.key_averages()}


def test_telemetry_dir_has_wavetpus_files(tmp_path):
    for mod, trace_mod, d in ((telemetry, tracing, tmp_path / "ours"),
                              (jtelemetry, jtracing, tmp_path / "ref")):
        tel = mod.start(str(d), registry=registry.MetricsRegistry()
                        if mod is telemetry else jregistry.MetricsRegistry(),
                        interval=60.0)
        try:
            trace_mod.event("hello", n=1)
        finally:
            tel.stop()
        assert not trace_mod.enabled()
    assert sorted(os.listdir(tmp_path / "ours")) == \
        sorted(os.listdir(tmp_path / "ref"))
    beats = [json.loads(line)
             for line in open(tmp_path / "ours" / "heartbeat.jsonl")]
    assert beats and "metrics" in beats[-1]


def _synthetic_trace(path):
    recs = [
        {"type": "span", "kind": "cli.solve", "span_id": "p-1",
         "parent_id": None, "t_start": 10.0, "dur_s": 0.50,
         "attrs": {"request_id": "p-9", "n": 512}},
        {"type": "span", "kind": "solve.chunk", "span_id": "p-3",
         "parent_id": "p-2", "t_start": 10.1, "dur_s": 0.30,
         "attrs": {"warm": True}},
        {"type": "span", "kind": "serve.batch", "span_id": "p-2",
         "parent_id": None, "t_start": 10.05, "dur_s": 0.40,
         "attrs": {"request_ids": ["p-9"], "occupancy": 2}},
        {"type": "span", "kind": "cli.solve", "span_id": "p-4",
         "parent_id": None, "t_start": 11.0, "dur_s": 0.10,
         "attrs": {"request_id": "p-8"}},
        {"type": "event", "kind": "memory.warn", "span_id": "p-5",
         "parent_id": None, "t_start": 12.0, "attrs": {"bytes": 4}},
    ]
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write("not json\n")  # a mid-write tail must not be fatal
    return str(path)


@pytest.mark.parametrize("args", [["{p}"], ["{p}", "--kind", "cli.solve"],
                                  ["--dir", "{d}"]],
                         ids=["summary", "kind", "dir"])
def test_trace_report_equals_wavetpus(tmp_path, capsys, args):
    path = _synthetic_trace(tmp_path / "trace.jsonl")
    args = [a.format(p=path, d=tmp_path) for a in args]
    assert cli.main(["trace-report"] + args) == 0
    ours = capsys.readouterr().out
    assert jreport.main(args) == 0
    assert ours == capsys.readouterr().out


def test_trace_report_of_a_port_run_equals_wavetpus(tmp_path, capsys):
    tel = tmp_path / "tel"
    assert cli.main(["8", "1", "1", "1", "1", "1", "3", "--platform", "cpu",
                     "--mesh", "2,2,1", "--overlap", "--out-dir",
                     str(tmp_path), "--telemetry-dir", str(tel)]) == 0
    capsys.readouterr()
    recs = [json.loads(line) for line in open(tel / "trace.jsonl")]
    (solve,) = [r for r in recs if r["kind"] == "cli.solve"]
    assert solve["attrs"]["backend"] == "sharded"
    assert solve["attrs"]["final_step"] == 3
    for args in ([str(tel / "trace.jsonl")], ["--dir", str(tel)]):
        assert cli.main(["trace-report"] + args) == 0
        ours = capsys.readouterr().out
        assert report.main(args) == 0
        assert capsys.readouterr().out == ours
        assert jreport.main(args) == 0
        assert capsys.readouterr().out == ours
    assert cli.main(["trace-report"]) == 2
    assert cli.main(["trace-report", str(tmp_path / "missing.jsonl")]) == 2


def _names_and_labels(reg):
    snap = reg.snapshot()
    out = {}
    for name in reg.names():
        m = reg._metrics[name]
        out[name] = (m.kind, tuple(m.labelnames))
    assert set(out) == set(snap)
    return out


def test_record_solve_keeps_wavetpus_metric_names_and_labels(monkeypatch):
    """The leapfrog instruments: the same families, kinds and label sets
    as wavetpu's record_solve on the same problem."""
    ours_reg, ref_reg = registry.MetricsRegistry(), \
        jregistry.MetricsRegistry()
    monkeypatch.setattr(metrics, "get_registry", lambda: ours_reg)
    monkeypatch.setattr(jmetrics, "get_registry", lambda: ref_reg)
    leapfrog.solve(Problem(N=8, timesteps=3), device="cpu")
    jleapfrog.solve(JProblem(N=8, timesteps=3))
    assert _names_and_labels(ours_reg) == _names_and_labels(ref_reg)
    for reg in (ours_reg, ref_reg):
        assert reg._metrics["wavetpu_solves_total"].value(
            path="leapfrog") == 1


@pytest.mark.parametrize("path,kw", [
    ("leapfrog", {}),
    ("sharded", dict(mesh=(2, 2, 1))),
    ("sharded_kfused", dict(mesh=(2, 2, 1), k=2)),
    ("kfused", dict(k=2)),
    ("kfused_comp", dict(k=2, scheme="compensated")),
    ("kfused_comp_sharded", dict(mesh=(2, 1, 1), k=2,
                                 scheme="compensated")),
    ("compensated", dict(scheme="compensated")),
])
def test_every_solver_entry_point_records_its_solve(path, kw):
    from wavetpu_torch.solver import kfused, kfused_comp, sharded_kfused

    reg = registry.get_registry()
    solves = reg.counter("wavetpu_solves_total",
                         "completed solve entry points", ("path",))
    gbps = reg.histogram("wavetpu_solve_gbps", "", ("path",),
                         buckets=perf._GBPS_BUCKETS)
    before, observed = solves.value(path=path), gbps.count(path=path)
    p = Problem(N=8, timesteps=5)
    mesh, k = kw.get("mesh"), kw.get("k")
    scheme = kw.get("scheme", "standard")
    if path == "leapfrog":
        leapfrog.solve(p, device="cpu")
    elif path == "compensated":
        leapfrog.solve_compensated(p, device="cpu")
    elif path == "sharded":
        sharded.solve_sharded(p, mesh, ["cpu"] * 4)
    elif path == "sharded_kfused":
        sharded_kfused.solve_sharded_kfused(p, k=k, mesh_shape=mesh,
                                            devices=["cpu"] * 4)
    elif path == "kfused":
        kfused.solve_kfused(p, k=k, device="cpu")
    elif path == "kfused_comp":
        kfused_comp.solve_kfused_comp(p, k=k, device="cpu")
    else:
        kfused_comp.solve_kfused_comp_sharded(p, k=k, mesh_shape=mesh,
                                              devices=["cpu"] * 2)
    assert solves.value(path=path) == before + 1
    # The roofline model exists for every path (one modeled-GB/s sample).
    assert gbps.count(path=path) == observed + 1
    err = reg.gauge("wavetpu_solve_max_abs_err", "",
                    ("path", "scheme", "dtype")).value(
                        path=path, scheme=scheme, dtype="f32")
    assert 0 < err < 0.1


def test_cli_error_exit_still_stops_telemetry(tmp_path, monkeypatch):
    """A crash inside the run closes the cli.solve span, writes the final
    heartbeat and unbinds the tracer."""
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(leapfrog, "solve", boom)
    tel = tmp_path / "tel"
    with pytest.raises(RuntimeError, match="boom"):
        cli.main(["8", "1", "1", "1", "1", "1", "3", "--platform", "cpu",
                  "--out-dir", str(tmp_path), "--telemetry-dir", str(tel)])
    assert not tracing.enabled()
    recs = [json.loads(line) for line in open(tel / "trace.jsonl")]
    assert recs[-1]["kind"] == "cli.solve"
    assert recs[-1]["attrs"]["aborted"] is True
    assert (tel / "heartbeat.jsonl").exists()
    assert (tel / "metrics.prom").exists()


def test_cli_solve_span_carries_the_roofline_gauges(monkeypatch):
    """The cli.solve span reads back the gauges record_solve stamped under
    the run's path (one computation), and nothing when none was."""
    reg = registry.MetricsRegistry()
    monkeypatch.setattr(registry, "get_registry", lambda: reg)
    assert cli._roofline_attrs("sharded") == {}
    reg.gauge("wavetpu_solve_model_gbps", "x", ("path",)).set(
        576.018, path="kfused_comp")
    reg.gauge("wavetpu_solve_roofline_fraction", "x", ("path",)).set(
        0.1719, path="kfused_comp")
    assert cli._roofline_attrs("kfused_comp") == {
        "model_gbps": 576.018, "roofline_fraction": 0.1719}
    assert cli._perf_path("sharded", "compensated", 4) == \
        "kfused_comp_sharded"
    assert cli._perf_path("single", "standard", 1) == "leapfrog"
