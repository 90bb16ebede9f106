"""The solvers' phase spans and the error pass's annotation (solver/phases.py,
obs/tracing.py): what they cost untraced, what a profiler sees without a
JSONL tracer, and what a tracer writes."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.obs import tracing
from wavetpu_torch.solver import (
    kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
)

N, T, K = 8, 11, 4
CHILDREN = ("solver.init", "solver.bootstrap", "solver.march",
            "solver.readback", "obs.record_solve")

# (entry, verify.errors annotations a solve opens): layer 1, then one a
# layer on the 1-step path and one a k-step launch on the k-fused paths
# (10 layers after layer 1 at k=4: two blocks and a tail of two layers,
# 1-step on the standard path, k=1 launches on the compensated one).
ENTRIES = {
    "leapfrog": (lambda p: leapfrog.solve(p, device="cpu"), T),
    "kfused": (lambda p: kfused.solve_kfused(p, k=K, device="cpu"),
               1 + 2 + 2),
    "kfused_comp": (lambda p: kfused_comp.solve_kfused_comp(
        p, k=K, device="cpu"), 1 + 2 + 2),
}


@pytest.fixture(autouse=True)
def _untraced():
    tracing.disable()
    yield
    tracing.disable()


class _Counting:
    """A record_function that counts its creations."""

    made = 0

    def __init__(self, real):
        self.real = real

    def __call__(self, *a, **k):
        _Counting.made += 1
        return self.real(*a, **k)


@pytest.fixture
def counting(monkeypatch):
    _Counting.made = 0
    for mod in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(mod, "record_function",
                            _Counting(mod.record_function))
    return _Counting


def _annotations(prof):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()
            and e.device_type() == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("path", list(ENTRIES))
def test_untraced_and_unprofiled_a_solve_opens_no_record_function(
        path, counting, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    solve, _ = ENTRIES[path]
    res = solve(Problem(N=N, timesteps=T))
    assert counting.made == 0
    assert res.init_seconds > 0 and res.solve_seconds > 0
    with tracing.span("probe.span"), tracing.annotate("probe.annotate"):
        pass
    assert counting.made == 0
    assert list(tmp_path.iterdir()) == []
    # The same solve under a profiler does create them: the count above
    # watches the right place.
    with profile(activities=[ProfilerActivity.CPU]):
        solve(Problem(N=N, timesteps=T))
    assert counting.made > 0


@pytest.mark.parametrize("path", list(ENTRIES))
def test_a_profiler_without_a_tracer_sees_the_phases_and_the_error_pass(
        path):
    solve, n_errors = ENTRIES[path]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve(Problem(N=N, timesteps=T))
    ann = _annotations(prof)
    (root,) = [a for a in ann if a[0] == "solver.solve"]
    _, r0, r1 = root
    for kind in CHILDREN:
        (child,) = [a for a in ann if a[0] == kind]
        assert r0 <= child[1] <= child[2] <= r1, kind
    errors = [a for a in ann if a[0] == "verify.errors"]
    assert len(errors) == n_errors
    phases = [a for a in ann if a[0] in ("solver.bootstrap", "solver.march")]
    for _, s, e in errors:
        assert any(p0 <= s <= e <= p1 for _, p0, p1 in phases)


@pytest.mark.parametrize("path", list(ENTRIES))
def test_a_tracer_writes_the_phases_and_no_error_pass_records(path,
                                                              tmp_path):
    solve, _ = ENTRIES[path]
    trace = tmp_path / "trace.jsonl"
    tracing.configure(str(trace))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = solve(Problem(N=N, timesteps=T))
    finally:
        tracing.disable()
    recs = [json.loads(line) for line in open(trace)]
    assert not [r for r in recs if r["kind"] == "verify.errors"]
    (root,) = [r for r in recs if r["kind"] == "solver.solve"]
    assert root["parent_id"] is None
    assert root["attrs"] == {"path": path, "N": N, "steps": T,
                             "k": 1 if path == "leapfrog" else K}
    by_kind = {}
    for kind in CHILDREN:
        (rec,) = [r for r in recs if r["kind"] == kind]
        assert rec["parent_id"] == root["span_id"], kind
        by_kind[kind] = rec
    assert abs(res.init_seconds - by_kind["solver.init"]["dur_s"]) <= 5e-7
    # The record's wall-clock start sits on the profiler's clock.
    starts = {name: s for name, s, _ in _annotations(prof)}
    for rec in [root] + list(by_kind.values()):
        assert abs(rec["t_start_ns"] - starts[rec["kind"]]) < 2e6


def _resumes():
    """{entry: (path, k, steps, call)} of every timed entry point: the
    solves, and the resumes from a solve stopped at layer 3."""
    p = Problem(N=8, timesteps=5)
    mesh4, cpu4, cpu2 = (2, 2, 1), ["cpu"] * 4, ["cpu"] * 2

    def lf_resume():
        r = leapfrog.solve(p, stop_step=3, device="cpu")
        return leapfrog.resume(p, r.u_prev, r.u_cur, 3, device="cpu")

    def comp_resume():
        r = leapfrog.solve_compensated(p, stop_step=3, device="cpu")
        return leapfrog.resume_compensated(p, r.u_cur, r.comp_v,
                                           r.comp_carry, 3, device="cpu")

    def kf_resume():
        r = kfused.solve_kfused(p, k=2, stop_step=3, device="cpu")
        return kfused.resume_kfused(p, r.u_prev, r.u_cur, 3, k=2,
                                    device="cpu")

    def kfc_resume():
        r = kfused_comp.solve_kfused_comp(p, k=2, stop_step=3, device="cpu")
        return kfused_comp.resume_kfused_comp(p, r.u_cur, r.comp_v,
                                              r.comp_carry, 3, k=2,
                                              device="cpu")

    def kfcs_resume():
        r = kfused_comp.solve_kfused_comp_sharded(
            p, k=2, stop_step=3, mesh_shape=(2, 1, 1), devices=cpu2)
        return kfused_comp.resume_kfused_comp_sharded(
            p, r.u_cur, r.comp_v, r.comp_carry, 3, k=2, mesh_shape=(2, 1, 1),
            devices=cpu2)

    def sh_resume():
        r = sharded.solve_sharded(p, mesh4, cpu4, stop_step=3)
        return sharded.resume_sharded(p, r.u_prev, r.u_cur, 3, mesh4, cpu4)

    def skf_resume():
        r = sharded_kfused.solve_sharded_kfused(
            p, k=2, stop_step=3, mesh_shape=mesh4, devices=cpu4)
        return sharded_kfused.resume_sharded_kfused(
            p, r.u_prev, r.u_cur, 3, k=2, mesh_shape=mesh4, devices=cpu4)

    return {
        "leapfrog.solve": ("leapfrog", 1, 5,
                           lambda: leapfrog.solve(p, device="cpu")),
        "leapfrog.resume": ("leapfrog", 1, 2, lf_resume),
        "leapfrog.solve_compensated": (
            "compensated", 1, 5,
            lambda: leapfrog.solve_compensated(p, device="cpu")),
        "leapfrog.resume_compensated": ("compensated", 1, 2, comp_resume),
        "kfused.solve_kfused": (
            "kfused", 2, 5, lambda: kfused.solve_kfused(p, k=2,
                                                        device="cpu")),
        "kfused.resume_kfused": ("kfused", 2, 2, kf_resume),
        "kfused_comp.solve_kfused_comp": (
            "kfused_comp", 2, 5,
            lambda: kfused_comp.solve_kfused_comp(p, k=2, device="cpu")),
        "kfused_comp.resume_kfused_comp": ("kfused_comp", 2, 2, kfc_resume),
        "kfused_comp.solve_kfused_comp_sharded": (
            "kfused_comp_sharded", 2, 5,
            lambda: kfused_comp.solve_kfused_comp_sharded(
                p, k=2, mesh_shape=(2, 1, 1), devices=cpu2)),
        "kfused_comp.resume_kfused_comp_sharded": (
            "kfused_comp_sharded", 2, 2, kfcs_resume),
        "sharded.solve_sharded": (
            "sharded", 1, 5, lambda: sharded.solve_sharded(p, mesh4, cpu4)),
        "sharded.resume_sharded": ("sharded", 1, 2, sh_resume),
        "sharded_kfused.solve_sharded_kfused": (
            "sharded_kfused", 2, 5,
            lambda: sharded_kfused.solve_sharded_kfused(
                p, k=2, mesh_shape=mesh4, devices=cpu4)),
        "sharded_kfused.resume_sharded_kfused": (
            "sharded_kfused", 2, 2, skf_resume),
    }


@pytest.mark.parametrize("entry", list(_resumes()))
def test_every_timed_entry_point_times_its_phases_with_spans(entry,
                                                             tmp_path):
    """Each of the 14 timed entry points runs in one solver.solve span;
    its init_seconds is solver.init's duration and its solve_seconds runs
    from there to the end of solver.readback."""
    path, k, steps, call = _resumes()[entry]
    trace = tmp_path / "trace.jsonl"
    tracing.configure(str(trace))
    try:
        res = call()
    finally:
        tracing.disable()
    recs = [json.loads(line) for line in open(trace)]
    roots = [r for r in recs if r["kind"] == "solver.solve"]
    root = roots[-1]  # a resume follows the solve that made its state
    assert root["attrs"] == {"path": path, "N": 8, "steps": steps, "k": k}
    kids = {r["kind"]: r for r in recs if r["parent_id"] == root["span_id"]}
    expected = set(CHILDREN) - ({"solver.bootstrap"} if steps == 2 else set())
    assert set(kids) == expected
    init, readback = kids["solver.init"], kids["solver.readback"]
    assert abs(res.init_seconds - init["dur_s"]) <= 5e-7
    init_end = init["t_start_ns"] * 1e-9 + init["dur_s"]
    readback_end = readback["t_start_ns"] * 1e-9 + readback["dur_s"]
    assert res.solve_seconds == pytest.approx(readback_end - init_end,
                                              abs=1e-4)
    assert not [r for r in recs if r["kind"] == "verify.errors"]


def test_a_timed_span_is_its_records_duration(tmp_path):
    trace = tmp_path / "trace.jsonl"
    tracing.configure(str(trace))
    try:
        with tracing.TimedSpan("probe.timed", n=1) as s:
            torch.ones(64).sum()
    finally:
        tracing.disable()
    (rec,) = [json.loads(line) for line in open(trace)]
    assert rec["kind"] == "probe.timed" and rec["attrs"] == {"n": 1}
    assert rec["dur_s"] == round(s.seconds, 6)
    with tracing.TimedSpan("probe.untraced") as u:
        pass
    assert u.seconds >= 0 and u.t1 >= u.t0


def test_a_label_only_span_closes_its_profiler_range():
    """begin_span/end_span under a profiler with no tracer open and close
    one range, and write nothing."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        h = tracing.begin_span("probe.begin", n=3)
        torch.ones(8).sum()
        tracing.end_span(h, done=True)
    assert h is not None and "span_id" not in h
    assert [a[0] for a in _annotations(prof)] == ["probe.begin"]
    assert tracing.begin_span("probe.off") is None
