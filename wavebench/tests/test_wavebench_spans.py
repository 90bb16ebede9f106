"""The reader of the program's spans (wavebench/spans.py), on synthetic
event lists, and on a cell's window profiled on the CPU at a tiny size."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wavebench import spans, spec
from wavebench.generators import solve as gen

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """The part of a kineto event the reader calls."""

    def __init__(self, name, s, e, dev=CPU, corr=0, ua=False):
        self._name, self._s, self._e = name, s, e
        self._dev, self._corr, self._ua = dev, corr, ua

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._ua


def _ann(name, s, e):
    return Ev(name, s, e, ua=True)


def _kernel(corr, s, e, name="void reduce_kernel<512>(...)"):
    return Ev(name, s, e, dev=CUDA, corr=corr)


def test_a_kernel_belongs_to_the_annotation_its_launch_started_in():
    events = [
        _ann("wb.window", 0, 10_000),
        _ann("verify.errors", 100, 200),
        # Launched inside, run after the annotation has ended: counts.
        Ev("cudaLaunchKernel", 150, 160, corr=5),
        _kernel(5, 300, 340),
        # A CPU op shares the number 6 with the next launch (CPU op and
        # runtime ids are separate spaces): only the runtime call counts.
        Ev("aten::mul", 120, 130, corr=6),
        Ev("cudaLaunchKernel", 250, 255, corr=6),
        _kernel(6, 400, 500),
        # No launch in the trace: belongs to nothing.
        _kernel(7, 150, 190),
        # Copies are device work, not kernels.
        Ev("cudaMemcpyAsync", 170, 175, corr=8),
        Ev("Memcpy DtoD (Device -> Device)", 600, 700, dev=CUDA, corr=8),
        # The annotation's mirror on the device timeline is not work.
        Ev("verify.errors", 300, 340, dev=CUDA, ua=True),
    ]
    got = spans.summary(events)["verify.errors"]
    assert got["count"] == 1
    assert got["device_s"] == pytest.approx(40e-9)
    assert got["host_s"] == pytest.approx(100e-9)


def test_idle_time_is_the_window_gaps_inside_solver_solve():
    events = [
        _ann("wb.window", 0, 1000),
        _ann("solver.solve", 50, 600),
        _ann("solver.solve", 650, 1000),
        _kernel(1, 100, 300),
        _kernel(2, 500, 900),
        # A mirrored annotation covering the gaps must not fill them.
        Ev("solver.solve", 0, 1000, dev=CUDA, ua=True),
    ]
    got = spans.summary(events)["solver.solve"]
    # Gaps [0,100], [300,500], [900,1000] inside [50,600] + [650,1000].
    assert got["idle_s"] == pytest.approx(350e-9)
    rec = {"spans": spans.summary(events), "timesteps": 10}
    assert spans.solver_idle_ms_per_solve(rec) == pytest.approx(
        1e3 * 350e-9 / 2)


def test_idle_gaps_cover_what_no_device_interval_covers():
    assert spans.idle_gaps([(10, 20), (15, 30), (50, 60)], 0, 100) == [
        (0, 10), (30, 50), (60, 100)]
    assert spans.idle_gaps([(-5, 200)], 0, 100) == []
    assert spans.idle_gaps([], 0, 100) == [(0, 100)]


def test_readers_of_a_summary():
    events = [
        _ann("wb.window", 0, 10_000),
        _ann("solver.solve", 10, 5000),
        _ann("solver.solve", 5010, 9000),
        _ann("obs.record_solve", 4000, 4030),
        _ann("obs.record_solve", 8000, 8010),
        _ann("verify.errors", 100, 200),
        Ev("cudaLaunchKernel", 150, 151, corr=1),
        _kernel(1, 160, 260),
        # Before the window: not the window's.
        _ann("obs.record_solve", -100, -10),
    ]
    rec = {"spans": spans.summary(events), "timesteps": 4}
    assert rec["spans"]["obs.record_solve"]["count"] == 2
    assert spans.obs_record_ms_per_solve(rec) == pytest.approx(
        1e3 * 40e-9 / 2)
    assert spans.verify_device_ms_per_layer(rec) == pytest.approx(
        1e3 * 100e-9 / (2 * 4))


@pytest.mark.parametrize("rec", [
    {"solves": 3, "timesteps": 10, "init_seconds": [0.1]},
    {"solves": 3, "timesteps": 10, "spans": None},
    {"solves": 3, "timesteps": 10, "spans": {}},
], ids=["untraced", "no-window", "no-program-spans"])
def test_the_readers_find_nothing_in_a_record_without_spans(rec):
    for read in spans.READERS.values():
        assert read(rec) is None


def test_no_window_no_summary():
    assert spans.summary([_ann("solver.solve", 0, 10)]) is None


def test_a_cells_window_on_the_cpu_holds_the_solver_spans():
    """The default cell's generator at N=16, 20 steps, profiled on the CPU:
    one solver.solve and one obs.record_solve a solve of the window, and
    verify.errors once a layer (layer 1 and each layer marched)."""
    cell = spec.workload(spec.benchmark(), "n512_default")
    cfg = dict(spec.config(cell["config"]), N=16, timesteps=20)
    mix = spec.traffic(cell["traffic"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = gen.run(cfg, mix, seed=2 ** 31 + 5, seconds=0.3, trace=False,
                      device="cpu", t0=time.perf_counter())
    got = spans.summary(prof.profiler.kineto_results.events())
    solves = out["records"]["solves"]
    assert solves > 0
    assert got["solver.solve"]["count"] == solves
    assert got["obs.record_solve"]["count"] == solves
    assert got["verify.errors"]["count"] == solves * 20
    for kind in ("solver.init", "solver.bootstrap", "solver.march",
                 "solver.readback"):
        assert got[kind]["count"] == solves
