"""The serving cell, serve_flagship_b8, driven on the CPU at a tiny size.

`run.measure` runs the cell's own mix and limits through
generators/serve.py: the replica on a thread of this process, the
closed-loop clients in their own process, the configuration cut to N=32
and 200 steps (T=1) and the program's kernels running their plain
versions on the CPU (at N=16 the lower-precision control drifts too
little to pass the limits set at the cell's N=256 on the card).  A sound
run comes out correct; both controls and a lane rotation planted under
the engine do not; a replica that ignores `probes` ends the run with a
result line well inside a request's deadline.
"""

import json
import subprocess
import sys
import time

import pytest

from wavebench import judge, run, spec
from wavebench.generators import serve

REPO = str(spec.ROOT)
BENCH = spec.benchmark()
CELL = "serve_flagship_b8"
SEED = 2 ** 31 + 77


def _tiny():
    w = spec.workload(BENCH, CELL)
    return dict(spec.config(w["config"]), N=32, timesteps=200)


def _measure(trace=False, seconds=1.0):
    return run.measure(BENCH, spec.workload(BENCH, CELL), seed=SEED,
                       seconds=seconds, trace=trace, device="cpu",
                       t0=time.perf_counter(), cfg=_tiny())


def test_the_clients_load_neither_torch_nor_the_program():
    code = ("import sys, json\n"
            "import wavebench.loadgen.closed_loop\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not {"torch", "numpy", "wavetpu_torch", "wavetpu",
                "jax"} & loaded


def test_a_sound_run_is_correct():
    line = _measure()
    assert line["correct"], (line["checked"], line.get("error"))
    assert line["attempted"] > 8 and line["failed"] == 0
    assert set(line["metrics"]) == {"gcells_per_s", "setup_s"}
    assert list(line)[-1] == "checked"


def test_a_traced_run_reads_the_serving_metrics():
    line = _measure(trace=True)
    assert line["correct"], line["checked"]
    got = line["metrics"]
    for name in ("serve.host_ms_per_request", "serve.lanes_per_batch",
                 "solver.init_ms_per_solve"):
        assert got[name]["value"] > 0, name
    assert 1.0 <= got["serve.lanes_per_batch"]["value"] <= 8.0
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def test_the_controls_are_not_correct():
    mix = spec.traffic(spec.workload(BENCH, CELL)["traffic"])
    numbers = serve.control(_tiny(), mix, seed=SEED, device="cpu")
    limits = spec.limits(CELL)
    for which in ("rotated.", "lower."):
        ok, rows = judge.verdict(
            {k[len(which):]: v for k, v in numbers.items()
             if k.startswith(which)}, limits)
        assert not ok, (which, rows)
    ok, rows = judge.verdict(numbers, limits)
    assert not ok, rows


def test_a_lane_rotation_under_the_engine_is_not_correct(monkeypatch):
    from wavetpu_torch.serve import api

    build = api.build_server

    def rotated(*a, **k):
        httpd, state = build(*a, **k)
        serve.rotate_lanes(state.engine)
        return httpd, state

    monkeypatch.setattr(api, "build_server", rotated)
    line = _measure()
    assert not line["correct"], line["checked"]


def test_a_replica_that_ignores_probes_ends_with_a_result_line(
        monkeypatch):
    from wavetpu_torch.serve import api

    monkeypatch.setattr(api, "parse_probes", lambda raw, n: None)
    t = time.perf_counter()
    line = _measure(seconds=30.0)
    took = time.perf_counter() - t
    mix = spec.traffic(spec.workload(BENCH, CELL)["traffic"])
    assert took < mix["request_deadline_s"] / 4
    assert not line["correct"]
    assert line["failed"] > 0 and "final_probes" in line["error"]
    assert "gcells_per_s" not in line["metrics"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs on the card")


@pytest.mark.gpu
def test_the_cell_runs_correct_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "-m", "wavebench.run", "--workload", CELL,
         "--seed", str(SEED), "--seconds", "5", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
