"""The command and its check, driven on the CPU at a tiny size.

`run.measure` is the whole of a run except the look for a card: the cells'
own mixes and limits, with the configurations cut to N=16 and 20 steps and
the program's kernels running their plain versions on the CPU.  A sound
run comes out correct; the control and each fault planted underneath the
timed path come out not correct.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from wavebench import judge, run, spec

REPO = str(spec.ROOT)
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 77


def _tiny(cell):
    w = spec.workload(BENCH, cell)
    return dict(spec.config(w["config"]), N=16, timesteps=20)


def _measure(cell, trace=False, seconds=0.5):
    w = spec.workload(BENCH, cell)
    return run.measure(BENCH, w, seed=SEED, seconds=seconds, trace=trace,
                       device="cpu", t0=time.perf_counter(), cfg=_tiny(cell))


def test_without_a_card_the_command_exits_nonzero_and_prints_nothing():
    p = subprocess.run(
        [sys.executable, "-m", "wavebench.run", "--workload",
         "n512_flagship", "--seed", str(SEED), "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 2
    assert p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_nothing_loads_jax_or_wavetpu_and_the_yardstick_loads_no_program():
    code = (
        "import sys, json\n"
        "import wavebench.reference.wave, wavebench.loadgen.phases\n"
        "import wavebench.judge, wavebench.roofline, wavebench.stats\n"
        "yard = sorted({m.split('.')[0] for m in sys.modules})\n"
        "import wavebench.run, wavebench.generators.solve\n"
        "import wavebench.calibrate, wavebench.trace\n"
        "import wavetpu_torch.solver.kfused_comp\n"
        "allm = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([yard, allm]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    yard, allm = json.loads(p.stdout.strip().splitlines()[-1])
    assert not {"jax", "jaxlib", "flax", "wavetpu"} & set(allm)
    assert "wavetpu_torch" in allm
    assert "wavetpu_torch" not in yard


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = _measure(cell)
    assert line["correct"], line["checked"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checked"
    e2e, _ = spec.cell_metrics(BENCH, cell)
    assert set(line["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(cell):
    line = _measure(cell, trace=True)
    assert line["correct"], line["checked"]
    _, layer = spec.cell_metrics(BENCH, cell)
    cpu_readable = {"solver.init_ms_per_solve"}
    want = {m["name"] for m in layer} & cpu_readable
    assert want <= set(line["metrics"])
    assert line["device"]["window_s"] > 0 and "breakdown" in line


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    w = spec.workload(BENCH, cell)
    mix = spec.traffic(w["traffic"])
    numbers = spec.generator(mix["generator"]).control(
        _tiny(cell), mix, seed=SEED, device="cpu")
    ok, rows = judge.verdict(numbers, spec.limits(cell))
    assert not ok, rows


def _keep_state(orig, n_state):
    def broken(*a, **k):
        out = orig(*a, **k)
        return tuple(a[:n_state]) + tuple(out[n_state:])
    return broken


def _standing_step(orig):
    def make(*a, **k):
        return lambda u_prev, u, problem: u
    return make


def _rows_times_100(orig):
    def broken(*a, **k):
        abs_e, rel_e = orig(*a, **k)
        return abs_e * 100, rel_e * 100
    return broken


def _lane_fn_times_100(orig):
    def make(*a, **k):
        errors = orig(*a, **k)
        return lambda u, ct: tuple(e * 100 for e in errors(u, ct))
    return make


def _state_nudged(orig):
    def broken(*a, **k):
        res = orig(*a, **k)
        res.u_cur = res.u_cur.clone()
        res.u_cur[5, 5, 5] += 0.5
        return res
    return broken


K = "wavetpu_torch.kernels.stencil_cuda"
FAULTS = {
    "n512_flagship": [
        ("state unchanged", K, "fused_kstep_comp", lambda o: _keep_state(o, 3)),
        ("rows altered", "wavetpu_torch.solver.kfused", "_block_errors",
         _rows_times_100),
        ("state altered", "wavetpu_torch.solver.kfused_comp",
         "solve_kfused_comp", _state_nudged),
    ],
    "n512_default": [
        ("state unchanged", K, "make_step_fn", _standing_step),
        ("errors altered", "wavetpu_torch.solver.leapfrog", "lane_error_fn",
         _lane_fn_times_100),
        ("state altered", "wavetpu_torch.solver.leapfrog", "solve",
         _state_nudged),
    ],
    "n512_kfused": [
        ("state unchanged", K, "fused_kstep", lambda o: _keep_state(o, 2)),
        ("rows altered", "wavetpu_torch.solver.kfused", "_block_errors",
         _rows_times_100),
        ("state altered", "wavetpu_torch.solver.kfused", "solve_kfused",
         _state_nudged),
    ],
}


@pytest.mark.parametrize("cell,fault", [
    (c, i) for c in CELLS for i in range(len(FAULTS[c]))])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    what, module, attr, make = FAULTS[cell][fault]
    owner = importlib.import_module(module)
    if "." in attr:
        cls, attr = attr.split(".")
        owner = getattr(owner, cls)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    line = _measure(cell)
    assert not line["correct"], (what, line["checked"])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "-m", "wavebench.run", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert np.isfinite(list(line["metrics"].values())[0]["value"])

