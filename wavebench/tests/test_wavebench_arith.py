"""The yardstick's arithmetic: seeded traffic, the window's rate, which
cells report a metric, the frozen roofline bounds, and the plain
reference."""

import math

import numpy as np
import pytest
import torch

from wavebench import roofline, spec, stats
from wavebench.loadgen import phases as seeded
from wavebench.reference import wave

BIG_SEED = 2 ** 31 + 12345


def _take(seed, n, purpose="phase"):
    it = seeded.phases(seed, purpose)
    return [next(it) for _ in range(n)]


def test_phases_repeat_for_a_seed_and_differ_between_seeds():
    assert _take(BIG_SEED, 50) == _take(BIG_SEED, 50)
    assert _take(BIG_SEED, 50) != _take(BIG_SEED + 1, 50)
    assert _take(BIG_SEED, 5) != _take(BIG_SEED, 5, "warmup")
    assert all(0.0 <= p < 2 * math.pi for p in _take(BIG_SEED, 1000))
    assert len(set(_take(BIG_SEED, 1000))) == 1000


def test_rate_is_all_work_over_all_time():
    # 3 solves of 1000 layers of (512+1)^3 cells in 3.6 s of window.
    r = stats.rate_gcells(513 ** 3, 1000, 3, 3.6)
    assert r == pytest.approx(513 ** 3 * 1000 * 3 / 3.6 / 1e9)


def test_a_metric_is_reported_by_one_rule():
    bench = {"end_to_end": [{"name": "rate"}, {"name": "setup_s"},
                            {"name": "served", "workloads": ["b"]}],
             "per_layer": [{"name": "any", "moves": "rate"},
                           {"name": "only_a", "moves": "rate",
                            "workloads": ["a"]},
                           {"name": "lane", "moves": "served"}]}
    names = {c: [[m["name"] for m in ms]
                 for ms in spec.cell_metrics(bench, c)] for c in "ab"}
    assert names["a"] == [["rate", "setup_s"], ["any", "only_a"]]
    assert names["b"] == [["rate", "setup_s", "served"], ["any", "lane"]]


@pytest.mark.parametrize("kernel,ms", [("K1", 0.4808), ("K3", 0.6410),
                                       ("K4", 0.8013)])
def test_frozen_bounds_at_n512(kernel, ms):
    k = 1 if kernel == "K1" else 4
    bound = roofline.bound_seconds(kernel, 512 ** 3, 1, k)
    assert bound * 1e3 == pytest.approx(ms, abs=5e-5)


def test_launch_counts_of_the_flagship():
    assert roofline.kstep_launches(999, 4, True) == 252
    assert roofline.kstep_launches(999, 4, False) == 249
    assert roofline.kstep_launches(99, 4, True) == 27


@pytest.mark.parametrize("scheme", ["standard", "compensated"])
@pytest.mark.parametrize("phase", [1.25, wave.TWO_PI])
def test_reference_meets_the_closed_form(scheme, phase):
    errs = []
    for n in (8, 16):
        w = wave.Wave(N=n, Lx=1.0, Ly=1.0, Lz=1.0, T=0.5, timesteps=4 * n)
        out = wave.march(w, phase, scheme, "cpu")
        assert len(out["abs"]) == w.timesteps + 1 and out["abs"][0] == 0
        errs.append(out["abs"].max())
    # Second order: halving h and tau quarters the error.
    assert errs[1] < 0.3 * errs[0] and errs[1] < 2e-3


def test_reference_forms_agree_in_float64():
    w = wave.Wave(N=12, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=30)
    a = wave.march(w, 0.7, "standard", "cpu")
    b = wave.march(w, 0.7, "compensated", "cpu")
    assert (a["u"] - b["u"]).abs().max() < 1e-12
    assert (a["u_prev"] - b["u_prev"]).abs().max() < 1e-12
    assert np.abs(a["abs"] - b["abs"]).max() < 1e-12


def test_reference_in_bfloat16_departs():
    w = wave.Wave(N=12, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=30)
    hi = wave.march(w, 0.7, "compensated", "cpu")
    lo = wave.march(w, 0.7, "compensated", "cpu", dtype=torch.bfloat16)
    assert (lo["u"] - hi["u"]).abs().max() > 1e-4

