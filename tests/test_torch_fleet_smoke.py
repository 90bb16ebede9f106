"""chip_smoke.py's phase 12 (the fleet tier before replica processes)
rehearsed on the CPU at a small size: the same code path as on the card -
two `warmup` processes, replicas A and B and the router as processes, the
flagship bodies landing on A, a `fleet roll` handing a chunked march from A
to the spawned C, a loadgen replay through the router, the B=8 rows with
fresh and keep-alive connections, B's recording replayed - with the
kernels' plain versions, so without launch counts (the CPU launches no
CUDA kernel).  The references are solve_ensemble lanes computed here.
A's hold before each chunk after the first (15 s) leaves the successor
that long to start; nothing else waits on time.
"""

import numpy as np

import chip_smoke as cs
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb


def test_phase_fleet_on_cpu(monkeypatch):
    monkeypatch.setattr(cs, "DEV", "cpu")
    monkeypatch.setattr(cs, "CLI_EXTRA", ["--platform", "cpu"])
    p = Problem(N=16, timesteps=41)
    bodies = [dict(b, N=16, timesteps=41, kernel="pallas",
                   **({"steps": 21} if "steps" in b else {}))
              for b in cs.SERVE_RUNS["serve_flagship"][0]]
    ens = eb.solve_ensemble(p, [cs.serve_lane(b) for b in bodies],
                            scheme="compensated", path="kfused", k=4,
                            device="cpu")
    refs = [(r.abs_errors, r.rel_errors) for r in ens.results]
    std = eb.solve_ensemble(p, [eb.LaneSpec()], path="roll",
                            device="cpu").results[0]
    cfg = dict(n=16, steps=41, serve_n=8, short_steps=10,
               chunk_threshold=20, chunk_steps=8, hold_s=15, qps=4.0,
               duration=3, count=False, body_extra={"kernel": "pallas"},
               flagship_bodies=bodies, flagship_refs=refs,
               flagship_max_err=float(np.max(refs[0][0])),
               default_phase3=(std.abs_errors, std.rel_errors))
    out = cs.phase_fleet("cpu", {}, {}, cfg)
    assert out["affinity"]["stats"]["hits"] == 3
    assert out["roll"]["resumed_from"] >= 1
    assert out["load"]["requests"] >= 1
    assert out["load"]["server"]["cold_compiles"] == 0
    assert sum(out["load"]["per_member"].values()) >= \
        out["load"]["requests"]
    assert set(out["rows_b8"]) == {"pallas", "flagship"}
    assert out["recorded"]["records"] >= 1
    assert out["nvcc_runs"] == {"A": 0, "B": 0, "C": 0}
