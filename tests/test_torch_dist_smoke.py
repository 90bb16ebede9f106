"""chip_smoke.py's phase 13 (`--distributed`) rehearsed on the CPU at
N=16, 9 steps: the same code path as on the card - the port's CLI as 2
and 4 rank processes over gloo, each run's errors held bit-equal to the
in-process solve of the same mesh, rank 1 silent, a stop + resume across
processes, the last run on one rank - with the kernels' plain versions,
so without launch counts (the CPU launches no CUDA kernel) and over gloo
where the card runs NCCL.  The phase-3 references are computed here."""

import chip_smoke as cs
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.solver import kfused_comp, leapfrog


def test_phase_distributed_on_cpu(monkeypatch):
    monkeypatch.setattr(cs, "CLI_EXTRA", ["--platform", "cpu"])
    monkeypatch.setattr(cs, "DIST_N", 16)
    monkeypatch.setattr(cs, "STEPS", 9)
    p = Problem(N=16, timesteps=9)
    sides = {
        "default": {"max_abs_error": float(
            leapfrog.solve(p, device="cpu").abs_errors.max())},
        "flagship": {"max_abs_error": float(kfused_comp.solve_kfused_comp(
            p, k=4, device="cpu").abs_errors.max())},
    }
    out = cs.phase_distributed("cpu", sides, device="cpu")
    assert set(out) == {"dist_211", "dist_flagship_211", "dist_kfused_221",
                        "dist_flagship_221", "dist_stop", "dist_resume",
                        "dist_211_nccl_1rank"}
    for label, run in out.items():
        assert run["backend"].startswith("gloo"), label
        assert run["ranks"] == (4 if "221" in label else
                                1 if "1rank" in label else 2)
    assert out["dist_211"]["cross_rank"]["exchanges"] == 9
    assert out["dist_211_nccl_1rank"]["cross_rank"]["exchanges"] == 0
