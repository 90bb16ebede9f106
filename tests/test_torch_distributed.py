"""The port's `--distributed` (comm/dist.py) on the CPU: the real
`python -m wavetpu_torch` in 2 or 4 OS processes over gloo, class by class
as wavetpu's tests/test_distributed.py runs its own CLI.

Each rank has its own --out-dir: a write by a rank other than 0 would show
as a file there, and only rank 0 may print the Courant line and the
report line.  Each run's error vectors are held two ways:

 * bit for bit against the port's in-process sharded solve of the same
   mesh on `["cpu"] * S` (the same kernels in the same order; only the
   transport differs);
 * against wavetpu's in-process sharded solve (interpret mode on the 8
   virtual CPU devices of tests/conftest.py) at the tolerances of
   tests/test_torch_sharded.py (f32 1-step: 1e-5),
   tests/test_torch_sharded_kfused.py (rtol 1e-5, atol 1e-7) and
   tests/test_torch_kfused_comp_sharded.py (the flagship: atol 2e-6).

Every `communicate()` carries its own timeout: a rank left waiting in a
receive is killed, never hangs the suite.  The layers under the CLI (the
exchange, the gathered errors, the placement) are held in
tests/test_torch_dist_exchange.py.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from wavetpu.core.problem import Problem as JProblem
from wavetpu.solver import kfused_comp as jkc
from wavetpu.solver import sharded as jsharded
from wavetpu.solver import sharded_kfused as jsk
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.solver import kfused_comp, sharded, sharded_kfused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, port: int, extra=None) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("WAVETPU_FAULT", None)
    env.update(PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE=str(world),
               RANK=str(rank), LOCAL_RANK=str(rank))
    env.update(extra or {})
    return env


def _communicate(procs):
    """Every process's (exit code, output); all are killed if one outlasts
    its timeout."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], outs


def run_cli(tmp_path, world, argv, name="run", extra_env=None):
    """`python -m wavetpu_torch ARGV --distributed --platform cpu` on
    `world` ranks, rank r writing to tmp_path/name/r: (exit codes,
    outputs, out dirs)."""
    port = _free_port()
    dirs = [str(tmp_path / name / str(r)) for r in range(world)]
    procs = []
    for r, d in enumerate(dirs):
        os.makedirs(d)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "wavetpu_torch", *argv, "--distributed",
             "--platform", "cpu", "--out-dir", d],
            env=_env(r, world, port, extra_env), cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    rcs, outs = _communicate(procs)
    return rcs, outs, dirs


def sidecar(out_dir, n, n_procs):
    with open(os.path.join(out_dir,
                           f"output_N{n}_Np{n_procs}_CUDA.json")) as f:
        return json.load(f)


def check_rank0_gating(rcs, outs, dirs, n, n_procs, code=0):
    """Every rank exits `code`; rank 0 alone writes its report and
    sidecar and prints the Courant and report lines."""
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == code, f"rank {r}: {out}"
    assert sorted(os.listdir(dirs[0])) == [
        f"output_N{n}_Np{n_procs}_CUDA.json",
        f"output_N{n}_Np{n_procs}_CUDA.txt"]
    assert "C = " in outs[0] and "report:" in outs[0]
    assert "distributed: gloo" in outs[0]
    for d, out in zip(dirs[1:], outs[1:]):
        assert os.listdir(d) == []
        assert "C = " not in out and "report:" not in out
    side = sidecar(dirs[0], n, n_procs)
    assert side["run_config"]["distributed"] is True
    assert side["n_procs"] == n_procs
    return side


def same_bits(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


CPU = "cpu"


class TestOneStep:
    """K6 on mesh 2,1,1 across two processes (wavetpu's
    test_two_process_cli_writes_one_report), and an uneven N."""

    @pytest.mark.parametrize("n", [16, 15])
    def test_two_process_cli_writes_one_report(self, tmp_path, n):
        rcs, outs, dirs = run_cli(
            tmp_path, 2, [str(n), "1", "1", "1", "1", "1", "5", "--mesh",
                          "2,1,1"])
        side = check_rank0_gating(rcs, outs, dirs, n, 2)
        local = sharded.solve_sharded(Problem(N=n, timesteps=5), (2, 1, 1),
                                      devices=[CPU] * 2)
        same_bits(side["abs_errors"], local.abs_errors)
        same_bits(side["rel_errors"], local.rel_errors)
        ref = jsharded.solve_sharded(JProblem(N=n, timesteps=5),
                                     mesh_shape=(2, 1, 1))
        assert np.max(np.abs(np.asarray(side["abs_errors"])
                             - ref.abs_errors)) <= 1e-5


class TestKFused:
    """K8 on mesh 2,1,1 (wavetpu's test_two_process_kfused) and K9, the
    pad-and-mask march, where k does not divide the shard."""

    @pytest.mark.parametrize("n,k", [(16, 2), (13, 2)],
                             ids=["even-K8", "uneven-K9"])
    def test_two_process_kfused(self, tmp_path, n, k):
        rcs, outs, dirs = run_cli(
            tmp_path, 2, [str(n), "1", "1", "1", "1", "1", "5", "--mesh",
                          "2,1,1", "--fuse-steps", str(k)])
        side = check_rank0_gating(rcs, outs, dirs, n, 2)
        assert "fuse-steps: 2" in outs[0]
        local = sharded_kfused.solve_sharded_kfused(
            Problem(N=n, timesteps=5), k=k, mesh_shape=(2, 1, 1),
            devices=[CPU] * 2)
        same_bits(side["abs_errors"], local.abs_errors)
        ref = jsk.solve_sharded_kfused(JProblem(N=n, timesteps=5),
                                       n_shards=2, k=k, interpret=True)
        np.testing.assert_allclose(side["abs_errors"], ref.abs_errors,
                                   rtol=1e-5, atol=1e-7)


class TestFlagship:
    """The distributed flagship, K11 on mesh 2,1,1 (wavetpu's
    test_two_process_compensated_kfused)."""

    def test_two_process_compensated_kfused(self, tmp_path):
        rcs, outs, dirs = run_cli(
            tmp_path, 2, ["16", "1", "1", "1", "1", "1", "5", "--mesh",
                          "2,1,1", "--scheme", "compensated",
                          "--fuse-steps", "2"])
        side = check_rank0_gating(rcs, outs, dirs, 16, 2)
        assert "scheme: compensated" in outs[0]
        local = kfused_comp.solve_kfused_comp_sharded(
            Problem(N=16, timesteps=5), k=2, mesh_shape=(2, 1, 1),
            devices=[CPU] * 2)
        same_bits(side["abs_errors"], local.abs_errors)
        ref = jkc.solve_kfused_comp_sharded(JProblem(N=16, timesteps=5),
                                            n_shards=2, k=2, interpret=True)
        np.testing.assert_allclose(side["abs_errors"], ref.abs_errors,
                                   rtol=0, atol=2e-6)


class TestFourProcesses:
    """Mesh 2,2,1 on four ranks: y-sharded k-fusion (K10) and the
    y-sharded flagship (K12)."""

    @pytest.mark.parametrize("scheme", ["standard", "compensated"],
                             ids=["K10", "K12"])
    def test_four_process_221(self, tmp_path, scheme):
        rcs, outs, dirs = run_cli(
            tmp_path, 4, ["16", "1", "1", "1", "1", "1", "5", "--mesh",
                          "2,2,1", "--fuse-steps", "2", "--scheme", scheme])
        side = check_rank0_gating(rcs, outs, dirs, 16, 4)
        p, jp = Problem(N=16, timesteps=5), JProblem(N=16, timesteps=5)
        if scheme == "standard":
            local = sharded_kfused.solve_sharded_kfused(
                p, k=2, mesh_shape=(2, 2, 1), devices=[CPU] * 4)
            ref = jsk.solve_sharded_kfused(jp, mesh_shape=(2, 2, 1), k=2,
                                           interpret=True)
            np.testing.assert_allclose(side["abs_errors"], ref.abs_errors,
                                       rtol=1e-5, atol=1e-7)
        else:
            local = kfused_comp.solve_kfused_comp_sharded(
                p, k=2, mesh_shape=(2, 2, 1), devices=[CPU] * 4)
            ref = jkc.solve_kfused_comp_sharded(jp, mesh_shape=(2, 2, 1),
                                                k=2, interpret=True)
            np.testing.assert_allclose(side["abs_errors"], ref.abs_errors,
                                       rtol=0, atol=2e-6)
        same_bits(side["abs_errors"], local.abs_errors)


class TestMeasurement:
    """`--overlap` and `--phase-timing` across ranks: the overlap mode
    keeps the serial march's bits, the probes run on every rank (their
    exchanges are collective) and rank 0 reports its own."""

    def test_overlap_is_bitwise_the_serial_march(self, tmp_path):
        rcs, outs, dirs = run_cli(
            tmp_path, 4, ["16", "1", "1", "1", "1", "1", "5", "--mesh",
                          "2,2,1", "--overlap"])
        side = check_rank0_gating(rcs, outs, dirs, 16, 4)
        local = sharded.solve_sharded(Problem(N=16, timesteps=5), (2, 2, 1),
                                      devices=[CPU] * 4)
        same_bits(side["abs_errors"], local.abs_errors)

    @pytest.mark.parametrize("extra", [
        [], ["--scheme", "compensated", "--fuse-steps", "2"],
    ], ids=["1step", "flagship"])
    def test_phase_timing_reports_on_rank_0(self, tmp_path, extra):
        rcs, outs, dirs = run_cli(
            tmp_path, 2, ["16", "1", "1", "1", "1", "1", "6", "--mesh",
                          "2,1,1", "--phase-timing"] + extra)
        side = check_rank0_gating(rcs, outs, dirs, 16, 2)
        assert side["exchange_seconds"] >= 0
        assert side["loop_seconds"] > 0
        assert "total ICI exchange time" in outs[0]
        assert "total ICI exchange time" not in outs[1]


class TestCheckpoints:
    """`--stop-step`/`--save-state` then `--resume` across processes, and
    a supervised run preempted on every rank."""

    def test_save_then_resume_is_bitwise(self, tmp_path):
        args = ["16", "1", "1", "1", "1", "1", "6", "--mesh", "2,1,1"]
        ck = str(tmp_path / "ck")
        rcs, outs, _ = run_cli(tmp_path, 2, args + [
            "--stop-step", "3", "--save-state", ck], name="stop")
        assert rcs == [0, 0], outs
        assert "checkpoint:" in outs[0] and "checkpoint:" not in outs[1]
        # One meta file and every shard's container, from two writers.
        assert sorted(os.listdir(ck)) == [
            "meta.npz", "shard_0_0_0.wts", "shard_8_0_0.wts"]
        rcs, outs, dirs = run_cli(tmp_path, 2, ["--resume", ck],
                                  name="resume")
        side = check_rank0_gating(rcs, outs, dirs, 16, 2)
        whole = sharded.solve_sharded(Problem(N=16, timesteps=6), (2, 1, 1),
                                      devices=[CPU] * 2)
        same_bits(side["abs_errors"][4:], whole.abs_errors[4:])
        assert side["run_config"]["resumed"] is True

    def test_preempt_exits_3_on_every_rank_then_resumes(self, tmp_path):
        args = ["16", "1", "1", "1", "1", "1", "20", "--mesh", "2,1,1",
                "--ckpt-every", "5"]
        rot = str(tmp_path / "rot")
        rcs, outs_cut, dirs = run_cli(
            tmp_path, 2, args + ["--ckpt-dir", rot], name="cut",
            extra_env={"WAVETPU_FAULT": "preempt:8"})
        assert rcs == [3, 3], outs_cut
        assert "resumable checkpoint:" in outs_cut[0]
        assert "resumable checkpoint:" not in outs_cut[1]
        assert os.listdir(dirs[1]) == []
        rcs, outs, dirs = run_cli(tmp_path, 2, ["--resume", rot,
                                                "--ckpt-every", "5"],
                                  name="rest")
        side = check_rank0_gating(rcs, outs, dirs, 16, 2)
        whole = sharded.solve_sharded(Problem(N=16, timesteps=20),
                                      (2, 1, 1), devices=[CPU] * 2)
        assert side["run_config"]["supervisor_status"] == "complete"
        # Cut at the chunk boundary 11 (chunks 0..6, 6..11, ...).
        assert "checkpointed at step 11" in outs_cut[0]
        same_bits(side["abs_errors"][12:], whole.abs_errors[12:])


    def test_nan_halts_every_rank_with_exit_4(self, tmp_path):
        """A NaN planted in shard 0 (rank 0's) trips the watchdog on both
        ranks at the same boundary: the health reading is reduced across
        ranks, so rank 1 halts too instead of waiting in a receive."""
        rcs, outs, dirs = run_cli(
            tmp_path, 2, ["16", "1", "1", "1", "1", "1", "20", "--mesh",
                          "2,1,1", "--ckpt-every", "5", "--ckpt-dir",
                          str(tmp_path / "rot")],
            extra_env={"WAVETPU_FAULT": "nan:8"})
        assert rcs == [4, 4], outs
        assert "watchdog: numerical-health trip" in outs[0]
        assert "last good step 6" in outs[0]
        assert os.listdir(dirs[1]) == []
