"""Supervised solves on the port's sharded paths (wavetpu_torch/run/
supervisor.py) on the CPU, every shard on the CPU: the sharded tests of
tests/test_supervisor.py, held on the port's paths.

The chunked sharded march equals the uninterrupted one bit for bit (K6/K7
per step; K8, K9 and K10 per k-block; K11/K12 for the distributed
flagship); the rotation holds per-shard checkpoint directories; a real
SIGTERM preempts and the `latest` directory resumes; the watchdog halts on
a NaN in one shard's block.
"""

import os

import numpy as np
import pytest
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import checkpoint
from wavetpu_torch.run import faults
from wavetpu_torch.run import supervisor as sup
from wavetpu_torch.solver import kfused_comp, sharded, sharded_kfused

CPU4 = ("cpu",) * 4


def opts(tmp_path, every=4, name="rot", **kw):
    return sup.SupervisorOptions(ckpt_every=every,
                                 ckpt_dir=str(tmp_path / name), **kw)


def eq(a, b):
    assert torch.equal(a.assemble("cpu"), b.assemble("cpu"))


def full_run(p, path, mesh, k):
    devs = list(CPU4)
    if path == "sharded1":
        return sharded.solve_sharded(p, mesh, devs)
    if path == "sharded1-compensated":
        return sharded.solve_sharded(p, mesh, devs, scheme="compensated")
    if path == "kfused":
        return sharded_kfused.solve_sharded_kfused(p, k=k, mesh_shape=mesh,
                                                   devices=devs)
    return kfused_comp.solve_kfused_comp_sharded(p, k=k, mesh_shape=mesh,
                                                 devices=devs)


def spec_of(path, mesh, k):
    return sup.PathSpec(
        backend="sharded",
        scheme="compensated" if "compensated" in path or path == "flagship"
        else "standard",
        fuse_steps=k if path in ("kfused", "flagship") else 1,
        mesh_shape=mesh, devices=CPU4)


CASES = {
    "sharded1-221": ("sharded1", (2, 2, 1), 1, 16),
    "sharded1-compensated-221": ("sharded1-compensated", (2, 2, 1), 1, 16),
    "K8-411": ("kfused", (4, 1, 1), 2, 16),
    "K9-uneven-211": ("kfused", (2, 1, 1), 4, 15),
    "K10-221": ("kfused", (2, 2, 1), 4, 16),
    "K11-211": ("flagship", (2, 1, 1), 4, 16),
    "K12-221": ("flagship", (2, 2, 1), 4, 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_supervised_sharded_bitwise_and_directories(tmp_path, case):
    path, mesh, k, n = CASES[case]
    p = Problem(N=n, timesteps=14)
    full = full_run(p, path, mesh, k)
    r = sup.supervise(p, spec_of(path, mesh, k), opts(tmp_path))
    assert r.status == "complete"
    eq(r.result.u_cur, full.u_cur)
    eq(r.result.u_prev, full.u_prev)
    if full.comp_carry is not None:
        eq(r.result.comp_carry, full.comp_carry)
    np.testing.assert_array_equal(r.result.abs_errors, full.abs_errors)
    assert os.path.isdir(r.checkpoint_path)
    assert os.path.exists(os.path.join(r.checkpoint_path, "meta.npz"))
    n_shards = mesh[0] * mesh[1] * mesh[2]
    assert len([f for f in os.listdir(r.checkpoint_path)
                if f.endswith(".wts")]) == n_shards
    assert len([e for e in os.listdir(tmp_path / "rot")
                if e.startswith("step-")]) == 2


@pytest.mark.parametrize("case", ["K10-221", "K12-221", "K9-uneven-211",
                                  "sharded1-221"])
def test_supervised_sharded_preempt_resume_bitwise(tmp_path, case):
    path, mesh, k, n = CASES[case]
    p = Problem(N=n, timesteps=14)
    full = full_run(p, path, mesh, k)
    spec = spec_of(path, mesh, k)
    r = sup.supervise(p, spec, opts(tmp_path,
                                    chunk_hook=faults.preempt_at_step(6)))
    assert r.status == "preempted"
    (_, u_prev, u_cur, step, ms, scheme, aux) = (
        checkpoint.load_sharded_checkpoint(r.checkpoint_path, CPU4))
    assert ms == mesh and step == r.final_step < p.timesteps
    state = (u_cur,) + aux if scheme == "compensated" else (u_prev, u_cur)
    r2 = sup.supervise(p, spec, opts(tmp_path), state=state,
                       start_step=step)
    assert r2.status == "complete"
    eq(r2.result.u_cur, full.u_cur)
    np.testing.assert_array_equal(r2.result.abs_errors[step + 1:],
                                  full.abs_errors[step + 1:])


def test_sharded_watchdog_and_retry(tmp_path):
    path, mesh, k, n = CASES["K10-221"]
    p = Problem(N=n, timesteps=14)
    full = full_run(p, path, mesh, k)
    spec = spec_of(path, mesh, k)
    r = sup.supervise(p, spec, opts(tmp_path,
                                    chunk_hook=faults.nan_at_step(7)))
    assert r.status == "watchdog" and r.final_step == 5
    assert r.checkpoint_path.endswith("step-00000005")
    r = sup.supervise(p, spec, opts(tmp_path, name="retry", retries=1,
                                    chunk_hook=faults.nan_at_step(7)))
    assert r.status == "complete" and r.retries_used == 1
    eq(r.result.u_cur, full.u_cur)


def test_cli_sharded_supervised_preempt_and_resume(tmp_path, capsys,
                                                   monkeypatch):
    """The CLI on a mesh of CPU shards: preempted exit 3 with a resumable
    shard directory, then --resume of the rotation root (mesh, scheme and
    dtype from the checkpoint) completes on the uninterrupted errors."""
    import json

    from wavetpu_torch import cli

    base = ["16", "1", "1", "1", "1", "1", "14", "--platform", "cpu",
            "--mesh", "2,2,1", "--fuse-steps", "4", "--scheme",
            "compensated"]
    assert cli.main(base + ["--out-dir", str(tmp_path / "full")]) == 0
    rot = str(tmp_path / "rot")
    monkeypatch.setenv(faults.ENV_FAULT, "preempt:6")
    assert cli.main(base + ["--ckpt-every", "4", "--ckpt-dir", rot,
                            "--out-dir", str(tmp_path / "pre")]) == 3
    monkeypatch.delenv(faults.ENV_FAULT)
    out = capsys.readouterr().out
    assert f"resumable checkpoint: {rot}/step-00000009" in out
    assert cli.main(["--resume", rot, "--ckpt-every", "4", "--fuse-steps",
                     "4", "--platform", "cpu", "--out-dir",
                     str(tmp_path / "res")]) == 0
    name = "output_N16_Np4_CUDA.json"
    full = json.load(open(tmp_path / "full" / name))
    res = json.load(open(tmp_path / "res" / name))
    assert res["abs_errors"][10:] == full["abs_errors"][10:]
    cfg = res["run_config"]
    assert cfg["mesh"] == [2, 2, 1] and cfg["scheme"] == "compensated"
    assert cfg["resumed"] and cfg["supervised"] and cfg["ckpt_every"] == 4
    assert cfg["supervisor_status"] == "complete"
