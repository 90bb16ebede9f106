"""Supervised solves on the port's single-device paths
(wavetpu_torch/run/supervisor.py) on the CPU: the intent of each test in
tests/test_supervisor.py, held on the port's paths.

A chunked march equals the uninterrupted march bit for bit on every path
(the chunk runners re-enter the same march on its block grid); checkpoint
rotation keeps fresh `step-*` entries, an atomic `latest` pointer and the
newest two; a real SIGTERM preempts and the rotation resumes; an injected
NaN halts with the last-good state, or is absorbed by a retry; and a
rotation root wavetpu wrote resumes in the port through `--resume ROOT`.
"""

import json
import os

import numpy as np
import pytest
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import checkpoint
from wavetpu_torch.kernels import stencil_ref
from wavetpu_torch.run import faults, health
from wavetpu_torch.run import supervisor as sup
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog, sharded_kfused

CPU = ("cpu",)
P = Problem(N=16, timesteps=10)


def opts(tmp_path, every=3, name="rot", **kw):
    return sup.SupervisorOptions(ckpt_every=every,
                                 ckpt_dir=str(tmp_path / name), **kw)


def eq(a, b):
    a = a.fundamental("cpu") if hasattr(a, "blocks") else a
    b = b.fundamental("cpu") if hasattr(b, "blocks") else b
    assert torch.equal(a.cpu(), b.cpu())


def test_chunk_length_snaps_to_block():
    assert sup.chunk_length(5, 1) == 5
    assert sup.chunk_length(5, 4) == 4
    assert sup.chunk_length(8, 4) == 8
    assert sup.chunk_length(1, 4) == 4
    assert sup.chunk_length(250, 4) == 248
    with pytest.raises(ValueError):
        sup.chunk_length(0, 1)


def test_supervised_standard_bitwise_and_rotation(tmp_path):
    full = leapfrog.solve(P, device="cpu", kernel="roll")
    r = sup.supervise(P, sup.PathSpec(kernel="roll", devices=CPU),
                      opts(tmp_path))
    assert r.status == "complete" and r.exit_code == sup.EXIT_COMPLETE
    eq(r.result.u_cur, full.u_cur)
    eq(r.result.u_prev, full.u_prev)
    np.testing.assert_array_equal(r.result.abs_errors, full.abs_errors)
    np.testing.assert_array_equal(r.result.rel_errors, full.rel_errors)
    root = tmp_path / "rot"
    entries = sorted(e for e in os.listdir(root) if e.startswith("step-"))
    assert r.checkpoints_written == 3          # boundaries 4, 7, 10
    assert entries == ["step-00000007.npz", "step-00000010.npz"]
    assert open(root / "latest").read().strip() == entries[-1]
    assert sup.resolve_latest(str(root)) == str(root / entries[-1])
    assert sup.looks_like_rotation_root(str(root))


def test_resolve_latest_survives_lost_pointer(tmp_path):
    sup.supervise(P, sup.PathSpec(kernel="roll", devices=CPU),
                  opts(tmp_path))
    root = tmp_path / "rot"
    os.remove(root / "latest")
    assert sup.resolve_latest(str(root)).endswith("step-00000010.npz")
    os.makedirs(tmp_path / "shardck")
    np.savez(tmp_path / "shardck" / "meta.npz", step=1)
    assert not sup.looks_like_rotation_root(str(tmp_path / "shardck"))
    assert sup.resolve_latest(str(tmp_path / "nothing")) is None


@pytest.mark.parametrize("path", [
    "kfused", "flagship", "flagship-increment", "compensated1",
    "varc", "kfused-varc", "flagship-varc", "uneven", "bf16",
])
def test_supervised_equals_unsupervised_bitwise(tmp_path, path):
    p = Problem(N=12, timesteps=11) if path != "uneven" else \
        Problem(N=15, timesteps=11)
    field = None
    if "varc" in path:
        field = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
    ce = field is None
    spec = {
        "kfused": sup.PathSpec(fuse_steps=3, devices=CPU),
        "flagship": sup.PathSpec(scheme="compensated", fuse_steps=3,
                                 devices=CPU),
        "flagship-increment": sup.PathSpec(
            scheme="compensated", fuse_steps=3, v_dtype=torch.bfloat16,
            carry=False, devices=CPU),
        "compensated1": sup.PathSpec(scheme="compensated", kernel="roll",
                                     devices=CPU),
        "varc": sup.PathSpec(kernel="roll", c2tau2_field=field,
                             compute_errors=False, devices=CPU),
        "kfused-varc": sup.PathSpec(fuse_steps=3, c2tau2_field=field,
                                    compute_errors=False, devices=CPU),
        "flagship-varc": sup.PathSpec(scheme="compensated", fuse_steps=3,
                                      c2tau2_field=field,
                                      compute_errors=False, devices=CPU),
        "uneven": sup.PathSpec(fuse_steps=4, devices=CPU),
        "bf16": sup.PathSpec(kernel="roll", dtype=torch.bfloat16,
                             devices=CPU),
    }[path]
    if path.startswith("flagship"):
        full = kfused_comp.solve_kfused_comp(
            p, k=3, device="cpu", c2tau2_field=field, compute_errors=ce,
            v_dtype=spec.v_dtype, carry=spec.carry)
    elif path.startswith("kfused"):
        full = kfused.solve_kfused(p, k=3, device="cpu", c2tau2_field=field,
                                   compute_errors=ce)
    elif path == "compensated1":
        full = leapfrog.solve_compensated(p, device="cpu", kernel="roll")
    elif path == "uneven":
        full = sharded_kfused.solve_sharded_kfused(p, n_shards=1, k=4,
                                                   devices=["cpu"])
    else:
        full = leapfrog.solve(p, dtype=spec.dtype or torch.float32,
                              device="cpu", kernel="roll",
                              c2tau2_field=field, compute_errors=ce)
    r = sup.supervise(p, spec, opts(tmp_path, every=4))
    assert r.status == "complete"
    eq(r.result.u_cur, full.u_cur)
    eq(r.result.u_prev, full.u_prev)
    if full.comp_v is not None:
        eq(r.result.comp_v, full.comp_v)
        if full.comp_carry is not None:
            eq(r.result.comp_carry, full.comp_carry)
    np.testing.assert_array_equal(r.result.abs_errors, full.abs_errors)


@pytest.mark.parametrize("scheme", ["standard", "compensated"])
def test_supervised_kfused_preempt_resume_bitwise(tmp_path, scheme):
    """A real SIGTERM mid-solve (delivered by the fault harness), then a
    resume of `latest`, equals the uninterrupted run, k=1 tail included."""
    p = Problem(N=12, timesteps=10)
    spec = sup.PathSpec(scheme=scheme, fuse_steps=2, devices=CPU)
    if scheme == "standard":
        full = kfused.solve_kfused(p, k=2, device="cpu")
    else:
        full = kfused_comp.solve_kfused_comp(p, k=2, device="cpu")
    r = sup.supervise(p, spec, opts(tmp_path, every=4,
                                    chunk_hook=faults.preempt_at_step(5)))
    assert r.status == "preempted" and r.exit_code == sup.EXIT_PREEMPTED
    assert r.checkpoint_path is not None
    _, u_prev, u_cur, step = checkpoint.load_checkpoint(r.checkpoint_path)
    assert step == r.final_step == 5 < p.timesteps
    assert not r.result.abs_errors[6:].any()
    if scheme == "standard":
        state = (u_prev, u_cur)
    else:
        state = (u_cur,) + checkpoint.load_checkpoint_aux(r.checkpoint_path)
    r2 = sup.supervise(p, spec, opts(tmp_path, every=4), state=state,
                       start_step=step)
    assert r2.status == "complete"
    eq(r2.result.u_cur, full.u_cur)
    eq(r2.result.u_prev, full.u_prev)
    np.testing.assert_array_equal(r2.result.abs_errors[step + 1:],
                                  full.abs_errors[step + 1:])


def test_watchdog_halts_with_last_good(tmp_path):
    full = leapfrog.solve(P, device="cpu", kernel="roll")
    spec = sup.PathSpec(kernel="roll", devices=CPU)
    r = sup.supervise(P, spec, opts(tmp_path,
                                    chunk_hook=faults.nan_at_step(7)))
    assert r.status == "watchdog" and r.exit_code == sup.EXIT_WATCHDOG
    assert r.amax_last == float("inf")
    assert r.final_step == 4
    good = leapfrog.solve(P, device="cpu", kernel="roll", stop_step=4)
    eq(r.result.u_cur, good.u_cur)
    np.testing.assert_array_equal(r.result.abs_errors[:5],
                                  full.abs_errors[:5])
    assert not r.result.abs_errors[5:].any()
    _, u_prev, u_cur, step = checkpoint.load_checkpoint(r.checkpoint_path)
    assert step == 4
    res = leapfrog.resume(P, u_prev, u_cur, step, device="cpu",
                          kernel="roll")
    eq(res.u_cur, full.u_cur)


def test_watchdog_retry_recovers_bitwise(tmp_path):
    full = leapfrog.solve(P, device="cpu", kernel="roll")
    r = sup.supervise(P, sup.PathSpec(kernel="roll", devices=CPU),
                      opts(tmp_path, retries=1,
                           chunk_hook=faults.nan_at_step(7)))
    assert r.status == "complete" and r.retries_used == 1
    eq(r.result.u_cur, full.u_cur)
    np.testing.assert_array_equal(r.result.abs_errors, full.abs_errors)


def test_resume_into_fresh_rotation_seeds_last_good(tmp_path):
    full = leapfrog.solve(P, device="cpu", kernel="roll")
    half = leapfrog.solve(P, device="cpu", kernel="roll", stop_step=5)
    ck = checkpoint.save_checkpoint(str(tmp_path / "ext.npz"), half)
    _, u_prev, u_cur, step = checkpoint.load_checkpoint(ck)
    spec = sup.PathSpec(kernel="roll", devices=CPU)
    r = sup.supervise(P, spec, opts(tmp_path, retries=1,
                                    chunk_hook=faults.nan_at_step(6)),
                      state=(u_prev, u_cur), start_step=step)
    assert r.status == "complete" and r.retries_used == 1
    eq(r.result.u_cur, full.u_cur)
    assert r.result.steps_computed <= 2 * (P.timesteps - 5)
    r2 = sup.supervise(P, spec, opts(tmp_path, name="rot2",
                                     chunk_hook=faults.nan_at_step(6)),
                       state=(u_prev, u_cur), start_step=step)
    assert r2.status == "watchdog" and r2.final_step == 5
    eq(r2.result.u_cur, half.u_cur)
    assert r2.checkpoint_path is not None


def test_watchdog_amplitude_bound(tmp_path):
    r = sup.supervise(P, sup.PathSpec(kernel="roll", devices=CPU),
                      opts(tmp_path, max_amp=1e-4))
    assert r.status == "watchdog"
    assert np.isfinite(r.amax_last) and r.amax_last > 1e-4
    r = sup.supervise(P, sup.PathSpec(kernel="roll", devices=CPU),
                      opts(tmp_path, name="off", max_amp=1e-4,
                           watchdog=False))
    assert r.status == "complete" and r.amax_last is None


def test_health_guard_semantics():
    from wavetpu.run import health as jhealth
    import jax.numpy as jnp

    cases = [[1.0, -3.0], [1.0, float("nan")], [1.0, float("inf")],
             [-float("inf"), 2.0], [0.0, 0.0]]
    for c in cases:
        for dt in (torch.float32, torch.float64, torch.bfloat16):
            got = health.guarded_amax(torch.tensor(c, dtype=dt))
            assert got == jhealth.guarded_amax(jnp.asarray(c)), (c, dt)
    assert health.guarded_amax(torch.tensor([1.0, -3.0])) == 3.0
    assert health.healthy(0.5) and not health.healthy(float("inf"))
    assert not health.healthy(float("nan"))
    assert health.healthy(5.0, 10.0) and not health.healthy(11.0, 10.0)
    assert health.state_amax([torch.ones(3), None, -2 * torch.ones(2)]) == 2
    # A ShardedArray: the max over its blocks, each reduced on its device.
    from wavetpu_torch.core.grid import Topology, build_mesh, split_global

    topo = Topology(N=6, mesh_shape=(2, 1, 1))
    g = torch.zeros(topo.padded)
    g[4, 1, 1] = -7.0
    sa = split_global(g, topo, build_mesh((2, 1, 1), ["cpu"] * 2))
    assert health.guarded_amax(sa) == 7.0
    sa.blocks[0][0, 0, 0] = float("nan")
    assert health.guarded_amax(sa) == float("inf")


def test_hook_from_env():
    env = {faults.ENV_FAULT: "nan:5"}
    assert faults.hook_from_env(env) is not None
    assert faults.hook_from_env({}) is None
    # Specs of the serving and router tiers are ignored by the run side.
    assert faults.hook_from_env(
        {faults.ENV_FAULT: "serve-execute-nan;router-drop"}) is None
    assert faults.hook_from_env(
        {faults.ENV_FAULT: "serve-slow-batch:seconds=1;preempt:3"})
    for bad in ("nan", "explode:3", "nan:x", "nan:3;preempt:4"):
        with pytest.raises(ValueError):
            faults.hook_from_env({faults.ENV_FAULT: bad})
    hook = faults.nan_at_step(4)
    st = (torch.zeros(3), torch.ones(3))
    assert hook(st, 3) is st
    out = hook(st, 4)
    assert torch.isnan(out[1][0]) and not torch.isnan(st[1]).any()
    assert hook(st, 5) is st                    # once


def test_wavetpu_rotation_root_resumes_in_the_port(tmp_path, capsys,
                                                   monkeypatch):
    """A rotation root wavetpu's supervised CLI wrote (preempted) resumes
    through the port's `--resume ROOT --ckpt-every`, to wavetpu's
    uninterrupted run within XLA-CPU's FMA tolerance (ROADMAP.md queue
    3), and keeps rotating in place."""
    from wavetpu import cli as jcli
    from wavetpu_torch import cli

    base = ["16", "1", "1", "1", "1", "1", "10", "--backend", "single",
            "--platform", "cpu"]
    rot = str(tmp_path / "rot")
    assert jcli.main(base + ["--out-dir", str(tmp_path / "jfull")]) == 0
    monkeypatch.setenv(faults.ENV_FAULT, "preempt:4")
    assert jcli.main(base + ["--ckpt-every", "3", "--ckpt-dir", rot,
                             "--out-dir", str(tmp_path / "pre")]) == 3
    monkeypatch.delenv(faults.ENV_FAULT)
    step = int(open(os.path.join(rot, "latest")).read()[5:13])
    capsys.readouterr()
    assert cli.main(["--resume", rot, "--ckpt-every", "3", "--platform",
                     "cpu", "--out-dir", str(tmp_path / "ours")]) == 0
    assert "supervisor: complete" in capsys.readouterr().out
    ours = json.load(open(tmp_path / "ours" / "output_N16_Np1_CUDA.json"))
    ref = json.load(open(tmp_path / "jfull" / "output_N16_Np1_TPU.json"))
    np.testing.assert_allclose(ours["abs_errors"][step + 1:],
                               ref["abs_errors"][step + 1:], rtol=0,
                               atol=1e-6)
    assert ours["run_config"]["resumed"] and ours["run_config"]["supervised"]
    assert sup.resolve_latest(rot).endswith("step-00000010.npz")
