"""The port's phase-timing probes (solver/timing.py) on the CPU, mirroring
tests/test_timing.py: the breakdown's fields, the 1-step, k-fused (x- and
y-sharded) and compensated probes, the refusals, and that the 1-step probe
builds its step through the production step builder.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.solver import timing as jtiming
from wavetpu_torch.core import grid
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.solver import sharded, sharded_kfused, timing

CPU8 = ["cpu"] * 8


@pytest.fixture
def small():
    return Problem(N=16, timesteps=10)


def test_phase_breakdown_sharded(small):
    pb = timing.measure_phase_breakdown(small, mesh_shape=(2, 2, 2),
                                        devices=CPU8, iters=4, repeats=2)
    assert pb.loop_seconds > 0.0
    assert pb.exchange_seconds >= 0.0
    assert pb.steps_measured == 4
    assert pb.total_seconds == pb.loop_seconds + pb.exchange_seconds


def test_phase_breakdown_single_device(small):
    pb = timing.measure_phase_breakdown(small, mesh_shape=(1, 1, 1),
                                        devices=["cpu"], iters=4, repeats=2)
    assert pb.loop_seconds > 0.0
    assert pb.exchange_seconds >= 0.0


def test_breakdown_fields_are_wavetpus(small):
    """The same fields and probe length as wavetpu's breakdown of the
    same run."""
    ours = timing.measure_phase_breakdown(small, mesh_shape=(2, 2, 2),
                                          devices=CPU8, iters=3, repeats=1)
    ref = jtiming.measure_phase_breakdown(
        JProblem(N=16, timesteps=10), mesh_shape=(2, 2, 2), iters=3,
        repeats=1)
    names = [f.name for f in dataclasses.fields(ours)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    assert ours.steps_measured == ref.steps_measured == 3


@pytest.mark.parametrize("kernel", ["roll", "pallas"])
@pytest.mark.parametrize("overlap", [False, True])
def test_probe_uses_production_step(small, monkeypatch, kernel, overlap):
    """The probe builds its step through sharded._make_local_step - the
    same builder the production solver uses - with the same kernel and
    overlap selection, once with exchange on and once off."""
    calls = []
    real = sharded._make_local_step

    def spy(problem, topo, mesh, offsets, kern, ovl, exchange=True):
        calls.append({"kernel": kern, "overlap": ovl, "exchange": exchange})
        return real(problem, topo, mesh, offsets, kern, ovl,
                    exchange=exchange)

    monkeypatch.setattr(sharded, "_make_local_step", spy)
    timing.measure_phase_breakdown(small, mesh_shape=(2, 2, 2),
                                   devices=CPU8, kernel=kernel,
                                   overlap=overlap, iters=2, repeats=1)
    assert {c["kernel"] for c in calls} == {kernel}
    assert {c["overlap"] for c in calls} == {overlap}
    assert {c["exchange"] for c in calls} == {True, False}


@pytest.mark.parametrize("scheme", ["standard", "compensated"])
def test_kfused_probe_uses_production_exchange(small, monkeypatch, scheme):
    """The k-fused probes' full variant exchanges through
    sharded_kfused.exchange, the compute variant through `_self_exchange`
    - for u_prev and u (u and v) of every k-block."""
    calls = []
    real = sharded_kfused.exchange

    def spy(blocks, mesh, kk, counts=None):
        calls.append(kk)
        return real(blocks, mesh, kk, counts)

    monkeypatch.setattr(sharded_kfused, "exchange", spy)
    timing.measure_phase_breakdown(small, mesh_shape=(2, 1, 1),
                                   devices=CPU8, fuse_steps=4, iters=2,
                                   repeats=1, scheme=scheme)
    # warm-up + one timed run, two fields per k-block, 2 blocks each.
    assert calls == [4] * 8


@pytest.mark.parametrize("mesh_shape", [(1, 1, 1), (2, 1, 1), (2, 2, 1),
                                        (1, 2, 1)])
def test_self_exchange_copies_what_exchange_copies(mesh_shape):
    """`_self_exchange` gives blocks and windows of the exchange's shapes,
    filled from the shard itself (equal to the exchange on one shard)."""
    n, k = 8, 2
    mx, my, _ = mesh_shape
    mesh = grid.build_mesh(mesh_shape, ["cpu"] * (mx * my))
    rng = np.random.default_rng(1)
    blocks = [torch.from_numpy(rng.standard_normal((n // mx, n // my, n)))
              for _ in range(mx * my)]
    ext, wins = sharded_kfused.exchange(blocks, mesh, k)
    own_ext, own_wins = timing._self_exchange(blocks, mesh, k)
    for a, b in zip(ext, own_ext):
        assert a.shape == b.shape
    for (a0, a1), (b0, b1) in zip(wins, own_wins):
        assert a0.shape == b0.shape and a1.shape == b1.shape
    for b, e, (lo, hi) in zip(blocks, own_ext, own_wins):
        if my > 1:
            assert torch.equal(e[:, k:-k], b)
            assert torch.equal(e[:, :k], b[:, -k:])
        assert torch.equal(lo, e[-k:]) and torch.equal(hi, e[:k])
    if mx * my == 1:
        assert torch.equal(ext[0], own_ext[0])
        assert all(torch.equal(a, b) for a, b in zip(wins[0], own_wins[0]))


def test_phase_breakdown_kfused(small):
    """fuse_steps > 1 probes the x-sharded k-fused march (K8): k-blocks
    with and without the exchange, scaled by the layers covered."""
    pb = timing.measure_phase_breakdown(small, mesh_shape=(2, 1, 1),
                                        devices=CPU8, fuse_steps=4,
                                        iters=2, repeats=1)
    assert pb.loop_seconds > 0.0
    assert pb.exchange_seconds >= 0.0
    assert pb.steps_measured == 8  # 2 blocks x k=4 layers


def test_phase_breakdown_kfused_xy_mesh(small):
    """The k-fused probe covers (MX, MY, 1) meshes (K10 on y-extended
    blocks)."""
    pb = timing.measure_phase_breakdown(small, mesh_shape=(2, 2, 1),
                                        devices=CPU8, fuse_steps=4,
                                        iters=2, repeats=1)
    assert pb.loop_seconds > 0.0
    assert pb.exchange_seconds >= 0.0
    assert pb.steps_measured == 8


def test_phase_breakdown_kfused_comp(small):
    """scheme="compensated" with fuse_steps > 1 probes the distributed
    flagship (K11, K12): (u, v, carry) state, u and v exchanging windows,
    on 1D and 2D meshes, including the carry-less bf16-increment mode."""
    pb = timing.measure_phase_breakdown(small, mesh_shape=(2, 1, 1),
                                        devices=CPU8, fuse_steps=4,
                                        scheme="compensated", iters=2,
                                        repeats=1)
    assert pb.loop_seconds > 0.0
    assert pb.exchange_seconds >= 0.0
    assert pb.steps_measured == 8
    pb_xy = timing.measure_phase_breakdown(small, mesh_shape=(2, 2, 1),
                                           devices=CPU8, fuse_steps=4,
                                           scheme="compensated", iters=2,
                                           repeats=1)
    assert pb_xy.loop_seconds > 0.0
    pb_inc = timing.measure_phase_breakdown(
        small, mesh_shape=(2, 1, 1), devices=CPU8, fuse_steps=4,
        scheme="compensated", v_dtype=torch.bfloat16, iters=2, repeats=1)
    assert pb_inc.loop_seconds > 0.0


def test_phase_breakdown_scales_to_the_solve_length(small):
    pb = timing.measure_phase_breakdown(small, mesh_shape=(1, 1, 1),
                                        devices=["cpu"], fuse_steps=2,
                                        iters=1, repeats=1)
    # The probe covers 2 layers; the solve 10.
    assert pb.steps_measured == 2


def test_phase_breakdown_kfused_rejects_3d_mesh(small):
    with pytest.raises(ValueError, match=r"\(MX, MY, 1\)"):
        timing.measure_phase_breakdown(small, mesh_shape=(2, 2, 2),
                                       devices=CPU8, fuse_steps=4,
                                       iters=1, repeats=1)
    with pytest.raises(ValueError, match="even"):
        # Uneven decompositions have no probe (the CLI rejects the combo).
        timing.measure_phase_breakdown(
            Problem(N=15, timesteps=10), mesh_shape=(2, 1, 1),
            devices=CPU8, fuse_steps=4, iters=1, repeats=1)


def test_phase_breakdown_rejects_1step_compensated(small):
    with pytest.raises(ValueError, match="compensated probe"):
        timing.measure_phase_breakdown(small, mesh_shape=(2, 1, 1),
                                       devices=CPU8, scheme="compensated",
                                       iters=1, repeats=1)
