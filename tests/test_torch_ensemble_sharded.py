"""The port's sharded ensemble (wavetpu_torch/ensemble/sharded.py) on the
CPU: every shard on the CPU (`devices=["cpu"] * 4`), where K6's lane mode
runs its plain version.

Every lane of a batched sharded solve equals the port's solo
`sharded.solve_sharded` of that lane (phase, stop) on the same mesh bit for
bit, states and error vectors - and so the single-device ensemble's lane
(the sharded == single-device contract) - with padding leaving the real
lanes unchanged.  Against wavetpu's `solve_ensemble_sharded` (Pallas in
interpret mode on the 8 virtual CPU devices, as tests/test_torch_sharded.py
runs wavetpu): f32 states and abs errors within 1e-5, rel errors within
rtol 1e-3 beside that slack (tests/test_torch_ensemble.py's tolerances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.ensemble import batched as jeb
from wavetpu.ensemble import sharded as jes
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.ensemble import sharded as es
from wavetpu_torch.solver import sharded

CPU4 = ["cpu"] * 4
MESHES = [(2, 2, 1), (2, 1, 1)]


@pytest.fixture(scope="module")
def problem():
    return Problem(N=16, timesteps=9)


@pytest.fixture(scope="module")
def lanes():
    return [eb.LaneSpec(), eb.LaneSpec(phase=1.0),
            eb.LaneSpec(phase=0.5, stop_step=5)]


def state(a):
    return a.fundamental() if hasattr(a, "blocks") else a


def assert_bitwise(res, solos):
    assert res.batched and res.fallback_reason is None
    for got, want in zip(res.results, solos, strict=True):
        assert torch.equal(state(got.u_cur), state(want.u_cur))
        assert torch.equal(state(got.u_prev), state(want.u_prev))
        assert got.final_step == want.final_step
        assert np.array_equal(got.abs_errors, want.abs_errors)
        assert np.array_equal(got.rel_errors, want.rel_errors)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kernel", ["roll", "pallas"])
def test_lanes_equal_solo_sharded_solves(problem, lanes, mesh, kernel):
    res = es.solve_ensemble_sharded(problem, lanes, mesh, kernel=kernel,
                                    devices=CPU4)
    assert res.path == f"sharded{mesh}:{kernel}"
    assert_bitwise(res, [
        sharded.solve_sharded(problem, mesh, devices=CPU4, kernel=kernel,
                              stop_step=ln.stop(problem), phase=ln.phase)
        for ln in lanes])


@pytest.mark.parametrize("mesh", MESHES)
def test_lanes_equal_single_device_ensemble(problem, lanes, mesh):
    res = es.solve_ensemble_sharded(problem, lanes, mesh, kernel="pallas",
                                    devices=CPU4)
    assert_bitwise(res, eb.solve_ensemble(problem, lanes, path="pallas",
                                          device="cpu").results)


def test_uneven_mesh_lanes_equal_solo(lanes):
    # N=15 on mesh (2,1,1): the last shard's hi ghost is absorbed into
    # its pad plane for every lane at once.
    p = Problem(N=15, timesteps=7)
    lanes = [eb.LaneSpec(), eb.LaneSpec(phase=1.0, stop_step=4)]
    res = es.solve_ensemble_sharded(p, lanes, (2, 1, 1), kernel="pallas",
                                    devices=CPU4)
    assert_bitwise(res, [
        sharded.solve_sharded(p, (2, 1, 1), devices=CPU4,
                              stop_step=ln.stop(p), phase=ln.phase)
        for ln in lanes])


@pytest.mark.parametrize("mesh", MESHES)
def test_padding_leaves_real_lanes_unchanged(problem, lanes, mesh):
    plain = es.solve_ensemble_sharded(problem, lanes, mesh, devices=CPU4)
    padded = es.solve_ensemble_sharded(problem, lanes, mesh, devices=CPU4,
                                       pad_to=6)
    assert padded.batch_size == 6 and padded.n_lanes == 3
    assert_bitwise(padded, plain.results)
    n_shards = mesh[0] * mesh[1] * mesh[2]
    assert len(padded.u_cur_batch) == n_shards
    assert padded.u_cur_batch[0].shape[0] == 6


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kernel", ["roll", "pallas"])
def test_matches_wavetpu(problem, lanes, mesh, kernel):
    ours = es.solve_ensemble_sharded(problem, lanes, mesh, kernel=kernel,
                                     devices=CPU4, pad_to=4)
    ref = jes.solve_ensemble_sharded(
        JProblem(N=16, timesteps=9),
        [jeb.LaneSpec(phase=ln.phase, stop_step=ln.stop_step)
         for ln in lanes], mesh, kernel=kernel, interpret=True, pad_to=4)
    assert ref.batched
    for got, want in zip(ours.results, ref.results, strict=True):
        a = got.u_cur.assemble().to(torch.float64).numpy()
        b = np.asarray(jnp.asarray(want.u_cur, jnp.float64))
        assert np.max(np.abs(a - b)) <= 1e-5
        np.testing.assert_allclose(got.abs_errors, want.abs_errors,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got.rel_errors, want.rel_errors,
                                   rtol=1e-3, atol=1e-5)


def test_validation(problem, lanes):
    field = np.full((16,) * 3, problem.a2tau2)
    for bad, match in ((dict(kernel="cuda"), "kernel"),
                       (dict(lanes=[]), "at least one lane"),
                       (dict(lanes=[eb.LaneSpec(c2tau2_field=field)]),
                        "constant speed"),
                       (dict(lanes=[eb.LaneSpec(stop_step=10)]), "stop_step"),
                       (dict(pad_to=2), "pad_to")):
        kw = dict(dict(lanes=lanes), **bad)
        with pytest.raises(ValueError, match=match):
            es.solve_ensemble_sharded(problem, kw.pop("lanes"), (2, 1, 1),
                                      devices=CPU4, **kw)


def test_capability_table_and_lane_loop(problem, lanes, monkeypatch):
    es._PROBE_CACHE.clear()
    try:
        assert es.vmap_capability((2, 2, 1), "pallas") == (True, None)
        assert es.vmap_capability((2, 2, 1), "roll", device="cpu") == (
            True, None)
        probes = es.probe_results()
        assert [p["mesh"] for p in probes] == [[2, 2, 1]] * 2
        assert {p["backend"] for p in probes} == {"cuda", "cpu"}
    finally:
        es._PROBE_CACHE.clear()
    monkeypatch.setattr(es, "vmap_capability",
                        lambda *a, **k: (False, "forced-by-test"))
    res = es.solve_ensemble_sharded(problem, lanes, (2, 1, 1), devices=CPU4)
    assert res.batched is False and "forced-by-test" in res.fallback_reason
    want = sharded.solve_sharded(problem, (2, 1, 1), devices=CPU4, phase=1.0,
                                 kernel="roll")
    assert torch.equal(state(res.results[1].u_cur), state(want.u_cur))
