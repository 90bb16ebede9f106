"""The port's batched ensemble (wavetpu_torch/ensemble/batched.py) on the
CPU, where the kernels' lane modes run their plain versions.

Two contracts, as tests/test_ensemble.py pins wavetpu's:
- every lane of a batched solve equals the port's solo solve of that lane
  (its phase and stop) bit for bit - states and error vectors - on every
  (scheme, path), with field batches, padding and early stops;
- the batch matches wavetpu's `solve_ensemble` (Pallas in interpret mode)
  within the port's parity tolerances (tests/test_torch_solver.py): f32
  states and abs errors within 1e-5 and rel errors within rtol 1e-3 (plus
  that absolute slack); f64 states and abs errors within 1e-12.  f64 rel
  errors are compared only where the metric is guarded (the flagship's):
  elsewhere the plane where sin(2 pi x) evaluates to ~1.2e-16 instead of
  0 divides a 1-ulp state difference by ~1e-16, so both sides report
  O(1) values that agree in no digit.  wavetpu's K3 takes no f64 state in
  interpret mode (its error rows are f32 refs), so the standard k-fused
  path is held to it in f32.  wavetpu's own compensated roll-lane parity
  fails on this jaxlib (ROADMAP.md queue 3), so the compensated lanes are
  held to wavetpu within tolerance only.
The compensated k-fused lanes run K4 at block_x=8 on both sides against
wavetpu (its default slab is shallower than the port's); against the
port's solo solves they run the port's default.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.ensemble import batched as jeb
from wavetpu.run import health as jhealth
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.run import health
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog, sharded

SCHEME_PATHS = [(s, p) for s in ("standard", "compensated")
                for p in ("roll", "pallas", "kfused")]
DT = [(torch.float32, jnp.float32, 1e-5, 1e-3),
      (torch.float64, jnp.float64, 1e-12, 1e-9)]


@pytest.fixture(scope="module")
def problem():
    return Problem(N=16, timesteps=9)


def lanes_of(lane_cls):
    # default phase, shifted phase, shifted phase + early stop (a k-block
    # boundary for k = 2 and 4)
    return [lane_cls(), lane_cls(phase=1.0),
            lane_cls(phase=0.5, stop_step=5)]


@pytest.fixture(scope="module")
def lanes():
    return lanes_of(eb.LaneSpec)


def solo(p, scheme, path, lane, k=4, dtype=torch.float32, **kw):
    """The port's solo solve of one lane on the ensemble's path."""
    kw = dict(kw, dtype=dtype, stop_step=lane.stop(p), device="cpu",
              phase=lane.phase)
    kernel = "roll" if path == "roll" else "pallas"
    if scheme == "compensated" and path == "kfused":
        return kfused_comp.solve_kfused_comp(p, k=k, **kw)
    if scheme == "compensated":
        return leapfrog.solve_compensated(p, kernel=kernel, **kw)
    if path == "kfused":
        return kfused.solve_kfused(p, k=k, c2tau2_field=lane.c2tau2_field,
                                   **kw)
    return leapfrog.solve(p, kernel=kernel, c2tau2_field=lane.c2tau2_field,
                          **kw)


def assert_bitwise(res, solos):
    assert res.batched and res.fallback_reason is None
    assert len(res.results) == len(solos)
    for got, want in zip(res.results, solos):
        assert torch.equal(got.u_cur, want.u_cur)
        assert torch.equal(got.u_prev, want.u_prev)
        assert got.final_step == want.final_step
        assert np.array_equal(got.abs_errors, want.abs_errors)
        assert np.array_equal(got.rel_errors, want.rel_errors)


def as64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x, jnp.float64))


def assert_close(res, ref, tol, rtol):
    assert len(res.results) == len(ref.results)
    for got, want in zip(res.results, ref.results):
        for a, b in ((got.u_cur, want.u_cur), (got.u_prev, want.u_prev)):
            assert np.max(np.abs(as64(a) - as64(b))) <= tol
        assert got.abs_errors.shape == want.abs_errors.shape
        np.testing.assert_allclose(got.abs_errors, want.abs_errors,
                                   rtol=0, atol=tol)
        if rtol is not None:
            np.testing.assert_allclose(got.rel_errors, want.rel_errors,
                                       rtol=rtol, atol=tol)


def jlanes(lanes):
    return [jeb.LaneSpec(phase=ln.phase, stop_step=ln.stop_step,
                         c2tau2_field=ln.c2tau2_field) for ln in lanes]


# ---------------------------------------------------------------------------
# Lane parity: every lane bitwise its solo port solve.


@pytest.mark.parametrize("scheme,path,k", [
    (s, p, k) for s, p in SCHEME_PATHS
    for k in ((2, 4) if p == "kfused" else (4,))])
def test_lanes_equal_solo_solves(problem, lanes, scheme, path, k):
    res = eb.solve_ensemble(problem, lanes, scheme=scheme, path=path, k=k,
                            device="cpu")
    assert_bitwise(res, [solo(problem, scheme, path, ln, k) for ln in lanes])


@pytest.mark.parametrize("scheme", ["standard", "compensated"])
def test_kfused_remainder_tail(scheme):
    # (10 - 1) % 2 == 1: the batch runs the 1-step (k=1) tail the solo
    # march also runs; the stop at 5 lies on the block grid.
    p = Problem(N=10, timesteps=10)
    lanes = lanes_of(eb.LaneSpec)
    res = eb.solve_ensemble(p, lanes, scheme=scheme, path="kfused", k=2,
                            device="cpu")
    assert_bitwise(res, [solo(p, scheme, "kfused", ln, 2) for ln in lanes])


def test_f64_lanes_equal_solo_solves(problem, lanes):
    for scheme, path in SCHEME_PATHS:
        res = eb.solve_ensemble(problem, lanes, dtype=torch.float64,
                                scheme=scheme, path=path, device="cpu")
        assert_bitwise(res, [solo(problem, scheme, path, ln,
                                  dtype=torch.float64) for ln in lanes])


def test_bf16_lanes_equal_solo_solves(problem, lanes):
    for path in ("pallas", "kfused"):
        res = eb.solve_ensemble(problem, lanes, dtype=torch.bfloat16,
                                path=path, device="cpu")
        assert_bitwise(res, [solo(problem, "standard", path, ln,
                                  dtype=torch.bfloat16) for ln in lanes])


@pytest.fixture(scope="module")
def field(problem):
    return stencil_ref.make_c2tau2_field(
        problem, lambda x, y, z: problem.a2 * (1.0 - 0.3 * np.exp(
            -((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) / 0.1)))


@pytest.mark.parametrize("path", ["roll", "pallas", "kfused"])
def test_field_lanes_equal_solo_solves(problem, field, path):
    lanes = [eb.LaneSpec(c2tau2_field=field), eb.LaneSpec(stop_step=5),
             eb.LaneSpec(c2tau2_field=0.5 * field)]
    res = eb.solve_ensemble(problem, lanes, path=path, compute_errors=False,
                            device="cpu", pad_to=4)
    # A lane without a field runs the constant tau^2 a^2 field
    # (fill_fields), as wavetpu's.
    assert_bitwise(res, [solo(problem, "standard", path, ln,
                              compute_errors=False)
                         for ln in eb.fill_fields(problem, lanes)])


@pytest.mark.parametrize("scheme,path", SCHEME_PATHS)
def test_padding_leaves_real_lanes_unchanged(problem, lanes, scheme, path):
    plain = eb.solve_ensemble(problem, lanes, scheme=scheme, path=path,
                              device="cpu")
    padded = eb.solve_ensemble(problem, lanes, scheme=scheme, path=path,
                               device="cpu", pad_to=8)
    assert padded.batch_size == 8 and padded.n_lanes == 3
    assert_bitwise(padded, plain.results)
    assert padded.u_cur_batch.shape == (8, 16, 16, 16)


def test_padding_enters_no_launch_after_layer_1(problem, lanes,
                                                monkeypatch):
    """The live-prefix march: the lane launches' count does not depend on
    B, and every launch after the bootstrap covers only the live lanes."""
    calls = []
    real = stencil_cuda.fused_step_lanes

    def spy(u_prev, u, **kw):
        calls.append(u.shape[0])
        return real(u_prev, u, **kw)

    monkeypatch.setattr(stencil_cuda, "fused_step_lanes", spy)
    for pad in (3, 8):
        calls.clear()
        eb.solve_ensemble(problem, lanes, path="pallas", device="cpu",
                          pad_to=pad)
        # Bootstrap over the reference-phase lanes (lane 0 and the
        # padding), then layers 2-5 over 3 lanes, 6-9 over 2.
        assert calls == [1 + pad - 3] + [3] * 4 + [2] * 4


def test_batch_arrays_in_the_callers_lane_order(problem, lanes):
    res = eb.solve_ensemble(problem, lanes, scheme="compensated",
                            path="kfused", device="cpu", pad_to=4)
    for i, r in enumerate(res.results):
        assert torch.equal(res.u_cur_batch[i], r.u_cur)
        assert torch.equal(res.u_prev_batch[i], r.u_prev)


# ---------------------------------------------------------------------------
# Against wavetpu's ensemble.


@pytest.mark.parametrize("scheme,path,dt,jdt,tol,rtol", [
    (s, p) + d for s, p in SCHEME_PATHS for d in DT
    if (s, p) != ("standard", "kfused") or d[0] == torch.float32])
def test_matches_wavetpu(problem, lanes, scheme, path, dt, jdt, tol, rtol):
    k = 2
    flagship = scheme == "compensated" and path == "kfused"
    bx = 8 if flagship else None
    if dt == torch.float64 and not flagship:
        rtol = None
    ours = eb.solve_ensemble(problem, lanes, dtype=dt, scheme=scheme,
                             path=path, k=k, block_x=bx, device="cpu",
                             pad_to=4)
    ref = jeb.solve_ensemble(JProblem(N=16, timesteps=9), jlanes(lanes),
                             dtype=jdt, scheme=scheme, path=path, k=k,
                             block_x=bx, interpret=True, pad_to=4)
    assert ref.batched
    assert_close(ours, ref, tol, rtol)


@pytest.mark.parametrize("path", ["roll", "pallas", "kfused"])
def test_field_batch_matches_wavetpu(problem, field, path):
    lanes = [eb.LaneSpec(c2tau2_field=field), eb.LaneSpec(stop_step=5)]
    ours = eb.solve_ensemble(problem, lanes, path=path, k=2,
                             compute_errors=False, device="cpu")
    ref = jeb.solve_ensemble(JProblem(N=16, timesteps=9), jlanes(lanes),
                             path=path, k=2, compute_errors=False,
                             interpret=True)
    assert_close(ours, ref, 1e-5, 1e-3)


# ---------------------------------------------------------------------------
# The solo solvers' shifted phase, against wavetpu's.


def test_guarded_amax_per_lane_matches_wavetpu():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 5, 6, 7)).astype(np.float32)
    a[1, 0, 0, 0] = np.nan
    a[2, 1, 2, 3] = -np.inf
    a[3] *= 1e3
    got = health.guarded_amax_per_lane(torch.from_numpy(a))
    want = jhealth.guarded_amax_per_lane(jnp.asarray(a))
    assert got.dtype == np.float64 and got.shape == (4,)
    assert np.array_equal(got, want)
    assert got[1] == got[2] == np.inf
    assert got[0] == health.guarded_amax(torch.from_numpy(a[0]))


def test_default_phase_is_the_reference_program(problem):
    a = leapfrog.solve(problem, device="cpu")
    b = leapfrog.solve(problem, device="cpu", phase=2.0 * np.pi)
    assert torch.equal(a.u_cur, b.u_cur)
    assert np.array_equal(a.abs_errors, b.abs_errors)


def test_shifted_phase_errors_stay_discretization_small():
    p = Problem(N=32, timesteps=20)
    ref = leapfrog.solve(p, device="cpu").abs_errors.max()
    for ph in (1.0, 0.5, 5.98):
        e = leapfrog.solve(p, device="cpu", phase=ph).abs_errors.max()
        assert e < 10 * ref, f"phase={ph}: {e} vs ref {ref}"
    e = kfused.solve_kfused(p, k=4, device="cpu", phase=1.0)
    assert e.abs_errors.max() < 1e-2


def test_analytic_increment_layer1_is_a_pure_product(problem):
    v1 = leapfrog.analytic_increment_layer1(problem, torch.float64, "cpu",
                                            1.0)
    u1 = leapfrog.analytic_layer(problem, torch.float64, "cpu", 1.0, 1)
    u0 = leapfrog.initial_layer0(problem, torch.float64, "cpu", 1.0)
    assert np.max(np.abs((u1 - u0 - v1).numpy())) < 1e-15
    assert not v1[:, 0, :].any() and not v1[:, :, 0].any()


def test_solo_solvers_refuse_a_shifted_phase_where_wavetpu_does(problem,
                                                                field):
    kw = dict(compute_errors=False, c2tau2_field=field, phase=1.0,
              device="cpu")
    for fn in (leapfrog.solve, lambda p, **a: kfused.solve_kfused(p, k=4, **a),
               lambda p, **a: kfused_comp.solve_kfused_comp(p, k=4, **a)):
        with pytest.raises(ValueError, match="analytic"):
            fn(problem, **kw)
    with pytest.raises(ValueError, match="reference phase"):
        sharded.solve_sharded(problem, (2, 1, 1), devices=["cpu"] * 2,
                              scheme="compensated", phase=1.0)


# ---------------------------------------------------------------------------
# Validation (wavetpu's TestValidation) and the capability table
# (wavetpu's TestFallbacks).


@pytest.mark.parametrize("kw,match", [
    (dict(lanes=[]), "at least one lane"),
    (dict(path="cuda"), "path"),
    (dict(scheme="kahan"), "scheme"),
    (dict(lanes=[eb.LaneSpec(stop_step=99)]), "stop_step"),
    (dict(lanes=[eb.LaneSpec(stop_step=0)]), "stop_step"),
    (dict(lanes=[eb.LaneSpec(stop_step=4)], path="kfused", k=2), "k-block"),
    (dict(path="kfused", k=3), "divide"),
    (dict(path="kfused", k=16), "k <= 8"),
    (dict(pad_to=2), "pad_to"),
])
def test_validation(problem, lanes, kw, match):
    kw = dict(dict(lanes=lanes, path="roll"), **kw)
    with pytest.raises(ValueError, match=match):
        eb.solve_ensemble(problem, kw.pop("lanes"), device="cpu", **kw)


def test_field_batch_validation(problem, field):
    with pytest.raises(ValueError, match="analytic"):
        eb.solve_ensemble(problem, [eb.LaneSpec(c2tau2_field=field,
                                                phase=1.0)],
                          compute_errors=False, device="cpu")
    with pytest.raises(ValueError, match="oracle"):
        eb.solve_ensemble(problem, [eb.LaneSpec(c2tau2_field=field)],
                          device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eb.solve_ensemble(problem, [eb.LaneSpec(
            c2tau2_field=np.ones((4, 4, 4)))], compute_errors=False,
            device="cpu")
    with pytest.raises(ValueError, match="compensated"):
        eb.solve_ensemble(problem, [eb.LaneSpec(c2tau2_field=field)],
                          scheme="compensated", compute_errors=False,
                          device="cpu")


def test_solver_geometry_is_checked(problem, lanes):
    s = eb.EnsembleSolver(problem, 2, device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        eb.solve_ensemble(problem, lanes, device="cpu", solver=s)
    with pytest.raises(ValueError, match="bf16|f32/f64"):
        eb.EnsembleSolver(problem, 2, dtype=torch.bfloat16,
                          scheme="compensated", device="cpu")


def test_default_device_is_cuda(problem, lanes):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        eb.solve_ensemble(problem, lanes)


def test_capability_table_covers_every_wired_batch():
    eb._PROBE_CACHE.clear()
    try:
        for scheme, path in SCHEME_PATHS:
            assert eb.vmap_capability(path, scheme=scheme) == (True, None)
        for path in ("roll", "pallas", "kfused"):
            assert eb.vmap_capability(path, with_field=True) == (True, None)
        ok, why = eb.vmap_capability("roll", with_field=True,
                                     scheme="compensated")
        assert not ok and "compensated" in why
        assert eb.vmap_capability("roll", device="cpu") == (True, None)
        probes = eb.probe_results()
        assert len(probes) == 11
        assert set(probes[0]) == {"scheme", "path", "with_field",
                                  "interpret", "backend", "ok", "reason"}
        assert {p["backend"] for p in probes} == {"cuda", "cpu"}
    finally:
        eb._PROBE_CACHE.clear()


def test_lane_loop_fallback_records_its_reason(problem, lanes, monkeypatch):
    monkeypatch.setattr(eb, "vmap_capability",
                        lambda *a, **k: (False, "forced-by-test"))
    res = eb.solve_ensemble(problem, lanes, path="roll", device="cpu")
    assert res.batched is False and "forced-by-test" in res.fallback_reason
    assert res.u_cur_batch is None
    # The lane loop is the solo solves, lane identity and all.
    for lane, got in zip(lanes, res.results):
        want = solo(problem, "standard", "roll", lane)
        assert torch.equal(got.u_cur, want.u_cur)
        assert np.array_equal(got.abs_errors, want.abs_errors)


def test_compensated_lane_loop_honors_phase(problem, monkeypatch):
    monkeypatch.setattr(eb, "vmap_capability",
                        lambda *a, **k: (False, "forced-by-test"))
    lane = eb.LaneSpec(phase=1.0)
    res = eb.solve_ensemble(problem, [lane], scheme="compensated",
                            path="kfused", k=2, device="cpu")
    assert res.batched is False
    assert torch.equal(res.results[0].u_cur,
                       solo(problem, "compensated", "kfused", lane, 2).u_cur)


# ---------------------------------------------------------------------------
# Result shape.


def test_aggregate_throughput_sums_lanes(problem, lanes):
    res = eb.solve_ensemble(problem, lanes, path="roll", device="cpu")
    cells = sum(problem.cells_per_step * ln.stop(problem) for ln in lanes)
    assert res.aggregate_gcells_per_second == pytest.approx(
        cells / res.solve_seconds / 1e9)


def test_error_arrays_trimmed_to_lane_stop(problem, lanes):
    res = eb.solve_ensemble(problem, lanes, path="kfused", device="cpu")
    assert len(res.results[2].abs_errors) == 5 + 1
    assert res.results[2].steps_computed == 5
    assert res.results[0].abs_errors.shape == (10,)
    assert eb.LaneSpec().stop(problem) == problem.timesteps
    assert eb.padding_lane().stop_step == 1
