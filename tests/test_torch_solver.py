"""The port's solvers against wavetpu's, on the CPU (the kernels' plain
versions run; wavetpu runs its Pallas kernels in interpret mode).

Tolerances: f64 <= 1e-12; f32 <= 1e-5 per solve (XLA-CPU's FMA
contraction differs from torch's separately rounded ops by about 1 ulp
per layer); the flagship against an f64 reference < 1e-6, the contract of
tests/test_kfused_comp.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.kernels import stencil_pallas as jpallas
from wavetpu.solver import kfused_comp as jkfc
from wavetpu.solver import leapfrog as jlf
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io.state import from_numpy_state, to_tensor
from wavetpu_torch.kernels import stencil_cuda
from wavetpu_torch.solver import kfused_comp, leapfrog

CASE = dict(N=16, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=10)
DT = [(torch.float32, jnp.float32, 1e-5), (torch.float64, jnp.float64, 1e-12)]


def np64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x, jnp.float64))


def maxdiff(a, b):
    return float(np.max(np.abs(np64(a) - np64(b))))


@pytest.fixture(scope="module")
def jstep():
    return jpallas.make_step_fn(interpret=True)


@pytest.mark.parametrize("dt,jdt,tol", DT)
def test_solve_matches_wavetpu(dt, jdt, tol, jstep):
    ours = leapfrog.solve(Problem(**CASE), dtype=dt, device="cpu")
    ref = jlf.solve(JProblem(**CASE), dtype=jdt, step_fn=jstep)
    assert ours.u_cur.dtype == dt and ours.u_cur.device.type == "cpu"
    assert maxdiff(ours.u_cur, ref.u_cur) <= tol
    assert maxdiff(ours.u_prev, ref.u_prev) <= tol
    assert ours.abs_errors.shape == ref.abs_errors.shape == (11,)
    assert ours.abs_errors[0] == 0.0
    assert np.max(np.abs(ours.abs_errors - ref.abs_errors)) <= tol


def test_solve_stop_step_and_no_errors(jstep):
    p = Problem(**CASE)
    ours = leapfrog.solve(p, stop_step=4, compute_errors=False, device="cpu")
    ref = jlf.solve(JProblem(**CASE), stop_step=4, compute_errors=False,
                    step_fn=jstep)
    assert ours.final_step == 4 and ours.abs_errors.shape == (5,)
    assert not ours.abs_errors.any()
    assert maxdiff(ours.u_cur, ref.u_cur) <= 1e-5
    assert ours.gcells_per_second > 0


@pytest.mark.parametrize("dt,jdt,tol", DT)
def test_solve_compensated_matches_wavetpu(dt, jdt, tol):
    ours = leapfrog.solve_compensated(Problem(**CASE), dtype=dt,
                                      device="cpu")
    ref = jlf.solve_compensated(
        JProblem(**CASE), dtype=jdt,
        comp_step_fn=jpallas.make_compensated_step_fn(interpret=True),
    )
    for a, b in ((ours.u_cur, ref.u_cur), (ours.u_prev, ref.u_prev),
                 (ours.comp_v, ref.comp_v)):
        assert maxdiff(a, b) <= tol
    assert np.max(np.abs(ours.abs_errors - ref.abs_errors)) <= tol


FLAG = dict(N=16, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=11)


@pytest.mark.parametrize("dt,jdt,tol", DT)
def test_flagship_matches_wavetpu(dt, jdt, tol):
    # 10 layers after the bootstrap: two k=4 blocks and a k=1 tail of 2.
    ours = kfused_comp.solve_kfused_comp(Problem(**FLAG), dtype=dt, k=4,
                                         block_x=8, device="cpu")
    ref = jkfc.solve_kfused_comp(JProblem(**FLAG), dtype=jdt, k=4,
                                 block_x=8, interpret=True)
    for a, b in ((ours.u_cur, ref.u_cur), (ours.u_prev, ref.u_prev),
                 (ours.comp_v, ref.comp_v), (ours.comp_carry, ref.comp_carry)):
        assert a.dtype == ({torch.float32: torch.bfloat16}.get(dt, dt)
                           if a is ours.comp_carry else dt)
        assert maxdiff(a, b) <= tol
    assert ours.abs_errors.shape == (12,)
    assert np.max(np.abs(ours.abs_errors - ref.abs_errors)) <= tol
    # rel = abs / |analytic|: relative, so held to a relative tolerance
    # (f32 per-layer abs differences ~1e-8 on errors ~1e-5).
    np.testing.assert_allclose(ours.rel_errors, ref.rel_errors,
                               rtol=1e-3 if dt == torch.float32 else 1e-9)


def test_flagship_bf16_increment_mode_matches_wavetpu():
    ours = kfused_comp.solve_kfused_comp(
        Problem(**FLAG), k=2, block_x=4, v_dtype=torch.bfloat16, carry=False,
        device="cpu")
    ref = jkfc.solve_kfused_comp(
        JProblem(**FLAG), k=2, block_x=4, v_dtype=jnp.bfloat16, carry=False,
        interpret=True)
    assert ours.comp_carry is None and ours.comp_v.dtype == torch.bfloat16
    assert maxdiff(ours.u_cur, ref.u_cur) <= 1e-5
    assert np.max(np.abs(ours.abs_errors - ref.abs_errors)) <= 1e-5


def test_flagship_f64_tolerance_parity():
    case = dict(N=32, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=21)
    ck4 = kfused_comp.solve_kfused_comp(Problem(**case), k=4, device="cpu")
    ref64 = jlf.solve(JProblem(**case), dtype=jnp.float64)
    assert maxdiff(ck4.u_cur, ref64.u_cur) < 1e-6
    assert np.isfinite(ck4.abs_errors).all()


def test_flagship_validation():
    p = Problem(**FLAG)
    with pytest.raises(ValueError):
        kfused_comp.solve_kfused_comp(p, k=1, device="cpu")
    with pytest.raises(ValueError):
        kfused_comp.solve_kfused_comp(p, k=3, device="cpu")  # 3 does not divide 16
    with pytest.raises(ValueError):
        kfused_comp.solve_kfused_comp(p, k=16, device="cpu")
    with pytest.raises(ValueError):
        kfused_comp.solve_kfused_comp(p, v_dtype=torch.bfloat16,
                                      device="cpu")  # carry needs f32 v
    with pytest.raises(ValueError):
        kfused_comp.solve_kfused_comp(p, carry_dtype=torch.float16,
                                      device="cpu")


def test_convergence_second_order():
    """Halving h and tau together divides the error by ~4."""
    e = []
    for n, ts in [(16, 32), (32, 64)]:
        res = leapfrog.solve(Problem(N=n, timesteps=ts), dtype=torch.float64,
                             device="cpu")
        e.append(res.abs_errors[-1])
    ratio = e[0] / e[1]
    assert 3.0 < ratio < 5.0, f"convergence ratio {ratio}"


@pytest.mark.parametrize("dt,jdt,tol", DT)
def test_resume_from_wavetpu_state(dt, jdt, tol, jstep):
    jp = JProblem(**CASE)
    mid = jlf.solve(jp, dtype=jdt, step_fn=jstep, stop_step=4)
    full = jlf.solve(jp, dtype=jdt, step_fn=jstep)
    u_prev, u_cur, _, _ = from_numpy_state(
        np.asarray(mid.u_prev), np.asarray(mid.u_cur), device="cpu")
    ours = leapfrog.resume(Problem(**CASE), u_prev, u_cur, 4, dtype=dt,
                           device="cpu")
    assert maxdiff(ours.u_cur, full.u_cur) <= tol
    assert ours.steps_computed == 6 and ours.final_step == 10
    assert not ours.abs_errors[:5].any()
    assert np.max(np.abs(ours.abs_errors[5:] - full.abs_errors[5:])) <= tol


def test_state_handover_keeps_bf16_bits():
    carry = jnp.asarray(
        np.random.default_rng(3).standard_normal((4, 4, 4)) * 1e-8,
        jnp.bfloat16)
    host = np.asarray(carry)  # ml_dtypes.bfloat16: torch.from_numpy refuses it
    with pytest.raises(TypeError):
        torch.from_numpy(host.copy())
    t = to_tensor(host, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  host.view(np.int16))
    res = jkfc.solve_kfused_comp(JProblem(**FLAG), k=4, interpret=True,
                                 stop_step=5)
    u_prev, u_cur, v, c = from_numpy_state(
        np.asarray(res.u_prev), np.asarray(res.u_cur),
        np.asarray(res.comp_v), np.asarray(res.comp_carry), device="cpu")
    assert c.dtype == torch.bfloat16 and v.dtype == torch.float32
    assert torch.equal(c.float(), torch.from_numpy(
        np.asarray(res.comp_carry, np.float32)))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert leapfrog.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            leapfrog.solve(Problem(**CASE))


INIT_FNS = {
    "analytic_layer": lambda p, **kw: (leapfrog.analytic_layer(p, n=3, **kw),),
    "initial_layer0": lambda p, **kw: (leapfrog.initial_layer0(p, **kw),),
    "initial_state": lambda p, **kw: leapfrog.initial_state(p, **kw),
}
JINIT_FNS = {
    "analytic_layer": lambda p, **kw: (jlf.analytic_layer(p, n=3, **kw),),
    "initial_layer0": lambda p, **kw: (jlf.initial_layer0(p, **kw),),
    "initial_state": lambda p, **kw: jlf.initial_state(p, **kw),
}


@pytest.mark.parametrize("name", list(INIT_FNS))
def test_init_defaults_to_cuda(name):
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda"
                   for t in INIT_FNS[name](Problem(**CASE)))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            INIT_FNS[name](Problem(**CASE))


@pytest.mark.parametrize("name", list(INIT_FNS))
@pytest.mark.parametrize("dt,jdt,tol", DT)
def test_init_matches_wavetpu(name, dt, jdt, tol):
    ours = INIT_FNS[name](Problem(**CASE), dtype=dt, device="cpu")
    ref = JINIT_FNS[name](JProblem(**CASE), dtype=jdt)
    for a, b in zip(ours, ref):
        assert a.dtype == dt and a.device.type == "cpu"
        assert maxdiff(a, b) <= tol


def test_cpu_solves_launch_no_kernel():
    stencil_cuda.reset_launches()
    leapfrog.solve(Problem(**CASE), device="cpu")
    kfused_comp.solve_kfused_comp(Problem(**FLAG), device="cpu")
    assert all(v == 0 for v in stencil_cuda.launches.values())


# ---------------------------------------------------------------------------
# The shifted phase (the ensembles' lane identity): the analytic layer-1
# start, against wavetpu's `phase=` solves.  rel errors are held at odd N
# only: at even N the x = N/2 plane holds sin(pi) ~ 1e-16, and the rel
# error there is a ratio of rounding noise (ROADMAP.md queue 3).

PHASED = dict(CASE, N=15)


@pytest.mark.parametrize("dt,jdt,tol", DT)
@pytest.mark.parametrize("phase", [1.0, 0.5])
def test_shifted_phase_matches_wavetpu(dt, jdt, tol, phase, jstep):
    ours = leapfrog.solve(Problem(**PHASED), dtype=dt, device="cpu",
                          phase=phase, stop_step=7)
    ref = jlf.solve(JProblem(**PHASED), dtype=jdt, step_fn=jstep,
                    phase=phase, stop_step=7)
    assert maxdiff(ours.u_cur, ref.u_cur) <= tol
    assert maxdiff(ours.u_prev, ref.u_prev) <= tol
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(ours.rel_errors, ref.rel_errors,
                               rtol=1e-3 if dt == torch.float32 else 1e-9,
                               atol=tol)


@pytest.mark.parametrize("dt,jdt,tol", DT)
def test_shifted_phase_compensated_matches_wavetpu(dt, jdt, tol):
    ours = leapfrog.solve_compensated(Problem(**PHASED), dtype=dt,
                                      device="cpu", phase=1.0)
    ref = jlf.solve_compensated(
        JProblem(**PHASED), dtype=jdt, phase=1.0,
        comp_step_fn=jpallas.make_compensated_step_fn(interpret=True))
    for a, b in ((ours.u_cur, ref.u_cur), (ours.u_prev, ref.u_prev),
                 (ours.comp_v, ref.comp_v), (ours.comp_carry, ref.comp_carry)):
        assert maxdiff(a, b) <= tol
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("dt,jdt,tol", DT)
def test_shifted_phase_flagship_matches_wavetpu(dt, jdt, tol):
    ours = kfused_comp.solve_kfused_comp(Problem(**FLAG), dtype=dt, k=4,
                                         block_x=8, device="cpu", phase=1.0)
    ref = jkfc.solve_kfused_comp(JProblem(**FLAG), dtype=jdt, k=4,
                                 block_x=8, interpret=True, phase=1.0)
    for a, b in ((ours.u_cur, ref.u_cur), (ours.u_prev, ref.u_prev),
                 (ours.comp_v, ref.comp_v), (ours.comp_carry, ref.comp_carry)):
        assert maxdiff(a, b) <= tol
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(ours.rel_errors, ref.rel_errors,
                               rtol=1e-3 if dt == torch.float32 else 1e-9,
                               atol=tol)


@pytest.mark.parametrize("dt,jdt,tol", DT)
@pytest.mark.parametrize("n", [0, 1])
def test_analytic_layers_match_wavetpu(dt, jdt, tol, n):
    p, jp = Problem(**CASE), JProblem(**CASE)
    assert maxdiff(leapfrog.analytic_layer(p, dt, "cpu", 0.5, n),
                   jlf.analytic_layer(jp, jdt, 0.5, n)) <= tol
    assert maxdiff(leapfrog.analytic_increment_layer1(p, dt, "cpu", 0.5),
                   jlf.analytic_increment_layer1(jp, jdt, 0.5)) <= tol
