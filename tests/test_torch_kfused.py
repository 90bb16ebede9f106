"""The port's standard k-fused march (K3, solver/kfused.py) against
wavetpu's, on the CPU.

Inputs come from a numpy seed and go through both packages: K3's plain
version (what a CPU tensor runs; `stencil_cuda.fused_kstep`) against
wavetpu's Pallas kernel in interpret mode, and the port's `solve_kfused`
against wavetpu's.  The port's own k-fused solve equals its 1-step solve
bit for bit, the contract wavetpu states for the standard onion
(stencil_pallas.py:750-755).

Tolerances against wavetpu: f32 within 2k ulp of the peak after k
substeps - XLA-CPU contracts a multiply-add into an FMA where torch rounds
twice (1 ulp at the peak per substep), and the next substep's 2u term
carries an earlier difference forward doubled at most; bf16 states within
one bf16 ulp of their value (a 1-ulp f32 difference before the cast can
flip the rounding); f64 within 1e-12.  The kernel itself is held bitwise
against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.kernels import stencil_pallas as jpallas
from wavetpu.kernels import stencil_ref as jref
from wavetpu.solver import kfused as jkfused
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, leapfrog

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float64: jnp.float64}


def state(seed, n):
    a = np.random.default_rng(seed).standard_normal((n, n, n))
    a[:, 0, :] = 0.0
    a[:, :, 0] = 0.0
    return a.astype(np.float32)


def c2_field(p, seed):
    """A positive tau^2 c^2 field around a2tau2 (0.5x to 1.5x)."""
    rng = np.random.default_rng(seed)
    return (p.a2tau2 * (0.5 + rng.random((p.N,) * 3))).astype(np.float32)


def as64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x, jnp.float64))


def ulps_of_peak(a, b):
    a, b = as64(a), as64(b)
    peak = np.max(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a - b)) / np.spacing(np.float32(peak)))


def assert_bf16_close(a, b):
    a, b = as64(a), as64(b)
    assert np.all(np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7)


def k3_inputs(n, k, nstart=3):
    p = Problem(N=n, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cpu")
    sxct = ct[nstart + 1: nstart + 1 + k][:, None] * sx[None, :]
    return p, JProblem(N=n, timesteps=20), syz, rsyz, sxct


def run_both(n, k, dtype, with_field, with_errors):
    p, jp, syz, rsyz, sxct = k3_inputs(n, k)
    up, u = state(1, n), state(2, n)
    fld = c2_field(p, 3) if with_field else None
    ours = stencil_cuda.fused_kstep(
        torch.from_numpy(up).to(dtype), torch.from_numpy(u).to(dtype),
        syz, rsyz, sxct, k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
        c2tau2_field=None if fld is None else torch.from_numpy(fld),
        with_errors=with_errors,
    )
    ref = jpallas.fused_kstep(
        jnp.asarray(up, JDT[dtype]), jnp.asarray(u, JDT[dtype]),
        jnp.asarray(syz.numpy()), jnp.asarray(rsyz.numpy()),
        jnp.asarray(sxct.numpy()), k=k, coeff=jp.a2tau2, inv_h2=jp.inv_h2,
        c2tau2_field=None if fld is None else jnp.asarray(fld),
        with_errors=with_errors, interpret=True,
    )
    return ours, ref


class TestK3Plain:
    # N=15 with k=3 and 5: odd N and k | N, as wavetpu's own K3 tests.
    @pytest.mark.parametrize("with_field", [False, True],
                             ids=["const", "field"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n,k", [(16, 2), (16, 4), (15, 3), (15, 5)])
    def test_matches_interpret_kernel(self, n, k, dtype, with_field):
        ours, ref = run_both(n, k, dtype, with_field, True)
        for a, b in zip(ours[:2], ref[:2]):
            assert a.dtype == dtype and a.shape == (n, n, n)
            if dtype == torch.bfloat16:
                assert_bf16_close(a, b)
            else:
                assert ulps_of_peak(a, b) <= 2 * k
        # Error rows: (k, N) f32 per-substep per-x-plane maxes.
        for a, b in zip(ours[2:], ref[2:]):
            assert a.shape == (k, n) and a.dtype == torch.float32
            assert ulps_of_peak(a, b) <= 2 * k

    @pytest.mark.parametrize("dtype,with_field", [
        (torch.float32, True), (torch.bfloat16, False)])
    def test_without_errors(self, dtype, with_field):
        ours, ref = run_both(15, 3, dtype, with_field, False)
        assert ours[2] is None and ours[3] is None
        assert ref[2] is None and ref[3] is None
        if dtype == torch.bfloat16:
            assert_bf16_close(ours[1], ref[1])
        else:
            assert ulps_of_peak(ours[1], ref[1]) <= 6

    def test_equals_k_one_step_kernels(self):
        # Op for op K1: k plain K1 steps give the same bits (K5 with a
        # field), the bf16 round trip included.
        p, _, syz, rsyz, sxct = k3_inputs(16, 4)
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            for fld in (None, torch.from_numpy(c2_field(p, 5)).to(
                    stencil_ref.compute_dtype(dtype))):
                up = torch.from_numpy(state(6, 16)).to(dtype)
                u = torch.from_numpy(state(7, 16)).to(dtype)
                got = stencil_cuda.fused_kstep(
                    up, u, syz, rsyz, sxct, k=4, coeff=p.a2tau2,
                    inv_h2=p.inv_h2, c2tau2_field=fld, with_errors=False)
                step = stencil_cuda.make_step_fn(fld)
                for _ in range(4):
                    up, u = u, step(up, u, p)
                assert torch.equal(got[0], up) and torch.equal(got[1], u)

    def test_nan_propagates_into_error_rows(self):
        p, _, syz, rsyz, sxct = k3_inputs(16, 2)
        u = torch.from_numpy(state(8, 16))
        u[5, 3, 3] = float("nan")
        out = stencil_cuda.fused_kstep(u, u, syz, rsyz, sxct, k=2,
                                       coeff=p.a2tau2, inv_h2=p.inv_h2)
        assert torch.isnan(out[2][0, 5]) and torch.isnan(out[3][0, 5])

    def test_k_must_divide_n(self):
        p, _, syz, rsyz, sxct = k3_inputs(16, 3)
        u = torch.from_numpy(state(9, 16))
        with pytest.raises(ValueError):
            stencil_cuda.fused_kstep(u, u, syz, rsyz, sxct, k=3, coeff=1.0,
                                     inv_h2=p.inv_h2)

    def test_cpu_tensors_count_no_launch(self):
        stencil_cuda.reset_launches()
        p, _, syz, rsyz, sxct = k3_inputs(16, 2)
        u = torch.from_numpy(state(10, 16))
        stencil_cuda.fused_kstep(u, u, syz, rsyz, sxct, k=2, coeff=1e-3,
                                 inv_h2=p.inv_h2)
        assert all(v == 0 for v in stencil_cuda.launches.values())


class TestSolveKfused:
    @pytest.mark.parametrize("with_field", [False, True],
                             ids=["const", "field"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.float64])
    @pytest.mark.parametrize("n,k,steps", [(16, 4, 14), (15, 5, 13)])
    def test_equals_one_step_solve_bitwise(self, n, k, steps, dtype,
                                           with_field):
        p = Problem(N=n, timesteps=steps)
        if with_field:
            fld = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
            a = kfused.solve_kfused(p, dtype, k, compute_errors=False,
                                    c2tau2_field=fld, device="cpu")
            b = leapfrog.solve(p, dtype, compute_errors=False,
                               c2tau2_field=fld, device="cpu")
        else:
            a = kfused.solve_kfused(p, dtype, k, device="cpu")
            b = leapfrog.solve(p, dtype, device="cpu")
            # In-kernel rows vs full-field errors: the same maxima up to the
            # multiply order of the oracle (sxct*syz vs (sx*sy*sz)*ct).
            np.testing.assert_allclose(a.abs_errors, b.abs_errors,
                                       rtol=0, atol=1e-6)
        assert a.u_cur.dtype == dtype
        assert torch.equal(a.u_cur, b.u_cur)
        assert torch.equal(a.u_prev, b.u_prev)

    # wavetpu's f64 onion cannot store its f64 row maxima into the f32
    # rows under this jax (interpret mode refuses the swap), so the f64
    # case runs without errors on both sides.
    @pytest.mark.parametrize("dtype,tol,errors", [
        (torch.float32, 2e-6, True), (torch.bfloat16, 1e-2, True),
        (torch.float64, 1e-12, False)])
    def test_matches_wavetpu(self, dtype, tol, errors):
        p, jp = Problem(N=12, timesteps=11), JProblem(N=12, timesteps=11)
        ours = kfused.solve_kfused(p, dtype, k=4, compute_errors=errors,
                                   device="cpu")
        ref = jkfused.solve_kfused(jp, JDT[dtype], k=4, interpret=True,
                                   compute_errors=errors)
        assert np.max(np.abs(as64(ours.u_cur) - as64(ref.u_cur))) <= tol
        assert np.max(np.abs(as64(ours.u_prev) - as64(ref.u_prev))) <= tol
        assert np.max(np.abs(ours.abs_errors - np.asarray(ref.abs_errors))) \
            <= tol
        assert ours.abs_errors.shape == (12,)
        assert (ours.abs_errors.max() > 0) == errors

    def test_stop_step_and_launch_plan(self):
        # 1 bootstrap + (nsteps-1)//k blocks + (nsteps-1)%k tail layers;
        # stop_step cuts the march as wavetpu's does.
        p = Problem(N=16, timesteps=14)
        full = kfused.solve_kfused(p, k=4, device="cpu")
        part = kfused.solve_kfused(p, k=4, stop_step=9, device="cpu")
        one = leapfrog.solve(p, stop_step=9, device="cpu")
        assert part.final_step == 9 and part.abs_errors.shape == (10,)
        assert torch.equal(part.u_cur, one.u_cur)
        np.testing.assert_array_equal(part.abs_errors, full.abs_errors[:10])

    @pytest.mark.parametrize("kwargs", [
        dict(k=1), dict(k=9), dict(k=3),
        dict(k=4, c2tau2_field=np.ones((16,) * 3))],
        ids=["k1", "k9", "k-not-dividing", "field-with-errors"])
    def test_validation(self, kwargs):
        with pytest.raises(ValueError):
            kfused.solve_kfused(Problem(N=16, timesteps=8), device="cpu",
                                **kwargs)

    def test_bootstrap_is_the_taylor_half_step(self):
        # Layer 1 derived from K1 equals wavetpu's reference half-step to
        # rounding.
        p = Problem(N=15, timesteps=1)
        r = kfused.solve_kfused(p, torch.float64, k=3, device="cpu")
        u0 = leapfrog.initial_layer0(p, torch.float64, "cpu")
        ref = jref.taylor_half_step(jnp.asarray(u0.numpy()),
                                    JProblem(N=15, timesteps=1))
        assert np.max(np.abs(r.u_cur.numpy() - np.asarray(ref))) <= 1e-12


# ---------------------------------------------------------------------------
# The shifted phase: the analytic layer-1 start of the k-fused march,
# against wavetpu's `phase=` solve (rel errors at odd N only:
# tests/test_torch_solver.py's note).


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-6),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("phase", [1.0, 0.5])
def test_shifted_phase_matches_wavetpu(dtype, tol, phase):
    p, jp = Problem(N=12, timesteps=11), JProblem(N=12, timesteps=11)
    ours = kfused.solve_kfused(p, dtype, k=4, device="cpu", phase=phase)
    ref = jkfused.solve_kfused(jp, JDT[dtype], k=4, interpret=True,
                               phase=phase)
    assert np.max(np.abs(as64(ours.u_cur) - as64(ref.u_cur))) <= tol
    assert np.max(np.abs(as64(ours.u_prev) - as64(ref.u_prev))) <= tol
    np.testing.assert_allclose(ours.abs_errors, np.asarray(ref.abs_errors),
                               rtol=0, atol=tol)


def test_shifted_phase_equals_one_step_solve_bitwise():
    p = Problem(N=12, timesteps=11)
    fused = kfused.solve_kfused(p, k=4, device="cpu", phase=1.0)
    one = leapfrog.solve(p, device="cpu", phase=1.0)
    assert torch.equal(fused.u_cur, one.u_cur)
    assert torch.equal(fused.u_prev, one.u_prev)
