"""The port's stencils against wavetpu's, on the CPU.

Inputs come from a numpy seed and go through both packages:
  * wavetpu_torch.kernels.stencil_ref vs wavetpu.kernels.stencil_ref;
  * the plain versions of the CUDA kernels K1, K2 and K4
    (wavetpu_torch.kernels.stencil_cuda - what a CPU tensor runs) vs the
    Pallas kernels in interpret mode (wavetpu.kernels.stencil_pallas).

Tolerances: f64 <= 1e-12 absolute; f32 <= 4 ulp of the field's peak per
kernel call (XLA-CPU may contract a multiply-add into an FMA where torch
rounds twice).  bf16 storage (K4's increment mode) is compared within one
bf16 ulp of its value, since a 1-ulp f32 difference before the cast can
flip the bf16 rounding.  The Kahan carry is the rounding residual of u'
(|carry'| <= ulp(u')/2), so no tolerance on the scale of u can tell it
from zero: it is held bitwise wherever u' and v' agree bitwise (the carry
is then a function of the same operands), and within one ulp of u' in
that cell elsewhere.  K4's u' and v' equal the interpret kernel's bit for
bit, so its carry is held bitwise everywhere.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
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
from wavetpu_torch.solver import kfused

N = 16
PROB = Problem(N=N, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=10)
JPROB = JProblem(N=N, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=10)
NPDT = {torch.float32: np.float32, torch.float64: np.float64}


def field(seed, dtype=np.float64, n=N, zero_planes=True):
    a = np.random.default_rng(seed).standard_normal((n, n, n))
    if zero_planes:
        a[:, 0, :] = 0.0
        a[:, :, 0] = 0.0
    return a.astype(dtype)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def as64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x, jnp.float64))


def max_ulp(a, b, dtype):
    """Largest |a - b| in ulps of the field's peak magnitude (a cell whose
    terms cancel keeps its operands' absolute rounding, not its own)."""
    a, b = as64(a), as64(b)
    peak = np.max(np.maximum(np.abs(a), np.abs(b)))
    scale = max(float(np.spacing(dtype(peak))), float(np.finfo(dtype).tiny))
    return float(np.max(np.abs(a - b)) / scale)


def assert_close(a, b, torch_dtype):
    if torch_dtype == torch.float64:
        assert np.max(np.abs(as64(a) - as64(b))) <= 1e-12
    else:
        assert max_ulp(a, b, np.float32) <= 4


def assert_bf16_close(a, b):
    """Stored bf16 values agree within one bf16 ulp of their magnitude."""
    a, b = as64(a), as64(b)
    ulp = np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7
    assert np.all(np.abs(a - b) <= ulp + 1e-30)


def assert_carry_close(ours, ref):
    """`ours`, `ref`: (u', v', carry') of the port and of wavetpu."""
    (u, v, c), (ru, rv, rc) = (tuple(as64(x) for x in o) for o in (ours, ref))
    same = (u == ru) & (v == rv)
    assert same.mean() >= 0.5
    np.testing.assert_array_equal(c[same], rc[same])
    dt = np.float64 if ours[0].dtype == torch.float64 else np.float32
    ulp_u = np.spacing(np.maximum(np.abs(u), np.abs(ru)).astype(dt))
    assert np.all(np.abs(c - rc)[~same] <= ulp_u[~same])


class TestStencilRef:
    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_laplacian(self, dt):
        u = field(0, NPDT[dt])
        ours = stencil_ref.laplacian(t(u), PROB.inv_h2)
        ref = jref.laplacian(jnp.asarray(u), JPROB.inv_h2)
        assert_close(ours, ref, dt)

    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_leapfrog_step(self, dt):
        up, u = field(1, NPDT[dt]), field(2, NPDT[dt])
        ours = stencil_ref.leapfrog_step(t(up), t(u), PROB)
        ref = jref.leapfrog_step(jnp.asarray(up), jnp.asarray(u), JPROB)
        assert_close(ours, ref, dt)

    def test_leapfrog_step_bf16_computes_in_f32(self):
        up, u = field(1, np.float32), field(2, np.float32)
        ours = stencil_ref.leapfrog_step(
            t(up).to(torch.bfloat16), t(u).to(torch.bfloat16), PROB
        )
        ref = jref.leapfrog_step(
            jnp.asarray(up, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16), JPROB
        )
        assert ours.dtype == torch.bfloat16
        assert_bf16_close(ours, ref)

    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_taylor_half_step(self, dt):
        u = field(3, NPDT[dt])
        ours = stencil_ref.taylor_half_step(t(u), PROB)
        ref = jref.taylor_half_step(jnp.asarray(u), JPROB)
        assert_close(ours, ref, dt)

    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_compensated_step(self, dt):
        u, v, c = (field(s, NPDT[dt]) * w for s, w in
                   ((4, 1.0), (5, 1e-3), (6, 1e-8)))
        ours = stencil_ref.compensated_step(t(u), t(v), t(c), PROB)
        ref = jref.compensated_step(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(c), JPROB
        )
        for a, b in zip(ours, ref):
            assert_close(a, b, dt)

    def test_apply_dirichlet_copies(self):
        u = t(field(7, zero_planes=False))
        before = u.clone()
        out = stencil_ref.apply_dirichlet(u)
        assert torch.equal(u, before)
        assert (out[:, 0, :] == 0).all() and (out[:, :, 0] == 0).all()
        assert torch.equal(out[:, 1:, 1:], u[:, 1:, 1:])

    def test_compute_dtype(self):
        assert stencil_ref.compute_dtype(torch.bfloat16) == torch.float32
        assert stencil_ref.compute_dtype(torch.float64) == torch.float64


class TestK1Plain:
    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_leapfrog_step(self, dt):
        up, u = field(10, NPDT[dt]), field(11, NPDT[dt], zero_planes=False)
        ours = stencil_cuda.leapfrog_step(t(up), t(u), PROB)
        ref = jpallas.leapfrog_step(jnp.asarray(up), jnp.asarray(u), JPROB,
                                    interpret=True)
        assert ours.dtype == dt
        assert_close(ours, ref, dt)

    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_taylor_half_step(self, dt):
        u = field(12, NPDT[dt])
        ours = stencil_cuda.taylor_half_step(t(u), PROB)
        ref = jpallas.taylor_half_step(jnp.asarray(u), JPROB, interpret=True)
        assert_close(ours, ref, dt)

    def test_bf16_state(self):
        up, u = field(13, np.float32), field(14, np.float32)
        ours = stencil_cuda.leapfrog_step(
            t(up).to(torch.bfloat16), t(u).to(torch.bfloat16), PROB
        )
        ref = jpallas.leapfrog_step(
            jnp.asarray(up, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16),
            JPROB, interpret=True,
        )
        assert ours.dtype == torch.bfloat16
        assert_bf16_close(ours, ref)

    def test_pallas_op_order_differs_from_ref_by_rounding_only(self):
        up, u = field(15), field(16)
        a = stencil_cuda.leapfrog_step(t(up), t(u), PROB)
        b = stencil_ref.leapfrog_step(t(up), t(u), PROB)
        assert np.max(np.abs(as64(a) - as64(b))) <= 1e-12


class TestK2Plain:
    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_step(self, dt):
        u, v, c = (field(s, NPDT[dt]) * w for s, w in
                   ((20, 1.0), (21, 1e-3), (22, 1e-8)))
        ours = stencil_cuda.compensated_step(t(u), t(v), t(c), PROB)
        ref = jpallas.compensated_step(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(c), JPROB,
            interpret=True,
        )
        for a, b in zip(ours[:2], ref[:2]):
            assert a.dtype == dt
            assert_close(a, b, dt)
        assert ours[2].dtype == dt
        assert_carry_close(ours, ref)

    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_bootstrap_half_coeff_zero_v_carry(self, dt):
        u = field(23, NPDT[dt])
        z = np.zeros_like(u)
        half = 0.5 * PROB.a2tau2
        ours = stencil_cuda.compensated_step(t(u), t(z), t(z), PROB, half)
        ref = jpallas.compensated_step(
            jnp.asarray(u), jnp.asarray(z), jnp.asarray(z), JPROB, half,
            interpret=True,
        )
        for a, b in zip(ours[:2], ref[:2]):
            assert_close(a, b, dt)
        assert torch.count_nonzero(ours[2]) > 0
        assert_carry_close(ours, ref)


def _oracle_inputs(k, f=torch.float32, nstart=3):
    """syz / rsyz / sxct as the flagship march builds them, in both
    packages (same host-f64 factors, cast once)."""
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(PROB, f, "cpu")
    ctk = ct[nstart + 1: nstart + 1 + k]
    sxct = ctk[:, None] * sx[None, :]
    return syz, rsyz, sxct


# (k, block_x): k=2 with a 4-plane slab checks the carry zero-seeding at
# a second slab depth.
K_BX = [(1, 8), (2, 4), (4, 8)]
MODES = {
    "f32v_bf16carry": (torch.float32, torch.bfloat16),
    "f32v_f32carry": (torch.float32, torch.float32),
    "bf16v_nocarry": (torch.bfloat16, None),
}


class TestK4Plain:
    @pytest.mark.parametrize("mode", list(MODES))
    @pytest.mark.parametrize("k,bx", K_BX)
    def test_matches_interpret_kernel(self, k, bx, mode):
        v_dt, c_dt = MODES[mode]
        u = field(30, np.float32)
        v = (field(31) * 1e-3).astype(np.float32)
        c = (field(32) * 1e-9).astype(np.float32)
        syz, rsyz, sxct = _oracle_inputs(k)
        tv = t(v).to(v_dt)
        tc = None if c_dt is None else t(c).to(c_dt)
        jv = jnp.asarray(v, jnp.bfloat16 if v_dt == torch.bfloat16
                         else jnp.float32)
        jc = None if c_dt is None else jnp.asarray(
            c, jnp.bfloat16 if c_dt == torch.bfloat16 else jnp.float32)
        ours = stencil_cuda.fused_kstep_comp(
            t(u), tv, tc, syz, rsyz, sxct, k=k, coeff=PROB.a2tau2,
            inv_h2=PROB.inv_h2, block_x=bx,
        )
        ref = jpallas.fused_kstep_comp(
            jnp.asarray(u), jv, jc, jnp.asarray(syz.numpy()),
            jnp.asarray(rsyz.numpy()), jnp.asarray(sxct.numpy()),
            k=k, coeff=JPROB.a2tau2, inv_h2=JPROB.inv_h2, block_x=bx,
            interpret=True,
        )
        assert_close(ours[0], ref[0], torch.float32)
        if v_dt == torch.bfloat16:
            assert ours[1].dtype == torch.bfloat16
            assert_bf16_close(ours[1], ref[1])
        else:
            assert_close(ours[1], ref[1], torch.float32)
        if c_dt is None:
            assert ours[2] is None and ref[2] is None
        else:
            assert ours[2].dtype == c_dt
            assert torch.count_nonzero(ours[2]) > 0
            assert_carry_close(ours[:3], ref[:3])
        # Error rows: (k, N) f32 per-substep per-x-plane maxes.
        for a, b in zip(ours[3:], ref[3:]):
            assert a.shape == (k, N) and a.dtype == torch.float32
            assert_close(a, b, torch.float32)

    def test_without_errors(self):
        syz, rsyz, sxct = _oracle_inputs(2)
        u = t(field(33, np.float32))
        out = stencil_cuda.fused_kstep_comp(
            u, torch.zeros_like(u), None, syz, rsyz, sxct, k=2,
            coeff=PROB.a2tau2, inv_h2=PROB.inv_h2, with_errors=False,
        )
        assert out[3] is None and out[4] is None

    def test_nan_propagates_into_error_rows(self):
        # jnp.max propagates NaN; a blown-up run must report NaN.
        syz, rsyz, sxct = _oracle_inputs(2)
        u = field(34, np.float32)
        u[5, 3, 3] = np.nan
        out = stencil_cuda.fused_kstep_comp(
            t(u), torch.zeros_like(t(u)), None, syz, rsyz, sxct, k=2,
            coeff=PROB.a2tau2, inv_h2=PROB.inv_h2, block_x=8,
        )
        assert torch.isnan(out[3][0, 5]) and torch.isnan(out[4][0, 5])

    @pytest.mark.parametrize("n,k", [(512, 4), (512, 1), (16, 2), (15, 3), (64, 8)])
    def test_default_block_and_tile(self, n, k):
        bx = stencil_cuda.default_block_x(n, k)
        assert n % bx == 0 and bx % k == 0
        tx, ty, tz = stencil_cuda.kstep_tile(k, bx)
        assert bx % tx == 0 and tx <= 8 and ty >= 2
        assert (ty + 2 * k) * (tz + 2 * k) <= 640  # one thread per column
        assert 2 * (tx + 2 * k) * 640 * 4 <= 227 * 1024  # shared memory

    def test_invalid_block_raises(self):
        syz, rsyz, sxct = _oracle_inputs(4)
        u = t(field(35, np.float32))
        with pytest.raises(ValueError):
            stencil_cuda.fused_kstep_comp(
                u, u, None, syz, rsyz, sxct, k=4, coeff=1.0,
                inv_h2=PROB.inv_h2, block_x=6,
            )


class TestOracleHelpers:
    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_oracle_parts(self, dt):
        ours = kfused._oracle_parts(PROB, dt, "cpu")
        ref = jkfused._oracle_parts(
            JPROB, jnp.float32 if dt == torch.float32 else jnp.float64
        )
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_block_errors(self):
        rng = np.random.default_rng(40)
        dmax = rng.random((4, N)).astype(np.float32)
        rmax = rng.random((4, N)).astype(np.float32)
        dmax[1, 3] = np.nan
        _, ct, _, _, xmask, inv_absx = kfused._oracle_parts(
            PROB, torch.float32, "cpu")
        ours = kfused._block_errors(t(dmax), t(rmax), ct[2:6], xmask,
                                    inv_absx)
        _, jct, _, _, jxm, jinv = jkfused._oracle_parts(JPROB, jnp.float32)
        ref = jkfused._block_errors(jnp.asarray(dmax), jnp.asarray(rmax),
                                    jct[2:6], jxm, jinv)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class TestDispatch:
    def test_cpu_tensors_run_plain_and_count_nothing(self):
        stencil_cuda.reset_launches()
        u = t(field(50, np.float32))
        stencil_cuda.leapfrog_step(u, u, PROB)
        stencil_cuda.compensated_step(u, u, u, PROB)
        syz, rsyz, sxct = _oracle_inputs(2)
        stencil_cuda.fused_kstep_comp(u, u, None, syz, rsyz, sxct, k=2,
                                      coeff=1e-3, inv_h2=PROB.inv_h2)
        assert all(v == 0 for v in stencil_cuda.launches.values())

    def test_reset_launches(self):
        stencil_cuda.launches["step"] = 3
        stencil_cuda.reset_launches()
        assert stencil_cuda.launches["step"] == 0
