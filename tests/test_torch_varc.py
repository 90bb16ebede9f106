"""Variable wave speed in the port (K5, and the field operands of K3 and K4)
against wavetpu, on the CPU.

Inputs come from a numpy seed and go through both packages:
  * the c^2 presets and `make_c2tau2_field` (host f64 numpy in both) are
    held bit for bit;
  * a field built by wavetpu, carried into the port by
    `io.state.c2tau2_field`, drives the port to the same bits as the port's
    own preset;
  * the plain versions of K5 and K4f (what a CPU tensor runs) against
    wavetpu's Pallas kernels in interpret mode, and the port's variable-c
    solves against wavetpu's.

Tolerances as tests/test_torch_stencil.py: f64 <= 1e-12 absolute; f32 <= 4
ulp of the field's peak per kernel call (XLA-CPU may contract a
multiply-add into an FMA where torch rounds twice); bf16 within one bf16
ulp of its value; the Kahan carry bitwise where u' and v' agree and
within one ulp of u' elsewhere.  Whole solves: f32 <= 1e-5 at N=12 (a few
ulp per layer, as test_torch_solver.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.kernels import stencil_pallas as jpallas
from wavetpu.kernels import stencil_ref as jref
from wavetpu.solver import kfused as jkfused
from wavetpu.solver import kfused_comp as jkfc
from wavetpu.solver import leapfrog as jlf
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog

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


def assert_close(a, b, torch_dtype):
    a, b = as64(a), as64(b)
    if torch_dtype == torch.float64:
        assert np.max(np.abs(a - b)) <= 1e-12
    else:
        peak = np.max(np.maximum(np.abs(a), np.abs(b)))
        scale = max(float(np.spacing(np.float32(peak))),
                    float(np.finfo(np.float32).tiny))
        assert np.max(np.abs(a - b)) / scale <= 4


def assert_bf16_close(a, b):
    a, b = as64(a), as64(b)
    ulp = np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7
    assert np.all(np.abs(a - b) <= ulp + 1e-30)


def assert_carry_close(ours, ref):
    """`ours`, `ref`: (u', v', carry') of the port and of wavetpu."""
    (u, v, c), (ru, rv, rc) = (tuple(as64(x) for x in o) for o in (ours, ref))
    same = (u == ru) & (v == rv)
    assert same.mean() >= 0.5
    np.testing.assert_array_equal(c[same], rc[same])
    ulp_u = np.spacing(np.maximum(np.abs(u), np.abs(ru)).astype(np.float32))
    assert np.all(np.abs(c - rc)[~same] <= ulp_u[~same])


def c2(seed, dtype=np.float64, p=PROB):
    """A positive tau^2 c^2 field around a2tau2 (0.5x to 1.5x)."""
    rng = np.random.default_rng(seed)
    return (p.a2tau2 * (0.5 + rng.random((p.N,) * 3))).astype(dtype)


class TestPresets:
    @pytest.mark.parametrize("name", stencil_ref.C2_PRESET_NAMES)
    @pytest.mark.parametrize("n,lx", [(16, 1.0), (15, np.pi)])
    def test_bitwise_equal_to_wavetpu(self, name, n, lx):
        p = Problem(N=n, Lx=lx, timesteps=10)
        jp = JProblem(N=n, Lx=lx, timesteps=10)
        ours = stencil_ref.make_preset_c2tau2_field(p, name)
        ref = jref.make_preset_c2tau2_field(jp, name)
        assert ours.dtype == np.float64 and ours.shape == (n, n, n)
        np.testing.assert_array_equal(ours, ref)

    def test_names_and_unknown_preset(self):
        assert stencil_ref.C2_PRESET_NAMES == jref.C2_PRESET_NAMES
        with pytest.raises(ValueError):
            stencil_ref.make_preset_c2tau2_field(PROB, "no-such")

    def test_constant_collapses_to_a2tau2(self):
        f = stencil_ref.make_c2tau2_field(PROB, lambda x, y, z: PROB.a2)
        np.testing.assert_allclose(f, PROB.a2tau2, rtol=1e-15)

    def test_custom_speed_bitwise_equal_to_wavetpu(self):
        def fn(x, y, z):
            return 0.02 + 0.01 * np.sin(x) * np.cos(3 * y) + z ** 2

        np.testing.assert_array_equal(
            stencil_ref.make_c2tau2_field(PROB, fn),
            jref.make_c2tau2_field(JPROB, fn))


class TestFieldHandover:
    @pytest.mark.parametrize("dtype,want", [
        (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
        (torch.float64, torch.float64)])
    def test_compute_dtype_and_rounding(self, dtype, want):
        ref = jref.make_preset_c2tau2_field(JPROB, "gaussian-lens")
        got = state.c2tau2_field(ref, dtype, "cpu")
        assert got.dtype == want and got.is_contiguous()
        # One rounding from f64, as wavetpu's jnp.asarray(field, f).
        jf = jnp.float32 if want == torch.float32 else jnp.float64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jnp.asarray(ref, jf)))

    def test_wavetpu_field_drives_the_port_like_its_own(self):
        ref = jref.make_preset_c2tau2_field(JPROB, "gaussian-lens")
        own = stencil_ref.make_preset_c2tau2_field(PROB, "gaussian-lens")
        a = kfused.solve_kfused(PROB, k=4, compute_errors=False,
                                c2tau2_field=state.c2tau2_field(ref, device="cpu"),
                                device="cpu")
        b = kfused.solve_kfused(PROB, k=4, compute_errors=False,
                                c2tau2_field=own, device="cpu")
        assert torch.equal(a.u_cur, b.u_cur) and torch.equal(a.u_prev, b.u_prev)


class TestK5Plain:
    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_matches_interpret_kernel(self, dt):
        up, u = field(60, NPDT[dt]), field(61, NPDT[dt], zero_planes=False)
        fld = c2(62, NPDT[dt])
        ours = stencil_cuda.fused_step(t(up), t(u), inv_h2=PROB.inv_h2,
                                       c2tau2_field=t(fld))
        ref = jpallas._fused_step(jnp.asarray(up), jnp.asarray(u),
                                  inv_h2=JPROB.inv_h2,
                                  c2tau2_field=jnp.asarray(fld),
                                  interpret=True)
        assert ours.dtype == dt
        assert (ours[:, 0] == 0).all() and (ours[:, :, 0] == 0).all()
        assert_close(ours, ref, dt)

    def test_bf16_state_f32_field(self):
        up, u = field(63, np.float32), field(64, np.float32)
        fld = c2(65, np.float32)
        ours = stencil_cuda.fused_step(
            t(up).to(torch.bfloat16), t(u).to(torch.bfloat16),
            inv_h2=PROB.inv_h2, c2tau2_field=t(fld))
        ref = jpallas._fused_step(
            jnp.asarray(up, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16),
            inv_h2=JPROB.inv_h2, c2tau2_field=jnp.asarray(fld),
            interpret=True)
        assert ours.dtype == torch.bfloat16
        assert_bf16_close(ours, ref)

    def test_constant_field_is_k1(self):
        # A field equal to a2tau2 everywhere gives K1's leapfrog bits.
        up, u = t(field(66, np.float32)), t(field(67, np.float32))
        fld = torch.full((N,) * 3, PROB.a2tau2, dtype=torch.float32)
        a = stencil_cuda.make_step_fn(fld)(up, u, PROB)
        b = stencil_cuda.make_step_fn()(up, u, PROB)
        assert torch.equal(a, b)

    @pytest.mark.parametrize("dt", [torch.float32, torch.float64])
    def test_variable_c_step_ref(self, dt):
        up, u = field(68, NPDT[dt]), field(69, NPDT[dt])
        fld = c2(70, NPDT[dt])
        ours = stencil_ref.make_variable_c_step(t(fld))(t(up), t(u), PROB)
        ref = jref.make_variable_c_step(fld)(jnp.asarray(up),
                                             jnp.asarray(u), JPROB)
        assert_close(ours, ref, dt)
        # The reference order differs from K5's by rounding only.
        k5 = stencil_cuda.fused_step(t(up), t(u), inv_h2=PROB.inv_h2,
                                     c2tau2_field=t(fld))
        assert_close(ours, k5, dt)


MODES = {
    "f32v_bf16carry": (torch.float32, torch.bfloat16),
    "f32v_f32carry": (torch.float32, torch.float32),
    "bf16v_nocarry": (torch.bfloat16, None),
}


class TestK4fPlain:
    @pytest.mark.parametrize("mode", list(MODES))
    @pytest.mark.parametrize("k,bx", [(1, 8), (4, 8)])
    def test_matches_interpret_kernel(self, k, bx, mode):
        v_dt, c_dt = MODES[mode]
        u = field(71, np.float32)
        v = (field(72) * 1e-3).astype(np.float32)
        c = (field(73) * 1e-9).astype(np.float32)
        fld = c2(74, np.float32)
        sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(PROB, torch.float32,
                                                       "cpu")
        sxct = ct[4:4 + k][:, None] * sx[None, :]
        tv = t(v).to(v_dt)
        tc = None if c_dt is None else t(c).to(c_dt)
        jv = jnp.asarray(v, jnp.bfloat16 if v_dt == torch.bfloat16
                         else jnp.float32)
        jc = None if c_dt is None else jnp.asarray(
            c, jnp.bfloat16 if c_dt == torch.bfloat16 else jnp.float32)
        ours = stencil_cuda.fused_kstep_comp(
            t(u), tv, tc, syz, rsyz, sxct, k=k, coeff=None,
            inv_h2=PROB.inv_h2, block_x=bx, c2tau2_field=t(fld))
        ref = jpallas.fused_kstep_comp(
            jnp.asarray(u), jv, jc, jnp.asarray(syz.numpy()),
            jnp.asarray(rsyz.numpy()), jnp.asarray(sxct.numpy()),
            k=k, coeff=None, inv_h2=JPROB.inv_h2, block_x=bx,
            c2tau2_field=jnp.asarray(fld), interpret=True)
        assert_close(ours[0], ref[0], torch.float32)
        if v_dt == torch.bfloat16:
            assert_bf16_close(ours[1], ref[1])
        else:
            assert_close(ours[1], ref[1], torch.float32)
        if c_dt is None:
            assert ours[2] is None
        else:
            assert_carry_close(ours[:3], ref[:3])
        for a, b in zip(ours[3:], ref[3:]):
            assert a.shape == (k, N)
            assert_close(a, b, torch.float32)

    def test_constant_field_is_k4(self):
        u = t(field(75, np.float32))
        v = t((field(76) * 1e-3).astype(np.float32))
        sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(PROB, torch.float32,
                                                       "cpu")
        sxct = ct[2:6][:, None] * sx[None, :]
        fld = torch.full((N,) * 3, PROB.a2tau2, dtype=torch.float32)
        kw = dict(k=4, inv_h2=PROB.inv_h2, block_x=8)
        a = stencil_cuda.fused_kstep_comp(u, v, v * 0, syz, rsyz, sxct,
                                          coeff=None, c2tau2_field=fld, **kw)
        b = stencil_cuda.fused_kstep_comp(u, v, v * 0, syz, rsyz, sxct,
                                          coeff=PROB.a2tau2, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


class TestSolves:
    P12 = Problem(N=12, timesteps=11)
    J12 = JProblem(N=12, timesteps=11)

    def _field(self):
        return jref.make_preset_c2tau2_field(self.J12, "gaussian-lens")

    def test_one_step_matches_wavetpu(self):
        fld = self._field()
        ours = leapfrog.solve(self.P12, compute_errors=False,
                              c2tau2_field=fld, device="cpu")
        ref = jlf.solve(self.J12, step_fn=jpallas.make_step_fn(
            interpret=True, c2tau2_field=jnp.asarray(fld, jnp.float32)),
            compute_errors=False)
        assert np.max(np.abs(as64(ours.u_cur) - as64(ref.u_cur))) <= 1e-5
        assert not ours.abs_errors.any()

    def test_kfused_matches_wavetpu(self):
        fld = self._field()
        ours = kfused.solve_kfused(self.P12, k=4, compute_errors=False,
                                   c2tau2_field=fld, device="cpu")
        ref = jkfused.solve_kfused(self.J12, k=4, compute_errors=False,
                                   c2tau2_field=fld, interpret=True)
        assert np.max(np.abs(as64(ours.u_cur) - as64(ref.u_cur))) <= 1e-5
        assert np.max(np.abs(as64(ours.u_prev) - as64(ref.u_prev))) <= 1e-5

    @pytest.mark.parametrize("v_bf16", [False, True],
                             ids=["carry", "bf16-increment"])
    def test_flagship_matches_wavetpu(self, v_bf16):
        fld = self._field()
        kw = dict(v_dtype=torch.bfloat16, carry=False) if v_bf16 else {}
        jkw = dict(v_dtype=jnp.bfloat16, carry=False) if v_bf16 else {}
        ours = kfused_comp.solve_kfused_comp(
            self.P12, k=4, compute_errors=False, c2tau2_field=fld,
            device="cpu", **kw)
        ref = jkfc.solve_kfused_comp(self.J12, k=4, compute_errors=False,
                                     c2tau2_field=fld, interpret=True, **jkw)
        assert np.max(np.abs(as64(ours.u_cur) - as64(ref.u_cur))) <= 1e-5
        assert np.max(np.abs(as64(ours.comp_v) - as64(ref.comp_v))) <= 1e-5

    def test_compensated_nearer_f64_than_standard(self):
        # wavetpu's tests/test_kfused_varc.py contract: against an f64
        # variable-c march, the compensated onion's f32 state lies nearer
        # than the standard onion's.
        p = Problem(N=16, timesteps=200)
        fld = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
        ref = leapfrog.solve(p, torch.float64, compute_errors=False,
                             c2tau2_field=fld, device="cpu").u_cur
        std = kfused.solve_kfused(p, k=4, compute_errors=False,
                                  c2tau2_field=fld, device="cpu").u_cur
        comp = kfused_comp.solve_kfused_comp(
            p, k=4, compute_errors=False, c2tau2_field=fld,
            device="cpu").u_cur
        e_std = (std.double() - ref).abs().max().item()
        e_comp = (comp.double() - ref).abs().max().item()
        assert e_comp < e_std

    def test_flagship_bootstrap_is_k4f(self):
        # With a field, layer 1 is K4f at k=1 with half the field and zero
        # v and carry: for a constant field that is K2's half-step.
        p = Problem(N=16, timesteps=1)
        const = stencil_ref.make_preset_c2tau2_field(p, "constant")
        a = kfused_comp.solve_kfused_comp(
            p, k=4, compute_errors=False, c2tau2_field=const, device="cpu")
        b = kfused_comp.solve_kfused_comp(p, k=4, compute_errors=False,
                                          device="cpu")
        assert (a.u_cur - b.u_cur).abs().max().item() <= 1e-7
        assert (a.comp_v - b.comp_v).abs().max().item() <= 1e-7

    @pytest.mark.parametrize("solver", ["one_step", "kfused", "flagship"])
    def test_field_needs_errors_off(self, solver):
        fn = {"one_step": leapfrog.solve,
              "kfused": functools.partial(kfused.solve_kfused, k=4),
              "flagship": functools.partial(kfused_comp.solve_kfused_comp,
                                            k=4)}[solver]
        with pytest.raises(ValueError):
            fn(PROB, c2tau2_field=c2(77), device="cpu")

    def test_one_step_field_takes_no_step_fn(self):
        with pytest.raises(ValueError):
            leapfrog.solve(PROB, step_fn=stencil_cuda.make_step_fn(),
                           compute_errors=False, c2tau2_field=c2(77),
                           device="cpu")
