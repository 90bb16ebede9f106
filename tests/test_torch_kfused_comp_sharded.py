"""The port's distributed flagship (K11, K12, the sharded half of
solver/kfused_comp.py) against wavetpu's, on the CPU.

wavetpu runs in interpret mode on the 8 virtual CPU devices of
tests/conftest.py; the port puts every shard on the CPU, where the kernels'
plain versions run.  Inputs come from a numpy seed or the analytic problem.

Tolerances against wavetpu (as tests/test_torch_stencil.py's K4 cases): f32
u and v within 2k ulp of their peak after k substeps for one kernel call
(XLA-CPU contracts multiply-adds into FMAs where torch rounds twice); bf16
v within one bf16 ulp of its value; the Kahan carry within one ulp of u'
(its own scale), and at k = 1 bitwise where u' and v' agree bitwise
(`assert_carry_close`); after a solve the states
within 2e-6 and the errors within 2e-6 absolute.  Against the port's own
single-device flagship at the same block_x: MY = 1 (K11 runs K4's op
sequence) bit for bit, states, carry and errors; MY > 1 (K12's carry is
also zero on the y ghost rows) within 1e-6, abs errors within rtol 1e-3 /
atol 1e-7 (wavetpu's tests/test_kfused_comp.py:291-312).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.kernels import stencil_pallas as jpallas
from wavetpu.solver import kfused_comp as jkc
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, kfused_comp

CPU8 = ["cpu"] * 8
N = 12
MODES = {
    "f32v_bf16carry": (torch.float32, torch.bfloat16),
    "f32v_f32carry": (torch.float32, torch.float32),
    "bf16v_nocarry": (torch.bfloat16, None),
    "f32v_nocarry": (torch.float32, None),
}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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
    assert np.all(np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7
                  + 1e-30)


def assert_carry_close(ours, ref, k):
    """`ours`, `ref`: (u', v', carry') of the port and of wavetpu.  At
    k = 1 the carry is a function of the cell's operands: bitwise where u'
    and v' agree bitwise.  Over k > 1 substeps it carries the earlier
    substeps' residuals, which an FMA one substep back moves by up to an
    ulp of u."""
    (u, v, c), (ru, rv, rc) = (tuple(as64(x) for x in o) for o in (ours, ref))
    same = (u == ru) & (v == rv)
    assert same.mean() >= 0.5
    if k == 1:
        np.testing.assert_array_equal(c[same], rc[same])
    ulp_u = np.spacing(np.maximum(np.abs(u), np.abs(ru)).astype(np.float32))
    assert np.all(np.abs(c - rc) <= ulp_u)


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _case(d, k, w, ny, mode, seed, with_field):
    """One launch's operands for both packages: (port args, wavetpu args,
    port field kwargs, wavetpu field kwargs)."""
    v_dt, c_dt = MODES[mode]
    u, v = rand((d, w, N), seed), rand((d, w, N), seed + 1, 1e-3)
    c = rand((d, ny, N), seed + 2, 1e-9)
    gu = [rand((k, w, N), seed + 3 + i) for i in range(2)]
    gv = [rand((k, w, N), seed + 5 + i, 1e-3) for i in range(2)]
    p = Problem(N=N, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cpu")
    sxct = (ct[3:3 + k][:, None] * sx[None, :d]).contiguous()

    def t(a, dt=torch.float32):
        return torch.from_numpy(a).to(dt)

    def j(a, dt=torch.float32):
        return jnp.asarray(a, JDT[dt])

    ours = [t(u), t(v, v_dt), None if c_dt is None else t(c, c_dt),
            (t(gu[0]), t(gu[1])), (t(gv[0], v_dt), t(gv[1], v_dt))]
    ref = [j(u), j(v, v_dt), None if c_dt is None else j(c, c_dt),
           (j(gu[0]), j(gu[1])), (j(gv[0], v_dt), j(gv[1], v_dt))]
    fo = fr = (None, None)
    if with_field:
        rng = np.random.default_rng(seed + 9)
        fld = (p.a2tau2 * (0.5 + rng.random((d, w, N)))).astype(np.float32)
        fg = [(p.a2tau2 * (0.5 + rng.random((k, w, N)))).astype(np.float32)
              for _ in range(2)]
        fo = (t(fld), tuple(map(t, fg)))
        fr = (j(fld), tuple(map(j, fg)))
    return p, (ours, ref, fo, fr), (syz, rsyz, sxct)


def _compare(ours, ref, k, mode, with_errors):
    v_dt, c_dt = MODES[mode]
    assert ulps_of_peak(ours[0], ref[0]) <= 2 * k
    assert ours[1].dtype == v_dt
    if v_dt == torch.bfloat16:
        assert_bf16_close(ours[1], ref[1])
    else:
        assert ulps_of_peak(ours[1], ref[1]) <= 2 * k
    if c_dt is None:
        assert ours[2] is None and ref[2] is None
    else:
        assert ours[2].dtype == c_dt and torch.count_nonzero(ours[2]) > 0
        assert_carry_close(ours[:3], ref[:3], k)
    if with_errors:
        for a, b in zip(ours[3:], ref[3:]):
            assert a.dtype == torch.float32
            assert ulps_of_peak(a, b) <= 2 * k
    else:
        assert ours[3] is None and ours[4] is None


# ---------------------------------------------------------------------------
# K11 and K12: the plain versions against wavetpu's kernels (interpret mode)


# (D, k, block_x) at N = 12; (D, k, block_x, nl_y, y0) for K12: the first
# and the last y shard, a ghost strip spanning a neighbour block (nl_y = k)
# and the bootstrap / tail depth k = 1.
K11_CASES = [(4, 1, 4), (8, 2, 4), (8, 4, 8)]
K12_CASES = [(4, 2, 4, 4, 0), (4, 2, 4, 4, 8), (8, 4, 8, 4, 8),
             (6, 1, 6, 6, 6)]
# Every storage mode with constant c; the field with the default mode.
VARIANTS = [(m, False) for m in MODES] + [("f32v_bf16carry", True)]


@pytest.mark.parametrize("mode,with_field", VARIANTS)
@pytest.mark.parametrize("d,k,bx", K11_CASES)
def test_k11_plain_matches_wavetpu(d, k, bx, mode, with_field):
    p, (ours, ref, fo, fr), (syz, rsyz, sxct) = _case(d, k, N, N, mode, 10,
                                                      with_field)
    jp = JProblem(N=N, timesteps=20)
    got = stencil_cuda.fused_kstep_comp_sharded(
        *ours, syz, rsyz, sxct, k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
        c2tau2_block=fo[0], c2_ghosts=fo[1], block_x=bx,
        with_errors=not with_field)
    want = jpallas.fused_kstep_comp_sharded(
        *ref, jnp.asarray(syz.numpy()), jnp.asarray(rsyz.numpy()),
        jnp.asarray(sxct.numpy()), k=k, coeff=jp.a2tau2, inv_h2=jp.inv_h2,
        c2tau2_block=fr[0], c2_ghosts=fr[1], block_x=bx,
        with_errors=not with_field, interpret=True)
    _compare(got, want, k, mode, not with_field)


@pytest.mark.parametrize("mode,with_field", VARIANTS)
@pytest.mark.parametrize("d,k,bx,nl_y,y0", K12_CASES)
def test_k12_plain_matches_wavetpu(d, k, bx, nl_y, y0, mode, with_field):
    p, (ours, ref, fo, fr), (syz, rsyz, sxct) = _case(
        d, k, nl_y + 2 * k, nl_y, mode, 20, with_field)
    jp = JProblem(N=N, timesteps=20)
    syz_c, rsyz_c = (a[y0:y0 + nl_y].contiguous() for a in (syz, rsyz))
    got = stencil_cuda.fused_kstep_comp_sharded_xy(
        *ours, syz_c, rsyz_c, sxct, y0, N, k=k, nl_y=nl_y, coeff=p.a2tau2,
        inv_h2=p.inv_h2, c2tau2_ext=fo[0], c2_ghosts=fo[1], block_x=bx,
        with_errors=not with_field)
    want = jpallas.fused_kstep_comp_sharded_xy(
        *ref, jnp.asarray(syz_c.numpy()), jnp.asarray(rsyz_c.numpy()),
        jnp.asarray(sxct.numpy()), y0, N, k=k, nl_y=nl_y, coeff=jp.a2tau2,
        inv_h2=jp.inv_h2, c2tau2_ext=fr[0], c2_ghosts=fr[1], block_x=bx,
        with_errors=not with_field, interpret=True)
    assert tuple(got[0].shape) == (d, nl_y, N)
    _compare(got, want, k, mode, not with_field)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("x0,d,k,bx", [(0, 6, 3, 6), (6, 6, 2, 6),
                                       (4, 4, 4, 4)])
def test_k11_equals_k4_on_a_block_cut_from_the_domain(x0, d, k, bx, mode):
    # For one block_x, K11 on an x block with its windows is K4's op
    # sequence on the whole domain: bit for bit, the carry included.
    v_dt, c_dt = MODES[mode]
    p = Problem(N=N, timesteps=20)
    u = torch.from_numpy(rand((N, N, N), 30))
    v = torch.from_numpy(rand((N, N, N), 31, 1e-3)).to(v_dt)
    c = None if c_dt is None else torch.from_numpy(
        rand((N, N, N), 32, 1e-9)).to(c_dt)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cpu")
    sxct = (ct[3:3 + k][:, None] * sx[None, :]).contiguous()
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, block_x=bx)
    whole = stencil_cuda.fused_kstep_comp(u, v, c, syz, rsyz, sxct, **kw)
    xs = slice(x0, x0 + d)

    def wins(a):
        return (a[[(x0 - k + i) % N for i in range(k)]],
                a[[(x0 + d + i) % N for i in range(k)]])

    got = stencil_cuda.fused_kstep_comp_sharded(
        u[xs], v[xs], None if c is None else c[xs], wins(u), wins(v), syz,
        rsyz, sxct[:, xs].contiguous(), **kw)
    for a, b in zip(got[:3], whole[:3]):
        assert (a is None and b is None) or torch.equal(a, b[xs])
    for a, b in zip(got[3:], whole[3:]):
        assert torch.equal(a, b[:, xs])


def test_k11_k12_cpu_tensors_count_no_launch_and_validate():
    stencil_cuda.reset_launches()
    p = Problem(N=8, timesteps=4)
    u = torch.zeros((4, 8, 8))
    g = (u[:2], u[:2])
    kw = dict(k=2, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=False)
    stencil_cuda.fused_kstep_comp_sharded(u, u, None, g, g, None, None, None,
                                          block_x=4, **kw)
    e = torch.zeros((4, 8, 8))[:, :8]
    stencil_cuda.fused_kstep_comp_sharded_xy(
        e, e, torch.zeros((4, 4, 8)), g, g, None, None, None, 0, 8, nl_y=4,
        block_x=4, **kw)
    assert all(n == 0 for n in stencil_cuda.launches.values())
    with pytest.raises(ValueError, match="block_x=3"):
        stencil_cuda.fused_kstep_comp_sharded(u, u, None, g, g, None, None,
                                              None, block_x=3, **kw)
    with pytest.raises(ValueError, match="extended y width"):
        stencil_cuda.fused_kstep_comp_sharded_xy(
            e, e, None, g, g, None, None, None, 0, 8, nl_y=6, block_x=4,
            **kw)


# ---------------------------------------------------------------------------
# solver/kfused_comp.py: solve_kfused_comp_sharded


MESHES = [(1, 1, 1), (2, 1, 1), (4, 1, 1), (2, 2, 1), (2, 4, 1)]


def _ours(mesh, **kw):
    return kfused_comp.solve_kfused_comp_sharded(
        Problem(N=16, timesteps=13), mesh_shape=mesh, k=4, block_x=4,
        devices=CPU8, **kw)


def _single(**kw):
    return kfused_comp.solve_kfused_comp(Problem(N=16, timesteps=13), k=4,
                                         block_x=4, device="cpu", **kw)


@pytest.fixture(scope="module")
def wavetpu_runs():
    """wavetpu's sharded flagship at N=16, 13 steps, k=4, block_x=4
    (interpret mode) on every mesh, shared by the tests below."""
    jp = JProblem(N=16, timesteps=13)
    return {m: jkc.solve_kfused_comp_sharded(jp, mesh_shape=m, k=4,
                                             block_x=4, interpret=True)
            for m in MESHES}


@pytest.mark.parametrize("mesh", MESHES)
def test_matches_wavetpu(mesh, wavetpu_runs):
    ours, ref = _ours(mesh), wavetpu_runs[mesh]
    for a, b in ((ours.u_cur, ref.u_cur), (ours.comp_v, ref.comp_v),
                 (ours.u_prev, ref.u_prev)):
        got = a.assemble()
        assert tuple(got.shape) == np.asarray(b).shape
        assert np.max(np.abs(as64(got) - as64(b))) <= 2e-6
    assert ours.comp_carry.dtype == torch.bfloat16  # the f32 default
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("mesh", MESHES)
def test_against_single_device_flagship(mesh):
    a, b = _ours(mesh), _single()
    u = a.u_cur.fundamental()
    assert a.u_cur.topo.mesh_shape == mesh
    assert torch.equal(a.u_prev.fundamental(),
                       (u - a.comp_v.fundamental()))
    if mesh[1] == 1:
        # K11 runs K4's op sequence: bit for bit, errors included.
        assert torch.equal(u, b.u_cur)
        assert torch.equal(a.comp_v.fundamental(), b.comp_v)
        assert torch.equal(a.comp_carry.fundamental(), b.comp_carry)
        np.testing.assert_allclose(a.abs_errors, b.abs_errors, rtol=1e-6,
                                   atol=1e-9)
    else:
        assert (u - b.u_cur).abs().max().item() < 1e-6
        np.testing.assert_allclose(a.abs_errors, b.abs_errors, rtol=1e-3,
                                   atol=1e-7)


@pytest.mark.parametrize("mesh", [(2, 1, 1), (2, 2, 1), (2, 4, 1)])
def test_field_against_single_device(mesh):
    fld = stencil_ref.make_preset_c2tau2_field(Problem(N=16, timesteps=13),
                                               "gaussian-lens")
    kw = dict(c2tau2_field=fld, compute_errors=False)
    a, b = _ours(mesh, **kw), _single(**kw)
    d = (a.u_cur.fundamental() - b.u_cur).abs().max().item()
    assert d == 0.0 if mesh[1] == 1 else d < 1e-6
    assert not a.abs_errors.any()


def test_field_matches_wavetpu():
    p, jp = Problem(N=16, timesteps=13), JProblem(N=16, timesteps=13)
    fld = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
    ours = _ours((2, 2, 1), c2tau2_field=fld, compute_errors=False)
    ref = jkc.solve_kfused_comp_sharded(
        jp, mesh_shape=(2, 2, 1), k=4, block_x=4, interpret=True,
        c2tau2_field=fld, compute_errors=False)
    assert np.max(np.abs(as64(ours.u_cur.assemble())
                         - as64(ref.u_cur))) <= 2e-6


@pytest.mark.parametrize("mesh", [(4, 1, 1), (2, 2, 1)])
def test_bf16_increment_mode(mesh):
    # The carry-less mode: no carry to differ in the y ghost rows, so K12
    # equals the single-device march bit for bit too.
    kw = dict(v_dtype=torch.bfloat16, carry=False)
    a, b = _ours(mesh, **kw), _single(**kw)
    assert a.comp_v.dtype == torch.bfloat16 and a.comp_carry is None
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.comp_v.fundamental(), b.comp_v)
    ref = jkc.solve_kfused_comp_sharded(
        JProblem(N=16, timesteps=13), mesh_shape=mesh, k=4, block_x=4,
        v_dtype=jnp.bfloat16, carry=False, interpret=True)
    assert np.max(np.abs(as64(a.u_cur.assemble()) - as64(ref.u_cur))) < 1e-4


def test_carry_dtype_and_stop_step():
    full = _ours((2, 2, 1), carry_dtype=torch.float32)
    assert full.comp_carry.dtype == torch.float32
    part = _ours((2, 1, 1), stop_step=9)
    assert part.final_step == 9 and part.abs_errors.shape == (10,)
    assert torch.equal(part.u_cur.fundamental(), _single(stop_step=9).u_cur)
    np.testing.assert_array_equal(part.abs_errors,
                                  _ours((2, 1, 1)).abs_errors[:10])


@pytest.mark.parametrize("mesh,k", [
    ((3, 1, 1), 4),   # MX does not divide N
    ((8, 1, 1), 4),   # k does not divide N/MX
    ((2, 3, 1), 4),   # MY does not divide N
    ((2, 8, 1), 4),   # N/MY < k
])
def test_validation_matches_wavetpu(mesh, k):
    p, jp = Problem(N=16, timesteps=8), JProblem(N=16, timesteps=8)
    with pytest.raises(ValueError) as ours:
        kfused_comp.solve_kfused_comp_sharded(p, mesh_shape=mesh, k=k,
                                              devices=["cpu"] * 32)
    with pytest.raises(ValueError) as ref:
        jkc.solve_kfused_comp_sharded(jp, mesh_shape=mesh, k=k,
                                      interpret=True)
    assert str(ours.value) == str(ref.value)
