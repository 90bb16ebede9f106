"""The port's k-fusion on y-sharded meshes (K10, the xy half of
solver/sharded_kfused.py) against wavetpu's, on the CPU.

wavetpu runs in interpret mode on the 8 virtual CPU devices of
tests/conftest.py; the port puts every shard on the CPU, where the kernels'
plain versions run.  Inputs come from a numpy seed or the analytic problem.

Tolerances against wavetpu (as tests/test_torch_sharded_kfused.py): f32
states within 2k ulp of the peak after k substeps for one kernel call
(XLA-CPU contracts multiply-adds into FMAs where torch rounds twice) and
within 2e-6 after a solve; bf16 within one bf16 ulp of the value; errors
within 2e-6 absolute after a solve.  Against the port's own single-device
k-fused solve the states are bitwise, and the errors within rtol 1e-5 /
atol 1e-7 (wavetpu's tests/test_sharded_kfused.py:304-330).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.kernels import stencil_pallas as jpallas
from wavetpu.solver import sharded_kfused as jsk
from wavetpu_torch.comm import halo
from wavetpu_torch.core.grid import build_mesh
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, sharded_kfused

CPU8 = ["cpu"] * 8
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float64: jnp.float64}


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


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# K10: the plain version against wavetpu's kernel (interpret mode)


# (D, k, nl_y, y0) at N = 12: the first (y0 = 0) and the last (y0 = N -
# nl_y) y shard, a ghost strip spanning a whole neighbour block (nl_y = k),
# and the bootstrap / tail depth k = 1.
K10_CASES = [(4, 2, 4, 0), (4, 2, 4, 8), (8, 4, 4, 4), (8, 4, 4, 8),
             (6, 1, 6, 6), (6, 3, 6, 0)]


@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,k,nl_y,y0", K10_CASES)
def test_k10_plain_matches_wavetpu(d, k, nl_y, y0, dtype, with_field):
    n = 12
    w = nl_y + 2 * k
    p, jp = Problem(N=n, timesteps=20), JProblem(N=n, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cpu")
    syz_c, rsyz_c = (a[y0:y0 + nl_y].contiguous() for a in (syz, rsyz))
    sxct = (ct[3:3 + k][:, None] * sx[None, :d]).contiguous()
    up, u = rand((d, w, n), 1), rand((d, w, n), 2)
    g = [rand((k, w, n), 3 + i) for i in range(4)]
    fld = fg = None
    if with_field:
        rng = np.random.default_rng(9)
        fld = (p.a2tau2 * (0.5 + rng.random((d, w, n)))).astype(np.float32)
        fg = [(p.a2tau2 * (0.5 + rng.random((k, w, n)))).astype(np.float32)
              for _ in range(2)]

    def t(a):
        return torch.from_numpy(a).to(dtype)

    def j(a):
        return jnp.asarray(a, JDT[dtype])

    ours = stencil_cuda.fused_kstep_sharded_xy(
        t(up), t(u), (t(g[0]), t(g[1])), (t(g[2]), t(g[3])), syz_c, rsyz_c,
        sxct, y0, n, k=k, nl_y=nl_y, coeff=p.a2tau2, inv_h2=p.inv_h2,
        c2tau2_ext=None if fld is None else torch.from_numpy(fld),
        c2_ghosts=None if fg is None else tuple(map(torch.from_numpy, fg)),
        with_errors=not with_field)
    ref = jpallas.fused_kstep_sharded_xy(
        j(up), j(u), (j(g[0]), j(g[1])), (j(g[2]), j(g[3])),
        jnp.asarray(syz_c.numpy()), jnp.asarray(rsyz_c.numpy()),
        jnp.asarray(sxct.numpy()), y0, n, k=k, nl_y=nl_y, coeff=jp.a2tau2,
        inv_h2=jp.inv_h2,
        c2tau2_ext=None if fld is None else jnp.asarray(fld),
        c2_ghosts=None if fg is None else tuple(map(jnp.asarray, fg)),
        with_errors=not with_field, interpret=True)
    for a, b in zip(ours[:2], ref[:2]):
        assert a.dtype == dtype and tuple(a.shape) == (d, nl_y, n)
        if dtype == torch.bfloat16:
            assert_bf16_close(a, b)
        else:
            assert ulps_of_peak(a, b) <= 2 * k
    if with_field:
        assert ours[2] is None and ours[3] is None
    else:
        for a, b in zip(ours[2:], ref[2:]):
            assert tuple(a.shape) == (k, d)
            assert ulps_of_peak(a, b) <= 2 * k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x0,nl_x,y0,nl_y", [(6, 6, 9, 3), (0, 6, 0, 6),
                                             (3, 3, 3, 6)])
def test_k10_equals_k3_on_a_block_cut_from_the_domain(x0, nl_x, y0, nl_y,
                                                      dtype):
    # K10 on an extended block cut from the whole domain equals K3 there,
    # bit for bit: the last y shard (y0 = 9), whose hi ghost strip holds
    # the global y = 0 row (re-zeroed by the wrapped-row mask, or it would
    # leak into real rows), with nl_y = k; the first one (y0 = 0).
    n, k = 12, 3
    p = Problem(N=n, timesteps=4)
    up, u = (torch.from_numpy(rand((n, n, n), s)).to(dtype) for s in (5, 6))
    for a in (up, u):
        a[:, 0, :] = 0.0
        a[:, :, 0] = 0.0
    kw = dict(coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=False)
    whole = stencil_cuda.fused_kstep_plain(up, u, None, None, None, k=k,
                                           **kw)
    rows = [(y0 - k + r) % n for r in range(nl_y + 2 * k)]

    def cut(a, xs):
        return a[[x % n for x in xs]][:, rows].contiguous()

    xs = range(x0, x0 + nl_x)
    lo, hi = range(x0 - k, x0), range(x0 + nl_x, x0 + nl_x + k)
    out = stencil_cuda.fused_kstep_sharded_xy(
        cut(up, xs), cut(u, xs), (cut(up, lo), cut(up, hi)),
        (cut(u, lo), cut(u, hi)), None, None, None, y0, n, k=k, nl_y=nl_y,
        **kw)
    for got, want in zip(out[:2], whole[:2]):
        assert torch.equal(got, want[x0:x0 + nl_x, y0:y0 + nl_y])


def test_k10_cpu_tensors_count_no_launch_and_validate():
    stencil_cuda.reset_launches()
    p = Problem(N=8, timesteps=4)
    u = torch.zeros((4, 8, 8))
    g = (u[:2], u[:2])
    kw = dict(k=2, nl_y=4, coeff=p.a2tau2, inv_h2=p.inv_h2,
              with_errors=False)
    stencil_cuda.fused_kstep_sharded_xy(u, u, g, g, None, None, None, 4, 8,
                                        **kw)
    assert all(v == 0 for v in stencil_cuda.launches.values())
    with pytest.raises(ValueError, match="extended y width"):
        stencil_cuda.fused_kstep_sharded_xy(u, u, g, g, None, None, None, 4,
                                            8, **dict(kw, nl_y=6))
    with pytest.raises(ValueError, match="divide the shard depth"):
        stencil_cuda.fused_kstep_sharded_xy(u[:3], u[:3], g, g, None, None,
                                            None, 4, 8, **kw)


# ---------------------------------------------------------------------------
# The exchange: y extension, x windows of the extended blocks, row max


def test_extend_y_and_windows_carry_the_corners():
    # A (2, 2, 1) mesh of a 4x4x2 array whose cells hold their global
    # (x, y) index: every extended block and window must hold the cyclic
    # global neighbours, the diagonal corners included.
    n, k = 4, 1
    a = torch.zeros((n, n, 2))
    a[:] = (torch.arange(n)[:, None] * 10 + torch.arange(n)[None, :])[
        :, :, None].float()
    mesh = build_mesh((2, 2, 1), ["cpu"] * 4)
    blocks = [a[cx * 2:cx * 2 + 2, cy * 2:cy * 2 + 2].contiguous()
              for cx, cy, _ in mesh.coords]
    ext, wins = sharded_kfused.exchange(blocks, mesh, k)
    for i, (cx, cy, _) in enumerate(mesh.coords):
        rows = [(cy * 2 - 1 + r) % n for r in range(2 + 2 * k)]
        want = a[cx * 2:cx * 2 + 2][:, rows]
        assert torch.equal(ext[i], want)
        lo, hi = wins[i]
        assert torch.equal(lo, a[[(cx * 2 - 1) % n]][:, rows])
        assert torch.equal(hi, a[[(cx * 2 + 2) % n]][:, rows])


def test_row_max_across_y_propagates_nan():
    rows = [torch.tensor([[1.0, 2.0]]), torch.tensor([[float("nan"), 0.5]]),
            torch.tensor([[3.0, 1.0]]), torch.tensor([[0.0, 4.0]])]
    got = sharded_kfused.rows_max_y(rows, 2, 2, "cpu")
    assert torch.isnan(got[0, 0])
    assert got[0, 1:].tolist() == [2.0, 3.0, 4.0]


def test_extend_y_is_a_copy():
    mesh = build_mesh((1, 2, 1), ["cpu"] * 2)
    blocks = [torch.zeros((2, 4, 3)), torch.ones((2, 4, 3))]
    ext = halo.extend_y(blocks, mesh, 2)
    ext[0].fill_(7.0)
    assert not blocks[0].any() and blocks[1].eq(1.0).all()


# ---------------------------------------------------------------------------
# solver/sharded_kfused.py on (MX, MY > 1, 1) meshes


MESHES = [(1, 2, 1), (2, 2, 1), (4, 2, 1), (2, 4, 1)]


def _ours(n, steps, k, mesh, dtype=torch.float32, **kw):
    return sharded_kfused.solve_sharded_kfused(
        Problem(N=n, timesteps=steps), mesh_shape=mesh, dtype=dtype, k=k,
        devices=CPU8, **kw)


@pytest.fixture(scope="module")
def wavetpu_runs():
    """wavetpu's xy solves at N=16, 13 steps, k=4 (interpret mode), shared
    by the tests below: every mesh, and mesh (2, 2, 1) with the lens."""
    jp = JProblem(N=16, timesteps=13)
    runs = {m: jsk.solve_sharded_kfused(jp, mesh_shape=m, k=4,
                                        interpret=True) for m in MESHES}
    fld = stencil_ref.make_preset_c2tau2_field(Problem(N=16, timesteps=13),
                                               "gaussian-lens")
    runs["lens"] = jsk.solve_sharded_kfused(
        jp, mesh_shape=(2, 2, 1), k=4, interpret=True, c2tau2_field=fld,
        compute_errors=False)
    return runs


@pytest.mark.parametrize("mesh", MESHES)
def test_matches_wavetpu(mesh, wavetpu_runs):
    # f32: the states and errors move by XLA-CPU's FMA contraction
    # (ROADMAP.md queue 3), ~1e-7 per step.
    ours, ref = _ours(16, 13, 4, mesh), wavetpu_runs[mesh]
    for a, b in ((ours.u_cur, ref.u_cur), (ours.u_prev, ref.u_prev)):
        got = a.assemble()
        assert tuple(got.shape) == np.asarray(b).shape
        assert np.max(np.abs(as64(got) - as64(b))) <= 2e-6
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=2e-6)
    assert ours.abs_errors.shape == (14,)


def test_field_matches_wavetpu(wavetpu_runs):
    p = Problem(N=16, timesteps=13)
    fld = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
    ours = _ours(16, 13, 4, (2, 2, 1), c2tau2_field=fld,
                 compute_errors=False)
    ref = wavetpu_runs["lens"]
    assert np.max(np.abs(as64(ours.u_cur.assemble())
                         - as64(ref.u_cur))) <= 2e-6
    assert not ours.abs_errors.any() and not ours.rel_errors.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("n,steps,k,mesh", [
    (16, 13, 4, (1, 2, 1)), (16, 13, 4, (2, 2, 1)), (16, 12, 2, (4, 2, 1)),
    (16, 13, 4, (2, 4, 1)), (12, 10, 3, (2, 2, 1))])
def test_equals_single_device_kfused_bitwise(n, steps, k, mesh, dtype):
    p = Problem(N=n, timesteps=steps)
    a = _ours(n, steps, k, mesh, dtype)
    b = kfused.solve_kfused(p, dtype, k, device="cpu")
    assert a.u_cur.dtype == dtype
    assert a.u_cur.topo.mesh_shape == mesh
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.u_prev.fundamental(), b.u_prev)
    # wavetpu's sharded vs single-device contract; layer 1 and the tail are
    # full-field errors on the single device (another multiply order).
    rtol, atol = (1e-5, 1e-7) if dtype != torch.bfloat16 else (0, 1e-6)
    np.testing.assert_allclose(a.abs_errors, b.abs_errors, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("mesh", MESHES)
def test_field_equals_single_device_bitwise(mesh):
    p = Problem(N=16, timesteps=13)
    kw = dict(compute_errors=False, c2tau2_field=stencil_ref.
              make_preset_c2tau2_field(p, "gaussian-lens"))
    a = _ours(16, 13, 4, mesh, **kw)
    b = kfused.solve_kfused(p, k=4, device="cpu", **kw)
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.u_prev.fundamental(), b.u_prev)


def test_stop_step():
    full = _ours(16, 13, 4, (2, 2, 1))
    part = _ours(16, 13, 4, (2, 2, 1), stop_step=7)
    one = kfused.solve_kfused(Problem(N=16, timesteps=13), k=4,
                              stop_step=7, device="cpu")
    assert part.final_step == 7 and part.abs_errors.shape == (8,)
    assert torch.equal(part.u_cur.fundamental(), one.u_cur)
    np.testing.assert_allclose(part.abs_errors[:6], full.abs_errors[:6],
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,k,mesh", [
    (13, 4, (2, 2, 1)),   # uneven N on a 2D mesh
    (16, 4, (2, 3, 1)),   # MY does not divide N
    (16, 4, (2, 8, 1)),   # N/MY < k
    (16, 4, (2, 2, 2)),   # MZ > 1
])
def test_validation_matches_wavetpu(n, k, mesh):
    p, jp = Problem(N=n, timesteps=8), JProblem(N=n, timesteps=8)
    with pytest.raises(ValueError) as ours:
        sharded_kfused.solve_sharded_kfused(p, mesh_shape=mesh, k=k,
                                            devices=["cpu"] * 32)
    with pytest.raises(ValueError) as ref:
        jsk.solve_sharded_kfused(jp, mesh_shape=mesh, k=k, interpret=True)
    assert str(ours.value) == str(ref.value)
