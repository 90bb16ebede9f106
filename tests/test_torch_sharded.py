"""The port's multi-shard solver (core/grid.py, comm/halo.py, K6, K7,
solver/sharded.py) against wavetpu's, on the CPU.

wavetpu runs as its own tests run it: Pallas in interpret mode on the 8
virtual CPU devices of tests/conftest.py.  The port runs every shard on the
CPU (`devices=["cpu"] * P`), where the kernels' plain versions run.  Inputs
come from a numpy seed or the analytic problem.

Tolerances against wavetpu: f64 states and errors within 1e-12
(tests/test_sharded_kernels.py); f32 within 1e-5 (XLA-CPU contracts some
multiply-adds into FMAs where the port rounds twice, ROADMAP.md queue 3);
the compensated scheme (f32) within 2e-7 (tests/test_compensated.py).
Against the port's own single-device solve the sharded solve is bitwise,
errors included: each K6/K7 update is op for op K1's/K2's, and the error
maxima are taken over the same cells.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.comm import halo as jhalo  # noqa: F401  (the module ported)
from wavetpu.core import grid as jgrid
from wavetpu.core.problem import Problem as JProblem
from wavetpu.kernels import stencil_pallas as jpallas
from wavetpu.kernels import stencil_ref as jref
from wavetpu.solver import sharded as jsharded
from wavetpu_torch.comm import halo
from wavetpu_torch.core import grid
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import leapfrog, sharded

CPU8 = ["cpu"] * 8
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64,
       torch.bfloat16: jnp.bfloat16}


def as64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x, jnp.float64))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


# ---------------------------------------------------------------------------
# core/grid.py and comm/halo.py


def test_choose_mesh_shape_matches_wavetpu():
    for n in range(1, 65):
        assert grid.choose_mesh_shape(n) == jgrid.choose_mesh_shape(n)


@pytest.mark.parametrize("n", [8, 15, 16, 31])
@pytest.mark.parametrize("mesh", [(1, 1, 1), (2, 2, 2), (8, 1, 1), (1, 2, 4),
                                  (4, 1, 1), (3, 2, 1)])
def test_topology_matches_wavetpu(n, mesh):
    ours, ref = grid.Topology(n, mesh), jgrid.Topology(n, mesh)
    assert (ours.block, ours.padded, ours.r_last, ours.n_devices) == (
        ref.block, ref.padded, ref.r_last, ref.n_devices)


def test_topology_refuses_an_empty_last_shard():
    with pytest.raises(ValueError):
        grid.Topology(9, (8, 1, 1))  # blocks of 2: the last owns none
    with pytest.raises(ValueError):
        jgrid.Topology(9, (8, 1, 1))


def _sharded(fund, mesh_shape):
    n = fund.shape[0]
    topo = grid.Topology(n, mesh_shape)
    mesh = grid.build_mesh(mesh_shape, ["cpu"] * topo.n_devices)
    return grid.split_global(grid.pad_global(torch.from_numpy(fund), topo),
                             topo, mesh)


# N=13 over 8 x-shards would leave the last shard empty: N=15 there.
@pytest.mark.parametrize("n,mesh_shape", [
    (13, (2, 2, 2)), (15, (8, 1, 1)), (13, (1, 2, 4)), (13, (4, 1, 1)),
    (16, (2, 2, 2)), (16, (8, 1, 1)), (16, (1, 2, 4)), (16, (4, 1, 1)),
])
def test_ghosts_are_the_cyclic_neighbours(n, mesh_shape):
    # Every shard's six ghosts equal the cyclic neighbours np.roll gives on
    # the fundamental array, the uneven seam (r_last < block) included.
    fund = rand((n, n, n), 1)
    u = _sharded(fund, mesh_shape)
    topo, mesh = u.topo, u.mesh
    ghosts = halo.collect_ghosts(u.blocks, topo, mesh)
    for i, coord in enumerate(mesh.coords):
        sl = grid.block_slices(topo, coord)
        for axis in range(3):
            b, r = topo.block[axis], topo.r_last[axis]
            first = coord[axis] * b
            last = first + (r if coord[axis] == mesh_shape[axis] - 1
                            else b) - 1
            for shift, plane, got in ((1, first, ghosts[i][axis][0]),
                                      (-1, last, ghosts[i][axis][1])):
                rolled = np.zeros(topo.padded)
                rolled[:n, :n, :n] = np.roll(fund, shift, axis)
                idx = list(sl)
                idx[axis] = slice(plane, plane + 1)
                np.testing.assert_array_equal(got.numpy(),
                                              rolled[tuple(idx)])


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 1, 1), (1, 4, 1),
                                        (1, 2, 4)])
def test_extension_and_absorbed_ghosts_give_the_full_laplacian(mesh_shape):
    # place_ghosts (hi at r_last + 1) and absorb_hi_ghosts + K6's ghost
    # slots (hi inside the block at r_last) both reproduce, on every real
    # cell, the Laplacian of the whole fundamental domain.
    n = 13
    fund = rand((n, n, n), 2)
    p = Problem(N=n, timesteps=4)
    u = _sharded(fund, mesh_shape)
    topo, mesh = u.topo, u.mesh
    want = np.zeros(topo.padded)
    want[:n, :n, :n] = stencil_ref.laplacian(torch.from_numpy(fund),
                                             p.inv_h2).numpy()
    ghosts = halo.collect_ghosts(u.blocks, topo, mesh)
    absorbed = halo.absorb_hi_ghosts(u.blocks, ghosts, topo, mesh)
    need = tuple(m > 1 for m in mesh_shape)
    for i, coord in enumerate(mesh.coords):
        real = tuple(slice(0, min(b, n - c * b))
                     for c, b in zip(coord, topo.block))
        w = want[grid.block_slices(topo, coord)][real]
        ext = halo.place_ghosts(u.blocks[i], ghosts[i], topo, coord)
        lap = stencil_ref.laplacian_ext(ext, p.inv_h2)
        np.testing.assert_array_equal(lap[real].numpy(), w)
        lap = stencil_cuda._ghost_lap(absorbed[i], ghosts[i], need, p.inv_h2)
        np.testing.assert_array_equal(lap[real].numpy(), w)
    # The state itself keeps its zero pad (only a copy absorbs the ghost).
    assert all(a is b or not torch.equal(a, b)
               for a, b in zip(absorbed, u.blocks))
    assert torch.equal(u.assemble()[n:], torch.zeros_like(u.assemble()[n:]))


def test_laplacian_ext_matches_wavetpu():
    ext = rand((7, 9, 6), 3)
    inv_h2 = (1.5, 2.5, 3.5)
    np.testing.assert_array_equal(
        stencil_ref.laplacian_ext(torch.from_numpy(ext), inv_h2).numpy(),
        np.asarray(jref.laplacian_ext(jnp.asarray(ext), inv_h2)))


def test_shard_state_round_trips_through_the_port():
    # A wavetpu (2,2,2) N=13 state - padded global arrays, bf16 included -
    # split into the port's blocks and assembled back unchanged.
    for dt in (jnp.bfloat16, jnp.float32):
        r = jsharded.solve_sharded(JProblem(N=13, timesteps=4),
                                   mesh_shape=(2, 2, 2), dtype=dt,
                                   kernel="pallas")
        a = np.asarray(r.u_cur)
        u = state.split_sharded(a, 13, (2, 2, 2), CPU8)
        assert [tuple(b.shape) for b in u.blocks] == [(7, 7, 7)] * 8
        back = state.assemble_sharded(u)
        assert back.dtype == a.dtype and back.shape == a.shape == (14,) * 3
        np.testing.assert_array_equal(back.view(np.uint8), a.view(np.uint8))
    field = jsharded.pad_field(
        jref.make_preset_c2tau2_field(JProblem(N=13, timesteps=4),
                                      "gaussian-lens"),
        jgrid.Topology(13, (2, 2, 2)))
    u = state.split_sharded(field, 13, (2, 2, 2), CPU8)
    np.testing.assert_array_equal(state.assemble_sharded(u), field)


# ---------------------------------------------------------------------------
# K6 and K7: the plain versions against wavetpu's kernels (interpret mode)


def _block_case(seed, shape, mesh_shape, dtype=np.float64):
    """A block, its u_prev, and ghosts from a seed (face-shaped)."""
    up, u = rand(shape, seed), rand(shape, seed + 1)
    ghosts = []
    for axis in range(3):
        face = list(shape)
        face[axis] = 1
        ghosts.append((rand(face, seed + 2 + 2 * axis),
                       rand(face, seed + 3 + 2 * axis)))
    return up.astype(dtype), u.astype(dtype), [
        tuple(g.astype(dtype) for g in pair) for pair in ghosts]


# (mesh, N, block, r_last, offsets): the last shard of an uneven axis
# carries pad planes (r_last < block); its pad cells hold arbitrary data,
# as an absorbed ghost does.
BLOCKS = [
    ((1, 1, 1), 12, (12, 12, 12), None, (0, 0, 0)),
    ((2, 2, 2), 12, (6, 6, 6), None, (6, 0, 6)),
    ((4, 1, 2), 15, (4, 15, 8), (3, 15, 7), (12, 0, 8)),  # uneven x and z
    ((1, 3, 1), 10, (10, 4, 10), (10, 2, 10), (0, 8, 0)),  # y ghosts only
]


@pytest.mark.parametrize("mesh_shape,n,shape,r_last,offsets", BLOCKS)
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k6_plain_matches_wavetpu(mesh_shape, n, shape, r_last, offsets,
                                  with_field):
    p = Problem(N=n, timesteps=8)
    up, u, ghosts = _block_case(10, shape, mesh_shape)
    fld = (p.a2tau2 * (0.5 + np.random.default_rng(4).random(shape))
           if with_field else None)
    kw = dict(inv_h2=p.inv_h2, mesh_shape=mesh_shape, r_last=r_last,
              alpha=2.0, beta=1.0, coeff=p.a2tau2)
    ours = stencil_cuda.sharded_fused_step(
        torch.from_numpy(up), torch.from_numpy(u),
        [tuple(map(torch.from_numpy, g)) for g in ghosts], offsets, n,
        c2tau2_block=None if fld is None else torch.from_numpy(fld), **kw)
    ref = jpallas.sharded_fused_step(
        jnp.asarray(up), jnp.asarray(u),
        [tuple(map(jnp.asarray, g)) for g in ghosts],
        jnp.asarray(offsets, jnp.int32), n,
        c2tau2_block=None if fld is None else jnp.asarray(fld),
        interpret=True, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    # The global mask: y/z index 0 and every pad cell are zero.
    g = [o + np.arange(b) for o, b in zip(offsets, shape)]
    out = ours.numpy()
    assert np.all(out[:, g[1] == 0] == 0) and np.all(out[:, :, g[2] == 0] == 0)
    assert np.all(out[g[0] >= n] == 0) and np.all(out[:, :, g[2] >= n] == 0)
    assert np.any(out != 0)


@pytest.mark.parametrize("mesh_shape,n,shape,r_last,offsets",
                         BLOCKS[1:3])
def test_k7_plain_matches_wavetpu(mesh_shape, n, shape, r_last, offsets):
    p = Problem(N=n, timesteps=8)
    _, u, ghosts = _block_case(20, shape, mesh_shape)
    v, c = rand(shape, 30) * 1e-3, rand(shape, 31) * 1e-9
    kw = dict(inv_h2=p.inv_h2, mesh_shape=mesh_shape, r_last=r_last,
              coeff=p.a2tau2)
    ours = stencil_cuda.sharded_compensated_step(
        *map(torch.from_numpy, (u, v, c)),
        [tuple(map(torch.from_numpy, g)) for g in ghosts], offsets, n, **kw)
    ref = jpallas.sharded_compensated_step(
        *map(jnp.asarray, (u, v, c)),
        [tuple(map(jnp.asarray, g)) for g in ghosts],
        jnp.asarray(offsets, jnp.int32), n, interpret=True, **kw)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12)


def test_k6_k7_cpu_tensors_count_no_launch():
    stencil_cuda.reset_launches()
    up, u, ghosts = _block_case(40, (4, 4, 4), (2, 2, 2))
    g = [tuple(map(torch.from_numpy, x)) for x in ghosts]
    t = torch.from_numpy(u)
    stencil_cuda.sharded_fused_step(torch.from_numpy(up), t, g, (0, 0, 0), 8,
                                    inv_h2=(1.0,) * 3, mesh_shape=(2, 2, 2),
                                    coeff=1e-3)
    stencil_cuda.sharded_compensated_step(t, t, t, g, (0, 0, 0), 8,
                                          inv_h2=(1.0,) * 3,
                                          mesh_shape=(2, 2, 2), coeff=1e-3)
    assert all(v == 0 for v in stencil_cuda.launches.values())


# ---------------------------------------------------------------------------
# solver/sharded.py against wavetpu's, and against the port's single device


def _ours(p, mesh, dtype=torch.float64, **kw):
    return sharded.solve_sharded(p, mesh, devices=CPU8, dtype=dtype, **kw)


def _ref(n, steps, mesh, dtype=jnp.float64, **kw):
    return jsharded.solve_sharded(JProblem(N=n, timesteps=steps),
                                  mesh_shape=mesh, dtype=dtype,
                                  kernel="pallas", **kw)


@pytest.mark.parametrize("n,mesh", [
    (16, (1, 1, 1)), (16, (2, 2, 2)), (16, (8, 1, 1)), (16, (1, 2, 4)),
    (13, (4, 1, 1)), (13, (2, 2, 2)), (13, (1, 4, 1)),
])
def test_solve_sharded_f64_matches_wavetpu(n, mesh):
    ours = _ours(Problem(N=n, timesteps=10), mesh)
    ref = _ref(n, 10, mesh)
    a, b = state.assemble_sharded(ours.u_cur), np.asarray(ref.u_cur)
    assert a.shape == b.shape == grid.Topology(n, mesh).padded
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(state.assemble_sharded(ours.u_prev),
                               np.asarray(ref.u_prev), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=1e-12)
    if n % 2:
        # At even N the x = N/2 plane holds sin(pi) ~ 1e-16, and the rel
        # error there is a ratio of rounding noise (ROADMAP.md queue 3).
        np.testing.assert_allclose(ours.rel_errors, ref.rel_errors, rtol=0,
                                   atol=1e-12)
    assert np.all(a[n:] == 0) and np.all(a[:, n:] == 0) \
        and np.all(a[:, :, n:] == 0)


def test_solve_sharded_f32_matches_wavetpu():
    ours = _ours(Problem(N=16, timesteps=10), (2, 2, 2), torch.float32)
    ref = _ref(16, 10, (2, 2, 2), jnp.float32)
    assert np.max(np.abs(as64(ours.u_cur.assemble())
                         - as64(ref.u_cur))) <= 1e-5
    assert np.max(np.abs(ours.abs_errors - ref.abs_errors)) <= 1e-5


def test_solve_sharded_field_matches_wavetpu():
    p = Problem(N=16, timesteps=10)
    fld = np.random.default_rng(5).random((16,) * 3)
    fld = p.a2tau2 * (0.5 + fld)
    ours = _ours(p, (2, 2, 2), c2tau2_field=fld, compute_errors=False)
    ref = _ref(16, 10, (2, 2, 2), c2tau2_field=fld, compute_errors=False)
    np.testing.assert_allclose(state.assemble_sharded(ours.u_cur),
                               np.asarray(ref.u_cur), rtol=0, atol=1e-12)
    assert not ours.abs_errors.any()


@pytest.mark.parametrize("n,mesh", [(16, (2, 2, 2)), (13, (4, 1, 1))])
def test_solve_sharded_compensated_matches_wavetpu(n, mesh):
    ours = _ours(Problem(N=n, timesteps=6), mesh, torch.float32,
                 scheme="compensated")
    ref = _ref(n, 6, mesh, jnp.float32, scheme="compensated")
    for a, b in ((ours.u_cur, ref.u_cur), (ours.u_prev, ref.u_prev),
                 (ours.comp_v, ref.comp_v)):
        np.testing.assert_allclose(as64(a.assemble()), as64(b), rtol=0,
                                   atol=2e-7)
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=2e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("n,mesh", [(16, (2, 2, 2)), (13, (4, 1, 1)),
                                    (13, (1, 2, 4)), (16, (1, 1, 1))])
def test_solve_sharded_equals_single_device_bitwise(n, mesh, dtype,
                                                    with_field):
    p = Problem(N=n, timesteps=9)
    kw = {}
    if with_field:
        kw = dict(compute_errors=False, c2tau2_field=stencil_ref.
                  make_preset_c2tau2_field(p, "gaussian-lens"))
    a = _ours(p, mesh, dtype, **kw)
    b = leapfrog.solve(p, dtype, device="cpu", **kw)
    assert a.u_cur.dtype == dtype
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.u_prev.fundamental(), b.u_prev)
    np.testing.assert_array_equal(a.abs_errors, b.abs_errors)
    np.testing.assert_array_equal(a.rel_errors, b.rel_errors)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,mesh", [(16, (2, 2, 2)), (13, (4, 1, 1))])
def test_compensated_equals_single_device_bitwise(n, mesh, dtype):
    p = Problem(N=n, timesteps=9)
    a = _ours(p, mesh, dtype, scheme="compensated")
    b = leapfrog.solve_compensated(p, dtype, device="cpu")
    for x, y in ((a.u_cur, b.u_cur), (a.u_prev, b.u_prev),
                 (a.comp_v, b.comp_v), (a.comp_carry, b.comp_carry)):
        assert torch.equal(x.fundamental(), y)
    np.testing.assert_array_equal(a.abs_errors, b.abs_errors)


def test_stop_step_and_gather():
    p = Problem(N=13, timesteps=10)
    part = _ours(p, (2, 2, 2), stop_step=6)
    one = leapfrog.solve(p, torch.float64, stop_step=6, device="cpu")
    assert part.final_step == 6 and part.abs_errors.shape == (7,)
    assert torch.equal(sharded.gather_fundamental(part.u_cur, p), one.u_cur)


@pytest.mark.parametrize("kwargs,match", [
    (dict(mesh_shape=(4, 4, 1)), "needs 16 devices"),
    (dict(mesh_shape=(2, 1, 1), scheme="compensated",
          c2tau2_field=np.ones((8,) * 3), compute_errors=False),
     "variable-c"),
    (dict(mesh_shape=(2, 1, 1), dtype=torch.bfloat16,
          scheme="compensated"), "f32/f64"),
    (dict(mesh_shape=(2, 1, 1), c2tau2_field=np.ones((8,) * 3)), "oracle"),
    (dict(mesh_shape=(2, 1, 1), scheme="overlap"), "scheme"),
])
def test_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        sharded.solve_sharded(Problem(N=8, timesteps=4), devices=CPU8,
                              **kwargs)


def test_default_devices_are_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh uses it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.solve_sharded(Problem(N=8, timesteps=4), (1, 1, 1))


# ---------------------------------------------------------------------------
# The shifted phase (the sharded ensemble's lane identity): the analytic
# layer-1 start on every shard, against wavetpu's `phase=` solve and
# bitwise the port's single-device solve.


@pytest.mark.parametrize("n,mesh", [(15, (2, 2, 1)), (13, (4, 1, 1)),
                                    (16, (2, 2, 2))])
def test_solve_sharded_shifted_phase_matches_wavetpu(n, mesh):
    ours = _ours(Problem(N=n, timesteps=10), mesh, phase=1.0, stop_step=7)
    ref = _ref(n, 10, mesh, phase=1.0, stop_step=7)
    np.testing.assert_allclose(state.assemble_sharded(ours.u_cur),
                               np.asarray(ref.u_cur), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=1e-12)
    one = leapfrog.solve(Problem(N=n, timesteps=10), dtype=torch.float64,
                         device="cpu", phase=1.0, stop_step=7)
    assert torch.equal(ours.u_cur.fundamental(), one.u_cur)
    assert torch.equal(ours.u_prev.fundamental(), one.u_prev)
    assert np.array_equal(ours.abs_errors, one.abs_errors)
    assert np.array_equal(ours.rel_errors, one.rel_errors)
