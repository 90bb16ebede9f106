"""The port's overlap mode (solver/sharded.py `_make_local_step(overlap=
True)`, `_self_ghosts`, `_face_block`) against its serial march and against
wavetpu's overlap mode, on the CPU.

The port's contract is stricter than wavetpu's: the overlapped march
equals the serial one bit for bit, states and error vectors (the face
patches keep K6's operation order).  Against wavetpu's overlap mode (f64,
Pallas in interpret mode on the 8 virtual CPU devices) the states and
errors agree within 1e-12 (tests/test_sharded_kernels.py's contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.solver import sharded as jsharded
from wavetpu_torch import cli
from wavetpu_torch.core import grid
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_ref
from wavetpu_torch.solver import sharded

CPU8 = ["cpu"] * 8
MESHES = [(2, 2, 2), (4, 1, 1), (1, 2, 2), (2, 2, 1)]


def _solve(p, mesh, overlap, dtype=torch.float32, field=False):
    kw = {}
    if field:
        kw = dict(c2tau2_field=stencil_ref.make_preset_c2tau2_field(
            p, "gaussian-lens"), compute_errors=False)
    return sharded.solve_sharded(p, mesh, CPU8, dtype=dtype,
                                 overlap=overlap, **kw)


@pytest.mark.parametrize("field", [False, True], ids=["const", "lens"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16],
                         ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_overlap_equals_serial_bitwise(mesh, dtype, field):
    p = Problem(N=16, timesteps=6)
    ser = _solve(p, mesh, False, dtype, field)
    ovl = _solve(p, mesh, True, dtype, field)
    for a, b in ((ser.u_cur, ovl.u_cur), (ser.u_prev, ovl.u_prev)):
        assert torch.equal(a.assemble("cpu"), b.assemble("cpu"))
    assert np.array_equal(ser.abs_errors, ovl.abs_errors)
    assert np.array_equal(ser.rel_errors, ovl.rel_errors)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_overlap_matches_wavetpu_overlap_f64(mesh):
    ours = _solve(Problem(N=16, timesteps=8), mesh, True, torch.float64)
    ref = jsharded.solve_sharded(JProblem(N=16, timesteps=8),
                                 mesh_shape=mesh, dtype=jnp.float64,
                                 kernel="pallas", overlap=True)
    np.testing.assert_allclose(state.assemble_sharded(ours.u_cur),
                               np.asarray(ref.u_cur), rtol=0, atol=1e-12)
    np.testing.assert_allclose(state.assemble_sharded(ours.u_prev),
                               np.asarray(ref.u_prev), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=1e-12)


def _blocks(n, mesh_shape, seed, dtype=torch.float64):
    topo = grid.Topology(n, mesh_shape)
    mesh = grid.build_mesh(mesh_shape, ["cpu"] * topo.n_devices)
    rng = np.random.default_rng(seed)
    fund = torch.from_numpy(rng.standard_normal((n,) * 3)).to(dtype)
    return topo, mesh, grid.split_global(grid.pad_global(fund, topo), topo,
                                         mesh).blocks


@pytest.mark.parametrize("mesh_shape", [(2, 1, 1), (1, 2, 2), (2, 2, 2)])
def test_self_ghosts_are_wavetpus_wrap_planes(mesh_shape):
    topo, _, blocks = _blocks(8, mesh_shape, 3)
    for u in blocks:
        ours = sharded._self_ghosts(u, topo)
        ref = jsharded._self_ghosts(jnp.asarray(u.numpy()))
        for axis in range(3):
            for a, b in zip(ours[axis], ref[axis]):
                assert np.array_equal(a.numpy(), np.asarray(b))
            # A copy where the exchange copies (mesh dim > 1), a view of
            # the block where it takes one.
            copied = ours[axis][0].data_ptr() != u.narrow(
                axis, u.shape[axis] - 1, 1).data_ptr()
            assert copied == (mesh_shape[axis] > 1)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("q", [0, 2, 3])
def test_face_block_extends_to_wavetpus_face_slab(axis, q):
    """The face plane as a one-plane block with its ghosts, extended by one
    ghost cell per side, is wavetpu's `_face_ext` slab (interior planes
    included: q = 2 of 4 takes both neighbours from the block)."""
    rng = np.random.default_rng(10 + axis)
    u = rng.standard_normal((4, 4, 4))
    ghosts = []
    for a in range(3):
        face = list(u.shape)
        face[a] = 1
        ghosts.append(tuple(rng.standard_normal(face) for _ in range(2)))
    fu, fg = sharded._face_block(
        torch.from_numpy(u), [tuple(map(torch.from_numpy, g))
                              for g in ghosts], axis, q, (2, 2, 2))
    ours = stencil_ref.ghost_extend(fu, fg)
    ref = jsharded._face_ext(jnp.asarray(u), [tuple(map(jnp.asarray, g))
                                              for g in ghosts], axis, q)
    assert np.array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (2, 2, 2)])
def test_overlap_step_without_exchange_equals_serial(mesh_shape):
    """The probe's exchange-free step (self ghosts) is the same in both
    modes, as the exchanged one is."""
    p = Problem(N=8, timesteps=4)
    topo, mesh, prev = _blocks(8, mesh_shape, 5)
    _, _, cur = _blocks(8, mesh_shape, 6)
    offsets = [sharded._shard_offsets(topo, c) for c in mesh.coords]
    fields = [None] * len(cur)
    outs = [sharded._make_local_step(p, topo, mesh, offsets, "pallas", ov,
                                     exchange=False)(prev, cur, fields)
            for ov in (False, True)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_overlap_refusals():
    with pytest.raises(ValueError, match="overlap mode requires N "
                                         "divisible"):
        _solve(Problem(N=15, timesteps=3), (2, 1, 1), True)
    with pytest.raises(ValueError, match="compensated"):
        sharded.solve_sharded(Problem(N=8, timesteps=3), (2, 1, 1),
                              ["cpu"] * 2, scheme="compensated",
                              overlap=True)


@pytest.mark.parametrize("argv,needle", [
    (["--backend", "single", "--overlap"], "applies to the sharded backend"),
    (["--mesh", "2,1,1", "--fuse-steps", "2", "--overlap"],
     "not --fuse-steps"),
    (["--mesh", "2,1,1", "--scheme", "compensated", "--overlap"],
     "--overlap is not available for the compensated scheme"),
    (["--mesh", "3,1,1", "--overlap"], "overlap mode requires N divisible"),
], ids=["single", "kfused", "compensated", "uneven"])
def test_cli_overlap_refusals_exit_2(argv, needle, capsys):
    assert cli.main(["8", "1", "1", "1", "1"] + argv
                    + ["--platform", "cpu"]) == 2
    assert needle in capsys.readouterr().err
