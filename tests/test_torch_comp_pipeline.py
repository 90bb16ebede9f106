"""The compensated family's carry slab rule and the pipeline tile of K4 and
K11/K12, on the CPU (csrc/comp_sharded.cu itself runs on the card:
tests/test_torch_gpu.py::test_k4, test_k11, test_k12,
test_k11_k12_pipeline_tiles).  On the card K4 launches K11's kernel over
the whole state with the state's own wrap planes as its x windows; here
K4's plain version is held bit for bit against K11's plain chain so fed.

`stencil_cuda.default_block_x` is the deepest multiple of k that divides
the depth, up to 32 planes, so a shard's default slab equals the
single-device one wherever that divides the shard depth: an x-sharded
flagship with default slabs is then bitwise equal to the single-device
one.  The deep slab keeps the flagship within tests/test_torch_solver.py's
1e-6 of an f64 reference.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.solver import leapfrog as jlf
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda
from wavetpu_torch.solver import kfused_comp

CAP = stencil_cuda._SLAB_CAP
SMEM = 227 * 1024  # shared memory a block can use on the H100


@pytest.mark.parametrize("k", range(1, 9))
def test_default_block_x_is_the_deepest_slab_up_to_the_cap(k):
    for n in range(k, 600, k):
        bx = stencil_cuda.default_block_x(n, k)
        assert bx % k == 0 and n % bx == 0 and bx <= CAP
        deeper = [m for m in range(bx + k, min(n, CAP) + 1, k) if n % m == 0]
        assert not deeper
        if any(n % m == 0 for m in range(k, min(n, CAP) + 1, k) if m > 8):
            assert bx > 8
    if 512 % k == 0:
        assert stencil_cuda.default_block_x(512, k) == CAP


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mx", [1, 2, 4])
def test_global_slab_divides_the_chip_smoke_shards(k, mx):
    # chip_smoke's meshes at N = 512: the shard slab is the global one.
    bx = stencil_cuda.default_block_x(512, k)
    assert (512 // mx) % bx == 0
    assert stencil_cuda.default_block_x(512 // mx, k) == bx


@pytest.mark.parametrize("k", range(1, 9))
def test_shard_slab_equals_single_device_slab_where_it_divides(k):
    for n in range(k, 520, k):
        bx = stencil_cuda.default_block_x(n, k)
        for mx in range(1, 9):
            if n % mx or (n // mx) % k:
                continue
            nl = n // mx
            if nl % bx == 0:
                assert stencil_cuda.default_block_x(nl, k) == bx


@pytest.mark.parametrize("k", range(1, 9))
def test_pipeline_tile_fits_a_block(k):
    # Every depth the wrappers accept (k | d, default slab), every storage
    # mode (the ring holds f32 u whatever v and the carry store).
    for d in range(k, 520, k):
        bx = stencil_cuda.default_block_x(d, k)
        seg, ty, tz = stencil_cuda.comp_pipe_tile(k, bx)
        assert bx % seg == 0 and seg <= stencil_cuda._PIPE_SEG
        assert ty >= 1 and tz >= 1
        threads = (ty + 2 * k) * (tz + 2 * k)
        assert threads <= stencil_cuda.pipe_max_threads(k) <= 1024
        assert threads % 32 == 0  # whole warps, one per z row
        assert stencil_cuda.comp_pipe_smem(
            k, 1, stencil_cuda.pipe_max_threads(k)) <= SMEM
    with pytest.raises(ValueError):
        stencil_cuda.comp_pipe_tile(9, 9)


STORAGE = {"f32v_bf16carry": (torch.float32, torch.bfloat16),
           "f32v_f32carry": (torch.float32, torch.float32),
           "f32v_nocarry": (torch.float32, None),
           "bf16v_nocarry": (torch.bfloat16, None)}


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("mode", list(STORAGE))
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_pipeline_shape_fits_a_block(k, mode, with_field):
    # comp_pipe_block for every k, storage and field, on every depth the
    # wrappers accept: the segment divides the slab, the halo face's
    # columns fit the block's threads x r, the threads fit a block size
    # built for that r, the rings fit shared memory; r = 1 is
    # comp_pipe_tile's face.
    v_dt, c_dt = STORAGE[mode]
    shapes = stencil_cuda.comp_pipe_shapes(k, v_dt, c_dt, with_field)
    for d, lanes in itertools.product(range(k, 520, k), (False, True)):
        bx = stencil_cuda.default_block_x(d, k)
        seg, ty, tz, r = stencil_cuda.comp_pipe_block(k, bx, v_dt, c_dt,
                                                      with_field, lanes)
        assert bx % seg == 0 and seg <= stencil_cuda._PIPE_SEG
        assert ty >= 1 and tz >= 1 and r in shapes
        threads = stencil_cuda.comp_pipe_threads(k, ty, tz, r)
        assert (ty + 2 * k) * (tz + 2 * k) <= threads * r
        assert threads % 32 == 0 and threads <= shapes[r] <= 1024
        assert tz + 2 * k <= stencil_cuda._COMP_MAX_EZ
        assert stencil_cuda.comp_pipe_smem(k, r, shapes[r]) <= SMEM
        if r == 1:
            assert (seg, ty, tz) == stencil_cuda.comp_pipe_tile(k, bx)
        assert stencil_cuda._comp_shape(k, bx, None, v_dt, c_dt, with_field,
                                        lanes)[:4] == (seg, ty, tz, r)


@pytest.mark.parametrize("n,lanes", [(512, False), (256, True)])
def test_claimed_cells_take_a_blocked_shape(n, lanes):
    # n512_flagship (solo, N=512) and serve_flagship_b8 (lanes, N=256): k=4,
    # f32 u and v, a bf16 carry, no field.
    bx = stencil_cuda.default_block_x(n, 4)
    shape = stencil_cuda.comp_pipe_block(4, bx, torch.float32,
                                         torch.bfloat16, False, lanes)
    assert shape[3] >= 2
    assert stencil_cuda._comp_shape(4, bx, None, torch.float32,
                                    torch.bfloat16, False,
                                    lanes)[:4] == shape


@pytest.mark.parametrize("tile,ok", [
    ((32, 24, 24), True),          # r = 1: comp_pipe_tile's face
    ((32, 24, 24, 1), True),
    ((32, 32, 24, 2), True),       # 640 threads
    ((32, 24, 24, 2), True),       # 512 of the 640-thread block
    ((32, 40, 24, 3), True),
    ((32, 38, 24, 3), True),       # 512, a padding row
    ((32, 48, 24, 2), False),      # 768 threads: no such block built
    ((32, 24, 24, 4), False),      # no r = 4 shape
    ((32, 25, 24, 1), False),      # 1056 threads
    ((32, 8, 60, 1), False),       # 68 columns: wider than a ring's guard
    ((12, 24, 24, 2), False),      # 12 does not divide the 32-plane slab
    ((32, 0, 24, 2), False),
])
def test_blocked_shape_checks(tile, ok):
    args = (4, 32, tile, torch.float32, torch.bfloat16, False)
    if ok:
        seg, ty, tz, r, block = stencil_cuda._comp_shape(*args)
        assert (seg, ty, tz) == tile[:3] and r == (tile + (1,))[3]
        assert stencil_cuda.comp_pipe_threads(4, ty, tz, r) <= block
    else:
        with pytest.raises(ValueError):
            stencil_cuda._comp_shape(*args)


@pytest.mark.parametrize("mode", ["f32v_f32carry", "f32v_nocarry",
                                  "bf16v_nocarry"])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_blocked_shapes_only_where_built(mode, with_field):
    # Other storage modes and the field forms take r = 1 alone at k=4, as
    # does the flagship's storage with a field.
    v_dt, c_dt = STORAGE[mode]
    for field in (with_field, True):
        for dt in ((v_dt, c_dt), (torch.float32, torch.bfloat16)):
            if dt == (torch.float32, torch.bfloat16) and not field:
                continue
            assert list(stencil_cuda.comp_pipe_shapes(4, *dt, field)) == [1]
            with pytest.raises(ValueError):
                stencil_cuda._comp_shape(4, 32, (32, 24, 24, 2), *dt, field)


@pytest.mark.parametrize("ey,ez,r", [(40, 32, 2), (32, 32, 2), (48, 32, 3),
                                     (46, 32, 3), (15, 21, 2), (13, 32, 3),
                                     (9, 9, 3), (32, 32, 1), (20, 32, 1)])
def test_ring_layout_holds_every_neighbour(ey, ez, r):
    # csrc/comp_sharded.cu's ring slot: plane q holds row q of every
    # thread's r rows at guard + tid, tid = (row / r) * ez + column.  Each
    # cell has its own word; a cell's y/z neighbours are the words the
    # kernel reads for them (its own registers for the rows between its
    # thread's) and lie inside the slot.
    guard = stencil_cuda._COMP_MAX_EZ
    rb = -(-ey // r)
    threads = rb * ez
    plane = -(-threads // 32) * 32 + 2 * guard

    def word(ly, lz):
        return (ly % r) * plane + guard + (ly // r) * ez + lz

    words = {word(y, z) for y in range(rb * r) for z in range(ez)}
    assert len(words) == rb * r * ez
    for y in range(1, ey - 1):
        for z in range(1, ez - 1):
            tid, q = (y // r) * ez + z, y % r
            up = word(y - 1, z) if q == 0 else None
            dn = word(y + 1, z) if q == r - 1 else None
            if up is not None:  # the last row of the thread rows above
                assert up == (r - 1) * plane + guard + tid - ez
            if dn is not None:  # the first row of the thread rows below
                assert dn == guard + tid + ez
            assert word(y, z - 1) == word(y, z) - 1
            assert word(y, z + 1) == word(y, z) + 1
    for y in (0, rb * r - 1):
        for z in (0, ez - 1):
            tid, q = (y // r) * ez + z, y % r
            for w in (q * plane + guard + tid - 1, q * plane + guard + tid + 1,
                      (r - 1) * plane + guard + tid - ez, guard + tid + ez):
                assert 0 <= w < r * plane


@pytest.mark.parametrize("k,bx,seg", [(4, 64, 32), (4, 8, 8), (4, 4, 4),
                                      (3, 48, 24), (1, 64, 32), (8, 64, 32),
                                      (5, 15, 15)])
def test_pipeline_segment_lies_in_one_slab(k, bx, seg):
    assert stencil_cuda.comp_pipe_tile(k, bx)[0] == seg


def test_x_sharded_flagship_with_default_slabs_equals_the_flagship():
    # N = 2 x cap: the global slab (the cap) divides the shard depth of mesh
    # (2, 1, 1), so K11 runs K4's slab partition with no block_x given.
    p = Problem(N=2 * CAP, timesteps=6)
    assert stencil_cuda.default_block_x(CAP, 4) == stencil_cuda.\
        default_block_x(2 * CAP, 4) == CAP
    a = kfused_comp.solve_kfused_comp_sharded(p, mesh_shape=(2, 1, 1), k=4,
                                              devices=["cpu"] * 2)
    b = kfused_comp.solve_kfused_comp(p, k=4, device="cpu")
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.comp_carry.fundamental(), b.comp_carry)
    assert torch.equal(a.comp_v.fundamental(), b.comp_v)


@pytest.mark.parametrize("n", [32, 64])
def test_deep_slab_flagship_stays_within_f64_tolerance(n):
    case = dict(N=n, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=21)
    assert stencil_cuda.default_block_x(n, 4) == CAP  # not 8-deep
    ours = kfused_comp.solve_kfused_comp(Problem(**case), k=4, device="cpu")
    ref64 = jlf.solve(JProblem(**case), dtype=jnp.float64)
    diff = np.max(np.abs(ours.u_cur.to(torch.float64).numpy()
                         - np.asarray(ref64.u_cur, np.float64)))
    assert diff < 1e-6
    assert np.isfinite(ours.abs_errors).all()


@pytest.mark.parametrize("mode", ["f32v_bf16carry", "f32v_f32carry",
                                  "f32v_nocarry", "bf16v_nocarry"])
@pytest.mark.parametrize("n,k,bx", [(16, 1, 8), (16, 4, 16), (24, 4, 8),
                                    (15, 3, 15), (16, 8, 8), (12, 4, 4)])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k4_is_k11_over_the_wrap_planes(mode, n, k, bx, with_field):
    v_dt, c_dt = {"f32v_bf16carry": (torch.float32, torch.bfloat16),
                  "f32v_f32carry": (torch.float32, torch.float32),
                  "f32v_nocarry": (torch.float32, None),
                  "bf16v_nocarry": (torch.bfloat16, None)}[mode]
    p = Problem(N=n, timesteps=20)
    rng = np.random.default_rng(n * 10 + k)

    def arr(scale, dt=torch.float32):
        return torch.from_numpy(
            rng.standard_normal((n, n, n)).astype(np.float32) * scale).to(dt)

    u, v = arr(1.0), arr(1e-3, v_dt)
    c = None if c_dt is None else arr(1e-8, c_dt)
    fld = (p.a2tau2 * (0.5 + torch.from_numpy(
        rng.random((n, n, n)).astype(np.float32)))) if with_field else None
    syz = torch.from_numpy(rng.random((n, n)).astype(np.float32))
    rsyz = torch.from_numpy(rng.random((n, n)).astype(np.float32))
    sxct = torch.from_numpy(rng.random((k, n)).astype(np.float32))

    def wrap(t):
        return None if t is None else (t[n - k:], t[:k])

    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, block_x=bx,
              with_errors=not with_field)
    want = stencil_cuda.fused_kstep_comp_plain(
        u, v, c, syz, rsyz, sxct, c2tau2_field=fld, **kw)
    got = stencil_cuda._comp_chain_plain(
        u, v, c, wrap(u), wrap(v), syz, rsyz, sxct, c2tau2_block=fld,
        c2_ghosts=wrap(fld), **kw)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)
