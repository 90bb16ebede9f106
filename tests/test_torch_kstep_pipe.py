"""K3, K8, K9 and K10's x-streaming pipeline (csrc/kstep_pipe.cu) on the
CPU.

The kernel itself runs on the card (tests/test_torch_gpu.py::test_k3,
test_k8, test_k9, test_k10, test_k3_k8_pipeline_tiles,
test_k9_k10_pipeline_tiles).  Here:

* K3's plain version equals K8's plain chain fed the state's own wrap
  planes as its x windows, bit for bit (states and error rows): on the card
  K3 is the pipeline over the whole state with those windows.
* `kstep_pipe_tile` fits a block for every k and every depth the solvers
  launch: K3's and K8's, every pad-and-mask layout of K9 and every
  y-extended block of K10.
* A torch emulation of the pipeline's schedule - stage s at step t makes
  plane t - s from stage s-1's three planes, one (ty, tz) face at a time,
  inside a face that shrinks by one cell per side per stage; the chain
  lo | block[:n_real] | hi | zero; whole y rows that wrap or a y-extended
  block; a last segment that ends at the depth - equals the plain versions
  of K8, K9 and K10 bit for bit, so a wrong stage, slot, reach, pad plane
  or row shows here.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda
from wavetpu_torch.kernels.stencil_ref import compute_dtype
from wavetpu_torch.solver import sharded_kfused

SMEM = 227 * 1024  # shared memory a block can use on the H100


def operands(d, n, k, dtype, with_field, seed, ny=None, ext=False):
    """Random (u_prev, u) blocks of py rows, their (k, py, N) windows, a
    positive field and its windows, and the (ny, N) oracle planes, made
    with numpy: py = ny = N (whole y rows) by default; with `ext` the
    y-extended block, py = ny + 2k."""
    rng = np.random.default_rng(seed)
    p = Problem(N=n, timesteps=20)
    ny = n if ny is None else ny
    py = ny + 2 * k if ext else ny

    def arr(shape, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * scale)

    up, u = arr((d, py, n)).to(dtype), arr((d, py, n)).to(dtype)
    pw = (arr((k, py, n)).to(dtype), arr((k, py, n)).to(dtype))
    cw = (arr((k, py, n)).to(dtype), arr((k, py, n)).to(dtype))
    fld = fw = None
    if with_field:
        def c2(shape):
            return p.a2tau2 * (0.5 + torch.from_numpy(
                rng.random(shape).astype(np.float32)))
        fld, fw = c2((d, py, n)), (c2((k, py, n)), c2((k, py, n)))
    syz = torch.from_numpy(rng.random((ny, n)).astype(np.float32))
    rsyz = torch.from_numpy(rng.random((ny, n)).astype(np.float32))
    sxct = torch.from_numpy(rng.random((k, d)).astype(np.float32))
    return p, (up, u, pw, cw, syz, rsyz, sxct), fld, fw


def same(got, want):
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b)


# (k, N): for each k the smallest and the largest multiple of k in 8..32.
K3_CASES = [(k, n) for k in range(2, 9)
            for n in sorted({-(-8 // k) * k, 32 // k * k})]


@pytest.mark.parametrize("k,n", K3_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_k3_is_k8_over_the_wrap_planes(k, n, dtype, with_field,
                                       with_errors):
    p, (up, u, _, _, syz, rsyz, sxct), fld, _ = operands(
        n, n, k, dtype, with_field, seed=n * 10 + k)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors)
    want = stencil_cuda.fused_kstep_plain(up, u, syz, rsyz, sxct,
                                          c2tau2_field=fld, **kw)
    got = stencil_cuda.fused_kstep_sharded_plain(
        up, u, stencil_cuda.wrap_planes(up, k), stencil_cuda.wrap_planes(u, k),
        syz, rsyz, sxct, c2tau2_block=fld,
        c2_ghosts=stencil_cuda.wrap_planes(fld, k), **kw)
    same(got, want)


def test_wrap_planes_are_views():
    t = torch.arange(5 * 3 * 2, dtype=torch.float32).reshape(5, 3, 2)
    lo, hi = stencil_cuda.wrap_planes(t, 2)
    assert torch.equal(lo, t[3:]) and torch.equal(hi, t[:2])
    assert lo.data_ptr() == t[3].data_ptr() and hi.data_ptr() == t.data_ptr()
    assert lo.is_contiguous() and hi.is_contiguous()
    assert stencil_cuda.wrap_planes(None, 2) is None


def check_tile(k, d):
    """kstep_pipe_tile(k, d) fits a block: the fewest segments of at most
    _KPIPE_SEG planes, balanced (no segment short), the face's threads
    and shared memory within the card's."""
    seg, ty, tz = stencil_cuda.kstep_pipe_tile(k, d)
    nseg = -(-d // seg)
    assert 1 <= seg <= min(d, stencil_cuda._KPIPE_SEG)
    assert nseg == -(-d // stencil_cuda._KPIPE_SEG)  # the fewest
    assert nseg * seg - d < nseg  # balanced: the overlap is under a plane
    assert seg >= min(d, stencil_cuda._KPIPE_SEG // 2)  # none is short
    assert ty >= 1 and tz >= 1
    threads = (ty + 2 * k) * (tz + 2 * k)
    assert threads <= stencil_cuda.pipe_max_threads(k) <= 1024
    assert threads % 32 == 0  # whole warps, one per z row
    assert stencil_cuda.kstep_pipe_smem(k, ty, tz) <= SMEM
    return seg, ty, tz


@pytest.mark.parametrize("k", range(1, 9))
def test_kstep_pipe_tile_fits_a_block(k):
    # Every depth the solvers launch K3 (k | N) and K8 (k | N/MX) at.
    for d in range(k, 601, k):
        check_tile(k, d)


@pytest.mark.parametrize("k", range(2, 9))
def test_kstep_pipe_tile_fits_every_k9_and_k10_block(k):
    # K9: every pad-and-mask layout (D, the last shard's r) of N 8..600 on
    # 1..8 x shards that the solver routes to it.  K10: every y-extended
    # block (N/MX, N/MY + 2k, N) of an even (MX, MY > 1, 1) mesh.
    k9 = k10 = 0
    for n in range(8, 601):
        p = Problem(N=n, timesteps=1)
        for mx in range(1, 9):
            if not sharded_kfused._is_even(p, k, mx):
                try:
                    bx, d, r = sharded_kfused.uneven_layout(p, k, mx)
                except ValueError:
                    continue  # the solver refuses this mesh at this k
                assert d % bx == 0 and 1 <= r <= d
                check_tile(k, d)
                k9 += 1
                continue
            d = n // mx
            for my in range(2, 9):
                if n % my or n // my < k:
                    continue
                check_tile(k, d)  # the tile does not depend on the rows
                k10 += 1
    assert k9 > 1000 and k10 > 100


@pytest.mark.parametrize("k,d,seg", [(4, 512, 128), (4, 128, 128),
                                     (1, 8, 8), (8, 8, 8), (3, 48, 48),
                                     (5, 15, 15), (4, 20, 20), (2, 148, 74),
                                     (4, 200, 100), (7, 539, 108),
                                     (4, 1048, 117), (2, 510, 128),
                                     (4, 129, 65)])
def test_kstep_pipe_segment(k, d, seg):
    assert stencil_cuda.kstep_pipe_tile(k, d)[0] == seg
    assert stencil_cuda.kstep_pipe_tile(k, d)[1:] == \
        stencil_cuda.comp_pipe_tile(k, d)[1:]


def emulate_pipe(up, u, pw, cw, syz, rsyz, sxct, *, k, coeff, inv_h2, fld,
                 fw, with_errors, tile, n_real=None, y0=0, nl_y=None):
    """K8, K9 and K10 as csrc/kstep_pipe.cu schedules them, in torch: per
    (x segment, y tile, z tile) block - the last segment ending at the
    depth - the (ty+2k, tz+2k) halo face walks the segment's chain planes;
    at step t stage 0 takes chain plane t and stage s makes plane t - s
    from stage s-1's planes t-s-1, t-s, t-s+1 (u) and t-s (u_prev, field),
    on the cells whose distance to the face's edge is at least s.  Stage k
    writes (u_prev, u) = (its input, its output), zero past `n_real`.  The
    chain is lo | block[:n_real] | hi | zero.  With `nl_y` the block is
    y-extended (py = nl_y + 2k rows): a face row yo of the central rows
    reads block row min(yo + k, py - 1), the mask tests the global row
    (y0 + yo) mod N."""
    d, py, n = u.shape
    ny = py if nl_y is None else nl_y
    n_real = d if n_real is None else n_real
    seg, ty, tz = tile
    f = compute_dtype(u.dtype)
    ix, iy, iz = inv_h2

    def chain(blk, win):
        pad = torch.zeros((d - n_real,) + tuple(blk.shape[1:]),
                          dtype=blk.dtype)
        return torch.cat([win[0], blk[:n_real], win[1], pad]).to(f)

    UP, U = chain(up, pw), chain(u, cw)
    FL = None if fld is None else chain(fld, fw)
    prev_out = torch.empty((d, ny, n), dtype=u.dtype)
    out = torch.empty_like(prev_out)
    dmax = torch.zeros((k, d)) if with_errors else None
    rmax = torch.zeros((k, d)) if with_errors else None
    ey, ez = ty + 2 * k, tz + 2 * k
    ly, lz = torch.arange(ey)[:, None], torch.arange(ez)[None, :]
    reach = torch.minimum(torch.minimum(ly, ey - 1 - ly),
                          torch.minimum(lz, ez - 1 - lz))
    planes = seg + 2 * k
    for x0 in (min(i * seg, d - seg) for i in range(-(-d // seg))):
        for y1 in range(0, ny, ty):
            for z1 in range(0, n, tz):
                yo = y1 - k + torch.arange(ey)  # rows among the output rows
                if nl_y is None:
                    rows = gy = yo % n
                else:
                    rows = torch.clamp(yo + k, max=py - 1)
                    gy = (y0 + yo) % n
                gz = (z1 - k + torch.arange(ez)) % n
                interior = (gy != 0)[:, None] & (gz != 0)[None, :]
                cy, cz = min(ty, ny - y1), min(tz, n - z1)  # central cells

                def face(a, j):
                    return a[x0 + j][rows][:, gz]

                W = [dict() for _ in range(k)]  # W[s][p]: stage s's u
                P = [dict() for _ in range(k)]  # ... its u_prev
                F = [dict() for _ in range(k)]  # ... its field cell
                for t in range(planes):
                    W[0][t], P[0][t] = face(U, t), face(UP, t)
                    if FL is not None:
                        F[0][t] = face(FL, t)
                    for s in range(1, k + 1):
                        p = t - s
                        if p < s or p >= planes - s:
                            continue
                        c = W[s - 1][p]
                        lap = (W[s - 1][p - 1] + W[s - 1][p + 1]
                               - 2.0 * c) * ix
                        lap = lap + (torch.roll(c, 1, 0) + torch.roll(c, -1, 0)
                                     - 2.0 * c) * iy
                        lap = lap + (torch.roll(c, 1, 1) + torch.roll(c, -1, 1)
                                     - 2.0 * c) * iz
                        co = coeff if FL is None else F[s - 1][p]
                        o = 2.0 * c + co * lap
                        o = o - P[s - 1][p]
                        o = torch.where(interior, o, 0.0)
                        if u.dtype != f:
                            o = o.to(u.dtype).to(f)
                        o = torch.where(reach >= s, o, c)
                        x = x0 + p - k  # the plane's index in the block
                        real = x < n_real
                        ctr = (slice(k, k + cy), slice(k, k + cz))
                        if with_errors and k <= p < k + seg and real:
                            sl = (slice(y1, y1 + cy), slice(z1, z1 + cz))
                            diff = (o[ctr] - sxct[s - 1, x] * syz[sl]).abs()
                            dmax[s - 1, x] = torch.maximum(
                                dmax[s - 1, x], diff.amax())
                            rmax[s - 1, x] = torch.maximum(
                                rmax[s - 1, x], (diff * rsyz[sl]).amax())
                        if s < k:
                            W[s][p], P[s][p] = o, c
                            if FL is not None:
                                F[s][p] = F[s - 1][p]
                        elif k <= p < k + seg:
                            cell = (x, slice(y1, y1 + cy), slice(z1, z1 + cz))
                            prev_out[cell] = c[ctr] if real else 0.0
                            out[cell] = o[ctr] if real else 0.0
    return prev_out, out, dmax, rmax


# (D, N, k, (seg, ty, tz)): faces that wrap in y and z, partial y/z tiles,
# one segment (seg = D) and several, a last segment that ends at D and
# overlaps the one before (seg not dividing D), D = k, and k = 1.
EMU_CASES = [(8, 10, 2, (4, 3, 4)), (8, 8, 4, (8, 2, 2)), (6, 9, 3, (3, 4, 5)),
             (4, 7, 1, (2, 3, 3)), (8, 8, 8, (8, 1, 2)),
             (12, 6, 4, (6, 6, 6)), (10, 7, 2, (4, 3, 3))]

@pytest.mark.parametrize("d,n,k,tile", EMU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_pipeline_schedule_equals_the_plain_version(d, n, k, tile, dtype,
                                                    with_field, with_errors):
    p, args, fld, fw = operands(d, n, k, dtype, with_field, seed=d + n + k)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors)
    want = stencil_cuda.fused_kstep_sharded_plain(
        *args, c2tau2_block=fld, c2_ghosts=fw, **kw)
    got = emulate_pipe(*args, fld=fld, fw=fw, tile=tile, **kw)
    same(got, want)


# K9 (D, N, k, n_real, (seg, ty, tz)): n_real inside a segment, on a
# segment boundary, at the block's end, below k (the hi window then holds
# planes of two shards), a single real plane, and a last segment that
# overlaps the one before.
K9_CASES = [(8, 10, 2, 5, (4, 3, 4)), (8, 10, 2, 4, (4, 3, 4)),
            (8, 8, 4, 3, (4, 2, 2)), (12, 6, 4, 1, (6, 6, 6)),
            (6, 9, 3, 6, (3, 4, 5)), (9, 7, 3, 7, (4, 3, 3)),
            (4, 7, 1, 2, (2, 3, 3))]


@pytest.mark.parametrize("d,n,k,n_real,tile", K9_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_pipeline_schedule_equals_k9_plain(d, n, k, n_real, tile, dtype,
                                           with_field, with_errors):
    p, (up, u, *rest), fld, fw = operands(d, n, k, dtype, with_field,
                                          seed=d + n + k + n_real)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors)
    # The pad planes hold data: the pipeline must not read them.
    want = stencil_cuda.fused_kstep_padded_plain(
        up, u, n_real, *rest, c2tau2_block=fld, c2_ghosts=fw, **kw)
    got = emulate_pipe(up, u, *rest, fld=fld, fw=fw, tile=tile,
                       n_real=n_real, **kw)
    same(got, want)
    assert not want[1][n_real:].any() and not want[0][n_real:].any()
    if with_errors:
        assert not want[2][:, n_real:].any()


# K10 (D, N, k, nl_y, y0, (seg, ty, tz)): the first (y0 = 0) and the last
# (y0 = N - nl_y) y shard, nl_y = k (a ghost strip spans a whole neighbour
# block), nl_y not a multiple of ty (the face overhangs the extension),
# k = 1, and a last segment that overlaps the one before.
K10_CASES = [(8, 12, 2, 6, 0, (4, 3, 4)), (8, 12, 2, 6, 6, (4, 4, 5)),
             (6, 12, 3, 3, 9, (3, 2, 4)), (8, 8, 4, 4, 0, (8, 3, 3)),
             (9, 10, 1, 5, 5, (4, 2, 3)), (6, 9, 3, 3, 3, (6, 5, 4))]


@pytest.mark.parametrize("d,n,k,ny,y0,tile", K10_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_pipeline_schedule_equals_k10_plain(d, n, k, ny, y0, tile, dtype,
                                            with_field, with_errors):
    p, (up, u, pw, cw, syz, rsyz, sxct), fld, fw = operands(
        d, n, k, dtype, with_field, seed=d + n + k + ny + y0, ny=ny,
        ext=True)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors)
    want = stencil_cuda.fused_kstep_sharded_xy_plain(
        up, u, pw, cw, syz, rsyz, sxct, y0, n, nl_y=ny, c2tau2_ext=fld,
        c2_ghosts=fw, **kw)
    got = emulate_pipe(up, u, pw, cw, syz, rsyz, sxct, fld=fld, fw=fw,
                       tile=tile, y0=y0, nl_y=ny, **kw)
    assert got[1].shape == (d, ny, n)
    same(got, want)


# ---------------------------------------------------------------------------
# The blocked shapes (csrc/kstep_pipe.cu `StdBlock`): R face rows a thread.


def check_block(k, d, dtype, field, pad, lanes, ext):
    """kstep_pipe_block fits a block: kstep_pipe_tile's segment, a shape
    built for the mode, the halo face's columns within threads x R, whole
    warps within the block size, the ring guards, and shared memory."""
    seg, ty, tz, r, nt = stencil_cuda.kstep_pipe_block(k, d, dtype, field,
                                                       pad, lanes, ext)
    assert seg == stencil_cuda.kstep_pipe_tile(k, d)[0]
    assert (r, nt) in stencil_cuda.kstep_pipe_shapes(k, dtype, field, pad,
                                                     lanes)
    assert ty >= 1 and tz >= 1
    threads = stencil_cuda.comp_pipe_threads(k, ty, tz, r)
    assert (ty + 2 * k) * (tz + 2 * k) <= threads * r
    assert threads % 32 == 0 and threads <= nt <= 1024
    if r == 1:
        assert (seg, ty, tz) == stencil_cuda.kstep_pipe_tile(k, d)
        assert stencil_cuda.kstep_pipe_smem(k, ty, tz) <= SMEM
    else:
        assert tz + 2 * k <= stencil_cuda._COMP_MAX_EZ
        assert stencil_cuda.kstep_pipe_smem(k, ty, tz, r, nt) <= SMEM
    assert stencil_cuda._kstep_shape(k, d, None, dtype, field, pad, lanes,
                                     ext) == (seg, ty, tz, r, nt)
    return seg, ty, tz, r, nt


MODES = [dict(), dict(field=True), dict(pad=True), dict(pad=True, field=True),
         dict(ext=True), dict(ext=True, field=True), dict(lanes=True),
         dict(lanes=True, field=True)]


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", range(len(MODES)),
                         ids=["solo", "field", "pad", "pad_field", "ext",
                              "ext_field", "lanes", "lanes_field"])
def test_kstep_pipe_block_fits_every_block_the_solvers_launch(k, dtype, mode):
    # K3 and K3 lanes (k | N), K8 (k | N/MX), K9 (every pad-and-mask
    # layout), K10 (every y-extended block of an even (MX, MY > 1, 1)
    # mesh): the chosen shape fits each depth in threads and shared memory
    # (the ring with its guards, the oracle pairs and the static slots).
    keys = dict(dict(field=False, pad=False, lanes=False, ext=False),
                **MODES[mode])
    depths = set()
    for n in range(8, 601):
        p = Problem(N=n, timesteps=1)
        if keys["pad"]:
            for mx in range(1, 9):
                if not sharded_kfused._is_even(p, k, mx):
                    try:
                        depths.add(sharded_kfused.uneven_layout(p, k, mx)[1])
                    except ValueError:
                        continue
        elif keys["ext"]:
            depths.update(n // mx for mx in range(1, 9)
                          if n % mx == 0 and (n // mx) % k == 0)
        elif keys["lanes"]:
            if n % k == 0:
                depths.add(n)
        else:
            depths.update(n // mx for mx in range(1, 9)
                          if n % mx == 0 and (n // mx) % k == 0)
    assert depths
    for d in sorted(depths):
        check_block(k, d, dtype, **keys)


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocked_shapes_only_where_built(k, dtype):
    # csrc/kstep_pipe.cu builds the blocked shapes that `_KSTEP_CHOICE`
    # launches (its WT_SHAPE lines) and no others, at k = 4 for an f32
    # state alone; every other k and dtype takes R = 1 and refuses a
    # blocked tile.
    src = open(stencil_cuda.build.CSRC / "kstep_pipe.cu").read()
    built = {(int(a), int(b))
             for a, b in re.findall(r"WT_SHAPE\((\d+), (\d+)\);", src)}
    assert built == set(stencil_cuda._KSTEP_CHOICE.values())
    blocked = k == 4 and dtype == torch.float32
    for field, pad, lanes in itertools.product((False, True), repeat=3):
        if pad and lanes:
            continue
        shapes = stencil_cuda.kstep_pipe_shapes(k, dtype, field, pad, lanes)
        assert shapes[0] == (1, stencil_cuda.pipe_max_threads(k))
        assert set(shapes[1:]) <= built and bool(shapes[1:]) == blocked
        for ext in (False, True):
            if lanes and ext or pad and ext:
                continue
            r, nt = stencil_cuda.kstep_pipe_block(k, 512, dtype, field, pad,
                                                  lanes, ext)[3:]
            assert (r, nt) in shapes and (r > 1) == blocked
        for r, nt in built:
            tile = (64, nt // 32 * r - 2 * k, 32 - 2 * k, r, nt)
            if (r, nt) in shapes:
                assert stencil_cuda._kstep_shape(
                    k, 512, tile, dtype, field, pad, lanes, False) == tile
            else:
                with pytest.raises(ValueError):
                    stencil_cuda._kstep_shape(k, 512, tile, dtype, field,
                                              pad, lanes, False)


def test_claimed_cell_takes_a_blocked_shape():
    # n512_kfused: K3 at k=4 on the whole f32 N=512 state, rows on.
    shape = stencil_cuda.kstep_pipe_block(4, 512)
    assert shape[3] >= 2
    assert stencil_cuda._kstep_shape(4, 512, None, torch.float32, False,
                                     False, False, False) == shape


@pytest.mark.parametrize("tile,ok", [
    ((128, 24, 24), True),             # r = 1: kstep_pipe_tile's face
    ((128, 24, 24, 1), True),
    ((128, 56, 24, 4), True),          # 512 threads at r = 4
    ((128, 56, 24, 4, 512), True),
    ((128, 55, 24, 4, 512), True),     # a padding row in the last thread
    ((128, 25, 24, 1), False),         # 1056 threads
    ((128, 60, 24, 4, 512), False),    # 544 threads on a 512-thread block
    ((128, 32, 24, 2, 640), False),    # not built for K3
    ((128, 8, 60, 4, 512), False),     # 68 columns: wider than a guard
    ((129, 24, 24), False),            # longer than a segment may be
    ((128, 0, 24, 4), False),
    ((128, 24, 24, 5), False),         # no r = 5 shape
])
def test_blocked_tile_checks(tile, ok):
    args = (4, 512, tile, torch.float32, False, False, False, False)
    if ok:
        seg, ty, tz, r, nt = stencil_cuda._kstep_shape(*args)
        assert (seg, ty, tz) == tile[:3] and r == (tile + (1,))[3]
        assert stencil_cuda.comp_pipe_threads(4, ty, tz, r) <= nt
    else:
        with pytest.raises(ValueError):
            stencil_cuda._kstep_shape(*args)


GUARD = stencil_cuda._COMP_MAX_EZ


def emulate_blocked(up, u, pw, cw, syz, rsyz, sxct, *, k, coeff, inv_h2,
                    fld, fw, with_errors, tile, r, nt, n_real=None, y0=0,
                    nl_y=None):
    """K8, K9 and K10 as csrc/kstep_pipe.cu's blocked body (`StdBlock`)
    schedules them, in torch over a block's threads: thread tid owns rows
    R * (tid // ez) .. + R-1 of column tid % ez of the (ty+2k, tz+2k) halo
    face.  Per stage a three-slot ring [k][3][R][nt + 2 GUARD] (word
    GUARD + tid of plane r: row r of the thread's rows), poisoned with NaN
    before each block; registers W, P, F of two slots; the left x
    neighbour from the ring slot of two steps ago, the outer rows' y
    neighbours from the thread rows above and below, the inner ones from
    registers.  A thread computes a stage when one of its cells lies in the
    stage's face.  The rows: each thread folds its central cells, each
    warp with a central cell reduces into its slot (poisoned slots of the
    other warps are zeroed at the start), and one step later the block's
    slots are reduced into the rows."""
    d, py, n = u.shape
    ny = py if nl_y is None else nl_y
    n_real = d if n_real is None else n_real
    seg, ty, tz = tile
    R = r
    f = compute_dtype(u.dtype)
    ix, iy, iz = inv_h2
    ext = nl_y is not None
    end = n_real

    def chain(blk, win):
        pad = torch.zeros((d - n_real,) + tuple(blk.shape[1:]),
                          dtype=blk.dtype)
        return torch.cat([win[0], blk[:n_real], win[1], pad]).to(f)

    UP, U = chain(up, pw), chain(u, cw)
    FL = None if fld is None else chain(fld, fw)
    prev_out = torch.full((d, ny, n), float("nan"), dtype=u.dtype)
    out = torch.full_like(prev_out, float("nan"))
    dmax = torch.zeros((k, d), dtype=torch.int32)
    rmax = torch.zeros((k, d), dtype=torch.int32)
    ey, ez = ty + 2 * k, tz + 2 * k
    nrb = -(-ey // R)
    threads = -(-(nrb * ez) // 32) * 32
    assert threads <= nt and ez <= GUARD
    warps = threads // 32
    plane = nt + 2 * GUARD
    tid = torch.arange(threads)
    live = tid < nrb * ez
    lz = torch.where(live, tid % ez, 0)
    rb = torch.where(live, tid // ez, 0)
    planes = seg + 2 * k
    big = torch.iinfo(torch.int32).max
    for xs in range(-(-d // seg)):
        x1 = min(xs * seg, d - seg)
        for y1 in range(0, ny, ty):
            for z1 in range(0, n, tz):
                gz = (z1 - k + lz) % n
                zc = (lz >= k) & (lz < k + tz) & (z1 + lz - k < n)
                zreach = torch.minimum(lz, ez - 1 - lz)
                reach = torch.full((threads,), -1)
                rows, interior, central, oy = [], [], [], []
                for q in range(R):
                    ly = rb * R + q
                    cl = live & (ly < ey)
                    yo = y1 - k + ly
                    pr = torch.clamp(yo + k, max=py - 1) if ext else yo % py
                    oy.append(yo if ext else pr)
                    rows.append((pr, gz))
                    central.append(cl & (ly >= k) & (ly < k + ty) & zc
                                   & (yo < ny))
                    interior.append(((y0 + yo) % n != 0) & (gz != 0))
                    cr = torch.minimum(torch.minimum(ly, ey - 1 - ly), zreach)
                    reach = torch.where(cl, torch.maximum(reach, cr), reach)
                wcentral = torch.stack(central).any(0).view(warps, 32).any(1)
                ring = torch.full((k, 3, R, plane), float("nan"), dtype=f)
                wmax = torch.full((2, k, 2, warps), big, dtype=torch.int32)
                wmax[:, :, :, ~wcentral] = 0
                W = torch.zeros((k, R, 2, threads), dtype=f)
                P = torch.zeros_like(W)
                F = torch.zeros_like(W)
                idx = GUARD + tid

                def load(a, t):  # chain plane x1 - k + t
                    return torch.stack([a[x1 + t][rows[q][0], rows[q][1]]
                                        for q in range(R)])

                for t in range(planes + 1):
                    q0, q1, q2 = t % 3, (t + 2) % 3, (t + 1) % 3
                    r0, r1 = t % 2, (t + 1) % 2
                    if with_errors and t > 0:  # flush step t - 1's rows
                        for s in range(1, k + 1):
                            p = t - 1 - s
                            if p < k or p >= k + seg or x1 - k + p >= n_real:
                                continue
                            x = x1 - k + p
                            for which, rows_ in ((0, dmax), (1, rmax)):
                                m = wmax[r1, s - 1, which].max()
                                rows_[s - 1, x] = torch.maximum(
                                    rows_[s - 1, x], m)
                    if t < planes:
                        W[0, :, r0] = load(U, t)
                        P[0, :, r0] = load(UP, t)
                        if FL is not None:
                            F[0, :, r0] = load(FL, t)
                        for q in range(R):
                            ring[0, q0, q, idx[live]] = W[0, q, r0][live]
                    for s in range(1, k + 1):
                        p = t - s
                        if p < s or p >= planes - s:
                            continue
                        act = reach >= s
                        rows_on = with_errors and k <= p < k + seg
                        db = torch.zeros(threads, dtype=torch.int32)
                        rb_ = torch.zeros(threads, dtype=torch.int32)
                        rg = ring[s - 1]
                        ym0 = rg[q1, R - 1, idx - ez]
                        ypR = rg[q1, 0, idx + ez]
                        x = x1 - k + p
                        for q in range(R):
                            c = W[s - 1, q, r1]
                            ym = ym0 if q == 0 else W[s - 1, q - 1, r1]
                            yp = ypR if q == R - 1 else W[s - 1, q + 1, r1]
                            lap = (rg[q2, q, idx] + W[s - 1, q, r0]
                                   - 2.0 * c) * ix
                            lap = lap + (ym + yp - 2.0 * c) * iy
                            lap = lap + (rg[q1, q, idx - 1]
                                         + rg[q1, q, idx + 1] - 2.0 * c) * iz
                            co = coeff if FL is None else F[s - 1, q, r1]
                            o = 2.0 * c + co * lap
                            o = o - P[s - 1, q, r1]
                            o = torch.where(interior[q], o, 0.0)
                            if u.dtype != f:
                                o = o.to(u.dtype).to(f)
                            if s < k:
                                W[s, q, r0] = torch.where(act, o, W[s, q, r0])
                                P[s, q, r0] = torch.where(act, c, P[s, q, r0])
                                F[s, q, r0] = torch.where(act, F[s - 1, q, r1],
                                                          F[s, q, r0])
                                ring[s, q0, q, idx[act]] = o[act]
                            else:
                                w = act & central[q]
                                cy, cz = oy[q][w], gz[w]
                                keep = torch.tensor(x < n_real)  # else +0
                                prev_out[x, cy, cz] = torch.where(
                                    keep, c[w], 0.0).to(u.dtype)
                                out[x, cy, cz] = torch.where(
                                    keep, o[w], 0.0).to(u.dtype)
                            if rows_on:
                                w = act & central[q]
                                sy = syz[oy[q].clamp(0, ny - 1), gz]
                                rs = rsyz[oy[q].clamp(0, ny - 1), gz]
                                diff = (o - sxct[s - 1, x1 + p - k] * sy).abs()
                                a = diff.view(torch.int32)
                                b = (diff * rs).abs().view(torch.int32)
                                db = torch.where(w, torch.maximum(db, a), db)
                                rb_ = torch.where(w, torch.maximum(rb_, b),
                                                  rb_)
                        if rows_on:
                            for which, v in ((0, db), (1, rb_)):
                                m = v.view(warps, 32).max(1).values
                                wmax[r0, s - 1, which] = torch.where(
                                    wcentral, m, wmax[r0, s - 1, which])
    if not with_errors:
        return prev_out, out, None, None
    return prev_out, out, dmax.view(torch.float32), rmax.view(torch.float32)


# (D, N, k, (seg, ty, tz), R, block): faces that wrap in y and z, partial
# y/z tiles, thread rows that R does not divide (ty + 2k not a multiple of
# R), faces narrower than a warp, one segment and several, a last segment
# that ends at D and overlaps the one before, k = 1 and 2.  The block sizes
# are small: the layout is the kernel's whatever the size.
BLOCKED_EMU_CASES = [(8, 10, 2, (4, 3, 4), 2, 64),
                     (8, 8, 4, (8, 2, 2), 2, 64),
                     (6, 9, 3, (3, 4, 5), 3, 96),
                     (10, 7, 2, (4, 3, 3), 3, 64),
                     (12, 6, 4, (6, 6, 6), 2, 128),
                     (4, 7, 1, (2, 3, 3), 4, 64),
                     (8, 12, 4, (8, 9, 4), 3, 96)]


@pytest.mark.parametrize("d,n,k,tile,r,nt", BLOCKED_EMU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_blocked_schedule_equals_the_plain_version(d, n, k, tile, r, nt,
                                                   dtype, with_field,
                                                   with_errors):
    p, args, fld, fw = operands(d, n, k, dtype, with_field, seed=d + n + k + r)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors)
    want = stencil_cuda.fused_kstep_sharded_plain(
        *args, c2tau2_block=fld, c2_ghosts=fw, **kw)
    got = emulate_blocked(*args, fld=fld, fw=fw, tile=tile, r=r, nt=nt, **kw)
    same(got, want)


# K9 (D, N, k, n_real, (seg, ty, tz), R, block): n_real inside a segment,
# below k, a single real plane, and a last segment that overlaps.
BLOCKED_K9_CASES = [(8, 10, 2, 5, (4, 3, 4), 2, 64),
                    (8, 8, 4, 3, (4, 2, 2), 3, 64),
                    (12, 6, 4, 1, (6, 6, 6), 2, 128),
                    (9, 7, 3, 7, (4, 3, 3), 3, 64)]


@pytest.mark.parametrize("d,n,k,n_real,tile,r,nt", BLOCKED_K9_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_blocked_schedule_equals_k9_plain(d, n, k, n_real, tile, r, nt,
                                          dtype, with_field, with_errors):
    p, (up, u, *rest), fld, fw = operands(d, n, k, dtype, with_field,
                                          seed=d + n + k + n_real + r)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors)
    want = stencil_cuda.fused_kstep_padded_plain(
        up, u, n_real, *rest, c2tau2_block=fld, c2_ghosts=fw, **kw)
    got = emulate_blocked(up, u, *rest, fld=fld, fw=fw, tile=tile, r=r,
                          nt=nt, n_real=n_real, **kw)
    same(got, want)


# K10 (D, N, k, nl_y, y0, (seg, ty, tz), R, block): the first and the last
# y shard, nl_y = k, central rows that neither ty nor R divides.
BLOCKED_K10_CASES = [(8, 12, 2, 6, 0, (4, 3, 4), 2, 64),
                     (8, 12, 2, 6, 6, (4, 4, 5), 3, 64),
                     (6, 12, 3, 3, 9, (3, 2, 4), 2, 64),
                     (8, 8, 4, 4, 0, (8, 3, 3), 3, 96),
                     (6, 9, 3, 3, 3, (6, 5, 4), 2, 96)]


@pytest.mark.parametrize("d,n,k,ny,y0,tile,r,nt", BLOCKED_K10_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_blocked_schedule_equals_k10_plain(d, n, k, ny, y0, tile, r, nt,
                                           dtype, with_field, with_errors):
    p, (up, u, pw, cw, syz, rsyz, sxct), fld, fw = operands(
        d, n, k, dtype, with_field, seed=d + n + k + ny + y0 + r, ny=ny,
        ext=True)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors)
    want = stencil_cuda.fused_kstep_sharded_xy_plain(
        up, u, pw, cw, syz, rsyz, sxct, y0, n, nl_y=ny, c2tau2_ext=fld,
        c2_ghosts=fw, **kw)
    got = emulate_blocked(up, u, pw, cw, syz, rsyz, sxct, fld=fld, fw=fw,
                          tile=tile, r=r, nt=nt, y0=y0, nl_y=ny, **kw)
    same(got, want)


@pytest.mark.parametrize("ey,ez,r,nt", [(40, 32, 2, 640), (48, 32, 3, 512),
                                        (39, 32, 2, 640), (46, 32, 3, 512),
                                        (64, 32, 4, 512), (15, 21, 2, 640),
                                        (13, 32, 3, 512), (9, 9, 4, 512)])
def test_std_ring_layout_holds_every_neighbour(ey, ez, r, nt):
    # csrc/kstep_pipe.cu's ring slot: plane q holds row q of every thread's
    # r rows at GUARD + tid, tid = (row / r) * ez + column.  Each cell has
    # its own word; a cell's y/z neighbours are the words the kernel reads
    # for them (its own registers for the rows between its thread's) and
    # every word read lies inside the slot.
    rb = -(-ey // r)
    threads = -(-(rb * ez) // 32) * 32
    assert threads <= nt
    plane = nt + 2 * GUARD

    def word(ly, lz):
        return (ly % r) * plane + GUARD + (ly // r) * ez + lz

    words = {word(y, z) for y in range(rb * r) for z in range(ez)}
    assert len(words) == rb * r * ez
    for y in range(1, ey - 1):
        for z in range(1, ez - 1):
            tid, q = (y // r) * ez + z, y % r
            if q == 0:  # the last row of the thread rows above
                assert word(y - 1, z) == (r - 1) * plane + GUARD + tid - ez
            if q == r - 1:  # the first row of the thread rows below
                assert word(y + 1, z) == GUARD + tid + ez
            assert word(y, z - 1) == word(y, z) - 1
            assert word(y, z + 1) == word(y, z) + 1
    for tid in range(threads):
        for q in range(r):
            for w in (q * plane + GUARD + tid - 1, q * plane + GUARD + tid + 1,
                      (r - 1) * plane + GUARD + tid - ez,
                      GUARD + tid + ez):
                assert 0 <= w < r * plane
