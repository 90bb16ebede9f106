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
