"""Temporally fused k-step solver over an (MX, MY, 1)-sharded mesh (torch
port of wavetpu/solver/sharded_kfused.py).

Composes the k-step kernel (solver/kfused.py) with the mesh of
solver/sharded.py: ghosts are exchanged once per k layers - the
reference's per-layer exchange (mpi_new.cpp:327-352) amortized k-fold (the
same halo bytes per layer, k times fewer messages).  Three kernels,
dispatched on the decomposition, all three on csrc/kstep_pipe.cu's
x-streaming pipeline:

 * **even, x-only** ((MX, 1, 1), MX | N and k | N/MX): K8
   (`stencil_cuda.fused_kstep_sharded`) on the (N/MX, N, N) blocks, y and
   z whole;
 * **pad-and-mask** (x-only, anything else; the reference's remainder
   folding, mpi_sol.cpp:417-421): every shard holds a uniform padded depth
   D and the last one r <= D real planes; K9 (`fused_kstep_padded`) masks
   the pad.  A (1, 1, 1) mesh is the single-device run with k not
   dividing N;
 * **x/y** ((MX, MY > 1, 1), even): each block is first extended with k
   cyclic ghost rows per y side (`comm.halo.extend_y`), then its x ghost
   windows are cut from the x neighbours' EXTENDED blocks, which delivers
   the diagonal corner cells with no extra exchange; K10
   (`fused_kstep_sharded_xy`) marches the extended block and writes its
   central rows, re-zeroing the wrapped global y = 0 row wherever it sits.

The x ghost windows are the k real planes globally before a shard's first
plane and after its last real one, cyclically.  A window is copied from
as many shards as it spans: two when the last shard owns r < k real planes
(wavetpu's two-hop seam, sharded_kfused.py:523-533).  On a mesh with one
x shard the windows are views of the block (no copy).  A field's y
extension and windows are built once per solve per depth (k for the
blocks, 1 for the bootstrap and the tail).

Per-layer L-inf errors: each shard's kernel emits (k, D) per-x-plane
maxes over its y range; at the end the rows of all layers are read back
once, their max taken across the y shards of each x column (NaN wins, as
`lax.pmax`), concatenated along x and turned into per-layer abs/rel
errors (`kfused._block_errors`).  The state equals the single-device
solve bit for bit (K8 and K10 against `kfused.solve_kfused`, K9 against
`leapfrog.solve`); the errors equal the full-field errors within 1e-6
(the rows multiply the oracle as ct*sx*syz, the full-field pass as
sx*sy*sz*ct).

`resume_sharded_kfused` and `make_chunk_runner` re-enter the march at a
given layer from state on the Topology layout (a sharded checkpoint's, or
wavetpu's padded global arrays); on the pad-and-mask path they convert it
to the D-deep padded blocks K9 marches and back
(`_from_topology_layout`, `_to_topology_layout`: x slabs moved between
shards, `_move_x`), as wavetpu's supervisor does per chunk.

Under `--distributed` (comm/dist.py) each process marches its own shards:
the windows, the y extension and the layout moves cross ranks through
`halo.transfer` (shapes from the layout, never from a block the rank
lacks), and the error rows of every shard are gathered
(`dist.gather_shards`) before `rows_max_y` takes their max.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from wavetpu_torch.comm import dist, halo
from wavetpu_torch.core.grid import (
    ShardedArray, Topology, build_mesh, each, split_global,
)
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.obs import tracing
from wavetpu_torch.solver import kfused, leapfrog, phases

MAX_K = 8  # the k-step pipeline of K8-K10 (stencil_cuda._KSTEP_MAX_K)


def _is_even(problem: Problem, k: int, n_x: int) -> bool:
    """True when the x decomposition divides evenly (K8's path); False
    routes to the pad-and-mask path (K9)."""
    return problem.N % n_x == 0 and (problem.N // n_x) % k == 0


def uneven_layout(problem: Problem, k: int, n_x: int) -> Tuple[int, int, int]:
    """(bx, D, r) for the pad-and-mask path.

    bx is the padding granule, a multiple of k up to 8 (wavetpu's k-step
    block depth, which the TPU chooser caps at 8 planes); D = bx *
    ceil(N / (MX * bx)) the uniform padded per-shard depth; r = N -
    (MX-1)*D the last shard's real planes.  The deepest bx that leaves
    r >= 1 wins.  wavetpu's chooser reads the TPU's VMEM instead; since
    bx = k gives the smallest D, this rule accepts every (N, MX, k) that
    wavetpu accepts, and the state does not depend on (bx, D, r).  K9's
    pipeline takes any D (`stencil_cuda.kstep_pipe_tile`).  Raises when
    even bx = k leaves the last shard empty: the mesh is too large for N
    at this k.
    """
    n = problem.N
    best = None
    for bx in range(k, MAX_K + 1, k):
        d = bx * (-(-n // (n_x * bx)))
        r = n - (n_x - 1) * d
        if r >= 1:
            best = (bx, d, r)
    if best is None:
        raise ValueError(
            f"no pad-and-mask layout for N={n} over {n_x} x-shards at "
            f"k={k}: every candidate leaves the last shard empty; use fewer "
            f"shards or a smaller k"
        )
    return best


def _validate(problem: Problem, k: int, n_x: int, n_y: int = 1,
              c2tau2_field=None, compute_errors: bool = True):
    if c2tau2_field is not None and compute_errors:
        raise ValueError(
            "variable-c runs have no analytic oracle; pass "
            "compute_errors=False with c2tau2_field"
        )
    if k < 2:
        raise ValueError(f"k must be >= 2 (got {k})")
    if k > MAX_K:
        raise ValueError(f"k must be <= {MAX_K} (got {k}): the k-step "
                         f"pipeline holds at most {MAX_K} stages")
    if n_x < 1 or n_y < 1:
        raise ValueError(
            f"mesh axes must be >= 1 (got MX={n_x}, MY={n_y})"
        )
    if problem.N < k:
        raise ValueError(f"k={k} exceeds N={problem.N}")
    if not _is_even(problem, k, n_x):
        if n_y > 1:
            raise ValueError(
                f"2D-mesh k-fusion needs N % MX == 0 and k | N/MX "
                f"(N={problem.N}, MX={n_x}, k={k}); uneven N is "
                f"supported on (MX, 1, 1) meshes"
            )
        uneven_layout(problem, k, n_x)  # raises if no layout exists
    if problem.N % n_y:
        raise ValueError(
            f"y-sharded k-fusion needs N % y-shards == 0 "
            f"(N={problem.N}, y-shards={n_y})"
        )
    if problem.N // n_y < k:
        raise ValueError(
            f"k={k} exceeds the y shard depth {problem.N // n_y} "
            f"(the k-row ghost strip must fit one neighbour)"
        )


def _assemble_errors(oracle_parts, dmax_rows, rmax_rows):
    """Global per-layer abs/rel errors from (layers, X) plane-max rows
    (kfused._block_errors over all layers at once)."""
    _, ct, _, _, xmask, inv_absx = oracle_parts
    return kfused._block_errors(
        dmax_rows, rmax_rows, ct[: dmax_rows.shape[0]], xmask, inv_absx
    )


def _layer_rows_local(u, sxct_row, syz, rsyz, f):
    """(1, D) per-x-plane abs/rel error maxes of one stored layer's block
    against its oracle slice - the bootstrap layer's counterpart of the
    kernels' in-kernel rows (wavetpu's kfused._layer_rows_local)."""
    diff = (u.to(f) - sxct_row[:, None, None] * syz[None]).abs()
    d = diff.amax(dim=(1, 2))[None]
    r = (diff * rsyz[None]).amax(dim=(1, 2))[None]
    return d, r


def _windows(blocks: Sequence[torch.Tensor], counts: Sequence[int], mesh,
             kk: int, columns: Optional[Sequence[Sequence[int]]] = None):
    """Every shard's (lo, hi) ghost windows of depth kk along the x
    columns of the mesh (`columns`: lists of shard indices, x order;
    default one column of every shard): the kk real planes globally
    before a shard's first plane and after its last real one (shard
    column[j] owns counts[j] real planes, cyclically), each copied onto
    the shard's device from as many shards as it spans - one exchange
    (`halo.transfer`) for all columns.  A 1-shard column takes views of
    its own block.  None at shards of other ranks."""
    if columns is None:
        columns = [list(range(len(blocks)))]
    ref = blocks[mesh.local[0]]
    out = [None] * len(blocks)
    moves, recipe = [], []

    def piece(src, dst, lo, hi):
        b = blocks[src]
        moves.append((src, dst, None if b is None else b[lo:hi],
                      (hi - lo,) + tuple(ref.shape[1:]), ref.dtype))
        return len(moves) - 1

    for column in columns:
        m = len(column)
        for i, dst in enumerate(column):
            if m == 1:
                r = counts[0]
                if blocks[dst] is not None:
                    out[dst] = (blocks[dst][r - kk:r], blocks[dst][:kk])
                continue
            lo, need, j = [], kk, i
            while need:
                j = (j - 1) % m
                take = min(need, counts[j])
                lo.insert(0, piece(column[j], dst, counts[j] - take,
                                   counts[j]))
                need -= take
            hi, need, j = [], kk, i
            while need:
                j = (j + 1) % m
                take = min(need, counts[j])
                hi.append(piece(column[j], dst, 0, take))
                need -= take
            recipe.append((dst, lo, hi))
    got = halo.transfer(mesh, moves)
    for dst, lo, hi in recipe:
        if mesh.is_local(dst):
            out[dst] = tuple(got[p[0]] if len(p) == 1
                             else torch.cat([got[x] for x in p])
                             for p in (lo, hi))
    return out


def _split_x(a: torch.Tensor, d: int, mesh) -> List[torch.Tensor]:
    """The (MX * d, N, N) tensor cut into x blocks of depth d, each a
    contiguous copy on its shard's device (this process's shards; None at
    the others)."""
    return [a[i * d:(i + 1) * d].to(dev, copy=True).contiguous()
            if mesh.is_local(i) else None
            for i, dev in enumerate(mesh.devices)]


def xy_windows(blocks: Sequence[torch.Tensor], mesh, kk: int):
    """Every shard's (lo, hi) x ghost windows of depth kk on an even
    (MX, MY, 1) mesh: `_windows` along each y column of the mesh (mesh
    order is x slowest, so shard (cx, cy) is blocks[cx * MY + cy])."""
    n_x, n_y, _ = mesh.shape
    depth = blocks[mesh.local[0]].shape[0]
    return _windows(blocks, [depth] * n_x, mesh, kk,
                    [[cx * n_y + cy for cx in range(n_x)]
                     for cy in range(n_y)])


def exchange(blocks: Sequence[torch.Tensor], mesh, kk: int,
             counts: Optional[Sequence[int]] = None):
    """The k-step exchange of depth kk of every shard's block: returns (the
    blocks the kernels march, their (lo, hi) x windows).  On an x-only mesh
    the blocks are the shards' own (`counts` real planes each, default
    all); on MY > 1 they are the y-extended blocks (`halo.extend_y`) and
    the windows are cut from the x neighbours' extended blocks, which
    carries the corner cells."""
    if mesh.shape[1] == 1:
        if counts is None:
            counts = [blocks[mesh.local[0]].shape[0]] * len(blocks)
        return list(blocks), _windows(blocks, counts, mesh, kk)
    ext = halo.extend_y(blocks, mesh, kk)
    return ext, xy_windows(ext, mesh, kk)


def rows_max_y(rows: Sequence[torch.Tensor], n_x: int, n_y: int,
               device) -> torch.Tensor:
    """The (layers, MX*D) error rows: each x column's max across its y
    shards (NaN wins, as `lax.pmax`), concatenated along x, on `device`."""
    cols = []
    for cx in range(n_x):
        col = [rows[cx * n_y + cy].to(device) for cy in range(n_y)]
        cols.append(torch.stack(col).amax(dim=0))
    return torch.cat(cols, dim=1)


def _make_runner(problem: Problem, mesh, dtype, k: int,
                 compute_errors: bool, nsteps: int, c2tau2_field=None):
    """Set up the march over the (MX, MY, 1) `mesh` and return
    `(run, march, errors_of, d, counts)`: `run()` -> (u_prev blocks,
    u_cur blocks, rows) marches from layer 0 to nsteps; `march(u_prev,
    u_cur, start, stop)` (block lists in the march's layout) marches
    layers start+1..stop and returns the same; `errors_of(rows)` reads
    the kernels' error rows back as per-layer host f64 arrays of nsteps+1
    entries (zero where no layer was marched); d is the blocks' x depth
    and counts their real planes (x-only meshes)."""
    n_x, n_y, _ = mesh.shape
    devices = list(mesh.devices)
    local = mesh.local
    n = problem.N
    nl_y = n // n_y
    even = _is_even(problem, k, n_x)
    if even:
        d = n // n_x
        counts = [d] * n_x
    else:
        _, d, r = uneven_layout(problem, k, n_x)
        counts = [d] * (n_x - 1) + [r]

    def kstep(i, u_prev, u, *args, **kw):
        """Shard i's k-step on an x-only mesh: K8 on the even
        decomposition, K9 (over its real planes) on the padded one."""
        if even:
            return stencil_cuda.fused_kstep_sharded(u_prev, u, *args, **kw)
        return stencil_cuda.fused_kstep_padded(u_prev, u, counts[i], *args,
                                               **kw)
    dg = n_x * d
    f = stencil_ref.compute_dtype(dtype)
    if any(dev.type == "cuda" for dev in devices):
        stencil_cuda.load_libraries()
    host = torch.device("cpu")
    sx, ct, syz, rsyz, xmask, inv_absx = kfused._oracle_parts(problem, f,
                                                              host)
    pad = dg - n
    zpad = torch.zeros(pad, dtype=f)
    sx_p = torch.cat([sx, zpad])
    parts = (sx_p, ct, syz, rsyz, torch.cat([xmask, torch.zeros(pad,
                                                                 dtype=bool)]),
             torch.cat([inv_absx, zpad]))
    sxct_all = ct[:, None] * sx_p[None, :]                 # (T+1, MX*D)
    # The oracle rows on every device and each shard's central (nl_y, N)
    # oracle planes, in the compute dtype (f32 on the card, where K8-K10
    # take f32 or bf16 states).
    sxct_on = {devices[i]: sxct_all.to(devices[i]) for i in local}
    planes = [tuple(a[cy * nl_y:(cy + 1) * nl_y].to(dev).contiguous()
                    for a in (syz, rsyz)) if mesh.is_local(i) else None
              for i, (dev, (_, cy, _)) in enumerate(zip(devices,
                                                        mesh.coords))]
    u0 = torch.zeros((dg, n, n), dtype=dtype)
    u0[:n] = leapfrog.initial_layer0(problem, dtype, host)
    fld = None
    if c2tau2_field is not None:
        fld = torch.zeros((dg, n, n), dtype=f)
        fld[:n] = torch.as_tensor(c2tau2_field, dtype=torch.float64).to(f)
    if n_y == 1:
        u0 = _split_x(u0, d, mesh)
        fields = None if fld is None else _split_x(fld, d, mesh)
    else:
        topo = Topology(N=n, mesh_shape=mesh.shape)
        u0 = split_global(u0, topo, mesh).blocks
        fields = None if fld is None else split_global(fld, topo,
                                                       mesh).blocks

    def field_pack(kk):
        """Every shard's (field block, its window pair) at depth kk, built
        once per solve."""
        if fields is None:
            return [None] * len(devices)
        return list(zip(*exchange(fields, mesh, kk, counts)))

    fpacks = {kk: field_pack(kk) for kk in (1, k)}

    def kcall(prev, cur, kk, layer, with_errors):
        """kk fused layers (layer+1 .. layer+kk) of every shard."""
        pe, pg = exchange(prev, mesh, kk, counts)
        ce, cg = exchange(cur, mesh, kk, counts)
        outs = [None] * len(devices)
        for i in local:
            dev = devices[i]
            cx, cy, _ = mesh.coords[i]
            fp = fpacks[kk][i]
            kw = dict(k=kk, coeff=problem.a2tau2, inv_h2=problem.inv_h2,
                      c2_ghosts=None if fp is None else fp[1],
                      with_errors=with_errors)
            sxct_k = sxct_on[dev][layer + 1:layer + 1 + kk,
                                  cx * d:(cx + 1) * d].contiguous()
            if n_y == 1:
                outs[i] = kstep(
                    i, pe[i], ce[i], pg[i], cg[i], *planes[i], sxct_k,
                    c2tau2_block=None if fp is None else fp[0], **kw)
            else:
                outs[i] = stencil_cuda.fused_kstep_sharded_xy(
                    pe[i], ce[i], pg[i], cg[i], *planes[i], sxct_k,
                    cy * nl_y, n, nl_y=nl_y,
                    c2tau2_ext=None if fp is None else fp[0], **kw)
        return outs

    def new_rows():
        return [[torch.zeros((nsteps + 1, d), dtype=f, device=dev)
                 if mesh.is_local(i) else None
                 for i, dev in enumerate(devices)]
                for _ in range(2)] if compute_errors else None

    def record(rows, outs, layer, kk):
        if compute_errors:
            for i in local:
                rows[0][i][layer + 1:layer + 1 + kk] = outs[i][2]
                rows[1][i][layer + 1:layer + 1 + kk] = outs[i][3]

    def advance(prev, cur, start, stop, rows):
        """Layers start+1..stop: (stop-start)//k blocks, then k=1 tail
        launches of the same kernel."""
        nblocks = (stop - start) // k
        layer = start
        for kk, count in ((k, nblocks), (1, stop - start - nblocks * k)):
            for _ in range(count):
                outs = kcall(prev, cur, kk, layer, compute_errors)
                record(rows, outs, layer, kk)
                prev, cur = (each(lambda o: o[0], outs),
                             each(lambda o: o[1], outs))
                layer += kk
        return prev, cur

    def errors_of(rows):
        """The cross-shard assembly (wavetpu's pmax over y and rows
        out_spec P(None, "x")), read back once."""
        if not compute_errors:
            z = np.zeros(nsteps + 1)
            return z, z.copy()
        dmax, rmax = (rows_max_y(dist.gather_shards(mesh, rs), n_x, n_y,
                                 host) for rs in rows)
        with tracing.annotate("verify.errors"):
            abs_e, rel_e = _assemble_errors(parts, dmax, rmax)
        return leapfrog._host(abs_e), leapfrog._host(rel_e)

    def run():
        with phases.bootstrap():
            rows = new_rows()
            # kcall returns (layer n+k-1, layer n+k, ...): with u_prev = u
            # = u0 at k = 1 the second output is u0 + C*lap(u0) (the
            # field's cell in place of C), so layer 1 needs no half
            # coefficient.
            s0 = each(lambda o: o[1], kcall(u0, u0, 1, 0, False))
            cur = each(lambda a, b: (0.5 * (a.to(f) + b.to(f))).to(dtype),
                       u0, s0)
            if compute_errors:
                with tracing.annotate("verify.errors"):
                    for i in local:
                        dev = devices[i]
                        cx = mesh.coords[i][0]
                        dr, rr = _layer_rows_local(
                            cur[i], sxct_on[dev][1, cx * d:(cx + 1) * d],
                            *planes[i], f)
                        rows[0][i][1:2] = dr
                        rows[1][i][1:2] = rr
        with phases.march():
            prev, cur = advance(u0, cur, 1, nsteps, rows)
        return prev, cur, rows

    def march(prev, cur, start, stop):
        rows = new_rows()
        prev, cur = advance(prev, cur, start, stop, rows)
        return prev, cur, rows

    return run, march, errors_of, d, counts


def _move_x(blocks, src, dst, depth: int, mesh):
    """x slabs re-cut between two layouts of the same x-only mesh: shard i
    holds global planes [start, start + count) of `src[i]` = (start,
    count) in its block's first planes, and gets those of `dst[i]` in a
    zero block `depth` planes deep; every overlap is one move of
    `halo.transfer` (shapes from the layouts)."""
    ref = blocks[mesh.local[0]]
    yz = tuple(ref.shape[1:])
    out = [torch.zeros((depth,) + yz, dtype=ref.dtype, device=dev)
           if mesh.is_local(i) else None
           for i, dev in enumerate(mesh.devices)]
    moves = []
    for i, (d0, dn) in enumerate(dst):
        for j, (s0, sn) in enumerate(src):
            lo, hi = max(d0, s0), min(d0 + dn, s0 + sn)
            if lo >= hi:
                continue
            b, o = blocks[j], out[i]
            moves.append((j, i, None if b is None else b[lo - s0:hi - s0],
                          (hi - lo,) + yz, ref.dtype,
                          None if o is None else o[lo - d0:hi - d0]))
    halo.transfer(mesh, moves)
    return out


def _layouts(counts, d, topo: Topology):
    """The (start, count) x slabs of the pad-and-mask layout (D-deep,
    counts real planes) and of the Topology layout of an x-only mesh."""
    b, n = topo.block[0], topo.N
    return ([(i * d, c) for i, c in enumerate(counts)],
            [(i * b, min(b, n - i * b)) for i in range(len(counts))])


def _to_topology_layout(blocks, counts, problem: Problem, mesh):
    """The blocks on the standard Topology layout of the mesh: an even
    decomposition is that layout already; uneven x-only blocks (depth D,
    counts[i] real planes each, zero pad) are re-cut into ceil(N/MX)-plane
    blocks (`_move_x`), so uneven k-fused results are laid out as every
    other sharded result."""
    topo = Topology(N=problem.N, mesh_shape=mesh.shape)
    d = blocks[mesh.local[0]].shape[0]
    if d == topo.block[0]:
        return ShardedArray(list(blocks), topo, mesh)
    pad_layout, topo_layout = _layouts(counts, d, topo)
    return ShardedArray(_move_x(blocks, pad_layout, topo_layout,
                                topo.block[0], mesh), topo, mesh)


def _resolve_grid(mesh_shape, n_shards, devices):
    """(n_x, n_y) from an explicit (MX, MY, 1) mesh_shape, the x-only
    n_shards shorthand, or all given devices."""
    if mesh_shape is not None:
        if len(mesh_shape) != 3 or mesh_shape[2] != 1:
            raise ValueError(
                f"k-fusion supports (MX, MY, 1) meshes, got {mesh_shape}"
            )
        return mesh_shape[0], mesh_shape[1]
    if n_shards is None:
        n_shards = len(devices)
    return n_shards, 1


def solve_sharded_kfused(
    problem: Problem,
    n_shards: Optional[int] = None,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    stop_step: Optional[int] = None,
    devices: Optional[Sequence] = None,
    mesh_shape: Optional[Tuple[int, int, int]] = None,
    c2tau2_field=None,
) -> leapfrog.SolveResult:
    """k-fused solve over an (MX, MY, 1) mesh; the reference's timing
    phases as `leapfrog.solve`.  `n_shards` is the x-only shorthand
    (MX, 1, 1); `mesh_shape` selects a 2D decomposition (MX | N and
    k | N/MX, MY | N, N/MY >= k).  `devices` (default: every visible card)
    lists the mesh's devices in mesh order and may repeat one
    (`["cpu"] * 4`, `["cuda"] * 4`).  `c2tau2_field` (host (N, N, N) tau^2
    c^2) threads variable c through the march (pair it with
    compute_errors=False).  u_prev / u_cur are `ShardedArray`s on the
    Topology layout of the mesh."""
    devices = leapfrog.resolve_devices(devices)
    n_x, n_y = _resolve_grid(mesh_shape, n_shards, devices)
    _validate(problem, k, n_x, n_y, c2tau2_field, compute_errors)
    if len(devices) < n_x * n_y:
        raise ValueError(f"mesh ({n_x}, {n_y}, 1) needs {n_x * n_y} "
                         f"devices, only {len(devices)} available")
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    mesh = build_mesh((n_x, n_y, 1), devices[:n_x * n_y])
    with phases.SolveSpans("sharded_kfused", problem, nsteps, k) as ph:
        with ph.init():
            run, _, errors_of, d, counts = _make_runner(
                problem, mesh, dtype, k, compute_errors, nsteps,
                c2tau2_field)
            _sync(mesh)
        u_prev, u_cur, rows = run()
        with ph.readback():
            abs_np, rel_np = errors_of(rows)
            _sync(mesh)
        result = leapfrog.SolveResult(
            problem=problem,
            u_prev=_to_topology_layout(u_prev, counts, problem, mesh),
            u_cur=_to_topology_layout(u_cur, counts, problem, mesh),
            abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=stop_step, final_step=nsteps,
        )
        ph.record(result, k=k,
                  with_field=c2tau2_field is not None,
                  block=(d, problem.N // n_y, problem.N),
                  mesh_shape=(n_x, n_y, 1), rows=compute_errors)
    return result


def _sync(mesh) -> None:
    for dev in sorted({dv for dv in mesh.devices if dv.type == "cuda"},
                      key=str):
        torch.cuda.synchronize(dev)


def _from_topology_layout(a, counts, d, problem: Problem, mesh, dtype):
    """State on the Topology layout (a ShardedArray, or wavetpu's padded
    global array) as the blocks the march takes: the Topology blocks on
    an even decomposition; on the pad-and-mask path the fundamental domain
    zero-padded to MX*D planes and cut into D-deep blocks (the inverse of
    `_to_topology_layout`)."""
    topo = Topology(N=problem.N, mesh_shape=mesh.shape)
    blocks = state.to_blocks(a, topo, mesh, dtype)
    if topo.block[0] == d:
        return blocks
    pad_layout, topo_layout = _layouts(counts, d, topo)
    return _move_x(blocks, topo_layout, pad_layout, d, mesh)


def _grid_setup(problem, n_shards, devices, mesh_shape, k, compute_errors,
                c2tau2_field):
    """(devices, n_x, n_y) of a resumed or chunked march: `devices`
    default to every visible card."""
    devices = leapfrog.resolve_devices(devices)
    n_x, n_y = _resolve_grid(mesh_shape, n_shards, devices)
    _validate(problem, k, n_x, n_y, c2tau2_field, compute_errors)
    if len(devices) < n_x * n_y:
        raise ValueError(f"mesh ({n_x}, {n_y}, 1) needs {n_x * n_y} "
                         f"devices, only {len(devices)} available")
    return devices, n_x, n_y


def resume_sharded_kfused(
    problem: Problem,
    u_prev,
    u_cur,
    start_step: int,
    n_shards: Optional[int] = None,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    devices: Optional[Sequence] = None,
    mesh_shape: Optional[Tuple[int, int, int]] = None,
    c2tau2_field=None,
) -> leapfrog.SolveResult:
    """Re-enter the sharded k-fused march at layer `start_step` from
    (u_prev, u_cur) on the Topology layout of the mesh - ShardedArrays (a
    sharded checkpoint's) or wavetpu's padded global arrays; `n_shards=1`
    is the single-device pad-and-mask route.  Each substep is K1's update,
    so the resumed state equals the uninterrupted one bit for bit; the
    error vectors are zero up to start_step."""
    devices, n_x, n_y = _grid_setup(problem, n_shards, devices, mesh_shape,
                                    k, compute_errors, c2tau2_field)
    nsteps = problem.timesteps
    leapfrog._check_start(start_step, nsteps)
    mesh = build_mesh((n_x, n_y, 1), devices[:n_x * n_y])
    with phases.SolveSpans("sharded_kfused", problem, nsteps - start_step,
                           k) as ph:
        with ph.init():
            _, march, errors_of, d, counts = _make_runner(
                problem, mesh, dtype, k, compute_errors, nsteps,
                c2tau2_field)
            prev, cur = (_from_topology_layout(a, counts, d, problem, mesh,
                                               dtype)
                         for a in (u_prev, u_cur))
            _sync(mesh)
        with phases.march():
            prev, cur, rows = march(prev, cur, start_step, nsteps)
        with ph.readback():
            abs_e, rel_e = errors_of(rows)
            _sync(mesh)
        head = np.zeros(start_step + 1)
        result = leapfrog.SolveResult(
            problem=problem,
            u_prev=_to_topology_layout(prev, counts, problem, mesh),
            u_cur=_to_topology_layout(cur, counts, problem, mesh),
            abs_errors=np.concatenate([head, abs_e[start_step + 1:]]),
            rel_errors=np.concatenate([head, rel_e[start_step + 1:]]),
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=nsteps - start_step, final_step=nsteps,
        )
        ph.record(result, k=k,
                  with_field=c2tau2_field is not None,
                  block=(d, problem.N // n_y, problem.N),
                  mesh_shape=(n_x, n_y, 1), rows=compute_errors)
    return result


def make_chunk_runner(
    problem: Problem,
    length: int,
    n_shards: Optional[int] = None,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    devices: Optional[Sequence] = None,
    mesh_shape: Optional[Tuple[int, int, int]] = None,
    c2tau2_field=None,
):
    """Fixed-length re-entry of the sharded k-fused march for supervised
    solves, built once per configuration (kernels loaded, oracle rows and
    field packs on the devices): `runner(u_prev, u_cur, start)` ->
    (u_prev, u_cur, abs, rel) marches layers start+1..start+length, the
    state as ShardedArrays on the Topology layout (converted to and from
    the pad-and-mask layout where K9 marches), the errors as the chunk's
    host f64 arrays."""
    if length < 1:
        raise ValueError(f"chunk length must be >= 1, got {length}")
    devices, n_x, n_y = _grid_setup(problem, n_shards, devices, mesh_shape,
                                    k, compute_errors, c2tau2_field)
    nsteps = problem.timesteps
    mesh = build_mesh((n_x, n_y, 1), devices[:n_x * n_y])
    _, march, errors_of, d, counts = _make_runner(
        problem, mesh, dtype, k, compute_errors, nsteps, c2tau2_field)

    def run(u_prev, u_cur, start: int):
        stop = leapfrog._chunk_stop(start, length, nsteps)
        prev, cur = (_from_topology_layout(a, counts, d, problem, mesh, dtype)
                     for a in (u_prev, u_cur))
        prev, cur, rows = march(prev, cur, start, stop)
        abs_e, rel_e = errors_of(rows)
        return (_to_topology_layout(prev, counts, problem, mesh),
                _to_topology_layout(cur, counts, problem, mesh),
                abs_e[start + 1:stop + 1], rel_e[start + 1:stop + 1])

    return run
