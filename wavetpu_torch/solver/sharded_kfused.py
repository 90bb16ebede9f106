"""Temporally fused k-step solver over an x-sharded mesh (torch port of the
x-only half of wavetpu/solver/sharded_kfused.py).

Composes the k-step cone kernel (solver/kfused.py) with the mesh of
solver/sharded.py: each block (D, N, N) keeps y and z whole, and its x
neighbours come from k-plane ghost windows exchanged once per k layers -
the reference's per-layer exchange (mpi_new.cpp:327-352) amortized k-fold
(the same halo bytes per layer, k times fewer messages).  Two kernels,
dispatched on the decomposition:

 * **even** (MX | N and k | N/MX): K8 (`stencil_cuda.fused_kstep_sharded`)
   on the (N/MX, N, N) blocks;
 * **pad-and-mask** (anything else, the reference's remainder folding,
   mpi_sol.cpp:417-421): every shard holds a uniform padded depth D and the
   last one r <= D real planes; K9 (`fused_kstep_padded`) masks the pad.
   A (1, 1, 1) mesh is the single-device run with k not dividing N.

The ghost windows are the k real planes globally before a shard's first
plane and after its last real one, cyclically.  A window is copied from
as many shards as it spans: two when the last shard owns r < k real planes
(wavetpu's two-hop seam, sharded_kfused.py:523-533).  On a 1-shard mesh
the windows are views of the block (no copy).  A field's windows are
exchanged once per solve per depth (k for the blocks, 1 for the bootstrap
and the tail).

Per-layer L-inf errors: each shard's kernel emits (k, D) per-x-plane
maxes; the rows of all layers are concatenated along x once, at the end,
and turned into per-layer abs/rel errors (`kfused._block_errors`).  The
state equals the single-device solve bit for bit (K8 against
`kfused.solve_kfused`, K9 against `leapfrog.solve`); the errors equal the
full-field errors within 1e-6 (the rows multiply the oracle as
ct*sx*syz, the full-field pass as sx*sy*sz*ct).

Not ported here: meshes (MX, MY > 1, 1) (K10), the sharded compensated
k-step (K11, K12), resume and chunk runners (ROADMAP.md queue 1 items 8-10).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from wavetpu_torch.comm import halo
from wavetpu_torch.core.grid import (
    ShardedArray, Topology, build_mesh, pad_global, split_global,
)
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, leapfrog

MAX_K = 8  # the cone tile of K8/K9 (stencil_cuda.kstep_tile)


def _is_even(problem: Problem, k: int, n_x: int) -> bool:
    """True when the x decomposition divides evenly (K8's path); False
    routes to the pad-and-mask path (K9)."""
    return problem.N % n_x == 0 and (problem.N // n_x) % k == 0


def uneven_layout(problem: Problem, k: int, n_x: int) -> Tuple[int, int, int]:
    """(bx, D, r) for the pad-and-mask path.

    bx is the x tile depth of K9, a multiple of k up to the cone tile's 8;
    D = bx * ceil(N / (MX * bx)) the uniform padded per-shard depth; r =
    N - (MX-1)*D the last shard's real planes.  The deepest bx that leaves
    r >= 1 wins (a depth-8 tile is K9's fastest).  wavetpu's chooser reads
    the TPU's VMEM instead; since bx = k gives the smallest D, this rule
    accepts every (N, MX, k) that wavetpu accepts, and the state does not
    depend on (bx, D, r).  Raises when even bx = k leaves the last shard
    empty: the mesh is too large for N at this k.
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
                         f"kernels' cone tile holds no deeper cone")
    if n_x < 1 or n_y < 1:
        raise ValueError(
            f"mesh axes must be >= 1 (got MX={n_x}, MY={n_y})"
        )
    if n_y > 1:
        raise ValueError(
            f"k-fusion on a y-sharded mesh (MX={n_x}, MY={n_y}, 1) is not "
            f"ported yet: ROADMAP.md queue 1 item 10 (kernel K10, the xy "
            f"k-step)"
        )
    if problem.N < k:
        raise ValueError(f"k={k} exceeds N={problem.N}")
    if not _is_even(problem, k, n_x):
        uneven_layout(problem, k, n_x)  # raises if no layout exists


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
    kernels' in-cone rows (wavetpu's kfused._layer_rows_local)."""
    diff = (u.to(f) - sxct_row[:, None, None] * syz[None]).abs()
    d = diff.amax(dim=(1, 2))[None]
    r = (diff * rsyz[None]).amax(dim=(1, 2))[None]
    return d, r


def _windows(blocks: Sequence[torch.Tensor], counts: Sequence[int],
             devices, kk: int):
    """Every shard's (lo, hi) ghost windows of depth kk: the kk real planes
    globally before its first plane and after its last real one (shard j
    owns counts[j] real planes, cyclically), each copied onto the shard's
    device from as many shards as it spans.  A 1-shard mesh takes views of
    its own block."""
    m = len(blocks)
    if m == 1:
        r = counts[0]
        return [(blocks[0][r - kk:r], blocks[0][:kk])]
    out = []
    for i, dst in enumerate(devices):
        lo, need, j = [], kk, i
        while need:
            j = (j - 1) % m
            take = min(need, counts[j])
            lo.insert(0, halo.send(blocks[j][counts[j] - take:counts[j]],
                                   dst))
            need -= take
        hi, need, j = [], kk, i
        while need:
            j = (j + 1) % m
            take = min(need, counts[j])
            hi.append(halo.send(blocks[j][:take], dst))
            need -= take
        out.append(tuple(p[0] if len(p) == 1 else torch.cat(p)
                         for p in (lo, hi)))
    return out


def _split_x(a: torch.Tensor, d: int, devices) -> List[torch.Tensor]:
    """The (len(devices) * d, N, N) tensor cut into x blocks of depth d,
    each a contiguous copy on its device."""
    return [a[i * d:(i + 1) * d].to(dev, copy=True).contiguous()
            for i, dev in enumerate(devices)]


def _make_runner(problem: Problem, devices, dtype, k: int,
                 compute_errors: bool, nsteps: int, c2tau2_field=None):
    """Set up the march over the x-sharded mesh `devices` and return
    `(run, d, counts)`: `run()` -> (u_prev blocks, u_cur blocks, abs, rel)
    with the per-layer errors as host f64 arrays; d is the blocks' depth
    and counts their real planes."""
    n_x = len(devices)
    n = problem.N
    even = _is_even(problem, k, n_x)
    if even:
        d = n // n_x
        counts = [d] * n_x
    else:
        _, d, r = uneven_layout(problem, k, n_x)
        counts = [d] * (n_x - 1) + [r]

    def kstep(i, u_prev, u, *args, **kw):
        """Shard i's k-step: K8 on the even decomposition, K9 (over its
        real planes) on the padded one."""
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
    # The oracle planes on every device, in the compute dtype (f32 on the
    # card, where K8/K9 take f32 or bf16 states).
    oracle_on = {dev: (syz.to(dev), rsyz.to(dev), sxct_all.to(dev))
                 for dev in set(devices)}
    u0 = torch.zeros((dg, n, n), dtype=dtype)
    u0[:n] = leapfrog.initial_layer0(problem, dtype, host)
    u0 = _split_x(u0, d, devices)
    fields = None
    if c2tau2_field is not None:
        fld = torch.zeros((dg, n, n), dtype=f)
        fld[:n] = torch.as_tensor(c2tau2_field, dtype=torch.float64).to(f)
        fields = _split_x(fld, d, devices)
    fpacks = {kk: ([None] * n_x if fields is None else
                   list(zip(fields, _windows(fields, counts, devices, kk))))
              for kk in (1, k)}
    start = 1
    nblocks = (nsteps - start) // k
    rem = (nsteps - start) - nblocks * k

    def kcall(prev, cur, kk, layer, with_errors):
        """kk fused layers (layer+1 .. layer+kk) of every shard."""
        pg = _windows(prev, counts, devices, kk)
        cg = _windows(cur, counts, devices, kk)
        outs = []
        for i, dev in enumerate(devices):
            syz_k, rsyz_k, sxct_k = oracle_on[dev]
            fp = fpacks[kk][i]
            outs.append(kstep(
                i, prev[i], cur[i], pg[i], cg[i], syz_k, rsyz_k,
                sxct_k[layer + 1:layer + 1 + kk, i * d:(i + 1) * d]
                .contiguous(), k=kk, coeff=problem.a2tau2,
                inv_h2=problem.inv_h2,
                c2tau2_block=None if fp is None else fp[0],
                c2_ghosts=None if fp is None else fp[1],
                with_errors=with_errors))
        return outs

    def run():
        rows = [[torch.zeros((nsteps + 1, d), dtype=f, device=dev)
                 for dev in devices]
                for _ in range(2)] if compute_errors else None

        def record(outs, layer, kk):
            if compute_errors:
                for i, o in enumerate(outs):
                    rows[0][i][layer + 1:layer + 1 + kk] = o[2]
                    rows[1][i][layer + 1:layer + 1 + kk] = o[3]

        # kcall returns (layer n+k-1, layer n+k, ...): with u_prev = u = u0
        # at k = 1 the second output is u0 + C*lap(u0) (the field's cell
        # in place of C), so layer 1 needs no half coefficient.
        s0 = [o[1] for o in kcall(u0, u0, 1, 0, False)]
        prev = u0
        cur = [(0.5 * (a.to(f) + b.to(f))).to(dtype) for a, b in zip(u0, s0)]
        if compute_errors:
            for i, dev in enumerate(devices):
                syz_f, rsyz_f, sxct_f = oracle_on[dev]
                dr, rr = _layer_rows_local(
                    cur[i], sxct_f[1, i * d:(i + 1) * d], syz_f, rsyz_f, f)
                rows[0][i][1:2] = dr
                rows[1][i][1:2] = rr
        layer = start
        for _ in range(nblocks):
            outs = kcall(prev, cur, k, layer, compute_errors)
            record(outs, layer, k)
            prev, cur = [o[0] for o in outs], [o[1] for o in outs]
            layer += k
        for _ in range(rem):
            outs = kcall(prev, cur, 1, layer, compute_errors)
            record(outs, layer, 1)
            prev, cur = [o[0] for o in outs], [o[1] for o in outs]
            layer += 1
        if not compute_errors:
            z = np.zeros(nsteps + 1)
            return prev, cur, z, z.copy()
        # The cross-shard assembly (wavetpu's rows out_spec P(None, "x")),
        # read back once.
        dmax, rmax = (torch.cat([r.to(host) for r in rs], dim=1)
                      for rs in rows)
        abs_e, rel_e = _assemble_errors(parts, dmax, rmax)
        return prev, cur, leapfrog._host(abs_e), leapfrog._host(rel_e)

    return run, d, counts


def _to_topology_layout(blocks, counts, problem: Problem, mesh):
    """The blocks (depth D, counts[i] real planes each, zero pad) on the
    standard Topology layout of an (MX, 1, 1) mesh (ceil(N/MX)-plane
    blocks), so uneven k-fused results are laid out as every other sharded
    result; blocks that already have that depth are that layout."""
    topo = Topology(N=problem.N, mesh_shape=mesh.shape)
    if blocks[0].shape[0] == topo.block[0]:
        return ShardedArray(list(blocks), topo, mesh)
    dev = mesh.devices[0]
    real = torch.cat([b[:c].to(dev) for b, c in zip(blocks, counts)])
    return split_global(pad_global(real, topo), topo, mesh)


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
    """k-fused solve over an x-sharded (MX, 1, 1) mesh; the reference's
    timing phases as `leapfrog.solve`.  `n_shards` is the x-only shorthand;
    `devices` (default: every visible card) lists the mesh's devices and
    may repeat one (`["cpu"] * 4`, `["cuda"] * 4`).  `c2tau2_field` (host
    (N, N, N) tau^2 c^2) threads variable c through the march (pair it with
    compute_errors=False).  u_prev / u_cur are `ShardedArray`s on the
    Topology layout of the (MX, 1, 1) mesh."""
    if devices is None:
        leapfrog.resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(dv) for dv in devices]
    n_x, n_y = _resolve_grid(mesh_shape, n_shards, devices)
    _validate(problem, k, n_x, n_y, c2tau2_field, compute_errors)
    if len(devices) < n_x:
        raise ValueError(f"mesh ({n_x}, 1, 1) needs {n_x} devices, only "
                         f"{len(devices)} available")
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    mesh = build_mesh((n_x, 1, 1), devices[:n_x])
    t0 = time.perf_counter()
    run, _, counts = _make_runner(problem, list(mesh.devices), dtype, k,
                                  compute_errors, nsteps, c2tau2_field)
    _sync(mesh)
    t1 = time.perf_counter()
    u_prev, u_cur, abs_np, rel_np = run()
    _sync(mesh)
    t2 = time.perf_counter()
    return leapfrog.SolveResult(
        problem=problem,
        u_prev=_to_topology_layout(u_prev, counts, problem, mesh),
        u_cur=_to_topology_layout(u_cur, counts, problem, mesh),
        abs_errors=abs_np, rel_errors=rel_np,
        init_seconds=t1 - t0, solve_seconds=t2 - t1,
        steps_computed=stop_step,
        final_step=problem.timesteps if stop_step is None else stop_step,
    )


def _sync(mesh) -> None:
    for dev in sorted({dv for dv in mesh.devices if dv.type == "cuda"},
                      key=str):
        torch.cuda.synchronize(dev)
