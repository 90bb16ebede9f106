"""Multi-shard solver over a 3D mesh (torch port of wavetpu/solver/sharded.py,
serial exchange).

The analog of the reference's MPI variants (mpi_new.cpp:324-372 fused loop,
mpi_sol.cpp:374-478 topology set-up).  One process drives every shard, as
wavetpu's single `shard_map` program does: each step exchanges the face
ghosts of every block (comm/halo.py, a copy onto the receiver's device per
ghost plane), then launches the per-shard kernel - K6
(`stencil_cuda.sharded_fused_step`, the analog of each MPI rank launching
the reference's CUDA kernel, cuda_sol.cpp:381-443) or, for the
compensated scheme, K7 (`sharded_compensated_step`).  The per-layer L-inf
errors stay in per-shard device vectors; the cross-shard max (wavetpu's
`pmax`, the reference's end-of-run MPI_Reduce(MPI_MAX), mpi_new.cpp:
360-361) is taken once, at the read-back.

The mesh is a list of devices that may name one device more than once
(core/grid.py): all shards on one card, or all on the CPU, run the same
code as shards on separate cards.  `devices=None` means one shard per
visible card and raises when the mesh needs more; the CPU runs only when
named.

Sharding model (core/grid.py): the fundamental (N, N, N) state is
zero-padded per axis to a multiple of the mesh dim.  The 1-D analytic
factors and boundary / error masks are computed on the host in f64,
padded, and each shard takes its slice - the reference's per-rank
x_0/y_0/z_0 offsets (mpi_sol.cpp:423-429).  Each kernel step is op for op
the single-device step, so the sharded solve equals `leapfrog.solve` (and
the compensated one `leapfrog.solve_compensated`) bit for bit, errors
included.

Overlap mode (`overlap=True`, the standard scheme on an even split): the
ghost copies run on side streams beside the bulk update and the face
planes are then recomputed from the real ghosts (`_make_local_step`), bit
for bit the serial step.

A shifted `phase` (the standard scheme, constant speed: the lane identity
of ensemble/sharded.py's batches) starts from the exact analytic layer 1,
as `leapfrog.solve`.

`resume_sharded` re-enters the march at a checkpoint's layer and
`make_sharded_chunk_runner` marches a supervised run's fixed-length chunks
(run/supervisor.py), both through `_parts`'s march.

Under `--distributed` (comm/dist.py) the mesh spans processes: each one
builds and marches only its own shards (the block lists hold None at the
others), the exchange moves crossing planes between ranks
(`halo.transfer`), and `_reduce` gathers every rank's error vectors before
it takes their max - the same march, so the same bits as one process.
In the overlap mode the planes from other ranks arrive before the bulk
update is queued, so across ranks it keeps the serial step's bits but
overlaps only the copies within a rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from wavetpu_torch.comm import dist, halo
from wavetpu_torch.core.grid import (
    Mesh, ShardedArray, Topology, build_mesh, choose_mesh_shape, each,
    split_global,
)
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.obs import tracing
from wavetpu_torch.solver import leapfrog, phases
from wavetpu_torch.verify import oracle


def _padded_factors(problem: Problem, topo: Topology):
    """Host-f64 1-D analytic factors on the padded per-axis grids; pad
    cells get factor 0, so the padded analytic field vanishes there."""
    n = problem.N

    def pad(v, p):
        out = np.zeros(p, dtype=np.float64)
        out[:n] = v
        return out

    factors = oracle.spatial_factors_np(problem, n)
    return tuple(pad(v, p) for v, p in zip(factors, topo.padded))


def _masks(problem: Problem, topo: Topology):
    """1-D boundary and error-interior masks over the padded axes (bool).

    bc (the cells an update may leave nonzero):
      x: real cells (global i < N) - the x=0 plane is a live periodic cell;
      y/z: real cells off the stored Dirichlet plane (global 0).
    err (the reference's error interior, global 1..N-1 per axis,
         openmp_sol.cpp:174-176): global index != 0 and < N.
    The sharded kernels reproduce the bc predicate from global offsets.
    """
    n = problem.N
    bc, err = [], []
    for axis, p in enumerate(topo.padded):
        g = np.arange(p)
        real = g < n
        bc.append(real if axis == 0 else real & (g != 0))
        err.append(real & (g != 0))
    return tuple(bc), tuple(err)


def pad_field(field: np.ndarray, topo: Topology) -> np.ndarray:
    """Zero-pad an (N, N, N) host field to the topology's padded shape."""
    field = np.asarray(field)
    out = np.zeros(topo.padded, dtype=field.dtype)
    n = field.shape
    out[: n[0], : n[1], : n[2]] = field
    return out


def _shard_offsets(topo: Topology, coord) -> Tuple[int, int, int]:
    """The shard's global cell offsets (the reference's per-rank
    x_0/y_0/z_0, mpi_sol.cpp:423-429)."""
    return tuple(c * b for c, b in zip(coord, topo.block))


class _Shard:
    """What one shard's march needs on its device: its offsets, its slices
    of the factors and masks, and its error function (the error kernel,
    `stencil_cuda.layer_errors`, or with kernel="roll" its plain
    version)."""

    def __init__(self, problem, topo, coord, device, f_dtype, factors,
                 masks, ct, kernel: str = "pallas"):
        self.device = device
        self.offsets = _shard_offsets(topo, coord)
        sl = [slice(o, o + b) for o, b in zip(self.offsets, topo.block)]
        fx, fy, fz = (
            torch.tensor(v[s], dtype=f_dtype, device=device)
            for v, s in zip(factors, sl)
        )
        self.factors = (fx, fy, fz)
        bc, err = masks
        self.bc = torch.as_tensor(
            bc[0][sl[0], None, None] & bc[1][None, sl[1], None]
            & bc[2][None, None, sl[2]], device=device)
        # The error interior of a block is one box (global 1..N-1 per
        # axis): take it as a view, as leapfrog's error pass takes
        # u[1:, 1:, 1:], instead of masking the whole block.
        box = []
        for e, s in zip(err, sl):
            idx = np.flatnonzero(e[s])
            box.append(slice(int(idx[0]), int(idx[-1]) + 1) if idx.size
                       else None)
        self.box = None if None in box else tuple(box)
        if self.box is not None:
            self.box_factors = tuple(v[b] for v, b in zip(self.factors,
                                                          self.box))
        self.layer_errors = stencil_cuda.make_layer_errors_fn(kernel)
        self.ct = ct.to(device)

    def analytic(self, ct, dtype):
        """The block of the analytic solution at time factor `ct` (0-d, on
        the shard's device), zero off the bc cells: layer 0 at ct(0)
        (leapfrog.initial_layer0's bits on the real cells), a shifted
        phase's layer 1 at ct(1) (leapfrog.analytic_layer's)."""
        fx, fy, fz = self.factors
        u = oracle.analytic_field(fx, fy, fz, ct)
        return torch.where(self.bc, u, 0.0).to(dtype)

    def layer0(self, dtype):
        return self.analytic(self.ct[0], dtype)

    def errors_at(self, u, ct, out=None):
        """(abs, rel) of block `u` against the analytic field at time factor
        `ct` over the block's error interior, 0-d tensors on the shard's
        device (zeros for a block with none); written into `out` = (abs
        slot, rel slot) of zeroed vectors when given
        (`stencil_cuda.layer_errors` on the box's view and factors)."""
        if self.box is None:
            if out is not None:
                return out
            z = torch.zeros((), dtype=self.ct.dtype, device=self.device)
            return z, z
        return self.layer_errors(u[self.box], *self.box_factors, ct, out)

    def errors(self, u, n, out=None):
        """(abs, rel) of layer n (`errors_at` ct(n))."""
        return self.errors_at(u, self.ct[n], out)


def _self_ghosts(u: torch.Tensor, topo: Topology,
                 stream=None) -> halo.Ghosts:
    """The block's own cyclic wrap planes, shaped like `collect_ghosts`'
    output: copies on every axis whose mesh dim is > 1 (where the exchange
    copies a neighbour's plane of the same size), views elsewhere (as the
    exchange takes them).  Fed to K6 they make the shard exactly periodic
    by itself: the phase-timing probe's exchange-free step (solver/
    timing.py), the same copies and kernel as the real step; `stream`
    puts the copies on that CUDA stream (`halo.send`)."""
    ghosts = []
    for axis in range(3):
        b = u.shape[axis]
        lo, hi = u.narrow(axis, b - 1, 1), u.narrow(axis, 0, 1)
        if topo.mesh_shape[axis] > 1:
            pair = None if stream is None else (stream, stream)
            lo, hi = (halo.send(lo, u.device, pair),
                      halo.send(hi, u.device, pair))
        ghosts.append((lo, hi))
    return tuple(ghosts)


def _face_block(u, ghosts, axis: int, q: int, mesh_shape):
    """Face plane `q` of `axis` as a one-plane block with its own ghosts
    (the port's counterpart of wavetpu's `_face_ext` slab): along `axis`
    the neighbouring planes - the exchanged ghost where the plane is the
    block's edge, the block's own plane otherwise - and across it the
    transverse ghosts restricted to the plane.  K6 on it updates the face
    plane exactly as K6 on the whole block with those ghosts would, edges
    and corners included.  Ghosts are copied contiguous where K6 reads
    them (axes whose mesh dim is > 1).  Even shard splits only."""
    b = u.shape[axis]
    lo = ghosts[axis][0] if q == 0 else u.narrow(axis, q - 1, 1)
    hi = ghosts[axis][1] if q == b - 1 else u.narrow(axis, q + 1, 1)
    out = []
    for a in range(3):
        pair = (lo, hi) if a == axis else tuple(
            g.narrow(axis, q, 1) for g in ghosts[a])
        if mesh_shape[a] > 1:
            pair = tuple(g.contiguous() for g in pair)
        out.append(pair)
    return u.narrow(axis, q, 1).contiguous(), tuple(out)


def _make_local_step(problem: Problem, topo: Topology, mesh: Mesh,
                     offsets, kernel: str = "pallas", overlap: bool = False,
                     exchange: bool = True):
    """The step over all shards, `step(prev, cur, fields)` -> next blocks:
    K6 (K6f with a field block) on every shard, or its plain version with
    kernel="roll".

    Serial: exchange the ghosts of `cur`, then update.  `exchange=False`
    puts each block's own wrap planes (`_self_ghosts`) in place of the
    exchanged ghosts - the same copies and kernel, but wrong at shard
    boundaries on every axis whose mesh dim is > 1; it exists only for the
    phase-timing probe (solver/timing.py).

    Overlap (even splits only): the ghost copies run on side streams, one
    per card, each copy on its sender's and its receiver's side stream,
    while the main streams update every block as if it were periodic by
    itself (K6 reading its own wrap planes); each main stream then waits
    for its card's side stream and recomputes the face planes of every
    axis whose mesh dim is > 1 from the real ghosts - K6 again, on each
    face plane as a one-plane block (`_face_block`), so every cell takes
    K6's operation order and the result equals the serial step bit for
    bit.  Each face costs one more K6 launch and a few plane copies.  The
    overlap has been measured with every shard on one card only.  On the
    CPU the same work runs in order."""
    stencil_cuda.check_kernel(kernel)
    n = problem.N
    uneven = any(r != b for r, b in zip(topo.r_last, topo.block))
    if overlap and uneven:
        raise ValueError(
            "overlap mode requires N divisible by every mesh dim "
            f"(N={n}, mesh={topo.mesh_shape})"
        )
    k6 = (stencil_cuda.sharded_fused_step if kernel == "pallas"
          else stencil_cuda.sharded_fused_step_plain)
    kw = dict(inv_h2=problem.inv_h2, alpha=2.0, beta=1.0)
    multi_axes = [a for a in range(3) if topo.mesh_shape[a] > 1]

    def update(p, u, g, off, fld, mesh_shape, r_last):
        return k6(p, u, g, off, n, mesh_shape=mesh_shape, r_last=r_last,
                  coeff=None if fld is not None else problem.a2tau2,
                  c2tau2_block=fld, **kw)

    def ghosts_of(cur, streams=None):
        if exchange:
            return halo.collect_ghosts(cur, topo, mesh, streams)
        return [None if u is None else
                _self_ghosts(u, topo, None if streams is None
                             else streams[i]) for i, u in enumerate(cur)]

    def step_serial(prev, cur, fields):
        ghosts = ghosts_of(cur)
        u_in = halo.absorb_hi_ghosts(cur, ghosts, topo, mesh)
        return each(lambda p, u, g, off, fld: update(
            p, u, g, off, fld, topo.mesh_shape, topo.r_last),
            prev, u_in, ghosts, offsets, fields)

    cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)
    side = {d: torch.cuda.Stream(d) for d in cards} if overlap else {}

    def gather_ghosts(cur):
        """Every shard's ghosts, each copy on its sender's and receiver's
        side streams (`halo.send`), which first wait for the work that
        made `cur`.  Planes from another rank arrive on the main stream
        (`halo.transfer`), before the bulk update is queued."""
        if not cards:
            return ghosts_of(cur)
        for d in cards:
            side[d].wait_stream(torch.cuda.current_stream(d))
        return ghosts_of(cur, [side.get(d) for d in mesh.devices])

    def join(ghosts):
        """The main streams wait for the ghost copies; the copies' memory
        is marked in use by them (the caching allocator would otherwise
        hand it out once the side stream is done with it)."""
        for d in cards:
            torch.cuda.current_stream(d).wait_stream(side[d])
        for g, dev in zip(ghosts, mesh.devices):
            if dev.type == "cuda":
                for axis in multi_axes:
                    for t in g[axis]:
                        t.record_stream(torch.cuda.current_stream(dev))

    def patch(bulk, p, u, g, off, fld):
        """Recompute the face planes of the multi-shard axes with the real
        ghosts: K6 (its plain version with kernel="roll") on each face
        plane as a one-plane block (`_face_block`)."""
        for axis in multi_axes:
            for q in sorted({0, topo.block[axis] - 1}):
                fu, fg = _face_block(u, g, axis, q, topo.mesh_shape)
                face_off = list(off)
                face_off[axis] += q
                fld_q = (None if fld is None
                         else fld.narrow(axis, q, 1).contiguous())
                bulk.narrow(axis, q, 1).copy_(update(
                    p.narrow(axis, q, 1).contiguous(), fu, fg, face_off,
                    fld_q, topo.mesh_shape, None))
        return bulk

    def step_overlap(prev, cur, fields):
        ghosts = gather_ghosts(cur)
        bulk = each(lambda p, u, off, fld: update(p, u, None, off, fld,
                                                  (1, 1, 1), None),
                    prev, cur, offsets, fields)
        if not multi_axes:
            return bulk
        join(ghosts)
        return each(patch, bulk, prev, cur, ghosts, offsets, fields)

    return step_overlap if overlap else step_serial


def _make_local_comp_step(problem: Problem, topo: Topology, mesh: Mesh,
                          offsets, kernel: str = "pallas"):
    """The compensated step over all shards, `comp_step(u, v, carry,
    coeff)` -> (u', v', carry') lists: K7 on every shard (its plain version
    with kernel="roll"), after the exchange of u's ghosts."""
    stencil_cuda.check_kernel(kernel)
    k7 = (stencil_cuda.sharded_compensated_step if kernel == "pallas"
          else stencil_cuda.sharded_compensated_step_plain)
    kw = dict(inv_h2=problem.inv_h2, mesh_shape=topo.mesh_shape,
              r_last=topo.r_last)

    def comp_step(u, v, carry, coeff):
        ghosts = halo.collect_ghosts(u, topo, mesh)
        u_in = halo.absorb_hi_ghosts(u, ghosts, topo, mesh)
        outs = each(lambda a, b, c, g, off: k7(a, b, c, g, off, problem.N,
                                               coeff=coeff, **kw),
                    u_in, v, carry, ghosts, offsets)
        return tuple([None if o is None else o[j] for o in outs]
                     for j in range(3))

    return comp_step


def _resolve_mesh(problem: Problem, mesh_shape, devices):
    """(topo, mesh): `devices=None` is every visible card (raises without
    one), `mesh_shape=None` a near-cubic factorization of their count."""
    devices = leapfrog.resolve_devices(devices)
    if mesh_shape is None:
        mesh_shape = choose_mesh_shape(len(devices))
    topo = Topology(N=problem.N, mesh_shape=tuple(mesh_shape))
    if len(devices) < topo.n_devices:
        raise ValueError(
            f"mesh {tuple(mesh_shape)} needs {topo.n_devices} devices, "
            f"only {len(devices)} available"
        )
    return topo, build_mesh(topo.mesh_shape, devices[: topo.n_devices])


def _field_blocks(c2tau2_field, topo: Topology, mesh: Mesh, f_dtype):
    """The padded tau^2 c^2 field's blocks in the compute dtype (one
    rounding from f64, as `io.state.c2tau2_field`), or Nones."""
    if c2tau2_field is None:
        return [None] * topo.n_devices
    if isinstance(c2tau2_field, torch.Tensor):
        c2tau2_field = c2tau2_field.cpu().numpy()
    padded = pad_field(np.asarray(c2tau2_field, dtype=np.float64), topo)
    return split_global(torch.from_numpy(padded), topo, mesh,
                        dtype=f_dtype).blocks


def _parts(problem: Problem, topo: Topology, mesh: Mesh, dtype,
           compute_errors: bool, c2tau2_field, scheme: str, kernel: str,
           overlap: bool, nsteps: int, phase: float = oracle.TWO_PI):
    """Set up the sharded march - kernels built and loaded, every shard's
    factors, masks and field block on its device - and return `(parts,
    u0, bootstrap)`: its `phases.Parts` (per-shard error vectors of
    nsteps+1 layers, read back as their cross-shard maxima, the results
    as ShardedArrays in wavetpu's padded layout), layer 0's blocks and
    `bootstrap(u0, abs_s, rel_s)` -> the state at layer 1.  The state is
    (u_prev, u_cur) block lists, or (u, v, carry) for the compensated
    scheme; the error vectors are indexed by layer.  A shifted `phase`
    bootstraps layer 1 from the analytic solution (standard scheme,
    constant speed)."""
    if scheme not in ("standard", "compensated"):
        raise ValueError(
            f"scheme must be 'standard' or 'compensated', got {scheme!r}")
    compensated = scheme == "compensated"
    analytic = leapfrog.check_phase(phase, c2tau2_field)
    if analytic and compensated:
        raise ValueError(
            "the sharded compensated scheme serves the reference phase "
            "only (use the single-device compensated solvers for "
            "shifted-phase lanes)")
    if compensated and overlap:
        raise ValueError("overlap mode is not available for the "
                         "compensated scheme yet")
    if compensated and c2tau2_field is not None:
        raise ValueError(
            "compensated scheme does not support a variable-c field yet")
    if compensated and dtype == torch.bfloat16:
        raise ValueError(
            "compensated scheme requires f32/f64 state (bf16 representation "
            "error dominates anything the compensation recovers)")
    if c2tau2_field is not None and compute_errors:
        raise ValueError(
            "variable-c runs have no analytic oracle; pass "
            "compute_errors=False with c2tau2_field")
    f = stencil_ref.compute_dtype(dtype)
    if kernel == "pallas" and any(d.type == "cuda" for d in mesh.devices):
        stencil_cuda.load_libraries()
    factors = _padded_factors(problem, topo)
    masks = _masks(problem, topo)
    ct = oracle.time_factor_table(problem, f, phase=phase)
    shards = [_Shard(problem, topo, coord, dev, f, factors, masks, ct,
                     kernel)
              if mesh.is_local(i) else None
              for i, (coord, dev) in enumerate(zip(mesh.coords,
                                                   mesh.devices))]
    fields = _field_blocks(c2tau2_field, topo, mesh, f)
    offsets = [_shard_offsets(topo, coord) for coord in mesh.coords]
    if compensated:
        comp_step = _make_local_comp_step(problem, topo, mesh, offsets,
                                          kernel)
    else:
        step = _make_local_step(problem, topo, mesh, offsets, kernel,
                                overlap)
    u0 = each(lambda sh: sh.layer0(dtype), shards)

    def vectors():
        return tuple(each(lambda sh: torch.zeros(nsteps + 1, dtype=f,
                                                 device=sh.device), shards)
                     for _ in range(2))

    def record(layer, n, abs_s, rel_s):
        if compute_errors:
            with tracing.annotate("verify.errors"):
                for sh, u, a, r in zip(shards, layer, abs_s, rel_s):
                    if sh is not None:
                        sh.errors(u, n, (a[n], r[n]))

    def bootstrap(u0, abs_s, rel_s):
        if compensated:
            # Layer 1 is the same step with v = carry = 0 and half the
            # coefficient: the Taylor half-step (sharded.py:429-435).
            zero = each(torch.zeros_like, u0)
            st = comp_step(u0, zero, zero, 0.5 * problem.a2tau2)
            record(st[0], 1, abs_s, rel_s)
            return st
        if analytic:
            cur = each(lambda sh: sh.analytic(sh.ct[1], dtype), shards)
            record(cur, 1, abs_s, rel_s)
            return u0, cur
        # Layer 1 derived from the step: u1 = (u0 + step(u0, u0))/2 in the
        # compute dtype, as leapfrog.solve.
        s0 = step(u0, u0, fields)
        cur = each(lambda a, b: (0.5 * (a.to(f) + b.to(f))).to(dtype), u0,
                   s0)
        record(cur, 1, abs_s, rel_s)
        return u0, cur

    def advance(st, start, stop, abs_s, rel_s):
        if compensated:
            u, v, c = st
            for n in range(start + 1, stop + 1):
                u, v, c = comp_step(u, v, c, problem.a2tau2)
                record(u, n, abs_s, rel_s)
            return u, v, c
        prev, cur = st
        for n in range(start + 1, stop + 1):
            prev, cur = cur, step(prev, cur, fields)
            record(cur, n, abs_s, rel_s)
        return prev, cur

    def march(st, start, stop, errs):
        return advance(st, start, stop, *errs), errs

    def state_in(*arrays):
        if compensated and (arrays[1] is None or arrays[2] is None):
            raise ValueError("a compensated resume needs comp_v and "
                             "comp_carry")
        return tuple(state.to_blocks(a, topo, mesh, dtype) for a in arrays)

    def read(errs, sl=None):
        abs_np, rel_np = _reduce(errs[0], mesh), _reduce(errs[1], mesh)
        return (abs_np, rel_np) if sl is None else (abs_np[sl], rel_np[sl])

    def out(st):
        u_p, u_c, v, c = _as_sharded(st, scheme, topo, mesh)
        return (u_c, v, c) if compensated else (u_p, u_c)

    parts = phases.Parts(
        march=march, state_in=state_in, vectors=vectors, host=read,
        fields=lambda st: dict(zip(_FIELDS, _as_sharded(st, scheme, topo,
                                                        mesh))),
        out=out, sync=lambda: phases.sync(*mesh.devices),
        record=dict(block=topo.block, mesh_shape=topo.mesh_shape))
    return parts, u0, bootstrap


_FIELDS = ("u_prev", "u_cur", "comp_v", "comp_carry")


def _solver(problem, topo, mesh, dtype, compute_errors, c2tau2_field,
            stop_step, scheme, kernel, overlap, phase) -> phases.Parts:
    """`make_sharded_solver`'s set-up, as `phases.Parts` whose `run` ->
    ((u_prev, u_cur, v, carry) block lists, errs), v and carry None on the
    standard scheme."""
    nsteps = phases.last_layer(problem, stop_step)
    parts, u0, bootstrap = _parts(problem, topo, mesh, dtype, compute_errors,
                                  c2tau2_field, scheme, kernel, overlap,
                                  nsteps, phase)
    layer0 = phases.from_layer0(lambda errs: bootstrap(u0, *errs),
                                parts.march, nsteps, parts.vectors)

    def run():
        st, errs = layer0()
        if scheme == "compensated":
            u, v, c = st
            return (each(torch.sub, u, v), u, v, c), errs
        return st + (None, None), errs

    def sharded(blocks):
        return None if blocks is None else ShardedArray(blocks, topo, mesh)

    parts.run = run
    parts.fields = lambda st: dict(zip(_FIELDS, map(sharded, st)))
    return parts


def make_sharded_solver(
    problem: Problem,
    topo: Topology,
    mesh: Mesh,
    dtype=torch.float32,
    compute_errors: bool = True,
    c2tau2_field=None,
    stop_step: Optional[int] = None,
    scheme: str = "standard",
    kernel: str = "pallas",
    overlap: bool = False,
    phase: float = oracle.TWO_PI,
):
    """Set up the sharded solve (`_parts`) and return `run()` ->
    (u_prev, u_cur, abs_per_shard, rel_per_shard, v, carry): lists of
    blocks in mesh order, the per-shard (nsteps+1,) error vectors, and for
    the compensated scheme the increment and Kahan carry (else None).
    `kernel="roll"` runs the kernels' plain versions on the same devices;
    `overlap` runs the standard step's exchange beside the bulk update
    (`_make_local_step`)."""
    run = _solver(problem, topo, mesh, dtype, compute_errors, c2tau2_field,
                  stop_step, scheme, kernel, overlap, phase).run

    def runner():
        (u_prev, u_cur, v, c), (abs_s, rel_s) = run()
        return u_prev, u_cur, abs_s, rel_s, v, c

    return runner


def _reduce(per_shard: List[torch.Tensor], mesh: Mesh) -> np.ndarray:
    """The cross-shard max of the per-shard error vectors (wavetpu's
    pmax), read back once; across ranks every shard's vector is gathered
    first (`dist.gather_shards`), so the max (NaN wins) is the same."""
    per_shard = dist.gather_shards(mesh, per_shard)
    return np.max(np.stack([phases.host(v) for v in per_shard]), axis=0)


def solve_sharded(
    problem: Problem,
    mesh_shape: Optional[Tuple[int, int, int]] = None,
    devices: Optional[Sequence] = None,
    dtype=torch.float32,
    compute_errors: bool = True,
    c2tau2_field=None,
    stop_step: Optional[int] = None,
    scheme: str = "standard",
    kernel: str = "pallas",
    overlap: bool = False,
    phase: float = oracle.TWO_PI,
) -> leapfrog.SolveResult:
    """The sharded solve with the reference's timing phases (as
    `leapfrog.solve`): `init_seconds` covers the kernel build and the
    shards' set-up, `solve_seconds` the bootstrap, the march and the
    read-back of the error vectors.

    `devices` (default: every visible card) lists the mesh's devices in
    mesh order and may repeat one - `devices=["cpu"] * 8` runs eight shards
    on the CPU, `["cuda"] * 4` four on one card.  `mesh_shape` defaults to
    a near-cubic factorization of their count.  `c2tau2_field` is an
    (N, N, N) host tau^2 c^2 array (pair it with compute_errors=False).
    `kernel="roll"` runs the kernels' plain versions; `overlap=True` (the
    standard scheme on an even split) exchanges the ghosts on a side
    stream beside the bulk update, bit for bit the serial result.
    `phase` (standard scheme, constant speed) as `leapfrog.solve`'s.
    The result's u_prev / u_cur (and comp_v / comp_carry) are
    `ShardedArray`s in wavetpu's padded layout; its errors are the
    cross-shard maxima.
    """
    def setup():
        topo, mesh = _resolve_mesh(problem, mesh_shape, devices)
        return _solver(problem, topo, mesh, dtype, compute_errors,
                       c2tau2_field, stop_step, scheme, kernel, overlap,
                       phase)

    return phases.timed_solve("sharded", problem, stop_step, setup,
                              scheme=scheme,
                              with_field=c2tau2_field is not None)


def gather_fundamental(u: ShardedArray, problem: Problem) -> torch.Tensor:
    """The (N, N, N) fundamental domain of a sharded field on the CPU,
    padding stripped."""
    if u.topo.N != problem.N:
        raise ValueError(f"field is for N={u.topo.N}, not {problem.N}")
    return u.fundamental("cpu")


def _as_sharded(st, scheme, topo, mesh):
    """(u_prev, u_cur, v, carry) ShardedArrays of a march's state."""
    def sh(blocks):
        return None if blocks is None else ShardedArray(list(blocks), topo,
                                                        mesh)

    if scheme == "compensated":
        u, v, c = st
        return sh(each(torch.sub, u, v)), sh(u), sh(v), sh(c)
    return sh(st[0]), sh(st[1]), None, None


def resume_sharded(
    problem: Problem,
    u_prev,
    u_cur,
    start_step: int,
    mesh_shape: Optional[Tuple[int, int, int]] = None,
    devices: Optional[Sequence] = None,
    dtype=torch.float32,
    kernel: str = "pallas",
    overlap: bool = False,
    compute_errors: bool = True,
    scheme: str = "standard",
    comp_v=None,
    comp_carry=None,
    c2tau2_field=None,
) -> leapfrog.SolveResult:
    """Re-enter the sharded 1-step march at layer `start_step` from a
    sharded checkpoint's state - ShardedArrays (io/checkpoint.py's load)
    or wavetpu's padded global arrays - on `mesh_shape` over `devices`
    (default: every visible card); the compensated scheme resumes from
    (u_cur, comp_v, comp_carry).  Each step is the uninterrupted march's,
    so the resumed state is bitwise equal; the error vectors are zero up
    to start_step.  A variable-c checkpoint resumes under the re-passed
    `c2tau2_field`."""
    phases.check_start(start_step, problem.timesteps)
    arrays = ((u_cur, comp_v, comp_carry) if scheme == "compensated"
              else (u_prev, u_cur))
    return phases.timed_resume(
        "sharded", problem, start_step,
        lambda: _resumed(problem, mesh_shape, devices, dtype, compute_errors,
                         c2tau2_field, scheme, kernel, overlap),
        arrays, scheme=scheme, with_field=c2tau2_field is not None)


def _resumed(problem, mesh_shape, devices, dtype, compute_errors,
             c2tau2_field, scheme, kernel, overlap) -> phases.Parts:
    """The `phases.Parts` of a resumed or chunked sharded march."""
    topo, mesh = _resolve_mesh(problem, mesh_shape, devices)
    return _parts(problem, topo, mesh, dtype, compute_errors, c2tau2_field,
                  scheme, kernel, overlap, problem.timesteps)[0]


def make_sharded_chunk_runner(
    problem: Problem,
    mesh_shape: Tuple[int, int, int],
    devices: Sequence,
    length: int,
    dtype=torch.float32,
    compute_errors: bool = True,
    kernel: str = "pallas",
    overlap: bool = False,
    c2tau2_field=None,
    scheme: str = "standard",
):
    """Fixed-length re-entry of the sharded 1-step march for supervised
    solves, built once per configuration (kernels loaded, every shard's
    factors and field block on its device): `runner(*state, start)` ->
    (*state, abs, rel) marches layers start+1..start+length, the state
    (u_prev, u_cur) - or (u, v, carry) compensated - as ShardedArrays on
    `mesh_shape` over `devices` (or padded global arrays), the errors as
    the chunk's host f64 cross-shard maxima."""
    return phases.chunk_runner(
        problem, length,
        lambda: _resumed(problem, mesh_shape, devices, dtype, compute_errors,
                         c2tau2_field, scheme, kernel, overlap))
