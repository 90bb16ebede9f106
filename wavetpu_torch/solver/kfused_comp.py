"""Compensated (velocity-form) temporally fused k-step solver - the
flagship (torch port of the single-device half of
wavetpu/solver/kfused_comp.py).

The march runs the increment form

    v_{n+1} = v_n + C*lap(u_n)
    u_{n+1} = u_n + v_{n+1}      (Kahan two-sum through `carry`)

k layers per launch of K4 (`stencil_cuda.fused_kstep_comp`), which keeps
the intermediate layers out of device memory and emits per-substep error
rows; a remainder of fewer than k layers runs the same kernel at k=1.
Layer 1 comes from K2 (`stencil_cuda.compensated_step`) with coeff C/2 and
v = carry = 0.  At N=512 / 1000 steps / k=4: 1 K2 launch, then 249 K4
launches at k=4 and 3 at k=1.

With `v_dtype=torch.bfloat16, carry=False` the same march is the
increment-form bf16 mode: the increment stream stores bf16, u stays the
f32 carrier.

Variable wave speed: `c2tau2_field` (a tau^2 c^2 (N,N,N) host array or
tensor, placed on the device once in the compute dtype before the timed
region) becomes the Laplacian coefficient of every substep through K4's
field operand (K4f): v' = v + mask(c2tau2*lap(u)).  Layer 1 is then K4f at
k=1 with half the field, zero v and carry, and no error rows - not K2,
whose coefficient is a scalar.  At N=512 / 1000 steps / k=4: 253 K4f
launches (1 bootstrap, 249 at k=4, 3 at k=1).  A field needs
compute_errors=False (no analytic oracle).

There is no bitwise-parity claim against the 1-step scheme (intermediate
layers skip the storage round trip, halo carries differ); the contract is
tolerance parity vs f64.

The sharded half (`solve_kfused_comp_sharded`) is the distributed
flagship over an (MX, MY, 1) mesh, with the k-step exchange of
solver/sharded_kfused.py (x windows of u and v per k-block; on MY > 1 the
blocks are first extended in y, and the windows are cut from the
extended blocks).  MY = 1 runs K11 (`stencil_cuda.fused_kstep_comp_
sharded`): for one block_x its op sequence is K4's, so it equals the
single-device flagship; MY > 1 runs K12 (`fused_kstep_comp_sharded_xy`),
whose carry is also zero on the y ghost rows (within 1e-6 of it).  The
bootstrap is the same kernel at k=1 with coeff C/2 on zero v and carry
(half the field with c2tau2_field), the tail k=1 launches of it; layer 1's
errors come from per-x-plane rows (`sharded_kfused._layer_rows_local`).
At N=512 / 1000 steps / k=4 each shard runs 253 launches.  Under
`--distributed` each process marches its own shards and the rows of every
shard are gathered before their max (comm/dist.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wavetpu_torch.comm import dist
from wavetpu_torch.core.grid import (
    ShardedArray, Topology, build_mesh, each, split_global,
)
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.obs import tracing
from wavetpu_torch.solver import kfused, leapfrog, phases, sharded_kfused
from wavetpu_torch.verify import oracle

# The K4 kernel's pipeline takes k <= 8 stages (stencil_cuda.comp_pipe_tile).
MAX_K = 8


def _default_carry_dtype(dtype):
    """bf16 carry for f32 runs, else the state dtype.  The carry holds
    ~ulp(u)-scale residuals; bf16 quantizes them at ~carry * 2^-8 per step
    (~1e-10 absolute for f32 runs), invisible at the f32 discretization
    error, while the carry's memory stream halves."""
    return torch.bfloat16 if dtype == torch.float32 else dtype


def _validate_carry_dtype(dtype, carry_dtype):
    """Allowed carry storages: the state dtype, or bf16 for f32 runs."""
    ok = carry_dtype == dtype or (
        carry_dtype == torch.bfloat16 and dtype == torch.float32
    )
    if not ok:
        raise ValueError(
            f"carry_dtype {carry_dtype} is invalid for state dtype {dtype}: "
            f"use the state dtype, or bfloat16 for float32 runs"
        )


def _normalize_carry(carry, dtype):
    """Resume-side carry normalization: keep a valid stored carry dtype
    (the state dtype, or bf16 for an f32 state - bf16-carry checkpoints
    resume bitwise) and cast anything else to the state dtype (e.g. an f64
    carry resumed as f32).  Takes a tensor or a ShardedArray."""
    cd = carry.dtype
    if cd == dtype or (cd == torch.bfloat16 and dtype == torch.float32):
        return carry
    if isinstance(carry, ShardedArray):
        return ShardedArray(each(lambda b: b.to(dtype), carry.blocks),
                            carry.topo, carry.mesh)
    return carry.to(dtype)


def _validate(problem: Problem, dtype, v_dtype, carry, k: int,
              c2tau2_field=None, compute_errors: bool = True):
    if k < 2:
        raise ValueError(f"k must be >= 2 (got {k}); use "
                         "leapfrog.solve_compensated for k=1")
    if k > MAX_K:
        raise ValueError(f"k must be <= {MAX_K} (got {k}): the K4 kernel's "
                         "pipeline takes no more stages")
    if problem.N % k:
        raise ValueError(f"k={k} must divide N={problem.N}")
    if c2tau2_field is not None and compute_errors:
        raise ValueError(
            "variable-c runs have no analytic oracle; pass "
            "compute_errors=False with c2tau2_field"
        )
    if dtype == torch.bfloat16:
        raise ValueError(
            "compensated/velocity scheme requires an f32/f64 carrier u "
            "(bf16 representation error dominates; use v_dtype=bfloat16 "
            "for the increment-form bf16 mode)"
        )
    if v_dtype != dtype and carry:
        raise ValueError(
            "carry compensation requires v_dtype == dtype (a narrowed "
            "increment stream quantizes far above what the carry "
            "recovers); pass carry=False"
        )


def _rel_guard_tol(f):
    """|sx| threshold below which a plane counts as an analytic zero for
    the REL metric (see `_make_march`)."""
    return 512 * torch.finfo(f).eps


def lane_error_fn_guarded(problem: Problem, dtype, device):
    """(u, ct) -> (abs_e, rel_e) with the representation-zero sx planes
    excluded, so the bootstrap layer's metric matches the in-kernel
    layers'; the time factor `ct` (0-d, compute dtype) is a runtime
    argument, as `leapfrog.lane_error_fn`'s."""
    f_dtype = stencil_ref.compute_dtype(dtype)
    sx, sy, sz = oracle.spatial_factors(problem, f_dtype, device)
    mask = torch.as_tensor(oracle.interior_masks_1d(problem.N), device=device)
    mask_x = mask & (sx.abs() > _rel_guard_tol(f_dtype))

    def errors(u, ct):
        f = oracle.analytic_field(sx, sy, sz, ct)
        return oracle.layer_errors(u.to(f_dtype), f, mask_x, mask, mask)

    return errors


def _error_fn_guarded(problem: Problem, dtype, device,
                      phase: float = oracle.TWO_PI):
    """(u, n) -> the guarded errors of layer n (`lane_error_fn_guarded`
    over the phase's time-factor table)."""
    errors = lane_error_fn_guarded(problem, dtype, device)
    ct_table = oracle.time_factor_table(
        problem, stencil_ref.compute_dtype(dtype), device, phase)
    return lambda u, n: errors(u, ct_table[n])


def oracle_parts_guarded(problem: Problem, f, device,
                         phase: float = oracle.TWO_PI):
    """`kfused._oracle_parts` with the rel-metric guard: representation-
    level zeros of the periodic x factor (sin at the domain midpoint
    evaluates to ~1.2e-16, not 0, and 1/|sx| would amplify the
    velocity-form onion's ~2e-9 asymmetry into garbage) drop out of
    inv_absx.  Abs errors are untouched."""
    sx, ct, syz, rsyz, xmask, inv_absx = kfused._oracle_parts(
        problem, f, device, phase)
    inv_absx = torch.where(sx.abs() > _rel_guard_tol(f), inv_absx, 0.0)
    return sx, ct, syz, rsyz, xmask, inv_absx


def _make_march(problem, dtype, k, compute_errors, block_x, nsteps, device,
                c2tau2_field=None, phase: float = oracle.TWO_PI):
    """Shared march: k-fused blocks + a k=1 tail through the SAME kernel.

    Returns `march(u, v, carry, start, abs_all, rel_all, stop=nsteps)` ->
    (u, v, carry) covering layers start+1..stop and writing their errors
    into the device vectors.  `c2tau2_field` (a device tensor in the compute dtype,
    or None) rides every launch.
    """
    f = stencil_ref.compute_dtype(dtype)
    sx, ct, syz, rsyz, xmask, inv_absx = oracle_parts_guarded(
        problem, f, device, phase)
    # The kernel takes f32 oracle planes; the plain version (CPU) takes them
    # in the compute dtype, as the TPU kernel does.
    kern_dtype = torch.float32 if device.type == "cuda" else f
    syz_k, rsyz_k = syz.to(kern_dtype), rsyz.to(kern_dtype)

    def kblock(u, v, carry, nstart, kk, bxo):
        ctk = ct[nstart + 1: nstart + 1 + kk]
        sxct = ctk[:, None] * sx[None, :]
        u2, v2, c2, dmax, rmax = stencil_cuda.fused_kstep_comp(
            u, v, carry, syz_k, rsyz_k, sxct.to(kern_dtype),
            k=kk, coeff=problem.a2tau2, inv_h2=problem.inv_h2,
            block_x=bxo, with_errors=compute_errors,
            c2tau2_field=c2tau2_field,
        )
        if compute_errors:
            with tracing.annotate("verify.errors"):
                return (u2, v2, c2) + kfused._block_errors(
                    dmax, rmax, ctk, xmask, inv_absx
                )
        return u2, v2, c2, None, None

    def march(u, v, carry, start, abs_all, rel_all, stop=nsteps):
        nblocks = (stop - start) // k
        rem = (stop - start) - nblocks * k
        layer = start
        for kk, count, bxo in ((k, nblocks, block_x), (1, rem, None)):
            for _ in range(count):
                u, v, carry, a, r = kblock(u, v, carry, layer, kk, bxo)
                if compute_errors:
                    abs_all[layer + 1: layer + 1 + kk] = a
                    rel_all[layer + 1: layer + 1 + kk] = r
                layer += kk
        return u, v, carry

    return march


def _bootstrap(problem, dtype, v_dtype, carry_on, carry_dtype, device,
               field=None, phase: float = oracle.TWO_PI):
    """Layers 0/1: analytic init + K2's half-step u1 = u0 + (C/2)lap(u0)
    with v = carry = 0 in the state dtype, then v cast to `v_dtype` and the
    carry to `carry_dtype` (reference bootstrap: openmp_sol.cpp:123-145).
    With a `field` the half-step coefficient is tau^2 c^2(x)/2 and K4f at
    k=1 runs it (the same Kahan sequence, the field as the Laplacian
    coefficient), with zero v and carry in their storage dtypes and no
    error rows.  A shifted `phase` (constant speed) takes the exact
    analytic two-level start instead: u1 analytic, v1
    `leapfrog.analytic_increment_layer1` in `v_dtype`, a zero carry."""
    if leapfrog.check_phase(phase, field):
        u1 = leapfrog.analytic_layer(problem, dtype, device, phase, 1)
        v1 = leapfrog.analytic_increment_layer1(problem, v_dtype, device,
                                                phase)
        c1 = (torch.zeros(u1.shape, dtype=carry_dtype, device=device)
              if carry_on else None)
        return u1, v1, c1
    u0 = leapfrog.initial_layer0(problem, dtype, device)
    if field is None:
        zero = torch.zeros_like(u0)
        u1, v1, c1 = stencil_cuda.compensated_step(
            u0, zero, zero, problem, 0.5 * problem.a2tau2
        )
        return u1, v1.to(v_dtype), (c1.to(carry_dtype) if carry_on else None)
    n = problem.N
    zero_plane = torch.zeros((n, n), dtype=torch.float32, device=device)
    u1, v1, c1, _, _ = stencil_cuda.fused_kstep_comp(
        u0, torch.zeros(u0.shape, dtype=v_dtype, device=device),
        torch.zeros(u0.shape, dtype=carry_dtype, device=device)
        if carry_on else None,
        zero_plane, zero_plane,
        torch.zeros((1, n), dtype=torch.float32, device=device),
        k=1, coeff=None, inv_h2=problem.inv_h2, with_errors=False,
        c2tau2_field=0.5 * field,
    )
    return u1, v1, c1


def _as_result(problem, u, v, c, abs_all, rel_all, init_s, solve_s,
               steps_computed, final_step):
    f = stencil_ref.compute_dtype(u.dtype)
    return leapfrog.SolveResult(
        problem=problem,
        u_prev=(u.to(f) - v.to(f)).to(u.dtype),
        u_cur=u,
        abs_errors=abs_all,
        rel_errors=rel_all,
        init_seconds=init_s,
        solve_seconds=solve_s,
        steps_computed=steps_computed,
        final_step=final_step,
        comp_v=v,
        comp_carry=c,
    )


def solve_kfused_comp(
    problem: Problem,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    stop_step: Optional[int] = None,
    block_x: Optional[int] = None,
    v_dtype=None,
    carry: bool = True,
    carry_dtype=None,
    c2tau2_field=None,
    device=None,
    phase: float = oracle.TWO_PI,
) -> leapfrog.SolveResult:
    """The compensated k-fused solve with the reference's timing phases (as
    `leapfrog.solve`): the bootstrap and the march are timed, the kernel
    build and the oracle and field set-up are not.  `carry_dtype` defaults
    to `_default_carry_dtype` (bf16 for f32 runs); `block_x` is K4's carry
    slab depth (default `stencil_cuda.default_block_x`: the deepest
    multiple of k dividing N, up to 32 planes).  `c2tau2_field`
    (host (N,N,N) tau^2 c^2 array or tensor) selects the variable-c march
    (K4f); pair it with compute_errors=False.  `phase` as
    `leapfrog.solve`'s (the analytic start of `_bootstrap`)."""
    device = leapfrog.resolve_device(device)
    leapfrog.check_phase(phase, c2tau2_field)
    v_dtype = dtype if v_dtype is None else v_dtype
    carry_dtype = (
        _default_carry_dtype(dtype) if carry_dtype is None else carry_dtype
    )
    if carry:
        _validate_carry_dtype(dtype, carry_dtype)
    _validate(problem, dtype, v_dtype, carry, k, c2tau2_field,
              compute_errors)
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    f = stencil_ref.compute_dtype(dtype)
    with phases.SolveSpans("kfused_comp", problem, nsteps, k) as ph:
        with ph.init():
            leapfrog.prepare_kernels(device)
            errors = _error_fn_guarded(problem, dtype, device, phase)
            field = None
            if c2tau2_field is not None:
                field = state.c2tau2_field(c2tau2_field, dtype, device)
            march = _make_march(problem, dtype, k, compute_errors, block_x,
                                nsteps, device, field, phase)
            abs_all = torch.zeros(nsteps + 1, dtype=f, device=device)
            rel_all = torch.zeros(nsteps + 1, dtype=f, device=device)
            leapfrog._sync(device)
        with phases.bootstrap():
            u1, v1, c1 = _bootstrap(problem, dtype, v_dtype, carry,
                                    carry_dtype, device, field, phase)
            if compute_errors:
                with tracing.annotate("verify.errors"):
                    abs_all[1], rel_all[1] = errors(u1, 1)
        with phases.march():
            u, v, c = march(u1, v1, c1, 1, abs_all, rel_all)
        with ph.readback():
            abs_np = leapfrog._host(abs_all)
            rel_np = leapfrog._host(rel_all)
            leapfrog._sync(device)
        result = _as_result(problem, u, v, c, abs_np, rel_np,
                            ph.init_seconds, ph.solve_seconds, stop_step,
                            nsteps)
        ph.record(result, scheme="compensated", k=k,
                  v_itemsize=v_dtype.itemsize, carry=carry,
                  carry_itemsize=carry_dtype.itemsize if carry else None,
                  with_field=c2tau2_field is not None)
    return result


def _validate_sharded(problem: Problem, dtype, v_dtype, carry, k, n_x,
                      n_y: int = 1, c2tau2_field=None,
                      compute_errors: bool = True):
    _validate(problem, dtype, v_dtype, carry, k, c2tau2_field,
              compute_errors)
    _validate_mesh(problem, k, n_x, n_y)


def _validate_mesh(problem: Problem, k: int, n_x: int, n_y: int):
    """The (MX, MY, 1) decomposition rules of the distributed flagship."""
    if n_x < 1 or n_y < 1:
        raise ValueError(
            f"mesh axes must be >= 1 (got MX={n_x}, MY={n_y})"
        )
    if problem.N % n_x:
        raise ValueError(
            f"sharded compensated k-fusion needs N % shards == 0 "
            f"(N={problem.N}, shards={n_x})"
        )
    if (problem.N // n_x) % k:
        raise ValueError(
            f"k={k} must divide the shard depth {problem.N // n_x}"
        )
    if problem.N % n_y:
        raise ValueError(
            f"y-sharded compensated k-fusion needs N % y-shards == 0 "
            f"(N={problem.N}, y-shards={n_y})"
        )
    if problem.N // n_y < k:
        raise ValueError(
            f"k={k} exceeds the y shard depth {problem.N // n_y}"
        )


def _make_sharded_runner(problem, mesh, dtype, v_dtype, carry_on, k,
                         compute_errors, nsteps, block_x, carry_dtype,
                         c2tau2_field=None):
    """Set up the distributed flagship over the (MX, MY, 1) `mesh` and
    return `(run, march, errors_of)`: `run()` -> (u, v, carry | None
    blocks, rows) marches from layer 0 to nsteps; `march(u, v, carry,
    start, stop)` (lists of blocks) marches layers start+1..stop - the
    resumed and chunked marches, on the uninterrupted march's block grid
    from an aligned start - and returns the same; `errors_of(rows)` reads
    the kernels' error rows back as per-layer host f64 arrays of nsteps+1
    entries (zero where no layer was marched).  One block_x serves every launch
    (default `default_block_x(N/MX, k)`, which equals the single-device
    default `default_block_x(N, k)` wherever that divides N/MX), so the op
    sequence matches the single-device kernel's slab partition."""
    n_x, n_y, _ = mesh.shape
    devices = list(mesh.devices)
    n = problem.N
    nl, nl_y = n // n_x, n // n_y
    bx = block_x or stencil_cuda.default_block_x(nl, k)
    if nl % bx or bx % k:
        raise ValueError(f"block_x={bx} must divide the shard depth {nl} "
                         f"and be a multiple of k={k}")
    f = stencil_ref.compute_dtype(dtype)
    if any(dev.type == "cuda" for dev in devices):
        stencil_cuda.load_libraries()
    host = torch.device("cpu")
    sx, ct, syz, rsyz, xmask, inv_absx = oracle_parts_guarded(problem, f,
                                                              host)
    sxct_all = ct[:, None] * sx[None, :]                     # (T+1, N)
    local = mesh.local
    sxct_on = {devices[i]: sxct_all.to(devices[i]) for i in local}
    planes = [tuple(a[cy * nl_y:(cy + 1) * nl_y].to(dev).contiguous()
                    for a in (syz, rsyz)) if mesh.is_local(i) else None
              for i, (dev, (_, cy, _)) in enumerate(zip(devices,
                                                        mesh.coords))]
    topo = Topology(N=n, mesh_shape=mesh.shape)
    u0 = split_global(leapfrog.initial_layer0(problem, dtype, host), topo,
                      mesh).blocks
    packs = {kk: [None] * len(devices) for kk in (1, k)}
    half = [None] * len(devices)
    if c2tau2_field is not None:
        fields = split_global(state.c2tau2_field(c2tau2_field, dtype, host),
                              topo, mesh).blocks
        for kk in (1, k):
            packs[kk] = [None if b is None else (b, g) for b, g in
                         zip(*sharded_kfused.exchange(fields, mesh, kk))]
        # The bootstrap's half field (wavetpu's field_pack(0.5 * fld, 1)):
        # halving is exact, so it is the k=1 pack halved.
        half = each(lambda p: (0.5 * p[0], (0.5 * p[1][0], 0.5 * p[1][1])),
                    packs[1])

    def kcall(u, v, c, kk, layer, coeff, with_errors, fpack):
        """kk fused layers (layer+1 .. layer+kk) of every shard."""
        ue, ug = sharded_kfused.exchange(u, mesh, kk)
        ve, vg = sharded_kfused.exchange(v, mesh, kk)
        outs = [None] * len(devices)
        for i in local:
            dev = devices[i]
            cx, cy, _ = mesh.coords[i]
            fp = fpack[i]
            kw = dict(k=kk, coeff=coeff, inv_h2=problem.inv_h2,
                      c2_ghosts=None if fp is None else fp[1], block_x=bx,
                      with_errors=with_errors)
            sxct_k = sxct_on[dev][layer + 1:layer + 1 + kk,
                                  cx * nl:(cx + 1) * nl].contiguous()
            if n_y == 1:
                outs[i] = stencil_cuda.fused_kstep_comp_sharded(
                    ue[i], ve[i], c[i], ug[i], vg[i], *planes[i], sxct_k,
                    c2tau2_block=None if fp is None else fp[0], **kw)
            else:
                outs[i] = stencil_cuda.fused_kstep_comp_sharded_xy(
                    ue[i], ve[i], c[i], ug[i], vg[i], *planes[i], sxct_k,
                    cy * nl_y, n, nl_y=nl_y,
                    c2tau2_ext=None if fp is None else fp[0], **kw)
        return outs

    def new_rows():
        return [[torch.zeros((nsteps + 1, nl), dtype=f, device=dev)
                 if mesh.is_local(i) else None
                 for i, dev in enumerate(devices)]
                for _ in range(2)] if compute_errors else None

    def step(state_, kk, layer, coeff, with_errors, fpack, rows):
        outs = kcall(*state_, kk, layer, coeff, with_errors, fpack)
        if with_errors:
            for i in local:
                rows[0][i][layer + 1:layer + 1 + kk] = outs[i][3]
                rows[1][i][layer + 1:layer + 1 + kk] = outs[i][4]
        return tuple([None if o is None else o[j] for o in outs]
                     for j in range(3))

    def advance(st, start, stop, rows):
        """Layers start+1..stop: (stop-start)//k blocks, then k=1 tail
        launches of the same kernel."""
        nblocks = (stop - start) // k
        layer = start
        for kk, count in ((k, nblocks), (1, stop - start - nblocks * k)):
            for _ in range(count):
                st = step(st, kk, layer, problem.a2tau2, compute_errors,
                          packs[kk], rows)
                layer += kk
        return st

    def errors_of(rows):
        if not compute_errors:
            z = np.zeros(nsteps + 1)
            return z, z.copy()
        dmax, rmax = (sharded_kfused.rows_max_y(
            dist.gather_shards(mesh, rs), n_x, n_y, host) for rs in rows)
        with tracing.annotate("verify.errors"):
            abs_e, rel_e = kfused._block_errors(
                dmax, rmax, ct[:nsteps + 1], xmask, inv_absx)
        return leapfrog._host(abs_e), leapfrog._host(rel_e)

    def run():
        with phases.bootstrap():
            rows = new_rows()
            zero_v = each(lambda b: torch.zeros(b.shape, dtype=v_dtype,
                                                device=b.device), u0)
            zero_c = [torch.zeros(b.shape, dtype=carry_dtype,
                                  device=b.device)
                      if carry_on and b is not None else None for b in u0]
            # Layer 1: the same kernel at k=1, coeff C/2 on zero v and
            # carry (the compensated half-step; half the field with a
            # field).
            st = step((u0, zero_v, zero_c), 1, 0, 0.5 * problem.a2tau2,
                      False, half, rows)
            if compute_errors:
                with tracing.annotate("verify.errors"):
                    for i in local:
                        dev = devices[i]
                        cx = mesh.coords[i][0]
                        dr, rr = sharded_kfused._layer_rows_local(
                            st[0][i], sxct_on[dev][1, cx * nl:(cx + 1) * nl],
                            *planes[i], f)
                        rows[0][i][1:2] = dr
                        rows[1][i][1:2] = rr
        with phases.march():
            st = advance(st, 1, nsteps, rows)
        return st + (rows,)

    def march(u, v, c, start, stop):
        rows = new_rows()
        st = advance((u, v, c if carry_on else [None] * len(u)), start,
                     stop, rows)
        return st + (rows,)

    return run, march, errors_of


def solve_kfused_comp_sharded(
    problem: Problem,
    n_shards: Optional[int] = None,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    stop_step: Optional[int] = None,
    block_x: Optional[int] = None,
    devices=None,
    v_dtype=None,
    carry: bool = True,
    mesh_shape=None,
    carry_dtype=None,
    c2tau2_field=None,
) -> leapfrog.SolveResult:
    """The distributed flagship: the compensated k-fused solve over an
    (MX, MY, 1) mesh (wavetpu's mpi_new.cpp role with the compensated
    accuracy class), timed as `leapfrog.solve`.  `n_shards` is the x-only
    shorthand; requires MX | N, k | N/MX, MY | N, k <= N/MY.  `devices`
    (default: every visible card) lists the mesh's devices in mesh order
    and may repeat one.  `carry_dtype`, `v_dtype` / `carry=False` (the
    bf16 increment mode) and `c2tau2_field` as `solve_kfused_comp`.
    u_prev, u_cur, comp_v and comp_carry are `ShardedArray`s on the
    Topology layout of the mesh (comp_carry None without a carry)."""
    devices = leapfrog.resolve_devices(devices)
    n_x, n_y = sharded_kfused._resolve_grid(mesh_shape, n_shards, devices)
    v_dtype = dtype if v_dtype is None else v_dtype
    if carry and carry_dtype is not None:
        _validate_carry_dtype(dtype, carry_dtype)
    carry_dtype = (_default_carry_dtype(dtype) if carry_dtype is None
                   else carry_dtype)
    _validate_sharded(problem, dtype, v_dtype, carry, k, n_x, n_y,
                      c2tau2_field, compute_errors)
    if len(devices) < n_x * n_y:
        raise ValueError(f"mesh ({n_x}, {n_y}, 1) needs {n_x * n_y} "
                         f"devices, only {len(devices)} available")
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    mesh = build_mesh((n_x, n_y, 1), devices[:n_x * n_y])
    with phases.SolveSpans("kfused_comp_sharded", problem, nsteps, k) as ph:
        with ph.init():
            run, _, errors_of = _make_sharded_runner(
                problem, mesh, dtype, v_dtype, carry, k, compute_errors,
                nsteps, block_x, carry_dtype, c2tau2_field)
            sharded_kfused._sync(mesh)
        u, v, c, rows = run()
        with ph.readback():
            abs_np, rel_np = errors_of(rows)
            sharded_kfused._sync(mesh)
        f = stencil_ref.compute_dtype(dtype)
        topo = Topology(N=problem.N, mesh_shape=mesh.shape)

        def sharded(blocks):
            return ShardedArray(list(blocks), topo, mesh)

        result = leapfrog.SolveResult(
            problem=problem,
            u_prev=sharded(each(lambda a, b: (a.to(f) - b.to(f)).to(a.dtype),
                                u, v)),
            u_cur=sharded(u),
            abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=stop_step, final_step=nsteps,
            comp_v=sharded(v),
            comp_carry=sharded(c) if carry else None,
        )
        ph.record(result, scheme="compensated", k=k,
                  v_itemsize=v_dtype.itemsize, carry=carry,
                  carry_itemsize=carry_dtype.itemsize if carry else None,
                  with_field=c2tau2_field is not None,
                  block=(problem.N // n_x, problem.N // n_y, problem.N),
                  mesh_shape=(n_x, n_y, 1), rows=compute_errors)
    return result


def _resume_state(u_cur, v, carry, dtype, v_dtype):
    """(u, v, carry | None) of an injected flagship state as tensors (or
    ShardedArrays): u in the state dtype, v in `v_dtype` (default: its
    stored dtype), the carry normalized (`_normalize_carry`)."""
    u = state.as_tensor(u_cur)
    vv = state.as_tensor(v)
    v_dtype = vv.dtype if v_dtype is None else v_dtype
    c = None if carry is None else _normalize_carry(state.as_tensor(carry),
                                                    dtype)
    return u, vv, c, v_dtype


def resume_kfused_comp(
    problem: Problem,
    u_cur,
    v,
    carry,
    start_step: int,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    block_x: Optional[int] = None,
    v_dtype=None,
    c2tau2_field=None,
    device=None,
) -> leapfrog.SolveResult:
    """Re-enter the flagship march at layer `start_step` from a
    compensated checkpoint's (u_cur, v, carry); `carry=None` resumes the
    carry-less increment form.  The march is the uninterrupted one's from
    that layer: on a block-aligned start ((start_step - 1) % k == 0) with
    the same `block_x` the resumed layers are bitwise the uninterrupted
    run's; elsewhere the block grid shifts and they agree to the scheme's
    tolerance.  A bf16 stored carry stays bf16 for an f32 state; `v_dtype`
    defaults to the stored v's dtype.  A variable-c checkpoint resumes
    under the re-passed `c2tau2_field`."""
    device = leapfrog.resolve_device(device)
    nsteps = problem.timesteps
    leapfrog._check_start(start_step, nsteps)
    u, vv, c, v_dtype = _resume_state(u_cur, v, carry, dtype, v_dtype)
    _validate(problem, dtype, v_dtype, c is not None, k, c2tau2_field,
              compute_errors)
    f = stencil_ref.compute_dtype(dtype)
    with phases.SolveSpans("kfused_comp", problem, nsteps - start_step,
                           k) as ph:
        with ph.init():
            leapfrog.prepare_kernels(device)
            field = None
            if c2tau2_field is not None:
                field = state.c2tau2_field(c2tau2_field, dtype, device)
            march = _make_march(problem, dtype, k, compute_errors, block_x,
                                nsteps, device, field)
            u = u.to(device=device, dtype=dtype).contiguous()
            vv = vv.to(device=device, dtype=v_dtype).contiguous()
            c = None if c is None else c.to(device).contiguous()
            abs_all = torch.zeros(nsteps + 1, dtype=f, device=device)
            rel_all = torch.zeros(nsteps + 1, dtype=f, device=device)
            leapfrog._sync(device)
        with phases.march():
            u, vv, c = march(u, vv, c, start_step, abs_all, rel_all)
        with ph.readback():
            abs_np = leapfrog._host(abs_all)
            rel_np = leapfrog._host(rel_all)
            leapfrog._sync(device)
        result = _as_result(problem, u, vv, c, abs_np, rel_np,
                            ph.init_seconds, ph.solve_seconds,
                            nsteps - start_step, nsteps)
        ph.record(result, scheme="compensated", k=k,
                  v_itemsize=v_dtype.itemsize, carry=c is not None,
                  carry_itemsize=c.dtype.itemsize if c is not None else None,
                  with_field=c2tau2_field is not None)
    return result


def make_chunk_runner(
    problem: Problem,
    dtype=torch.float32,
    length: int = 4,
    k: int = 4,
    compute_errors: bool = True,
    block_x: Optional[int] = None,
    v_dtype=None,
    carry: bool = True,
    c2tau2_field=None,
    device=None,
):
    """Fixed-length flagship re-entry for supervised solves, built once per
    configuration (kernels loaded, oracle planes and field on the device):
    `runner(u, v, carry, start)` -> (u, v, carry, abs, rel) marches layers
    start+1..start+length (carry None for the carry-less increment form).
    On block-aligned starts with length a multiple of k - the supervisor's
    chunks - the op sequence is the uninterrupted march's, so supervision
    keeps the flagship's exact trajectory."""
    if length < 1:
        raise ValueError(f"chunk length must be >= 1, got {length}")
    device = leapfrog.resolve_device(device)
    v_dtype = dtype if v_dtype is None else v_dtype
    _validate(problem, dtype, v_dtype, carry, k, c2tau2_field,
              compute_errors)
    f = stencil_ref.compute_dtype(dtype)
    nsteps = problem.timesteps
    leapfrog.prepare_kernels(device)
    field = None
    if c2tau2_field is not None:
        field = state.c2tau2_field(c2tau2_field, dtype, device)
    march = _make_march(problem, dtype, k, compute_errors, block_x, nsteps,
                        device, field)

    def run(u_cur, v, carry_, start: int):
        stop = leapfrog._chunk_stop(start, length, nsteps)
        u, vv, c, _ = _resume_state(u_cur, v, carry_ if carry else None,
                                    dtype, v_dtype)
        abs_all = torch.zeros(nsteps + 1, dtype=f, device=device)
        rel_all = torch.zeros(nsteps + 1, dtype=f, device=device)
        u, vv, c = march(u.to(device=device, dtype=dtype).contiguous(),
                         vv.to(device=device, dtype=v_dtype).contiguous(),
                         None if c is None else c.to(device).contiguous(),
                         start, abs_all, rel_all, stop)
        return (u, vv, c, leapfrog._host(abs_all[start + 1:stop + 1]),
                leapfrog._host(rel_all[start + 1:stop + 1]))

    return run


def _sharded_setup(problem, n_x, n_y, devices, dtype, v_dtype, carry_on, k,
                   compute_errors, block_x, carry_dtype, c2tau2_field):
    """(mesh, topo, march, errors_of) of the distributed flagship's resumed
    and chunked marches over the first MX*MY `devices`
    (`_make_sharded_runner`)."""
    _validate_sharded(problem, dtype, v_dtype, carry_on, k, n_x, n_y,
                      c2tau2_field, compute_errors)
    if len(devices) < n_x * n_y:
        raise ValueError(f"mesh ({n_x}, {n_y}, 1) needs {n_x * n_y} "
                         f"devices, only {len(devices)} available")
    mesh = build_mesh((n_x, n_y, 1), devices[:n_x * n_y])
    _, march, errors_of = _make_sharded_runner(
        problem, mesh, dtype, v_dtype, carry_on, k, compute_errors,
        problem.timesteps, block_x,
        carry_dtype if carry_dtype is not None else dtype, c2tau2_field)
    return (mesh, Topology(N=problem.N, mesh_shape=mesh.shape), march,
            errors_of)


def _sharded_state(topo, mesh, u, v, c, dtype, v_dtype):
    """An injected (u, v, carry) - ShardedArrays, or wavetpu's padded
    global arrays - as block lists on the mesh (the carry keeps its
    normalized dtype)."""
    return (state.to_blocks(u, topo, mesh, dtype),
            state.to_blocks(v, topo, mesh, v_dtype),
            None if c is None else state.to_blocks(c, topo, mesh))


def resume_kfused_comp_sharded(
    problem: Problem,
    u_cur,
    v,
    carry,
    start_step: int,
    n_shards: Optional[int] = None,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    block_x: Optional[int] = None,
    devices=None,
    v_dtype=None,
    mesh_shape=None,
    c2tau2_field=None,
) -> leapfrog.SolveResult:
    """Re-enter the distributed flagship at layer `start_step` from a
    sharded compensated checkpoint's (u_cur, v, carry) - ShardedArrays or
    padded global arrays (carry=None: the increment form) - on the
    (MX, MY, 1) mesh over `devices` (default: every visible card)."""
    devices = leapfrog.resolve_devices(devices)
    n_x, n_y = sharded_kfused._resolve_grid(mesh_shape, n_shards, devices)
    nsteps = problem.timesteps
    leapfrog._check_start(start_step, nsteps)
    u, vv, c, v_dtype = _resume_state(u_cur, v, carry, dtype, v_dtype)
    with phases.SolveSpans("kfused_comp_sharded", problem,
                           nsteps - start_step, k) as ph:
        with ph.init():
            mesh, topo, march, errors_of = _sharded_setup(
                problem, n_x, n_y, devices, dtype, v_dtype, c is not None, k,
                compute_errors, block_x, None if c is None else c.dtype,
                c2tau2_field)
            st = _sharded_state(topo, mesh, u, vv, c, dtype, v_dtype)
            sharded_kfused._sync(mesh)
        with phases.march():
            u, vv, c, rows = march(*st, start_step, nsteps)
        with ph.readback():
            abs_e, rel_e = errors_of(rows)
            sharded_kfused._sync(mesh)
        head = np.zeros(start_step + 1)
        f = stencil_ref.compute_dtype(dtype)

        def sharded(blocks):
            return None if blocks is None or blocks[mesh.local[0]] is None \
                else ShardedArray(list(blocks), topo, mesh)

        result = leapfrog.SolveResult(
            problem=problem,
            u_prev=sharded(each(lambda a, b: (a.to(f) - b.to(f)).to(a.dtype),
                                u, vv)),
            u_cur=sharded(u),
            abs_errors=np.concatenate([head, abs_e[start_step + 1:]]),
            rel_errors=np.concatenate([head, rel_e[start_step + 1:]]),
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=nsteps - start_step, final_step=nsteps,
            comp_v=sharded(vv), comp_carry=sharded(c),
        )
        ph.record(result, scheme="compensated", k=k,
                  v_itemsize=v_dtype.itemsize, carry=c is not None,
                  carry_itemsize=(c[mesh.local[0]].dtype.itemsize
                                  if c is not None else None),
                  with_field=c2tau2_field is not None,
                  block=(problem.N // n_x, problem.N // n_y, problem.N),
                  mesh_shape=(n_x, n_y, 1), rows=compute_errors)
    return result


def make_sharded_chunk_runner(
    problem: Problem,
    mesh_shape,
    devices,
    dtype=torch.float32,
    length: int = 4,
    k: int = 4,
    compute_errors: bool = True,
    block_x: Optional[int] = None,
    v_dtype=None,
    carry: bool = True,
    carry_dtype=None,
    c2tau2_field=None,
):
    """The sharded counterpart of `make_chunk_runner` over an (MX, MY, 1)
    mesh of `devices`: `runner(u, v, carry, start)` -> (u, v, carry,
    abs, rel) with the state as ShardedArrays on the Topology layout (or
    padded global arrays) and the result as ShardedArrays - the
    supervised chunk of the distributed flagship."""
    if length < 1:
        raise ValueError(f"chunk length must be >= 1, got {length}")
    devices = [torch.device(dv) for dv in devices]
    n_x, n_y = sharded_kfused._resolve_grid(mesh_shape, None, devices)
    v_dtype = dtype if v_dtype is None else v_dtype
    if carry:
        carry_dtype = (_default_carry_dtype(dtype) if carry_dtype is None
                       else carry_dtype)
        _validate_carry_dtype(dtype, carry_dtype)
    mesh, topo, march, errors_of = _sharded_setup(
        problem, n_x, n_y, devices, dtype, v_dtype, carry, k,
        compute_errors, block_x, carry_dtype if carry else None,
        c2tau2_field)
    nsteps = problem.timesteps

    def run(u_cur, v, carry_, start: int):
        stop = leapfrog._chunk_stop(start, length, nsteps)
        u, vv, c, _ = _resume_state(u_cur, v, carry_ if carry else None,
                                    dtype, v_dtype)
        u, vv, c, rows = march(
            *_sharded_state(topo, mesh, u, vv, c, dtype, v_dtype), start,
            stop)
        abs_e, rel_e = errors_of(rows)
        return (ShardedArray(u, topo, mesh), ShardedArray(vv, topo, mesh),
                None if c[mesh.local[0]] is None
                else ShardedArray(c, topo, mesh),
                abs_e[start + 1:stop + 1], rel_e[start + 1:stop + 1])

    return run
