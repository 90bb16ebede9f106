"""Temporally fused k-step solver, standard scheme (torch port of the
single-device half of wavetpu/solver/kfused.py).

The march runs (nsteps-1)//k blocks of k leapfrog layers, each one launch
of K3 (`stencil_cuda.fused_kstep`), which keeps the intermediate layers out
of device memory and writes only the block's last two; a remainder of
fewer than k layers runs the 1-step kernel (K1).  Layer 1 is derived from
the 1-step kernel exactly as `leapfrog.solve` derives it (the analytic
layer 1 for a shifted `phase`, as there).  At N=512 /
1000 steps / k=4: 249 K3 launches and 4 K1 launches (bootstrap + 3 tail).

Each K3 substep is op for op K1's update, so k-fused layers are bitwise
equal to 1-step layers (the contract of stencil_pallas.py:750-755).

The k-step kernels emit per-substep, per-x-plane error maxes (`dmax`/
`rmax`, (k, N) f32 rows) instead of the intermediate layers; this module
builds the oracle planes they need and turns the rows into per-layer L-inf
abs/rel errors with the x != 0 interior mask - the reference error
contract (mpi_new.cpp:335-345).  The remainder tail takes full-field
errors, as the 1-step path does.  The compensated flagship
(solver/kfused_comp.py) shares these helpers.

Variable wave speed: `c2tau2_field` (a tau^2 c^2 (N,N,N) host array or
tensor) is placed on the device once, in the compute dtype, before the
timed region; every k-block then runs K3's field operand and the
bootstrap and tail run K5.  There is no analytic oracle for variable c,
so a field requires compute_errors=False.

`resume_kfused` re-enters the march at a checkpoint's layer and
`make_chunk_runner` marches a supervised run's fixed-length chunks
(run/supervisor.py); both run `_make_march`'s march, so their layers are
the uninterrupted march's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.obs import tracing
from wavetpu_torch.solver import leapfrog, phases
from wavetpu_torch.verify import oracle

# The K3 kernel's pipeline takes k <= 8 (stencil_cuda.kstep_pipe_tile).
MAX_K = 8


def _oracle_parts(problem: Problem, f_dtype, device,
                  phase: float = oracle.TWO_PI):
    """(sx, ct, syz, rsyz, xmask, inv_absx) on `device` in `f_dtype`.

    syz / rsyz are the (N, N) planes sy*sz and 1/|sy*sz| (exact-zero cells
    -> 0: there u = f = 0 and the reference's NaN-skip reports 0).
    inv_absx is the per-x-plane rescale 1/|sx| with the x=0 interior
    exclusion and exact zeros folded in.
    """
    sx, sy, sz = oracle.spatial_factors(problem, f_dtype, device)
    ct = oracle.time_factor_table(problem, f_dtype, device, phase)
    syz = sy[:, None] * sz[None, :]
    one = torch.ones((), dtype=f_dtype, device=device)
    rsyz = torch.where(syz == 0, 0.0, 1.0 / torch.where(syz == 0, one, syz))
    rsyz = rsyz.abs()
    absx = sx.abs()
    xmask = torch.as_tensor(np.arange(problem.N) != 0, device=device)
    inv_absx = torch.where(
        xmask & (absx != 0),
        1.0 / torch.where(absx == 0, one, absx),
        0.0,
    )
    return sx, ct, syz, rsyz, xmask, inv_absx


def _block_errors(dmax, rmax, ctk, xmask, inv_absx):
    """(k,) abs / rel layer errors from the kernel's (k, N) plane maxes (or
    (B, k) from a lane batch's (B, k, N) rows and (B, k) time factors:
    the same elementwise ops and exact maxima, lane by lane)."""
    abs_e = torch.where(xmask, dmax, 0.0).amax(dim=-1)
    rel_e = torch.where(xmask, rmax * inv_absx, 0.0).amax(dim=-1)
    ictk = ctk.abs()
    rel_e = torch.where(
        ictk != 0, rel_e / torch.where(ictk == 0, 1.0, ictk), 0.0
    )
    return abs_e, rel_e


def _validate(problem: Problem, k: int, c2tau2_field=None,
              compute_errors: bool = True):
    if k < 2:
        raise ValueError(f"k must be >= 2 (got {k}); use leapfrog.solve "
                         "with the 1-step kernel for k=1")
    if k > MAX_K:
        raise ValueError(f"k must be <= {MAX_K} (got {k}): the K3 kernel's "
                         f"pipeline holds at most {MAX_K} stages")
    if problem.N % k:
        raise ValueError(f"k={k} must divide N={problem.N}")
    if c2tau2_field is not None and compute_errors:
        raise ValueError(
            "variable-c runs have no analytic oracle; pass "
            "compute_errors=False with c2tau2_field"
        )


def _make_march(problem, dtype, k, compute_errors, nsteps, device,
                c2tau2_field=None, phase: float = oracle.TWO_PI):
    """Shared march: k-fused blocks + a 1-step remainder tail.

    Returns `(march, step1, errors)`; `march(u_prev, u_cur, start, abs_all,
    rel_all, stop=nsteps)` -> (u_prev, u_cur) covers layers start+1..stop
    and writes their errors into the device vectors.  `c2tau2_field` is a device
    tensor in the compute dtype (or None); `phase` the analytic solution's
    time phase.
    """
    f = stencil_ref.compute_dtype(dtype)
    sx, ct, syz, rsyz, xmask, inv_absx = _oracle_parts(problem, f, device,
                                                       phase)
    errors = leapfrog._error_fn(problem, dtype, device, phase)
    step1 = stencil_cuda.make_step_fn(c2tau2_field)
    # The kernel takes f32 oracle planes; the plain version (CPU) takes them
    # in the compute dtype, as the TPU kernel does.
    kern_dtype = torch.float32 if device.type == "cuda" else f
    syz_k, rsyz_k = syz.to(kern_dtype), rsyz.to(kern_dtype)

    def kblock(u_prev, u, nstart):
        ctk = ct[nstart + 1: nstart + 1 + k]
        sxct = ctk[:, None] * sx[None, :]
        up, uc, dmax, rmax = stencil_cuda.fused_kstep(
            u_prev, u, syz_k, rsyz_k, sxct.to(kern_dtype),
            k=k, coeff=problem.a2tau2, inv_h2=problem.inv_h2,
            c2tau2_field=c2tau2_field, with_errors=compute_errors,
        )
        if compute_errors:
            with tracing.annotate("verify.errors"):
                return (up, uc) + _block_errors(dmax, rmax, ctk, xmask,
                                                inv_absx)
        return up, uc, None, None

    def march(u_prev, u_cur, start, abs_all, rel_all, stop=nsteps):
        nblocks = (stop - start) // k
        layer = start
        for _ in range(nblocks):
            u_prev, u_cur, a, r = kblock(u_prev, u_cur, layer)
            if compute_errors:
                abs_all[layer + 1: layer + 1 + k] = a
                rel_all[layer + 1: layer + 1 + k] = r
            layer += k
        # The remainder: the 1-step kernel with full-field errors.
        return leapfrog._march(problem, step1, errors, compute_errors,
                               u_prev, u_cur, layer, stop, abs_all,
                               rel_all)

    return march, step1, errors


def make_kfused_solver(
    problem: Problem,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    stop_step: Optional[int] = None,
    c2tau2_field=None,
    device=None,
    phase: float = oracle.TWO_PI,
):
    """Set up the k-fused solve - kernels built and loaded, the oracle
    planes and the field (once, in the compute dtype) on the device, layer
    0 - and return `run()` -> (u_prev, u_cur, abs_all, rel_all) with the
    per-layer error vectors on the device.

    Layers 0/1 bootstrap as `leapfrog.solve` with the 1-step kernel (K1,
    K5 with a field; the analytic layer 1 for a shifted `phase`); then
    (nsteps-1)//k K3 blocks; a remainder of (nsteps-1) % k layers runs the
    1-step kernel.  Requires 2 <= k <= 8, k | N; a field requires
    compute_errors=False and the reference phase.
    """
    device = leapfrog.resolve_device(device)
    _validate(problem, k, c2tau2_field, compute_errors)
    analytic = leapfrog.check_phase(phase, c2tau2_field)
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    f = stencil_ref.compute_dtype(dtype)
    leapfrog.prepare_kernels(device)
    field = None
    if c2tau2_field is not None:
        field = state.c2tau2_field(c2tau2_field, dtype, device)
    march, step1, errors = _make_march(problem, dtype, k, compute_errors,
                                       nsteps, device, field, phase)
    u0 = leapfrog.initial_layer0(problem, dtype, device, phase)

    def run():
        with phases.bootstrap():
            abs_all = torch.zeros(nsteps + 1, dtype=f, device=device)
            rel_all = torch.zeros(nsteps + 1, dtype=f, device=device)
            u1 = (leapfrog.analytic_layer(problem, dtype, device, phase, 1)
                  if analytic else leapfrog.step_layer1(u0, step1, problem,
                                                        dtype))
            if compute_errors:
                with tracing.annotate("verify.errors"):
                    abs_all[1], rel_all[1] = errors(u1, 1)
        with phases.march():
            u_prev, u_cur = march(u0, u1, 1, abs_all, rel_all)
        return u_prev, u_cur, abs_all, rel_all

    return run


def solve_kfused(
    problem: Problem,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    stop_step: Optional[int] = None,
    c2tau2_field=None,
    device=None,
    phase: float = oracle.TWO_PI,
) -> leapfrog.SolveResult:
    """The k-fused solve with the reference's timing phases (as
    `leapfrog.solve`): `init_seconds` covers the kernel build/load and the
    set-up, `solve_seconds` the bootstrap, the march and the read-back of
    the error vectors.  `c2tau2_field` (host (N,N,N) tau^2 c^2 array,
    `stencil_ref.make_c2tau2_field`, or a tensor) selects the variable-c
    march; pair it with compute_errors=False.  `phase` as
    `leapfrog.solve`'s."""
    device = leapfrog.resolve_device(device)
    nsteps = problem.timesteps if stop_step is None else stop_step
    with phases.SolveSpans("kfused", problem, nsteps, k) as ph:
        with ph.init():
            run = make_kfused_solver(problem, dtype, k, compute_errors,
                                     stop_step, c2tau2_field, device, phase)
            leapfrog._sync(device)
        u_prev, u_cur, abs_all, rel_all = run()
        with ph.readback():
            abs_np, rel_np = leapfrog._host(abs_all), leapfrog._host(rel_all)
            leapfrog._sync(device)
        result = leapfrog.SolveResult(
            problem=problem, u_prev=u_prev, u_cur=u_cur,
            abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=stop_step, final_step=nsteps,
        )
        ph.record(result, k=k, with_field=c2tau2_field is not None)
    return result


def _setup(problem, dtype, k, compute_errors, c2tau2_field, device):
    """Kernels loaded, the field placed once and the march built, for the
    resumed and chunked marches (run to `problem.timesteps` at most)."""
    _validate(problem, k, c2tau2_field, compute_errors)
    leapfrog.prepare_kernels(device)
    field = None
    if c2tau2_field is not None:
        field = state.c2tau2_field(c2tau2_field, dtype, device)
    march, _, _ = _make_march(problem, dtype, k, compute_errors,
                              problem.timesteps, device, field)
    return march


def resume_kfused(
    problem: Problem,
    u_prev,
    u_cur,
    start_step: int,
    dtype=torch.float32,
    k: int = 4,
    compute_errors: bool = True,
    c2tau2_field=None,
    device=None,
) -> leapfrog.SolveResult:
    """Re-enter the k-fused march at layer `start_step` from (u_prev,
    u_cur) (tensors, or numpy arrays as a wavetpu result or a checkpoint
    holds them): (T - start_step)//k K3 blocks, then the 1-step tail.  The
    layers equal the uninterrupted march's bit for bit (each K3 substep is
    K1's update), whatever block grid the stop left; the error vectors
    are zero up to start_step.  A variable-c checkpoint resumes under the
    re-passed `c2tau2_field` (checkpoints store state, not the field)."""
    device = leapfrog.resolve_device(device)
    nsteps = problem.timesteps
    leapfrog._check_start(start_step, nsteps)
    with phases.SolveSpans("kfused", problem, nsteps - start_step,
                           k) as ph:
        with ph.init():
            march = _setup(problem, dtype, k, compute_errors, c2tau2_field,
                           device)
            f = stencil_ref.compute_dtype(dtype)
            u_p = leapfrog._state_in(u_prev, dtype, device)
            u_c = leapfrog._state_in(u_cur, dtype, device)
            abs_all = torch.zeros(nsteps + 1, dtype=f, device=device)
            rel_all = torch.zeros(nsteps + 1, dtype=f, device=device)
            leapfrog._sync(device)
        with phases.march():
            u_p, u_c = march(u_p, u_c, start_step, abs_all, rel_all)
        with ph.readback():
            abs_np, rel_np = leapfrog._host(abs_all), leapfrog._host(rel_all)
            leapfrog._sync(device)
        result = leapfrog.SolveResult(
            problem=problem, u_prev=u_p, u_cur=u_c,
            abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=nsteps - start_step, final_step=nsteps,
        )
        ph.record(result, k=k, with_field=c2tau2_field is not None)
    return result


def make_chunk_runner(
    problem: Problem,
    dtype=torch.float32,
    length: int = 4,
    k: int = 4,
    compute_errors: bool = True,
    c2tau2_field=None,
    device=None,
):
    """Fixed-length k-fused re-entry for supervised solves, built once per
    configuration (kernels loaded, oracle planes and field on the device):
    `runner(u_prev, u_cur, start)` -> (u_prev, u_cur, abs, rel) marches
    layers start+1..start+length - length//k K3 blocks, then the 1-step
    tail - with the chunk's errors as host f64 arrays."""
    if length < 1:
        raise ValueError(f"chunk length must be >= 1, got {length}")
    device = leapfrog.resolve_device(device)
    march = _setup(problem, dtype, k, compute_errors, c2tau2_field, device)
    f = stencil_ref.compute_dtype(dtype)
    nsteps = problem.timesteps

    def run(u_prev, u_cur, start: int):
        stop = leapfrog._chunk_stop(start, length, nsteps)
        abs_all = torch.zeros(nsteps + 1, dtype=f, device=device)
        rel_all = torch.zeros(nsteps + 1, dtype=f, device=device)
        u_p, u_c = march(leapfrog._state_in(u_prev, dtype, device),
                         leapfrog._state_in(u_cur, dtype, device), start,
                         abs_all, rel_all, stop)
        return (u_p, u_c, leapfrog._host(abs_all[start + 1:stop + 1]),
                leapfrog._host(rel_all[start + 1:stop + 1]))

    return run
