"""Temporally fused k-step solver, standard scheme (torch port of the
single-device half of wavetpu/solver/kfused.py).

The march runs (nsteps-1)//k blocks of k leapfrog layers, each one launch
of K3 (`stencil_cuda.fused_kstep`), which keeps the intermediate layers out
of device memory and writes only the block's last two; a remainder of
fewer than k layers runs the 1-step kernel (K1).  Layer 1 is derived from
the 1-step kernel exactly as `leapfrog.solve` derives it.  At N=512 /
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

`resume_kfused` and `make_chunk_runner` come with checkpoints and
supervision (ROADMAP.md queue 1 items 8 and 9).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.obs import metrics as obs_metrics
from wavetpu_torch.solver import leapfrog
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
    """(k,) abs / rel layer errors from the kernel's (k, N) plane maxes."""
    abs_e = torch.where(xmask[None, :], dmax, 0.0).amax(dim=1)
    rel_e = torch.where(
        xmask[None, :], rmax * inv_absx[None, :], 0.0
    ).amax(dim=1)
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
                c2tau2_field=None):
    """Shared march: k-fused blocks + a 1-step remainder tail.

    Returns `(march, step1, errors)`; `march(u_prev, u_cur, start, abs_all,
    rel_all)` -> (u_prev, u_cur) covers layers start+1..nsteps and writes
    their errors into the device vectors.  `c2tau2_field` is a device
    tensor in the compute dtype (or None).
    """
    f = stencil_ref.compute_dtype(dtype)
    sx, ct, syz, rsyz, xmask, inv_absx = _oracle_parts(problem, f, device)
    errors = leapfrog._error_fn(problem, dtype, device)
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
            return (up, uc) + _block_errors(dmax, rmax, ctk, xmask,
                                            inv_absx)
        return up, uc, None, None

    def march(u_prev, u_cur, start, abs_all, rel_all):
        nblocks = (nsteps - start) // k
        layer = start
        for _ in range(nblocks):
            u_prev, u_cur, a, r = kblock(u_prev, u_cur, layer)
            if compute_errors:
                abs_all[layer + 1: layer + 1 + k] = a
                rel_all[layer + 1: layer + 1 + k] = r
            layer += k
        # The remainder: the 1-step kernel with full-field errors.
        return leapfrog._march(problem, step1, errors, compute_errors,
                               u_prev, u_cur, layer, nsteps, abs_all,
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
):
    """Set up the k-fused solve - kernels built and loaded, the oracle
    planes and the field (once, in the compute dtype) on the device, layer
    0 - and return `run()` -> (u_prev, u_cur, abs_all, rel_all) with the
    per-layer error vectors on the device.

    Layers 0/1 bootstrap as `leapfrog.solve` with the 1-step kernel (K1,
    K5 with a field); then (nsteps-1)//k K3 blocks; a remainder of
    (nsteps-1) % k layers runs the 1-step kernel.  Requires 2 <= k <= 8,
    k | N; a field requires compute_errors=False.
    """
    device = leapfrog.resolve_device(device)
    _validate(problem, k, c2tau2_field, compute_errors)
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
                                       nsteps, device, field)
    u0 = leapfrog.initial_layer0(problem, dtype, device)

    def run():
        abs_all = torch.zeros(nsteps + 1, dtype=f, device=device)
        rel_all = torch.zeros(nsteps + 1, dtype=f, device=device)
        u1 = (0.5 * (u0.to(f) + step1(u0, u0, problem).to(f))).to(dtype)
        if compute_errors:
            abs_all[1], rel_all[1] = errors(u1, 1)
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
) -> leapfrog.SolveResult:
    """The k-fused solve with the reference's timing phases (as
    `leapfrog.solve`): `init_seconds` covers the kernel build/load and the
    set-up, `solve_seconds` the bootstrap, the march and the read-back of
    the error vectors.  `c2tau2_field` (host (N,N,N) tau^2 c^2 array,
    `stencil_ref.make_c2tau2_field`, or a tensor) selects the variable-c
    march; pair it with compute_errors=False."""
    device = leapfrog.resolve_device(device)
    t0 = time.perf_counter()
    run = make_kfused_solver(problem, dtype, k, compute_errors, stop_step,
                             c2tau2_field, device)
    leapfrog._sync(device)
    t1 = time.perf_counter()
    u_prev, u_cur, abs_all, rel_all = run()
    abs_np, rel_np = leapfrog._host(abs_all), leapfrog._host(rel_all)
    leapfrog._sync(device)
    t2 = time.perf_counter()
    result = leapfrog.SolveResult(
        problem=problem, u_prev=u_prev, u_cur=u_cur,
        abs_errors=abs_np, rel_errors=rel_np,
        init_seconds=t1 - t0, solve_seconds=t2 - t1,
        steps_computed=stop_step,
        final_step=problem.timesteps if stop_step is None else stop_step,
    )
    obs_metrics.record_solve(result, "kfused", k=k,
                             with_field=c2tau2_field is not None)
    return result
