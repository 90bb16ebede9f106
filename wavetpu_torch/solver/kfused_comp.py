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

There is no bitwise-parity claim against the 1-step scheme (intermediate
layers skip the storage round trip, halo carries differ); the contract is
tolerance parity vs f64.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, leapfrog
from wavetpu_torch.verify import oracle

# The K4 kernel's shared-memory tile holds k <= 8 (stencil_cuda.kstep_tile).
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


def _validate(problem: Problem, dtype, v_dtype, carry, k: int):
    if k < 2:
        raise ValueError(f"k must be >= 2 (got {k}); use "
                         "leapfrog.solve_compensated for k=1")
    if k > MAX_K:
        raise ValueError(f"k must be <= {MAX_K} (got {k}): the K4 kernel's "
                         "shared-memory tile holds no deeper cone")
    if problem.N % k:
        raise ValueError(f"k={k} must divide N={problem.N}")
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


def _error_fn_guarded(problem: Problem, dtype, device):
    """Layer-error fn with the representation-zero sx planes excluded, so
    the bootstrap layer's metric matches the in-kernel layers'."""
    f_dtype = stencil_ref.compute_dtype(dtype)
    sx, sy, sz = oracle.spatial_factors(problem, f_dtype, device)
    ct_table = oracle.time_factor_table(problem, f_dtype, device)
    mask = torch.as_tensor(oracle.interior_masks_1d(problem.N), device=device)
    mask_x = mask & (sx.abs() > _rel_guard_tol(f_dtype))

    def errors(u, n):
        f = oracle.analytic_field(sx, sy, sz, ct_table[n])
        return oracle.layer_errors(u.to(f_dtype), f, mask_x, mask, mask)

    return errors


def _make_march(problem, dtype, k, compute_errors, block_x, nsteps, device):
    """Shared march: k-fused blocks + a k=1 tail through the SAME kernel.

    Returns `march(u, v, carry, start, abs_all, rel_all)` -> (u, v, carry)
    covering layers start+1..nsteps and writing their errors into the
    device vectors.
    """
    f = stencil_ref.compute_dtype(dtype)
    sx, ct, syz, rsyz, xmask, inv_absx = kfused._oracle_parts(
        problem, f, device
    )
    # Rel-metric guard: exclude representation-level zeros of the periodic
    # x factor (sin at the domain midpoint evaluates to ~1.2e-16, not 0,
    # and 1/|sx| would amplify the velocity-form onion's ~2e-9 asymmetry
    # into garbage).  Abs errors are untouched.
    inv_absx = torch.where(sx.abs() > _rel_guard_tol(f), inv_absx, 0.0)
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
        )
        if compute_errors:
            return (u2, v2, c2) + kfused._block_errors(
                dmax, rmax, ctk, xmask, inv_absx
            )
        return u2, v2, c2, None, None

    def march(u, v, carry, start, abs_all, rel_all):
        nblocks = (nsteps - start) // k
        rem = (nsteps - start) - nblocks * k
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


def _bootstrap(problem, dtype, v_dtype, carry_on, carry_dtype, device):
    """Layers 0/1: analytic init + K2's half-step u1 = u0 + (C/2)lap(u0)
    with v = carry = 0 in the state dtype, then v cast to `v_dtype` and the
    carry to `carry_dtype` (reference bootstrap: openmp_sol.cpp:123-145)."""
    u0 = leapfrog.initial_layer0(problem, dtype, device)
    zero = torch.zeros_like(u0)
    u1, v1, c1 = stencil_cuda.compensated_step(
        u0, zero, zero, problem, 0.5 * problem.a2tau2
    )
    return u1, v1.to(v_dtype), (c1.to(carry_dtype) if carry_on else None)


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
    device=None,
) -> leapfrog.SolveResult:
    """The compensated k-fused solve with the reference's timing phases (as
    `leapfrog.solve`): the bootstrap and the march are timed, the kernel
    build and the oracle set-up are not.  `carry_dtype` defaults to
    `_default_carry_dtype` (bf16 for f32 runs); `block_x` is K4's carry
    slab depth (default `stencil_cuda.default_block_x`)."""
    device = leapfrog.resolve_device(device)
    v_dtype = dtype if v_dtype is None else v_dtype
    carry_dtype = (
        _default_carry_dtype(dtype) if carry_dtype is None else carry_dtype
    )
    if carry:
        _validate_carry_dtype(dtype, carry_dtype)
    _validate(problem, dtype, v_dtype, carry, k)
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    f = stencil_ref.compute_dtype(dtype)
    t0 = time.perf_counter()
    leapfrog.prepare_kernels(device)
    errors = _error_fn_guarded(problem, dtype, device)
    march = _make_march(problem, dtype, k, compute_errors, block_x, nsteps,
                        device)
    abs_all = torch.zeros(nsteps + 1, dtype=f, device=device)
    rel_all = torch.zeros(nsteps + 1, dtype=f, device=device)
    leapfrog._sync(device)
    t1 = time.perf_counter()

    u1, v1, c1 = _bootstrap(problem, dtype, v_dtype, carry, carry_dtype,
                            device)
    if compute_errors:
        abs_all[1], rel_all[1] = errors(u1, 1)
    u, v, c = march(u1, v1, c1, 1, abs_all, rel_all)
    abs_np = abs_all.cpu().numpy().astype(np.float64)
    rel_np = rel_all.cpu().numpy().astype(np.float64)
    leapfrog._sync(device)
    t2 = time.perf_counter()
    return _as_result(problem, u, v, c, abs_np, rel_np, t1 - t0, t2 - t1,
                      stop_step, nsteps)
