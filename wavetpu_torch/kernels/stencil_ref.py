"""Plain PyTorch leapfrog + 7-point Laplacian stencil (torch port of
wavetpu/kernels/stencil_ref.py, the semantic reference).

Everything is expressed as cyclic rolls, which is exact because of the
state representation documented in `wavetpu_torch.core.problem`:

 * x is the fundamental periodic domain, so rolls ARE the boundary
   condition;
 * y/z hold the Dirichlet invariant u[:,0,:] = u[:,:,0] = 0, so a cyclic
   roll delivers the correct zero neighbour for the j = N-1 / k = N-1
   planes, and the j=0 / k=0 planes are re-zeroed after each update.

The CUDA kernels of `stencil_cuda` must agree with these functions to
rounding on identical inputs.  Note the summation order: `leapfrog_step`
here is the reference's `2u - u_prev + c*lap`, while the kernels (and
their plain versions in `stencil_cuda`) keep the Pallas kernels'
`2u + c*lap - u_prev`.
"""

from __future__ import annotations

import torch

from wavetpu_torch.core.problem import Problem


def compute_dtype(dtype):
    """bf16 state computes in f32 (bf16 storage + fp32 accumulation);
    everything else computes as stored."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def laplacian(u, inv_h2):
    """7-point Laplacian with cyclic shifts on all three axes."""
    ix, iy, iz = inv_h2
    lap = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0) - 2.0 * u) * ix
    lap = lap + (torch.roll(u, 1, 1) + torch.roll(u, -1, 1) - 2.0 * u) * iy
    lap = lap + (torch.roll(u, 1, 2) + torch.roll(u, -1, 2) - 2.0 * u) * iz
    return lap


def apply_dirichlet(u):
    """Re-impose the Dirichlet invariant on a copy: zero the stored y=0 and
    z=0 planes (the y=N / z=N planes are not stored; see problem.py)."""
    u = u.clone()
    u[:, 0, :] = 0.0
    u[:, :, 0] = 0.0
    return u


def leapfrog_step(u_prev, u, problem: Problem):
    """u_next = 2u - u_prev + a^2 tau^2 lap(u), Dirichlet re-imposed
    (openmp_sol.cpp:160).  bf16 state computes in f32 and stores bf16."""
    f = compute_dtype(u.dtype)
    uc = u.to(f)
    u_next = 2.0 * uc - u_prev.to(f) + problem.a2tau2 * laplacian(
        uc, problem.inv_h2
    )
    return apply_dirichlet(u_next).to(u.dtype)


def taylor_half_step(u0, problem: Problem):
    """Layer-1 bootstrap: u1 = u0 + (a^2 tau^2 / 2) lap(u0)  (u_t(0) = 0;
    openmp_sol.cpp:137-144)."""
    f = compute_dtype(u0.dtype)
    uc = u0.to(f)
    u1 = uc + (0.5 * problem.a2tau2) * laplacian(uc, problem.inv_h2)
    return apply_dirichlet(u1).to(u0.dtype)


def compensated_step(u, v, carry, problem: Problem, coeff=None):
    """One step of the compensated (Kahan) incremental leapfrog:

        v_{n+1} = v_n + C*lap(u_n)
        u_{n+1} = u_n + v_{n+1}          (two-sum through `carry`)

    The Dirichlet mask applies to the increment only: u, v and carry all
    start masked and sums of masked fields stay masked.  `coeff` defaults
    to a2tau2; the layer-1 bootstrap is this step with v = carry = 0 and
    coeff = a2tau2/2 (the Taylor half-step).
    """
    c = problem.a2tau2 if coeff is None else coeff
    d = apply_dirichlet(c * laplacian(u, problem.inv_h2))
    v_next = v + d
    y = v_next - carry
    t = u + y
    carry_next = (t - u) - y
    return t, v_next, carry_next
