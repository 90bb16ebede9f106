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

from typing import Callable

import numpy as np
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


def laplacian_ext(ext, inv_h2):
    """7-point Laplacian of the interior of a halo-extended block.

    `ext` has one ghost cell on each side of each axis: shape (bx+2, by+2,
    bz+2); the result has shape (bx, by, bz), summed in the same order as
    `laplacian`.  Used by the sharded solver, where ghost planes arrive
    from the neighbouring shards instead of the rolls.
    """
    ix, iy, iz = inv_h2
    c = ext[1:-1, 1:-1, 1:-1]
    lap = (ext[:-2, 1:-1, 1:-1] + ext[2:, 1:-1, 1:-1] - 2.0 * c) * ix
    lap = lap + (ext[1:-1, :-2, 1:-1] + ext[1:-1, 2:, 1:-1] - 2.0 * c) * iy
    lap = lap + (ext[1:-1, 1:-1, :-2] + ext[1:-1, 1:-1, 2:] - 2.0 * c) * iz
    return lap


def ghost_extend(u, ghosts, hi_at=None):
    """The (bx+2, by+2, bz+2) extension of block `u`: its cells at offset 1,
    each axis's `lo` ghost plane at position 0 and its `hi` ghost at
    hi_at[a] + 1 (default: the block's end); the corners and any cell past
    a hi ghost stay zero.  `ghosts` is ((xlo, xhi), (ylo, yhi), (zlo, zhi))
    with each plane shaped like the block's face."""
    shape = u.shape
    hi_at = shape if hi_at is None else hi_at
    ext = torch.zeros(tuple(s + 2 for s in shape), dtype=u.dtype,
                      device=u.device)
    ext[1:-1, 1:-1, 1:-1] = u
    inner = [slice(1, s + 1) for s in shape]
    for axis, (lo, hi) in enumerate(ghosts):
        for pos, g in ((0, lo), (hi_at[axis] + 1, hi)):
            idx = list(inner)
            idx[axis] = slice(pos, pos + 1)
            ext[tuple(idx)] = g
    return ext


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


def make_c2tau2_field(
    problem: Problem, c2_fn: Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray]
) -> np.ndarray:
    """Evaluate tau^2 * c^2(x, y, z) on the fundamental grid, host-side f64.

    `c2_fn` takes broadcastable (x, y, z) coordinate arrays and returns the
    squared wave speed.  The constant-speed problem is `c2_fn = lambda
    x, y, z: problem.a2`; the result then equals `problem.a2tau2`
    everywhere.  (A verbatim copy of wavetpu's, so a field means the same
    physics in both packages.)

    Variable wave speed is a capability extension over the reference (its
    a^2 is hardcoded, openmp_sol.cpp:207); the analytic oracle only holds
    for constant speed, so variable-c runs should pass compute_errors=False.
    """
    n = problem.N
    x = (np.arange(n, dtype=np.float64) * problem.hx)[:, None, None]
    y = (np.arange(n, dtype=np.float64) * problem.hy)[None, :, None]
    z = (np.arange(n, dtype=np.float64) * problem.hz)[None, None, :]
    c2 = np.broadcast_to(
        np.asarray(c2_fn(x, y, z), dtype=np.float64), (n, n, n)
    )
    return c2 * problem.tau**2


C2_PRESET_NAMES = ("constant", "gaussian-lens", "two-layer")


def make_preset_c2tau2_field(problem: Problem, name: str) -> np.ndarray:
    """The named tau^2 c^2(x,y,z) presets, the same table as wavetpu's
    (CLI `--c2-field`), so a preset name means the same physics in both
    packages.

    constant: c^2 = a^2 everywhere (collapses to a2tau2).  gaussian-lens: a
    slow-speed lens dipping to a^2/2 at the domain centre.  two-layer: a
    discontinuous interface with the far z half running at DOUBLE c^2
    (Courant-unstable at configs whose constant-c C is already near the
    bound).
    """
    a2 = problem.a2

    def _gaussian_lens(x, y, z):
        s2 = 2.0 * (problem.Lx / 8.0) ** 2
        r2 = (
            (x - problem.Lx / 2) ** 2
            + (y - problem.Ly / 2) ** 2
            + (z - problem.Lz / 2) ** 2
        )
        return a2 * (1.0 - 0.5 * np.exp(-r2 / s2))

    presets = {
        "constant": lambda x, y, z: a2 * np.ones_like(x + y + z),
        "gaussian-lens": _gaussian_lens,
        "two-layer": lambda x, y, z: np.where(
            z < problem.Lz / 2, a2, 2.0 * a2
        ) + 0.0 * x + 0.0 * y,
    }
    if name not in presets:
        raise ValueError(
            f"c2 preset must be one of {sorted(presets)}, got {name!r}"
        )
    return make_c2tau2_field(problem, presets[name])


def make_variable_c_step(c2tau2_field):
    """A plain full-field step with spatially varying speed:
    u_next = 2u - u_prev + tau^2 c^2(x,y,z) lap(u), Dirichlet re-imposed.

    `c2tau2_field` is a device tensor (the caller places it once); the
    returned `(u_prev, u, problem) -> u_next` slots into
    `leapfrog.solve(step_fn=...)`.  It casts the field to the compute dtype
    per call; the K5 step (`stencil_cuda.make_step_fn`) takes it as is.
    """

    def step(u_prev, u, problem: Problem):
        f = compute_dtype(u.dtype)
        uc = u.to(f)
        u_next = 2.0 * uc - u_prev.to(f) + c2tau2_field.to(f) * laplacian(
            uc, problem.inv_h2
        )
        return apply_dirichlet(u_next).to(u.dtype)

    return step


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
