"""Analytic-solution oracle and per-layer error accounting (torch port of
wavetpu/verify/oracle.py).

The reference validates every run against the closed-form solution and
reports per-layer L-infinity absolute and relative error over the interior
points, global (i,j,k) in [1, N-1]^3 (openmp_sol.cpp:169-190,
mpi_new.cpp:335-345).  The solution is separable,

    u(t,x,y,z) = Sx(x) * Sy(y) * Sz(z) * cos(a_t*t + 2*pi),

so the three 1-D spatial factors are computed once and the analytic field
of a layer is two broadcast multiplies and one scalar cosine.

Every transcendental is evaluated in float64 numpy on the host and cast
once: a device `cos` may be a fast-math approximation, which would pollute
the oracle (wavetpu measured ~3e-8 for XLA's).  No `torch.cos` runs here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem

TWO_PI = 2.0 * math.pi


def spatial_factors_np(problem: Problem, n_points: int):
    """Host-f64 1-D spatial factors over indices 0..n_points-1 (numpy).

    sx[i] = sin(2*pi*(i*hx)/Lx), sy[j] = sin(pi*(j*hy)/Ly),
    sz[k] = sin(pi*(k*hz)/Lz).
    """
    i = np.arange(n_points, dtype=np.float64)
    sx = np.sin(2.0 * np.pi * (i * problem.hx) / problem.Lx)
    sy = np.sin(np.pi * (i * problem.hy) / problem.Ly)
    sz = np.sin(np.pi * (i * problem.hz) / problem.Lz)
    return sx, sy, sz


def spatial_factors(problem: Problem, dtype=torch.float32, device="cpu"):
    """1-D spatial factors (sx, sy, sz) on the fundamental (N,N,N) grid,
    computed in float64 on the host and cast once."""
    return tuple(
        torch.tensor(a, dtype=dtype, device=device)
        for a in spatial_factors_np(problem, problem.N)
    )


def time_factor(problem: Problem, n: int, dtype=torch.float32, device="cpu",
                phase: float = TWO_PI):
    """cos(a_t * tau * n + phase) for a static layer n, computed on host."""
    return torch.tensor(
        np.cos(problem.a_t * problem.tau * float(n) + phase),
        dtype=dtype, device=device,
    )


def time_factor_table_np(problem: Problem, phase: float = TWO_PI) -> np.ndarray:
    """Host-f64 cos(a_t*tau*n + phase) for every layer n in [0, timesteps]."""
    n = np.arange(problem.timesteps + 1, dtype=np.float64)
    return np.cos(problem.a_t * problem.tau * n + phase)


def time_factor_table(problem: Problem, dtype=torch.float32, device="cpu",
                      phase: float = TWO_PI):
    """`time_factor_table_np` cast once to `dtype` on `device`; indexed by
    the layer counter inside the march, so the device never evaluates a
    transcendental."""
    return torch.tensor(
        time_factor_table_np(problem, phase), dtype=dtype, device=device
    )


def analytic_field(sx, sy, sz, ct):
    """Broadcast the separable analytic solution to an (N,N,N) field, in the
    reference's multiply order ((sx*sy)*sz)*ct."""
    return sx[:, None, None] * sy[None, :, None] * sz[None, None, :] * ct


def interior_masks_1d(n: int, start: int = 0) -> np.ndarray:
    """Boolean 1-D mask selecting the error interior of a block: the
    reference's error loops cover global indices 1..N-1 on every axis, i.e.
    "exclude global index 0" (`start` is the block's global offset)."""
    idx = np.arange(start, start + n)
    return idx != 0


def layer_errors(u, f, mask_x=None, mask_y=None, mask_z=None):
    """L-inf absolute and relative error of field `u` vs analytic field `f`
    (0-d tensors on u's device; no host sync).

    Matches the reference metric (mpi_new.cpp:340-344): abs = |u - f|,
    rel = |u - f| / |f|, max over the interior.  Points where numerator and
    denominator both vanish (the reference's fmax skips the NaN) contribute
    0.  A NaN in `u` still surfaces in abs: amax propagates NaN.

    The 1-D masks select the interior; without them the whole of `u` counts
    (pass interior views, e.g. u[1:, 1:, 1:], to skip the masking passes).
    Neither input is modified.
    """
    diff = (u - f).abs_()
    rel = f.abs()
    torch.div(diff, rel, out=rel)
    rel.nan_to_num_(nan=0.0, posinf=math.inf, neginf=-math.inf)
    if mask_x is not None:
        mask = (
            mask_x[:, None, None] & mask_y[None, :, None]
            & mask_z[None, None, :]
        )
        diff = torch.where(mask, diff, 0.0)
        rel = torch.where(mask, rel, 0.0)
    return diff.amax(), rel.amax()
