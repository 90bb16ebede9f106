"""Separable-oracle helpers of the temporally fused solvers (torch port of
wavetpu/solver/kfused.py:57-105).

The k-step kernels never write intermediate layers to memory, so they emit
per-substep, per-x-plane error maxes instead (`dmax`/`rmax`, (k, N) f32
rows); this module builds the oracle planes they need and turns the rows
into per-layer L-inf abs/rel errors with the x != 0 interior mask - the
reference error contract (mpi_new.cpp:335-345).

The standard k-fused march and its kernel (K3, `fused_kstep`) are not
ported yet; the compensated flagship (solver/kfused_comp.py) uses these
helpers.
"""

from __future__ import annotations

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.verify import oracle


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
