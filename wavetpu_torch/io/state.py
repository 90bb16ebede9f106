"""State carried across: turn the numpy arrays of a wavetpu run (e.g.
`np.asarray` of a wavetpu `SolveResult`'s u_prev / u_cur / comp_v /
comp_carry, or a checkpoint's arrays) into the port's tensors, so a march
begun in wavetpu continues in the port (`leapfrog.resume`).

A JAX bf16 array becomes an `ml_dtypes.bfloat16` numpy array, which
`torch.from_numpy` refuses; its bits go through `uint16` instead and are
reinterpreted as `torch.bfloat16` - exact, no rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wavetpu_torch.solver.leapfrog import resolve_device


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy array (any float dtype, ml_dtypes bf16 included) as a
    contiguous tensor of the same dtype on `device` (default: CUDA)."""
    device = resolve_device(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_numpy_state(
    u_prev, u_cur, v=None, carry=None, device=None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """(u_prev, u_cur, v, carry) as tensors on `device` (default: CUDA);
    None stays None (the standard scheme has no v or carry)."""
    return tuple(
        None if a is None else to_tensor(a, device)
        for a in (u_prev, u_cur, v, carry)
    )
