"""State carried across: turn the numpy arrays of a wavetpu run (e.g.
`np.asarray` of a wavetpu `SolveResult`'s u_prev / u_cur / comp_v /
comp_carry, or a checkpoint's arrays) into the port's tensors, so a march
begun in wavetpu continues in the port (`leapfrog.resume`).  The same holds
for a variable-c run's coefficient: `c2tau2_field` places wavetpu's host
tau^2 c^2 array (`stencil_ref.make_preset_c2tau2_field` in either package)
on the device once, in the compute dtype the kernels take.

A JAX bf16 array becomes an `ml_dtypes.bfloat16` numpy array, which
`torch.from_numpy` refuses; its bits go through `uint16` instead and are
reinterpreted as `torch.bfloat16` - exact, no rounding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wavetpu_torch.kernels.stencil_ref import compute_dtype
from wavetpu_torch.solver import leapfrog


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy array (any float dtype, ml_dtypes bf16 included) as a
    contiguous tensor of the same dtype on `device` (default: CUDA)."""
    device = leapfrog.resolve_device(device)
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


def c2tau2_field(field, dtype=torch.float32, device=None) -> torch.Tensor:
    """A tau^2 c^2 (N, N, N) field (host f64 numpy, as wavetpu and
    `stencil_ref.make_c2tau2_field` build it, or a tensor) as a contiguous
    tensor on `device` (default: CUDA) in the compute dtype of a `dtype`
    state: f32 for f32 and bf16 states, f64 for f64 - one rounding from
    f64, as wavetpu's `jnp.asarray(field, compute_dtype)`."""
    device = leapfrog.resolve_device(device)
    t = field if isinstance(field, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(field, dtype=np.float64))
    return t.to(device=device, dtype=compute_dtype(dtype)).contiguous()
