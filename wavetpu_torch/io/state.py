"""State carried across: turn the numpy arrays of a wavetpu run (e.g.
`np.asarray` of a wavetpu `SolveResult`'s u_prev / u_cur / comp_v /
comp_carry, or a checkpoint's arrays) into the port's tensors, so a march
begun in wavetpu continues in the port (`leapfrog.resume`).  The same holds
for a variable-c run's coefficient: `c2tau2_field` places wavetpu's host
tau^2 c^2 array (`stencil_ref.make_preset_c2tau2_field` in either package)
on the device once, in the compute dtype the kernels take.

A wavetpu sharded state (a `solve_sharded` / `solve_sharded_kfused`
result, or a sharded checkpoint's arrays) is the padded global
`Topology.padded` array; `split_sharded` cuts it into the port's shard
blocks on given devices (a `ShardedArray`) and `assemble_sharded` puts them
back together, so a state crosses between the packages in either
direction.  A variable-c field crosses the same way after wavetpu's
`pad_field`.

A JAX bf16 array becomes an `ml_dtypes.bfloat16` numpy array, which
`torch.from_numpy` refuses; its bits go through `uint16` instead and are
reinterpreted as `torch.bfloat16` - exact, no rounding - and back.

Resumed and chunked marches take their state through `as_tensor` (one
array, any of these forms) and, on a mesh, `to_blocks`: a checkpoint's
arrays (u_prev, u_cur, comp_v, comp_carry, a bf16 carry included) - as
ShardedArrays from io/checkpoint.py, or wavetpu's padded global arrays -
become the blocks a sharded march takes; `assemble_sharded` and
io/checkpoint.py's shard files take them back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from wavetpu_torch.core.grid import (
    ShardedArray, Topology, build_mesh, each, pad_global, split_global,
)
from wavetpu_torch.kernels.stencil_ref import compute_dtype
from wavetpu_torch.solver import phases


def to_tensor(a, device=None) -> torch.Tensor:
    """One numpy array (any float dtype, ml_dtypes bf16 included) as a
    contiguous tensor of the same dtype on `device` (default: CUDA)."""
    device = phases.resolve_device(device)
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
    device = phases.resolve_device(device)
    t = field if isinstance(field, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(field, dtype=np.float64))
    return t.to(device=device, dtype=compute_dtype(dtype)).contiguous()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array of the same dtype; bf16 comes back as
    `ml_dtypes.bfloat16` (what a JAX bf16 array converts to) where that
    package is installed, else as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return bits
    return bits.view(ml_dtypes.bfloat16)


def split_sharded(a, n: int, mesh_shape, devices) -> ShardedArray:
    """A wavetpu sharded array - the padded global (Topology.padded) array
    of an N-point problem on `mesh_shape`, as numpy, bf16 included - as the
    port's shard blocks, block i on devices[i] (mesh order; a device may
    repeat)."""
    topo = Topology(N=n, mesh_shape=tuple(mesh_shape))
    mesh = build_mesh(topo.mesh_shape, devices)
    return split_global(to_tensor(a, "cpu"), topo, mesh)


def assemble_sharded(u: ShardedArray) -> np.ndarray:
    """The port's shard blocks back as wavetpu's padded global numpy
    array (`split_sharded`'s inverse)."""
    return to_numpy(u.assemble("cpu"))


def as_tensor(a):
    """A state array as the port holds it: a tensor or a ShardedArray
    stays as it is; a numpy array (ml_dtypes bf16 or float) becomes a CPU
    tensor of the same dtype."""
    if isinstance(a, (torch.Tensor, ShardedArray)):
        return a
    return to_tensor(a, "cpu")


def to_blocks(a, topo: Topology, mesh, dtype=None):
    """One state array as the mesh's blocks (block i on mesh.devices[i], in
    `dtype`, default its own): a ShardedArray of the same topology is
    moved block by block; a tensor or numpy array of the padded global
    shape (wavetpu's sharded arrays) - or of the (N, N, N) fundamental
    domain, zero-padded - is cut with `split_global`."""
    if isinstance(a, ShardedArray):
        if a.topo != topo:
            raise ValueError(f"state on mesh {a.topo.mesh_shape} "
                             f"(N={a.topo.N}) given to mesh "
                             f"{topo.mesh_shape} (N={topo.N})")
        return each(lambda b, dev: b.to(device=dev,
                                        dtype=dtype or b.dtype).contiguous(),
                    a.blocks, mesh.devices)
    t = as_tensor(a)
    if tuple(t.shape) == (topo.N,) * 3 and topo.padded != tuple(t.shape):
        t = pad_global(t, topo)
    return split_global(t, topo, mesh, dtype).blocks
