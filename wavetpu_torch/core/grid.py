"""Sharded state and the 3D device mesh (torch port of wavetpu/core/grid.py).

The fundamental (N, N, N) domain is decomposed over an (MX, MY, MZ) mesh
with the reference's near-cubic factorization (`MPI_Dims_create`,
mpi_sol.cpp:405-459).  Every shard holds an equal block; an axis that the
mesh dim does not divide is zero-padded to `block * mesh_dim`, and its last
shard owns `r_last < block` real planes (the seam arithmetic of
`comm/halo.py` and the pad mask of the sharded kernels follow from it).

A mesh here is a list of `torch.device`s in mesh order (x slowest, z
fastest, as `np.reshape` lays out wavetpu's device array), and one device
may appear more than once: several shards then live on one card, or all of
them on the CPU, driven by one process - the single-controller shape of
wavetpu's `shard_map`.  A sharded tensor is a `ShardedArray`: one block per
shard on that shard's device.

Under `--distributed` (comm/dist.py) the mesh spans processes: shard i
belongs to rank i // (S / W), process-major as wavetpu's `jax.devices()`
orders them (`Mesh.ranks`), and a process holds only its own shards'
blocks - a block list keeps one entry per shard, None where another rank
holds it, and the device of such a shard is `meta`.  Without a process
group `ranks` is None and every shard is local.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence, Tuple

import torch

AXIS_NAMES = ("x", "y", "z")


def choose_mesh_shape(n_devices: int) -> Tuple[int, int, int]:
    """Near-cubic 3D factorization of `n_devices` (MPI_Dims_create analog).

    Returns (mx, my, mz) with mx >= my >= mz, as balanced as possible
    (reference relies on MPI_Dims_create the same way, mpi_sol.cpp:407).
    """
    best = (n_devices, 1, 1)
    best_score = n_devices  # max/min spread proxy: the max dim
    for a in range(1, int(round(n_devices ** (1 / 3))) + 2):
        if n_devices % a:
            continue
        rest = n_devices // a
        for b in range(a, int(math.isqrt(rest)) + 1):
            if rest % b:
                continue
            c = rest // b
            dims = tuple(sorted((a, b, c), reverse=True))
            if dims[0] < best_score:
                best, best_score = dims, dims[0]
    return best


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static decomposition of the fundamental (N, N, N) domain over a mesh.

    block[a]   - shard extent along axis a (equal for every shard)
    padded[a]  - block[a] * mesh_shape[a] >= N (zero-padded global extent)
    r_last[a]  - number of *real* (non-pad) planes owned by the last shard
    """

    N: int
    mesh_shape: Tuple[int, int, int]

    def __post_init__(self):
        for m, name in zip(self.mesh_shape, AXIS_NAMES):
            if m < 1:
                raise ValueError(f"mesh dim {name} must be >= 1, got {m}")
            b = -(-self.N // m)  # ceil
            if self.N - (m - 1) * b < 1:
                raise ValueError(
                    f"mesh dim {name}={m} too large for N={self.N}: "
                    f"last shard would own no real planes"
                )

    @property
    def block(self) -> Tuple[int, int, int]:
        return tuple(-(-self.N // m) for m in self.mesh_shape)

    @property
    def padded(self) -> Tuple[int, int, int]:
        return tuple(b * m for b, m in zip(self.block, self.mesh_shape))

    @property
    def r_last(self) -> Tuple[int, int, int]:
        return tuple(
            self.N - (m - 1) * b for b, m in zip(self.block, self.mesh_shape)
        )

    @property
    def n_devices(self) -> int:
        mx, my, mz = self.mesh_shape
        return mx * my * mz


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (MX, MY, MZ) mesh: `devices[i]` holds the shard at `coords[i]`,
    in mesh order (x slowest, z fastest).  `ranks[i]` is the process that
    holds shard i and `rank` this process (None and 0 in a single
    process, where every shard is local)."""

    shape: Tuple[int, int, int]
    devices: Tuple[torch.device, ...]
    ranks: Optional[Tuple[int, ...]] = None
    rank: int = 0

    @property
    def coords(self) -> List[Tuple[int, int, int]]:
        return list(itertools.product(*(range(m) for m in self.shape)))

    @property
    def local(self) -> List[int]:
        """The indices of the shards this process holds, in mesh order."""
        return [i for i in range(len(self.devices)) if self.is_local(i)]

    def is_local(self, i: int) -> bool:
        return self.ranks is None or self.ranks[i] == self.rank

    def owner(self, i: int) -> int:
        return 0 if self.ranks is None else self.ranks[i]

    def index(self, coord) -> int:
        """The flat shard index of a coordinate, each axis taken cyclically
        (the mesh's neighbour relation is cyclic on every axis)."""
        _, my, mz = self.shape
        cx, cy, cz = (c % m for c, m in zip(coord, self.shape))
        return (cx * my + cy) * mz + cz


def build_mesh(mesh_shape: Tuple[int, int, int],
               devices: Sequence) -> Mesh:
    """The mesh of `mesh_shape` over `devices` in mesh order (the
    counterpart of `MPI_Cart_create` with periods {1,0,0},
    mpi_sol.cpp:409-410; periodicity lives in comm/halo.py's neighbour
    maps).  A device may be named more than once."""
    from wavetpu_torch.comm import dist

    mesh_shape = tuple(int(m) for m in mesh_shape)
    n = mesh_shape[0] * mesh_shape[1] * mesh_shape[2]
    if len(devices) != n:
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, got "
                         f"{len(devices)}")
    devices = tuple(torch.device(d) for d in devices)
    world = dist.current()
    if world is None:
        return Mesh(mesh_shape, devices)
    ranks = tuple(dist.shard_ranks(n, world.size))
    devices = tuple(d if r == world.rank else torch.device("meta")
                    for d, r in zip(devices, ranks))
    return Mesh(mesh_shape, devices, ranks, world.rank)


def each(fn, *lists) -> list:
    """`fn(*entries)` at every shard whose entry in the first list is
    present (the shards this process holds), None at the others."""
    return [None if args[0] is None else fn(*args) for args in zip(*lists)]


def block_slices(topo: Topology, coord) -> Tuple[slice, slice, slice]:
    """The slices of the padded global array that shard `coord` holds."""
    return tuple(slice(c * b, (c + 1) * b) for c, b in zip(coord, topo.block))


@dataclasses.dataclass
class ShardedArray:
    """A padded global (topo.padded) array held as one block per shard,
    `blocks[i]` on `mesh.devices[i]` - the port's form of wavetpu's
    P("x", "y", "z")-sharded state.  Pad cells hold zero."""

    blocks: List[Optional[torch.Tensor]]
    topo: Topology
    mesh: Mesh

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[self.mesh.local[0]].dtype

    def assemble(self, device=None) -> torch.Tensor:
        """The padded global array on `device` (default: the first
        shard's); every block must be local."""
        if any(b is None for b in self.blocks):
            raise ValueError("a mesh spread over processes has no global "
                             "array in one of them")
        device = self.blocks[0].device if device is None else device
        out = torch.empty(self.topo.padded, dtype=self.dtype, device=device)
        for coord, blk in zip(self.mesh.coords, self.blocks):
            out[block_slices(self.topo, coord)] = blk.to(device)
        return out

    def fundamental(self, device=None) -> torch.Tensor:
        """The (N, N, N) fundamental domain, padding stripped."""
        n = self.topo.N
        return self.assemble(device)[:n, :n, :n].contiguous()


def split_global(a: torch.Tensor, topo: Topology, mesh: Mesh,
                 dtype: Optional[torch.dtype] = None) -> ShardedArray:
    """Cut a padded global (topo.padded) tensor into the mesh's blocks, each
    a contiguous copy on its shard's device (this process's shards only;
    None at the others)."""
    if tuple(a.shape) != topo.padded:
        raise ValueError(f"expected the padded shape {topo.padded}, got "
                         f"{tuple(a.shape)}")
    dtype = a.dtype if dtype is None else dtype
    blocks = [
        a[block_slices(topo, coord)].to(device=dev, dtype=dtype,
                                        copy=True).contiguous()
        if mesh.is_local(i) else None
        for i, (coord, dev) in enumerate(zip(mesh.coords, mesh.devices))
    ]
    return ShardedArray(blocks, topo, mesh)


def pad_global(a: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Zero-pad an (N, N, N) tensor to the topology's padded shape."""
    out = torch.zeros(topo.padded, dtype=a.dtype, device=a.device)
    n = a.shape
    out[: n[0], : n[1], : n[2]] = a
    return out
