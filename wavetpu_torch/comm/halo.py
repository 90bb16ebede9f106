"""Halo exchange between the shards of a mesh: cyclic on all three axes
(torch port of wavetpu/comm/halo.py).

The counterpart of the reference's pack / MPI_Sendrecv / unpack layer
(mpi_sol.cpp:196-285, mpi_new.cpp:181-269).  Every function takes all of a
mesh's blocks at once (one process drives every shard, as one `shard_map`
program does): a `ppermute` becomes a copy of the sender's plane onto the
receiver's device (`send`), a real copy even where both shards live on one
device, so the same code runs across cards.

Why cyclic on every axis: the fundamental-domain state makes the global
neighbour relation a cyclic shift on all three axes - x because the domain
is periodic, y/z because the wrap delivers the stored zero Dirichlet plane
(see wavetpu_torch.core.problem).

Uneven-grid seam arithmetic (core/grid.py pads each axis to block * mesh
dim; the last shard owns r_last real planes):

 * the forward send ships the last *real* plane (r_last - 1, not block - 1);
 * the hi ghost of the last shard belongs right after its last real plane:
   at ext position r_last + 1 (`place_ghosts`), or inside the block at
   plane r_last (`absorb_hi_ghosts`, what the sharded kernels read).

A mesh dim of 1 takes the local wrap with no copy (the block's own planes).

A batch of lanes (the sharded ensemble: every block (B, bx, by, bz), lane
first) passes `lanes=True`: each ghost is then (B, face), one copy per face
for every lane.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from wavetpu_torch.core.grid import Mesh, Topology
from wavetpu_torch.kernels import stencil_ref

Ghosts = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


def send(t: torch.Tensor, device: torch.device,
         streams: Optional[Tuple[torch.cuda.Stream, torch.cuda.Stream]] = None
         ) -> torch.Tensor:
    """`t` copied onto `device` as a new contiguous tensor (a ppermute's
    delivery): always a copy, never a view of the sender's block.

    `streams`, the (sender's, receiver's) pair of CUDA streams, puts the
    copy on them instead of the two cards' current streams.  A copy
    between cards runs on the sender's current stream behind a two-way
    barrier with the receiver's current stream, so with both streams
    made current here the copy is queued on the sender's stream, after
    the receiver's stream has caught up, and the receiver's stream waits
    for it; the result is allocated on the receiver's stream, and the
    sender's plane is marked in use by the sender's stream."""
    if streams is not None:
        with torch.cuda.stream(streams[0]), torch.cuda.stream(streams[1]):
            out = send(t, device)
        t.record_stream(streams[0])
        return out
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t, non_blocking=True)
    return out


def _plane(u: torch.Tensor, axis: int, p: int) -> torch.Tensor:
    return u.narrow(axis, p, 1)


def collect_ghosts(blocks: Sequence[torch.Tensor], topo: Topology,
                   mesh: Mesh,
                   streams: Optional[Sequence[torch.cuda.Stream]] = None,
                   lanes: bool = False) -> List[Ghosts]:
    """Exchange the 6 face ghost planes of every shard; no placement.

    Returns, per shard in mesh order, ((xlo, xhi), (ylo, yhi), (zlo, zhi)):
    `lo` is the -1 neighbour of the shard's plane 0 along that axis, `hi`
    the +1 neighbour of its last *real* plane.  On a mesh dim of 1 they are
    views of the block's own wrap planes (no pad exists there); otherwise
    copies received from the cyclic neighbour shard.  `streams` (one
    CUDA stream per shard, in mesh order) puts each copy on its sender's
    and receiver's streams (`send`).  `lanes`: every block is a (B,) +
    block batch, and each ghost the (B, face) planes of all its lanes.
    """
    lead = int(lanes)
    out = []
    for i, coord in enumerate(mesh.coords):
        dst = mesh.devices[i]
        ghosts = []
        for axis in range(3):
            m, b = topo.mesh_shape[axis], topo.block[axis]
            u = blocks[i]
            if m == 1:
                ghosts.append((_plane(u, axis + lead, b - 1),
                               _plane(u, axis + lead, 0)))
                continue
            lo_c = list(coord)
            lo_c[axis] -= 1
            hi_c = list(coord)
            hi_c[axis] += 1
            lo_i, hi_i = mesh.index(lo_c), mesh.index(hi_c)
            # Forward: the lower neighbour's last real plane.
            last = (coord[axis] - 1) % m == m - 1
            p = topo.r_last[axis] - 1 if last else b - 1
            ghost_lo = send(_plane(blocks[lo_i], axis + lead, p), dst,
                            None if streams is None
                            else (streams[lo_i], streams[i]))
            # Backward: the upper neighbour's first plane.
            ghost_hi = send(_plane(blocks[hi_i], axis + lead, 0), dst,
                            None if streams is None
                            else (streams[hi_i], streams[i]))
            ghosts.append((ghost_lo, ghost_hi))
        out.append(tuple(ghosts))
    return out


def extend_y(blocks: Sequence[torch.Tensor], mesh: Mesh,
             depth: int) -> List[torch.Tensor]:
    """Every shard's block extended with `depth` cyclic ghost rows per y
    side (wavetpu sharded_kfused.extend_y, one y ppermute pair): a new
    (bx, by + 2*depth, bz) tensor on the shard's device holding the last
    `depth` rows of the lower y neighbour, the block, and the first `depth`
    rows of the upper one, each piece copied in place (a send into the
    receiver's buffer).  The y axis must divide evenly (no pad rows) and
    depth <= by, so the strip comes from one neighbour."""
    out = []
    for i, coord in enumerate(mesh.coords):
        blk = blocks[i]
        bx, by, bz = blk.shape
        lo_c, hi_c = list(coord), list(coord)
        lo_c[1] -= 1
        hi_c[1] += 1
        lo, hi = blocks[mesh.index(lo_c)], blocks[mesh.index(hi_c)]
        ext = torch.empty((bx, by + 2 * depth, bz), dtype=blk.dtype,
                          device=mesh.devices[i])
        ext[:, :depth].copy_(lo[:, by - depth:], non_blocking=True)
        ext[:, depth:depth + by].copy_(blk, non_blocking=True)
        ext[:, depth + by:].copy_(hi[:, :depth], non_blocking=True)
        out.append(ext)
    return out


def _is_last(topo: Topology, coord, axis: int) -> bool:
    return coord[axis] == topo.mesh_shape[axis] - 1


def place_ghosts(u: torch.Tensor, ghosts: Ghosts, topo: Topology,
                 coord) -> torch.Tensor:
    """The (bx+2, by+2, bz+2) extension of one shard's block from its
    pre-exchanged ghosts: lo at position 0, hi after the last real plane
    (r_last + 1 on the last shard of an uneven axis, block + 1 elsewhere);
    cells past it stay zero.  `stencil_ref.laplacian_ext` consumes it."""
    hi_at = tuple(
        topo.r_last[a] if _is_last(topo, coord, a) else topo.block[a]
        for a in range(3)
    )
    return stencil_ref.ghost_extend(u, ghosts, hi_at)


def absorb_hi_ghosts(blocks: Sequence[torch.Tensor],
                     ghosts: Sequence[Ghosts], topo: Topology,
                     mesh: Mesh, lanes: bool = False) -> List[torch.Tensor]:
    """Every shard's block with, on the last shard of each unevenly sharded
    axis, the `hi` ghost written into its first pad plane (plane r_last).

    The sharded kernels read the +1 neighbour of local plane p from plane
    p+1 of their block, so there the ghost must live inside the block, the
    in-block counterpart of `place_ghosts`' position r_last + 1.  Such a
    block is a copy (the state itself keeps its zero pad: the previous
    layer is read at its pad cells only by masked outputs); every other
    block is returned as it is.  Even axes are untouched (their hi ghost
    rides the kernel's ghost operand).  `lanes` as `collect_ghosts`."""
    out = list(blocks)
    for i, coord in enumerate(mesh.coords):
        for axis in range(3):
            b, r = topo.block[axis], topo.r_last[axis]
            if r == b or not _is_last(topo, coord, axis):
                continue
            if out[i] is blocks[i]:
                out[i] = blocks[i].clone()
            _plane(out[i], axis + int(lanes), r).copy_(ghosts[i][axis][1])
    return out
