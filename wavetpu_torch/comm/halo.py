"""Halo exchange between the shards of a mesh: cyclic on all three axes
(torch port of wavetpu/comm/halo.py).

The counterpart of the reference's pack / MPI_Sendrecv / unpack layer
(mpi_sol.cpp:196-285, mpi_new.cpp:181-269).  Every function takes all of a
mesh's blocks at once (one process drives every shard, as one `shard_map`
program does): a `ppermute` becomes a copy of the sender's plane onto the
receiver's device (`send`), a real copy even where both shards live on one
device, so the same code runs across cards.

Every move of a plane from one shard to another goes through `transfer`,
which also carries a mesh spread over processes (`--distributed`,
comm/dist.py): each rank enumerates an exchange's (source shard,
destination shard, plane) moves in the same order; local -> local is the
copy above, local -> remote an `isend`, remote -> local an `irecv` into a
buffer whose shape the caller gives from the Topology (a rank never holds
a remote block), and a move with neither end local is skipped.  The
sends and receives of one exchange are one `batch_isend_irecv` and its
wait.  Planes travel as bytes (any dtype, bf16 included); with ranks
sharing a card over gloo they are staged through pinned host memory.

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

import math
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from wavetpu_torch.core.grid import Mesh, Topology
from wavetpu_torch.kernels import stencil_ref

Ghosts = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

# What the exchanges that crossed ranks cost this process: their count,
# the bytes it sent and received, and the host seconds from staging the
# first plane to unstaging the last (where ranks share a card the
# device's queued work is drained first, as the first staging copy would,
# so the seconds are the exchange's own).
cross_rank = {"exchanges": 0, "bytes": 0, "seconds": 0.0}


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


def _plane(u: Optional[torch.Tensor], axis: int,
           p: int) -> Optional[torch.Tensor]:
    return None if u is None else u.narrow(axis, p, 1)


def _wire(t: torch.Tensor, world) -> torch.Tensor:
    """A plane as the contiguous bytes a send carries: on the card NCCL
    talks through, or on the host (pinned, when staged from a card)."""
    if world.backend == "nccl":
        t = t.to(torch.device("cuda", world.cards[0]))
    elif t.device.type == "cuda":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    return t.contiguous().view(-1).view(torch.uint8)


def transfer(mesh: Mesh, moves: Sequence, streams=None) -> list:
    """Carry out one exchange's moves, each `(src, dst, plane, shape,
    dtype)` or with a sixth entry `into`: shard `src`'s `plane` (None
    unless src is local) delivered to shard `dst`'s device, `shape` and
    `dtype` the plane's (known to every rank from the Topology).  Returns,
    per move, the delivered plane where dst is local (written into `into`
    when given, else a new contiguous tensor), None elsewhere.  `streams`
    (one CUDA stream per shard) puts each local copy on its sender's and
    receiver's streams (`send`)."""
    out = [None] * len(moves)
    ops, recvs = [], []
    world = None
    nbytes_moved = 0
    for tag, move in enumerate(moves):
        src, dst, plane, shape, dtype = move[:5]
        into = move[5] if len(move) > 5 else None
        here_src, here_dst = mesh.is_local(src), mesh.is_local(dst)
        if here_src and here_dst:
            if into is None:
                out[tag] = send(plane, mesh.devices[dst],
                                None if streams is None
                                else (streams[src], streams[dst]))
            else:
                out[tag] = into.copy_(plane, non_blocking=True)
            continue
        if not (here_src or here_dst):
            continue
        if world is None:
            from wavetpu_torch.comm import dist

            world = dist.current()
            if world.staged:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        nbytes = math.prod(shape) * dtype.itemsize
        nbytes_moved += nbytes
        if here_src:
            ops.append(tdist.P2POp(tdist.isend, _wire(plane, world),
                                   mesh.owner(dst), tag=tag))
            continue
        wire_dev = (torch.device("cuda", world.cards[0])
                    if world.backend == "nccl" else torch.device("cpu"))
        buf = torch.empty(nbytes, dtype=torch.uint8, device=wire_dev,
                          pin_memory=world.staged)
        ops.append(tdist.P2POp(tdist.irecv, buf, mesh.owner(src), tag=tag))
        recvs.append((tag, buf, tuple(shape), dtype, mesh.devices[dst],
                      into))
    if ops:
        for work in tdist.batch_isend_irecv(ops):
            work.wait()
    for tag, buf, shape, dtype, dev, into in recvs:
        plane = buf.view(dtype).view(shape)
        if into is None:
            out[tag] = plane.to(dev, non_blocking=True).contiguous()
        else:
            out[tag] = into.copy_(plane, non_blocking=True)
    if world is not None:
        cross_rank["exchanges"] += 1
        cross_rank["bytes"] += nbytes_moved
        cross_rank["seconds"] += time.perf_counter() - t0
    return out


def _face_shape(block_shape, axis: int):
    shape = list(block_shape)
    shape[axis] = 1
    return tuple(shape)


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
    ref = blocks[mesh.local[0]]
    ghosts = [[None] * 3 if mesh.is_local(i) else None
              for i in range(len(blocks))]
    moves, slots = [], []
    for i, coord in enumerate(mesh.coords):
        for axis in range(3):
            m, b = topo.mesh_shape[axis], topo.block[axis]
            u = blocks[i]
            if m == 1:
                if u is not None:
                    ghosts[i][axis] = (_plane(u, axis + lead, b - 1),
                                       _plane(u, axis + lead, 0))
                continue
            lo_c = list(coord)
            lo_c[axis] -= 1
            hi_c = list(coord)
            hi_c[axis] += 1
            lo_i, hi_i = mesh.index(lo_c), mesh.index(hi_c)
            # Forward: the lower neighbour's last real plane.
            last = (coord[axis] - 1) % m == m - 1
            p = topo.r_last[axis] - 1 if last else b - 1
            shape = _face_shape(ref.shape, axis + lead)
            moves.append((lo_i, i, _plane(blocks[lo_i], axis + lead, p),
                          shape, ref.dtype))
            # Backward: the upper neighbour's first plane.
            moves.append((hi_i, i, _plane(blocks[hi_i], axis + lead, 0),
                          shape, ref.dtype))
            slots.append((i, axis))
    got = transfer(mesh, moves, streams)
    for n, (i, axis) in enumerate(slots):
        if ghosts[i] is not None:
            ghosts[i][axis] = (got[2 * n], got[2 * n + 1])
    return [None if g is None else tuple(g) for g in ghosts]


def extend_y(blocks: Sequence[torch.Tensor], mesh: Mesh,
             depth: int) -> List[torch.Tensor]:
    """Every shard's block extended with `depth` cyclic ghost rows per y
    side (wavetpu sharded_kfused.extend_y, one y ppermute pair): a new
    (bx, by + 2*depth, bz) tensor on the shard's device holding the last
    `depth` rows of the lower y neighbour, the block, and the first `depth`
    rows of the upper one, each piece copied in place (a send into the
    receiver's buffer).  The y axis must divide evenly (no pad rows) and
    depth <= by, so the strip comes from one neighbour."""
    ref = blocks[mesh.local[0]]
    bx, by, bz = ref.shape
    strip = (bx, depth, bz)
    out = [None] * len(blocks)
    moves = []
    for i, coord in enumerate(mesh.coords):
        lo_c, hi_c = list(coord), list(coord)
        lo_c[1] -= 1
        hi_c[1] += 1
        lo_i, hi_i = mesh.index(lo_c), mesh.index(hi_c)
        lo, hi = blocks[lo_i], blocks[hi_i]
        ext = None
        if mesh.is_local(i):
            ext = torch.empty((bx, by + 2 * depth, bz), dtype=ref.dtype,
                              device=mesh.devices[i])
            out[i] = ext
        moves.append((lo_i, i, None if lo is None else lo[:, by - depth:],
                      strip, ref.dtype,
                      None if ext is None else ext[:, :depth]))
        moves.append((i, i, blocks[i], (bx, by, bz), ref.dtype,
                      None if ext is None else ext[:, depth:depth + by]))
        moves.append((hi_i, i, None if hi is None else hi[:, :depth],
                      strip, ref.dtype,
                      None if ext is None else ext[:, depth + by:]))
    transfer(mesh, moves)
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
        if out[i] is None:
            continue
        for axis in range(3):
            b, r = topo.block[axis], topo.r_last[axis]
            if r == b or not _is_last(topo, coord, axis):
                continue
            if out[i] is blocks[i]:
                out[i] = blocks[i].clone()
            _plane(out[i], axis + int(lanes), r).copy_(ghosts[i][axis][1])
    return out
