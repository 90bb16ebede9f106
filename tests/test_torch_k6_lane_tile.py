"""K6's lane-mode tiling (`stencil_cuda.k6_lane_tile`), on the CPU.

The x-streaming kernel (csrc/sharded.cu `sharded_lanes_kernel`) gives one
block to each (z tile, y tile, x segment, lane) of a one-dimensional grid.
Held here, where no kernel runs: the segments cover every x plane of the
block exactly once, the tiles every (y, z) column, the grid stays within
its 2^31 - 1 blocks for B up to 64 at bx 256-512 (the old lane body's grid
capped lanes x bx at 65535), and a block no dimension of which is a
multiple of the tile is tiled all the same.  On the CPU the wrapper takes
the plain version whatever the tile.
"""

import numpy as np
import pytest
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda

BLOCKS = [(256, 256, 512), (128, 128, 256), (65, 65, 130), (9, 6, 5),
          (4, 15, 15), (1, 1, 1), (512, 512, 512), (17, 3, 33)]


def covered(extent, step):
    """How often each index of range(extent) falls in the pieces
    [i * step, min((i + 1) * step, extent)), i < ceil(extent / step)."""
    hits = np.zeros(extent, int)
    for i in range(-(-extent // step)):
        piece = range(i * step, min((i + 1) * step, extent))
        assert len(piece) > 0
        hits[piece.start:piece.stop] += 1
    return hits


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("lanes", [1, 3, 8, 64])
def test_tile_covers_every_plane_and_column_once(block, lanes):
    seg, ty, tz = stencil_cuda.k6_lane_tile(block, lanes)
    bx, by, bz = block
    assert tz == 32 and ty in (4, 8) and 1 <= seg <= bx
    for extent, step in ((bx, seg), (by, ty), (bz, tz)):
        assert (covered(extent, step) == 1).all()
    # Segments are no shorter than the floor unless the block is.
    assert seg >= min(bx, stencil_cuda._K6L_MIN_SEG)


@pytest.mark.parametrize("bx", [256, 320, 384, 512])
@pytest.mark.parametrize("lanes", [1, 8, 32, 64])
def test_grid_within_limits(bx, lanes):
    """A mesh-2,2,1 block of N = 2 bx at up to 64 lanes: one launch, a grid
    of at least ~4096 blocks (or one per plane) and at most 2^31 - 1."""
    block = (bx, bx, 2 * bx)
    tile = stencil_cuda.k6_lane_tile(block, lanes)
    blocks = stencil_cuda.k6_lane_grid(block, lanes, tile)
    assert blocks <= stencil_cuda._GRID_X_MAX
    cols = -(-block[2] // 32) * -(-block[1] // tile[1]) * lanes
    assert blocks >= min(stencil_cuda._K6L_BLOCKS, cols * bx // 16)


def test_block_without_tile_multiples():
    """N=130 on mesh 2,2,1: a 65 x 65 x 130 block, B=8 - no dimension is a
    multiple of its tile's, and the last segment is the short one."""
    block = (65, 65, 130)
    seg, ty, tz = stencil_cuda.k6_lane_tile(block, 8)
    assert all(e % s for e, s in zip(block, (seg, ty, tz)))
    assert (covered(65, seg) == 1).all()


def test_tile_refuses_an_empty_block():
    with pytest.raises(ValueError, match="K6 lanes"):
        stencil_cuda.k6_lane_tile((0, 8, 8), 2)
    with pytest.raises(ValueError, match="K6 lanes"):
        stencil_cuda.k6_lane_tile((8, 8, 8), 0)


@pytest.mark.parametrize("tile", [None, (3, 8, 32), (1, 4, 32)])
def test_cpu_lanes_take_the_plain_version(tile):
    """On the CPU the lane wrapper is its plain version, tile or not, and
    counts no launch."""
    p = Problem(N=12, timesteps=10)
    g = torch.Generator().manual_seed(4)
    shape = (2, 6, 6, 12)
    up, u = (torch.randn(shape, generator=g) for _ in range(2))
    ghosts = []
    for axis in range(3):
        face = list(shape)
        face[axis + 1] = 1
        ghosts.append(tuple(torch.randn(face, generator=g) for _ in range(2)))
    kw = dict(inv_h2=p.inv_h2, mesh_shape=(2, 2, 1), coeff=p.a2tau2)
    before = dict(stencil_cuda.launches)
    got = stencil_cuda.sharded_fused_step_lanes(up, u, ghosts, (6, 6, 0), 12,
                                                tile=tile, **kw)
    assert stencil_cuda.launches == before
    assert torch.equal(got, stencil_cuda.sharded_fused_step_lanes_plain(
        up, u, ghosts, (6, 6, 0), 12, **kw))


@pytest.mark.parametrize("block,streams", [
    ((256, 256, 512), True),    # the mesh-2,2,1 shard of N=512
    ((512, 512, 512), True),    # mesh 1,1,1
    ((1, 256, 512), False),     # the overlap mode's x face block
    ((256, 1, 512), False),     # its y face block
    ((16, 256, 512), False), ((32, 256, 512), True),
    ((256, 16, 512), False), ((256, 32, 512), True),
    ((31, 32, 64), False), ((32, 32, 64), True), ((32, 31, 64), False),
])
def test_solo_takes_the_streaming_kernel_on_thick_blocks(block, streams):
    """The solo K6 at constant speed streams on blocks of at least 32
    planes and 32 rows; thinner blocks keep the one-thread-per-cell body."""
    assert stencil_cuda.k6_solo_streams(block) is streams
