"""The layers under `--distributed` (comm/dist.py, comm/halo.transfer) on
the CPU, in worker processes over gloo: a distributed `collect_ghosts` and
`sharded_kfused.exchange` give every rank, for its own shards, the planes
the in-process call gives (even and uneven N); a NaN planted in one rank's
error vector comes out NaN in every rank's reduced vector, as `_reduce`
gives it in one process; and the shard ownership and the backend choice
of `comm/dist.py`.  The worker's processes share the launcher of
tests/test_torch_distributed.py, each `communicate()` with its timeout.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_distributed import (
    _communicate, _env, _free_port, same_bits,
)
from wavetpu_torch.comm import dist, halo
from wavetpu_torch.core import grid
from wavetpu_torch.solver import sharded, sharded_kfused

# A worker: joins the group, runs one of the checks below on its rank's
# blocks and saves what it got (per shard) to OUT/rank{r}.npz.
WORKER = r"""
import sys
import numpy as np
import torch
from wavetpu_torch.comm import dist, halo
from wavetpu_torch.core import grid
from wavetpu_torch.solver import sharded, sharded_kfused

case, n, mx, my, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4]), sys.argv[5]
world = dist.init("cpu", mx * my)
topo = grid.Topology(N=n, mesh_shape=(mx, my, 1))
mesh = grid.build_mesh((mx, my, 1), ["cpu"] * (mx * my))
a = torch.from_numpy(np.random.default_rng(7).standard_normal(topo.padded))
blocks = grid.split_global(a.float(), topo, mesh).blocks
saved = {}
if case == "ghosts":
    for i, g in enumerate(halo.collect_ghosts(blocks, topo, mesh)):
        if g is not None:
            for axis, (lo, hi) in enumerate(g):
                saved[f"{i}_{axis}_lo"] = lo.numpy()
                saved[f"{i}_{axis}_hi"] = hi.numpy()
elif case == "exchange":
    ext, wins = sharded_kfused.exchange(blocks, mesh, 2)
    for i, (e, w) in enumerate(zip(ext, wins)):
        if e is not None:
            saved[f"{i}_block"] = e.numpy()
            saved[f"{i}_lo"], saved[f"{i}_hi"] = w[0].numpy(), w[1].numpy()
elif case == "nan":
    vecs = [torch.arange(6, dtype=torch.float32) + i
            if mesh.is_local(i) else None for i in range(mx * my)]
    if mesh.is_local(1):
        vecs[1][3] = float("nan")
    saved["reduced"] = sharded._reduce(vecs, mesh)
np.savez(f"{out}/rank{world.rank}.npz", **saved)
dist.shutdown()
"""


def run_worker(tmp_path, case, n, mx, my):
    """Run WORKER's `case` on mx * my ranks; returns every rank's saved
    arrays, merged."""
    world, port = mx * my, _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, case, str(n), str(mx), str(my),
         str(tmp_path)],
        env=_env(r, world, port), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    rcs, outs = _communicate(procs)
    assert rcs == [0] * world, outs
    got = {}
    for r in range(world):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            got[r] = {key: z[key] for key in z.files}
    return got


def _in_process(n, mx, my):
    topo = grid.Topology(N=n, mesh_shape=(mx, my, 1))
    mesh = grid.build_mesh((mx, my, 1), ["cpu"] * (mx * my))
    a = torch.from_numpy(
        np.random.default_rng(7).standard_normal(topo.padded))
    return topo, mesh, grid.split_global(a.float(), topo, mesh).blocks


@pytest.mark.parametrize("n,mx,my", [(16, 2, 2), (15, 2, 1)],
                         ids=["even-221", "uneven-211"])
def test_distributed_ghosts_equal_in_process(tmp_path, n, mx, my):
    """`halo.collect_ghosts` across ranks gives every rank, for its own
    shards, the planes the in-process call gives."""
    got = run_worker(tmp_path, "ghosts", n, mx, my)
    topo, mesh, blocks = _in_process(n, mx, my)
    want = halo.collect_ghosts(blocks, topo, mesh)
    for i, g in enumerate(want):
        mine = got[i]  # one shard per rank
        for axis, (lo, hi) in enumerate(g):
            assert np.array_equal(mine[f"{i}_{axis}_lo"], lo.numpy())
            assert np.array_equal(mine[f"{i}_{axis}_hi"], hi.numpy())


@pytest.mark.parametrize("n,mx,my", [(16, 2, 2), (13, 2, 1)],
                         ids=["even-221", "uneven-211"])
def test_distributed_exchange_equal_in_process(tmp_path, n, mx, my):
    """`sharded_kfused.exchange` (the y extension and the x windows)
    across ranks gives every rank the in-process blocks and windows."""
    got = run_worker(tmp_path, "exchange", n, mx, my)
    _, mesh, blocks = _in_process(n, mx, my)
    ext, wins = sharded_kfused.exchange(blocks, mesh, 2)
    for i, (e, (lo, hi)) in enumerate(zip(ext, wins)):
        mine = got[i]
        assert np.array_equal(mine[f"{i}_block"], e.numpy())
        assert np.array_equal(mine[f"{i}_lo"], lo.numpy())
        assert np.array_equal(mine[f"{i}_hi"], hi.numpy())


def test_planted_nan_layer_survives_the_gather(tmp_path):
    """A NaN in one rank's error vector comes out NaN in every rank's
    reduced vector, as `_reduce` gives it in one process."""
    got = run_worker(tmp_path, "nan", 8, 2, 2)
    _, mesh, _ = _in_process(8, 2, 2)
    vecs = [torch.arange(6, dtype=torch.float32) + i for i in range(4)]
    vecs[1][3] = float("nan")
    want = sharded._reduce(vecs, mesh)
    assert np.isnan(want[3])
    for r in range(4):
        same_bits(got[r]["reduced"], want)


@pytest.mark.parametrize("world,shards,expect", [
    (2, 2, [0, 1]), (2, 4, [0, 0, 1, 1]), (4, 4, [0, 1, 2, 3]),
])
def test_shard_ranks_are_process_major(world, shards, expect):
    assert dist.shard_ranks(shards, world) == expect


@pytest.mark.parametrize("local,local_size,per,cards,expect", [
    (1, 2, 1, 2, ("nccl", (1,), False)),
    (1, 2, 2, 2, ("nccl", (1, 1), False)),
    (1, 2, 2, 4, ("nccl", (2, 3), False)),
    (1, 2, 1, 1, ("gloo", (0,), True)),
    (0, 1, 2, 1, ("nccl", (0, 0), False)),
], ids=["card-per-rank", "shards-share-rank-card", "card-per-shard",
        "shared-card-staged", "one-rank"])
def test_backend_follows_placement(local, local_size, per, cards, expect):
    assert dist.placement("gpu", local, local_size, per, cards) == expect
    assert dist.placement("cpu", local, local_size, per, cards) == (
        "gloo", (), False)
