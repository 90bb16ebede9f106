"""The process group of `--distributed` (the port's counterpart of the
`jax.distributed.initialize()` block of wavetpu/cli.py:527-565).

One OS process per rank, launched by `torchrun` or by anything that sets
torch's `env://` variables: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and
LOCAL_RANK (LOCAL_WORLD_SIZE, when set, is the ranks on this node;
otherwise the whole world is taken to share the node).  There is no
cluster auto-detection: a missing variable is a usage error that names
it.

The backend follows from the placement, never from a failure:

 * NCCL where every rank of the node has a card of its own;
 * gloo on the CPU (`--platform cpu`);
 * gloo where ranks share a card (more ranks on the node than cards).
   NCCL refuses two ranks on one GPU and gloo moves only host memory, so
   there every plane that crosses ranks is staged through pinned host
   memory: device -> host, gloo, host -> device (`World.staged`).

An NCCL init or send that fails raises; nothing carries on over gloo or
on the CPU.  `init` makes the world current for the process - core/
grid.py's `build_mesh` then assigns each shard its rank - and
`shutdown` tears the group down (the CLI calls it on every exit path).

`gather_shards` and `max_across` are the reductions: per-rank values are
gathered whole (`all_gather`) and reduced by the caller's own code, so
NaN keeps the meaning it has in one process (an `all_reduce(MAX)`'s NaN
handling depends on the backend).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
# How long a rank waits in a collective or a receive for its peers
# before it raises instead of hanging.
TIMEOUT_S = 600


class MissingEnv(ValueError):
    """An `env://` variable `--distributed` needs is not set."""


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the group.

    `cards`: the CUDA device indices this rank's shards sit on (empty on
    the CPU); `staged`: crossing planes go through pinned host memory
    (gloo with the shards on a card)."""

    rank: int
    size: int
    local_rank: int
    backend: str
    cards: tuple
    staged: bool

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def describe(self) -> str:
        how = {("nccl", False): "nccl", ("gloo", False): "gloo",
               ("gloo", True): "gloo, host-staged"}[(self.backend,
                                                     self.staged)]
        cards = (", cards " + ",".join(str(c) for c in self.cards)
                 if self.cards else "")
        return f"{how}, {self.size} rank(s){cards}"


_WORLD: Optional[World] = None


def current() -> Optional[World]:
    """The world `init` set up, or None without a process group."""
    return _WORLD


def env_config(environ=None):
    """(rank, world size, local rank, local world size) from torch's
    `env://` variables.  Raises MissingEnv naming the first missing one,
    ValueError for a value that is not a valid number."""
    environ = os.environ if environ is None else environ
    for name in ENV_VARS:
        if not environ.get(name):
            raise MissingEnv(
                f"--distributed needs the env:// variable {name} (set "
                f"{', '.join(ENV_VARS)}, as torchrun does)")
    size = int(environ["WORLD_SIZE"])
    rank = int(environ["RANK"])
    local = int(environ["LOCAL_RANK"])
    local_size = int(environ.get("LOCAL_WORLD_SIZE") or size)
    if size < 1 or not 0 <= rank < size or not 0 <= local < local_size:
        raise ValueError(
            f"--distributed: RANK={rank}, LOCAL_RANK={local} do not fit "
            f"WORLD_SIZE={size}, LOCAL_WORLD_SIZE={local_size}")
    return rank, size, local, local_size


def placement(platform: str, local_rank: int, local_size: int,
              shards_per_rank: int, n_cards: int):
    """(backend, cards, staged) of a rank: on the CPU gloo; on the GPU
    NCCL with one card per shard where the node has local_size *
    shards_per_rank cards, NCCL with one card per rank (its shards share
    it) where it has local_size, else gloo with every shard on card 0,
    host-staged."""
    if platform == "cpu":
        return "gloo", (), False
    if n_cards >= local_size * shards_per_rank:
        first = local_rank * shards_per_rank
        return "nccl", tuple(range(first, first + shards_per_rank)), False
    if n_cards >= local_size:
        return "nccl", (local_rank,) * shards_per_rank, False
    return "gloo", (0,) * shards_per_rank, True


def shard_ranks(n_shards: int, world_size: int) -> List[int]:
    """The owner of every shard in mesh order: shard i belongs to rank
    i // (S / W), process-major as `jax.devices()` orders them.  Raises
    ValueError when the world size does not divide the shard count."""
    if n_shards % world_size:
        raise ValueError(
            f"--distributed over {world_size} ranks needs a mesh whose "
            f"shard count they divide; the mesh has {n_shards} shard(s)")
    per = n_shards // world_size
    return [i // per for i in range(n_shards)]


def init(platform: str, n_shards: int) -> World:
    """Join the process group and make it current: the placement of this
    rank's shards decides the backend (`placement`).  Raises MissingEnv /
    ValueError for a usage error (before any connection is made)."""
    global _WORLD
    import torch
    import torch.distributed as dist

    rank, size, local, local_size = env_config()
    per = n_shards // size
    shard_ranks(n_shards, size)
    n_cards = torch.cuda.device_count() if platform == "gpu" else 0
    backend, cards, staged = placement(platform, local, local_size, per,
                                       n_cards)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(cards[0])
        kw["device_id"] = torch.device("cuda", cards[0])
    dist.init_process_group(
        backend, init_method="env://", world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    _WORLD = World(rank, size, local, backend, cards, staged)
    # Every rank has joined before the first exchange.
    dist.barrier()
    return _WORLD


def shutdown() -> None:
    """Leave the process group (every exit path of a distributed run)."""
    global _WORLD
    if _WORLD is None:
        return
    _WORLD = None
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if _WORLD is not None:
        import torch.distributed as dist

        dist.barrier()


def _comm_device(world: World):
    import torch

    return (torch.device("cuda", world.cards[0]) if world.backend == "nccl"
            else torch.device("cpu"))


def gather_shards(mesh, per_shard: Sequence) -> list:
    """Every shard's tensor, in mesh order, from the ranks that hold them:
    `per_shard` has this rank's tensors at its own shards (None
    elsewhere, all of one shape and dtype); the result has them all, on
    the CPU.  In a single process it is `per_shard` itself."""
    if mesh.ranks is None:
        return list(per_shard)
    import torch
    import torch.distributed as dist

    world = _WORLD
    mine = torch.stack([per_shard[i].detach() for i in mesh.local])
    mine = mine.to(_comm_device(world)).contiguous()
    parts = [torch.empty_like(mine) for _ in range(world.size)]
    dist.all_gather(parts, mine)
    out = []
    for part in parts:
        out.extend(part.cpu().unbind(0))
    return out


def max_across(value: float) -> float:
    """The largest of every rank's `value` (a host float; NaN wins, as in
    Python's own comparison chain here: any NaN gives NaN)."""
    if _WORLD is None:
        return value
    import torch
    import torch.distributed as dist

    mine = torch.tensor([value], dtype=torch.float64,
                        device=_comm_device(_WORLD))
    parts = [torch.empty_like(mine) for _ in range(_WORLD.size)]
    dist.all_gather(parts, mine)
    vals = [float(p.item()) for p in parts]
    if any(v != v for v in vals):
        return float("nan")
    return max(vals)


def any_across(flag: bool) -> bool:
    """True when any rank's `flag` is (a preemption signal seen by one
    rank stops them all at the same chunk boundary)."""
    return bool(max_across(1.0 if flag else 0.0))
