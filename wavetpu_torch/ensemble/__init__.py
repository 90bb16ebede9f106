"""Ensemble-batched solves: many independent problems as one batched march
(torch port of wavetpu/ensemble).

`batched.py` writes the lane axis out over the step families of both
schemes, the flagship compensated velocity form included: a batch of B
lanes is one launch of a kernel's lane mode per layer or k-block, each
lane bitwise its solo solve.  `sharded.py` composes the lane axis with the
device mesh, so a batch of sharded solves runs as one march.  The serve
layer (ROADMAP.md queue 1 item 12) sits on top.
"""

from wavetpu_torch.ensemble.batched import (
    EnsembleResult,
    EnsembleSolver,
    LaneSpec,
    probe_results,
    solve_ensemble,
    vmap_capability,
)
from wavetpu_torch.ensemble.sharded import (
    ShardedEnsembleSolver,
    solve_ensemble_sharded,
)

__all__ = [
    "EnsembleResult",
    "EnsembleSolver",
    "LaneSpec",
    "ShardedEnsembleSolver",
    "probe_results",
    "solve_ensemble",
    "solve_ensemble_sharded",
    "vmap_capability",
]
