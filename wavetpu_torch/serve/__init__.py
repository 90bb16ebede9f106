"""Inference-style serving layer over the ensemble engine (the port of
wavetpu/serve).

`engine.py` caches the batched solvers (LRU, keyed by the full program
identity incl. the batch-size bucket) and applies the per-lane
numerical-health watchdog; `scheduler.py` coalesces concurrent requests
into batches (shape bucketing + max-batch/max-wait dynamic batching);
`api.py` is the stdlib-HTTP JSON front end (`python -m wavetpu_torch
serve` / `wavetpu-torch-serve`).  wavetpu's docs/serving.md sets the
endpoint contract.
"""

from wavetpu_torch.progkey import ProgramKey
from wavetpu_torch.serve.engine import ServeEngine
from wavetpu_torch.serve.scheduler import (
    DynamicBatcher,
    QueueFullError,
    ServeMetrics,
    SolveRequest,
)

__all__ = [
    "DynamicBatcher",
    "ProgramKey",
    "QueueFullError",
    "ServeEngine",
    "ServeMetrics",
    "SolveRequest",
]
