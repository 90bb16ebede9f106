"""Numerical-health watchdog: one non-finite/amplitude reduction per state
array (the port of wavetpu/run/health.py).

A NaN or Inf born inside the march reaches the final layer unless
something looks; an amplitude blowup (e.g. a Courant-unstable config) is
worse - every value stays finite for many layers while the "solution"
grows exponentially, and the run ends with a garbage error norm that LOOKS
like a result.  The supervisor (run/supervisor.py) checks each chunk
boundary with the guard below and halts - or retries - with the last-good
step and checkpoint; the CLI's `--debug-nans` runs the same guard after
every launch of an unsupervised march.

The guard, per state array (a tensor or a ShardedArray, whose blocks are
reduced on their devices and the maxima taken on the host; a process of a
`--distributed` run sees its own blocks, and the supervisor reduces the
reading across ranks):

    amax* = max(where(isfinite(|u|), |u|, +inf))    in f32

so NaN/Inf anywhere collapses to +inf and ONE scalar crosses to the host
per array (per block).  wavetpu's guard is a jitted jnp reduction, not a
Pallas kernel; here it is plain PyTorch on the array's device.
`healthy(amax, bound)` is then a plain float comparison (NaN-safe:
`NaN <= bound` is False).  The analytic solution is a product of sines
(|u| <= 1) and any physical variable-c field keeps the amplitude O(1), so
the default bound of 1e3 only ever trips on genuine blowups while staying
scheme-agnostic.
"""

from __future__ import annotations

from typing import Iterable, Optional

DEFAULT_AMP_BOUND = 1e3


def _guarded_abs(t):
    """|t| in f32 with every non-finite value +inf."""
    import torch

    x = t.abs().to(torch.float32)
    return torch.where(torch.isfinite(x), x, torch.full_like(x, float("inf")))


def _device_amax(t):
    return _guarded_abs(t).amax()


def guarded_amax(array) -> float:
    """max |array| with every non-finite value counted as +inf (host
    float): one reduction on the array's device per tensor or block, one
    scalar to the host each."""
    blocks = getattr(array, "blocks", None)
    if blocks is None:
        return float(_device_amax(array).item())
    return max(float(_device_amax(b).item()) for b in blocks
               if b is not None)


def guarded_amax_per_lane(array):
    """Per-lane guarded amax over a leading batch axis (B, ...): one
    reduction on the batch's device, B scalars to the host as a numpy (B,)
    float64 array - `guarded_amax` applied lane by lane, without B separate
    reductions (the ensemble engine's per-batch watchdog)."""
    import numpy as np

    x = _guarded_abs(array).reshape(array.shape[0], -1).amax(dim=1)
    return x.cpu().numpy().astype(np.float64)


def state_amax(arrays: Iterable) -> float:
    """The guarded amax over a state tuple (None entries skipped - e.g.
    the carry-less increment form's missing Kahan carry)."""
    vals = [guarded_amax(a) for a in arrays if a is not None]
    return max(vals) if vals else 0.0


def healthy(amax: float, bound: Optional[float] = None) -> bool:
    """True iff the state passed its check.  NaN/Inf fail (the guard maps
    them to +inf; a literal NaN compares False anyway)."""
    bound = DEFAULT_AMP_BOUND if bound is None else bound
    return amax <= bound
