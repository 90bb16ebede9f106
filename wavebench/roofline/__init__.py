"""The yardstick of the kernels' roofline shares, frozen here.

Each kernel's file holds the bytes one launch must move per cell (each
input read once, each output written once, whatever the kernel reads
again) and the float32 operations one step needs per cell; peaks.json
holds the card's published peaks.  The least time a launch could take is
the larger of its bytes over the HBM rate and its operations over the
float32 rate.  A share is that least time, summed over the work the cell's
steps need, over the device time the profiler measured for the kernel's
launches in the same window.
"""

from __future__ import annotations

from typing import Iterable, Optional

from wavebench import spec


def kstep_launches(steps: int, k: int, tail_same_kernel: bool) -> int:
    """Launches of a k-step kernel over `steps` marched layers: one per
    k-block, plus one per remainder layer where the tail runs the same
    kernel at k=1."""
    return steps // k + (steps % k if tail_same_kernel else 0)


def bound_seconds(kernel: str, cells: int, launches: int,
                  steps: int) -> float:
    """The least time `launches` launches over `cells` cells each, marching
    `steps` layers in all, could take on the card."""
    entry, peak = spec.roofline(kernel), spec.peaks()
    by_bytes = entry["bytes_per_cell_per_launch"] * cells * launches \
        / peak["hbm_bytes_per_s"]
    by_ops = entry["ops_per_cell_per_step"] * cells * steps \
        / peak["f32_ops_per_s"]
    return max(by_bytes, by_ops)


def device_seconds(rec: dict, names: Iterable[str]) -> float:
    return sum(rec["kernels"].get(n, (0, 0.0))[1] for n in names)


def share_pct(bound_s: float, measured_s: float) -> Optional[float]:
    """The share in percent, or None where the kernel did not run."""
    if measured_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
