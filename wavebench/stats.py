"""The arithmetic of the window's numbers."""

from __future__ import annotations


def rate_gcells(cells_per_step: int, steps: int, done: int,
                seconds: float) -> float:
    """Cell updates of `done` whole solves or requests over the window's
    wall seconds, in 10^9 per second: all the work over all the time."""
    return cells_per_step * steps * done / seconds / 1e9

