"""The comparison that decides `correct`: the program's answers against the
plain reference's (reference/wave.py) for the same problem and phase.

Every number is a gap on the closed form's scale (its amplitude is 1):

  u_gap     the largest |program - reference| over the last two layers the
            program returns (its final state)
  abs_gap   the largest |program - reference| of the per-layer absolute
            errors, over layers 1..T

An answer of the wrong length, or with a NaN, reads inf or nan, which no
limit passes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


def _vec(p, r) -> Optional[np.ndarray]:
    p, r = np.asarray(p, dtype=np.float64), np.asarray(r, dtype=np.float64)
    if p.shape != r.shape or p.ndim != 1 or len(p) < 2:
        return None
    return np.abs(p[1:] - r[1:])


def abs_gap(p, r) -> float:
    d = _vec(p, r)
    return math.inf if d is None else float(d.max())


def field_gap(u, ref) -> float:
    if tuple(u.shape) != tuple(ref.shape):
        return math.inf
    return float((u.to(ref.device, ref.dtype) - ref).abs().max())


def verdict(numbers: Dict[str, float],
            limits: Dict[str, float]) -> Tuple[bool, List[list]]:
    """Every number the cell's limits name must be at most its limit (a
    missing number fails).  Returns (correct, [[name, number, limit]])."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        ok = ok and value <= limit
        rows.append([name, value, limit])
    return ok, rows
