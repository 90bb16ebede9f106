"""The seeded inputs of every cell: one phase per solve or request.

Phases are drawn uniformly in [0, 2 pi) from a stream of the seed alone,
so the same seed gives the same phases in the same order, and every seed
the same amount of work.  Separate streams of the same seed choose the
warm-up's phases and which answers are checked.
"""

from __future__ import annotations

import math
import random
from typing import Iterator


def stream(seed: int, purpose: str = "phase") -> random.Random:
    # A str seed is hashed with sha512: the same on every run and machine.
    return random.Random(f"{int(seed)}:{purpose}")


def phases(seed: int, purpose: str = "phase") -> Iterator[float]:
    rng = stream(seed, purpose)
    while True:
        yield rng.uniform(0.0, 2.0 * math.pi)
