"""The plain reference of a served lane's digest: plain PyTorch, nothing of
the program under test imported or read.

A serving replica answers a /solve request that names `probes` ([i, j, k]
held nodes) with its lane's `final_probes`, [u_last, u_before] at each
node, and `final_rms`, the root mean square of the last layer over all
N^3 held nodes.  The reference forms the same numbers from its own float64
march at the request's phase (wave.py), with the per-layer absolute
errors of the same march.
"""

from __future__ import annotations

from typing import Sequence

import torch

from wavebench.reference import wave


def digest(w: wave.Wave, phase: float, scheme: str,
           probes: Sequence[Sequence[int]], device) -> dict:
    """{"final_probes": [[u_last, u_before] at each probe], "final_rms",
    "abs": the per-layer absolute errors} of the reference march of `w`
    at `phase`, all float64."""
    ref = wave.march(w, phase, scheme, device)
    u, u_prev = ref["u"], ref["u_prev"]
    at = tuple(torch.tensor(c, dtype=torch.long, device=u.device)
               for c in zip(*probes)) if len(probes) else None
    pairs = ([] if at is None else
             torch.stack([u[at], u_prev[at]], dim=1).cpu().tolist())
    return {"final_probes": pairs,
            "final_rms": float(u.square().mean().sqrt()),
            "abs": ref["abs"]}
