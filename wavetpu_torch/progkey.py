"""ProgramKey: the compiled-program identity of the compile ledger and
its manifests (the port's own copy of the key half of wavetpu/progkey.py:
the same fields and canonical JSON, so ledgers written by either package
read alike), and the `--kernel` resolver.

Imports only `core.problem` (itself import-free) - never torch: the
ledger tools run on hosts with no accelerator stack.  The request-body
identity and the router's affinity keys (wavetpu's serving tier) come
with the serving slice.
"""

from __future__ import annotations

import json
from typing import NamedTuple, Optional, Tuple

# The ProgramKey field order - also the JSON-dict shape of the ledger and
# the warmup manifests.
KEY_FIELDS = (
    "N", "Lx", "Ly", "Lz", "T", "timesteps", "scheme", "path", "k",
    "dtype", "with_field", "compute_errors", "batch", "mesh",
)


class ProgramKey(NamedTuple):
    """Identity of one compiled batched program (the cache key).

    `mesh` is None for single-device programs, or the (MX, MY, MZ) mesh
    shape of a sharded x batched program (ensemble/sharded.py) - a
    (mesh, batch-bucket) pair is its own compiled executable."""

    N: int
    Lx: float
    Ly: float
    Lz: float
    T: float
    timesteps: int
    scheme: str
    path: str
    k: int
    dtype: str
    with_field: bool
    compute_errors: bool
    batch: int
    mesh: Optional[Tuple[int, int, int]] = None


def normalize_key(key: dict) -> dict:
    """A JSON-stable key dict: ProgramKey field order, mesh as a list
    (JSON has no tuples), unknown fields rejected loudly."""
    unknown = set(key) - set(KEY_FIELDS)
    if unknown:
        raise ValueError(f"unknown ProgramKey fields {sorted(unknown)}")
    out = {}
    for f in KEY_FIELDS:
        v = key.get(f)
        if f == "mesh" and v is not None:
            v = [int(x) for x in v]
        out[f] = v
    return out


def canonical_key(key: dict) -> str:
    return json.dumps(normalize_key(key), sort_keys=True)


def key_from_program_key(pk) -> dict:
    """A ProgramKey (duck-typed: any NamedTuple with `_asdict`) as the
    ledger's JSON key dict."""
    return normalize_key(dict(pk._asdict()))


def program_key_from_dict(d: dict) -> ProgramKey:
    """The round-trip half: a ledger/manifest/warm-keys key dict back
    into a `ProgramKey`."""
    d = normalize_key(d)
    if d["mesh"] is not None:
        d["mesh"] = tuple(d["mesh"])
    return ProgramKey(**d)


def resolve_kernel(flag_value: str, platform: str) -> str:
    """Map --kernel {auto,roll,pallas} to the concrete kernel for
    `platform` ("gpu" or "cpu", the CLI's --platform).  pallas = the CUDA
    kernels, roll = their plain PyTorch versions on the same device; auto
    = pallas on the GPU and roll on the CPU (where the CUDA kernels cannot
    run - the plain versions are what the CPU runs)."""
    if flag_value not in ("auto", "roll", "pallas"):
        raise ValueError(
            f"--kernel must be auto|roll|pallas, got {flag_value}"
        )
    if flag_value == "auto":
        return "pallas" if platform == "gpu" else "roll"
    return flag_value
