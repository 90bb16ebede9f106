"""ProgramKey: the compiled-program identity of the serve engine's program
cache, the compile ledger and its manifests (the port's own copy of
wavetpu/progkey.py: the same fields and canonical JSON, so ledgers written
by either package read alike), the `--kernel` resolver, the identity a
/solve body determines (`identity_from_body`, `result_key`), and the
fleet router's affinity keys.

Imports only `core.problem` (itself import-free) - never torch: the
router and the ledger tools run on hosts with no accelerator stack.

Affinity keys: the router's warm-key table is keyed by the program
identity MINUS the `batch` bucket (the replica picks the bucket at
batch-assembly time; any bucket of a tier shares its built kernels and
the same breaker, see `ServeEngine.breaker_key`) and MINUS
`compute_errors` (a server-side config flag a request body cannot see).
"""

from __future__ import annotations

import hashlib
import json
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

from wavetpu_torch.core.problem import Problem, parse_length

# The ProgramKey field order - also the JSON-dict shape the ledger,
# warmup manifests, and the /metrics warm_keys block use.
KEY_FIELDS = (
    "N", "Lx", "Ly", "Lz", "T", "timesteps", "scheme", "path", "k",
    "dtype", "with_field", "compute_errors", "batch", "mesh",
)

# The routing identity: everything a request body determines.  `batch`
# is the replica's bucketing decision and `compute_errors` its config;
# neither is visible to (or stable for) the router.
AFFINITY_FIELDS = tuple(
    f for f in KEY_FIELDS if f not in ("batch", "compute_errors")
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

    @classmethod
    def for_batch(cls, problem: Problem, scheme: str, path: str, k: int,
                  dtype_name: str, with_field: bool, compute_errors: bool,
                  batch: int,
                  mesh: Optional[Tuple[int, int, int]] = None
                  ) -> "ProgramKey":
        return cls(
            N=problem.N, Lx=problem.Lx, Ly=problem.Ly, Lz=problem.Lz,
            T=problem.T, timesteps=problem.timesteps, scheme=scheme,
            path=path, k=k if path == "kfused" else 1, dtype=dtype_name,
            with_field=with_field, compute_errors=compute_errors,
            batch=batch, mesh=None if mesh is None else tuple(mesh),
        )


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


def affinity_key_from_dict(key: dict) -> str:
    """The router's warm-key-table key for a ProgramKey JSON dict: the
    AFFINITY_FIELDS projection as canonical JSON.  Every batch bucket of
    a tier maps to the same affinity key, so a replica that advertises
    {.., batch: 4} warmth attracts the tier's traffic at any occupancy."""
    out = {}
    for f in AFFINITY_FIELDS:
        v = key.get(f)
        if f == "mesh" and v is not None:
            v = [int(x) for x in v]
        out[f] = v
    return json.dumps(out, sort_keys=True)


def affinity_key(pk) -> str:
    """Affinity key of a ProgramKey (or any `_asdict` NamedTuple)."""
    return affinity_key_from_dict(dict(pk._asdict()))


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


class RequestIdentity(NamedTuple):
    """The program identity a /solve body determines - everything in
    ProgramKey except the server-chosen batch bucket and the server-
    config compute_errors flag."""

    problem: Problem
    scheme: str
    path: str
    k: int
    dtype: str
    with_field: bool
    mesh: Optional[Tuple[int, int, int]]

    def program_key(self, batch: int, compute_errors: bool) -> ProgramKey:
        return ProgramKey.for_batch(
            self.problem, self.scheme, self.path, self.k, self.dtype,
            self.with_field, compute_errors, batch, mesh=self.mesh,
        )

    def affinity_key(self) -> str:
        p = self.problem
        return affinity_key_from_dict({
            "N": p.N, "Lx": p.Lx, "Ly": p.Ly, "Lz": p.Lz, "T": p.T,
            "timesteps": p.timesteps, "scheme": self.scheme,
            "path": self.path, "k": self.k, "dtype": self.dtype,
            "with_field": self.with_field,
            "mesh": None if self.mesh is None else list(self.mesh),
        })


# `platform` for identity_from_body: "gpu" or "cpu" (the replica's
# --platform), or a callable resolved lazily ONLY when the body says
# kernel=auto.
PlatformSource = Union[str, Callable[[], str], None]


def identity_from_body(body: dict, default_kernel: str = "auto",
                       platform: PlatformSource = None) -> RequestIdentity:
    """The identity half of /solve body validation (ValueError on any
    bad field - HTTP 400 at the replica).  Validation that needs a
    backend (device-count for mesh, c2-field preset names, lane
    validation) is NOT done here - `serve/api.parse_solve_request`
    layers it on top.  kernel=auto resolves through `resolve_kernel`:
    pallas (the CUDA kernels) on "gpu", roll (their plain versions) on
    "cpu"."""
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    if "N" not in body:
        raise ValueError("missing required field N")
    problem = Problem(
        N=int(body["N"]),
        Np=int(body.get("Np", 1)),
        Lx=parse_length(body.get("Lx", 1.0)),
        Ly=parse_length(body.get("Ly", 1.0)),
        Lz=parse_length(body.get("Lz", 1.0)),
        T=float(body.get("T", 1.0)),
        timesteps=int(body.get("timesteps", 20)),
    )
    scheme = body.get("scheme", "standard")
    if scheme not in ("standard", "compensated"):
        raise ValueError(
            f"scheme must be standard|compensated, got {scheme!r}"
        )
    dtype_name = body.get("dtype", "f32")
    if dtype_name not in ("f32", "f64", "bf16"):
        raise ValueError(f"dtype must be f32|f64|bf16, got {dtype_name!r}")
    kernel = body.get("kernel", default_kernel)
    if kernel not in ("auto", "roll", "pallas"):
        raise ValueError(
            f"kernel must be auto|roll|pallas, got {kernel!r}"
        )
    fuse_steps = int(body.get("fuse_steps", 1))
    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    if kernel == "auto":
        resolved = platform() if callable(platform) else platform
        kernel = resolve_kernel("auto", resolved or "cpu")
    if fuse_steps > 1:
        if kernel == "roll":
            raise ValueError("fuse_steps needs the pallas kernel")
        path = "kfused"
    else:
        path = kernel
    with_field = bool(body.get("c2_field"))
    if scheme == "compensated" and with_field:
        # Compensated batches are constant-speed only (the field is not
        # wired through the compensated vmapped core); reject here so
        # the client gets a 400, not a batch-time 500.  Shifted phases
        # DO batch on the compensated scheme (analytic bootstrap).
        raise ValueError(
            "scheme=compensated does not serve c2_field requests"
        )
    if scheme == "compensated" and dtype_name == "bf16":
        # Same 400-not-500 reasoning: the compensated scheme requires
        # an f32/f64 carrier (EnsembleSolver would refuse at build).
        raise ValueError(
            "scheme=compensated requires f32/f64 state (bf16 "
            "representation error dominates what compensation recovers)"
        )
    mesh = body.get("mesh")
    if mesh is not None:
        mesh = tuple(int(m) for m in mesh)
        if len(mesh) != 3 or any(m < 1 for m in mesh):
            raise ValueError(
                f"mesh must be three positive ints [MX, MY, MZ], "
                f"got {body.get('mesh')!r}"
            )
        if scheme == "compensated":
            raise ValueError(
                "sharded x batched serves the standard scheme only"
            )
        if fuse_steps > 1:
            raise ValueError(
                "sharded x batched does not take fuse_steps (the "
                "sharded lane marches the 1-step kernel)"
            )
        if with_field:
            raise ValueError(
                "sharded x batched does not serve c2_field requests"
            )
    return RequestIdentity(
        problem=problem, scheme=scheme, path=path,
        k=fuse_steps if path == "kfused" else 1, dtype=dtype_name,
        with_field=with_field, mesh=mesh,
    )


# Body fields beyond the program identity that change a deterministic
# solve's ANSWER (not just its routing): per-lane phase, the early-stop
# step, and the c2-field preset name.  `deadline_ms` / `priority` /
# QoS headers shape scheduling, never the payload, so they are NOT part
# of the result identity - two tenants replaying the same solve share
# one cache entry.
RESULT_FIELDS = ("phase", "steps", "c2_field")


def result_cache_eligible(body) -> bool:
    """Conservative result-cache eligibility: deterministic FULL solves
    only.  A resume-token request continues a specific checkpointed
    march (its answer depends on server-side state, not just the body),
    so it must never be served from - or stored into - the result
    cache."""
    return isinstance(body, dict) and not body.get("resume_token")


def result_key(body: dict, default_kernel: str = "auto",
               platform: PlatformSource = None) -> str:
    """The content-addressed RESULT identity of a /solve body: a sha256
    hex digest over the canonical `RequestIdentity` projection plus the
    answer-shaping RESULT_FIELDS.  Derived through the SAME
    `identity_from_body` normalization the engine caches programs under
    and the router routes by, so the replica result cache and the
    router edge cache hash a body identically.  Raises ValueError on a
    body that yields no identity (the caller treats that as
    ineligible)."""
    ident = identity_from_body(body, default_kernel, platform=platform)
    p = ident.problem
    payload = {
        "N": p.N, "Np": p.Np, "Lx": p.Lx, "Ly": p.Ly, "Lz": p.Lz,
        "T": p.T, "timesteps": p.timesteps, "scheme": ident.scheme,
        "path": ident.path, "k": ident.k, "dtype": ident.dtype,
        "with_field": ident.with_field,
        "mesh": None if ident.mesh is None else list(ident.mesh),
    }
    for f in RESULT_FIELDS:
        payload[f] = body.get(f)
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()


def warm_keys_to_affinity(warm_keys: dict) -> List[str]:
    """Flatten a /metrics `program_cache.warm_keys` block ({"memory":
    [keydict..], "disk": [keydict..]}) into affinity keys, ignoring
    malformed entries (a half-written cache dir must not poison the
    router's table)."""
    out: List[str] = []
    seen = set()
    for tier in ("memory", "disk"):
        for kd in warm_keys.get(tier, ()) or ():
            if not isinstance(kd, dict):
                continue
            if any(kd.get(f) is None
                   for f in ("N", "timesteps", "path", "dtype")):
                continue  # not a ProgramKey dict; don't poison the table
            try:
                ak = affinity_key_from_dict(kd)
            except (ValueError, TypeError):
                continue
            if ak not in seen:
                seen.add(ak)
                out.append(ak)
    return out
