"""Preemptible long solves: serve-side chunked march + resumable state
tokens (the port of wavetpu/serve/preempt.py).

 * `ChunkRunner` wraps `run/supervisor._Path` for the single-device
   standard-scheme serve tiers (roll / pallas / kfused) and adds the one
   piece the supervisor rebuilds per call: a BOOTSTRAP runner
   (`stop_step=1`, built once) that produces layers 0..1 exactly as the
   uninterrupted solve would (`leapfrog.make_solver`,
   `kfused.make_kfused_solver`).  tau stays `T / timesteps` wherever the
   march stops, so bootstrap-to-1 followed by fixed-length chunks from
   start=1 replays the monolithic solve's op sequence bit for bit (the
   invariant tests/test_torch_supervisor.py pins for the CLI).  One
   ChunkRunner per chunk ProgramKey lives in the engine's program LRU
   under the same ledger / program-cache discipline as the ensemble
   programs; its cache payload is the kernel libraries its build loads.

 * `SolveStateStore` is the cross-replica handoff surface: mid-flight
   state checkpoints under `--solve-state-dir`, CONTENT-ADDRESSED (the
   token is the sha256 of the file bytes) and REPLICA-VERIFIED on load
   (hash re-check + solve-identity match against the resuming request),
   so a forged or corrupt token gets a clean 422
   (`InvalidStateTokenError`), never a traceback.  Entries expire after
   `--solve-state-ttl-s` (GC on `put` and on `load`).  The file is
   wavetpu's, key for key (`io/checkpoint`'s bf16-safe field codec, the
   JSON meta blob, the error prefixes), so either package resumes the
   other's token.

Chunk boundaries land on the k-fusion block grid (`chunk_length`), and
resume steps are validated against that grid, so a resumed kfused march
reproduces the uninterrupted op sequence exactly.  Stdlib + numpy at
import; torch only inside functions.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from wavetpu_torch.serve.resilience import InvalidStateTokenError

STATE_FORMAT_VERSION = 1

_TOKEN_PREFIX = "st-"
_TOKEN_SUFFIX = ".npz"
_TOKEN_HEX = frozenset("0123456789abcdef")

# Identity fields a resume token must match on the resuming request -
# everything that changes the trajectory or the chunk-program shape.
_IDENTITY_FIELDS = (
    "N", "Np", "Lx", "Ly", "Lz", "T", "timesteps",
    "scheme", "path", "k", "dtype", "compute_errors", "chunk_len",
)


def solve_identity(problem, scheme: str, path: str, k: int,
                   dtype_name: str, compute_errors: bool,
                   chunk_len: int) -> dict:
    """The JSON-stable identity a state token is bound to."""
    return {
        "format": STATE_FORMAT_VERSION,
        "N": int(problem.N),
        "Np": int(problem.Np),
        "Lx": float(problem.Lx),
        "Ly": float(problem.Ly),
        "Lz": float(problem.Lz),
        "T": float(problem.T),
        "timesteps": int(problem.timesteps),
        "scheme": str(scheme),
        "path": str(path),
        "k": int(k),
        "dtype": str(dtype_name),
        "compute_errors": bool(compute_errors),
        "chunk_len": int(chunk_len),
    }


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class SolveStateStore:
    """Content-addressed mid-flight solve checkpoints.

    `put` writes one .npz (state fields via io/checkpoint's bf16-safe
    codec + a JSON meta blob + error prefixes) to a temp file, names it
    by its own sha256, and atomically renames it in - so a half-written
    file is never loadable and identical states dedupe to one entry.
    `load` re-hashes the file and refuses on ANY mismatch or parse
    problem with `InvalidStateTokenError` (the 422 contract)."""

    def __init__(self, directory: str, ttl_s: float = 3600.0):
        self.directory = directory
        self.ttl_s = float(ttl_s)
        os.makedirs(directory, exist_ok=True)

    def path_for(self, token: str) -> str:
        return os.path.join(
            self.directory, _TOKEN_PREFIX + token + _TOKEN_SUFFIX
        )

    @staticmethod
    def valid_token(token) -> bool:
        return (
            isinstance(token, str)
            and len(token) == 64
            and all(c in _TOKEN_HEX for c in token)
        )

    def put(self, identity: dict, state: Sequence, step: int,
            abs_errors: np.ndarray, rel_errors: np.ndarray,
            origin_trace: Optional[Sequence[str]] = None,
            priority: Optional[str] = None) -> str:
        """Checkpoint `state` (tensors on any device, or numpy; layers up
        to `step` marched) -> token.  `origin_trace` is the originating
        request's (trace id, span id) pair and `priority` the march's QoS
        class (a resume adopts it); load's identity check reads only
        `_IDENTITY_FIELDS`, so these never affect token acceptance."""
        from wavetpu_torch.io.checkpoint import _encode_field

        arrays = {}
        tags = []
        for i, field in enumerate(state):
            enc, tag = _encode_field(field)
            arrays[f"state{i}"] = enc
            tags.append(tag)
        meta = dict(identity)
        meta["step"] = int(step)
        meta["nstate"] = len(tags)
        meta["state_tags"] = tags
        if origin_trace is not None:
            meta["origin_trace"] = [str(x) for x in origin_trace]
        if priority is not None:
            meta["priority"] = str(priority)
        arrays["meta"] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode("utf-8"),
            dtype=np.uint8,
        )
        # Error prefixes ride along so the final result reports the full
        # per-layer history even across a handoff.
        arrays["abs_errors"] = np.asarray(
            abs_errors[: step + 1], dtype=np.float64
        )
        arrays["rel_errors"] = np.asarray(
            rel_errors[: step + 1], dtype=np.float64
        )
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            token = _file_sha256(tmp)
            os.replace(tmp, self.path_for(token))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.gc()
        return token

    def load(self, token: str, expect_identity: Optional[dict] = None
             ) -> Tuple[dict, int, tuple, np.ndarray, np.ndarray]:
        """Verify + decode a token -> (meta, step, state, abs, rel), the
        state as CPU tensors.

        Every failure mode - malformed token, missing or expired file,
        content hash mismatch (truncation/corruption/forgery of the name),
        unparseable npz, or identity mismatch against `expect_identity` -
        raises `InvalidStateTokenError` with a one-line reason."""
        if not self.valid_token(token):
            raise InvalidStateTokenError(
                "resume_token must be 64 lowercase hex characters"
            )
        self.gc()
        path = self.path_for(token)
        if not os.path.exists(path):
            raise InvalidStateTokenError(
                "resume_token not found (expired, GCed, or from a "
                "replica not sharing this --solve-state-dir)"
            )
        try:
            if _file_sha256(path) != token:
                raise InvalidStateTokenError(
                    "resume_token failed content verification "
                    "(checkpoint bytes do not hash to the token)"
                )
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"]).decode("utf-8"))
                from wavetpu_torch.io.checkpoint import _decode_field

                tags = meta["state_tags"]
                state = tuple(
                    _decode_field(z[f"state{i}"], tags[i])
                    for i in range(int(meta["nstate"]))
                )
                abs_e = np.asarray(z["abs_errors"], dtype=np.float64)
                rel_e = np.asarray(z["rel_errors"], dtype=np.float64)
        except InvalidStateTokenError:
            raise
        except Exception as exc:
            raise InvalidStateTokenError(
                f"resume_token checkpoint is unreadable: "
                f"{type(exc).__name__}"
            ) from None
        step = int(meta.get("step", -1))
        if expect_identity is not None:
            for field in _IDENTITY_FIELDS:
                if meta.get(field) != expect_identity.get(field):
                    raise InvalidStateTokenError(
                        f"resume_token does not match this request "
                        f"({field}: token has {meta.get(field)!r}, "
                        f"request needs {expect_identity.get(field)!r})"
                    )
            chunk_len = int(expect_identity["chunk_len"])
            timesteps = int(expect_identity["timesteps"])
            # Resume steps must land on the chunk grid (checkpoints are
            # only ever written there); off-grid steps would de-align a
            # kfused march from the uninterrupted op sequence.
            if (step < 1 or step >= timesteps
                    or (step - 1) % chunk_len != 0):
                raise InvalidStateTokenError(
                    f"resume_token step {step} is off the chunk grid "
                    f"(1 + j*{chunk_len}, below {timesteps})"
                )
            if len(abs_e) != step + 1 or len(rel_e) != step + 1:
                raise InvalidStateTokenError(
                    "resume_token error history is inconsistent with "
                    "its step"
                )
        return meta, step, state, abs_e, rel_e

    def gc(self) -> int:
        """Drop entries older than ttl_s (by mtime); returns the count.
        Racing replicas double-unlinking is harmless."""
        removed = 0
        cutoff = time.time() - self.ttl_s
        try:
            names = os.listdir(self.directory)
        except OSError:
            return 0
        for name in names:
            if not (name.startswith(_TOKEN_PREFIX)
                    and name.endswith(_TOKEN_SUFFIX)):
                continue
            full = os.path.join(self.directory, name)
            try:
                if os.path.getmtime(full) < cutoff:
                    os.unlink(full)
                    removed += 1
            except OSError:
                continue
        return removed


class ChunkRunner:
    """A cacheable chunked-march program set for ONE serve tier: a
    `_Path` (the supervisor's PathSpec -> solver adapter) plus the
    bootstrap runner, built once per process per config (the engine
    caches one per chunk ProgramKey)."""

    def __init__(self, problem, scheme: str, path: str, k: int,
                 dtype, dtype_name: str, compute_errors: bool,
                 chunk_steps: int, device=None,
                 block_x: Optional[int] = None):
        from wavetpu_torch.run import supervisor
        from wavetpu_torch.solver import leapfrog

        if scheme != "standard":
            raise ValueError(
                "chunked serving supports scheme='standard' only "
                "(ensemble bootstrap results carry no compensation "
                "state); compensated tiers run monolithic"
            )
        if path not in ("roll", "pallas", "kfused"):
            raise ValueError(f"chunked serving does not cover path "
                             f"{path!r}")
        self.device = leapfrog.resolve_device(device)
        fuse = int(k) if path == "kfused" else 1
        spec = supervisor.PathSpec(
            backend="single",
            scheme=scheme,
            fuse_steps=fuse,
            kernel="roll" if path == "roll" else "pallas",
            dtype=dtype,
            compute_errors=compute_errors,
            block_x=block_x,
            devices=(self.device,),
        )
        self._path = supervisor._Path(problem, spec)
        if path == "kfused" and self._path.kind != "kfused":
            raise ValueError(
                f"kfused chunked serving needs N % k == 0 "
                f"(N={problem.N}, k={fuse})"
            )
        self.problem = problem
        self.scheme = scheme
        self.path_name = path
        self.k = fuse
        self.dtype = dtype
        self.dtype_name = dtype_name
        self.compute_errors = compute_errors
        self.chunk_len = supervisor.chunk_length(int(chunk_steps), fuse)
        self.identity = solve_identity(
            problem, scheme, path, fuse, dtype_name, compute_errors,
            self.chunk_len,
        )
        self.compile_seconds = 0.0   # cumulative, for the LRU/ledger
        self._boot = None            # the bootstrap runner
        self._primed = False

    @property
    def libraries(self) -> Tuple[str, ...]:
        """The kernel libraries this runner's build loads: the solo
        solvers' set-up loads every library (`leapfrog.prepare_kernels`),
        none on the roll path or the CPU."""
        from wavetpu_torch.kernels import stencil_cuda

        if self.device.type != "cuda" or self.path_name == "roll":
            return ()
        return tuple(stencil_cuda._LOADERS)

    # -- geometry ------------------------------------------------------

    def march_lengths(self) -> Tuple[int, ...]:
        """The distinct chunk lengths a full march uses: the main
        length, plus the tail remainder when T-1 is not a multiple."""
        total = self.problem.timesteps - 1
        lens = []
        if total // self.chunk_len:
            lens.append(self.chunk_len)
        if total % self.chunk_len:
            lens.append(total % self.chunk_len)
        return tuple(lens)

    def next_length(self, step: int) -> int:
        """The next chunk's length when `step` layers are done."""
        return min(self.chunk_len, self.problem.timesteps - step)

    # -- bootstrap (layers 0..1) ---------------------------------------

    def _build_boot(self) -> float:
        if self._boot is not None:
            return 0.0
        from wavetpu_torch.solver import kfused, leapfrog

        t0 = time.perf_counter()
        p = self._path
        if p.kind == "kfused":
            self._boot = kfused.make_kfused_solver(
                self.problem, dtype=p.dtype, k=p.k,
                compute_errors=self.compute_errors, stop_step=1,
                device=self.device)
        else:
            self._boot = leapfrog.make_solver(
                self.problem, dtype=p.dtype,
                compute_errors=self.compute_errors, stop_step=1,
                device=self.device, kernel=p.spec.kernel)
        spent = time.perf_counter() - t0
        self.compile_seconds += spent
        return spent

    def bootstrap(self):
        """Run layers 0..1 exactly as the uninterrupted solve would;
        returns (state, abs2, rel2, compile_s, solve_s)."""
        from wavetpu_torch.solver import phases

        from wavetpu_torch.kernels import stencil_cuda

        compile_s = self._build_boot()
        fl0 = stencil_cuda.first_launch_seconds
        t0 = time.perf_counter()
        u_prev, u_cur, abs_all, rel_all = self._boot()
        abs_np, rel_np = phases.host(abs_all), phases.host(rel_all)
        solve_s = time.perf_counter() - t0
        first = stencil_cuda.first_launch_seconds - fl0
        return ((u_prev, u_cur), abs_np, rel_np, compile_s + first,
                solve_s - first)

    # -- chunks --------------------------------------------------------

    def chunk(self, state, start: int, length: int):
        """(state', abs_chunk, rel_chunk, solve_s, compile_s) - the
        supervisor's cached fixed-length chunk runner; the host time of
        the first launches of template instantiations (CUDA loads them
        there) counts as compile."""
        from wavetpu_torch.kernels import stencil_cuda

        fl0 = stencil_cuda.first_launch_seconds
        state, a, r, solve_s, build_s = self._path.chunk(state, start,
                                                         length)
        first = stencil_cuda.first_launch_seconds - fl0
        return state, a, r, solve_s - first, build_s + first

    def prime(self) -> float:
        """Build the bootstrap and a runner for EVERY chunk length this
        march uses (kernels built and loaded, oracle tables on the
        device), launching nothing; returns the build wall seconds.  A
        primed runner serves its first long solve with no build."""
        spent = self._build_boot()
        for length in self.march_lengths():
            if length in self._path._runners:
                continue
            t0 = time.perf_counter()
            self._path._runners[length] = self._path._build_runner(
                length, None)
            chunk_s = time.perf_counter() - t0
            self.compile_seconds += chunk_s
            spent += chunk_s
        self._primed = True
        return spent

    # -- state plumbing ------------------------------------------------

    def health_arrays(self, state):
        return self._path.health_arrays(state)

    def prepare(self, state):
        return self._path.prepare(state)

    def to_result(self, state, abs_full, rel_full, final_step: int,
                  init_s: float, solve_s: float, marched: int):
        return self._path.to_result(
            state, abs_full, rel_full, final_step, init_s, solve_s,
            marched,
        )

    @staticmethod
    def state_nbytes(state) -> int:
        """Bytes the march state holds (the /healthz memory view)."""
        return int(sum(a.numel() * a.element_size()
                       for a in state if a is not None))

    # -- persistent-cache hooks (serve/progcache.py) -------------------

    def executable_payload(self):
        """The libraries this runner's build loads, for the disk tier;
        None before `prime`."""
        from wavetpu_torch.serve import progcache

        return (progcache.library_payload(self.libraries)
                if self._primed else None)

    def adopt_executable(self, payload) -> float:
        """Adopt the libraries from a cache entry (checked, placed in the
        build directory, loaded as disk loads), then build the runners;
        returns the wall seconds.  Raises on a payload that does not
        check out - the caller counts it and builds fresh."""
        from wavetpu_torch.serve import progcache

        t0 = time.perf_counter()
        progcache.adopt_libraries(payload, self.libraries)
        self.prime()
        return time.perf_counter() - t0
