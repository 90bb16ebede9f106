"""Program cache + batched execution for the serve layer (the port of
wavetpu/serve/engine.py).

One batched solver serves every request that matches its identity:
`ProgramKey` = the full problem geometry (N, Lx/y/z, T, timesteps),
scheme, kernel path, k, dtype, whether lanes carry c2 fields, whether
errors are computed, the mesh of a sharded batch, and the BATCH-SIZE
BUCKET.  Requests are padded up to the nearest bucket with
`padding_lane()`s (frozen after layer 1, so real lanes are bitwise
unchanged - tests/test_torch_ensemble.py), so a handful of buckets
(default 1/2/4/8) covers every occupancy.

Where wavetpu caches compiled XLA executables, the port caches the
`EnsembleSolver` / `ShardedEnsembleSolver` objects: a plain LRU of
`max_programs` solvers, hits/misses/evictions counted for /metrics.  A
solver holds no state between batches (each `run` allocates its own);
its `compile()` builds and loads the kernel libraries and is what a
cache miss pays (0.0 once the libraries are loaded) - the `compile`
component of a response's Server-Timing header.  `warmup()` builds ahead
of traffic and launches nothing, so it may run beside the scheduler's
worker thread: only that thread launches kernels (the launch counters
and `stencil_cuda.first_launch_seconds` have no other writer).

Every batch passes the per-lane numerical-health watchdog (run/health.py's
guarded amax, one reduction over the batch): a poisoned lane - NaN, Inf,
or an amplitude blowup from e.g. a Courant-unstable field - yields a
per-lane error string while its batchmates' results stand.  The batch's
states are released right after that reduction and the digest of every
lane that asked for `probes` (`final_digests`: one gather and one
reduction over the asking lanes, one copy to the host, under a
`serve.digest` span): a lane's answer is its error vectors, digest and
report fields, and the next batch must not find the last one's
(B, N, N, N) states still on the card.

The engine runs on one `torch.device`: the CUDA device (the kernels'
lane modes; `kernel: auto` resolves to pallas) or the CPU (their plain
versions, `--platform cpu`).  A mesh request puts its shards on the
visible cards, repeating them as the port's sharded solvers do (the CPU
repeats itself).  A kernel that fails to build or launch raises: the
request gets a 5xx that the circuit breaker counts - it never re-runs on
the plain versions.  The lane-loop fallback runs only where the lane
modes' static table refuses a key (`ensemble.vmap_capability`), and is
counted in /metrics.

A per-ProgramKey CIRCUIT BREAKER (serve/resilience.py) quarantines a key
after K consecutive build/execute failures (batch bucket excluded), so a
poisoned tier sheds fast `QuarantinedError`s (HTTP 503 + Retry-After)
while other tiers keep serving.  `run/faults.py`'s serve plan injects
`compile-fail` (before the build) and `execute-nan` (after the solve,
proving the watchdog catches it) at this layer.

The persistent disk tier (`--program-cache-dir`, serve/progcache.py) sits
under the LRU: memory -> disk adopt -> fresh build.  A disk entry holds
the kernel libraries a key launches; adopting it places them in the build
directory and loads them (no nvcc), and a program so adopted is a
`disk_hit` with a `source: disk` compile-ledger line.  An entry that does
not check out is a counted miss and the fresh build runs - never the
plain versions.  The chunk runners of preemptible long solves
(serve/preempt.py, `chunk_runner`) live in the same LRU under
`path@chunk{L}` keys; their march state is the scheduler's, held on the
card between rounds.  With `keep_final_state` (the shadow sampler's
need) each lane keeps its own copy of its final layer after the release.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as ensemble
from wavetpu_torch.ensemble import sharded as ens_sharded
from wavetpu_torch.kernels import stencil_cuda
from wavetpu_torch.obs import accuracy
from wavetpu_torch.obs import ledger as compile_ledger
from wavetpu_torch.obs import perf, tracing
from wavetpu_torch.obs.registry import MetricsRegistry
from wavetpu_torch.progkey import ProgramKey, key_from_program_key
from wavetpu_torch.run import faults, health
from wavetpu_torch.serve.resilience import CircuitBreaker, QuarantinedError

_DTYPES = {"f32": torch.float32, "f64": torch.float64,
           "bf16": torch.bfloat16}


class ServeEngine:
    """LRU-cached batched solvers + watchdogged batch execution on
    `device` (default: the CUDA device, raising without one).

    Thread-safe for the single-scheduler-worker design (a lock guards the
    cache, so a warmup from another thread is safe)."""

    def __init__(
        self,
        bucket_sizes: Sequence[int] = (1, 2, 4, 8),
        max_programs: int = 8,
        compute_errors: bool = True,
        device=None,
        watchdog: bool = True,
        max_amp: Optional[float] = None,
        block_x: Optional[int] = None,
        registry: Optional[MetricsRegistry] = None,
        breaker_threshold: Optional[int] = 3,
        breaker_cooldown_s: float = 30.0,
        fault_plan: Optional[faults.ServeFaultPlan] = None,
        program_cache_dir: Optional[str] = None,
        program_cache_max_bytes: Optional[int] = None,
    ):
        from wavetpu_torch.solver import leapfrog

        if not bucket_sizes or any(b < 1 for b in bucket_sizes):
            raise ValueError(f"bad bucket_sizes {bucket_sizes}")
        if max_programs < 1:
            raise ValueError(f"max_programs must be >= 1, got {max_programs}")
        self.bucket_sizes = tuple(sorted(set(int(b) for b in bucket_sizes)))
        self.max_programs = max_programs
        self.compute_errors = compute_errors
        self.device = leapfrog.resolve_device(device)
        self.watchdog = watchdog
        self.max_amp = max_amp
        self.block_x = block_x
        # `build_server` passes the server's registry so cache and
        # build/execute metrics land in the same /metrics exposition as
        # the scheduler's; a standalone engine gets its own.
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._c_cache = self.registry.counter(
            "wavetpu_program_cache_events_total",
            "compiled-program cache events", ("event",),
        )
        self._h_compile = self.registry.histogram(
            "wavetpu_serve_compile_seconds",
            "batched-program build+compile time on cache miss",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                     120.0, 300.0),
        )
        self._h_execute = self.registry.histogram(
            "wavetpu_serve_execute_seconds",
            "batch solve wall time (warm=false includes this key's "
            "first compile in the same request)", ("warm",),
            buckets=(0.005, 0.025, 0.1, 0.25, 1.0, 2.5, 5.0, 10.0,
                     30.0, 60.0, 120.0, 300.0),
        )
        self._lock = threading.Lock()
        self._programs: "OrderedDict[ProgramKey, object]" = OrderedDict()
        # path -> recorded fallback reason (never silent; surfaced in
        # /metrics so an operator sees WHICH path has no lane mode).
        self.fallbacks: dict = {}
        self.breaker: Optional[CircuitBreaker] = (
            None if breaker_threshold is None else CircuitBreaker(
                threshold=breaker_threshold,
                cooldown_s=breaker_cooldown_s, registry=self.registry,
            )
        )
        # Chaos harness: the serve-path injection plan (shared server-
        # wide by build_server; a standalone engine reads WAVETPU_FAULT
        # itself).  None on the happy path - every seam is a None check.
        self.fault_plan = (
            fault_plan if fault_plan is not None
            else faults.serve_plan_from_env()
        )
        if self.fault_plan is not None:
            self.fault_plan.bind_registry(self.registry)
        # Persistent disk tier (serve/progcache.py): None without
        # --program-cache-dir - every use is a None check.  A bad
        # directory raises HERE (operator config error at startup).
        self.progcache = None
        if program_cache_dir:
            from wavetpu_torch.serve import progcache as progcache_mod

            self.progcache = progcache_mod.ProgramCache(
                program_cache_dir, max_bytes=program_cache_max_bytes,
                registry=self.registry, fault_plan=self.fault_plan,
                device=self.device,
            )
        # Shadow sampling compares final layers after the primary answer:
        # with this set, each lane keeps its own copy of u_cur.
        self.keep_final_state = False

    # Cache hit/miss/eviction counts live in the registry counter - the
    # single source of truth for the JSON and Prometheus /metrics views.

    @property
    def hits(self) -> int:
        return int(self._c_cache.value(event="hit"))

    @property
    def misses(self) -> int:
        return int(self._c_cache.value(event="miss"))

    @property
    def evictions(self) -> int:
        return int(self._c_cache.value(event="eviction"))

    @property
    def disk_hits(self) -> int:
        return int(self._c_cache.value(event="disk_hit"))

    @property
    def max_batch(self) -> int:
        return self.bucket_sizes[-1]

    @property
    def platform(self) -> str:
        """"gpu" or "cpu": what `kernel: auto` resolves against."""
        return "gpu" if self.device.type == "cuda" else "cpu"

    def bucket_for(self, n_lanes: int) -> int:
        """Smallest bucket >= n_lanes (the scheduler never exceeds
        max_batch, so there is always one)."""
        for b in self.bucket_sizes:
            if b >= n_lanes:
                return b
        raise ValueError(
            f"{n_lanes} lanes exceed the largest bucket "
            f"{self.bucket_sizes[-1]}"
        )

    def _dtype(self, dtype_name: str):
        if dtype_name not in _DTYPES:
            raise ValueError(
                f"dtype must be one of {sorted(_DTYPES)}, got {dtype_name!r}"
            )
        if dtype_name == "f64" and self.device.type != "cpu":
            raise ValueError("dtype f64 runs only on the CPU (--platform "
                             "cpu), as the CLI's --dtype f64")
        return _DTYPES[dtype_name]

    def mesh_devices(self, mesh: Tuple[int, int, int]) -> List:
        """The devices of a mesh request's shards in mesh order: the
        visible cards, repeated to fill the mesh (the CPU repeats)."""
        n = mesh[0] * mesh[1] * mesh[2]
        if self.device.type != "cuda":
            return [self.device] * n
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]

    def _device_scope(self):
        """The engine's card as the calling thread's current device (the
        kernels launch on the current stream): the worker thread passes
        its device explicitly, never relying on a thread default."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def program(
        self, problem: Problem, scheme: str, path: str, k: int,
        dtype_name: str, with_field: bool, batch: int,
        mesh: Optional[Tuple[int, int, int]] = None,
    ):
        """The cached batched solver for this key, building it on a miss
        - or None when no lane mode serves the key: the caller then runs
        the recorded lane-loop fallback.  `mesh` selects the sharded x
        batched composition (ensemble/sharded.py)."""
        return self._program(
            problem, scheme, path, k, dtype_name, with_field, batch, mesh
        )[0]

    def _program(
        self, problem: Problem, scheme: str, path: str, k: int,
        dtype_name: str, with_field: bool, batch: int,
        mesh: Optional[Tuple[int, int, int]] = None,
    ):
        """`program()` plus THIS call's attribution - (solver, source,
        compile_seconds) with source "memory" (LRU hit), "fresh" (built;
        compile_seconds is the kernel build and load it paid, 0.0 once
        the libraries are loaded) or "fallback" (solver None)."""
        compute_errors = self.compute_errors and not with_field
        if mesh is not None:
            if scheme != "standard":
                # Refuse loudly: serving a compensated request with the
                # standard scheme would be a wrong result, not a fallback.
                # (The HTTP layer 400s this at parse.)
                raise ValueError(
                    "sharded x batched serves the standard scheme only; "
                    f"got scheme={scheme!r} with mesh {tuple(mesh)}"
                )
            ok, why = ens_sharded.vmap_capability(
                mesh, kernel=path, device=self.device)
            if not ok:
                self.fallbacks.setdefault(f"mesh:{tuple(mesh)}:{path}", why)
                return None, "fallback", 0.0
        else:
            ok, why = ensemble.vmap_capability(
                path, k=k, with_field=with_field, scheme=scheme,
                device=self.device)
            if not ok:
                self.fallbacks.setdefault(f"{scheme}:{path}", why)
                return None, "fallback", 0.0
        key = ProgramKey.for_batch(
            problem, scheme, path, k, dtype_name, with_field,
            compute_errors, batch, mesh,
        )
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                self._c_cache.inc(event="hit")
                return prog, "memory", 0.0

        def _build():
            dtype = self._dtype(dtype_name)
            if mesh is not None:
                return ens_sharded.ShardedEnsembleSolver(
                    problem, batch, mesh, dtype=dtype, kernel=path,
                    compute_errors=compute_errors,
                    devices=self.mesh_devices(mesh),
                )
            return ensemble.EnsembleSolver(
                problem, batch, dtype=dtype, path=path, k=k,
                compute_errors=compute_errors, block_x=self.block_x,
                with_field=with_field, scheme=scheme, device=self.device,
            )

        return self._acquire(
            key, _build, lambda prog: prog.compile(), problem, scheme,
            path, dtype_name, batch, mesh)

    def _acquire(self, key: ProgramKey, build, first_build, problem,
                 scheme: str, path: str, dtype_name: str, batch: int,
                 mesh):
        """The disk tier and the fresh build of an LRU miss ->
        (prog, source, compile_seconds).  Disk: adopt a persisted entry
        (a valid one counts `disk_hit` only - `miss` stays exactly the
        fresh-build count); any disk problem is a counted miss that falls
        through to the fresh build, which stores its libraries for the
        next process."""
        key_dict = key_from_program_key(key)
        if self.progcache is not None:
            entry = self.progcache.load(key_dict)
            if entry is not None:
                payload, header = entry
                from wavetpu_torch.serve import progcache as progcache_mod

                t0 = time.perf_counter()
                try:
                    prog = build()
                    prog.adopt_executable(payload)
                except progcache_mod.FingerprintMismatch:
                    self.progcache.count("fingerprint_mismatch")
                    prog = None
                except Exception:
                    # A checksum-valid entry whose libraries do not check
                    # out: counted, then the fresh path below builds.
                    self.progcache.count("corrupt")
                    prog = None
                if prog is not None:
                    load_s = time.perf_counter() - t0
                    self._c_cache.inc(event="disk_hit")
                    fresh_s = header.get("compile_s")
                    if not isinstance(fresh_s, (int, float)):
                        fresh_s = None
                    if fresh_s is not None:
                        self.progcache.credit_saved(fresh_s, load_s)
                    compile_ledger.record_compile(
                        key_dict, load_s, source="disk",
                        fresh_compile_s=fresh_s,
                    )
                    self._cache_insert(key, prog)
                    return prog, "disk", load_s
        self._c_cache.inc(event="miss")
        # Chaos seam: an injected build failure lands exactly where a real
        # nvcc or load error would - after the miss is counted, before any
        # build work.
        if self.fault_plan is not None and self.fault_plan.fire(
            "compile-fail", n=problem.N, timesteps=problem.timesteps,
            scheme=scheme, path=path.partition("@")[0], k=key.k,
            dtype=dtype_name,
        ):
            raise faults.InjectedFault(
                f"injected compile failure ({scheme}:{path} "
                f"N={problem.N}/{problem.timesteps})"
            )
        # Build OUTSIDE the cache lock (an nvcc build takes seconds; a
        # warmup from another thread must not serialize on it - the
        # builds themselves serialize in kernels/build.py).
        t0 = time.perf_counter()
        with tracing.span(
            "serve.compile", scheme=scheme, path=path, batch=batch,
            n=problem.N, mesh=None if mesh is None else list(mesh),
        ):
            prog = build()
            first_build(prog)
        compile_seconds = time.perf_counter() - t0
        self._h_compile.observe(compile_seconds)
        # Compile-cost ledger (obs/ledger.py): one line per build, keyed
        # by the full ProgramKey; a no-op without --telemetry-dir.
        compile_ledger.record_compile(key_dict, compile_seconds,
                                      source="fresh")
        # Persist for the next process (guarded: a full disk must never
        # fail the request that just built).
        if self.progcache is not None:
            try:
                payload = prog.executable_payload()
                if payload is not None:
                    self.progcache.put(key_dict, payload, compile_seconds)
            except Exception:
                self.progcache.count("store_error")
        self._cache_insert(key, prog)
        return prog, "fresh", compile_seconds

    def _cache_insert(self, key: ProgramKey, prog) -> None:
        with self._lock:
            self._programs[key] = prog
            self._programs.move_to_end(key)
            while len(self._programs) > self.max_programs:
                self._programs.popitem(last=False)
                self._c_cache.inc(event="eviction")

    def warmup(
        self, problem: Problem, scheme: str = "standard",
        path: str = "roll", k: int = 4, dtype_name: str = "f32",
        with_field: bool = False, batches: Optional[Sequence[int]] = None,
        mesh: Optional[Tuple[int, int, int]] = None,
    ) -> List[int]:
        """Build the key's solver for each requested bucket (default:
        all) and load its kernels; launches nothing.  Returns the bucket
        sizes warmed (empty when the key falls back - recorded, not
        raised)."""
        warmed = []
        for b in (self.bucket_sizes if batches is None else batches):
            if self.program(
                problem, scheme, path, k, dtype_name, with_field, b, mesh
            ) is not None:
                warmed.append(b)
        return warmed

    def warm_manifest(self, manifest: dict) -> Tuple[int, int, int]:
        """`serve --warmup-manifest`: build or adopt every key a
        ledger-report manifest names through the LRU (launching
        nothing); returns (warmed, skipped, failed).  A key the device
        cannot hold is skipped (`progcache.cannot_hold`); a `path@chunkL`
        key warms the chunk-runner tier."""
        from wavetpu_torch import progkey
        from wavetpu_torch.serve import progcache as progcache_mod

        done = skipped = failed = 0
        for raw in manifest.get("keys", ()):
            try:
                pk = progkey.program_key_from_dict(raw)
                if progcache_mod.cannot_hold(pk, self.device) is not None:
                    skipped += 1
                    continue
                mp = Problem(N=pk.N, Np=1, Lx=pk.Lx, Ly=pk.Ly, Lz=pk.Lz,
                             T=pk.T, timesteps=pk.timesteps)
                if "@chunk" in pk.path:
                    base, _, clen = pk.path.partition("@chunk")
                    self.chunk_runner(mp, pk.scheme, base, pk.k, pk.dtype,
                                      int(clen))
                    done += 1
                elif self.program(mp, pk.scheme, pk.path, pk.k, pk.dtype,
                                  pk.with_field, pk.batch,
                                  pk.mesh) is not None:
                    done += 1
                else:
                    skipped += 1
            except Exception as e:
                failed += 1
                print(f"manifest warmup key failed: {e}", file=sys.stderr)
        return done, skipped, failed

    # ---- chunked long solves (serve/preempt.py) ----

    @staticmethod
    def chunk_program_key(problem: Problem, scheme: str, path: str,
                          k: int, dtype_name: str, compute_errors: bool,
                          chunk_len: int) -> ProgramKey:
        """The chunk-program identity: the full-march ProgramKey at
        batch=1 with the chunk geometry folded into the path string
        (`pallas@chunk200`).  `timesteps` stays the TOTAL march length,
        and the suffix keeps chunked and monolithic programs apart in the
        LRU, the ledger and the program cache."""
        base = ProgramKey.for_batch(
            problem, scheme, path, k, dtype_name, False,
            compute_errors, 1, None,
        )
        # for_batch normalizes k to 1 off the kfused path, so the suffix
        # rides in AFTER derivation.
        return base._replace(path=f"{path}@chunk{chunk_len}")

    def chunk_runner(
        self, problem: Problem, scheme: str, path: str, k: int,
        dtype_name: str, chunk_steps: int,
    ):
        """The cached ChunkRunner (bootstrap + fixed-length chunk
        runners) for a long solve's tier - (runner, source,
        compile_seconds) with the memory -> disk -> fresh discipline and
        attribution of `_program`, in the same LRU.  The circuit breaker
        is NOT consulted: the chunked path has its own failure handling
        (per-chunk watchdog 422s, crash re-enqueue,
        checkpoint-and-preempt), none of which may quarantine the
        tier."""
        from wavetpu_torch.run import supervisor
        from wavetpu_torch.serve import preempt

        fuse = int(k) if path == "kfused" else 1
        chunk_len = supervisor.chunk_length(int(chunk_steps), fuse)
        key = self.chunk_program_key(
            problem, scheme, path, k, dtype_name, self.compute_errors,
            chunk_len,
        )
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
                self._c_cache.inc(event="hit")
                return prog, "memory", 0.0

        def _build():
            return preempt.ChunkRunner(
                problem, scheme, path, fuse, self._dtype(dtype_name),
                dtype_name, self.compute_errors, chunk_steps=chunk_len,
                device=self.device, block_x=self.block_x,
            )

        with self._device_scope():
            return self._acquire(
                key, _build, lambda prog: prog.prime(), problem, scheme,
                key.path, dtype_name, 1, None)

    def breaker_key(self, problem: Problem, scheme: str, path: str,
                    k: int, dtype_name: str, with_field: bool,
                    mesh: Optional[Tuple[int, int, int]] = None
                    ) -> ProgramKey:
        """The circuit-breaker identity: the ProgramKey with batch=0, so
        every bucket of a tier shares one breaker."""
        return ProgramKey.for_batch(
            problem, scheme, path, k, dtype_name, with_field,
            self.compute_errors and not with_field, 0, mesh,
        )

    def breaker_stats(self) -> dict:
        """The JSON /metrics `breaker` block."""
        if self.breaker is None:
            return {"enabled": False}
        return {"enabled": True, **self.breaker.snapshot()}

    def cache_stats(self) -> dict:
        """The JSON /metrics `program_cache` block (wavetpu's keys)."""
        with self._lock:
            return {
                "programs": len(self._programs),
                "max_programs": self.max_programs,
                "hits": self.hits,
                "misses": self.misses,
                "disk_hits": int(self._c_cache.value(event="disk_hit")),
                "evictions": self.evictions,
                "keys": [list(k) for k in self._programs],
                "warm_keys": {
                    "memory": [
                        key_from_program_key(k)
                        for k in self._programs
                    ],
                    "disk": (
                        self.progcache.entry_keys()
                        if self.progcache is not None else []
                    ),
                },
                "fallbacks": dict(self.fallbacks),
                "progcache": (
                    self.progcache.stats()
                    if self.progcache is not None
                    else {"enabled": False}
                ),
                # Every capability verdict asked for (single-device +
                # sharded): a replica serving lane loops is visible here.
                "vmap_probes": (
                    ensemble.probe_results() + ens_sharded.probe_results()
                ),
            }

    # ---- execution ----

    def lane_health(
        self, result: ensemble.EnsembleResult
    ) -> List[Optional[str]]:
        """Per-lane watchdog verdicts: None = healthy, else the error
        string for that lane's response.  The guarded-amax reduction maps
        NaN/Inf to +inf (run/health.py), so a poisoned lane trips without
        touching its batchmates."""
        if not self.watchdog:
            return [None] * len(result.results)
        with tracing.span("serve.watchdog", lanes=len(result.results)) as sp:
            n = len(result.results)
            if result.u_prev_batch is not None:
                # One reduction per batched array (per shard block of a
                # sharded batch): B scalars to the host each.
                amaxes = []
                for batch in (result.u_prev_batch, result.u_cur_batch):
                    blocks = (batch if isinstance(batch, (list, tuple))
                              else [batch])
                    per_block = [health.guarded_amax_per_lane(b)[:n]
                                 for b in blocks]
                    amaxes.append([max(v) for v in zip(*per_block)])
            else:
                amaxes = [[health.guarded_amax(getattr(r, name))
                           for r in result.results]
                          for name in ("u_prev", "u_cur")]
            out = []
            for amax in map(max, zip(*amaxes)):
                amax = float(amax)
                if health.healthy(amax, self.max_amp):
                    out.append(None)
                else:
                    bound = (health.DEFAULT_AMP_BOUND
                             if self.max_amp is None else self.max_amp)
                    out.append(
                        f"numerical-health trip: guarded amax {amax:g} "
                        f"exceeds bound {bound:g} (NaN/Inf count as inf)"
                    )
            sp["tripped"] = sum(1 for o in out if o is not None)
        return out

    def solve(
        self, problem: Problem, lanes: Sequence[ensemble.LaneSpec],
        scheme: str = "standard", path: str = "roll", k: int = 4,
        dtype_name: str = "f32",
        mesh: Optional[Tuple[int, int, int]] = None,
        timing: Optional[dict] = None,
        feed_breaker: bool = True,
        probes: Optional[Sequence[Optional[list]]] = None,
    ) -> Tuple[ensemble.EnsembleResult, List[Optional[str]]]:
        """Pad to the bucket, run the cached solver (or the recorded
        fallback), watchdog each lane, release the batch's states;
        returns (EnsembleResult, per-lane health) - each lane's
        SolveResult keeps its error vectors and timings, its u_prev /
        u_cur are None.  `timing`, when a dict is passed, is filled with
        `compile_seconds` (this call's cache-miss build, 0.0 warm) and
        `warm` ("true"/"false"/"disk"/"fallback") for the Server-Timing
        header.  `feed_breaker=False` (a batch of only shadow lanes,
        serve/shadow.py) neither consults nor feeds the circuit
        breaker.  `probes`, one entry per lane (a list of [i, j, k] held
        nodes, or None), fills `EnsembleResult.digests` with each asking
        lane's `final_digests` before the states are released (a single-
        device batch's: the scheduler refuses probes on a mesh)."""
        lanes = list(lanes)
        with_field = any(lane.c2tau2_field is not None for lane in lanes)
        compute_errors = self.compute_errors and not with_field
        bucket = self.bucket_for(len(lanes))
        # Circuit breaker: an open key sheds HERE (fast QuarantinedError,
        # HTTP 503 + Retry-After) before any build or device work.  Per-
        # lane watchdog trips are CLIENT errors and never feed it.
        bkey = None
        if self.breaker is not None and feed_breaker:
            bkey = self.breaker_key(
                problem, scheme, path, k, dtype_name, with_field, mesh
            )
            self.breaker.admit(bkey)
        try:
            with self._device_scope():
                prog, source, compile_seconds = self._program(
                    problem, scheme, path, k, dtype_name, with_field,
                    bucket, mesh
                )
                warm = prog is not None and source == "memory"
                warm_label = ("fallback" if prog is None
                              else "true" if warm
                              else "disk" if source == "disk" else "false")
                if timing is not None:
                    timing["compile_seconds"] = compile_seconds
                    timing["warm"] = warm_label
                with tracing.span(
                    "serve.execute", scheme=scheme, path=path,
                    occupancy=len(lanes), bucket=bucket, warm=warm,
                ) as sp:
                    fl0 = stencil_cuda.first_launch_seconds
                    result = self._execute(
                        problem, lanes, scheme, path, k, dtype_name, mesh,
                        compute_errors, bucket, prog)
                    if timing is not None:
                        # CUDA loads a template instantiation at its
                        # first launch: that host time is the program's
                        # compile, not its march (only this thread
                        # launches, so the difference is this batch's).
                        timing["compile_seconds"] += (
                            stencil_cuda.first_launch_seconds - fl0)
                    sp["batched"] = result.batched
                    self._record_roofline(sp, problem, result, scheme, k,
                                          dtype_name, with_field)
        except QuarantinedError:
            raise
        except Exception as e:
            if self.breaker is not None and bkey is not None:
                self.breaker.record_failure(bkey, e)
            raise
        if self.breaker is not None and bkey is not None:
            self.breaker.record_success(bkey)
        self._h_execute.observe(result.solve_seconds, warm=warm_label)
        if not result.batched and result.fallback_reason:
            self.fallbacks.setdefault(
                f"{scheme}:{result.path}", result.fallback_reason
            )
        # Chaos seam: execute-NaN poisons the batch's final state AFTER
        # the solve - the per-lane watchdog below must catch it (422s),
        # exactly as it would a real device fault.
        if self.fault_plan is not None and self.fault_plan.fire(
            "execute-nan", n=problem.N, timesteps=problem.timesteps,
            scheme=scheme, path=path, k=k, dtype=dtype_name,
        ):
            _poison_states(result)
        verdicts = self.lane_health(result)
        if probes is not None and any(p is not None for p in probes):
            asked = sum(len(p) for p in probes if p is not None)
            with tracing.span("serve.digest", lanes=len(lanes),
                              probes=asked):
                result.digests = final_digests(
                    result.u_prev_batch, result.u_cur_batch, probes)
            # Registered at the first digest: wavetpu's replica has no
            # probes, and until a request asks for them the exposition
            # holds wavetpu's metric families and no other.
            self.registry.counter(
                "wavetpu_serve_probes_total",
                "probe nodes answered in /solve reports (final-state "
                "digests)",
            ).inc(asked)
        _release_states(result, keep_u_cur=self.keep_final_state)
        # Accuracy observatory: every HEALTHY lane that computed oracle
        # errors appends one accuracy-ledger line (obs/accuracy.py).
        # Guarded: the X-ray must never fail the batch it measures.
        if compute_errors:
            try:
                accuracy.observe_serve_batch(
                    result, verdicts, scheme=scheme, k=k,
                    dtype=dtype_name, registry=self.registry,
                )
            except Exception:
                pass
        return result, verdicts

    def _execute(self, problem, lanes, scheme, path, k, dtype_name, mesh,
                 compute_errors, bucket, prog):
        pad_to = bucket if prog is not None else None
        if mesh is not None:
            return ens_sharded.solve_ensemble_sharded(
                problem, lanes, mesh_shape=mesh,
                dtype=self._dtype(dtype_name), kernel=path,
                compute_errors=compute_errors,
                devices=self.mesh_devices(mesh), pad_to=pad_to, solver=prog,
            )
        return ensemble.solve_ensemble(
            problem, lanes, dtype=self._dtype(dtype_name), scheme=scheme,
            path=path, k=k, compute_errors=compute_errors,
            block_x=self.block_x, pad_to=pad_to, solver=prog,
            device=self.device,
        )

    def _record_roofline(self, sp, problem, result, scheme, k, dtype_name,
                         with_field) -> None:
        """Roofline attribution of the batch (padding lanes stream bytes
        too) on the serve.execute span and the registry, and a device
        memory sample.  Guarded: an X-ray bug must never fail the batch
        (an exception here would even feed the circuit breaker)."""
        try:
            steps = max((r.steps_computed or problem.timesteps
                         for r in result.results),
                        default=problem.timesteps)
            prog_gcells = (
                problem.cells_per_step * result.batch_size * steps
                / result.solve_seconds / 1e9
                if result.solve_seconds else 0.0
            )
            rf = perf.record_roofline(
                self.registry, result.path, perf.solve_perf(
                    prog_gcells, result.path, scheme=scheme, k=k,
                    n=problem.N,
                    itemsize=perf.DTYPE_ITEMSIZE.get(dtype_name, 4),
                    with_field=with_field,
                ),
            )
            if rf is not None:
                sp["model_bytes_per_cell"] = rf["model_bytes_per_cell"]
                sp["model_gbps"] = rf["model_gbps"]
                sp["roofline_fraction"] = rf["roofline_fraction"]
            perf.record_memory(self.registry, context="serve")
        except Exception:
            pass


def final_digests(u_prev: torch.Tensor, u_cur: torch.Tensor,
                  probes: Sequence[Optional[list]]) -> List[Optional[dict]]:
    """The digest of each asking lane's final state, as /solve reports it.

    `u_prev` / `u_cur` are a batch's (B, N, N, N) last two layers, lane i
    of `probes` at index i (padding lanes past `len(probes)` are never
    read); `probes[i]` is a list of [i, j, k] held nodes, or None for a
    lane that asked for nothing.  Lane i's digest is {"final_probes":
    [[u_last, u_before] at each node], "final_rms": the root mean square
    of u_last over all N^3 held nodes, its squares summed in float64}.

    One gather and one reduction over the asking lanes and one copy to
    the host: the reduction sums each lane's (N, N) planes on the device
    and the last N partial sums with `math.fsum` on the host, so a lane's
    digest does not depend on its batchmates (a lane reads the digest of
    its solo solve bit for bit)."""
    asking = [i for i, p in enumerate(probes) if p is not None]
    out: List[Optional[dict]] = [None] * len(probes)
    if not asking:
        return out
    dev, n = u_cur.device, u_cur.shape[-1]
    nodes = [(lane, *node) for lane in asking for node in probes[lane]]
    at = tuple(torch.tensor(c, dtype=torch.long, device=dev)
               for c in zip(*nodes)) if nodes else None
    rows = (u_cur[:len(asking)] if asking == list(range(len(asking)))
            else u_cur.index_select(0, torch.tensor(asking, device=dev)))
    planes = rows.to(torch.float64).square_().sum(-1).sum(-1)
    parts = [planes.reshape(-1)]
    if at is not None:
        parts = [u_cur[at].to(torch.float64), u_prev[at].to(torch.float64),
                 *parts]
    host = torch.cat(parts).cpu().tolist()
    k = len(nodes)
    last, before, sums = host[:k], host[k:2 * k], host[2 * k:]
    cursor = 0
    for row, lane in enumerate(asking):
        m = len(probes[lane])
        out[lane] = {
            "final_probes": [[last[cursor + q], before[cursor + q]]
                             for q in range(m)],
            "final_rms": math.sqrt(
                math.fsum(sums[row * n:(row + 1) * n]) / n ** 3),
        }
        cursor += m
    return out


def _poison_states(result: ensemble.EnsembleResult) -> None:
    """The execute-nan seam: every lane's final state NaN."""
    def nan_like(t):
        return torch.full_like(t, float("nan"))

    if result.u_cur_batch is not None:
        batch = result.u_cur_batch
        result.u_cur_batch = ([nan_like(b) for b in batch]
                              if isinstance(batch, (list, tuple))
                              else nan_like(batch))
        return
    for r in result.results:
        blocks = getattr(r.u_cur, "blocks", None)
        r.u_cur = (nan_like(r.u_cur) if blocks is None else
                   type(r.u_cur)([nan_like(b) for b in blocks],
                                 r.u_cur.topo, r.u_cur.mesh))


def _release_states(result: ensemble.EnsembleResult,
                    keep_u_cur: bool = False) -> None:
    """Drop every reference the result holds to the batch's states, so
    the card's memory is free for the next batch; `keep_u_cur` keeps a
    copy of each lane's final layer of its own (never a view that would
    hold the whole batch)."""
    result.u_prev_batch = result.u_cur_batch = None
    for r in result.results:
        kept = None
        if keep_u_cur and r.u_cur is not None:
            u = r.u_cur
            kept = (u.fundamental(u.blocks[0].device)
                    if hasattr(u, "blocks") else u.clone())
        r.u_prev = None
        r.u_cur = kept
        r.comp_v = r.comp_carry = None
