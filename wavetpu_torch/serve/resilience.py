"""Request-path resilience primitives: typed failures + circuit breaker
(the port's copy of wavetpu/serve/resilience.py).

run/supervisor.py makes *solves* survive faults (checkpoint rotation,
watchdog); this module is the serve-stack half of that contract.  The
scheduler, engine, and HTTP layer share a small failure taxonomy so a
client can tell "retry me" from "your fault" from "too late":

 * `DeadlineExceededError`  -> HTTP 504.  The request's `deadline_ms`
   budget expired (in queue, or while the batch was in flight).  Carries
   `queue_s` when the scheduler dropped it before execution, so the 504
   attributes WHERE the budget went.
 * `WorkerCrashError`       -> HTTP 503 + `Retry-After`.  The scheduler
   worker died mid-batch and was restarted by its supervisor; the
   request itself is fine - retry it.
 * `QuarantinedError`       -> HTTP 503 + `Retry-After`.  The request's
   ProgramKey is circuit-broken (K consecutive compile/execute
   failures); `retry_after_s` is the remaining cooldown.
 * `PreemptedError`         -> HTTP 503 + `Retry-After` + resume_token.
   A chunked long solve was checkpointed mid-march (drain/roll); the
   token resumes it on any replica sharing `--solve-state-dir`
   (serve/preempt.py).
 * `InvalidStateTokenError` -> HTTP 422.  A `resume_token` failed
   verification (bad format, missing/corrupt/expired file, or identity
   mismatch with the request) - the client's fault, never retriable.
 * `ShedError`              -> HTTP 503 + `Retry-After`.  The brownout
   ladder (serve/scheduler.py BrownoutController) refused the request's
   priority class while queue-wait p95 is over threshold;
   `retry_after_s` is the measured queue-drain estimate, not a
   constant.

`CircuitBreaker` quarantines per program identity (the ProgramKey minus
its batch bucket - one poisoned tier is ONE breaker however it
batches).  Classic three-state machine:

    closed --K consecutive failures--> open --cooldown--> half_open
    half_open --probe success--> closed;  --probe failure--> open

While open, `admit()` sheds every request for the key with a fast
`QuarantinedError` instead of letting each one re-pay the failing
compile (and stall the single scheduler worker for everyone else's
batches).  After `cooldown_s` the next request through is the half-open
PROBE: its success closes the breaker, its failure re-opens the clock.
State is visible in both /metrics views (JSON `breaker` block;
Prometheus `wavetpu_serve_breaker_*`).

Imports neither torch nor numpy (same before-the-backend discipline as
obs/registry.py).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple


class DeadlineExceededError(RuntimeError):
    """The request's deadline budget expired before a result existed.
    `queue_s` (when set) is the time the request spent queued - the
    scheduler dropped it before batching rather than marching work
    nobody is waiting for."""

    def __init__(self, message: str, queue_s: Optional[float] = None,
                 resume_token: Optional[str] = None):
        super().__init__(message)
        self.queue_s = queue_s
        # Chunked long solves checkpoint on deadline expiry; the 504
        # carries this token so the client can resume instead of
        # restarting from layer 0 (serve/preempt.py).
        self.resume_token = resume_token


class WorkerCrashError(RuntimeError):
    """The scheduler worker crashed while this request was in flight.
    The supervisor restarted the worker; the request is RETRIABLE -
    mapped to 503 + Retry-After, never a hang."""


class PreemptedError(RuntimeError):
    """A chunked long solve was checkpointed and preempted before
    completion (replica drain / rolling deploy).  RETRIABLE: mapped to
    503 + Retry-After with `resume_token` in the body, so the retry -
    on this replica or any other sharing `--solve-state-dir` - resumes
    from the last completed chunk instead of layer 0."""

    def __init__(self, message: str, resume_token: Optional[str] = None,
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.resume_token = resume_token
        self.retry_after_s = retry_after_s


class InvalidStateTokenError(ValueError):
    """A `resume_token` failed verification: malformed token, missing or
    corrupt checkpoint file (content hash mismatch), expired entry, or
    an identity that does not match the request.  Client error (422),
    never a traceback and never retriable."""


class ShedError(RuntimeError):
    """The brownout ladder shed this request at admission: queue-wait
    p95 is over a rung threshold and the request's priority class is at
    or below the rung being shed.  RETRIABLE (503 + Retry-After) - the
    replica is overloaded, not broken.  `retry_after_s` is the MEASURED
    queue-drain estimate (`ServeMetrics.retry_after_s`), so the client
    backs off exactly as long as the backlog says, and `rung` names the
    ladder step that fired (docs/robustness.md "Brownout ladder")."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 rung: str = ""):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.rung = rung


class QuarantinedError(RuntimeError):
    """The request's program key is circuit-broken.  `retry_after_s` is
    the remaining cooldown before the half-open probe - the value the
    503's Retry-After header carries."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class CircuitBreaker:
    """Per-key three-state breaker (closed/open/half_open).

    Thread-safe; the serve layer calls `admit(key)` before touching the
    program cache, then exactly one of `record_failure` /
    `record_success` per admitted solve.  Keys are hashable tuples (the
    engine uses ProgramKey with batch=0 so every bucket of a tier
    shares one breaker).  Failure counting is CONSECUTIVE: any success
    resets the count, so a tier that fails intermittently under load
    never quarantines - only a key that fails `threshold` times in a
    row with no success between them.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 registry=None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        # key -> {state, consecutive_failures, opened_at, opens,
        #         last_error}
        self._keys: Dict[Tuple, dict] = {}
        self._c_events = None
        self._g_open = None
        if registry is not None:
            self._c_events = registry.counter(
                "wavetpu_serve_breaker_events_total",
                "circuit-breaker transitions and sheds", ("event",),
            )
            self._g_open = registry.gauge(
                "wavetpu_serve_breaker_open",
                "program keys currently quarantined (open or half-open)",
            )

    def _event(self, name: str) -> None:
        if self._c_events is not None:
            self._c_events.inc(event=name)

    def _set_open_gauge(self) -> None:
        if self._g_open is not None:
            self._g_open.set(sum(
                1 for st in self._keys.values()
                if st["state"] != "closed"
            ))

    def admit(self, key: Tuple) -> None:
        """Raise `QuarantinedError` when `key` is open and still cooling
        down; transition open -> half_open (admitting THIS call as the
        probe) once the cooldown has elapsed.  Closed keys pass free."""
        with self._lock:
            st = self._keys.get(key)
            if st is None or st["state"] == "closed":
                return
            if st["state"] == "open":
                elapsed = time.monotonic() - st["opened_at"]
                remaining = self.cooldown_s - elapsed
                if remaining > 0:
                    self._event("shed")
                    raise QuarantinedError(
                        f"program {self.describe(key)} is quarantined "
                        f"({st['consecutive_failures']} consecutive "
                        f"failures; last: {st['last_error']}); half-open "
                        f"probe in {remaining:.1f}s",
                        retry_after_s=remaining,
                    )
                st["state"] = "half_open"
                self._event("half_open")
            # half_open: this call is the probe (single scheduler
            # worker, so concurrent probes are a warmup-thread edge we
            # accept - both report into record_*).

    def record_failure(self, key: Tuple, error: BaseException) -> None:
        with self._lock:
            st = self._keys.setdefault(key, {
                "state": "closed", "consecutive_failures": 0,
                "opened_at": 0.0, "opens": 0, "last_error": "",
            })
            st["consecutive_failures"] += 1
            st["last_error"] = str(error)[:200]
            trip = (
                st["state"] == "half_open"  # failed probe re-opens
                or st["consecutive_failures"] >= self.threshold
            )
            if trip:
                if st["state"] != "open":
                    st["opens"] += 1
                    self._event("open")
                st["state"] = "open"
                st["opened_at"] = time.monotonic()
                self._set_open_gauge()

    def record_success(self, key: Tuple) -> None:
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                return
            if st["state"] != "closed":
                self._event("close")
            st["state"] = "closed"
            st["consecutive_failures"] = 0
            st["last_error"] = ""
            self._set_open_gauge()

    @staticmethod
    def describe(key: Tuple) -> str:
        """A short human-readable key label for error strings and the
        JSON /metrics view (works for ProgramKey and plain tuples)."""
        fields = getattr(key, "_asdict", None)
        if fields is not None:
            d = fields()
            parts = [f"N={d.get('N')}", f"steps={d.get('timesteps')}",
                     f"{d.get('scheme')}:{d.get('path')}"]
            if d.get("k", 1) and d.get("k", 1) > 1:
                parts.append(f"k={d['k']}")
            if d.get("mesh"):
                parts.append(f"mesh={d['mesh']}")
            return "/".join(str(p) for p in parts)
        return repr(key)

    def snapshot(self) -> dict:
        """The JSON /metrics `breaker` block: config + every non-closed
        (or previously-tripped) key's state."""
        with self._lock:
            keys: List[dict] = []
            n_open = 0
            now = time.monotonic()
            for key, st in self._keys.items():
                if st["state"] == "closed" and st["opens"] == 0:
                    continue  # never tripped: noise, not signal
                if st["state"] != "closed":
                    n_open += 1
                row = {
                    "key": self.describe(key),
                    "state": st["state"],
                    "consecutive_failures": st["consecutive_failures"],
                    "opens": st["opens"],
                    "last_error": st["last_error"] or None,
                }
                if st["state"] == "open":
                    row["retry_after_s"] = round(max(
                        0.0, self.cooldown_s - (now - st["opened_at"])
                    ), 3)
                keys.append(row)
            return {
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s,
                "open": n_open,
                "keys": keys,
            }
