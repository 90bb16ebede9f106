"""Dynamic batching: coalesce concurrent solve requests into ensembles
(the port of wavetpu/serve/scheduler.py).

The request path is the standard inference-serving shape (arXiv:2108.11076
batches simulations the same way an LLM server batches prompts):

 * `submit()` enqueues a `SolveRequest` and returns a future immediately
   (the HTTP handler thread blocks on it; the server stays concurrent).
 * One worker thread drains the queue.  Requests are SHAPE-BUCKETED by
   `SolveRequest.bucket_key()` - everything the compiled program identity
   depends on (problem geometry, scheme, kernel path, k, dtype, field
   presence) - because only same-key requests can share a program.
 * A batch closes when it reaches `max_batch` lanes or `max_wait` seconds
   after its first request - the classic max-batch/max-wait tradeoff
   (batch occupancy vs tail latency).  Non-matching requests seen while
   collecting are stashed and served next round in arrival order.
 * The engine pads the batch to its bucket with masked lanes, runs the
   cached program, watchdogs each lane; every future resolves with ITS
   lane's result (or per-lane health error) plus batch context.

Multi-tenant QoS (docs/serving.md "Priority classes"): every request
carries a `priority` class (interactive | batch | best_effort).  The
stash is one deque PER CLASS, drained by weighted deficit round-robin
(`CLASS_WEIGHTS` 16:4:1): each worker pass credits every backlogged
class its weight, serves the largest deficit (ties go to the higher
static class), and debits the winner the round's total credit - so an
eligible interactive request takes the NEXT pass ahead of a lower-class
chunked march's next chunk slot (the one-chunk-per-pass machinery makes
preemption a dequeue-ordering decision), while the deficit counter
guarantees best_effort is served within ~sum(weights)/1 passes however
hard interactive floods (the starvation bound tests/test_qos.py pins).
With a single backlogged class the deficits stay zeroed and scheduling
is exactly the historical FIFO - the QoS-off fast path.

`BrownoutController` is the adaptive overload ladder: when measured
queue-wait p95 crosses its rung thresholds the batcher sheds
best_effort admissions first, then batch, then defers NEW chunked-march
starts - and de-escalates only after a hysteresis-gated cooldown so the
ladder never flaps.  Shed responses are 503 + a MEASURED Retry-After
(`ServeMetrics.retry_after_s`, the queue-drain estimate that also
replaced the hardcoded queue-full/draining constants).

`ServeMetrics` is the shared counter block /metrics renders: request and
batch counts, occupancy, latency percentiles over a sliding reservoir,
and aggregate Gcell/s across all served lanes.  Since the unified-
telemetry round it WRITES THROUGH an `obs.registry.MetricsRegistry`
(one per server, so test servers never share counters): the JSON
snapshot keeps its exact historical fields while the same state renders
as Prometheus text exposition under `Accept: text/plain`, and every
batch emits a `serve.batch` span (occupancy, padding waste, queue
waits, request ids) into the structured trace when `--telemetry-dir`
is on.

The worker thread is the only thread that launches kernels: the engine
it drives passes its device explicitly.  A chunked long solve's march
state (serve/preempt.py) stays on the card between its rounds; it is
freed when the request's future resolves (completion, a resume token, a
watchdog trip, a failure), and `chunk_state_bytes` says how much of the
allocator's live bytes (/healthz `memory_bytes_in_use`) the marches hold.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble.batched import LaneSpec
from wavetpu_torch.obs import ledger as compile_ledger
from wavetpu_torch.obs import tracing
from wavetpu_torch.obs.registry import MetricsRegistry
from wavetpu_torch.obs.report import percentile_nearest_rank
from wavetpu_torch.run import faults, health
from wavetpu_torch.serve.resilience import (
    DeadlineExceededError,
    InvalidStateTokenError,
    PreemptedError,
    ShedError,
    WorkerCrashError,
)

# Priority classes, highest static priority first.  The order IS the
# deficit tie-break and the brownout shed order (best_effort sheds
# first).  CLASS_WEIGHTS drive the deficit round-robin: under a
# two-class backlog the service ratio converges to the weight ratio,
# and the lowest class is served at least once per ~sum(weights)
# worker passes - the starvation bound.
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")
CLASS_WEIGHTS = {"interactive": 16, "batch": 4, "best_effort": 1}
DEFAULT_PRIORITY = "batch"


def normalize_priority(value, default: str = DEFAULT_PRIORITY) -> str:
    """Clamp any caller-supplied priority to a known class (unknown or
    absent values land on `default`, never an error - priority is a
    scheduling hint, not a validation surface)."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in PRIORITY_CLASSES:
            return v
    return default


class QueueFullError(RuntimeError):
    """`submit()` refused: the bounded request queue is at capacity.
    The HTTP layer maps this to 429 (backpressure, not failure)."""


@dataclasses.dataclass
class SolveRequest:
    """One lane's worth of work plus its program identity.

    `mesh_shape` routes the request through the sharded x batched
    composition (ensemble/sharded.py); only same-mesh requests share a
    program."""

    problem: Problem
    lane: LaneSpec
    scheme: str = "standard"
    path: str = "roll"
    k: int = 1
    dtype_name: str = "f32"
    mesh_shape: Optional[Tuple[int, int, int]] = None
    # Preemptible long solves: continue a previously-checkpointed march
    # (serve/preempt.py state token).  NOT part of bucket_key - a
    # resumed solve never batches anyway (chunked items get unique
    # keys).
    resume_token: Optional[str] = None
    # Tenant label the router stamped (X-Wavetpu-Tenant); rides into
    # spans, per-tenant counters, and ledger lines.  Never part of the
    # program identity.
    tenant: Optional[str] = None
    # QoS class (PRIORITY_CLASSES member; submit() normalizes unknown
    # values to "batch").  Drives the per-class deficit round-robin and
    # the brownout shed order - never the program identity, so classes
    # still coalesce into one batch when their keys match.
    priority: str = DEFAULT_PRIORITY
    # Shadow-solve sampling (serve/shadow.py): True marks the off-hot-
    # path reference twin of a sampled production request.  Never part
    # of the program identity - a shadow coalesces into a production
    # batch of the same key (a free ride) - but a batch of ONLY
    # shadows runs with the circuit breaker bypassed.
    shadow: bool = False
    # Final-state probes ([i, j, k] held nodes; None = none asked): the
    # engine gathers them into the lane's digest (`final_probes`,
    # `final_rms`).  Never part of the program identity or the lane, so
    # requests with different probes still share one program and batch.
    probes: Optional[List[List[int]]] = None

    def bucket_key(self) -> Tuple:
        """Everything the compiled program identity depends on; only
        same-key requests may share a batch."""
        p = self.problem
        return (
            p.N, p.Lx, p.Ly, p.Lz, p.T, p.timesteps,
            self.scheme, self.path,
            self.k if self.path == "kfused" else 1,
            self.dtype_name,
            self.lane.c2tau2_field is not None,
            None if self.mesh_shape is None else tuple(self.mesh_shape),
        )


_LATENCY_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0,
)
_OCCUPANCY_BUCKETS = (1, 2, 4, 8, 16, 32)


class ServeMetrics:
    """Thread-safe counters for /metrics (shared by scheduler + api).

    All state lives in an `obs.registry.MetricsRegistry` (own one by
    default; `build_server` passes a shared per-server registry so the
    engine's program-cache counters land in the same Prometheus
    exposition).  `snapshot()` takes the REGISTRY lock across the whole
    read - including the exact-percentile latency reservoir, which is
    guarded by the same lock - so a scrape is one consistent cut and can
    never see, e.g., `responses_ok` ahead of `requests_total` or a torn
    occupancy mean.  (The pre-registry ServeMetrics held its own lock in
    snapshot() but each observe_* released it between related fields;
    one registry-wide lock closes that audit for good.)
    """

    def __init__(self, latency_window: int = 1024,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.started = time.time()
        r = self.registry
        self._requests = r.counter(
            "wavetpu_serve_requests_total", "solve requests accepted"
        )
        self._responses = r.counter(
            "wavetpu_serve_responses_total", "responses by outcome",
            ("status",),
        )
        self._rejected = r.counter(
            "wavetpu_serve_rejected_total",
            "requests rejected with 429 (bounded queue full)",
        )
        self._limit_rejected = r.counter(
            "wavetpu_serve_limit_rejected_total",
            "requests refused by request-size limits before scheduling "
            "(413 body bytes, 422 lane cells)", ("limit",),
        )
        self._batches = r.counter(
            "wavetpu_serve_batches_total", "batches executed"
        )
        self._occupancy = r.histogram(
            "wavetpu_serve_batch_occupancy", "real lanes per batch",
            buckets=_OCCUPANCY_BUCKETS,
        )
        self._occupancy_max = r.gauge(
            "wavetpu_serve_batch_occupancy_max",
            "largest batch occupancy seen",
        )
        self._padding = r.counter(
            "wavetpu_serve_padding_lanes_total",
            "masked padding lanes marched (bucket size - occupancy)",
        )
        self._fallbacks = r.counter(
            "wavetpu_serve_fallback_batches_total",
            "batches served by the lane-loop fallback",
        )
        self._cells = r.counter(
            "wavetpu_serve_cells_total", "cell updates served"
        )
        self._solve_seconds = r.counter(
            "wavetpu_serve_solve_seconds_total", "batch solve wall seconds"
        )
        self._latency = r.histogram(
            "wavetpu_serve_request_seconds",
            "end-to-end request latency", buckets=_LATENCY_BUCKETS,
        )
        self._queue_wait = r.histogram(
            "wavetpu_serve_queue_wait_seconds",
            "submit-to-batch-formed wait", buckets=_LATENCY_BUCKETS,
        )
        self._queue_depth = r.gauge(
            "wavetpu_serve_queue_depth",
            "requests submitted but not yet executing",
        )
        self._last_batch_ts = r.gauge(
            "wavetpu_serve_last_batch_timestamp",
            "unix time the last batch finished (0 = none yet)",
        )
        self._deadline_expired = r.counter(
            "wavetpu_serve_deadline_expired_total",
            "requests dropped because their deadline_ms budget expired "
            "before execution (HTTP 504)",
        )
        self._worker_restarts = r.counter(
            "wavetpu_serve_worker_restarts_total",
            "scheduler-worker crashes absorbed by the supervisor "
            "(in-flight futures failed retriable, worker restarted)",
        )
        # Preemptible long solves (serve/preempt.py).
        self._chunks = r.counter(
            "wavetpu_serve_chunks_total",
            "chunks marched by preemptible long solves",
        )
        self._preempted = r.counter(
            "wavetpu_serve_preempted_total",
            "long solves checkpointed/aborted mid-march by reason "
            "(deadline = 504 + token, drain = retriable 503 + token)",
            ("reason",),
        )
        self._resumes = r.counter(
            "wavetpu_serve_resumes_total",
            "long-solve resumptions by source (token = client-supplied "
            "resume_token, crash = in-memory re-enqueue after a worker "
            "crash)",
            ("source",),
        )
        self._tenant_requests = r.counter(
            "wavetpu_serve_tenant_requests_total",
            "solve requests by router-stamped tenant label",
            ("tenant",),
        )
        self._inflight_chunks = r.gauge(
            "wavetpu_serve_inflight_chunk_marches",
            "chunked long solves currently mid-march (march state "
            "held between scheduler rounds; survives worker crashes)",
        )
        # Multi-tenant QoS (docs/serving.md "Priority classes").
        self._class_requests = r.counter(
            "wavetpu_serve_class_requests_total",
            "solve requests admitted by priority class",
            ("class",),
        )
        self._scheduled = r.counter(
            "wavetpu_serve_scheduled_total",
            "requests scheduled onto a worker pass by priority class "
            "(deficit round-robin picks)",
            ("class",),
        )
        self._shed = r.counter(
            "wavetpu_serve_shed_total",
            "admissions refused by the brownout ladder, by rung and "
            "priority class (503 + measured Retry-After)",
            ("rung", "class"),
        )
        self._tenant_shed = r.counter(
            "wavetpu_serve_tenant_shed_total",
            "brownout sheds by router-stamped tenant label",
            ("tenant",),
        )
        self._brownout_rung = r.gauge(
            "wavetpu_serve_brownout_rung",
            "current brownout ladder rung (0 healthy, 1 shedding "
            "best_effort, 2 shedding batch too, 3 deferring chunk "
            "starts)",
        )
        self._chunk_deferred = r.counter(
            "wavetpu_serve_chunk_starts_deferred_total",
            "worker passes that deferred starting a NEW chunked march "
            "because the brownout ladder is at its top rung",
        )
        self._tenant_inflight_rejected = r.counter(
            "wavetpu_serve_tenant_inflight_rejected_total",
            "requests refused by the per-tenant in-flight cap "
            "(--tenant-inflight-cap; 429 + measured Retry-After)",
            ("tenant",),
        )
        self._tenant_spoof_rejected = r.counter(
            "wavetpu_serve_tenant_spoof_rejected_total",
            "direct-to-replica requests whose tenant/priority headers "
            "were IGNORED for lack of the --proxy-token secret "
            "(request still served, untenanted)",
        )
        self._coalesced = r.counter(
            "wavetpu_serve_coalesced_total",
            "requests that rode an identical in-flight solve via "
            "singleflight coalescing instead of enqueueing their own "
            "march (each still counted/charged as a request)",
        )
        # Drain-rate estimator behind `retry_after_s`: (monotonic end
        # time, lanes completed) per batch, guarded by the registry
        # lock like everything else here.
        self._drained: "deque[Tuple[float, int]]" = deque(maxlen=64)
        # Exact-percentile reservoir for the JSON snapshot's historical
        # latency_p50/p95_ms fields (the histogram above serves
        # Prometheus); guarded by the REGISTRY lock so snapshot() is one
        # consistent cut.
        self._latencies = deque(maxlen=latency_window)

    def observe_request(self) -> None:
        self._requests.inc()

    def observe_rejected(self) -> None:
        self._rejected.inc()

    def observe_limit_rejected(self, limit: str) -> None:
        """A request refused by `--max-body-bytes` (limit="body_bytes")
        or `--max-lane-cells` (limit="lane_cells") before it ever
        touched the queue."""
        self._limit_rejected.inc(limit=limit)

    def observe_response(self, ok: bool) -> None:
        self._responses.inc(status="ok" if ok else "error")

    def observe_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(depth)

    def observe_deadline_expired(self) -> None:
        self._deadline_expired.inc()

    def observe_worker_restart(self) -> None:
        self._worker_restarts.inc()

    def observe_chunk(self) -> None:
        self._chunks.inc()

    def observe_chunk_march_started(self) -> None:
        self._inflight_chunks.inc()

    def observe_chunk_march_ended(self) -> None:
        self._inflight_chunks.dec()

    def observe_preempted(self, reason: str) -> None:
        self._preempted.inc(reason=reason)

    def observe_resume(self, source: str) -> None:
        self._resumes.inc(source=source)

    def observe_tenant(self, tenant: Optional[str]) -> None:
        if tenant:
            self._tenant_requests.inc(tenant=tenant)

    def observe_class_request(self, priority: str) -> None:
        self._class_requests.inc(**{"class": priority})

    def observe_scheduled(self, priority: str) -> None:
        self._scheduled.inc(**{"class": priority})

    def observe_shed(self, rung: str, priority: str,
                     tenant: Optional[str] = None) -> None:
        self._shed.inc(**{"rung": rung, "class": priority})
        if tenant:
            self._tenant_shed.inc(tenant=tenant)

    def observe_brownout_rung(self, rung: int) -> None:
        self._brownout_rung.set(rung)

    def observe_chunk_start_deferred(self) -> None:
        self._chunk_deferred.inc()

    def observe_tenant_inflight_rejected(self, tenant: str) -> None:
        self._tenant_inflight_rejected.inc(tenant=tenant)

    def observe_tenant_spoof_rejected(self) -> None:
        self._tenant_spoof_rejected.inc()

    def observe_coalesced(self) -> None:
        self._coalesced.inc()

    def retry_after_s(self, pending: int, fallback: float = 1.0) -> float:
        """MEASURED backoff hint for 429/503 responses: how long until
        `pending` queued lanes drain at the recently observed service
        rate (lanes completed per second over the last minute of
        batches), clamped to [1, 60] seconds.  `fallback` (the
        historical constant for the call site) is returned when no
        batch has completed recently - a cold or idle server has no
        rate to measure, and a fixed small hint beats a wild guess."""
        now = time.monotonic()
        with self.registry.lock:
            samples = [s for s in self._drained if now - s[0] <= 60.0]
        if len(samples) < 2:
            return fallback
        span = now - samples[0][0]
        lanes = sum(n for _, n in samples[1:])
        if span <= 0.0 or lanes <= 0:
            return fallback
        rate = lanes / span
        return min(60.0, max(1.0, (pending + 1) / rate))

    def observe_batch(self, occupancy: int, batched: bool,
                      cells: float, solve_seconds: float,
                      batch_size: Optional[int] = None,
                      queue_waits: Sequence[float] = (),
                      request_ids: Sequence[Optional[str]] = ()) -> None:
        with self.registry.lock:
            self._batches.inc()
            self._occupancy.observe(occupancy)
            if occupancy > self._occupancy_max.value():
                self._occupancy_max.set(occupancy)
            if batch_size is not None and batch_size > occupancy:
                self._padding.inc(batch_size - occupancy)
            if not batched:
                self._fallbacks.inc()
            self._cells.inc(cells)
            self._solve_seconds.inc(solve_seconds)
            self._last_batch_ts.set(time.time())
            self._drained.append((time.monotonic(), occupancy))
            for i, w in enumerate(queue_waits):
                rid = request_ids[i] if i < len(request_ids) else None
                self._queue_wait.observe(
                    w,
                    exemplar={"request_id": rid} if rid else None,
                )

    def observe_latency(self, seconds: float,
                        request_id: Optional[str] = None) -> None:
        """End-to-end request latency.  `request_id` becomes an
        OpenMetrics exemplar on the bucket the observation lands in, so
        a scraped p99 outlier bucket names the exact request to feed
        `wavetpu trace-report --request`."""
        with self.registry.lock:
            self._latencies.append(seconds)
            self._latency.observe(
                seconds,
                exemplar={"request_id": request_id} if request_id else None,
            )

    def _percentile(self, p: float) -> Optional[float]:
        if not self._latencies:
            return None
        return percentile_nearest_rank(sorted(self._latencies), p)

    def last_batch_age(self) -> Optional[float]:
        """Seconds since the last batch finished, or None before any
        batch - the load balancer's idle-vs-wedged discriminator.

        Keyed on the batches COUNTER, not the timestamp gauge: a gauge
        still at its 0.0 default is indistinguishable from a genuine
        t=0 timestamp, so "never executed a batch" (None) and "has
        executed, currently idle" (a number, possibly 0.0) must be told
        apart by whether any batch was ever counted."""
        with self.registry.lock:
            if self._batches.value() == 0:
                return None
            ts = self._last_batch_ts.value()
        return max(0.0, time.time() - ts)

    def snapshot(self) -> dict:
        with self.registry.lock:
            batches = int(self._batches.value())
            occ = self._occupancy._snapshot_value()
            mean_occ = occ["sum"] / batches if batches else None
            p50 = self._percentile(0.50)
            p95 = self._percentile(0.95)
            solve_s = self._solve_seconds.value()
            agg = (
                self._cells.value() / solve_s / 1e9 if solve_s else None
            )
            age = self.last_batch_age()
            return {
                "uptime_seconds": round(time.time() - self.started, 3),
                "requests_total": int(self._requests.value()),
                "responses_ok": int(self._responses.value(status="ok")),
                "responses_error": int(
                    self._responses.value(status="error")
                ),
                "batches_total": batches,
                "batch_occupancy_mean": mean_occ,
                "batch_occupancy_max": int(self._occupancy_max.value()),
                "fallback_batches": int(self._fallbacks.value()),
                "latency_p50_ms": None if p50 is None else round(
                    p50 * 1e3, 3
                ),
                "latency_p95_ms": None if p95 is None else round(
                    p95 * 1e3, 3
                ),
                "aggregate_gcells_per_s": (
                    None if agg is None else round(agg, 4)
                ),
                "queue_depth": int(self._queue_depth.value()),
                "rejected_total": int(self._rejected.value()),
                "limit_rejected_total": int(self._limit_rejected.total()),
                "padding_lanes_total": int(self._padding.value()),
                "last_batch_age_seconds": (
                    None if age is None else round(age, 3)
                ),
                "deadline_expired_total": int(
                    self._deadline_expired.value()
                ),
                "worker_restarts_total": int(
                    self._worker_restarts.value()
                ),
                "chunks_total": int(self._chunks.value()),
                "preempted_total": int(self._preempted.total()),
                "resumed_total": int(self._resumes.total()),
                "shed_total": int(self._shed.total()),
                "brownout_rung": int(self._brownout_rung.value()),
                "coalesced_total": int(self._coalesced.value()),
            }


@dataclasses.dataclass
class _Item:
    request: SolveRequest
    future: Future
    key: Tuple
    # Telemetry: the trace id the HTTP layer minted for this request
    # (None untraced) and the monotonic submit time for queue-wait
    # attribution.
    request_id: Optional[str] = None
    enqueued: float = 0.0
    # Absolute monotonic deadline (None = no budget): the worker drops
    # an already-expired item at batch formation (HTTP 504) instead of
    # marching work nobody is waiting for.
    deadline: Optional[float] = None
    # Preemptible long solves: True routes the item through the chunked
    # march (never batched - its key is unique); `chunk` holds the
    # march's in-memory progress once the first round initialized it
    # (worker-crash recovery resumes from it instead of failing the
    # request).
    chunked: bool = False
    chunk: Optional["_ChunkProgress"] = None
    # Fleet trace context the HTTP layer adopted/minted for this
    # request: (32-hex trace id, 16-hex serve.request wire id), None
    # untraced.  Chunk spans stamp the trace id, and checkpoints
    # persist it so a resume on another replica links back.
    trace_context: Optional[Tuple[str, str]] = None


class _ChunkProgress:
    """In-memory march state of one chunked long solve between rounds
    (the item carries it across the scheduler's interleaving and across
    worker-crash restarts)."""

    __slots__ = (
        "runner", "state", "step", "abs", "rel", "chunks_done",
        "wait_s", "compile_s", "execute_s", "warm", "resumed_from",
        "origin_trace",
    )

    def __init__(self, runner, warm: str, compile_s: float,
                 wait_s: float):
        import numpy as np

        self.runner = runner
        self.state = None
        self.step = 0
        t = runner.problem.timesteps
        self.abs = np.zeros(t + 1, dtype=np.float64)
        self.rel = np.zeros(t + 1, dtype=np.float64)
        self.chunks_done = 0
        self.wait_s = wait_s
        self.compile_s = compile_s
        self.execute_s = 0.0
        self.warm = warm
        self.resumed_from: Optional[int] = None
        # [trace_id, span_w3c_id] of the ORIGINATING request: minted on
        # the first march, carried through checkpoints, so the chunk
        # spans of a solve resumed on another replica (or under a fresh
        # client trace) still link back to where the march began.
        self.origin_trace: Optional[List[str]] = None


class BrownoutController:
    """The adaptive overload ladder (docs/robustness.md "Brownout
    ladder").  Input: queue-wait samples (submit-to-batch-formed
    seconds) the batcher feeds at every batch formation / chunk init.
    Output: a rung in [0, 3] recomputed from the p95 of the samples
    seen in the last `sample_ttl_s` seconds:

        rung 0  healthy            admit everything
        rung 1  p95 >= thresholds[0]  shed best_effort admissions
        rung 2  p95 >= thresholds[1]  shed batch admissions too
        rung 3  p95 >= thresholds[2]  also defer NEW chunked-march
                                      starts (in-flight marches keep
                                      draining; interactive still
                                      admitted at every rung)

    Escalation is immediate (overload hurts NOW); de-escalation is
    hysteresis-gated - one rung at a time, only after `cooldown_s`
    since the last change AND with p95 back under `hysteresis` x the
    current rung's threshold - so the ladder settles instead of
    flapping around a threshold.  Thread-safe; `update()` is cheap
    enough for the submit path (the p95 is recomputed at most every
    `min_interval_s`)."""

    RUNG_NAMES = ("healthy", "shed_best_effort", "shed_batch",
                  "defer_chunk_starts")

    def __init__(self, thresholds=(0.5, 2.0, 8.0), window: int = 256,
                 min_samples: int = 8, hysteresis: float = 0.5,
                 cooldown_s: float = 5.0, sample_ttl_s: float = 30.0,
                 min_interval_s: float = 0.1):
        if len(thresholds) != 3:
            raise ValueError(
                f"thresholds must be 3 ascending seconds, got "
                f"{thresholds!r}"
            )
        t = tuple(float(x) for x in thresholds)
        if not (0 < t[0] <= t[1] <= t[2]):
            raise ValueError(
                f"thresholds must be 3 ascending seconds, got "
                f"{thresholds!r}"
            )
        self.thresholds = t
        self.min_samples = min_samples
        self.hysteresis = hysteresis
        self.cooldown_s = cooldown_s
        self.sample_ttl_s = sample_ttl_s
        self.min_interval_s = min_interval_s
        self._samples: "deque[Tuple[float, float]]" = deque(
            maxlen=window
        )
        self._lock = threading.Lock()
        self._rung = 0
        self._last_change = 0.0
        self._last_update = 0.0
        self._p95 = 0.0

    def observe_wait(self, seconds: float) -> None:
        with self._lock:
            self._samples.append((time.monotonic(), float(seconds)))

    def _compute_p95(self, now: float) -> Optional[float]:
        live = [w for t, w in self._samples
                if now - t <= self.sample_ttl_s]
        if len(live) < self.min_samples:
            return None
        return percentile_nearest_rank(sorted(live), 0.95)

    def update(self) -> int:
        """Recompute (rate-limited) and return the current rung."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_update < self.min_interval_s:
                return self._rung
            self._last_update = now
            p95 = self._compute_p95(now)
            self._p95 = p95 if p95 is not None else 0.0
            if p95 is None:
                # Not enough recent signal: decay toward healthy on
                # the same cooldown cadence as a measured recovery.
                desired = 0
            else:
                desired = 0
                for i, th in enumerate(self.thresholds):
                    if p95 >= th:
                        desired = i + 1
            if desired > self._rung:
                self._rung = desired
                self._last_change = now
            elif desired < self._rung:
                recovered = (
                    p95 is None
                    or p95 <= self.hysteresis
                    * self.thresholds[self._rung - 1]
                )
                if recovered and now - self._last_change \
                        >= self.cooldown_s:
                    self._rung -= 1  # one rung at a time
                    self._last_change = now
            return self._rung

    @property
    def rung(self) -> int:
        with self._lock:
            return self._rung

    def rung_name(self, rung: Optional[int] = None) -> str:
        return self.RUNG_NAMES[self.rung if rung is None else rung]

    def sheds(self, priority: str) -> bool:
        """Does the CURRENT rung shed this class?  Interactive is never
        shed by the ladder (quotas and the bounded queue still apply)."""
        r = self.rung
        if r >= 2:
            return priority in ("batch", "best_effort")
        if r >= 1:
            return priority == "best_effort"
        return False

    def defers_chunk_starts(self) -> bool:
        return self.rung >= 3

    def snapshot(self) -> dict:
        """The /healthz `brownout` block."""
        with self._lock:
            return {
                "rung": self._rung,
                "rung_name": self.RUNG_NAMES[self._rung],
                "queue_wait_p95_s": round(self._p95, 4),
                "thresholds_s": list(self.thresholds),
            }


class DynamicBatcher:
    """The request queue + single batching worker.

    `max_wait` bounds how long the FIRST request of a batch waits for
    company; `max_batch` (usually the engine's largest bucket) bounds the
    batch.  `submit()` is safe from any thread (futures are
    `concurrent.futures.Future`); `close()` joins the worker, then fails
    every still-unresolved future - both the worker's stash and anything
    left in (or racing into) the queue - with a RuntimeError.
    `close(drain=True)` is the graceful-shutdown path: new submits are
    refused, but everything already queued is FLUSHED through the engine
    (batched as usual, no max-wait idling) and every outstanding future
    resolves with its result instead of an error.

    The worker runs under a SUPERVISOR (`_worker_main`): a crash fails
    the in-flight batch's futures with a retriable `WorkerCrashError`
    (503 + Retry-After) and restarts the loop - a wedged scheduler must
    never strand blocked HTTP handlers.  Requests may carry an absolute
    `deadline` (submit kwarg); already-expired items are dropped with
    `DeadlineExceededError` (504) at batch formation instead of being
    marched.  Both are no-ops when unused.

    `length_bucket_steps` is the occupancy/latency knob for diverging
    stop_steps: per-lane masking marches every lane to the batch's
    longest stop, so a 10-step request batched with a 1000-step one
    burns ~990 masked-lane steps of FLOPs.  With the knob set, requests
    are additionally bucketed by stop-length quantum - the quantum
    rounded UP to a multiple of the request's k so bucket boundaries sit
    on the onion's k-block grid - and only same-length-bucket requests
    share a batch: tighter buckets waste fewer masked steps but split
    traffic across more batches (lower occupancy).  Starvation is
    bounded: stashed non-matching requests keep arrival order and the
    worker serves the OLDEST stashed request as the next batch's leader,
    so a request waits at most one batch per distinct key ahead of it.
    """

    def __init__(self, engine, metrics: Optional[ServeMetrics] = None,
                 max_batch: Optional[int] = None, max_wait: float = 0.025,
                 length_bucket_steps: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 fault_plan: Optional[faults.ServeFaultPlan] = None,
                 chunk_threshold: Optional[int] = None,
                 chunk_steps: int = 32,
                 state_store=None,
                 brownout: Optional[BrownoutController] = None):
        self.engine = engine
        self.metrics = metrics if metrics is not None else ServeMetrics()
        # Chaos harness: worker-crash / slow-batch injections fire at
        # this layer.  Default to the engine's plan so one WAVETPU_FAULT
        # budget governs the whole stack (build_server passes the shared
        # plan explicitly; engine-less stubs get None).
        self.fault_plan = (
            fault_plan if fault_plan is not None
            else getattr(engine, "fault_plan", None)
        )
        self.max_batch = (
            engine.max_batch if max_batch is None
            else min(max_batch, engine.max_batch)
        )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if length_bucket_steps is not None and length_bucket_steps < 1:
            raise ValueError(
                f"length_bucket_steps must be >= 1, got "
                f"{length_bucket_steps}"
            )
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        if chunk_threshold is not None and chunk_threshold < 2:
            raise ValueError(
                f"chunk_threshold must be >= 2, got {chunk_threshold}"
            )
        if chunk_steps < 1:
            raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
        self.max_wait = max_wait
        self.length_bucket_steps = length_bucket_steps
        # Preemptible long solves: requests with timesteps >= threshold
        # (None = feature off) march through cached chunk programs
        # (serve/preempt.py), interleaved with ordinary batches, and
        # checkpoint to `state_store` (a SolveStateStore; None = no
        # cross-replica handoff, deadline 504s carry no token).
        self.chunk_threshold = chunk_threshold
        self.chunk_steps = chunk_steps
        self.state_store = state_store
        self._chunk_seq = 0
        # id(item) -> item of every chunked march holding state on the
        # card (`chunk_state_bytes`); an entry leaves when its future
        # resolves.
        self._marches: Dict[int, _Item] = {}
        # Bounded-queue backpressure: submit() raises QueueFullError
        # (HTTP 429) once this many requests are submitted-but-not-yet-
        # executing.  None = unbounded (the historical behavior).
        self.max_queue = max_queue
        self._depth = 0
        self._q: "queue.Queue[_Item]" = queue.Queue()
        # The stash: one deque PER PRIORITY CLASS, drained by weighted
        # deficit round-robin (_pick_locked).  With one backlogged
        # class the deficits stay zero and scheduling is the historical
        # arrival-order FIFO.
        self._pending = {c: deque() for c in PRIORITY_CLASSES}
        self._deficit = {c: 0.0 for c in PRIORITY_CLASSES}
        # Adaptive overload shedding (None = ladder off: submit never
        # sheds, chunk starts never defer).
        self.brownout = brownout
        # Guards _pending: the worker mutates it between batches and
        # close() sweeps it after the join timeout - which can expire
        # while a drain is still executing batches, so the sweep must
        # not race the worker's stash bookkeeping.
        self._plock = threading.Lock()
        self._closed = False
        self._drain = False
        # Singleflight coalescing (guarded by _plock): coalesce_key ->
        # the in-flight primary _Item.  Only populated when the HTTP
        # layer passes a key (result cache enabled + request eligible);
        # followers chain onto the primary's future and never enter the
        # queue.  Entries unregister via a done-callback on the primary
        # future - every resolution site (worker, close sweep, crash
        # cleanup) resolves futures OUTSIDE _plock, so the callback's
        # _plock acquire cannot deadlock.
        self._singleflight: Dict[str, _Item] = {}
        # The batch the worker currently holds OUTSIDE the queue/stash
        # (supervisor bookkeeping): if the worker crashes mid-batch,
        # these futures must be failed retriable, never stranded.
        self._inflight: List[_Item] = []
        self._worker = threading.Thread(
            target=self._worker_main, name="wavetpu-batcher", daemon=True
        )
        self._worker.start()

    def length_bucket(self, request: SolveRequest) -> int:
        """The request's stop-length bucket id (0 when the knob is off).

        The quantum is rounded up to a multiple of the request's k, so
        every bucket boundary sits on the k-block grid the onion's lane
        masking freezes on."""
        if self.length_bucket_steps is None:
            return 0
        q = self.length_bucket_steps
        k = request.k if request.path == "kfused" else 1
        q = ((q + k - 1) // k) * k
        return (request.lane.stop(request.problem) - 1) // q

    def _item_key(self, request: SolveRequest) -> Tuple:
        return request.bucket_key() + (self.length_bucket(request),)

    def chunk_eligible(self, request: SolveRequest) -> bool:
        """Whether this request CAN march chunked: the single-backend
        standard-scheme tiers the supervisor's chunk runners cover, at
        default phase, full stop, no per-lane field.  Compensated,
        sharded, shifted-phase, partial-stop, and variable-c requests
        run monolithic (documented contract, docs/robustness.md)."""
        from wavetpu_torch.verify import oracle

        r = request
        return (
            self.chunk_threshold is not None
            and hasattr(self.engine, "chunk_runner")
            and r.mesh_shape is None
            and r.scheme == "standard"
            and r.path in ("roll", "pallas", "kfused")
            and r.lane.c2tau2_field is None
            and r.lane.phase == oracle.TWO_PI
            and r.lane.stop(r.problem) == r.problem.timesteps
            and (r.path != "kfused" or r.problem.N % max(1, r.k) == 0)
        )

    def _chunk_mode(self, request: SolveRequest) -> bool:
        """Route through the chunked march?  Long requests past the
        threshold, plus ANY resume (the token's march is already
        chunked).  A resume_token on a request that cannot march
        chunked - or on a replica without the feature - is a client
        error, rejected synchronously (422)."""
        eligible = self.chunk_eligible(request)
        if request.resume_token is not None:
            if not eligible:
                raise InvalidStateTokenError(
                    "resume_token requires a chunk-eligible request "
                    "(standard scheme, roll/pallas/kfused path, default "
                    "phase, full stop, no c2_field) on a replica with "
                    "--chunk-threshold set"
                )
            if self.state_store is None:
                raise InvalidStateTokenError(
                    "this replica has no --solve-state-dir; it cannot "
                    "resume a checkpointed solve"
                )
            return True
        return (
            eligible
            and request.problem.timesteps >= self.chunk_threshold
        )

    def digest_refusal(self, request: SolveRequest) -> Optional[str]:
        """Why this replica cannot answer the request's `probes` (the
        HTTP layer's 422), or None: a mesh request's state is sharded
        over its cards and a chunked march's final state never passes
        through a batch, so neither gathers a digest."""
        if request.probes is None:
            return None
        if request.mesh_shape is not None:
            return ("probes are not answered for mesh requests: the state "
                    "is sharded over the mesh's cards")
        try:
            chunked = self._chunk_mode(request)
        except InvalidStateTokenError:
            return None  # submit() answers the token's own 422
        if chunked:
            return ("probes are not answered for chunked marches "
                    f"(timesteps >= --chunk-threshold {self.chunk_threshold}"
                    " or a resume_token)")
        return None

    def _dec_depth(self, n: int) -> None:
        # Gauge set INSIDE _plock: a set outside could interleave with a
        # concurrent submit and leave a stale depth on an idle server.
        # (Lock order is always _plock -> registry lock, never reversed.)
        with self._plock:
            self._depth = max(0, self._depth - n)
            self.metrics.observe_queue_depth(self._depth)

    def submit(self, request: SolveRequest,
               request_id: Optional[str] = None,
               deadline: Optional[float] = None,
               trace_context: Optional[Tuple[str, str]] = None,
               coalesce_key: Optional[str] = None) -> Future:
        """`deadline` is an absolute `time.monotonic()` bound (None =
        unbounded, the historical behavior): the worker drops the item
        with `DeadlineExceededError` if it is still queued past it.
        `trace_context` is the serving span's (trace id, wire span id):
        chunk spans stamp the trace id and checkpoints carry it so
        resumed marches link back to the originating request.
        `coalesce_key` (the request's content-addressed result key)
        opts this submit into singleflight: if an identical solve is
        already in flight its answer fans out to this caller too (the
        returned future carries `wavetpu_coalesced = True`); otherwise
        this submit becomes the primary later identical submits ride."""
        request.priority = normalize_priority(
            getattr(request, "priority", None)
        )
        if coalesce_key is not None:
            with self._plock:
                primary = self._singleflight.get(coalesce_key)
                if primary is not None and not primary.future.done():
                    follower: Future = Future()
                    follower.wavetpu_coalesced = True

                    def _fanout(pf: Future, f: Future = follower) -> None:
                        if f.done():
                            return
                        exc = pf.exception()
                        if exc is not None:
                            f.set_exception(exc)
                        else:
                            f.set_result(pf.result())

                    primary.future.add_done_callback(_fanout)
                else:
                    primary = None
            if primary is not None:
                # Each coalesced rider is still individually counted
                # (and, at the router, individually quota-charged): the
                # fan-out saves the march, not the accounting.
                self.metrics.observe_coalesced()
                self.metrics.observe_request()
                self.metrics.observe_tenant(request.tenant)
                self.metrics.observe_class_request(request.priority)
                return follower
        # Brownout ladder: overload sheds lower classes AT ADMISSION
        # (before any queue accounting) with a measured Retry-After -
        # a fast retriable 503, never a slow timeout.
        if self.brownout is not None:
            self.brownout.update()
            self.metrics.observe_brownout_rung(self.brownout.rung)
            if self.brownout.sheds(request.priority):
                rung = self.brownout.rung_name()
                self.metrics.observe_shed(
                    rung, request.priority, request.tenant
                )
                raise ShedError(
                    f"overloaded: brownout ladder at rung "
                    f"'{rung}' is shedding {request.priority} "
                    f"requests; retry later",
                    retry_after_s=self.metrics.retry_after_s(
                        self._depth
                    ),
                    rung=rung,
                )
        chunked = self._chunk_mode(request)
        if chunked:
            # A unique key: chunked items never coalesce with (or get
            # taken as batchmates of) anything - the worker marches them
            # one chunk per pass, interleaved with ordinary batches.
            with self._plock:
                self._chunk_seq += 1
                key: Tuple = ("__chunk__", self._chunk_seq)
        else:
            key = self._item_key(request)
        item = _Item(
            request, Future(), key,
            request_id=request_id, enqueued=time.monotonic(),
            deadline=deadline, chunked=chunked,
            trace_context=trace_context,
        )
        if chunked and self.state_store is not None:
            # The march answers an expired deadline with a resume token
            # at its next chunk boundary (after the checkpoint is
            # written): the HTTP layer waits for that answer instead of
            # cutting the wait at the deadline.
            item.future.wavetpu_awaits_token = True
        # Closed-check + enqueue are ATOMIC against close() (which
        # flips _closed under this same lock): a submit that passes the
        # check has its item IN the queue before close()'s final sweep
        # runs, so the item is either drained or failed fast - a racing
        # submit can never strand a future in a dead queue
        # (tests/test_serve.py pins the drain-vs-submit race).
        with self._plock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self.max_queue is not None and self._depth >= self.max_queue:
                self.metrics.observe_rejected()
                raise QueueFullError(
                    f"request queue full ({self._depth} waiting >= "
                    f"max_queue {self.max_queue}); retry later"
                )
            self._depth += 1
            self.metrics.observe_queue_depth(self._depth)
            self._q.put(item)
            if coalesce_key is not None and not chunked:
                self._singleflight[coalesce_key] = item
        if coalesce_key is not None and not chunked:
            # Attached OUTSIDE _plock; fires in whatever thread resolves
            # the primary (always lock-free at that point, see __init__).
            item.future.add_done_callback(
                lambda _f, k=coalesce_key, it=item:
                self._unregister_singleflight(k, it)
            )
        self.metrics.observe_request()
        self.metrics.observe_tenant(request.tenant)
        self.metrics.observe_class_request(request.priority)
        return item.future

    def _unregister_singleflight(self, key: str, item: _Item) -> None:
        with self._plock:
            if self._singleflight.get(key) is item:
                del self._singleflight[key]

    def close(self, timeout: float = 5.0, drain: bool = False) -> None:
        """Stop the worker.  `drain=True` flushes everything already
        queued through the engine first (graceful SIGTERM shutdown):
        outstanding futures resolve with RESULTS; only what the worker
        could not finish within `timeout` is failed."""
        with self._plock:
            # Under _plock so no submit can pass its closed-check and
            # enqueue after the final sweep below (see submit()).
            self._drain = drain
            self._closed = True
        self._q.put(None)  # wake the worker
        self._worker.join(timeout)
        if self._worker.is_alive():
            # The drain outlived the timeout (it does unbounded engine
            # work).  Tell the worker to stop after its in-flight batch
            # and give it a short grace to exit; the sweep below then
            # fails what it could not finish - under _plock, so a
            # worker that is STILL mid-batch cannot race the stash.
            self._drain = False
            self._worker.join(min(timeout, 5.0))
        # Fail EVERY unresolved future: the worker's stash plus anything
        # still in the queue (including a submit that raced past the
        # _closed check) - a blocked HTTP handler must get its 500, not
        # sit out the full request timeout.  After a completed drain
        # there is nothing left here and this is a no-op.
        with self._plock:
            leftovers = [
                i for c in PRIORITY_CLASSES for i in self._pending[c]
            ]
            for c in PRIORITY_CLASSES:
                self._pending[c].clear()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                leftovers.append(item)
        self._dec_depth(len(leftovers))
        for item in leftovers:
            if not item.future.done():
                item.future.set_exception(
                    RuntimeError("server shutting down")
                )
        if self._worker.is_alive():
            # The sweep above may have eaten the wake sentinel; re-post
            # it so a worker still finishing its batch can observe
            # _closed and exit instead of blocking on an empty queue.
            self._q.put(None)

    # ---- worker ----

    def _worker_main(self) -> None:
        """The worker's SUPERVISOR: `_loop` returning means a clean
        shutdown; `_loop` raising means the worker crashed mid-batch (a
        scheduler bug, an injected `serve-worker-crash`, anything the
        per-batch engine try does not cover).  The supervisor fails the
        crashed batch's futures with a retriable `WorkerCrashError`
        (HTTP 503 + Retry-After - a blocked handler must never sit out
        its timeout) and re-enters the loop, so everything still queued
        or stashed keeps getting served.  A short sleep between
        restarts keeps a crash-looping bug from spinning hot."""
        while True:
            try:
                self._loop()
                return
            except Exception as e:
                self._crash_cleanup(e)
                if self._closed and not self._drain:
                    return
                time.sleep(0.05)

    def _crash_cleanup(self, exc: BaseException) -> None:
        items, self._inflight = self._inflight, []
        requeue: List[_Item] = []
        for item in items:
            if item.future.done():
                continue
            if (
                item.chunk is not None
                and not (self._closed and not self._drain)
            ):
                # A chunked long solve keeps its in-memory march state
                # on the item: re-enqueue at the FRONT and resume from
                # the last completed chunk after the worker restart -
                # the client sees nothing (zero-visible-errors half of
                # the serve-chunk-crash drill).
                requeue.append(item)
            else:
                item.future.set_exception(WorkerCrashError(
                    f"scheduler worker crashed mid-batch ({exc!r}); "
                    f"worker restarted - retry the request"
                ))
        if requeue:
            with self._plock:
                for item in reversed(requeue):
                    # Front of the item's CLASS queue: the march
                    # resumes at its own class's next turn, not ahead
                    # of higher classes.
                    self._pending[self._class_of(item)].appendleft(item)
            for _ in requeue:
                self.metrics.observe_resume("crash")
        self.metrics.observe_worker_restart()

    @staticmethod
    def _class_of(item: _Item) -> str:
        return normalize_priority(
            getattr(item.request, "priority", None)
        )

    def _pending_empty(self) -> bool:
        with self._plock:
            return not any(
                self._pending[c] for c in PRIORITY_CLASSES
            )

    def _stash_locked(self, item: _Item) -> None:
        self._pending[self._class_of(item)].append(item)

    def _pick_locked(self) -> Optional[_Item]:
        """One weighted-deficit-round-robin pick (caller holds _plock).

        Each pick credits every BACKLOGGED class its weight, serves the
        class with the largest deficit (ties break to the higher static
        class), then debits the winner the round's total credit.  Net
        effect: service converges to the 16:4:1 weight ratio under
        backlog, a newly-arrived interactive request beats a lower
        class's next turn (its 16-credit first round outbids any
        deficit a lower class can have accrued before its own turn
        comes), and best_effort is served at least once every
        ~sum(weights) picks - the starvation bound.  A class's deficit
        resets when its queue empties (classic DRR: credit never
        banks while idle), so a SINGLE backlogged class runs at
        deficit zero - exactly the historical FIFO, no QoS overhead."""
        nonempty = [c for c in PRIORITY_CLASSES if self._pending[c]]
        if not nonempty:
            return None
        if len(nonempty) == 1:
            c = nonempty[0]
            for k in PRIORITY_CLASSES:
                self._deficit[k] = 0.0
            return self._pending[c].popleft()
        total = 0.0
        for c in nonempty:
            self._deficit[c] += CLASS_WEIGHTS[c]
            total += CLASS_WEIGHTS[c]
        best = max(
            nonempty,
            key=lambda c: (self._deficit[c],
                           -PRIORITY_CLASSES.index(c)),
        )
        self._deficit[best] -= total
        item = self._pending[best].popleft()
        if not self._pending[best]:
            self._deficit[best] = 0.0
        return item

    def _take_pending(self, key, limit: int) -> List[_Item]:
        """Same-key batchmates from EVERY class queue (a matching
        request rides along whatever its class - it is being served
        now, which can only help it)."""
        taken: List[_Item] = []
        with self._plock:
            for c in PRIORITY_CLASSES:
                keep = deque()
                while self._pending[c]:
                    item = self._pending[c].popleft()
                    if item.key == key and len(taken) < limit:
                        taken.append(item)
                    else:
                        keep.append(item)
                self._pending[c].extend(keep)
        return taken

    def _drain_queue(self) -> None:
        """Move everything still in the queue onto the per-class stash
        (arrival order preserved within a class) - the worker's intake
        and the drain path's."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                with self._plock:
                    self._stash_locked(item)

    def _loop(self) -> None:
        while True:
            if self._closed:
                if not self._drain:
                    return
                self._drain_queue()
                if self._pending_empty():
                    return
            # Intake first so the pick sees EVERY arrival: this is the
            # strict rule - an interactive request that arrived while a
            # lower-class chunk marched is in its class queue before
            # the next pick, and the pick serves it ahead of the
            # march's next chunk slot.
            self._drain_queue()
            with self._plock:
                first = self._pick_locked()
            if first is None:
                item = self._q.get()
                if item is None:
                    continue  # sentinel: loop back to the closed check
                # Serve the dequeued item THIS pass (through the pick,
                # so deficits stay consistent): re-running the closed
                # check here could strand an item a racing close()
                # already popped from the queue's accounting.
                with self._plock:
                    self._stash_locked(item)
                    first = self._pick_locked()
            if first.chunked:
                # Brownout top rung: defer STARTING new marches (keep
                # the item queued at the back of its class) while
                # in-flight marches keep draining.  Never during a
                # drain - flushing queued work is the whole point then.
                if (
                    first.chunk is None
                    and self.brownout is not None
                    and not (self._closed and self._drain)
                    and self.brownout.update() >= 3
                ):
                    self.metrics.observe_chunk_start_deferred()
                    with self._plock:
                        self._stash_locked(first)
                    # Block briefly on the queue so a stash holding
                    # only deferred starts does not spin the worker
                    # hot; fresh arrivals wake it immediately.
                    try:
                        nxt = self._q.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    if nxt is not None:
                        with self._plock:
                            self._stash_locked(nxt)
                    continue
                # One chunk per pass: the march yields the worker back
                # between chunks so short/high-priority traffic
                # interleaves instead of queueing behind a monolithic
                # long solve.
                self.metrics.observe_scheduled(self._class_of(first))
                self._inflight = [first]
                finished = self._chunk_round(first)
                self._inflight = []
                if not finished:
                    # Fresh arrivals (still in the queue) go ahead of
                    # the long solve's next chunk; the item itself goes
                    # to the back of its class's stash.
                    self._drain_queue()
                    with self._plock:
                        self._stash_locked(first)
                continue
            batch = [first]
            batch += self._take_pending(
                first.key, self.max_batch - len(batch)
            )
            # While draining, skip the max-wait idle: flush immediately.
            deadline = time.monotonic() + (
                0.0 if self._closed else self.max_wait
            )
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    # Sentinel mid-collection: execute what we have; the
                    # outer loop then drains (or returns, leaving
                    # close() to fail the stash).
                    break
                if nxt.key == first.key:
                    batch.append(nxt)
                else:
                    with self._plock:
                        self._stash_locked(nxt)
            # Supervisor bookkeeping: these items live only in this
            # local list now; if _execute crashes past its engine try,
            # _worker_main fails them retriable instead of stranding.
            for item in batch:
                self.metrics.observe_scheduled(self._class_of(item))
            self._inflight = batch
            self._execute(batch)
            self._inflight = []

    def _execute(self, batch: List[_Item]) -> None:
        req0 = batch[0].request
        # Batch formed: the members' queue wait ends here; they leave
        # the bounded queue's accounting as they enter the engine.
        t_formed = time.monotonic()
        waits = [max(0.0, t_formed - item.enqueued) for item in batch]
        if self.brownout is not None:
            # The ladder's input signal: queue wait at batch formation.
            for w in waits:
                self.brownout.observe_wait(w)
        self._dec_depth(len(batch))
        # Deadline shedding: an item whose budget already expired in
        # queue is dropped HERE (504 with queue attribution), before any
        # compile or device work - marching a lane nobody is waiting for
        # wastes the whole batch's FLOP budget.  No-deadline items (the
        # historical path) are untouched.
        live: List[_Item] = []
        live_waits: List[float] = []
        for item, wait in zip(batch, waits):
            if item.deadline is not None and t_formed >= item.deadline:
                self.metrics.observe_deadline_expired()
                if not item.future.done():
                    item.future.set_exception(DeadlineExceededError(
                        f"deadline expired after {wait * 1e3:.0f} ms in "
                        f"queue (dropped before execution)",
                        queue_s=wait,
                    ))
            else:
                live.append(item)
                live_waits.append(wait)
        if not live:
            return
        batch, waits = live, live_waits
        # Chaos seams: a worker crash escapes to the supervisor (the
        # engine try below must NOT absorb it - it models the thread
        # dying, not the solve failing); a slow batch stalls the worker
        # exactly where a pathological build or device hang would.
        plan = self.fault_plan
        if plan is not None and plan.active:
            ctx = dict(
                n=req0.problem.N, timesteps=req0.problem.timesteps,
                scheme=req0.scheme, path=req0.path, k=req0.k,
                dtype=req0.dtype_name,
            )
            if plan.fire("worker-crash", **ctx):
                raise faults.InjectedFault(
                    "injected scheduler worker crash"
                )
            slow = plan.fire("slow-batch", **ctx)
            if slow is not None:
                time.sleep(slow.seconds)
        span = tracing.begin_span(
            "serve.batch",
            request_ids=[i.request_id for i in batch if i.request_id],
            occupancy=len(batch), scheme=req0.scheme, path=req0.path,
            k=req0.k, n=req0.problem.N,
            queue_wait_max_ms=round(max(waits) * 1e3, 3),
            tenant=req0.tenant,
        )
        timing: dict = {}
        # A batch of ONLY shadow-solve lanes (serve/shadow.py) must
        # never feed the circuit breaker; one production lane in the
        # batch restores the normal contract.  The kwarg is passed only
        # in the shadow-only case so engine stand-ins with the plain
        # production signature keep working.
        solve_kw: dict = {}
        if all(item.request.shadow for item in batch):
            solve_kw["feed_breaker"] = False
        probes = [item.request.probes for item in batch]
        if any(p is not None for p in probes):
            solve_kw["probes"] = probes
        # Tenant attribution is thread-local (the worker thread, not the
        # handler thread, pays the builds): any ledger line the engine
        # records during this solve carries the batch leader's tenant.
        compile_ledger.set_request_context(tenant=req0.tenant)
        try:
            result, lane_health = self.engine.solve(
                req0.problem,
                [item.request.lane for item in batch],
                scheme=req0.scheme, path=req0.path, k=req0.k,
                dtype_name=req0.dtype_name, mesh=req0.mesh_shape,
                timing=timing, **solve_kw,
            )
        except Exception as e:
            tracing.end_span(span, error=str(e))
            for item in batch:
                if not item.future.done():
                    item.future.set_exception(e)
            return
        finally:
            compile_ledger.clear_request_context()
        t_done = time.monotonic()
        tracing.end_span(
            span, batch_size=result.batch_size, batched=result.batched,
            padding_lanes=result.batch_size - result.n_lanes,
            solve_seconds=round(result.solve_seconds, 6),
        )
        cells = sum(
            req0.problem.cells_per_step * (r.steps_computed or 0)
            for r in result.results
        )
        self.metrics.observe_batch(
            occupancy=result.n_lanes, batched=result.batched,
            cells=cells, solve_seconds=result.solve_seconds,
            batch_size=result.batch_size, queue_waits=waits,
            request_ids=[item.request_id for item in batch],
        )
        padding_lanes = result.batch_size - result.n_lanes
        batch_info = {
            "occupancy": result.n_lanes,
            "batch_size": result.batch_size,
            "batched": result.batched,
            "fallback_reason": result.fallback_reason,
            "path": result.path,
            "padding_lanes": padding_lanes,
            "aggregate_gcells_per_s": round(
                result.aggregate_gcells_per_second, 4
            ),
            "warm": timing.get("warm"),
        }
        # Per-request latency attribution (the Server-Timing header's
        # source): queue = this request's submit-to-batch-formed wait,
        # compile = the batch's cache-miss compile (0 warm), execute =
        # everything after batch formation minus that compile (device
        # march + watchdog + result plumbing), padding = the share of
        # the batch's solve spent marching masked padding lanes -
        # informational waste attribution, a subset of execute, NOT an
        # additive wall-clock component.
        compile_s = float(timing.get("compile_seconds", 0.0))
        execute_s = max(0.0, t_done - t_formed - compile_s)
        padding_s = (
            result.solve_seconds * padding_lanes / result.batch_size
            if result.batch_size else 0.0
        )
        digests = getattr(result, "digests", None)
        for i, item in enumerate(batch):
            # done() guard: a close() that timed out may have failed
            # this future already; a second set_ would raise
            # InvalidStateError inside the worker.
            if not item.future.done():
                info = dict(batch_info)
                if digests is not None and digests[i] is not None:
                    info["digest"] = digests[i]
                info["timing"] = {
                    "queue_s": waits[i],
                    "compile_s": compile_s,
                    "execute_s": execute_s,
                    "padding_s": padding_s,
                }
                item.future.set_result(
                    (result.results[i], lane_health[i], info)
                )

    # ---- chunked long solves (serve/preempt.py) ----

    def _checkpoint(self, item: _Item) -> Optional[str]:
        """Persist the item's march state -> resume token, or None when
        there is nothing to save or no --solve-state-dir.  Guarded: a
        full disk downgrades the preemption to a token-less abort, it
        never turns into a 500."""
        cp = item.chunk
        if cp is None or cp.state is None or self.state_store is None:
            return None
        try:
            return self.state_store.put(
                cp.runner.identity,
                cp.state,
                cp.step, cp.abs, cp.rel,
                origin_trace=cp.origin_trace,
                priority=item.request.priority,
            )
        except Exception:
            return None

    def _chunk_init(self, item: _Item) -> bool:
        """First round: queue accounting, chunk-program acquisition,
        then bootstrap (fresh) or token load (resume).  Returns True
        when the item is RESOLVED (queue-expired deadline, bad token,
        or acquisition failure); False to keep marching."""
        req = item.request
        now = time.monotonic()
        wait = max(0.0, now - item.enqueued)
        if self.brownout is not None:
            self.brownout.observe_wait(wait)
        self._dec_depth(1)
        if item.deadline is not None and now >= item.deadline:
            self.metrics.observe_deadline_expired()
            if not item.future.done():
                item.future.set_exception(DeadlineExceededError(
                    f"deadline expired after {wait * 1e3:.0f} ms in "
                    f"queue (dropped before execution)",
                    queue_s=wait,
                ))
            return True
        plan = self.fault_plan
        compile_ledger.set_request_context(tenant=req.tenant)
        try:
            runner, source, acquire_s = self.engine.chunk_runner(
                req.problem, req.scheme, req.path, req.k,
                req.dtype_name, self.chunk_steps,
            )
            warm_label = (
                "true" if source == "memory"
                else "disk" if source == "disk" else "false"
            )
            cp = _ChunkProgress(
                runner, warm=warm_label, compile_s=acquire_s,
                wait_s=wait,
            )
            if req.resume_token is not None:
                # Chaos seam: serve-handoff-corrupt truncates the
                # checkpoint file between the client presenting the
                # token and the replica loading it - the load below
                # must reject it 422-clean, never traceback (and the
                # breaker never hears it).
                if plan is not None and plan.fire(
                    "handoff-corrupt", n=req.problem.N,
                    timesteps=req.problem.timesteps, scheme=req.scheme,
                    path=req.path, k=req.k, dtype=req.dtype_name,
                ):
                    target = self.state_store.path_for(
                        req.resume_token
                    )
                    import os as _os

                    if _os.path.exists(target):
                        faults.truncate_tail(target)
                meta, step, state_np, abs_p, rel_p = (
                    self.state_store.load(
                        req.resume_token, cp.runner.identity
                    )
                )
                cp.state = cp.runner.prepare(state_np)
                cp.step = step
                cp.abs[: step + 1] = abs_p
                cp.rel[: step + 1] = rel_p
                cp.resumed_from = step
                # Prefer the checkpoint's origin: even when the resume
                # arrives under a fresh client trace, the chunk spans
                # link back to the march's FIRST request.
                origin = meta.get("origin_trace")
                if (isinstance(origin, (list, tuple)) and len(origin) == 2
                        and all(isinstance(x, str) for x in origin)):
                    cp.origin_trace = list(origin)
                elif item.trace_context is not None:
                    cp.origin_trace = list(item.trace_context)
                # The march keeps the class it was ADMITTED at: the
                # checkpoint's priority (clamped by the router when the
                # march began) wins over whatever label the resume
                # request carries - a preempted best_effort solve
                # cannot relabel itself interactive via its token.
                if "priority" in meta:
                    req.priority = normalize_priority(
                        meta.get("priority"), default=req.priority
                    )
                self.metrics.observe_resume("token")
            else:
                state, abs2, rel2, boot_c, boot_s = cp.runner.bootstrap()
                cp.state = state
                cp.step = 1
                cp.abs[:2] = abs2
                cp.rel[:2] = rel2
                cp.compile_s += boot_c
                cp.execute_s += boot_s
                if item.trace_context is not None:
                    cp.origin_trace = list(item.trace_context)
            item.chunk = cp
            self.metrics.observe_chunk_march_started()
            with self._plock:
                self._marches[id(item)] = item
            # The future resolves EXACTLY once regardless of how the
            # march ends (completion, drain/deadline preemption with a
            # token, watchdog trip, close-sweep failure, crash fail) -
            # the one safe place to decrement the in-flight gauge.
            item.future.add_done_callback(
                lambda _f, it=item: self._march_ended(it)
            )
            return False
        except Exception as e:
            if not item.future.done():
                item.future.set_exception(e)
            return True
        finally:
            compile_ledger.clear_request_context()

    def _march_ended(self, item: _Item) -> None:
        """A chunked march's future resolved: free its state on the card
        (the answer, a token or an error has taken what it needs)."""
        self.metrics.observe_chunk_march_ended()
        with self._plock:
            self._marches.pop(id(item), None)
        if item.chunk is not None:
            item.chunk.state = None

    def chunk_state_bytes(self) -> int:
        """Bytes of march state the in-flight chunked solves hold."""
        with self._plock:
            marches = list(self._marches.values())
        total = 0
        for item in marches:
            cp = item.chunk
            state = None if cp is None else cp.state
            if state is not None:
                total += cp.runner.state_nbytes(state)
        return total

    def _chunk_round(self, item: _Item) -> bool:
        """March ONE chunk (or initialize on the first round); returns
        True when the item's future is resolved.  Between rounds the
        worker serves other traffic - the interleaving that keeps short
        requests from queueing behind a monolithic long march.

        Preemption points, checked before each chunk:
          * drain (close(drain=True), the `fleet roll` path):
            checkpoint -> retriable 503 + resume_token;
          * deadline expiry: checkpoint -> 504 + resume_token;
          * per-chunk watchdog AFTER each chunk: a poisoned march 422s
            at the first chunk boundary past the blowup, with the
            last-good step attributed - not after marching the
            remaining thousands of layers.
        A worker crash leaves the march state on the item;
        `_crash_cleanup` re-enqueues it and the next round continues
        from the last completed chunk.  None of these feed the circuit
        breaker."""
        if item.future.done():
            # close() raced and failed it (drain timeout sweep).
            return True
        if item.chunk is None:
            return self._chunk_init(item)
        req = item.request
        cp = item.chunk
        timesteps = req.problem.timesteps
        if self._closed and self._drain:
            token = self._checkpoint(item)
            if token is not None:
                self.metrics.observe_preempted("drain")
                item.future.set_exception(PreemptedError(
                    f"replica draining: long solve checkpointed at "
                    f"step {cp.step}/{timesteps}; resume with the "
                    f"token on any replica sharing --solve-state-dir",
                    resume_token=token,
                ))
                return True
            # No state store: nothing to hand off - finish the march
            # inside the drain like any other queued work.
        if item.deadline is not None and time.monotonic() >= item.deadline:
            token = self._checkpoint(item)
            self.metrics.observe_deadline_expired()
            self.metrics.observe_preempted("deadline")
            item.future.set_exception(DeadlineExceededError(
                f"deadline expired mid-solve at step "
                f"{cp.step}/{timesteps}"
                + ("" if token is None
                   else "; resume with the returned token"),
                resume_token=token,
            ))
            return True
        plan = self.fault_plan
        if plan is not None and plan.active:
            ctx = dict(
                n=req.problem.N, timesteps=timesteps,
                scheme=req.scheme, path=req.path, k=req.k,
                dtype=req.dtype_name,
            )
            if plan.fire("chunk-crash", **ctx):
                # Models the worker thread dying mid-chunk: escapes to
                # the supervisor, which re-enqueues this item with its
                # state intact (see _crash_cleanup) - the client never
                # sees it.
                raise faults.InjectedFault(
                    f"injected worker crash mid-chunk (step {cp.step})"
                )
            # slow-batch applies per CHUNK here (the drills' lever for
            # deterministic mid-march deadline expiry / straddling a
            # roll cutover).
            slow = plan.fire("slow-batch", **ctx)
            if slow is not None:
                time.sleep(slow.seconds)
        length = cp.runner.next_length(cp.step)
        compile_ledger.set_request_context(tenant=req.tenant)
        # Chunk spans run on the scheduler thread, outside the serving
        # request's span stack: stamp the trace id explicitly, and when
        # this march was resumed from another request's checkpoint link
        # back to the originating trace so the joiner can stitch a
        # preempted-and-resumed solve into ONE tree.
        tc = item.trace_context
        origin = cp.origin_trace
        span_trace = tc[0] if tc else (origin[0] if origin else None)
        links = None
        if origin is not None and origin[0] != span_trace:
            links = [{"trace_id": origin[0], "span_id": origin[1]}]
        try:
            with tracing.span(
                "serve.chunk", request_id=item.request_id,
                tenant=req.tenant, path=req.path, start=cp.step,
                length=length, n=req.problem.N,
                trace_id=span_trace, links=links,
            ):
                state, abs_c, rel_c, solve_s, compile_s = (
                    cp.runner.chunk(cp.state, cp.step, length)
                )
        except Exception as e:
            if not item.future.done():
                item.future.set_exception(e)
            return True
        finally:
            compile_ledger.clear_request_context()
        cp.state = state
        cp.abs[cp.step + 1: cp.step + length + 1] = abs_c
        cp.rel[cp.step + 1: cp.step + length + 1] = rel_c
        cp.step += length
        cp.chunks_done += 1
        cp.execute_s += solve_s
        cp.compile_s += compile_s
        self.metrics.observe_chunk()
        if self.engine.watchdog:
            amax = health.state_amax(
                cp.runner.health_arrays(cp.state)
            )
            if not health.healthy(amax, self.engine.max_amp):
                bound = (
                    health.DEFAULT_AMP_BOUND
                    if self.engine.max_amp is None
                    else self.engine.max_amp
                )
                err = (
                    f"numerical-health trip: guarded amax {amax:g} "
                    f"exceeds bound {bound:g} (NaN/Inf count as inf) "
                    f"at step {cp.step} (chunk {cp.chunks_done}); "
                    f"last good step {cp.step - length}"
                )
                item.future.set_result(
                    (None, err, self._chunk_info(item))
                )
                return True
        if cp.step < timesteps:
            return False
        # Complete: the full-march result, bitwise-identical to the
        # unpreempted monolithic solve (bootstrap-to-1 + block-grid
        # chunks replay the same op sequence - the supervisor's
        # invariant).
        marched = timesteps - (cp.resumed_from or 0)
        result = cp.runner.to_result(
            cp.state, cp.abs, cp.rel, timesteps,
            init_s=cp.compile_s, solve_s=cp.execute_s, marched=marched,
        )
        # As the engine does for a batch: the answer is the error vectors
        # and report fields; only the shadow sampler keeps the final
        # layer.
        result.u_prev = result.comp_v = result.comp_carry = None
        if not getattr(self.engine, "keep_final_state", False):
            result.u_cur = None
        cells = req.problem.cells_per_step * marched
        self.metrics.observe_batch(
            occupancy=1, batched=True, cells=cells,
            solve_seconds=cp.execute_s, batch_size=1,
            queue_waits=[cp.wait_s],
            request_ids=[item.request_id],
        )
        if not item.future.done():
            item.future.set_result(
                (result, None, self._chunk_info(item))
            )
        return True

    def _chunk_info(self, item: _Item) -> dict:
        cp = item.chunk
        agg = (
            item.request.problem.cells_per_step
            * (cp.step - (cp.resumed_from or 0))
            / cp.execute_s / 1e9
            if cp.execute_s else 0.0
        )
        return {
            "occupancy": 1,
            "batch_size": 1,
            "batched": True,
            "fallback_reason": None,
            "path": item.request.path,
            "padding_lanes": 0,
            "aggregate_gcells_per_s": round(agg, 4),
            "warm": cp.warm,
            "chunked": True,
            "chunks": cp.chunks_done,
            "chunk_len": cp.runner.chunk_len,
            "resumed_from": cp.resumed_from,
            "timing": {
                "queue_s": cp.wait_s,
                "compile_s": cp.compile_s,
                "execute_s": cp.execute_s,
                "padding_s": 0.0,
            },
        }
