"""stdlib-HTTP JSON front end: `python -m wavetpu_torch serve` /
`wavetpu-torch-serve` (the port of wavetpu/serve/api.py, speaking its HTTP
contract, so wavetpu's client and router can front this replica).

Endpoints (contract in docs/serving.md):

  POST /solve    one solve request -> its own reference-format report.
                 Body: {"N": 32, "timesteps": 20, ...} (fields below).
                 Concurrent requests with the same program identity are
                 coalesced into one batched solve (scheduler.py): one
                 launch of a kernel's lane mode per layer or k-block;
                 each response carries its lane's report plus batch
                 context (occupancy, batched-or-fallback, path).  With
                 --max-queue set, a full queue answers 429 (bounded-
                 queue backpressure) instead of building latency.
                 Every response echoes the request id (`X-Request-Id`:
                 the caller's header if supplied, else server-minted
                 when tracing is on) and carries a `Server-Timing`
                 header attributing the latency - queue/compile/
                 execute (additive; sum ~= total) plus padding (the
                 masked-lane share of the batch solve) and total (the
                 server-measured wall) - so a load generator reads
                 WHERE each request's time went without touching the
                 server's trace files, and the id joins the outlier to
                 `python -m wavetpu_torch trace-report --request ID`.
                 --max-body-bytes refuses oversized bodies with 413 and
                 --max-lane-cells refuses oversized grids with 422,
                 both BEFORE scheduling (counted in /metrics).
                 Resilience contract (docs/robustness.md): a request
                 may carry `deadline_ms` (JSON field, or the
                 `X-Deadline-Ms` header, which wins) - a relative
                 budget from server receipt; expired-in-queue work is
                 dropped with 504 + queue attribution and the handler
                 never outwaits the budget.  429 (queue full) and 503
                 (draining / circuit-broken program / worker crash)
                 carry `Retry-After` and `"retriable": true`; a
                 ProgramKey with K consecutive compile/execute
                 failures is quarantined by the engine's circuit
                 breaker (--breaker-threshold/--breaker-cooldown-s/
                 --no-breaker) while other tiers keep serving.
  GET /healthz   liveness AND readiness: {"status": "ok", "ready",
                 "uptime_seconds", "draining", "warming",
                 "last_batch_age_seconds", "memory_bytes_in_use",
                 "memory_peak_bytes", "backend"} - the memory fields
                 are the CUDA caching allocator's (null on the CPU),
                 backend "gpu" or "cpu"; `status` says the process
                 serves HTTP, `ready` says ROUTE HERE (false while the
                 --warmup build runs or once draining is set); a
                 load balancer distinguishes idle (no traffic, age
                 null/stale but draining false) from wedged; age is
                 null ONLY if no batch was ever executed.
  GET /metrics   request counts, batch occupancy, p50/p95 latency,
                 aggregate Gcell/s, queue depth/rejections, program-
                 cache and fallback state.  Content-negotiated: the
                 default is the historical JSON snapshot; `Accept:
                 text/plain` serves Prometheus text exposition and
                 `Accept: application/openmetrics-text` the OpenMetrics
                 form with request-id EXEMPLARS on latency histogram
                 buckets, all from the same registry cut
                 (docs/observability.md).

Request fields: N (required), Np, Lx, Ly, Lz (floats or "pi"), T,
timesteps, phase (initial time phase, default 2*pi), steps (stop layer,
default timesteps), scheme (standard|compensated - BOTH batch through
the vmapped core, incl. the flagship compensated velocity form), kernel
(auto|roll|pallas), fuse_steps (K >= 2 selects the k-fused onion),
dtype (f32|f64|bf16), c2_field (preset constant|gaussian-lens|two-layer;
standard scheme only), mesh ([MX, MY, MZ] - route through the sharded x
batched composition over that device mesh, its shards on the visible
cards, repeated as needed; standard scheme, no fuse_steps/c2_field).
kernel auto resolves to pallas (the CUDA kernels) on the card and to roll
(their plain versions) with --platform cpu.  A `resume_token` is refused
with 400: the preemptible long solves come with ROADMAP.md queue 1 item
12b.

A request whose lane trips the numerical-health watchdog (NaN/Inf or
amplitude blowup - e.g. a Courant-unstable config) gets HTTP 422 with the
per-lane error; its batchmates' 200s are unaffected (engine.py).  During
a graceful drain (SIGTERM/SIGINT) new /solve requests get 503 while
queued work flushes to completion.

The server is stdlib HTTP (http.server.ThreadingHTTPServer): handler
threads block on the batcher future and never touch a tensor on the
card, while the single scheduler worker launches the kernels - the same
thread discipline as any Python inference server in front of an
accelerator.  The replica runs on the CUDA device unless `--platform
cpu` is given; without a card and without it, `serve` exits 2.

Not ported yet, each exiting 2 with the ROADMAP.md item that brings it:
--program-cache-dir, --program-cache-max-bytes, --warmup-manifest,
--chunk-threshold, --chunk-steps, --solve-state-dir, --solve-state-ttl-s,
--result-cache*, --shadow-* (queue 1 item 12b) and --record-trace (item
12c, with the load generator's traces).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple

from wavetpu_torch import progkey
from wavetpu_torch.cli import _ITEM_12B, _ITEM_12C
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.obs import tracing

_USAGE = (
    "usage: python -m wavetpu_torch serve [--host H] [--port P] "
    "[--max-batch B] [--max-wait-ms MS] [--bucket-sizes 1,2,4,8] [--max-programs M] "
    "[--length-bucket-steps Q] [--max-queue Q] "
    "[--max-body-bytes B] [--max-lane-cells C] "
    "[--kernel auto|roll|pallas] "
    "[--no-errors] [--max-amp X] [--no-watchdog] [--no-server-timing] "
    "[--breaker-threshold K] [--breaker-cooldown-s S] [--no-breaker] "
    "[--warmup N,TIMESTEPS[,K]] "
    "[--brownout-thresholds P1,P2,P3] [--no-brownout] "
    "[--proxy-token SECRET] [--tenant-inflight-cap N] "
    "[--platform gpu|cpu] "
    "[--telemetry-dir DIR] [--version]"
)

# wavetpu's serve flags the port does not take yet, with the ROADMAP.md
# item that brings each.
_NOT_PORTED = {
    **{flag: _ITEM_12B for flag in (
        "program-cache-dir", "program-cache-max-bytes", "warmup-manifest",
        "chunk-threshold", "chunk-steps", "solve-state-dir",
        "solve-state-ttl-s", "result-cache", "result-cache-max-bytes",
        "result-cache-ttl-s", "shadow-sample-rate", "shadow-deadline-s")},
    "record-trace": _ITEM_12C,
}

_KNOWN = (
    "host", "port", "max-batch", "max-wait-ms", "bucket-sizes",
    "max-programs", "length-bucket-steps", "max-queue",
    "max-body-bytes", "max-lane-cells", "kernel",
    "no-errors", "max-amp", "no-watchdog", "no-server-timing",
    "breaker-threshold", "breaker-cooldown-s", "no-breaker",
    "warmup", "warmup-manifest", "program-cache-dir",
    "program-cache-max-bytes", "chunk-threshold", "chunk-steps",
    "solve-state-dir", "solve-state-ttl-s",
    "brownout-thresholds", "no-brownout", "proxy-token",
    "tenant-inflight-cap", "result-cache",
    "result-cache-max-bytes", "result-cache-ttl-s",
    "shadow-sample-rate", "shadow-deadline-s", "platform",
    "telemetry-dir", "record-trace", "version",
)
_VALUELESS = ("no-errors", "no-watchdog", "no-server-timing",
              "no-breaker", "no-brownout", "result-cache", "version")


def _split_flags(argv: Sequence[str]) -> dict:
    from wavetpu_torch.core.flags import split_flags

    _, flags = split_flags(argv, _KNOWN, _VALUELESS,
                           allow_positionals=False)
    return flags


def _c2_preset(problem: Problem, spec: str):
    """The CLI's --c2-field presets - one shared table
    (stencil_ref.make_preset_c2tau2_field), so a preset name means the
    same physics on both surfaces."""
    from wavetpu_torch.kernels import stencil_ref

    if spec not in stencil_ref.C2_PRESET_NAMES:
        raise ValueError(
            f"c2_field must be one of "
            f"{sorted(stencil_ref.C2_PRESET_NAMES)}, got {spec!r}"
        )
    return stencil_ref.make_preset_c2tau2_field(problem, spec)


def parse_solve_request(body: dict, default_kernel: str = "auto",
                        platform: str = "gpu"):
    """Validate a POST /solve body into a SolveRequest (ValueError on any
    bad field - mapped to HTTP 400).  `platform` is the replica's ("gpu"
    or "cpu"): kernel auto resolves against it.

    The program-identity half (geometry, scheme/path/k/dtype/mesh-shape
    checks) is `progkey.identity_from_body` - the derivation wavetpu's
    router uses for affinity routing, so the key the engine caches under
    and the key a router routes by cannot drift.  This function layers
    on c2-field preset construction and lane validation."""
    from wavetpu_torch.ensemble.batched import LaneSpec
    from wavetpu_torch.serve.scheduler import SolveRequest

    if isinstance(body, dict) and body.get("resume_token") is not None:
        raise ValueError(
            "resume_token is not ported yet: ROADMAP.md queue 1 item 12b "
            "(preemptible long solves)")
    ident = progkey.identity_from_body(
        body, default_kernel, platform=platform
    )
    problem = ident.problem
    stop = body.get("steps")
    stop = None if stop is None else int(stop)
    field = None
    if body.get("c2_field"):
        field = _c2_preset(problem, str(body["c2_field"]))
    phase = float(body.get("phase", 2.0 * 3.141592653589793))
    mesh = ident.mesh
    if mesh is not None:
        from wavetpu_torch.core.grid import Topology

        # The shards go on the visible cards, repeated as needed; a mesh
        # that leaves a shard without a real plane is the body's fault.
        Topology(N=problem.N, mesh_shape=mesh)
    lane = LaneSpec(phase=phase, stop_step=stop, c2tau2_field=field)
    # Surface lane-level errors (bad stop/k alignment) at parse time so
    # they 400 instead of failing the whole batch later.
    if mesh is not None:
        from wavetpu_torch.ensemble.sharded import _validate as _validate_sh

        _validate_sh(problem, [lane], ident.path, compute_errors=False)
    else:
        from wavetpu_torch.ensemble.batched import _validate

        _validate(problem, [lane], ident.path,
                  ident.k if ident.path == "kfused" else 2,
                  compute_errors=False, scheme=ident.scheme)
    # QoS class: JSON `priority` field (the X-Priority header, when
    # trusted, wins - _handle_solve applies it after this).  Unknown
    # values clamp to the default class rather than 400 - priority is a
    # scheduling hint, and a router ceiling may rewrite it anyway.
    from wavetpu_torch.serve.scheduler import normalize_priority

    return SolveRequest(
        problem=problem, lane=lane, scheme=ident.scheme, path=ident.path,
        k=ident.k, dtype_name=ident.dtype,
        mesh_shape=mesh,
        priority=normalize_priority(body.get("priority")),
    )


def _ok_payload(result, batch_info: dict, errors_computed: bool) -> dict:
    """The reference report fields for one lane (io/report.py sidecar
    contract) plus the verbatim text report."""
    from wavetpu_torch.io import report

    p = result.problem
    return {
        "status": "ok",
        "report": {
            "problem": dataclasses.asdict(p),
            "courant": p.courant,
            "init_seconds": result.init_seconds,
            "solve_seconds": result.solve_seconds,
            "gcells_per_second": result.gcells_per_second,
            "cells_per_step": p.cells_per_step,
            "final_step": result.final_step,
            "errors_computed": errors_computed,
            "max_abs_error": (
                float(result.abs_errors.max()) if errors_computed else None
            ),
            "abs_errors": (
                [float(x) for x in result.abs_errors]
                if errors_computed else None
            ),
            "rel_errors": (
                [float(x) for x in result.rel_errors]
                if errors_computed else None
            ),
        },
        "report_text": report.format_report(
            result, errors_computed=errors_computed
        ),
        "batch": batch_info,
    }


_RID_ALLOWED = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.:"
)


def sanitize_request_id(raw: Optional[str]) -> Optional[str]:
    """A caller-supplied X-Request-Id, accepted only when it is plainly
    a token (<= 64 chars from [-A-Za-z0-9_.:]) - anything else is
    dropped so header junk can never be reflected into responses, trace
    attrs, or exemplar labels."""
    if not raw:
        return None
    raw = raw.strip()
    if not raw or len(raw) > 64 or not set(raw) <= _RID_ALLOWED:
        return None
    return raw


def sanitize_tenant(raw: Optional[str]) -> Optional[str]:
    """The `X-Wavetpu-Tenant` label the router stamped after API-key
    termination - same token discipline as request ids, so a hostile
    label can never be reflected into metrics labels, span attrs, or
    ledger lines."""
    return sanitize_request_id(raw)


def format_retry_after(seconds: float) -> str:
    """Integer delta-seconds form of a measured backoff (the only form
    `WavetpuClient.parse_retry_after` promises to read), floored at 1 -
    a sub-second hint rounded to 0 would tell clients to hammer."""
    return str(max(1, int(seconds + 0.5)))


def server_timing_header(timing: dict, total_s: float,
                         warm: Optional[str] = None) -> str:
    """RFC-style `Server-Timing` value from the scheduler's per-request
    attribution: queue/compile/execute are the ADDITIVE wall components
    (their sum ~= total up to parse/serialize overhead - the 10%
    contract tests/test_serve.py pins), padding is the informational
    masked-lane share of execute, total is the server-measured wall.
    `warm` (the engine's true/disk/false/fallback program-source label)
    rides as a desc-only entry - the fleet router reads it off each
    response to learn which replica holds which program without an
    extra /metrics round trip."""
    parts = []
    for name, key in (("queue", "queue_s"), ("compile", "compile_s"),
                      ("execute", "execute_s"), ("padding", "padding_s")):
        parts.append(f"{name};dur={timing.get(key, 0.0) * 1e3:.3f}")
    parts.append(f"total;dur={total_s * 1e3:.3f}")
    if warm is not None:
        parts.append(f"warm;desc={warm}")
    return ", ".join(parts)


class ServerState:
    """Everything the handler needs, hung off the HTTPServer instance.

    `draining` flips on SIGTERM/SIGINT: new /solve requests get 503
    while the batcher flushes what is already queued (graceful drain -
    outstanding futures resolve with results, scheduler.close(drain)).

    `max_body_bytes` / `max_lane_cells` are the pre-scheduling request
    size limits (413 / 422); `server_timing=False` suppresses the
    Server-Timing response header (ops escape hatch)."""

    def __init__(self, engine, batcher, metrics, default_kernel: str,
                 request_timeout: float = 600.0,
                 max_body_bytes: Optional[int] = None,
                 max_lane_cells: Optional[int] = None,
                 server_timing: bool = True,
                 fault_plan=None, proxy_token: Optional[str] = None,
                 tenant_inflight_cap: Optional[int] = None):
        self.engine = engine
        self.batcher = batcher
        self.metrics = metrics
        self.default_kernel = default_kernel
        self.request_timeout = request_timeout
        self.max_body_bytes = max_body_bytes
        self.max_lane_cells = max_lane_cells
        self.server_timing = server_timing
        self.fault_plan = fault_plan
        # Replica-side tenant trust (--proxy-token): with a secret set,
        # X-Wavetpu-Tenant / X-Priority headers are honored ONLY when
        # the request also carries the matching X-Wavetpu-Proxy-Token -
        # i.e. it came through the router, which holds the secret.  A
        # direct-to-replica client without it cannot impersonate a
        # tenant or self-promote its class; the headers are IGNORED
        # (rejection counted) and the request still serves untenanted.
        self.proxy_token = proxy_token
        # Defensive per-tenant concurrency cap (--tenant-inflight-cap):
        # a backstop UNDER the router's authoritative token buckets, so
        # one tenant cannot occupy every handler slot of a replica even
        # if it reaches it directly.  None = off.
        self.tenant_inflight_cap = tenant_inflight_cap
        self._tenant_inflight: dict = {}
        self._tenant_lock = threading.Lock()
        self.started = time.time()
        self.draining = False
        # Readiness: `warming` is True while the background --warmup
        # build runs; /healthz reports ready = not draining and not
        # warming, so a load balancer routes to a replica only once its
        # programs exist and pulls it BEFORE drain kills requests.
        self.warming = False
        self.warmup_error: Optional[str] = None
        # "gpu" or "cpu" (/healthz `backend`): a router resolves
        # kernel=auto against it the same way this replica will.
        self.backend: str = engine.platform
        self._drain_lock = threading.Lock()
        self._drain_started = False

    def begin_drain(self, httpd) -> bool:
        """Graceful drain, shared by SIGTERM/SIGINT and POST
        /admin/drain: refuse new /solve (503 + Retry-After) immediately
        and stop the accept loop from a daemon thread (shutdown() joins
        serve_forever, so it must never run on a handler thread
        in-line).  Idempotent; returns False when already draining."""
        with self._drain_lock:
            first = not self._drain_started
            self._drain_started = True
            self.draining = True
        if first:
            threading.Thread(target=httpd.shutdown, daemon=True).start()
        return first

    def try_acquire_tenant_slot(self, tenant: Optional[str]) -> bool:
        """Take one in-flight slot for `tenant` (always True with the
        cap off or no tenant label).  Pair with release_tenant_slot."""
        if self.tenant_inflight_cap is None or not tenant:
            return True
        with self._tenant_lock:
            n = self._tenant_inflight.get(tenant, 0)
            if n >= self.tenant_inflight_cap:
                return False
            self._tenant_inflight[tenant] = n + 1
            return True

    def release_tenant_slot(self, tenant: Optional[str]) -> None:
        if self.tenant_inflight_cap is None or not tenant:
            return
        with self._tenant_lock:
            n = self._tenant_inflight.get(tenant, 0) - 1
            if n <= 0:
                self._tenant_inflight.pop(tenant, None)
            else:
                self._tenant_inflight[tenant] = n


class _Handler(BaseHTTPRequestHandler):
    # HTTP/1.1 = persistent connections: the fleet router and the
    # keep-alive WavetpuClient reuse one socket across requests instead
    # of paying a TCP handshake each (BaseHTTPRequestHandler defaults
    # to 1.0/close).  Safe because _send_text is the single send path
    # and always sets Content-Length; responses that skip reading the
    # request body send `Connection: close` so leftover bytes can never
    # be parsed as the next request on the same socket.
    protocol_version = "HTTP/1.1"

    # quiet by default; the scheduler's numbers live in /metrics
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def state(self) -> ServerState:
        return self.server.wavetpu_state

    def _send(self, code: int, payload,
              headers: Optional[dict] = None) -> None:
        if isinstance(payload, (bytes, bytearray)):
            # A result-cache hit (or a just-stored fresh solve) replays
            # the EXACT serialized payload - bytes, not a re-encodable
            # dict - so hits are byte-identical by construction.
            self._send_raw(code, bytes(payload), "application/json",
                           headers)
            return
        self._send_text(code, json.dumps(payload), "application/json",
                        headers)

    def _send_raw(self, code: int, body: bytes, content_type: str,
                  headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, content_type: str,
                   headers: Optional[dict] = None) -> None:
        self._send_raw(code, text.encode(), content_type, headers)

    def do_GET(self) -> None:  # noqa: N802 (stdlib contract)
        if self.path == "/healthz":
            from wavetpu_torch.obs import perf

            age = self.state.metrics.last_batch_age()
            # Device-memory visibility for the balancer/autoscaler:
            # None on the CPU, else the CUDA caching allocator's live +
            # peak byte counts.  Unit pinned in the
            # field names, like last_batch_age_seconds.
            mem = perf.memory_snapshot()
            # Liveness vs READINESS: "status: ok" = the process serves
            # HTTP (liveness); "ready" = route traffic here (false while
            # the warmup build is still running, or once draining is
            # set - so a load balancer stops routing BEFORE drain starts
            # failing requests, not after).
            payload = {
                "status": "ok",
                "ready": (
                    not self.state.draining and not self.state.warming
                ),
                "uptime_seconds": round(
                    time.time() - self.state.started, 3
                ),
                "draining": self.state.draining,
                "warming": self.state.warming,
                "last_batch_age_seconds": (
                    None if age is None else round(age, 3)
                ),
                "memory_bytes_in_use": (
                    None if mem is None else mem["bytes_in_use"]
                ),
                "memory_peak_bytes": (
                    None if mem is None else mem["peak_bytes"]
                ),
                "backend": self.state.backend,
            }
            brownout = getattr(self.state.batcher, "brownout", None)
            if brownout is not None:
                # The overload ladder's state, for balancers and ops:
                # rung 0 = healthy; higher rungs shed classes
                # (docs/robustness.md "Brownout ladder").
                brownout.update()
                payload["brownout"] = brownout.snapshot()
            if self.state.warmup_error is not None:
                payload["warmup_error"] = self.state.warmup_error
            self._send(200, payload)
        elif self.path == "/metrics":
            accept = self.headers.get("Accept", "") or ""
            # A client that lists application/json at all (e.g. the
            # axios default "application/json, text/plain, */*") gets
            # JSON; Prometheus scrapers send text/plain or openmetrics
            # without it.
            wants_text = (
                "application/json" not in accept
                and ("text/plain" in accept or "openmetrics" in accept)
            )
            if wants_text:
                # Prometheus text exposition - one consistent registry
                # cut (scrape config: docs/observability.md).  An
                # openmetrics Accept additionally gets request-id
                # EXEMPLARS on the latency histogram buckets (+ # EOF).
                openmetrics = "openmetrics" in accept
                self._send_text(
                    200,
                    self.state.metrics.registry.render_prometheus(
                        openmetrics=openmetrics
                    ),
                    "application/openmetrics-text; version=1.0.0; "
                    "charset=utf-8" if openmetrics
                    else "text/plain; version=0.0.4; charset=utf-8",
                )
                return
            snap = self.state.metrics.snapshot()
            snap["program_cache"] = self.state.engine.cache_stats()
            snap["breaker"] = self.state.engine.breaker_stats()
            self._send(200, snap)
        else:
            self._send(404, {"status": "error", "error": "not found"})

    def do_POST(self) -> None:  # noqa: N802
        if self.path == "/admin/drain":
            # HTTP-equivalent of SIGTERM, for a rolling fleet deploy: flip
            # draining (healthz ready -> false, new /solve -> 503 +
            # Retry-After) and stop the accept loop; queued
            # work flushes to completion exactly like the signal path.
            # Idempotent - a second call reports already_draining.
            first = self.state.begin_drain(self.server)
            self._send(200, {
                "status": "ok",
                "draining": True,
                "already_draining": not first,
            }, {"Connection": "close"})
            return
        if self.path != "/solve":
            self._send(404, {"status": "error", "error": "not found"},
                       {"Connection": "close"})
            return
        # Chaos seam: connection drop - close the socket with no
        # response at all, the failure mode a crashed proxy or a
        # severed network produces (the retrying client must absorb it
        # as a transport error).
        plan = self.state.fault_plan
        if plan is not None and plan.active and plan.fire("conn-drop"):
            self.close_connection = True
            try:
                self.connection.close()
            except OSError:
                pass
            return
        # One `serve.request` span per request: its wall time is the
        # end-to-end latency; the scheduler-thread `serve.batch` span
        # that carried it joins on the shared request_id attribute
        # (trace-report --request ID stitches the two).  A caller-
        # supplied X-Request-Id (the loadgen minted one) becomes THE id
        # - so the client-side report and the server-side trace agree
        # on the join key without any translation table.
        rid = sanitize_request_id(self.headers.get("X-Request-Id"))
        rid = rid or tracing.new_id()
        # Fleet trace adoption (docs/observability.md "Distributed
        # tracing"): an inbound W3C `traceparent` (a router attempt, or
        # a bare WavetpuClient) becomes the REMOTE parent of this
        # serve.request span, so the replica's whole tree hangs under
        # the fleet trace id; a traced request with no inbound context
        # mints its own trace id.  The span advertises a 16-hex
        # `w3c_id` the joiner resolves cross-process, and the context
        # is echoed on the response either way - even untraced, the
        # inbound header is reflected so the client's join handle
        # always answers.
        inbound_tp = self.headers.get("traceparent")
        ctx = tracing.parse_traceparent(inbound_tp)
        echo_tp = inbound_tp if ctx else None
        span = None
        self._trace_context: Optional[Tuple[str, str]] = None
        if tracing.enabled():
            trace_id = ctx[0] if ctx else tracing.mint_trace_id()
            w3c = tracing.mint_span_id()
            echo_tp = tracing.format_traceparent(trace_id, w3c)
            self._trace_context = (trace_id, w3c)
            span = tracing.begin_span(
                "serve.request",
                remote=(trace_id, ctx[1] if ctx else None),
                request_id=rid, w3c_id=w3c,
            )
        code = None
        headers: dict = {}
        # Per-tenant in-flight accounting: _handle_solve records the
        # slot it took here; releasing in THIS finally covers every
        # return path (including handler exceptions).
        self._tenant_slot: Optional[str] = None
        try:
            code, payload, headers = self._handle_solve(rid)
        finally:
            self.state.release_tenant_slot(self._tenant_slot)
            # An unexpected handler exception must not leak the open
            # span (it would poison this thread's parent stack and
            # vanish from the trace).
            tracing.end_span(
                span, status="exception" if code is None else code
            )
        if rid:
            headers.setdefault("X-Request-Id", rid)
        if echo_tp:
            headers.setdefault("traceparent", echo_tp)
        self._send(code, payload, headers)

    def _handle_solve(self, rid) -> Tuple[int, dict, dict]:
        from wavetpu_torch.serve.resilience import (
            DeadlineExceededError,
            QuarantinedError,
            ShedError,
            WorkerCrashError,
        )
        from wavetpu_torch.serve.scheduler import (
            QueueFullError,
            normalize_priority,
        )

        st = self.state
        queue_depth = getattr(st.batcher, "_depth", 0)
        if st.draining:
            # Connection: close because the request body is never read
            # on this path - leftover bytes on a kept-alive socket
            # would be parsed as the next request.  Retry-After is the
            # MEASURED drain estimate for what is still queued (the
            # historical 2 s stands in when no rate has been observed).
            st.metrics.observe_response(False)
            return 503, {
                "status": "error",
                "error": "server draining (shutting down)",
                "retriable": True,
            }, {
                "Retry-After": format_retry_after(
                    st.metrics.retry_after_s(queue_depth, fallback=2.0)
                ),
                "Connection": "close",
            }
        t0 = time.monotonic()
        try:
            length = int(self.headers.get("Content-Length", "0") or 0)
            if length < 0:
                # A negative length would turn rfile.read(length) into
                # read-to-EOF and pin this handler thread forever.
                raise ValueError(length)
        except (TypeError, ValueError):
            # A malformed Content-Length is a 400 like any other bad
            # field, not a dropped connection (or a hung thread).
            st.metrics.observe_response(False)
            return 400, {
                "status": "error",
                "error": "malformed Content-Length header",
            }, {"Connection": "close"}
        if st.max_body_bytes is not None and length > st.max_body_bytes:
            # Refused before the body is even read: an oversized upload
            # must not be buffered just to be thrown away.
            st.metrics.observe_limit_rejected("body_bytes")
            st.metrics.observe_response(False)
            return 413, {
                "status": "error",
                "error": (
                    f"request body {length} bytes exceeds "
                    f"--max-body-bytes {st.max_body_bytes}"
                ),
            }, {"Connection": "close"}
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
            req = parse_solve_request(body, st.default_kernel,
                                      platform=st.backend)
            tenant_hdr = self.headers.get("X-Wavetpu-Tenant")
            prio_hdr = self.headers.get("X-Priority")
            if st.proxy_token is not None and (tenant_hdr or prio_hdr):
                # Replica-side tenant trust: identity/class headers are
                # honored only from the router (it holds --proxy-token).
                # A direct client's claim is IGNORED - the request still
                # serves, untenanted and at its body-declared class.
                if self.headers.get("X-Wavetpu-Proxy-Token") \
                        != st.proxy_token:
                    st.metrics.observe_tenant_spoof_rejected()
                    tenant_hdr = prio_hdr = None
            tenant = sanitize_tenant(tenant_hdr)
            if tenant is not None:
                req = dataclasses.replace(req, tenant=tenant)
            if prio_hdr:
                # The router-stamped (ceiling-clamped) class wins over
                # the body's self-declared one.
                req = dataclasses.replace(req, priority=normalize_priority(
                    prio_hdr, default=req.priority
                ))
            # Deadline contract: `X-Deadline-Ms` header (proxy-settable,
            # wins) or JSON `deadline_ms` - a RELATIVE budget in ms from
            # server receipt.  None (the historical default) disables
            # every deadline path bit-for-bit.
            raw_dl = self.headers.get("X-Deadline-Ms")
            if raw_dl is None:
                raw_dl = body.get("deadline_ms")
            deadline = deadline_ms = None
            if raw_dl is not None:
                deadline_ms = float(raw_dl)
                if not deadline_ms > 0:
                    raise ValueError(
                        f"deadline_ms must be > 0, got {deadline_ms}"
                    )
                deadline = t0 + deadline_ms / 1e3
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            st.metrics.observe_response(False)
            return 400, {"status": "error", "error": str(e)}, {}
        cells = req.problem.cells_per_step
        if st.max_lane_cells is not None and cells > st.max_lane_cells:
            # A parseable but oversized grid is rejected BEFORE it can
            # occupy a scheduler slot or force a huge program compile.
            st.metrics.observe_limit_rejected("lane_cells")
            st.metrics.observe_response(False)
            return 422, {
                "status": "error",
                "error": (
                    f"lane grid (N+1)^3 = {cells} cells exceeds "
                    f"--max-lane-cells {st.max_lane_cells}"
                ),
            }, {}
        if not st.try_acquire_tenant_slot(req.tenant):
            # Defensive per-tenant in-flight cap (--tenant-inflight-cap):
            # the router's token buckets are the authoritative quota;
            # this is the replica's backstop against a tenant that
            # bypasses or outraces them.  429 like quota exhaustion,
            # with the measured queue-drain estimate as the hint.
            st.metrics.observe_tenant_inflight_rejected(req.tenant)
            st.metrics.observe_response(False)
            return 429, {
                "status": "error",
                "error": (
                    f"tenant {req.tenant!r} is at its in-flight cap "
                    f"({st.tenant_inflight_cap})"
                ),
                "retriable": True,
            }, {"Retry-After": format_retry_after(
                st.metrics.retry_after_s(queue_depth)
            )}
        self._tenant_slot = req.tenant
        try:
            fut = st.batcher.submit(
                req, request_id=rid, deadline=deadline,
                trace_context=getattr(self, "_trace_context", None),
            )
        except QueueFullError as e:
            # Bounded-queue backpressure: shed load NOW instead of
            # stacking latency the client will time out on anyway,
            # with a Retry-After hint so a well-behaved client backs
            # off instead of hammering.  (Sub-millisecond rejections
            # stay out of the latency reservoir - they would drag p50
            # to ~0 under overload.)  Retry-After is MEASURED: the
            # queue-drain estimate from recent batch throughput, not a
            # constant - a deep backlog says "come back later", a
            # transient blip says "1s".
            st.metrics.observe_response(False)
            return 429, {
                "status": "error", "error": str(e), "retriable": True,
            }, {"Retry-After": format_retry_after(
                st.metrics.retry_after_s(queue_depth)
            )}
        except ShedError as e:
            # Brownout ladder: queue-wait p95 over threshold and this
            # request's class is at/below the rung being shed.  The
            # replica is overloaded, not broken - retriable 503 whose
            # Retry-After is the measured drain estimate the ladder
            # computed at shed time.
            st.metrics.observe_response(False)
            return 503, {
                "status": "error", "error": str(e), "retriable": True,
                "shed_rung": e.rung,
            }, {"Retry-After": format_retry_after(e.retry_after_s)}
        except Exception as e:
            # A closed batcher ("batcher is closed" during shutdown)
            # gets its 500 JSON, not a connection reset - the
            # historical handler's contract.
            st.metrics.observe_response(False)
            return 500, {"status": "error", "error": str(e)}, {}
        # The handler never outwaits the caller's deadline: with a
        # budget set, the wait on the future is bounded by it (plus a
        # small grace for a result racing in), so "no future ever hangs
        # past its deadline" holds even when the scheduler is wedged
        # mid-batch.  Without a budget the historical request_timeout
        # stands.
        wait_s = st.request_timeout
        if deadline is not None:
            wait_s = min(
                wait_s, max(0.0, deadline - time.monotonic()) + 0.050
            )
        try:
            lane_result, lane_error, batch_info = fut.result(wait_s)
        except DeadlineExceededError as e:
            # The scheduler dropped it in queue: 504 with attribution.
            st.metrics.observe_response(False)
            payload = {
                "status": "error", "error": str(e),
                "deadline_ms": deadline_ms,
            }
            if e.queue_s is not None:
                payload["queue_ms"] = round(e.queue_s * 1e3, 3)
            return 504, payload, {}
        except QuarantinedError as e:
            # Circuit-broken program key: shed with the remaining
            # cooldown as the Retry-After hint.
            st.metrics.observe_response(False)
            return 503, {
                "status": "error", "error": str(e), "retriable": True,
            }, {"Retry-After": str(max(1, int(e.retry_after_s + 0.5)))}
        except WorkerCrashError as e:
            # The scheduler worker died mid-batch and was restarted:
            # the request itself is fine - retriable 503, never a hang.
            # Retry-After from the drain estimate: the restarted worker
            # re-marches the requeued backlog before fresh retries land.
            st.metrics.observe_response(False)
            return 503, {
                "status": "error", "error": str(e), "retriable": True,
            }, {"Retry-After": format_retry_after(
                st.metrics.retry_after_s(queue_depth)
            )}
        except FuturesTimeoutError:
            st.metrics.observe_response(False)
            # 504 only when the DEADLINE is what ran out: a budget
            # longer than request_timeout can cap the wait at the
            # timeout with budget to spare, and that case must keep the
            # historical (retriable-by-the-client) timeout 500, not
            # masquerade as an expired deadline.
            if deadline is not None and time.monotonic() >= deadline:
                return 504, {
                    "status": "error",
                    "error": (
                        f"deadline_ms {deadline_ms:g} expired while the "
                        f"request was in flight (queue + execute "
                        f"exceeded the budget)"
                    ),
                    "deadline_ms": deadline_ms,
                }, {}
            return 500, {
                "status": "error",
                "error": (
                    f"request timed out after {wait_s:g}s"
                ),
            }, {}
        except Exception as e:
            st.metrics.observe_response(False)
            return 500, {"status": "error", "error": str(e)}, {}
        finally:
            st.metrics.observe_latency(time.monotonic() - t0,
                                       request_id=rid)
        headers = {}
        timing = batch_info.get("timing")
        if st.server_timing and timing is not None:
            headers["Server-Timing"] = server_timing_header(
                timing, time.monotonic() - t0,
                warm=batch_info.get("warm"),
            )
        if lane_error is not None:
            st.metrics.observe_response(False)
            return 422, {
                "status": "error",
                "error": lane_error,
                "batch": batch_info,
            }, headers
        errors_computed = (
            st.engine.compute_errors and req.lane.c2tau2_field is None
        )
        st.metrics.observe_response(True)
        return 200, _ok_payload(lane_result, batch_info,
                                errors_computed), headers


def build_server(
    host: str = "127.0.0.1",
    port: int = 0,
    bucket_sizes: Sequence[int] = (1, 2, 4, 8),
    max_batch: Optional[int] = None,
    max_wait: float = 0.025,
    max_programs: int = 8,
    compute_errors: bool = True,
    watchdog: bool = True,
    max_amp: Optional[float] = None,
    default_kernel: str = "auto",
    device=None,
    length_bucket_steps: Optional[int] = None,
    max_queue: Optional[int] = None,
    max_body_bytes: Optional[int] = None,
    max_lane_cells: Optional[int] = None,
    server_timing: bool = True,
    breaker_threshold: Optional[int] = 3,
    breaker_cooldown_s: float = 30.0,
    fault_plan=None,
    brownout: bool = True,
    brownout_thresholds: Sequence[float] = (0.5, 2.0, 8.0),
    proxy_token: Optional[str] = None,
    tenant_inflight_cap: Optional[int] = None,
) -> Tuple[ThreadingHTTPServer, ServerState]:
    """Assemble engine + batcher + HTTP server on `device` (default: the
    CUDA device, raising without one; "cpu" runs the kernels' plain
    versions).  Port 0 = ephemeral; the bound port is
    `httpd.server_address[1]`.  The returned httpd is not yet serving -
    call `serve_forever()` (main does) or drive it from a thread (tests
    do).  `length_bucket_steps` turns on stop-length bucketing in the
    scheduler; `max_queue` bounds the request queue (full -> 429);
    `max_body_bytes`/`max_lane_cells` refuse oversized requests before
    scheduling (413/422).  `breaker_threshold`/`breaker_cooldown_s`
    configure the per-ProgramKey circuit breaker (None disables);
    `fault_plan` (a run/faults.ServeFaultPlan, default WAVETPU_FAULT) is
    ONE shared chaos-injection plan across engine, scheduler and handler
    so count-limited budgets mean what they say.  Engine and metrics
    share ONE MetricsRegistry, so the Prometheus exposition at /metrics
    is a single consistent cut.  `brownout`/`brownout_thresholds`
    configure the adaptive overload ladder; `proxy_token` gates
    tenant/priority headers to router-stamped requests only, and
    `tenant_inflight_cap` bounds any one tenant's concurrent in-flight
    solves at this replica."""
    from wavetpu_torch.obs.registry import MetricsRegistry
    from wavetpu_torch.run import faults
    from wavetpu_torch.serve.engine import ServeEngine
    from wavetpu_torch.serve.scheduler import (
        BrownoutController, DynamicBatcher, ServeMetrics,
    )

    registry = MetricsRegistry()
    if fault_plan is None:
        fault_plan = faults.serve_plan_from_env()
    engine = ServeEngine(
        bucket_sizes=bucket_sizes, max_programs=max_programs,
        compute_errors=compute_errors, device=device,
        watchdog=watchdog, max_amp=max_amp, registry=registry,
        breaker_threshold=breaker_threshold,
        breaker_cooldown_s=breaker_cooldown_s, fault_plan=fault_plan,
    )
    metrics = ServeMetrics(registry=registry)
    bo = (
        BrownoutController(thresholds=tuple(brownout_thresholds))
        if brownout else None
    )
    batcher = DynamicBatcher(
        engine, metrics=metrics, max_batch=max_batch, max_wait=max_wait,
        length_bucket_steps=length_bucket_steps, max_queue=max_queue,
        fault_plan=fault_plan, brownout=bo,
    )
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.wavetpu_state = ServerState(
        engine, batcher, metrics, default_kernel,
        max_body_bytes=max_body_bytes, max_lane_cells=max_lane_cells,
        server_timing=server_timing, fault_plan=fault_plan,
        proxy_token=proxy_token, tenant_inflight_cap=tenant_inflight_cap,
    )
    return httpd, httpd.wavetpu_state


def _warm(state: ServerState, parts: Sequence[int]) -> None:
    """--warmup N,TIMESTEPS[,K] in the background: build the tier's
    solvers for every bucket (kfused at K > 1, else the replica's auto
    kernel) while /healthz says `warming`.  Builds only - the scheduler's
    worker stays the only thread that launches kernels.  A failure is
    recorded (/healthz `warmup_error`) and the replica keeps serving."""
    try:
        wp = Problem(N=parts[0], timesteps=parts[1])
        k = parts[2] if len(parts) == 3 else 1
        path = "kfused" if k > 1 else progkey.resolve_kernel(
            "auto", state.backend)
        warmed = state.engine.warmup(wp, path=path, k=max(k, 2))
        print(f"warmed buckets {warmed} for N={wp.N} path={path}")
    except Exception as e:
        state.warmup_error = str(e)
        print(f"warmup failed: {e}", file=sys.stderr)
    finally:
        state.warming = False


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        flags = _split_flags(argv)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2
    if "version" in flags:
        from wavetpu_torch import __version__

        print(f"wavetpu-torch-serve {__version__}")
        return 0
    for name, item in _NOT_PORTED.items():
        if name in flags:
            print(f"error: --{name} is not ported yet: ROADMAP.md {item}",
                  file=sys.stderr)
            return 2
    try:
        host = flags.get("host", "127.0.0.1")
        port = int(flags.get("port", "8077"))
        buckets = tuple(
            int(x) for x in flags.get("bucket-sizes", "1,2,4,8").split(",")
        )
        max_batch = (
            int(flags["max-batch"]) if "max-batch" in flags else None
        )
        max_wait = float(flags.get("max-wait-ms", "25")) / 1e3
        max_programs = int(flags.get("max-programs", "8"))
        length_bucket_steps = (
            int(flags["length-bucket-steps"])
            if "length-bucket-steps" in flags else None
        )
        max_queue = (
            int(flags["max-queue"]) if "max-queue" in flags else None
        )
        max_body_bytes = (
            int(flags["max-body-bytes"])
            if "max-body-bytes" in flags else None
        )
        max_lane_cells = (
            int(flags["max-lane-cells"])
            if "max-lane-cells" in flags else None
        )
        max_amp = float(flags["max-amp"]) if "max-amp" in flags else None
        breaker_threshold = (
            None if "no-breaker" in flags
            else int(flags.get("breaker-threshold", "3"))
        )
        breaker_cooldown_s = float(flags.get("breaker-cooldown-s", "30"))
        kernel = flags.get("kernel", "auto")
        if kernel not in ("auto", "roll", "pallas"):
            raise ValueError(
                f"--kernel must be auto|roll|pallas, got {kernel}"
            )
        platform = flags.get("platform", "gpu")
        if platform not in ("gpu", "cpu"):
            raise ValueError(f"--platform must be gpu|cpu, got {platform}")
        warmup_parts = None
        if "warmup" in flags:
            warmup_parts = [int(x) for x in flags["warmup"].split(",")]
            if len(warmup_parts) not in (2, 3):
                raise ValueError("--warmup wants N,TIMESTEPS[,K]")
        brownout_thresholds = tuple(
            float(x)
            for x in flags.get("brownout-thresholds", "0.5,2,8").split(",")
        )
        if len(brownout_thresholds) != 3:
            raise ValueError(
                "--brownout-thresholds wants P1,P2,P3 (three seconds "
                "values, ascending)"
            )
        tenant_inflight_cap = (
            int(flags["tenant-inflight-cap"])
            if "tenant-inflight-cap" in flags else None
        )
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2

    import torch

    if platform == "gpu" and not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU unless "
              "--platform cpu is given", file=sys.stderr)
        return 2

    httpd, state = build_server(
        host=host, port=port, bucket_sizes=buckets, max_batch=max_batch,
        max_wait=max_wait, max_programs=max_programs,
        compute_errors="no-errors" not in flags,
        watchdog="no-watchdog" not in flags, max_amp=max_amp,
        default_kernel=kernel,
        device="cuda" if platform == "gpu" else "cpu",
        length_bucket_steps=length_bucket_steps,
        max_queue=max_queue, max_body_bytes=max_body_bytes,
        max_lane_cells=max_lane_cells,
        server_timing="no-server-timing" not in flags,
        breaker_threshold=breaker_threshold,
        breaker_cooldown_s=breaker_cooldown_s,
        brownout="no-brownout" not in flags,
        brownout_thresholds=brownout_thresholds,
        proxy_token=flags.get("proxy-token"),
        tenant_inflight_cap=tenant_inflight_cap,
    )
    telemetry = None
    serving = False
    try:
        if "telemetry-dir" in flags:
            # Tracing (request/batch/compile spans) + heartbeat snapshots
            # of THIS server's registry, tailable while it serves.
            from wavetpu_torch.obs import telemetry as _tel

            telemetry = _tel.start(
                flags["telemetry-dir"], registry=state.metrics.registry
            )
            print(f"telemetry: {flags['telemetry-dir']}")
        if warmup_parts is not None:
            # Warm in the BACKGROUND so /healthz answers `ready: false`
            # while the build runs (the load balancer's routing signal).
            state.warming = True
            threading.Thread(
                target=_warm, args=(state, warmup_parts),
                name="wavetpu-warmup", daemon=True,
            ).start()

        bound = httpd.server_address
        device = state.engine.device
        name = (torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")
        print(
            f"wavetpu_torch serve on http://{bound[0]}:{bound[1]} "
            f"(device={name}, max_batch={state.batcher.max_batch}, "
            f"max_wait={state.batcher.max_wait * 1e3:g}ms, buckets="
            f"{state.engine.bucket_sizes})", flush=True
        )
        import signal

        def _shutdown(signum, frame):
            # Graceful drain: refuse new /solve (503) immediately, stop
            # the accept loop, and let the finally block flush what is
            # queued.  Shared with POST /admin/drain.
            state.begin_drain(httpd)

        signal.signal(signal.SIGTERM, _shutdown)
        signal.signal(signal.SIGINT, _shutdown)
        serving = True
        httpd.serve_forever()
    finally:
        # Once serving, drain=True resolves every outstanding future
        # with its RESULT (queued batches are flushed through the
        # engine) instead of erroring them.  Before serve started there
        # is nothing to drain - close fast, and never leak the batcher
        # worker thread, the listening socket, or a running heartbeat.
        state.batcher.close(timeout=120.0 if serving else 5.0,
                            drain=serving)
        httpd.server_close()
        if telemetry is not None:
            telemetry.stop()
    print("wavetpu_torch serve: shut down cleanly (drained)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
