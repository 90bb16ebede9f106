"""Replay a scenario trace against a live replica or router (the port's
copy of wavetpu/loadgen/runner.py).

Two drive modes (the standard loadgen pair):

 * OPEN loop - fire each request at its trace timestamp (optionally
   time-scaled by `speed`), regardless of whether earlier requests have
   returned: measures the server under the OFFERED load, including
   queue growth and 429 shedding.  This is the mode arrival-process
   realism (poisson / diurnal traces) exists for.
 * CLOSED loop - `concurrency` workers each hold at most one request in
   flight and send the next the moment the previous returns, ignoring
   timestamps: measures sustainable throughput and per-request latency
   at a fixed multiprogramming level.

Both modes run an optional WARMUP phase first (one request per distinct
scenario tier, excluded from the measurement) so a report's p99 is the
steady state, not the first-contact compile - unless the trace is
explicitly cache-adversarial (hotkey mix), where warmup is the thing
being measured and should be 0.

Every request carries a minted `X-Request-Id` header; the server echoes
it, tags its trace spans with it, and pins it as the exemplar on the
latency histogram bucket - so any outlier in the client-side report is
joinable to its server-side critical path via
`python -m wavetpu_torch trace-report --request ID`.  The response's
`Server-Timing` header is parsed into per-request queue/compile/execute/padding
seconds.  `/metrics` (Prometheus text view) is scraped before and after
the measured phase; the report layer turns the deltas into occupancy,
padding-waste, reject-rate and cold-vs-warm compile numbers for exactly
the replayed window.

Pure stdlib; imports neither torch nor jax.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Union

from wavetpu_torch.obs.tracing import format_traceparent, mint_span_id, \
    mint_trace_id


class PreflightError(RuntimeError):
    """The target server failed the health preflight - replaying a
    trace at a down/draining server would produce a garbage report."""


def _get(url: str, timeout: float, accept: Optional[str] = None):
    req = urllib.request.Request(
        url, headers={"Accept": accept} if accept else {}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def preflight(base_url: str, timeout: float = 10.0) -> dict:
    """Assert the target is alive, READY, and accepting BEFORE replay:
    /healthz must answer 200 with status ok, `ready` not false (false =
    still warming or draining - a load balancer would not route there,
    so neither does the loadgen), and draining false.  Returns the
    health payload (uptime, last_batch_age_seconds - null means the
    server has never executed a batch, i.e. replay starts cold)."""
    url = base_url.rstrip("/") + "/healthz"
    try:
        status, text = _get(url, timeout)
        health = json.loads(text)
    except (OSError, ValueError, urllib.error.URLError) as e:
        raise PreflightError(f"cannot reach {url}: {e}")
    if status != 200 or health.get("status") != "ok":
        raise PreflightError(f"{url} unhealthy: {health}")
    if health.get("ready") is False:
        raise PreflightError(
            f"{url} not ready "
            f"(warming={health.get('warming')}, "
            f"draining={health.get('draining')})"
        )
    if health.get("draining"):
        raise PreflightError(f"{url} is draining (shutting down)")
    return health


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Minimal Prometheus 0.0.4 text parser: {sample_name_with_labels:
    value}.  Enough for metric deltas; exemplar suffixes and # EOF (the
    OpenMetrics render) are tolerated but the loadgen scrapes the plain
    text view anyway."""
    samples: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if " # " in line:  # OpenMetrics exemplar suffix
            line = line.split(" # ", 1)[0]
        name, _, value = line.rpartition(" ")
        if not name:
            continue
        try:
            samples[name] = float(value.replace("+Inf", "inf"))
        except ValueError:
            continue
    return samples


def scrape_metrics(base_url: str, timeout: float = 30.0
                   ) -> Dict[str, float]:
    """One consistent /metrics cut in the Prometheus text view (it
    carries cells/solve-seconds/occupancy-sum counters the JSON
    snapshot summarizes away)."""
    _, text = _get(
        base_url.rstrip("/") + "/metrics", timeout, accept="text/plain"
    )
    return parse_prometheus_text(text)


def parse_server_timing(header: Optional[str]) -> Dict[str, float]:
    """`queue;dur=1.2, execute;dur=45` -> {"queue": 0.0012, ...}
    (seconds).  Unparseable entries are skipped - the report must not
    die on a proxy that rewrites headers."""
    out: Dict[str, float] = {}
    if not header:
        return out
    for part in header.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, params = part.partition(";")
        for p in params.split(";"):
            k, _, v = p.strip().partition("=")
            if k == "dur":
                try:
                    out[name.strip()] = float(v) / 1e3
                except ValueError:
                    pass
    return out


@dataclasses.dataclass
class RequestOutcome:
    """One replayed request, client-side view + parsed Server-Timing.
    `attempts` > 1 means the retrying client (`--retries`) absorbed
    retriable failures before this final status."""

    index: int
    scenario: str
    request_id: str
    status: int            # HTTP status; 0 = transport error/timeout
    latency_s: float
    t_sent: float          # offset from replay start
    server_timing: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    error: Optional[str] = None
    attempts: int = 1
    target: str = ""       # which --target URL served this request
    traceparent: str = ""  # W3C context the request carried (fleet
                           # trace join handle for trace-report)
    tenant: str = ""       # the record's tenant label (QoS traces)
    priority: str = ""     # the record's declared priority class
    # Measured oracle error from the response sidecar
    # (report.max_abs_error) - None when the server did not compute
    # errors (c2-field lane, --no-errors server).  Feeds the report's
    # per-tier error-budget table and the --error-slo gate.
    max_abs_error: Optional[float] = None


@dataclasses.dataclass
class ReplayResult:
    outcomes: List[RequestOutcome]
    warmup_outcomes: List[RequestOutcome]
    metrics_before: Dict[str, float]   # summed across targets
    metrics_after: Dict[str, float]    # summed across targets
    wall_seconds: float
    mode: str
    concurrency: int
    speed: float
    targets: List[str] = dataclasses.field(default_factory=list)
    failover: bool = False             # --failover: one HA client
    endpoint_failovers: int = 0        # times the client rotated
    # Share of replayed requests whose canonical body is a repeat of an
    # earlier one - the result-cache tier's opportunity ceiling (a
    # warm hit rate can never exceed it).
    duplicate_rate: float = 0.0


def duplicate_rate_of(records: Sequence[dict]) -> float:
    """1 - unique canonical bodies / total over `records` (0.0 when
    empty).  Canonicalized with sort_keys so key order never makes two
    identical requests look distinct."""
    bodies = [
        json.dumps(r.get("body") or {}, sort_keys=True) for r in records
    ]
    if not bodies:
        return 0.0
    return 1.0 - len(set(bodies)) / len(bodies)


def sum_metrics(cuts: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Sample-wise sum of several /metrics cuts - the fleet view of N
    replicas' counters (deltas of a sum = sum of deltas, so the report
    layer's delta math is unchanged)."""
    out: Dict[str, float] = {}
    for cut in cuts:
        for name, value in cut.items():
            out[name] = out.get(name, 0.0) + value
    return out


def _qos_headers(rec: dict) -> Dict[str, str]:
    """Map a record's multi-tenant QoS fields onto request headers:
    api_key -> X-Api-Key (the authenticated-router form), tenant ->
    X-Wavetpu-Tenant (open-router labeling; a keyed router strips it
    and stamps its own), priority -> X-Priority."""
    h: Dict[str, str] = {}
    if rec.get("api_key"):
        h["X-Api-Key"] = str(rec["api_key"])
    if rec.get("tenant"):
        h["X-Wavetpu-Tenant"] = str(rec["tenant"])
    if rec.get("priority"):
        h["X-Priority"] = str(rec["priority"])
    return h


def _sidecar_error(payload) -> Optional[float]:
    """report.max_abs_error from a parsed /solve body (None when the
    server did not compute errors, or the body is not the sidecar
    shape - a proxy error page must not kill the replay)."""
    if not isinstance(payload, dict):
        return None
    report = payload.get("report")
    if not isinstance(report, dict):
        return None
    v = report.get("max_abs_error")
    return float(v) if isinstance(v, (int, float)) else None


def _post_one(base_url: str, index: int, rec: dict, rid: str,
              t_sent: float, timeout: float,
              client=None) -> RequestOutcome:
    qos = _qos_headers(rec)
    if client is not None:
        # The retrying path (`--retries`): wavetpu_torch.client.WavetpuClient
        # absorbs transport errors / 429 / 500 / 503 with jittered
        # backoff honoring Retry-After; the SAME request id rides every
        # attempt, so the report's join handles still resolve.
        out = client.solve(rec["body"], request_id=rid,
                           headers=qos or None)
        return RequestOutcome(
            index=index, scenario=rec.get("scenario", "?"),
            request_id=rid, status=out.status,
            latency_s=out.latency_s, t_sent=t_sent,
            server_timing=parse_server_timing(
                out.headers.get("Server-Timing")
            ),
            error=out.error, attempts=out.attempts,
            target=base_url.rstrip("/"),
            traceparent=out.traceparent,
            tenant=rec.get("tenant", "") or "",
            priority=rec.get("priority", "") or "",
            max_abs_error=_sidecar_error(out.payload),
        )
    body = json.dumps(rec["body"]).encode()
    traceparent = format_traceparent(mint_trace_id(), mint_span_id())
    req = urllib.request.Request(
        base_url.rstrip("/") + "/solve", data=body,
        headers={
            "Content-Type": "application/json",
            "X-Request-Id": rid,
            "traceparent": traceparent,
            **qos,
        },
    )
    t0 = time.perf_counter()
    status, timing, err, measured_err = 0, {}, None, None
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            raw = r.read()
            status = r.status
            timing = parse_server_timing(r.headers.get("Server-Timing"))
            try:
                measured_err = _sidecar_error(json.loads(raw))
            except (ValueError, TypeError):
                measured_err = None
    except urllib.error.HTTPError as e:
        status = e.code
        timing = parse_server_timing(e.headers.get("Server-Timing"))
        try:
            err = json.loads(e.read()).get("error")
        except Exception:
            err = str(e)
    except (OSError, urllib.error.URLError) as e:
        err = str(e)
    return RequestOutcome(
        index=index, scenario=rec.get("scenario", "?"), request_id=rid,
        status=status, latency_s=time.perf_counter() - t0,
        t_sent=t_sent, server_timing=timing, error=err,
        target=base_url.rstrip("/"), traceparent=traceparent,
        tenant=rec.get("tenant", "") or "",
        priority=rec.get("priority", "") or "",
        max_abs_error=measured_err,
    )


def _mint_rid(run_tag: str, index: int) -> str:
    return f"lg-{run_tag}-{index}"


def extend_for_duration(records: Sequence[dict], duration: float,
                        speed: float = 1.0) -> List[dict]:
    """The open-loop soak schedule: loop the trace (each lap offset by
    the trace span plus one mean gap, so laps never collide on the same
    timestamp) until the wall-clock budget `duration` is filled at
    replay `speed`.  Always returns at least one record."""
    records = list(records)
    span = records[-1]["t"]
    gap = (span / len(records)) if span > 0 else 0.01
    lap_len = span + max(gap, 1e-3)
    out: List[dict] = []
    lap = 0
    while (lap * lap_len) / speed < duration:
        for rec in records:
            t = rec["t"] + lap * lap_len
            if t / speed >= duration:
                break
            out.append(dict(rec, t=t))
        lap += 1
    if not out:
        out.append(dict(records[0], t=0.0))
    return out


def replay(
    base_url: Union[str, Sequence[str]],
    records: Sequence[dict],
    mode: str = "open",
    concurrency: int = 4,
    speed: float = 1.0,
    warmup: int = 0,
    timeout: float = 120.0,
    run_tag: Optional[str] = None,
    skip_preflight: bool = False,
    retries: int = 0,
    duration: Optional[float] = None,
    failover: bool = False,
) -> ReplayResult:
    """Drive `records` at `base_url`; returns outcomes + the /metrics
    cuts bracketing the measured phase.  `warmup` > 0 first serves up
    to that many requests - one per distinct scenario, sequential,
    excluded from the measurement - so steady-state numbers are not
    first-compile numbers.  `speed` > 1 time-compresses an open-loop
    trace (a 300 s recorded trace replayed at speed=10 offers 10x the
    QPS in 30 s).  `retries` > 0 sends every request through the
    retrying `wavetpu_torch.client.WavetpuClient` (jittered backoff honoring
    Retry-After, request-id reuse - outcomes record `attempts`).
    `duration` turns the replay into a SOAK: the trace loops until the
    wall-clock budget elapses (open loop re-offsets each lap's
    timestamps; closed loop cycles the records), still reported as
    replay-window deltas like any run.

    `base_url` may be a LIST of targets (repeated `--target`): requests
    round-robin across them - the no-router way to drive a fleet of
    replicas directly.  Every target is preflighted; warmup serves each
    tier at EVERY target (one replica warm is not the fleet warm); the
    bracketing /metrics cuts are summed sample-wise across targets so
    the report's delta math sees the fleet as one server.  Outcomes
    carry `target` for the per-replica breakdown.

    `failover=True` flips the multi-target semantics from fan-out to
    HA: ALL targets become ONE multi-endpoint `WavetpuClient` (requires
    `retries` >= 1 - rotation happens on retry), so requests follow the
    client's endpoint cursor to whichever router is active and rotate
    away from a dead/standby one.  Preflight passes if ANY target is
    ready (a standby answers ready=false by design), warmup warms each
    tier once through the shared client, and a target whose /metrics
    cannot be scraped (e.g. the killed active) is dropped from the
    bracketing cuts instead of aborting the report."""
    if mode not in ("open", "closed"):
        raise ValueError(f"mode must be open|closed, got {mode!r}")
    if concurrency < 1:
        raise ValueError(f"concurrency must be >= 1, got {concurrency}")
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    if duration is not None and duration <= 0:
        raise ValueError(f"duration must be > 0, got {duration}")
    if failover and retries < 1:
        raise ValueError(
            "failover mode needs retries >= 1 (the client rotates "
            "endpoints on retry; with no retry budget a dead router "
            "is a client-visible error)"
        )
    if isinstance(base_url, str):
        targets = [base_url.rstrip("/")]
    else:
        targets = [u.rstrip("/") for u in base_url]
    if not targets:
        raise ValueError("need at least one target")
    records = list(records)
    if not records:
        raise ValueError("empty trace")
    if not skip_preflight:
        if failover:
            # An HA set is healthy when ANYONE is ready - the standby
            # answers ready=false (not the lease holder) by design.
            errs: List[str] = []
            for t in targets:
                try:
                    preflight(t)
                    break
                except PreflightError as e:
                    errs.append(str(e))
            else:
                raise PreflightError(
                    "no ready endpoint in the HA set: "
                    + "; ".join(errs)
                )
        else:
            for t in targets:
                preflight(t)
    if run_tag is None:
        # Unique enough across replays against one server; hex keeps it
        # inside the server's sanitized request-id alphabet.
        run_tag = f"{int(time.time() * 1e3) & 0xFFFFFFFF:x}"
    clients: Dict[str, object] = {}
    shared = None
    if retries > 0:
        from wavetpu_torch.client import WavetpuClient

        if failover:
            # ONE client over the whole HA set: its endpoint cursor is
            # the failover state, shared by every replay thread.
            shared = WavetpuClient(targets, retries=retries,
                                   timeout=timeout)
            clients = {t: shared for t in targets}
        else:
            clients = {
                t: WavetpuClient(t, retries=retries, timeout=timeout)
                for t in targets
            }

    def _target(i: int) -> str:
        if shared is not None:
            # Label outcomes with the endpoint the HA client currently
            # points at (best-effort: a mid-request rotation lands on
            # the next one).
            return shared.base_url
        return targets[i % len(targets)]

    def _scrape_all() -> Dict[str, float]:
        cuts = []
        for t in targets:
            try:
                cuts.append(scrape_metrics(t))
            except (OSError, ValueError, urllib.error.URLError):
                # In an HA drill the killed active cannot be scraped;
                # its counters live on in the survivors' store-restored
                # state.  Outside failover mode a dead target is a
                # configuration error worth dying on.
                if not failover:
                    raise
        return sum_metrics(cuts)

    warmup_outcomes: List[RequestOutcome] = []
    if warmup > 0:
        seen = set()
        wi = 0
        for rec in records:
            tier = rec.get("scenario", "?")
            if tier in seen or len(seen) >= warmup:
                continue
            seen.add(tier)
            # Failover mode warms through the shared client (whichever
            # router is active proxies to the fleet); fan-out mode
            # warms every target - one replica warm is not the fleet
            # warm.
            for t in ([_target(0)] if failover else targets):
                warmup_outcomes.append(_post_one(
                    t, wi, rec, _mint_rid(run_tag + "w", wi), 0.0,
                    timeout, clients.get(t),
                ))
                wi += 1

    if duration is not None and mode == "open":
        records = extend_for_duration(records, duration, speed)

    metrics_before = _scrape_all()
    t_start = time.perf_counter()

    if duration is not None and mode == "closed":
        # Soak: `concurrency` workers cycle the trace until the budget
        # elapses; outcomes accumulate (the request count is a result,
        # not an input).
        soak: List[RequestOutcome] = []
        nxt = {"i": 0}
        lock = threading.Lock()
        stop_at = t_start + duration

        def soak_worker():
            while time.perf_counter() < stop_at:
                with lock:
                    i = nxt["i"]
                    nxt["i"] = i + 1
                t = _target(i)
                out = _post_one(
                    t, i, records[i % len(records)],
                    _mint_rid(run_tag, i),
                    time.perf_counter() - t_start, timeout,
                    clients.get(t),
                )
                with lock:
                    soak.append(out)

        threads = [
            threading.Thread(target=soak_worker, daemon=True)
            for _ in range(concurrency)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(duration + timeout + 30.0)
        with lock:
            done = sorted(soak, key=lambda o: o.index)
        return ReplayResult(
            outcomes=done, warmup_outcomes=warmup_outcomes,
            metrics_before=metrics_before,
            metrics_after=_scrape_all(),
            wall_seconds=time.perf_counter() - t_start, mode=mode,
            concurrency=concurrency, speed=speed, targets=targets,
            failover=failover,
            endpoint_failovers=(
                shared.endpoint_failovers if shared is not None else 0
            ),
            duplicate_rate=duplicate_rate_of(records),
        )

    outcomes: List[Optional[RequestOutcome]] = [None] * len(records)

    def fire(i: int, rec: dict) -> None:
        t = _target(i)
        outcomes[i] = _post_one(
            t, i, rec, _mint_rid(run_tag, i),
            time.perf_counter() - t_start, timeout, clients.get(t),
        )

    if mode == "open":
        threads = []
        for i, rec in enumerate(records):
            delay = rec.get("t", 0.0) / speed - (
                time.perf_counter() - t_start
            )
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=fire, args=(i, rec), daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout + 30.0)
    else:
        nxt = {"i": 0}
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    i = nxt["i"]
                    if i >= len(records):
                        return
                    nxt["i"] = i + 1
                fire(i, records[i])

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(concurrency, len(records)))
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout * len(records) + 30.0)

    wall = time.perf_counter() - t_start
    metrics_after = _scrape_all()
    done = [
        o if o is not None else RequestOutcome(
            index=i, scenario=records[i].get("scenario", "?"),
            request_id=_mint_rid(run_tag, i), status=0,
            latency_s=timeout, t_sent=0.0, error="never completed",
            target=_target(i),
            tenant=records[i].get("tenant", "") or "",
            priority=records[i].get("priority", "") or "",
        )
        for i, o in enumerate(outcomes)
    ]
    return ReplayResult(
        outcomes=done, warmup_outcomes=warmup_outcomes,
        metrics_before=metrics_before, metrics_after=metrics_after,
        wall_seconds=wall, mode=mode, concurrency=concurrency,
        speed=speed, targets=targets, failover=failover,
        endpoint_failovers=(
            shared.endpoint_failovers if shared is not None else 0
        ),
        duplicate_rate=duplicate_rate_of(records),
    )
