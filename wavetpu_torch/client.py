"""`WavetpuClient` - the retrying HTTP client for the serving replica (the
port's copy of wavetpu/client.py: it speaks the same HTTP contract, so it
talks to `wavetpu serve` and `wavetpu_torch serve` alike).

The server side of the resilience contract (serve/api.py) promises
typed, retriable failures: 429 + Retry-After under backpressure, 503 +
Retry-After for a draining replica / a circuit-broken program / a
crashed-and-restarted scheduler worker, 504 for an expired deadline.
This client is the matching half:

 * **Jittered exponential backoff** on retriable outcomes (transport
   errors, 429, 500, 503), HONORING a `Retry-After` header when the
   server sends one - the server knows its cooldown better than any
   client-side curve.
 * **Per-request deadlines**: `deadline_s` is one budget across ALL
   attempts; each attempt forwards the remaining budget as
   `deadline_ms` so the server sheds work this client has already given
   up on, and retrying stops the moment the budget is gone.
 * **Request-id reuse**: every attempt of one logical request carries
   the SAME `X-Request-Id`, so `wavetpu trace-report --request ID`
   against the server's telemetry shows the whole retry chain as one
   story, not N unrelated requests.
 * **Distributed trace context**: every attempt also carries the SAME
   W3C `traceparent` (one trace id minted per logical request), so the
   router's and every replica's spans for all attempts hang under ONE
   fleet-wide trace (docs/observability.md "Distributed tracing").  The
   server echoes the trace context back; `SolveOutcome.traceparent` is
   the join handle `wavetpu trace-report` resolves.
 * **Transparent resume**: a 503/504 carrying `resume_token` (a
   preempted chunked long solve - docs/robustness.md) has the token
   re-presented on every later attempt, so the retry continues the
   march from the last completed chunk instead of restarting; a
   504-with-token is even retried (while budget remains) because each
   attempt makes forward progress.
 * **Multi-endpoint failover**: `base_url` may be a LIST of router
   URLs (an HA pair/fleet - docs/fleet.md "Control plane & router
   HA").  A transport failure or a standby-503 (`"standby": true`,
   the not-the-lease-holder answer) ROTATES the client to the next
   endpoint for the retry - counted as `endpoint_failovers` - instead
   of backing off against a dead or deferring router.  The retry
   budget, deadline, request-id, resume-token, and traceparent
   semantics are unchanged: a failover retry is just a retry that
   lands somewhere more useful.

`solve()` returns a `SolveOutcome` (it does not raise on HTTP errors -
the status/error fields are the result; a load generator must count
failures, not crash on them).  Pure stdlib, never imports torch - safe
for load-generation hosts with no accelerator stack.

    from wavetpu_torch.client import WavetpuClient

    client = WavetpuClient("http://localhost:8077", retries=3,
                           deadline_s=30.0)
    out = client.solve({"N": 64, "timesteps": 100})
    if out.ok:
        print(out.payload["report"]["gcells_per_second"])
    else:
        print(out.status, out.error, f"after {out.attempts} attempts")
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import random
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

from wavetpu_torch.obs.tracing import format_traceparent, mint_span_id, \
    mint_trace_id

# Outcomes worth a retry: transport failure (status 0), backpressure
# (429), engine failure (500 - the batch died, a retry lands in a fresh
# batch), and retriable unavailability (503: draining, quarantined
# program, restarted worker).  400/404/413/422 are THIS request's fault
# and retrying cannot fix them; 504 means the deadline is already gone.
RETRIABLE_STATUSES = frozenset((0, 429, 500, 503))


@dataclasses.dataclass
class SolveOutcome:
    """One logical request's final result plus its retry history."""

    status: int                    # final HTTP status; 0 = transport
    payload: Optional[dict]        # parsed JSON body (None unparsable)
    headers: Dict[str, str]        # final attempt's response headers
    attempts: int                  # total attempts made (>= 1)
    retries: List[dict]            # per-retry {status, delay_s, error}
    latency_s: float               # wall across ALL attempts + backoff
    request_id: str                # the id EVERY attempt carried
    error: Optional[str] = None    # final error string (None on 200)
    traceparent: str = ""          # W3C context EVERY attempt carried

    @property
    def ok(self) -> bool:
        return self.status == 200

    @property
    def server_timing(self) -> Optional[str]:
        return self.headers.get("Server-Timing")

    @property
    def trace_id(self) -> Optional[str]:
        """The 32-hex fleet trace id this request rode (None if the
        client somehow sent no context)."""
        parts = self.traceparent.split("-")
        return parts[1] if len(parts) == 4 else None


def parse_retry_after(headers: Dict[str, str]) -> Optional[float]:
    """Seconds from a `Retry-After` header (delta-seconds form only -
    the server emits integers; HTTP-date is a proxy exotic we skip).
    None when absent or unparseable."""
    raw = headers.get("Retry-After")
    if raw is None:
        return None
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return None


class WavetpuClient:
    """Thread-safe stdlib client with KEEP-ALIVE: one persistent
    `http.client.HTTPConnection` per calling thread (threading.local),
    reused across requests - the serve handler speaks HTTP/1.1, so the
    per-request TCP handshake the old urllib transport paid (and the
    fleet router tier would have amplified 2x) is gone.  Any transport
    error closes and resets that thread's connection, so the NEXT
    attempt reconnects fresh - a stale kept-alive socket (server
    drained, restarted, or chaos-dropped between requests) costs one
    retriable status-0 attempt, never a wedged client.  A response
    carrying `Connection: close` (drain 503, 413) retires the socket
    in an orderly way (not counted as a reset).

    `retries` is the RETRY budget (total attempts = retries + 1);
    `deadline_s` the default per-request budget (None = unbounded);
    `backoff_base_s`/`backoff_max_s` shape the jittered exponential
    curve `min(max, base * 2^attempt) * uniform(0.5, 1.0)`.  `rng` and
    `sleep` are injectable for deterministic tests.

    Connection accounting (for tests and the loadgen report):
    `connections_opened` / `requests_on_reused_connection` /
    `connection_resets` under one stats lock."""

    def __init__(
        self,
        base_url: Union[str, Sequence[str]],
        retries: int = 2,
        timeout: float = 120.0,
        deadline_s: Optional[float] = None,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        headers: Optional[Dict[str, str]] = None,
    ):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {deadline_s}"
            )
        # One endpoint is the historical single-server client; several
        # are an HA router set the client fails over across.  All
        # threads share ONE current-endpoint cursor: once one thread
        # discovers an endpoint is dead/standby, nobody else should
        # have to rediscover it.
        urls = [base_url] if isinstance(base_url, str) else list(base_url)
        if not urls:
            raise ValueError("base_url needs at least one endpoint")
        self.endpoints: List[str] = []
        self._parsed: List[Tuple[str, int, str]] = []
        for u in urls:
            u = str(u).rstrip("/")
            parts = urllib.parse.urlsplit(u)
            if parts.scheme != "http" or not parts.hostname:
                raise ValueError(
                    f"base_url must be http://host[:port], got {u!r}"
                )
            self.endpoints.append(u)
            self._parsed.append(
                (parts.hostname, parts.port or 80,
                 parts.path.rstrip("/"))
            )
        self._cur = 0
        self.endpoint_failovers = 0
        self.retries = retries
        self.timeout = timeout
        self.deadline_s = deadline_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        # Extra request headers on EVERY /solve attempt - how a caller
        # authenticates (X-Api-Key / Authorization) and declares its
        # priority class (X-Priority) against a QoS-enabled router.
        self.headers: Dict[str, str] = dict(headers or {})
        self._n = 0
        self._tag = f"{int(time.time() * 1e3) & 0xFFFFFFFF:x}"
        self._local = threading.local()
        self._stats_lock = threading.Lock()
        self.connections_opened = 0
        self.requests_on_reused_connection = 0
        self.connection_resets = 0

    def _mint(self) -> str:
        self._n += 1
        return f"cl-{self._tag}-{self._n}"

    @property
    def base_url(self) -> str:
        """The endpoint requests currently target (the only endpoint
        for a single-URL client) - kept as an attribute-shaped property
        so existing callers and reports read the live value."""
        return self.endpoints[self._cur]

    def _rotate(self, from_idx: int) -> None:
        """Advance the shared endpoint cursor past `from_idx` - the
        endpoint that just failed.  A no-op if another thread already
        moved it (their failover counts once, ours doesn't double) or
        if there is nowhere else to go."""
        if len(self.endpoints) < 2:
            return
        with self._stats_lock:
            if self._cur != from_idx:
                return
            self._cur = (from_idx + 1) % len(self.endpoints)
            self.endpoint_failovers += 1

    # ---- transport (keep-alive) ----

    def _conn(self, idx: int, timeout: float
              ) -> Tuple[http.client.HTTPConnection, bool]:
        """This thread's persistent connection TO ENDPOINT `idx`
        (created on first use), with the socket timeout refreshed for
        this request.  Returns (conn, reused) - reused=True when the
        socket is already up."""
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = {}
            self._local.conns = conns
        conn = conns.get(idx)
        if conn is None:
            host, port, _prefix = self._parsed[idx]
            conn = http.client.HTTPConnection(host, port,
                                              timeout=timeout)
            conns[idx] = conn
            with self._stats_lock:
                self.connections_opened += 1
        reused = conn.sock is not None
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        return conn, reused

    def _reset_conn(self, idx: int, orderly: bool = False) -> None:
        """Close and forget this thread's connection to endpoint `idx`
        (next request there reconnects).  `orderly` = the server
        announced `Connection: close`; anything else counts as a
        reset."""
        conns = getattr(self._local, "conns", None)
        conn = conns.get(idx) if conns else None
        if conn is None:
            return
        try:
            conn.close()
        except Exception:
            pass
        conns.pop(idx, None)
        if not orderly:
            with self._stats_lock:
                self.connection_resets += 1

    def close(self) -> None:
        """Retire the CALLING thread's persistent connections (other
        threads' sockets close when their conns are garbage-collected)."""
        conns = getattr(self._local, "conns", None)
        for idx in list(conns) if conns else ():
            self._reset_conn(idx, orderly=True)

    def _request(self, method: str, path: str, data: Optional[bytes],
                 headers: Dict[str, str], timeout: float,
                 idx: Optional[int] = None
                 ) -> Tuple[int, bytes, Dict[str, str]]:
        """One HTTP exchange on the thread's kept-alive connection to
        endpoint `idx` (default: the current endpoint).  Raises
        OSError/http.client errors on transport failure (after
        resetting that connection so the next attempt reconnects)."""
        if idx is None:
            idx = self._cur
        conn, reused = self._conn(idx, timeout)
        prefix = self._parsed[idx][2]
        try:
            conn.request(method, prefix + path, body=data,
                         headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
        except Exception:
            self._reset_conn(idx)
            raise
        if reused:
            with self._stats_lock:
                self.requests_on_reused_connection += 1
        if resp.will_close:
            self._reset_conn(idx, orderly=True)
        return resp.status, raw, dict(resp.headers)

    def _attempt(self, body: dict, rid: str, timeout: float,
                 traceparent: str = "",
                 extra_headers: Optional[Dict[str, str]] = None,
                 idx: Optional[int] = None):
        """One POST /solve: (status, payload, headers, error)."""
        headers = dict(self.headers)
        if extra_headers:
            headers.update(extra_headers)
        headers["Content-Type"] = "application/json"
        headers["X-Request-Id"] = rid
        if traceparent:
            headers["traceparent"] = traceparent
        try:
            status, raw, headers = self._request(
                "POST", "/solve", json.dumps(body).encode(), headers,
                timeout, idx=idx,
            )
        except (OSError, http.client.HTTPException) as e:
            return 0, None, {}, f"{type(e).__name__}: {e}" if str(e) \
                else type(e).__name__
        try:
            payload = json.loads(raw or b"{}")
        except (ValueError, TypeError):
            payload = None
        error = None
        if status != 200:
            error = (payload or {}).get("error") or f"HTTP {status}"
        return status, payload, headers, error

    def healthz(self, timeout: float = 10.0) -> dict:
        status, raw, _headers = self._request("GET", "/healthz", None,
                                              {}, timeout)
        return json.loads(raw)

    # ---- the retry loop ----

    def solve(
        self,
        body: dict,
        request_id: Optional[str] = None,
        deadline_s: Optional[float] = None,
        retries: Optional[int] = None,
        timeout: Optional[float] = None,
        headers: Optional[Dict[str, str]] = None,
    ) -> SolveOutcome:
        """POST /solve with retry/backoff/deadline per the class doc.
        The per-call kwargs override the client defaults; `request_id`
        (else a minted `cl-*` id) rides EVERY attempt.  `headers`
        merge OVER the client-level extra headers per attempt (e.g. a
        per-request X-Priority on a shared authenticated client)."""
        retries = self.retries if retries is None else retries
        deadline_s = (
            self.deadline_s if deadline_s is None else deadline_s
        )
        timeout = self.timeout if timeout is None else timeout
        # `headers` is reused below for RESPONSE headers; keep the
        # caller's request extras under their own name.
        per_call_headers = headers
        rid = request_id or self._mint()
        # One trace id for the whole logical request: every attempt
        # (and thus every router hop and replica it lands on) carries
        # the SAME traceparent, so retries are one fleet trace.
        traceparent = format_traceparent(mint_trace_id(), mint_span_id())
        t0 = time.monotonic()
        deadline = None if deadline_s is None else t0 + deadline_s
        retried: List[dict] = []
        attempt = 0
        status, payload, headers, error = 0, None, {}, "not attempted"
        while True:
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                error = (
                    f"client deadline {deadline_s:g}s exhausted after "
                    f"{attempt} attempt(s); last: {error}"
                )
                break
            send_body = body
            if remaining is not None and "deadline_ms" not in body:
                # Forward the REMAINING budget so the server sheds work
                # this client will no longer read.
                send_body = dict(
                    body, deadline_ms=round(remaining * 1e3, 3)
                )
            att_timeout = (
                timeout if remaining is None
                else min(timeout, remaining + 0.25)
            )
            attempt += 1
            endpoint_idx = self._cur
            status, payload, headers, error = self._attempt(
                send_body, rid, att_timeout, traceparent,
                extra_headers=per_call_headers, idx=endpoint_idx,
            )
            # Transparent resume (preemptible long solves): a 503 from
            # a draining replica - or a 504 whose budget died mid-march
            # - may carry `resume_token`, the server-side checkpoint of
            # the chunks already marched.  Re-present it on every later
            # attempt so the retry CONTINUES the solve instead of
            # restarting at layer 0 (on a fleet, possibly on a
            # different replica sharing --solve-state-dir).
            token = (
                payload.get("resume_token")
                if isinstance(payload, dict) else None
            )
            if isinstance(token, str) and token:
                body = dict(body, resume_token=token)
            retriable = status in RETRIABLE_STATUSES or (
                # 504 is normally final (the budget is gone), but with
                # a token each retry makes PROGRESS - worth it while
                # client budget remains.
                status == 504 and bool(token)
                and (deadline is None
                     or deadline - time.monotonic() > 0)
            )
            if status == 200 or not retriable or attempt > retries:
                break
            # Multi-endpoint failover: a dead socket (status 0) or a
            # standby router's not-the-lease-holder 503 means THIS
            # endpoint is the problem, not this request - rotate the
            # shared cursor so the retry (and every other thread) lands
            # on the next router.  A rotated retry ignores Retry-After:
            # that header described the endpoint being left.
            standby = (
                status == 503 and isinstance(payload, dict)
                and payload.get("standby") is True
            )
            rotated = False
            if (status == 0 or standby) and len(self.endpoints) > 1:
                self._rotate(endpoint_idx)
                rotated = True
            delay = None if rotated else parse_retry_after(headers)
            if delay is None:
                delay = min(
                    self.backoff_max_s,
                    self.backoff_base_s * (2 ** (attempt - 1)),
                ) * (0.5 + 0.5 * self._rng.random())
            if deadline is not None:
                budget = deadline - time.monotonic()
                if delay >= budget:
                    error = (
                        f"client deadline {deadline_s:g}s would expire "
                        f"during backoff ({delay:.3f}s) after {attempt} "
                        f"attempt(s); last: {error}"
                    )
                    break
            retried.append({
                "status": status,
                "delay_s": round(delay, 4),
                "error": error,
            })
            self._sleep(delay)
        return SolveOutcome(
            status=status, payload=payload, headers=headers,
            attempts=attempt, retries=retried,
            latency_s=time.monotonic() - t0, request_id=rid,
            error=error if status != 200 else None,
            traceparent=traceparent,
        )
