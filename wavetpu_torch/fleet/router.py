"""`python -m wavetpu_torch router` - the ProgramKey-affinity fleet front
tier (the port's copy of wavetpu/fleet/router.py: the same endpoints,
headers, `wavetpu_router_*` metrics and control-plane files).

A stdlib ThreadingHTTPServer (the serve/api.py discipline: handler
threads block on upstream I/O, one shared state object on the server)
that proxies /solve across N `python -m wavetpu_torch serve` replicas:

  POST /solve       derive the body's program identity with the SHARED
                    key module (`wavetpu_torch.progkey` - the same derivation
                    the engine caches under, so router and engine
                    cannot drift), land it on a replica that already
                    holds the compiled program (fleet/affinity.py),
                    else least-loaded power-of-two-choices.  A
                    transport failure or a 503 (draining / breaker /
                    crashed-worker replica) is RETRIED on a different
                    live member before the client ever sees it; only
                    when every member refused does the router answer
                    503 + Retry-After + retriable (which WavetpuClient
                    absorbs with backoff).  The response carries
                    `X-Wavetpu-Member` naming the replica that served.
                    `X-Deadline-Ms` is forwarded DECREMENTED by the
                    router-side wall already burned, and retries stop
                    when the remaining budget drops below
                    --min-retry-budget-ms (a doomed retry wastes a
                    replica slot).  A 503 carrying `resume_token` (a
                    draining replica checkpointed a chunked long
                    solve) has the token re-injected into the retried
                    body, so the next member resumes the march -
                    cross-replica solve handoff.  With
                    --api-keys-file, /solve requires a mapped API key
                    (Authorization: Bearer or X-Api-Key; else 401) and
                    the router stamps the mapped tenant label as
                    X-Wavetpu-Tenant, stripping any caller-supplied
                    value.  The key's entry may also carry a QoS
                    config (fleet/quota.py): a default priority class
                    + ceiling (the router clamps and stamps
                    X-Priority, stripping the inbound claim) and
                    per-tenant token buckets - requests/s AND
                    model-priced cells/s - enforced HERE, before
                    routing; exhaustion answers 429 with Retry-After
                    set to the measured bucket refill time.  With
                    --proxy-token the router stamps
                    X-Wavetpu-Proxy-Token on every forwarded request,
                    so replicas started with the same secret accept
                    tenant/priority headers ONLY from this router.
                    With --telemetry-dir the router writes its OWN
                    trace.jsonl (obs/tracing.py records): a
                    `router.request` span per proxied /solve with
                    `router.attempt` children per member try plus
                    `router.retry` / `router.drain_handoff` events -
                    adopting the client's W3C `traceparent` as remote
                    parent and minting a fresh per-attempt context for
                    the replica, so `python -m wavetpu_torch
                    trace-report --dir ...` joins router and replica
                    spans into ONE fleet trace (docs/observability.md
                    "Distributed tracing").  The trace context is
                    echoed on every /solve response.
  GET /healthz      router liveness + readiness (`ready` = at least
                    one routable member) + per-member state summary.
  GET /metrics      JSON (default): router counters, affinity stats
                    (hit/rerouted/cold + hit_rate), per-member summary
                    and proxied counts.  `Accept: text/plain`: the
                    FLEET-WIDE Prometheus cut - sample-wise sum over
                    every member ever seen (departed members contribute
                    frozen snapshots; mid-flight joiners contribute
                    growth since join, their warmup history baselined
                    away - so `python -m wavetpu_torch loadgen`
                    pointed at the router sees monotonic, roll-clean
                    deltas across a rolling deploy) plus the
                    router's own wavetpu_router_* samples.
  POST /admin/join  {"url": U} - add a member (admitted to rotation
                    when its /healthz says ready).
  POST /admin/leave {"url": U} - drain U (POST its /admin/drain),
                    keep polling its counters while it flushes, then
                    retire it with counters frozen.  The roll driver's
                    cutover primitive.

Stdlib-only; imports neither torch nor jax (routers run on hosts
with no accelerator stack).  Contract and runbook: wavetpu's
docs/fleet.md.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Sequence, Tuple

from wavetpu_torch import progkey
from wavetpu_torch.core.flags import split_flags
from wavetpu_torch.fleet import ha as fleet_ha
from wavetpu_torch.fleet import quota
from wavetpu_torch.fleet.affinity import (
    AffinityTable,
    warm_label_from_server_timing,
)
from wavetpu_torch.fleet.edgecache import EdgeCache
from wavetpu_torch.fleet.membership import MembershipTable
from wavetpu_torch.fleet.store import ControlPlaneStore
from wavetpu_torch.obs import tracing
from wavetpu_torch.obs.telemetry import (
    DEFAULT_MAX_BYTES,
    ROTATE_KEEP,
    TRACE_FILENAME,
)

_USAGE = (
    "usage: python -m wavetpu_torch router --member URL [--member URL2 ...] "
    "[--host H] [--port P] [--poll-interval-s S] [--fail-threshold K] "
    "[--proxy-timeout-s S] [--max-body-bytes B] "
    "[--min-retry-budget-ms MS] [--api-keys-file FILE.json] "
    "[--quota-default-rps R] [--quota-default-burst B] "
    "[--quota-default-cells-per-s C] [--quota-default-cells-burst CB] "
    "[--proxy-token SECRET] [--telemetry-dir DIR] "
    "[--control-plane-dir DIR] [--lease-ttl-s S] "
    "[--store-flush-interval-s S] "
    "[--edge-cache] [--edge-cache-max-bytes B] [--edge-cache-ttl-s S]"
)

# Response headers worth forwarding verbatim from replica to client
# (the rest are hop-by-hop or recomputed by the router's send path).
# `traceparent` is the replica's trace-context echo; a TRACED router
# overwrites it with its own outer-hop context before answering.
_FORWARD_RESPONSE_HEADERS = (
    "X-Request-Id", "Server-Timing", "Retry-After", "traceparent",
    "X-Wavetpu-Cache",
)
# Request headers forwarded replica-ward.  X-Wavetpu-Tenant and
# X-Priority pass through only on an UNauthenticated router (trusted
# internal callers); with --api-keys-file the router strips the inbound
# values and stamps its own - the tenant from the key map, the class
# defaulted + ceiling-clamped by the tenant's config - so neither label
# is forgeable.  `traceparent` passes through verbatim on an UNtraced
# router (the client's context still reaches the replica); a traced
# router replaces it with a fresh per-attempt context under the same
# trace id.
_FORWARD_REQUEST_HEADERS = (
    "Content-Type", "X-Request-Id", "X-Deadline-Ms",
    "X-Wavetpu-Tenant", "X-Priority", "traceparent",
)


def _server_timing_total_ms(header: Optional[str]) -> Optional[float]:
    """The `total;dur=` milliseconds from a replica's Server-Timing
    header - the replica-side wall for the per-hop attribution counters
    (router wall vs replica wall).  None when absent/unparseable."""
    if not header:
        return None
    for part in header.split(","):
        name, _, params = part.strip().partition(";")
        if name.strip() != "total":
            continue
        for p in params.split(";"):
            k, _, v = p.strip().partition("=")
            if k == "dur":
                try:
                    return float(v)
                except ValueError:
                    return None
    return None


def load_api_keys(path: str) -> Dict[str, quota.TenantConfig]:
    """Parse an --api-keys-file into key -> TenantConfig.  Two value
    shapes: the PR-12 plain tenant-label string (identity only), or a
    QoS config object (tenant + priority default/ceiling + per-tenant
    token-bucket rates) - fleet/quota.py `load_api_keys` holds the
    schema.  Keys terminate AT the router (replicas never see them)."""
    return quota.load_api_keys(path)


class _ProxyConns:
    """Thread-local kept-alive upstream connections, one per (handler
    thread, member) - the router pays the TCP handshake once per
    member per thread, not once per proxied request (the replicas
    speak HTTP/1.1)."""

    def __init__(self):
        self._local = threading.local()

    def _pool(self) -> Dict[str, http.client.HTTPConnection]:
        pool = getattr(self._local, "pool", None)
        if pool is None:
            pool = {}
            self._local.pool = pool
        return pool

    def request(self, base_url: str, method: str, path: str,
                body: Optional[bytes], headers: Dict[str, str],
                timeout: float) -> Tuple[int, bytes, Dict[str, str]]:
        """One exchange on the kept-alive connection to `base_url`;
        raises OSError/http.client errors on transport failure (after
        dropping the dead connection so the next try reconnects)."""
        pool = self._pool()
        conn = pool.get(base_url)
        if conn is None:
            parts = urllib.parse.urlsplit(base_url)
            conn = http.client.HTTPConnection(
                parts.hostname, parts.port or 80, timeout=timeout
            )
            pool[base_url] = conn
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
        except Exception:
            try:
                conn.close()
            except Exception:
                pass
            pool.pop(base_url, None)
            raise
        if resp.will_close:
            try:
                conn.close()
            except Exception:
                pass
            pool.pop(base_url, None)
        return resp.status, raw, dict(resp.headers)

    def drop(self, base_url: str) -> None:
        conn = self._pool().pop(base_url, None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass


class RouterState:
    """Shared router state: membership + affinity + counters."""

    def __init__(self, table: MembershipTable, affinity: AffinityTable,
                 proxy_timeout: float = 120.0,
                 max_body_bytes: Optional[int] = None,
                 min_retry_budget_ms: float = 50.0,
                 api_keys: Optional[Dict] = None,
                 quotas: Optional[quota.QuotaManager] = None,
                 proxy_token: Optional[str] = None):
        self.table = table
        self.affinity = affinity
        self.proxy_timeout = proxy_timeout
        self.max_body_bytes = max_body_bytes
        # Deadline-budget floor for cross-member retries: when the
        # remaining client budget is below this, a second attempt
        # cannot finish in time - surface the last answer instead of
        # burning another replica's queue slot on doomed work.
        self.min_retry_budget_ms = min_retry_budget_ms
        # key -> TenantConfig; None = unauthenticated router (the
        # historical open mode).  Plain-string values (the PR-12 flat
        # map, still what tests/embedders hand build_router) are
        # normalized to identity-only configs here.
        self.api_keys: Optional[Dict[str, quota.TenantConfig]] = None
        if api_keys is not None:
            self.api_keys = {
                k: (v if isinstance(v, quota.TenantConfig)
                    else quota.parse_tenant_entry(k, v))
                for k, v in api_keys.items()
            }
        # Authoritative per-tenant token buckets (requests/s +
        # model-priced cells/s); default-constructed (enforcing
        # nothing) when the caller passes None so the admit path stays
        # branch-light.
        self.quotas = quotas if quotas is not None \
            else quota.QuotaManager()
        # Shared secret stamped as X-Wavetpu-Proxy-Token on every
        # forwarded request; replicas started with the same secret
        # accept tenant/priority headers only when it matches.
        self.proxy_token = proxy_token
        self.conns = _ProxyConns()
        self.started = time.time()
        self._lock = threading.Lock()
        self.requests_total = 0
        self.retried_requests = 0      # requests needing >1 member
        self.retries_total = 0         # extra member attempts
        self.exhausted_total = 0       # every member refused -> 503
        self.unparseable_total = 0     # body gave no identity (routed
        #                                anyway; the replica 400s it)
        self.auth_rejected_total = 0   # missing/unknown API key -> 401
        self.quota_rejected_total = 0  # bucket exhausted -> 429
        self.budget_stops_total = 0    # retries refused: budget floor
        self.resume_handoffs_total = 0  # 503-with-token retried with
        #                                 the token re-injected
        # Per-hop wall attribution: cumulative router-side wall per
        # proxied /solve vs the replica-side wall the members reported
        # (Server-Timing `total;dur=`).  The difference is the
        # network/queue/retry overhead the router tier added.
        self.proxy_wall_ms_total = 0.0
        self.upstream_wall_ms_total = 0.0
        # The router's OWN Tracer (--telemetry-dir), deliberately NOT
        # the module-level singleton: a test process may host this
        # router and N in-process replicas, each with its own trace
        # file - the router must not clobber theirs (or vice versa).
        self.tracer: Optional[tracing.Tracer] = None
        self.proxied_per_member: Dict[str, int] = {}
        self.requests_per_tenant: Dict[str, int] = {}
        # Control plane + HA (--control-plane-dir; both None without
        # it - the historical standalone-active router, bit-for-bit).
        self.store: Optional[ControlPlaneStore] = None
        self.ha: Optional[fleet_ha.HACoordinator] = None
        # Edge result cache (--edge-cache; fleet/edgecache.py, None =
        # off): repeats of a replica-stored answer are served AT the
        # router - zero replica I/O, pinned by an unchanged replica
        # batch counter.  Its index rides the control-plane store as
        # the `edge_cache` section, so restarts and HA promotions
        # inherit the warm edge.
        self.edge: Optional[EdgeCache] = None
        # Router-tier chaos plan (WAVETPU_FAULT router-*/store-* specs;
        # run/faults.py router_plan_from_env).  Shared with the store
        # and lease so count= budgets span the whole process.
        self.fault_plan = None
        self.standby_rejected_total = 0  # /solve answered standby-503
        self._poll_stop = threading.Event()
        self._poller: Optional[threading.Thread] = None

    # ---- HA role ----

    @property
    def role(self) -> str:
        """`active` (serving /solve) or `standby` (503s retriably until
        the lease is ours).  A router without a control plane is always
        active - there is nobody to defer to."""
        return fleet_ha.ACTIVE if self.ha is None else self.ha.role

    # ---- control-plane persistence (fleet/store.py sections) ----

    def export_state(self) -> dict:
        """The full durable section map the HA flusher persists."""
        with self._lock:
            counters = {
                "requests_total": self.requests_total,
                "retried_requests": self.retried_requests,
                "retries_total": self.retries_total,
                "exhausted_total": self.exhausted_total,
                "unparseable_total": self.unparseable_total,
                "auth_rejected_total": self.auth_rejected_total,
                "quota_rejected_total": self.quota_rejected_total,
                "budget_stops_total": self.budget_stops_total,
                "resume_handoffs_total": self.resume_handoffs_total,
                "standby_rejected_total": self.standby_rejected_total,
                "proxy_wall_ms_total": round(
                    self.proxy_wall_ms_total, 3
                ),
                "upstream_wall_ms_total": round(
                    self.upstream_wall_ms_total, 3
                ),
                "proxied_per_member": dict(self.proxied_per_member),
                "requests_per_tenant": dict(self.requests_per_tenant),
            }
        out = {
            "quota": self.quotas.export_state(),
            "affinity": self.affinity.export_state(),
            "membership": self.table.export_state(),
            "router_counters": counters,
        }
        if self.edge is not None:
            out["edge_cache"] = self.edge.export_state()
        return out

    def restore_state(self, state: dict) -> None:
        """Adopt a predecessor's persisted state (boot with a store, or
        a standby's promotion).  Counters max-merge so the router-own
        /metrics samples stay monotonic across the restart; quota
        levels restore refilled for downtime; membership restores
        frozen snapshots + baselines; affinity union-merges."""
        if not isinstance(state, dict):
            return
        self.quotas.restore_state(state.get("quota") or {})
        self.affinity.restore_state(state.get("affinity") or {})
        self.table.restore_state(state.get("membership") or {})
        if self.edge is not None:
            self.edge.restore_state(state.get("edge_cache") or {})
        counters = state.get("router_counters")
        if not isinstance(counters, dict):
            return
        with self._lock:
            for field in (
                "requests_total", "retried_requests", "retries_total",
                "exhausted_total", "unparseable_total",
                "auth_rejected_total", "quota_rejected_total",
                "budget_stops_total", "resume_handoffs_total",
                "standby_rejected_total",
            ):
                try:
                    v = int(counters.get(field) or 0)
                except (TypeError, ValueError):
                    continue
                setattr(self, field, max(getattr(self, field), v))
            for field in ("proxy_wall_ms_total",
                          "upstream_wall_ms_total"):
                try:
                    v = float(counters.get(field) or 0.0)
                except (TypeError, ValueError):
                    continue
                setattr(self, field, max(getattr(self, field), v))
            for field, pool in (
                ("proxied_per_member", self.proxied_per_member),
                ("requests_per_tenant", self.requests_per_tenant),
            ):
                persisted = counters.get(field)
                if not isinstance(persisted, dict):
                    continue
                for k, n in persisted.items():
                    try:
                        n = int(n)
                    except (TypeError, ValueError):
                        continue
                    pool[k] = max(pool.get(k, 0), n)

    # ---- load signal for power-of-two-choices ----

    def load_of(self, url: str) -> float:
        m = self.table.get(url)
        if m is None:
            return 0.0
        # Router-side inflight is fresh per request; queue depth is as
        # fresh as the last poll - together they bias p2c away from a
        # member that is busy RIGHT NOW or was backed up recently.
        return float(m.inflight + m.queue_depth)

    def note_proxied(self, url: str, retried: bool,
                     extra_attempts: int) -> None:
        with self._lock:
            self.proxied_per_member[url] = (
                self.proxied_per_member.get(url, 0) + 1
            )
            if retried:
                self.retried_requests += 1
            self.retries_total += extra_attempts

    # ---- background health poll ----

    def start_poller(self, interval_s: float) -> None:
        def _loop():
            while not self._poll_stop.wait(interval_s):
                try:
                    self.table.poll_once()
                except Exception:
                    pass  # a poll crash must never kill the loop

        self._poller = threading.Thread(
            target=_loop, name="wavetpu-router-poll", daemon=True
        )
        self._poller.start()

    def stop_poller(self) -> None:
        self._poll_stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5.0)

    # ---- leave orchestration (the roll cutover primitive) ----

    def leave_member(self, url: str, drain: bool = True,
                     drain_wait_s: float = 30.0,
                     sync: bool = False) -> bool:
        """Mark `url` LEAVING (out of rotation now), drain it, keep
        snapshotting its counters while it flushes, then retire it
        (counters frozen).  Runs in the background unless sync=True
        (tests); returns whether the member existed."""
        m = self.table.leave(url)
        if m is None:
            return False

        def _drain_and_retire():
            if drain:
                try:
                    # A short-lived one-shot connection: the member is
                    # about to close every socket anyway.
                    self.conns.drop(m.base_url)
                    parts = urllib.parse.urlsplit(m.base_url)
                    conn = http.client.HTTPConnection(
                        parts.hostname, parts.port or 80, timeout=10.0
                    )
                    try:
                        conn.request("POST", "/admin/drain")
                        conn.getresponse().read()
                    finally:
                        conn.close()
                except Exception:
                    pass  # already down = already drained
            deadline = time.monotonic() + drain_wait_s
            while time.monotonic() < deadline:
                # Liveness probe FIRST: a drained replica stops
                # accepting the moment its serve loop exits, and
                # burning the metrics-fetch timeouts against a dead
                # socket would stall the cutover for nothing.
                try:
                    self.table._fetch(  # noqa: SLF001
                        m.base_url, "/healthz", 2.0, None
                    )
                except Exception:
                    break  # process gone: last snapshot is final
                try:
                    self.table.refresh_metrics(m)
                except Exception:
                    pass
                time.sleep(0.2)
            self.table.retire(m.base_url)

        if sync:
            _drain_and_retire()
        else:
            threading.Thread(
                target=_drain_and_retire,
                name="wavetpu-router-leave", daemon=True,
            ).start()
        return True

    # ---- fleet platform (for kernel:auto identity resolution) ----

    def platform(self) -> str:
        for m in self.table.routable_members():
            if m.backend:
                return m.backend
        for m in self.table.members():
            if m.backend:
                return m.backend
        return "cpu"

    # ---- metrics views ----

    def snapshot(self) -> dict:
        with self._lock:
            per_member = dict(self.proxied_per_member)
            snap = {
                "router": True,
                "uptime_seconds": round(time.time() - self.started, 3),
                "requests_total": self.requests_total,
                "retried_requests": self.retried_requests,
                "retries_total": self.retries_total,
                "exhausted_total": self.exhausted_total,
                "unparseable_total": self.unparseable_total,
                "auth_rejected_total": self.auth_rejected_total,
                "quota_rejected_total": self.quota_rejected_total,
                "budget_stops_total": self.budget_stops_total,
                "resume_handoffs_total": self.resume_handoffs_total,
                "standby_rejected_total": self.standby_rejected_total,
                "proxy_wall_ms_total": round(
                    self.proxy_wall_ms_total, 3
                ),
                "upstream_wall_ms_total": round(
                    self.upstream_wall_ms_total, 3
                ),
                "requests_per_tenant": dict(self.requests_per_tenant),
            }
        snap.update(self.quotas.snapshot())
        # Live bucket levels: what the failover-parity drill compares
        # between the pre-kill active and the promoted standby.
        snap["quota_buckets"] = self.quotas.levels()
        snap["role"] = self.role
        if self.ha is not None:
            snap["ha"] = self.ha.snapshot()
        if self.store is not None:
            snap["store"] = self.store.snapshot_counters()
        if self.edge is not None:
            snap["edge_cache"] = self.edge.snapshot()
        if self.fault_plan is not None:
            snap["fault_plan"] = self.fault_plan.snapshot()
        snap["affinity"] = self.affinity.stats()
        members = self.table.summary()
        for row in members:
            row["proxied_total"] = per_member.get(row["url"], 0)
        snap["members"] = members
        return snap

    def render_prometheus(self) -> str:
        """Fleet-wide text exposition: summed member samples (frozen
        snapshots included - monotonic across a roll) + router-own
        wavetpu_router_* samples."""
        agg = self.table.aggregate_prom(refresh=True)
        snap = self.snapshot()
        aff = snap["affinity"]
        own: Dict[str, float] = {
            "wavetpu_router_requests_total": snap["requests_total"],
            "wavetpu_router_retried_requests_total":
                snap["retried_requests"],
            "wavetpu_router_retries_total": snap["retries_total"],
            "wavetpu_router_exhausted_total": snap["exhausted_total"],
            "wavetpu_router_auth_rejected_total":
                snap["auth_rejected_total"],
            "wavetpu_router_quota_rejected_total":
                snap["quota_rejected_total"],
            "wavetpu_router_budget_stops_total":
                snap["budget_stops_total"],
            "wavetpu_router_resume_handoffs_total":
                snap["resume_handoffs_total"],
            "wavetpu_router_proxy_wall_ms_total":
                snap["proxy_wall_ms_total"],
            "wavetpu_router_upstream_wall_ms_total":
                snap["upstream_wall_ms_total"],
            'wavetpu_router_affinity_decisions_total{decision="hit"}':
                aff["hits"],
            'wavetpu_router_affinity_decisions_total{decision="rerouted"}':
                aff["rerouted"],
            'wavetpu_router_affinity_decisions_total{decision="cold"}':
                aff["cold"],
            "wavetpu_router_affinity_known_keys": aff["known_keys"],
        }
        for row in snap["members"]:
            url = row["url"]
            own[
                'wavetpu_router_member_proxied_total'
                f'{{member="{url}"}}'
            ] = row["proxied_total"]
        for tenant, n in sorted(snap["requests_per_tenant"].items()):
            own[
                'wavetpu_router_tenant_requests_total'
                f'{{tenant="{tenant}"}}'
            ] = n
        for tenant, n in sorted(
            snap["quota_rejected_per_tenant"].items()
        ):
            own[
                'wavetpu_router_tenant_quota_rejected_total'
                f'{{tenant="{tenant}"}}'
            ] = n
        by_state: Dict[str, int] = {}
        for row in snap["members"]:
            by_state[row["state"]] = by_state.get(row["state"], 0) + 1
        for state, n in sorted(by_state.items()):
            own[f'wavetpu_router_members{{state="{state}"}}'] = n
        own["wavetpu_router_standby_rejected_total"] = snap[
            "standby_rejected_total"
        ]
        if self.store is not None:
            own.update(self.store.prom_samples())
        if self.ha is not None:
            own.update(self.ha.prom_samples())
        if self.edge is not None:
            own.update(self.edge.prom_samples())
        if self.fault_plan is not None:
            for inj in self.fault_plan.snapshot():
                own[
                    'wavetpu_router_fault_injections_total'
                    f'{{kind="{inj["kind"]}"}}'
                ] = inj["fired"]
        lines = [f"{k} {float(v)}" for k, v in sorted(agg.items())]
        lines += [f"{k} {float(v)}" for k, v in sorted(own.items())]
        return "\n".join(lines) + "\n"


class _RouterHandler(BaseHTTPRequestHandler):
    # Same HTTP/1.1 + single-send-path discipline as serve/api.py: the
    # keep-alive WavetpuClient holds one socket to the router across a
    # whole replay; error paths that skip reading the request body
    # answer with Connection: close.
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 (quiet, like serve)
        pass

    @property
    def rstate(self) -> RouterState:
        return self.server.wavetpu_router

    def _send(self, code: int, payload: dict,
              headers: Optional[dict] = None) -> None:
        self._send_bytes(code, json.dumps(payload).encode(),
                         "application/json", headers)

    def _send_bytes(self, code: int, body: bytes, content_type: str,
                    headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    # ---- GET ----

    def do_GET(self) -> None:  # noqa: N802 (stdlib contract)
        st = self.rstate
        if self.path == "/healthz":
            members = st.table.summary()
            up = sum(1 for m in members if m["state"] == "up")
            payload = {
                "status": "ok",
                "router": True,
                # Preflight-compatible readiness: route here iff at
                # least one member can take traffic AND this router
                # holds the lease (a standby tells load balancers and
                # loadgen preflights NOT to point measured traffic at
                # it; the multi-endpoint client finds it on rotation).
                "ready": up > 0 and st.role == fleet_ha.ACTIVE,
                "draining": False,
                "role": st.role,
                "uptime_seconds": round(time.time() - st.started, 3),
                "members_up": up,
                "members": members,
            }
            if st.ha is not None:
                payload["ha"] = st.ha.snapshot()
            self._send(200, payload)
        elif self.path == "/metrics":
            accept = self.headers.get("Accept", "") or ""
            wants_text = (
                "application/json" not in accept
                and ("text/plain" in accept or "openmetrics" in accept)
            )
            if wants_text:
                self._send_bytes(
                    200, st.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            else:
                self._send(200, st.snapshot())
        else:
            self._send(404, {"status": "error", "error": "not found"})

    # ---- POST ----

    def _read_body(self) -> Optional[bytes]:
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            return None
        limit = self.rstate.max_body_bytes
        if limit is not None and length > limit:
            return None
        return self.rfile.read(length) if length > 0 else b""

    def do_POST(self) -> None:  # noqa: N802
        st = self.rstate
        if self.path in ("/admin/join", "/admin/leave"):
            raw = self._read_body()
            try:
                body = json.loads(raw or b"{}")
                url = body["url"]
            except (ValueError, KeyError, TypeError):
                self._send(400, {
                    "status": "error",
                    "error": 'admin body must be {"url": "http://..."}',
                }, {"Connection": "close"})
                return
            if self.path == "/admin/join":
                # baseline=True: a mid-flight joiner's pre-join
                # counters (manifest warmup) must not show up as fleet
                # delta growth.
                m = st.table.add(url, baseline=True)
                # Admit without waiting for the next poll tick - the
                # roll driver polls router /healthz for the flip.
                st.table.poll_member(m)
                self._send(200, {"status": "ok", "member": m.summary()})
            else:
                found = st.leave_member(
                    url,
                    drain=bool(body.get("drain", True)),
                    drain_wait_s=float(body.get("drain_wait_s", 30.0)),
                    sync=bool(body.get("sync", False)),
                )
                if not found:
                    self._send(404, {
                        "status": "error",
                        "error": f"unknown member {url}",
                    })
                else:
                    self._send(200, {"status": "ok", "leaving": url})
            return
        if self.path != "/solve":
            self._send(404, {"status": "error", "error": "not found"},
                       {"Connection": "close"})
            return
        raw = self._read_body()
        if raw is None:
            self._send(413, {
                "status": "error",
                "error": "request body too large for this router",
            }, {"Connection": "close"})
            return
        self._proxy_solve(raw)

    # ---- the proxy data path ----

    def _affinity_key(self, raw: bytes) -> Optional[str]:
        """The request's routing identity, or None (unkeyed: malformed
        bodies are still FORWARDED - the replica owns the 400 contract;
        the router must stay transparent to error-shape tests).  Reuses
        the ONE body parse _proxy_solve did (quota pricing and routing
        identity share it)."""
        st = self.rstate
        body = self._body_obj
        try:
            if body is None:
                raise ValueError("unparseable body")
            return progkey.identity_from_body(
                body, platform=st.platform
            ).affinity_key()
        except (ValueError, TypeError, KeyError):
            with st._lock:  # noqa: SLF001
                st.unparseable_total += 1
            return None

    def _auth_tenant(self) -> Tuple[
        bool, Optional[str], Optional[quota.TenantConfig]
    ]:
        """API-key termination: (authorized, tenant_label, config).
        With no --api-keys-file every request is authorized with a
        pass-through tenant and no config (trusted internal mode); with
        one, the key must be in the map (Authorization: Bearer K, or
        X-Api-Key: K) and the MAPPED label replaces whatever tenant
        header the caller sent - a client can never self-assign a
        billing identity.  The returned TenantConfig carries the
        tenant's quota buckets + priority default/ceiling."""
        st = self.rstate
        if st.api_keys is None:
            return True, self.headers.get("X-Wavetpu-Tenant"), None
        key = self.headers.get("X-Api-Key")
        if not key:
            auth = self.headers.get("Authorization", "") or ""
            if auth.startswith("Bearer "):
                key = auth[len("Bearer "):].strip()
        cfg = st.api_keys.get(key) if key else None
        if cfg is None:
            return False, None, None
        return True, cfg.tenant, cfg

    def _echo_headers(self, base: Optional[dict] = None) -> dict:
        """Response headers + the trace-context echo (satellite of the
        traceparent contract: EVERY /solve answer names its fleet
        trace, so an outlier in a client-side report resolves to its
        trace with no translation table)."""
        out = dict(base or {})
        if self._echo_tp:
            out["traceparent"] = self._echo_tp
        return out

    def _proxy_solve(self, raw: bytes) -> None:
        st = self.rstate
        t0 = time.monotonic()
        with st._lock:  # noqa: SLF001
            st.requests_total += 1
        if st.role != fleet_ha.ACTIVE:
            # A standby must not admit (that would double every quota)
            # or proxy (split-brain routing).  The 503 is retriable and
            # carries `standby: true` so a multi-endpoint WavetpuClient
            # rotates to the active immediately instead of backing off
            # against this endpoint.
            with st._lock:  # noqa: SLF001
                st.standby_rejected_total += 1
            self._send(503, {
                "status": "error",
                "error": "standby router (not the lease holder)",
                "retriable": True,
                "standby": True,
            }, {"Retry-After": "1"})
            return
        if st.fault_plan is not None and st.fault_plan.fire(
                "router-crash") is not None:
            # The chaos drill's dead-active: a REAL SIGKILL of this
            # process, mid-request - no flush, no lease release, no
            # response.  The standby must take over within one TTL and
            # the client must see only a transport error it absorbs.
            import signal as _signal

            os.kill(os.getpid(), _signal.SIGKILL)
        authorized, tenant, cfg = self._auth_tenant()
        if not authorized:
            with st._lock:  # noqa: SLF001
                st.auth_rejected_total += 1
            self._send(401, {
                "status": "error",
                "error": "missing or unknown API key",
            }, {"Connection": "close",
                "WWW-Authenticate": "Bearer"})
            return
        if tenant:
            with st._lock:  # noqa: SLF001
                st.requests_per_tenant[tenant] = (
                    st.requests_per_tenant.get(tenant, 0) + 1
                )
        # ONE body parse, shared by quota pricing (here), the edge
        # result-cache key, and the affinity-key derivation
        # (_route_solve).
        self._body_obj = None
        try:
            self._body_obj = json.loads(raw)
        except (ValueError, TypeError):
            pass
        # Edge result cache (fleet/edgecache.py): same torch-free key
        # derivation the replica tier uses.  The key is computed even
        # under `Cache-Control: no-cache` (the fresh answer still
        # refreshes the edge); only the LOOKUP is bypassed.
        self._edge_key: Optional[str] = None
        self._priced_cells = 0.0
        edge_hit = None
        if st.edge is not None and isinstance(self._body_obj, dict) \
                and progkey.result_cache_eligible(self._body_obj):
            try:
                self._edge_key = progkey.result_key(
                    self._body_obj, platform=st.platform
                )
            except (ValueError, TypeError, KeyError):
                self._edge_key = None
        if self._edge_key is not None and "no-cache" not in (
                self.headers.get("Cache-Control") or "").lower():
            edge_hit = st.edge.get(self._edge_key)
        # Priority-class authority: on an authenticated router the
        # effective class is the tenant's config default (when the
        # request declares none) clamped at its ceiling - the inbound
        # X-Priority / body claim is an INPUT to the clamp, never
        # forwarded as-is.
        self._priority: Optional[str] = None
        if cfg is not None:
            requested = self.headers.get("X-Priority")
            if requested is None and isinstance(self._body_obj, dict):
                requested = self._body_obj.get("priority")
            self._priority = cfg.effective_priority(
                requested if isinstance(requested, str) else None
            )
        # Authoritative per-tenant quota spend (requests/s + model-
        # priced cells/s) BEFORE routing: an over-quota request never
        # occupies a replica slot.  Retry-After is the measured bucket
        # refill time for this request's cost.  On an open router
        # (--quota-default-* without --api-keys-file) pass-through
        # tenant labels spend the default buckets.
        if cfg is None and tenant and st.quotas.enforces_anything:
            cfg = quota.TenantConfig(tenant=tenant)
        if cfg is not None:
            # An edge hit is still individually charged its request-
            # rate token, but its cells price is the MEASURED cost of
            # answering - a dict lookup, near zero - not the analytic
            # model's full march volume.
            self._priced_cells = (
                0.0 if edge_hit is not None
                else quota.price_cells(self._body_obj)
            )
            ok, retry = st.quotas.admit(cfg, self._priced_cells)
            if not ok:
                with st._lock:  # noqa: SLF001
                    st.quota_rejected_total += 1
                self._send(429, {
                    "status": "error",
                    "error": (
                        f"tenant {tenant!r} quota exhausted"
                    ),
                    "retriable": True,
                    "retry_after_s": round(retry, 3),
                }, {"Retry-After": str(max(1, int(retry + 0.5)))})
                return
        # Distributed tracing (docs/observability.md): adopt the
        # client's W3C traceparent as the remote parent of a
        # `router.request` span (minting a fresh trace id for
        # context-less callers); per-attempt spans/events nest under it
        # on this handler thread.  An UNtraced router still forwards
        # the inbound context verbatim (it rides
        # _FORWARD_REQUEST_HEADERS) and echoes it back.
        inbound_tp = self.headers.get("traceparent")
        inbound = tracing.parse_traceparent(inbound_tp)
        self._trace_id: Optional[str] = None
        self._echo_tp: Optional[str] = inbound_tp if inbound else None
        span = None
        if st.tracer is not None:
            self._trace_id = (
                inbound[0] if inbound else tracing.mint_trace_id()
            )
            req_w3c = tracing.mint_span_id()
            self._echo_tp = tracing.format_traceparent(
                self._trace_id, req_w3c
            )
            span = st.tracer.begin(
                "router.request",
                {
                    "request_id": (
                        self.headers.get("X-Request-Id") or ""
                    ),
                    "tenant": tenant or "",
                    "w3c_id": req_w3c,
                },
                remote=(
                    self._trace_id, inbound[1] if inbound else None
                ),
            )
        status = 0
        try:
            if edge_hit is not None:
                status = self._serve_edge_hit(edge_hit, t0)
            else:
                status = self._route_solve(raw, t0, tenant)
        finally:
            with st._lock:  # noqa: SLF001
                st.proxy_wall_ms_total += (
                    (time.monotonic() - t0) * 1e3
                )
            if span is not None:
                st.tracer.end(span, status=status)

    def _serve_edge_hit(self, hit: Tuple[bytes, str, Optional[str]],
                        t0: float) -> int:
        """Answer a /solve from the edge index: the EXACT replica
        payload bytes, with ZERO replica I/O (no forward, no queue
        slot, no batch - the drill pins the replica batch counter
        unchanged)."""
        payload, content_type, _orig_timing = hit
        out = {
            "X-Wavetpu-Cache": "edge-hit",
            "Server-Timing": (
                f"cache;desc=edge-hit, "
                f"total;dur={(time.monotonic() - t0) * 1e3:.3f}"
            ),
        }
        self._send_bytes(200, payload, content_type,
                         self._echo_headers(out))
        return 200

    def _route_solve(self, raw: bytes, t0: float,
                     tenant: Optional[str]) -> int:
        """The member-retry routing loop; sends the response and
        returns the status it answered with (the wrapper's span/metric
        bookkeeping wants it)."""
        st = self.rstate
        rid = self.headers.get("X-Request-Id") or ""
        ak = self._affinity_key(raw)
        fwd_headers = {
            h: self.headers[h]
            for h in _FORWARD_REQUEST_HEADERS if self.headers.get(h)
        }
        fwd_headers.setdefault("Content-Type", "application/json")
        if st.api_keys is not None:
            # The router is the tenant AND class authority: stamp the
            # mapped label and the ceiling-clamped effective class,
            # never the caller's claims.
            fwd_headers.pop("X-Wavetpu-Tenant", None)
            fwd_headers.pop("X-Priority", None)
            if tenant:
                fwd_headers["X-Wavetpu-Tenant"] = tenant
            if self._priority:
                fwd_headers["X-Priority"] = self._priority
        if st.proxy_token is not None:
            # Replica-side trust: replicas started with the same
            # --proxy-token honor tenant/priority headers only when
            # this secret rides along.
            fwd_headers["X-Wavetpu-Proxy-Token"] = st.proxy_token
        # Client deadline budget (X-Deadline-Ms): each attempt forwards
        # the REMAINING budget - the original minus router-side
        # queue/retry wall already burned - so a replica never marches
        # against wall the client no longer has.
        budget_ms: Optional[float] = None
        raw_dl = self.headers.get("X-Deadline-Ms")
        if raw_dl is not None:
            try:
                budget_ms = float(raw_dl)
            except ValueError:
                budget_ms = None  # replica owns the 400 contract
        tried = []
        last: Optional[Tuple[int, bytes, Dict[str, str]]] = None
        while True:
            candidates = [
                u for u in st.table.routable_urls() if u not in tried
            ]
            if not candidates:
                break
            remaining_ms = None
            if budget_ms is not None:
                remaining_ms = (
                    budget_ms - (time.monotonic() - t0) * 1e3
                )
                if tried and remaining_ms < st.min_retry_budget_ms:
                    # A retry below the budget floor cannot finish in
                    # time: stop here and surface the last answer.
                    with st._lock:  # noqa: SLF001
                        st.budget_stops_total += 1
                    break
                if remaining_ms <= 0:
                    # Budget fully burned router-side: answer the 504
                    # ourselves rather than making a replica say it.
                    self._send(504, {
                        "status": "error",
                        "error": (
                            f"deadline_ms {budget_ms:g} expired at the "
                            f"router before any replica could serve"
                        ),
                        "deadline_ms": budget_ms,
                    }, self._echo_headers())
                    return 504
                fwd_headers["X-Deadline-Ms"] = (
                    f"{max(1.0, remaining_ms):.0f}"
                )
            if tried:
                url = self._retry_pick(candidates, ak)
            else:
                url = st.affinity.choose(ak, candidates, st.load_of)
            member = st.table.get(url)
            if member is not None:
                with st.table._lock:  # noqa: SLF001
                    member.inflight += 1
            att_span = None
            if st.tracer is not None:
                # A fresh per-attempt wire context under the SAME trace
                # id: the replica's serve.request adopts it as remote
                # parent, so each attempt's replica tree hangs under
                # its own router.attempt span.
                att_w3c = tracing.mint_span_id()
                fwd_headers["traceparent"] = tracing.format_traceparent(
                    self._trace_id, att_w3c
                )
                att_span = st.tracer.begin(
                    "router.attempt",
                    {"request_id": rid, "member": url,
                     "attempt": len(tried) + 1, "w3c_id": att_w3c},
                )
            try:
                status, body, headers = st.conns.request(
                    url, "POST", "/solve", raw, fwd_headers,
                    st.proxy_timeout,
                )
                last = (status, body, headers)
            except (OSError, http.client.HTTPException):
                status, last = 0, None
            finally:
                if member is not None:
                    with st.table._lock:  # noqa: SLF001
                        member.inflight = max(0, member.inflight - 1)
            tried.append(url)
            replica_ms = None
            if last is not None and status != 0:
                replica_ms = _server_timing_total_ms(
                    last[2].get("Server-Timing")
                )
            if replica_ms is not None:
                with st._lock:  # noqa: SLF001
                    st.upstream_wall_ms_total += replica_ms
            if att_span is not None:
                extra = {"status": status}
                if replica_ms is not None:
                    extra["replica_ms"] = replica_ms
                st.tracer.end(att_span, **extra)
            if status == 200 and ak is not None:
                st.affinity.observe_response(
                    url, ak,
                    warm_label_from_server_timing(
                        (last[2] if last else {}).get("Server-Timing")
                    ),
                )
            # Transport failures and 503s (draining / breaker /
            # crashed worker) are MEMBER problems, not request
            # problems: try a different member before surfacing
            # anything.  Every other status is the request's answer.
            if status not in (0, 503):
                break
            if status == 503 and last is not None:
                # Cross-replica solve handoff: a draining replica's 503
                # may carry a resume_token (a checkpointed long solve).
                # Re-inject it into the body so the NEXT member picks
                # the march up from the last completed chunk instead of
                # restarting at layer 0.
                token = None
                try:
                    token = json.loads(last[1]).get("resume_token")
                except (ValueError, AttributeError):
                    pass
                if isinstance(token, str) and token:
                    try:
                        body_obj = json.loads(raw)
                        body_obj["resume_token"] = token
                        raw = json.dumps(body_obj).encode()
                        with st._lock:  # noqa: SLF001
                            st.resume_handoffs_total += 1
                        if st.tracer is not None:
                            st.tracer.event(
                                "router.drain_handoff",
                                request_id=rid, from_member=url,
                                resume_token=token,
                            )
                    except (ValueError, TypeError):
                        pass
            if st.tracer is not None:
                st.tracer.event(
                    "router.retry", request_id=rid,
                    from_member=url, status=status,
                )
        retried = len(tried) > 1
        if last is not None and last[0] not in (0, 503):
            status, body, headers = last
            cache_hdr = headers.get("X-Wavetpu-Cache") or ""
            if status == 200 and cache_hdr:
                if cache_hdr.startswith("store;fp=") \
                        and st.edge is not None \
                        and self._edge_key is not None:
                    # The replica just stored this answer in ITS tier:
                    # adopt the exact bytes at the edge under the
                    # replica's fingerprint tag (a NEW tag flushes the
                    # old fleet's entries).
                    st.edge.put(
                        self._edge_key, body,
                        headers.get("Content-Type", "application/json"),
                        headers.get("Server-Timing"),
                        fp=cache_hdr[len("store;fp="):],
                    )
                elif cache_hdr in ("hit", "coalesced") and tenant \
                        and self._priced_cells > 0:
                    # Replica-tier cache hit / singleflight ride: no
                    # march happened, so the analytic cells price
                    # collapses to measured near-zero (the rps token
                    # stays spent - every request is charged).
                    st.quotas.refund_cells(tenant, self._priced_cells)
            out = {
                h: headers[h]
                for h in _FORWARD_RESPONSE_HEADERS if headers.get(h)
            }
            out["X-Wavetpu-Member"] = tried[-1]
            st.note_proxied(tried[-1], retried, len(tried) - 1)
            self._send_bytes(
                status, body,
                headers.get("Content-Type", "application/json"),
                self._echo_headers(out),
            )
            return status
        # Exhausted: every member refused (or none exist).  Answer in
        # the replica's own retriable-503 shape so WavetpuClient backs
        # off and retries through the cutover exactly as it would
        # against a single draining replica.
        with st._lock:  # noqa: SLF001
            st.exhausted_total += 1
            if retried:
                st.retried_requests += 1
            st.retries_total += max(0, len(tried) - 1)
        if last is not None and last[0] == 503:
            out = {
                h: last[2][h]
                for h in _FORWARD_RESPONSE_HEADERS if last[2].get(h)
            }
            out.setdefault("Retry-After", "2")
            out["X-Wavetpu-Member"] = tried[-1]
            self._send_bytes(
                503, last[1],
                last[2].get("Content-Type", "application/json"),
                self._echo_headers(out),
            )
            return 503
        self._send(503, {
            "status": "error",
            "error": (
                "no live fleet member could serve the request"
                if tried else "fleet has no routable members"
            ),
            "retriable": True,
        }, self._echo_headers({"Retry-After": "2"}))
        return 503

    def _retry_pick(self, candidates, affinity_key=None) -> str:
        """Retry attempts skip the affinity counters (one request, one
        counted decision).  Unlike wavetpu's router, whose retry takes
        the least-loaded pair of all candidates, they keep to the live
        holders of the request's key where there are any: a drained
        replica's chunked march then resumes where its tier's kernels
        are already loaded, not on a member that must build them first.
        Then the least-loaded pair pick."""
        st = self.rstate
        holders = (st.affinity.holders(affinity_key)
                   if affinity_key is not None else set())
        pool = [c for c in candidates if c in holders] or list(candidates)
        if len(pool) == 1:
            return pool[0]
        pair = random.sample(pool, 2)
        return min(pair, key=st.load_of)


def build_router(
    member_urls: Sequence[str],
    host: str = "127.0.0.1",
    port: int = 0,
    poll_interval_s: float = 2.0,
    fail_threshold: int = 3,
    proxy_timeout: float = 120.0,
    max_body_bytes: Optional[int] = None,
    fetch=None,
    rng: Optional[random.Random] = None,
    start_poller: bool = True,
    min_retry_budget_ms: float = 50.0,
    api_keys: Optional[Dict] = None,
    telemetry_dir: Optional[str] = None,
    quotas: Optional[quota.QuotaManager] = None,
    proxy_token: Optional[str] = None,
    control_plane_dir: Optional[str] = None,
    lease_ttl_s: float = 2.0,
    store_flush_interval_s: float = 0.5,
    ha_owner: Optional[str] = None,
    start_ha: bool = True,
    edge_cache: bool = False,
    edge_cache_max_bytes: Optional[int] = None,
    edge_cache_ttl_s: Optional[float] = None,
) -> Tuple[ThreadingHTTPServer, RouterState]:
    """Assemble membership + affinity + HTTP front (port 0 =
    ephemeral).  Does ONE synchronous poll before returning so the
    rotation is populated the moment the caller starts serving; the
    periodic poller (start_poller) keeps it fresh.  Returned httpd is
    not yet serving - call serve_forever() (main does) or drive it
    from a thread (tests do).  `telemetry_dir` turns on the router's
    own span tracing (DIR/trace.jsonl, rotated like a replica's).
    `api_keys` accepts either the PR-12 flat {key: label} map or
    {key: TenantConfig}; `quotas` carries the router-wide default
    bucket rates (--quota-default-*), and `proxy_token` is stamped on
    every forwarded request for replica-side tenant trust.

    `control_plane_dir` turns on the durable control plane + HA
    (fleet/store.py, fleet/ha.py): the router elects through the dir's
    single-writer lease (first election is SYNCHRONOUS - a lone router
    boots straight to active with persisted quota/membership/counter
    state restored, before serving a request; a second router over the
    same dir boots standby and answers retriable standby-503s until
    the lease frees).  `ha_owner` names this router in the lease
    (default host:port#pid); `start_ha=False` leaves the coordinator
    un-started for tests that drive ticks by hand.

    `edge_cache` (--edge-cache, default OFF) turns on the router edge
    result tier (fleet/edgecache.py): repeats of answers the replicas
    stamped `X-Wavetpu-Cache: store;fp=H` are served at the router with
    zero replica I/O, and with a control plane the index persists as
    the store's `edge_cache` section (restart/HA-promotion warm)."""
    from wavetpu_torch.run.faults import router_plan_from_env

    fault_plan = router_plan_from_env()
    affinity = AffinityTable(rng=rng)
    table = MembershipTable(
        member_urls, fail_threshold=fail_threshold, fetch=fetch,
        affinity=affinity,
    )
    state = RouterState(
        table, affinity, proxy_timeout=proxy_timeout,
        max_body_bytes=max_body_bytes,
        min_retry_budget_ms=min_retry_budget_ms, api_keys=api_keys,
        quotas=quotas, proxy_token=proxy_token,
    )
    state.fault_plan = fault_plan
    if edge_cache:
        from wavetpu_torch.fleet import edgecache as _edgecache

        # Built BEFORE the HA coordinator: the first (synchronous)
        # election restore adopts the persisted `edge_cache` section
        # into this instance.
        state.edge = EdgeCache(
            max_bytes=(edge_cache_max_bytes
                       or _edgecache.DEFAULT_MAX_BYTES),
            ttl_s=edge_cache_ttl_s or _edgecache.DEFAULT_TTL_S,
        )
    if telemetry_dir is not None:
        state.tracer = tracing.Tracer(
            os.path.join(telemetry_dir, TRACE_FILENAME),
            max_bytes=DEFAULT_MAX_BYTES, keep=ROTATE_KEEP,
        )
    table.poll_once()
    httpd = ThreadingHTTPServer((host, port), _RouterHandler)
    httpd.wavetpu_router = state
    if control_plane_dir is not None:
        state.store = ControlPlaneStore(
            control_plane_dir, fault_plan=fault_plan
        )
        bound = httpd.server_address
        owner = ha_owner or f"{bound[0]}:{bound[1]}#{os.getpid()}"
        lease = fleet_ha.LeaseManager(
            control_plane_dir, owner, ttl_s=lease_ttl_s,
            fault_plan=fault_plan,
        )
        state.ha = fleet_ha.HACoordinator(
            state.store, lease,
            export_state=state.export_state,
            restore_state=state.restore_state,
            flush_interval_s=store_flush_interval_s,
        )
        if start_ha:
            state.ha.start()
    if start_poller:
        state.start_poller(poll_interval_s)
    return httpd, state


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        pos, flags = split_flags(
            argv,
            known=("member", "host", "port", "poll-interval-s",
                   "fail-threshold", "proxy-timeout-s",
                   "max-body-bytes", "min-retry-budget-ms",
                   "api-keys-file", "quota-default-rps",
                   "quota-default-burst", "quota-default-cells-per-s",
                   "quota-default-cells-burst", "proxy-token",
                   "telemetry-dir", "control-plane-dir",
                   "lease-ttl-s", "store-flush-interval-s",
                   "edge-cache", "edge-cache-max-bytes",
                   "edge-cache-ttl-s"),
            valueless=("edge-cache",),
            allow_positionals=False,
            repeatable=("member",),
        )
        members = list(flags.get("member") or [])
        if not members:
            raise ValueError("router needs at least one --member URL")
        host = flags.get("host", "127.0.0.1")
        port = int(flags.get("port", "8070"))
        poll_interval_s = float(flags.get("poll-interval-s", "2"))
        fail_threshold = int(flags.get("fail-threshold", "3"))
        proxy_timeout = float(flags.get("proxy-timeout-s", "120"))
        max_body_bytes = (
            int(flags["max-body-bytes"])
            if "max-body-bytes" in flags else None
        )
        min_retry_budget_ms = float(
            flags.get("min-retry-budget-ms", "50")
        )
        api_keys = (
            load_api_keys(flags["api-keys-file"])
            if "api-keys-file" in flags else None
        )
        quotas = quota.QuotaManager(
            default_rps=(
                float(flags["quota-default-rps"])
                if "quota-default-rps" in flags else None
            ),
            default_burst=(
                float(flags["quota-default-burst"])
                if "quota-default-burst" in flags else None
            ),
            default_cells_per_s=(
                float(flags["quota-default-cells-per-s"])
                if "quota-default-cells-per-s" in flags else None
            ),
            default_cells_burst=(
                float(flags["quota-default-cells-burst"])
                if "quota-default-cells-burst" in flags else None
            ),
        )
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2
    try:
        lease_ttl_s = float(flags.get("lease-ttl-s", "2"))
        store_flush_interval_s = float(
            flags.get("store-flush-interval-s", "0.5")
        )
        edge_cache_max_bytes = (
            int(flags["edge-cache-max-bytes"])
            if "edge-cache-max-bytes" in flags else None
        )
        edge_cache_ttl_s = (
            float(flags["edge-cache-ttl-s"])
            if "edge-cache-ttl-s" in flags else None
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2
    httpd, state = build_router(
        members, host=host, port=port,
        poll_interval_s=poll_interval_s, fail_threshold=fail_threshold,
        proxy_timeout=proxy_timeout, max_body_bytes=max_body_bytes,
        min_retry_budget_ms=min_retry_budget_ms, api_keys=api_keys,
        telemetry_dir=flags.get("telemetry-dir"),
        quotas=quotas, proxy_token=flags.get("proxy-token"),
        control_plane_dir=flags.get("control-plane-dir"),
        lease_ttl_s=lease_ttl_s,
        store_flush_interval_s=store_flush_interval_s,
        edge_cache="edge-cache" in flags,
        edge_cache_max_bytes=edge_cache_max_bytes,
        edge_cache_ttl_s=edge_cache_ttl_s,
    )
    if state.edge is not None:
        print(
            f"edge cache: on ({state.edge.max_bytes >> 20} MiB, "
            f"ttl {state.edge.ttl_s:g}s)"
        )
    if api_keys is not None:
        n_tenants = len({c.tenant for c in api_keys.values()})
        n_quota = sum(
            1 for c in api_keys.values()
            if c.rps is not None or c.cells_per_s is not None
        )
        print(f"api keys: {len(api_keys)} key(s) -> "
              f"{n_tenants} tenant(s), {n_quota} with quotas")
    if state.tracer is not None:
        print(f"telemetry: router spans -> {state.tracer.path}")
    if state.ha is not None:
        print(
            f"control plane: {flags['control-plane-dir']} "
            f"(role {state.role}, lease ttl {lease_ttl_s:g}s, "
            f"flush every {store_flush_interval_s:g}s)"
        )
    bound = httpd.server_address
    up = len(state.table.routable_urls())
    print(
        f"wavetpu_torch router on http://{bound[0]}:{bound[1]} "
        f"({up}/{len(members)} members up, poll every "
        f"{poll_interval_s:g}s, fail threshold {fail_threshold})"
    )
    for m in state.table.summary():
        print(f"  member {m['url']}: {m['state']}"
              + (f" [{m['backend']}]" if m["backend"] else ""))
    import signal

    def _shutdown(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    try:
        httpd.serve_forever()
    finally:
        state.stop_poller()
        if state.ha is not None:
            # Orderly exit: final flush + lease release so a standby
            # promotes immediately instead of waiting out the TTL.
            state.ha.stop(release=True)
        httpd.server_close()
        if state.tracer is not None:
            state.tracer.close()
    print("wavetpu_torch router: shut down")
    return 0


if __name__ == "__main__":
    sys.exit(main())
