"""Per-tenant quotas for the router tier: token buckets + tenant QoS
config parsed from the --api-keys-file schema (the port's copy of
wavetpu/fleet/quota.py).

The router is the AUTHORITATIVE quota point (replicas keep only a
defensive per-tenant in-flight cap - serve/api.py): every authenticated
/solve spends from its tenant's two token buckets BEFORE routing:

 * requests/s  - each request costs 1 token.  Caps call rate.
 * cells/s     - each request costs its MODEL-PRICED cell volume:
   `cells_per_step x timesteps`, weighted by the request path's
   memory bytes-per-cell relative to the roll stencil's, so one giant
   solve spends proportionally more than a hundred tiny ones and a
   cheap path spends less than an expensive one.  The weights are
   wavetpu's, not the port's cost model: two routers (one of each
   package) on one control plane must charge a body the same, so
   `price_cells` keeps its own copy of the figures wavetpu's
   obs/perf.py `model_bytes_per_cell` gives it (`_bytes_per_cell`).

Exhausting EITHER bucket answers 429 with `Retry-After` set to the
MEASURED refill time - `(cost - tokens) / rate` - not a constant: the
client (WavetpuClient honors Retry-After over its own backoff) returns
exactly when the bucket can afford the request again.

Priority-class policy also lives in the tenant config: each tenant has
a default class (applied when a request declares none) and a CEILING
(the highest class its requests may claim; the router clamps and stamps
`X-Priority`, stripping the inbound header like it strips tenant
claims, so a tenant can never self-promote past its contract).

Stdlib-only; imports neither torch nor jax (this module runs in the
router process).  The class ladder here must stay identical to
serve/scheduler.py's - tests/test_torch_fleet.py pins the two tuples
equal.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Highest-to-lowest, identical to serve/scheduler.py PRIORITY_CLASSES
# (pinned by tests; duplicated because the router must not import the
# torch-loading serve package).
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")
DEFAULT_PRIORITY = "batch"

# cells/s pricing is normalized so the roll stencil costs exactly its
# geometric cell count: weight = _bytes_per_cell(path) / this.
_BASELINE_BYTES_PER_CELL = 12.0

# wavetpu's path names whose traffic model is an onion that needs the
# grid size (model_bytes_per_cell returns None without one, and a body
# priced here never passes one).
_ONION_PATHS = ("kfused", "sharded_kfused", "kfused_comp",
                "kfused_comp_sharded")


def _bytes_per_cell(path: str) -> Optional[float]:
    """wavetpu's `model_bytes_per_cell(path, k=k)` as `price_cells`
    calls it (f32, standard scheme, no grid size): None for the onion
    paths, 6 f32 streams for `compensated`, 3 for every other name."""
    if path in _ONION_PATHS:
        return None
    if path == "compensated":
        return 6.0 * 4
    return 3.0 * 4


def normalize_priority(value, default: str = DEFAULT_PRIORITY) -> str:
    """Lenient class parse (same contract as the scheduler's): strip +
    lower; anything unknown (None, junk, empty) maps to `default`, so a
    bad label degrades to policy rather than erroring a request."""
    if isinstance(value, str):
        v = value.strip().lower()
        if v in PRIORITY_CLASSES:
            return v
    return default


def clamp_priority(requested: str, ceiling: str) -> str:
    """The effective class: `requested` demoted to `ceiling` when it
    outranks it (lower index = higher class).  Both args must already
    be normalized class names."""
    if PRIORITY_CLASSES.index(requested) < PRIORITY_CLASSES.index(ceiling):
        return ceiling
    return requested


@dataclass
class TenantConfig:
    """One tenant's QoS contract from the --api-keys-file schema.

    `priority` is the default class stamped when a request declares
    none; `priority_ceiling` the highest class it may claim.  The four
    quota fields are all optional - None means "no limit on this axis"
    (a plain-string api-keys entry gets all-None: the historical
    identity-only behavior, bit-for-bit)."""

    tenant: str
    priority: str = DEFAULT_PRIORITY
    priority_ceiling: str = PRIORITY_CLASSES[0]  # interactive = no cap
    rps: Optional[float] = None
    burst: Optional[float] = None
    cells_per_s: Optional[float] = None
    cells_burst: Optional[float] = None

    def effective_priority(self, requested: Optional[str]) -> str:
        """Default-then-clamp: the class the router stamps forward."""
        if requested is None:
            return clamp_priority(self.priority, self.priority_ceiling)
        return clamp_priority(
            normalize_priority(requested, default=self.priority),
            self.priority_ceiling,
        )


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill toward a `burst`
    cap.  `try_take(cost)` either spends and returns (True, 0.0) or
    leaves the bucket untouched and returns (False, retry_after_s) with
    the measured time until `cost` tokens exist - the 429's
    Retry-After.  Thread-safe; monotonic clock."""

    def __init__(self, rate: float, burst: Optional[float] = None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else float(rate)
        if self.burst <= 0:
            raise ValueError(f"burst must be > 0, got {self.burst}")
        self._tokens = self.burst  # start full: first burst is free
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(
            self.burst, self._tokens + (now - self._t) * self.rate
        )
        self._t = now

    def try_take(self, cost: float = 1.0) -> Tuple[bool, float]:
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            if self._tokens >= cost:
                self._tokens -= cost
                return True, 0.0
            return False, (cost - self._tokens) / self.rate

    def refund(self, cost: float) -> None:
        """Return `cost` tokens (capped at burst).  Used when a spend
        turns out to have priced work that never happened - a /solve
        the replica answered from its result cache or coalesced onto an
        in-flight march costs near-zero cells, not the analytic model's
        full volume."""
        if cost <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            self._tokens = min(self.burst, self._tokens + cost)

    def tokens(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._refill_locked(now)
            return self._tokens

    # ---- persistence (fleet/store.py) ----

    def export_state(self) -> dict:
        """Durable view of this bucket.  The internal clock is
        monotonic (meaningless across processes), so the export pairs
        the refreshed level with a UNIX stamp; restore refills for the
        wall time that elapsed in between - a restarted router neither
        reopens a drained bucket nor double-charges the downtime."""
        return {
            "rate": self.rate,
            "burst": self.burst,
            "tokens": round(self.tokens(), 6),
            "unix": round(time.time(), 6),
        }

    @classmethod
    def restore(cls, data: dict) -> "TokenBucket":
        """A bucket rebuilt from `export_state` output, refilled for
        the wall time since export.  ValueError/KeyError on a
        malformed record (callers treat that as a counted miss)."""
        b = cls(float(data["rate"]), float(data["burst"]))
        elapsed = max(0.0, time.time() - float(data["unix"]))
        b._tokens = min(
            b.burst, float(data["tokens"]) + elapsed * b.rate
        )
        b._t = time.monotonic()
        return b


def price_cells(body: Optional[dict]) -> float:
    """Model-priced cell volume of a /solve body: geometric cell
    updates (`(N+1)^3 x timesteps`, the BASELINE.md throughput
    definition) weighted by the path's memory traffic relative to the
    roll stencil (wavetpu's weights, `_bytes_per_cell`).  Unparseable
    bodies price 0 (the replica 400s them; they never reach a scheduler
    slot, so they spend only the rps bucket)."""
    if not isinstance(body, dict):
        return 0.0
    try:
        n = int(body.get("N", 0))
        timesteps = int(body.get("timesteps", 20))
        if n <= 0 or timesteps <= 0:
            return 0.0
        cells = float((n + 1) ** 3 * timesteps)
    except (ValueError, TypeError):
        return 0.0
    path = body.get("path") or body.get("kernel") or "roll"
    try:
        # int(k) is checked as wavetpu checks it: a junk k prices at
        # weight 1 whatever the path.
        int(body.get("k", 1) or 1)
        bpc = _bytes_per_cell(str(path))
    except (ValueError, TypeError):
        bpc = None
    weight = (bpc / _BASELINE_BYTES_PER_CELL) if bpc else 1.0
    return cells * weight


class QuotaManager:
    """Per-tenant bucket pairs, lazily built from TenantConfig (plus
    router-wide defaults for tenants whose config leaves an axis
    unset).  `admit(cfg, cells)` spends both buckets atomically-enough:
    the rps bucket first (cheap), then cells - on a cells refusal the
    rps token is NOT refunded (the request did arrive; refunding would
    let a flood of oversized requests probe for free)."""

    def __init__(self, default_rps: Optional[float] = None,
                 default_burst: Optional[float] = None,
                 default_cells_per_s: Optional[float] = None,
                 default_cells_burst: Optional[float] = None):
        self.default_rps = default_rps
        self.default_burst = default_burst
        self.default_cells_per_s = default_cells_per_s
        self.default_cells_burst = default_cells_burst
        self._lock = threading.Lock()
        self._rps: Dict[str, TokenBucket] = {}
        self._cells: Dict[str, TokenBucket] = {}
        self.rejected_per_tenant: Dict[str, int] = {}

    @property
    def enforces_anything(self) -> bool:
        return any(v is not None for v in (
            self.default_rps, self.default_cells_per_s,
        ))

    def _bucket(self, pool: Dict[str, TokenBucket], tenant: str,
                rate: Optional[float],
                burst: Optional[float]) -> Optional[TokenBucket]:
        if rate is None:
            return None
        b = pool.get(tenant)
        if b is None:
            b = TokenBucket(rate, burst if burst is not None else rate)
            pool[tenant] = b
        return b

    def admit(self, cfg: TenantConfig,
              cells: float) -> Tuple[bool, float]:
        """(admitted, retry_after_s).  retry_after_s is the measured
        refill wait of whichever bucket refused (0.0 on admit)."""
        with self._lock:
            rps = self._bucket(
                self._rps, cfg.tenant,
                cfg.rps if cfg.rps is not None else self.default_rps,
                cfg.burst if cfg.burst is not None else self.default_burst,
            )
            cb = self._bucket(
                self._cells, cfg.tenant,
                cfg.cells_per_s if cfg.cells_per_s is not None
                else self.default_cells_per_s,
                cfg.cells_burst if cfg.cells_burst is not None
                else self.default_cells_burst,
            )
        if rps is not None:
            ok, retry = rps.try_take(1.0)
            if not ok:
                self._note_rejected(cfg.tenant)
                return False, retry
        if cb is not None and cells > 0:
            # A request larger than the burst can NEVER pass; answer
            # with one full-bucket refill rather than a precise-but-
            # unreachable wait (the client would retry forever).
            cost = min(cells, cb.burst)
            ok, retry = cb.try_take(cost)
            if not ok:
                self._note_rejected(cfg.tenant)
                return False, retry
        return True, 0.0

    def refund_cells(self, tenant: str, cells: float) -> None:
        """Return model-priced cells to a tenant's bucket after the
        fleet learned the request was answered WITHOUT marching (result
        -cache hit or singleflight ride): the tenant keeps paying the
        1-token request rate - every request is individually charged -
        but the cells price collapses to the measured near-zero cost of
        a cache lookup.  No-op for tenants with no cells bucket."""
        if cells <= 0:
            return
        with self._lock:
            cb = self._cells.get(tenant)
        if cb is not None:
            cb.refund(min(cells, cb.burst))

    def _note_rejected(self, tenant: str) -> None:
        with self._lock:
            self.rejected_per_tenant[tenant] = (
                self.rejected_per_tenant.get(tenant, 0) + 1
            )

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "quota_rejected_per_tenant":
                    dict(self.rejected_per_tenant),
            }

    def levels(self) -> Dict[str, dict]:
        """Live per-tenant bucket levels (the /metrics `quota_buckets`
        block - what the failover-parity drill compares)."""
        with self._lock:
            tenants = set(self._rps) | set(self._cells)
            out: Dict[str, dict] = {}
            for t in sorted(tenants):
                row: Dict[str, float] = {}
                if t in self._rps:
                    row["rps_tokens"] = round(self._rps[t].tokens(), 4)
                if t in self._cells:
                    row["cells_tokens"] = round(
                        self._cells[t].tokens(), 4
                    )
                out[t] = row
            return out

    # ---- persistence (fleet/store.py) ----

    def export_state(self) -> dict:
        """Everything a successor router needs to RESUME enforcement:
        each tenant's bucket levels (with rate/burst/unix, so restore
        can refill for downtime) plus the rejection counters."""
        with self._lock:
            return {
                "rps": {
                    t: b.export_state() for t, b in self._rps.items()
                },
                "cells": {
                    t: b.export_state() for t, b in self._cells.items()
                },
                "rejected_per_tenant": dict(self.rejected_per_tenant),
            }

    def restore_state(self, data: dict) -> int:
        """Adopt persisted bucket levels (malformed per-bucket records
        are skipped - a corrupt entry costs ONE tenant one fresh
        bucket, never the restore).  Rejection counters restore as a
        max-merge so they stay monotonic.  Returns buckets adopted."""
        if not isinstance(data, dict):
            return 0
        adopted = 0
        for field, pool in (("rps", self._rps), ("cells", self._cells)):
            entries = data.get(field)
            if not isinstance(entries, dict):
                continue
            for tenant, rec in entries.items():
                try:
                    bucket = TokenBucket.restore(rec)
                except (KeyError, TypeError, ValueError):
                    continue
                with self._lock:
                    pool[tenant] = bucket
                adopted += 1
        rejected = data.get("rejected_per_tenant")
        if isinstance(rejected, dict):
            with self._lock:
                for tenant, n in rejected.items():
                    try:
                        n = int(n)
                    except (TypeError, ValueError):
                        continue
                    self.rejected_per_tenant[tenant] = max(
                        self.rejected_per_tenant.get(tenant, 0), n
                    )
        return adopted


def parse_tenant_entry(key: str, value) -> TenantConfig:
    """One --api-keys-file entry -> TenantConfig.  A plain string is
    the PR-12 schema (identity only, no quotas, default classes); an
    object grows the QoS fields.  ValueError on anything else."""
    if isinstance(value, str) and value:
        return TenantConfig(tenant=value)
    if isinstance(value, dict):
        tenant = value.get("tenant")
        if not isinstance(tenant, str) or not tenant:
            raise ValueError(
                f"api key {key!r}: object entries need a non-empty "
                f'"tenant" label'
            )
        prio = normalize_priority(value.get("priority"))
        ceiling = normalize_priority(
            value.get("priority_ceiling"),
            default=PRIORITY_CLASSES[0],
        )
        cfg = TenantConfig(
            tenant=tenant,
            # A declared default above the ceiling is clamped at parse
            # time, so the pair is always consistent.
            priority=clamp_priority(prio, ceiling),
            priority_ceiling=ceiling,
        )
        for fname in ("rps", "burst", "cells_per_s", "cells_burst"):
            raw = value.get(fname)
            if raw is None:
                continue
            try:
                fv = float(raw)
            except (ValueError, TypeError):
                raise ValueError(
                    f"api key {key!r}: {fname} must be a number, "
                    f"got {raw!r}"
                ) from None
            if fv <= 0:
                raise ValueError(
                    f"api key {key!r}: {fname} must be > 0, got {fv}"
                )
            setattr(cfg, fname, fv)
        return cfg
    raise ValueError(
        f"api key {key!r}: value must be a tenant-label string or a "
        f"config object, got {type(value).__name__}"
    )


def load_api_keys(path: str) -> Dict[str, TenantConfig]:
    """Parse an --api-keys-file.  Two value shapes per key:

        {"KEY": "tenant-label"}                      (PR-12 schema)
        {"KEY": {"tenant": "label",                  (QoS schema)
                 "priority": "batch",
                 "priority_ceiling": "interactive",
                 "rps": 50, "burst": 100,
                 "cells_per_s": 2.0e8, "cells_burst": 1.0e9}}

    Keys terminate AT the router (replicas never see them); the mapped
    tenant label travels on as X-Wavetpu-Tenant and the effective
    (defaulted, ceiling-clamped) class as X-Priority."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    return parse_api_keys(raw, source=path)


def parse_api_keys(raw, source: str = "api-keys") \
        -> Dict[str, TenantConfig]:
    """Schema validation for an already-loaded api-keys object (the
    build_router path accepts plain dicts from tests/embedding)."""
    if not isinstance(raw, dict) or not raw:
        raise ValueError(
            f"{source}: want a non-empty JSON object "
            f'{{"API_KEY": "tenant-label" | {{config}}, ...}}'
        )
    out: Dict[str, TenantConfig] = {}
    for k, v in raw.items():
        if not isinstance(k, str) or not k:
            raise ValueError(
                f"{source}: API keys must be non-empty strings"
            )
        try:
            out[k] = parse_tenant_entry(k, v)
        except ValueError as e:
            raise ValueError(f"{source}: {e}") from None
    return out
