"""Health-gated fleet membership: who is routable, right now (the
port's copy of wavetpu/fleet/membership.py).

A `Member` is one serve replica; the `MembershipTable` is the router's
authoritative view of the fleet.  The state machine (wavetpu's
docs/fleet.md):

    joining --(healthz ready)--> up
    up --(ready:false / FAIL_THRESHOLD consecutive transport
          failures)--> ejected
    ejected --(healthz ready again)--> up          (re-admission)
    any --(/admin/leave)--> leaving --> left       (terminal)

Only `up` members receive new traffic.  `ejected` members stay in the
table and keep being polled - a replica that was draining, restarting,
or partitioned re-admits itself the moment its /healthz says ready
again, with no operator action.  `left` is terminal: the member's last
parsed Prometheus snapshot is kept FROZEN so the router's aggregated
/metrics stay monotonic across a rolling deploy (a loadgen delta
bracketing a roll must never see counters go backwards because a
replica left the fleet).

Every poll also refreshes the affinity inputs: the member's JSON
/metrics `program_cache.warm_keys` block (which programs it already
holds, memory and disk) and its `queue_depth` (the load half of
power-of-two-choices).

Transport is injectable (`fetch=`) so the state machine is testable
with zero sockets; the default fetch is a short-lived stdlib
urllib request per poll (polls are rare - keep-alive lives in the
proxy data path, not here).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# states
JOINING = "joining"
UP = "up"
EJECTED = "ejected"
LEAVING = "leaving"
LEFT = "left"

ROUTABLE = (UP,)

FetchFn = Callable[[str, str, float, Optional[str]], Tuple[int, str]]


def default_fetch(base_url: str, path: str, timeout: float,
                  accept: Optional[str] = None) -> Tuple[int, str]:
    """GET base_url+path -> (status, body text).  Raises OSError family
    on transport failure (the caller counts those toward ejection)."""
    req = urllib.request.Request(
        base_url.rstrip("/") + path,
        headers={"Accept": accept} if accept else {},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


class Member:
    """One replica's membership record (mutated only under the table's
    lock; `inflight` is the router's own in-flight counter - the
    fresher load signal between metric polls)."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")
        self.state = JOINING
        self.joined_unix = time.time()
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None
        self.health: dict = {}
        self.backend: Optional[str] = None
        self.queue_depth: int = 0
        self.inflight: int = 0
        self.warm_key_count: int = 0
        # Last successfully parsed Prometheus cut {sample: value} -
        # frozen at departure for monotonic fleet aggregation.
        self.prom: Dict[str, float] = {}
        # Join-time snapshot of the member's CUMULATIVE samples,
        # subtracted from its aggregate contribution: a replica
        # admitted mid-flight (rolling deploy) must not inject its
        # pre-join history - e.g. manifest-warmup compiles - into a
        # loadgen delta bracketing the roll.  Empty for founding
        # members (their history IS the fleet's history).
        self.prom_baseline: Dict[str, float] = {}
        self.baseline_pending: bool = False
        self.last_poll_unix: Optional[float] = None
        self.transitions: List[dict] = []

    @property
    def routable(self) -> bool:
        return self.state in ROUTABLE

    def summary(self) -> dict:
        return {
            "url": self.base_url,
            "state": self.state,
            "backend": self.backend,
            "queue_depth": self.queue_depth,
            "inflight": self.inflight,
            "warm_keys": self.warm_key_count,
            "consecutive_failures": self.consecutive_failures,
            "last_error": self.last_error,
        }


def _is_cumulative(sample_name: str) -> bool:
    """True for counter/histogram samples (the ones join-baselining
    applies to); gauges must pass through absolute."""
    bare = sample_name.split("{", 1)[0]
    return bare.endswith(("_total", "_count", "_sum", "_bucket"))


def _parse_prometheus_text(text: str) -> Dict[str, float]:
    """Same minimal parser shape as loadgen/runner.py (duplicated by
    value, not import - loadgen is a peer tier, not a dependency)."""
    samples: Dict[str, float] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        if " # " in line:
            line = line.split(" # ", 1)[0]
        name, _, value = line.rpartition(" ")
        if not name:
            continue
        try:
            samples[name] = float(value.replace("+Inf", "inf"))
        except ValueError:
            continue
    return samples


class MembershipTable:
    """The fleet view: poll, admit, eject, re-admit, retire.

    `fail_threshold` transport failures in a row eject (one flaky poll
    must not empty the rotation); a single `ready: false` ejects
    immediately - the replica SAID do not route here (warming or
    draining), believing it is the whole point of readiness."""

    def __init__(self, member_urls: Sequence[str],
                 fail_threshold: int = 3,
                 poll_timeout: float = 5.0,
                 fetch: Optional[FetchFn] = None,
                 affinity=None):
        self._lock = threading.RLock()
        self._members: Dict[str, Member] = {}
        self.fail_threshold = max(1, int(fail_threshold))
        self.poll_timeout = poll_timeout
        self._fetch = fetch or default_fetch
        # AffinityTable (fleet/affinity.py), fed warm-key observations
        # from every metrics poll; optional so membership is testable
        # alone.
        self.affinity = affinity
        for url in member_urls:
            self.add(url)

    # ---- membership edits ----

    def add(self, base_url: str, baseline: bool = False) -> Member:
        """Join (or re-join) a member.  Re-adding a LEFT url starts a
        fresh record - the frozen counters of the old incarnation stay
        aggregated under a retired alias so deltas stay monotonic.

        `baseline=True` (the /admin/join path) snapshots the member's
        cumulative samples at its first metrics parse and subtracts
        them from its aggregate contribution: a mid-flight joiner's
        pre-join work (manifest-warmup compiles, direct traffic) is not
        fleet work and must not appear as delta growth to a scrape
        bracketing the join."""
        url = base_url.rstrip("/")
        with self._lock:
            existing = self._members.get(url)
            if existing is not None and existing.state != LEFT:
                return existing
            if existing is not None:
                # Retire the old incarnation under an alias key; its
                # frozen prom snapshot must keep contributing.
                alias = f"{url}#retired-{len(self._members)}"
                self._members[alias] = existing
            m = Member(url)
            m.baseline_pending = bool(baseline)
            self._record(m, JOINING, "joined")
            self._members[url] = m
            return m

    def leave(self, base_url: str) -> Optional[Member]:
        """Mark a member LEAVING (out of rotation immediately).  The
        caller (router leave handler / roll driver) is responsible for
        draining it and calling `retire` once its counters are final."""
        url = base_url.rstrip("/")
        with self._lock:
            m = self._members.get(url)
            if m is None:
                return None
            self._record(m, LEAVING, "leave requested")
            return m

    def retire(self, base_url: str) -> None:
        """LEAVING -> LEFT: the member's prom snapshot is now frozen."""
        url = base_url.rstrip("/")
        with self._lock:
            m = self._members.get(url)
            if m is not None and m.state != LEFT:
                self._record(m, LEFT, "retired (counters frozen)")
                if self.affinity is not None:
                    self.affinity.forget_member(url)

    def _record(self, m: Member, state: str, why: str) -> None:
        m.state = state
        m.transitions.append({
            "unix": round(time.time(), 3), "state": state, "why": why,
        })

    # ---- views ----

    def members(self) -> List[Member]:
        with self._lock:
            return list(self._members.values())

    def get(self, base_url: str) -> Optional[Member]:
        with self._lock:
            return self._members.get(base_url.rstrip("/"))

    def routable_members(self) -> List[Member]:
        with self._lock:
            return [m for m in self._members.values() if m.routable]

    def routable_urls(self) -> List[str]:
        return [m.base_url for m in self.routable_members()]

    def summary(self) -> List[dict]:
        with self._lock:
            return [m.summary() for m in self._members.values()]

    # ---- persistence (fleet/store.py) ----

    def export_state(self) -> dict:
        """Durable membership view: every record's state-machine
        position, frozen/last Prometheus snapshot, join baseline, and
        last health block (the per-member brownout rung rides in
        there).  Retired aliases export too - they carry the frozen
        counters that keep fleet deltas monotonic across deploys."""
        with self._lock:
            return {
                url: {
                    "state": m.state,
                    "base_url": m.base_url,
                    "joined_unix": round(m.joined_unix, 3),
                    "prom": dict(m.prom),
                    "prom_baseline": dict(m.prom_baseline),
                    "baseline_pending": m.baseline_pending,
                    "health": m.health if isinstance(m.health, dict)
                    else {},
                    "warm_keys": m.warm_key_count,
                }
                for url, m in self._members.items()
            }

    def restore_state(self, data: dict) -> int:
        """Adopt a predecessor's membership view.  LEFT records (and
        retired aliases) restore FROZEN - their snapshots keep
        aggregating, which is what makes fleet /metrics monotonic
        across a router restart.  Live records merge conservatively:
        unknown urls join as JOINING (the next poll decides
        routability - restoring UP outright could route to a corpse),
        known urls adopt the persisted baseline/prom only where the
        live record has none yet (a fresher poll always wins).
        Malformed entries are skipped.  Returns records adopted."""
        if not isinstance(data, dict):
            return 0
        adopted = 0
        for key, rec in data.items():
            if not isinstance(rec, dict):
                continue
            state = rec.get("state")
            prom = rec.get("prom")
            prom = prom if isinstance(prom, dict) else {}
            baseline = rec.get("prom_baseline")
            baseline = baseline if isinstance(baseline, dict) else {}
            with self._lock:
                m = self._members.get(key)
                if m is None:
                    m = Member(rec.get("base_url") or key)
                    if state in (LEFT, LEAVING):
                        # Frozen history: never polled again.
                        m.state = LEFT
                        m.prom = {
                            k: float(v) for k, v in prom.items()
                            if isinstance(v, (int, float))
                        }
                        m.prom_baseline = {
                            k: float(v) for k, v in baseline.items()
                            if isinstance(v, (int, float))
                        }
                    else:
                        m.state = JOINING
                        m.prom_baseline = {
                            k: float(v) for k, v in baseline.items()
                            if isinstance(v, (int, float))
                        }
                        m.baseline_pending = bool(
                            rec.get("baseline_pending")
                        )
                        if isinstance(rec.get("health"), dict):
                            m.health = rec["health"]
                    self._members[key] = m
                    adopted += 1
                    continue
                # Known url: fill only the gaps a fresh process has.
                if not m.prom_baseline and baseline:
                    m.prom_baseline = {
                        k: float(v) for k, v in baseline.items()
                        if isinstance(v, (int, float))
                    }
                    m.baseline_pending = False
                if not m.prom and prom and m.state == LEFT:
                    m.prom = {
                        k: float(v) for k, v in prom.items()
                        if isinstance(v, (int, float))
                    }
                if not m.health and isinstance(rec.get("health"), dict):
                    m.health = rec["health"]
                adopted += 1
        return adopted

    # ---- the poll ----

    def poll_member(self, m: Member) -> None:
        """One health + metrics poll of one member, applying the state
        machine.  LEFT members are never polled (frozen)."""
        if m.state == LEFT:
            return
        try:
            status, text = self._fetch(
                m.base_url, "/healthz", self.poll_timeout, None
            )
            health = json.loads(text)
        except Exception as e:  # transport/parse = one failure strike
            with self._lock:
                m.consecutive_failures += 1
                m.last_error = f"{type(e).__name__}: {e}"
                m.last_poll_unix = time.time()
                if (m.state in (UP, JOINING)
                        and m.consecutive_failures >= self.fail_threshold):
                    self._record(
                        m, EJECTED,
                        f"{m.consecutive_failures} consecutive "
                        f"transport failures",
                    )
            return
        with self._lock:
            m.consecutive_failures = 0
            m.last_error = None
            m.health = health
            m.last_poll_unix = time.time()
            m.backend = health.get("backend") or m.backend
            ready = (
                status == 200 and health.get("status") == "ok"
                and health.get("ready") is not False
            )
            if m.state in (JOINING, EJECTED) and ready:
                self._record(m, UP, "healthz ready")
            elif m.state == UP and not ready:
                self._record(
                    m, EJECTED,
                    "ready: false "
                    f"(warming={health.get('warming')}, "
                    f"draining={health.get('draining')})",
                )
        # Metrics refresh even for ejected/leaving members: a draining
        # replica's final counters and warm keys are still true, and a
        # recovering one should re-admit with a warm table, not a cold
        # one.
        self.refresh_metrics(m)

    def refresh_metrics(self, m: Member) -> None:
        """Best-effort refresh of one member's JSON metrics (warm keys,
        queue depth) and Prometheus cut (aggregation snapshot)."""
        if m.state == LEFT:
            return
        try:
            _, text = self._fetch(
                m.base_url, "/metrics", self.poll_timeout,
                "application/json",
            )
            snap = json.loads(text)
        except Exception:
            snap = None
        if isinstance(snap, dict):
            warm = (snap.get("program_cache") or {}).get("warm_keys")
            with self._lock:
                try:
                    m.queue_depth = int(snap.get("queue_depth") or 0)
                except (TypeError, ValueError):
                    pass
            if isinstance(warm, dict) and self.affinity is not None:
                n = self.affinity.observe_warm_keys(m.base_url, warm)
                with self._lock:
                    m.warm_key_count = n
        try:
            _, prom_text = self._fetch(
                m.base_url, "/metrics", self.poll_timeout, "text/plain"
            )
            prom = _parse_prometheus_text(prom_text)
        except Exception:
            return
        if prom:
            with self._lock:
                if m.baseline_pending:
                    m.prom_baseline = {
                        k: v for k, v in prom.items()
                        if _is_cumulative(k)
                    }
                    m.baseline_pending = False
                m.prom = prom

    def poll_once(self) -> None:
        for m in self.members():
            self.poll_member(m)

    # ---- aggregation ----

    def aggregate_prom(self, refresh: bool = True) -> Dict[str, float]:
        """Fleet-wide Prometheus cut: sample-wise sum of every member's
        last counters - LIVE members freshly fetched (refresh=True, the
        scrape path), departed/unreachable ones contributing their last
        (frozen) snapshot, mid-flight joiners contributing their growth
        SINCE join (cumulative samples minus the join baseline, clamped
        at zero in case the same URL restarted with reset counters).
        Deltas of the sum across a roll stay monotonic because no
        snapshot is ever dropped."""
        if refresh:
            for m in self.members():
                if m.state != LEFT:
                    self.refresh_metrics(m)
        out: Dict[str, float] = {}
        with self._lock:
            for m in self._members.values():
                for name, value in m.prom.items():
                    base = m.prom_baseline.get(name)
                    if base is not None:
                        value = max(0.0, value - base)
                    out[name] = out.get(name, 0.0) + value
        return out
