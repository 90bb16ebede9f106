"""The router's warm-key table: which replica already built what (the
port's copy of wavetpu/fleet/affinity.py).

A kernel build is seconds to minutes; a warm batched solve is
milliseconds.  The single highest-leverage routing decision in a fleet
is landing a request where its program is ALREADY built, so this table maps
affinity keys (`wavetpu_torch.progkey.AFFINITY_FIELDS` - the program identity
minus the server-chosen batch bucket and server-config flags) to the
set of member urls known to hold them, learned from two sources:

 * **Polls**: each membership poll reads the replica's /metrics
   `program_cache.warm_keys` block (memory LRU + disk program-cache entries)
   and REPLACES that member's warm set - the authoritative bootstrap,
   and how a restarted-on-a-shared-cache replica advertises its disk
   inheritance before serving a single request.
 * **Responses**: every proxied /solve response's `Server-Timing:
   warm;desc=` label updates the table at traffic speed - `true`
   (memory hit), `disk` (adopted from the persistent cache), and
   `false` (it JUST paid the compile - warm from now on) all mark the
   serving member a holder; `fallback` marks nothing (no batched
   program was built).

Routing (`choose`): warm holders win; among several holders (or for a
cold key) the least-loaded of TWO RANDOM CHOICES takes it - the
power-of-two-choices bound on max load without a global scan, using
router-side inflight + last-polled queue depth as the load signal.
Decisions are counted (hits / rerouted / cold) and exposed at the
router's /metrics; `hit_rate = hits / (hits + rerouted)` is the
acceptance-drill number (how often a warm-keyed request actually
landed on a holder).

Stdlib-only, thread-safe, imports neither torch nor jax.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Dict, Optional, Sequence, Set

from wavetpu_torch.progkey import warm_keys_to_affinity

# Server-Timing warm labels that prove the serving member now holds the
# compiled program (see ServeEngine batch_info["warm"]).
_HOLDER_LABELS = ("true", "disk", "false")


class AffinityTable:
    """affinity key -> set of member urls holding the program."""

    def __init__(self, rng: Optional[random.Random] = None):
        self._lock = threading.Lock()
        self._holders: Dict[str, Set[str]] = {}
        self._rng = rng if rng is not None else random.Random()
        # Routing decision counters (monotonic).
        self.hits = 0         # warm key routed onto a holder
        self.rerouted = 0     # warm key, but no routable holder
        self.cold = 0         # key nobody holds yet
        self.unkeyed = 0      # body did not parse to an identity

    # ---- learning ----

    def observe_warm_keys(self, member_url: str, warm_keys: dict) -> int:
        """Poll-driven REPLACE of one member's warm set from its
        /metrics warm_keys block; returns how many keys it holds."""
        member_url = member_url.rstrip("/")
        keys = warm_keys_to_affinity(warm_keys)
        with self._lock:
            for holders in self._holders.values():
                holders.discard(member_url)
            for ak in keys:
                self._holders.setdefault(ak, set()).add(member_url)
            self._gc()
        return len(keys)

    def observe_response(self, member_url: str, affinity_key: str,
                         warm_label: Optional[str]) -> None:
        """Response-driven ADD: the member served (or just compiled)
        this key, so it holds the program now."""
        if not affinity_key or warm_label not in _HOLDER_LABELS:
            return
        with self._lock:
            self._holders.setdefault(
                affinity_key, set()
            ).add(member_url.rstrip("/"))

    def forget_member(self, member_url: str) -> None:
        member_url = member_url.rstrip("/")
        with self._lock:
            for holders in self._holders.values():
                holders.discard(member_url)
            self._gc()

    def _gc(self) -> None:
        # under self._lock
        for ak in [k for k, v in self._holders.items() if not v]:
            del self._holders[ak]

    # ---- views ----

    def holders(self, affinity_key: str) -> Set[str]:
        with self._lock:
            return set(self._holders.get(affinity_key, ()))

    def known_keys(self) -> int:
        with self._lock:
            return len(self._holders)

    # ---- persistence (fleet/store.py) ----

    def export_state(self) -> dict:
        """Durable view: the holder table plus the decision counters
        (restored so affinity hit rates stay monotonic across a router
        restart/failover)."""
        with self._lock:
            return {
                "holders": {
                    ak: sorted(urls)
                    for ak, urls in self._holders.items()
                },
                "hits": self.hits,
                "rerouted": self.rerouted,
                "cold": self.cold,
                "unkeyed": self.unkeyed,
            }

    def restore_state(self, data: dict) -> int:
        """UNION-merge persisted holders into the live table (the
        successor may already have fresher poll data - never discard
        it) and max-merge the counters.  Returns keys adopted."""
        if not isinstance(data, dict):
            return 0
        holders = data.get("holders")
        adopted = 0
        with self._lock:
            if isinstance(holders, dict):
                for ak, urls in holders.items():
                    if not isinstance(urls, (list, tuple)):
                        continue
                    self._holders.setdefault(ak, set()).update(
                        str(u).rstrip("/") for u in urls
                    )
                    adopted += 1
            for field in ("hits", "rerouted", "cold", "unkeyed"):
                try:
                    v = int(data.get(field) or 0)
                except (TypeError, ValueError):
                    continue
                setattr(self, field, max(getattr(self, field), v))
        return adopted

    def stats(self) -> dict:
        with self._lock:
            routed = self.hits + self.rerouted
            return {
                "known_keys": len(self._holders),
                "hits": self.hits,
                "rerouted": self.rerouted,
                "cold": self.cold,
                "unkeyed": self.unkeyed,
                "hit_rate": (
                    round(self.hits / routed, 4) if routed else None
                ),
            }

    # ---- routing ----

    def _load(self, url: str, load: Callable[[str], float]) -> float:
        try:
            return float(load(url))
        except Exception:
            return 0.0

    def _p2c(self, candidates: Sequence[str],
             load: Callable[[str], float]) -> str:
        """Least-loaded of two random choices (the whole list when it
        is that short)."""
        if len(candidates) == 1:
            return candidates[0]
        pair = self._rng.sample(list(candidates), 2)
        return min(pair, key=lambda u: self._load(u, load))

    def choose(self, affinity_key: Optional[str],
               candidates: Sequence[str],
               load: Callable[[str], float]) -> str:
        """Pick the member for one request.  `candidates` is the
        routable-url list (non-empty - the router 503s before calling
        with an empty rotation); `load(url)` returns the comparable
        load figure (inflight + queue depth).  Counts the decision."""
        candidates = [c.rstrip("/") for c in candidates]
        if not candidates:
            raise ValueError("choose() needs at least one candidate")
        if affinity_key is None:
            with self._lock:
                self.unkeyed += 1
            return self._p2c(candidates, load)
        with self._lock:
            holders = self._holders.get(affinity_key, set())
            live_holders = [c for c in candidates if c in holders]
            if live_holders:
                self.hits += 1
            elif holders:
                self.rerouted += 1
            else:
                self.cold += 1
        if live_holders:
            return self._p2c(live_holders, load)
        return self._p2c(candidates, load)


def warm_label_from_server_timing(header: Optional[str]) -> Optional[str]:
    """Extract the `warm;desc=LABEL` entry from a Server-Timing header
    (None when absent/unparseable - e.g. --no-server-timing replicas,
    whose affinity then learns from polls alone)."""
    if not header:
        return None
    for part in header.split(","):
        name, _, params = part.strip().partition(";")
        if name.strip() != "warm":
            continue
        for p in params.split(";"):
            k, _, v = p.strip().partition("=")
            if k == "desc":
                return v.strip() or None
    return None
