"""Content-addressed result cache: the fleet's memory for answers (the
port's copy of wavetpu/serve/resultcache.py).

Solves are deterministic - the same `RequestIdentity` (plus the
answer-shaping phase/steps/c2_field fields) yields a bitwise-identical
final state - yet until this tier existed every duplicate request
recomputed from scratch on a chip.  This module is the replica-side
half of the fleet result tier (docs/serving.md "Result cache"): a
bounded in-memory LRU keyed by `progkey.result_key` (the SAME
derivation wavetpu's router edge cache uses, so the two tiers hash
a body identically) storing the EXACT serialized `/solve` success
payload, its Server-Timing attribution, and a sha256 payload digest.

Contract:

 * Hits are BYTE-IDENTICAL to the fresh solve whose answer was stored:
   the cache keeps serialized bytes, never a re-encodable object, so a
   dict-ordering or float-formatting drift can never produce a
   response that differs from what a cold client saw.
 * Bounded by bytes (LRU) and by TTL; every entry records the
   environment fingerprint it was computed under
   (serve/progcache.py `env_fingerprint`) and a fingerprint drift is a
   counted miss - a torch, CUDA or kernel-source change must never
   replay a stale answer.
 * Integrity over trust: every `get` re-verifies the stored digest.
   Corruption (real, or the `WAVETPU_FAULT=serve-resultcache-corrupt`
   chaos injection) is a COUNTED miss that falls through to a clean
   recompute - never a wrong answer, and never a circuit-breaker event
   (the breaker reasons about compile/execute health; a cache losing
   an entry says nothing about the program).
 * Eligibility is the caller's job (serve/api.py): deterministic full
   solves only, never resume-token or recorded-fallback responses, and
   `Cache-Control: no-cache` bypasses (counted).

Stdlib + obs.registry only; never imports torch (the environment
fingerprint is computed once by build_server and passed IN, so unit
tests and torch-less tooling can construct the cache directly).
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

# Counted outcomes on the events counter - one label per branch so a
# chaos drill can pin "corruption fired AND was counted" exactly.
EVENTS = ("hit", "miss", "store", "evict_lru", "evict_ttl",
          "fingerprint_mismatch", "corrupt", "bypass")

DEFAULT_MAX_BYTES = 64 << 20
DEFAULT_TTL_S = 600.0


def payload_digest(payload: bytes) -> str:
    """The stored entry's integrity digest (sha256 hex over the exact
    response bytes - which embed the final-state error digest the
    report carries, so this is also the answer's content address)."""
    return hashlib.sha256(payload).hexdigest()


class _Entry:
    __slots__ = ("payload", "server_timing", "digest", "fingerprint",
                 "created")

    def __init__(self, payload: bytes, server_timing: Optional[str],
                 fingerprint: Optional[dict], created: float):
        self.payload = payload
        self.server_timing = server_timing
        self.digest = payload_digest(payload)
        self.fingerprint = fingerprint
        self.created = created

    @property
    def size(self) -> int:
        return len(self.payload)


class ResultCache:
    """Thread-safe bounded LRU of serialized /solve success payloads.

    `fingerprint` is the environment identity entries are valid under
    (None = unpinned, unit-test mode); `fault_plan` is the server's
    shared WAVETPU_FAULT plan - the two `resultcache-*` chaos kinds
    fire here, at the exact seam real corruption would land."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 ttl_s: float = DEFAULT_TTL_S,
                 fingerprint: Optional[dict] = None,
                 registry=None, fault_plan=None,
                 clock=time.monotonic):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self.fingerprint = fingerprint
        self.fault_plan = fault_plan
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        self._events: Dict[str, int] = {e: 0 for e in EVENTS}
        self._counter = None
        self._bytes_gauge = None
        self._entries_gauge = None
        if registry is not None:
            self._counter = registry.counter(
                "wavetpu_serve_resultcache_events_total",
                "result-cache outcomes (hit/miss/store/evictions/"
                "rejections) on the replica tier",
                ("event",),
            )
            self._bytes_gauge = registry.gauge(
                "wavetpu_serve_resultcache_bytes",
                "bytes of serialized payloads resident in the result "
                "cache",
            )
            self._entries_gauge = registry.gauge(
                "wavetpu_serve_resultcache_entries",
                "entries resident in the result cache",
            )

    # ---- bookkeeping ----

    def _count(self, event: str) -> None:
        self._events[event] += 1
        if self._counter is not None:
            self._counter.inc(event=event)

    def _set_gauges(self) -> None:
        if self._bytes_gauge is not None:
            self._bytes_gauge.set(float(self._bytes))
            self._entries_gauge.set(float(len(self._entries)))

    def _drop(self, key: str) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= entry.size

    # ---- data path ----

    def get(self, key: str, **fault_ctx) -> Optional[
        Tuple[bytes, Optional[str]]
    ]:
        """The stored (payload_bytes, server_timing) for `key`, or None
        (every non-hit branch is a counted miss variant).  `fault_ctx`
        is the program-identity selector context for the chaos plan."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._count("miss")
                return None
            if self.fault_plan is not None and entry is not None \
                    and self.fault_plan.fire(
                        "resultcache-corrupt", **fault_ctx
                    ) is not None:
                # Chaos: flip one payload byte IN PLACE so the digest
                # check below - the real rejection branch - fires.
                b = bytearray(entry.payload)
                b[len(b) // 2] ^= 0x01
                entry.payload = bytes(b)
            expected_fp = self.fingerprint
            if self.fault_plan is not None and self.fault_plan.fire(
                    "resultcache-stale-fingerprint", **fault_ctx
            ) is not None:
                # Chaos: this lookup "observes" an environment drift -
                # exactly what a toolkit upgrade under a warm cache
                # would look like.
                expected_fp = {"poisoned": True}
            if payload_digest(entry.payload) != entry.digest:
                self._drop(key)
                self._count("corrupt")
                self._count("miss")
                self._set_gauges()
                return None
            if entry.fingerprint != expected_fp:
                self._drop(key)
                self._count("fingerprint_mismatch")
                self._count("miss")
                self._set_gauges()
                return None
            if self._clock() - entry.created > self.ttl_s:
                self._drop(key)
                self._count("evict_ttl")
                self._count("miss")
                self._set_gauges()
                return None
            self._entries.move_to_end(key)
            self._count("hit")
            return entry.payload, entry.server_timing

    def put(self, key: str, payload: bytes,
            server_timing: Optional[str] = None) -> bool:
        """Store one success payload (exact bytes).  Returns False when
        the payload alone exceeds the byte bound (never evict the whole
        cache for one oversized answer)."""
        if len(payload) > self.max_bytes:
            return False
        with self._lock:
            self._drop(key)
            entry = _Entry(payload, server_timing, self.fingerprint,
                           self._clock())
            self._entries[key] = entry
            self._bytes += entry.size
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                old_key = next(iter(self._entries))
                if old_key == key:
                    break
                self._drop(old_key)
                self._count("evict_lru")
            self._count("store")
            self._set_gauges()
            return True

    def note_bypass(self) -> None:
        """Count a `Cache-Control: no-cache` bypass (the contract says
        the client CAN opt out; the metrics must show it happening)."""
        with self._lock:
            self._count("bypass")

    # ---- views ----

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "events": dict(self._events),
            }
