"""Router edge result cache: answer repeats with ZERO replica I/O (the
port's copy of wavetpu/fleet/edgecache.py).

The outermost layer of the fleet result tier (wavetpu's docs/fleet.md
"Edge result cache"): the router keyed every /solve by the shared
`wavetpu_torch.progkey.result_key` already (it routes by the same identity),
so a repeat of a cached answer can be served AT the router - no
forward, no replica queue slot, no batch executed (the drill pins the
replica batch counter unchanged across an edge hit).

Entries are stored from real replica responses: a replica that stored
a payload into ITS result cache stamps `X-Wavetpu-Cache: store;fp=H`
(H = a short hash of its environment fingerprint), and the router
adopts the exact response bytes under that fingerprint tag.  A store
carrying a NEW fingerprint flushes every entry of the old one - the
edge must never outlive a fleet upgrade.  Each entry carries a sha256
digest verified on every hit; corruption is a counted miss that falls
through to the replicas, never a wrong answer.

The index rides the control plane (store.py): `export_state()` /
`restore_state()` round-trip the full entry map as the `edge_cache`
section of the ControlPlaneStore WAL, so a router restart - or an HA
standby's promotion - inherits the warm edge, and the first request
after a failover can still be answered without touching a card.

Stdlib-only; imports neither torch nor jax (routers run on
accelerator-less hosts).
"""

from __future__ import annotations

import base64
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

DEFAULT_MAX_BYTES = 32 << 20
DEFAULT_TTL_S = 600.0


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


class EdgeCache:
    """Thread-safe bounded LRU of /solve success payloads at the
    router.  Keys are `progkey.result_key` digests; values are the
    exact replica response bytes + the headers a hit must replay."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 ttl_s: float = DEFAULT_TTL_S,
                 clock=time.time):
        if max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0, got {max_bytes}")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        # key -> {payload, content_type, server_timing, fp, digest,
        #         created}; insertion order is LRU order.
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._bytes = 0
        self._fp: Optional[str] = None  # the fleet fingerprint tag
        self.hits_total = 0
        self.misses_total = 0
        self.stores_total = 0
        self.evicted_total = 0
        self.corrupt_total = 0
        self.fingerprint_flushes_total = 0

    # ---- internals (call under lock) ----

    def _drop(self, key: str) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= len(entry["payload"])

    def _flush_all(self) -> None:
        self._entries.clear()
        self._bytes = 0

    # ---- data path ----

    def get(self, key: str) -> Optional[Tuple[bytes, str,
                                              Optional[str]]]:
        """(payload, content_type, server_timing) for a live verified
        entry, else None (counted miss; TTL-expired, corrupt, and
        fingerprint-flushed entries all land here)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses_total += 1
                return None
            if self._clock() - entry["created"] > self.ttl_s:
                self._drop(key)
                self.evicted_total += 1
                self.misses_total += 1
                return None
            if _digest(entry["payload"]) != entry["digest"]:
                self._drop(key)
                self.corrupt_total += 1
                self.misses_total += 1
                return None
            self._entries.move_to_end(key)
            self.hits_total += 1
            return (entry["payload"], entry["content_type"],
                    entry["server_timing"])

    def put(self, key: str, payload: bytes, content_type: str,
            server_timing: Optional[str], fp: Optional[str]) -> bool:
        """Adopt one replica success payload under fingerprint tag
        `fp`.  A NEW fp flushes every old-fp entry first (the fleet
        upgraded under us); an oversized payload is refused."""
        if len(payload) > self.max_bytes:
            return False
        with self._lock:
            if fp != self._fp:
                if self._entries:
                    self.fingerprint_flushes_total += 1
                self._flush_all()
                self._fp = fp
            self._drop(key)
            self._entries[key] = {
                "payload": payload,
                "content_type": content_type,
                "server_timing": server_timing,
                "fp": fp,
                "digest": _digest(payload),
                "created": self._clock(),
            }
            self._bytes += len(payload)
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                old_key = next(iter(self._entries))
                if old_key == key:
                    break
                self._drop(old_key)
                self.evicted_total += 1
            self.stores_total += 1
            return True

    # ---- control-plane persistence (the `edge_cache` store section) ----

    def export_state(self) -> dict:
        """The WAL-persistable index: payload bytes base64'd (the store
        is JSON), counters included so a promoted standby's /metrics
        stay monotonic."""
        with self._lock:
            return {
                "fp": self._fp,
                "entries": [
                    {
                        "key": k,
                        "payload": base64.b64encode(
                            e["payload"]
                        ).decode("ascii"),
                        "content_type": e["content_type"],
                        "server_timing": e["server_timing"],
                        "fp": e["fp"],
                        "digest": e["digest"],
                        "created": e["created"],
                    }
                    for k, e in self._entries.items()
                ],
                "counters": {
                    "hits_total": self.hits_total,
                    "misses_total": self.misses_total,
                    "stores_total": self.stores_total,
                    "evicted_total": self.evicted_total,
                    "corrupt_total": self.corrupt_total,
                    "fingerprint_flushes_total":
                        self.fingerprint_flushes_total,
                },
            }

    def restore_state(self, state: dict) -> None:
        """Adopt a predecessor's persisted index (router restart or
        standby promotion).  Entries that fail to decode or verify are
        silently skipped - a corrupt WAL record must cost at most its
        own entry; counters max-merge for monotonic /metrics."""
        if not isinstance(state, dict):
            return
        with self._lock:
            fp = state.get("fp")
            self._fp = fp if isinstance(fp, str) or fp is None else None
            self._flush_all()
            for e in state.get("entries") or ():
                if not isinstance(e, dict):
                    continue
                try:
                    key = e["key"]
                    payload = base64.b64decode(e["payload"])
                    if _digest(payload) != e["digest"]:
                        self.corrupt_total += 1
                        continue
                    created = float(e["created"])
                except (KeyError, TypeError, ValueError):
                    continue
                if len(payload) > self.max_bytes:
                    continue
                self._entries[key] = {
                    "payload": payload,
                    "content_type": str(
                        e.get("content_type") or "application/json"
                    ),
                    "server_timing": e.get("server_timing"),
                    "fp": e.get("fp"),
                    "digest": e["digest"],
                    "created": created,
                }
                self._bytes += len(payload)
            while self._bytes > self.max_bytes and self._entries:
                self._drop(next(iter(self._entries)))
            counters = state.get("counters")
            if isinstance(counters, dict):
                for field in ("hits_total", "misses_total",
                              "stores_total", "evicted_total",
                              "corrupt_total",
                              "fingerprint_flushes_total"):
                    try:
                        v = int(counters.get(field) or 0)
                    except (TypeError, ValueError):
                        continue
                    setattr(self, field,
                            max(getattr(self, field), v))

    # ---- observability ----

    def prom_samples(self) -> Dict[str, float]:
        with self._lock:
            return {
                "wavetpu_router_edgecache_hits_total": self.hits_total,
                "wavetpu_router_edgecache_misses_total":
                    self.misses_total,
                "wavetpu_router_edgecache_stores_total":
                    self.stores_total,
                "wavetpu_router_edgecache_evicted_total":
                    self.evicted_total,
                "wavetpu_router_edgecache_corrupt_total":
                    self.corrupt_total,
                "wavetpu_router_edgecache_bytes": self._bytes,
                "wavetpu_router_edgecache_entries":
                    len(self._entries),
            }

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "ttl_s": self.ttl_s,
                "fingerprint": self._fp,
                "hits": self.hits_total,
                "misses": self.misses_total,
                "stores": self.stores_total,
                "evicted": self.evicted_total,
                "corrupt": self.corrupt_total,
                "fingerprint_flushes": self.fingerprint_flushes_total,
            }
