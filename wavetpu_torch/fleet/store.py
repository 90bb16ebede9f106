"""Crash-safe control-plane store for the router tier (the port's copy
of wavetpu/fleet/store.py, byte for byte its file format: either
package's router restarts from the other's directory).

Everything the router knows that is not re-derivable from a poll -
quota-bucket levels, per-member affinity tables, membership
state-machine positions (including LEFT members' frozen Prometheus
snapshots and mid-flight joiners' baselines), last-observed brownout
rungs, and the router's own monotonic counters - lives in one process
today, so a router crash loses it: quotas reopen full (a restart is a
free flood), fleet /metrics deltas go backwards, and N routers behind
an L4 balancer each admit the full per-tenant limit.  This module is
the durable home for that state, shared by every `python -m wavetpu_torch
router --control-plane-dir DIR` pointed at the same directory.

Layout (all under the control-plane dir):

    snapshot.json   the last compacted full state - atomic tmp +
                    `os.replace` write with a whole-payload sha256 in
                    the header, the progcache/checkpoint discipline
    wal.jsonl       append-only JSONL records SINCE the snapshot; each
                    line carries `{"seq", "section", "data", "sha"}`
                    with a per-line sha256 over the canonical record
    lease.json /    single-writer lease + its mutation lock
    lease.lock      (fleet/ha.py owns these; listed for the runbook)

`load()` is snapshot-base + WAL-replay, latest-seq-wins per section.
Corruption anywhere - a flipped byte, a torn tail from a killed
writer, a snapshot that fails its checksum - is a COUNTED recoverable
miss (`corrupt_lines_total` / `corrupt_snapshots_total`), never a
crash: the store degrades to whatever prefix still verifies, exactly
like a progcache miss degrades to a recompile.  `compact()` folds the
WAL into a fresh snapshot and truncates it, bounding replay time.

Stdlib-only; imports neither torch nor jax (this module runs in
router processes on hosts with no accelerator stack).  Contract and
failover runbook: wavetpu's docs/fleet.md "Control plane & router HA".
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict

SNAPSHOT_NAME = "snapshot.json"
WAL_NAME = "wal.jsonl"
SNAPSHOT_MAGIC = "wavetpu-control-plane-v1"


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def _record_sha(seq: int, section: str, data) -> str:
    return hashlib.sha256(
        _canonical({"seq": seq, "section": section, "data": data})
    ).hexdigest()[:16]


class ControlPlaneStore:
    """One router's handle on the shared durable state.

    Thread-safe; every instance keeps its own miss/append counters
    (exposed by the router as `wavetpu_store_*` samples - a corruption
    that recovered silently would make the chaos drills unfalsifiable).
    `fault_plan` is the optional WAVETPU_FAULT router plan
    (run/faults.py `router_plan_from_env`): a `store-corrupt` injection
    truncates the WAL tail just before a load, driving the real
    per-line checksum rejection branch."""

    def __init__(self, root: str, fault_plan=None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.snapshot_path = os.path.join(root, SNAPSHOT_NAME)
        self.wal_path = os.path.join(root, WAL_NAME)
        self.fault_plan = fault_plan
        self._lock = threading.Lock()
        self._seq = 0
        # wavetpu_store_* counter sources (see prom_samples()).
        self.appends_total = 0
        self.compactions_total = 0
        self.loads_total = 0
        self.corrupt_lines_total = 0
        self.corrupt_snapshots_total = 0

    # ---- write path ----

    def append(self, section: str, data: dict) -> int:
        """Append one section's latest state to the WAL (flushed, not
        fsynced - the flusher cadence bounds loss to one interval, the
        per-line checksum bounds a torn tail to one skipped record).
        Returns the record's sequence number."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            rec = {
                "seq": seq,
                "section": section,
                "data": data,
                "sha": _record_sha(seq, section, data),
            }
            with open(self.wal_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
            self.appends_total += 1
        return seq

    def compact(self, state: Dict[str, dict]) -> None:
        """Fold `state` (the full current section map) into a fresh
        snapshot - tmp + os.replace so a crash mid-write leaves the old
        snapshot intact - then truncate the WAL it supersedes."""
        payload = {
            "magic": SNAPSHOT_MAGIC,
            "seq": self._seq,
            "state": state,
            "sha": hashlib.sha256(_canonical(state)).hexdigest(),
        }
        with self._lock:
            tmp = self.snapshot_path + f".tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snapshot_path)
            with open(self.wal_path, "w", encoding="utf-8"):
                pass  # truncate: the snapshot now owns this history
            self.compactions_total += 1

    # ---- read path ----

    def _load_snapshot(self) -> Dict[str, dict]:
        """The checksummed snapshot base, or {} (missing/corrupt - a
        counted miss; the WAL replay may still recover newer state)."""
        try:
            with open(self.snapshot_path, encoding="utf-8") as f:
                payload = json.load(f)
        except FileNotFoundError:
            return {}
        except (OSError, ValueError):
            self.corrupt_snapshots_total += 1
            return {}
        state = payload.get("state")
        if (
            payload.get("magic") != SNAPSHOT_MAGIC
            or not isinstance(state, dict)
            or payload.get("sha")
            != hashlib.sha256(_canonical(state)).hexdigest()
        ):
            self.corrupt_snapshots_total += 1
            return {}
        try:
            self._seq = max(self._seq, int(payload.get("seq") or 0))
        except (TypeError, ValueError):
            pass
        return state

    def load(self) -> Dict[str, dict]:
        """Snapshot base + WAL replay, latest-wins per section.  Every
        line that fails to parse or verify is counted and SKIPPED (a
        torn tail from a killed writer costs its last record, nothing
        else); the store never raises on corruption."""
        if self.fault_plan is not None \
                and self.fault_plan.fire("store-corrupt") is not None:
            self._corrupt_wal_tail()
        with self._lock:
            self.loads_total += 1
            state = self._load_snapshot()
            try:
                with open(self.wal_path, encoding="utf-8") as f:
                    lines = f.readlines()
            except FileNotFoundError:
                lines = []
            except OSError:
                self.corrupt_lines_total += 1
                lines = []
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    seq = int(rec["seq"])
                    section = rec["section"]
                    data = rec["data"]
                    if rec["sha"] != _record_sha(seq, section, data):
                        raise ValueError("checksum mismatch")
                except (ValueError, KeyError, TypeError):
                    self.corrupt_lines_total += 1
                    continue
                state[section] = data
                self._seq = max(self._seq, seq)
            return state

    def _corrupt_wal_tail(self) -> None:
        """The store-corrupt chaos injection: chop bytes off the WAL
        (or, with no WAL yet, flip a snapshot byte) so the NEXT load
        exercises the real rejection branch."""
        try:
            if os.path.getsize(self.wal_path) > 0:
                with open(self.wal_path, "r+b") as f:
                    f.truncate(max(0, os.path.getsize(self.wal_path) - 9))
                return
        except OSError:
            pass
        try:
            size = os.path.getsize(self.snapshot_path)
            with open(self.snapshot_path, "r+b") as f:
                f.seek(size // 2)
                b = f.read(1)
                f.seek(size // 2)
                f.write(bytes([b[0] ^ 0x01]))
        except OSError:
            pass

    # ---- observability ----

    def prom_samples(self) -> Dict[str, float]:
        """The store's Prometheus samples, merged into the router's
        own block (docs/observability.md catalogs each)."""
        return {
            "wavetpu_store_appends_total": self.appends_total,
            "wavetpu_store_compactions_total": self.compactions_total,
            "wavetpu_store_loads_total": self.loads_total,
            "wavetpu_store_corrupt_lines_total": self.corrupt_lines_total,
            "wavetpu_store_corrupt_snapshots_total":
                self.corrupt_snapshots_total,
        }

    def snapshot_counters(self) -> dict:
        return {
            "appends": self.appends_total,
            "compactions": self.compactions_total,
            "loads": self.loads_total,
            "corrupt_lines": self.corrupt_lines_total,
            "corrupt_snapshots": self.corrupt_snapshots_total,
        }
