"""Router high availability: single-writer lease + active/standby (the
port's copy of wavetpu/fleet/ha.py; the lease file is wavetpu's, so a
wavetpu router and a port router contend for one lease).

N `python -m wavetpu_torch router --control-plane-dir DIR` processes
sharing one store
elect exactly ONE active router through a file-based lease:

 * `lease.json` names the current holder: `{"owner", "epoch",
   "acquired_unix", "renewed_unix", "ttl_s"}`.  A lease whose
   `renewed_unix` is more than `ttl_s` old is EXPIRED - the holder
   stopped renewing (crashed, partitioned, SIGKILLed) and any standby
   may take it.
 * Mutations (acquire / renew / release) happen under `lease.lock`, a
   bare O_CREAT|O_EXCL file - the only primitive the filesystem gives
   us that is atomic on every POSIX target.  A lock older than a few
   seconds is broken (its holder died mid-mutation).
 * `epoch` increments on every ACQUISITION (never on renewal): the
   fencing token.  A deposed active discovers the loss on its next
   renewal (owner/epoch mismatch) and demotes itself; it can never
   renew its way back into a lease someone else took.

`HACoordinator` runs the role loop in a daemon thread:

 * ACTIVE: renew the lease every tick, flush the router's exported
   state to the store every `flush_interval_s`, compact periodically.
   A failed renewal = the lease is lost -> demote to standby
   immediately (fail-safe direction: a false demotion costs one
   takeover gap; a false retention costs split-brain).
 * STANDBY: answer /solve with a retriable 503 (`"standby": true`, so
   the multi-endpoint WavetpuClient rotates instead of backing off),
   poll the lease each tick, and on expiry acquire it, RESTORE the
   persisted state into the router (quota-bucket levels, membership
   freeze/baselines, counters, affinity), and start serving - within
   about one lease TTL of the active's death.

Stdlib-only; imports neither torch nor jax.  Runbook: wavetpu's
docs/fleet.md.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

LEASE_NAME = "lease.json"
LOCK_NAME = "lease.lock"

# A lease.lock older than this is a dead mutator's leftover: break it.
_STALE_LOCK_S = 5.0

ACTIVE = "active"
STANDBY = "standby"


class LeaseManager:
    """The file lease: acquire / renew / release with epoch fencing.

    `clock` is injectable for deterministic tests.  All methods are
    safe to call from any thread of any process sharing the dir."""

    def __init__(self, root: str, owner: str, ttl_s: float = 2.0,
                 clock: Callable[[], float] = time.time,
                 fault_plan=None):
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.owner = owner
        self.ttl_s = float(ttl_s)
        self.path = os.path.join(root, LEASE_NAME)
        self.lock_path = os.path.join(root, LOCK_NAME)
        self._clock = clock
        self.fault_plan = fault_plan
        self.epoch = 0          # the epoch WE hold (0 = not holding)
        self.acquisitions_total = 0
        self.renew_failures_total = 0

    # ---- the on-disk lock (mutation critical section) ----

    def _take_lock(self) -> bool:
        try:
            fd = os.open(self.lock_path,
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            return True
        except FileExistsError:
            try:
                age = self._clock() - os.path.getmtime(self.lock_path)
            except OSError:
                return False  # racing remover; retry next tick
            if age > _STALE_LOCK_S:
                # The locker died mid-mutation: break the lock.  The
                # O_EXCL recreate below races fairly among breakers.
                try:
                    os.unlink(self.lock_path)
                except OSError:
                    pass
                try:
                    fd = os.open(self.lock_path,
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                    os.close(fd)
                    return True
                except OSError:
                    return False
            return False
        except OSError:
            return False

    def _drop_lock(self) -> None:
        try:
            os.unlink(self.lock_path)
        except OSError:
            pass

    # ---- reads ----

    def read(self) -> Optional[dict]:
        """The current lease record, or None (missing/corrupt - corrupt
        reads as absent so a torn lease write can only DELAY an
        acquisition by one tick, never wedge the fleet)."""
        try:
            with open(self.path, encoding="utf-8") as f:
                lease = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(lease, dict):
            return None
        return lease

    def _expired(self, lease: dict) -> bool:
        try:
            renewed = float(lease["renewed_unix"])
            ttl = float(lease.get("ttl_s") or self.ttl_s)
        except (KeyError, TypeError, ValueError):
            return True  # unreadable fields = not a live claim
        return self._clock() - renewed > ttl

    def holder(self) -> Optional[str]:
        lease = self.read()
        if lease is None or self._expired(lease):
            return None
        return lease.get("owner")

    @property
    def held(self) -> bool:
        return self.epoch > 0

    # ---- mutations ----

    def _write(self, lease: dict) -> None:
        tmp = self.path + f".tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(lease, f)
            f.flush()
        os.replace(tmp, self.path)

    def try_acquire(self) -> bool:
        """Take the lease iff it is free, expired, or already ours.
        A NEW acquisition (not a reclaim of our own epoch) bumps the
        epoch - the fencing token every flush rides."""
        if not self._take_lock():
            return False
        try:
            now = self._clock()
            lease = self.read()
            if lease is not None and not self._expired(lease) \
                    and lease.get("owner") != self.owner:
                return False
            if lease is not None and lease.get("owner") == self.owner \
                    and not self._expired(lease) \
                    and int(lease.get("epoch") or 0) == self.epoch \
                    and self.epoch > 0:
                return True  # already ours and live
            try:
                prev_epoch = int((lease or {}).get("epoch") or 0)
            except (TypeError, ValueError):
                prev_epoch = 0
            self.epoch = prev_epoch + 1
            self.acquisitions_total += 1
            self._write({
                "owner": self.owner,
                "epoch": self.epoch,
                "acquired_unix": round(now, 3),
                "renewed_unix": round(now, 3),
                "ttl_s": self.ttl_s,
            })
            return True
        finally:
            self._drop_lock()

    def renew(self) -> bool:
        """Refresh our claim.  False = the lease is no longer ours
        (someone fenced us out, the file vanished, or a
        `store-stale-lease` chaos injection fired) - the caller MUST
        demote; it may try_acquire again next tick."""
        if self.epoch <= 0:
            return False
        if self.fault_plan is not None and self.fault_plan.fire(
                "store-stale-lease") is not None:
            # Chaos: this renewal "observes" a stale/foreign lease, the
            # exact thing a paused-then-resumed active would see.  The
            # holder must demote (and may re-acquire cleanly after).
            self.epoch = 0
            self.renew_failures_total += 1
            return False
        if not self._take_lock():
            # Could not enter the critical section this tick; the lease
            # record is untouched, so our claim stands until TTL.  Only
            # repeated failures (> TTL) cost the lease.
            return True
        try:
            lease = self.read()
            if (
                lease is None
                or lease.get("owner") != self.owner
                or int(lease.get("epoch") or 0) != self.epoch
            ):
                self.epoch = 0
                self.renew_failures_total += 1
                return False
            lease["renewed_unix"] = round(self._clock(), 3)
            self._write(lease)
            return True
        except (OSError, TypeError, ValueError):
            self.epoch = 0
            self.renew_failures_total += 1
            return False
        finally:
            self._drop_lock()

    def release(self) -> None:
        """Orderly handoff: mark our lease expired (renewed_unix 0, a
        time every clock agrees is past TTL) so a standby takes over
        immediately instead of waiting out the TTL.  The record - and
        its epoch - stays on disk: the fencing counter must be
        monotonic across releases, not just crashes."""
        if self.epoch <= 0:
            return
        if not self._take_lock():
            self.epoch = 0
            return
        try:
            lease = self.read()
            if lease is not None and lease.get("owner") == self.owner \
                    and int(lease.get("epoch") or 0) == self.epoch:
                lease["renewed_unix"] = 0.0
                lease["released"] = True
                try:
                    self._write(lease)
                except OSError:
                    pass
        finally:
            self.epoch = 0
            self._drop_lock()


class HACoordinator:
    """The role loop gluing a RouterState to the store + lease.

    `export_state()` / `restore_state(state)` are the router's
    callbacks (RouterState provides them); `on_promote` fires after a
    standby finishes restoring and flips active (tests hook it)."""

    def __init__(self, store, lease: LeaseManager,
                 export_state: Callable[[], dict],
                 restore_state: Callable[[dict], None],
                 flush_interval_s: float = 0.5,
                 compact_every: int = 64,
                 on_promote: Optional[Callable[[], None]] = None):
        self.store = store
        self.lease = lease
        self._export = export_state
        self._restore = restore_state
        self.flush_interval_s = max(0.01, float(flush_interval_s))
        self.compact_every = max(1, int(compact_every))
        self.on_promote = on_promote
        self.role = STANDBY
        self.takeovers_total = 0
        self.flushes_total = 0
        self.demotions_total = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._flushes_since_compact = 0

    # ---- lifecycle ----

    def start(self) -> None:
        """One synchronous election tick first (a lone router boots
        straight to active with its state restored, before it serves a
        single request), then the background loop."""
        self.tick()
        self._thread = threading.Thread(
            target=self._run, name="wavetpu-router-ha", daemon=True
        )
        self._thread.start()

    def stop(self, release: bool = True) -> None:
        """Orderly shutdown: final flush + lease release so a standby
        promotes immediately.  `release=False` simulates a crash
        (tests): the lease must expire on its own."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if release and self.role == ACTIVE:
            try:
                self.flush(compact=True)
            except Exception:
                pass
            self.lease.release()
        with self._lock:
            self.role = STANDBY

    def _run(self) -> None:
        # Tick fast enough that a renewal always lands well inside the
        # TTL and a standby notices expiry within ~half a TTL.
        interval = min(self.flush_interval_s, self.lease.ttl_s / 3.0)
        while not self._stop.wait(interval):
            try:
                self.tick()
            except Exception:
                pass  # the role loop must never die to one bad tick

    # ---- the role machine ----

    def tick(self) -> None:
        if self.role == ACTIVE:
            if not self.lease.renew():
                # Fenced out (or chaos said so): demote NOW.  Serving
                # one extra request as a deposed active is the
                # split-brain direction; a spurious demotion costs one
                # takeover gap.
                with self._lock:
                    self.role = STANDBY
                    self.demotions_total += 1
                return
            self.flush()
            return
        # standby
        if self.lease.try_acquire():
            state = self.store.load()
            if state:
                try:
                    self._restore(state)
                except Exception:
                    pass  # partial restore beats refusing to serve
            with self._lock:
                self.role = ACTIVE
                self.takeovers_total += 1
            if self.on_promote is not None:
                try:
                    self.on_promote()
                except Exception:
                    pass

    def flush(self, compact: bool = False) -> None:
        """Persist the router's current exported state (one WAL record
        per section), compacting every `compact_every` flushes."""
        state = self._export()
        for section, data in state.items():
            self.store.append(section, data)
        with self._lock:
            self.flushes_total += 1
            self._flushes_since_compact += 1
            due = self._flushes_since_compact >= self.compact_every
            if compact or due:
                self._flushes_since_compact = 0
        if compact or due:
            self.store.compact(state)

    # ---- views ----

    def snapshot(self) -> dict:
        lease = self.lease.read() or {}
        with self._lock:
            return {
                "role": self.role,
                "owner": self.lease.owner,
                "epoch": self.lease.epoch,
                "lease_owner": lease.get("owner"),
                "lease_epoch": lease.get("epoch"),
                "lease_ttl_s": self.lease.ttl_s,
                "takeovers_total": self.takeovers_total,
                "demotions_total": self.demotions_total,
                "flushes_total": self.flushes_total,
                "acquisitions_total": self.lease.acquisitions_total,
                "renew_failures_total":
                    self.lease.renew_failures_total,
            }

    def prom_samples(self) -> dict:
        snap = self.snapshot()
        return {
            "wavetpu_fleet_ha_takeovers_total": snap["takeovers_total"],
            "wavetpu_fleet_ha_demotions_total": snap["demotions_total"],
            "wavetpu_fleet_ha_flushes_total": snap["flushes_total"],
            "wavetpu_fleet_ha_renew_failures_total":
                snap["renew_failures_total"],
            "wavetpu_fleet_ha_lease_epoch": snap["epoch"],
            "wavetpu_fleet_ha_active":
                1.0 if snap["role"] == ACTIVE else 0.0,
        }
