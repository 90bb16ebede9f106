"""The port's control plane and router HA on the CPU (wavetpu_torch/
fleet/store.py, fleet/ha.py, the router's --control-plane-dir wiring and
the multi-endpoint WavetpuClient), class by class after wavetpu's
tests/test_ha.py:

 * the store's WAL/snapshot crash discipline - torn tails and corrupt
   snapshots are COUNTED recoverable misses, never crashes;
 * the file lease's epoch fencing - a deposed active can never renew
   its way back, and the epoch stays monotonic across orderly releases;
 * quota-bucket persistence - a restarted router resumes enforcement
   (downtime refilled, never reopened-full);
 * the client's endpoint rotation on transport failure / standby-503;
 * the router-tier WAVETPU_FAULT grammar (router-crash / store-corrupt
   / store-stale-lease) and its isolation from the run-side hook;
 * /metrics monotonicity across a ROUTER restart (frozen LEFT members
   included) - the bracketing-deltas pin;
 * two routers sharing a store admit within bounded slack fleet-wide
   (and the ~2x over-admission WITHOUT the store, pinned both ways);
 * the failover drill: active killed mid-flight with a chunked-march
   resume token outstanding -> the standby promotes within one lease
   TTL, the multi-endpoint client rotates with ZERO visible errors,
   the token completes the march, and quota levels survive the swap.

Beside those, the shared files: each package's store reads the other's
snapshot and WAL, and each package's router restarts from the other's
control-plane directory (counters monotonic, frozen members and quota
levels restored, the lease's epoch carried on).

Scripted members throughout - stdlib only, no sockets beyond loopback.
"""

import json
import os
import threading
import time

import pytest

from wavetpu.fleet import router as jrouter
from wavetpu.fleet import store as jstore
from wavetpu_torch.client import WavetpuClient
from wavetpu_torch.fleet import ha as fleet_ha
from wavetpu_torch.fleet import quota
from wavetpu_torch.fleet.membership import LEFT, UP
from wavetpu_torch.fleet import router as trouter
from wavetpu_torch.fleet.router import build_router
from wavetpu_torch.fleet.store import ControlPlaneStore
from wavetpu_torch.loadgen.runner import parse_prometheus_text
from wavetpu_torch.run import faults

from tests.test_torch_fleet import _ScriptedMember, _get, _post


# ---- the crash-safe store ----


class TestControlPlaneStore:
    def test_wal_replay_latest_wins_per_section(self, tmp_path):
        s = ControlPlaneStore(str(tmp_path))
        s.append("quota", {"v": 1})
        s.append("membership", {"m": "a"})
        s.append("quota", {"v": 2})
        fresh = ControlPlaneStore(str(tmp_path))
        state = fresh.load()
        assert state == {"quota": {"v": 2}, "membership": {"m": "a"}}
        assert fresh.loads_total == 1
        assert fresh.corrupt_lines_total == 0

    def test_compact_truncates_wal_and_survives_reload(self, tmp_path):
        s = ControlPlaneStore(str(tmp_path))
        s.append("quota", {"v": 1})
        s.compact({"quota": {"v": 1}})
        assert os.path.getsize(s.wal_path) == 0
        s.append("quota", {"v": 2})
        fresh = ControlPlaneStore(str(tmp_path))
        assert fresh.load() == {"quota": {"v": 2}}
        # seq continues past the snapshot: appends after a reload can
        # never collide with pre-compaction history
        assert fresh.append("quota", {"v": 3}) > 2

    def test_torn_wal_tail_is_counted_skip_not_crash(self, tmp_path):
        s = ControlPlaneStore(str(tmp_path))
        s.append("a", {"v": 1})
        s.append("b", {"v": 2})
        s.append("a", {"v": 3})
        # a killed writer tears the last record mid-line
        with open(s.wal_path, "r+b") as f:
            f.truncate(os.path.getsize(s.wal_path) - 7)
        fresh = ControlPlaneStore(str(tmp_path))
        state = fresh.load()
        assert state == {"a": {"v": 1}, "b": {"v": 2}}
        assert fresh.corrupt_lines_total == 1

    def test_corrupt_snapshot_counted_wal_still_replays(self, tmp_path):
        s = ControlPlaneStore(str(tmp_path))
        s.compact({"a": {"v": 1}})
        s.append("b", {"v": 2})
        with open(s.snapshot_path, "r+b") as f:
            size = os.path.getsize(s.snapshot_path)
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0x01]))
        fresh = ControlPlaneStore(str(tmp_path))
        state = fresh.load()
        assert state == {"b": {"v": 2}}  # degraded to the WAL prefix
        assert fresh.corrupt_snapshots_total == 1

    def test_store_corrupt_fault_drives_real_rejection(self, tmp_path):
        plan = faults.parse_router_spec("store-corrupt:count=1")
        s = ControlPlaneStore(str(tmp_path), fault_plan=plan)
        s.append("a", {"v": 1})
        s.append("a", {"v": 2})
        state = s.load()  # the injection chops the tail first
        assert state == {"a": {"v": 1}}
        assert s.corrupt_lines_total == 1
        assert plan.snapshot()[0]["fired"] == 1
        # budget spent: the next load is clean
        assert s.load() == {"a": {"v": 1}}

    def test_prom_samples_cover_all_five_counters(self, tmp_path):
        s = ControlPlaneStore(str(tmp_path))
        assert sorted(s.prom_samples()) == [
            "wavetpu_store_appends_total",
            "wavetpu_store_compactions_total",
            "wavetpu_store_corrupt_lines_total",
            "wavetpu_store_corrupt_snapshots_total",
            "wavetpu_store_loads_total",
        ]


# ---- the lease ----


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class TestLease:
    def test_epoch_fences_a_deposed_active(self, tmp_path):
        clk = _Clock()
        l1 = fleet_ha.LeaseManager(str(tmp_path), "r1", ttl_s=2.0,
                                   clock=clk)
        l2 = fleet_ha.LeaseManager(str(tmp_path), "r2", ttl_s=2.0,
                                   clock=clk)
        assert l1.try_acquire() and l1.epoch == 1
        assert not l2.try_acquire()      # live and not ours
        assert l1.renew()
        clk.t += 5.0                     # r1 stops renewing (crashed)
        assert l2.try_acquire() and l2.epoch == 2
        # the resumed r1 discovers the loss on its next renewal and can
        # NEVER renew its way back in
        assert not l1.renew()
        assert l1.epoch == 0
        clk.t += 5.0
        assert l1.try_acquire() and l1.epoch == 3

    def test_release_hands_off_immediately_epoch_monotonic(
        self, tmp_path
    ):
        clk = _Clock()
        l1 = fleet_ha.LeaseManager(str(tmp_path), "r1", clock=clk)
        l2 = fleet_ha.LeaseManager(str(tmp_path), "r2", clock=clk)
        assert l1.try_acquire() and l1.epoch == 1
        l1.release()
        assert l1.epoch == 0
        # NO clock advance: the release itself freed the lease, and the
        # epoch kept counting (fencing survives orderly handoffs)
        assert l2.try_acquire() and l2.epoch == 2

    def test_corrupt_lease_file_reads_as_absent(self, tmp_path):
        clk = _Clock()
        l1 = fleet_ha.LeaseManager(str(tmp_path), "r1", clock=clk)
        assert l1.try_acquire()
        with open(l1.path, "w", encoding="utf-8") as f:
            f.write("{torn")
        l2 = fleet_ha.LeaseManager(str(tmp_path), "r2", clock=clk)
        assert l2.holder() is None
        assert l2.try_acquire()          # a torn write only delays

    def test_stale_lease_fault_forces_demotion_path(self, tmp_path):
        plan = faults.parse_router_spec("store-stale-lease:count=1")
        clk = _Clock()
        lease = fleet_ha.LeaseManager(str(tmp_path), "r1", clock=clk,
                                      fault_plan=plan)
        assert lease.try_acquire()
        assert not lease.renew()         # chaos: observed stale
        assert lease.epoch == 0
        assert lease.renew_failures_total == 1
        clk.t += 5.0
        assert lease.try_acquire()       # clean re-election after


# ---- quota persistence ----


class TestQuotaPersistence:
    def test_bucket_restore_refills_for_downtime_only(self):
        b = quota.TokenBucket(rate=10.0, burst=10.0)
        for _ in range(8):
            assert b.try_take(1.0)[0]
        exported = b.export_state()
        # pretend the router was down for 0.5s: 5 tokens refill, the
        # other 3 stay SPENT
        exported = dict(exported, unix=exported["unix"] - 0.5)
        restored = quota.TokenBucket.restore(exported)
        assert 6.5 <= restored.tokens() <= 7.6
        # a long outage refills to burst, never past it
        stale = dict(exported, unix=exported["unix"] - 3600.0)
        assert quota.TokenBucket.restore(stale).tokens() == 10.0

    def test_manager_restore_skips_malformed_per_bucket(self):
        qm = quota.QuotaManager(default_rps=5.0)
        adopted = qm.restore_state({
            "rps": {
                "good": {"rate": 5.0, "burst": 5.0, "tokens": 1.0,
                         "unix": time.time()},
                "bad": {"rate": "junk"},
            },
            "rejected_per_tenant": {"good": 3, "junk": "x"},
        })
        assert adopted == 1
        assert 0.9 <= qm.levels()["good"]["rps_tokens"] <= 1.5
        assert qm.rejected_per_tenant == {"good": 3}

    def test_roundtrip_preserves_levels(self):
        qm = quota.QuotaManager()
        cfg = quota.TenantConfig(tenant="t", rps=4.0, burst=4.0)
        assert qm.admit(cfg, 0.0)[0]
        assert qm.admit(cfg, 0.0)[0]
        qm2 = quota.QuotaManager()
        qm2.restore_state(qm.export_state())
        assert qm2.levels()["t"]["rps_tokens"] <= 2.5


# ---- the multi-endpoint client ----


class TestClientMultiEndpoint:
    def _standby(self):
        m = _ScriptedMember()
        m.solve_script = [(503, {
            "status": "error",
            "error": "standby router (not the lease holder)",
            "retriable": True, "standby": True,
        }, {"Retry-After": "1"})] * 50
        return m

    def test_rotates_past_dead_and_standby_to_active(self):
        import socket

        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_url = f"http://127.0.0.1:{dead.getsockname()[1]}"
        dead.close()  # nothing listens here now
        standby, live = self._standby(), _ScriptedMember()
        try:
            c = WavetpuClient(
                [dead_url, standby.url, live.url], retries=4,
                sleep=lambda s: None,
            )
            out = c.solve({"N": 8, "timesteps": 4})
            assert out.ok and out.attempts == 3
            assert c.endpoint_failovers == 2
            assert c.base_url == live.url
            # the cursor is sticky: the next request goes straight to
            # the live endpoint, no rediscovery
            assert c.solve({"N": 8, "timesteps": 4}).attempts == 1
            assert c.endpoint_failovers == 2
        finally:
            standby.close()
            live.close()

    def test_retry_budget_and_request_id_semantics_unchanged(self):
        standby, live = self._standby(), _ScriptedMember()
        try:
            c = WavetpuClient([standby.url, live.url], retries=3,
                              sleep=lambda s: None)
            out = c.solve({"N": 8, "timesteps": 4}, request_id="rid-1")
            assert out.ok and out.request_id == "rid-1"
            # every attempt carried the SAME id and traceparent
            seen = standby.seen_headers + live.seen_headers
            assert {h.get("X-Request-Id") for h in seen} == {"rid-1"}
            assert len({h.get("traceparent") for h in seen}) == 1
        finally:
            standby.close()
            live.close()

    def test_single_endpoint_never_rotates(self):
        import socket

        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        url = f"http://127.0.0.1:{dead.getsockname()[1]}"
        dead.close()
        c = WavetpuClient(url, retries=1, sleep=lambda s: None)
        out = c.solve({"N": 8})
        assert out.status == 0
        assert c.endpoint_failovers == 0

    def test_empty_endpoint_list_rejected(self):
        with pytest.raises(ValueError):
            WavetpuClient([])


# ---- router-tier fault grammar ----


class TestRouterFaultSpecs:
    def test_parse_kinds_and_budgets(self):
        plan = faults.parse_router_spec(
            "router-crash:after=2,count=1;store-corrupt"
        )
        snaps = plan.snapshot()
        assert [s["kind"] for s in snaps] == [
            "router-crash", "store-corrupt"
        ]
        assert snaps[0]["after"] == 2 and snaps[0]["remaining"] == 1
        # after= skips the first K eligible events
        assert plan.fire("router-crash") is None
        assert plan.fire("router-crash") is None
        assert plan.fire("router-crash") is not None
        assert plan.fire("router-crash") is None  # count budget spent

    def test_unknown_param_and_kind_rejected(self):
        with pytest.raises(ValueError):
            faults.parse_router_spec("router-crash:seconds=3")
        with pytest.raises(ValueError):
            faults.parse_router_spec("router-explode")

    def test_plan_from_env_ignores_run_and_serve_specs(self):
        env = {"WAVETPU_FAULT": "nan:3;serve-crash:count=1"}
        assert faults.router_plan_from_env(env) is None
        env = {"WAVETPU_FAULT": "nan:3;store-corrupt:count=2"}
        plan = faults.router_plan_from_env(env)
        assert [s["kind"] for s in plan.snapshot()] == ["store-corrupt"]

    def test_router_wires_env_plan_and_exposes_firings(
        self, tmp_path, monkeypatch
    ):
        """build_router adopts the WAVETPU_FAULT router plan and
        renders per-kind firing counts - `after=` keeps the SIGKILL
        seam armed-but-unfired here (firing it would kill pytest; the
        nightly HA smoke fires it for real in a subprocess router)."""
        monkeypatch.setenv("WAVETPU_FAULT",
                           "router-crash:after=9999;store-corrupt")
        m = _ScriptedMember()
        h, s, b = _start([m.url],
                         control_plane_dir=str(tmp_path / "cp"))
        try:
            assert s.fault_plan is not None
            assert s.store.fault_plan is s.fault_plan  # ONE budget
            code, _, _ = _post(b, "/solve", {"N": 8, "timesteps": 4})
            assert code == 200  # after= swallowed the eligible event
            samples = _scrape(b)
            assert samples[
                'wavetpu_router_fault_injections_total'
                '{kind="router-crash"}'
            ] == 0.0
            # store-corrupt fired on the boot load (count unlimited)
            assert samples[
                'wavetpu_router_fault_injections_total'
                '{kind="store-corrupt"}'
            ] >= 1.0
        finally:
            _stop(h, s)
            m.close()

    def test_run_hook_ignores_router_specs(self):
        # a router chaos env leaking into `wavetpu run` must not crash
        env = {"WAVETPU_FAULT":
               "router-crash:after=1;store-stale-lease"}
        assert faults.hook_from_env(env) is None
        env = {"WAVETPU_FAULT": "store-corrupt;nan:3"}
        hook = faults.hook_from_env(env)
        assert hook is not None  # the run-side half still parses


# ---- router restart: state + /metrics monotonicity (satellite) ----


def _start(member_urls, build=build_router, **kw):
    kw.setdefault("poll_interval_s", 60.0)
    httpd, state = build(member_urls, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, state, release=True):
    if state.ha is not None:
        state.ha.stop(release=release)
    state.stop_poller()
    httpd.shutdown()
    httpd.server_close()


def _scrape(base):
    _, text = _get(base, "/metrics", accept="text/plain")
    return parse_prometheus_text(text)


class TestRouterRestartResumesState:
    BODY = {"N": 8, "timesteps": 4}

    def test_restart_restores_counters_quota_and_frozen_members(
        self, tmp_path
    ):
        """The bracketing-deltas pin: scrape r1, restart into r2 over
        the same --control-plane-dir, scrape r2 - every counter sample
        present in both cuts must be monotonic, INCLUDING a LEFT
        member's frozen fleet counters (the member is off the network
        and absent from r2's --member list; only the store remembers
        it)."""
        cp = str(tmp_path / "cp")
        gone = _ScriptedMember(prom="wavetpu_y_total 5\n")
        stays = _ScriptedMember(prom="wavetpu_y_total 2\n")
        keys = {"k": quota.TenantConfig(tenant="t", rps=0.5,
                                        burst=6.0)}
        h1, s1, b1 = _start(
            [gone.url, stays.url], control_plane_dir=cp,
            api_keys=keys, store_flush_interval_s=0.05,
        )
        try:
            assert s1.role == fleet_ha.ACTIVE  # lone router boots active
            for _ in range(3):
                code, _, _ = _post(b1, "/solve", self.BODY,
                                   headers={"X-Api-Key": "k"})
                assert code == 200
            # retire `gone` (a completed roll): counters freeze
            s1.table.leave(gone.url)
            s1.table.retire(gone.url)
            gone.close()
            gone = None
            before = _scrape(b1)
            assert before["wavetpu_y_total"] == 7.0
            assert before["wavetpu_router_requests_total"] == 3.0
            levels_before = s1.quotas.levels()["t"]["rps_tokens"]
            assert levels_before <= 3.5    # 6 - 3 spent (+tiny refill)
        finally:
            _stop(h1, s1)
            if gone is not None:
                gone.close()
        # r2: same dir, but `gone` is NOT in the member list - only the
        # restored membership section can carry its frozen 5.0
        h2, s2, b2 = _start(
            [stays.url], control_plane_dir=cp, api_keys=keys,
            store_flush_interval_s=0.05,
        )
        try:
            assert s2.role == fleet_ha.ACTIVE
            after = _scrape(b2)
            for name, v in before.items():
                # wavetpu_store_*/wavetpu_fleet_ha_* describe THIS
                # process's store/lease activity (like a process start
                # time) - they are the one family that legitimately
                # resets with the process.
                if name.startswith(("wavetpu_store_",
                                    "wavetpu_fleet_ha_")):
                    continue
                if name.endswith("_total") and name in after:
                    assert after[name] >= v, (
                        f"{name} went backwards across the restart: "
                        f"{v} -> {after[name]}"
                    )
            assert after["wavetpu_y_total"] >= 7.0
            assert after["wavetpu_router_requests_total"] >= 3.0
            # the frozen member is back in the table, frozen
            left = [
                row for row in s2.snapshot()["members"]
                if row["state"] == LEFT
            ]
            assert left, "restored LEFT member missing from the table"
            up = [
                row for row in s2.snapshot()["members"]
                if row["state"] == UP
            ]
            assert [row["url"] for row in up] == [stays.url]
            # quota enforcement RESUMED: the bucket is not full again
            levels_after = s2.quotas.levels()["t"]["rps_tokens"]
            assert levels_after <= levels_before + 1.5
            # and the store's own counters are exposed
            assert after["wavetpu_store_loads_total"] >= 1.0
            assert after["wavetpu_fleet_ha_active"] == 1.0
        finally:
            _stop(h2, s2)
            stays.close()


# ---- two-router coordination (satellite: bounded fleet admission) ----


class TestTwoRouterCoordination:
    BODY = {"N": 8, "timesteps": 4}
    LIMIT = 20.0  # burst: the configured per-tenant admission budget

    def _keys(self):
        return {"k": quota.TenantConfig(tenant="t", rps=self.RPS,
                                        burst=self.LIMIT)}

    RPS = 2.0  # the bucket's refill rate

    def _flood(self, bases, n=60):
        """n requests round-robined across `bases` from 8 threads;
        returns (admitted_200s, standby_503s, the flood's wall s)."""
        counts = {"ok": 0, "standby": 0}
        lock = threading.Lock()
        nxt = {"i": 0}

        def worker():
            while True:
                with lock:
                    i = nxt["i"]
                    if i >= n:
                        return
                    nxt["i"] = i + 1
                code, payload, _ = _post(
                    bases[i % len(bases)], "/solve", self.BODY,
                    headers={"X-Api-Key": "k"},
                )
                with lock:
                    if code == 200:
                        counts["ok"] += 1
                    elif code == 503 and payload.get("standby"):
                        counts["standby"] += 1

        threads = [threading.Thread(target=worker) for _ in range(8)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        return counts["ok"], counts["standby"], time.monotonic() - t0

    def test_shared_store_bounds_fleet_admission(self, tmp_path):
        """Two routers over ONE control-plane dir: the single-writer
        lease means only the active admits, so the fleet-wide admitted
        count stays within limit + refill slack - not N x limit."""
        cp = str(tmp_path / "cp")
        m = _ScriptedMember()
        ha, sa, ba = _start([m.url], control_plane_dir=cp,
                            api_keys=self._keys(), lease_ttl_s=5.0)
        hb, sb, bb = _start([m.url], control_plane_dir=cp,
                            api_keys=self._keys(), lease_ttl_s=5.0)
        try:
            assert sa.role == fleet_ha.ACTIVE
            assert sb.role == fleet_ha.STANDBY
            ok, standby, wall = self._flood([ba, bb])
            # the burst plus what the bucket refilled while the flood
            # ran (a slow host runs a longer flood, never a looser one)
            bound = self.LIMIT + self.RPS * wall + 1
            assert ok <= bound, (
                f"fleet admitted {ok} > the configured {self.LIMIT} + "
                f"{self.RPS}/s over {wall:.2f} s"
            )
            assert standby > 0  # B refused retriably, not silently
            assert sb.snapshot()["standby_rejected_total"] == standby
            # the standby's /healthz tells balancers not to route there
            _, text = _get(bb, "/healthz")
            health = json.loads(text)
            assert health["role"] == "standby"
            assert health["ready"] is False
            assert health["status"] == "ok"
        finally:
            _stop(ha, sa)
            _stop(hb, sb)
            m.close()

    def test_without_store_two_routers_overadmit(self):
        """The regression pin for the world this PR fixes: two
        independent routers each open the full per-tenant budget, so
        the same flood admits ~2x the configured limit."""
        m = _ScriptedMember()
        ha, sa, ba = _start([m.url], api_keys=self._keys())
        hb, sb, bb = _start([m.url], api_keys=self._keys())
        try:
            ok, _, _ = self._flood([ba, bb])
            assert ok >= self.LIMIT * 1.5, (
                f"expected ~2x over-admission without the store, "
                f"got {ok} (did quota coordination appear for free?)"
            )
        finally:
            _stop(ha, sa)
            _stop(hb, sb)
            m.close()


# ---- the failover drill (acceptance) ----


class TestFailoverDrill:
    BODY = {"N": 8, "timesteps": 4}
    TOKEN = "fa" * 32

    def test_kill_active_midflight_standby_resumes_the_march(
        self, tmp_path
    ):
        """The whole tentpole in one drill: a chunked long solve is
        mid-march (the member checkpointed it - 504 + resume_token)
        when the active router DIES (no flush, no release).  The
        multi-endpoint client rotates; the standby acquires the expired
        lease, restores quota/counter state, and serves the retry; the
        re-presented token completes the march.  Zero client-visible
        errors, quota levels within one refill interval of pre-kill."""
        cp = str(tmp_path / "cp")
        m = _ScriptedMember()
        keys = {"k": quota.TenantConfig(tenant="t", rps=0.2,
                                        burst=5.0)}
        ha_httpd, sa, ba = _start(
            [m.url], control_plane_dir=cp, api_keys=keys,
            lease_ttl_s=0.6, store_flush_interval_s=0.05,
        )
        hb, sb, bb = _start(
            [m.url], control_plane_dir=cp, api_keys=keys,
            lease_ttl_s=0.6, store_flush_interval_s=0.05,
        )
        killed = []

        def kill_active():
            # the crash: stop serving AND stop renewing, release
            # NOTHING - the lease must expire on its own
            ha_httpd.shutdown()
            ha_httpd.server_close()
            sa.ha.stop(release=False)
            sa.stop_poller()

        def chaos_sleep(s):
            if not killed:
                killed.append(time.monotonic())
                kill_active()
            time.sleep(min(s, 0.25))

        client = WavetpuClient([ba, bb], retries=15,
                               sleep=chaos_sleep)
        try:
            assert sa.role == fleet_ha.ACTIVE
            assert sb.role == fleet_ha.STANDBY
            # pre-kill traffic: spend quota the successor must remember
            for _ in range(2):
                out = client.solve(self.BODY,
                                   headers={"X-Api-Key": "k"})
                assert out.ok
            # the spends persisted: a flush appended after them
            flushed = sa.store.appends_total
            deadline = time.monotonic() + 30.0
            while sa.store.appends_total == flushed:
                assert time.monotonic() < deadline, "no flush landed"
                time.sleep(0.02)
            pre_kill_level = sa.quotas.levels()["t"]["rps_tokens"]
            # NOW the chunked march: the member answers its next /solve
            # with "deadline died mid-march but CHECKPOINTED" - the
            # client's first backoff sleep is where the active dies
            with m.lock:
                m.solve_script = [(504, {
                    "status": "error",
                    "error": "deadline exceeded mid-march; "
                             "checkpointed",
                    "retriable": False, "resume_token": self.TOKEN,
                }, {})]
            out = client.solve(self.BODY, headers={"X-Api-Key": "k"})
            # ZERO client-visible errors across the failover
            assert out.ok, (out.status, out.error)
            assert killed, "the kill hook never fired"
            assert client.endpoint_failovers >= 1
            assert client.base_url == bb
            assert sb.role == fleet_ha.ACTIVE
            assert sb.ha.snapshot()["takeovers_total"] == 1
            # the successor holds a HIGHER epoch: the dead active is
            # fenced out even if it resurrects
            assert sb.ha.lease.epoch > 1
            # the resume token completed the march at the member via
            # the promoted router
            final_body = json.loads(m.seen_bodies[-1])
            assert final_body.get("resume_token") == self.TOKEN
            # quota state survived: the restored bucket is within one
            # refill interval (takeover gap ~1-3 s at 0.2/s, plus the
            # drill request itself) of the pre-kill level - NOT
            # reopened to the full burst of 5
            post_level = sb.quotas.levels()["t"]["rps_tokens"]
            assert post_level <= pre_kill_level + 1.5, (
                f"quota reopened across failover: {pre_kill_level} -> "
                f"{post_level}"
            )
            # and the standby's rejections were all retriable
            assert out.status == 200
        finally:
            _stop(hb, sb)
            if not killed:
                _stop(ha_httpd, sa)
            m.close()
            client.close()

    def test_orderly_stop_hands_off_within_one_tick(self, tmp_path):
        """The zero-downtime half: an orderly shutdown releases the
        lease, so the standby promotes on its next tick - no TTL
        wait."""
        cp = str(tmp_path / "cp")
        m = _ScriptedMember()
        ha_httpd, sa, ba = _start(
            [m.url], control_plane_dir=cp, lease_ttl_s=30.0,
            store_flush_interval_s=0.05,
        )
        hb, sb, bb = _start(
            [m.url], control_plane_dir=cp, lease_ttl_s=30.0,
            store_flush_interval_s=0.05,
        )
        try:
            assert sb.role == fleet_ha.STANDBY
            _stop(ha_httpd, sa)  # orderly: flush + release
            # well under the 30 s TTL however slow the host
            deadline = time.monotonic() + 20.0
            while (sb.role != fleet_ha.ACTIVE
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            # a 30s TTL would have pinned a crash-takeover here; the
            # RELEASE is what made this fast
            assert sb.role == fleet_ha.ACTIVE
        finally:
            _stop(hb, sb)
            m.close()


# ---- the control plane shared with wavetpu's router ----


PACKAGES = {"port": (ControlPlaneStore, trouter.build_router),
            "wavetpu": (jstore.ControlPlaneStore, jrouter.build_router)}


class TestSharedControlPlane:
    @pytest.mark.parametrize("writer,reader", [("port", "wavetpu"),
                                               ("wavetpu", "port")])
    def test_store_reads_the_other_packages_files(self, tmp_path, writer,
                                                  reader):
        """Snapshot + WAL written by one package's store load equal in
        the other's, before and after compaction, and a torn WAL tail
        is the same counted miss on both sides."""
        d = str(tmp_path / "cp")
        w = PACKAGES[writer][0](d)
        w.append("quota", {"t": {"rate": 1.0, "tokens": 2.5}})
        w.append("membership", {"members": [{"url": "http://a:1"}]})
        w.append("quota", {"t": {"rate": 1.0, "tokens": 1.5}})
        r = PACKAGES[reader][0](d)
        assert r.load() == w.load()
        w.compact(w.load())
        w.append("counters", {"requests_total": 7})
        assert PACKAGES[reader][0](d).load() == w.load()
        with open(os.path.join(d, "wal.jsonl"), "a") as f:
            f.write('{"seq": 99, "section": "torn"')
        r = PACKAGES[reader][0](d)
        assert r.load() == PACKAGES[writer][0](d).load()
        assert r.corrupt_lines_total == 1

    @pytest.mark.parametrize("first,second", [("port", "wavetpu"),
                                              ("wavetpu", "port")])
    def test_router_restarts_from_the_other_packages_store(
            self, tmp_path, first, second):
        """The restart pin across packages: a router of one package runs
        over a --control-plane-dir, retires a member and spends quota;
        a router of the other package boots on the same directory -
        every counter sample monotonic, the LEFT member's frozen
        counters carried, the quota bucket not reopened and the lease
        taken at the next epoch."""
        cp = str(tmp_path / "cp")
        body = {"N": 8, "timesteps": 4}
        gone = _ScriptedMember(prom="wavetpu_y_total 5\n")
        stays = _ScriptedMember(prom="wavetpu_y_total 2\n")
        keys = {"k": {"tenant": "t", "rps": 0.5, "burst": 6.0}}
        h1, s1, b1 = _start([gone.url, stays.url],
                            build=PACKAGES[first][1], control_plane_dir=cp,
                            api_keys=keys, store_flush_interval_s=0.05)
        try:
            assert s1.role == fleet_ha.ACTIVE
            for _ in range(3):
                assert _post(b1, "/solve", body,
                             headers={"X-Api-Key": "k"})[0] == 200
            s1.table.leave(gone.url)
            s1.table.retire(gone.url)
            gone.close()
            gone = None
            before = _scrape(b1)
            epoch = s1.snapshot()["ha"]["lease_epoch"]
            levels_before = s1.quotas.levels()["t"]["rps_tokens"]
            assert before["wavetpu_y_total"] == 7.0
        finally:
            _stop(h1, s1)
            if gone is not None:
                gone.close()
        h2, s2, b2 = _start([stays.url], build=PACKAGES[second][1],
                            control_plane_dir=cp, api_keys=keys,
                            store_flush_interval_s=0.05)
        try:
            assert s2.role == fleet_ha.ACTIVE
            assert s2.snapshot()["ha"]["lease_epoch"] == epoch + 1
            after = _scrape(b2)
            for name, v in before.items():
                if name.startswith(("wavetpu_store_",
                                    "wavetpu_fleet_ha_")):
                    continue
                if name.endswith("_total") and name in after:
                    assert after[name] >= v, (name, v, after[name])
            assert after["wavetpu_y_total"] >= 7.0
            assert after["wavetpu_router_requests_total"] >= 3.0
            assert any(row["state"] == LEFT
                       for row in s2.snapshot()["members"])
            assert s2.quotas.levels()["t"]["rps_tokens"] <= \
                levels_before + 1.5
        finally:
            _stop(h2, s2)
            stays.close()
