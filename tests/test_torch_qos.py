"""The replica side of multi-tenant QoS in the port, on the CPU (the
intent of wavetpu's tests/test_qos.py TestClassLadder, TestRetryAfter,
TestWDRR, TestBrownout, TestIsolationDrill and TestReplicaTenantTrust):

 * the class ladder is ONE ladder - wavetpu's router quota module (which
   will front this replica) must stay identical to the port scheduler's;
 * WDRR keeps an interactive flood from starving best_effort, and a
   single backlogged class pays zero QoS (plain FIFO);
 * a best_effort solve served under interactive pressure finishes bit
   for bit as its unloaded run - QoS reorders work, never numerics;
 * Retry-After is the measured drain estimate, honored by the client;
 * the brownout ladder escalates immediately and de-escalates one
   hysteresis-gated rung at a time, never shedding interactive;
 * the replica trusts tenant/priority headers only with --proxy-token.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_obs import parse_prometheus
from wavetpu.fleet import quota
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.serve import scheduler as sched
from wavetpu_torch.serve.api import build_server, format_retry_after
from wavetpu_torch.serve.engine import ServeEngine
from wavetpu_torch.serve.resilience import ShedError
from wavetpu_torch.serve.scheduler import (
    BrownoutController,
    DynamicBatcher,
    ServeMetrics,
    SolveRequest,
)


# ---- the one class ladder ----

class TestClassLadder:
    def test_quota_ladder_identical_to_scheduler_ladder(self):
        # quota.py duplicates the tuple (the router must not import the
        # jax-transitive serve package); this pin is the only thing
        # keeping the two from drifting.
        assert quota.PRIORITY_CLASSES == sched.PRIORITY_CLASSES
        assert quota.DEFAULT_PRIORITY == sched.DEFAULT_PRIORITY

    def test_normalize_is_lenient_never_raises(self):
        for fn in (quota.normalize_priority, sched.normalize_priority):
            assert fn(" Interactive ") == "interactive"
            assert fn("best_effort") == "best_effort"
            assert fn(None) == "batch"
            assert fn("turbo") == "batch"
            assert fn(7) == "batch"
            assert fn("junk", default="best_effort") == "best_effort"

    def test_clamp_demotes_never_promotes(self):
        assert quota.clamp_priority("interactive", "batch") == "batch"
        assert quota.clamp_priority("best_effort", "batch") \
            == "best_effort"
        assert quota.clamp_priority("batch", "interactive") == "batch"

    def test_effective_priority_default_then_ceiling(self):
        cfg = quota.TenantConfig(
            tenant="t", priority="batch", priority_ceiling="batch"
        )
        assert cfg.effective_priority(None) == "batch"
        # a self-promotion past the ceiling is clamped, not an error
        assert cfg.effective_priority("interactive") == "batch"
        assert cfg.effective_priority("best_effort") == "best_effort"
        assert cfg.effective_priority("junk") == "batch"

    def test_parse_tenant_entry_clamps_default_to_ceiling(self):
        cfg = quota.parse_tenant_entry("k", {
            "tenant": "t", "priority": "interactive",
            "priority_ceiling": "batch",
        })
        assert cfg.priority == "batch"
        assert cfg.priority_ceiling == "batch"


# ---- measured Retry-After, server + client sides ----

class TestRetryAfter:
    def test_format_rounds_up_to_at_least_one_second(self):
        assert format_retry_after(0.2) == "1"
        assert format_retry_after(1.4) == "1"
        assert format_retry_after(1.6) == "2"

    def test_metrics_fallback_when_no_drain_history(self):
        m = ServeMetrics()
        assert m.retry_after_s(5) == 1.0
        assert m.retry_after_s(5, fallback=3.5) == 3.5

    def test_client_honors_exactly_the_servers_computation(self):
        # the pin: server-side measured seconds -> wire header ->
        # client parse round-trips to the same honored wait
        from wavetpu_torch.client import parse_retry_after
        m = ServeMetrics()
        wire = format_retry_after(m.retry_after_s(4, fallback=2.6))
        assert parse_retry_after({"Retry-After": wire}) == 3.0


# ---- WDRR scheduling ----

class _GateEngine:
    """max_batch=1 stub whose solve() blocks until released - each
    release exposes exactly one scheduler pick, so `order` IS the
    worker's pick sequence."""

    max_batch = 1

    def __init__(self):
        self.order = []
        self.entered = threading.Semaphore(0)
        self.release = threading.Semaphore(0)

    def solve(self, problem, lanes, scheme, path, k, dtype_name,
              mesh=None, timing=None):
        self.order.append(problem.timesteps)
        self.entered.release()
        self.release.acquire()
        if timing is not None:
            timing["compile_seconds"] = 0.0
            timing["warm"] = "true"
        results = [
            types.SimpleNamespace(steps_computed=problem.timesteps)
            for _ in lanes
        ]
        return types.SimpleNamespace(
            results=results, n_lanes=len(lanes), batch_size=len(lanes),
            batched=True, fallback_reason=None, path=path,
            solve_seconds=0.0, aggregate_gcells_per_second=1.0,
        ), [None] * len(lanes)


def _qreq(timesteps, priority):
    # distinct timesteps -> distinct program keys, so nothing coalesces
    # and the engine-observed order is the raw pick order
    return SolveRequest(
        problem=Problem(N=8, timesteps=timesteps),
        lane=eb.LaneSpec(), priority=priority,
    )


def _drive(classes_by_timesteps):
    """Submit one request per (timesteps, class), with the worker held
    inside the FIRST solve so the rest stash as one backlog; release
    everything and return the engine's pick order as class names."""
    eng = _GateEngine()
    b = DynamicBatcher(eng, max_wait=0.001)
    mapping = dict(classes_by_timesteps)
    futs = []
    try:
        head_t, head_c = classes_by_timesteps[0]
        futs.append(b.submit(_qreq(head_t, head_c)))
        eng.entered.acquire(timeout=10)  # worker is inside solve #1
        for t, c in classes_by_timesteps[1:]:
            futs.append(b.submit(_qreq(t, c)))
        for _ in classes_by_timesteps[1:]:
            eng.release.release()
            eng.entered.acquire(timeout=10)
        eng.release.release()  # let the last solve return
        for f in futs:
            f.result(30)
    finally:
        eng.release.release()
        b.close()
    return [mapping[t] for t in eng.order]


class TestWDRR:
    def test_single_class_is_plain_arrival_order_fifo(self):
        plan = [(3 + i, "batch") for i in range(6)]
        assert _drive(plan) == ["batch"] * 6
        # and the engine saw strict arrival order (no reordering cost
        # for the pre-QoS single-tenant deployment)
        eng = _GateEngine()
        b = DynamicBatcher(eng, max_wait=0.001)
        try:
            futs = [b.submit(_qreq(3 + i, "batch")) for i in range(6)]
            eng.entered.acquire(timeout=10)
            for _ in range(5):
                eng.release.release()
                eng.entered.acquire(timeout=10)
            eng.release.release()
            for f in futs:
                f.result(30)
        finally:
            eng.release.release()
            b.close()
        assert eng.order == sorted(eng.order)

    def test_interactive_flood_does_not_starve_best_effort(self):
        # 40 interactive stacked against 2 best_effort: DRR's bound
        # serves best_effort at least once every ~sum(weights)=17
        # picks, so BOTH drain well before the flood does.
        plan = [(100, "best_effort"), (101, "best_effort")]
        plan += [(3 + i, "interactive") for i in range(40)]
        # head item (occupying the worker) is interactive so the two
        # best_effort submissions land in an already-contended stash
        plan = [plan[2]] + plan[:2] + plan[3:]
        order = _drive(plan)
        be = [i for i, c in enumerate(order) if c == "best_effort"]
        assert len(be) == 2
        # contention holds them back at first (interactive outbids)...
        assert be[0] > 1
        # ...but the starvation bound (one best_effort turn per
        # ~sum(weights) picks) drains both long before the flood ends
        assert be[0] <= 17
        assert be[-1] <= 2 * 17
        assert be[-1] < len(order) - 1

    def test_fresh_interactive_beats_backlogged_lower_class(self):
        # strict rule: an eligible interactive request takes the NEXT
        # pick ahead of a backlogged batch queue - its first-round
        # 16-credit outbids any deficit batch can have banked.
        eng = _GateEngine()
        b = DynamicBatcher(eng, max_wait=0.001)
        try:
            f0 = b.submit(_qreq(50, "batch"))
            eng.entered.acquire(timeout=10)
            futs = [b.submit(_qreq(3 + i, "batch")) for i in range(4)]
            fi = b.submit(_qreq(40, "interactive"))
            eng.release.release()            # finish the head batch
            eng.entered.acquire(timeout=10)  # pick #2 is now chosen
            for _ in range(4):
                eng.release.release()
                eng.entered.acquire(timeout=10)
            eng.release.release()
            f0.result(30)
            fi.result(30)
            for f in futs:
                f.result(30)
        finally:
            eng.release.release()
            b.close()
        assert eng.order[1] == 40  # the interactive one, next pass

    def test_class_counters_land_in_the_registry(self):
        m = ServeMetrics()
        eng = _GateEngine()
        b = DynamicBatcher(eng, metrics=m, max_wait=0.001)
        try:
            f = b.submit(_qreq(3, "interactive"))
            eng.entered.acquire(timeout=10)
            eng.release.release()
            f.result(30)
        finally:
            eng.release.release()
            b.close()
        assert m._class_requests.value(
            **{"class": "interactive"}
        ) == 1
        assert m._scheduled.value(**{"class": "interactive"}) == 1


# ---- brownout ladder ----

class TestBrownout:
    def _hot(self, bo, n=10, wait=1.0):
        for _ in range(n):
            bo.observe_wait(wait)

    def test_rejects_malformed_thresholds(self):
        with pytest.raises(ValueError):
            BrownoutController(thresholds=(1.0, 2.0))
        with pytest.raises(ValueError):
            BrownoutController(thresholds=(3.0, 2.0, 1.0))
        with pytest.raises(ValueError):
            BrownoutController(thresholds=(0.0, 1.0, 2.0))

    def test_escalates_immediately_across_rungs(self):
        bo = BrownoutController(
            thresholds=(0.1, 0.2, 0.3), min_samples=4,
            min_interval_s=0.0,
        )
        assert bo.update() == 0  # too few samples: healthy
        self._hot(bo, wait=0.15)
        assert bo.update() == 1
        self._hot(bo, wait=5.0)
        assert bo.update() == 3  # straight to the top, no ladder-climb

    def test_shed_policy_never_touches_interactive(self):
        bo = BrownoutController(min_interval_s=0.0)
        for rung, sheds in ((0, set()), (1, {"best_effort"}),
                            (2, {"batch", "best_effort"}),
                            (3, {"batch", "best_effort"})):
            bo._rung = rung
            assert {c for c in sched.PRIORITY_CLASSES
                    if bo.sheds(c)} == sheds
        assert bo.defers_chunk_starts()  # still at rung 3
        bo._rung = 2
        assert not bo.defers_chunk_starts()

    def test_recovery_is_one_rung_at_a_time(self):
        bo = BrownoutController(
            thresholds=(0.1, 0.2, 0.3), min_samples=4,
            min_interval_s=0.0, cooldown_s=0.0, sample_ttl_s=0.2,
        )
        self._hot(bo, wait=5.0)
        assert bo.update() == 3
        time.sleep(0.25)  # the hot samples age out of the TTL window
        assert bo.update() == 2  # never 3 -> 0 in one step
        assert bo.update() == 1
        assert bo.update() == 0
        snap = bo.snapshot()
        assert snap["rung_name"] == "healthy"
        assert snap["thresholds_s"] == [0.1, 0.2, 0.3]

    def test_cooldown_gates_deescalation(self):
        bo = BrownoutController(
            thresholds=(0.1, 0.2, 0.3), min_samples=4,
            min_interval_s=0.0, cooldown_s=60.0, sample_ttl_s=0.2,
        )
        self._hot(bo, wait=5.0)
        assert bo.update() == 3
        time.sleep(0.25)
        assert bo.update() == 3  # healthy signal but inside cooldown

    def test_submit_sheds_with_measured_retry_after(self):
        bo = BrownoutController(
            thresholds=(0.01, 10.0, 20.0), min_samples=4,
            min_interval_s=0.0,
        )
        for _ in range(8):
            bo.observe_wait(0.5)
        m = ServeMetrics()
        b = DynamicBatcher(_GateEngine(), metrics=m, max_wait=0.001,
                           brownout=bo)
        try:
            with pytest.raises(ShedError) as ei:
                b.submit(_qreq(3, "best_effort"))
            assert ei.value.rung == "shed_best_effort"
            assert ei.value.retry_after_s > 0
            # interactive and batch still board at rung 1
            fi = b.submit(_qreq(4, "interactive"))
            fb = b.submit(_qreq(5, "batch"))
            eng = b.engine
            eng.entered.acquire(timeout=10)
            eng.release.release()
            eng.entered.acquire(timeout=10)
            eng.release.release()
            fi.result(30)
            fb.result(30)
        finally:
            b.engine.release.release()
            b.close()
        assert m.snapshot()["shed_total"] == 1
        assert m._shed.value(
            rung="shed_best_effort", **{"class": "best_effort"}
        ) == 1


# ---- the bitwise isolation drill ----


class TestIsolationDrill:
    """A best_effort solve served while interactive traffic takes every
    pick ahead of it finishes BITWISE as its unloaded run."""

    def test_low_priority_solve_under_interactive_pressure_is_bitwise(
            self):
        eng = ServeEngine(bucket_sizes=(1, 2), device="cpu")
        p = Problem(N=8, timesteps=17)
        b = DynamicBatcher(eng, max_wait=0.005)
        try:
            control = b.submit(SolveRequest(
                problem=p, lane=eb.LaneSpec(), priority="best_effort",
            )).result(300)[0]
        finally:
            b.close()
        b = DynamicBatcher(eng, max_wait=0.005)
        short = Problem(N=8, timesteps=3)
        try:
            shorts = [b.submit(SolveRequest(
                problem=short, lane=eb.LaneSpec(phase=1.0 + i),
                priority="interactive")) for i in range(3)]
            long_fut = b.submit(SolveRequest(
                problem=p, lane=eb.LaneSpec(), priority="best_effort"))
            for i in range(3, 6):
                shorts.append(b.submit(SolveRequest(
                    problem=short, lane=eb.LaneSpec(phase=1.0 + i),
                    priority="interactive")))
                time.sleep(0.01)
            short_res = [f.result(300) for f in shorts]
            res, health, info = long_fut.result(300)
        finally:
            b.close()
        assert health is None and info["batched"] is True
        assert all(h is None for _, h, _ in short_res)
        assert np.array_equal(res.abs_errors, control.abs_errors)
        assert np.array_equal(res.rel_errors, control.rel_errors)
        assert res.final_step == control.final_step == 17


# ---- replica-side tenant trust over HTTP ----

@pytest.fixture(scope="module")
def qos_server():
    httpd, state = build_server(
        port=0, max_wait=0.05, default_kernel="roll", device="cpu",
        proxy_token="sek", tenant_inflight_cap=2,
    )
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base, state
    httpd.shutdown()
    state.batcher.close()
    httpd.server_close()


def _post(base, body, headers=None):
    req = urllib.request.Request(
        base + "/solve", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _metric(base, name, **labels):
    """One sample's value from a live /metrics scrape (0.0 when the
    labeled sample has not been emitted yet)."""
    req = urllib.request.Request(
        base + "/metrics", headers={"Accept": "text/plain"}
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        samples, _types = parse_prometheus(r.read().decode())
    for key, value in samples.items():
        sample = key if "{" in key else key + "{"
        sname, _, rest = sample.partition("{")
        if sname != name:
            continue
        if all(f'{k}="{v}"' in rest for k, v in labels.items()):
            return value
    return 0.0


class TestReplicaTenantTrust:
    BODY = {"N": 8, "timesteps": 3, "kernel": "roll"}

    def test_spoofed_headers_are_ignored_and_counted(self, qos_server):
        base, _state = qos_server
        before = _metric(
            base, "wavetpu_serve_tenant_spoof_rejected_total"
        )
        code, payload, _h = _post(base, self.BODY, headers={
            "X-Wavetpu-Tenant": "mallory", "X-Priority": "interactive",
            "X-Wavetpu-Proxy-Token": "wrong",
        })
        assert code == 200 and payload["status"] == "ok"  # served...
        assert _metric(
            base, "wavetpu_serve_tenant_spoof_rejected_total"
        ) == before + 1  # ...but untenanted, and the spoof is counted
        assert _metric(
            base, "wavetpu_serve_tenant_requests_total",
            tenant="mallory",
        ) == 0.0
        assert _metric(
            base, "wavetpu_serve_class_requests_total",
            **{"class": "interactive"},
        ) == 0.0

    def test_router_token_unlocks_tenant_and_priority(self, qos_server):
        base, _state = qos_server
        code, payload, _h = _post(base, self.BODY, headers={
            "X-Wavetpu-Tenant": "alice", "X-Priority": "interactive",
            "X-Wavetpu-Proxy-Token": "sek",
        })
        assert code == 200 and payload["status"] == "ok"
        assert _metric(
            base, "wavetpu_serve_tenant_requests_total", tenant="alice",
        ) == 1.0
        assert _metric(
            base, "wavetpu_serve_class_requests_total",
            **{"class": "interactive"},
        ) == 1.0

    def test_body_priority_needs_no_token(self, qos_server):
        # priority in the BODY is the direct-client path: it only picks
        # a class (no tenant impersonation), so it needs no token
        base, _state = qos_server
        code, _p, _h = _post(
            base, {**self.BODY, "priority": "best_effort"}
        )
        assert code == 200
        assert _metric(
            base, "wavetpu_serve_class_requests_total",
            **{"class": "best_effort"},
        ) == 1.0

    def test_inflight_cap_acquire_release(self, qos_server):
        _base, state = qos_server
        assert state.try_acquire_tenant_slot("bob")
        assert state.try_acquire_tenant_slot("bob")
        assert not state.try_acquire_tenant_slot("bob")  # cap = 2
        assert state.try_acquire_tenant_slot("carol")  # per-tenant
        state.release_tenant_slot("bob")
        assert state.try_acquire_tenant_slot("bob")
        for _ in range(2):
            state.release_tenant_slot("bob")
        state.release_tenant_slot("carol")
        state.release_tenant_slot("ghost")  # never acquired: no-op

    def test_healthz_carries_the_brownout_block(self, qos_server):
        base, _state = qos_server
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            payload = json.loads(r.read())
        bo = payload["brownout"]
        assert bo["rung"] == 0 and bo["rung_name"] == "healthy"
        assert len(bo["thresholds_s"]) == 3


# ---- router quota + priority stamping, end to end ----
