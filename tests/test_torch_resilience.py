"""The port's serve-path resilience on the CPU (the intent of wavetpu's
tests/test_resilience.py): deadlines, worker supervision, the per-
ProgramKey circuit breaker, the serve fault plan, the retrying client,
and a chaos drill - injected build failures on one tier plus a
mid-replay scheduler-worker kill and a dropped connection, driven by the
retrying client, with ZERO client-visible failures, the poisoned tier's
breaker opened while the other tier kept serving, and nothing past its
deadline.
"""

import json
import random
import threading
import time
import types
import urllib.request

import pytest

from wavetpu_torch.client import (
    RETRIABLE_STATUSES,
    WavetpuClient,
    parse_retry_after,
)
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.run import faults
from wavetpu_torch.serve.api import build_server
from wavetpu_torch.serve.engine import ServeEngine
from wavetpu_torch.serve.resilience import (
    CircuitBreaker,
    DeadlineExceededError,
    QuarantinedError,
    WorkerCrashError,
)
from wavetpu_torch.serve.scheduler import (
    DynamicBatcher,
    ServeMetrics,
    SolveRequest,
)


def _req(problem, **kw):
    return SolveRequest(problem=problem, lane=eb.LaneSpec(**kw))


class _FakeEngine:
    """Engine stub (mirrors test_serve's) recording batch occupancies."""

    max_batch = 4

    def __init__(self):
        self.batches = []

    def solve(self, problem, lanes, scheme, path, k, dtype_name,
              mesh=None, timing=None):
        if timing is not None:
            timing["compile_seconds"] = 0.0
            timing["warm"] = "true"
        self.batches.append(len(lanes))
        results = [
            types.SimpleNamespace(steps_computed=problem.timesteps)
            for _ in lanes
        ]
        res = types.SimpleNamespace(
            results=results, n_lanes=len(lanes), batch_size=len(lanes),
            batched=True, fallback_reason=None, path=path,
            solve_seconds=0.01, aggregate_gcells_per_second=1.0,
        )
        return res, [None] * len(lanes)


# ---- circuit breaker unit contracts ----


class TestCircuitBreaker:
    def test_opens_after_k_consecutive_failures_and_sheds(self):
        br = CircuitBreaker(threshold=3, cooldown_s=60.0)
        key = ("tier-a",)
        err = RuntimeError("compile exploded")
        br.admit(key)  # closed: free
        br.record_failure(key, err)
        br.admit(key)  # 1 failure < threshold: still closed
        br.record_failure(key, err)
        br.admit(key)
        br.record_failure(key, err)  # third consecutive: opens
        with pytest.raises(QuarantinedError) as ei:
            br.admit(key)
        assert 0 < ei.value.retry_after_s <= 60.0
        assert "quarantined" in str(ei.value)
        snap = br.snapshot()
        assert snap["open"] == 1
        assert snap["keys"][0]["state"] == "open"
        assert "compile exploded" in snap["keys"][0]["last_error"]

    def test_success_resets_consecutive_count(self):
        br = CircuitBreaker(threshold=2, cooldown_s=60.0)
        key = ("tier-a",)
        br.record_failure(key, RuntimeError("x"))
        br.record_success(key)  # intermittent failure never quarantines
        br.record_failure(key, RuntimeError("x"))
        br.admit(key)  # still closed: the count reset between failures

    def test_half_open_probe_closes_on_success(self):
        br = CircuitBreaker(threshold=1, cooldown_s=0.05)
        key = ("tier-a",)
        br.record_failure(key, RuntimeError("x"))
        with pytest.raises(QuarantinedError):
            br.admit(key)
        time.sleep(0.08)
        br.admit(key)  # cooldown elapsed: this call is the probe
        br.record_success(key)
        br.admit(key)  # closed again
        assert br.snapshot()["open"] == 0
        # history survives: the key row still records its open
        assert br.snapshot()["keys"][0]["opens"] == 1

    def test_half_open_probe_failure_reopens(self):
        br = CircuitBreaker(threshold=2, cooldown_s=0.05)
        key = ("tier-a",)
        br.record_failure(key, RuntimeError("x"))
        br.record_failure(key, RuntimeError("x"))
        time.sleep(0.08)
        br.admit(key)  # probe
        br.record_failure(key, RuntimeError("still broken"))
        with pytest.raises(QuarantinedError):
            br.admit(key)  # a SINGLE failed probe re-opened it

    def test_keys_are_independent(self):
        br = CircuitBreaker(threshold=1, cooldown_s=60.0)
        br.record_failure(("a",), RuntimeError("x"))
        with pytest.raises(QuarantinedError):
            br.admit(("a",))
        br.admit(("b",))  # the healthy tier is untouched

    def test_bad_config_rejected(self):
        with pytest.raises(ValueError):
            CircuitBreaker(threshold=0)
        with pytest.raises(ValueError):
            CircuitBreaker(cooldown_s=0.0)


# ---- serve fault plan (the chaos harness core) ----


class TestServeFaultPlan:
    def test_parse_env_multi_spec_mixed_with_run_side(self):
        env = {faults.ENV_FAULT: (
            "nan:5;serve-compile-fail:timesteps=12,count=2;"
            "serve-worker-crash:after=3,count=1"
        )}
        # the run-side half still resolves to its chunk hook
        assert faults.hook_from_env(env) is not None
        plan = faults.serve_plan_from_env(env)
        assert plan is not None and plan.active
        snap = plan.snapshot()
        assert [s["kind"] for s in snap] == \
            ["compile-fail", "worker-crash"]
        assert snap[0]["match"] == {"timesteps": "12"}
        assert snap[0]["remaining"] == 2
        assert snap[1]["after"] == 3

    def test_run_only_env_yields_no_plan_and_serve_only_no_hook(self):
        assert faults.serve_plan_from_env({faults.ENV_FAULT: "nan:5"}) \
            is None
        assert faults.hook_from_env(
            {faults.ENV_FAULT: "serve-conn-drop:count=1"}
        ) is None
        assert faults.serve_plan_from_env({}) is None

    def test_unknown_kind_and_selector_are_loud(self):
        with pytest.raises(ValueError, match="unknown serve fault"):
            faults.parse_serve_spec("serve-meteor-strike")
        with pytest.raises(ValueError, match="selector"):
            faults.parse_serve_spec("serve-compile-fail:color=red")
        with pytest.raises(ValueError, match="key=value"):
            faults.parse_serve_spec("serve-slow-batch:0.5")
        # conn-drop fires before the body is parsed: a selector would
        # silently never match, so it is refused at parse time
        with pytest.raises(ValueError, match="no selector"):
            faults.parse_serve_spec("serve-conn-drop:n=64")

    def test_multiple_run_side_specs_stay_loud(self):
        # The historical one-run-fault-per-drill contract: silently
        # running only the first would make the second assertion
        # vacuous.
        with pytest.raises(ValueError, match="at most one"):
            faults.hook_from_env({faults.ENV_FAULT: "nan:5;preempt:9"})

    def test_selector_count_and_after_budgets(self):
        plan = faults.parse_serve_spec(
            "serve-compile-fail:timesteps=7,count=2,after=1"
        )
        ctx = {"timesteps": 7, "scheme": "standard"}
        assert plan.fire("compile-fail", **ctx) is None  # after skips 1
        assert plan.fire("compile-fail", **ctx) is not None
        assert plan.fire("compile-fail", timesteps=8) is None  # no match
        assert plan.fire("compile-fail", **ctx) is not None
        assert plan.fire("compile-fail", **ctx) is None  # budget spent
        assert plan.fire("worker-crash", **ctx) is None  # wrong kind

    def test_firings_counted_in_registry(self):
        from wavetpu_torch.obs.registry import MetricsRegistry

        plan = faults.parse_serve_spec("serve-conn-drop:count=3")
        reg = MetricsRegistry()
        plan.bind_registry(reg)
        plan.fire("conn-drop")
        plan.fire("conn-drop")
        c = reg.counter(
            "wavetpu_serve_fault_injections_total", labelnames=("kind",)
        )
        assert c.value(kind="conn-drop") == 2


# ---- deadlines in the scheduler ----


class TestDeadlines:
    def test_expired_in_queue_dropped_before_engine(self):
        eng = _FakeEngine()
        metrics = ServeMetrics()
        b = DynamicBatcher(eng, metrics=metrics, max_wait=0.05)
        p = Problem(N=8, timesteps=3)
        try:
            fut = b.submit(_req(p), deadline=time.monotonic() - 0.001)
            with pytest.raises(DeadlineExceededError) as ei:
                fut.result(10)
            assert ei.value.queue_s is not None
            assert eng.batches == []  # never reached the engine
            assert metrics.snapshot()["deadline_expired_total"] == 1
        finally:
            b.close()

    def test_mixed_batch_live_lane_survives_expired_batchmate(self):
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=0.3)
        p = Problem(N=8, timesteps=3)
        try:
            dead = b.submit(_req(p), deadline=time.monotonic() - 0.001)
            live = b.submit(_req(p, phase=1.0),
                            deadline=time.monotonic() + 60.0)
            res, health, info = live.result(10)
            assert health is None
            with pytest.raises(DeadlineExceededError):
                dead.result(10)
            assert eng.batches == [1]  # the expired lane was not padded in
        finally:
            b.close()

    def test_no_deadline_is_the_historical_path(self):
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=0.05)
        p = Problem(N=8, timesteps=3)
        try:
            fut = b.submit(_req(p))
            res, health, info = fut.result(10)
            assert health is None
        finally:
            b.close()

    def test_http_deadline_504_from_json_field_and_header(self):
        # A slow batch (injected) makes the in-flight deadline expire:
        # the handler answers 504 within the budget, never hanging.
        plan = faults.parse_serve_spec("serve-slow-batch:seconds=0.6")
        httpd, state = build_server(
            port=0, max_wait=0.02, default_kernel="roll",
            device="cpu", fault_plan=plan,
        )
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            body = {"N": 8, "timesteps": 4, "deadline_ms": 150}
            t0 = time.monotonic()
            code, payload, _ = _post_full(base, body)
            took = time.monotonic() - t0
            assert code == 504
            assert payload["deadline_ms"] == 150
            assert "deadline" in payload["error"]
            assert took < 0.6  # returned at the deadline, not the batch
            # header form wins over the JSON field
            code, payload, _ = _post_full(
                base, {"N": 8, "timesteps": 4, "deadline_ms": 60000},
                headers={"X-Deadline-Ms": "150"},
            )
            assert code == 504
            assert payload["deadline_ms"] == 150
            # bad budgets are 400s
            code, payload, _ = _post_full(
                base, {"N": 8, "timesteps": 4, "deadline_ms": -5}
            )
            assert code == 400
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    def test_timeout_with_unexpired_deadline_is_500_not_504(self):
        """A budget LONGER than the server's request timeout can cap
        the future wait at the timeout with budget to spare - that is
        the historical timeout 500 (retriable by the client), not an
        expired-deadline 504."""
        plan = faults.parse_serve_spec("serve-slow-batch:seconds=1.0")
        httpd, state = build_server(
            port=0, max_wait=0.02, default_kernel="roll",
            device="cpu", fault_plan=plan,
        )
        state.request_timeout = 0.2  # the timeout loses, not the budget
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, payload, _ = _post_full(
                base, {"N": 8, "timesteps": 4, "deadline_ms": 600000}
            )
            assert code == 500
            assert "timed out" in payload["error"]
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    def test_generous_deadline_serves_normally(self):
        httpd, state = build_server(
            port=0, max_wait=0.02, default_kernel="roll", device="cpu",
        )
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, payload, _ = _post_full(
                base, {"N": 8, "timesteps": 4, "deadline_ms": 600000}
            )
            assert code == 200
            assert payload["report"]["final_step"] == 4
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()


# ---- worker supervision ----


class TestWorkerSupervision:
    def test_crash_fails_inflight_retriable_and_worker_restarts(self):
        plan = faults.parse_serve_spec("serve-worker-crash:count=1")
        eng = _FakeEngine()
        metrics = ServeMetrics()
        b = DynamicBatcher(eng, metrics=metrics, max_wait=0.05,
                           fault_plan=plan)
        p = Problem(N=8, timesteps=3)
        try:
            fut = b.submit(_req(p))
            with pytest.raises(WorkerCrashError, match="retry"):
                fut.result(10)
            # the supervisor restarted the worker: the next submit is
            # served normally, not stranded behind a dead thread
            res, health, info = b.submit(_req(p, phase=1.0)).result(10)
            assert health is None
            assert metrics.snapshot()["worker_restarts_total"] == 1
        finally:
            b.close()

    def test_repeated_crashes_never_strand_queued_requests(self):
        plan = faults.parse_serve_spec("serve-worker-crash:count=3")
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=0.02, fault_plan=plan)
        p = Problem(N=8, timesteps=3)
        try:
            futs = [b.submit(_req(p, phase=1.0 + i)) for i in range(5)]
            for f in futs:
                try:
                    f.result(15)  # result OR a fast crash error -
                except WorkerCrashError:
                    pass          # - never a hang
            # keep submitting: the crash budget (3) is finite, so the
            # supervisor must eventually restart into a serving worker
            for i in range(6):
                try:
                    res, health, _ = b.submit(
                        _req(p, phase=10.0 + i)
                    ).result(15)
                    assert health is None
                    break
                except WorkerCrashError:
                    continue
            else:
                pytest.fail("service never resumed after crash budget")
        finally:
            b.close()

    def test_http_worker_crash_maps_to_retriable_503(self):
        plan = faults.parse_serve_spec("serve-worker-crash:count=1")
        httpd, state = build_server(
            port=0, max_wait=0.02, default_kernel="roll",
            device="cpu", fault_plan=plan,
        )
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, payload, headers = _post_full(
                base, {"N": 8, "timesteps": 4}
            )
            assert code == 503
            assert payload["retriable"] is True
            assert "Retry-After" in headers
            # and the server recovered
            code, _, _ = _post_full(base, {"N": 8, "timesteps": 4})
            assert code == 200
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()


# ---- engine quarantine + injections ----


class TestEngineQuarantine:
    def test_compile_failures_open_breaker_other_tier_serves(self):
        plan = faults.parse_serve_spec(
            "serve-compile-fail:timesteps=9"  # unlimited: a dead tier
        )
        eng = ServeEngine(
            bucket_sizes=(1, 2), device="cpu", breaker_threshold=2,
            breaker_cooldown_s=60.0, fault_plan=plan,
        )
        poisoned = Problem(N=8, timesteps=9)
        healthy = Problem(N=8, timesteps=4)
        for _ in range(2):
            with pytest.raises(faults.InjectedFault):
                eng.solve(poisoned, [eb.LaneSpec()], path="roll")
        # breaker open: the third request sheds WITHOUT compiling
        misses_before = eng.misses
        with pytest.raises(QuarantinedError) as ei:
            eng.solve(poisoned, [eb.LaneSpec()], path="roll")
        assert eng.misses == misses_before  # no compile attempt
        assert ei.value.retry_after_s > 0
        # the healthy tier is untouched by its neighbor's quarantine
        res, health = eng.solve(healthy, [eb.LaneSpec()], path="roll")
        assert health == [None]
        stats = eng.breaker_stats()
        assert stats["enabled"] and stats["open"] == 1
        assert "steps=9" in stats["keys"][0]["key"]

    def test_breaker_key_spans_buckets(self):
        # Both buckets of one tier share a breaker: failures at bucket 1
        # quarantine bucket 2 as well (the tier is poisoned, not the
        # bucket).
        plan = faults.parse_serve_spec("serve-compile-fail:timesteps=9")
        eng = ServeEngine(
            bucket_sizes=(1, 2), device="cpu", breaker_threshold=2,
            breaker_cooldown_s=60.0, fault_plan=plan,
        )
        p = Problem(N=8, timesteps=9)
        for _ in range(2):
            with pytest.raises(faults.InjectedFault):
                eng.solve(p, [eb.LaneSpec()], path="roll")
        with pytest.raises(QuarantinedError):
            eng.solve(p, [eb.LaneSpec(), eb.LaneSpec(phase=1.0)],
                      path="roll")

    def test_half_open_probe_recovers_after_transient_fault(self):
        plan = faults.parse_serve_spec(
            "serve-compile-fail:timesteps=9,count=2"  # transient
        )
        eng = ServeEngine(
            bucket_sizes=(1,), device="cpu", breaker_threshold=2,
            breaker_cooldown_s=0.1, fault_plan=plan,
        )
        p = Problem(N=8, timesteps=9)
        for _ in range(2):
            with pytest.raises(faults.InjectedFault):
                eng.solve(p, [eb.LaneSpec()], path="roll")
        with pytest.raises(QuarantinedError):
            eng.solve(p, [eb.LaneSpec()], path="roll")
        time.sleep(0.15)
        # cooldown elapsed -> this is the half-open probe; the fault
        # budget is exhausted so it compiles fine and closes the breaker
        res, health = eng.solve(p, [eb.LaneSpec()], path="roll")
        assert health == [None]
        assert eng.breaker_stats()["open"] == 0

    def test_breaker_disabled_is_the_historical_path(self):
        eng = ServeEngine(bucket_sizes=(1,), device="cpu",
                          breaker_threshold=None)
        assert eng.breaker is None
        assert eng.breaker_stats() == {"enabled": False}
        p = Problem(N=8, timesteps=3)
        res, health = eng.solve(p, [eb.LaneSpec()], path="roll")
        assert health == [None]

    def test_watchdog_trips_do_not_feed_the_breaker(self):
        # A Courant-unstable REQUEST is the client's fault: 60 of them
        # in a row must not quarantine the tier for valid requests.
        from wavetpu_torch.serve.api import _c2_preset

        p = Problem(N=8, T=26.0, timesteps=60)
        eng = ServeEngine(bucket_sizes=(1,), device="cpu",
                          breaker_threshold=2)
        for _ in range(3):
            _, health = eng.solve(
                p, [eb.LaneSpec(c2tau2_field=_c2_preset(p, "two-layer"))],
                path="roll",
            )
            assert health[0] is not None  # tripped
        assert eng.breaker_stats()["open"] == 0

    def test_execute_nan_injection_caught_by_watchdog(self):
        plan = faults.parse_serve_spec("serve-execute-nan:count=1")
        eng = ServeEngine(bucket_sizes=(1,), device="cpu",
                          fault_plan=plan)
        p = Problem(N=8, timesteps=3)
        _, health = eng.solve(p, [eb.LaneSpec()], path="roll")
        assert health[0] is not None and "amax" in health[0]
        # budget spent: the next solve is clean
        _, health = eng.solve(p, [eb.LaneSpec()], path="roll")
        assert health == [None]


# ---- the retrying client ----


class _ScriptedHandler:
    """A tiny scripted /solve server: pops the next (status, body,
    headers) per request, recording what it saw."""

    def __init__(self, script):
        self.script = list(script)
        self.seen = []
        self.lock = threading.Lock()


def _scripted_server(script):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    state = _ScriptedHandler(script)

    class H(BaseHTTPRequestHandler):
        # keep-alive, like the real serve handler - lets the client
        # tests below exercise connection-reuse accounting
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            length = int(self.headers.get("Content-Length", "0") or 0)
            body = json.loads(self.rfile.read(length) or b"{}")
            with state.lock:
                state.seen.append({
                    "body": body,
                    "rid": self.headers.get("X-Request-Id"),
                })
                status, payload, headers = (
                    state.script.pop(0) if state.script
                    else (200, {"status": "ok"}, {})
                )
            if status == -1:  # drop the connection
                self.close_connection = True
                self.connection.close()
                return
            raw = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            for k, v in headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(raw)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


class TestClient:
    def _client(self, base, **kw):
        kw.setdefault("rng", random.Random(7))
        kw.setdefault("sleep", lambda s: None)
        return WavetpuClient(base, **kw)

    def test_retries_absorb_503_and_reuse_request_id(self):
        httpd, state, base = _scripted_server([
            (503, {"status": "error", "error": "worker crashed",
                   "retriable": True}, {"Retry-After": "0"}),
            (200, {"status": "ok", "report": {}}, {}),
        ])
        try:
            out = self._client(base, retries=3).solve(
                {"N": 8}, request_id="cl-test-1"
            )
            assert out.ok and out.attempts == 2
            assert out.retries[0]["status"] == 503
            # the SAME id rode both attempts (the trace-join contract)
            assert [s["rid"] for s in state.seen] == \
                ["cl-test-1", "cl-test-1"]
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_honors_retry_after_header(self):
        sleeps = []
        httpd, state, base = _scripted_server([
            (429, {"status": "error", "error": "queue full"},
             {"Retry-After": "2"}),
            (200, {"status": "ok"}, {}),
        ])
        try:
            out = self._client(
                base, retries=1, sleep=sleeps.append
            ).solve({"N": 8})
            assert out.ok and sleeps == [2.0]
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_non_retriable_4xx_returns_immediately(self):
        httpd, state, base = _scripted_server([
            (400, {"status": "error", "error": "missing N"}, {}),
        ])
        try:
            out = self._client(base, retries=5).solve({})
            assert out.status == 400 and out.attempts == 1
            assert "missing N" in out.error
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_connection_drop_is_retriable(self):
        httpd, state, base = _scripted_server([
            (-1, None, None),  # dropped connection
            (200, {"status": "ok"}, {}),
        ])
        try:
            out = self._client(base, retries=2).solve({"N": 8})
            assert out.ok and out.attempts == 2
            assert out.retries[0]["status"] == 0
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_deadline_bounds_attempts_and_rides_the_body(self):
        clock = {"t": 0.0}
        httpd, state, base = _scripted_server([
            (503, {"status": "error", "error": "x"}, {"Retry-After": "5"}),
            (503, {"status": "error", "error": "x"}, {"Retry-After": "5"}),
        ])

        def sleep(s):
            clock["t"] += s
            time.sleep(0)  # never actually wait in the test

        try:
            out = self._client(base, retries=10, sleep=sleep).solve(
                {"N": 8}, deadline_s=3.0
            )
            # Retry-After 5 s exceeds the 3 s budget: exactly one
            # attempt, then the client gives up instead of sleeping
            # past its own deadline.
            assert not out.ok and out.attempts == 1
            assert "deadline" in out.error
            # the remaining budget rode the body as deadline_ms
            sent = state.seen[0]["body"]
            assert 0 < sent["deadline_ms"] <= 3000
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_keepalive_reuses_connection_across_requests(self):
        httpd, state, base = _scripted_server([])  # default 200s
        try:
            c = self._client(base, retries=0)
            assert c.solve({"N": 8}).ok
            assert c.solve({"N": 8}).ok
            assert c.solve({"N": 8}).ok
            # one socket carried all three requests
            assert c.connections_opened == 1
            assert c.requests_on_reused_connection == 2
            assert c.connection_resets == 0
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_connection_close_header_retires_socket_orderly(self):
        httpd, state, base = _scripted_server([
            (200, {"status": "ok"}, {"Connection": "close"}),
            (200, {"status": "ok"}, {}),
        ])
        try:
            c = self._client(base, retries=0)
            assert c.solve({"N": 8}).ok
            assert c.solve({"N": 8}).ok
            # the announced close forced a reconnect, but it is NOT a
            # reset - that counter only tracks surprise failures
            assert c.connections_opened == 2
            assert c.connection_resets == 0
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_stale_kept_alive_socket_costs_one_status0_retry(self):
        httpd, state, base = _scripted_server([
            (200, {"status": "ok"}, {}),
            (-1, None, None),  # server kills the kept-alive socket
        ])
        try:
            c = self._client(base, retries=2)
            assert c.solve({"N": 8}).ok
            out = c.solve({"N": 8})
            # the dead socket cost one retriable status-0 attempt and
            # one counted reset; the retry reconnected and succeeded
            assert out.ok and out.attempts == 2
            assert out.retries[0]["status"] == 0
            assert c.connection_resets == 1
            assert c.connections_opened == 2
            # request 3 rides the fresh socket again
            assert c.solve({"N": 8}).ok
            assert c.requests_on_reused_connection >= 1
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_retriable_statuses_pinned(self):
        assert RETRIABLE_STATUSES == {0, 429, 500, 503}
        assert parse_retry_after({"Retry-After": "3"}) == 3.0
        assert parse_retry_after({"Retry-After": "junk"}) is None
        assert parse_retry_after({}) is None

    def test_bad_config_rejected(self):
        with pytest.raises(ValueError):
            WavetpuClient("http://x", retries=-1)
        with pytest.raises(ValueError):
            WavetpuClient("http://x", deadline_s=0)


# ---- HTTP helpers (shared shape with test_serve) ----


def _post_full(base, body, timeout=120, headers=None):
    import urllib.error

    req = urllib.request.Request(
        base + "/solve", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


# ---- acceptance: the chaos drill ----


class TestChaosDrill:
    def test_chaos_drill_zero_client_visible_errors(self):
        """Acceptance: injected compile failures on one tier
        (transient, breaker-opening) + a mid-replay worker kill + a
        dropped connection, all driven by the retrying client: every
        logical request succeeds, the poisoned tier's breaker opened
        while the healthy tier kept serving, injections are counted,
        and nothing hangs past its deadline."""
        plan = faults.parse_serve_spec(
            "serve-compile-fail:timesteps=9,count=2;"
            "serve-worker-crash:after=2,count=1;"
            "serve-conn-drop:after=1,count=1"
        )
        httpd, state = build_server(
            port=0, max_wait=0.02, default_kernel="roll",
            device="cpu", fault_plan=plan,
            breaker_threshold=2, breaker_cooldown_s=0.3,
        )
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            self._drill(base, state, plan)
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    @staticmethod
    def _drill(base, state, plan):
        client = WavetpuClient(
            base, retries=8, timeout=60.0, backoff_base_s=0.02,
            backoff_max_s=0.3, rng=random.Random(3),
        )
        outcomes = [None] * 10
        t0 = time.monotonic()

        def fire(i):
            body = (
                {"N": 8, "timesteps": 9} if i % 2 else
                {"N": 8, "timesteps": 4, "phase": 1.0 + i}
            )
            outcomes[i] = client.solve(body, deadline_s=45.0)

        threads = [
            threading.Thread(target=fire, args=(i,)) for i in range(10)
        ]
        for t in threads:
            t.start()
            time.sleep(0.03)  # staggered: the crash lands mid-replay
        for t in threads:
            t.join(90)
        took = time.monotonic() - t0
        # 1. zero client-visible failures: retry/backoff absorbed
        # compile faults, the worker kill, and the dropped connection
        assert all(o is not None and o.ok for o in outcomes), [
            (o.status, o.error) for o in outcomes if o and not o.ok
        ]
        # 2. faults actually fired and were absorbed (not a vacuous run)
        assert any(o.attempts > 1 for o in outcomes)
        fired = {s["kind"]: s["fired"] for s in plan.snapshot()}
        assert fired["compile-fail"] == 2
        assert fired["worker-crash"] == 1
        assert fired["conn-drop"] == 1
        # 3. the poisoned tier's breaker opened (and has since closed
        # via the half-open probe) while the healthy tier served
        stats = state.engine.breaker_stats()
        assert any(k["opens"] >= 1 for k in stats["keys"])
        assert stats["open"] == 0  # recovered by the probe
        # 4. no future outlived its deadline (45 s budget, generous
        # margin for CI)
        assert took < 80.0
        # 5. the injections are visible in the registry counter
        code, snap = _get_json(base, "/metrics")
        assert snap["worker_restarts_total"] == 1
        assert snap["breaker"]["enabled"] is True

    def test_happy_path_response_unchanged_with_resilience_live(self):
        """Acceptance: with the breaker on (default) and no fault or
        deadline, the /solve response carries exactly the historical
        payload shape - the resilience layer is invisible until used."""
        httpd, state = build_server(
            port=0, max_wait=0.02, default_kernel="roll", device="cpu",
        )
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, payload, _ = _post_full(base, {"N": 8, "timesteps": 4})
            assert code == 200
            assert set(payload) == {
                "status", "report", "report_text", "batch"
            }
            assert set(payload["batch"]) == {
                "occupancy", "batch_size", "batched", "fallback_reason",
                "path", "padding_lanes", "aggregate_gcells_per_s",
                "warm", "timing",
            }
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()


def _get_json(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, json.loads(r.read())
