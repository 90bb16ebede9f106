"""The port's shadow sampler (serve/shadow.py): the intent of wavetpu's
tests/test_accuracy.py TestShadowSampler, TestShadowNeverFeedsBreaker and
TestServeShadowHTTP, on the CPU.  The sampler runs after the primary 200,
the twin at best_effort, one in flight, never feeding the breaker; the
`serve-shadow-fail` seam is a counter tick; every skip reason is counted;
the primary's bytes are unchanged by a shadow.  The reference plan is
compensated / k=1 / f32, on `roll` here and on K2's lane mode (`pallas`)
on the card; `_is_reference` treats the two alike.
"""

import json
import os
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.obs import accuracy, telemetry
from wavetpu_torch.obs.registry import MetricsRegistry
from wavetpu_torch.run import faults
from wavetpu_torch.serve.api import build_server
from wavetpu_torch.serve.scheduler import DynamicBatcher, SolveRequest
from wavetpu_torch.serve.shadow import ShadowSampler


class _StubFuture:
    def __init__(self, fn):
        self._fn = fn

    def result(self, timeout=None):
        return self._fn()


class _StubBatcher:
    """A deterministic twin: a fixed reference layer (or an error),
    optionally blocking until released."""

    def __init__(self, ref, error=None, release=None):
        self.ref = ref
        self.error = error
        self.release = release
        self.submits = []

    def submit(self, req, request_id=None, deadline=None,
               trace_context=None):
        self.submits.append(req)

        def run():
            if self.release is not None:
                assert self.release.wait(30.0)
            if self.error is not None:
                return None, self.error, {}
            return types.SimpleNamespace(u_cur=self.ref), None, {}

        return _StubFuture(run)


def _shadow_req(problem=None, **over):
    kw = dict(scheme="standard", path="kfused", k=2, dtype_name="f32")
    kw.update(over)
    return SolveRequest(problem=problem or Problem(N=8, timesteps=4),
                        lane=kw.pop("lane", eb.LaneSpec()), **kw)


def _lane_result(u, solve_seconds=0.02):
    return types.SimpleNamespace(u_cur=u, solve_seconds=solve_seconds,
                                 steps_computed=None)


class TestShadowSampler:
    def test_rate_bounds_validated(self):
        for bad in (-0.1, 1.5):
            with pytest.raises(ValueError, match="shadow-sample-rate"):
                ShadowSampler(_StubBatcher(None), MetricsRegistry(), bad)

    def test_eligibility_matrix(self):
        s = ShadowSampler(_StubBatcher(None), MetricsRegistry(), 1.0)
        assert s.ineligible_reason(_shadow_req(resume_token="t")) == \
            "resume"
        assert s.ineligible_reason(_shadow_req(mesh_shape=(2, 1, 1))) == \
            "mesh"
        # roll and pallas alike: K2's lane mode is the reference on the
        # card.
        for path in ("roll", "pallas"):
            assert s.ineligible_reason(_shadow_req(
                scheme="compensated", path=path, k=1)) == "reference-plan"
        assert s.ineligible_reason(_shadow_req(
            scheme="compensated", path="kfused", k=4)) is None
        assert s.ineligible_reason(_shadow_req()) is None

    @pytest.mark.parametrize("platform_path", ["roll", "pallas"])
    def test_reference_request_shape(self, platform_path):
        s = ShadowSampler(_StubBatcher(None), MetricsRegistry(), 1.0,
                          reference_path=platform_path)
        req = _shadow_req(dtype_name="bf16", priority="interactive")
        ref = s.reference_request(req)
        assert (ref.scheme, ref.path, ref.k, ref.dtype_name) == (
            "compensated", platform_path, 1, "f32")
        assert ref.priority == "best_effort" and ref.shadow is True
        assert ref.problem is req.problem
        field_req = _shadow_req(
            lane=eb.LaneSpec(c2tau2_field=np.ones((8, 8, 8))))
        assert s.reference_request(field_req).scheme == "standard"

    def test_rate_zero_skips_unsampled(self):
        s = ShadowSampler(_StubBatcher(None), MetricsRegistry(), 0.0)
        assert s.offer(_shadow_req(), _lane_result(np.zeros(3)),
                       "r1") is False
        assert s.snapshot()["skipped"] == {"unsampled": 1.0}

    def test_divergence_measured_and_ledgered(self, tmp_path):
        """Served differs from the twin by exactly 0.5 in one cell: L-inf
        divergence 0.5 under the SERVED plan, source=shadow (the served
        layer a tensor, as the engine keeps it)."""
        d = str(tmp_path / "tel")
        ref = np.zeros((4, 4, 4), dtype=np.float32)
        served = torch.zeros((4, 4, 4))
        served[1, 2, 3] = 0.5
        reg = MetricsRegistry()
        batcher = _StubBatcher(ref)
        s = ShadowSampler(batcher, reg, 1.0, deadline_s=30.0)
        tel = telemetry.start(d, interval=60.0)
        try:
            assert s.offer(_shadow_req(), _lane_result(served), "req-1")
            assert s.wait_idle(30.0)
        finally:
            tel.stop()
        snap = s.snapshot()
        assert snap["solves"] == 1.0 and snap["failures"] == 0.0
        assert reg.gauge("wavetpu_shadow_divergence", "",
                         ("path", "scheme", "dtype")).value(
            path="kfused", scheme="standard", dtype="f32") == 0.5
        recs = accuracy.load_accuracy_ledger(
            os.path.join(d, accuracy.ACCURACY_FILENAME))
        shadows = [r for r in recs if r["source"] == "shadow"]
        assert len(shadows) == 1 and shadows[0]["max_abs_err"] == 0.5
        assert shadows[0]["plan"]["path"] == "kfused"
        assert shadows[0]["plan"]["k"] == 2
        assert batcher.submits[0].scheme == "compensated"
        assert batcher.submits[0].shadow is True

    def test_one_in_flight_second_offer_skipped_busy(self):
        release = threading.Event()
        ref = np.zeros(3, dtype=np.float32)
        s = ShadowSampler(_StubBatcher(ref, release=release),
                          MetricsRegistry(), 1.0)
        try:
            assert s.offer(_shadow_req(), _lane_result(ref), "a") is True
            assert s.offer(_shadow_req(), _lane_result(ref), "b") is False
            assert s.snapshot()["skipped"] == {"busy": 1.0}
        finally:
            release.set()
        assert s.wait_idle(30.0)
        assert s.snapshot()["solves"] == 1.0

    def test_shadow_fail_chaos_is_counter_only(self, tmp_path):
        d = str(tmp_path / "tel")
        ref = np.zeros(3, dtype=np.float32)
        batcher = _StubBatcher(ref)
        plan = faults.parse_serve_spec("serve-shadow-fail:count=1")
        s = ShadowSampler(batcher, MetricsRegistry(), 1.0, fault_plan=plan)
        tel = telemetry.start(d, interval=60.0)
        try:
            assert s.offer(_shadow_req(), _lane_result(ref), "a") is True
            assert s.wait_idle(30.0)
            snap = s.snapshot()
            assert snap["failures"] == 1.0 and snap["solves"] == 0.0
            assert batcher.submits == []
            assert s.offer(_shadow_req(), _lane_result(ref), "b") is True
            assert s.wait_idle(30.0)
        finally:
            tel.stop()
        assert s.snapshot()["solves"] == 1.0
        recs = accuracy.load_accuracy_ledger(
            os.path.join(d, accuracy.ACCURACY_FILENAME))
        assert len([r for r in recs if r["source"] == "shadow"]) == 1

    def test_unhealthy_twin_is_a_failure_not_a_crash(self):
        ref = np.zeros(3, dtype=np.float32)
        s = ShadowSampler(_StubBatcher(ref, error="lane blew up"),
                          MetricsRegistry(), 1.0)
        assert s.offer(_shadow_req(), _lane_result(ref), "a") is True
        assert s.wait_idle(30.0)
        snap = s.snapshot()
        assert snap["failures"] == 1.0 and snap["solves"] == 0.0


class _BreakerProbeEngine:
    """Records what the scheduler passed for feed_breaker: "absent" is
    the production calling convention, False the shadow-only bypass."""

    max_batch = 4

    def __init__(self):
        self.feed_breaker_seen = []

    def solve(self, problem, lanes, scheme, path, k, dtype_name,
              mesh=None, timing=None, **kw):
        self.feed_breaker_seen.append(kw.get("feed_breaker", "absent"))
        if timing is not None:
            timing["compile_seconds"] = 0.0
            timing["warm"] = "true"
        results = [types.SimpleNamespace(steps_computed=problem.timesteps)
                   for _ in lanes]
        res = types.SimpleNamespace(
            results=results, n_lanes=len(lanes), batch_size=len(lanes),
            batched=True, fallback_reason=None, path=path,
            solve_seconds=0.01, aggregate_gcells_per_second=1.0)
        return res, [None] * len(lanes)


class TestShadowNeverFeedsBreaker:
    def test_scheduler_bypasses_breaker_for_shadow_only_batches(self):
        eng = _BreakerProbeEngine()
        b = DynamicBatcher(eng, max_wait=0.01)
        p = Problem(N=8, timesteps=4)
        try:
            b.submit(SolveRequest(problem=p, lane=eb.LaneSpec())).result(30)
            b.submit(SolveRequest(problem=p, lane=eb.LaneSpec(),
                                  shadow=True,
                                  priority="best_effort")).result(30)
        finally:
            b.close()
        assert eng.feed_breaker_seen == ["absent", False]

    def test_engine_bypass_leaves_breaker_untouched(self):
        """The real engine: a failing shadow-only batch is neither
        admitted through nor recorded by the breaker."""
        from wavetpu_torch.serve.engine import ServeEngine

        plan = faults.parse_serve_spec("serve-compile-fail:count=5")
        eng = ServeEngine(bucket_sizes=(1,), device="cpu",
                          breaker_threshold=1, fault_plan=plan)
        with pytest.raises(faults.InjectedFault):
            eng.solve(Problem(N=8, timesteps=4), [eb.LaneSpec()],
                      feed_breaker=False)
        assert eng.breaker.snapshot()["keys"] == []


def _post(base, body):
    req = urllib.request.Request(base + "/solve",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def _wait_shadow(state, n, timeout=300.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = state.shadow.snapshot()
        if snap["solves"] + snap["failures"] >= n:
            assert state.shadow.wait_idle(timeout)
            return snap
        time.sleep(0.05)
    raise AssertionError(f"shadow never resolved {n}: "
                         f"{state.shadow.snapshot()}")


def _serve(**kw):
    kw.setdefault("max_wait", 0.1)
    kw.setdefault("default_kernel", "roll")
    kw.setdefault("device", "cpu")
    httpd, state = build_server(port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, state):
    httpd.shutdown()
    state.batcher.close()
    httpd.server_close()


def _answer(raw):
    rep = json.loads(raw)["report"]
    return {k: rep[k] for k in ("problem", "final_step", "max_abs_error",
                                "abs_errors", "rel_errors")}


class TestServeShadowHTTP:
    def test_sampled_request_shadowed_and_ledgered(self, tmp_path):
        d = str(tmp_path / "tel")
        tel = telemetry.start(d, interval=60.0)
        httpd, state, base = _serve(shadow_sample_rate=1.0)
        try:
            code, body = _post(base, {"N": 8, "timesteps": 4,
                                      "fuse_steps": 2,
                                      "kernel": "pallas"})
            assert code == 200
            _wait_shadow(state, 1)
            metrics = _get(base, "/metrics")
            assert metrics["shadow"]["rate"] == 1.0
            assert metrics["shadow"]["solves"] == 1
            assert metrics["shadow"]["failures"] == 0
        finally:
            _stop(httpd, state)
            tel.stop()
        recs = accuracy.load_accuracy_ledger(
            os.path.join(d, accuracy.ACCURACY_FILENAME))
        shadows = [r for r in recs if r["source"] == "shadow"]
        assert len(shadows) == 1
        assert 0.0 <= shadows[0]["max_abs_err"] < 1e-3
        assert shadows[0]["plan"]["path"] == "kfused"
        assert len([r for r in recs if r["source"] == "oracle"]) >= 2

    def test_primary_bytes_unchanged_by_shadow(self):
        """The primary's answer is the same with and without a shadow:
        its answer fields equal, its states released as ever."""
        body = {"N": 8, "timesteps": 6, "fuse_steps": 2,
                "kernel": "pallas"}
        answers = []
        for rate in (1.0, 0.0):
            httpd, state, base = _serve(shadow_sample_rate=rate)
            try:
                code, raw = _post(base, body)
                assert code == 200
                answers.append(_answer(raw))
                if rate:
                    _wait_shadow(state, 1)
                    assert state.engine.keep_final_state is True
                else:
                    assert state.shadow is None
                    assert state.engine.keep_final_state is False
            finally:
                _stop(httpd, state)
        assert answers[0] == answers[1]

    def test_shadow_crash_invisible_to_primary_and_breaker(self):
        plan = faults.parse_serve_spec("serve-shadow-fail:count=1")
        httpd, state, base = _serve(shadow_sample_rate=1.0,
                                    fault_plan=plan)
        try:
            body = {"N": 8, "timesteps": 4}
            code1, p1 = _post(base, body)
            assert code1 == 200
            _wait_shadow(state, 1)
            m1 = _get(base, "/metrics")
            assert m1["shadow"]["failures"] == 1
            assert m1["shadow"]["solves"] == 0
            assert m1["breaker"]["open"] == 0 and m1["breaker"]["keys"] == []
            code2, p2 = _post(base, body)
            assert code2 == 200
            _wait_shadow(state, 2)
            assert _answer(p1) == _answer(p2)
            m2 = _get(base, "/metrics")
            assert m2["shadow"]["solves"] == 1
            assert m2["responses_error"] == 0
        finally:
            _stop(httpd, state)

    @pytest.mark.parametrize("body,reason", [
        ({"N": 8, "timesteps": 4, "scheme": "compensated"},
         "reference-plan"),
        ({"N": 8, "timesteps": 4, "mesh": [2, 1, 1]}, "mesh"),
    ])
    def test_ineligible_requests_not_shadowed(self, body, reason):
        httpd, state, base = _serve(shadow_sample_rate=1.0)
        try:
            code, _ = _post(base, body)
            assert code == 200
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                if state.shadow.snapshot()["skipped"]:
                    break
                time.sleep(0.05)
            metrics = _get(base, "/metrics")
            assert metrics["shadow"]["solves"] == 0
            assert metrics["shadow"]["skipped"] == {reason: 1}
        finally:
            _stop(httpd, state)
