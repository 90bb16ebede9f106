"""The port's serving replica over HTTP on the CPU (the intent of
wavetpu's tests/test_serve.py TestHTTP, TestDistributedTracingServe and
TestCLI): concurrent /solve requests coalesce into one batch with their
own reports, /healthz liveness and readiness, /metrics in JSON, Prometheus
and OpenMetrics, Server-Timing, request ids and traceparent, 400 / 404 /
413 / 422 / 429 / 503, the watchdog's per-lane 422, and the entry points.
The features of ROADMAP.md queue 1 items 12b and 12c answer 400 / exit 2
naming their item.  wavetpu's load-generator helpers read the port's
headers and /healthz as they read wavetpu's.

Every server a test starts is shut down in its teardown; every HTTP call
and future wait has a timeout.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from tests.test_obs import parse_prometheus
from wavetpu_torch.serve.api import build_server

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve(**kw):
    kw.setdefault("default_kernel", "roll")
    kw.setdefault("device", "cpu")
    httpd, state = build_server(port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, state):
    httpd.shutdown()
    state.batcher.close()
    httpd.server_close()


@pytest.fixture()
def server():
    httpd, state, base = _serve(max_wait=0.5)
    yield base, state
    _stop(httpd, state)


def _post(base, body, timeout=120):
    code, payload, _headers = _post_full(base, body, timeout=timeout)
    return code, payload


def _post_full(base, body, timeout=120, headers=None):
    req = urllib.request.Request(
        base + "/solve", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.status, json.loads(r.read())


class TestHTTP:
    def test_concurrent_requests_coalesce_with_own_reports(self, server):
        base, state = server
        results = [None] * 4
        phases = [6.283, 1.0, 0.5, 0.25]

        def worker(i):
            results[i] = _post(
                base, {"N": 8, "timesteps": 4, "phase": phases[i]}
            )

        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(4)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        errs = set()
        for code, body in results:
            assert code == 200
            assert body["status"] == "ok"
            assert body["batch"]["occupancy"] > 1
            assert body["report"]["final_step"] == 4
            assert len(body["report"]["abs_errors"]) == 5
            assert "grids initialized in" in body["report_text"]
            errs.add(body["report"]["max_abs_error"])
        # four distinct phases -> four distinct per-request reports
        assert len(errs) == 4
        code, metrics = _get(base, "/metrics")
        assert code == 200
        assert metrics["batch_occupancy_max"] > 1
        assert metrics["requests_total"] == 4
        assert metrics["responses_ok"] == 4
        assert metrics["aggregate_gcells_per_s"] is not None
        assert metrics["latency_p50_ms"] is not None
        assert metrics["program_cache"]["programs"] >= 1

    def test_healthz(self, server):
        base, _ = server
        code, body = _get(base, "/healthz")
        assert code == 200
        assert body["status"] == "ok"

    def test_healthz_memory_fields(self, server):
        """Device-memory visibility: both fields present and unit-pinned
        in the name (`_bytes`); None exactly when the backend has no
        memory_stats() (the CPU backend CI runs on), else non-negative
        ints."""
        base, _ = server
        code, body = _get(base, "/healthz")
        assert code == 200
        assert "memory_bytes_in_use" in body
        assert "memory_peak_bytes" in body
        for field in ("memory_bytes_in_use", "memory_peak_bytes"):
            v = body[field]
            assert v is None or (isinstance(v, int) and v >= 0)
        # Both sides of the contract agree: None iff the probe says
        # unsupported.
        from wavetpu_torch.obs import perf

        snap = perf.memory_snapshot()
        assert (body["memory_bytes_in_use"] is None) == (snap is None)

    def test_healthz_liveness_vs_readiness(self, server):
        """The readiness split: `status: ok` = the process serves HTTP;
        `ready` = route traffic here - false while the warmup compile
        runs or once draining is set, so a load balancer pulls the
        replica BEFORE drain starts failing requests.  The loadgen
        preflight refuses a not-ready target the same way."""
        from wavetpu.loadgen import runner as lg_runner

        base, state = server
        code, body = _get(base, "/healthz")
        assert code == 200
        assert body["ready"] is True and body["warming"] is False
        state.warming = True
        try:
            code, body = _get(base, "/healthz")
            assert body["status"] == "ok"  # alive...
            assert body["ready"] is False  # ...but do not route yet
            with pytest.raises(lg_runner.PreflightError,
                               match="not ready"):
                lg_runner.preflight(base)
        finally:
            state.warming = False
        state.draining = True
        try:
            code, body = _get(base, "/healthz")
            assert body["ready"] is False and body["draining"] is True
        finally:
            state.draining = False
        assert _get(base, "/healthz")[1]["ready"] is True

    def test_429_and_503_carry_retry_after(self):
        httpd, state = build_server(
            port=0, max_wait=0.1, default_kernel="roll",
            device="cpu", max_queue=0,
        )
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, body, headers = _post_full(
                base, {"N": 8, "timesteps": 4}
            )
            assert code == 429
            assert headers.get("Retry-After") is not None
            assert body["retriable"] is True
            state.draining = True
            code, body, headers = _post_full(
                base, {"N": 8, "timesteps": 4}
            )
            assert code == 503
            assert headers.get("Retry-After") is not None
            assert body["retriable"] is True
        finally:
            state.draining = False
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    def test_metrics_json_carries_breaker_block(self, server):
        base, _ = server
        code, snap = _get(base, "/metrics")
        assert code == 200
        assert snap["breaker"]["enabled"] is True
        assert snap["breaker"]["open"] == 0

    def test_healthz_idle_vs_wedged_fields(self, server):
        # The load-balancer discriminator fields: uptime, draining, and
        # last-batch age (null while idle, a number after traffic).
        base, state = server
        code, body = _get(base, "/healthz")
        assert code == 200
        assert body["uptime_seconds"] >= 0
        assert body["draining"] is False
        assert body["last_batch_age_seconds"] is None
        _post(base, {"N": 8, "timesteps": 4})
        code, body = _get(base, "/healthz")
        assert body["last_batch_age_seconds"] is not None
        assert body["last_batch_age_seconds"] >= 0
        state.draining = True
        try:
            code, body = _get(base, "/healthz")
            assert body["draining"] is True
        finally:
            state.draining = False

    def test_metrics_prometheus_text_negotiated(self, server):
        base, state = server
        _post(base, {"N": 8, "timesteps": 4})
        req = urllib.request.Request(
            base + "/metrics", headers={"Accept": "text/plain"}
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        samples, types = parse_prometheus(text)
        assert samples["wavetpu_serve_requests_total"] >= 1
        assert types["wavetpu_serve_request_seconds"] == "histogram"
        assert samples["wavetpu_serve_request_seconds_count"] >= 1
        # engine metrics share the server registry (build_server wiring)
        assert samples['wavetpu_program_cache_events_total{event="miss"}'] \
            >= 1
        # the same cut agrees with the JSON view
        code, snap = _get(base, "/metrics")
        assert code == 200
        assert snap["requests_total"] == \
            samples["wavetpu_serve_requests_total"]
        # default Accept still gets the historical JSON shape
        assert "program_cache" in snap

    def test_request_and_batch_spans_join_on_request_id(
        self, server, tmp_path
    ):
        from wavetpu_torch.obs import report as obs_report
        from wavetpu_torch.obs import tracing

        base, _ = server
        path = str(tmp_path / "trace.jsonl")
        tracing.configure(path)
        try:
            code, body = _post(base, {"N": 8, "timesteps": 4})
            assert code == 200
        finally:
            tracing.disable()
        recs = [json.loads(line) for line in open(path)]
        reqs = [r for r in recs if r["kind"] == "serve.request"]
        batches = [r for r in recs if r["kind"] == "serve.batch"]
        assert len(reqs) == 1 and len(batches) == 1
        rid = reqs[0]["attrs"]["request_id"]
        assert rid in batches[0]["attrs"]["request_ids"]
        assert reqs[0]["attrs"]["status"] == 200
        assert batches[0]["attrs"]["padding_lanes"] == 0
        # execute (and on first contact compile) spans nest under batch
        execs = [r for r in recs if r["kind"] == "serve.execute"]
        assert execs and execs[0]["parent_id"] == batches[0]["span_id"]
        # trace-report stitches the critical path from the id
        view = obs_report.request_view(recs, rid)
        kinds = {r["kind"] for r in view}
        assert {"serve.request", "serve.batch", "serve.execute"} <= kinds

    def test_server_timing_components_sum_to_total(self, server):
        """Acceptance: every /solve response carries Server-Timing whose
        additive components (queue + compile + execute) sum to within
        10% of the server-measured wall (`total`), and the per-request
        timing rides the JSON batch context too."""
        from wavetpu.loadgen.runner import parse_server_timing

        base, _ = server
        for i in range(2):  # first contact (cold compile) AND warm
            t0 = time.monotonic()
            code, body, headers = _post_full(
                base, {"N": 8, "timesteps": 4, "phase": 1.0 + i}
            )
            client_wall = time.monotonic() - t0
            assert code == 200
            timing = parse_server_timing(headers.get("Server-Timing"))
            assert set(timing) == {
                "queue", "compile", "execute", "padding", "total"
            }
            additive = timing["queue"] + timing["compile"] + \
                timing["execute"]
            # components ~= the server-measured wall (parse/serialize
            # overhead is the slack; 10% + a tiny absolute epsilon for
            # the CI-scale solves where total is single-digit ms)
            assert abs(additive - timing["total"]) <= \
                0.1 * timing["total"] + 0.010
            # server total never exceeds what the client measured
            assert timing["total"] <= client_wall + 0.010
            # padding is a subset-of-execute attribution
            assert timing["padding"] <= timing["execute"] + 1e-9
            # and the same attribution is in the JSON batch context
            jt = body["batch"]["timing"]
            assert jt["compile_s"] == pytest.approx(
                timing["compile"], abs=1e-4
            )
        # the cold/warm split is visible: first request compiled,
        # second hit the cache
        assert body["batch"]["warm"] == "true"

    def test_request_id_echoed_and_client_id_wins(self, server):
        base, _ = server
        # client-minted id is echoed verbatim
        code, _body, headers = _post_full(
            base, {"N": 8, "timesteps": 4},
            headers={"X-Request-Id": "lg-abc-7"},
        )
        assert code == 200
        assert headers.get("X-Request-Id") == "lg-abc-7"
        # junk ids (bad chars / over-long) are dropped, not reflected
        junk = 'evil"id with spaces' + "x" * 80
        code, _body, headers = _post_full(
            base, {"N": 8, "timesteps": 4},
            headers={"X-Request-Id": junk},
        )
        assert code == 200
        assert headers.get("X-Request-Id") != junk

    def test_client_request_id_tags_server_spans(self, server, tmp_path):
        """The loadgen join contract: a client-supplied X-Request-Id is
        THE request_id on the server's trace spans, so a report outlier
        resolves via `wavetpu trace-report --request ID`."""
        from wavetpu_torch.obs import report as obs_report
        from wavetpu_torch.obs import tracing

        base, _ = server
        path = str(tmp_path / "trace.jsonl")
        tracing.configure(path)
        try:
            code, _, headers = _post_full(
                base, {"N": 8, "timesteps": 4},
                headers={"X-Request-Id": "lg-join-1"},
            )
            assert code == 200
        finally:
            tracing.disable()
        recs = [json.loads(line) for line in open(path)]
        view = obs_report.request_view(recs, "lg-join-1")
        kinds = {r["kind"] for r in view}
        assert {"serve.request", "serve.batch", "serve.execute"} <= kinds

    def test_metrics_openmetrics_exemplars_negotiated(self, server):
        base, _ = server
        _post_full(base, {"N": 8, "timesteps": 4},
                   headers={"X-Request-Id": "lg-ex-1"})
        req = urllib.request.Request(
            base + "/metrics",
            headers={"Accept": "application/openmetrics-text"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith(
                "application/openmetrics-text"
            )
            text = r.read().decode()
        samples, _types, exemplars = parse_prometheus(
            text, with_exemplars=True
        )
        assert text.rstrip().endswith("# EOF")
        # the latency histogram carries the request id as an exemplar
        latency_ex = [
            ex for name, ex in exemplars.items()
            if name.startswith("wavetpu_serve_request_seconds_bucket")
        ]
        assert any(
            ex["labels"].get("request_id") == "lg-ex-1"
            for ex in latency_ex
        )
        # plain text/plain stays exemplar-free (0.0.4 parsers)
        req = urllib.request.Request(
            base + "/metrics", headers={"Accept": "text/plain"}
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            plain = r.read().decode()
        assert " # " not in plain and "# EOF" not in plain

    def test_malformed_content_length_gets_400(self, server):
        """A junk Content-Length header must produce a 400 JSON error,
        not an unhandled handler exception (dropped connection)."""
        import socket

        base, _ = server
        host, port = base.replace("http://", "").split(":")
        with socket.create_connection((host, int(port)), timeout=30) as s:
            s.sendall(
                b"POST /solve HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: abc\r\n\r\n"
            )
            data = s.recv(65536)
        status_line = data.split(b"\r\n", 1)[0]
        assert b" 400 " in status_line + b" "
        assert b"Content-Length" in data
        # A NEGATIVE length must 400 too - rfile.read(-1) would block
        # to EOF and pin the handler thread forever (thread-exhaustion
        # DoS), so it is the same malformed-header case.
        with socket.create_connection((host, int(port)), timeout=30) as s:
            s.sendall(
                b"POST /solve HTTP/1.1\r\nHost: x\r\n"
                b"Content-Length: -1\r\n\r\n"
            )
            data = s.recv(65536)
        assert b" 400 " in data.split(b"\r\n", 1)[0] + b" "

    def test_max_body_bytes_413(self):
        httpd, state = build_server(
            port=0, max_wait=0.1, default_kernel="roll",
            device="cpu", max_body_bytes=64,
        )
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            big = {"N": 8, "timesteps": 4, "pad": "x" * 500}
            code, body, _ = _post_full(base, big)
            assert code == 413
            assert "max-body-bytes" in body["error"]
            code, snap = _get(base, "/metrics")
            assert snap["limit_rejected_total"] == 1
            # and in the Prometheus view, labeled by limit
            samples, _ = parse_prometheus(
                state.metrics.registry.render_prometheus()
            )
            assert samples[
                'wavetpu_serve_limit_rejected_total{limit="body_bytes"}'
            ] == 1
            # a small request still serves
            code, _, _ = _post_full(base, {"N": 8, "timesteps": 4})
            assert code == 200
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    def test_max_lane_cells_422_before_scheduling(self):
        httpd, state = build_server(
            port=0, max_wait=0.1, default_kernel="roll",
            device="cpu", max_lane_cells=1000,  # (N+1)^3 <= 1000
        )
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, body, _ = _post_full(base, {"N": 16, "timesteps": 4})
            assert code == 422
            assert "max-lane-cells" in body["error"]
            code, snap = _get(base, "/metrics")
            assert snap["limit_rejected_total"] == 1
            # nothing reached the scheduler
            assert snap["batches_total"] == 0
            code, _, _ = _post_full(base, {"N": 8, "timesteps": 4})
            assert code == 200  # 9^3 = 729 <= 1000
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    def test_queue_full_returns_429(self):
        httpd, state = build_server(
            port=0, max_wait=0.1, default_kernel="roll",
            device="cpu", max_queue=0,
        )
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            code, body = _post(base, {"N": 8, "timesteps": 4})
            assert code == 429
            assert "queue full" in body["error"]
            code, snap = _get(base, "/metrics")
            assert snap["rejected_total"] == 1
            assert snap["responses_error"] == 1
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    def test_draining_returns_503(self, server):
        base, state = server
        state.draining = True
        try:
            code, body = _post(base, {"N": 8, "timesteps": 4})
            assert code == 503
            assert "draining" in body["error"]
        finally:
            state.draining = False

    def test_metrics_exposes_vmap_probes(self, server):
        base, _ = server
        _post(base, {"N": 8, "timesteps": 4})
        code, metrics = _get(base, "/metrics")
        assert code == 200
        probes = metrics["program_cache"]["vmap_probes"]
        assert any(p.get("path") == "roll" and p["ok"] for p in probes)

    def test_mesh_request_serves_sharded_batched(self, server):
        base, _ = server
        code, body = _post(
            base, {"N": 8, "timesteps": 4, "mesh": [2, 2, 1],
                   "phase": 1.0}, timeout=300,
        )
        assert code == 200
        assert body["batch"]["batched"] is True
        assert "sharded(2, 2, 1)" in body["batch"]["path"]
        assert body["report"]["final_step"] == 4

    def test_bad_request_400(self, server):
        base, _ = server
        code, body = _post(base, {"timesteps": 4})
        assert code == 400
        assert "N" in body["error"]

    def test_unknown_route_404(self, server):
        base, _ = server
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert ei.value.code == 404

    def test_watchdog_poisoned_request_422_batchmate_ok(self, server):
        base, _ = server
        results = [None] * 2
        bodies = [
            {"N": 8, "T": 26.0, "timesteps": 60, "c2_field": "constant"},
            {"N": 8, "T": 26.0, "timesteps": 60, "c2_field": "two-layer"},
        ]

        def worker(i):
            results[i] = _post(base, bodies[i], timeout=300)

        threads = [
            threading.Thread(target=worker, args=(i,)) for i in range(2)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        codes = sorted(r[0] for r in results)
        assert codes == [200, 422]
        bad = next(b for c, b in results if c == 422)
        assert "amax" in bad["error"]
        ok = next(b for c, b in results if c == 200)
        # a field request serves without the analytic oracle
        assert ok["report"]["errors_computed"] is False
        assert ok["report"]["max_abs_error"] is None


class TestDistributedTracingServe:
    """The replica's half of the fleet trace contract (wavetpu's
    docs/observability.md "Distributed tracing"): traceparent echoed on
    every /solve answer, inbound context adopted as the remote parent of
    serve.request.  (The chunk-march gauge and checkpointed trace context
    come with the preemptible long solves, ROADMAP.md queue 1 item
    12b.)"""

    @staticmethod
    def _lower(headers):
        return {k.lower(): v for k, v in headers.items()}

    def test_untraced_replica_reflects_inbound_verbatim(self, server):
        base, _state = server
        tp = "00-" + "ab" * 16 + "-" + "12" * 8 + "-01"
        code, _body, hdrs = _post_full(
            base, {"N": 8, "timesteps": 3}, headers={"traceparent": tp}
        )
        assert code == 200
        # untraced tier: the join handle still answers - the inbound
        # header comes back untouched
        assert self._lower(hdrs).get("traceparent") == tp

    def test_untraced_replica_without_inbound_sends_no_header(
        self, server
    ):
        base, _state = server
        code, _body, hdrs = _post_full(base, {"N": 8, "timesteps": 3})
        assert code == 200
        assert "traceparent" not in self._lower(hdrs)

    def test_untraced_replica_drops_malformed_inbound(self, server):
        base, _state = server
        code, _body, hdrs = _post_full(
            base, {"N": 8, "timesteps": 3},
            headers={"traceparent": "00-nothex-11-01"},
        )
        assert code == 200
        assert "traceparent" not in self._lower(hdrs)

    def test_traced_replica_adopts_inbound_and_echoes_own_context(
        self, tmp_path
    ):
        from wavetpu_torch.obs import tracing
        trace_path = str(tmp_path / "trace.jsonl")
        tracing.configure(trace_path)
        httpd, state = build_server(
            port=0, max_wait=0.05, default_kernel="roll", device="cpu"
        )
        threading.Thread(
            target=httpd.serve_forever, daemon=True
        ).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        tid, wire = "ab" * 16, "12" * 8
        try:
            code, _body, hdrs = _post_full(
                base, {"N": 8, "timesteps": 3},
                headers={"traceparent": f"00-{tid}-{wire}-01"},
            )
            assert code == 200
            echoed = tracing.parse_traceparent(
                self._lower(hdrs)["traceparent"]
            )
            # traced tier overwrites the echo with its OWN context:
            # same fleet trace id, fresh wire span id
            assert echoed is not None
            assert echoed[0] == tid
            assert echoed[1] != wire
            # no inbound context: a fresh trace id is minted
            code, _body, hdrs2 = _post_full(
                base, {"N": 8, "timesteps": 3}
            )
            assert code == 200
            fresh = tracing.parse_traceparent(
                self._lower(hdrs2)["traceparent"]
            )
            assert fresh is not None and fresh[0] != tid
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()
            tracing.disable()
        recs = [json.loads(l) for l in open(trace_path)]
        adopted = [
            r for r in recs
            if r.get("kind") == "serve.request"
            and r.get("trace_id") == tid
        ]
        assert len(adopted) == 1
        # the inbound wire id IS the remote parent, and the span
        # advertises the echoed wire id for the cross-process joiner
        assert adopted[0]["parent_id"] == wire
        assert adopted[0]["attrs"]["w3c_id"] == echoed[1]


class TestTenant:
    def test_tenant_header_lands_in_metrics(self, tmp_path):
        httpd, state, base = _serve(max_wait=0.05)
        try:
            code, _, _ = _post_full(
                base, {"N": 8, "timesteps": 3},
                headers={"X-Wavetpu-Tenant": "acme"},
            )
            assert code == 200
            req = urllib.request.Request(
                base + "/metrics", headers={"Accept": "text/plain"}
            )
            with urllib.request.urlopen(req, timeout=30) as r:
                text = r.read().decode()
            samples, _types = parse_prometheus(text)
            assert samples[
                'wavetpu_serve_tenant_requests_total{tenant="acme"}'
            ] == 1.0
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()


class TestNotPortedYet:
    """ROADMAP.md queue 1 items 12b (program cache, preemptible long
    solves, result cache, shadow solves) and 12c (router, fleet, load
    generator traces): refused by name, never half-served."""

    def test_resume_token_400_names_item_12b(self, server):
        base, _ = server
        code, body = _post(base, {"N": 8, "timesteps": 3,
                                  "resume_token": "0" * 64})
        assert code == 400
        assert "queue 1 item 12b" in body["error"]

    @pytest.mark.parametrize("flag,item", [
        (["--program-cache-dir", "d"], "12b"),
        (["--program-cache-max-bytes", "9"], "12b"),
        (["--warmup-manifest", "m.json"], "12b"),
        (["--chunk-threshold", "64"], "12b"),
        (["--chunk-steps", "8"], "12b"),
        (["--solve-state-dir", "s"], "12b"),
        (["--solve-state-ttl-s", "5"], "12b"),
        (["--result-cache"], "12b"),
        (["--result-cache-max-bytes", "9"], "12b"),
        (["--result-cache-ttl-s", "5"], "12b"),
        (["--shadow-sample-rate", "0.5"], "12b"),
        (["--shadow-deadline-s", "5"], "12b"),
        (["--record-trace", "t.jsonl"], "12c"),
    ])
    def test_serve_flags_exit_2_naming_their_item(self, flag, item,
                                                   capsys):
        from wavetpu_torch.serve.api import main

        assert main(flag + ["--platform", "cpu", "--port", "0"]) == 2
        err = capsys.readouterr().err
        assert "not ported yet" in err and f"queue 1 item {item}" in err


class TestCLI:
    def test_serve_version(self, capsys):
        from wavetpu_torch import __version__
        from wavetpu_torch.cli import main

        assert main(["serve", "--version"]) == 0
        out = capsys.readouterr().out
        assert "wavetpu-torch-serve" in out and __version__ in out

    def test_console_script_is_the_serve_entry_point(self, capsys):
        import importlib
        import tomllib

        with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
            scripts = tomllib.load(f)["project"]["scripts"]
        module, _, func = scripts["wavetpu-torch-serve"].partition(":")
        entry = getattr(importlib.import_module(module), func)
        assert entry(["--version"]) == 0
        assert "wavetpu-torch-serve" in capsys.readouterr().out

    def test_serve_rejects_unknown_flag(self, capsys):
        from wavetpu_torch.cli import main

        assert main(["serve", "--frobnicate", "1"]) == 2

    def test_serve_rejects_malformed_warmup(self, capsys):
        from wavetpu_torch.serve.api import main

        assert main(["--warmup", "8x4", "--platform", "cpu"]) == 2
        assert "usage" in capsys.readouterr().err
        assert main(["--warmup", "8,4,2,9", "--platform", "cpu"]) == 2
        assert "--warmup wants" in capsys.readouterr().err

    def test_serve_rejects_malformed_breaker_and_platform_flags(self):
        from wavetpu_torch.serve.api import main

        assert main(["--breaker-threshold", "x"]) == 2
        assert main(["--breaker-cooldown-s", "y"]) == 2
        assert main(["--platform", "tpu"]) == 2

    def test_without_cuda_serve_exits_2_unless_cpu_asked(self, capsys):
        import torch

        from wavetpu_torch.cli import main

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: serve runs on it")
        assert main(["serve", "--port", "0"]) == 2
        assert "no CUDA device" in capsys.readouterr().err

    def test_serve_main_crash_stops_telemetry(self, tmp_path,
                                              monkeypatch):
        """A crash at the accept loop after telemetry started must not
        leak the heartbeat daemon or leave the process tracer bound."""
        from http.server import ThreadingHTTPServer

        from wavetpu_torch.obs import tracing
        from wavetpu_torch.serve.api import main

        def boom(self, *a, **kw):
            raise RuntimeError("injected accept-loop failure")

        monkeypatch.setattr(ThreadingHTTPServer, "serve_forever", boom)
        with pytest.raises(RuntimeError, match="injected"):
            main(["--port", "0", "--platform", "cpu",
                  "--telemetry-dir", str(tmp_path / "tel")])
        assert not tracing.enabled()
        assert (tmp_path / "tel" / "heartbeat.jsonl").exists()

    def test_python_m_serve_answers_then_drains_on_sigterm(self, tmp_path):
        """`python -m wavetpu_torch serve --platform cpu --port 0 --warmup
        8,3`: /healthz (ready once warm), /solve and /metrics answer;
        SIGTERM drains and exits 0."""
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.Popen(
            [sys.executable, "-m", "wavetpu_torch", "serve", "--platform",
             "cpu", "--port", "0", "--warmup", "8,3"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            base = None
            deadline = time.monotonic() + 60
            while base is None and time.monotonic() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                if "serve on http://" in line:
                    base = line.split(" on ")[1].split()[0]
            assert base, proc.stderr.read()
            for _ in range(200):
                if _get(base, "/healthz")[1]["ready"]:
                    break
                time.sleep(0.05)
            code, health = _get(base, "/healthz")
            assert health["ready"] is True and health["backend"] == "cpu"
            code, body = _post(base, {"N": 8, "timesteps": 3}, timeout=60)
            assert code == 200 and body["batch"]["path"] == "roll"
            assert body["batch"]["warm"] == "true"  # --warmup built it
            code, snap = _get(base, "/metrics")
            assert snap["responses_ok"] == 1
            proc.send_signal(signal.SIGTERM)
            out, err = proc.communicate(timeout=60)
            assert proc.returncode == 0, err
            assert "shut down cleanly" in out
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=10)


def test_trace_report_request_view_through_the_cli(tmp_path, capsys):
    """`python -m wavetpu_torch trace-report TRACE --request ID` prints
    the request's critical path: the handler's serve.request span joined
    to the worker's serve.batch / serve.execute spans."""
    from wavetpu_torch import cli
    from wavetpu_torch.obs import tracing

    path = str(tmp_path / "trace.jsonl")
    tracing.configure(path)
    httpd, state, base = _serve(max_wait=0.05)
    try:
        code, _, headers = _post_full(base, {"N": 8, "timesteps": 3},
                                      headers={"X-Request-Id": "rq-7"})
        assert code == 200 and headers["X-Request-Id"] == "rq-7"
    finally:
        _stop(httpd, state)
        tracing.disable()
    capsys.readouterr()
    assert cli.main(["trace-report", path, "--request", "rq-7"]) == 0
    out = capsys.readouterr().out
    assert "critical path of request rq-7" in out
    for kind in ("serve.request", "serve.batch", "serve.execute"):
        assert kind in out
