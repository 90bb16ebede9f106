"""The port's result cache (serve/resultcache.py) and its replica hooks:
the replica half of wavetpu's tests/test_resultcache.py (TestResultKey,
TestResultCacheBounds, TestReplicaCacheHTTP, TestChaosDrills) on the CPU.
A hit is BYTE-IDENTICAL to the fresh answer and marches nothing;
`Cache-Control: no-cache` bypasses and is counted; corruption is a counted
miss that recomputes cleanly and never reaches the breaker; the entries'
fingerprint tag is the port's `env_fingerprint`.  The router's edge cache
comes with ROADMAP.md queue 1 item 12c.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from wavetpu_torch import progkey
from wavetpu_torch.kernels import stencil_cuda
from wavetpu_torch.run import faults
from wavetpu_torch.serve import progcache
from wavetpu_torch.serve.api import build_server
from wavetpu_torch.serve.resultcache import ResultCache


def _post_raw(base, body, headers=None):
    req = urllib.request.Request(
        base + "/solve", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _metrics_json(base):
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        return json.loads(r.read())


def _start_replica(**kw):
    kw.setdefault("max_wait", 0.02)
    kw.setdefault("default_kernel", "roll")
    kw.setdefault("device", "cpu")
    httpd, state = build_server(port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop_replica(httpd, state):
    httpd.shutdown()
    state.batcher.close(timeout=30.0, drain=False)
    httpd.server_close()


class TestResultKey:
    def test_answer_shaping_fields_change_the_key(self):
        base = progkey.result_key({"N": 8, "timesteps": 4},
                                  platform="cpu")
        for other in ({"phase": 1.0}, {"c2_field": "gaussian-lens"},
                      {"timesteps": 5}):
            assert base != progkey.result_key(
                dict({"N": 8, "timesteps": 4}, **other), platform="cpu")

    def test_key_is_encoding_order_invariant_and_wavetpus(self):
        from wavetpu import progkey as wprogkey

        a = progkey.result_key({"N": 8, "timesteps": 4, "k": 2},
                               platform="cpu")
        b = progkey.result_key({"k": 2, "timesteps": 4, "N": 8},
                               platform="cpu")
        assert a == b == wprogkey.result_key(
            {"N": 8, "timesteps": 4, "k": 2}, platform="cpu")

    def test_rejects_what_the_server_rejects(self):
        with pytest.raises(ValueError):
            progkey.result_key({"timesteps": 4}, platform="cpu")

    def test_eligibility_is_conservative(self):
        assert progkey.result_cache_eligible({"N": 8, "timesteps": 4})
        assert not progkey.result_cache_eligible(
            {"N": 8, "timesteps": 4, "resume_token": "tok"})
        assert not progkey.result_cache_eligible("not a dict")
        assert not progkey.result_cache_eligible(None)


class TestResultCacheBounds:
    def _cache(self, **kw):
        self.now = [0.0]
        kw.setdefault("clock", lambda: self.now[0])
        return ResultCache(**kw)

    def test_lru_evicts_oldest_when_over_bytes(self):
        c = self._cache(max_bytes=100, ttl_s=60.0)
        assert c.put("a", b"x" * 40)
        assert c.put("b", b"y" * 40)
        assert c.put("c", b"z" * 40)
        snap = c.snapshot()
        assert snap["entries"] == 2 and snap["bytes"] <= 100
        assert snap["events"]["evict_lru"] == 1
        assert c.get("a") is None
        assert c.get("b") is not None and c.get("c") is not None

    def test_hit_refreshes_lru_order(self):
        c = self._cache(max_bytes=100, ttl_s=60.0)
        c.put("a", b"x" * 40)
        c.put("b", b"y" * 40)
        assert c.get("a") is not None
        c.put("c", b"z" * 40)
        assert c.get("b") is None and c.get("a") is not None

    def test_oversized_payload_rejected_not_thrashed(self):
        c = self._cache(max_bytes=100, ttl_s=60.0)
        c.put("a", b"x" * 40)
        assert not c.put("big", b"z" * 200)
        assert c.get("a") is not None and c.snapshot()["entries"] == 1

    def test_ttl_expiry_is_a_counted_miss(self):
        c = self._cache(max_bytes=100, ttl_s=10.0)
        c.put("a", b"payload")
        self.now[0] = 11.0
        assert c.get("a") is None
        ev = c.snapshot()["events"]
        assert ev["evict_ttl"] == 1 and ev["miss"] == 1

    def test_fingerprint_drift_invalidates(self):
        fp = progcache.env_fingerprint("cpu")
        c = self._cache(max_bytes=100, ttl_s=60.0, fingerprint=fp)
        c.put("a", b"payload")
        assert c.get("a") is not None
        # An edited kernel source is such a drift.
        c.fingerprint = dict(fp, csrc_sha256="0" * 64)
        assert c.get("a") is None
        assert c.snapshot()["events"]["fingerprint_mismatch"] == 1

    def test_real_corruption_is_detected_and_dropped(self):
        c = self._cache(max_bytes=100, ttl_s=60.0)
        c.put("a", b"payload-bytes")
        with c._lock:
            c._entries["a"].payload = b"payload-bytEs"
        assert c.get("a") is None
        assert c.snapshot()["events"]["corrupt"] == 1


BODY = {"N": 8, "timesteps": 4}


class TestReplicaCacheHTTP:
    def test_hit_is_byte_identical_and_launches_nothing(self):
        httpd, state, base = _start_replica(result_cache=True)
        try:
            code, fresh, h1 = _post_raw(base, BODY)
            assert code == 200
            tag = progcache.fingerprint_tag(
                progcache.env_fingerprint("cpu"))
            assert h1.get("X-Wavetpu-Cache") == f"store;fp={tag}"
            batches = _metrics_json(base)["batches_total"]
            launches = dict(stencil_cuda.launches)
            code, cached, h2 = _post_raw(base, BODY)
            assert code == 200 and h2.get("X-Wavetpu-Cache") == "hit"
            assert cached == fresh
            assert "cache;desc=hit" in h2.get("Server-Timing", "")
            snap = _metrics_json(base)
            assert snap["batches_total"] == batches
            assert stencil_cuda.launches == launches
            assert snap["result_cache"]["events"]["hit"] == 1
        finally:
            _stop_replica(httpd, state)

    def test_no_cache_header_bypasses_and_recomputes(self):
        httpd, state, base = _start_replica(result_cache=True)
        try:
            assert _post_raw(base, BODY)[0] == 200
            batches = _metrics_json(base)["batches_total"]
            code, _, h = _post_raw(base, BODY,
                                   headers={"Cache-Control": "no-cache"})
            assert code == 200 and h.get("X-Wavetpu-Cache") != "hit"
            snap = _metrics_json(base)
            assert snap["batches_total"] == batches + 1
            assert snap["result_cache"]["events"]["bypass"] == 1
        finally:
            _stop_replica(httpd, state)

    def test_cache_off_by_default(self):
        httpd, state, base = _start_replica()
        try:
            for _ in range(2):
                code, _, h = _post_raw(base, BODY)
                assert code == 200 and "X-Wavetpu-Cache" not in h
            assert "result_cache" not in _metrics_json(base)
        finally:
            _stop_replica(httpd, state)

    def test_singleflight_collapses_concurrent_identicals(self):
        httpd, state, base = _start_replica(result_cache=True,
                                            max_wait=0.3)
        try:
            results = []
            lock = threading.Lock()

            def worker():
                out = _post_raw(base, BODY)
                with lock:
                    results.append(out)

            threads = [threading.Thread(target=worker)]
            threads[0].start()
            time.sleep(0.1)
            for _ in range(4):
                t = threading.Thread(target=worker)
                t.start()
                threads.append(t)
            for t in threads:
                t.join(120)
            assert len(results) == 5
            assert all(code == 200 for code, _, _ in results)
            assert len({bytes(body) for _, body, _ in results}) == 1
            assert sum(1 for _, _, h in results
                       if h.get("X-Wavetpu-Cache") == "coalesced") == 4
            snap = _metrics_json(base)
            assert snap["batches_total"] == 1
            assert snap["coalesced_total"] == 4
            assert snap["requests_total"] == 5
        finally:
            _stop_replica(httpd, state)

    def test_chunked_and_resumed_answers(self, tmp_path):
        """A chunked long solve's answer is cached like any full solve; a
        resume-token request is never cached."""
        httpd, state, base = _start_replica(
            result_cache=True, chunk_threshold=8, chunk_steps=4,
            solve_state_dir=str(tmp_path / "s"))
        try:
            body = {"N": 8, "timesteps": 17}
            code, fresh, h1 = _post_raw(base, body)
            assert code == 200 and json.loads(fresh)["batch"]["chunked"]
            code, hit, h2 = _post_raw(base, body)
            assert h2.get("X-Wavetpu-Cache") == "hit" and hit == fresh
            code, _, h3 = _post_raw(base, dict(body,
                                               resume_token="0" * 64))
            assert code == 422 and "X-Wavetpu-Cache" not in h3
        finally:
            _stop_replica(httpd, state)


class TestChaosDrills:
    @pytest.mark.parametrize("kind,event", [
        ("resultcache-corrupt", "corrupt"),
        ("resultcache-stale-fingerprint", "fingerprint_mismatch"),
    ])
    def test_corruption_recomputes_cleanly(self, kind, event):
        plan = faults.parse_serve_spec(f"serve-{kind}:count=1")
        httpd, state, base = _start_replica(result_cache=True,
                                            fault_plan=plan)
        try:
            code, fresh, _ = _post_raw(base, BODY)
            assert code == 200
            code, recomputed, h = _post_raw(base, BODY)
            assert code == 200 and h.get("X-Wavetpu-Cache") != "hit"

            def answer(raw):
                rep = json.loads(raw)["report"]
                return {k: rep[k] for k in (
                    "problem", "final_step", "max_abs_error",
                    "abs_errors", "rel_errors")}

            assert answer(recomputed) == answer(fresh)
            snap = _metrics_json(base)
            ev = snap["result_cache"]["events"]
            assert ev[event] == 1 and ev["miss"] >= 1
            assert snap["breaker"]["open"] == 0
            assert snap["breaker"]["keys"] == []
            code, again, h = _post_raw(base, BODY)
            assert code == 200 and h.get("X-Wavetpu-Cache") == "hit"
            assert again == recomputed
        finally:
            _stop_replica(httpd, state)
