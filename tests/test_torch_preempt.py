"""Preemptible long solves in the port (serve/preempt.py, the scheduler's
chunked march): the intent of wavetpu's tests/test_serve.py
TestPreemptible and TestPreemptibleHTTP, on the CPU (the kernels' plain
versions).

 * chunked == monolithic bit for bit on roll, pallas and kfused, and
   within the XLA-CPU FMA tolerance of wavetpu's chunked serve (ROADMAP.md
   queue 3);
 * deadline, drain and worker-crash preemption resume bit for bit;
 * token hygiene: forged, corrupt, unknown, mismatched and expired tokens
   are clean 422s, and the breaker never hears of them;
 * the token file is wavetpu's: a token written by either package's
   `SolveStateStore` resumes in the other;
 * a chunked march's state is freed when its request resolves.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.run import faults
from wavetpu_torch.serve import preempt
from wavetpu_torch.serve.api import build_server
from wavetpu_torch.serve.engine import ServeEngine
from wavetpu_torch.serve.preempt import SolveStateStore
from wavetpu_torch.serve.resilience import (
    DeadlineExceededError,
    InvalidStateTokenError,
    PreemptedError,
)
from wavetpu_torch.serve.scheduler import DynamicBatcher, SolveRequest

THRESHOLD = 8
CHUNK = 4
# ROADMAP.md queue 3: XLA-CPU contracts multiply-adds the port rounds twice.
FMA_TOL = 1e-5


def _req(p, path="roll", k=1, **kw):
    return SolveRequest(problem=p, lane=eb.LaneSpec(), path=path, k=k, **kw)


def _bitwise(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def eng():
    # One CPU engine for the module: the chunk runners build once.
    return ServeEngine(bucket_sizes=(1,), device="cpu")


def _batcher(eng, store=None, plan=None, max_wait=0.02):
    return DynamicBatcher(
        eng, max_wait=max_wait, fault_plan=plan,
        chunk_threshold=THRESHOLD, chunk_steps=CHUNK, state_store=store,
    )


def _control(eng, p, path="roll", k=1):
    """The unpreempted chunked march (the drills' parity baseline)."""
    b = _batcher(eng)
    try:
        return b.submit(_req(p, path, k)).result(120)
    finally:
        b.close()


def _preempt_by_deadline(eng, store, p):
    """A chunked march the deadline expires mid-flight (a slow-chunk
    injection stretches it deterministically) -> its token."""
    plan = faults.parse_serve_spec(
        f"serve-slow-batch:seconds=0.25,timesteps={p.timesteps}")
    b = _batcher(eng, store=store, plan=plan)
    try:
        fut = b.submit(_req(p), deadline=time.monotonic() + 0.4)
        with pytest.raises(DeadlineExceededError) as ei:
            fut.result(120)
        assert b.metrics.snapshot()["preempted_total"] == 1
        assert b.chunk_state_bytes() == 0  # freed once the token is out
        return ei.value.resume_token
    finally:
        b.close()


def _resume(eng, store, p, token):
    b = _batcher(eng, store=store)
    try:
        res, health, info = b.submit(
            SolveRequest(problem=p, lane=eb.LaneSpec(), resume_token=token)
        ).result(120)
        assert health is None and info["resumed_from"] >= 1
        assert b.metrics.snapshot()["resumed_total"] == 1
        return res, info
    finally:
        b.close()


class TestChunkedEqualsMonolithic:
    @pytest.mark.parametrize("path,k,n,steps,chunks", [
        ("roll", 1, 8, 17, 4),
        ("pallas", 1, 8, 17, 4),
        ("kfused", 4, 8, 18, 5),
    ])
    def test_bitwise(self, eng, path, k, n, steps, chunks):
        """The chunked march (bootstrap to layer 1 + chunks on the k-block
        grid) answers every error of the monolithic serve answer bit for
        bit (the final layer: the next test)."""
        p = Problem(N=n, timesteps=steps)
        res, health, info = _control(eng, p, path, k)
        assert health is None
        assert info["chunked"] is True and info["chunks"] == chunks
        assert info["chunk_len"] == CHUNK and info["resumed_from"] is None
        assert res.final_step == p.timesteps
        eng.keep_final_state = True
        try:
            mono, mono_health = eng.solve(p, [eb.LaneSpec()], path=path,
                                          k=k)
        finally:
            eng.keep_final_state = False
        assert mono_health == [None]
        # The engine's release keeps no u_cur unless asked; the chunked
        # answer neither.
        assert res.u_cur is None and res.u_prev is None
        assert _bitwise(res.abs_errors, mono.results[0].abs_errors)
        assert _bitwise(res.rel_errors, mono.results[0].rel_errors)

    @pytest.mark.parametrize("path,k", [("roll", 1), ("kfused", 4)])
    def test_final_layer_bitwise_with_kept_state(self, path, k):
        eng = ServeEngine(bucket_sizes=(1,), device="cpu")
        eng.keep_final_state = True
        p = Problem(N=8, timesteps=18)
        res, _, _ = _control(eng, p, path, k)
        mono, _ = eng.solve(p, [eb.LaneSpec()], path=path, k=k)
        assert _bitwise(res.u_cur, mono.results[0].u_cur)

    def test_short_requests_stay_on_the_batched_path(self, eng):
        b = _batcher(eng)
        try:
            _, health, info = b.submit(
                _req(Problem(N=8, timesteps=4))).result(120)
            assert health is None and not info.get("chunked")
        finally:
            b.close()

    def test_matches_wavetpu_chunked_serve(self, eng):
        """The port's chunked answer equals wavetpu's chunked serve within
        the FMA tolerance (wavetpu on the CPU, roll)."""
        from wavetpu.core.problem import Problem as WProblem
        from wavetpu.ensemble import batched as web
        from wavetpu.serve.engine import ServeEngine as WEngine
        from wavetpu.serve.scheduler import (
            DynamicBatcher as WBatcher,
            SolveRequest as WRequest,
        )

        weng = WEngine(bucket_sizes=(1,), interpret=True)
        wb = WBatcher(weng, max_wait=0.02, chunk_threshold=THRESHOLD,
                      chunk_steps=CHUNK)
        try:
            wres, whealth, winfo = wb.submit(WRequest(
                problem=WProblem(N=12, timesteps=21), lane=web.LaneSpec(),
                path="roll")).result(300)
        finally:
            wb.close()
        res, health, info = _control(eng, Problem(N=12, timesteps=21))
        assert whealth is None and health is None
        assert info["chunks"] == winfo["chunks"] == 5
        np.testing.assert_allclose(res.abs_errors, wres.abs_errors,
                                   atol=FMA_TOL, rtol=0)


class TestPreemption:
    def test_deadline_preempts_with_token_resume_is_bitwise(self, eng,
                                                            tmp_path):
        p = Problem(N=8, timesteps=17)
        control = _control(eng, p)[0]
        store = SolveStateStore(str(tmp_path / "state"))
        token = _preempt_by_deadline(eng, store, p)
        assert SolveStateStore.valid_token(token)
        res, _ = _resume(eng, store, p, token)
        assert _bitwise(res.abs_errors, control.abs_errors)
        assert _bitwise(res.rel_errors, control.rel_errors)

    def test_worker_crash_resumes_march_zero_client_errors(self, eng):
        """serve-chunk-crash: the worker dies mid-march, restarts, and
        resumes in-process from the last completed chunk."""
        p = Problem(N=8, timesteps=17)
        control = _control(eng, p)[0]
        plan = faults.parse_serve_spec(
            f"serve-chunk-crash:timesteps={p.timesteps},count=1")
        b = _batcher(eng, plan=plan)
        try:
            res, health, _ = b.submit(_req(p)).result(120)
            assert health is None and res.final_step == p.timesteps
            snap = b.metrics.snapshot()
            assert snap["worker_restarts_total"] == 1
            assert snap["resumed_total"] == 1
            assert b.chunk_state_bytes() == 0
        finally:
            b.close()
        assert _bitwise(res.abs_errors, control.abs_errors)

    def test_drain_checkpoints_and_successor_resumes_bitwise(self, eng,
                                                             tmp_path):
        p = Problem(N=8, timesteps=17)
        control = _control(eng, p)[0]
        state_dir = str(tmp_path / "state")
        plan = faults.parse_serve_spec(
            f"serve-slow-batch:seconds=0.4,timesteps={p.timesteps}")
        b = _batcher(eng, store=SolveStateStore(state_dir), plan=plan)
        fut = b.submit(_req(p))
        deadline = time.monotonic() + 60.0
        while (b.metrics.snapshot()["chunks_total"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert b.metrics.snapshot()["chunks_total"] >= 1
        assert b.chunk_state_bytes() > 0  # the march holds its state
        b.close(timeout=60.0, drain=True)
        with pytest.raises(PreemptedError) as ei:
            fut.result(0)
        assert b.chunk_state_bytes() == 0
        # The successor: a different engine sharing only the state dir.
        eng2 = ServeEngine(bucket_sizes=(1,), device="cpu")
        res, _ = _resume(eng2, SolveStateStore(state_dir), p,
                         ei.value.resume_token)
        assert _bitwise(res.abs_errors, control.abs_errors)

    def test_watchdog_trip_answers_with_last_good_step(self, tmp_path):
        """A Courant-unstable chunked march trips at the first chunk
        boundary past the blowup, naming the last good step."""
        eng = ServeEngine(bucket_sizes=(1,), device="cpu")
        p = Problem(N=8, T=40.0, timesteps=60)  # C = 0.85 > 1/sqrt(3)
        b = _batcher(eng)
        try:
            res, health, info = b.submit(_req(p)).result(120)
        finally:
            b.close()
        assert res is None and "last good step" in health
        assert info["chunked"] is True and b.chunk_state_bytes() == 0


class TestTokenHygiene:
    def test_corrupt_and_unknown_token_422_breaker_never_hears(
            self, eng, tmp_path):
        p = Problem(N=8, timesteps=17)
        store = SolveStateStore(str(tmp_path / "state"))
        token = _preempt_by_deadline(eng, store, p)
        corrupt = faults.parse_serve_spec("serve-handoff-corrupt:count=1")
        b = _batcher(eng, store=store, plan=corrupt)
        try:
            with pytest.raises(InvalidStateTokenError,
                               match="content verification"):
                b.submit(SolveRequest(problem=p, lane=eb.LaneSpec(),
                                      resume_token=token)).result(120)
            with pytest.raises(InvalidStateTokenError, match="not found"):
                b.submit(SolveRequest(problem=p, lane=eb.LaneSpec(),
                                      resume_token="0" * 64)).result(120)
        finally:
            b.close()
        assert eng.breaker_stats()["open"] == 0

    def test_identity_mismatch_is_rejected(self, eng, tmp_path):
        store = SolveStateStore(str(tmp_path / "state"))
        token = _preempt_by_deadline(eng, store, Problem(N=8, timesteps=17))
        b = _batcher(eng, store=store)
        try:
            with pytest.raises(InvalidStateTokenError,
                               match="does not match"):
                b.submit(SolveRequest(
                    problem=Problem(N=8, timesteps=13),
                    lane=eb.LaneSpec(), resume_token=token)).result(120)
        finally:
            b.close()

    def test_forged_name_and_ttl_gc(self, tmp_path):
        p = Problem(N=8, timesteps=17)
        store = SolveStateStore(str(tmp_path / "s"), ttl_s=3600.0)
        ident = preempt.solve_identity(p, "standard", "roll", 1, "f32",
                                       True, CHUNK)
        state = (torch.zeros((8, 8, 8)), torch.ones((8, 8, 8)))
        errs = np.zeros(18)
        token = store.put(ident, state, 1, errs, errs)
        meta, step, got, a, _ = store.load(token, ident)
        assert step == 1 and _bitwise(got[1], state[1])
        # A forged name: the bytes of one token under another's name.
        forged = "f" * 64
        os.replace(store.path_for(token), store.path_for(forged))
        with pytest.raises(InvalidStateTokenError,
                           match="content verification"):
            store.load(forged, ident)
        with pytest.raises(InvalidStateTokenError, match="64 lowercase"):
            store.load("zz", ident)
        # TTL: an entry older than ttl_s is GCed, on put and on load.
        short = SolveStateStore(str(tmp_path / "t"), ttl_s=60.0)
        old = short.put(ident, state, 1, errs, errs)
        os.utime(short.path_for(old), (time.time() - 120,) * 2)
        with pytest.raises(InvalidStateTokenError, match="not found"):
            short.load(old, ident)
        assert not os.path.exists(short.path_for(old))
        assert short.gc() == 0

    def test_off_grid_step_refused(self, tmp_path):
        p = Problem(N=8, timesteps=17)
        store = SolveStateStore(str(tmp_path / "s"))
        ident = preempt.solve_identity(p, "standard", "roll", 1, "f32",
                                       True, CHUNK)
        state = (torch.zeros((8, 8, 8)),) * 2
        token = store.put(ident, state, 3, np.zeros(18), np.zeros(18))
        with pytest.raises(InvalidStateTokenError, match="chunk grid"):
            store.load(token, ident)


class TestCrossPackageTokens:
    """The token file is wavetpu's, key for key: a token either package
    writes resumes in the other (wavetpu's side on the CPU)."""

    def _wavetpu(self):
        from wavetpu.core.problem import Problem as WProblem
        from wavetpu.ensemble import batched as web
        from wavetpu.serve.engine import ServeEngine as WEngine
        from wavetpu.serve.preempt import SolveStateStore as WStore
        from wavetpu.serve.scheduler import (
            DynamicBatcher as WBatcher,
            SolveRequest as WRequest,
        )

        return WProblem, web, WEngine, WStore, WBatcher, WRequest

    def test_wavetpu_token_resumes_in_the_port(self, eng, tmp_path):
        WProblem, web, WEngine, WStore, WBatcher, WRequest = self._wavetpu()
        from wavetpu.run import faults as wfaults

        d = str(tmp_path / "state")
        wp = WProblem(N=8, timesteps=17)
        weng = WEngine(bucket_sizes=(1,), interpret=True)
        plan = wfaults.parse_serve_spec(
            "serve-slow-batch:seconds=0.25,timesteps=17")
        wb = WBatcher(weng, max_wait=0.02, fault_plan=plan,
                      chunk_threshold=THRESHOLD, chunk_steps=CHUNK,
                      state_store=WStore(d))
        try:
            fut = wb.submit(WRequest(problem=wp, lane=web.LaneSpec(),
                                     path="roll"),
                            deadline=time.monotonic() + 0.4)
            with pytest.raises(Exception) as ei:
                fut.result(300)
            token = ei.value.resume_token
        finally:
            wb.close()
        # The port decodes wavetpu's file exactly as wavetpu does.
        wmeta, wstep, wstate, wabs, _ = WStore(d).load(token)
        meta, step, state, a, _ = SolveStateStore(d).load(token)
        assert meta == wmeta and step == wstep
        for t, w in zip(state, wstate):
            assert np.array_equal(t.numpy(), np.asarray(w))
        p = Problem(N=8, timesteps=17)
        res, info = _resume(eng, SolveStateStore(d), p, token)
        assert info["resumed_from"] == wstep
        np.testing.assert_array_equal(res.abs_errors[:wstep + 1], wabs)
        control = _control(eng, p)[0]
        np.testing.assert_allclose(res.abs_errors, control.abs_errors,
                                   atol=FMA_TOL, rtol=0)

    def test_port_token_resumes_in_wavetpu(self, eng, tmp_path):
        WProblem, web, WEngine, WStore, WBatcher, WRequest = self._wavetpu()

        d = str(tmp_path / "state")
        p = Problem(N=8, timesteps=17)
        token = _preempt_by_deadline(eng, SolveStateStore(d), p)
        control = _control(eng, p)[0]
        wp = WProblem(N=8, timesteps=17)
        weng = WEngine(bucket_sizes=(1,), interpret=True)
        wb = WBatcher(weng, max_wait=0.02, chunk_threshold=THRESHOLD,
                      chunk_steps=CHUNK, state_store=WStore(d))
        try:
            wres, whealth, winfo = wb.submit(WRequest(
                problem=wp, lane=web.LaneSpec(), path="roll",
                resume_token=token)).result(300)
        finally:
            wb.close()
        assert whealth is None and winfo["resumed_from"] >= 1
        step = winfo["resumed_from"]
        np.testing.assert_array_equal(wres.abs_errors[:step + 1],
                                      control.abs_errors[:step + 1])
        np.testing.assert_allclose(wres.abs_errors, control.abs_errors,
                                   atol=FMA_TOL, rtol=0)


class TestPreemptibleHTTP:
    """The HTTP face: 504 with a token, resume with full error-history
    parity, token hygiene (400/422), the engine's chunk-program keys."""

    def _server(self, tmp_path, **kw):
        kw.setdefault("max_wait", 0.05)
        kw.setdefault("default_kernel", "roll")
        kw.setdefault("device", "cpu")
        kw.setdefault("chunk_threshold", 64)
        kw.setdefault("chunk_steps", 1)
        kw.setdefault("solve_state_dir", str(tmp_path / "state"))
        httpd, state = build_server(port=0, **kw)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"

    @staticmethod
    def _post(base, body):
        req = urllib.request.Request(base + "/solve",
                                     data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def test_deadline_504_with_token_then_resume_matches(self, tmp_path):
        httpd, state, base = self._server(tmp_path)
        body = {"N": 8, "timesteps": 193}
        try:
            code, control = self._post(base, body)
            assert code == 200 and control["batch"]["chunked"] is True
            code, payload = self._post(base, dict(body, deadline_ms=20))
            assert code == 504, payload
            token = payload.get("resume_token")
            assert SolveStateStore.valid_token(token), payload
            code, resumed = self._post(base, dict(body, resume_token=token))
            assert code == 200, resumed
            assert resumed["report"]["final_step"] == 193
            assert resumed["report"]["abs_errors"] == \
                control["report"]["abs_errors"]
            assert resumed["report"]["rel_errors"] == \
                control["report"]["rel_errors"]
            keys = state.engine.cache_stats()["warm_keys"]["memory"]
            assert {k["path"] for k in keys} == {"roll@chunk1"}
            assert state.batcher.chunk_state_bytes() == 0
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    def test_token_on_an_ineligible_request_is_422(self, tmp_path):
        httpd, state, base = self._server(tmp_path)
        try:
            code, payload = self._post(base, {
                "N": 8, "timesteps": 193, "scheme": "compensated",
                "resume_token": "0" * 64})
            assert code == 422 and "chunk-eligible" in payload["error"]
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()
