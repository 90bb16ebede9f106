"""The port's serve layer on the CPU: engine cache, dynamic batcher and
request parsing (the intent of wavetpu's tests/test_serve.py TestEngine,
TestBatcher, TestLengthBuckets, TestDrain, TestBoundedQueue,
TestMetricsRegistryIntegration and TestParse).

The engine runs the kernels' plain versions (device "cpu"); every lane a
batch serves is held bit for bit against the port's `solve_ensemble` lane
and its solo solve (error vectors: the engine releases the batch's states
once its watchdog has read them).  The batcher tests drive a stub engine
(batching logic only).
"""

import threading
import time
import types

import numpy as np
import pytest

from tests.test_obs import parse_prometheus
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.ensemble import sharded as es
from wavetpu_torch.progkey import ProgramKey
from wavetpu_torch.serve.api import _c2_preset, parse_solve_request
from wavetpu_torch.serve.engine import ServeEngine
from wavetpu_torch.serve.scheduler import (
    DynamicBatcher,
    QueueFullError,
    ServeMetrics,
    SolveRequest,
)
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog, sharded


def _same_errors(res, ref):
    """Bit-equal error vectors (numpy f64 arrays)."""
    assert np.array_equal(res.abs_errors, ref.abs_errors)
    assert np.array_equal(res.rel_errors, ref.rel_errors)


def _engine(**kw):
    kw.setdefault("bucket_sizes", (1, 2, 4))
    return ServeEngine(device="cpu", **kw)


# ---- engine ----

class TestEngine:
    def test_bucket_for(self):
        eng = _engine(bucket_sizes=(1, 2, 4, 8))
        assert eng.bucket_for(1) == 1
        assert eng.bucket_for(3) == 4
        assert eng.bucket_for(8) == 8
        with pytest.raises(ValueError, match="exceed"):
            eng.bucket_for(9)

    def test_bad_config_refused(self):
        with pytest.raises(ValueError, match="bucket_sizes"):
            ServeEngine(bucket_sizes=(0, 2), device="cpu")
        with pytest.raises(ValueError, match="max_programs"):
            ServeEngine(max_programs=0, device="cpu")

    def test_program_cache_hits_misses_eviction(self):
        eng = _engine(bucket_sizes=(1, 2), max_programs=1)
        p1 = Problem(N=8, timesteps=3)
        p2 = Problem(N=8, timesteps=4)
        a = eng.program(p1, "standard", "roll", 1, "f32", False, 2)
        assert a is not None and eng.misses == 1 and eng.hits == 0
        b = eng.program(p1, "standard", "roll", 1, "f32", False, 2)
        assert b is a and eng.hits == 1
        c = eng.program(p2, "standard", "roll", 1, "f32", False, 2)
        assert c is not a
        assert eng.evictions == 1
        stats = eng.cache_stats()
        assert stats["programs"] == 1
        assert stats["misses"] == 2
        assert stats["warm_keys"]["memory"][0]["timesteps"] == 4
        assert stats["progcache"] == {"enabled": False}

    @pytest.mark.parametrize("path,k,scheme", [
        ("roll", 1, "standard"), ("pallas", 1, "standard"),
        ("kfused", 4, "standard"), ("roll", 1, "compensated"),
        ("kfused", 4, "compensated"),
    ], ids=["roll", "pallas", "kfused", "comp", "flagship"])
    def test_solve_pads_to_bucket_lanes_equal_ensemble_and_solo(
            self, path, k, scheme):
        eng = _engine()
        p = Problem(N=8, timesteps=9)
        lanes = [eb.LaneSpec(), eb.LaneSpec(phase=1.0),
                 eb.LaneSpec(phase=0.5, stop_step=5)]
        res, health = eng.solve(p, lanes, scheme=scheme, path=path, k=k)
        assert res.batch_size == 4 and res.n_lanes == 3
        assert health == [None, None, None]
        assert res.batched and res.fallback_reason is None
        ens = eb.solve_ensemble(p, lanes, scheme=scheme, path=path, k=k,
                                pad_to=4, device="cpu")
        for i, lane in enumerate(lanes):
            _same_errors(res.results[i], ens.results[i])
            kw = dict(device="cpu", phase=lane.phase,
                      stop_step=lane.stop(p))
            if scheme == "compensated" and path == "kfused":
                solo = kfused_comp.solve_kfused_comp(p, k=k, **kw)
            elif scheme == "compensated":
                solo = leapfrog.solve_compensated(p, kernel="roll", **kw)
            elif path == "kfused":
                solo = kfused.solve_kfused(p, k=k, **kw)
            else:
                solo = leapfrog.solve(p, kernel="roll", **kw)
            _same_errors(res.results[i], solo)

    def test_batch_states_released_after_the_watchdog(self):
        eng = _engine()
        p = Problem(N=8, timesteps=3)
        res, _ = eng.solve(p, [eb.LaneSpec(), eb.LaneSpec(phase=1.0)])
        assert res.u_prev_batch is None and res.u_cur_batch is None
        assert all(r.u_prev is None and r.u_cur is None
                   for r in res.results)
        assert res.results[0].final_step == 3

    def test_warmup_precompiles(self):
        eng = _engine(bucket_sizes=(1, 2))
        p = Problem(N=8, timesteps=3)
        warmed = eng.warmup(p, path="roll")
        assert warmed == [1, 2]
        assert eng.misses == 2
        timing = {}
        eng.solve(p, [eb.LaneSpec()], path="roll", timing=timing)
        assert eng.hits == 1  # served from the warmed solver
        assert timing == {"compile_seconds": 0.0, "warm": "true"}

    def test_warmup_beside_a_served_batch(self):
        """A warmup on another thread (the replica's --warmup) while the
        worker serves: both finish, the served lanes stay bitwise."""
        eng = _engine(bucket_sizes=(1, 2, 4, 8))
        p = Problem(N=8, timesteps=6)
        lanes = [eb.LaneSpec(), eb.LaneSpec(phase=1.0)]
        out = {}
        th = threading.Thread(target=lambda: out.setdefault(
            "warmed", eng.warmup(Problem(N=8, timesteps=7), path="roll")))
        th.start()
        res, health = eng.solve(p, lanes, path="roll")
        th.join(60)
        assert not th.is_alive()
        assert out["warmed"] == [1, 2, 4, 8] and health == [None, None]
        ens = eb.solve_ensemble(p, lanes, path="roll", device="cpu")
        for i in range(2):
            _same_errors(res.results[i], ens.results[i])

    def test_vmap_probes_surface_in_cache_stats(self):
        eng = _engine(bucket_sizes=(1,))
        p = Problem(N=8, timesteps=3)
        eng.solve(p, [eb.LaneSpec()], scheme="compensated", path="roll")
        probes = eng.cache_stats()["vmap_probes"]
        assert any(
            pr.get("scheme") == "compensated" and pr["path"] == "roll"
            and pr["ok"] and pr["backend"] == "cpu" for pr in probes
        )
        for pr in probes:
            assert "backend" in pr and "ok" in pr and "reason" in pr

    def test_sharded_batched_program_cached_per_mesh_bucket(self):
        eng = _engine(bucket_sizes=(1, 2))
        p = Problem(N=8, timesteps=4)
        warmed = eng.warmup(p, path="roll", mesh=(2, 2, 1))
        assert warmed == [1, 2]
        lanes = [eb.LaneSpec(), eb.LaneSpec(phase=1.0)]
        res, health = eng.solve(p, lanes, path="roll", mesh=(2, 2, 1))
        assert res.batched and res.fallback_reason is None
        assert health == [None, None]
        assert eng.hits == 1  # served from the warmed (mesh, bucket=2)
        keys = eng.cache_stats()["keys"]
        assert any(tuple(k[-1] or ()) == (2, 2, 1) for k in keys)
        assert eng.mesh_devices((2, 2, 1)) == [eng.device] * 4
        ens = es.solve_ensemble_sharded(p, lanes, (2, 2, 1),
                                        devices=["cpu"] * 4)
        for i, lane in enumerate(lanes):
            _same_errors(res.results[i], ens.results[i])
            solo = sharded.solve_sharded(p, (2, 2, 1), devices=["cpu"] * 4,
                                         kernel="roll", phase=lane.phase)
            _same_errors(res.results[i], solo)

    def test_watchdog_isolates_poisoned_lane(self):
        # C = 0.55: stable under constant c^2 = a^2, but the two-layer
        # preset DOUBLES c^2 in half the domain (c * sqrt2 -> C = 0.78,
        # past the leapfrog bound) - that lane blows up while its
        # batchmate stays bounded.
        p = Problem(N=8, T=26.0, timesteps=60)
        eng = _engine(bucket_sizes=(1, 2))
        lanes = [
            eb.LaneSpec(c2tau2_field=_c2_preset(p, "constant")),
            eb.LaneSpec(c2tau2_field=_c2_preset(p, "two-layer")),
        ]
        res, health = eng.solve(p, lanes, path="roll")
        assert health[0] is None
        assert health[1] is not None and "amax" in health[1]
        solo = leapfrog.solve(p, kernel="roll", device="cpu",
                              compute_errors=False,
                              c2tau2_field=lanes[0].c2tau2_field)
        assert float(solo.u_cur.abs().max()) < 10.0

    def test_guarded_amax_per_lane_semantics(self):
        import torch

        from wavetpu_torch.run import health

        batch = torch.stack([
            torch.ones((4, 4, 4)),
            torch.full((4, 4, 4), float("nan")),
            torch.full((4, 4, 4), 7.0),
        ])
        out = health.guarded_amax_per_lane(batch)
        assert out.shape == (3,)
        assert out[0] == 1.0
        assert np.isinf(out[1])  # NaN anywhere -> +inf, as guarded_amax
        assert out[2] == 7.0
        for i in range(3):
            assert out[i] == health.guarded_amax(batch[i])

    def test_mesh_with_compensated_scheme_refused_loudly(self):
        # Silently serving a compensated request with the standard
        # scheme would be a wrong-result bug, not a fallback.
        eng = _engine(bucket_sizes=(1,))
        p = Problem(N=8, timesteps=3)
        with pytest.raises(ValueError, match="standard scheme only"):
            eng.solve(
                p, [eb.LaneSpec()], scheme="compensated", path="roll",
                mesh=(2, 1, 1),
            )

    def test_watchdog_can_be_disabled(self):
        p = Problem(N=8, T=26.0, timesteps=60)
        eng = _engine(bucket_sizes=(1,), watchdog=False)
        _, health = eng.solve(
            p, [eb.LaneSpec(c2tau2_field=_c2_preset(p, "two-layer"))],
            path="roll",
        )
        assert health == [None]

    def test_f64_runs_only_on_the_cpu(self):
        import torch

        eng = _engine(bucket_sizes=(1,))
        p = Problem(N=8, timesteps=3)
        res, _ = eng.solve(p, [eb.LaneSpec()], dtype_name="f64")
        _same_errors(res.results[0], leapfrog.solve(
            p, kernel="roll", device="cpu", dtype=torch.float64))
        with pytest.raises(ValueError, match="dtype must be one of"):
            eng.solve(p, [eb.LaneSpec()], dtype_name="f16")
        eng.device = torch.device("cuda")  # the dtype table only
        with pytest.raises(ValueError, match="only on the CPU"):
            eng._dtype("f64")

    def test_without_cuda_the_default_device_raises(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the engine runs on it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine()


# ---- scheduler (stub engine: batching logic only) ----

class _FakeEngine:
    """Engine stub recording batch compositions."""

    max_batch = 4

    def __init__(self, fail=False):
        self.batches = []
        self.fail = fail

    def solve(self, problem, lanes, scheme, path, k, dtype_name,
              mesh=None, timing=None):
        if self.fail:
            raise RuntimeError("engine exploded")
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


def _req(problem, **kw):
    return SolveRequest(problem=problem, lane=eb.LaneSpec(**kw))


def _req(problem, **kw):
    return SolveRequest(problem=problem, lane=eb.LaneSpec(**kw))


class TestBatcher:
    def test_concurrent_same_key_requests_coalesce(self):
        eng = _FakeEngine()
        metrics = ServeMetrics()
        b = DynamicBatcher(eng, metrics=metrics, max_wait=0.5)
        p = Problem(N=8, timesteps=3)
        futs = [b.submit(_req(p, phase=1.0 + i)) for i in range(3)]
        out = [f.result(10) for f in futs]
        b.close()
        assert eng.batches == [3]
        assert all(o[2]["occupancy"] == 3 for o in out)
        snap = metrics.snapshot()
        assert snap["batches_total"] == 1
        assert snap["batch_occupancy_max"] == 3

    def test_different_keys_never_share_a_batch(self):
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=0.3)
        pa = Problem(N=8, timesteps=3)
        pb = Problem(N=8, timesteps=4)
        fa = b.submit(_req(pa))
        fb = b.submit(_req(pb))
        fa.result(10)
        fb.result(10)
        b.close()
        assert sorted(eng.batches) == [1, 1]

    def test_max_batch_closes_the_batch_early(self):
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=30.0, max_batch=2)
        p = Problem(N=8, timesteps=3)
        t0 = time.monotonic()
        futs = [b.submit(_req(p, phase=1.0 + i)) for i in range(2)]
        for f in futs:
            f.result(10)
        took = time.monotonic() - t0
        b.close()
        assert eng.batches == [2]
        assert took < 5.0  # did not sit out the 30 s max_wait

    def test_engine_failure_propagates_to_every_future(self):
        b = DynamicBatcher(_FakeEngine(fail=True), max_wait=0.2)
        p = Problem(N=8, timesteps=3)
        futs = [b.submit(_req(p, phase=1.0 + i)) for i in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="engine exploded"):
                f.result(10)
        b.close()

    def test_bucket_key_separates_program_identities(self):
        p = Problem(N=8, timesteps=3)
        base = _req(p)
        assert base.bucket_key() == _req(p, phase=2.0).bucket_key()
        other = SolveRequest(problem=p, lane=eb.LaneSpec(), dtype_name="f64")
        assert base.bucket_key() != other.bucket_key()
        kf = SolveRequest(problem=p, lane=eb.LaneSpec(), path="kfused", k=2)
        assert base.bucket_key() != kf.bucket_key()
        meshy = SolveRequest(
            problem=p, lane=eb.LaneSpec(), mesh_shape=(2, 2, 1)
        )
        assert base.bucket_key() != meshy.bucket_key()


class TestLengthBuckets:
    """Length-bucketed scheduling: lanes with diverging stop_steps are
    sorted into step-length buckets (k-block-granular) before batching,
    so a short request never marches a long batch's masked tail."""

    def _kreq(self, p, stop, k=2):
        return SolveRequest(
            problem=p, lane=eb.LaneSpec(stop_step=stop), path="kfused",
            k=k,
        )

    def test_bucket_assignment_and_quantum(self):
        p = Problem(N=8, timesteps=40)
        b = DynamicBatcher(
            _FakeEngine(), max_wait=0.01, length_bucket_steps=10
        )
        try:
            # 1-step path: quantum 10, bucket = (stop-1)//10
            assert b.length_bucket(_req(p)) == 3  # stop=40
            r5 = SolveRequest(problem=p, lane=eb.LaneSpec(stop_step=5))
            r11 = SolveRequest(problem=p, lane=eb.LaneSpec(stop_step=11))
            assert b.length_bucket(r5) == 0
            assert b.length_bucket(r11) == 1
        finally:
            b.close()

    def test_quantum_rounds_up_to_k_block_grid(self):
        # quantum 10 with k=4 aligns to 12: every bucket boundary sits
        # on the onion's k-block grid ((stop-1) % k == 0 freeze points).
        p = Problem(N=8, timesteps=40)
        b = DynamicBatcher(
            _FakeEngine(), max_wait=0.01, length_bucket_steps=10
        )
        try:
            assert b.length_bucket(self._kreq(p, 13, k=4)) == 1  # 12//12
            assert b.length_bucket(self._kreq(p, 12 + 1, k=4)) == 1
            assert b.length_bucket(self._kreq(p, 9, k=4)) == 0
            assert b.length_bucket(self._kreq(p, 25, k=4)) == 2
        finally:
            b.close()

    def test_disabled_by_default_everything_one_bucket(self):
        p = Problem(N=8, timesteps=40)
        b = DynamicBatcher(_FakeEngine(), max_wait=0.01)
        try:
            r5 = SolveRequest(problem=p, lane=eb.LaneSpec(stop_step=5))
            assert b.length_bucket(r5) == 0
            assert b.length_bucket(_req(p)) == 0
        finally:
            b.close()

    def test_different_length_buckets_never_share_a_batch(self):
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=0.3, length_bucket_steps=10)
        p = Problem(N=8, timesteps=40)
        fs = b.submit(SolveRequest(problem=p, lane=eb.LaneSpec(stop_step=5)))
        fl = b.submit(_req(p, phase=1.0))
        fs2 = b.submit(SolveRequest(problem=p, lane=eb.LaneSpec(stop_step=7)))
        out = [f.result(10) for f in (fs, fl, fs2)]
        b.close()
        # the two short requests coalesce; the long one runs alone
        assert sorted(eng.batches) == [1, 2]
        assert out[1][2]["occupancy"] == 1

    def test_starvation_bound_stashed_request_served_next_round(self):
        # A non-matching stashed request becomes the NEXT batch's leader
        # (arrival order), so it waits at most one batch - the bound the
        # occupancy/latency tradeoff rests on.
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=0.2, length_bucket_steps=10)
        p = Problem(N=8, timesteps=40)
        f1 = b.submit(SolveRequest(problem=p, lane=eb.LaneSpec(stop_step=5)))
        f2 = b.submit(_req(p, phase=1.0))  # different bucket: stashed
        t0 = time.monotonic()
        f1.result(10)
        f2.result(10)
        took = time.monotonic() - t0
        b.close()
        assert eng.batches == [1, 1]
        assert took < 5.0


class TestDrain:
    def test_drain_resolves_queued_futures_with_results(self):
        eng = _FakeEngine()
        # max_wait far longer than the test: drain must flush
        # immediately, not sit out the window.
        b = DynamicBatcher(eng, max_wait=30.0, max_batch=2)
        p = Problem(N=8, timesteps=3)
        futs = [b.submit(_req(p, phase=1.0 + i)) for i in range(3)]
        t0 = time.monotonic()
        b.close(timeout=60.0, drain=True)
        took = time.monotonic() - t0
        for f in futs:
            res, health, info = f.result(0)  # already resolved
            assert health is None
        assert took < 10.0
        assert sum(eng.batches) == 3

    def test_drain_refuses_new_submits(self):
        b = DynamicBatcher(_FakeEngine(), max_wait=0.01)
        b.close(drain=True)
        p = Problem(N=8, timesteps=3)
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(_req(p))

    def test_drain_timeout_fails_unserved_futures_without_stranding(self):
        # A drain that outlives its timeout must stop draining, and
        # close() must fail whatever the worker could not finish -
        # blocked handlers get an error, never the 600 s request
        # timeout.  The slow engine makes each batch outlast the drain
        # timeout deterministically.
        class _SlowEngine(_FakeEngine):
            def solve(self, *a, **k):
                time.sleep(1.0)
                return super().solve(*a, **k)

        eng = _SlowEngine()
        b = DynamicBatcher(eng, max_wait=30.0, max_batch=1)
        p = Problem(N=8, timesteps=3)
        futs = [b.submit(_req(p, phase=1.0 + i)) for i in range(4)]
        b.close(timeout=0.2, drain=True)
        resolved = errored = 0
        for f in futs:
            try:
                f.result(10)  # in-flight batches may still land
                resolved += 1
            except RuntimeError:
                errored += 1
        assert resolved + errored == 4
        assert errored >= 1  # the tail was failed, not stranded

    def test_drain_vs_submit_race_never_hangs(self):
        """A request submitted CONCURRENTLY with close(drain=True) must
        resolve - with a result or a fast shutdown error - never hang
        to the client timeout.  Hammer the race: a spammer thread
        submits as fast as it can while the main thread drains; every
        future it got back must be done shortly after close returns."""
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=0.01, max_batch=4)
        p = Problem(N=8, timesteps=3)
        futs = []
        started = threading.Event()

        def spam():
            i = 0
            while True:
                try:
                    futs.append(b.submit(_req(p, phase=1.0 + i)))
                except RuntimeError:
                    return  # batcher closed: the race window is over
                i += 1
                started.set()

        th = threading.Thread(target=spam, daemon=True)
        th.start()
        assert started.wait(5)
        b.close(timeout=30.0, drain=True)
        th.join(10)
        assert not th.is_alive()
        assert futs  # the race actually happened
        deadline = time.monotonic() + 10.0
        resolved = errored = 0
        for f in futs:
            try:
                f.result(max(0.0, deadline - time.monotonic()))
                resolved += 1
            except RuntimeError:
                errored += 1
        # every single future resolved fast - results for what the
        # drain flushed, an immediate error for what raced past it
        assert resolved + errored == len(futs)
        assert resolved >= 1

    def test_close_without_drain_still_errors_stashed_leftovers(self):
        # The non-drain path keeps its contract: the in-flight batch
        # resolves, but a stashed different-key request fails fast
        # instead of hanging to the request timeout.
        eng = _FakeEngine()
        b = DynamicBatcher(eng, max_wait=30.0, max_batch=8)
        pa = Problem(N=8, timesteps=3)
        pb = Problem(N=8, timesteps=4)
        f1 = b.submit(_req(pa))
        f2 = b.submit(SolveRequest(problem=pb, lane=eb.LaneSpec()))
        b.close(timeout=10.0)
        res, health, info = f1.result(10)  # the batch in flight finishes
        assert health is None
        with pytest.raises(RuntimeError, match="shutting down"):
            f2.result(0)


class TestBoundedQueue:
    """Bounded request queue with 429 backpressure (ROADMAP serving-
    hardening item): submit() raises QueueFullError once max_queue
    requests are submitted-but-not-executing; depth and rejections are
    exposed via the registry and /metrics."""

    def test_submit_rejects_when_full(self):
        class _StuckEngine(_FakeEngine):
            def __init__(self):
                super().__init__()
                self.release = threading.Event()

            def solve(self, *a, **k):
                self.release.wait(30)
                return super().solve(*a, **k)

        eng = _StuckEngine()
        metrics = ServeMetrics()
        b = DynamicBatcher(eng, metrics=metrics, max_wait=30.0,
                           max_batch=1, max_queue=2)
        p = Problem(N=8, timesteps=3)
        try:
            # First fills the (max_batch=1) in-flight batch; the worker
            # takes it off the queue, so keep stuffing until depth
            # sticks at the bound, then the next submit must 429.
            futs = [b.submit(_req(p, phase=1.0 + i)) for i in range(2)]
            with pytest.raises(QueueFullError, match="queue full"):
                for i in range(8):
                    futs.append(b.submit(_req(p, phase=10.0 + i)))
            snap = metrics.snapshot()
            assert snap["rejected_total"] >= 1
            assert snap["queue_depth"] >= 1
        finally:
            eng.release.set()
            b.close(timeout=10.0, drain=True)

    def test_zero_max_queue_rejects_everything(self):
        b = DynamicBatcher(_FakeEngine(), max_wait=0.01, max_queue=0)
        p = Problem(N=8, timesteps=3)
        try:
            with pytest.raises(QueueFullError):
                b.submit(_req(p))
        finally:
            b.close()

    def test_unbounded_by_default(self):
        b = DynamicBatcher(_FakeEngine(), max_wait=0.2)
        assert b.max_queue is None
        p = Problem(N=8, timesteps=3)
        futs = [b.submit(_req(p, phase=1.0 + i)) for i in range(16)]
        for f in futs:
            f.result(10)
        b.close()

    def test_depth_returns_to_zero_after_service(self):
        metrics = ServeMetrics()
        b = DynamicBatcher(_FakeEngine(), metrics=metrics, max_wait=0.05)
        p = Problem(N=8, timesteps=3)
        b.submit(_req(p)).result(10)
        b.close()
        assert metrics.snapshot()["queue_depth"] == 0


class TestMetricsRegistryIntegration:
    """ServeMetrics writes through the registry: the JSON snapshot keeps
    its historical fields while the same cut renders as Prometheus text,
    and snapshot() holds ONE lock across everything it reads."""

    def test_snapshot_fields_preserved_and_extended(self):
        m = ServeMetrics()
        m.observe_request()
        m.observe_response(True)
        m.observe_batch(occupancy=3, batched=True, cells=1e9,
                        solve_seconds=0.5, batch_size=4)
        m.observe_latency(0.1)
        snap = m.snapshot()
        # historical fields, exact names and derivations
        assert snap["requests_total"] == 1
        assert snap["responses_ok"] == 1
        assert snap["responses_error"] == 0
        assert snap["batches_total"] == 1
        assert snap["batch_occupancy_mean"] == 3.0
        assert snap["batch_occupancy_max"] == 3
        assert snap["fallback_batches"] == 0
        assert snap["latency_p50_ms"] == 100.0
        assert snap["aggregate_gcells_per_s"] == 2.0
        # new observability fields
        assert snap["queue_depth"] == 0
        assert snap["rejected_total"] == 0
        assert snap["padding_lanes_total"] == 1
        assert snap["last_batch_age_seconds"] is not None

    def test_last_batch_age_none_only_before_any_batch(self):
        """The /healthz discriminator: age is None IFF no batch was
        ever executed.  Keyed on the batches counter, not the timestamp
        gauge, so a gauge sitting at its 0.0 default ("idle since t=0")
        can never read as "never executed"."""
        m = ServeMetrics()
        assert m.last_batch_age() is None
        m.observe_batch(occupancy=1, batched=True, cells=1.0,
                        solve_seconds=0.1)
        assert m.last_batch_age() is not None
        # even a zero timestamp is "has executed", not "never"
        m._last_batch_ts.set(0.0)
        assert m.last_batch_age() is not None

    def test_json_and_text_views_agree(self):
        m = ServeMetrics()
        for _ in range(3):
            m.observe_request()
        m.observe_response(True)
        m.observe_response(False)
        m.observe_batch(occupancy=2, batched=False, cells=2e9,
                        solve_seconds=1.0, batch_size=2)
        m.observe_latency(0.2)
        snap = m.snapshot()
        samples, types = parse_prometheus(m.registry.render_prometheus())
        assert types["wavetpu_serve_requests_total"] == "counter"
        assert samples["wavetpu_serve_requests_total"] == \
            snap["requests_total"] == 3
        assert samples['wavetpu_serve_responses_total{status="ok"}'] == \
            snap["responses_ok"] == 1
        assert samples['wavetpu_serve_responses_total{status="error"}'] \
            == snap["responses_error"] == 1
        assert samples["wavetpu_serve_batches_total"] == \
            snap["batches_total"] == 1
        assert samples["wavetpu_serve_fallback_batches_total"] == \
            snap["fallback_batches"] == 1
        # histogram triplet for the latency distribution
        assert samples["wavetpu_serve_request_seconds_count"] == 1
        assert samples["wavetpu_serve_request_seconds_sum"] == \
            pytest.approx(0.2)
        assert samples['wavetpu_serve_request_seconds_bucket{le="+Inf"}'] \
            == 1


# ---- request parsing ----

class TestParse:
    def test_minimal_request(self):
        req = parse_solve_request({"N": 8}, default_kernel="roll")
        assert req.problem.N == 8
        assert req.path == "roll"
        assert req.k == 1

    def test_fuse_steps_selects_kfused(self):
        req = parse_solve_request(
            {"N": 8, "fuse_steps": 2, "kernel": "pallas"},
            default_kernel="roll",
        )
        assert req.path == "kfused" and req.k == 2

    def test_fuse_steps_rejects_roll(self):
        with pytest.raises(ValueError, match="pallas"):
            parse_solve_request(
                {"N": 8, "fuse_steps": 2, "kernel": "roll"},
                default_kernel="roll",
            )

    def test_pi_lengths_and_preset_fields(self):
        req = parse_solve_request(
            {"N": 8, "Lx": "pi", "c2_field": "gaussian-lens"},
            default_kernel="roll",
        )
        assert req.problem.Lx == pytest.approx(np.pi)
        assert req.lane.c2tau2_field is not None

    def test_bad_fields_rejected(self):
        for body, msg in [
            ({}, "missing required field N"),
            ({"N": 8, "scheme": "x"}, "scheme"),
            ({"N": 8, "dtype": "f16"}, "dtype"),
            ({"N": 8, "c2_field": "nope"}, "c2_field"),
            ({"N": 8, "steps": 99}, "stop_step"),
            ({"N": 8, "scheme": "compensated", "c2_field": "constant"},
             "c2_field"),
            ({"N": 8, "phase": 1.0, "c2_field": "constant"},
             "analytic layer-1"),
            ({"N": 8, "mesh": [2, 2]}, "mesh"),
            ({"N": 8, "mesh": [99, 99, 99]}, "too large for N"),
            ({"N": 8, "mesh": [2, 1, 1], "scheme": "compensated"},
             "standard scheme"),
            ({"N": 8, "mesh": [2, 1, 1], "fuse_steps": 2,
              "kernel": "pallas"}, "fuse_steps"),
            ({"N": 8, "mesh": [2, 1, 1], "c2_field": "constant"},
             "c2_field"),
        ]:
            with pytest.raises(ValueError, match=msg):
                parse_solve_request(body, default_kernel="roll")

    def test_compensated_bf16_rejected_at_parse(self):
        with pytest.raises(ValueError, match="f32/f64"):
            parse_solve_request(
                {"N": 8, "scheme": "compensated", "dtype": "bf16"},
                default_kernel="roll",
            )

    def test_compensated_shifted_phase_now_parses(self):
        # The vmapped compensated core serves shifted phases; the old
        # parse-time refusal is gone.
        req = parse_solve_request(
            {"N": 8, "scheme": "compensated", "phase": 1.0},
            default_kernel="roll",
        )
        assert req.scheme == "compensated"
        assert req.lane.phase == 1.0

    def test_mesh_request_parses(self):
        req = parse_solve_request(
            {"N": 8, "mesh": [2, 2, 1], "phase": 1.0},
            default_kernel="roll",
        )
        assert req.mesh_shape == (2, 2, 1)
        assert req.path == "roll"


    def test_kernel_auto_resolves_by_platform(self):
        assert parse_solve_request({"N": 8}, platform="gpu").path == \
            "pallas"
        assert parse_solve_request({"N": 8}, platform="cpu").path == "roll"
        req = parse_solve_request({"N": 8, "fuse_steps": 4},
                                  platform="gpu")
        assert req.path == "kfused" and req.k == 4

    def test_resume_token_names_item_12b(self):
        with pytest.raises(ValueError, match="queue 1 item 12b"):
            parse_solve_request({"N": 8, "resume_token": "ab" * 32},
                                default_kernel="roll")

    def test_program_key_shape(self):
        p = Problem(N=8, timesteps=3)
        key = ProgramKey.for_batch(
            p, "standard", "roll", 4, "f32", False, True, 2
        )
        assert key.k == 1  # non-kfused paths normalize k
        assert key.batch == 2
        assert key.mesh is None  # single-device default
        sharded_key = ProgramKey.for_batch(
            p, "standard", "roll", 4, "f32", False, True, 2, (2, 2, 1)
        )
        assert sharded_key.mesh == (2, 2, 1)
        assert sharded_key != key


class TestSingleflight:
    """`submit(coalesce_key=)`: an identical in-flight solve fans its
    answer out to later submits of the same key (one march, each rider
    counted as a request); a finished primary takes no more riders."""

    def test_identical_in_flight_submits_share_one_march(self):
        class _Held(_FakeEngine):
            def __init__(self):
                super().__init__()
                self.release = threading.Event()

            def solve(self, *a, **k):
                self.release.wait(30)
                return super().solve(*a, **k)

        eng = _Held()
        metrics = ServeMetrics()
        b = DynamicBatcher(eng, metrics=metrics, max_wait=0.01)
        p = Problem(N=8, timesteps=3)
        try:
            first = b.submit(_req(p), coalesce_key="k1")
            riders = [b.submit(_req(p), coalesce_key="k1")
                      for _ in range(2)]
            other = b.submit(_req(p, phase=1.0), coalesce_key="k2")
            eng.release.set()
            out = [f.result(10) for f in [first] + riders + [other]]
            assert all(getattr(f, "wavetpu_coalesced", False)
                       for f in riders)
            assert out[1] == out[0] and out[2] == out[0]
            assert sum(eng.batches) == 2  # k1 once, k2 once
            snap = metrics.snapshot()
            assert snap["coalesced_total"] == 2
            assert snap["requests_total"] == 4
            # the primary is done: the next identical submit marches anew
            b.submit(_req(p), coalesce_key="k1").result(10)
            assert sum(eng.batches) == 3
        finally:
            eng.release.set()
            b.close()
