"""The port's serving replica held to wavetpu's, side by side on the CPU.

wavetpu's replica (`wavetpu.serve.api.build_server`, JAX on the CPU, kernel
auto -> roll, explicit pallas in interpret mode) and the port's
(`device="cpu"`, the kernels' plain versions) answer the same bodies at
N=8-12: standard, k-fused, the compensated flagship, a c2 field, a mesh,
a shifted phase, an early stop, f64.  Held:

 * the /solve JSON key sets and `batch` keys equal, the /healthz and
   /metrics JSON key sets equal and the Prometheus metric names equal -
   so wavetpu's router (ROADMAP.md queue 1 item 12c) can read either;
 * the same status codes for the same bad bodies (400 / 413 / 422 / 429 /
   503);
 * error vectors within the parity tolerances of tests/
   test_torch_ensemble.py: f32 abs within 1e-5 and rel within rtol 1e-3
   plus that slack, f64 abs within 1e-12 (f64 rel is noise where the
   metric is unguarded, as that file says);
 * every port response bit-equal to the port's own `solve_ensemble` lane
   and to its solo solve.

Nothing in wavetpu changes for this: its replica runs as its own tests run
it.  The compensated k-fused lanes run K4 on a slab of the port's default
depth and wavetpu's (they differ), so they agree within the tolerance.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_obs import parse_prometheus
from wavetpu.run import faults as jfaults
from wavetpu.serve import api as japi
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.ensemble import sharded as es
from wavetpu_torch.run import faults as tfaults
from wavetpu_torch.serve import api
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog, sharded

TOL = {"f32": (1e-5, 1e-3), "f64": (1e-12, None)}
BODIES = {
    "standard": {"N": 12, "timesteps": 8},
    "phase": {"N": 12, "timesteps": 8, "phase": 1.0},
    "early": {"N": 12, "timesteps": 8, "phase": 0.5, "steps": 5},
    "kfused": {"N": 12, "timesteps": 9, "fuse_steps": 4,
               "kernel": "pallas"},
    "flagship": {"N": 8, "timesteps": 9, "scheme": "compensated",
                 "fuse_steps": 4, "kernel": "pallas"},
    "flagship_phase": {"N": 8, "timesteps": 9, "scheme": "compensated",
                       "fuse_steps": 4, "kernel": "pallas", "phase": 1.6,
                       "steps": 5},
    "compensated": {"N": 12, "timesteps": 8, "scheme": "compensated"},
    "c2_field": {"N": 12, "timesteps": 8, "c2_field": "gaussian-lens"},
    "mesh": {"N": 12, "timesteps": 8, "mesh": [2, 1, 1], "phase": 1.0},
    "f64": {"N": 12, "timesteps": 8, "dtype": "f64"},
}
LIMITS = dict(max_body_bytes=512, max_lane_cells=13 ** 3)


def _start(build, **kw):
    httpd, state = build(port=0, max_wait=0.02, **LIMITS, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def replicas():
    """(wavetpu base, port base, wavetpu state, port state)."""
    j = _start(japi.build_server)
    t = _start(api.build_server, device="cpu")
    yield j[2], t[2], j[1], t[1]
    for httpd, state, _ in (j, t):
        httpd.shutdown()
        state.batcher.close()
        httpd.server_close()


def _post(base, body, timeout=300):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(base + "/solve", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path, accept=None):
    req = urllib.request.Request(
        base + path, headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=30) as r:
        text = r.read().decode()
    return text if accept else json.loads(text)


def _lane(body):
    return eb.LaneSpec(phase=float(body.get("phase", eb.LaneSpec().phase)),
                       stop_step=body.get("steps"))


def _port_references(body):
    """The port's solve_ensemble lane and solo solve of a body, on the
    CPU (its parse gives the problem, path, k and the c2 field)."""
    req = api.parse_solve_request(body, platform="cpu")
    p, lane = req.problem, req.lane
    dtype = torch.float64 if req.dtype_name == "f64" else torch.float32
    errors = lane.c2tau2_field is None
    kw = dict(stop_step=lane.stop(p), phase=lane.phase, dtype=dtype,
              compute_errors=errors)
    if req.mesh_shape is not None:
        devs = ["cpu"] * int(np.prod(req.mesh_shape))
        ens = es.solve_ensemble_sharded(p, [lane], req.mesh_shape,
                                        dtype=dtype, devices=devs)
        solo = sharded.solve_sharded(p, req.mesh_shape, devices=devs,
                                     kernel="roll", **kw)
        return ens.results[0], solo
    ens = eb.solve_ensemble(p, [lane], dtype=dtype, scheme=req.scheme,
                            path=req.path, k=req.k, compute_errors=errors,
                            device="cpu")
    kernel = "roll" if req.path == "roll" else "pallas"
    kw["device"] = "cpu"
    if req.scheme == "compensated" and req.path == "kfused":
        solo = kfused_comp.solve_kfused_comp(p, k=req.k, **kw)
    elif req.scheme == "compensated":
        solo = leapfrog.solve_compensated(p, kernel=kernel, **kw)
    elif req.path == "kfused":
        solo = kfused.solve_kfused(p, k=req.k,
                                   c2tau2_field=lane.c2tau2_field, **kw)
    else:
        solo = leapfrog.solve(p, kernel=kernel,
                              c2tau2_field=lane.c2tau2_field, **kw)
    return ens.results[0], solo


@pytest.mark.parametrize("name", list(BODIES))
def test_solve_answers_agree(replicas, name):
    jbase, tbase, _, _ = replicas
    body = BODIES[name]
    jcode, jres = _post(jbase, body)
    tcode, tres = _post(tbase, body)
    assert jcode == tcode == 200, (jres, tres)
    assert set(tres) == set(jres)
    assert set(tres["batch"]) == set(jres["batch"])
    assert set(tres["report"]) == set(jres["report"])
    assert set(tres["batch"]["timing"]) == set(jres["batch"]["timing"])
    assert tres["batch"]["batched"] is True
    for key in ("final_step", "errors_computed", "cells_per_step"):
        assert tres["report"][key] == jres["report"][key]
    assert tres["batch"]["path"] == jres["batch"]["path"]
    if not tres["report"]["errors_computed"]:
        assert tres["report"]["abs_errors"] is None
        return
    t_abs = np.array(tres["report"]["abs_errors"])
    t_rel = np.array(tres["report"]["rel_errors"])
    atol, rtol = TOL[body.get("dtype", "f32")]
    np.testing.assert_allclose(t_abs, jres["report"]["abs_errors"], rtol=0,
                               atol=atol)
    if rtol is not None:
        np.testing.assert_allclose(t_rel, jres["report"]["rel_errors"],
                                   rtol=rtol, atol=atol)
    ens, solo = _port_references(body)
    for ref in (ens, solo):
        assert np.array_equal(t_abs, ref.abs_errors)
        assert np.array_equal(t_rel, ref.rel_errors)
    assert tres["report"]["max_abs_error"] == float(ens.abs_errors.max())


def test_coalesced_pair_bit_equal_to_its_ensemble(replicas):
    """Two concurrent requests coalesce into one port batch; each answer
    is bit for bit its lane of `solve_ensemble` over the pair."""
    _, tbase, _, _ = replicas
    bodies = [dict(BODIES["flagship"], phase=p) for p in (1.0, 1.3)]
    out = [None, None]

    def go(i):
        out[i] = _post(tbase, bodies[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    assert [o[0] for o in out] == [200, 200]
    assert all(o[1]["batch"]["occupancy"] == 2 for o in out)
    p = Problem(N=8, timesteps=9)
    ens = eb.solve_ensemble(p, [_lane(b) for b in bodies],
                            scheme="compensated", path="kfused", k=4,
                            pad_to=2, device="cpu")
    for (_, res), ref in zip(out, ens.results):
        assert np.array_equal(res["report"]["abs_errors"], ref.abs_errors)
        assert np.array_equal(res["report"]["rel_errors"], ref.rel_errors)


BAD = {
    "missing_n": ({"timesteps": 4}, 400),
    "bad_scheme": ({"N": 8, "scheme": "x"}, 400),
    "fuse_roll": ({"N": 8, "fuse_steps": 2, "kernel": "roll"}, 400),
    "mesh_too_big": ({"N": 8, "mesh": [99, 99, 99]}, 400),
    "mesh_compensated": ({"N": 8, "mesh": [2, 1, 1],
                          "scheme": "compensated"}, 400),
    "bad_steps": ({"N": 8, "steps": 99}, 400),
    "body_bytes": ({"N": 8, "pad": "x" * 600}, 413),
    "lane_cells": ({"N": 14, "timesteps": 3}, 422),
    "unstable": ({"N": 8, "T": 26.0, "timesteps": 60,
                  "c2_field": "two-layer"}, 422),
}


@pytest.mark.parametrize("name", list(BAD))
def test_bad_bodies_same_status(replicas, name):
    jbase, tbase, _, _ = replicas
    body, code = BAD[name]
    jcode, jres = _post(jbase, body)
    tcode, tres = _post(tbase, body)
    assert jcode == tcode == code, (jres, tres)
    assert set(tres) == set(jres)


def test_malformed_json_same_status(replicas):
    jbase, tbase, _, _ = replicas
    assert _post(jbase, b"{nope")[0] == _post(tbase, b"{nope")[0] == 400


def test_draining_and_full_queue_same_status():
    """503 while draining, 429 on a full queue: the same codes, bodies
    and Retry-After contract on both replicas."""
    for max_queue, code in ((None, 503), (0, 429)):
        pair = [_start(japi.build_server, max_queue=max_queue),
                _start(api.build_server, device="cpu",
                       max_queue=max_queue)]
        try:
            answers = []
            for _, state, base in pair:
                state.draining = code == 503
                req = urllib.request.Request(
                    base + "/solve", data=b'{"N": 8, "timesteps": 3}',
                    headers={"Content-Type": "application/json"})
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(req, timeout=60)
                answers.append((ei.value.code, set(json.loads(
                    ei.value.read())), ei.value.headers.get("Retry-After")
                    is not None))
            assert answers[0] == answers[1] == (
                code, {"status", "error", "retriable"}, True)
        finally:
            for httpd, state, _ in pair:
                state.draining = False
                httpd.shutdown()
                state.batcher.close()
                httpd.server_close()


def test_healthz_and_metrics_views_agree(replicas):
    """After the same traffic: the /healthz and /metrics JSON key sets,
    the program_cache block's keys and the Prometheus metric names."""
    jbase, tbase, _, _ = replicas
    for body in (BODIES["standard"], BODIES["mesh"]):
        assert _post(jbase, body)[0] == _post(tbase, body)[0] == 200
    jh, th = _get(jbase, "/healthz"), _get(tbase, "/healthz")
    assert set(th) == set(jh)
    assert th["backend"] == jh["backend"] == "cpu"
    assert th["memory_bytes_in_use"] is None  # no card here
    jm, tm = _get(jbase, "/metrics"), _get(tbase, "/metrics")
    assert set(tm) == set(jm)
    assert set(tm["program_cache"]) == set(jm["program_cache"])
    assert set(tm["breaker"]) == set(jm["breaker"])
    assert set(tm["program_cache"]["warm_keys"]["memory"][0]) == \
        set(jm["program_cache"]["warm_keys"]["memory"][0])

    def names(base):
        _, types = parse_prometheus(_get(base, "/metrics", "text/plain"))
        return set(types)

    assert names(tbase) == names(jbase)


# ---- the item-12b flags set on both replicas ----


@pytest.fixture(scope="module")
def replicas_12b(tmp_path_factory):
    """wavetpu's replica and the port's with every item-12b flag set:
    the disk tier, chunked long solves with a state directory, the result
    cache and shadow sampling (wavetpu's on the CPU, roll)."""
    d = tmp_path_factory.mktemp("r12b")
    kw = dict(chunk_threshold=64, chunk_steps=1, result_cache=True,
              shadow_sample_rate=1.0, default_kernel="roll")
    j = _start(japi.build_server, program_cache_dir=str(d / "jpc"),
               solve_state_dir=str(d / "js"),
               fault_plan=_march_gate(jfaults.ServeFaultPlan)(), **kw)
    t = _start(api.build_server, device="cpu",
               program_cache_dir=str(d / "tpc"),
               solve_state_dir=str(d / "ts"),
               fault_plan=_march_gate(tfaults.ServeFaultPlan)(), **kw)
    yield j, t
    for httpd, state, _ in (j, t):
        httpd.shutdown()
        state.batcher.close()
        httpd.server_close()


def _march_gate(base):
    """A serve fault plan class (on `base`, wavetpu's ServeFaultPlan or
    the port's) that holds one chunked march at a chunk boundary: once
    `arm(timesteps, release_at)`ed, the first chunk pass of the
    `timesteps` tier goes through and the next one waits until
    `time.monotonic()` reaches `release_at`, then the gate disarms.
    Unarmed it fires nothing."""

    class Gate(base):
        def __init__(self):
            super().__init__([])
            self._lock = threading.Lock()
            self.timesteps = self.release_at = None
            self.passes = 0

        @property
        def active(self) -> bool:
            return True

        def arm(self, timesteps, release_at):
            with self._lock:
                self.timesteps, self.release_at = timesteps, release_at
                self.passes = 0

        def fire(self, kind, **ctx):
            with self._lock:
                if (kind != "slow-batch" or self.release_at is None
                        or str(ctx.get("timesteps")) != str(self.timesteps)):
                    return None
                self.passes += 1
                if self.passes < 2:
                    return None
                release_at, self.release_at = self.release_at, None
            time.sleep(max(0.0, release_at - time.monotonic()))
            return None

    return Gate


def _shadow_total(state):
    """Every shadow offer's outcome so far: twins run, failed or
    skipped (a busy sampler skips an offer)."""
    snap = state.shadow.snapshot()
    return snap["solves"] + snap["failures"] + sum(snap["skipped"].values())


def _wait_for_shadow_offer(state, n, timeout=300.0):
    """Wait until `_shadow_total` reaches n, then join the twin."""
    deadline = time.monotonic() + timeout
    while _shadow_total(state) < n:
        assert time.monotonic() < deadline, "shadow offer never resolved"
        time.sleep(0.05)
    assert state.shadow.wait_idle(timeout)


def _wait_shadows(state, n, timeout=300.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = state.shadow.snapshot()
        if snap["solves"] + snap["failures"] >= n:
            assert state.shadow.wait_idle(timeout)
            return
        time.sleep(0.05)
    raise AssertionError("shadow never resolved")


def test_12b_metrics_views_agree(replicas_12b):
    """With the 12b flags set, after the same traffic (a short solve
    twice - a store and a hit - and its shadow, and a chunked march): the
    /metrics and /healthz JSON key sets, the program-cache, result-cache
    and shadow blocks' keys and the Prometheus metric names are equal."""
    (jh, js, jbase), (th, ts, tbase) = replicas_12b
    for base, state in ((jbase, js), (tbase, ts)):
        for body in (BODIES["standard"], BODIES["standard"],
                     {"N": 8, "timesteps": 65}):
            assert _post(base, body)[0] == 200
        _wait_shadows(state, 1)
    jm, tm = _get(jbase, "/metrics"), _get(tbase, "/metrics")
    assert set(tm) == set(jm)
    for block in ("program_cache", "result_cache", "shadow", "breaker"):
        assert set(tm[block]) == set(jm[block]), block
    assert set(tm["program_cache"]["progcache"]) == \
        set(jm["program_cache"]["progcache"])
    assert tm["chunks_total"] == jm["chunks_total"] == 64
    assert tm["result_cache"]["events"]["hit"] == \
        jm["result_cache"]["events"]["hit"] == 1
    assert set(_get(tbase, "/healthz")) == set(_get(jbase, "/healthz"))

    def names(base):
        _, types = parse_prometheus(_get(base, "/metrics", "text/plain"))
        return set(types)

    assert names(tbase) == names(jbase)


# How often wavetpu's replica is asked again for a 504 with its token.
CUT_TRIES = 8
# The cut request's budget: far longer than a pickup from the idle queue,
# so the budget runs out while the gate holds the march, never in the
# queue.
CUT_BUDGET_MS = 1000


def test_12b_deadline_504_payload_with_token_agrees(replicas_12b):
    """A deadline that expires mid-march: 504 on both, the same payload
    keys with `resume_token`; each token resumes on its own replica to
    the uninterrupted answer.

    The cut lands mid-march by construction: the replica's gate holds the
    march at its second chunk boundary until the budget, counted from
    before the request was sent, has run out (and 20 ms more), so the
    chunk round after the gate finds the deadline passed, checkpoints and
    answers; the budget is long enough that no queue wait spends it.

    wavetpu's handler waits only 50 ms past the deadline for the chunk
    boundary's checkpoint (wavetpu/serve/api.py:890-897); on a loaded
    host (a slow checkpoint write) it answers 504 without the token.  So
    its cut request is repeated, up to CUT_TRIES times, until its answer
    carries one.  The port's handler waits for the checkpoint: its one
    answer must carry its token."""
    (_, jstate, jbase), (_, tstate, tbase) = replicas_12b
    body = {"N": 8, "timesteps": 793}
    keys = []
    for base, state, tries in ((jbase, jstate, CUT_TRIES),
                               (tbase, tstate, 1)):
        gate = state.fault_plan
        # A shadow twin left running by an earlier request would march
        # beside the cut below; join it before counting offers.
        assert state.shadow.wait_idle(300.0)
        seen = _shadow_total(state)
        # Warms every chunk program; `steps` keeps this answer's
        # result-cache key apart from the cut request's.
        code, whole = _post(base, dict(body, steps=793))
        assert code == 200 and whole["batch"]["chunked"] is True
        # Its shadow twin (or the offer's skip) comes first, so the cut
        # below finds the worker free.
        _wait_for_shadow_offer(state, seen + 1)
        for _ in range(tries):
            gate.arm(793, time.monotonic() + CUT_BUDGET_MS / 1e3 + 0.020)
            code, cut = _post(base, dict(body, deadline_ms=CUT_BUDGET_MS))
            assert code == 504, cut
            if "resume_token" in cut:
                break
        assert "resume_token" in cut, cut
        keys.append(set(cut))
        code, resumed = _post(base, dict(body,
                                         resume_token=cut["resume_token"]))
        assert code == 200
        assert resumed["report"]["abs_errors"] == \
            whole["report"]["abs_errors"]
    assert keys[0] == keys[1] == {"status", "error", "deadline_ms",
                                  "resume_token"}


def test_12b_drain_503_payload_with_token_agrees(tmp_path):
    """A drain mid-march checkpoints it: 503 on both replicas with the
    same payload keys, `resume_token` among them."""
    import time

    keys = []
    for build, kw in ((japi.build_server, {}),
                      (api.build_server, {"device": "cpu"})):
        plan_mod = (__import__("wavetpu.run.faults", fromlist=["x"])
                    if build is japi.build_server else
                    __import__("wavetpu_torch.run.faults", fromlist=["x"]))
        plan = plan_mod.parse_serve_spec(
            "serve-slow-batch:seconds=0.3,timesteps=33")
        httpd, state, base = _start(
            build, chunk_threshold=10, chunk_steps=4, fault_plan=plan,
            default_kernel="roll",
            solve_state_dir=str(tmp_path / build.__module__), **kw)
        out = {}
        th = threading.Thread(target=lambda: out.update(
            r=_post(base, {"N": 8, "timesteps": 33})))
        th.start()
        deadline = time.monotonic() + 120
        while (state.metrics.snapshot()["chunks_total"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        state.batcher.close(timeout=60.0, drain=True)
        th.join(120)
        httpd.shutdown()
        httpd.server_close()
        code, payload = out["r"]
        assert code == 503, payload
        keys.append(set(payload))
    assert keys[0] == keys[1] == {"status", "error", "retriable",
                                  "resume_token"}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_12b_warmup_manifest_readiness_agrees(tmp_path):
    """`serve --warmup-manifest`: both replicas (each its own process)
    warm the manifest's keys in the background and turn /healthz ready
    once they are warm, with the same /healthz keys."""
    import os
    import signal
    import subprocess
    import sys
    import time

    from wavetpu_torch.obs import ledger

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lp = str(tmp_path / "compile_ledger.jsonl")
    led = ledger.CompileLedger(lp)
    for n in (8, 12):
        led.record(dict(N=n, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=4,
                        scheme="standard", path="roll", k=1, dtype="f32",
                        with_field=False, compute_errors=True, batch=1,
                        mesh=None), 1.0, ts=1.0, pid=1)
    led.close()
    mp = str(tmp_path / "m.json")
    assert ledger.main([lp, "--emit-warmup-manifest", mp]) == 0
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    procs, bases = [], []
    for cmd in ([sys.executable, "-m", "wavetpu.serve.api",
                 "--kernel", "roll"],
                [sys.executable, "-m", "wavetpu_torch", "serve",
                 "--platform", "cpu"]):
        port = _free_port()
        procs.append(subprocess.Popen(
            cmd + ["--port", str(port), "--warmup-manifest", mp,
                   "--program-cache-dir", str(tmp_path / f"pc{port}")],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        bases.append(f"http://127.0.0.1:{port}")
    try:
        views = []
        for base in bases:
            deadline = time.monotonic() + 240
            view = None
            while time.monotonic() < deadline:
                try:
                    view = _get(base, "/healthz")
                    if view["ready"]:
                        break
                except OSError:
                    pass
                time.sleep(0.2)
            assert view is not None and view["ready"] is True, view
            views.append(view)
        assert set(views[0]) == set(views[1])
        for base in bases:
            warm = _get(base, "/metrics")["program_cache"]["warm_keys"]
            assert len(warm["memory"]) == 2
    finally:
        outs = []
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
            outs.append(proc.communicate(timeout=120)[0])
    for out in outs:
        assert "manifest warmup: 2 warmed, 0 skipped, 0 failed" in out, out
