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
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_obs import parse_prometheus
from wavetpu.serve import api as japi
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.ensemble import sharded as es
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
