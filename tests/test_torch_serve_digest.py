"""The final-state digest of a served lane (`probes` in a /solve body,
`final_probes` and `final_rms` in its report), on the CPU with the
kernels' plain versions.

Eight compensated k=4 requests released together form one batch of the
replica's normal path (build_server -> scheduler -> ServeEngine -> the
ensemble's K4 lanes).  Each answer's digest equals that of a solo
`solve_kfused_comp` at its phase bit for bit (the lane == solo contract
carried through the gather), and agrees with the benchmark's plain
float64 reference (wavebench/reference/digest.py); a lane answered with
its neighbour's state does not.  Malformed probes get 400, mesh and
chunked requests with probes 422, and a request without probes the
payload it got before the digest existed.

Every server a test starts is shut down in its teardown; every HTTP call
and thread join has a timeout.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from wavebench.reference import digest as ref_digest
from wavebench.reference import wave
from wavetpu_torch.client import WavetpuClient
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.obs import tracing
from wavetpu_torch.serve import engine as serve_engine
from wavetpu_torch.serve.api import MAX_PROBES, build_server
from wavetpu_torch.solver import kfused_comp

N, T, STEPS = 16, 0.5, 40
BODY = {"N": N, "T": T, "timesteps": STEPS, "scheme": "compensated",
        "fuse_steps": 4, "kernel": "pallas"}
PHASES = [0.1 + 0.77 * i for i in range(8)]
RNG = np.random.default_rng(2026)
# Each lane its own probes: they are not part of the program identity, so
# the eight still form one batch.  Lane 0 also probes a zero face.
PROBES = [RNG.integers(0, N, size=(6, 3)).tolist() for _ in PHASES]
PROBES[0][0] = [3, 0, 7]
# The program holds u and v in float32 with a bfloat16 carry; the
# reference marches in float64.  Their gap at this size is float32
# rounding over 40 layers plus the shifted-phase bootstrap's float32
# difference of two cosines (PERF.md section 2): at most 3e-6 on these
# phases.  A lane with its neighbour's state reads 1e-2 or more, and the
# program's bfloat16-increment path reads 4e-4 or more (tested below).
TOL = 2e-5


def _serve(**kw):
    kw.setdefault("device", "cpu")
    # A batch forms once its eight requests are in (the largest bucket),
    # or after max_wait: long enough that released requests never split.
    # The overload ladder would count those waits; it is not tested here.
    kw.setdefault("max_wait", 2.0)
    kw.setdefault("brownout", False)
    httpd, state = build_server(port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, state):
    httpd.shutdown()
    state.batcher.close()
    httpd.server_close()


def _post(base, body, timeout=120):
    req = urllib.request.Request(
        base + "/solve", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _together(base, bodies):
    """Post every body at once (a barrier releases them), so they reach
    the scheduler inside one batching window."""
    out = [None] * len(bodies)
    gate = threading.Barrier(len(bodies))

    def one(i):
        gate.wait(timeout=60)
        out[i] = _post(base, bodies[i])

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return out


def _batch(base):
    return _together(base, [dict(BODY, phase=p, probes=q)
                            for p, q in zip(PHASES, PROBES)])


@pytest.fixture(scope="module")
def served():
    """The replica, its first batch's eight answers, and the tracer's
    records of that batch."""
    httpd, state, base = _serve()
    records = []
    tracing.configure(os.devnull)._write = records.append
    try:
        answers = _batch(base)
    finally:
        tracing.disable()
    yield base, state, answers, records
    _stop(httpd, state)


@pytest.fixture(scope="module")
def solos():
    problem = Problem(N=N, Np=1, Lx=1.0, Ly=1.0, Lz=1.0, T=T,
                      timesteps=STEPS)
    return [kfused_comp.solve_kfused_comp(problem, torch.float32, k=4,
                                          device="cpu", phase=p)
            for p in PHASES]


def _report(answer):
    code, raw = answer
    assert code == 200, raw[:300]
    return json.loads(raw)["report"]


def _gaps(report, phase, probes):
    ref = ref_digest.digest(wave.Wave(N=N, Lx=1.0, Ly=1.0, Lz=1.0, T=T,
                                      timesteps=STEPS),
                            phase, "compensated", probes, "cpu")
    return (np.abs(np.subtract(report["final_probes"],
                               ref["final_probes"])).max(),
            abs(report["final_rms"] - ref["final_rms"]),
            np.abs(np.subtract(report["abs_errors"], ref["abs"])).max())


def test_the_eight_requests_form_one_batch(served):
    _, _, answers, _ = served
    for a in answers:
        code, raw = a
        assert code == 200, raw[:300]
        batch = json.loads(raw)["batch"]
        assert batch["occupancy"] == 8 and batch["batched"]
        assert "digest" not in batch


@pytest.mark.parametrize("lane", range(8))
def test_digest_equals_the_solo_solve_bit_for_bit(served, solos, lane):
    _, _, answers, _ = served
    report = _report(answers[lane])
    solo = solos[lane]
    want = serve_engine.final_digests(solo.u_prev[None], solo.u_cur[None],
                                      [PROBES[lane]])[0]
    assert report["final_probes"] == want["final_probes"]
    assert report["final_rms"] == want["final_rms"]
    # The probes are the solo solve's own last two layers at the nodes.
    assert report["final_probes"] == [
        [float(solo.u_cur[i, j, k]), float(solo.u_prev[i, j, k])]
        for i, j, k in PROBES[lane]]
    assert report["abs_errors"] == [float(x) for x in solo.abs_errors]


@pytest.mark.parametrize("lane", range(8))
def test_digest_agrees_with_the_plain_reference(served, lane):
    _, _, answers, _ = served
    gaps = _gaps(_report(answers[lane]), PHASES[lane], PROBES[lane])
    assert max(gaps) <= TOL, gaps


def test_final_rms_is_the_float64_root_mean_square(solos):
    u = solos[3].u_cur
    got = serve_engine.final_digests(u[None], u[None], [[]])[0]
    assert got["final_probes"] == []
    assert got["final_rms"] == pytest.approx(
        float(u.double().square().mean().sqrt()), rel=1e-14)


def test_a_lane_rotation_under_the_engine_is_caught():
    from wavebench.generators.serve import rotate_lanes

    httpd, state, base = _serve()
    try:
        rotate_lanes(state.engine)
        answers = _batch(base)
    finally:
        _stop(httpd, state)
    for lane in range(8):
        assert json.loads(answers[lane][1])["batch"]["occupancy"] == 8
        gaps = _gaps(_report(answers[lane]), PHASES[lane], PROBES[lane])
        assert gaps[0] > 100 * TOL and gaps[1] > TOL, (lane, gaps)


def test_the_lower_precision_path_is_caught():
    from wavebench.generators.serve import lower_precision

    httpd, state, base = _serve()
    try:
        lower_precision({"k": 4, "v_dtype": "bfloat16",
                         "carry": False})(state.engine)
        answers = _together(base, [dict(BODY, phase=p, probes=q)
                                   for p, q in zip(PHASES[:2],
                                                   PROBES[:2])])
    finally:
        _stop(httpd, state)
    for lane in range(2):
        gaps = _gaps(_report(answers[lane]), PHASES[lane], PROBES[lane])
        assert max(gaps) > TOL, (lane, gaps)


@pytest.mark.parametrize("probes", [
    "x", {"i": 1}, [[1, 2]], [[1, 2, 3, 4]], [[N, 0, 0]], [[-1, 0, 0]],
    [[1.0, 2, 3]], [[True, 2, 3]], [["1", 2, 3]], [1, 2, 3],
    [[0, 0, 0]] * (MAX_PROBES + 1),
])
def test_malformed_probes_get_400(served, probes):
    base = served[0]
    code, raw = _post(base, dict(BODY, phase=1.0, probes=probes))
    assert code == 400, raw[:300]
    assert "probe" in json.loads(raw)["error"]


def test_mesh_request_with_probes_gets_422(served):
    base = served[0]
    code, raw = _post(base, {"N": N, "timesteps": 8, "mesh": [2, 1, 1],
                             "probes": [[1, 1, 1]]})
    assert code == 422, raw[:300]
    assert "mesh" in json.loads(raw)["error"]


def test_chunked_request_with_probes_gets_422():
    httpd, state, base = _serve(chunk_threshold=8, chunk_steps=4)
    try:
        code, raw = _post(base, {"N": N, "timesteps": 8,
                                 "probes": [[1, 1, 1]]})
        plain, _ = _post(base, {"N": N, "timesteps": 8})
    finally:
        _stop(httpd, state)
    assert code == 422, raw[:300]
    assert "chunked" in json.loads(raw)["error"]
    assert plain == 200


OLD_TOP = ["status", "report", "report_text", "batch"]
OLD_REPORT = ["problem", "courant", "init_seconds", "solve_seconds",
              "gcells_per_second", "cells_per_step", "final_step",
              "errors_computed", "max_abs_error", "abs_errors", "rel_errors"]
OLD_BATCH = ["occupancy", "batch_size", "batched", "fallback_reason", "path",
             "padding_lanes", "aggregate_gcells_per_s", "warm", "timing"]


def test_without_probes_the_payload_is_as_before(served):
    """A request without probes, batched with one that has them, gets the
    payload of a replica without the digest: the same keys in the same
    order, serialized by the same json.dumps, and the same numbers as
    its solo solve."""
    base = served[0]
    (c0, raw), (c1, _) = _together(base, [
        dict(BODY, phase=PHASES[2]),
        dict(BODY, phase=PHASES[5], probes=PROBES[5])])
    assert (c0, c1) == (200, 200)
    payload = json.loads(raw)
    assert list(payload) == OLD_TOP
    assert list(payload["report"]) == OLD_REPORT
    assert list(payload["batch"]) == OLD_BATCH
    assert payload["batch"]["occupancy"] == 2
    assert raw == json.dumps(payload).encode()


def test_digest_spans_and_counter(served):
    base, state, _, records = served
    kinds = [r["kind"] for r in records if r.get("type") == "span"]
    assert kinds.count("serve.parse") == 8
    assert kinds.count("serve.respond") == 8
    assert kinds.count("serve.digest") == 1
    digest = next(r for r in records if r.get("kind") == "serve.digest")
    assert digest["attrs"] == {"lanes": 8, "probes": 48}
    assert state.engine.registry.counter(
        "wavetpu_serve_probes_total").value() >= 48
    with urllib.request.urlopen(urllib.request.Request(
            base + "/metrics", headers={"Accept": "text/plain"}),
            timeout=30) as r:
        text = r.read().decode()
    assert any(line.startswith("wavetpu_serve_probes_total ")
               for line in text.splitlines())


def test_result_cache_never_answers_a_request_with_probes():
    httpd, state, base = _serve(result_cache=True)
    try:
        body = dict(BODY, phase=0.3)
        first = _post(base, body)
        hit = _post(base, body)
        with_probes = _post(base, dict(body, probes=[[2, 3, 4]]))
    finally:
        _stop(httpd, state)
    assert first[0] == hit[0] == with_probes[0] == 200
    assert hit[1] == first[1]
    report = json.loads(with_probes[1])["report"]
    assert len(report["final_probes"]) == 1 and report["final_rms"] > 0


def test_client_passes_probes_through(served):
    base = served[0]
    out = WavetpuClient(base, retries=0, timeout=120).solve(
        dict(BODY, phase=PHASES[1]), probes=[(1, 2, 3)])
    assert out.ok, out.error
    assert len(out.payload["report"]["final_probes"]) == 1
    assert out.payload["report"]["final_rms"] == _report(
        served[2][1])["final_rms"]
