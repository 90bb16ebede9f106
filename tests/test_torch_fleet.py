"""The port's fleet tier (wavetpu_torch/fleet/) on the CPU, class by class
after wavetpu's tests/test_fleet.py: the shared ProgramKey derivation
(router == engine, and the port's affinity keys == wavetpu's), health-gated
membership, the warm-key affinity table, the router proxy seam with
scripted members (stdlib only), the deadline budget, API keys, tracing,
chaos at one member of a two-replica fleet, and the rolling-deploy drill -
the replicas being the port's own (`device="cpu"`, the kernels' plain
versions).

Beside those, the shared contract with wavetpu: `price_cells` equal over a
grid of bodies, the routers' /metrics key sets and Prometheus names equal,
and the north star - an unmodified `wavetpu.fleet.router` (imported here,
never by the package) fronting two port replicas: affinity hits, a drain
handoff with a `resume_token`, and every answer bit-equal to its
`solve_ensemble` lane; the port's router held to the same.

Nothing here depends on the host's speed: a drill waits for the state it
needs by polling against a deadline (a long march is held mid-flight by a
gate, not by a sleep), and every socket call and join has a timeout.
"""

import json
import random
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from wavetpu import progkey as jprogkey
from wavetpu.fleet import quota as jquota
from wavetpu.fleet import router as jrouter
from wavetpu_torch import progkey
from wavetpu_torch.client import WavetpuClient
from wavetpu_torch.fleet.affinity import (
    AffinityTable,
    warm_label_from_server_timing,
)
from wavetpu_torch.fleet.membership import (
    EJECTED,
    JOINING,
    LEAVING,
    LEFT,
    UP,
    MembershipTable,
)
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.fleet import quota
from wavetpu_torch.fleet import router as trouter
from wavetpu_torch.fleet.router import build_router, load_api_keys
from wavetpu_torch.fleet import roll as fleet_roll
from wavetpu_torch.loadgen import report as lg_report
from wavetpu_torch.loadgen import runner, trace
from wavetpu_torch.run import faults
from wavetpu_torch.serve.api import build_server, parse_solve_request


# ---- the shared key derivation: router == engine, pinned ----


class TestSharedKeyDerivation:
    BODIES = [
        {"N": 8, "timesteps": 4},
        {"N": 8, "timesteps": 4, "phase": 1.0},   # same identity
        {"N": 12, "timesteps": 6, "Lx": "pi", "dtype": "f64"},
        {"N": 8, "timesteps": 4, "scheme": "compensated"},
        {"N": 8, "timesteps": 4, "kernel": "pallas", "fuse_steps": 2},
        {"N": 8, "timesteps": 4, "c2_field": "gaussian-lens"},
        {"N": 8, "timesteps": 4, "mesh": [1, 1, 2]},
    ]

    def test_router_identity_matches_engine_program_key(self):
        """THE drift pin: for every body shape the fleet serves, the
        affinity key the router derives (progkey.identity_from_body,
        no torch) equals the affinity projection of the ProgramKey the
        engine actually caches under (parse_solve_request -> the
        engine's for_batch key)."""
        for body in self.BODIES:
            ident = progkey.identity_from_body(body, platform="cpu")
            req = parse_solve_request(body, platform="cpu")
            engine_key = progkey.ProgramKey.for_batch(
                req.problem, req.scheme, req.path, req.k,
                req.dtype_name,
                with_field=req.lane.c2tau2_field is not None,
                compute_errors=True, batch=4, mesh=req.mesh_shape,
            )
            assert ident.affinity_key() == progkey.affinity_key(
                engine_key
            ), body

    def test_affinity_key_ignores_batch_and_compute_errors(self):
        ident = progkey.identity_from_body(
            {"N": 8, "timesteps": 4}, platform="cpu"
        )
        keys = {
            progkey.affinity_key(ident.program_key(b, ce))
            for b in (1, 2, 4, 8) for ce in (True, False)
        }
        assert keys == {ident.affinity_key()}

    def test_identity_rejects_what_the_server_rejects(self):
        for body in (
            {"timesteps": 4},                       # missing N
            {"N": 8, "scheme": "magic"},
            {"N": 8, "dtype": "f16"},
            {"N": 8, "fuse_steps": 2, "kernel": "roll"},
            {"N": 8, "scheme": "compensated", "dtype": "bf16"},
            {"N": 8, "mesh": [2, 2]},
            {"N": 8, "mesh": [1, 1, 2], "fuse_steps": 2,
             "kernel": "pallas"},
        ):
            with pytest.raises(ValueError):
                progkey.identity_from_body(body, platform="cpu")

    def test_warm_keys_flatten_dedup_and_skip_malformed(self):
        kd = progkey.key_from_program_key(
            progkey.identity_from_body(
                {"N": 8, "timesteps": 4}, platform="cpu"
            ).program_key(4, True)
        )
        other = dict(kd, batch=8)           # same tier, other bucket
        warm = {
            "memory": [kd, "junk", None],
            "disk": [other, {"not": "a key"}],
        }
        aks = progkey.warm_keys_to_affinity(warm)
        assert aks == [progkey.affinity_key_from_dict(kd)]

    # Bodies for the two packages' key parity: every knob the identity
    # reads, with explicit kernels (auto differs on the card, below).
    PARITY_BODIES = BODIES + [
        {"N": 16, "timesteps": 20, "T": 2.0, "Ly": 0.5, "Lz": "pi"},
        {"N": 8, "timesteps": 9, "scheme": "compensated",
         "fuse_steps": 4, "kernel": "pallas"},
        {"N": 8, "timesteps": 4, "kernel": "roll", "dtype": "bf16"},
        {"N": 8, "timesteps": 4, "kernel": "pallas"},
        {"N": 8, "timesteps": 4, "c2_field": "two-layer",
         "kernel": "pallas", "fuse_steps": 2},
        {"N": 12, "timesteps": 6, "mesh": [2, 2, 1], "kernel": "roll"},
        {"N": 8, "timesteps": 4, "steps": 2, "phase": 0.5},
    ]

    @pytest.mark.parametrize("platform", ["cpu", "gpu"])
    def test_affinity_keys_equal_wavetpus(self, platform):
        """The port's affinity key of a body equals wavetpu's, so either
        package's router lands the body on the replica that advertises
        it.  On "gpu" a body that leaves `kernel` to auto resolves to the
        CUDA kernels (pallas) in the port and to roll in wavetpu (whose
        pallas means the TPU): the one place the keys part, by design."""
        assert progkey.AFFINITY_FIELDS == jprogkey.AFFINITY_FIELDS
        for body in self.PARITY_BODIES:
            mine = progkey.identity_from_body(body, platform=platform)
            theirs = jprogkey.identity_from_body(body, platform=platform)
            if platform == "gpu" and "kernel" not in body \
                    and "fuse_steps" not in body:
                assert mine.path == "pallas" and theirs.path == "roll"
                continue
            assert mine.affinity_key() == theirs.affinity_key(), body
            kd = progkey.key_from_program_key(mine.program_key(4, True))
            assert progkey.affinity_key_from_dict(kd) == \
                jprogkey.affinity_key_from_dict(kd)
            warm = {"memory": [kd, "junk"], "disk": [dict(kd, batch=8)]}
            assert progkey.warm_keys_to_affinity(warm) == \
                jprogkey.warm_keys_to_affinity(warm)

    def test_warm_label_parse(self):
        h = ("queue;dur=1.2, compile;dur=0.0, execute;dur=45, "
             "warm;desc=disk, total;dur=50")
        assert warm_label_from_server_timing(h) == "disk"
        assert warm_label_from_server_timing("execute;dur=4") is None
        assert warm_label_from_server_timing(None) is None


# ---- membership state machine (fake transport, zero sockets) ----


class _FakeFleet:
    """Scriptable fetch: per-url healthz/metrics payloads or raised
    transport errors."""

    def __init__(self):
        self.health = {}     # url -> dict | Exception
        self.prom = {}       # url -> str
        self.warm = {}       # url -> warm_keys dict

    def fetch(self, base_url, path, timeout, accept=None):
        url = base_url.rstrip("/")
        if path == "/healthz":
            h = self.health.get(url, ConnectionRefusedError("down"))
            if isinstance(h, Exception):
                raise h
            return 200, json.dumps(h)
        if path == "/metrics":
            h = self.health.get(url)
            if isinstance(h, Exception) or h is None:
                raise ConnectionRefusedError("down")
            if accept == "application/json":
                return 200, json.dumps({
                    "queue_depth": 0,
                    "program_cache": {
                        "warm_keys": self.warm.get(url, {}),
                    },
                })
            return 200, self.prom.get(url, "")
        raise AssertionError(f"unexpected path {path}")


READY = {"status": "ok", "ready": True, "backend": "cpu"}
DRAINING = {"status": "ok", "ready": False, "draining": True}


class TestMembership:
    def _table(self, urls, **kw):
        fleet = _FakeFleet()
        for u in urls:
            fleet.health[u] = dict(READY)
        table = MembershipTable(urls, fetch=fleet.fetch, **kw)
        return fleet, table

    def test_joining_to_up_on_ready(self):
        fleet, table = self._table(["http://a:1"])
        assert table.get("http://a:1").state == JOINING
        table.poll_once()
        assert table.get("http://a:1").state == UP
        assert table.routable_urls() == ["http://a:1"]

    def test_ready_false_ejects_immediately_and_readmits(self):
        fleet, table = self._table(["http://a:1"])
        table.poll_once()
        fleet.health["http://a:1"] = dict(DRAINING)
        table.poll_once()
        m = table.get("http://a:1")
        assert m.state == EJECTED and not table.routable_urls()
        fleet.health["http://a:1"] = dict(READY)
        table.poll_once()
        assert m.state == UP  # recovery re-admits, no operator action

    def test_transport_failures_eject_at_threshold_only(self):
        fleet, table = self._table(["http://a:1"], fail_threshold=3)
        table.poll_once()
        fleet.health["http://a:1"] = ConnectionRefusedError("boom")
        table.poll_once()
        table.poll_once()
        assert table.get("http://a:1").state == UP  # 2 < threshold
        table.poll_once()
        assert table.get("http://a:1").state == EJECTED
        fleet.health["http://a:1"] = dict(READY)
        table.poll_once()
        m = table.get("http://a:1")
        assert m.state == UP and m.consecutive_failures == 0

    def test_leave_retire_freezes_counters_for_aggregation(self):
        fleet, table = self._table(["http://a:1", "http://b:2"])
        fleet.prom["http://a:1"] = "wavetpu_x_total 5\n"
        fleet.prom["http://b:2"] = "wavetpu_x_total 7\n"
        table.poll_once()
        assert table.aggregate_prom(refresh=False) == {
            "wavetpu_x_total": 12.0
        }
        table.leave("http://a:1")
        assert table.get("http://a:1").state == LEAVING
        assert table.routable_urls() == ["http://b:2"]
        table.retire("http://a:1")
        assert table.get("http://a:1").state == LEFT
        # a is gone from the network...
        fleet.health["http://a:1"] = ConnectionRefusedError("gone")
        fleet.prom["http://b:2"] = "wavetpu_x_total 9\n"
        table.poll_once()
        # ...but its final counters stay in the sum: monotonic deltas
        # across a roll.
        assert table.aggregate_prom(refresh=False) == {
            "wavetpu_x_total": 14.0
        }

    def test_join_baseline_excludes_prejoin_history(self):
        """A member admitted mid-flight (the /admin/join path) must
        contribute only growth SINCE join to the fleet aggregate - its
        manifest-warmup compiles happened before it was fleet."""
        fleet, table = self._table(["http://a:1"])
        fleet.prom["http://a:1"] = "wavetpu_x_total 5\n"
        table.poll_once()
        # the successor arrives carrying 3 pre-join compiles and a
        # nonzero gauge
        fleet.health["http://b:2"] = dict(READY)
        fleet.prom["http://b:2"] = (
            "wavetpu_x_total 3\nwavetpu_gauge 2\n"
        )
        m = table.add("http://b:2", baseline=True)
        table.poll_member(m)
        agg = table.aggregate_prom(refresh=False)
        # counter baselined away; the gauge passes through absolute
        assert agg["wavetpu_x_total"] == 5.0
        assert agg["wavetpu_gauge"] == 2.0
        # growth after join counts
        fleet.prom["http://b:2"] = (
            "wavetpu_x_total 4\nwavetpu_gauge 0\n"
        )
        table.poll_once()
        agg = table.aggregate_prom(refresh=False)
        assert agg["wavetpu_x_total"] == 6.0
        assert agg["wavetpu_gauge"] == 0.0

    def test_poll_feeds_affinity_warm_keys(self):
        aff = AffinityTable(rng=random.Random(0))
        fleet = _FakeFleet()
        fleet.health["http://a:1"] = dict(READY)
        kd = progkey.key_from_program_key(
            progkey.identity_from_body(
                {"N": 8, "timesteps": 4}, platform="cpu"
            ).program_key(4, True)
        )
        fleet.warm["http://a:1"] = {"memory": [kd], "disk": []}
        table = MembershipTable(
            ["http://a:1"], fetch=fleet.fetch, affinity=aff
        )
        table.poll_once()
        ak = progkey.affinity_key_from_dict(kd)
        assert aff.holders(ak) == {"http://a:1"}
        assert table.get("http://a:1").warm_key_count == 1


# ---- affinity table ----


class TestAffinityTable:
    AK1, AK2 = '{"k": 1}', '{"k": 2}'

    def test_poll_replace_and_response_add(self):
        t = AffinityTable(rng=random.Random(0))
        t.observe_response("http://a", self.AK1, "false")  # just compiled
        t.observe_response("http://a", self.AK2, "fallback")  # no program
        assert t.holders(self.AK1) == {"http://a"}
        assert t.holders(self.AK2) == set()
        # poll REPLACES a's set; response-learned key not in the poll
        # is dropped (evicted server-side)
        t.observe_response("http://b", self.AK1, "disk")
        t.observe_warm_keys("http://a", {"memory": [], "disk": []})
        assert t.holders(self.AK1) == {"http://b"}

    def test_choose_counts_hit_rerouted_cold_unkeyed(self):
        t = AffinityTable(rng=random.Random(0))
        load = lambda u: 0.0  # noqa: E731
        t.observe_response("http://a", self.AK1, "true")
        assert t.choose(self.AK1, ["http://a", "http://b"], load) \
            == "http://a"
        # holder exists but is not a candidate (ejected): rerouted
        assert t.choose(self.AK1, ["http://b"], load) == "http://b"
        t.choose(self.AK2, ["http://a", "http://b"], load)   # cold
        t.choose(None, ["http://a"], load)                   # unkeyed
        s = t.stats()
        assert (s["hits"], s["rerouted"], s["cold"], s["unkeyed"]) \
            == (1, 1, 1, 1)
        assert s["hit_rate"] == 0.5

    def test_p2c_prefers_lower_load(self):
        t = AffinityTable(rng=random.Random(42))
        loads = {"http://a": 9.0, "http://b": 0.0}
        picks = {
            t.choose(None, ["http://a", "http://b"], loads.get)
            for _ in range(16)
        }
        assert picks == {"http://b"}  # both sampled each time: 2 of 2

    def test_forget_member(self):
        t = AffinityTable(rng=random.Random(0))
        t.observe_response("http://a", self.AK1, "true")
        t.forget_member("http://a")
        assert t.holders(self.AK1) == set()
        assert t.known_keys() == 0


# ---- scripted members: the router proxy seam, stdlib only ----


class _ScriptedMember:
    """A fake replica speaking the serve contract's fleet-facing
    subset: /healthz, /metrics (JSON + Prometheus), /solve (scripted
    or default-200 with a warm label), /admin/drain."""

    def __init__(self, warm_keys=None, prom="wavetpu_y_total 1\n"):
        self.lock = threading.Lock()
        self.ready = True
        self.draining = False
        self.warm_keys = warm_keys or {"memory": [], "disk": []}
        self.prom = prom
        self.queue_depth = 0     # the JSON /metrics load signal
        self.solve_script = []   # (status, payload, headers) or "drop"
        self.solves = 0
        self.seen_headers = []   # per /solve attempt: request headers
        self.seen_bodies = []    # per /solve attempt: raw request body

        state = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, code, payload, headers=None,
                      content_type="application/json"):
                raw = (payload if isinstance(payload, bytes)
                       else json.dumps(payload).encode())
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(raw)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                if self.path == "/healthz":
                    with state.lock:
                        self._send(200, {
                            "status": "ok",
                            "ready": state.ready and not state.draining,
                            "draining": state.draining,
                            "backend": "cpu",
                        })
                elif self.path == "/metrics":
                    accept = self.headers.get("Accept", "") or ""
                    if "application/json" in accept:
                        with state.lock:
                            self._send(200, {
                                "queue_depth": state.queue_depth,
                                "program_cache": {
                                    "warm_keys": state.warm_keys,
                                },
                            })
                    else:
                        with state.lock:
                            self._send(
                                200, state.prom.encode(),
                                content_type="text/plain",
                            )
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(length)
                if self.path == "/solve":
                    with state.lock:
                        state.seen_headers.append(dict(self.headers))
                        state.seen_bodies.append(raw)
                if self.path == "/admin/drain":
                    with state.lock:
                        state.draining = True
                    self._send(200, {"status": "ok", "draining": True},
                               {"Connection": "close"})
                    return
                with state.lock:
                    state.solves += 1
                    if state.draining:
                        self._send(503, {
                            "status": "error", "error": "draining",
                            "retriable": True,
                        }, {"Retry-After": "2", "Connection": "close"})
                        return
                    step = (state.solve_script.pop(0)
                            if state.solve_script else None)
                if step == "drop":
                    self.close_connection = True
                    self.connection.close()
                    return
                if step is not None:
                    self._send(*step)
                    return
                self._send(200, {"status": "ok", "report": {}}, {
                    "Server-Timing": "execute;dur=1, warm;desc=true",
                })

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        ).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _start_router(member_urls, **kw):
    kw.setdefault("poll_interval_s", 60.0)  # tests poll explicitly
    kw.setdefault("rng", random.Random(0))
    httpd, state = build_router(member_urls, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(base, path, body, timeout=30, headers=None):
    import urllib.error

    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(base, path, accept=None, timeout=30):
    req = urllib.request.Request(
        base + path, headers={"Accept": accept} if accept else {}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


class TestRouterProxy:
    BODY = {"N": 8, "timesteps": 4}

    def _ak(self, body=None):
        return progkey.identity_from_body(
            body or self.BODY, platform="cpu"
        ).affinity_key()

    def test_routes_warm_key_to_advertised_holder(self):
        """Bootstrap affinity: B advertises the key in its /metrics
        warm_keys (disk inheritance); every request for it lands on B
        even though A is equally healthy."""
        kd = progkey.key_from_program_key(
            progkey.identity_from_body(
                self.BODY, platform="cpu"
            ).program_key(4, True)
        )
        a = _ScriptedMember()
        b = _ScriptedMember(warm_keys={"memory": [], "disk": [kd]})
        httpd, state, base = _start_router([a.url, b.url])
        try:
            for _ in range(4):
                code, _, headers = _post(base, "/solve", self.BODY)
                assert code == 200
                assert headers["X-Wavetpu-Member"] == b.url
            assert a.solves == 0 and b.solves == 4
            assert state.affinity.stats()["hits"] == 4
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close(); b.close()

    def test_response_warm_label_builds_affinity(self):
        """No poll data at all: the first (cold) response's warm label
        pins the key to whichever member served it."""
        a, b = _ScriptedMember(), _ScriptedMember()
        httpd, state, base = _start_router([a.url, b.url])
        try:
            _, _, headers = _post(base, "/solve", self.BODY)
            first = headers["X-Wavetpu-Member"]
            for _ in range(5):
                _, _, h = _post(base, "/solve", self.BODY)
                assert h["X-Wavetpu-Member"] == first
            s = state.affinity.stats()
            assert s["cold"] == 1 and s["hits"] == 5
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close(); b.close()

    def test_draining_503_retried_on_live_member_not_surfaced(self):
        """Satellite: the cutover seam.  A drained member's 503 +
        Retry-After is absorbed by the ROUTER (retried onto the live
        member); a zero-retry client sees only 200s."""
        kd = progkey.key_from_program_key(
            progkey.identity_from_body(
                self.BODY, platform="cpu"
            ).program_key(4, True)
        )
        # a advertises the key -> every first pick deterministically
        # lands on a, which is ALREADY draining (the router learns only
        # at the next poll - exactly the cutover race).
        a = _ScriptedMember(warm_keys={"memory": [kd], "disk": []})
        b = _ScriptedMember()
        # b's responses carry no warm label, so b never becomes a
        # holder and every first pick keeps landing on (draining) a.
        b.solve_script = [(200, {"status": "ok"}, {})] * 4
        httpd, state, base = _start_router([a.url, b.url])
        try:
            a.draining = True
            for _ in range(4):
                code, payload, headers = _post(base, "/solve", self.BODY)
                assert code == 200, payload
                assert headers["X-Wavetpu-Member"] == b.url
            snap = state.snapshot()
            # every request first hit draining a, was retried onto b,
            # and none failed
            assert snap["exhausted_total"] == 0
            assert snap["retried_requests"] == 4
            assert a.solves == 4 and b.solves == 4
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close(); b.close()

    @pytest.mark.parametrize("router_mod", [trouter, jrouter],
                             ids=["port_router", "wavetpu_router"])
    def test_retry_keeps_to_a_live_holder(self, router_mod):
        """The port's one routing change: a retried request (here a
        drained holder's 503) goes to another live HOLDER of its key
        when there is one - where a resumed march finds its tier's
        kernels loaded - even past a less loaded non-holder.  wavetpu's
        router takes the least-loaded pair of all candidates (b)."""
        kd = progkey.key_from_program_key(
            progkey.identity_from_body(
                self.BODY, platform="cpu"
            ).program_key(4, True)
        )
        a = _ScriptedMember(warm_keys={"memory": [kd], "disk": []})
        b = _ScriptedMember()
        c = _ScriptedMember(warm_keys={"memory": [], "disk": [kd]})
        c.queue_depth = 5   # the first pick among the holders is a
        # b's answers carry no warm label: b never becomes a holder
        b.solve_script = [(200, {"status": "ok"}, {})] * 4
        httpd, state = router_mod.build_router(
            [a.url, b.url, c.url], poll_interval_s=60.0,
            rng=random.Random(0), start_poller=False)
        # a drains after the router's only poll: it keeps routing there
        a.draining = True
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        want = c if router_mod is trouter else b
        try:
            for _ in range(4):
                code, payload, headers = _post(base, "/solve", self.BODY)
                assert code == 200, payload
                assert headers["X-Wavetpu-Member"] == want.url
            assert a.solves == 4 and want.solves == 4
            assert state.snapshot()["retried_requests"] == 4
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close(); b.close(); c.close()

    def test_connection_drop_retried_on_other_member(self):
        kd = progkey.key_from_program_key(
            progkey.identity_from_body(
                self.BODY, platform="cpu"
            ).program_key(4, True)
        )
        a = _ScriptedMember(warm_keys={"memory": [kd], "disk": []})
        b = _ScriptedMember()
        a.solve_script = ["drop"]  # first hit at holder a: severed conn
        httpd, state, base = _start_router([a.url, b.url])
        try:
            for _ in range(3):
                code, payload, _ = _post(base, "/solve", self.BODY)
                assert code == 200, payload
            assert state.snapshot()["retried_requests"] >= 1
            assert a.solves >= 1 and b.solves >= 1
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close(); b.close()

    def test_all_members_down_yields_retriable_503(self):
        a, b = _ScriptedMember(), _ScriptedMember()
        a.draining = True
        b.draining = True
        httpd, state, base = _start_router([a.url, b.url])
        try:
            code, payload, headers = _post(base, "/solve", self.BODY)
            assert code == 503
            assert payload.get("retriable") is True or \
                "Retry-After" in headers
            assert "Retry-After" in headers
            assert state.snapshot()["exhausted_total"] == 1
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close(); b.close()

    def test_malformed_body_forwarded_replica_owns_the_400(self):
        a = _ScriptedMember()
        a.solve_script = [(400, {"status": "error",
                                 "error": "missing required field N"},
                           {})]
        httpd, state, base = _start_router([a.url])
        try:
            code, payload, _ = _post(base, "/solve", {"junk": True})
            assert code == 400 and "missing" in payload["error"]
            assert state.snapshot()["unparseable_total"] == 1
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close()

    def test_healthz_and_admin_join_leave(self):
        a, b = _ScriptedMember(), _ScriptedMember()
        httpd, state, base = _start_router([a.url])
        try:
            _, text = _get(base, "/healthz")
            h = json.loads(text)
            assert h["ready"] is True and h["members_up"] == 1
            code, payload, _ = _post(base, "/admin/join", {"url": b.url})
            assert code == 200
            assert payload["member"]["state"] == "up"  # synchronous poll
            _, text = _get(base, "/healthz")
            assert json.loads(text)["members_up"] == 2
            code, _, _ = _post(
                base, "/admin/leave",
                {"url": a.url, "sync": True, "drain_wait_s": 2.0},
            )
            assert code == 200
            assert a.draining is True  # router POSTed /admin/drain
            m = state.table.get(a.url)
            assert m.state == LEFT
            code, payload, _ = _post(base, "/admin/leave",
                                     {"url": "http://nope:1"})
            assert code == 404
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close(); b.close()

    def test_metrics_aggregation_monotonic_across_leave(self):
        a = _ScriptedMember(prom="wavetpu_y_total 5\n")
        b = _ScriptedMember(prom="wavetpu_y_total 3\n")
        httpd, state, base = _start_router([a.url, b.url])
        try:
            _, text = _get(base, "/metrics", accept="text/plain")
            samples = runner.parse_prometheus_text(text)
            assert samples["wavetpu_y_total"] == 8.0
            assert "wavetpu_router_requests_total" in samples
            _post(base, "/admin/leave",
                  {"url": a.url, "sync": True, "drain_wait_s": 1.0})
            a.close()  # the process is gone
            b.prom = "wavetpu_y_total 4\n"
            _, text = _get(base, "/metrics", accept="text/plain")
            samples = runner.parse_prometheus_text(text)
            # a's final 5 frozen in, b refreshed to 4: still monotonic
            assert samples["wavetpu_y_total"] == 9.0
            assert samples['wavetpu_router_members{state="left"}'] == 1
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            b.close()

    def test_json_metrics_expose_affinity_and_members(self):
        a = _ScriptedMember()
        httpd, state, base = _start_router([a.url])
        try:
            _post(base, "/solve", self.BODY)
            _, text = _get(base, "/metrics")
            snap = json.loads(text)
            assert snap["router"] is True
            assert set(snap["affinity"]) >= {
                "hits", "rerouted", "cold", "hit_rate", "known_keys",
            }
            assert snap["members"][0]["proxied_total"] == 1
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            a.close()


# ---- real fleet: chaos at one member, absorbed at the router seam ----


def _hget(headers: dict, name: str):
    return {k.lower(): v for k, v in headers.items()}.get(name.lower())


class TestRouterDeadlineBudget:
    """Satellite: the router forwards X-Deadline-Ms DECREMENTED by its
    own wall, refuses doomed retries below --min-retry-budget-ms, and
    re-injects a draining member's resume_token into the retried body
    (the cross-replica solve handoff seam, scripted)."""

    BODY = {"N": 8, "timesteps": 4}

    def _pin(self, member):
        """A warm-key advertisement pinning BODY's first pick to
        `member` (the test needs attempt order deterministic)."""
        kd = progkey.key_from_program_key(
            progkey.identity_from_body(
                self.BODY, platform="cpu"
            ).program_key(4, True)
        )
        member.warm_keys = {"memory": [kd], "disk": []}

    def test_deadline_decremented_and_token_reinjected_on_retry(self):
        token = "ab" * 32
        m1, m2 = _ScriptedMember(), _ScriptedMember()
        self._pin(m1)
        m1.solve_script = [(503, {
            "status": "error", "error": "draining: checkpointed",
            "retriable": True, "resume_token": token,
        }, {"Retry-After": "1"})]
        httpd, state, base = _start_router([m1.url, m2.url])
        try:
            state.table.poll_once()
            code, payload, _ = _post(
                base, "/solve", self.BODY,
                headers={"X-Deadline-Ms": "200000"},
            )
            assert code == 200
            assert m1.solves == 1 and m2.solves == 1
            # both attempts carried a budget; the retry's is the
            # REMAINING budget, never more than the original
            d1 = float(_hget(m1.seen_headers[0], "X-Deadline-Ms"))
            d2 = float(_hget(m2.seen_headers[0], "X-Deadline-Ms"))
            assert 0 < d1 <= 200000
            assert 0 < d2 <= d1
            # the drained member's token rode the retry into m2's body
            retried = json.loads(m2.seen_bodies[0])
            assert retried["resume_token"] == token
            snap = state.snapshot()
            assert snap["resume_handoffs_total"] == 1
            assert snap["retried_requests"] == 1
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            m1.close(); m2.close()

    def test_retry_below_min_budget_surfaces_last_answer(self):
        m1, m2 = _ScriptedMember(), _ScriptedMember()
        self._pin(m1)
        m1.solve_script = [(503, {
            "status": "error", "error": "draining", "retriable": True,
        }, {"Retry-After": "1"})]
        httpd, state, base = _start_router(
            [m1.url, m2.url], min_retry_budget_ms=10_000_000.0,
        )
        try:
            state.table.poll_once()
            code, payload, _ = _post(
                base, "/solve", self.BODY,
                headers={"X-Deadline-Ms": "200000"},
            )
            # remaining budget < the floor: no second attempt, the
            # 503 stands (still retriable - the CLIENT may have more
            # budget tomorrow, the router just won't burn it now)
            assert code == 503
            assert m1.solves == 1 and m2.solves == 0
            assert state.snapshot()["budget_stops_total"] == 1
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            m1.close(); m2.close()

    def test_budget_burned_router_side_is_a_router_504(self):
        m1 = _ScriptedMember()
        httpd, state, base = _start_router([m1.url])
        try:
            code, payload, _ = _post(
                base, "/solve", self.BODY,
                headers={"X-Deadline-Ms": "0"},
            )
            assert code == 504
            assert "router" in payload["error"]
            assert m1.solves == 0  # no replica marched doomed work
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            m1.close()

    def test_unparseable_budget_forwarded_replica_owns_the_400(self):
        m1 = _ScriptedMember()
        httpd, state, base = _start_router([m1.url])
        try:
            code, _, _ = _post(
                base, "/solve", self.BODY,
                headers={"X-Deadline-Ms": "soon"},
            )
            assert code == 200  # scripted member answers; contract is
            assert m1.solves == 1  # "forwarded, not router-rejected"
            assert _hget(m1.seen_headers[0], "X-Deadline-Ms") == "soon"
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            m1.close()


class TestRouterApiKeys:
    """Satellite carry-over: API keys terminate at the router; the
    mapped tenant label - never the caller's claim - travels on as
    X-Wavetpu-Tenant."""

    BODY = {"N": 8, "timesteps": 4}

    def test_load_api_keys_parses_and_validates(self, tmp_path):
        p = tmp_path / "keys.json"
        # PR-12 flat schema: plain tenant-label strings normalize to
        # identity-only configs (no quotas, default classes).
        p.write_text(json.dumps({"k1": "acme", "k2": "umbrella"}))
        keys = load_api_keys(str(p))
        assert {k: c.tenant for k, c in keys.items()} == {
            "k1": "acme", "k2": "umbrella"
        }
        assert keys["k1"].rps is None
        assert keys["k1"].cells_per_s is None
        assert keys["k1"].priority == "batch"
        assert keys["k1"].priority_ceiling == "interactive"
        # QoS schema: config objects carry quota + class policy; a
        # default class above the ceiling is clamped at parse time.
        p.write_text(json.dumps({
            "k1": "acme",
            "k2": {"tenant": "umbrella", "priority": "interactive",
                   "priority_ceiling": "batch", "rps": 5,
                   "burst": 10, "cells_per_s": 1e6},
        }))
        keys = load_api_keys(str(p))
        assert keys["k1"].tenant == "acme"
        c = keys["k2"]
        assert c.tenant == "umbrella"
        assert c.priority == "batch"  # clamped at the ceiling
        assert c.priority_ceiling == "batch"
        assert c.rps == 5 and c.burst == 10 and c.cells_per_s == 1e6
        assert c.cells_burst is None
        for bad in (["k1"], {}, {"k": 5}, {"": "t"}, {"k": ""},
                    {"k": {}}, {"k": {"tenant": ""}},
                    {"k": {"tenant": "t", "rps": 0}},
                    {"k": {"tenant": "t", "rps": "fast"}}):
            p.write_text(json.dumps(bad))
            with pytest.raises(ValueError):
                load_api_keys(str(p))

    def test_keys_gate_solve_and_stamp_the_mapped_tenant(self):
        m = _ScriptedMember()
        httpd, state, base = _start_router(
            [m.url], api_keys={"k1": "acme"}
        )
        try:
            # no key / unknown key: 401 with a challenge, nothing
            # forwarded
            code, _, headers = _post(base, "/solve", self.BODY)
            assert code == 401
            assert _hget(headers, "WWW-Authenticate") == "Bearer"
            code, _, _ = _post(base, "/solve", self.BODY,
                               headers={"X-Api-Key": "nope"})
            assert code == 401
            assert m.solves == 0
            # Bearer form; a spoofed tenant claim is REPLACED by the
            # key's mapped label
            code, _, _ = _post(base, "/solve", self.BODY, headers={
                "Authorization": "Bearer k1",
                "X-Wavetpu-Tenant": "evil",
            })
            assert code == 200
            assert _hget(m.seen_headers[-1], "X-Wavetpu-Tenant") == "acme"
            # X-Api-Key form
            code, _, _ = _post(base, "/solve", self.BODY,
                               headers={"X-Api-Key": "k1"})
            assert code == 200
            assert _hget(m.seen_headers[-1], "X-Wavetpu-Tenant") == "acme"
            snap = state.snapshot()
            assert snap["auth_rejected_total"] == 2
            assert snap["requests_per_tenant"] == {"acme": 2}
            # health stays unauthenticated (probes, fleet tooling)
            code, _ = _get(base, "/healthz")
            assert code == 200
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            m.close()

    def test_keys_off_passes_the_tenant_header_through(self):
        m = _ScriptedMember()
        httpd, state, base = _start_router([m.url])
        try:
            code, _, _ = _post(base, "/solve", self.BODY,
                               headers={"X-Wavetpu-Tenant": "acme"})
            assert code == 200
            assert _hget(m.seen_headers[0], "X-Wavetpu-Tenant") == "acme"
            assert state.snapshot()["requests_per_tenant"] == {
                "acme": 1
            }
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            m.close()


class TestRouterTracing:
    """The router's half of the fleet trace contract
    (docs/observability.md "Distributed tracing"): an untraced router
    forwards and echoes the inbound traceparent verbatim; a traced one
    adopts it as the remote parent of `router.request`, re-parents
    each upstream attempt under a fresh wire id, and marks retries."""

    BODY = {"N": 8, "timesteps": 4}

    def test_untraced_router_forwards_and_echoes_verbatim(self):
        m = _ScriptedMember()
        httpd, state, base = _start_router([m.url])
        tp = "00-" + "ab" * 16 + "-" + "12" * 8 + "-01"
        try:
            code, _body, hdrs = _post(
                base, "/solve", self.BODY,
                headers={"traceparent": tp},
            )
            assert code == 200
            assert _hget(hdrs, "traceparent") == tp
            assert _hget(m.seen_headers[0], "traceparent") == tp
            # no inbound context: nothing invented, nothing echoed
            code, _body, hdrs = _post(base, "/solve", self.BODY)
            assert code == 200
            assert _hget(hdrs, "traceparent") is None
            assert _hget(m.seen_headers[1], "traceparent") is None
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            m.close()

    def test_traced_router_spans_reparent_the_attempt(self, tmp_path):
        from wavetpu_torch.obs import tracing
        m = _ScriptedMember()
        httpd, state, base = _start_router(
            [m.url], telemetry_dir=str(tmp_path / "rt")
        )
        tid, wire = "ab" * 16, "12" * 8
        try:
            code, _body, hdrs = _post(
                base, "/solve", self.BODY,
                headers={"traceparent": f"00-{tid}-{wire}-01",
                         "X-Request-Id": "req-tr-1"},
            )
            assert code == 200
            # echo carries the router's OWN context on the same trace
            echoed = tracing.parse_traceparent(
                _hget(hdrs, "traceparent")
            )
            assert echoed is not None
            assert echoed[0] == tid and echoed[1] != wire
            # the member saw the ATTEMPT's wire id, not the client's
            fwd = tracing.parse_traceparent(
                _hget(m.seen_headers[0], "traceparent")
            )
            assert fwd is not None
            assert fwd[0] == tid
            assert fwd[1] not in (wire, echoed[1])
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            state.tracer.close()
            m.close()
        recs = [
            json.loads(l)
            for l in open(str(tmp_path / "rt" / "trace.jsonl"))
        ]
        req = [r for r in recs if r["kind"] == "router.request"]
        att = [r for r in recs if r["kind"] == "router.attempt"]
        assert len(req) == 1 and len(att) == 1
        assert req[0]["trace_id"] == tid
        assert req[0]["parent_id"] == wire        # the client's wire id
        assert req[0]["attrs"]["w3c_id"] == echoed[1]
        assert req[0]["attrs"]["request_id"] == "req-tr-1"
        assert att[0]["trace_id"] == tid
        assert att[0]["parent_id"] == req[0]["span_id"]
        assert att[0]["attrs"]["w3c_id"] == fwd[1]
        assert att[0]["attrs"]["member"] == m.url

    def test_traced_retry_is_marked_and_stays_one_trace(self, tmp_path):
        # affinity pins the first attempt at holder `a`, whose severed
        # connection forces the cross-member retry onto `b`
        kd = progkey.key_from_program_key(
            progkey.identity_from_body(
                self.BODY, platform="cpu"
            ).program_key(4, True)
        )
        a = _ScriptedMember(warm_keys={"memory": [kd], "disk": []})
        b = _ScriptedMember()
        a.solve_script = ["drop"]
        httpd, state, base = _start_router(
            [a.url, b.url], telemetry_dir=str(tmp_path / "rt")
        )
        tid = "cd" * 16
        try:
            code, _body, _hdrs = _post(
                base, "/solve", self.BODY,
                headers={"traceparent": f"00-{tid}-{'34' * 8}-01"},
            )
            assert code == 200
            assert a.solves == 1 and b.solves == 1
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            state.tracer.close()
            a.close(); b.close()
        recs = [
            json.loads(l)
            for l in open(str(tmp_path / "rt" / "trace.jsonl"))
        ]
        atts = [r for r in recs if r["kind"] == "router.attempt"]
        retries = [r for r in recs if r["kind"] == "router.retry"]
        assert len(atts) == 2 and len(retries) == 1
        assert all(r["trace_id"] == tid for r in atts + retries)
        # both attempts carry DISTINCT wire ids under one request span
        assert (atts[0]["attrs"]["w3c_id"]
                != atts[1]["attrs"]["w3c_id"])
        assert atts[0]["parent_id"] == atts[1]["parent_id"]


def _start_replica(**kw):
    kw.setdefault("max_wait", 0.02)
    kw.setdefault("default_kernel", "roll")
    kw.setdefault("device", "cpu")
    httpd, state = build_server(port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop_replica(httpd, state):
    try:
        httpd.shutdown()
    except Exception:
        pass
    state.batcher.close(timeout=30.0, drain=False)
    httpd.server_close()


class TestFleetChaos:
    def test_member_faults_absorbed_by_router_zero_retry_client(self):
        """Satellite: WAVETPU_FAULT conn-drop + worker-crash specs at
        ONE member of a two-replica fleet.  The router retries the
        transport error and the crashed-worker 503 onto the live
        member, so even a ZERO-retry client sees only 200s."""
        plan = faults.parse_serve_spec(
            "serve-conn-drop:after=1,count=1;"
            "serve-worker-crash:after=1,count=1"
        )
        h1, s1, u1 = _start_replica(fault_plan=plan)
        h2, s2, u2 = _start_replica()
        httpd, state, base = _start_router(
            [u1, u2], poll_interval_s=60.0, proxy_timeout=60.0
        )
        try:
            # Warm u1 DIRECTLY (the after=1 budgets skip this request
            # and its batch), then poll: u1 now advertises the key, so
            # the router's first routed pick lands on the faulted
            # member - the seam the chaos must cross.
            direct = WavetpuClient(u1, retries=0, timeout=60.0)
            assert direct.solve({"N": 8, "timesteps": 4}).ok
            state.table.poll_once()
            client = WavetpuClient(base, retries=0, timeout=60.0)
            outs = []
            for i in range(20):
                # distinct phases dodge request coalescing; loop until
                # both faults have fired through the router
                outs.append(client.solve(
                    {"N": 8, "timesteps": 4, "phase": 1.0 + i}
                ))
                fired = {
                    s["kind"]: s["fired"] for s in plan.snapshot()
                }
                if (fired.get("conn-drop") and
                        fired.get("worker-crash")):
                    break
            assert all(o.ok for o in outs), [
                (o.status, o.error) for o in outs if not o.ok
            ]
            assert all(o.attempts == 1 for o in outs)  # zero retries
            fired = {s["kind"]: s["fired"] for s in plan.snapshot()}
            assert fired["conn-drop"] == 1
            assert fired["worker-crash"] == 1
            assert state.snapshot()["retried_requests"] >= 2
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            _stop_replica(h1, s1)
            _stop_replica(h2, s2)




# ---- a gate that holds a long march mid-flight ----


class _GatedChunks(faults.ServeFaultPlan):
    """A serve fault plan that holds a chunked march mid-flight: once
    `arm()`ed, the chunk passes of the `timesteps` tier go through until
    `after` of them have run, then the next one blocks (up to 120 s)
    until `release()`.  Where wavetpu's drill stretches every chunk with
    a slow-batch sleep and races the roll against it, this makes "the
    drain lands mid-march" an event, not a timing."""

    def __init__(self, timesteps: int, after: int = 1):
        super().__init__([])
        self.timesteps = timesteps
        self.after = after
        self.armed = threading.Event()
        self.entered = threading.Event()
        self._released = threading.Event()
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return True

    def arm(self) -> None:
        self.armed.set()

    def release(self) -> None:
        self._released.set()

    def fire(self, kind, **ctx):
        if (kind != "slow-batch" or not self.armed.is_set()
                or str(ctx.get("timesteps")) != str(self.timesteps)):
            return None
        with self._lock:
            self.after -= 1
            hold = self.after < 0 and not self.entered.is_set()
            if hold:
                self.entered.set()
        if hold:
            self._released.wait(120.0)
        return None


def _wait_for(predicate, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# ---- acceptance: the rolling-deploy drill ----


class TestRollingDeployDrill:
    def test_roll_under_load_zero_errors_zero_cold_compiles(
        self, tmp_path
    ):
        """Closed-loop replay THROUGH THE ROUTER over a two-replica fleet
        while one replica is rolled out and its successor (sharing the
        persistent program cache) rolled in - via the real `fleet roll`
        driver against the router's admin API.  Asserts: zero
        client-visible errors and ZERO fresh builds in every replay
        window (the successor disk-adopts), >= 90%% of warm-key
        requests routed to a holder, the predecessor retired and the
        successor serving.  The replay runs in one-second windows until
        the roll is done and the successor has answered, under one
        deadline: a slow host takes more windows, it fails no check."""
        cache_dir = str(tmp_path / "progcache")
        # max_batch=1: closed-loop concurrency 3 would otherwise
        # coalesce into bucket-2 programs the warmup never built - a
        # batcher first-contact cost, not a cutover cost.
        rep_kw = dict(program_cache_dir=cache_dir, max_batch=1)
        h1, s1, u1 = _start_replica(**rep_kw)
        h2, s2, u2 = _start_replica(**rep_kw)
        httpd, state, base = _start_router(
            [u1, u2], poll_interval_s=0.3, proxy_timeout=120.0,
        )
        scenarios = [
            {"name": "t4", "weight": 2, "body": {"N": 8, "timesteps": 4}},
            {"name": "t6", "weight": 1, "body": {"N": 8, "timesteps": 6}},
        ]
        records = trace.generate(
            "uniform", 4.0, 8.0, scenarios=scenarios, seed=11
        )
        started = []
        roll_result = {}

        def _roll():
            # the successor: same shared program cache -> every program
            # the fleet built is a DISK ADOPTION, not a build
            started.append(_start_replica(**rep_kw))
            roll_result["url"] = started[0][2]
            roll_result["rc"] = fleet_roll.roll(
                base, old_url=u1, new_url=started[0][2],
                spawn_argv=None, manifest_path=None,
                timeout_s=60.0, leave_sync=True,
                log=lambda *a, **k: None,
            )

        def _successor_served():
            url = roll_result.get("url")
            return url is not None and any(
                row["url"] == url and row["proxied_total"] > 0
                for row in state.snapshot()["members"]
            )

        roller = threading.Thread(target=_roll, daemon=True)
        try:
            deadline = time.monotonic() + 120.0
            windows = 0
            while True:
                # window 0 warms both tiers (warmup=2, outside the
                # window) before the roll starts
                result = runner.replay(
                    base, records, mode="closed", concurrency=3,
                    warmup=2 if windows == 0 else 0, timeout=120.0,
                    retries=2, duration=1.0,
                )
                report = lg_report.build_report(result, target=base)
                # 1. zero client-visible errors across the cutover
                assert report["errors"] == 0, report
                # 2. zero fresh builds in the window: the gate the CI
                # smoke runs as --max-cold-compiles 0 --error-budget 0
                violations = lg_report.gate(report, slo={
                    "error_budget": 0.0, "max_cold_compiles": 0,
                })
                assert violations == [], (windows, violations)
                if windows == 0:
                    roller.start()
                windows += 1
                if "rc" in roll_result and _successor_served():
                    break
                assert time.monotonic() < deadline, (
                    windows, roll_result, state.snapshot()["members"])
            roller.join(90.0)
            assert not roller.is_alive()
            assert roll_result.get("rc") == 0, roll_result
            # 3. affinity kept landing warm keys on holders (>= 90%)
            aff = state.snapshot()["affinity"]
            assert aff["hit_rate"] is not None
            assert aff["hit_rate"] >= 0.90, aff
            # 4. the roll really happened: predecessor retired, the
            # successor served traffic
            assert state.table.get(u1).state == LEFT
        finally:
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            _stop_replica(h1, s1)
            _stop_replica(h2, s2)
            for h3, s3, _ in started:
                _stop_replica(h3, s3)

    def test_roll_hands_off_inflight_long_solve(self, tmp_path, capsys):
        """The drain-roll leg: a chunked long solve is IN FLIGHT at the
        predecessor when `fleet roll` drains it.  The drain checkpoints
        the march (503 + resume_token), the router re-injects the token
        on its member retry, and the successor - sharing
        --solve-state-dir - resumes from the last completed chunk.  The
        zero-retry client sees ONE attempt, a 200, and a report exactly
        equal to an unpreempted run's.

        Tracing leg: router and both replicas write telemetry, and ONE
        command - `python -m wavetpu_torch trace-report --dir routerT
        --dir replA --dir replB --request ID` - reconstructs the
        handed-off solve as a single tree under the client's trace id:
        router attempts, both replicas' serve.request spans, the
        drain-handoff mark, and chunk spans from BOTH sides of the
        preemption."""
        from wavetpu_torch.cli import main as cli_main
        from wavetpu_torch.obs import report as trace_report
        from wavetpu_torch.obs import tracing
        router_t = str(tmp_path / "routerT")
        repl_a = str(tmp_path / "replA")
        repl_b = str(tmp_path / "replB")
        # the in-process stand-in for per-replica --telemetry-dir: the
        # module tracer is replica A's until the drain completes, then
        # replica B's (the router owns its own Tracer either way)
        tracing.configure(repl_a + "/trace.jsonl")
        state_dir = str(tmp_path / "state")
        body = {"N": 8, "timesteps": 33}
        chunk_kw = dict(chunk_threshold=8, chunk_steps=4,
                        solve_state_dir=state_dir)
        # the predecessor holds the victim's march after its first chunk
        # until the drain has begun (the successor carries no gate)
        gate = _GatedChunks(timesteps=33, after=1)
        h1, s1, u1 = _start_replica(fault_plan=gate, **chunk_kw)
        httpd, state, base = _start_router(
            [u1], poll_interval_s=0.3, proxy_timeout=120.0,
            telemetry_dir=router_t,
        )
        h3 = s3 = None
        u3 = None
        victim = {}
        roll_result = {}
        vt = rt = None
        try:
            # control: the same long solve, unpreempted (also warms
            # u1's chunk programs, so the victim marches immediately)
            direct = WavetpuClient(u1, retries=0, timeout=120.0)
            control = direct.solve(body)
            assert control.ok, (control.status, control.error)
            assert control.payload["batch"]["chunked"] is True
            gate.arm()

            def _solve():
                client = WavetpuClient(base, retries=0, timeout=120.0)
                victim["out"] = client.solve(body)

            vt = threading.Thread(target=_solve, daemon=True)
            vt.start()
            # the victim's march is mid-flight: a chunk done, the next
            # one held by the gate
            assert gate.entered.wait(60.0)

            # successor: no gate, same shared state dir
            h3, s3, u3 = _start_replica(**chunk_kw)

            def _roll():
                roll_result["rc"] = fleet_roll.roll(
                    base, old_url=u1, new_url=u3,
                    spawn_argv=None, manifest_path=None,
                    timeout_s=60.0, leave_sync=True,
                    log=lambda *a, **k: None,
                )

            rt = threading.Thread(target=_roll, daemon=True)
            rt.start()
            # a real serve process drains its batcher in main()'s
            # finally once /admin/drain stops the accept loop; the
            # in-process replica does that step here
            _wait_for(lambda: s1.draining, "the predecessor's drain")
            # the successor's spans go to its own telemetry dir (in a
            # real fleet this is B's --telemetry-dir; records still
            # racing out of A's drain merge fine - the joiner reads
            # every --dir)
            tracing.configure(repl_b + "/trace.jsonl")
            gate.release()
            s1.batcher.close(timeout=60.0, drain=True)
            rt.join(90.0)
            vt.join(90.0)
            assert not rt.is_alive() and not vt.is_alive()
            assert roll_result.get("rc") == 0, roll_result
            out = victim.get("out")
            assert out is not None and out.ok, (
                out and (out.status, out.error, out.payload)
            )
            # the handoff was invisible: ONE attempt (zero client
            # retries), answered by the successor
            assert out.attempts == 1
            assert out.headers.get("X-Wavetpu-Member") == u3
            # exact parity with the unpreempted control: the report's
            # per-checkpoint error lists are the full float values
            cr, vr = control.payload["report"], out.payload["report"]
            assert vr["final_step"] == cr["final_step"] == 33
            assert vr["abs_errors"] == cr["abs_errors"]
            assert vr["rel_errors"] == cr["rel_errors"]
            # the resume really crossed replicas via the shared dir
            assert out.payload["batch"]["resumed_from"] >= 1
            assert s1.metrics.snapshot()["preempted_total"] >= 1
            assert s3.metrics.snapshot()["resumed_total"] == 1
            assert state.snapshot()["resume_handoffs_total"] == 1
            assert state.table.get(u1).state == LEFT
        finally:
            gate.release()
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            _stop_replica(h1, s1)
            if h3 is not None:
                _stop_replica(h3, s3)
            if state.tracer is not None:
                state.tracer.close()
            tracing.disable()
        # ---- the one-command joiner over all three telemetry dirs ----
        rid = out.request_id
        tid = out.trace_id
        assert rid and tid
        paths = [
            d + "/trace.jsonl" for d in (router_t, repl_a, repl_b)
        ]
        # the router handler thread ends its span just AFTER the
        # response bytes reach the client - poll for the flush
        deadline = time.monotonic() + 30.0
        while True:
            recs = trace_report.load_traces(paths)
            view = trace_report.request_view(recs, rid)
            if any(r["kind"] == "router.request" for r in view):
                break
            assert time.monotonic() < deadline, "router span never landed"
            time.sleep(0.05)
        kinds = {r["kind"] for r in view}
        assert {"router.request", "router.attempt",
                "router.drain_handoff", "serve.request",
                "serve.chunk"} <= kinds, kinds
        # ONE trace id spans client->router->A->drain->B
        assert {r.get("trace_id")
                for r in view if r.get("trace_id")} == {tid}
        # both replicas answered this request...
        assert len([r for r in view
                    if r["kind"] == "serve.request"]) == 2
        # ...and chunk spans exist on BOTH sides of the preemption
        # (two distinct tracer namespaces marched chunks)
        assert len({r["span_id"].split("-")[0] for r in view
                    if r["kind"] == "serve.chunk"}) == 2
        # the pinned one-command form: `trace-report` over the three
        # dirs reconstructs and annotates the same tree
        rc = cli_main([
            "trace-report", "--dir", router_t, "--dir", repl_a,
            "--dir", repl_b, "--request", rid,
        ])
        assert rc == 0
        text = capsys.readouterr().out
        assert "joined across 3 processes" in text
        assert "<-hop" in text
        assert "router.drain_handoff" in text


# ---- the shared contract with wavetpu's fleet tier ----


# Path names of both packages (wavetpu's cost model and the port's) and
# junk; `price_cells` must price each exactly as wavetpu's does.
PRICE_PATHS = ["roll", "pallas", "sharded", "kfused", "sharded_kfused",
               "kfused_comp", "kfused_comp_sharded", "compensated",
               "leapfrog", "sharded_kfused_xy", "auto", "junk", "", None,
               0, ["compensated"]]


def _price(fn, body):
    try:
        return ("ok", fn(body))
    except Exception as e:  # both packages must fail alike
        return ("raised", type(e).__name__)


class TestContractParity:
    @pytest.mark.parametrize("path", PRICE_PATHS,
                             ids=[repr(x) for x in PRICE_PATHS])
    def test_price_cells_equals_wavetpus(self, path):
        """The router's cells/s pricing is wavetpu's, body for body: each
        path name under `path` and under `kernel`, k from 1 to 8 and
        junk, N and timesteps valid and junk (two routers of different
        packages on one control plane charge a tenant alike)."""
        n_values = [8, 64, 512, "16", 12.7, 0, -1, "x", None, True,
                    float("inf")]
        t_values = [1, 20, 1000, "7", 0, "x", None]
        k_values = list(range(1, 9)) + [0, None, "x", 2.5, "3", [2]]
        for field in ("path", "kernel"):
            for k in k_values:
                for n in n_values:
                    for steps in t_values:
                        body = {"N": n, "timesteps": steps, field: path,
                                "k": k}
                        assert _price(quota.price_cells, body) == \
                            _price(jquota.price_cells, body), body
        for body in (None, [], "x", {}, {"N": 8}, {"timesteps": 5},
                     {"N": 8, "path": path, "scheme": "compensated"}):
            assert _price(quota.price_cells, body) == \
                _price(jquota.price_cells, body), body

    def test_priority_ladders_agree(self):
        from wavetpu_torch.serve import scheduler

        assert quota.PRIORITY_CLASSES == scheduler.PRIORITY_CLASSES \
            == jquota.PRIORITY_CLASSES
        assert quota.DEFAULT_PRIORITY == jquota.DEFAULT_PRIORITY

    def test_router_views_agree(self):
        """The two routers over the same scripted member answer the same
        /healthz and /metrics JSON key sets (with the affinity block and
        the member rows) and the same Prometheus names."""
        m = _ScriptedMember()
        routers = [
            r.build_router([m.url], poll_interval_s=60.0,
                           rng=random.Random(0))
            for r in (trouter, jrouter)
        ]
        try:
            bases = []
            for httpd, state in routers:
                threading.Thread(target=httpd.serve_forever,
                                 daemon=True).start()
                state.table.poll_once()
                base = f"http://127.0.0.1:{httpd.server_address[1]}"
                assert _post(base, "/solve", {"N": 8, "timesteps": 4})[0] \
                    == 200
                bases.append(base)
            views = []
            for base in bases:
                health = json.loads(_get(base, "/healthz")[1])
                metrics = json.loads(_get(base, "/metrics")[1])
                text = _get(base, "/metrics", accept="text/plain")[1]
                names = {
                    line.split("{")[0].split(" ")[0]
                    for line in text.splitlines()
                    if line and not line.startswith("#")
                }
                views.append((
                    set(health), set(health["members"][0]), set(metrics),
                    set(metrics["affinity"]), set(metrics["members"][0]),
                    names,
                ))
            assert views[0] == views[1]
        finally:
            for httpd, state in routers:
                httpd.shutdown(); httpd.server_close()
                state.stop_poller()
            m.close()


# ---- the north star: wavetpu's router in front of port replicas ----


def _lane_errors(n, timesteps, phase=None):
    """(abs, rel) error lists of one solve_ensemble lane on the CPU."""
    lane = eb.LaneSpec() if phase is None else eb.LaneSpec(phase=phase)
    r = eb.solve_ensemble(Problem(N=n, timesteps=timesteps), [lane],
                          path="roll", device="cpu").results[0]
    return np.asarray(r.abs_errors), np.asarray(r.rel_errors)


def _bit_equal(report, want):
    return (np.array_equal(report["abs_errors"], want[0])
            and np.array_equal(report["rel_errors"], want[1]))


class TestFrontsPortReplicas:
    @pytest.mark.parametrize("router_mod", [jrouter, trouter],
                             ids=["wavetpu_router", "port_router"])
    def test_router_fronts_two_port_replicas(self, router_mod, tmp_path):
        """An unmodified `wavetpu.fleet.router` (and the port's, held to
        the same) in front of two in-process CPU port replicas: a warm
        key lands every request on its holder (affinity hits), each
        answer is bit-equal to its `solve_ensemble` lane, and a chunked
        march held mid-flight at the replica that holds its tier when the
        router drains that replica answers ONE 200 from the other - the
        503's `resume_token` re-injected by the router, the other replica
        resuming from the shared state directory - bit-equal to the
        unpreempted march and its lane.  (A chunked march's programs are
        keyed `path@chunkL`, so a replica's polled warm keys never name
        the body's tier: the router learns the holder from the answer's
        Server-Timing label, and no poll runs in between.)"""
        chunk_kw = dict(chunk_threshold=8, chunk_steps=4,
                        solve_state_dir=str(tmp_path / "state"))
        gates = [_GatedChunks(timesteps=33, after=1) for _ in range(2)]
        ha_, sa, ua = _start_replica(fault_plan=gates[0], **chunk_kw)
        hb, sb, ub = _start_replica(fault_plan=gates[1], **chunk_kw)
        httpd, state = router_mod.build_router(
            [ua, ub], poll_interval_s=60.0, proxy_timeout=120.0,
            rng=random.Random(0), start_poller=False)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        leave = None
        try:
            direct = WavetpuClient(ua, retries=0, timeout=120.0)
            client = WavetpuClient(base, retries=0, timeout=120.0)
            # 1. affinity: A holds the tier, the router learns it from
            # A's /metrics warm keys
            assert direct.solve({"N": 8, "timesteps": 4,
                                 "phase": 0.3}).ok
            state.table.poll_once()
            hits0 = state.snapshot()["affinity"]["hits"]
            for phase in (1.0, 1.3, 1.6):
                out = client.solve({"N": 8, "timesteps": 4,
                                    "phase": phase})
                assert out.ok, (out.status, out.error)
                assert out.headers.get("X-Wavetpu-Member") == ua
                assert _bit_equal(out.payload["report"],
                                  _lane_errors(8, 4, phase))
            assert state.snapshot()["affinity"]["hits"] - hits0 == 3

            # 2. the drain handoff: the control marches the long tier on
            # the member the router picks (X, its holder from now on);
            # the victim lands there and is held after one chunk
            long_body = {"N": 8, "timesteps": 33}
            control = client.solve(long_body)
            assert control.ok and control.payload["batch"]["chunked"]
            want = _lane_errors(8, 33)
            assert _bit_equal(control.payload["report"], want)
            x = control.headers.get("X-Wavetpu-Member")
            assert x in (ua, ub)
            (sx, gate), (sy, uy) = (
                ((sa, gates[0]), (sb, ub)) if x == ua
                else ((sb, gates[1]), (sa, ua)))
            gate.arm()
            victim = {}
            vt = threading.Thread(
                target=lambda: victim.update(out=client.solve(long_body)),
                daemon=True)
            vt.start()
            assert gate.entered.wait(60.0)
            leave = threading.Thread(target=lambda: _post(
                base, "/admin/leave", {"url": x, "drain": True,
                                       "sync": True}, timeout=120),
                daemon=True)
            leave.start()
            _wait_for(lambda: sx.draining, "the holder's drain")
            gate.release()
            sx.batcher.close(timeout=60.0, drain=True)
            vt.join(90.0)
            leave.join(90.0)
            assert not vt.is_alive() and not leave.is_alive()
            out = victim["out"]
            assert out.ok and out.attempts == 1, (out.status, out.error)
            assert out.headers.get("X-Wavetpu-Member") == uy
            assert out.payload["batch"]["resumed_from"] >= 1
            assert _bit_equal(out.payload["report"], want)
            assert out.payload["report"]["abs_errors"] == \
                control.payload["report"]["abs_errors"]
            assert state.snapshot()["resume_handoffs_total"] == 1
            assert sy.metrics.snapshot()["resumed_total"] == 1
        finally:
            for g in gates:
                g.release()
            httpd.shutdown(); httpd.server_close()
            state.stop_poller()
            _stop_replica(ha_, sa)
            _stop_replica(hb, sb)
