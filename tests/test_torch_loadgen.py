"""The port's load generator (wavetpu_torch/loadgen/) on the CPU, class by
class after wavetpu's tests/test_loadgen.py: trace format + generators,
Server-Timing parse, the regression gate, preflight, the replay round
trip, soak and retries, multi-target and the acceptance drills.

The acceptance-level tests drive the REAL pipeline end to end against
an in-process port replica (`device="cpu"`, its `--record-trace`
recorder on):

 * record -> replay -> report: real /solve traffic captured by the
   server-side recorder replays through the HTTP runner and produces a
   loadgen_report.json with the pinned field set;
 * self-consistency: the same warmed server replayed twice produces two
   reports whose regression gate PASSES;
 * injected slowdown: a server misconfigured with a 10x max-wait makes
   the p99 gate FAIL with a non-zero CLI exit.

Beside those, the shared formats: both packages write the same trace
bytes, each package's loadgen replays the other's traces (and the port
replica's recording), and the two reports carry the same keys and gate
each other.
"""

import json
import threading

import pytest

from wavetpu.loadgen import report as jreport
from wavetpu.loadgen import runner as jrunner
from wavetpu.loadgen import trace as jtrace
from wavetpu_torch.loadgen import report as lg_report
from wavetpu_torch.loadgen import runner, trace
from wavetpu_torch.loadgen.cli import main as loadgen_main
from wavetpu_torch.serve.api import build_server


# ---- trace format + generators ----


class TestTraceFormat:
    def test_generate_is_deterministic(self):
        a = trace.generate("poisson", 5.0, 3.0, seed=7)
        b = trace.generate("poisson", 5.0, 3.0, seed=7)
        c = trace.generate("poisson", 5.0, 3.0, seed=8)
        assert a == b
        assert a != c

    def test_save_load_round_trip(self, tmp_path):
        recs = trace.generate("uniform", 4.0, 2.0, seed=1)
        path = str(tmp_path / "t.jsonl")
        trace.save_scenario_trace(path, recs)
        loaded = trace.load_scenario_trace(path)
        assert loaded == recs

    def test_records_are_time_ordered_and_bounded(self):
        for mix in trace.MIXES:
            recs = trace.generate(mix, 6.0, 4.0, seed=2)
            ts = [r["t"] for r in recs]
            assert ts == sorted(ts)
            assert all(0 <= t < 6.0 + 1e-9 for t in ts)
            assert all(isinstance(r["body"], dict) for r in recs)

    def test_mix_spans_scenario_knobs(self):
        """The default tier set varies the knobs the batcher buckets on:
        steps, scheme, phase, c2-field presets, and (advisory) error
        budgets - plus two distinct timesteps (program identities)."""
        recs = trace.generate("uniform", 30.0, 4.0, seed=0)
        bodies = [r["body"] for r in recs]
        assert any(b.get("scheme") == "compensated" for b in bodies)
        assert any(b.get("c2_field") for b in bodies)
        assert any(b.get("phase") for b in bodies)
        assert any(b.get("steps") for b in bodies)
        assert len({b.get("timesteps") for b in bodies}) >= 2
        assert any("error_budget" in r for r in recs)

    def test_hotkey_mix_is_cache_adversarial(self):
        recs = trace.generate("hotkey", 30.0, 6.0, seed=0, distinct=10)
        # more distinct program identities (timesteps values) than the
        # serve default --max-programs 8: the LRU must thrash
        assert len({r["body"]["timesteps"] for r in recs}) > 8
        hot = sum(1 for r in recs if r["scenario"] == "small-standard")
        assert 0 < hot < len(recs)

    def test_load_rejects_broken_records(self, tmp_path):
        path = tmp_path / "bad.jsonl"
        path.write_text('{"t": -1, "body": {"N": 8}}\n')
        with pytest.raises(ValueError, match="'t'"):
            trace.load_scenario_trace(str(path))
        path.write_text('{"t": 0}\n')
        with pytest.raises(ValueError, match="body"):
            trace.load_scenario_trace(str(path))
        path.write_text("")
        with pytest.raises(ValueError, match="empty"):
            trace.load_scenario_trace(str(path))

    def test_scenario_label_derivation(self):
        assert trace.scenario_label({"N": 8, "timesteps": 20}) == \
            "N8/20-standard"
        label = trace.scenario_label({
            "N": 16, "timesteps": 10, "scheme": "compensated",
            "fuse_steps": 4, "kernel": "pallas",
        })
        assert "k4" in label and "compensated" in label

    def test_generate_cli(self, tmp_path, capsys):
        out = str(tmp_path / "t.jsonl")
        assert loadgen_main([
            "generate", "--out", out, "--mix", "diurnal",
            "--duration", "10", "--qps", "3", "--seed", "5",
        ]) == 0
        assert "wrote" in capsys.readouterr().out
        assert trace.load_scenario_trace(out)
        assert loadgen_main(["generate"]) == 2  # missing --out
        assert loadgen_main([
            "generate", "--out", out, "--mix", "nope"
        ]) == 2


# ---- server-timing parsing ----


class TestServerTimingParse:
    def test_parse(self):
        st = runner.parse_server_timing(
            "queue;dur=1.5, compile;dur=0.000, execute;dur=45.25, "
            "padding;dur=2, total;dur=47"
        )
        assert st["queue"] == pytest.approx(0.0015)
        assert st["execute"] == pytest.approx(0.04525)
        assert st["total"] == pytest.approx(0.047)

    def test_parse_tolerates_junk(self):
        assert runner.parse_server_timing(None) == {}
        assert runner.parse_server_timing("") == {}
        st = runner.parse_server_timing("a;dur=x, b;dur=3;desc=hi,,")
        assert st == {"b": 0.003}


# ---- report + gate on fabricated data ----


def _fake_report(p99=100.0, rps=10.0, error_rate=0.0, reject_rate=0.0):
    return {
        "loadgen_report": True,
        "requests": 100,
        "latency_ms": {"p50_ms": p99 / 2, "p95_ms": p99 * 0.9,
                       "p99_ms": p99, "mean_ms": p99 / 2,
                       "max_ms": p99},
        "requests_per_s": rps,
        "error_rate": error_rate,
        "reject_rate": reject_rate,
    }


class TestGate:
    def test_pass_when_within_budgets(self):
        assert lg_report.gate(
            _fake_report(), baseline=_fake_report()
        ) == []

    def test_absolute_p99_budget(self):
        v = lg_report.gate(
            _fake_report(p99=200.0), slo={"p99_budget_ms": 150.0}
        )
        assert [x["slo"] for x in v] == ["p99_budget_ms"]

    def test_error_budget_default_is_strict(self):
        v = lg_report.gate(_fake_report(error_rate=0.02))
        assert [x["slo"] for x in v] == ["error_budget"]
        assert lg_report.gate(
            _fake_report(error_rate=0.02), slo={"error_budget": 0.05}
        ) == []

    def test_reject_budget_optional(self):
        assert lg_report.gate(_fake_report(reject_rate=0.5)) == []
        v = lg_report.gate(
            _fake_report(reject_rate=0.5), slo={"reject_budget": 0.1}
        )
        assert [x["slo"] for x in v] == ["reject_budget"]

    def test_p99_regression_vs_baseline(self):
        base = _fake_report(p99=100.0)
        assert lg_report.gate(
            _fake_report(p99=140.0), baseline=base
        ) == []  # +40% < default 50%
        v = lg_report.gate(_fake_report(p99=160.0), baseline=base)
        assert [x["slo"] for x in v] == ["p99_regression_pct"]

    def test_throughput_floor_vs_baseline(self):
        base = _fake_report(rps=10.0)
        assert lg_report.gate(
            _fake_report(rps=6.0), baseline=base
        ) == []  # -40% > default -50% floor
        v = lg_report.gate(_fake_report(rps=4.0), baseline=base)
        assert [x["slo"] for x in v] == ["throughput_floor_pct"]

    def test_unknown_slo_key_is_loud(self):
        with pytest.raises(ValueError, match="unknown SLO"):
            lg_report.gate(_fake_report(), slo={"p99": 1.0})

    def test_format_gate_names_violations(self):
        base = _fake_report(p99=100.0)
        new = _fake_report(p99=300.0)
        v = lg_report.gate(new, baseline=base)
        text = lg_report.format_gate(v, new, base)
        assert "FAIL" in text and "p99_regression_pct" in text
        assert "-> FAIL" in text
        assert "-> PASS" in lg_report.format_gate([], base, base)

    def test_gate_cli_exit_codes(self, tmp_path, capsys):
        ok = tmp_path / "ok.json"
        slow = tmp_path / "slow.json"
        base = tmp_path / "base.json"
        base.write_text(json.dumps(_fake_report(p99=100.0)))
        ok.write_text(json.dumps(_fake_report(p99=110.0)))
        slow.write_text(json.dumps(_fake_report(p99=400.0)))
        assert loadgen_main([
            "gate", str(ok), "--baseline", str(base)
        ]) == 0
        assert "PASS" in capsys.readouterr().out
        assert loadgen_main([
            "gate", str(slow), "--baseline", str(base)
        ]) == 1
        assert "FAIL" in capsys.readouterr().out
        # the knob widens the gate back to passing
        assert loadgen_main([
            "gate", str(slow), "--baseline", str(base),
            "--p99-regression-pct", "400",
        ]) == 0
        # usage errors are 2, not violations
        assert loadgen_main(["gate", str(ok)]) == 2
        assert loadgen_main([
            "gate", str(tmp_path / "nope.json"), "--baseline", str(base)
        ]) == 2
        # a non-report JSON is refused
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        assert loadgen_main([
            "gate", str(bad), "--baseline", str(base)
        ]) == 2


# ---- HTTP end to end ----


@pytest.fixture()
def server(tmp_path):
    """In-process serve stack with traffic recording on."""
    record = str(tmp_path / "recorded.jsonl")
    httpd, state = build_server(
        port=0, max_wait=0.02, default_kernel="roll", device="cpu",
        record_trace=record,
    )
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    yield base, state, record
    httpd.shutdown()
    state.batcher.close()
    httpd.server_close()
    if state.recorder is not None:
        state.recorder.close()


def _mini_scenarios():
    # Two tiers, one program identity dominant: small and fast on the
    # CI CPU backend while still exercising per-tier reporting.
    return [
        {"name": "a", "weight": 3, "error_budget": 1e-3,
         "body": {"N": 8, "timesteps": 4}},
        {"name": "b", "weight": 1,
         "body": {"N": 8, "timesteps": 4, "phase": 1.0}},
    ]


class TestPreflight:
    def test_ok(self, server):
        base, _, _ = server
        health = runner.preflight(base)
        assert health["status"] == "ok"

    def test_draining_server_refused(self, server):
        base, state, _ = server
        state.draining = True
        try:
            with pytest.raises(runner.PreflightError, match="draining"):
                runner.preflight(base)
        finally:
            state.draining = False

    def test_unreachable_refused_and_cli_exit_2(self, tmp_path):
        with pytest.raises(runner.PreflightError, match="cannot reach"):
            runner.preflight("http://127.0.0.1:9")  # discard port
        path = str(tmp_path / "t.jsonl")
        trace.save_scenario_trace(
            path, trace.generate("uniform", 1.0, 2.0,
                                 scenarios=_mini_scenarios())
        )
        assert loadgen_main([
            "replay", path, "--target", "http://127.0.0.1:9",
        ]) == 2


class TestReplayRoundTrip:
    def test_record_replay_report_fields(self, server, tmp_path):
        """The tentpole round trip: real traffic -> recorded trace ->
        replay -> report with the pinned field set."""
        base, state, record = server
        # 1. offer real traffic (the recorder captures it)
        seed_trace = trace.generate(
            "uniform", 1.0, 6.0, scenarios=_mini_scenarios(), seed=4
        )
        first = runner.replay(base, seed_trace, mode="closed",
                              concurrency=2, timeout=300)
        assert all(o.status == 200 for o in first.outcomes)
        # 2. the recorded file is itself a loadable scenario trace of
        # exactly the accepted requests
        recorded = trace.load_scenario_trace(record)
        assert len(recorded) == len(seed_trace)
        assert all(r["body"]["N"] == 8 for r in recorded)
        assert all("id" in r or "scenario" in r for r in recorded)
        # 3. replay the RECORDED trace and build the report
        res = runner.replay(base, recorded, mode="closed",
                            concurrency=2, warmup=2, timeout=300)
        rep = lg_report.build_report(res, trace_path=record, target=base)
        assert rep["loadgen_report"] is True
        assert rep["requests"] == len(recorded)
        assert rep["ok"] == len(recorded)
        assert rep["errors"] == 0 and rep["rejected_429"] == 0
        lat = rep["latency_ms"]
        assert lat["p50_ms"] <= lat["p95_ms"] <= lat["p99_ms"] \
            <= lat["max_ms"]
        # per-tier rows exist with their own percentiles
        assert set(rep["tiers"]) >= {"N8/4-standard"}
        for tier in rep["tiers"].values():
            assert tier["requests"] >= 1
            assert tier["p99_ms"] >= tier["p50_ms"]
        # server-side window deltas: occupancy, compiles, throughput
        srv = rep["server"]
        assert srv["batches"] >= 1
        assert srv["occupancy_mean"] >= 1.0
        assert srv["cold_compiles"] == 0  # warmed by the first replay
        assert srv["warm_hits"] >= 1
        assert srv["aggregate_gcells_per_s"] is not None
        # Server-Timing attribution made it through the HTTP client
        assert rep["server_timing_mean_ms"] is not None
        assert rep["server_timing_mean_ms"]["execute"] > 0
        # the slowest requests carry join handles (minted request ids)
        assert rep["slowest_requests"][0]["request_id"].startswith("lg-")

    def test_open_loop_honors_trace_spacing(self, server):
        base, _, _ = server
        recs = [
            {"t": 0.0, "scenario": "a", "body": {"N": 8, "timesteps": 4}},
            {"t": 0.4, "scenario": "a",
             "body": {"N": 8, "timesteps": 4, "phase": 1.0}},
        ]
        res = runner.replay(base, recs, mode="open", warmup=1,
                            timeout=300)
        assert res.wall_seconds >= 0.4  # waited for the second arrival
        assert [o.status for o in res.outcomes] == [200, 200]
        # speed=4 compresses the same trace
        res = runner.replay(base, recs, mode="open", speed=4.0,
                            timeout=300)
        assert res.outcomes[1].t_sent < 0.4

    def test_replay_cli_writes_report(self, server, tmp_path, capsys):
        base, _, _ = server
        path = str(tmp_path / "t.jsonl")
        out = str(tmp_path / "report.json")
        trace.save_scenario_trace(
            path, trace.generate("uniform", 1.0, 4.0,
                                 scenarios=_mini_scenarios())
        )
        assert loadgen_main([
            "replay", path, "--target", base, "--mode", "closed",
            "--concurrency", "2", "--warmup", "2", "--out", out,
            "--timeout", "300",
        ]) == 0
        assert "replayed" in capsys.readouterr().out
        rep = lg_report.load_report(out)
        assert rep["ok"] == rep["requests"]


class TestSoakAndRetries:
    """The resilience-round loadgen satellites: `--duration` soak mode
    (loop the trace until a wall-clock budget elapses) and `--retries`
    (the retrying WavetpuClient behind the runner)."""

    def test_closed_loop_duration_soak_loops_the_trace(self, server):
        base, _, _ = server
        recs = trace.generate(
            "uniform", 0.2, 10.0, scenarios=_mini_scenarios(), seed=3
        )
        res = runner.replay(base, recs, mode="closed", concurrency=2,
                            duration=1.5, timeout=300)
        assert res.wall_seconds >= 1.5
        # the trace (2 requests) looped: more outcomes than records
        assert len(res.outcomes) > len(recs)
        assert all(o.status == 200 for o in res.outcomes)
        rep = lg_report.build_report(res, target=base)
        assert rep["requests"] == len(res.outcomes)
        assert rep["attempts_total"] == rep["requests"]  # no retries

    def test_open_loop_duration_extends_schedule(self):
        recs = [
            {"t": 0.0, "scenario": "a", "body": {"N": 8}},
            {"t": 0.3, "scenario": "b", "body": {"N": 8}},
        ]
        ext = runner.extend_for_duration(recs, duration=1.0)
        assert len(ext) > len(recs)
        ts = [r["t"] for r in ext]
        assert ts == sorted(ts)
        assert len(ts) == len(set(ts))  # laps never collide
        assert all(t < 1.0 for t in ts)
        # speed compresses: a 2x speed fits twice the laps
        assert len(runner.extend_for_duration(recs, 1.0, speed=2.0)) \
            > len(ext)

    def test_bad_duration_and_retries_rejected(self, server):
        base, _, _ = server
        recs = [{"t": 0.0, "scenario": "a", "body": {"N": 8}}]
        with pytest.raises(ValueError, match="duration"):
            runner.replay(base, recs, duration=0.0)
        with pytest.raises(ValueError, match="retries"):
            runner.replay(base, recs, retries=-1)

    def test_retries_absorb_injected_connection_drops(self, tmp_path):
        """The chaos half: a server that drops the first two
        connections produces transport errors without retries and a
        clean report WITH them - attempts accounting pins that the
        retries actually happened."""
        from wavetpu_torch.run import faults

        plan = faults.parse_serve_spec("serve-conn-drop:count=2")
        httpd, state = build_server(
            port=0, max_wait=0.02, default_kernel="roll",
            device="cpu", fault_plan=plan,
        )
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        recs = trace.generate(
            "uniform", 0.5, 8.0, scenarios=_mini_scenarios(), seed=6
        )
        try:
            res = runner.replay(base, recs, mode="closed",
                                concurrency=1, retries=3, timeout=300)
            assert all(o.status == 200 for o in res.outcomes)
            # both drops were absorbed by retries (they may land on one
            # logical request - its retry can be the second drop - or
            # on two)
            retried = [o for o in res.outcomes if o.attempts > 1]
            assert sum(o.attempts - 1 for o in res.outcomes) == 2
            assert 1 <= len(retried) <= 2
            rep = lg_report.build_report(res, target=base)
            assert rep["errors"] == 0
            assert rep["retried_requests"] == len(retried)
            assert rep["attempts_total"] == rep["requests"] + 2
            # Per-tier breakout: the tier rows must partition the
            # aggregate retry accounting exactly (which tier absorbed
            # the drops is the question the aggregate-only fields hid).
            assert sum(
                t["attempts_total"] for t in rep["tiers"].values()
            ) == rep["attempts_total"]
            assert sum(
                t["retried_requests"] for t in rep["tiers"].values()
            ) == rep["retried_requests"]
            retried_tiers = {o.scenario for o in retried}
            for tier, row in rep["tiers"].items():
                assert (row["retried_requests"] > 0) == (
                    tier in retried_tiers
                )
        finally:
            httpd.shutdown()
            state.batcher.close()
            httpd.server_close()

    def test_replay_cli_slo_gate_without_baseline(
        self, server, tmp_path, capsys
    ):
        """`replay --error-budget 0` gates a baseline-less replay (the
        nightly chaos smoke's zero-client-visible-errors check)."""
        base, _, _ = server
        path = str(tmp_path / "t.jsonl")
        trace.save_scenario_trace(
            path, trace.generate("uniform", 0.5, 6.0,
                                 scenarios=_mini_scenarios(), seed=2)
        )
        assert loadgen_main([
            "replay", path, "--target", base, "--mode", "closed",
            "--concurrency", "2", "--timeout", "300",
            "--retries", "2", "--error-budget", "0",
        ]) == 0
        out = capsys.readouterr().out
        assert "-> PASS" in out and "retries:" in out
        # a RELATIVE-only flag set does not gate a baseline-less
        # replay (relative gates need a baseline; the strict default
        # error budget must not kick in off an unrelated flag)
        assert loadgen_main([
            "replay", path, "--target", base, "--mode", "closed",
            "--concurrency", "2", "--timeout", "300",
            "--p99-regression-pct", "300",
        ]) == 0
        assert "-> " not in capsys.readouterr().out  # no gate ran


# ---- multi-target fan-out (repeated --target) ----


def _second_server():
    httpd, state = build_server(
        port=0, max_wait=0.02, default_kernel="roll", device="cpu",
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


class TestMultiTarget:
    def test_round_robin_reaches_both_and_per_target_breakdown(
        self, server
    ):
        """`replay([url1, url2])`: requests fan out round-robin, warmup
        serves every tier at EVERY target, the bracketing /metrics cuts
        are summed fleet-wide, and the report grows a per-target
        breakdown."""
        base1, _, _ = server
        h2, s2, base2 = _second_server()
        try:
            records = trace.generate(
                "uniform", 1.0, 6.0, scenarios=_mini_scenarios(), seed=5
            )
            res = runner.replay(
                [base1, base2], records, mode="closed", concurrency=2,
                warmup=2, timeout=300,
            )
            assert res.targets == [base1, base2]
            assert {o.target for o in res.outcomes} == {base1, base2}
            # warmup = one request per tier per TARGET (one replica
            # warm is not the fleet warm)
            assert len(res.warmup_outcomes) == 4
            assert {o.target for o in res.warmup_outcomes} == \
                {base1, base2}
            # summed metrics cuts: the fleet-wide accepted-request
            # counter grew by warmup + measured requests
            name = "wavetpu_serve_requests_total"
            grown = (res.metrics_after.get(name, 0.0)
                     - res.metrics_before.get(name, 0.0))
            assert grown == len(res.outcomes)
            rep = lg_report.build_report(res, target=[base1, base2])
            assert rep["targets"] == [base1, base2]
            per = rep["per_target"]
            assert set(per) == {base1, base2}
            assert sum(r["requests"] for r in per.values()) == \
                rep["requests"]
            for row in per.values():
                assert row["ok"] == row["requests"]
                assert row["errors"] == 0
                assert row["p95_ms"] >= 0.0
        finally:
            h2.shutdown()
            s2.batcher.close()
            h2.server_close()

    def test_cli_repeated_target_flag(self, server, tmp_path, capsys):
        base1, _, _ = server
        h2, s2, base2 = _second_server()
        try:
            path = str(tmp_path / "t.jsonl")
            trace.save_scenario_trace(path, trace.generate(
                "uniform", 1.0, 4.0, scenarios=_mini_scenarios(),
                seed=12,
            ))
            out = str(tmp_path / "rep.json")
            assert loadgen_main([
                "replay", path, "--target", base1, "--target", base2,
                "--mode", "closed", "--concurrency", "2",
                "--warmup", "2", "--out", out, "--timeout", "300",
            ]) == 0
            printed = capsys.readouterr().out
            # the per-target summary lines name both replicas
            assert base1 in printed and base2 in printed
            rep = lg_report.load_report(out)
            assert rep["targets"] == [base1, base2]
            assert set(rep["per_target"]) == {base1, base2}
        finally:
            h2.shutdown()
            s2.batcher.close()
            h2.server_close()


class TestAcceptance:
    """The acceptance: the self-consistency gate passes on a warmed
    server; an injected slowdown fails the p99 gate with exit != 0."""

    def _trace(self, tmp_path):
        path = str(tmp_path / "t.jsonl")
        trace.save_scenario_trace(path, trace.generate(
            "uniform", 1.0, 8.0, scenarios=_mini_scenarios(), seed=9
        ))
        return path

    def test_self_consistency_then_injected_slowdown(
        self, server, tmp_path, capsys
    ):
        base, _, record = server
        path = self._trace(tmp_path)
        r1 = str(tmp_path / "r1.json")
        r2 = str(tmp_path / "r2.json")
        common = ["--target", base, "--mode", "closed",
                  "--concurrency", "2", "--warmup", "2",
                  "--timeout", "300"]
        assert loadgen_main(["replay", path, *common, "--out", r1]) == 0
        # replay 2 vs replay 1 on the same warmed server: the gate
        # passes (generous tolerances - CI CPU latencies at N=8 scale
        # are noisy; the injected failure below is a 50x signal)
        assert loadgen_main([
            "replay", path, *common, "--out", r2, "--baseline", r1,
            "--p99-regression-pct", "400",
            "--throughput-floor-pct", "80",
        ]) == 0
        assert "-> PASS" in capsys.readouterr().out

        # the slowdown: the same stack misconfigured with a 25x
        # max-wait (500 ms vs 20 ms) - every batch idles out the window
        slow_httpd, slow_state = build_server(
            port=0, max_wait=0.5, default_kernel="roll", device="cpu",
        )
        t = threading.Thread(
            target=slow_httpd.serve_forever, daemon=True
        )
        t.start()
        slow_base = f"http://127.0.0.1:{slow_httpd.server_address[1]}"
        try:
            # Baseline = the fully-warmed second report (r1 still
            # carries the bucket-2 first-contact compile in its p99).
            # Tolerance 150%: far above replay-to-replay noise, far
            # below the ~25x wait injection (+400%+ observed).
            rc = loadgen_main([
                "replay", path, "--target", slow_base, "--mode",
                "closed", "--concurrency", "2", "--warmup", "2",
                "--timeout", "300", "--baseline", r2,
                "--p99-regression-pct", "150",
            ])
        finally:
            slow_httpd.shutdown()
            slow_state.batcher.close()
            slow_httpd.server_close()
        assert rc == 1  # the p99 gate tripped, exit != 0
        assert "p99_regression_pct" in capsys.readouterr().out


# ---- the formats shared with wavetpu's loadgen ----


def _key_shape(report):
    """The report's keys: top level, latency, server block, tier rows."""
    tier = next(iter(report["tiers"].values()))
    return (set(report), set(report["latency_ms"]), set(report["server"]),
            set(tier))


class TestSharedFormats:
    def test_generators_write_the_same_bytes(self, tmp_path):
        for mix in ("uniform", "poisson", "diurnal", "hotkey"):
            a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
            trace.save_scenario_trace(a, trace.generate(
                mix, 3.0, 4.0, seed=5))
            jtrace.save_scenario_trace(b, jtrace.generate(
                mix, 3.0, 4.0, seed=5))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), mix
        assert trace.default_scenarios(256, 100, pallas=True) == \
            jtrace.default_scenarios(256, 100, pallas=True)

    def test_each_loadgen_replays_the_others_trace(self, server, tmp_path):
        """wavetpu's trace through the port's runner, the port's through
        wavetpu's, and the port replica's recording through both: every
        answer a 200, and the two reports of one replay carry the same
        keys and each package's gate reads the other's report."""
        base, _, record = server
        ours, theirs = str(tmp_path / "o.jsonl"), str(tmp_path / "t.jsonl")
        trace.save_scenario_trace(ours, trace.generate(
            "uniform", 1.0, 4.0, scenarios=_mini_scenarios(), seed=2))
        jtrace.save_scenario_trace(theirs, jtrace.generate(
            "uniform", 1.0, 4.0, scenarios=_mini_scenarios(), seed=3))
        res = runner.replay(base, trace.load_scenario_trace(theirs),
                            mode="closed", concurrency=2, timeout=300)
        assert [o.status for o in res.outcomes] == [200] * 4
        jres = jrunner.replay(base, jtrace.load_scenario_trace(ours),
                              mode="closed", concurrency=2, timeout=300)
        assert [o.status for o in jres.outcomes] == [200] * 4
        recorded = jtrace.load_scenario_trace(record)
        assert len(recorded) == 8
        assert recorded == trace.load_scenario_trace(record)
        mine = lg_report.build_report(res, target=base)
        other = jreport.build_report(jres, target=base)
        assert _key_shape(mine) == _key_shape(other)
        # each gate reads the other package's report (as its own
        # baseline: a comparison of two replays' timings would be noise)
        assert lg_report.gate(other, baseline=other) == []
        assert jreport.gate(mine, baseline=mine) == []
        assert lg_report.gate(mine, slo={"error_budget": 0.0}) == \
            jreport.gate(mine, slo={"error_budget": 0.0}) == []


class TestRecordTraceFlag:
    def test_serve_record_trace_writes_a_replayable_trace(self, tmp_path):
        """`python -m wavetpu_torch serve --record-trace FILE` in its own
        process: the accepted /solve bodies land in FILE, which both
        packages' loaders read as a scenario trace."""
        import os
        import re
        import signal
        import subprocess
        import sys
        import urllib.request

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        record = str(tmp_path / "rec.jsonl")
        proc = subprocess.Popen(
            [sys.executable, "-m", "wavetpu_torch", "serve", "--platform",
             "cpu", "--port", "0", "--max-wait-ms", "20", "--record-trace",
             record],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        try:
            lines = []
            for line in proc.stdout:
                lines.append(line)
                m = re.search(r"serve on http://([\d.]+):(\d+)", line)
                if m:
                    break
            assert m, "".join(lines)
            assert any("recording accepted /solve traffic" in ln
                       for ln in lines)
            base = f"http://{m.group(1)}:{m.group(2)}"
            bodies = [{"N": 8, "timesteps": 4},
                      {"N": 8, "timesteps": 4, "phase": 1.0}]
            for body in bodies:
                req = urllib.request.Request(
                    base + "/solve", data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    assert r.status == 200
            proc.send_signal(signal.SIGTERM)
            rest, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0, rest
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        for load in (trace.load_scenario_trace, jtrace.load_scenario_trace):
            recs = load(record)
            assert [r["body"] for r in recs] == bodies
