"""loadgen_report.json + the perf-regression gate (the port's copy of
wavetpu/loadgen/report.py; the report's JSON keys are wavetpu's).

`build_report` turns one replay (client-side outcomes + the /metrics
cuts bracketing it) into a machine-readable report:

 * overall and PER-SCENARIO-TIER latency percentiles (p50/p95/p99,
   nearest-rank - the same definition /metrics and trace-report use),
 * outcome accounting: ok / 429-reject / error rates,
 * mean Server-Timing attribution (queue vs compile vs execute vs
   padding) overall and per tier - where the latency went, fleet-wide,
 * server-side deltas for exactly the replayed window: batch occupancy,
   padding-lane waste, cold-vs-warm compile counts, queue rejections,
   aggregate Gcell/s,
 * the slowest request ids - each joinable to its server-side critical
   path via `python -m wavetpu_torch trace-report --request ID`.

`gate(report, baseline, slo)` is the regression gate `python -m
wavetpu_torch loadgen --baseline OLD.json` runs: absolute SLOs (p99
budget, error budget) and relative ones against the baseline report
(p99 regression %, throughput floor %).  It returns a violation list;
the CLI exits 1 when it is non-empty.  Defaults are deliberately loose
enough for shared-host noise and tight enough that a 10x max-wait
misconfiguration cannot pass.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence

from wavetpu_torch.obs.report import percentile_nearest_rank

# Gate defaults: see module docstring for the calibration argument.
DEFAULT_SLO = {
    "p99_budget_ms": None,        # absolute p99 cap (None = off)
    "error_budget": 0.0,          # allowed non-ok non-429 fraction
    "reject_budget": None,        # allowed 429 fraction (None = off)
    "p99_regression_pct": 50.0,   # p99 may grow this % over baseline
    "throughput_floor_pct": 50.0,  # req/s may drop this % under baseline
    "max_cold_compiles": None,    # fresh-compile cap (0 = "a warm
                                  # replica must compile nothing")
    "min_cache_hit_rate": None,   # result-cache floor across all tiers
                                  # (replica hits + coalesced riders +
                                  # router edge hits, over requests)
    # Per-tenant absolute gates on the report's `tenants` breakdown:
    # {"TENANT": {"error_budget": F, "reject_budget": F,
    #             "p95_budget_ms": X}} - the isolation drill's "victim
    # sees zero errors while the aggressor eats 429s" check in ONE
    # mixed replay (--tenant-slo victim:error_budget=0).
    "tenant_slos": None,
    # Per-tier MEASURED-ACCURACY gates: {"TIER": MAX_ABS_ERR} against
    # the tiers' `max_abs_err` (worst response-sidecar oracle error in
    # the window) - the error-budget loop's CI form (--error-slo
    # compensated=1e-4 fails a replay where the flagship scheme's
    # measured error regressed past its budget).
    "error_slos": None,
}

_TIMING_KEYS = ("queue", "compile", "execute", "padding")


def _pcts(latencies_ms: Sequence[float]) -> Dict[str, Optional[float]]:
    if not latencies_ms:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None,
                "mean_ms": None, "max_ms": None}
    s = sorted(latencies_ms)
    return {
        "p50_ms": round(percentile_nearest_rank(s, 0.50), 3),
        "p95_ms": round(percentile_nearest_rank(s, 0.95), 3),
        "p99_ms": round(percentile_nearest_rank(s, 0.99), 3),
        "mean_ms": round(sum(s) / len(s), 3),
        "max_ms": round(s[-1], 3),
    }


def _delta(after: Dict[str, float], before: Dict[str, float],
           name: str) -> float:
    return after.get(name, 0.0) - before.get(name, 0.0)


def build_report(result, trace_path: Optional[str] = None,
                 target: Optional[str] = None,
                 meta: Optional[dict] = None,
                 error_budgets: Optional[Dict[str, float]] = None) -> dict:
    """One replay -> the loadgen_report.json dict (see module doc).
    `result` is a runner.ReplayResult.  `error_budgets` maps scenario
    tier -> advisory accuracy budget (the trace records' error_budget
    field); budgets are echoed next to each tier's measured
    max_abs_err so the report reads as measured-vs-budget."""
    outs = result.outcomes
    n = len(outs)
    ok = sum(1 for o in outs if o.status == 200)
    rejected = sum(1 for o in outs if o.status == 429)
    errors = n - ok - rejected
    lat_ms = [o.latency_s * 1e3 for o in outs]

    tiers: Dict[str, dict] = {}
    for tier in sorted({o.scenario for o in outs}):
        sub = [o for o in outs if o.scenario == tier]
        t_lat = [o.latency_s * 1e3 for o in sub]
        t_ok = sum(1 for o in sub if o.status == 200)
        row = {
            "requests": len(sub),
            "ok": t_ok,
            "error_rate": round(1.0 - t_ok / len(sub), 4),
            # Per-tier retry accounting (the aggregate-only fields below
            # hid WHICH tier the retrying client was absorbing failures
            # for - e.g. one circuit-broken tier retrying while the rest
            # sail through).
            "attempts_total": sum(o.attempts for o in sub),
            "retried_requests": sum(1 for o in sub if o.attempts > 1),
        }
        row.update(_pcts(t_lat))
        # Measured accuracy from the response sidecar (the error-budget
        # loop): the tier's worst oracle error over the window, next to
        # its advisory budget from the trace.  Both omitted when the
        # server computed no errors for the tier (c2-field lanes,
        # --no-errors) so pre-accuracy baselines keep their shape.
        errs = [
            o.max_abs_error for o in sub
            if getattr(o, "max_abs_error", None) is not None
        ]
        if errs:
            row["max_abs_err"] = max(errs)
            row["measured_requests"] = len(errs)
        budget = (error_budgets or {}).get(tier)
        if budget is not None:
            row["error_budget"] = budget
        st = [o.server_timing for o in sub if o.server_timing]
        if st:
            row["server_timing_mean_ms"] = {
                k: round(
                    sum(s.get(k, 0.0) for s in st) / len(st) * 1e3, 3
                )
                for k in _TIMING_KEYS
            }
        tiers[tier] = row

    st_all = [o.server_timing for o in outs if o.server_timing]
    timing_mean = {
        k: round(
            sum(s.get(k, 0.0) for s in st_all) / len(st_all) * 1e3, 3
        )
        for k in _TIMING_KEYS
    } if st_all else None

    before, after = result.metrics_before, result.metrics_after
    occ_sum = _delta(after, before, "wavetpu_serve_batch_occupancy_sum")
    occ_n = _delta(after, before, "wavetpu_serve_batch_occupancy_count")
    cells = _delta(after, before, "wavetpu_serve_cells_total")
    solve_s = _delta(after, before, "wavetpu_serve_solve_seconds_total")
    server = {
        "batches": int(occ_n),
        "occupancy_mean": round(occ_sum / occ_n, 3) if occ_n else None,
        "padding_lanes": int(_delta(
            after, before, "wavetpu_serve_padding_lanes_total"
        )),
        "queue_rejected": int(_delta(
            after, before, "wavetpu_serve_rejected_total"
        )),
        "limit_rejected": int(sum(
            _delta(after, before, name)
            for name in after
            if name.startswith("wavetpu_serve_limit_rejected_total")
        )),
        "fallback_batches": int(_delta(
            after, before, "wavetpu_serve_fallback_batches_total"
        )),
        # Cold-vs-warm program traffic during the replay window: misses
        # are FRESH compiles the replay paid, hits the warmed steady
        # state, disk_hits persistent-cache adoptions (a restarted
        # replica with a warm --program-cache-dir shows disk_hits > 0
        # and cold_compiles == 0 - the "compiled nothing" CI assert).
        "cold_compiles": int(_delta(
            after, before,
            'wavetpu_program_cache_events_total{event="miss"}',
        )),
        "warm_hits": int(_delta(
            after, before,
            'wavetpu_program_cache_events_total{event="hit"}',
        )),
        "disk_hits": int(_delta(
            after, before,
            'wavetpu_program_cache_events_total{event="disk_hit"}',
        )),
        "evictions": int(_delta(
            after, before,
            'wavetpu_program_cache_events_total{event="eviction"}',
        )),
        "aggregate_gcells_per_s": (
            round(cells / solve_s / 1e9, 4) if solve_s else None
        ),
    }
    # Result-cache traffic during the window, per tier: replica hits
    # (stored solve replayed, no march), coalesced riders (fanned out
    # from an identical in-flight solve), and router edge hits (zero
    # replica I/O).  Omitted entirely when no cache tier moved, so
    # pre-cache reports and baselines keep their exact shape.
    cache_hits = int(_delta(
        after, before,
        'wavetpu_serve_resultcache_events_total{event="hit"}',
    ))
    coalesced = int(_delta(
        after, before, "wavetpu_serve_coalesced_total",
    ))
    edge_hits = int(_delta(
        after, before, "wavetpu_router_edgecache_hits_total",
    ))
    cache_stores = int(_delta(
        after, before,
        'wavetpu_serve_resultcache_events_total{event="store"}',
    ))
    if cache_hits or coalesced or edge_hits or cache_stores:
        server["cache"] = {
            "replica_hits": cache_hits,
            "coalesced": coalesced,
            "edge_hits": edge_hits,
            "stores": cache_stores,
            "misses": int(_delta(
                after, before,
                'wavetpu_serve_resultcache_events_total{event="miss"}',
            )),
        }

    # Per-target breakdown (repeated --target, i.e. a fleet driven
    # without a router in front): which replica served what, and which
    # one the failures came from - a fleet drill must attribute, not
    # average.  Omitted for the single-target report (no new field to
    # confuse old baselines).
    per_target: Optional[Dict[str, dict]] = None
    target_urls = sorted({o.target for o in outs if o.target})
    if len(getattr(result, "targets", []) or []) > 1 or \
            len(target_urls) > 1:
        per_target = {}
        for t in sorted(set(getattr(result, "targets", []) or [])
                        | set(target_urls)):
            sub = [o for o in outs if o.target == t]
            t_ok = sum(1 for o in sub if o.status == 200)
            t_rej = sum(1 for o in sub if o.status == 429)
            row = {
                "requests": len(sub),
                "ok": t_ok,
                "rejected_429": t_rej,
                "errors": len(sub) - t_ok - t_rej,
                "retried_requests": sum(
                    1 for o in sub if o.attempts > 1
                ),
            }
            row.update(_pcts([o.latency_s * 1e3 for o in sub]))
            per_target[t] = row

    # Per-tenant / per-class breakdown (QoS traces: records carrying
    # `tenant` / `priority`).  Omitted entirely for single-tenant
    # traces so pre-QoS reports and baselines keep their exact shape.
    def _qos_rows(key) -> Optional[Dict[str, dict]]:
        labels = sorted({key(o) for o in outs if key(o)})
        if not labels:
            return None
        rows: Dict[str, dict] = {}
        for label in labels:
            sub = [o for o in outs if key(o) == label]
            s_ok = sum(1 for o in sub if o.status == 200)
            s_rej = sum(1 for o in sub if o.status == 429)
            row = {
                "requests": len(sub),
                "ok": s_ok,
                "rejected_429": s_rej,
                "errors": len(sub) - s_ok - s_rej,
                "reject_rate": round(s_rej / len(sub), 4),
                "error_rate": round(
                    (len(sub) - s_ok - s_rej) / len(sub), 4
                ),
                "retried_requests": sum(
                    1 for o in sub if o.attempts > 1
                ),
            }
            row.update(_pcts([o.latency_s * 1e3 for o in sub]))
            rows[label] = row
        return rows

    tenants = _qos_rows(lambda o: getattr(o, "tenant", ""))
    classes = _qos_rows(lambda o: getattr(o, "priority", ""))

    slowest = sorted(outs, key=lambda o: -o.latency_s)[:5]
    report = {
        "loadgen_report": True,
        "generated_unix": round(time.time(), 3),
        "target": target,
        "trace": trace_path,
        "mode": result.mode,
        "concurrency": result.concurrency,
        "speed": result.speed,
        "warmup_requests": len(result.warmup_outcomes),
        "wall_seconds": round(result.wall_seconds, 3),
        "requests": n,
        "ok": ok,
        "rejected_429": rejected,
        "errors": errors,
        "reject_rate": round(rejected / n, 4) if n else None,
        "error_rate": round(errors / n, 4) if n else None,
        # Retry accounting (the retrying client's absorption record):
        # attempts_total == requests when --retries is off or nothing
        # failed; retried_requests counts logical requests that needed
        # more than one attempt to reach their final status.
        "attempts_total": sum(o.attempts for o in outs),
        "retried_requests": sum(1 for o in outs if o.attempts > 1),
        "requests_per_s": (
            round(n / result.wall_seconds, 3)
            if result.wall_seconds else None
        ),
        # Fraction of replayed bodies that were exact repeats of an
        # earlier body in the same trace - the result-cache tiers'
        # opportunity ceiling (a warm replay's hit rate approaches it).
        "duplicate_rate": round(
            getattr(result, "duplicate_rate", 0.0), 4
        ),
        "cache_hit_rate": (
            round((cache_hits + coalesced + edge_hits) / n, 4)
            if n else None
        ),
        "latency_ms": _pcts(lat_ms),
        "server_timing_mean_ms": timing_mean,
        "tiers": tiers,
        "server": server,
        # The join handles: feed any of these to
        # `python -m wavetpu_torch trace-report --request ID` against the
        # server's telemetry dir(s) to see that exact request's critical path;
        # `traceparent` carries the fleet trace id the request rode
        # across the router and every replica it touched.
        "slowest_requests": [
            {
                "request_id": o.request_id,
                "scenario": o.scenario,
                "status": o.status,
                "latency_ms": round(o.latency_s * 1e3, 3),
                "traceparent": getattr(o, "traceparent", ""),
            }
            for o in slowest
        ],
    }
    if per_target is not None:
        report["per_target"] = per_target
        report["targets"] = list(getattr(result, "targets", []) or [])
    if getattr(result, "failover", False):
        # HA replay: how many times the shared client rotated off a
        # dead or standby endpoint (0 on an uneventful run).
        report["failover"] = True
        report["endpoint_failovers"] = int(
            getattr(result, "endpoint_failovers", 0)
        )
    if tenants is not None:
        report["tenants"] = tenants
    if classes is not None:
        report["classes"] = classes
    if meta:
        report["meta"] = meta
    return report


def load_report(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        report = json.load(f)
    if not isinstance(report, dict) or not report.get("loadgen_report"):
        raise ValueError(f"{path} is not a loadgen report")
    return report


def gate(report: dict, baseline: Optional[dict] = None,
         slo: Optional[dict] = None) -> List[dict]:
    """Evaluate the SLOs; returns the violation list (empty = pass).
    Absolute gates (p99 budget, error/reject budgets) always apply;
    relative gates (p99 regression, throughput floor) need `baseline`."""
    cfg = dict(DEFAULT_SLO)
    if slo:
        unknown = set(slo) - set(DEFAULT_SLO)
        if unknown:
            raise ValueError(f"unknown SLO keys {sorted(unknown)}")
        cfg.update({k: v for k, v in slo.items() if v is not None})
    out: List[dict] = []

    def fail(name, observed, budget, detail):
        out.append({"slo": name, "observed": observed,
                    "budget": budget, "detail": detail})

    p99 = (report.get("latency_ms") or {}).get("p99_ms")
    if cfg["p99_budget_ms"] is not None:
        if p99 is None or p99 > cfg["p99_budget_ms"]:
            fail("p99_budget_ms", p99, cfg["p99_budget_ms"],
                 f"p99 {p99} ms exceeds budget "
                 f"{cfg['p99_budget_ms']} ms")
    err = report.get("error_rate")
    if cfg["error_budget"] is not None and err is not None \
            and err > cfg["error_budget"]:
        fail("error_budget", err, cfg["error_budget"],
             f"error rate {err} exceeds budget {cfg['error_budget']}")
    rej = report.get("reject_rate")
    if cfg["reject_budget"] is not None and rej is not None \
            and rej > cfg["reject_budget"]:
        fail("reject_budget", rej, cfg["reject_budget"],
             f"429 reject rate {rej} exceeds budget "
             f"{cfg['reject_budget']}")
    # Persistent-cache gate: a replay against a replica whose program
    # cache SHOULD be warm (second replica start) asserts zero fresh
    # compiles here - the CI-checkable form of "restart paid nothing".
    cold = (report.get("server") or {}).get("cold_compiles")
    if cfg["max_cold_compiles"] is not None and cold is not None \
            and cold > cfg["max_cold_compiles"]:
        fail("max_cold_compiles", cold, cfg["max_cold_compiles"],
             f"{cold} fresh compile(s) during replay exceeds budget "
             f"{cfg['max_cold_compiles']} (program cache not warm)")
    # Result-cache gate: a WARM hotkey replay (same trace replayed
    # twice through the same replica/router) asserts a hit-rate floor
    # here - the CI-checkable form of "repeats were answered from
    # memory, not re-marched".
    hit_rate = report.get("cache_hit_rate")
    if cfg["min_cache_hit_rate"] is not None and (
            hit_rate is None or hit_rate < cfg["min_cache_hit_rate"]):
        fail("min_cache_hit_rate", hit_rate, cfg["min_cache_hit_rate"],
             f"cache hit rate {hit_rate} below floor "
             f"{cfg['min_cache_hit_rate']} (result cache not warm)")
    # Per-tenant gates against the QoS breakdown: the isolation drill's
    # one-replay form (victim zero-error while the aggressor is
    # legitimately shedding 429s).
    if cfg["tenant_slos"]:
        rows = report.get("tenants") or {}
        for tenant, tslo in sorted(cfg["tenant_slos"].items()):
            row = rows.get(tenant)
            if row is None:
                fail(f"tenant:{tenant}", None, tslo,
                     f"tenant {tenant!r} has an SLO but no requests "
                     f"in the report")
                continue
            unknown = set(tslo) - {
                "error_budget", "reject_budget", "p95_budget_ms"
            }
            if unknown:
                raise ValueError(
                    f"unknown tenant SLO keys {sorted(unknown)} "
                    f"for {tenant!r}"
                )
            if tslo.get("error_budget") is not None \
                    and row["error_rate"] > tslo["error_budget"]:
                fail(f"tenant:{tenant}:error_budget",
                     row["error_rate"], tslo["error_budget"],
                     f"tenant {tenant!r} error rate "
                     f"{row['error_rate']} exceeds budget "
                     f"{tslo['error_budget']}")
            if tslo.get("reject_budget") is not None \
                    and row["reject_rate"] > tslo["reject_budget"]:
                fail(f"tenant:{tenant}:reject_budget",
                     row["reject_rate"], tslo["reject_budget"],
                     f"tenant {tenant!r} 429 rate "
                     f"{row['reject_rate']} exceeds budget "
                     f"{tslo['reject_budget']}")
            if tslo.get("p95_budget_ms") is not None and (
                row["p95_ms"] is None
                or row["p95_ms"] > tslo["p95_budget_ms"]
            ):
                fail(f"tenant:{tenant}:p95_budget_ms",
                     row["p95_ms"], tslo["p95_budget_ms"],
                     f"tenant {tenant!r} p95 {row['p95_ms']} ms "
                     f"exceeds budget {tslo['p95_budget_ms']} ms")

    # Measured-accuracy gates: the error-budget loop's teeth.  A tier
    # with an SLO must exist AND have measured errors AND be inside its
    # budget - "no data" passes nothing (a --no-errors server or a
    # renamed tier must not silently green the accuracy gate).
    if cfg["error_slos"]:
        rows = report.get("tiers") or {}
        for tier, budget in sorted(cfg["error_slos"].items()):
            row = rows.get(tier)
            if row is None:
                fail(f"err:{tier}", None, budget,
                     f"tier {tier!r} has an error SLO but no requests "
                     f"in the report")
                continue
            measured = row.get("max_abs_err")
            if measured is None:
                fail(f"err:{tier}", None, budget,
                     f"tier {tier!r} has an error SLO but the replay "
                     f"measured no errors (server --no-errors, or a "
                     f"c2-field tier with no oracle)")
            elif measured > budget:
                fail(f"err:{tier}", measured, budget,
                     f"tier {tier!r} measured max_abs_err "
                     f"{measured:.3e} exceeds budget {budget:.3e}")

    if baseline is not None:
        base_p99 = (baseline.get("latency_ms") or {}).get("p99_ms")
        if cfg["p99_regression_pct"] is not None and base_p99 and p99:
            limit = base_p99 * (1.0 + cfg["p99_regression_pct"] / 100.0)
            if p99 > limit:
                fail("p99_regression_pct",
                     round(100.0 * (p99 / base_p99 - 1.0), 1),
                     cfg["p99_regression_pct"],
                     f"p99 {p99} ms vs baseline {base_p99} ms "
                     f"(+{100.0 * (p99 / base_p99 - 1.0):.1f}% > "
                     f"+{cfg['p99_regression_pct']}% allowed)")
        base_rps = baseline.get("requests_per_s")
        rps = report.get("requests_per_s")
        if cfg["throughput_floor_pct"] is not None and base_rps and rps:
            floor = base_rps * (1.0 - cfg["throughput_floor_pct"] / 100.0)
            if rps < floor:
                fail("throughput_floor_pct",
                     round(100.0 * (1.0 - rps / base_rps), 1),
                     cfg["throughput_floor_pct"],
                     f"throughput {rps} req/s vs baseline {base_rps} "
                     f"req/s (-{100.0 * (1.0 - rps / base_rps):.1f}% > "
                     f"-{cfg['throughput_floor_pct']}% allowed)")
    return out


def format_gate(violations: Sequence[dict], report: dict,
                baseline: Optional[dict] = None) -> str:
    """The human-readable gate diff (also a useful CI artifact)."""
    lines = ["loadgen regression gate"]

    def row(label, new, old, unit=""):
        if old is not None and new is not None and old:
            pct = 100.0 * (new / old - 1.0)
            lines.append(
                f"  {label:<18} {new:>10} vs {old:>10} {unit} "
                f"({pct:+.1f}%)"
            )
        else:
            lines.append(f"  {label:<18} {new!r:>10} (no baseline)")

    lat = report.get("latency_ms") or {}
    blat = (baseline or {}).get("latency_ms") or {}
    row("p50_ms", lat.get("p50_ms"), blat.get("p50_ms"), "ms")
    row("p99_ms", lat.get("p99_ms"), blat.get("p99_ms"), "ms")
    row("requests_per_s", report.get("requests_per_s"),
        (baseline or {}).get("requests_per_s"), "req/s")
    lines.append(
        f"  {'error_rate':<18} {report.get('error_rate')!r:>10}"
        f"   reject_rate {report.get('reject_rate')!r}"
    )
    srv = report.get("server") or {}
    if "cold_compiles" in srv:
        # Compile traffic during the window: the line CI greps to prove
        # a restarted replica served entirely from the persistent cache.
        lines.append(
            f"  {'compiles':<18} {srv.get('cold_compiles')} fresh, "
            f"{srv.get('disk_hits', 0)} disk hit(s), "
            f"{srv.get('warm_hits')} warm hit(s)"
        )
    cache = srv.get("cache")
    if cache:
        # Cache traffic per tier: the line CI greps to prove a warm
        # replay was answered from memory (and WHERE - replica vs edge).
        lines.append(
            f"  {'cache':<18} rate "
            f"{report.get('cache_hit_rate')!r} "
            f"(replica {cache.get('replica_hits')}, coalesced "
            f"{cache.get('coalesced')}, edge {cache.get('edge_hits')}; "
            f"dup rate {report.get('duplicate_rate')!r})"
        )
    measured_tiers = {
        tier: row for tier, row in (report.get("tiers") or {}).items()
        if row.get("max_abs_err") is not None
    }
    if measured_tiers:
        # Measured accuracy vs advisory budget, per tier: the line CI
        # greps to prove the error-budget loop closed on real numbers.
        for tier, trow in sorted(measured_tiers.items()):
            budget = trow.get("error_budget")
            lines.append(
                f"  {'err:' + tier:<18} max_abs_err "
                f"{trow['max_abs_err']:.3e} over "
                f"{trow.get('measured_requests')} measured"
                + (f" (budget {budget:.3e})" if budget is not None
                   else " (no budget)")
            )
    for section, singular in (("tenants", "tenant"), ("classes", "class")):
        # QoS breakdown: one line per tenant/class so the isolation
        # drill's victim-vs-aggressor split is visible in the gate text.
        for label, trow in sorted((report.get(section) or {}).items()):
            lines.append(
                f"  {singular + ':' + label:<18} "
                f"{trow['requests']} req, p95 {trow.get('p95_ms')!r} ms, "
                f"429 {trow['rejected_429']}, err {trow['errors']}"
            )
    att = report.get("attempts_total")
    req = report.get("requests")
    if att and req and att > req:
        # Retry absorption, broken out per tier: the gate diff must say
        # WHERE the retrying client worked, not just that it did.
        lines.append(
            f"  {'retries':<18} {report.get('retried_requests')} "
            f"request(s) retried ({att} attempts / {req} requests)"
        )
        for tier, row in sorted((report.get("tiers") or {}).items()):
            if row.get("retried_requests"):
                lines.append(
                    f"    {tier}: {row['retried_requests']} retried, "
                    f"{row['attempts_total']} attempts / "
                    f"{row['requests']} requests"
                )
    if violations:
        lines.append("violations:")
        for v in violations:
            lines.append(f"  FAIL [{v['slo']}] {v['detail']}")
        lines.append("-> FAIL")
    else:
        lines.append("-> PASS")
    return "\n".join(lines)
