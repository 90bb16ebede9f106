"""`python -m wavetpu_torch loadgen` - generate, replay, gate (the
port's copy of wavetpu/loadgen/cli.py).

    python -m wavetpu_torch loadgen generate --out TRACE.jsonl [--mix poisson]
        [--duration S] [--qps Q] [--seed N] [--n N] [--timesteps T]
        [--pallas] [--distinct D] [--victim-frac F] [--victim-key K]
        [--aggressor-key K] [--aggressor-mult M]
    python -m wavetpu_torch loadgen replay TRACE.jsonl --target URL
        [--target URL2 ...]
        [--mode open|closed]
        [--concurrency C] [--speed X] [--warmup W] [--timeout S]
        [--retries N] [--duration SECONDS] [--failover]
        [--out REPORT.json] [--no-preflight]
        [--baseline OLD.json] [SLO flags]
    python -m wavetpu_torch loadgen gate REPORT.json --baseline OLD.json
        [SLO flags]

Repeating `--target` fans the replay out round-robin across N replica
URLs (a router-less fleet drill); the report carries a `per_target`
request/error breakdown so failures attribute to a replica, and
server-side metric deltas are summed across all targets.

`--retries N` sends every request through the retrying WavetpuClient
(jittered backoff honoring Retry-After, request-id reuse across
attempts - the chaos-drill client); `--duration S` is SOAK mode: loop
the trace until the wall-clock budget elapses, reported as replay-
window deltas like any run.

`--failover` (requires `--retries` >= 1) flips multi-target from
fan-out to HA: every `--target` joins ONE multi-endpoint client that
rotates off a dead or standby router on retry (the router-failover
drill).  Preflight passes if ANY target is ready, and a target whose
/metrics cannot be scraped (the killed active) is dropped from the
bracketing cuts; the report carries `endpoint_failovers`.

SLO flags (gate + replay-with-baseline; the ABSOLUTE ones also gate a
baseline-less replay when passed explicitly - the chaos smoke's
"zero client-visible errors" check):
    --p99-budget-ms X          absolute p99 cap
    --error-budget F           allowed non-ok non-429 fraction (default 0)
    --reject-budget F          allowed 429 fraction
    --p99-regression-pct P     p99 may grow P% over the baseline (50)
    --throughput-floor-pct P   req/s may drop P% under the baseline (50)
    --max-cold-compiles N      fresh-compile cap for the replay window
                               (0 = a warm program cache must serve
                               every program - the restart drill)
    --min-cache-hit-rate F     result-cache hit-rate floor (replica
                               hits + coalesced + edge hits, over
                               requests) - the warm hotkey-replay
                               drill's "repeats came from memory" check
    --tenant-slo T:KEY=V       per-tenant absolute gate (repeatable);
                               KEY is error-budget, reject-budget, or
                               p95-budget-ms.  The isolation drill pins
                               `--tenant-slo victim:error-budget=0`
                               while the aggressor sheds 429s.
    --error-slo TIER=BUDGET    per-tier MEASURED-ACCURACY gate
                               (repeatable): the tier's worst
                               response-sidecar max_abs_error over the
                               window must exist and stay <= BUDGET -
                               the error-budget loop closed on real
                               numbers (--error-slo compensated=1e-4).
                               Tiers' advisory budgets from the trace
                               are echoed in the report either way.

`--mix tenants` generates the aggressor-vs-victim QoS trace: a victim
tenant replaying the scenario mix at interactive priority interleaved
with an aggressor flooding oversized best_effort solves
(`--victim-frac` splits the qps; `--victim-key`/`--aggressor-key`
stamp api_keys; `--aggressor-mult` scales the aggressor's timesteps).

Exit codes: 0 pass / generated / replayed; 1 SLO violation (the
regression gate failed); 2 usage, unreadable input, or preflight
failure.  `replay` without `--baseline` or SLO flags just writes the
report; `replay --baseline OLD.json` additionally diffs against it and
exits 1 on violation - the one-command perf-regression gate CI runs.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional, Sequence

from wavetpu_torch.core.flags import split_flags as _split_flags
from wavetpu_torch.loadgen import report as lg_report
from wavetpu_torch.loadgen import runner, trace

_USAGE = __doc__.split("Exit codes:")[0].strip()

_SLO_FLAGS = {
    "p99-budget-ms": ("p99_budget_ms", float),
    "error-budget": ("error_budget", float),
    "reject-budget": ("reject_budget", float),
    "p99-regression-pct": ("p99_regression_pct", float),
    "throughput-floor-pct": ("throughput_floor_pct", float),
    "max-cold-compiles": ("max_cold_compiles", int),
    "min-cache-hit-rate": ("min_cache_hit_rate", float),
}

_TENANT_SLO_KEYS = {
    "error-budget": ("error_budget", float),
    "reject-budget": ("reject_budget", float),
    "p95-budget-ms": ("p95_budget_ms", float),
}


def _parse_error_slos(values: Sequence[str]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for raw in values:
        tier, eq, val = raw.partition("=")
        if not (eq and tier):
            raise ValueError(
                f"--error-slo wants TIER=BUDGET, got {raw!r}"
            )
        try:
            out[tier] = float(val)
        except ValueError:
            raise ValueError(
                f"--error-slo budget must be a number, got {raw!r}"
            )
    return out


def _parse_tenant_slos(values: Sequence[str]) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for raw in values:
        head, eq, val = raw.partition("=")
        tenant, colon, key = head.partition(":")
        if not (eq and colon and tenant) or key not in _TENANT_SLO_KEYS:
            raise ValueError(
                f"--tenant-slo wants TENANT:KEY=VALUE with KEY one of "
                f"{sorted(_TENANT_SLO_KEYS)}, got {raw!r}"
            )
        name, conv = _TENANT_SLO_KEYS[key]
        out.setdefault(tenant, {})[name] = conv(val)
    return out


def _slo_from_flags(flags: dict) -> Dict[str, object]:
    slo: Dict[str, object] = {}
    for flag, (key, conv) in _SLO_FLAGS.items():
        if flag in flags:
            slo[key] = conv(flags[flag])
    if flags.get("tenant-slo"):
        slo["tenant_slos"] = _parse_tenant_slos(flags["tenant-slo"])
    if flags.get("error-slo"):
        slo["error_slos"] = _parse_error_slos(flags["error-slo"])
    return slo


def _usage_error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    print(_USAGE, file=sys.stderr)
    return 2


def _generate(argv: Sequence[str]) -> int:
    try:
        pos, flags = _split_flags(
            argv,
            known=("out", "mix", "duration", "qps", "seed", "n",
                   "timesteps", "pallas", "distinct", "victim-frac",
                   "victim-key", "aggressor-key", "aggressor-mult"),
            valueless=("pallas",),
        )
        if pos:
            raise ValueError(f"unexpected positional {pos[0]!r}")
        if "out" not in flags:
            raise ValueError("generate needs --out TRACE.jsonl")
        mix = flags.get("mix", "poisson")
        duration = float(flags.get("duration", "30"))
        qps = float(flags.get("qps", "4"))
        seed = int(flags.get("seed", "0"))
        scenarios = trace.default_scenarios(
            n=int(flags.get("n", "8")),
            timesteps=int(flags.get("timesteps", "20")),
            pallas="pallas" in flags,
        )
        kw = {}
        if mix == "hotkey" and "distinct" in flags:
            kw["distinct"] = int(flags["distinct"])
        if mix == "tenants":
            if "victim-frac" in flags:
                kw["victim_frac"] = float(flags["victim-frac"])
            if "victim-key" in flags:
                kw["victim_key"] = flags["victim-key"]
            if "aggressor-key" in flags:
                kw["aggressor_key"] = flags["aggressor-key"]
            if "aggressor-mult" in flags:
                kw["aggressor_mult"] = int(flags["aggressor-mult"])
        records = trace.generate(
            mix, duration, qps, scenarios=scenarios, seed=seed, **kw
        )
    except ValueError as e:
        return _usage_error(str(e))
    trace.save_scenario_trace(flags["out"], records)
    tiers = sorted({r["scenario"] for r in records})
    print(
        f"wrote {len(records)} requests / {len(tiers)} tiers "
        f"({mix}, {duration:g}s @ {qps:g} qps, seed {seed}) "
        f"-> {flags['out']}"
    )
    return 0


def _run_gate(report: dict, baseline_path: str, slo: dict) -> int:
    try:
        baseline = lg_report.load_report(baseline_path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        return _usage_error(f"cannot read baseline: {e}")
    violations = lg_report.gate(report, baseline=baseline, slo=slo)
    print(lg_report.format_gate(violations, report, baseline))
    return 1 if violations else 0


def _replay(argv: Sequence[str]) -> int:
    try:
        pos, flags = _split_flags(
            argv,
            known=("target", "mode", "concurrency", "speed", "warmup",
                   "timeout", "out", "baseline", "no-preflight",
                   "retries", "duration", "tenant-slo", "error-slo",
                   "failover")
            + tuple(_SLO_FLAGS),
            valueless=("no-preflight", "failover"),
            repeatable=("target", "tenant-slo", "error-slo"),
        )
        if len(pos) != 1:
            raise ValueError("replay wants exactly one TRACE.jsonl")
        if "target" not in flags:
            raise ValueError("replay needs --target URL")
        targets = list(flags["target"])
        mode = flags.get("mode", "open")
        concurrency = int(flags.get("concurrency", "4"))
        speed = float(flags.get("speed", "1"))
        warmup = int(flags.get("warmup", "0"))
        timeout = float(flags.get("timeout", "120"))
        retries = int(flags.get("retries", "0"))
        duration = (
            float(flags["duration"]) if "duration" in flags else None
        )
        slo = _slo_from_flags(flags)
        records = trace.load_scenario_trace(pos[0])
    except ValueError as e:
        return _usage_error(str(e))
    except OSError as e:
        return _usage_error(f"cannot read trace: {e}")
    try:
        result = runner.replay(
            targets, records, mode=mode,
            concurrency=concurrency, speed=speed, warmup=warmup,
            timeout=timeout, skip_preflight="no-preflight" in flags,
            retries=retries, duration=duration,
            failover="failover" in flags,
        )
    except runner.PreflightError as e:
        print(f"error: preflight failed: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        return _usage_error(str(e))
    # Advisory per-tier accuracy budgets from the trace itself (every
    # record of a tier carries the same error_budget) - echoed next to
    # the measured max_abs_err in the report's tier rows.
    budgets: Dict[str, float] = {}
    for rec in records:
        if rec.get("error_budget") is not None:
            budgets.setdefault(rec["scenario"], rec["error_budget"])
    report = lg_report.build_report(
        result, trace_path=pos[0],
        target=targets[0] if len(targets) == 1 else targets,
        error_budgets=budgets or None,
    )
    lat = report["latency_ms"]
    occ = report["server"]["occupancy_mean"]
    print(
        f"replayed {report['requests']} requests in "
        f"{report['wall_seconds']}s ({report['mode']} loop): "
        f"ok {report['ok']}, 429 {report['rejected_429']}, errors "
        f"{report['errors']}; p50 {lat['p50_ms']}ms p99 {lat['p99_ms']}ms; "
        f"occupancy {occ}; cold compiles "
        f"{report['server']['cold_compiles']}; disk hits "
        f"{report['server']['disk_hits']}"
    )
    cache = (report.get("server") or {}).get("cache")
    if cache:
        print(
            f"cache: hit rate {report['cache_hit_rate']} "
            f"(replica {cache['replica_hits']}, coalesced "
            f"{cache['coalesced']}, edge {cache['edge_hits']}); "
            f"duplicate rate {report['duplicate_rate']}"
        )
    if retries:
        print(
            f"retries: {report['retried_requests']} of "
            f"{report['requests']} requests needed retries "
            f"({report['attempts_total']} attempts total)"
        )
    if report.get("failover"):
        print(
            f"failover: {report['endpoint_failovers']} endpoint "
            f"rotation(s) across {len(targets)} router(s)"
        )
    for t, row in sorted((report.get("per_target") or {}).items()):
        print(
            f"  {t}: {row['requests']} requests, ok {row['ok']}, "
            f"429 {row['rejected_429']}, errors {row['errors']}, "
            f"p95 {row['p95_ms']}ms"
        )
    for tenant, row in sorted((report.get("tenants") or {}).items()):
        print(
            f"  tenant {tenant}: {row['requests']} requests, "
            f"ok {row['ok']}, 429 {row['rejected_429']}, "
            f"errors {row['errors']}, p95 {row['p95_ms']}ms"
        )
    for tier, row in sorted((report.get("tiers") or {}).items()):
        # The error-budget loop's human-readable form: measured oracle
        # error per tier vs the trace's advisory budget.
        if row.get("max_abs_err") is None:
            continue
        budget = row.get("error_budget")
        print(
            f"  err {tier}: max_abs_err {row['max_abs_err']:.3e} "
            f"over {row['measured_requests']} measured"
            + (f" (budget {budget:.3e})" if budget is not None else "")
        )
    if "out" in flags:
        with open(flags["out"], "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f"report written: {flags['out']}")
    if "baseline" in flags:
        return _run_gate(report, flags["baseline"], slo)
    absolute = {
        k: v for k, v in slo.items()
        if k in ("p99_budget_ms", "error_budget", "reject_budget",
                 "max_cold_compiles", "min_cache_hit_rate",
                 "tenant_slos", "error_slos")
    }
    if absolute:
        # An explicitly-passed ABSOLUTE SLO gates even without a
        # baseline (the chaos smoke's zero-client-visible-errors
        # check).  A relative-only flag set does NOT - relative gates
        # need a baseline, and triggering the strict default
        # error_budget off an unrelated flag would fail runs nobody
        # asked to gate.
        violations = lg_report.gate(report, baseline=None, slo=absolute)
        print(lg_report.format_gate(violations, report, None))
        return 1 if violations else 0
    return 0


def _gate(argv: Sequence[str]) -> int:
    try:
        pos, flags = _split_flags(
            argv, known=("baseline", "tenant-slo", "error-slo")
            + tuple(_SLO_FLAGS),
            repeatable=("tenant-slo", "error-slo"),
        )
        if len(pos) != 1:
            raise ValueError("gate wants exactly one REPORT.json")
        if "baseline" not in flags:
            raise ValueError("gate needs --baseline OLD.json")
        slo = _slo_from_flags(flags)
    except ValueError as e:
        return _usage_error(str(e))
    try:
        report = lg_report.load_report(pos[0])
    except (OSError, ValueError, json.JSONDecodeError) as e:
        return _usage_error(f"cannot read report: {e}")
    return _run_gate(report, flags["baseline"], slo)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        return _usage_error("missing subcommand (generate|replay|gate)")
    cmd, rest = argv[0], argv[1:]
    if cmd == "generate":
        return _generate(rest)
    if cmd == "replay":
        return _replay(rest)
    if cmd == "gate":
        return _gate(rest)
    return _usage_error(f"unknown subcommand {cmd!r}")


if __name__ == "__main__":
    sys.exit(main())
