"""Accuracy observatory: per-plan measured-error ledger + plan-report
(the port's copy of wavetpu/obs/accuracy.py).

The solver family spans a wide speed-accuracy trade (the bf16-increment
mode against the compensated f32 flagship) that speed telemetry alone
does not record.  This module is the accuracy half: every
solve that computes errors against the analytic oracle appends one line
to an APPEND-ONLY JSONL file under `--telemetry-dir`:

    {"type": "accuracy", "ts": 1754500000.0, "pid": 4242,
     "plan": {"scheme": "standard", "path": "kfused", "k": 4,
              "dtype": "bf16", "with_field": false},
     "n": 512, "n_bucket": 512, "timesteps": 1000,
     "max_abs_err": 1e-3, "wall_s": 1.0, "cells": 1.35e11,
     "source": "oracle"}

`plan` is the (scheme, path, k, dtype, with_field) tuple - the exact
program-identity slice that decides numerical behavior, shared with
`wavetpu_torch.progkey`.  `n_bucket` is N rounded up to a power of two so
requests at N=100 and N=120 aggregate into one frontier row.  `source`
distinguishes how the error was measured: "oracle" (analytic standing
wave - solo CLI solves and serve lanes with compute_errors on) vs
"shadow" (wavetpu's `serve --shadow-sample-rate P`, serve/shadow.py:
max_abs_err is then the measured L-infinity DIVERGENCE of the served
plan's answer vs its compensated-f32 reference twin - accuracy
telemetry even where no analytic solution exists).

The file follows `obs/ledger.py`'s discipline exactly: append-only,
best-effort writes (a full disk never crashes the solve it observes),
EXEMPT from telemetry rotation, foreign/malformed lines skipped with a
stderr note instead of crashing the report, and pure stdlib - never
imports torch - so `wavetpu-torch plan-report` runs off-accelerator against a
scraped telemetry dir.

`wavetpu-torch plan-report DIR [--json] [--emit-plan-table OUT.json]` joins
this ledger with the compile ledger and `obs/perf.py`'s roofline model
into the measured speed-accuracy frontier per (plan, N-bucket):
measured Gcell/s, measured wall s/request, measured error percentiles,
compile spend, roofline fraction, and Pareto-dominance flags.
`--emit-plan-table` writes `plan_table.json` - the input ROADMAP
direction 4's error-budget planner consumes, and (carrying measured
wall s/request per plan) the drop-in replacement for the analytic
cells pricing in `fleet/quota.py`.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

ACCURACY_FILENAME = "accuracy_ledger.jsonl"
LEDGER_FILENAME = ACCURACY_FILENAME  # telemetry.py symmetry with ledger.py

PLAN_TABLE_FLAG = "wavetpu_plan_table"

PLAN_FIELDS = ("scheme", "path", "k", "dtype", "with_field")

# Log-decade buckets for the per-plan error histogram: the measured
# trade spans 5.7e-6 (compensated f32) to 0.66 (bf16 onion), so decades
# from 1e-8 up cover every plan the bench has produced with room on
# both ends.
ERR_BUCKETS = (1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)


def n_bucket(n: int) -> int:
    """N rounded UP to a power of two (N=100 and N=120 share bucket
    128): frontier rows aggregate comparable problem sizes without one
    row per distinct grid."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def normalize_plan(plan: dict) -> dict:
    """Validate + canonically order a plan dict (the scheme/path/k/
    dtype/with_field slice of a ProgramKey).  Unknown fields are
    rejected loudly - same discipline as progkey.normalize_key."""
    extra = set(plan) - set(PLAN_FIELDS)
    if extra:
        raise ValueError(f"unknown plan field(s): {sorted(extra)}")
    missing = set(PLAN_FIELDS) - set(plan)
    if missing:
        raise ValueError(f"missing plan field(s): {sorted(missing)}")
    return {
        "scheme": str(plan["scheme"]),
        "path": str(plan["path"]),
        "k": int(plan["k"]),
        "dtype": str(plan["dtype"]),
        "with_field": bool(plan["with_field"]),
    }


def canonical_plan(plan: dict) -> str:
    return json.dumps(normalize_plan(plan), sort_keys=True)


def plan_label(plan: dict) -> str:
    return (
        f"{plan['scheme']}:{plan['path']} k={plan['k']} {plan['dtype']}"
        + (" field" if plan.get("with_field") else "")
    )


def make_plan(scheme: str, path: str, k: int, dtype: str,
              with_field: bool = False) -> dict:
    """A plan dict from the loose (scheme, path, k, dtype) call-site
    shape; `k` forced to 1 off the onion paths, like ProgramKey."""
    return normalize_plan({
        "scheme": scheme, "path": path,
        "k": k if "kfused" in path else 1,
        "dtype": dtype, "with_field": bool(with_field),
    })


_DTYPE_NAMES = {
    "float32": "f32", "float64": "f64", "bfloat16": "bf16",
    "torch.float32": "f32", "torch.float64": "f64",
    "torch.bfloat16": "bf16",
    "f32": "f32", "f64": "f64", "bf16": "bf16",
}


def dtype_name(dtype) -> str:
    """Ledger dtype label from a numpy/torch dtype or a name string
    (unknown dtypes pass through as their string form - a foreign
    dtype must not crash the recording seam)."""
    return _DTYPE_NAMES.get(str(dtype), str(dtype))


class AccuracyLedger:
    """Append-only JSONL writer for one accuracy ledger file.

    Best-effort like the compile ledger: a full disk must never crash
    the solve the ledger observes.  The file accumulates across
    processes (append mode, no rotation)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def record(self, plan: dict, n: int, timesteps: int,
               max_abs_err: float, wall_s: float, cells: float,
               source: str = "oracle", ts: Optional[float] = None,
               pid: Optional[int] = None) -> dict:
        rec = {
            "type": "accuracy",
            "ts": round(time.time() if ts is None else ts, 3),
            "pid": os.getpid() if pid is None else int(pid),
            "plan": normalize_plan(plan),
            "n": int(n),
            "n_bucket": n_bucket(n),
            "timesteps": int(timesteps),
            "max_abs_err": float(max_abs_err),
            "wall_s": round(float(wall_s), 6),
            "cells": float(cells),
            "source": str(source),
        }
        with self._lock:
            try:
                if not self._f.closed:
                    self._f.write(json.dumps(rec) + "\n")
                    self._f.flush()
            except (OSError, ValueError):
                pass
        return rec

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


# ------------------------------------------------- process singleton

_ledger: Optional[AccuracyLedger] = None
_config_lock = threading.Lock()


def configure(path: str) -> AccuracyLedger:
    """Bind the process accuracy ledger (telemetry.start does this
    under `--telemetry-dir`); replaces a previous one."""
    global _ledger
    with _config_lock:
        if _ledger is not None:
            _ledger.close()
        _ledger = AccuracyLedger(path)
        return _ledger


def disable() -> None:
    global _ledger
    with _config_lock:
        if _ledger is not None:
            _ledger.close()
        _ledger = None


def get_ledger() -> Optional[AccuracyLedger]:
    return _ledger


def enabled() -> bool:
    return _ledger is not None


def record_accuracy(plan: dict, n: int, timesteps: int,
                    max_abs_err: float, wall_s: float, cells: float,
                    source: str = "oracle") -> None:
    """Record one measured error into the process ledger; a None-check
    no-op (zero file I/O) when no telemetry dir configured one."""
    led = _ledger
    if led is not None:
        led.record(plan, n, timesteps, max_abs_err, wall_s, cells,
                   source=source)


def record_error_metrics(registry, plan: dict, max_abs_err: float,
                         shadow: bool = False) -> None:
    """Stamp one measured error into `registry` (gauge + log-bucketed
    histogram, labeled by the plan's path/scheme/dtype).  Shadow
    divergences (serve/shadow.py) get their own gauge so the oracle
    signal and the production-divergence signal never overwrite each
    other."""
    labels = dict(path=plan["path"], scheme=plan["scheme"],
                  dtype=plan["dtype"])
    if shadow:
        registry.gauge(
            "wavetpu_shadow_divergence",
            "L-inf divergence of the served plan vs its reference "
            "twin, most recent shadow solve",
            ("path", "scheme", "dtype"),
        ).set(float(max_abs_err), **labels)
    else:
        registry.gauge(
            "wavetpu_solve_max_abs_err",
            "max abs error vs the analytic oracle, most recent solve",
            ("path", "scheme", "dtype"),
        ).set(float(max_abs_err), **labels)
    registry.histogram(
        "wavetpu_solve_abs_err",
        "per-plan measured-error distribution (log-decade buckets)",
        ("path", "scheme", "dtype"), buckets=ERR_BUCKETS,
    ).observe(float(max_abs_err), **labels)


def observe_solve(result, path: str, *, scheme: str, k: int,
                  with_field: bool, registry) -> None:
    """The single recording seam for the instrumented solver entry
    points (obs/metrics.record_solve threads every solver family
    through here).  `result` is a leapfrog.SolveResult whose
    `abs_errors` is None when the oracle was skipped - then NOTHING is
    recorded: the accuracy observatory only ever reports measured
    errors.  Caller guards exceptions (the X-ray must never fail the
    solve)."""
    errs = getattr(result, "abs_errors", None)
    if errs is None:
        return
    max_err = float(max(float(e) for e in errs))
    # The solver family's errors-off sentinel is an ALL-ZERO error
    # array (bench.py's errors_computed contract): a measured max of
    # exactly 0.0 is that sentinel, never a real oracle verdict -
    # ledgering it would claim perfect accuracy for an unchecked solve.
    if max_err <= 0.0:
        return
    plan = make_plan(scheme, path, k, dtype_name(result.u_cur.dtype),
                     with_field)
    record_error_metrics(registry, plan, max_err)
    problem = result.problem
    steps = result.steps_computed or problem.timesteps
    record_accuracy(
        plan, problem.N, problem.timesteps, max_err,
        float(result.solve_seconds or 0.0),
        float(problem.cells_per_step) * steps,
    )


def observe_serve_batch(result, verdicts, *, scheme: str, k: int,
                        dtype: str, registry) -> None:
    """Per-lane accuracy recording off the serve engine's watchdog
    reduction: each HEALTHY lane that computed oracle errors records
    one ledger line + metric stamp for the plan that served it (the
    batch's actual `result.path`, so a lane-loop fallback is labeled
    as what ran).  Tripped lanes are excluded - their error fields are
    poison, and their 422 already tells the story.  Caller guards
    exceptions (the X-ray must never fail the batch)."""
    plan = None
    for r, verdict in zip(result.results, verdicts):
        if verdict is not None:
            continue
        errs = getattr(r, "abs_errors", None)
        if errs is None:
            continue
        max_err = float(max(float(e) for e in errs))
        if max_err <= 0.0:
            continue  # all-zero = the errors-off sentinel, not a verdict
        if plan is None:
            plan = make_plan(scheme, result.path, k, dtype_name(dtype))
        record_error_metrics(registry, plan, max_err)
        problem = r.problem
        steps = getattr(r, "steps_computed", None) or problem.timesteps
        record_accuracy(
            plan, problem.N, problem.timesteps, max_err,
            float(result.solve_seconds or 0.0),
            float(problem.cells_per_step) * steps,
        )


def resolve_accuracy_path(path: str) -> str:
    """Accept a telemetry DIR (the common case) or the ledger file."""
    if os.path.isdir(path):
        return os.path.join(path, ACCURACY_FILENAME)
    return path


def load_accuracy_ledger(path: str) -> List[dict]:
    """Parse the accuracy ledger; malformed/foreign lines counted, not
    fatal (the file may be mid-append, and an append-only cross-version
    file may hold records a newer/older wavetpu wrote - skipped, never
    a crash)."""
    records, bad = [], 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if not (
                isinstance(rec, dict) and rec.get("type") == "accuracy"
                and isinstance(rec.get("plan"), dict)
                and isinstance(rec.get("max_abs_err"), (int, float))
                and isinstance(rec.get("n"), int)
            ):
                bad += 1
                continue
            try:
                rec["plan"] = normalize_plan(rec["plan"])
            except (ValueError, TypeError):
                bad += 1
                continue
            rec.setdefault("n_bucket", n_bucket(rec["n"]))
            rec.setdefault("wall_s", 0.0)
            rec.setdefault("cells", 0.0)
            rec.setdefault("source", "oracle")
            records.append(rec)
    if bad:
        print(f"note: skipped {bad} malformed accuracy ledger line(s)",
              file=sys.stderr)
    return records


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _compile_spend(compile_records: Sequence[dict]) -> Dict[tuple, dict]:
    """Compile seconds per (plan, n_bucket), from obs/ledger.py
    records.  `source: disk` lines are cache loads, not compiles -
    excluded, like ledger.aggregate."""
    out: Dict[tuple, dict] = {}
    for rec in compile_records:
        if rec.get("source") == "disk":
            continue
        key = rec.get("key") or {}
        try:
            plan = make_plan(key["scheme"], key["path"], key.get("k", 1),
                             key["dtype"], key.get("with_field", False))
            bucket = n_bucket(key["N"])
        except (KeyError, ValueError, TypeError):
            continue
        row = out.setdefault((canonical_plan(plan), bucket),
                             {"compiles": 0, "compile_s": 0.0})
        row["compiles"] += 1
        row["compile_s"] += float(rec.get("compile_s", 0.0))
    return out


def _roofline(plan: dict, n: int, gcells_per_s: float) -> Optional[dict]:
    """The analytic roofline verdict for a measured throughput - best
    effort: plan-report must run off-accelerator even if obs/perf (or
    its model for this config) is unavailable."""
    try:
        from wavetpu_torch.obs import perf

        return perf.solve_perf(
            gcells_per_s, plan["path"], scheme=plan["scheme"],
            k=plan["k"], n=n,
            itemsize=perf.DTYPE_ITEMSIZE.get(plan["dtype"], 4),
            with_field=plan["with_field"],
        )
    except Exception:
        return None


def build_plan_table(accuracy_records: Sequence[dict],
                     compile_records: Sequence[dict] = ()) -> dict:
    """The measured speed-accuracy frontier per (plan, N-bucket).

    Each row aggregates that plan's ledger lines in the bucket:
    measured Gcell/s (median of per-record cells/wall), measured wall
    s/request (median - the quota cost-model feedback ROADMAP's
    carry-over asks for), error percentiles p50/p95/max over every
    measured line (oracle and shadow alike - both are measured errors
    of the SERVED plan), the compile-ledger spend for matching keys,
    and the roofline model's verdict on the measured throughput.

    Pareto flags: within an N-bucket, a plan is `pareto_dominated`
    when some other plan is at least as fast (median Gcell/s) AND at
    least as accurate (p50 error), strictly better on one axis - the
    rows direction 4's planner can discard outright."""
    per: Dict[tuple, dict] = {}
    for rec in accuracy_records:
        key = (canonical_plan(rec["plan"]), int(rec["n_bucket"]))
        row = per.setdefault(key, {
            "plan": rec["plan"], "n_bucket": int(rec["n_bucket"]),
            "_errs": [], "_walls": [], "_gcells": [],
            "requests": 0, "oracle_requests": 0, "shadow_requests": 0,
            "_n_max": 0,
        })
        row["requests"] += 1
        if rec.get("source") == "shadow":
            row["shadow_requests"] += 1
        else:
            row["oracle_requests"] += 1
        row["_errs"].append(float(rec["max_abs_err"]))
        row["_n_max"] = max(row["_n_max"], int(rec["n"]))
        wall = float(rec.get("wall_s") or 0.0)
        cells = float(rec.get("cells") or 0.0)
        if wall > 0.0:
            row["_walls"].append(wall)
            if cells > 0.0:
                row["_gcells"].append(cells / wall / 1e9)
    spend = _compile_spend(compile_records)
    rows = []
    for (canon, bucket), row in sorted(per.items()):
        errs = sorted(row.pop("_errs"))
        walls = sorted(row.pop("_walls"))
        gcells = sorted(row.pop("_gcells"))
        n_max = row.pop("_n_max")
        row["err_p50"] = _percentile(errs, 0.50)
        row["err_p95"] = _percentile(errs, 0.95)
        row["err_max"] = errs[-1] if errs else 0.0
        row["wall_s_per_request"] = round(_percentile(walls, 0.50), 6)
        row["gcells_per_s"] = round(_percentile(gcells, 0.50), 6)
        comp = spend.get((canon, bucket))
        row["compiles"] = 0 if comp is None else comp["compiles"]
        row["compile_s"] = (
            0.0 if comp is None else round(comp["compile_s"], 6)
        )
        rf = _roofline(row["plan"], n_max, row["gcells_per_s"])
        row["roofline_fraction"] = (
            None if rf is None else rf["roofline_fraction"]
        )
        row["model_gbps"] = None if rf is None else rf["model_gbps"]
        rows.append(row)
    # Pareto-dominance within each bucket, on (median Gcell/s, p50 err).
    for row in rows:
        row["pareto_dominated"] = any(
            other is not row
            and other["n_bucket"] == row["n_bucket"]
            and other["gcells_per_s"] >= row["gcells_per_s"]
            and other["err_p50"] <= row["err_p50"]
            and (other["gcells_per_s"] > row["gcells_per_s"]
                 or other["err_p50"] < row["err_p50"])
            for other in rows
        )
    return {
        PLAN_TABLE_FLAG: True,
        "version": 1,
        "generated_unix": round(time.time(), 3),
        "entries": len(accuracy_records),
        "rows": rows,
    }


def format_plan_report(table: dict) -> str:
    rows = table["rows"]
    lines = [
        f"accuracy ledger: {table['entries']} measured solve(s), "
        f"{len(rows)} (plan, N-bucket) frontier row(s)",
        "",
        f"{'plan':<38} {'N<=':>5} {'req':>4} {'gcell/s':>9} "
        f"{'wall_s':>8} {'err_p50':>9} {'err_p95':>9} {'dominated':>9}",
    ]
    lines.append("-" * len(lines[-1]))
    for row in rows:
        lines.append(
            f"{plan_label(row['plan']):<38} {row['n_bucket']:>5} "
            f"{row['requests']:>4} {row['gcells_per_s']:>9.4f} "
            f"{row['wall_s_per_request']:>8.3f} "
            f"{row['err_p50']:>9.2e} {row['err_p95']:>9.2e} "
            f"{'yes' if row['pareto_dominated'] else 'no':>9}"
        )
    shadows = sum(r["shadow_requests"] for r in rows)
    if shadows:
        lines += [
            "",
            f"shadow-solve divergence lines: {shadows} (measured vs "
            f"the compensated-f32 reference twin, serve/shadow.py)",
        ]
    lines += [
        "",
        "wall_s is the MEASURED per-request cost per plan - the "
        "drop-in replacement for the analytic cells pricing in "
        "fleet/quota.py (ROADMAP quota cost-model carry-over); "
        "non-dominated rows are the measured speed-accuracy frontier "
        "direction 4's planner consumes.",
    ]
    return "\n".join(lines)


_USAGE = (
    "usage: wavetpu-torch plan-report TELEMETRY_DIR|ACCURACY_LEDGER.jsonl "
    "[--json] [--emit-plan-table OUT.json]"
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    as_json = False
    table_out = None
    it = iter(argv)
    try:
        for a in it:
            if a == "--json":
                as_json = True
            elif a == "--emit-plan-table":
                table_out = next(it)
            elif a.startswith("--emit-plan-table="):
                table_out = a.split("=", 1)[1]
            elif a.startswith("--"):
                raise ValueError(f"unknown flag {a}")
            elif path is None:
                path = a
            else:
                raise ValueError(f"unexpected positional {a!r}")
        if path is None:
            raise ValueError("missing telemetry dir / ledger path")
    except (ValueError, StopIteration) as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2
    try:
        records = load_accuracy_ledger(resolve_accuracy_path(path))
    except OSError as e:
        print(f"error: cannot read accuracy ledger: {e}",
              file=sys.stderr)
        return 2
    # The compile-ledger join is best effort: a telemetry dir scraped
    # before any compile was recorded still reports its frontier.
    compile_records: List[dict] = []
    if os.path.isdir(path):
        from wavetpu_torch.obs import ledger as compile_ledger

        cpath = os.path.join(path, compile_ledger.LEDGER_FILENAME)
        if os.path.exists(cpath):
            try:
                compile_records = compile_ledger.load_ledger(cpath)
            except OSError:
                pass
    table = build_plan_table(records, compile_records)
    if as_json:
        print(json.dumps(table, indent=1, sort_keys=True))
    else:
        print(format_plan_report(table))
    if table_out is not None:
        with open(table_out, "w", encoding="utf-8") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        print(f"plan table ({len(table['rows'])} row(s)): {table_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
