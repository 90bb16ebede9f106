"""`wavetpu-torch trace-report`: summarize JSONL span traces.

Reads the trace files `--telemetry-dir` produces (obs/tracing.py
records) and answers the operator question a raw JSONL tail cannot:
WHERE did time go, by span kind - count / total / p50 / p95 per kind,
sorted by total time, plus event counts.  Several sources (positional
trace files and/or repeated `--dir DIR`, each DIR meaning
`DIR/trace.jsonl` plus its rotated segments) are merged into one
summary.

Pure stdlib + host-side; never imports torch (a babysitting operator runs
this against a live run's telemetry dir without touching the backend).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence

from wavetpu_torch.obs.telemetry import TRACE_FILENAME

_USAGE = (
    "usage: wavetpu-torch trace-report [TRACE.jsonl ...] [--dir DIR ...] "
    "[--kind KIND]\n"
    "  each --dir DIR reads DIR/trace.jsonl (+ rotated segments); "
    "multiple sources are merged"
)


def trace_segments(path: str) -> List[str]:
    """The rotated segment set for a trace path, OLDEST FIRST: the size
    rotation (obs/tracing.py `rotate_file`) shifts trace.jsonl ->
    trace.jsonl.1 -> .2 ..., so higher suffixes are older and the live
    file is newest.  A never-rotated trace is just [path]."""
    old = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        old.append(f"{path}.{i}")
        i += 1
    return list(reversed(old)) + [path]


def load_trace(path: str, include_rotated: bool = True) -> List[dict]:
    """Parse a JSONL trace; malformed lines are counted, not fatal (the
    file may be mid-write when an operator runs the report).  Rotated
    segments (`path.1`, `path.2`, ...) are read too, oldest first, so a
    long-lived server's report covers the whole retained window."""
    records, bad = [], 0
    segments = trace_segments(path) if include_rotated else [path]
    for seg in segments:
        try:
            f = open(seg, encoding="utf-8")
        except OSError:
            if seg == path:
                raise  # the live file must exist; segments may race GC
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    bad += 1
                    continue
                if isinstance(rec, dict) and "kind" in rec:
                    records.append(rec)
    if bad:
        print(f"note: skipped {bad} malformed line(s)", file=sys.stderr)
    return records


def load_traces(paths: Sequence[str],
                include_rotated: bool = True) -> List[dict]:
    """Merge several trace files (each with its rotated segment set)
    into one record list, sorted by wall-clock start so interleaved
    multi-process output reads chronologically."""
    records: List[dict] = []
    for path in paths:
        records.extend(load_trace(path, include_rotated=include_rotated))
    records.sort(key=lambda r: r.get("t_start", 0.0))
    return records


def percentile_nearest_rank(sorted_vals: Sequence[float],
                            p: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence - the ONE
    percentile definition shared by trace-report and the serve layer's
    /metrics latency fields (scheduler.ServeMetrics), so the two views
    can never disagree on identical data."""
    idx = min(len(sorted_vals) - 1, int(round(p * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def summarize(records: Sequence[dict]) -> dict:
    """Per-kind span stats + event counts, machine-readable."""
    spans: Dict[str, List[float]] = {}
    events: Dict[str, int] = {}
    for r in records:
        if r.get("type") == "span":
            spans.setdefault(r["kind"], []).append(float(r.get("dur_s", 0.0)))
        else:
            events[r["kind"]] = events.get(r["kind"], 0) + 1
    kinds = {}
    for kind, durs in spans.items():
        durs.sort()
        kinds[kind] = {
            "count": len(durs),
            "total_s": round(sum(durs), 6),
            "p50_ms": round(percentile_nearest_rank(durs, 0.50) * 1e3, 3),
            "p95_ms": round(percentile_nearest_rank(durs, 0.95) * 1e3, 3),
            "max_ms": round(durs[-1] * 1e3, 3),
        }
    return {"spans": kinds, "events": events,
            "n_records": len(records)}


def format_summary(summary: dict) -> str:
    lines = []
    header = (
        f"{'span kind':<34} {'count':>6} {'total_s':>9} "
        f"{'p50_ms':>9} {'p95_ms':>9} {'max_ms':>9}"
    )
    lines.append(header)
    lines.append("-" * len(header))
    by_total = sorted(
        summary["spans"].items(), key=lambda kv: -kv[1]["total_s"]
    )
    for kind, st in by_total:
        lines.append(
            f"{kind:<34} {st['count']:>6} {st['total_s']:>9.3f} "
            f"{st['p50_ms']:>9.2f} {st['p95_ms']:>9.2f} "
            f"{st['max_ms']:>9.2f}"
        )
    if summary["events"]:
        lines.append("")
        lines.append(f"{'event kind':<34} {'count':>6}")
        for kind, n in sorted(summary["events"].items()):
            lines.append(f"{kind:<34} {n:>6}")
    lines.append("")
    lines.append(f"{summary['n_records']} records")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    paths: List[str] = []
    kind = None
    it = iter(argv)
    try:
        for a in it:
            if a == "--kind":
                kind = next(it)
            elif a == "--dir":
                paths.append(os.path.join(next(it), TRACE_FILENAME))
            elif a.startswith("--"):
                raise ValueError(f"unknown flag {a}")
            else:
                paths.append(a)
        if not paths:
            raise ValueError(
                "no trace source (pass TRACE.jsonl paths and/or "
                "--dir DIR)"
            )
    except (ValueError, StopIteration) as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2
    try:
        records = load_traces(paths)
    except OSError as e:
        print(f"error: cannot read trace: {e}", file=sys.stderr)
        return 2
    if kind is not None:
        records = [r for r in records if r["kind"] == kind]
    print(format_summary(summarize(records)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
