"""`wavetpu-torch trace-report`: summarize and JOIN JSONL span traces
(the port's copy of wavetpu/obs/report.py).

Reads the trace files `--telemetry-dir` produces (obs/tracing.py
records) and answers the operator questions a raw JSONL tail cannot:

 * WHERE did time go, by span kind - count / total / p50 / p95 per kind,
   sorted by total time, plus event counts;
 * WHERE did ONE request's latency go - `--request ID` prints the
   request's span tree (queue wait vs batch execute vs compile), joining
   the HTTP-thread request span to the scheduler-thread batch span on
   the shared `request_id`/`request_ids` attributes.

It is also the FLEET trace joiner: pass several sources (positional
trace files and/or repeated `--dir DIR`, each DIR meaning
`DIR/trace.jsonl` plus its rotated segments) and the merged record set
is stitched across processes.  Forwarding spans (router.attempt,
serve.request) mint a 16-hex W3C wire id, record it as their `w3c_id`
attr, and send it downstream as the traceparent parent; the joiner
resolves each wire parent_id back to the minting span, so one request's
spans across the client, the router, and N replicas render as ONE tree
- including a long solve preempted on replica A and resumed on B, whose
successor chunk spans share the trace id (and carry `links` back to the
originating request when the resume arrived under a fresh trace).

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
    "[--kind KIND] [--request REQUEST_ID]\n"
    "  each --dir DIR reads DIR/trace.jsonl (+ rotated segments); "
    "multiple sources are merged and cross-process joined"
)

_HEX = frozenset("0123456789abcdef")


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


def _is_wire_id(value) -> bool:
    """A 16-hex W3C wire id (what a traceparent carries).  Internal span
    ids are `{pid:x}-{n}` and always contain a dash, so the two
    namespaces cannot collide."""
    return (
        isinstance(value, str)
        and len(value) == 16
        and all(c in _HEX for c in value)
    )


def join_processes(records: Sequence[dict]) -> List[dict]:
    """Stitch a merged multi-process record set into connected trees.

    A forwarding span mints a wire id, records it as its `w3c_id` attr,
    and sends it downstream as the traceparent parent - so the
    receiving span's `parent_id` is a 16-hex wire id, not an internal
    `{pid:x}-{n}` id.  Rewrite every wire parent_id to the minting
    span's internal id when that span is in the set; wire parents whose
    minting span is NOT here (the upstream hop's dir was not passed)
    become roots (parent_id None) so the tree renders cleanly instead
    of dangling.  Idempotent: rewritten parents are internal ids."""
    wire_to_span: Dict[str, str] = {}
    for r in records:
        w3c = (r.get("attrs") or {}).get("w3c_id")
        if _is_wire_id(w3c):
            wire_to_span[w3c] = r["span_id"]
    out = []
    for r in records:
        parent = r.get("parent_id")
        if _is_wire_id(parent):
            r = dict(r)
            r["parent_id"] = wire_to_span.get(parent)
        out.append(r)
    return out


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


def _touches_request(rec: dict, request_id: str) -> bool:
    attrs = rec.get("attrs") or {}
    if attrs.get("request_id") == request_id:
        return True
    ids = attrs.get("request_ids")
    return isinstance(ids, (list, tuple)) and request_id in ids


def request_view(records: Sequence[dict], request_id: str) -> List[dict]:
    """Every span/event that belongs to one request's story: records
    tagged with the request id (HTTP request span, the batch that
    carried it) plus their tree descendants (execute / compile /
    watchdog sub-spans) - AND, across processes, everything sharing the
    request's trace id(s), following `links` both ways so a preempted
    solve resumed under a fresh client trace still joins (successor
    chunk spans link back to the originating request; the closure runs
    to fixpoint in either direction).  Start-time order."""
    records = join_processes(records)
    roots = [r for r in records if _touches_request(r, request_id)]
    keep = {r["span_id"] for r in roots}
    # Trace-id closure: the request's trace ids, expanded through
    # cross-trace links until stable, then every record on any of them.
    tids = {r["trace_id"] for r in roots if r.get("trace_id")}
    if tids:
        changed = True
        while changed:
            changed = False
            for r in records:
                linked = {
                    ln.get("trace_id") for ln in (r.get("links") or ())
                    if ln.get("trace_id")
                }
                if not linked:
                    continue
                mine = r.get("trace_id")
                if mine in tids and not linked <= tids:
                    tids |= linked
                    changed = True
                elif mine and mine not in tids and linked & tids:
                    tids.add(mine)
                    changed = True
        for r in records:
            if r.get("trace_id") in tids:
                keep.add(r["span_id"])
    # Pull in descendants of any kept span (child spans carry no
    # request tag of their own): one parent->children index + BFS, so a
    # long-lived server's hundred-thousand-record trace stays O(n).
    children: Dict[str, List[str]] = {}
    for r in records:
        parent = r.get("parent_id")
        if parent is not None:
            children.setdefault(parent, []).append(r["span_id"])
    frontier = list(keep)
    while frontier:
        sid = frontier.pop()
        for child in children.get(sid, ()):
            if child not in keep:
                keep.add(child)
                frontier.append(child)
    out = [r for r in records if r["span_id"] in keep]
    out.sort(key=lambda r: r.get("t_start", 0.0))
    return out


def _pid_of(span_id) -> Optional[str]:
    """The `{pid:x}` prefix of an internal span id (None for wire ids
    or missing)."""
    if isinstance(span_id, str) and "-" in span_id:
        return span_id.split("-", 1)[0]
    return None


def format_request_view(records: Sequence[dict], request_id: str) -> str:
    if not records:
        return f"no records for request {request_id}"
    t0 = records[0].get("t_start", 0.0)
    by_id = {r["span_id"]: r for r in records}
    n_procs = len({_pid_of(r["span_id"]) for r in records} - {None})
    depth = {None: -1}
    lines = [
        f"critical path of request {request_id}"
        + (f" (joined across {n_procs} processes)" if n_procs > 1 else "")
        + ":"
    ]
    for r in records:
        parent = r.get("parent_id")
        d = depth.get(parent, 0) + 1
        depth[r["span_id"]] = d
        rel = (r.get("t_start", t0) - t0) * 1e3
        dur = r.get("dur_s")
        dur_txt = (
            f"{dur * 1e3:9.2f}ms" if dur is not None else "    event"
        )
        attrs = r.get("attrs") or {}
        attr_txt = " ".join(
            f"{k}={v}" for k, v in sorted(attrs.items())
            if k not in ("request_ids",) and not isinstance(v, (list, dict))
        )
        # A parent in ANOTHER process means this span starts a network
        # hop: the start-to-start gap is wire + downstream queue time
        # (wall clocks, so cross-host skew shows up here too).
        hop_txt = ""
        p = by_id.get(parent)
        if p is not None and _pid_of(parent) != _pid_of(r["span_id"]):
            gap = (r.get("t_start", t0) - p.get("t_start", t0)) * 1e3
            hop_txt = f"  <-hop {gap:+.2f}ms"
        link_txt = ""
        if r.get("links"):
            link_txt = "  ~>resumed-from " + ",".join(
                str(ln.get("span_id") or ln.get("trace_id") or "?")
                for ln in r["links"]
            )
        lines.append(
            f"  +{rel:9.2f}ms {dur_txt}  {'  ' * d}{r['kind']}"
            + (f"  [{attr_txt}]" if attr_txt else "")
            + hop_txt + link_txt
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    paths: List[str] = []
    kind = None
    request = None
    it = iter(argv)
    try:
        for a in it:
            if a == "--kind":
                kind = next(it)
            elif a == "--request":
                request = next(it)
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
    if request is not None:
        print(format_request_view(request_view(records, request), request))
        return 0
    print(format_summary(summarize(records)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
