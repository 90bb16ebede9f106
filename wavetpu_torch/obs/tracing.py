"""Structured span tracing: JSONL application spans + profiler trace
bridging (the port of wavetpu/obs/tracing.py).

`--profile DIR` captures op-level device traces but says nothing
about the APPLICATION structure around them - which request a compile
belonged to, how long a chunk waited on a checkpoint write.  This module
emits that structure as newline-delimited JSON records an operator can
tail and `wavetpu-torch trace-report` can summarize:

    {"type": "span", "kind": "supervisor.chunk", "span_id": "1f03-4",
     "parent_id": "1f03-1", "thread": "MainThread",
     "t_start": 1722772800.123, "t_start_ns": 1722772800123456789,
     "dur_s": 0.512, "attrs": {...}}

(`t_start_ns` is `time.time_ns()`, the Unix-epoch clock the profiler
stamps its events with, so a record can be placed on a device trace of
the same run.)

 * `span(kind, **attrs)` - context manager: allocates a span id, links
   the enclosing span on the SAME THREAD as parent, measures wall time,
   and writes one record on exit.  The yielded dict is the record's
   `attrs`: mutate it to attach results discovered mid-span (occupancy,
   cache verdicts).
 * `begin_span()` / `end_span()` - the same span without the `with`
   block, for call sites where a context manager would force a 300-line
   reindent (cli.py's solve dispatch).
 * `TimedSpan(kind, **attrs)` - a span that also keeps its own clock
   readings (`t0`, `t1`, `seconds`), traced or not: the solvers' timed
   phases (solver/phases.py), whose `init_seconds` / `solve_seconds` are
   the same readings as the records' `dur_s`.
 * `annotate(kind)` - a profiler label alone: never a JSONL record.
 * `event(kind, **attrs)` - a zero-duration record.

The profiler side: while the torch profiler records (`torch.profiler.
profile`, the CLI's `--profile`, a benchmark's traced window) every span
and annotation also holds a matching `torch.profiler.record_function(
kind)`, whether or not a tracer is configured, so the application's
phases line up with the device work they launched in the same trace.
Whether it records is one flag read (`torch.autograd.profiler.
_is_profiler_enabled`, found through `sys.modules`: tracing never
imports torch, so it never drags the backend in).

The module-level tracer is a process-wide singleton configured by
`configure(path)` (the CLI's `--telemetry-dir` does this).  With neither
a tracer nor a recording profiler every call is that flag read and a
return - `span()` yields a throwaway dict without allocating ids,
touching any lock or creating a `record_function` - so instrumented code
paths cost nothing in untraced runs.  Spans are per solve, phase or
chunk, never per step: a site that runs once per layer or per k-block
(the error pass, `verify.errors`) uses `annotate`, which writes nothing
and labels the profiler only while it records.

Cross-thread linkage: parenthood is thread-local (a scheduler-worker
span is not a child of whatever the HTTP thread had open).  Cross-thread
stories - one serve request enqueued on thread A and executed on thread
B - are stitched by shared ATTRIBUTES instead (`request_id` /
`request_ids`), which `wavetpu-torch trace-report --request` joins on.

Cross-PROCESS linkage (the fleet story) rides W3C trace context:
`parse_traceparent` / `format_traceparent` speak the `traceparent`
header (`00-{32-hex trace id}-{16-hex parent id}-{flags}`), and
`begin()` accepts `remote=(trace_id, parent_id)` to adopt an inbound
context as the span's parent.  Internal span ids stay `{pid:x}-{n}`;
a FORWARDING span (router attempt, serve request) additionally mints a
16-hex W3C id, records it as its `w3c_id` attr, and sends it downstream
as the traceparent parent - the trace joiner (obs/report.py) resolves
`w3c_id -> span_id` at merge time, so one request's spans across the
client, the router, and N replicas share one `trace_id` and one tree.
Preemption resume chains that cross requests use record-level `links`
(`[{"trace_id": ..., "span_id": ...}]`) instead of parenthood.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import List, Optional, Tuple


# ------------------------------------------- W3C trace context (fleet)

_ZERO_TRACE = "0" * 32
_ZERO_SPAN = "0" * 16


def mint_trace_id() -> str:
    """A fresh 32-hex W3C trace id (crypto-random, never all-zero)."""
    while True:
        tid = os.urandom(16).hex()
        if tid != _ZERO_TRACE:
            return tid


def mint_span_id() -> str:
    """A fresh 16-hex W3C span id for the wire (the `traceparent`
    parent-id field).  Internal span ids stay `{pid:x}-{n}`; this is
    only what a FORWARDING span advertises downstream."""
    while True:
        sid = os.urandom(8).hex()
        if sid != _ZERO_SPAN:
            return sid


def format_traceparent(trace_id: str, parent_id: str,
                       flags: str = "01") -> str:
    """`00-{trace_id}-{parent_id}-{flags}` (W3C Trace Context v00)."""
    return f"00-{trace_id}-{parent_id}-{flags}"


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str]]:
    """`traceparent` header -> (trace_id, parent_id), or None for
    anything malformed (wrong field count/width, non-hex, all-zero ids,
    the reserved version ff).  Garbage from an arbitrary proxy must
    degrade to 'untraced', never to a crash or a poisoned trace id."""
    if not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, parent_id, flags = parts
    if (len(version), len(trace_id), len(parent_id), len(flags)) != \
            (2, 32, 16, 2):
        return None
    try:
        int(version, 16), int(trace_id, 16)
        int(parent_id, 16), int(flags, 16)
    except ValueError:
        return None
    if version == "ff" or trace_id == _ZERO_TRACE \
            or parent_id == _ZERO_SPAN:
        return None
    return trace_id, parent_id


def rotate_file(path: str, keep: int) -> None:
    """Size-rotation shift: path -> path.1 -> ... -> path.{keep-1}, the
    oldest segment dropped.  Every move is an atomic `os.replace`, so a
    concurrent reader (trace-report on a live dir) sees whole segments,
    never a half-renamed set.  `keep` counts TOTAL retained segments
    including the live file; keep=1 means rotation just truncates."""
    keep = max(1, int(keep))
    if keep == 1:
        try:
            os.replace(path, path + ".dropped")
            os.remove(path + ".dropped")
        except OSError:
            pass
        return
    for i in range(keep - 1, 0, -1):
        src = path if i == 1 else f"{path}.{i - 1}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i}")


# ------------------------------------------------ the profiler side


def _profiling() -> bool:
    """True while the torch profiler records in this process (torch
    already imported; one attribute read)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return torch.autograd.profiler._is_profiler_enabled
    except AttributeError:
        return False


def _open_annotation(kind: str):
    """An entered `record_function(kind)` while the profiler records, else
    None (nothing is created)."""
    if not _profiling():
        return None
    try:
        annotation = sys.modules["torch"].profiler.record_function(kind)
        annotation.__enter__()
        return annotation
    except Exception:
        return None


def _close_annotation(annotation) -> None:
    if annotation is not None:
        try:
            annotation.__exit__(None, None, None)
        except Exception:
            pass


class annotate:
    """`with annotate(kind):` labels the enclosed host work (and, by
    launch correlation, the device work it launches) in a recording
    profiler's trace; never writes a JSONL record.  For sites that run
    once per layer or per k-block; without a recording profiler it is
    the flag read and nothing else."""

    __slots__ = ("kind", "_annotation")

    def __init__(self, kind: str):
        self.kind = kind
        self._annotation = None

    def __enter__(self):
        self._annotation = _open_annotation(self.kind)
        return self

    def __exit__(self, *exc):
        _close_annotation(self._annotation)
        self._annotation = None
        return False


_tracer_instances = itertools.count()


class Tracer:
    """JSONL span writer bound to one output file (append mode).

    `max_bytes` caps the live segment: a write that would exceed it
    first rotates (`rotate_file`, keep-last-`keep` segments), so a
    long-lived server's trace.jsonl cannot append forever.  Rotation
    happens under the write lock; `wavetpu-torch trace-report` reads the
    whole rotated segment set (obs/report.py)."""

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 keep: int = 4):
        self.path = path
        self.max_bytes = max_bytes
        self.keep = max(1, int(keep))
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._wlock = threading.Lock()
        self._ids = itertools.count(1)
        # Span ids are `{prefix}-{n}`.  The prefix must be unique PER
        # TRACER, not just per process: a router and an in-process
        # replica (tests, bench) each own a Tracer, and two id
        # namespaces both rooted at the bare pid would collide on
        # `{pid:x}-1` - corrupting the joiner's by-id maps.  The first
        # tracer in a process keeps the plain pid (the production
        # one-tracer-per-process shape); later instances get a distinct
        # `{pid}t{k}` namespace.
        n = next(_tracer_instances)
        self._prefix = (
            f"{os.getpid():x}" if n == 0 else f"{os.getpid():x}t{n}"
        )
        self._local = threading.local()

    # -- ids / stack ---------------------------------------------------

    def new_id(self) -> str:
        return f"{self._prefix}-{next(self._ids)}"

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current_span_id(self) -> Optional[str]:
        st = self._stack()
        return st[-1][0] if st else None

    def current_trace_id(self) -> Optional[str]:
        """The W3C trace id of the innermost open span on THIS thread
        (None when untraced / no span open) - child spans inherit it."""
        st = self._stack()
        return st[-1][1] if st else None

    # -- emission ------------------------------------------------------

    def _write(self, record: dict) -> None:
        # Best-effort: telemetry must never crash the run it observes.
        # OSError = disk full / EIO; ValueError = file closed by a
        # concurrent disable() while another thread still held a span.
        line = json.dumps(record, default=str)
        try:
            with self._wlock:
                if (
                    self.max_bytes is not None
                    and self._f.tell() > 0
                    and self._f.tell() + len(line) + 1 > self.max_bytes
                ):
                    self._f.close()
                    rotate_file(self.path, self.keep)
                    self._f = open(self.path, "a", encoding="utf-8")
                self._f.write(line + "\n")
                self._f.flush()
        except (OSError, ValueError):
            pass

    def begin(self, kind: str, attrs: dict, /,
              remote: Optional[Tuple[str, Optional[str]]] = None,
              links: Optional[List[dict]] = None,
              trace_id: Optional[str] = None,
              t0: Optional[float] = None) -> dict:
        """Open a span; returns the handle `end()` wants.  Also opens a
        matching torch.profiler.record_function while the profiler
        records, so application spans land in `--profile` device traces.
        `t0` is the span's start on the `time.perf_counter` clock when the
        caller took it (TimedSpan), else now.

        `remote=(trace_id, parent_id)` adopts an INBOUND W3C context
        (another process's traceparent) as the parent instead of this
        thread's stack: parent_id may be a 16-hex wire id (the joiner
        resolves it against the sender's `w3c_id` attr) or None for a
        trace root.  `trace_id` alone stamps the record's trace id
        without touching parenthood (a scheduler-thread chunk span that
        belongs to a request's trace but is not its tree child).
        `links` attaches record-level cross-trace links (the preemption
        resume chain)."""
        annotation = _open_annotation(kind)
        if remote is not None:
            parent_id: Optional[str] = remote[1]
            trace_id = remote[0]
        else:
            parent_id = self.current_span_id()
            if trace_id is None:
                trace_id = self.current_trace_id()
        handle = {
            "kind": kind,
            "span_id": self.new_id(),
            "parent_id": parent_id,
            "trace_id": trace_id,
            "links": list(links) if links else None,
            "t_start_ns": time.time_ns(),
            "_t0": time.perf_counter() if t0 is None else t0,
            "_annotation": annotation,
            "attrs": attrs,
        }
        self._stack().append((handle["span_id"], trace_id))
        return handle

    def end(self, handle: dict, t1: Optional[float] = None, /,
            **extra_attrs) -> None:
        """Close a span and write its record; `t1` is its end on the
        `time.perf_counter` clock when the caller took it, else now."""
        t0 = handle.pop("_t0", None)
        if t0 is None:
            # Already ended: a crash-path end_span can race the normal
            # end on the same handle (supervisor's except handler).
            # Ending twice must not raise (it would mask the original
            # exception) or emit a duplicate record.
            return
        st = self._stack()
        if st and st[-1][0] == handle["span_id"]:
            st.pop()
        else:  # unbalanced begin/end: recover
            for i, (sid, _tid) in enumerate(st):
                if sid == handle["span_id"]:
                    del st[i]
                    break
        _close_annotation(handle.pop("_annotation", None))
        handle["attrs"] = dict(handle["attrs"], **extra_attrs)
        dur = (time.perf_counter() if t1 is None else t1) - t0
        record = {
            "type": "span",
            "kind": handle["kind"],
            "span_id": handle["span_id"],
            "parent_id": handle["parent_id"],
            "thread": threading.current_thread().name,
            "t_start": round(handle["t_start_ns"] * 1e-9, 6),
            "t_start_ns": handle["t_start_ns"],
            "dur_s": round(dur, 6),
            "attrs": handle["attrs"],
        }
        if handle.get("trace_id") is not None:
            record["trace_id"] = handle["trace_id"]
        if handle.get("links"):
            record["links"] = handle["links"]
        self._write(record)

    @contextlib.contextmanager
    def span(self, kind: str, /,
             remote: Optional[Tuple[str, Optional[str]]] = None,
             links: Optional[List[dict]] = None,
             trace_id: Optional[str] = None, **attrs):
        handle = self.begin(kind, attrs, remote=remote, links=links,
                            trace_id=trace_id)
        try:
            yield handle["attrs"]
        finally:
            self.end(handle)

    def event(self, kind: str, /, **attrs) -> None:
        now_ns = time.time_ns()
        record = {
            "type": "event",
            "kind": kind,
            "span_id": self.new_id(),
            "parent_id": self.current_span_id(),
            "thread": threading.current_thread().name,
            "t_start": round(now_ns * 1e-9, 6),
            "t_start_ns": now_ns,
            "attrs": attrs,
        }
        tid = self.current_trace_id()
        if tid is not None:
            record["trace_id"] = tid
        self._write(record)

    def close(self) -> None:
        with self._wlock:
            if not self._f.closed:
                self._f.close()


# ------------------------------------------------- module-level tracer

_tracer: Optional[Tracer] = None
_config_lock = threading.Lock()


def configure(path: str, max_bytes: Optional[int] = None,
              keep: int = 4) -> Tracer:
    """Start (or replace) the process tracer, writing JSONL to `path`.
    `max_bytes`/`keep` turn on size-based segment rotation (the
    telemetry layer passes its defaults; direct callers - tests - get
    an unrotated file unless they ask)."""
    global _tracer
    with _config_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = Tracer(path, max_bytes=max_bytes, keep=keep)
        return _tracer


def disable() -> None:
    global _tracer
    with _config_lock:
        if _tracer is not None:
            _tracer.close()
        _tracer = None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


@contextlib.contextmanager
def span(kind: str, /, remote: Optional[Tuple[str, Optional[str]]] = None,
         links: Optional[List[dict]] = None,
         trace_id: Optional[str] = None, **attrs):
    """Module-level span: a JSONL record when a tracer is configured, a
    profiler label while the profiler records, and otherwise a no-op
    (fresh throwaway attrs dict), so instrumented paths cost nothing
    untraced."""
    t = _tracer
    if t is not None:
        with t.span(kind, remote=remote, links=links, trace_id=trace_id,
                    **attrs) as a:
            yield a
        return
    annotation = _open_annotation(kind)
    try:
        yield attrs
    finally:
        _close_annotation(annotation)


def begin_span(kind: str, /,
               remote: Optional[Tuple[str, Optional[str]]] = None,
               links: Optional[List[dict]] = None,
               trace_id: Optional[str] = None, **attrs
               ) -> Optional[dict]:
    """`span` without the `with` block: the handle `end_span` wants, or
    None with neither a tracer nor a recording profiler (a profiler
    alone gets a label-only handle)."""
    t = _tracer
    if t is not None:
        return t.begin(kind, attrs, remote=remote, links=links,
                       trace_id=trace_id)
    annotation = _open_annotation(kind)
    return None if annotation is None else {"_annotation": annotation}


def end_span(handle: Optional[dict], **extra_attrs) -> None:
    if handle is None:
        return
    t = _tracer
    if t is not None and "span_id" in handle:
        t.end(handle, **extra_attrs)
    else:
        # A label-only handle, or a tracer disabled while the span was
        # open: the profiler's range still closes.
        _close_annotation(handle.pop("_annotation", None))


class TimedSpan:
    """`with TimedSpan(kind, **attrs) as s:` - a span (JSONL record and
    profiler label as `span`) that keeps its own clock readings, traced
    or not: `s.t0` / `s.t1` on the `time.perf_counter` clock and
    `s.seconds`.  A record's `dur_s` is the same pair of readings."""

    __slots__ = ("kind", "attrs", "t0", "t1", "_handle")

    def __init__(self, kind: str, /, **attrs):
        self.kind = kind
        self.attrs = attrs
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self._handle: Optional[dict] = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self):
        self.t0 = time.perf_counter()
        t = _tracer
        self._handle = (begin_span(self.kind) if t is None
                        else t.begin(self.kind, self.attrs, t0=self.t0))
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        handle, self._handle = self._handle, None
        t = _tracer
        if t is not None and handle is not None and "span_id" in handle:
            t.end(handle, self.t1)
        else:
            end_span(handle)
        return False


def event(kind: str, /, **attrs) -> None:
    t = _tracer
    if t is not None:
        t.event(kind, **attrs)


def new_id() -> Optional[str]:
    """A fresh id in the tracer's namespace (request correlation), or
    None untraced."""
    t = _tracer
    return None if t is None else t.new_id()
