"""Closed-loop HTTP clients of a serving replica: the traffic of the
serving cells.  Standard library only, run as its own process:

    python -m wavebench.loadgen.closed_loop

It reads its job, one JSON line, on standard input:

    {"url": "http://127.0.0.1:PORT", "body": {...}, "seed": n,
     "clients": 16, "warmup": 8, "warmup_purpose": "warmup",
     "deadline_s": 60}

`body` is every /solve field but `phase`, which each request draws from
the seed (wavebench/loadgen/phases.py): the warm-up's from the stream
named `warmup_purpose`, the window's from the seed's main stream, in the
order the requests are sent.

1. Warm-up: `warmup` connections are opened, then one request is sent on
   each at once (released together by a barrier, so they reach the
   replica as one batch) and all are awaited.  It prints one line,
   {"warmup": {"answers", "failed", "error", "kept"}}.
2. It then waits for a line {"seconds": s} on standard input, and runs
   the window: `clients` threads, each with its own keep-alive
   connection, send /solve requests one after another, each the moment
   the previous one is answered, until `s` seconds have passed since the
   line arrived.  The window ends when the last answer arrives, or at the
   first failure: every thread then stops after its request in flight.
   It prints {"window": {"answers", "failed", "error", "window_s",
   "kept"}}, the window's length on this process's clock, and exits.

An answer counts only as a 200 whose report carries the digest the body
asked for: `final_probes`, one [u_last, u_before] pair per probe, and a
finite `final_rms`.  Anything else is a failure: another status, a
transport error, no answer within `deadline_s`, or a 200 without the
digest (a replica that ignores `probes`).  `kept` is one answer drawn
from the seed among those of the phase (a reservoir over the answers in
the order they arrive): its phase, `final_probes`, `final_rms` and
`abs_errors`, for the check against the plain reference.
"""

from __future__ import annotations

import http.client
import json
import math
import sys
import threading
import time
import urllib.parse
from typing import Iterator, List, Optional

from wavebench.loadgen import phases as seeded


class _Phase:
    """One phase of the traffic: sends requests, counts answers and
    failures, keeps the seeded sample."""

    def __init__(self, job: dict, phases: Iterator[float], purpose: str):
        parts = urllib.parse.urlsplit(job["url"])
        self.host, self.port = parts.hostname, parts.port
        self.body = job["body"]
        self.n_probes = len(self.body.get("probes") or ())
        self.deadline_s = float(job["deadline_s"])
        self.phases = phases
        self.pick = seeded.stream(job["seed"], purpose)
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.answers = self.failed = 0
        self.error: Optional[str] = None
        self.kept: Optional[dict] = None

    def connect(self) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.deadline_s)
        conn.connect()
        return conn

    def next_phase(self) -> float:
        with self.lock:
            return next(self.phases)

    def send(self, conn: http.client.HTTPConnection, phase: float) -> None:
        """One request on `conn`, its outcome counted."""
        data = json.dumps(dict(self.body, phase=phase)).encode()
        try:
            conn.request("POST", "/solve", body=data,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            report = (json.loads(raw).get("report") or {}
                      if resp.status == 200 else None)
        except (OSError, http.client.HTTPException, ValueError) as e:
            self._fail(f"request at phase {phase!r}: {type(e).__name__}: "
                       f"{e}")
            return
        if report is None:
            self._fail(f"HTTP {resp.status} at phase {phase!r}: "
                       f"{raw[:300]!r}")
            return
        why = self._missing(report)
        if why is not None:
            self._fail(f"answer at phase {phase!r} {why}")
            return
        with self.lock:
            self.answers += 1
            if self.pick.random() * self.answers < 1.0:
                self.kept = {"phase": phase,
                             "final_probes": report["final_probes"],
                             "final_rms": report["final_rms"],
                             "abs_errors": report.get("abs_errors")}

    def _missing(self, report: dict) -> Optional[str]:
        fp, rms = report.get("final_probes"), report.get("final_rms")
        if not (isinstance(fp, list) and len(fp) == self.n_probes
                and all(isinstance(p, list) and len(p) == 2 for p in fp)):
            return "carries no final_probes for its probes"
        if not (isinstance(rms, (int, float)) and math.isfinite(rms)):
            return "carries no finite final_rms"
        return None

    def _fail(self, error: str) -> None:
        with self.lock:
            self.failed += 1
            if self.error is None:
                self.error = error
        self.stop.set()

    def summary(self, **extra) -> dict:
        return dict(answers=self.answers, failed=self.failed,
                    error=self.error, kept=self.kept, **extra)


def warm_up(job: dict) -> dict:
    n = int(job["warmup"])
    ph = _Phase(job, seeded.phases(job["seed"], job["warmup_purpose"]),
                "warmup-sample")
    conns: List[http.client.HTTPConnection] = []
    try:
        for _ in range(n):
            conns.append(ph.connect())
    except OSError as e:
        ph._fail(f"warm-up connect: {type(e).__name__}: {e}")
        return ph.summary()
    phases = [next(ph.phases) for _ in range(n)]
    gate = threading.Barrier(n)

    def one(i: int) -> None:
        gate.wait()
        ph.send(conns[i], phases[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in conns:
        c.close()
    return ph.summary()


def window(job: dict, seconds: float) -> dict:
    ph = _Phase(job, seeded.phases(job["seed"]), "sample")
    start = time.perf_counter()

    def client() -> None:
        conn = None
        try:
            while not ph.stop.is_set() and \
                    time.perf_counter() - start < seconds:
                if conn is None:
                    conn = ph.connect()
                ph.send(conn, ph.next_phase())
                if ph.stop.is_set():
                    break
        except OSError as e:
            ph._fail(f"connect: {type(e).__name__}: {e}")
        finally:
            if conn is not None:
                conn.close()

    threads = [threading.Thread(target=client)
               for _ in range(int(job["clients"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return ph.summary(window_s=time.perf_counter() - start)


def _say(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def main() -> int:
    job = json.loads(sys.stdin.readline())
    _say({"warmup": warm_up(job)})
    line = sys.stdin.readline()
    if not line.strip():
        return 0
    _say({"window": window(job, float(json.loads(line)["seconds"]))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
