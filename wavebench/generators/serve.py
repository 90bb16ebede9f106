"""Closed-loop clients of one serving replica: the generator of the serving
cells.

The configuration names the problem of every request (N, L, T,
timesteps), its scheme and k, and the replica as `build_server` takes it
(`replica`: its keyword arguments).  Set-up starts that replica in this
process, serving HTTP on a thread, and the clients in a child process
(wavebench/loadgen/closed_loop.py, standard library only).  The warm-up is
`warmup` requests released together from as many open connections, so
they form one batch (the program's build and first launches), then a
bounded wait until the replica's overload ladder stands at its lowest
rung again.  The window: `clients` closed-loop keep-alive clients send
/solve requests, each at its own phase from the seed and with the same
`probes` held nodes drawn from the seed, until `seconds` have passed; it
ends when the last answer arrives, or at the first failure (another
status, a missing digest, no answer within `deadline_s`).

`gcells_per_s` is (N+1)^3 x timesteps x answers over the window's wall on
the clients' clock.  One answer of the window, drawn from the seed, is
checked against the plain reference at its phase (reference/digest.py):

  probe_gap  the largest |program - reference| at the probes, over the
             last two layers
  rms_gap    |program - reference| of the last layer's root mean square
  abs_gap    as the solver cells compute it (judge.abs_gap)

A traced run reads the device from torch.profiler (trace.Window) and the
replica's own spans from the program's span records: the replica's
handler and worker threads label their phases with `obs/tracing` spans,
which a profiler started on this thread does not see, so for the window
the program's tracer keeps them in memory.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

from torch.profiler import record_function

from wavebench import judge, spec, stats
from wavebench.generators import solve as solve_gen
from wavebench.loadgen import phases as seeded
from wavebench.reference import digest as ref_digest
from wavebench.reference import wave
from wavebench.trace import Window


_REQUEST_DTYPES = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}


def body_of(cfg: dict, probes: list) -> dict:
    """Every /solve field of the cell's requests but the phase (kernel
    pallas: the CUDA kernels on the card, their plain versions on the
    CPU)."""
    return {"N": int(cfg["N"]), "Lx": cfg["Lx"], "Ly": cfg["Ly"],
            "Lz": cfg["Lz"], "T": cfg["T"],
            "timesteps": int(cfg["timesteps"]), "scheme": cfg["scheme"],
            "kernel": "pallas", "fuse_steps": int(cfg["fuse_steps"]),
            "dtype": _REQUEST_DTYPES[cfg["dtype"]], "probes": probes}


def probes_of(cfg: dict, mix: dict, seed: int) -> list:
    """The seed's `probes` held nodes, uniform over the N^3 grid."""
    rng, n = seeded.stream(seed, "probes"), int(cfg["N"])
    return [[rng.randrange(n) for _ in range(3)]
            for _ in range(int(mix["probes"]))]


class Replica:
    """The configuration's replica serving HTTP on a thread of this
    process.  `batches` records (lanes, init_seconds) of every batch its
    engine solved; `plant(engine)`, where given, alters the engine first
    (the controls and the tests' faults)."""

    def __init__(self, cfg: dict, device,
                 plant: Optional[Callable] = None):
        from wavetpu_torch.serve.api import build_server

        self.httpd, self.state = build_server(port=0, device=device,
                                              **cfg["replica"])
        engine = self.state.engine
        if plant is not None:
            plant(engine)
        self.batches: List[tuple] = []
        solve = engine.solve

        def observed(*a, **k):
            result, health = solve(*a, **k)
            self.batches.append((result.n_lanes, result.init_seconds))
            return result, health

        engine.solve = observed
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="wb-replica", daemon=True)
        self._thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def await_ladder(self, limit_s: float) -> bool:
        """Wait (at most `limit_s`) until the overload ladder is at rung
        0: a warm-up's queue waits stay in its samples for a while."""
        ladder = self.state.batcher.brownout
        t_end = time.monotonic() + limit_s
        while ladder is not None and ladder.update() != 0:
            if time.monotonic() >= t_end:
                return False
            time.sleep(0.1)
        return True

    def close(self) -> None:
        self.httpd.shutdown()
        self.state.batcher.close()
        self.httpd.server_close()
        self._thread.join(timeout=10.0)


class Clients:
    """The child process of closed-loop clients (loadgen/closed_loop.py)."""

    def __init__(self, job: dict):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "wavebench.loadgen.closed_loop"],
            cwd=str(spec.ROOT), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
        self._say(job)

    def _say(self, obj: dict) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def _hear(self, key: str) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the clients exited before their {key} "
                               f"(exit code {self.proc.wait()})")
        return json.loads(line)[key]

    def warm_up(self) -> dict:
        return self._hear("warmup")

    def window(self, seconds: float) -> dict:
        self._say({"seconds": seconds})
        return self._hear("window")

    def close(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


class ProgramSpans:
    """The program's span records while open (obs/tracing's tracer, its
    records kept in memory), summed by kind over those that start
    between `start()` and `stop()`: {kind: {"count", "host_s"}}."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.records: list = []
        self.summary: Optional[dict] = None
        self._t0 = self._t1 = 0

    def __enter__(self):
        if self.enabled:
            from wavetpu_torch.obs import tracing

            tracing.configure(os.devnull)._write = self.records.append
        return self

    def start(self) -> None:
        self._t0 = time.time_ns()

    def stop(self) -> None:
        self._t1 = time.time_ns()

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        from wavetpu_torch.obs import tracing

        tracing.disable()
        out: dict = {}
        for r in self.records:
            if r.get("type") == "span" and \
                    self._t0 <= r["t_start_ns"] <= self._t1:
                kind = out.setdefault(r["kind"], {"count": 0, "host_s": 0.0})
                kind["count"] += 1
                kind["host_s"] += r["dur_s"]
        self.summary = out
        return False


def _job(cfg, mix, seed, url, probes, purpose) -> dict:
    return {"url": url, "body": body_of(cfg, probes), "seed": int(seed),
            "clients": int(mix["clients"]), "warmup": int(mix["warmup"]),
            "warmup_purpose": purpose,
            "deadline_s": float(mix["request_deadline_s"])}


def _gap(p, r) -> float:
    """max |p - r| over equal-shaped nested lists; inf on another shape
    or a NaN."""
    import numpy as np

    p, r = np.asarray(p, dtype=np.float64), np.asarray(r, dtype=np.float64)
    if p.shape != r.shape or p.size == 0:
        return math.inf
    d = float(np.abs(p - r).max())
    return d if d == d else math.inf


def check(cfg: dict, kept: dict, probes: list, device) -> dict:
    """The check of one answer against the plain reference at its
    phase."""
    import torch

    with torch.no_grad():
        ref = ref_digest.digest(wave.Wave.from_config(cfg), kept["phase"],
                                cfg["scheme"], probes, device)
    rms = kept["final_rms"]
    return {"probe_gap": _gap(kept["final_probes"], ref["final_probes"]),
            "rms_gap": (abs(rms - ref["final_rms"])
                        if isinstance(rms, (int, float)) else math.inf),
            "abs_gap": judge.abs_gap(kept["abs_errors"] or [], ref["abs"])}


def run(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        device, t0: float, plant: Optional[Callable] = None) -> dict:
    import torch

    cuda = torch.device(device).type == "cuda"
    probes = probes_of(cfg, mix, seed)
    with record_function("wb.setup"):
        replica = Replica(cfg, device, plant)
        marks = [["replica serving", time.perf_counter() - t0]]
        clients = Clients(_job(cfg, mix, seed, replica.url, probes,
                               "warmup"))
        try:
            warm = clients.warm_up()
            marks.append(["warm-up answered", time.perf_counter() - t0])
            if not replica.await_ladder(float(mix["ladder_wait_s"])):
                print("wavebench: the overload ladder stayed above rung 0 "
                      f"for {mix['ladder_wait_s']} s after the warm-up",
                      file=sys.stderr)
        except BaseException:
            clients.close()
            replica.close()
            raise
    setup_s = time.perf_counter() - t0
    marks.append(["ladder at rung 0", setup_s])

    got, first = {"answers": 0, "failed": 0, "window_s": 0.0}, 0
    try:
        if warm["failed"]:
            got = dict(warm, window_s=0.0, kept=None)
            win = Window(False)
        else:
            with ProgramSpans(trace) as spans, \
                    Window(trace, cuda=cuda) as win:
                first = len(replica.batches)
                spans.start()
                got = clients.window(seconds)
                spans.stop()
                last = len(replica.batches)
    finally:
        clients.close()
        replica.close()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    batches = replica.batches[first:last] if not warm["failed"] else []
    replica = None
    solve_gen._release(device)

    numbers = {}
    if got.get("kept") is not None:
        numbers = check(cfg, got["kept"], probes, device)
        solve_gen._release(device)
    n, steps = int(cfg["N"]), int(cfg["timesteps"])
    answers, window_s = got["answers"], got["window_s"]
    rec = {"N": n, "timesteps": steps, "k": int(cfg["fuse_steps"]),
           "solves": len(batches), "lanes": [b[0] for b in batches],
           "init_seconds": [b[1] for b in batches], "answers": answers,
           "window_s": window_s}
    if win.busy_s is not None:
        rec.update(kernels=win.kernels, busy_s=win.busy_s,
                   trace_window_s=win.window_s)
    if trace and not warm["failed"]:
        rec["spans"] = spans.summary
    rate = (stats.rate_gcells((n + 1) ** 3, steps, answers, window_s)
            if answers and window_s > 0 else None)
    return {
        "e2e": {"gcells_per_s": rate, "setup_s": setup_s},
        "records": rec, "numbers": numbers,
        "attempted": answers + got["failed"], "failed": got["failed"],
        "error": got.get("error"), "memory_peak_bytes": peak,
        "window": win, "setup_marks": marks,
        "log": (f"{answers} answers in {window_s:.3f} s, "
                f"{len(batches)} batches"),
    }


def rotate_lanes(engine) -> None:
    """The fault the digest exists to catch: each lane of a batch answered
    with the next lane's digest and error vectors."""
    solve = engine.solve

    def rotated(*a, **k):
        result, health = solve(*a, **k)
        lanes = result.results
        if getattr(result, "digests", None) is not None:
            result.digests = result.digests[1:] + result.digests[:1]
        pairs = [(r.abs_errors, r.rel_errors) for r in lanes]
        pairs = pairs[1:] + pairs[:1]
        for r, (a_e, r_e) in zip(lanes, pairs):
            r.abs_errors, r.rel_errors = a_e, r_e
        return result, health

    engine.solve = rotated


def lower_precision(args: dict) -> Callable:
    """The program's own lower-precision compensated path under the
    engine: every lane a solo `solve_kfused_comp` with `args` (v in
    bfloat16, no carry), stacked into the batch the engine digests."""

    def plant(engine) -> None:
        import torch

        from wavetpu_torch.ensemble.batched import EnsembleResult
        from wavetpu_torch.solver import kfused_comp

        kw = solve_gen._torch_args(args)

        def execute(problem, lanes, scheme, path, k, dtype_name, mesh,
                    compute_errors, bucket, prog):
            res = [kfused_comp.solve_kfused_comp(
                problem, torch.float32, device=engine.device,
                phase=lane.phase, stop_step=lane.stop_step, **kw)
                for lane in lanes]
            return EnsembleResult(
                problem=problem, results=res, path=path, batched=True,
                fallback_reason=None, batch_size=len(res),
                n_lanes=len(res), init_seconds=0.0,
                solve_seconds=sum(r.solve_seconds for r in res),
                u_prev_batch=torch.stack([r.u_prev for r in res]),
                u_cur_batch=torch.stack([r.u_cur for r in res]))

        engine._execute = execute

    return plant


def _control_reading(cfg, mix, seed, device, plant) -> dict:
    """One batch of `warmup` requests at the seed's first phases, released
    together on a replica with `plant` under its engine; the answer the
    seed draws, checked as a run checks its window's."""
    probes = probes_of(cfg, mix, seed)
    replica = Replica(cfg, device, plant)
    clients = Clients(_job(cfg, mix, seed, replica.url, probes, "phase"))
    try:
        warm = clients.warm_up()
    finally:
        clients.close()
        replica.close()
    replica = None
    solve_gen._release(device)
    if warm["kept"] is None:
        raise RuntimeError(f"the control answered nothing: {warm['error']}")
    return check(cfg, warm["kept"], probes, device)


def control(cfg: dict, mix: dict, *, seed: int, device) -> dict:
    """Two controls, each number the smaller of their readings: (a) the
    replica with each lane's digest and error vectors rotated by one lane
    within its batch; (b) the program's lower-precision path (the mix's
    `control.args`) under the engine.  Each one's own readings follow
    under `rotated.` and `lower.`."""
    a = _control_reading(cfg, mix, seed, device, rotate_lanes)
    b = _control_reading(cfg, mix, seed, device,
                         lower_precision(mix["control"]["args"]))
    out = {k: min(a[k], b[k]) for k in a}
    out.update({f"rotated.{k}": v for k, v in a.items()})
    out.update({f"lower.{k}": v for k, v in b.items()})
    return out
