"""The program's own spans in a traced window, read from torch.profiler.

The program labels its phases for the profiler (wavetpu_torch/obs/tracing:
`solver.solve` and its children, `verify.errors` around the error pass,
`obs.record_solve`); they reach the profiler as CPU user annotations.
`summary(events)` reads them from the kineto events of a run whose window
is the harness's `wb.window` span:

    {kind: {"count": n, "host_s": s, "device_s": s, "idle_s": s}}

per annotation kind that starts inside the window: how many, their host
duration, the device time of the kernels their host work launched (a
kernel belongs to every annotation open when its launching runtime call
started, matched by correlation id: a kernel that runs after the
annotation has ended still counts), and the device-idle time that falls
inside them (the window's idle intervals, every one of them, intersected
with the annotations).  The readers below turn a record holding such a
summary under "spans" into per-layer metrics, and return None where the
record has none (an untraced run, or a program without the spans).

The benchmark's traced window (trace.py) keeps no events, so nothing in a
`--trace 1` run reads these yet.  `python -m wavebench.spans --workload
<cell> --seed <n> --seconds <s>` runs a cell's window under its own
profiler and prints the readings, the existing per-layer metrics and the
breakdown as one JSON line.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int]


def _merged(ivs: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_gaps(device: List[Interval], w0: int, w1: int) -> List[Interval]:
    """The intervals of [w0, w1] in which no device interval runs."""
    gaps, cursor = [], w0
    for s, e in _merged([(max(s, w0), min(e, w1)) for s, e in device
                         if e > w0 and s < w1]):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    return gaps


def _overlap(a: List[Interval], b: List[Interval]) -> int:
    """Total overlap of two lists of disjoint, sorted intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(t: int, ivs: List[Interval], starts: List[int]) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ivs[i][1]


def summary(events) -> Optional[Dict[str, dict]]:
    """The program annotations of the window (see the module's doc), or
    None without a `wb.window` span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    window = None
    annotations: Dict[str, List[Interval]] = {}
    launches: Dict[int, int] = {}
    device: List[Interval] = []
    kernels: List[Tuple[int, int]] = []
    for e in events:
        name, s, t = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            # Annotations are mirrored on the device's timeline: not work.
            if e.is_user_annotation() or name.startswith("wb."):
                continue
            device.append((s, t))
            if not name.startswith(("Memcpy", "Memset", "Memory")):
                kernels.append((e.correlation_id(), t - s))
        elif name == "wb.window":
            window = (s, t)
        elif e.is_user_annotation():
            if not name.startswith("wb."):
                annotations.setdefault(name, []).append((s, t))
        elif name.startswith("cu"):
            # A CUDA API call (cudaLaunchKernel, cuLaunchKernel, ...): its
            # correlation id is that of the device work it launched.
            launches[e.correlation_id()] = s
    if window is None:
        return None
    w0, w1 = window
    gaps = idle_gaps(device, w0, w1)
    out = {}
    for kind, ivs in annotations.items():
        ivs = [(s, t) for s, t in ivs if w0 <= s <= w1]
        if not ivs:
            continue
        merged = _merged(ivs)
        starts = [s for s, _ in merged]
        dev_ns = sum(d for corr, d in kernels
                     if corr in launches
                     and _inside(launches[corr], merged, starts))
        out[kind] = {"count": len(ivs),
                     "host_s": sum(t - s for s, t in ivs) * 1e-9,
                     "device_s": dev_ns * 1e-9,
                     "idle_s": _overlap(gaps, merged) * 1e-9}
    return out


def _kind(rec: dict, kind: str) -> Optional[dict]:
    return (rec.get("spans") or {}).get(kind)


def solver_idle_ms_per_solve(rec: dict) -> Optional[float]:
    """Device-idle time inside `solver.solve` annotations, per solve."""
    solve = _kind(rec, "solver.solve")
    return 1e3 * solve["idle_s"] / solve["count"] if solve else None


def verify_device_ms_per_layer(rec: dict) -> Optional[float]:
    """Device time of the kernels launched inside `verify.errors`
    annotations, per layer the window's solves marched."""
    solve, errors = _kind(rec, "solver.solve"), _kind(rec, "verify.errors")
    if not solve or not errors:
        return None
    return 1e3 * errors["device_s"] / (solve["count"] * rec["timesteps"])


def obs_record_ms_per_solve(rec: dict) -> Optional[float]:
    """Host duration of the `obs.record_solve` annotations, per solve."""
    record = _kind(rec, "obs.record_solve")
    return 1e3 * record["host_s"] / record["count"] if record else None


READERS = {
    "solver.idle_ms_per_solve": solver_idle_ms_per_solve,
    "verify.device_ms_per_layer": verify_device_ms_per_layer,
    "obs.record_ms_per_solve": obs_record_ms_per_solve,
}


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys

    from wavebench import run, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    t0 = run.process_start()
    os.environ["WAVETPU_TORCH_BUILD_DIR"] = str(run.BUILD_DIR)
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(run.BUILD_DIR / "pycache")

    import torch
    from torch.profiler import ProfilerActivity, profile

    from wavebench.trace import Window

    if not torch.cuda.is_available():
        print("wavebench.spans: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    cell = spec.workload(bench, a.workload)
    mix = spec.traffic(cell["traffic"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = spec.generator(mix["generator"]).run(
            spec.config(cell["config"]), mix, seed=a.seed,
            seconds=a.seconds, trace=False, device="cuda", t0=t0)
    # The profile also holds the set-up and the check after the window:
    # only what starts inside the window is the window's.
    events = prof.profiler.kineto_results.events()
    w0, w1 = next((e.start_ns(), e.end_ns()) for e in events
                  if e.name() == "wb.window")
    events = [e for e in events if w0 <= e.start_ns() <= w1]
    win = Window(True)
    win._read(events)
    rec = dict(out["records"], kernels=win.kernels, busy_s=win.busy_s,
               trace_window_s=win.window_s, spans=summary(events))
    _, layer = spec.cell_metrics(bench, cell["name"])
    metrics = {m["name"]: spec.metric_reader(m["name"]).read(rec)
               for m in layer}
    metrics.update({name: fn(rec) for name, fn in READERS.items()})
    print(json.dumps({
        "workload": a.workload, "seed": a.seed,
        "gcells_per_s": out["e2e"]["gcells_per_s"], "log": out["log"],
        "failed": out["failed"], "metrics": metrics, "spans": rec["spans"],
        "busy_s": win.busy_s, "window_s": win.window_s,
        "breakdown": win.breakdown()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
