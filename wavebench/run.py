"""Run one cell of the benchmark once: `python -m wavebench.run`.

    python -m wavebench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

from the root of a checkout.  The cell's entry in BENCHMARK.json names its
configuration and traffic mix; their files, the mix's generator, the
limits of its check and the readers of its per-layer metrics are found by
those names (spec.py).  The run sets up, warms up, measures for `--seconds`
seconds, checks what the window produced against the plain reference, and
prints one JSON line last on standard output.  With `--trace 0` its
metrics are the cell's end-to-end metrics; with `--trace 1` the window is
profiled and its metrics are the cell's per-layer metrics.

The program's compiled kernels are kept in wavebench/_build/ inside the
checkout (WAVETPU_TORCH_BUILD_DIR), and the bytecode of torch and the
program in wavebench/_build/pycache/, so only the first run in a checkout
runs nvcc or compiles Python.  Without a CUDA device, or with fewer than the cell asks for, the
run exits 2 and prints no result; it exits 3 if jax, jaxlib or wavetpu
were loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from wavebench import judge, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "wavetpu")
BUILD_DIR = spec.HERE / "_build"


def process_start() -> float:
    """This process's start on the perf_counter clock (from /proc; the
    module's own start where /proc cannot say)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 600.0:
            return now - age
    except (OSError, ValueError, IndexError):
        pass
    return _MODULE_START


_MODULE_START = time.perf_counter()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or wavetpu
    (whole names: wavetpu_torch is not wavetpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(bench: dict, cell: dict, *, seed: int, seconds: float,
            trace: bool, device, t0: float, cfg=None, mix=None,
            limits=None) -> dict:
    """Run the cell once on `device` and return its result line (as a dict)
    with the rows its check compared.  `cfg`, `mix` and `limits` default
    to the cell's own files."""
    cfg = spec.config(cell["config"]) if cfg is None else cfg
    mix = spec.traffic(cell["traffic"]) if mix is None else mix
    limits = spec.limits(cell["name"]) if limits is None else limits
    out = spec.generator(mix["generator"]).run(
        cfg, mix, seed=seed, seconds=seconds, trace=trace, device=device,
        t0=t0)
    e2e, layer = spec.cell_metrics(bench, cell["name"])
    metrics = {}
    if trace:
        for m in layer:
            value = spec.metric_reader(m["name"]).read(out["records"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = out["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, rows = judge.verdict(out["numbers"], limits)
    correct = ok and out["failed"] == 0 and out["attempted"] > 0
    device_info = _device(device, cell["chips"], out["memory_peak_bytes"])
    win = out["window"]
    if trace and win.busy_s is not None:
        device_info.update(busy_s=win.busy_s, window_s=win.window_s)
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if trace and win.busy_s is not None:
        line["breakdown"] = win.breakdown()
    line["log"] = out["log"]
    if out.get("error"):
        line["error"] = out["error"]
    line["setup_marks"] = out["setup_marks"]
    line["checked"] = {name: {"value": _finite(value), "limit": limit}
                       for name, value, limit in rows}
    return line


def _finite(x):
    """A number as JSON holds it: inf and nan as strings."""
    return x if x == x and abs(x) != float("inf") else str(x)


def _device(device, chips: int, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def main(argv=None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ["WAVETPU_TORCH_BUILD_DIR"] = str(BUILD_DIR)
    # Bytecode of torch and the program, compiled by the first run in the
    # checkout and read by every later one (whatever PYTHONDONTWRITEBYTECODE
    # says), as the kernel libraries are.
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(BUILD_DIR / "pycache")

    import torch

    imported = time.perf_counter() - t0
    bench = spec.benchmark()
    cell = spec.workload(bench, a.workload)
    if not torch.cuda.is_available():
        print("wavebench: no CUDA device (torch.cuda.is_available() is "
              "false): the benchmark runs on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"wavebench: {a.workload} needs {cell['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    line = measure(bench, cell, seed=a.seed, seconds=a.seconds,
                   trace=bool(a.trace), device="cuda", t0=t0)

    from wavetpu_torch.kernels import build

    marks = [["torch imported", imported]] + line.pop("setup_marks")
    print("set-up marks (s from process start): " + json.dumps(marks),
          file=sys.stderr)
    print("kernel libraries: " + json.dumps(build.stats, sort_keys=True),
          file=sys.stderr)
    leaked = forbidden_modules()
    if leaked:
        print(f"wavebench: loaded {', '.join(leaked)}: the benchmark "
              f"must not load jax, jaxlib, flax or wavetpu", file=sys.stderr)
        return 3
    for name, row in line["checked"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
