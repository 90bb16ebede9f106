"""Readings behind a cell's limits: `python -m wavebench.calibrate`.

    python -m wavebench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds S] [--device cuda]

In one process (the kernels built once): for every seed, one run of the
cell's generator as the benchmark runs it (a `--seconds` window, then the
check of what it produced), and for every control seed the cell's control
(the mix's lower-precision stand-in in the program's place).  Prints one
JSON line per reading, {"kind": "program" | "control", "seed", "numbers"},
and last the largest program reading and the smallest control reading of
each number.  The limits in limits/<cell>.json are set between the two.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from wavebench import spec
from wavebench.run import BUILD_DIR


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    os.environ["WAVETPU_TORCH_BUILD_DIR"] = str(BUILD_DIR)
    cell = spec.workload(spec.benchmark(), a.workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    gen = spec.generator(mix["generator"])
    worst: dict = {}
    least: dict = {}
    for s in filter(None, a.seeds.split(",")):
        t = time.perf_counter()
        out = gen.run(cfg, mix, seed=int(s), seconds=a.seconds, trace=False,
                      device=a.device, t0=t)
        for k, v in out["numbers"].items():
            worst[k] = max(worst.get(k, v), v)
        print(json.dumps({"kind": "program", "seed": int(s),
                          "numbers": out["numbers"], "log": out["log"],
                          "failed": out["failed"],
                          "seconds": time.perf_counter() - t}), flush=True)
    for s in filter(None, a.control_seeds.split(",")):
        t = time.perf_counter()
        numbers = gen.control(cfg, mix, seed=int(s), device=a.device)
        for k, v in numbers.items():
            least[k] = min(least.get(k, v), v)
        print(json.dumps({"kind": "control", "seed": int(s),
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": a.workload, "program_max": worst,
                      "control_min": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
