"""Run-report writer, format-compatible with the reference's output files
(the port of wavetpu/io/report.py; the variant label is "CUDA").

The reference's rank 0 writes `output_N{N}_Np{procs}[_..]_{variant}.txt`
containing init time, solve wall time and per-layer L-inf abs/rel errors
(openmp_sol.cpp:229, mpi_new.cpp:454).  The layer-error lines are
verbatim-compatible ("max abs and rel errors on layer n: A R") so outputs
diff cleanly against reference and wavetpu runs.  A JSON sidecar carries
the same data plus throughput for machines, with wavetpu's keys.  A
`--phase-timing` run adds wavetpu's "total ICI exchange time" / "total
loop time" lines and the probe label (the sidecar's `exchange_seconds`,
`loop_seconds` and `phase_probe_steps`; null without it).  The line
keeps wavetpu's wording, so reports diff cleanly; here the exchange is
the ghost copies between shards (solver/timing.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from wavetpu_torch.solver.leapfrog import SolveResult

VARIANT = "CUDA"


def _fmt(x: float) -> str:
    """C++ ostream default formatting: 6 significant digits, shortest form."""
    return f"{x:.6g}"


def report_filename(N: int, n_procs: int = 1) -> str:
    """Reference naming convention, variant CUDA:
    output_N{N}_Np{procs}_CUDA.txt."""
    return f"output_N{N}_Np{n_procs}_{VARIANT}.txt"


def format_report(
    result: SolveResult,
    exchange_seconds: Optional[float] = None,
    loop_seconds: Optional[float] = None,
    errors_computed: bool = True,
    probe_steps: Optional[int] = None,
) -> str:
    """Render the text report body (reference line layout).  A --no-errors
    run gets an explicit marker instead of all-zero errors that would read
    as a perfect run."""
    lines = [
        f"grids initialized in {int(result.init_seconds * 1000)}ms",
        f"numerical solution calculated in {int(result.solve_seconds * 1000)}ms",
    ]
    if errors_computed:
        for n, (a, r) in enumerate(zip(result.abs_errors, result.rel_errors)):
            lines.append(
                f"max abs and rel errors on layer {n}: {_fmt(a)} {_fmt(r)}"
            )
    else:
        lines.append("errors not computed (run without --no-errors to verify)")
    if exchange_seconds is not None:
        lines.append(
            f"total ICI exchange time: {int(exchange_seconds * 1000)}ms"
        )
    if loop_seconds is not None:
        lines.append(f"total loop time: {int(loop_seconds * 1000)}ms")
    if probe_steps is not None and (
        exchange_seconds is not None or loop_seconds is not None
    ):
        # Unlike the reference's per-step host timers (mpi_new.cpp:
        # 200-240), these come from probe marches of the production step
        # extrapolated to the full solve length.
        lines.append(
            f"(phase times probe-extrapolated from {probe_steps} steps)"
        )
    return "\n".join(lines) + "\n"


def write_report(
    result: SolveResult,
    out_dir: str = ".",
    n_procs: int = 1,
    errors_computed: bool = True,
    run_config: Optional[dict] = None,
    exchange_seconds: Optional[float] = None,
    loop_seconds: Optional[float] = None,
    probe_steps: Optional[int] = None,
) -> str:
    """Write the text report + JSON sidecar; returns the text-file path.
    `run_config` records how the run was produced (device, scheme,
    fuse_steps, dtype, ...), so the sidecar is self-describing."""
    p = result.problem
    name = report_filename(p.N, n_procs)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(format_report(result, exchange_seconds, loop_seconds,
                              errors_computed, probe_steps))
    side = {
        "problem": dataclasses.asdict(p),
        "courant": p.courant,
        "variant": VARIANT,
        "n_procs": n_procs,
        "init_seconds": result.init_seconds,
        "solve_seconds": result.solve_seconds,
        "gcells_per_second": result.gcells_per_second,
        "cells_per_step": p.cells_per_step,
        "errors_computed": errors_computed,
        "max_abs_error": (
            float(result.abs_errors.max()) if errors_computed else None
        ),
        "abs_errors": (
            [float(x) for x in result.abs_errors] if errors_computed else None
        ),
        "rel_errors": (
            [float(x) for x in result.rel_errors] if errors_computed else None
        ),
        "exchange_seconds": exchange_seconds,
        "loop_seconds": loop_seconds,
        "phase_probe_steps": probe_steps,
        "run_config": run_config,
    }
    # Derive the sidecar from `name` (not `path`): out_dir may itself
    # contain ".txt".
    with open(os.path.join(out_dir, name[:-4] + ".json"), "w") as f:
        json.dump(side, f, indent=1)
    return path
