"""Run-report writer, format-compatible with the reference's output files
(the port of wavetpu/io/report.py; the variant label is "CUDA").

The reference's rank 0 writes `output_N{N}_Np{procs}[_..]_{variant}.txt`
containing init time, solve wall time and per-layer L-inf abs/rel errors
(openmp_sol.cpp:229, mpi_new.cpp:454).  The layer-error lines are
verbatim-compatible ("max abs and rel errors on layer n: A R") so outputs
diff cleanly against reference and wavetpu runs.  A JSON sidecar carries
the same data plus throughput for machines, with wavetpu's keys:
`exchange_seconds`, `loop_seconds` and `phase_probe_steps` are null until
the port has `--phase-timing` (wavetpu's phase-timing report lines have no
counterpart yet).
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


def format_report(result: SolveResult, errors_computed: bool = True) -> str:
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
    return "\n".join(lines) + "\n"


def write_report(
    result: SolveResult,
    out_dir: str = ".",
    n_procs: int = 1,
    errors_computed: bool = True,
    run_config: Optional[dict] = None,
) -> str:
    """Write the text report + JSON sidecar; returns the text-file path.
    `run_config` records how the run was produced (device, scheme,
    fuse_steps, dtype, ...), so the sidecar is self-describing."""
    p = result.problem
    name = report_filename(p.N, n_procs)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        f.write(format_report(result, errors_computed))
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
        # Not measured: the port has no --phase-timing yet.
        "exchange_seconds": None,
        "loop_seconds": None,
        "phase_probe_steps": None,
        "run_config": run_config,
    }
    # Derive the sidecar from `name` (not `path`): out_dir may itself
    # contain ".txt".
    with open(os.path.join(out_dir, name[:-4] + ".json"), "w") as f:
        json.dump(side, f, indent=1)
    return path
