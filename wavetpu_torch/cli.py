"""Command-line entry point: the main-path subset of wavetpu/cli.py.

    python -m wavetpu_torch N Np Lx Ly Lz [T] [timesteps] [flags]

Positional contract (as every reference variant): `N Np Lx Ly Lz [T]
[timesteps]`, where Lx/Ly/Lz accept the literal string "pi" and
T/timesteps default to 1 and 20 (openmp_sol.cpp:192-204).  Np is parsed
for compatibility and does not influence the computation.

Flags:

  --scheme {standard,compensated}   standard leapfrog (K1) or the Kahan
                                    incremental scheme (K2); compensated
                                    with --fuse-steps K is the flagship
                                    velocity-form march (K4)
  --fuse-steps K                    K layers per kernel launch; K >= 2 needs
                                    --scheme compensated (K | N, K <= 8)
  --dtype {f32,f64}                 state dtype; f64 runs only on the CPU
  --v-dtype {f32,bf16}              increment-stream dtype of the flagship:
                                    bf16 = the carry-less increment-form
                                    bf16 mode
  --no-errors                       skip the per-layer analytic errors
  --out-dir DIR                     where the report files go
  --platform {gpu,cpu}              gpu (default) runs the CUDA kernels;
                                    cpu runs their plain PyTorch versions.
                                    Without a CUDA device the CLI exits 2
                                    unless --platform cpu is given.

wavetpu's other flags and subcommands are not ported yet: each exits 2
and names the ROADMAP.md item that brings it.  Exit codes: 0 complete,
2 usage error.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from wavetpu_torch.core.flags import split_flags
from wavetpu_torch.core.problem import Problem

# wavetpu flags (and subcommands) the port does not take yet, with the
# ROADMAP.md item that will bring each.
_NOT_PORTED = {
    "backend": "queue 1 item 10 (multi-rank sharding)",
    "mesh": "queue 1 item 10 (multi-rank sharding)",
    "overlap": "queue 1 item 10 (multi-rank sharding)",
    "distributed": "queue 1 item 10 (multi-rank sharding)",
    "phase-timing": "queue 1 item 10 (solver/timing.py)",
    "kernel": "queue 1 item 4 (kernel selection; the port picks the CUDA "
              "kernels on the GPU and their plain versions on the CPU)",
    "c2-field": "queue 2 K5 (variable c)",
    "stop-step": "queue 1 item 8 (checkpoint I/O)",
    "save-state": "queue 1 item 8 (checkpoint I/O)",
    "resume": "queue 1 item 8 (checkpoint I/O)",
    "ckpt-every": "queue 1 item 9 (supervision)",
    "ckpt-dir": "queue 1 item 9 (supervision)",
    "retries": "queue 1 item 9 (supervision)",
    "max-amp": "queue 1 item 9 (supervision)",
    "no-watchdog": "queue 1 item 9 (supervision)",
    "debug-nans": "queue 1 item 9 (supervision's health checks)",
    "profile": "queue 1 item 7 (perf + metrics)",
    "telemetry-dir": "queue 1 item 7 (perf + metrics)",
    "program-cache-dir": "queue 1 item 12 (serving)",
}
_NOT_PORTED_SUBCOMMANDS = {
    "serve": "queue 1 item 12 (serving)",
    "router": "queue 1 item 12 (serving)",
    "fleet": "queue 1 item 12 (serving)",
    "warmup": "queue 1 item 12 (serving)",
    "loadgen": "queue 1 item 12 (serving)",
    "trace-report": "queue 1 item 7 (perf + metrics)",
    "ledger-report": "queue 1 item 7 (perf + metrics)",
    "plan-report": "queue 1 item 7 (perf + metrics)",
    "profile": "queue 1 item 7 (perf + metrics)",
}
_PORTED = ("scheme", "fuse-steps", "dtype", "v-dtype", "no-errors",
           "out-dir", "platform")
_VALUELESS = ("no-errors", "overlap", "distributed", "debug-nans",
              "no-watchdog", "phase-timing")
_USAGE = (
    "usage: python -m wavetpu_torch N Np Lx Ly Lz [T] [timesteps] "
    "[--scheme standard|compensated] [--fuse-steps K] [--dtype f32|f64] "
    "[--v-dtype f32|bf16] [--no-errors] [--out-dir DIR] "
    "[--platform gpu|cpu] | --version"
)


class _NotPorted(ValueError):
    pass


def _parse(argv):
    """Validate argv; returns (problem, flags, scheme, fuse_steps, platform).
    Raises ValueError (usage) or _NotPorted."""
    pos, flags = split_flags(argv, _PORTED + tuple(_NOT_PORTED), _VALUELESS)
    for name, item in _NOT_PORTED.items():
        if name in flags:
            raise _NotPorted(f"--{name} is not ported yet: ROADMAP.md {item}")
    if flags.get("dtype") == "bf16":
        raise _NotPorted("--dtype bf16 is not ported yet: ROADMAP.md queue 1 "
                         "item 4")
    if flags.get("dtype", "f32") not in ("f32", "f64"):
        raise ValueError(f"--dtype must be f32|f64, got {flags['dtype']}")
    platform = flags.get("platform", "gpu")
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"--platform must be gpu|cpu, got {platform}")
    if flags.get("dtype") == "f64" and platform != "cpu":
        raise ValueError("--dtype f64 runs only on the CPU (--platform cpu)")
    scheme = flags.get("scheme", "standard")
    if scheme not in ("standard", "compensated"):
        raise ValueError(f"--scheme must be standard|compensated, got {scheme}")
    fuse_steps = int(flags.get("fuse-steps", "1"))
    if fuse_steps < 1:
        raise ValueError(f"--fuse-steps must be >= 1, got {fuse_steps}")
    if fuse_steps > 1 and scheme == "standard":
        raise _NotPorted(
            "--fuse-steps K > 1 with the standard scheme is not ported yet: "
            "ROADMAP.md queue 1 item 5 (the k-fused march, kernel K3)"
        )
    v_dtype = flags.get("v-dtype")
    if v_dtype is not None and v_dtype not in ("f32", "bf16"):
        raise ValueError(f"--v-dtype must be f32|bf16, got {v_dtype}")
    if v_dtype == "bf16" and (scheme != "compensated" or fuse_steps < 2):
        raise ValueError(
            "--v-dtype bf16 is the increment-form bf16 mode: it requires "
            "--scheme compensated --fuse-steps K"
        )
    problem = Problem.from_argv(pos)
    if fuse_steps > 1 and (problem.N % fuse_steps or fuse_steps > 8):
        raise ValueError(
            f"--fuse-steps {fuse_steps} must divide N={problem.N} and be "
            f"<= 8 (the K4 kernel's tile)"
        )
    return problem, flags, scheme, fuse_steps, platform


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED_SUBCOMMANDS:
        print(f"error: `{argv[0]}` is not ported yet: ROADMAP.md "
              f"{_NOT_PORTED_SUBCOMMANDS[argv[0]]}", file=sys.stderr)
        return 2
    if "--version" in argv:
        from wavetpu_torch import __version__

        print(f"wavetpu_torch {__version__}")
        return 0
    try:
        problem, flags, scheme, fuse_steps, platform = _parse(argv)
    except _NotPorted as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2

    import torch

    if platform == "gpu" and not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU unless "
              "--platform cpu is given", file=sys.stderr)
        return 2
    device = torch.device("cuda" if platform == "gpu" else "cpu")

    from wavetpu_torch.io import report
    from wavetpu_torch.solver import kfused_comp, leapfrog

    # Courant printout before solving (openmp_sol.cpp:214).
    print(f"C = {problem.courant:.6g}")
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    print(f"device: {device_name}")
    print(f"scheme: {scheme}")
    if fuse_steps > 1:
        print(f"fuse-steps: {fuse_steps}")
    dtype = torch.float64 if flags.get("dtype") == "f64" else torch.float32
    compute_errors = "no-errors" not in flags
    v_bf16 = flags.get("v-dtype") == "bf16"

    if scheme == "compensated" and fuse_steps > 1:
        result = kfused_comp.solve_kfused_comp(
            problem, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors,
            v_dtype=torch.bfloat16 if v_bf16 else None, carry=not v_bf16,
            device=device,
        )
    elif scheme == "compensated":
        result = leapfrog.solve_compensated(
            problem, dtype=dtype, compute_errors=compute_errors,
            device=device,
        )
    else:
        result = leapfrog.solve(
            problem, dtype=dtype, compute_errors=compute_errors,
            device=device,
        )

    path = report.write_report(
        result,
        out_dir=flags.get("out-dir", "."),
        errors_computed=compute_errors,
        run_config={
            "device": device_name,
            "platform": platform,
            "scheme": scheme,
            "fuse_steps": fuse_steps,
            "dtype": str(result.u_cur.dtype).replace("torch.", ""),
            "v_dtype": flags.get("v-dtype"),
        },
    )
    print(f"grids initialized in {int(result.init_seconds * 1000)}ms")
    print(f"numerical solution calculated in "
          f"{int(result.solve_seconds * 1000)}ms")
    if compute_errors:
        print(f"max abs error: {result.abs_errors.max():.6g}")
    print(f"throughput: {result.gcells_per_second:.3f} Gcell-updates/s")
    print(f"report: {path}")
    return 0
