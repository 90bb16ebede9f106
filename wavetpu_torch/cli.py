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
  --fuse-steps K                    K layers per kernel launch (2 <= K <= 8,
                                    K | N): the standard k-fused march (K3,
                                    bitwise equal to the 1-step march) or,
                                    with --scheme compensated, the flagship
  --dtype {f32,f64,bf16}            state dtype; f64 runs only on the CPU;
                                    bf16 (f32 compute) only on the standard
                                    scheme
  --v-dtype {f32,bf16}              increment-stream dtype of the flagship:
                                    bf16 = the carry-less increment-form
                                    bf16 mode
  --c2-field PRESET|FILE.npy        variable wave speed c^2(x,y,z): a preset
                                    (constant, gaussian-lens, two-layer) or
                                    an .npy of c^2 on the (N,N,N) grid.  The
                                    1-step march runs K5, --fuse-steps K
                                    K3's field operand, the compensated
                                    scheme (which needs --fuse-steps K) K4's.
                                    Errors are off (no analytic oracle).
  --no-errors                       skip the per-layer analytic errors
  --out-dir DIR                     where the report files go
  --platform {gpu,cpu}              gpu (default) runs the CUDA kernels;
                                    cpu runs their plain PyTorch versions.
                                    Without a CUDA device the CLI exits 2
                                    unless --platform cpu is given.
  --backend {auto,single,sharded}   auto = sharded iff the platform has more
                                    than one device (the visible cards on
                                    gpu; the CPU counts as one)
  --mesh MX,MY,MZ                   explicit 3D mesh (sharded backend): the
                                    1-step march runs K6 (K7 compensated) on
                                    every shard; with --fuse-steps K the
                                    mesh is (MX,MY,1): an (MX,1,1) mesh runs
                                    K8, or K9 where MX or K does not divide
                                    evenly, MY > 1 runs K10 on y-extended
                                    blocks; with --scheme compensated
                                    --fuse-steps K it is the distributed
                                    flagship, K11 (MY = 1) or K12 (MY > 1).
                                    On gpu the shards are the visible cards
                                    (a larger mesh exits 2); on cpu every
                                    shard lives on the CPU.  Standard
                                    --fuse-steps K with K not dividing N
                                    also runs K9, on a (1,1,1) mesh.

  --kernel {auto,roll,pallas}       pallas runs the CUDA kernels, roll their
                                    plain PyTorch versions on the same
                                    device; auto = pallas on gpu, roll on
                                    cpu.  --fuse-steps needs pallas (auto);
                                    pallas needs the card
  --overlap                         the 1-step sharded march with the ghost
                                    copies on a side CUDA stream of each
                                    card beside the bulk update (even
                                    splits, standard scheme; bit for bit
                                    the serial march)
  --phase-timing                    measure the loop vs exchange split with
                                    probe marches of the production step
                                    (solver/timing.py) and add wavetpu's
                                    "total ICI exchange time" / "total loop
                                    time" lines to the report; covers the
                                    1-step standard step and both k-fused
                                    marches on even decompositions
  --profile DIR                     run the solve under torch.profiler and
                                    write a Chrome trace (DIR/trace.json)
                                    and its top operations
                                    (DIR/device_ops.json)
  --telemetry-dir DIR               spans into DIR/trace.jsonl, registry
                                    snapshots into DIR/heartbeat.jsonl and
                                    DIR/metrics.prom, and the compile and
                                    accuracy ledgers (obs/)

Subcommands: `trace-report [TRACE.jsonl ...] [--dir DIR ...]` (obs/
report.py), `ledger-report TELEMETRY_DIR [--json]` (obs/ledger.py),
`plan-report TELEMETRY_DIR [--json]` (obs/accuracy.py) and `profile --out
DIR ARGS...` (obs/perf.py: one full command line under torch.profiler).

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
    "distributed": "queue 1 item 10, step 5 (--distributed: one process "
                   "per card)",
    "stop-step": "queue 1 item 8 (checkpoint I/O)",
    "save-state": "queue 1 item 8 (checkpoint I/O)",
    "resume": "queue 1 item 8 (checkpoint I/O)",
    "ckpt-every": "queue 1 item 9 (supervision)",
    "ckpt-dir": "queue 1 item 9 (supervision)",
    "retries": "queue 1 item 9 (supervision)",
    "max-amp": "queue 1 item 9 (supervision)",
    "no-watchdog": "queue 1 item 9 (supervision)",
    "debug-nans": "queue 1 item 9 (supervision's health checks)",
    "program-cache-dir": "queue 1 item 12 (serving)",
}
_NOT_PORTED_SUBCOMMANDS = {
    "serve": "queue 1 item 12 (serving)",
    "router": "queue 1 item 12 (serving)",
    "fleet": "queue 1 item 12 (serving)",
    "warmup": "queue 1 item 12 (serving)",
    "loadgen": "queue 1 item 12 (serving)",
}
_PORTED = ("scheme", "fuse-steps", "dtype", "v-dtype", "no-errors",
           "out-dir", "platform", "c2-field", "backend", "mesh", "kernel",
           "overlap", "phase-timing", "profile", "telemetry-dir")
_VALUELESS = ("no-errors", "overlap", "distributed", "debug-nans",
              "no-watchdog", "phase-timing")
_USAGE = (
    "usage: python -m wavetpu_torch N Np Lx Ly Lz [T] [timesteps] "
    "[--scheme standard|compensated] [--fuse-steps K] "
    "[--dtype f32|f64|bf16] [--v-dtype f32|bf16] "
    "[--c2-field PRESET|FILE.npy] [--no-errors] [--out-dir DIR] "
    "[--platform gpu|cpu] [--backend auto|single|sharded] "
    "[--mesh MX,MY,MZ] [--kernel auto|roll|pallas] [--overlap] "
    "[--phase-timing] [--profile DIR] [--telemetry-dir DIR] | "
    "trace-report [...] | ledger-report DIR [...] | plan-report DIR [...] "
    "| profile --out DIR ARGS... | --version"
)
# The subcommands: (module, its entry point).
_SUBCOMMANDS = {
    "trace-report": ("wavetpu_torch.obs.report", "main"),
    "ledger-report": ("wavetpu_torch.obs.ledger", "main"),
    "plan-report": ("wavetpu_torch.obs.accuracy", "main"),
    "profile": ("wavetpu_torch.obs.perf", "profile_main"),
}


class _NotPorted(ValueError):
    pass


def _parse_mesh(flags):
    """The --mesh flag as (MX, MY, MZ), or None."""
    if "mesh" not in flags:
        return None
    try:
        mesh = tuple(int(x) for x in flags["mesh"].split(","))
    except ValueError:
        mesh = ()
    if len(mesh) != 3 or min(mesh) < 1:
        raise ValueError(f"--mesh wants MX,MY,MZ (each >= 1), got "
                         f"{flags['mesh']}")
    return mesh


def _parse(argv):
    """Validate argv; returns (problem, flags, scheme, fuse_steps, platform,
    mesh).  Raises ValueError (usage) or _NotPorted."""
    pos, flags = split_flags(argv, _PORTED + tuple(_NOT_PORTED), _VALUELESS)
    for name, item in _NOT_PORTED.items():
        if name in flags:
            raise _NotPorted(f"--{name} is not ported yet: ROADMAP.md {item}")
    if flags.get("dtype", "f32") not in ("f32", "f64", "bf16"):
        raise ValueError(f"--dtype must be f32|f64|bf16, got {flags['dtype']}")
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
    if scheme == "compensated" and flags.get("dtype") == "bf16":
        raise ValueError(
            "--dtype bf16 is not available for the compensated scheme "
            "(it requires an f32/f64 carrier; for a bf16 increment stream "
            "use --v-dtype bf16)"
        )
    if "c2-field" in flags and scheme == "compensated" and fuse_steps < 2:
        raise ValueError(
            "--c2-field with the compensated scheme rides the velocity-form "
            "onion: add --fuse-steps K (the 1-step compensated kernel "
            "carries a scalar coefficient)"
        )
    kernel = flags.get("kernel", "auto")
    if kernel not in ("auto", "roll", "pallas"):
        raise ValueError(f"--kernel must be auto|roll|pallas, got {kernel}")
    if kernel == "pallas" and platform == "cpu":
        raise ValueError(
            "--kernel pallas runs the CUDA kernels, which need the card; "
            "--platform cpu runs their plain versions (--kernel roll)")
    if fuse_steps > 1:
        if kernel == "roll":
            raise ValueError("--fuse-steps needs the pallas kernel")
        if "overlap" in flags:
            raise ValueError(
                "--overlap applies to the 1-step sharded backend, not "
                "--fuse-steps (whose exchange is amortized over k layers)")
    if "c2-field" in flags and "phase-timing" in flags:
        raise ValueError(
            "--phase-timing's probe times the constant-c step; drop it for "
            "--c2-field runs")
    if flags.get("backend") == "single" and "overlap" in flags:
        raise ValueError("--overlap applies to the sharded backend")
    if scheme == "compensated":
        bad = None
        if "overlap" in flags:
            bad = "--overlap"
        elif "phase-timing" in flags and fuse_steps < 2:
            bad = ("--phase-timing (the compensated probe covers "
                   "--fuse-steps K programs; the 1-step scheme has none)")
        if bad:
            raise ValueError(
                f"{bad} is not available for the compensated scheme")
    v_dtype = flags.get("v-dtype")
    if v_dtype is not None and v_dtype not in ("f32", "bf16"):
        raise ValueError(f"--v-dtype must be f32|bf16, got {v_dtype}")
    if v_dtype == "bf16" and (scheme != "compensated" or fuse_steps < 2):
        raise ValueError(
            "--v-dtype bf16 is the increment-form bf16 mode: it requires "
            "--scheme compensated --fuse-steps K"
        )
    backend = flags.get("backend", "auto")
    if backend not in ("auto", "single", "sharded"):
        raise ValueError(f"--backend must be auto|single|sharded, got "
                         f"{backend}")
    mesh = _parse_mesh(flags)
    if backend == "single" and mesh is not None:
        raise ValueError("--mesh contradicts --backend single")
    sharded = mesh is not None or backend == "sharded"
    if fuse_steps > 1 and mesh is not None and mesh[2] != 1:
        raise ValueError(
            f"--fuse-steps supports (MX,MY,1) meshes (MX, MY >= 1, MZ = 1); "
            f"got {flags['mesh']}"
        )
    problem = Problem.from_argv(pos)
    if fuse_steps > 8:
        raise ValueError(
            f"--fuse-steps {fuse_steps} must be <= 8 (the k-step kernels' "
            f"tiles)"
        )
    if fuse_steps > 1 and scheme == "compensated" and problem.N % fuse_steps:
        raise ValueError(
            f"--fuse-steps {fuse_steps} must divide N={problem.N} for the "
            f"compensated k-fused march"
        )
    return problem, flags, scheme, fuse_steps, platform, mesh


def _c2_field(spec: str, problem: Problem):
    """The host tau^2 c^2 field of `--c2-field`: a preset, or an .npy of c^2
    on the (N,N,N) grid times tau^2 (wavetpu/cli.py:660-698).  Raises
    ValueError with the message to print."""
    import numpy as np

    from wavetpu_torch.kernels import stencil_ref

    if spec in stencil_ref.C2_PRESET_NAMES:
        return stencil_ref.make_preset_c2tau2_field(problem, spec)
    try:
        arr = np.load(spec)
    except Exception as e:
        raise ValueError(
            f"--c2-field {spec!r} is neither a preset "
            f"({', '.join(sorted(stencil_ref.C2_PRESET_NAMES))}) nor a "
            f"loadable .npy file: {e}"
        ) from e
    if arr.shape != (problem.N,) * 3:
        raise ValueError(
            f"--c2-field array shape {arr.shape} != {(problem.N,) * 3} "
            f"(c^2 values on the fundamental grid)"
        )
    return np.asarray(arr, np.float64) * problem.tau**2


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED_SUBCOMMANDS:
        print(f"error: `{argv[0]}` is not ported yet: ROADMAP.md "
              f"{_NOT_PORTED_SUBCOMMANDS[argv[0]]}", file=sys.stderr)
        return 2
    if argv and argv[0] in _SUBCOMMANDS:
        import importlib

        module, entry = _SUBCOMMANDS[argv[0]]
        return getattr(importlib.import_module(module), entry)(argv[1:])
    if "--version" in argv:
        from wavetpu_torch import __version__

        print(f"wavetpu_torch {__version__}")
        return 0
    try:
        problem, flags, scheme, fuse_steps, platform, mesh = _parse(argv)
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
    try:
        backend, shape, devices = _placement(problem, flags, fuse_steps,
                                             platform, mesh)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from wavetpu_torch.io import report
    from wavetpu_torch.obs import ledger, tracing
    from wavetpu_torch.progkey import resolve_kernel

    kernel = resolve_kernel(flags.get("kernel", "auto"), platform)
    overlap = "overlap" in flags
    # Courant printout before solving (openmp_sol.cpp:214).
    print(f"C = {problem.courant:.6g}")
    compute_errors = "no-errors" not in flags
    c2_field = None
    if "c2-field" in flags:
        try:
            c2_field = _c2_field(flags["c2-field"], problem)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if compute_errors:
            # The analytic oracle only holds for constant speed.
            print("errors: disabled (--c2-field has no analytic oracle)")
            compute_errors = False
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    print(f"device: {device_name}")
    print(f"kernel: {kernel}")
    print(f"scheme: {scheme}")
    if fuse_steps > 1:
        print(f"fuse-steps: {fuse_steps}")
    if backend == "sharded":
        print(f"mesh: {shape[0]},{shape[1]},{shape[2]}")
    dtype = {"f64": torch.float64, "bf16": torch.bfloat16}.get(
        flags.get("dtype"), torch.float32)
    v_bf16 = flags.get("v-dtype") == "bf16"

    telemetry = None
    if "telemetry-dir" in flags:
        # Spans to DIR/trace.jsonl, heartbeat registry snapshots and the
        # ledgers (obs/telemetry.py); spans open record_function ranges,
        # so with --profile the application structure lands in the trace.
        from wavetpu_torch.obs import telemetry as obs_telemetry

        telemetry = obs_telemetry.start(flags["telemetry-dir"])
        print(f"telemetry: {flags['telemetry-dir']}")
    prof = None
    if "profile" in flags:
        from wavetpu_torch.obs import perf as obs_perf

        prof = torch.profiler.profile(
            activities=obs_perf.profiler_activities())
        prof.__enter__()
    solve_span = tracing.begin_span(
        "cli.solve", backend=backend, scheme=scheme, kernel=kernel,
        fuse_steps=fuse_steps, n=problem.N, timesteps=problem.timesteps,
        supervised=False, resumed=False,
    )
    compiled = _compile_counts()
    try:
        result = _solve(problem, scheme, fuse_steps, backend, shape,
                        devices, device, dtype, compute_errors, c2_field,
                        v_bf16, kernel, overlap)
        span_extra = {}
        if solve_span is not None:
            span_extra = _roofline_attrs(_perf_path(backend, scheme,
                                                    fuse_steps))
        tracing.end_span(
            solve_span, final_step=result.final_step,
            gcells_per_s=round(result.gcells_per_second, 3), **span_extra,
        )
        if ledger.enabled():
            _record_compile(ledger, problem, scheme, fuse_steps, kernel,
                            result, c2_field is not None, compute_errors,
                            shape if backend == "sharded" else None,
                            compiled, _compile_counts())
        if prof is not None:
            prof.__exit__(None, None, None)
            ops = obs_perf.export_profile(prof, flags["profile"])
            prof = None
            print(f"profile trace: {flags['profile']}")
            print(obs_perf.format_ops(ops))

        exchange_seconds = loop_seconds = probe_steps = None
        if "phase-timing" in flags:
            from wavetpu_torch.solver import timing

            # The probe times the mesh the solve ran on.
            pb = timing.measure_phase_breakdown(
                problem,
                mesh_shape=shape if backend == "sharded" else (1, 1, 1),
                devices=devices if backend == "sharded" else [device],
                dtype=dtype, kernel=kernel, overlap=overlap,
                fuse_steps=fuse_steps, scheme=scheme,
                v_dtype=torch.bfloat16 if v_bf16 else None,
            )
            exchange_seconds = pb.exchange_seconds
            loop_seconds = pb.loop_seconds
            probe_steps = pb.steps_measured

        sharded_run = backend == "sharded"
        path = report.write_report(
            result,
            out_dir=flags.get("out-dir", "."),
            n_procs=shape[0] * shape[1] * shape[2] if sharded_run else 1,
            errors_computed=compute_errors,
            exchange_seconds=exchange_seconds,
            loop_seconds=loop_seconds,
            probe_steps=probe_steps,
            run_config={
                "device": device_name,
                "platform": platform,
                "backend": backend,
                "mesh": list(shape) if sharded_run else None,
                "scheme": scheme,
                "fuse_steps": fuse_steps,
                "dtype": str(result.u_cur.dtype).replace("torch.", ""),
                "v_dtype": flags.get("v-dtype"),
                "c2_field": flags.get("c2-field"),
                # "pallas" where the CUDA kernels ran (wavetpu's kernel
                # path), "roll" where their plain versions ran.
                "kernel": kernel,
                # wavetpu's keys, with the values of a run without those
                # features.
                "distributed": False,
                "resumed": False,
                "supervised": False,
                "ckpt_every": None,
                "supervisor_status": None,
            },
        )
        print(f"grids initialized in {int(result.init_seconds * 1000)}ms")
        print(f"numerical solution calculated in "
              f"{int(result.solve_seconds * 1000)}ms")
        if exchange_seconds is not None:
            print(f"total ICI exchange time: "
                  f"{int(exchange_seconds * 1000)}ms")
            print(f"total loop time: {int(loop_seconds * 1000)}ms")
        if compute_errors:
            print(f"max abs error: {result.abs_errors.max():.6g}")
        print(f"throughput: {result.gcells_per_second:.3f} Gcell-updates/s")
        print(f"report: {path}")
    except BaseException:
        # A crash mid-run still closes the open cli.solve span, the
        # profiler and the final heartbeat, and leaves no tracer bound to
        # this run's files for the next in-process call (span end and
        # telemetry.stop() are idempotent).
        tracing.end_span(solve_span, aborted=True)
        if prof is not None:
            prof.__exit__(None, None, None)
        raise
    finally:
        if telemetry is not None:
            telemetry.stop()
    return 0


def _solve(problem, scheme, fuse_steps, backend, shape, devices, device,
           dtype, compute_errors, c2_field, v_bf16, kernel, overlap):
    """The solver call of the run's path."""
    import torch

    from wavetpu_torch.solver import (
        kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
    )

    if backend == "sharded" and fuse_steps > 1 and scheme == "compensated":
        # The distributed flagship (wavetpu/cli.py:951-986).
        return kfused_comp.solve_kfused_comp_sharded(
            problem, mesh_shape=shape, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors, devices=devices,
            v_dtype=torch.bfloat16 if v_bf16 else None, carry=not v_bf16,
            c2tau2_field=c2_field,
        )
    if backend == "sharded" and fuse_steps > 1:
        return sharded_kfused.solve_sharded_kfused(
            problem, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors, devices=devices,
            mesh_shape=shape, c2tau2_field=c2_field,
        )
    if backend == "sharded":
        return sharded.solve_sharded(
            problem, shape, devices, dtype=dtype,
            compute_errors=compute_errors, c2tau2_field=c2_field,
            scheme=scheme, kernel=kernel, overlap=overlap,
        )
    if scheme == "compensated" and fuse_steps > 1:
        return kfused_comp.solve_kfused_comp(
            problem, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors,
            v_dtype=torch.bfloat16 if v_bf16 else None, carry=not v_bf16,
            c2tau2_field=c2_field, device=device,
        )
    if scheme == "compensated":
        return leapfrog.solve_compensated(
            problem, dtype=dtype, compute_errors=compute_errors,
            device=device, kernel=kernel,
        )
    if fuse_steps > 1 and problem.N % fuse_steps:
        # K does not divide N: wavetpu's pad-and-mask march (K9) on a
        # (1, 1, 1) mesh (wavetpu/cli.py:1201-1213).
        return sharded_kfused.solve_sharded_kfused(
            problem, n_shards=1, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors, devices=[device],
            c2tau2_field=c2_field,
        )
    if fuse_steps > 1:
        return kfused.solve_kfused(
            problem, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors, c2tau2_field=c2_field,
            device=device,
        )
    return leapfrog.solve(
        problem, dtype=dtype, compute_errors=compute_errors,
        c2tau2_field=c2_field, device=device, kernel=kernel,
    )


def _perf_path(backend: str, scheme: str, fuse_steps: int) -> str:
    """The path label `record_solve` stamped for this run."""
    if backend == "sharded":
        if fuse_steps > 1:
            return ("kfused_comp_sharded" if scheme == "compensated"
                    else "sharded_kfused")
        return "sharded"
    if fuse_steps > 1:
        return "kfused_comp" if scheme == "compensated" else "kfused"
    return "compensated" if scheme == "compensated" else "leapfrog"


def _roofline_attrs(path: str) -> dict:
    """The roofline gauges record_solve just stamped under `path` (one
    computation, read back), for the cli.solve span."""
    try:
        from wavetpu_torch.obs.registry import get_registry

        reg = get_registry()
        gbps = reg.gauge("wavetpu_solve_model_gbps", "",
                         ("path",)).value(path=path)
        if not gbps:
            return {}
        return {"model_gbps": gbps, "roofline_fraction": reg.gauge(
            "wavetpu_solve_roofline_fraction", "", ("path",)).value(
                path=path)}
    except Exception:
        return {}  # the X-ray must never fail a finished solve


def _compile_counts() -> dict:
    """What the process has paid for its kernels so far: nvcc runs and
    seconds, library loads (from the build directory) and their seconds,
    and the first launches of template instantiations."""
    from wavetpu_torch.kernels import build, stencil_cuda

    return dict(build.stats,
                first_launch_seconds=stencil_cuda.first_launch_seconds)


def _record_compile(ledger, problem, scheme, fuse_steps, kernel, result,
                    with_field, compute_errors, mesh, before, after):
    """One compile-ledger line for the solve: its batch=1 key, the seconds
    it paid for builds, loads and first launches, and where the libraries
    came from ("fresh": nvcc ran, "disk": loaded from the build directory;
    no source when nothing was loaded)."""
    d = {k: after[k] - before[k] for k in after}
    seconds = (d["nvcc_seconds"] + d["load_seconds"]
               + d["first_launch_seconds"])
    source = ("fresh" if d["nvcc_runs"] else
              "disk" if d["disk_loads"] else None)
    dtype = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}.get(
        str(result.u_cur.dtype).replace("torch.", ""), "f32")
    try:
        ledger.record_compile(ledger.solo_key(
            problem, scheme, "kfused" if fuse_steps > 1 else kernel,
            fuse_steps, dtype, with_field, compute_errors, mesh=mesh,
        ), seconds, source=source)
    except Exception:
        pass  # ledger bookkeeping must never fail the run


def _placement(problem: Problem, flags, fuse_steps: int, platform: str,
               mesh):
    """(backend, mesh shape, devices) of the run (wavetpu/cli.py:587-658).

    The platform's devices are the visible cards on gpu and the CPU (one
    device) on cpu.  Auto means sharded iff there is more than one; an
    explicit --mesh or --backend sharded means sharded, and k-fusion goes
    sharded only on such explicit request.  On gpu a mesh larger than the
    cards exits 2; on cpu every shard lives on the CPU.  Raises ValueError
    with the message to print."""
    import torch

    n_devices = torch.cuda.device_count() if platform == "gpu" else 1
    backend = flags.get("backend", "auto")
    explicit = mesh is not None or backend == "sharded"
    if explicit:
        backend = "sharded"
    elif fuse_steps > 1 or backend == "auto" and n_devices == 1:
        backend = "single"
    elif backend == "auto":
        backend = "sharded"
    if backend == "single":
        shape = (1, 1, 1)
    elif mesh is not None:
        shape = mesh
    elif fuse_steps > 1:
        shape = (n_devices, 1, 1)
    else:
        from wavetpu_torch.core.grid import choose_mesh_shape

        shape = choose_mesh_shape(n_devices)
    n = problem.N
    if fuse_steps > 1:
        # The mesh rules of the k-fused marches, checked before anything is
        # built (a pad-and-mask layout must exist where K9 runs).
        from wavetpu_torch.solver import kfused_comp, sharded_kfused

        if flags.get("scheme") != "compensated":
            sharded_kfused._validate(problem, fuse_steps, shape[0],
                                     shape[1])
        elif backend == "sharded":
            kfused_comp._validate_mesh(problem, fuse_steps, shape[0],
                                       shape[1])
        if ("phase-timing" in flags
                and not sharded_kfused._is_even(problem, fuse_steps,
                                                shape[0])):
            raise ValueError(
                "--phase-timing's k-fused probe covers even decompositions "
                "(k | N/MX); drop it for uneven N")
    if "overlap" in flags and backend == "sharded" and any(
            n % m for m in shape):
        raise ValueError(
            f"overlap mode requires N divisible by every mesh dim "
            f"(N={n}, mesh={tuple(shape)})")
    if backend == "single":
        return backend, shape, None
    from wavetpu_torch.core.grid import Topology

    n_shards = Topology(n, shape).n_devices  # raises if a shard is empty
    if platform == "cpu":
        return backend, shape, ["cpu"] * n_shards
    if n_shards > n_devices:
        raise ValueError(
            f"mesh {shape[0]},{shape[1]},{shape[2]} needs {n_shards} cards, "
            f"{n_devices} visible (on the GPU every shard is a card; "
            f"--platform cpu puts all shards on the CPU)")
    return backend, shape, [torch.device("cuda", i) for i in range(n_shards)]
