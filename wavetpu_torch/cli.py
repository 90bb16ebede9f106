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
    "overlap": "queue 1 item 10, step 3 (--overlap: the exchange on a "
               "second stream)",
    "distributed": "queue 1 item 10, step 5 (--distributed: one process "
                   "per card)",
    "phase-timing": "queue 1 item 10, step 4 (solver/timing.py)",
    "kernel": "queue 1 item 4 (kernel selection; the port picks the CUDA "
              "kernels on the GPU and their plain versions on the CPU)",
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
           "out-dir", "platform", "c2-field", "backend", "mesh")
_VALUELESS = ("no-errors", "overlap", "distributed", "debug-nans",
              "no-watchdog", "phase-timing")
_USAGE = (
    "usage: python -m wavetpu_torch N Np Lx Ly Lz [T] [timesteps] "
    "[--scheme standard|compensated] [--fuse-steps K] "
    "[--dtype f32|f64|bf16] [--v-dtype f32|bf16] "
    "[--c2-field PRESET|FILE.npy] [--no-errors] [--out-dir DIR] "
    "[--platform gpu|cpu] [--backend auto|single|sharded] "
    "[--mesh MX,MY,MZ] | --version"
)


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
    from wavetpu_torch.solver import (
        kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
    )

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
    print(f"scheme: {scheme}")
    if fuse_steps > 1:
        print(f"fuse-steps: {fuse_steps}")
    if backend == "sharded":
        print(f"mesh: {shape[0]},{shape[1]},{shape[2]}")
    dtype = {"f64": torch.float64, "bf16": torch.bfloat16}.get(
        flags.get("dtype"), torch.float32)
    v_bf16 = flags.get("v-dtype") == "bf16"

    if backend == "sharded" and fuse_steps > 1 and scheme == "compensated":
        # The distributed flagship (wavetpu/cli.py:951-986).
        result = kfused_comp.solve_kfused_comp_sharded(
            problem, mesh_shape=shape, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors, devices=devices,
            v_dtype=torch.bfloat16 if v_bf16 else None, carry=not v_bf16,
            c2tau2_field=c2_field,
        )
    elif backend == "sharded" and fuse_steps > 1:
        result = sharded_kfused.solve_sharded_kfused(
            problem, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors, devices=devices,
            mesh_shape=shape, c2tau2_field=c2_field,
        )
    elif backend == "sharded":
        result = sharded.solve_sharded(
            problem, shape, devices, dtype=dtype,
            compute_errors=compute_errors, c2tau2_field=c2_field,
            scheme=scheme,
        )
    elif scheme == "compensated" and fuse_steps > 1:
        result = kfused_comp.solve_kfused_comp(
            problem, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors,
            v_dtype=torch.bfloat16 if v_bf16 else None, carry=not v_bf16,
            c2tau2_field=c2_field, device=device,
        )
    elif scheme == "compensated":
        result = leapfrog.solve_compensated(
            problem, dtype=dtype, compute_errors=compute_errors,
            device=device,
        )
    elif fuse_steps > 1 and problem.N % fuse_steps:
        # K does not divide N: wavetpu's pad-and-mask march (K9) on a
        # (1, 1, 1) mesh (wavetpu/cli.py:1201-1213).
        result = sharded_kfused.solve_sharded_kfused(
            problem, n_shards=1, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors, devices=[device],
            c2tau2_field=c2_field,
        )
    elif fuse_steps > 1:
        result = kfused.solve_kfused(
            problem, dtype=dtype, k=fuse_steps,
            compute_errors=compute_errors, c2tau2_field=c2_field,
            device=device,
        )
    else:
        result = leapfrog.solve(
            problem, dtype=dtype, compute_errors=compute_errors,
            c2tau2_field=c2_field, device=device,
        )

    sharded_run = backend == "sharded"
    path = report.write_report(
        result,
        out_dir=flags.get("out-dir", "."),
        n_procs=shape[0] * shape[1] * shape[2] if sharded_run else 1,
        errors_computed=compute_errors,
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
            # wavetpu's keys, with the values of a run without those
            # features: "pallas" where the CUDA kernels run (wavetpu's
            # kernel path), "roll" where their plain versions run.
            "kernel": "pallas" if platform == "gpu" else "roll",
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
    if compute_errors:
        print(f"max abs error: {result.abs_errors.max():.6g}")
    print(f"throughput: {result.gcells_per_second:.3f} Gcell-updates/s")
    print(f"report: {path}")
    return 0


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
