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
  --stop-step S                     halt after layer S; pairs with
                                    --save-state for preemptible runs
  --save-state PATH                 write the final state as a checkpoint:
                                    one .npz (single backend) or a per-shard
                                    directory of WTS1 files (sharded backend;
                                    io/checkpoint.py, wavetpu's format)
  --resume PATH                     continue a checkpointed run to its
                                    timesteps (positionals then unneeded;
                                    scheme, dtype and mesh come from the
                                    checkpoint): a .npz resumes on the
                                    single backend, a shard directory on the
                                    sharded one, a rotation root (what
                                    --ckpt-dir keeps) through its `latest`
                                    pointer
  --ckpt-every S                    supervised solve (run/supervisor.py):
                                    chunks of ~S layers (snapped to the
                                    --fuse-steps block, so the layers stay
                                    bitwise the unsupervised run's), each
                                    boundary checkpointed into a fresh
                                    rotation entry under --ckpt-dir with an
                                    atomic `latest` pointer and keep-last-2
                                    GC; SIGTERM/SIGINT finish the chunk,
                                    save and exit 3; each chunk is health-
                                    checked (run/health.py), a NaN or
                                    amplitude blowup halts with the last-good
                                    checkpoint (exit 4)
  --ckpt-dir DIR                    the rotation root of --ckpt-every (the
                                    --resume rotation root by default)
  --retries N                       reload the last-good checkpoint after a
                                    watchdog trip and re-run the chunk, up
                                    to N times, before halting
  --max-amp X                       watchdog amplitude bound (default 1e3)
  --no-watchdog                     supervised run without health checks
  --program-cache-dir DIR           adopt the solve's built kernel
                                    libraries from DIR before it runs (no
                                    nvcc), and store them there after a
                                    fresh build (serve/progcache.py)
  --distributed                     one process per rank over
                                    torch.distributed (comm/dist.py), from
                                    torch's env:// variables (MASTER_ADDR,
                                    MASTER_PORT, WORLD_SIZE, RANK,
                                    LOCAL_RANK, as torchrun sets them):
                                    shard i of the mesh belongs to rank
                                    i // (shards / ranks); NCCL where every
                                    rank has a card of its own, gloo on
                                    --platform cpu or where ranks share a
                                    card (planes staged through host
                                    memory).  Only rank 0 prints and writes
                                    the report, sidecar, telemetry,
                                    profile and program cache; each rank
                                    writes its own checkpoint shards
  --debug-nans                      check each launch's output (each step,
                                    or each k-block) for a non-finite value
                                    and stop with the layers named - a check
                                    at launch granularity, where wavetpu's
                                    jax_debug_nans traps the first op; with
                                    --ckpt-every each chunk marches launch
                                    by launch

Subcommands: `serve [...]` (serve/api.py: the serving replica, answering
/solve through the kernels' lane modes; `serve --version`), `warmup
--manifest M.json [--program-cache-dir DIR] [--program-cache-max-bytes B]
[--platform gpu|cpu]` (serve/progcache.py: fill a program cache from a
manifest), `trace-report [TRACE.jsonl ...] [--dir DIR ...] [--request
ID]` (obs/report.py), `ledger-report TELEMETRY_DIR [--json]
[--emit-warmup-manifest OUT.json]` (obs/ledger.py),
`plan-report TELEMETRY_DIR [--json]` (obs/accuracy.py), `profile --out
DIR ARGS...` (obs/perf.py: one full command line under torch.profiler),
and the fleet tier, which imports neither torch nor jax: `router --member
URL [...]` (fleet/router.py: the ProgramKey-affinity front of N
replicas), `fleet roll --router URL --old URL --new URL (--ledger DIR |
--manifest FILE) -- SUCCESSOR ARGV...` (fleet/roll.py: a rolling deploy)
and `loadgen generate|replay|gate [...]` (loadgen/cli.py: trace replay
and its SLO gate).

Exit codes: 0 complete,
2 usage or checkpoint-load error, 3 preempted with a resumable checkpoint
(requeue with --resume), 4 watchdog halt with the last-good checkpoint;
a supervised run that exits 3 or 4 prints `resumable checkpoint: PATH`.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from wavetpu_torch.core.flags import split_flags
from wavetpu_torch.core.problem import Problem

_PORTED = ("scheme", "fuse-steps", "dtype", "v-dtype", "no-errors",
           "out-dir", "platform", "c2-field", "backend", "mesh", "kernel",
           "overlap", "phase-timing", "profile", "telemetry-dir",
           "stop-step", "save-state", "resume", "ckpt-every", "ckpt-dir",
           "retries", "max-amp", "no-watchdog", "debug-nans",
           "program-cache-dir", "distributed")
_VALUELESS = ("no-errors", "overlap", "distributed", "debug-nans",
              "no-watchdog", "phase-timing")
_USAGE = (
    "usage: python -m wavetpu_torch N Np Lx Ly Lz [T] [timesteps] "
    "[--scheme standard|compensated] [--fuse-steps K] "
    "[--dtype f32|f64|bf16] [--v-dtype f32|bf16] "
    "[--c2-field PRESET|FILE.npy] [--no-errors] [--out-dir DIR] "
    "[--platform gpu|cpu] [--backend auto|single|sharded] "
    "[--mesh MX,MY,MZ] [--kernel auto|roll|pallas] [--overlap] "
    "[--phase-timing] [--profile DIR] [--telemetry-dir DIR] "
    "[--stop-step S] [--save-state PATH] [--resume PATH] "
    "[--ckpt-every S] [--ckpt-dir DIR] [--retries N] [--max-amp X] "
    "[--no-watchdog] [--debug-nans] [--program-cache-dir DIR] "
    "[--distributed] | "
    "serve [...] | warmup --manifest M.json [...] | "
    "trace-report [...] | ledger-report DIR [...] | plan-report DIR [...] "
    "| profile --out DIR ARGS... | router --member URL [...] | "
    "fleet roll [...] | loadgen generate|replay|gate [...] | --version"
)
# The subcommands: (module, its entry point).
_SUBCOMMANDS = {
    "serve": ("wavetpu_torch.serve.api", "main"),
    "warmup": ("wavetpu_torch.serve.progcache", "main"),
    "trace-report": ("wavetpu_torch.obs.report", "main"),
    "ledger-report": ("wavetpu_torch.obs.ledger", "main"),
    "plan-report": ("wavetpu_torch.obs.accuracy", "main"),
    "profile": ("wavetpu_torch.obs.perf", "profile_main"),
    # The fleet tier (stdlib only, never torch: routers and load
    # generators run on hosts with no accelerator stack).
    "router": ("wavetpu_torch.fleet.router", "main"),
    "loadgen": ("wavetpu_torch.loadgen.cli", "main"),
}


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
    """Validate argv's flags; returns (positionals, flags, fuse_steps,
    platform, mesh, supervision) - supervision the (ckpt_every, retries,
    max_amp) of --ckpt-every, else None.  The checks that depend on the
    problem or the scheme, which a resumed run takes from its checkpoint,
    are `_check_run`'s.  Raises ValueError (usage)."""
    pos, flags = split_flags(argv, _PORTED, _VALUELESS)
    if flags.get("dtype", "f32") not in ("f32", "f64", "bf16"):
        raise ValueError(f"--dtype must be f32|f64|bf16, got {flags['dtype']}")
    platform = flags.get("platform", "gpu")
    if platform not in ("gpu", "cpu"):
        raise ValueError(f"--platform must be gpu|cpu, got {platform}")
    if flags.get("dtype") == "f64" and platform != "cpu":
        raise ValueError("--dtype f64 runs only on the CPU (--platform cpu)")
    if flags.get("scheme", "standard") not in ("standard", "compensated"):
        raise ValueError(f"--scheme must be standard|compensated, got "
                         f"{flags['scheme']}")
    fuse_steps = int(flags.get("fuse-steps", "1"))
    if fuse_steps < 1:
        raise ValueError(f"--fuse-steps must be >= 1, got {fuse_steps}")
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
    v_dtype = flags.get("v-dtype")
    if v_dtype is not None and v_dtype not in ("f32", "bf16"):
        raise ValueError(f"--v-dtype must be f32|bf16, got {v_dtype}")
    backend = flags.get("backend", "auto")
    if backend not in ("auto", "single", "sharded"):
        raise ValueError(f"--backend must be auto|single|sharded, got "
                         f"{backend}")
    mesh = _parse_mesh(flags)
    if backend == "single" and mesh is not None:
        raise ValueError("--mesh contradicts --backend single")
    if fuse_steps > 1 and mesh is not None and mesh[2] != 1:
        raise ValueError(
            f"--fuse-steps supports (MX,MY,1) meshes (MX, MY >= 1, MZ = 1); "
            f"got {flags['mesh']}"
        )
    if fuse_steps > 8:
        raise ValueError(
            f"--fuse-steps {fuse_steps} must be <= 8 (the k-step kernels' "
            f"tiles)"
        )
    supervision = None
    if "ckpt-every" in flags:
        ckpt_every = int(flags["ckpt-every"])
        if ckpt_every < 1:
            raise ValueError(f"--ckpt-every must be >= 1, got {ckpt_every}")
        if "stop-step" in flags:
            raise ValueError(
                "--ckpt-every supervises the run to completion; it is "
                "exclusive with --stop-step (preempt a supervised run with "
                "SIGTERM instead)")
        retries = int(flags.get("retries", "0"))
        if retries < 0:
            raise ValueError(f"--retries must be >= 0, got {retries}")
        max_amp = float(flags["max-amp"]) if "max-amp" in flags else None
        if max_amp is not None and not max_amp > 0:
            raise ValueError(f"--max-amp must be > 0, got {max_amp}")
        supervision = (ckpt_every, retries, max_amp)
    else:
        for dep in ("ckpt-dir", "retries", "max-amp", "no-watchdog"):
            if dep in flags:
                raise ValueError(f"--{dep} requires --ckpt-every S (the "
                                 f"supervised-solve mode)")
    if "resume" in flags and "stop-step" in flags:
        raise ValueError("--resume and --stop-step are exclusive")
    if "stop-step" in flags:
        int(flags["stop-step"])
    return pos, flags, fuse_steps, platform, mesh, supervision


def _check_run(problem: Problem, flags, scheme: str, fuse_steps: int):
    """The flag checks that depend on the problem and on the scheme - run
    after a resumed run has taken both from its checkpoint, so they also
    cover e.g. `--resume comp_ck --phase-timing`.  Raises ValueError."""
    if scheme == "compensated":
        bad = None
        if flags.get("dtype") == "bf16":
            bad = ("--dtype bf16 (it requires an f32/f64 carrier; for a "
                   "bf16 increment stream use --v-dtype bf16)")
        elif "overlap" in flags:
            bad = "--overlap"
        elif "phase-timing" in flags and fuse_steps < 2:
            bad = ("--phase-timing (the compensated probe covers "
                   "--fuse-steps K programs; the 1-step scheme has none)")
        elif "c2-field" in flags and fuse_steps < 2:
            bad = ("--c2-field without --fuse-steps K (the 1-step "
                   "compensated kernels carry a scalar coefficient; the "
                   "field rides the velocity-form march)")
        elif fuse_steps > 1 and problem.N % fuse_steps:
            bad = (f"--fuse-steps {fuse_steps} (it must divide N="
                   f"{problem.N} for the compensated k-fused march)")
        if bad:
            raise ValueError(
                f"{bad} is not available for the compensated scheme")
    if flags.get("v-dtype") == "bf16" and (scheme != "compensated"
                                           or fuse_steps < 2):
        raise ValueError(
            "--v-dtype bf16 is the increment-form bf16 mode: it requires "
            "--scheme compensated --fuse-steps K"
        )
    if "stop-step" in flags:
        stop = int(flags["stop-step"])
        if not 1 <= stop <= problem.timesteps:
            raise ValueError(f"--stop-step must be in [1, "
                             f"{problem.timesteps}], got {stop}")


class _CheckpointError(Exception):
    """A checkpoint --resume cannot use: exit 2 with its message."""


def _load_resume(flags, fuse_steps: int, mesh):
    """Resolve and read --resume's checkpoint - a .npz, a per-shard
    directory, or a rotation root through its `latest` pointer - before
    anything runs.  Returns a dict: path, rotation root (or None),
    problem, scheme, start step, `sharded`, and for a shard directory its
    mesh and state dtype name, for a .npz its (u_prev, u_cur) and the
    compensated (v, carry) (CPU tensors).  Raises _CheckpointError."""
    import os

    from wavetpu_torch.io import checkpoint
    from wavetpu_torch.run import supervisor

    path, root = flags["resume"], None
    if supervisor.looks_like_rotation_root(path):
        root = path
        path = supervisor.resolve_latest(root)
        if path is None:
            raise _CheckpointError(f"{root} holds no resumable checkpoint")
    out = dict(path=path, root=root, sharded=os.path.isdir(path))
    try:
        if out["sharded"]:
            if flags.get("backend") == "single":
                raise _CheckpointError(
                    "checkpoint is a per-shard directory; --backend single "
                    "cannot resume it")
            problem, start, ck_mesh, dtype_name, scheme = (
                checkpoint.load_sharded_meta(path))
            if mesh is not None and tuple(mesh) != ck_mesh:
                raise _CheckpointError(
                    f"--mesh contradicts the checkpoint's mesh {ck_mesh}")
            if fuse_steps > 1 and ck_mesh[2] != 1:
                raise _CheckpointError(
                    f"--fuse-steps supports (MX,MY,1) meshes; the "
                    f"checkpoint was saved on {ck_mesh}")
            out.update(mesh=ck_mesh, dtype_name=dtype_name)
        else:
            if flags.get("backend") == "sharded" or mesh is not None:
                raise _CheckpointError(
                    "checkpoint is a single-device .npz; --backend sharded/"
                    "--mesh cannot resume it")
            problem, u_prev, u_cur, start = checkpoint.load_checkpoint(path)
            scheme = checkpoint.checkpoint_scheme(path)
            aux = (checkpoint.load_checkpoint_aux(path)
                   if scheme == "compensated" else None)
            out.update(state=(u_prev, u_cur), aux=aux,
                       dtype_name=checkpoint.dtype_name(u_cur.dtype))
    except _CheckpointError:
        raise
    except Exception as e:
        # OSError, KeyError, ValueError, zipfile.BadZipFile (a .npz torn by
        # a mid-save preemption - the case --resume exists for), ...
        raise _CheckpointError(f"cannot load checkpoint: {e}") from e
    out.update(problem=problem, scheme=scheme, start=start)
    return out


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
    from wavetpu_torch.comm import dist

    try:
        return _main(list(sys.argv[1:] if argv is None else argv))
    finally:
        # Every exit path of a --distributed run leaves the group.
        dist.shutdown()


def _main(argv) -> int:
    if argv and argv[0] == "fleet":
        # Fleet operations; `fleet roll`, the rolling-deploy driver.
        if len(argv) > 1 and argv[1] == "roll":
            from wavetpu_torch.fleet import roll as fleet_roll

            return fleet_roll.main(argv[2:])
        print("error: fleet wants a subcommand: roll", file=sys.stderr)
        print("usage: python -m wavetpu_torch fleet roll ...",
              file=sys.stderr)
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
        pos, flags, fuse_steps, platform, mesh, supervision = _parse(argv)
        resume = None
        if "resume" in flags:
            resume = _load_resume(flags, fuse_steps, mesh)
            problem = resume["problem"]
            # A checkpoint resumes under the scheme it was saved with.
            if "scheme" in flags and flags["scheme"] != resume["scheme"]:
                raise _CheckpointError(
                    f"checkpoint was saved with scheme {resume['scheme']}; "
                    f"--scheme {flags['scheme']} cannot resume it")
            scheme = resume["scheme"]
            if resume["sharded"]:
                mesh = resume["mesh"]
            else:
                flags["backend"] = "single"
            if "dtype" not in flags and resume["dtype_name"] == "float64" \
                    and platform != "cpu":
                raise ValueError("the checkpoint holds an f64 state, which "
                                 "runs only on the CPU (--platform cpu)")
        else:
            problem = Problem.from_argv(pos)
            scheme = flags.get("scheme", "standard")
        _check_run(problem, flags, scheme, fuse_steps)
    except _CheckpointError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2
    supervised = supervision is not None
    ckpt_dir = None
    if supervised:
        ckpt_dir = flags.get("ckpt-dir") or (resume or {}).get("root")
        if not ckpt_dir:
            print("error: --ckpt-every needs --ckpt-dir DIR (or --resume of "
                  "an existing rotation root)", file=sys.stderr)
            return 2

    import torch

    if platform == "gpu" and not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU unless "
              "--platform cpu is given", file=sys.stderr)
        return 2
    device = torch.device("cuda" if platform == "gpu" else "cpu")
    from wavetpu_torch.comm import dist

    world_size = None
    try:
        if "distributed" in flags:
            world_size = dist.env_config()[1]
        backend, shape, devices = _placement(problem, flags, fuse_steps,
                                             platform, mesh, scheme,
                                             world_size)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    world = None
    if world_size is not None:
        # The process group (an NCCL init that fails raises: the run ends
        # with a nonzero code, never carries on over gloo or the CPU).
        world = dist.init(platform, shape[0] * shape[1] * shape[2])
        devices = _rank_devices(world, shape)
        if world.cards:
            device = torch.device("cuda", world.cards[0])
    main_rank = world is None or world.is_main
    say = print if main_rank else _silent

    from wavetpu_torch.io import report
    from wavetpu_torch.obs import ledger, tracing
    from wavetpu_torch.progkey import resolve_kernel

    kernel = resolve_kernel(flags.get("kernel", "auto"), platform)
    overlap = "overlap" in flags
    # Courant printout before solving (openmp_sol.cpp:214); under
    # --distributed it waits until the rank is known, so only rank 0
    # speaks (mpi_new.cpp:356-371).
    say(f"C = {problem.courant:.6g}")
    if world is not None:
        say(f"distributed: {world.describe()}")
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
            say("errors: disabled (--c2-field has no analytic oracle)")
            compute_errors = False
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    say(f"device: {device_name}")
    say(f"kernel: {kernel}")
    say(f"scheme: {scheme}")
    if fuse_steps > 1:
        say(f"fuse-steps: {fuse_steps}")
    if backend == "sharded":
        say(f"mesh: {shape[0]},{shape[1]},{shape[2]}")
    from wavetpu_torch.io import checkpoint

    dtype = {"f64": torch.float64, "bf16": torch.bfloat16}.get(
        flags.get("dtype"), torch.float32)
    if resume is not None and "dtype" not in flags:
        # A resumed run keeps the checkpoint's dtype: a cast would break
        # the bitwise-equal resume.
        dtype = checkpoint.torch_dtype(resume["dtype_name"])
    stop_step = int(flags["stop-step"]) if "stop-step" in flags else None

    run = _Run(problem, scheme, fuse_steps, backend, shape, devices, device,
               dtype, compute_errors, c2_field, kernel, overlap, flags)
    if resume is not None:
        try:
            run.take_checkpoint(resume)
        except _CheckpointError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    telemetry = None
    if "telemetry-dir" in flags and main_rank:
        # Spans to DIR/trace.jsonl, heartbeat registry snapshots and the
        # ledgers (obs/telemetry.py).  With --profile the spans label the
        # profiler's trace whether or not this is on (obs/tracing.py).
        from wavetpu_torch.obs import telemetry as obs_telemetry

        telemetry = obs_telemetry.start(flags["telemetry-dir"])
        say(f"telemetry: {flags['telemetry-dir']}")
    prof = None
    if "profile" in flags and main_rank:
        from wavetpu_torch.obs import perf as obs_perf

        prof = torch.profiler.profile(
            activities=obs_perf.profiler_activities())
        prof.__enter__()
    solve_span = tracing.begin_span(
        "cli.solve", backend=backend, scheme=scheme, kernel=kernel,
        fuse_steps=fuse_steps, n=problem.N, timesteps=problem.timesteps,
        supervised=supervised, resumed=resume is not None,
    )
    compiled = _compile_counts()
    pcache = None
    sup_out = None
    try:
        if "program-cache-dir" in flags:
            pcache = _ProgramCacheRun(
                flags["program-cache-dir"], device, kernel, problem, scheme,
                fuse_steps, dtype, c2_field is not None, compute_errors,
                shape if backend == "sharded" else None, main_rank)
        if supervised:
            sup_out = run.supervise(supervision, ckpt_dir,
                                    "no-watchdog" not in flags,
                                    "debug-nans" in flags)
            result = sup_out.result
            say(f"supervisor: {sup_out.status}; "
                f"{sup_out.checkpoints_written} checkpoint(s), "
                f"{sup_out.retries_used} retr"
                f"{'y' if sup_out.retries_used == 1 else 'ies'}, "
                f"overhead {sup_out.overhead_seconds * 1000:.0f}ms")
        elif "debug-nans" in flags:
            result = run.checked(stop_step)
        elif resume is not None:
            result = run.resume()
        else:
            result = _solve(problem, scheme, fuse_steps, backend, shape,
                            devices, device, dtype, compute_errors, c2_field,
                            flags.get("v-dtype") == "bf16", kernel, overlap,
                            stop_step)
        span_extra = {}
        if tracing.enabled():
            span_extra = _roofline_attrs(_perf_path(backend, scheme,
                                                    fuse_steps))
        tracing.end_span(
            solve_span, final_step=result.final_step,
            gcells_per_s=round(result.gcells_per_second, 3), **span_extra,
        )
        if ledger.enabled() and not supervised:
            # A supervised run's chunks record their own compiles
            # (run/supervisor.py).
            _record_compile(ledger, problem, scheme, fuse_steps, kernel,
                            result, c2_field is not None, compute_errors,
                            shape if backend == "sharded" else None,
                            compiled, _compile_counts(),
                            fresh_compile_s=(None if pcache is None
                                             else pcache.fresh_compile_s))
        if pcache is not None:
            pcache.store(compiled, _compile_counts())
        if "save-state" in flags:
            if backend == "sharded":
                ck_path = checkpoint.save_sharded_checkpoint(
                    flags["save-state"], result)
            else:
                ck_path = checkpoint.save_checkpoint(flags["save-state"],
                                                     result)
            say(f"checkpoint: {ck_path}")
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
                v_dtype=(torch.bfloat16 if flags.get("v-dtype") == "bf16"
                         else None),
            )
            exchange_seconds = pb.exchange_seconds
            loop_seconds = pb.loop_seconds
            probe_steps = pb.steps_measured

        if not main_rank:
            # Rank 0 alone writes the report and speaks; every rank leaves
            # with the run's one exit code.
            return sup_out.exit_code if sup_out is not None else 0
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
                # The state's dtype (a resumed run inherits the
                # checkpoint's).
                "dtype": str(result.u_cur.dtype).replace("torch.", ""),
                "v_dtype": flags.get("v-dtype"),
                "c2_field": flags.get("c2-field"),
                # "pallas" where the CUDA kernels ran (wavetpu's kernel
                # path), "roll" where their plain versions ran.
                "kernel": kernel,
                "distributed": world is not None,
                "resumed": resume is not None,
                "supervised": supervised,
                "ckpt_every": supervision[0] if supervised else None,
                "supervisor_status": (sup_out.status if sup_out is not None
                                      else None),
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
        if sup_out is not None and sup_out.status != "complete":
            # The orchestration contract: 3 = requeue with --resume, 4 =
            # page an operator, and the resumable path in the output.
            if sup_out.status == "preempted":
                print(f"preempted: checkpointed at step "
                      f"{sup_out.final_step}")
            else:
                print(f"watchdog: numerical-health trip (guarded amax "
                      f"{sup_out.amax_last:g}); last good step "
                      f"{sup_out.final_step}")
            if sup_out.checkpoint_path:
                print(f"resumable checkpoint: {sup_out.checkpoint_path}")
            return sup_out.exit_code
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
           dtype, compute_errors, c2_field, v_bf16, kernel, overlap,
           stop_step=None):
    """The solver call of the run's path."""
    import torch

    from wavetpu_torch.solver import (
        kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
    )

    common = dict(dtype=dtype, compute_errors=compute_errors,
                  stop_step=stop_step)
    if backend == "sharded" and fuse_steps > 1 and scheme == "compensated":
        # The distributed flagship (wavetpu/cli.py:951-986).
        return kfused_comp.solve_kfused_comp_sharded(
            problem, mesh_shape=shape, k=fuse_steps, devices=devices,
            v_dtype=torch.bfloat16 if v_bf16 else None, carry=not v_bf16,
            c2tau2_field=c2_field, **common)
    if backend == "sharded" and fuse_steps > 1:
        return sharded_kfused.solve_sharded_kfused(
            problem, k=fuse_steps, devices=devices, mesh_shape=shape,
            c2tau2_field=c2_field, **common)
    if backend == "sharded":
        return sharded.solve_sharded(
            problem, shape, devices, c2tau2_field=c2_field, scheme=scheme,
            kernel=kernel, overlap=overlap, **common)
    if scheme == "compensated" and fuse_steps > 1:
        return kfused_comp.solve_kfused_comp(
            problem, k=fuse_steps,
            v_dtype=torch.bfloat16 if v_bf16 else None, carry=not v_bf16,
            c2tau2_field=c2_field, device=device, **common)
    if scheme == "compensated":
        return leapfrog.solve_compensated(problem, device=device,
                                          kernel=kernel, **common)
    if fuse_steps > 1 and problem.N % fuse_steps:
        # K does not divide N: wavetpu's pad-and-mask march (K9) on a
        # (1, 1, 1) mesh (wavetpu/cli.py:1201-1213).
        return sharded_kfused.solve_sharded_kfused(
            problem, n_shards=1, k=fuse_steps, devices=[device],
            c2tau2_field=c2_field, **common)
    if fuse_steps > 1:
        return kfused.solve_kfused(problem, k=fuse_steps,
                                   c2tau2_field=c2_field, device=device,
                                   **common)
    return leapfrog.solve(problem, c2tau2_field=c2_field, device=device,
                          kernel=kernel, **common)


class _Run:
    """The resumed, supervised and --debug-nans forms of a run's path: a
    checkpoint's state taken in, and the resume entry points, the
    supervisor and its launch-by-launch check dispatched on the path."""

    def __init__(self, problem, scheme, fuse_steps, backend, shape, devices,
                 device, dtype, compute_errors, c2_field, kernel, overlap,
                 flags):
        self.problem, self.scheme, self.k = problem, scheme, fuse_steps
        self.backend, self.shape = backend, shape
        self.devices = devices if backend == "sharded" else [device]
        self.device, self.dtype = device, dtype
        self.compute_errors, self.c2_field = compute_errors, c2_field
        self.kernel, self.overlap, self.flags = kernel, overlap, flags
        self.state = self.start = None
        self.v_bf16 = flags.get("v-dtype") == "bf16"

    def take_checkpoint(self, resume: dict) -> None:
        """The checkpoint's state: a shard directory is loaded onto the
        mesh's devices; a .npz was read by `_load_resume`.  A bf16
        increment stream beside a non-bf16 carrier marks the carry-less
        increment form (k-fused only): its stored zero carry is dropped and
        the sidecar records `v_dtype` bf16."""
        import torch

        from wavetpu_torch.io import checkpoint

        self.start = resume["start"]
        if resume["sharded"]:
            try:
                _, u_prev, u_cur, _, _, _, aux = (
                    checkpoint.load_sharded_checkpoint(resume["path"],
                                                       self.devices))
            except Exception as e:
                # A missing or truncated shard, a step/meta mismatch from a
                # mid-save preemption: the same clean exit as a torn .npz.
                raise _CheckpointError(f"cannot load checkpoint: {e}") from e
        else:
            (u_prev, u_cur), aux = resume["state"], resume["aux"]
        if self.scheme != "compensated":
            self.state = (u_prev, u_cur)
            return
        v, carry = aux
        if (self.k > 1 and v.dtype == torch.bfloat16
                and self.dtype != torch.bfloat16):
            self.flags["v-dtype"] = "bf16"
            self.v_bf16 = True
            carry = None
        self.state = (u_cur, v, carry)

    def spec(self):
        import torch

        from wavetpu_torch.run import supervisor

        return supervisor.PathSpec(
            backend=self.backend, scheme=self.scheme, fuse_steps=self.k,
            kernel=self.kernel, dtype=self.dtype,
            v_dtype=torch.bfloat16 if self.v_bf16 else None,
            carry=not self.v_bf16,
            mesh_shape=self.shape if self.backend == "sharded" else None,
            c2tau2_field=self.c2_field, compute_errors=self.compute_errors,
            overlap=self.overlap, devices=tuple(self.devices))

    def supervise(self, supervision, ckpt_dir: str, watchdog: bool,
                  debug_nans: bool):
        from wavetpu_torch.run import supervisor

        ckpt_every, retries, max_amp = supervision
        return supervisor.supervise(
            self.problem, self.spec(),
            supervisor.SupervisorOptions(
                ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, retries=retries,
                watchdog=watchdog, max_amp=max_amp, debug_nans=debug_nans),
            state=self.state, start_step=self.start)

    def checked(self, stop_step):
        from wavetpu_torch.run import supervisor

        return supervisor.checked_march(self.problem, self.spec(), stop_step,
                                        state=self.state,
                                        start_step=self.start)

    def resume(self):
        """The resume entry point of the path (wavetpu/cli.py:951-1150)."""
        from wavetpu_torch.solver import (
            kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
        )

        p, st, start = self.problem, self.state, self.start
        common = dict(dtype=self.dtype, compute_errors=self.compute_errors)
        if self.backend == "sharded":
            kw = dict(mesh_shape=self.shape, devices=self.devices,
                      c2tau2_field=self.c2_field, **common)
            if self.k > 1 and self.scheme == "compensated":
                return kfused_comp.resume_kfused_comp_sharded(
                    p, *st, start, k=self.k, **kw)
            if self.k > 1:
                return sharded_kfused.resume_sharded_kfused(
                    p, *st, start, k=self.k, **kw)
            if self.scheme == "compensated":
                u, v, c = st
                return sharded.resume_sharded(
                    p, None, u, start, kernel=self.kernel,
                    scheme="compensated", comp_v=v, comp_carry=c, **kw)
            return sharded.resume_sharded(p, *st, start, kernel=self.kernel,
                                          overlap=self.overlap, **kw)
        kw = dict(device=self.device, **common)
        if self.k > 1 and self.scheme == "compensated":
            return kfused_comp.resume_kfused_comp(
                p, *st, start, k=self.k, c2tau2_field=self.c2_field, **kw)
        if self.scheme == "compensated":
            return leapfrog.resume_compensated(p, *st, start,
                                               kernel=self.kernel, **kw)
        if self.k > 1 and p.N % self.k:
            # The pad-and-mask march on a (1, 1, 1) mesh, as the solve.
            return sharded_kfused.resume_sharded_kfused(
                p, *st, start, n_shards=1, k=self.k, devices=self.devices,
                c2tau2_field=self.c2_field, **common)
        if self.k > 1:
            return kfused.resume_kfused(p, *st, start, k=self.k,
                                        c2tau2_field=self.c2_field, **kw)
        return leapfrog.resume(p, *st, start, c2tau2_field=self.c2_field,
                               kernel=self.kernel, **kw)


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
                    with_field, compute_errors, mesh, before, after,
                    fresh_compile_s=None):
    """One compile-ledger line for the solve: its batch=1 key, the seconds
    it paid for builds, loads and first launches, and where the libraries
    came from ("fresh": nvcc ran, "disk": loaded from the build directory
    or adopted from --program-cache-dir, whose entry names the fresh build
    it replaced, `fresh_compile_s`; no source when nothing was loaded)."""
    d = {k: after[k] - before[k] for k in after}
    seconds = (d["nvcc_seconds"] + d["load_seconds"]
               + d["first_launch_seconds"])
    source = ("fresh" if d["nvcc_runs"] else
              "disk" if d["disk_loads"] else None)
    dtype = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}.get(
        str(result.u_cur.dtype).replace("torch.", ""), "f32")
    try:
        extra = {}
        if source == "disk" and fresh_compile_s is not None:
            extra["fresh_compile_s"] = fresh_compile_s
        ledger.record_compile(ledger.solo_key(
            problem, scheme, "kfused" if fuse_steps > 1 else kernel,
            fuse_steps, dtype, with_field, compute_errors, mesh=mesh,
        ), seconds, source=source, **extra)
    except Exception:
        pass  # ledger bookkeeping must never fail the run


class _ProgramCacheRun:
    """--program-cache-dir on a CLI solve: before it runs, adopt the
    kernel libraries its build loads (every library on the card with the
    CUDA kernels, none for the plain versions) from the entry of its
    batch=1 key; after a solve that built them, store them.  A missing or
    refused entry is counted and the solve builds as usual (nvcc) - never
    the plain versions."""

    def __init__(self, directory, device, kernel, problem, scheme,
                 fuse_steps, dtype, with_field, compute_errors, mesh,
                 main_rank: bool = True):
        from wavetpu_torch.kernels import stencil_cuda
        from wavetpu_torch.obs import accuracy, ledger
        from wavetpu_torch.serve import progcache

        # A --distributed rank other than 0 adopts from the cache and
        # writes nothing there.
        self.main_rank = main_rank
        self.cache = progcache.ProgramCache(directory, device=device,
                                            read_only=not main_rank)
        self.key = ledger.solo_key(
            problem, scheme, "kfused" if fuse_steps > 1 else kernel,
            fuse_steps, accuracy.dtype_name(dtype), with_field,
            compute_errors, mesh=mesh)
        self.need = (tuple(stencil_cuda._LOADERS)
                     if device.type == "cuda" and kernel == "pallas"
                     else ())
        self.fresh_compile_s = None
        self.adopted = False
        entry = self.cache.load(self.key)
        if entry is not None:
            payload, header = entry
            try:
                progcache.adopt_libraries(payload, self.need)
                self.adopted = True
                fresh = header.get("compile_s")
                if isinstance(fresh, (int, float)):
                    self.fresh_compile_s = fresh
            except progcache.FingerprintMismatch:
                self.cache.count("fingerprint_mismatch")
            except Exception:
                self.cache.count("corrupt")
        if main_rank:
            print(f"program cache: {directory} ["
                  f"{'adopted' if self.adopted else 'miss'}: "
                  f"{', '.join(self.need) or 'no kernel library'}]")

    def store(self, before: dict, after: dict) -> None:
        """Store the solve's libraries (built now or found in the build
        directory) unless they came from the cache, crediting the entry
        with what this solve paid for them."""
        from wavetpu_torch.serve import progcache

        if self.adopted or not self.main_rank:
            return
        seconds = sum(after[k] - before[k] for k in (
            "nvcc_seconds", "load_seconds", "first_launch_seconds"))
        self.cache.put(self.key, progcache.library_payload(self.need),
                       seconds)


def _silent(*args, **kwargs) -> None:
    """`print` on a --distributed rank other than 0."""


def _rank_devices(world, shape):
    """The mesh's devices under --distributed: this rank's shards on its
    placement's cards (comm/dist.py), or the CPU; another rank's shard
    gets a placeholder (core/grid.py's build_mesh makes it `meta`)."""
    import torch

    from wavetpu_torch.comm import dist

    ranks = dist.shard_ranks(shape[0] * shape[1] * shape[2], world.size)
    out = [torch.device("meta")] * len(ranks)
    mine = [i for i, r in enumerate(ranks) if r == world.rank]
    for j, i in enumerate(mine):
        out[i] = (torch.device("cuda", world.cards[j]) if world.cards
                  else torch.device("cpu"))
    return out


def _placement(problem: Problem, flags, fuse_steps: int, platform: str,
               mesh, scheme: str = "standard",
               world_size: Optional[int] = None):
    """(backend, mesh shape, devices) of the run (wavetpu/cli.py:587-658).

    The platform's devices are the visible cards on gpu and the CPU (one
    device) on cpu; under --distributed (`world_size` ranks) they are one
    per rank, as wavetpu's `jax.devices()` spans the processes.  Auto
    means sharded iff there is more than one; an explicit --mesh or
    --backend sharded means sharded, and k-fusion goes sharded only on
    such explicit request.  On gpu a mesh larger than the cards exits 2;
    on cpu every shard lives on the CPU.  Under --distributed the ranks
    must divide the shards, the single backend runs on a world of one
    only, and the devices come from the process group (`_rank_devices`:
    None here).  Raises ValueError with the message to print."""
    import torch

    if world_size is not None:
        n_devices = world_size
    else:
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

        if scheme != "compensated":
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
        if world_size is not None and world_size > 1:
            raise ValueError(
                f"--backend single runs on one device; across "
                f"{world_size} --distributed ranks it has no meaning "
                f"(give --mesh MX,MY,MZ)")
        return backend, shape, None
    from wavetpu_torch.core.grid import Topology

    n_shards = Topology(n, shape).n_devices  # raises if a shard is empty
    if world_size is not None:
        from wavetpu_torch.comm import dist

        dist.shard_ranks(n_shards, world_size)
        return backend, shape, None
    if platform == "cpu":
        return backend, shape, ["cpu"] * n_shards
    if n_shards > n_devices:
        raise ValueError(
            f"mesh {shape[0]},{shape[1]},{shape[2]} needs {n_shards} cards, "
            f"{n_devices} visible (on the GPU every shard is a card; "
            f"--platform cpu puts all shards on the CPU)")
    return backend, shape, [torch.device("cuda", i) for i in range(n_shards)]
