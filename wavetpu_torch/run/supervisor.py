"""Solve supervisor: chunked march with checkpoints, watchdog, signals (the
port of wavetpu/run/supervisor.py).

Every solver entry point treats a solve as one uninterruptible march: it
either finishes or loses everything since the last manual `--stop-step`
save.  This module wraps every solver path (standard/compensated,
1-step/k-fused, single/sharded, variable-c) in the discipline of a
restartable job:

 * **Chunked march.**  The solve runs as chunks of `ckpt_every` layers,
   snapped down to the k-fusion block size, so chunk boundaries sit on
   the uninterrupted march's block grid - which keeps supervised layers
   bitwise the unsupervised solve's.  Chunk 1 is the ordinary
   `solve_*(stop_step=...)`; every later chunk re-enters through the
   solver's chunk runner (`make_*chunk_runner`), built ONCE per chunk
   length - oracle tables and field on the device, kernels loaded - and
   given the start layer when it runs (a shorter final chunk builds one
   more runner).  A runner's build runs no nvcc and loads no library
   once the first chunk has; each chunk's span in the trace carries what
   it paid (nvcc runs, library loads, first launches of kernel
   instantiations), and a chunk that built or loaded a library writes a
   compile-ledger line.

 * **Periodic checkpointing.**  Each chunk boundary saves to a FRESH entry
   `step-XXXXXXXX[.npz]` under the rotation root, then atomically updates
   the `latest` pointer file and garbage-collects all but the newest
   `keep` entries (plus stale `latest.tmp-*` debris).  A preemption
   mid-save can tear only the entry the pointer does not yet reference.

 * **Numerical-health watchdog.**  After each chunk (and any injected
   fault - run/faults.py) the guard of run/health.py reduces the state to
   one scalar per array; a NaN/Inf or amplitude blowup halts the run with
   the LAST-GOOD step and checkpoint instead of marching garbage to the
   final layer.

 * **Preemption.**  SIGTERM/SIGINT set a flag; the supervisor finishes the
   current chunk, saves, and returns `status="preempted"` (CLI exit code
   3 - requeue me).  `--resume <rotation root>` re-enters from `latest`,
   and the cycle composes across repeated preemptions.

 * **Bounded auto-retry.**  `retries=N` reloads the last-good checkpoint
   after a watchdog trip and re-runs the chunk - the transient-fault model
   (a bit flip, an injected NaN).  A deterministic blowup trips again and
   exhausts the budget, landing in the watchdog halt (CLI exit code 4 -
   page me).

Under `--distributed` (comm/dist.py) every rank runs the supervisor over
its own shards: the health reading and the preemption flag are reduced
across ranks at each chunk boundary, so every rank retries, halts or
preempts at the same step, and only rank 0 flips the rotation's `latest`
pointer and collects old entries (wavetpu's `is_main`).

Exit-code contract (wavetpu_torch.cli): 0 complete, 2 usage/load error,
3 preempted-but-checkpointed (resumable), 4 watchdog halt (last-good
checkpoint preserved).

The module imports no torch at import time, so the CLI can resolve
rotation pointers before anything else.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import signal
import threading
import time
from typing import Callable, Optional, Tuple

EXIT_COMPLETE = 0
EXIT_PREEMPTED = 3
EXIT_WATCHDOG = 4

_STEP_PREFIX = "step-"
_LATEST = "latest"


# ------------------------------------------------------------- rotation


def _entry_step(name: str) -> Optional[int]:
    """The step number of a rotation entry name, else None."""
    if not name.startswith(_STEP_PREFIX):
        return None
    stem = name[len(_STEP_PREFIX):]
    if stem.endswith(".npz"):
        stem = stem[:-4]
    return int(stem) if stem.isdigit() else None


def resolve_latest(root: str) -> Optional[str]:
    """The newest checkpoint under a rotation root, or None.  Prefers the
    atomically updated `latest` pointer; falls back to the highest-numbered
    `step-*` entry (pointer lost to a crash before any update)."""
    if not os.path.isdir(root):
        return None
    ptr = os.path.join(root, _LATEST)
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        cand = os.path.join(root, name)
        if name and os.path.exists(cand):
            return cand
    best = None
    for e in os.listdir(root):
        s = _entry_step(e)
        if s is not None and (best is None or s > best[0]):
            best = (s, e)
    return os.path.join(root, best[1]) if best else None


def looks_like_rotation_root(path: str) -> bool:
    """True for a checkpoint ROTATION directory (what --resume may name),
    as opposed to a per-shard checkpoint directory itself (which carries
    meta.npz at its top level)."""
    if not os.path.isdir(path):
        return False
    if os.path.exists(os.path.join(path, "meta.npz")):
        return False
    if os.path.exists(os.path.join(path, _LATEST)):
        return True
    return any(_entry_step(e) is not None for e in os.listdir(path))


class CheckpointRotation:
    """Rotating fresh-entry checkpoint writer with a `latest` pointer and
    keep-last-N garbage collection (see the module docstring); with
    `is_main` False (a rank other than 0) it writes its entries' files
    and leaves the pointer and the collection to the main process."""

    def __init__(self, root: str, keep: int = 2, is_main: bool = True):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.root = root
        self.keep = keep
        self.is_main = is_main
        os.makedirs(root, exist_ok=True)

    def entry_path(self, step: int, directory: bool) -> str:
        name = f"{_STEP_PREFIX}{step:08d}" + ("" if directory else ".npz")
        return os.path.join(self.root, name)

    def save(self, save_fn: Callable[[str], Optional[str]], step: int,
             directory: bool) -> str:
        """Run `save_fn(entry_path)` into a fresh entry, then (on the main
        process) flip the `latest` pointer and GC old entries."""
        path = self.entry_path(step, directory)
        actual = save_fn(path) or path
        if self.is_main:
            self._write_latest(os.path.basename(actual))
            self._gc()
        return actual

    def latest_path(self) -> Optional[str]:
        return resolve_latest(self.root)

    def _write_latest(self, name: str) -> None:
        tmp = os.path.join(self.root, f"{_LATEST}.tmp-{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(name + "\n")
        os.replace(tmp, os.path.join(self.root, _LATEST))

    def _gc(self) -> None:
        entries = sorted(
            (s, e) for e in os.listdir(self.root)
            if (s := _entry_step(e)) is not None
        )
        for _, e in entries[:-self.keep]:
            p = os.path.join(self.root, e)
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            else:
                try:
                    os.remove(p)
                except OSError:
                    pass
        # Stale pointer temp files from a writer killed mid-update.
        for e in os.listdir(self.root):
            if e.startswith(f"{_LATEST}.tmp-"):
                try:
                    os.remove(os.path.join(self.root, e))
                except OSError:
                    pass


# ----------------------------------------------------------------- specs


@dataclasses.dataclass(frozen=True)
class PathSpec:
    """Which solver path to supervise - the resolved form of the CLI's
    backend/scheme/kernel/fusion flags (cli.py's dispatch)."""

    backend: str = "single"            # "single" | "sharded"
    scheme: str = "standard"           # "standard" | "compensated"
    fuse_steps: int = 1
    kernel: str = "pallas"             # "pallas" (CUDA kernels) | "roll"
    dtype: object = None               # torch dtype; None -> float32
    v_dtype: object = None             # bf16 increment stream (flagship)
    carry: bool = True                 # Kahan carry on (flagship)
    mesh_shape: Optional[Tuple[int, int, int]] = None
    c2tau2_field: object = None        # host (N,N,N) tau^2 c^2 array
    compute_errors: bool = True
    overlap: bool = False
    block_x: Optional[int] = None
    # The device (single backend: devices[0]) or the mesh's devices in
    # mesh order (sharded; a device may repeat).  None: the CUDA device /
    # every visible card.
    devices: Optional[Tuple] = None


@dataclasses.dataclass
class SupervisorOptions:
    ckpt_every: int
    ckpt_dir: str
    retries: int = 0
    watchdog: bool = True
    max_amp: Optional[float] = None    # None -> health.DEFAULT_AMP_BOUND
    keep: int = 2
    handle_signals: bool = True
    chunk_hook: Optional[Callable] = None  # fault port (run/faults.py)
    # --debug-nans: every chunk marches launch by launch, each launch's
    # output checked (`_march_checked`); a non-finite value raises
    # FloatingPointError naming its layers and the chunk's.
    debug_nans: bool = False


@dataclasses.dataclass
class SupervisedResult:
    result: object                     # leapfrog.SolveResult
    status: str                        # "complete"|"preempted"|"watchdog"
    exit_code: int
    final_step: int                    # layer result.u_cur holds
    checkpoint_path: Optional[str]     # resumable path (rotation entry)
    checkpoints_written: int
    retries_used: int
    overhead_seconds: float            # health checks + saves + GC
    amax_last: Optional[float]         # last watchdog reading


# ---------------------------------------------------------------- signals


class _SignalGuard:
    """SIGTERM/SIGINT flag handlers for the duration of a supervised march
    (main thread only; the previous handlers come back on exit).  The
    first signal sets `triggered` and restores that signal's original
    handler, so a second delivery regains its default force-kill
    meaning."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enabled: bool = True):
        self.enabled = (
            enabled
            and threading.current_thread() is threading.main_thread()
        )
        self.triggered: Optional[int] = None
        self._prev = {}

    def __enter__(self):
        if self.enabled:
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._handle)
        return self

    def _handle(self, signum, frame):
        self.triggered = signum
        import sys

        print(
            f"wavetpu_torch: received signal {signum}; finishing the "
            f"current chunk, checkpointing, and exiting resumable",
            file=sys.stderr,
        )
        signal.signal(signum, self._prev[signum])

    def __exit__(self, *exc):
        if self.enabled:
            for s, h in self._prev.items():
                if signal.getsignal(s) == self._handle:
                    signal.signal(s, h)
        return False


# ------------------------------------------------------------------ path


def _compile_counts() -> dict:
    """What the process has paid for its kernels so far (nvcc runs,
    library loads, first-launch seconds)."""
    from wavetpu_torch.kernels import build, stencil_cuda

    return dict(nvcc_runs=build.stats["nvcc_runs"],
                loads=build.stats["loads"],
                nvcc_seconds=build.stats["nvcc_seconds"],
                load_seconds=build.stats["load_seconds"],
                first_launch_seconds=stencil_cuda.first_launch_seconds)


class _Path:
    """Adapter from a PathSpec to its solver family: the first chunk (the
    ordinary solve), cached fixed-length chunk runners, state <->
    checkpoint conversion."""

    def __init__(self, problem, spec: PathSpec):
        import torch

        self.problem = problem
        self.spec = spec
        self.dtype = torch.float32 if spec.dtype is None else spec.dtype
        self.compensated = spec.scheme == "compensated"
        self.k = spec.fuse_steps
        self.carry_on = (spec.carry if (self.compensated and self.k > 1)
                         else self.compensated)
        self._runners = {}    # chunk length -> runner
        self._resolve_kind()

    def _resolve_kind(self):
        from wavetpu_torch.solver import leapfrog, sharded_kfused

        spec, n = self.spec, self.problem.N
        if spec.backend == "single":
            self.device = leapfrog.resolve_device(
                spec.devices[0] if spec.devices else None)
            self.devices = [self.device]
            if self.k <= 1:
                self.kind = "comp1" if self.compensated else "single1"
            elif self.compensated:
                self.kind = "kfused_comp"
            elif n % self.k == 0:
                self.kind = "kfused"
            else:
                # The pad-and-mask march on a (1, 1, 1) mesh, as cli.py.
                self.kind = "uneven"
            self.mesh_shape = (1, 1, 1)
            return
        devices = leapfrog.resolve_devices(spec.devices)
        self.device = devices[0]
        self.kind = ("sharded1" if self.k <= 1 else
                     "sharded_kfused_comp" if self.compensated else
                     "sharded_kfused")
        if self.k > 1 and spec.mesh_shape is None:
            self.mesh_shape = (len(devices), 1, 1)
        elif spec.mesh_shape is None:
            from wavetpu_torch.core.grid import choose_mesh_shape

            self.mesh_shape = choose_mesh_shape(len(devices))
        else:
            self.mesh_shape = tuple(spec.mesh_shape)
        if self.k > 1:
            sharded_kfused._resolve_grid(self.mesh_shape, None, devices)
        m = self.mesh_shape
        self.devices = devices[: m[0] * m[1] * m[2]]

    @property
    def saves_directory(self) -> bool:
        """Sharded backends checkpoint per-shard directories; the single
        backend (its uneven pad-and-mask route included) one .npz."""
        return self.spec.backend == "sharded"

    # -- first chunk (the ordinary solve) --------------------------------

    def first(self, stop: int):
        from wavetpu_torch.solver import (
            kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
        )

        spec, p = self.spec, self.problem
        common = dict(dtype=self.dtype, compute_errors=spec.compute_errors,
                      stop_step=stop)
        if self.kind == "single1":
            res = leapfrog.solve(p, device=self.device, kernel=spec.kernel,
                                 c2tau2_field=spec.c2tau2_field, **common)
        elif self.kind == "comp1":
            res = leapfrog.solve_compensated(p, device=self.device,
                                             kernel=spec.kernel, **common)
        elif self.kind == "kfused":
            res = kfused.solve_kfused(p, k=self.k, device=self.device,
                                      c2tau2_field=spec.c2tau2_field,
                                      **common)
        elif self.kind == "kfused_comp":
            res = kfused_comp.solve_kfused_comp(
                p, k=self.k, block_x=spec.block_x, v_dtype=spec.v_dtype,
                carry=spec.carry, c2tau2_field=spec.c2tau2_field,
                device=self.device, **common)
        elif self.kind == "uneven":
            res = sharded_kfused.solve_sharded_kfused(
                p, n_shards=1, k=self.k, devices=self.devices,
                c2tau2_field=spec.c2tau2_field, **common)
        elif self.kind == "sharded1":
            res = sharded.solve_sharded(
                p, self.mesh_shape, self.devices, kernel=spec.kernel,
                overlap=spec.overlap, c2tau2_field=spec.c2tau2_field,
                scheme=spec.scheme, **common)
        elif self.kind == "sharded_kfused":
            res = sharded_kfused.solve_sharded_kfused(
                p, k=self.k, devices=self.devices,
                mesh_shape=self.mesh_shape, c2tau2_field=spec.c2tau2_field,
                **common)
        else:
            res = kfused_comp.solve_kfused_comp_sharded(
                p, k=self.k, block_x=spec.block_x, devices=self.devices,
                v_dtype=spec.v_dtype, carry=spec.carry,
                mesh_shape=self.mesh_shape, c2tau2_field=spec.c2tau2_field,
                **common)
        return (self._state_of(res), res.abs_errors, res.rel_errors,
                res.init_seconds, res.solve_seconds)

    def _state_of(self, res):
        if self.compensated:
            return (res.u_cur, res.comp_v, res.comp_carry)
        return (res.u_prev, res.u_cur)

    # -- chunk runners ---------------------------------------------------

    def _build_runner(self, length: int, state):
        from wavetpu_torch.solver import (
            kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
        )

        spec, p = self.spec, self.problem
        common = dict(dtype=self.dtype, length=length,
                      compute_errors=spec.compute_errors)
        if self.kind == "single1":
            return leapfrog.make_chunk_runner(
                p, device=self.device, kernel=spec.kernel,
                c2tau2_field=spec.c2tau2_field, **common)
        if self.kind == "comp1":
            return leapfrog.make_comp_chunk_runner(
                p, device=self.device, kernel=spec.kernel, **common)
        if self.kind == "kfused":
            return kfused.make_chunk_runner(
                p, k=self.k, c2tau2_field=spec.c2tau2_field,
                device=self.device, **common)
        if self.kind == "kfused_comp":
            return kfused_comp.make_chunk_runner(
                p, k=self.k, block_x=spec.block_x, v_dtype=state[1].dtype,
                carry=self.carry_on, c2tau2_field=spec.c2tau2_field,
                device=self.device, **common)
        if self.kind == "uneven":
            return sharded_kfused.make_chunk_runner(
                p, n_shards=1, k=self.k, devices=self.devices,
                c2tau2_field=spec.c2tau2_field, **common)
        if self.kind == "sharded1":
            return sharded.make_sharded_chunk_runner(
                p, self.mesh_shape, self.devices, kernel=spec.kernel,
                overlap=spec.overlap, c2tau2_field=spec.c2tau2_field,
                scheme=spec.scheme, **common)
        if self.kind == "sharded_kfused":
            return sharded_kfused.make_chunk_runner(
                p, k=self.k, devices=self.devices,
                mesh_shape=self.mesh_shape, c2tau2_field=spec.c2tau2_field,
                **common)
        return kfused_comp.make_sharded_chunk_runner(
            p, self.mesh_shape, self.devices, k=self.k,
            block_x=spec.block_x, v_dtype=state[1].dtype,
            carry=self.carry_on,
            carry_dtype=state[2].dtype if self.carry_on else None,
            c2tau2_field=spec.c2tau2_field, **common)

    def chunk(self, state, start: int, length: int):
        """March layers start+1..start+length through the cached runner;
        returns (state', abs_chunk, rel_chunk, solve_s, build_s)."""
        build_s = 0.0
        if length not in self._runners:
            t0 = time.perf_counter()
            self._runners[length] = self._build_runner(length, state)
            build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = self._runners[length](*state, start)
        n = 3 if self.compensated else 2
        state, (a, r) = tuple(out[:n]), out[n:]
        # The read-back of the chunk's errors (inside the runner) is the
        # synchronisation that closes its time.
        return state, a, r, time.perf_counter() - t0, build_s

    # -- state <-> checkpoints -------------------------------------------

    def health_arrays(self, state):
        return tuple(a for a in state if a is not None)

    def amax(self, state) -> float:
        """The guarded amax of the state over every rank's shards."""
        from wavetpu_torch.comm import dist
        from wavetpu_torch.run import health

        return dist.max_across(health.state_amax(self.health_arrays(state)))

    def _shim_result(self, state, step: int):
        import numpy as np

        from wavetpu_torch.solver.leapfrog import SolveResult

        if self.compensated:
            u, v, c = state
            u_prev = _difference(u, v)
            comp_v, comp_carry = v, c
        else:
            u_prev, u = state
            comp_v = comp_carry = None
        z = np.zeros((0,))
        return SolveResult(
            problem=self.problem, u_prev=u_prev, u_cur=u,
            abs_errors=z, rel_errors=z, final_step=step,
            comp_v=comp_v, comp_carry=comp_carry,
        )

    def save(self, rot: CheckpointRotation, state, step: int) -> str:
        from wavetpu_torch.io import checkpoint

        res = self._shim_result(state, step)
        if self.saves_directory:
            return rot.save(
                lambda p: checkpoint.save_sharded_checkpoint(p, res),
                step, directory=True)
        return rot.save(lambda p: checkpoint.save_checkpoint(p, res), step,
                        directory=False)

    def load(self, path: str):
        """Reload a rotation entry -> (prepared state, step)."""
        from wavetpu_torch.io import checkpoint

        if os.path.isdir(path):
            _, u_prev, u_cur, step, _, _, aux = (
                checkpoint.load_sharded_checkpoint(path, self.devices))
            if self.compensated:
                v, c = aux
                state = (u_cur, v, c if self.carry_on else None)
            else:
                state = (u_prev, u_cur)
        else:
            _, u_prev, u_cur, step = checkpoint.load_checkpoint(path)
            if self.compensated:
                v, c = checkpoint.load_checkpoint_aux(path)
                state = (u_cur, v, c if self.carry_on else None)
            else:
                state = (u_prev, u_cur)
        return self.prepare(state), step

    def prepare(self, state):
        """Device placement and dtype normalization of an injected state
        (a loaded checkpoint), as the resume entry points do: the state
        dtype for u (and, on the 1-step compensated scheme, v and the
        carry); the k-fused flagship keeps v's stored dtype and a valid
        carry dtype (`kfused_comp._normalize_carry`).  Sharded state
        (ShardedArrays, or padded global arrays) goes to the runners,
        which place it on the mesh."""
        from wavetpu_torch.io import state as state_io
        from wavetpu_torch.solver.kfused_comp import _normalize_carry

        if self.saves_directory:
            return tuple(None if a is None else state_io.as_tensor(a)
                         for a in state)

        def place(a, dtype=None):
            a = state_io.as_tensor(a)
            if hasattr(a, "blocks"):          # the uneven route's state
                a = a.fundamental(self.device)
            return a.to(device=self.device,
                        dtype=dtype or a.dtype).contiguous()

        if self.compensated:
            u, v, c = state
            if self.k > 1:
                c = None if c is None else place(
                    _normalize_carry(state_io.as_tensor(c), self.dtype))
                return (place(u, self.dtype), place(v), c)
            return tuple(place(a, self.dtype) for a in (u, v, c))
        return tuple(place(a, self.dtype) for a in state)

    def to_result(self, state, abs_full, rel_full, final_step: int,
                  init_s: float, solve_s: float, marched: int):
        import torch

        from wavetpu_torch.solver.leapfrog import SolveResult

        if state is None:
            # Watchdog trip before any checkpoint existed: no good state
            # to report; a zero field marks "nothing survived".
            z = torch.zeros((self.problem.N,) * 3, dtype=self.dtype,
                            device=self.device)
            state = (z, z, z) if self.compensated else (z, z)
        shim = self._shim_result(state, final_step)
        return SolveResult(
            problem=self.problem, u_prev=shim.u_prev, u_cur=shim.u_cur,
            abs_errors=abs_full, rel_errors=rel_full,
            init_seconds=init_s, solve_seconds=solve_s,
            steps_computed=max(marched, 0) or None,
            final_step=final_step,
            comp_v=shim.comp_v, comp_carry=shim.comp_carry,
        )


def _difference(u, v):
    """u - v in the compute dtype, rounded to u's dtype (the compensated
    state's u_prev), for tensors and ShardedArrays."""
    import dataclasses as dc

    from wavetpu_torch.kernels.stencil_ref import compute_dtype

    def diff(a, b):
        f = compute_dtype(a.dtype)
        return (a.to(f) - b.to(f)).to(a.dtype)

    if hasattr(u, "blocks"):
        return dc.replace(u, blocks=[diff(a, b)
                                     for a, b in zip(u.blocks, v.blocks)])
    return diff(u, v)


# ------------------------------------------------------------ supervise


def chunk_length(ckpt_every: int, fuse_steps: int) -> int:
    """The supervised chunk length: `ckpt_every` snapped DOWN to a multiple
    of the k-fusion block (min one block), so every chunk boundary lands on
    the uninterrupted march's block grid and the supervised trajectory
    stays bitwise identical."""
    if ckpt_every < 1:
        raise ValueError(f"ckpt_every must be >= 1, got {ckpt_every}")
    k = max(1, fuse_steps)
    return max(k, (ckpt_every // k) * k)


def _record_chunk_compile(problem, spec: PathSpec, paid: dict,
                          path: _Path) -> None:
    """A compile-ledger line for a chunk that built or loaded a kernel
    library (no-op without a configured ledger)."""
    from wavetpu_torch.obs import ledger

    if not ledger.enabled() or not (paid["nvcc_runs"] or paid["loads"]):
        return
    try:
        dtype = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}.get(
            str(path.dtype).replace("torch.", ""), "f32")
        ledger.record_compile(ledger.solo_key(
            problem, spec.scheme,
            "kfused" if spec.fuse_steps > 1 else spec.kernel,
            spec.fuse_steps, dtype, spec.c2tau2_field is not None,
            spec.compute_errors,
            mesh=path.mesh_shape if spec.backend == "sharded" else None,
        ), paid["nvcc_seconds"] + paid["load_seconds"]
            + paid["first_launch_seconds"],
            source="fresh" if paid["nvcc_runs"] else "disk")
    except Exception:
        pass  # ledger bookkeeping must never fail the run


def supervise(problem, spec: PathSpec, opts: SupervisorOptions,
              state=None, start_step: Optional[int] = None
              ) -> SupervisedResult:
    """Run (or resume) a solve under supervision; see the module
    docstring.

    `state`/`start_step` inject a loaded checkpoint (the CLI's --resume):
    the supervisor re-enters through the chunk runners and keeps
    checkpointing on its own boundary grid.  Without them the march
    starts from scratch through the ordinary solve."""
    import numpy as np

    from wavetpu_torch.obs import metrics as obs_metrics
    from wavetpu_torch.obs import perf as obs_perf
    from wavetpu_torch.obs import tracing
    from wavetpu_torch.run import faults, health

    c_chunks = obs_metrics.supervisor_counter(
        "chunks_total", "chunk programs executed")
    c_ckpts = obs_metrics.supervisor_counter(
        "checkpoints_total", "rotation entries written")
    c_retries = obs_metrics.supervisor_counter(
        "retries_total", "watchdog auto-retries taken")
    c_trips = obs_metrics.supervisor_counter(
        "watchdog_trips_total", "numerical-health check failures")
    g_step = obs_metrics.supervisor_step_gauge()

    from wavetpu_torch.comm import dist

    path = _Path(problem, spec)
    world = dist.current()
    rot = CheckpointRotation(opts.ckpt_dir, keep=opts.keep,
                             is_main=world is None or world.is_main)
    T = problem.timesteps
    L = chunk_length(opts.ckpt_every, path.k)
    hook = opts.chunk_hook or faults.hook_from_env()
    abs_full = np.zeros((T + 1,), dtype=np.float64)
    rel_full = np.zeros((T + 1,), dtype=np.float64)
    init_s = solve_s = overhead_s = 0.0
    ckpts = 0
    retries_used = 0
    marched = 0
    amax = None
    status = "complete"
    cur: Optional[int] = None

    if state is not None:
        if start_step is None:
            raise ValueError("state injection requires start_step")
        state = path.prepare(state)
        cur = start_step
        if dist.any_across(rot.latest_path() is None):
            # Seed a fresh rotation with the injected state: the retry and
            # watchdog-halt fallbacks reload `latest`, and without this
            # seed a resumed run whose first chunk trips would restart
            # from layer 0 (or halt reporting step 0).
            t0 = time.perf_counter()
            path.save(rot, state, cur)
            ckpts += 1
            c_ckpts.inc()
            overhead_s += time.perf_counter() - t0

    march_span = tracing.begin_span(
        "supervisor.march", n=problem.N, timesteps=T, chunk_length=L,
        solver_kind=path.kind, start_step=0 if cur is None else cur,
    )
    chunk_span = None
    try:
        with _SignalGuard(opts.handle_signals) as sig:
            while True:
                chunk_ran = True
                before = _compile_counts()
                if state is None:
                    length = b = min(T, 1 + L)
                    chunk_span = tracing.begin_span(
                        "supervisor.chunk", start=0, end=b, length=b,
                        first=True)
                    if opts.debug_nans:
                        state, i_s, s_s, _ = _march_checked(
                            path, None, 0, b, abs_full, rel_full,
                            chunk=True)
                    else:
                        state, a, r, i_s, s_s = path.first(b)
                        abs_full[: b + 1] = a
                        rel_full[: b + 1] = r
                    cur = b
                elif cur < T:
                    length = min(L, T - cur)
                    chunk_span = tracing.begin_span(
                        "supervisor.chunk", start=cur, end=cur + length,
                        length=length, first=False)
                    if opts.debug_nans:
                        state, i_s, s_s, _ = _march_checked(
                            path, state, cur, cur + length, abs_full,
                            rel_full, chunk=True)
                    else:
                        state, a, r, s_s, i_s = path.chunk(state, cur,
                                                           length)
                        abs_full[cur + 1: cur + length + 1] = a
                        rel_full[cur + 1: cur + length + 1] = r
                    cur += length
                else:
                    # Injected state already at the target layer: no
                    # chunk ran this iteration.
                    chunk_ran = False
                if chunk_ran:
                    after = _compile_counts()
                    paid = {key: after[key] - before[key] for key in after}
                    tracing.end_span(
                        chunk_span, solve_seconds=round(s_s, 6),
                        compile_seconds=round(i_s, 6),
                        nvcc_runs=paid["nvcc_runs"], loads=paid["loads"],
                        first_launch_seconds=round(
                            paid["first_launch_seconds"], 6))
                    chunk_span = None
                    _record_chunk_compile(problem, spec, paid, path)
                    # Device memory at chunk granularity: an OOM-adjacent
                    # supervised march is seen coming.
                    obs_perf.record_memory(context="supervisor")
                    init_s += i_s
                    solve_s += s_s
                    marched += length
                    c_chunks.inc()
                g_step.set(cur)
                # ---- chunk-boundary bookkeeping at layer `cur` ----
                if hook is not None:
                    state = hook(state, cur)
                    if opts.debug_nans and chunk_ran:
                        # A fault injected at the boundary belongs to the
                        # chunk that ends here (wavetpu's jax_debug_nans
                        # traps the injection itself).
                        _check_finite(path, state, cur - length + 1, cur,
                                      "the supervised chunk's end state")
                t0 = time.perf_counter()
                ok = True
                if opts.watchdog:
                    with tracing.span("supervisor.health", step=cur) as sp:
                        amax = path.amax(state)
                        ok = health.healthy(amax, opts.max_amp)
                        sp["amax"] = amax
                        sp["ok"] = ok
                if not ok:
                    c_trips.inc()
                    latest = rot.latest_path()
                    if retries_used < opts.retries:
                        # Transient-fault model: reload the last-good
                        # checkpoint (or restart from scratch if none yet)
                        # and re-run the tripped chunk.
                        retries_used += 1
                        c_retries.inc()
                        tracing.event(
                            "supervisor.retry", step=cur, amax=amax,
                            retry=retries_used,
                            reload=latest or "from-scratch")
                        if latest is None:
                            state, cur = None, None
                        else:
                            state, cur = path.load(latest)
                        overhead_s += time.perf_counter() - t0
                        continue
                    status = "watchdog"
                    tracing.event("supervisor.watchdog_halt", step=cur,
                                  amax=amax)
                    if latest is not None:
                        state, cur = path.load(latest)
                    else:
                        state, cur = None, 0
                    abs_full[cur + 1:] = 0.0
                    rel_full[cur + 1:] = 0.0
                    overhead_s += time.perf_counter() - t0
                    break
                with tracing.span("supervisor.checkpoint", step=cur) as sp:
                    sp["path"] = path.save(rot, state, cur)
                ckpts += 1
                c_ckpts.inc()
                overhead_s += time.perf_counter() - t0
                if cur >= T:
                    break
                if dist.any_across(sig.triggered is not None):
                    status = "preempted"
                    tracing.event("supervisor.preempted", step=cur,
                                  signal=sig.triggered)
                    abs_full[cur + 1:] = 0.0
                    rel_full[cur + 1:] = 0.0
                    break
    except BaseException as e:
        # A crash mid-march still emits the open chunk/march spans - the
        # telemetry meant to explain it.
        tracing.end_span(chunk_span, error=repr(e))
        tracing.end_span(march_span, status="error", error=repr(e))
        raise
    tracing.end_span(march_span, status=status, final_step=cur or 0,
                     checkpoints=ckpts, retries=retries_used)
    result = path.to_result(state, abs_full, rel_full, cur or 0, init_s,
                            solve_s, marched)
    exit_code = {"complete": EXIT_COMPLETE, "preempted": EXIT_PREEMPTED,
                 "watchdog": EXIT_WATCHDOG}[status]
    return SupervisedResult(
        result=result, status=status, exit_code=exit_code,
        final_step=cur or 0, checkpoint_path=rot.latest_path(),
        checkpoints_written=ckpts, retries_used=retries_used,
        overhead_seconds=overhead_s, amax_last=amax,
    )


def _check_finite(path: _Path, state, first: int, last: int,
                  where: Optional[str] = None) -> None:
    """--debug-nans: raise FloatingPointError naming layers first..last
    when the state holds a non-finite value (the health guard's +inf)."""
    if path.amax(state) == float("inf"):
        where = where or f"the launch that computed layer {last}"
        raise FloatingPointError(
            f"--debug-nans: a non-finite value appeared in layers "
            f"{first}..{last} ({where})")


def _march_checked(path: _Path, state, cur: int, stop: int, abs_full,
                   rel_full, chunk: bool = False):
    """March layers cur+1..stop - from layer 0 when `state` is None - in
    launch-sized chunks (one k-block, or one step) on the production
    march's block grid, each checked by `_check_finite`; the error
    vectors are filled in place.  Returns (state, init_s, solve_s,
    marched).  A non-finite value raises FloatingPointError naming the
    launch's layers and, for a supervised `chunk`, the chunk's."""
    step = max(1, path.k)
    first_layer = cur + 1
    init_s = solve_s = 0.0
    marched = 0

    def check(state, first, last):
        where = (f"the launch that computed layer {last}, in the supervised "
                 f"chunk of layers {first_layer}..{stop}" if chunk else None)
        _check_finite(path, state, first, last, where)

    if state is None:
        cur = min(stop, 1 + step)
        state, a, r, init_s, solve_s = path.first(cur)
        abs_full[: cur + 1], rel_full[: cur + 1] = a, r
        marched = cur
        check(state, 1, cur)
    while cur < stop:
        length = min(step, stop - cur)
        state, a, r, s_s, i_s = path.chunk(state, cur, length)
        abs_full[cur + 1: cur + length + 1] = a
        rel_full[cur + 1: cur + length + 1] = r
        init_s += i_s
        solve_s += s_s
        marched += length
        check(state, cur + 1, cur + length)
        cur += length
    return state, init_s, solve_s, marched


def checked_march(problem, spec: PathSpec, stop_step: Optional[int] = None,
                  state=None, start_step: Optional[int] = None):
    """The CLI's unsupervised --debug-nans: the march - from layer 0, or
    from an injected state at `start_step` - to `stop_step` (default: the
    last layer) through `_march_checked`, so the result is bitwise the
    unchecked run's.  wavetpu's jax_debug_nans traps the first
    NaN-producing op instead; a launch is the finest grain the port can
    see."""
    import numpy as np

    path = _Path(problem, spec)
    stop = problem.timesteps if stop_step is None else stop_step
    abs_full = np.zeros((stop + 1,), dtype=np.float64)
    rel_full = np.zeros((stop + 1,), dtype=np.float64)
    cur = 0
    if state is not None:
        state, cur = path.prepare(state), start_step
    state, init_s, solve_s, marched = _march_checked(
        path, state, cur, stop, abs_full, rel_full)
    return path.to_result(state, abs_full, rel_full, max(cur, stop), init_s,
                          solve_s, marched)
