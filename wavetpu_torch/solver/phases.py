"""The solver layer's timed-call protocol: the phases of a solver call as
spans that also give its timings, the read-back, the result, its record
and the chunked re-entry, behind three functions.

Every timed solver entry point (`leapfrog.solve`, `resume`,
`solve_compensated`, `resume_compensated`, `kfused.solve_kfused`,
`resume_kfused`, the `kfused_comp` and `sharded*` solves and resumes)
runs through `timed_solve` or `timed_resume`, inside one `SolveSpans`:

    solver.solve       path, N, steps, k
      solver.init        kernels loaded, oracle tables, state on the
                         device, up to a device synchronisation
      solver.bootstrap   layer 1 and its error row (entries that start
                         at layer 0; `from_layer0`)
      solver.march       the layers after it
      solver.readback    the error vectors to the host and the final
                         synchronisation
      obs.record_solve   the solve's counters and gauges (obs/metrics.py)

and every supervised chunk (`make_*chunk_runner`) through `chunk_runner`.
A march family supplies only what is its own, as `Parts` built by its
set-up inside solver.init: the march, how a state comes in, its error
holders, how they and the state come back to the host.  Where the error
holders are allocated is the family's: `from_layer0` allocates them at
the start of solver.bootstrap, a set-up that allocates them itself does
so in solver.init.

`init_seconds` is solver.init's duration and `solve_seconds` runs from
its end to the end of solver.readback: the reference's two timing phases,
taken from the spans' own clock readings (obs/tracing.TimedSpan), so a
JSONL record's `dur_s` and the SolveResult agree.  The spans are host
time and add no synchronisation: in a profiler's trace the device work
of a phase is the work its host span launched (launch correlation).
With neither a tracer nor a recording profiler a span costs a flag read.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state as state_io
from wavetpu_torch.kernels import stencil_ref
from wavetpu_torch.obs import metrics as obs_metrics
from wavetpu_torch.obs import tracing


@dataclasses.dataclass
class SolveResult:
    problem: Problem
    u_prev: torch.Tensor       # layer final_step-1 (fundamental (N,N,N) domain)
    u_cur: torch.Tensor        # layer final_step
    abs_errors: np.ndarray     # per-layer L-inf abs error, shape (timesteps+1,)
    rel_errors: np.ndarray     # per-layer L-inf rel error, shape (timesteps+1,)
    init_seconds: float = 0.0
    solve_seconds: float = 0.0
    steps_computed: Optional[int] = None  # steps THIS run marched (throughput)
    final_step: Optional[int] = None      # layer index u_cur holds
    # Compensated-scheme state (None on the standard scheme): the increment
    # v = u_n - u_{n-1} and the Kahan carry at final_step.
    comp_v: Optional[torch.Tensor] = None
    comp_carry: Optional[torch.Tensor] = None

    @property
    def gcells_per_second(self) -> float:
        """(N+1)^3 cell updates per step (the reference's grid-point count,
        `Problem.cells_per_step`) over the solve wall time."""
        steps = (
            self.steps_computed
            if self.steps_computed is not None
            else self.problem.timesteps
        )
        total = self.problem.cells_per_step * steps
        return total / self.solve_seconds / 1e9 if self.solve_seconds else 0.0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another.  Without a CUDA device, `None` raises - the port never
    carries on on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: wavetpu_torch runs on the GPU unless asked "
                "for the CPU (device='cpu', or --platform cpu on the CLI)"
            )
        return torch.device("cuda")
    return torch.device(device)


def resolve_devices(devices=None) -> List[torch.device]:
    """The devices of a mesh: as given (a device may repeat), or every
    visible card - raising without one, as `resolve_device`."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def sync(*devices) -> None:
    """Wait for every CUDA device among `devices` (a mesh's list may name
    one more than once), each once, in name order."""
    for dev in sorted({d for d in devices if d.type == "cuda"}, key=str):
        torch.cuda.synchronize(dev)


def host(v: torch.Tensor) -> np.ndarray:
    """A device vector read back as a host f64 array."""
    return v.cpu().numpy().astype(np.float64)


def state_in(a, dtype, device) -> torch.Tensor:
    """An injected state array (tensor, or numpy as a wavetpu SolveResult
    or a checkpoint holds it, bf16 included) on `device` in `dtype`."""
    t = a if isinstance(a, torch.Tensor) else state_io.to_tensor(a, "cpu")
    return t.to(device=device, dtype=dtype).contiguous()


def last_layer(problem: Problem, stop_step: Optional[int]) -> int:
    """The layer a solve stops at: `stop_step`, default the last."""
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    return nsteps


def check_start(start_step: int, nsteps: int) -> None:
    if not 1 <= start_step <= nsteps:
        raise ValueError(
            f"start_step must be in [1, {nsteps}], got {start_step}"
        )


@dataclasses.dataclass
class Parts:
    """A march family's own parts, built by its set-up, which
    `timed_solve`, `timed_resume` and `chunk_runner` run, time, read back
    and wrap:

      run()                 -> (state, errs): layers 0..nsteps (solves)
      march(state, start, stop, errs) -> (state, errs): layers
                               start+1..stop
      state_in(*arrays)     -> an injected state on the march's devices
      vectors()             -> zeroed per-layer error holders, or None
                               where `march` makes its own
      host(errs, sl=None)   -> (abs, rel): host f64 arrays of the layers
                               `sl` (None: all)
      fields(state)         -> the SolveResult's u_prev, u_cur, comp_v and
                               comp_carry
      out(state)            -> the state a chunk runner returns
      sync()                   waits for the march's devices
      record                   `record_solve` keywords known only after
                               set-up
    """

    host: Callable
    sync: Callable
    fields: Optional[Callable] = None
    run: Optional[Callable] = None
    march: Optional[Callable] = None
    state_in: Optional[Callable] = None
    vectors: Callable = lambda: None
    out: Callable = tuple
    record: dict = dataclasses.field(default_factory=dict)


def on_device(device: torch.device, dtype, nsteps: int, **parts) -> Parts:
    """The `Parts` of a single-device march: two error vectors of nsteps+1
    layers in the compute dtype, each read back as the slice asked for,
    and `device`'s synchronisation."""
    f = stencil_ref.compute_dtype(dtype)

    def vectors():
        return (torch.zeros(nsteps + 1, dtype=f, device=device),
                torch.zeros(nsteps + 1, dtype=f, device=device))

    def read(errs, sl=None):
        if sl is None:
            return host(errs[0]), host(errs[1])
        return host(errs[0][sl]), host(errs[1][sl])

    return Parts(vectors=vectors, host=read, sync=lambda: sync(device),
                 **parts)


def from_layer0(bootstrap: Callable, march: Callable, nsteps: int,
                vectors: Callable) -> Callable:
    """`run()` -> (state, errs) of a solve from layer 0: `errs =
    vectors()` and `bootstrap(errs)` -> the state at layer 1 inside
    solver.bootstrap, then `march(state, 1, nsteps, errs)` inside
    solver.march."""
    def run():
        with tracing.span("solver.bootstrap"):
            errs = vectors()
            st = bootstrap(errs)
        with tracing.span("solver.march"):
            return march(st, 1, nsteps, errs)

    return run


class SolveSpans:
    """`with SolveSpans(path, problem, steps, k) as ph:` around a solver
    call; `with ph.init():` and `with ph.readback():` around those phases,
    then `ph.init_seconds`, `ph.solve_seconds` and `ph.record(result,
    **config)`."""

    def __init__(self, path: str, problem, steps: int, k: int = 1):
        self.path = path
        self._solve = tracing.TimedSpan("solver.solve", path=path,
                                        N=problem.N, steps=steps, k=k)
        self._init = tracing.TimedSpan("solver.init")
        self._readback = tracing.TimedSpan("solver.readback")

    def __enter__(self):
        self._solve.__enter__()
        return self

    def __exit__(self, *exc):
        return self._solve.__exit__(*exc)

    def init(self) -> tracing.TimedSpan:
        return self._init

    def readback(self) -> tracing.TimedSpan:
        return self._readback

    @property
    def init_seconds(self) -> float:
        return self._init.seconds

    @property
    def solve_seconds(self) -> float:
        return self._readback.t1 - self._init.t1

    def record(self, result, **config) -> None:
        """`obs_metrics.record_solve` of the result under this call's path,
        in its span."""
        with tracing.span("obs.record_solve"):
            obs_metrics.record_solve(result, self.path, **config)


def _timed(path, problem, steps, k, begin, steps_computed, final_step,
           record, head=0) -> SolveResult:
    """One timed call: `begin()` -> (parts, run) inside solver.init, then
    `run()` -> (state, errs), the read-back of errs in solver.readback,
    the result and its record.  Error entries before layer `head` + 1
    belong to another run and read 0."""
    if k is not None:
        record = dict(record, k=k)
    with SolveSpans(path, problem, steps, k or 1) as ph:
        with ph.init():
            parts, run = begin()
            parts.sync()
        st, errs = run()
        with ph.readback():
            abs_np, rel_np = parts.host(errs)
            parts.sync()
        if head:
            abs_np[:head + 1] = 0.0
            rel_np[:head + 1] = 0.0
        result = SolveResult(
            problem=problem, abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=steps_computed, final_step=final_step,
            **parts.fields(st))
        ph.record(result, **record, **parts.record)
    return result


def timed_solve(path: str, problem: Problem, stop_step: Optional[int],
                setup: Callable, k: Optional[int] = None,
                **record) -> SolveResult:
    """A solve from layer 0 to `stop_step` (default the last) with the
    reference's timing phases: `setup()` -> `Parts` with `run` inside
    solver.init, its run timed.  `record` holds the path's `record_solve`
    keywords; a k-fused path's depth `k` joins them."""
    nsteps = problem.timesteps if stop_step is None else stop_step

    def begin():
        parts = setup()
        return parts, parts.run

    return _timed(path, problem, nsteps, k, begin, stop_step, nsteps,
                  record)


def timed_resume(path: str, problem: Problem, start_step: int,
                 setup: Callable, arrays, k: Optional[int] = None,
                 **record) -> SolveResult:
    """The march re-entered at layer `start_step` and run to the last
    layer, timed as a solve: `setup()` -> `Parts` inside solver.init,
    where the injected `arrays` come in and the error holders are
    allocated; the march runs inside solver.march.  The error vectors
    are zero up to start_step.  `record` and `k` as `timed_solve`'s."""
    nsteps = problem.timesteps

    def begin():
        parts = setup()
        st = parts.state_in(*arrays)
        errs = parts.vectors()

        def run():
            with tracing.span("solver.march"):
                return parts.march(st, start_step, nsteps, errs)

        return parts, run

    return _timed(path, problem, nsteps - start_step, k, begin,
                  nsteps - start_step, nsteps, record, head=start_step)


def chunk_runner(problem: Problem, length: int, setup: Callable):
    """Fixed-length re-entry of a march for supervised solves
    (run/supervisor.py), set up once (`setup()` -> `Parts`):
    `runner(*arrays, start)` -> (*state, abs, rel) marches layers
    start+1..start+length from the injected state at layer `start` -
    the resume's march, so chunked layers are the uninterrupted march's -
    with the chunk's per-layer errors as host f64 arrays of `length`
    entries."""
    if length < 1:
        raise ValueError(f"chunk length must be >= 1, got {length}")
    parts = setup()
    nsteps = problem.timesteps

    def run(*args):
        *arrays, start = args
        check_start(start, nsteps)
        if start + length > nsteps:
            raise ValueError(f"chunk {start}+{length} passes the last layer "
                             f"{nsteps}")
        stop = start + length
        st = parts.state_in(*arrays)
        st, errs = parts.march(st, start, stop, parts.vectors())
        return tuple(parts.out(st)) + parts.host(errs,
                                                 slice(start + 1, stop + 1))

    return run
