"""Single-device time-stepping driver (torch port of the single-device core
of wavetpu/solver/leapfrog.py).

Layer 0 is the analytic solution, layer 1 the Taylor half-step derived from
the step function (the exact analytic layer 1 for a shifted `phase`, the
lane identity of the ensembles: ensemble/batched.py), then the leapfrog
march with the per-layer L-inf errors against the separable oracle written
into device vectors - the analog of the reference's
`max_abs_errors.push_back` (mpi_new.cpp:350) with no host round trip
inside the loop.  PyTorch runs eagerly, so the march is a Python
loop that enqueues one K1 launch and a few error reductions per layer; the
only synchronisation is the read-back of the error vectors at the end.

Devices: `device=None` means the CUDA device and raises without one; the
CPU runs only when asked (`device="cpu"`), and then the kernels' plain
versions run (kernels/stencil_cuda.py dispatches on the tensor's device).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.obs import tracing
from wavetpu_torch.solver import phases
from wavetpu_torch.verify import oracle


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare_kernels(device: torch.device, kernel: str = "pallas") -> None:
    """Build and load every CUDA kernel library before any timed region (a
    no-op on the CPU, and where the plain versions run): the nvcc build
    counts as set-up, never as solve time."""
    if device.type == "cuda" and kernel == "pallas":
        stencil_cuda.load_libraries()


def lane_error_fn(problem: Problem, dtype, device):
    """Returns (u, ct) -> (abs_e, rel_e), 0-d device tensors, against the
    analytic field at the time factor `ct` (a 0-d tensor in the compute
    dtype): `_error_fn` with the time factor a runtime argument, so the
    ensemble's lanes (each with its own phase's table) share one spatial
    product.  The oracle evaluates in the compute dtype (f32 for bf16
    state).

    The error interior excludes index 0 on every axis
    (`oracle.interior_masks_1d`), so the errors are taken on the interior
    view u[1:, 1:, 1:] - the same maxima as masking the full field, without
    the masking passes - and the spatial product ((sx*sy)*sz) is formed once
    (times ct per layer, the same multiply order as
    `oracle.analytic_field`).
    """
    f_dtype = stencil_ref.compute_dtype(dtype)
    sx, sy, sz = oracle.spatial_factors(problem, f_dtype, device)
    assert not oracle.interior_masks_1d(problem.N)[0]
    spatial = sx[1:, None, None] * sy[None, 1:, None] * sz[None, None, 1:]

    def errors(u, ct):
        return oracle.layer_errors(u[1:, 1:, 1:].to(f_dtype), spatial * ct)

    return errors


def _error_fn(problem: Problem, dtype, device, phase: float = oracle.TWO_PI):
    """Returns (u, n) -> (abs_e, rel_e) of layer n (`lane_error_fn` over
    the phase's time-factor table)."""
    errors = lane_error_fn(problem, dtype, device)
    ct_table = oracle.time_factor_table(
        problem, stencil_ref.compute_dtype(dtype), device, phase)
    return lambda u, n: errors(u, ct_table[n])


def analytic_layer(problem: Problem, dtype=torch.float32, device=None,
                   phase: float = oracle.TWO_PI, n: int = 0) -> torch.Tensor:
    """The analytic solution at layer n, Dirichlet re-imposed (n=0 is the
    reference's layer-0 fill, openmp_sol.cpp:126-133).  bf16 state
    evaluates in f32 and rounds once."""
    device = resolve_device(device)
    f = stencil_ref.compute_dtype(dtype)
    sx, sy, sz = oracle.spatial_factors(problem, f, device)
    ct = oracle.time_factor(problem, n, f, device, phase)
    u = oracle.analytic_field(sx, sy, sz, ct)
    return stencil_ref.apply_dirichlet(u).to(dtype)


def initial_layer0(problem: Problem, dtype=torch.float32, device=None,
                   phase: float = oracle.TWO_PI) -> torch.Tensor:
    """Layer 0: the analytic solution at t=0."""
    return analytic_layer(problem, dtype, device, phase, 0)


def analytic_increment_layer1(problem: Problem, dtype=torch.float32,
                              device=None,
                              phase: float = oracle.TWO_PI) -> torch.Tensor:
    """The exact analytic layer-0 -> 1 increment Sx Sy Sz (ct(1) - ct(0)),
    Dirichlet re-imposed: the v1 a shifted-phase compensated solve
    bootstraps with.  A pure product (the time factors' difference taken
    first), never u1 - u0, as wavetpu's: the same bits wherever it is
    formed."""
    device = resolve_device(device)
    f = stencil_ref.compute_dtype(dtype)
    sx, sy, sz = oracle.spatial_factors(problem, f, device)
    dct = (oracle.time_factor(problem, 1, f, device, phase)
           - oracle.time_factor(problem, 0, f, device, phase))
    u = oracle.analytic_field(sx, sy, sz, dct)
    return stencil_ref.apply_dirichlet(u).to(dtype)


def check_phase(phase: float, c2tau2_field=None) -> bool:
    """True for a shifted phase (not the reference's 2*pi), which
    bootstraps layer 1 from the analytic solution: refused with a c2
    field, under which no analytic solution exists."""
    shifted = phase != oracle.TWO_PI
    if shifted and c2tau2_field is not None:
        raise ValueError(
            "a shifted phase bootstraps layer 1 from the analytic "
            "solution, which only exists for constant speed; use the "
            "reference phase with c2tau2_field")
    return shifted


def step_layer1(u0, step, problem: Problem, dtype):
    """The step-derived layer 1: u1 = (u0 + step(u0, u0))/2 in the compute
    dtype, the Taylor half-step for any leapfrog-form step (a batch of
    lanes steps through its lane mode alike)."""
    f = stencil_ref.compute_dtype(dtype)
    return (0.5 * (u0.to(f) + step(u0, u0, problem).to(f))).to(dtype)


def initial_state(problem: Problem, dtype=torch.float32,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layers 0 and 1: analytic init + the Taylor half-step (reference
    `calculate_start`, openmp_sol.cpp:123-145) - the standalone form; the
    solvers derive layer 1 from their step function instead."""
    u0 = initial_layer0(problem, dtype, device)
    return u0, stencil_ref.taylor_half_step(u0, problem).to(dtype)


def _march(problem, step, errors, compute_errors, u_prev, u, start, stop,
           abs_all, rel_all):
    """March layers start+1..stop from (layer start-1, layer start), writing
    each layer's errors into the device vectors.  Shared by solve and
    resume, so a resumed run's op sequence is the uninterrupted run's."""
    for n in range(start + 1, stop + 1):
        u_next = step(u_prev, u, problem)
        if compute_errors:
            with tracing.annotate("verify.errors"):
                a, r = errors(u_next, n)
                abs_all[n] = a
                rel_all[n] = r
        u_prev, u = u, u_next
    return u_prev, u


def _zeros(length, dtype, device):
    return torch.zeros(length, dtype=stencil_ref.compute_dtype(dtype),
                       device=device)


def _host(v: torch.Tensor) -> np.ndarray:
    return v.cpu().numpy().astype(np.float64)


def make_solver(
    problem: Problem,
    dtype=torch.float32,
    step_fn: Optional[Callable] = None,
    compute_errors: bool = True,
    stop_step: Optional[int] = None,
    device=None,
    c2tau2_field=None,
    kernel: str = "pallas",
    phase: float = oracle.TWO_PI,
) -> Callable:
    """Set up the standard leapfrog solve - kernels built and loaded, the
    field (once, in the compute dtype) and the oracle tables on the
    device, layer 0 - and return `run()` -> (u_prev, u_cur, abs_all,
    rel_all) with the per-layer error vectors on the device.  The port of
    wavetpu's `make_solver`: `solve` is set-up plus one timed `run()`, so
    a runner built once (the serve layer's chunk bootstrap to
    `stop_step=1`) replays `solve`'s op sequence exactly.

    `step_fn(u_prev, u, problem) -> u_next` defaults to K1
    (`stencil_cuda.leapfrog_step`).  Layer 1 is derived from it -
    u1 = (u0 + step(u0, u0))/2 in the compute dtype, which equals the
    Taylor half-step for any leapfrog-form step.  `c2tau2_field` (a host
    tau^2 c^2 (N,N,N) array, `stencil_ref.make_c2tau2_field`, or a tensor)
    selects the variable-c solve: K5 steps over the field
    (`stencil_cuda.make_step_fn`); it takes no `step_fn` and needs
    compute_errors=False (no analytic oracle for variable c).
    `kernel="roll"` steps with K1's (K5's) plain version on the device.

    `phase` is the analytic solution's initial time phase (the lane
    identity of the ensembles; the default 2*pi is the reference's).  A
    shifted phase has a nonzero initial velocity, which the step-derived
    bootstrap cannot represent, so layer 1 is then the exact analytic
    layer (`analytic_layer(n=1)`); constant speed only.
    """
    analytic = check_phase(phase, c2tau2_field)
    if c2tau2_field is not None and (compute_errors or step_fn is not None):
        raise ValueError(
            "variable-c runs have no analytic oracle and step with K5: pass "
            "compute_errors=False and no step_fn with c2tau2_field"
        )
    device = resolve_device(device)
    step = stencil_cuda.make_step_fn(None, kernel) if step_fn is None \
        else step_fn
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    prepare_kernels(device, kernel)
    if c2tau2_field is not None:
        step = stencil_cuda.make_step_fn(
            state.c2tau2_field(c2tau2_field, dtype, device), kernel)
    errors = _error_fn(problem, dtype, device, phase)
    u0 = initial_layer0(problem, dtype, device, phase)

    def run():
        with phases.bootstrap():
            abs_all = _zeros(nsteps + 1, dtype, device)
            rel_all = _zeros(nsteps + 1, dtype, device)
            u1 = (analytic_layer(problem, dtype, device, phase, 1)
                  if analytic else step_layer1(u0, step, problem, dtype))
            # Layer 0 is assigned from the oracle: its error is 0 by
            # definition.
            if compute_errors:
                with tracing.annotate("verify.errors"):
                    abs_all[1], rel_all[1] = errors(u1, 1)
        with phases.march():
            u_prev, u_cur = _march(problem, step, errors, compute_errors,
                                   u0, u1, 1, nsteps, abs_all, rel_all)
        return u_prev, u_cur, abs_all, rel_all

    return run


def solve(
    problem: Problem,
    dtype=torch.float32,
    step_fn: Optional[Callable] = None,
    compute_errors: bool = True,
    stop_step: Optional[int] = None,
    device=None,
    c2tau2_field=None,
    kernel: str = "pallas",
    phase: float = oracle.TWO_PI,
) -> SolveResult:
    """The standard leapfrog solve with the reference's two timing phases:
    `init_seconds` covers the kernel build/load and the state set-up (layer
    0, the oracle factors, the field: `make_solver`); `solve_seconds`
    brackets the march, from the layer-1 bootstrap to the read-back of the
    error vectors.  The arguments are `make_solver`'s.
    """
    nsteps = problem.timesteps if stop_step is None else stop_step
    with phases.SolveSpans("leapfrog", problem, nsteps) as ph:
        with ph.init():
            run = make_solver(problem, dtype, step_fn, compute_errors,
                              stop_step, device, c2tau2_field, kernel, phase)
            device = resolve_device(device)
            _sync(device)
        u_prev, u_cur, abs_all, rel_all = run()
        with ph.readback():
            abs_np, rel_np = _host(abs_all), _host(rel_all)
            _sync(device)
        result = SolveResult(
            problem=problem, u_prev=u_prev, u_cur=u_cur,
            abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=stop_step,
            final_step=nsteps,
        )
        ph.record(result, with_field=c2tau2_field is not None)
    return result


def _state_in(a, dtype, device) -> torch.Tensor:
    """An injected state array (tensor, or numpy as a wavetpu SolveResult
    or a checkpoint holds it, bf16 included) on `device` in `dtype`."""
    t = a if isinstance(a, torch.Tensor) else state.to_tensor(a, "cpu")
    return t.to(device=device, dtype=dtype).contiguous()


def _check_start(start_step: int, nsteps: int) -> None:
    if not 1 <= start_step <= nsteps:
        raise ValueError(
            f"start_step must be in [1, {nsteps}], got {start_step}"
        )


def _chunk_stop(start: int, length: int, nsteps: int) -> int:
    """The last layer of a chunk of `length` layers after layer `start`,
    checked against the march's layers."""
    _check_start(start, nsteps)
    if start + length > nsteps:
        raise ValueError(f"chunk {start}+{length} passes the last layer "
                         f"{nsteps}")
    return start + length


def _standard_step(step_fn, c2tau2_field, dtype, device, kernel):
    """The 1-step function of a resumed or chunked standard march: K1, K5
    over `c2tau2_field` (placed once, in the compute dtype), or the
    caller's `step_fn`."""
    if step_fn is not None:
        return step_fn
    field = None
    if c2tau2_field is not None:
        field = state.c2tau2_field(c2tau2_field, dtype, device)
    return stencil_cuda.make_step_fn(field, kernel)


def resume(
    problem: Problem,
    u_prev,
    u_cur,
    start_step: int,
    dtype=torch.float32,
    step_fn: Optional[Callable] = None,
    compute_errors: bool = True,
    device=None,
    c2tau2_field=None,
    kernel: str = "pallas",
) -> SolveResult:
    """Re-enter the standard march at layer `start_step` and run to the end.

    `u_prev` / `u_cur` (tensors, or numpy arrays e.g. from a wavetpu
    SolveResult or a checkpoint - see io/state.py) are layers
    start_step-1 / start_step.  The step is K1 (K5 over `c2tau2_field`,
    which needs compute_errors=False; the plain versions with
    kernel="roll") unless `step_fn` is given.  The error vectors cover
    layers start_step+1..timesteps; earlier entries are zero (they belong
    to the run that produced the state).
    """
    if c2tau2_field is not None and compute_errors:
        raise ValueError(
            "variable-c runs have no analytic oracle; pass "
            "compute_errors=False with c2tau2_field"
        )
    device = resolve_device(device)
    nsteps = problem.timesteps
    _check_start(start_step, nsteps)
    with phases.SolveSpans("leapfrog", problem, nsteps - start_step) as ph:
        with ph.init():
            prepare_kernels(device, kernel)
            step = _standard_step(step_fn, c2tau2_field, dtype, device,
                                  kernel)
            errors = _error_fn(problem, dtype, device)
            u_p = _state_in(u_prev, dtype, device)
            u_c = _state_in(u_cur, dtype, device)
            abs_all = _zeros(nsteps + 1, dtype, device)
            rel_all = _zeros(nsteps + 1, dtype, device)
            _sync(device)
        with phases.march():
            u_p, u_c = _march(problem, step, errors, compute_errors, u_p,
                              u_c, start_step, nsteps, abs_all, rel_all)
        with ph.readback():
            abs_np, rel_np = _host(abs_all), _host(rel_all)
            _sync(device)
        result = SolveResult(
            problem=problem, u_prev=u_p, u_cur=u_c,
            abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=nsteps - start_step, final_step=nsteps,
        )
        ph.record(result, with_field=c2tau2_field is not None)
    return result


def make_chunk_runner(
    problem: Problem,
    dtype=torch.float32,
    length: int = 1,
    step_fn: Optional[Callable] = None,
    compute_errors: bool = True,
    device=None,
    c2tau2_field=None,
    kernel: str = "pallas",
):
    """Fixed-length re-entry of the standard march for supervised solves
    (run/supervisor.py), built once per configuration: the kernels built
    and loaded, the oracle tables and the field on the device.

    Returns `runner(u_prev, u_cur, start)` -> (u_prev, u_cur, abs, rel):
    layers start+1..start+length from the state at layer `start`, given
    when the runner runs, with the chunk's per-layer errors as host f64
    arrays of `length` entries.  The march is `resume`'s (`_march`), so
    chunked layers are bitwise the uninterrupted march's."""
    if length < 1:
        raise ValueError(f"chunk length must be >= 1, got {length}")
    if c2tau2_field is not None and compute_errors:
        raise ValueError(
            "variable-c runs have no analytic oracle; pass "
            "compute_errors=False with c2tau2_field"
        )
    device = resolve_device(device)
    prepare_kernels(device, kernel)
    step = _standard_step(step_fn, c2tau2_field, dtype, device, kernel)
    errors = _error_fn(problem, dtype, device)
    nsteps = problem.timesteps

    def run(u_prev, u_cur, start: int):
        stop = _chunk_stop(start, length, nsteps)
        abs_all = _zeros(nsteps + 1, dtype, device)
        rel_all = _zeros(nsteps + 1, dtype, device)
        u_p, u_c = _march(problem, step, errors, compute_errors,
                          _state_in(u_prev, dtype, device),
                          _state_in(u_cur, dtype, device), start, stop,
                          abs_all, rel_all)
        return (u_p, u_c, _host(abs_all[start + 1:stop + 1]),
                _host(rel_all[start + 1:stop + 1]))

    return run


def solve_compensated(
    problem: Problem,
    dtype=torch.float32,
    comp_step_fn: Optional[Callable] = None,
    compute_errors: bool = True,
    stop_step: Optional[int] = None,
    device=None,
    kernel: str = "pallas",
    phase: float = oracle.TWO_PI,
) -> SolveResult:
    """The 1-step compensated (Kahan) solve: layer 1 is the same step with
    v = carry = 0 and coeff = a2tau2/2; `comp_step_fn(u, v, carry, problem,
    coeff)` defaults to K2 (`stencil_cuda.compensated_step`; its plain
    version with kernel="roll").  bf16 state is refused (its
    representation error dwarfs what compensation recovers).  A shifted
    `phase` (as `solve`) starts from the exact analytic layers: u1
    analytic, v1 `analytic_increment_layer1`, a zero carry.
    """
    analytic = check_phase(phase)
    if dtype == torch.bfloat16:
        raise ValueError(
            "compensated scheme requires f32/f64 state (bf16 representation "
            "error dominates anything the compensation recovers)"
        )
    device = resolve_device(device)
    step = (stencil_cuda.make_compensated_step_fn(kernel)
            if comp_step_fn is None else comp_step_fn)
    nsteps = problem.timesteps if stop_step is None else stop_step
    if not 1 <= nsteps <= problem.timesteps:
        raise ValueError(
            f"stop_step must be in [1, {problem.timesteps}], got {nsteps}"
        )
    with phases.SolveSpans("compensated", problem, nsteps) as ph:
        with ph.init():
            prepare_kernels(device, kernel)
            errors = _error_fn(problem, dtype, device, phase)
            u0 = initial_layer0(problem, dtype, device, phase)
            zero = torch.zeros_like(u0)
            abs_all = _zeros(nsteps + 1, dtype, device)
            rel_all = _zeros(nsteps + 1, dtype, device)
            _sync(device)
        with phases.bootstrap():
            if analytic:
                u = analytic_layer(problem, dtype, device, phase, 1)
                v = analytic_increment_layer1(problem, dtype, device, phase)
                c = zero
            else:
                u, v, c = step(u0, zero, zero, problem,
                               0.5 * problem.a2tau2)
            if compute_errors:
                with tracing.annotate("verify.errors"):
                    abs_all[1], rel_all[1] = errors(u, 1)
        with phases.march():
            u, v, c = _comp_march(problem, step, errors, compute_errors, u,
                                  v, c, 1, nsteps, abs_all, rel_all)
        with ph.readback():
            abs_np, rel_np = _host(abs_all), _host(rel_all)
            _sync(device)
        result = SolveResult(
            problem=problem, u_prev=u - v, u_cur=u,
            abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=stop_step, final_step=nsteps,
            comp_v=v, comp_carry=c,
        )
        ph.record(result, scheme="compensated")
    return result


def _comp_march(problem, step, errors, compute_errors, u, v, c, start, stop,
                abs_all, rel_all):
    """March the 1-step compensated scheme over layers start+1..stop from
    (u, v, carry) at layer start.  Shared by solve_compensated's march,
    resume_compensated and the chunk runner, so their op sequences are one
    another's."""
    for n in range(start + 1, stop + 1):
        u, v, c = step(u, v, c, problem, None)
        if compute_errors:
            with tracing.annotate("verify.errors"):
                abs_all[n], rel_all[n] = errors(u, n)
    return u, v, c


def _comp_state_in(u_cur, v, carry, dtype, device):
    """(u, v, carry) of an injected compensated state in the state dtype:
    the 1-step scheme carries v and the carry in it (wavetpu's
    unconditional cast)."""
    if dtype == torch.bfloat16:
        raise ValueError("compensated scheme requires f32/f64 state")
    return tuple(_state_in(a, dtype, device) for a in (u_cur, v, carry))


def resume_compensated(
    problem: Problem,
    u_cur,
    v,
    carry,
    start_step: int,
    dtype=torch.float32,
    comp_step_fn: Optional[Callable] = None,
    compute_errors: bool = True,
    device=None,
    kernel: str = "pallas",
) -> SolveResult:
    """Re-enter the 1-step compensated march at layer `start_step` from
    the full compensated state a checkpoint stores (u_cur, the increment
    v and the Kahan carry); the per-step op sequence equals an
    uninterrupted run's, so the final state is bitwise equal.  The step is
    K2 (its plain version with kernel="roll") unless `comp_step_fn` is
    given."""
    device = resolve_device(device)
    nsteps = problem.timesteps
    _check_start(start_step, nsteps)
    step = (stencil_cuda.make_compensated_step_fn(kernel)
            if comp_step_fn is None else comp_step_fn)
    with phases.SolveSpans("compensated", problem,
                           nsteps - start_step) as ph:
        with ph.init():
            prepare_kernels(device, kernel)
            errors = _error_fn(problem, dtype, device)
            u, vv, c = _comp_state_in(u_cur, v, carry, dtype, device)
            abs_all = _zeros(nsteps + 1, dtype, device)
            rel_all = _zeros(nsteps + 1, dtype, device)
            _sync(device)
        with phases.march():
            u, vv, c = _comp_march(problem, step, errors, compute_errors, u,
                                   vv, c, start_step, nsteps, abs_all,
                                   rel_all)
        with ph.readback():
            abs_np, rel_np = _host(abs_all), _host(rel_all)
            _sync(device)
        result = SolveResult(
            problem=problem, u_prev=u - vv, u_cur=u,
            abs_errors=abs_np, rel_errors=rel_np,
            init_seconds=ph.init_seconds, solve_seconds=ph.solve_seconds,
            steps_computed=nsteps - start_step, final_step=nsteps,
            comp_v=vv, comp_carry=c,
        )
        ph.record(result, scheme="compensated")
    return result


def make_comp_chunk_runner(
    problem: Problem,
    dtype=torch.float32,
    length: int = 1,
    comp_step_fn: Optional[Callable] = None,
    compute_errors: bool = True,
    device=None,
    kernel: str = "pallas",
):
    """The compensated counterpart of `make_chunk_runner`:
    `runner(u, v, carry, start)` -> (u, v, carry, abs, rel) marches
    `length` layers from the compensated state at layer `start` through
    `resume_compensated`'s march."""
    if length < 1:
        raise ValueError(f"chunk length must be >= 1, got {length}")
    device = resolve_device(device)
    step = (stencil_cuda.make_compensated_step_fn(kernel)
            if comp_step_fn is None else comp_step_fn)
    prepare_kernels(device, kernel)
    errors = _error_fn(problem, dtype, device)
    nsteps = problem.timesteps

    def run(u_cur, v, carry, start: int):
        stop = _chunk_stop(start, length, nsteps)
        abs_all = _zeros(nsteps + 1, dtype, device)
        rel_all = _zeros(nsteps + 1, dtype, device)
        u, vv, c = _comp_march(problem, step, errors, compute_errors,
                               *_comp_state_in(u_cur, v, carry, dtype,
                                               device),
                               start, stop, abs_all, rel_all)
        return (u, vv, c, _host(abs_all[start + 1:stop + 1]),
                _host(rel_all[start + 1:stop + 1]))

    return run


def solve_history(problem: Problem, dtype=torch.float64,
                  device=None) -> np.ndarray:
    """Full time history (timesteps+1, N, N, N) - the openmp_sol storage
    model (every layer kept, errors post hoc; openmp_sol.cpp:216-219,
    169-190).  Layers 0 and 1 are `initial_state`'s, the march
    `stencil_ref.leapfrog_step`'s.  For parity testing and small-N
    debugging; O(T * N^3) memory."""
    device = resolve_device(device)
    u_prev, u = initial_state(problem, dtype, device)
    layers = [u_prev, u]
    for _ in range(problem.timesteps - 1):
        u_prev, u = u, stencil_ref.leapfrog_step(u_prev, u, problem)
        layers.append(u)
    return torch.stack(layers).cpu().numpy()


def to_reference_grid(u) -> np.ndarray:
    """Expand a fundamental-domain (N,N,N) field to the reference's
    (N+1)^3: the duplicated periodic seam plane x=N (= x=0) and the zero
    Dirichlet planes y=N, z=N re-attached, giving index-for-index
    comparability with the reference's `Grid` layout
    (openmp_sol.cpp:44-50)."""
    u = u.cpu().numpy() if isinstance(u, torch.Tensor) else np.asarray(u)
    n = u.shape[0]
    out = np.zeros((n + 1, n + 1, n + 1), dtype=u.dtype)
    out[:n, :n, :n] = u
    out[n, :n, :n] = u[0]
    return out
