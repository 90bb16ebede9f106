"""Single-device time-stepping driver (torch port of the single-device core
of wavetpu/solver/leapfrog.py).

Layer 0 is the analytic solution, layer 1 the Taylor half-step derived from
the step function (the exact analytic layer 1 for a shifted `phase`, the
lane identity of the ensembles: ensemble/batched.py), then the leapfrog
march with the per-layer L-inf errors against the separable oracle written
into device vectors - the analog of the reference's
`max_abs_errors.push_back` (mpi_new.cpp:350) with no host round trip
inside the loop.  PyTorch runs eagerly, so the march is a Python
loop that enqueues one K1 launch and one launch of the error pass per
layer (`stencil_cuda.layer_errors`, which writes the layer's two maxima
into their slots); the only synchronisation is the read-back of the
error vectors at the end.

Devices: `device=None` means the CUDA device and raises without one; the
CPU runs only when asked (`device="cpu"`), and then the kernels' plain
versions run (kernels/stencil_cuda.py dispatches on the tensor's device).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.obs import tracing
from wavetpu_torch.solver import phases
from wavetpu_torch.solver.phases import (  # noqa: F401 (the solver API)
    SolveResult, resolve_device, resolve_devices,
)
from wavetpu_torch.verify import oracle


def prepare_kernels(device: torch.device, kernel: str = "pallas") -> None:
    """Build and load every CUDA kernel library before any timed region (a
    no-op on the CPU, and where the plain versions run): the nvcc build
    counts as set-up, never as solve time."""
    if device.type == "cuda" and kernel == "pallas":
        stencil_cuda.load_libraries()


def lane_error_fn(problem: Problem, dtype, device, kernel: str = "pallas"):
    """Returns (u, ct, out=None) -> (abs_e, rel_e), 0-d device tensors,
    against the analytic field at the time factor `ct` (a 0-d tensor in
    the compute dtype): `error_fn` with the time factor a runtime
    argument, so the ensemble's lanes (each with its own phase's table)
    share one set of factors.  The oracle evaluates in the compute dtype
    (f32 for bf16 state).  `out` = (abs slot, rel slot), 0-d views of
    zeroed error vectors (`abs_all[n]`), takes the maxima in place.

    The error interior excludes index 0 on every axis
    (`oracle.interior_masks_1d`), so the errors are taken on the interior
    view u[1:, 1:, 1:] against the factors' [1:] slices - the same maxima
    as masking the full field, without the masking passes.  On the card
    that is one launch of the error kernel (`stencil_cuda.layer_errors`),
    which forms ((sx*sy)*sz)*ct in registers (`oracle.analytic_field`'s
    multiply order); on the CPU, and with kernel="roll", its plain version.
    """
    f_dtype = stencil_ref.compute_dtype(dtype)
    sx, sy, sz = (a[1:] for a in
                  oracle.spatial_factors(problem, f_dtype, device))
    assert not oracle.interior_masks_1d(problem.N)[0]
    fn = stencil_cuda.make_layer_errors_fn(kernel)

    def errors(u, ct, out=None):
        return fn(u[1:, 1:, 1:], sx, sy, sz, ct, out)

    return errors


def error_fn(problem: Problem, dtype, device, phase: float = oracle.TWO_PI,
             kernel: str = "pallas"):
    """Returns (u, n, out=None) -> (abs_e, rel_e) of layer n
    (`lane_error_fn` over the phase's time-factor table)."""
    errors = lane_error_fn(problem, dtype, device, kernel)
    ct_table = oracle.time_factor_table(
        problem, stencil_ref.compute_dtype(dtype), device, phase)
    return lambda u, n, out=None: errors(u, ct_table[n], out)


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


def march_layers(problem, step, errors, compute_errors, u_prev, u, start,
                 stop, abs_all, rel_all):
    """March layers start+1..stop from (layer start-1, layer start), writing
    each layer's errors into the device vectors' slots.  Shared by solve
    and resume, so a resumed run's op sequence is the uninterrupted run's."""
    for n in range(start + 1, stop + 1):
        u_next = step(u_prev, u, problem)
        if compute_errors:
            with tracing.annotate("verify.errors"):
                errors(u_next, n, (abs_all[n], rel_all[n]))
        u_prev, u = u, u_next
    return u_prev, u


def _march_fn(problem, step, errors, compute_errors):
    """`march_layers` as a `phases.Parts` march over (u_prev, u_cur)."""
    def march(st, start, stop, errs):
        return march_layers(problem, step, errors, compute_errors, *st,
                            start, stop, *errs), errs

    return march


def standard_parts(march, dtype, device, nsteps: int) -> phases.Parts:
    """The `phases.Parts` of a standard march on `device` (the 1-step
    march's, kfused's): `march` over the state (u_prev, u_cur), error
    vectors of nsteps+1 layers."""
    return phases.on_device(
        device, dtype, nsteps, march=march,
        state_in=lambda u_prev, u_cur: (
            phases.state_in(u_prev, dtype, device),
            phases.state_in(u_cur, dtype, device)),
        fields=lambda st: dict(u_prev=st[0], u_cur=st[1]))


def _solver(problem, dtype, step_fn, compute_errors, stop_step, device,
            c2tau2_field, kernel, phase) -> phases.Parts:
    """`make_solver`'s set-up, as `phases.Parts` with the solve's `run`."""
    analytic = check_phase(phase, c2tau2_field)
    if c2tau2_field is not None and (compute_errors or step_fn is not None):
        raise ValueError(
            "variable-c runs have no analytic oracle and step with K5: pass "
            "compute_errors=False and no step_fn with c2tau2_field"
        )
    device = resolve_device(device)
    step = stencil_cuda.make_step_fn(None, kernel) if step_fn is None \
        else step_fn
    nsteps = phases.last_layer(problem, stop_step)
    prepare_kernels(device, kernel)
    if c2tau2_field is not None:
        step = stencil_cuda.make_step_fn(
            state.c2tau2_field(c2tau2_field, dtype, device), kernel)
    errors = error_fn(problem, dtype, device, phase, kernel)
    u0 = initial_layer0(problem, dtype, device, phase)
    parts = standard_parts(_march_fn(problem, step, errors, compute_errors),
                           dtype, device, nsteps)

    def bootstrap(errs):
        u1 = (analytic_layer(problem, dtype, device, phase, 1)
              if analytic else step_layer1(u0, step, problem, dtype))
        # Layer 0 is assigned from the oracle: its error is 0 by
        # definition.
        if compute_errors:
            with tracing.annotate("verify.errors"):
                errors(u1, 1, (errs[0][1], errs[1][1]))
        return u0, u1

    parts.run = phases.from_layer0(bootstrap, parts.march, nsteps,
                                   parts.vectors)
    return parts


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
    run = _solver(problem, dtype, step_fn, compute_errors, stop_step, device,
                  c2tau2_field, kernel, phase).run

    def runner():
        (u_prev, u_cur), (abs_all, rel_all) = run()
        return u_prev, u_cur, abs_all, rel_all

    return runner


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
    return phases.timed_solve(
        "leapfrog", problem, stop_step,
        lambda: _solver(problem, dtype, step_fn, compute_errors, stop_step,
                        device, c2tau2_field, kernel, phase),
        with_field=c2tau2_field is not None)


def _check_field(c2tau2_field, compute_errors: bool) -> None:
    if c2tau2_field is not None and compute_errors:
        raise ValueError(
            "variable-c runs have no analytic oracle; pass "
            "compute_errors=False with c2tau2_field"
        )


def _resumed(problem, dtype, step_fn, compute_errors, device, c2tau2_field,
             kernel) -> phases.Parts:
    """The set-up of a resumed or chunked standard march: K1, K5 over
    `c2tau2_field` (placed once, in the compute dtype), or the caller's
    `step_fn`."""
    prepare_kernels(device, kernel)
    step = step_fn
    if step_fn is None:
        field = None
        if c2tau2_field is not None:
            field = state.c2tau2_field(c2tau2_field, dtype, device)
        step = stencil_cuda.make_step_fn(field, kernel)
    errors = error_fn(problem, dtype, device, kernel=kernel)
    return standard_parts(_march_fn(problem, step, errors, compute_errors),
                          dtype, device, problem.timesteps)


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
    _check_field(c2tau2_field, compute_errors)
    device = resolve_device(device)
    phases.check_start(start_step, problem.timesteps)
    return phases.timed_resume(
        "leapfrog", problem, start_step,
        lambda: _resumed(problem, dtype, step_fn, compute_errors, device,
                         c2tau2_field, kernel),
        (u_prev, u_cur), with_field=c2tau2_field is not None)


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
    arrays of `length` entries.  The march is `resume`'s, so chunked
    layers are bitwise the uninterrupted march's."""
    def setup():
        _check_field(c2tau2_field, compute_errors)
        return _resumed(problem, dtype, step_fn, compute_errors,
                        resolve_device(device), c2tau2_field, kernel)

    return phases.chunk_runner(problem, length, setup)


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
                errors(u, n, (abs_all[n], rel_all[n]))
    return u, v, c


def _comp_parts(problem, dtype, step, errors, compute_errors, device,
                nsteps) -> phases.Parts:
    """The 1-step compensated march's `phases.Parts` on `device`: state
    (u, v, carry) in the state dtype (wavetpu's unconditional cast; bf16
    refused)."""
    def march(st, start, stop, errs):
        return _comp_march(problem, step, errors, compute_errors, *st, start,
                           stop, *errs), errs

    def state_in(u_cur, v, carry):
        if dtype == torch.bfloat16:
            raise ValueError("compensated scheme requires f32/f64 state")
        return tuple(phases.state_in(a, dtype, device)
                     for a in (u_cur, v, carry))

    return phases.on_device(
        device, dtype, nsteps, march=march, state_in=state_in,
        fields=lambda st: dict(u_prev=st[0] - st[1], u_cur=st[0],
                               comp_v=st[1], comp_carry=st[2]))


def _comp_step(comp_step_fn, kernel):
    return (stencil_cuda.make_compensated_step_fn(kernel)
            if comp_step_fn is None else comp_step_fn)


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
    step = _comp_step(comp_step_fn, kernel)
    nsteps = phases.last_layer(problem, stop_step)

    def setup():
        prepare_kernels(device, kernel)
        errors = error_fn(problem, dtype, device, phase, kernel)
        u0 = initial_layer0(problem, dtype, device, phase)
        zero = torch.zeros_like(u0)
        parts = _comp_parts(problem, dtype, step, errors, compute_errors,
                            device, nsteps)
        errs = parts.vectors()

        def bootstrap(errs):
            if analytic:
                u = analytic_layer(problem, dtype, device, phase, 1)
                v = analytic_increment_layer1(problem, dtype, device, phase)
                c = zero
            else:
                u, v, c = step(u0, zero, zero, problem,
                               0.5 * problem.a2tau2)
            if compute_errors:
                with tracing.annotate("verify.errors"):
                    errors(u, 1, (errs[0][1], errs[1][1]))
            return u, v, c

        parts.run = phases.from_layer0(bootstrap, parts.march, nsteps,
                                       lambda: errs)
        return parts

    return phases.timed_solve("compensated", problem, stop_step, setup,
                              scheme="compensated")


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
    phases.check_start(start_step, problem.timesteps)
    step = _comp_step(comp_step_fn, kernel)

    def setup():
        prepare_kernels(device, kernel)
        return _comp_parts(problem, dtype, step,
                           error_fn(problem, dtype, device, kernel=kernel),
                           compute_errors, device, problem.timesteps)

    return phases.timed_resume("compensated", problem, start_step, setup,
                               (u_cur, v, carry), scheme="compensated")


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
    def setup():
        dev = resolve_device(device)
        step = _comp_step(comp_step_fn, kernel)
        prepare_kernels(dev, kernel)
        return _comp_parts(problem, dtype, step,
                           error_fn(problem, dtype, dev, kernel=kernel),
                           compute_errors, dev, problem.timesteps)

    return phases.chunk_runner(problem, length, setup)


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
