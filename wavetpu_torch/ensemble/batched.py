"""Batched ensemble core: a batch of independent solves as one march (torch
port of wavetpu/ensemble/batched.py).

A batch (an "ensemble") shares the program identity - (N, Lx/y/z, T,
timesteps, scheme, kernel path, k, dtype) - while each LANE differs in

 * the initial time phase of the analytic solution (`LaneSpec.phase`;
   u(0) = Sx*Sy*Sz * cos(phase), which solves the PDE for any phase, so
   every lane keeps an exact oracle; a shifted phase bootstraps layer 1
   analytically, as the solo solvers do),
 * the number of layers marched (`LaneSpec.stop_step`: the batch marches
   to the latest stop and a lane that stops earlier is frozen bit for
   bit), and
 * optionally a per-lane tau^2 c^2(x,y,z) field (standard scheme only, no
   analytic oracle, so field batches need compute_errors=False).

Wired paths: "roll" (the kernels' plain versions), "pallas" (the 1-step
kernels), "kfused" (the k-step kernels, 2 <= k <= 8, k | N) - each on both
schemes: "standard" mirrors leapfrog.solve / kfused.solve_kfused and
"compensated" (the flagship Kahan velocity form) mirrors
leapfrog.solve_compensated / kfused_comp.solve_kfused_comp.

Where wavetpu `jax.vmap`s each solo program over a lane axis, the port
writes the batch dimension out: the state is (B, N, N, N) and every layer
(or k-block) is ONE launch of a kernel's lane mode (kernels/stencil_cuda.py
"Lane modes": K1/K5, K2, K3/K3f, K4), never B launches of the solo kernel.
Each lane's cells run the solo kernel's op sequence and the rest of a
lane's arithmetic (bootstrap, error pass, error rows) is the solo solver's
op for op, so every lane equals the solo port solve of that lane bit for
bit - states and error vectors (tests/test_torch_ensemble.py).

Frozen lanes cost nothing per layer (wavetpu `where`-masks both state
arrays every layer: two passes over the whole batch).  The solver orders
the lanes by stop, latest first, and launches each layer (each k-block on
"kfused", whose lanes freeze on the block grid) over the live prefix only;
when a lane reaches its stop its state is copied once into the output
arrays, in the caller's lane order.  Padding lanes (stop=1) therefore cost
nothing after layer 1, and the launch count does not depend on B.  A
frozen lane's later error entries are 0, as in wavetpu.

Lane modes are static: `vmap_capability` is a table of the (scheme, path,
with_field) triples they cover (every one wavetpu wires) and probes
nothing; a kernel that fails to build or launch raises.  The lane-loop
fallback (`_solve_lane_loop`, sequential solo solves) is reached only
where that table says no, with the reason recorded.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import state
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog, phases
from wavetpu_torch.verify import oracle

PATHS = ("roll", "pallas", "kfused")
SCHEMES = ("standard", "compensated")


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """One lane of an ensemble batch.

    `phase`: initial time phase of the analytic solution (reference: 2*pi).
    `stop_step`: layers to march (None = the problem's timesteps; the lane
    freezes there while the batch marches on).  `c2tau2_field`: optional
    host (N,N,N) tau^2 c^2 array (stencil_ref.make_c2tau2_field).
    """

    phase: float = oracle.TWO_PI
    stop_step: Optional[int] = None
    c2tau2_field: Optional[object] = None

    def stop(self, problem: Problem) -> int:
        return (
            problem.timesteps if self.stop_step is None else self.stop_step
        )


def padding_lane() -> LaneSpec:
    """The filler lane the serve layer pads batches with: frozen after
    layer 1 (stop=1 sits on every k-block grid), default phase.  It never
    enters a launch after layer 1, so real lanes are bitwise unchanged."""
    return LaneSpec(stop_step=1)


@dataclasses.dataclass
class EnsembleResult:
    """A batched solve's outcome: per-lane SolveResults + how it ran.

    `batched` False means the lane-loop fallback executed (reason in
    `fallback_reason` - never None in that case); `batch_size` counts the
    batch's lanes including padding, `n_lanes` the real ones.
    `solve_seconds` is the whole batch's wall time (each lane's
    SolveResult carries the same number: lanes finish together).
    """

    problem: Problem
    results: List[leapfrog.SolveResult]
    path: str
    batched: bool
    fallback_reason: Optional[str]
    batch_size: int
    n_lanes: int
    init_seconds: float
    solve_seconds: float
    # The (B, N, N, N) batched state in the caller's lane order, padding
    # lanes included (None on the lane-loop fallback; per-shard (B,) +
    # block batches for the sharded ensemble).  Each lane's SolveResult
    # holds views of it.
    u_prev_batch: Optional[object] = None
    u_cur_batch: Optional[object] = None
    # Per-lane final-state digests the serve engine gathers before it
    # releases the states (serve/engine.final_digests), None where no
    # lane asked.
    digests: Optional[List[Optional[dict]]] = None

    @property
    def aggregate_gcells_per_second(self) -> float:
        """Sum of per-lane cell-updates over the batch wall time - the
        serving throughput number (arXiv:2108.11076's batching win)."""
        if not self.solve_seconds:
            return 0.0
        total = sum(
            self.problem.cells_per_step * (r.steps_computed or 0)
            for r in self.results
        )
        return total / self.solve_seconds / 1e9


def _validate(problem: Problem, lanes: Sequence[LaneSpec], path: str,
              k: int, compute_errors: bool,
              scheme: str = "standard") -> bool:
    """Shared lane validation; returns with_field (all-or-none normalized
    by the caller via `fill_fields`)."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if scheme not in SCHEMES:
        raise ValueError(
            f"scheme must be one of {SCHEMES}, got {scheme!r}"
        )
    if not lanes:
        raise ValueError("an ensemble needs at least one lane")
    if scheme == "compensated" and any(
        lane.c2tau2_field is not None for lane in lanes
    ):
        raise ValueError(
            "per-lane c2tau2 fields are not wired through the compensated "
            "batched core; use scheme='standard' for field batches"
        )
    if path == "kfused":
        _check_k(problem, k)
    with_field = any(lane.c2tau2_field is not None for lane in lanes)
    if with_field and compute_errors:
        raise ValueError(
            "per-lane c2tau2 fields have no analytic oracle; pass "
            "compute_errors=False"
        )
    for i, lane in enumerate(lanes):
        s = lane.stop(problem)
        if not 1 <= s <= problem.timesteps:
            raise ValueError(
                f"lane {i}: stop_step must be in [1, {problem.timesteps}],"
                f" got {s}"
            )
        if path == "kfused" and s != problem.timesteps and (s - 1) % k:
            raise ValueError(
                f"lane {i}: on the kfused path a lane freezes at whole "
                f"k-blocks - stop_step must satisfy (stop-1) % {k} == 0 "
                f"or equal timesteps={problem.timesteps}, got {s}"
            )
        if lane.c2tau2_field is not None and tuple(np.shape(
            lane.c2tau2_field
        )) != (problem.N,) * 3:
            raise ValueError(
                f"lane {i}: c2tau2_field shape "
                f"{tuple(np.shape(lane.c2tau2_field))} != {(problem.N,) * 3}"
            )
        if with_field and lane.phase != oracle.TWO_PI:
            # In a field batch every lane runs the variable-c kernel
            # (fill_fields), and a shifted phase's analytic layer-1
            # bootstrap exists for constant speed only.
            raise ValueError(
                f"lane {i}: a shifted phase has no analytic layer-1 "
                f"bootstrap in a variable-c field batch; use the "
                f"reference phase with c2tau2_field"
            )
    return with_field


def _check_k(problem: Problem, k: int) -> None:
    if not 2 <= k <= kfused.MAX_K:
        raise ValueError(f"kfused path needs 2 <= k <= {kfused.MAX_K}, "
                         f"got {k}")
    if problem.N % k:
        raise ValueError(f"k={k} must divide N={problem.N}")


def fill_fields(problem: Problem, lanes: Sequence[LaneSpec]) -> list:
    """In a field batch every lane runs the variable-c kernel, so lanes
    without a field get the CONSTANT tau^2 a^2 field (numerically the
    constant-speed problem; bitwise it matches the solo variable-c solve
    with that constant field, not the constant-c kernel)."""
    const = None
    out = []
    for lane in lanes:
        if lane.c2tau2_field is None:
            if const is None:
                const = np.full(
                    (problem.N,) * 3, problem.a2tau2, dtype=np.float64
                )
            lane = dataclasses.replace(lane, c2tau2_field=const)
        out.append(lane)
    return out


def _lane_error_fn(problem: Problem, dtype, device, kernel: str = "pallas"):
    """(u, n, ct_table) -> (abs_e, rel_e): leapfrog.error_fn with the
    lane's time-factor table a runtime argument (`leapfrog.lane_error_fn`,
    one set of factors for every lane; the error kernel, or with
    kernel="roll" its plain version)."""
    errors = leapfrog.lane_error_fn(problem, dtype, device, kernel)
    return lambda u, n, ct_table: errors(u, ct_table[n])


def _lane_error_fn_guarded(problem: Problem, dtype, device):
    """`_lane_error_fn` with the representation-zero sx planes excluded
    from the rel metric: the runtime-ct twin of
    kfused_comp._error_fn_guarded (the flagship's bootstrap layer)."""
    errors = kfused_comp.lane_error_fn_guarded(problem, dtype, device)
    return lambda u, n, ct_table: errors(u, ct_table[n])


def _bootstrap(problem: Problem, dtype, batch, u0, step):
    """Layer 1 of every lane, each as its solo solve: the reference's
    step-derived Taylor half-step over the reference-phase lanes (one lane
    launch of `step(u_prev, u, problem, fields)`), the exact analytic layer
    1 a shifted phase needs elsewhere (leapfrog.solve's phase decision,
    taken per lane at pack time)."""
    u1 = torch.empty_like(u0)
    idx = np.flatnonzero(batch.taylor)
    if idx.size:
        it = torch.as_tensor(idx, device=u0.device)
        fld = None if batch.fields is None else batch.fields[it]
        u1[it] = leapfrog.step_layer1(
            u0[it], lambda a, b, p: step(a, b, p, fld), problem, dtype)
    for i in np.flatnonzero(~batch.taylor):
        u1[i] = leapfrog.analytic_layer(problem, dtype, u0.device,
                                        batch.phases[i], 1)
    return u1


def _comp_bootstrap(problem: Problem, dtype, v_dtype, carry_dtype, batch,
                    u0, comp_step):
    """Compensated layer 1 of every lane, each as its solo solve: K2's
    half-step (coeff C/2, zero v and carry) over the reference-phase lanes
    in one lane launch, v and the carry then cast to their storage dtypes;
    elsewhere the exact analytic start (u1 analytic, v1
    `leapfrog.analytic_increment_layer1`, a zero carry)."""
    dev = u0.device
    u = torch.empty_like(u0)
    v = torch.empty(u0.shape, dtype=v_dtype, device=dev)
    c = torch.empty(u0.shape, dtype=carry_dtype, device=dev)
    idx = np.flatnonzero(batch.taylor)
    if idx.size:
        it = torch.as_tensor(idx, device=dev)
        zero = torch.zeros_like(u0[it])
        ut, vt, ct = comp_step(u0[it], zero, zero, 0.5 * problem.a2tau2)
        u[it], v[it], c[it] = ut, vt.to(v_dtype), ct.to(carry_dtype)
    for i in np.flatnonzero(~batch.taylor):
        ph = batch.phases[i]
        u[i] = leapfrog.analytic_layer(problem, dtype, dev, ph, 1)
        v[i] = leapfrog.analytic_increment_layer1(problem, v_dtype, dev, ph)
        c[i] = 0.0
    return u, v, c


def _march_lanes(stops: np.ndarray, st, units: Iterable[Tuple[int, Callable]],
                 prefix: Callable, keep: Callable) -> None:
    """The live-prefix march shared by both ensembles.

    `stops` are the lanes' stop layers, latest first; `st` the batch's
    state at layer 1.  Each unit (length, fn) marches `length` layers:
    `fn(prefix(st, n), layer, n)` -> the state of the n lanes whose stop
    lies at or past the unit's last layer (a prefix, by the order).  When
    a lane reaches its stop - after the bootstrap or a unit - `keep(st,
    lo, hi)` copies lanes lo..hi-1 of the state aside, once; they enter no
    later launch."""
    def freeze(st, layer, n):
        lo = int(np.count_nonzero(stops > layer))
        if lo < n:
            keep(st, lo, n)

    freeze(st, 1, len(stops))
    layer = 1
    for length, fn in units:
        end = layer + length
        n = int(np.count_nonzero(stops >= end))
        if n == 0:
            return
        st = fn(prefix(st, n), layer, n)
        freeze(st, end, n)
        layer = end


@dataclasses.dataclass
class _Batch:
    """A packed batch, lanes ordered by stop (latest first): `order[j]` is
    the caller's index of sorted lane j."""

    order: np.ndarray
    stops: np.ndarray
    phases: List[float]
    taylor: np.ndarray
    cts: torch.Tensor                  # (B, T+1) time factors, compute dtype
    fields: Optional[torch.Tensor]     # (B, N, N, N) compute dtype, or None


class EnsembleSolver:
    """The batched march for one (problem, path, batch size) key.

    Built once, reused across batches - the object the serve layer's
    program cache holds.  `compile()` builds and loads the kernels (the
    warm-up; idempotent); `run(lanes)` marches a packed batch and returns
    the batched outputs.
    """

    def __init__(
        self,
        problem: Problem,
        n_lanes: int,
        dtype=torch.float32,
        path: str = "roll",
        k: int = 4,
        compute_errors: bool = True,
        block_x: Optional[int] = None,
        with_field: bool = False,
        scheme: str = "standard",
        device=None,
    ):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}, got {path!r}")
        if scheme not in SCHEMES:
            raise ValueError(
                f"scheme must be one of {SCHEMES}, got {scheme!r}"
            )
        if path == "kfused":
            _check_k(problem, k)
        if with_field and compute_errors:
            raise ValueError(
                "field batches have no analytic oracle; pass "
                "compute_errors=False"
            )
        if scheme == "compensated":
            if with_field:
                raise ValueError(
                    "per-lane c2tau2 fields are not wired through the "
                    "compensated batched core"
                )
            if dtype == torch.bfloat16:
                raise ValueError(
                    "compensated scheme requires f32/f64 state"
                )
        self.problem = problem
        self.n_lanes = n_lanes
        self.dtype = dtype
        self.path = path
        # What the 1-step error pass runs: the plain versions on "roll".
        self._kernel = "roll" if path == "roll" else "pallas"
        self.k = k if path == "kfused" else 1
        self.compute_errors = compute_errors
        self.block_x = block_x
        self.with_field = with_field
        self.scheme = scheme
        self.device = leapfrog.resolve_device(device)
        self._f = stencil_ref.compute_dtype(dtype)
        self._compiled = False
        self.compile_seconds: Optional[float] = None

    # ---- packing / compiling / running ----

    def pack(self, lanes: Sequence[LaneSpec]) -> _Batch:
        """The batch's per-lane operands on the device, lanes ordered by
        stop, latest first: (B, T+1) time-factor tables, the stops, the
        bootstrap selectors, and the (B, N, N, N) fields when the batch
        carries them (caller has already run `fill_fields`)."""
        if len(lanes) != self.n_lanes:
            raise ValueError(
                f"batch has {len(lanes)} lanes; this program wants "
                f"{self.n_lanes} (pad with padding_lane())"
            )
        stops = np.asarray([lane.stop(self.problem) for lane in lanes])
        order = np.argsort(-stops, kind="stable")
        lanes = [lanes[i] for i in order]
        cts = np.stack([oracle.time_factor_table_np(self.problem, lane.phase)
                        for lane in lanes])
        fields = None
        if self.with_field:
            n = self.problem.N
            fields = torch.empty((len(lanes), n, n, n), dtype=self._f,
                                 device=self.device)
            for i, lane in enumerate(lanes):
                fields[i] = state.c2tau2_field(lane.c2tau2_field, self.dtype,
                                               self.device)
        return _Batch(
            order=order, stops=stops[order],
            phases=[lane.phase for lane in lanes],
            # The solo solvers' phase decision (leapfrog.check_phase).
            taylor=np.asarray([lane.phase == oracle.TWO_PI
                               for lane in lanes]),
            cts=torch.tensor(cts, dtype=self._f, device=self.device),
            fields=fields,
        )

    @property
    def libraries(self) -> Tuple[str, ...]:
        """The kernel libraries this program launches (none on the CPU,
        where the plain versions run)."""
        if self.device.type != "cuda":
            return ()
        return stencil_cuda.libraries_for(self.path, self.scheme, self.k)

    def compile(self) -> float:
        """Build and load the kernel libraries this program launches (the
        serve engine's warm-up); idempotent.  Returns the wall seconds (0.0
        on a warm hit)."""
        if self._compiled:
            return 0.0
        t0 = time.perf_counter()
        if self.libraries:
            stencil_cuda.load_libraries(self.libraries)
        self._compiled = True
        self.compile_seconds = time.perf_counter() - t0
        return self.compile_seconds

    def executable_payload(self):
        """The persistent program cache's entry (serve/progcache.py): the
        built libraries this program launches; None before `compile`."""
        from wavetpu_torch.serve import progcache

        return (progcache.library_payload(self.libraries)
                if self._compiled else None)

    def adopt_executable(self, payload) -> float:
        """Install and load this program's libraries from a cache entry
        (checked, placed atomically in the build directory, loaded as a
        disk load); returns the wall seconds.  Raises on a payload that
        does not check out - the caller counts it and builds fresh."""
        from wavetpu_torch.serve import progcache

        t0 = time.perf_counter()
        progcache.adopt_libraries(payload, self.libraries)
        self.compile()
        return time.perf_counter() - t0

    def run(self, lanes: Sequence[LaneSpec]):
        """March the batch; returns (outputs, init_seconds, solve_seconds)
        with outputs = (u_prev_b, u_cur_b, abs_b, rel_b): the (B, N, N, N)
        states and the (B, T+1) host f64 error vectors, in the caller's
        lane order.  init_seconds is the kernel build this call paid (0
        when warm) and the batch's set-up (layer 0, fields, tables);
        solve_seconds brackets the bootstrap, the march and the read-back,
        as the solo solvers' timing phases."""
        t0 = time.perf_counter()
        self.compile()
        batch = self.pack(lanes)
        dev, dtype, n = self.device, self.dtype, self.problem.N
        b = self.n_lanes
        u0 = torch.empty((b, n, n, n), dtype=dtype, device=dev)
        for i, phase in enumerate(batch.phases):
            u0[i] = leapfrog.initial_layer0(self.problem, dtype, dev, phase)
        errs = [torch.zeros((b, self.problem.timesteps + 1), dtype=self._f,
                            device=dev) for _ in range(2)]
        out = [torch.empty_like(u0) for _ in range(2)]
        order = torch.as_tensor(batch.order, device=dev)
        phases.sync(dev)
        t1 = time.perf_counter()
        if self.scheme == "compensated":
            self._march_compensated(batch, u0, errs, out, order)
        else:
            self._march_standard(batch, u0, errs, out, order)
        abs_b, rel_b = (np.empty((b, e.shape[1])) for e in errs)
        abs_b[batch.order] = phases.host(errs[0])
        rel_b[batch.order] = phases.host(errs[1])
        phases.sync(dev)
        t2 = time.perf_counter()
        return (out[0], out[1], abs_b, rel_b), t1 - t0, t2 - t1

    # ---- the marches ----

    def _errors_1(self, batch, errors, cur, layer, n, errs):
        """Full-field errors of layer `layer` of lanes 0..n-1 (lane by
        lane: no batch-sized temporaries) into the error vectors."""
        if not self.compute_errors:
            return
        pairs = [errors(cur[i], layer, batch.cts[i]) for i in range(n)]
        errs[0][:n, layer] = torch.stack([a for a, _ in pairs])
        errs[1][:n, layer] = torch.stack([r for _, r in pairs])

    def _march_standard(self, batch, u0, errs, out, order):
        problem, dtype, dev = self.problem, self.dtype, self.device
        errors = _lane_error_fn(problem, dtype, dev, self._kernel)
        field = batch.fields
        step_lanes = (stencil_cuda.fused_step_lanes_plain
                      if self.path == "roll"
                      else stencil_cuda.fused_step_lanes)

        def step(up, u, problem, fld=None):
            if fld is not None:
                return step_lanes(up, u, inv_h2=problem.inv_h2,
                                  c2tau2_field=fld)
            return step_lanes(up, u, inv_h2=problem.inv_h2, alpha=2.0,
                              beta=1.0, coeff=problem.a2tau2)

        u1 = _bootstrap(problem, dtype, batch, u0, step)
        self._errors_1(batch, errors, u1, 1, len(batch.stops), errs)

        def keep(st, lo, hi):
            for o, t in zip(out, st):
                o.index_copy_(0, order[lo:hi], t[lo:hi])

        def one_step(st, layer, n):
            u_prev, u = st
            u_next = step(u_prev, u, problem,
                          None if field is None else field[:n])
            self._errors_1(batch, errors, u_next, layer + 1, n, errs)
            return u, u_next

        units = [(1, one_step)] * (problem.timesteps - 1)
        if self.path == "kfused":
            units = self._kfused_units(batch, errs, one_step)
        _march_lanes(batch.stops, (u0, u1), units,
                     lambda st, n: tuple(t[:n] for t in st), keep)

    def _kfused_units(self, batch, errs, one_step):
        """The k-fused march's units: (nsteps-1)//k K3 lane blocks, then the
        1-step remainder (kfused._make_march's march on every lane)."""
        problem, dev, k = self.problem, self.device, self.k
        f = self._f
        sx, _, syz, rsyz, xmask, inv_absx = kfused._oracle_parts(problem, f,
                                                                 dev)
        kern = torch.float32 if dev.type == "cuda" else f
        syz_k, rsyz_k = syz.to(kern), rsyz.to(kern)
        field = batch.fields
        ce = self.compute_errors

        def block(st, layer, n):
            u_prev, u = st
            ctk = batch.cts[:n, layer + 1: layer + 1 + k]
            sxct = ctk[:, :, None] * sx[None, None, :]
            up, uc, dmax, rmax = stencil_cuda.fused_kstep_lanes(
                u_prev, u, syz_k, rsyz_k, sxct.to(kern), k=k,
                coeff=problem.a2tau2, inv_h2=problem.inv_h2,
                c2tau2_field=None if field is None else field[:n],
                with_errors=ce)
            if ce:
                a, r = kfused._block_errors(dmax, rmax, ctk, xmask,
                                            inv_absx)
                errs[0][:n, layer + 1: layer + 1 + k] = a
                errs[1][:n, layer + 1: layer + 1 + k] = r
            return up, uc

        nblocks = (problem.timesteps - 1) // k
        rem = (problem.timesteps - 1) - nblocks * k
        return [(k, block)] * nblocks + [(1, one_step)] * rem

    def _march_compensated(self, batch, u0, errs, out, order):
        problem, dtype, dev = self.problem, self.dtype, self.device
        f = self._f
        kfused_path = self.path == "kfused"
        v_dtype = dtype
        carry_dtype = (kfused_comp._default_carry_dtype(dtype) if kfused_path
                       else dtype)
        errors = (_lane_error_fn_guarded(problem, dtype, dev) if kfused_path
                  else _lane_error_fn(problem, dtype, dev, self._kernel))
        if self.path == "roll":
            def comp_step(u, v, c, coeff=None):
                return stencil_cuda.compensated_step_lanes_plain(
                    u, v, c, inv_h2=problem.inv_h2,
                    coeff=problem.a2tau2 if coeff is None else coeff)
        else:
            def comp_step(u, v, c, coeff=None):
                return stencil_cuda.compensated_step_lanes(u, v, c, problem,
                                                           coeff)

        u, v, c = _comp_bootstrap(problem, dtype, v_dtype, carry_dtype,
                                  batch, u0, comp_step)
        self._errors_1(batch, errors, u, 1, len(batch.stops), errs)

        def keep(st, lo, hi):
            uu, vv, _ = st
            # u_prev reconstructed from the increment, as the solo
            # compensated solvers return it.
            prev = (uu[lo:hi].to(f) - vv[lo:hi].to(f)).to(dtype)
            out[0].index_copy_(0, order[lo:hi], prev)
            out[1].index_copy_(0, order[lo:hi], uu[lo:hi])

        def one_step(st, layer, n):
            st = comp_step(*st)
            self._errors_1(batch, errors, st[0], layer + 1, n, errs)
            return st

        units = [(1, one_step)] * (problem.timesteps - 1)
        if kfused_path:
            units = self._comp_kfused_units(batch, errs)
        _march_lanes(batch.stops, (u, v, c), units,
                     lambda st, n: tuple(t[:n] for t in st), keep)

    def _comp_kfused_units(self, batch, errs):
        """The flagship's units: (nsteps-1)//k K4 lane blocks, then the
        remainder through the same kernel at k=1
        (kfused_comp._make_march's march on every lane)."""
        problem, dev, k = self.problem, self.device, self.k
        f = self._f
        sx, _, syz, rsyz, xmask, inv_absx = kfused_comp.oracle_parts_guarded(
            problem, f, dev)
        kern = torch.float32 if dev.type == "cuda" else f
        syz_k, rsyz_k = syz.to(kern), rsyz.to(kern)
        ce = self.compute_errors

        def block(kk, bx):
            def run(st, layer, n):
                ctk = batch.cts[:n, layer + 1: layer + 1 + kk]
                sxct = ctk[:, :, None] * sx[None, None, :]
                u2, v2, c2, dmax, rmax = stencil_cuda.fused_kstep_comp_lanes(
                    *st, syz_k, rsyz_k, sxct.to(kern), k=kk,
                    coeff=problem.a2tau2, inv_h2=problem.inv_h2,
                    block_x=bx, with_errors=ce)
                if ce:
                    a, r = kfused._block_errors(dmax, rmax, ctk, xmask,
                                                inv_absx)
                    errs[0][:n, layer + 1: layer + 1 + kk] = a
                    errs[1][:n, layer + 1: layer + 1 + kk] = r
                return u2, v2, c2

            return run

        nblocks = (problem.timesteps - 1) // k
        rem = (problem.timesteps - 1) - nblocks * k
        return ([(k, block(k, self.block_x))] * nblocks
                + [(1, block(1, None))] * rem)


def _lane_results(problem, outputs, lanes, init_s, solve_s):
    """Per-lane SolveResults from batched outputs (padding already
    dropped by the caller passing only the real lanes, first)."""
    upb, ucb, ab, rb = outputs
    results = []
    for i, lane in enumerate(lanes):
        s = lane.stop(problem)
        results.append(
            leapfrog.SolveResult(
                problem=problem,
                u_prev=upb[i],
                u_cur=ucb[i],
                abs_errors=np.asarray(ab[i], np.float64)[: s + 1],
                rel_errors=np.asarray(rb[i], np.float64)[: s + 1],
                init_seconds=init_s,
                solve_seconds=solve_s,
                steps_computed=s,
                final_step=s,
            )
        )
    return results


# ---- capability table ----

# The (scheme, path, with_field) triples the kernels' lane modes cover:
# every triple wavetpu's batched core wires (compensated field batches are
# refused by `_validate`, as there).
LANE_MODES = {
    (scheme, path, with_field)
    for path in PATHS
    for scheme, with_field in (("standard", False), ("standard", True),
                               ("compensated", False))
}

_PROBE_CACHE = {}


def vmap_capability(
    path: str,
    k: int = 2,
    with_field: bool = False,
    scheme: str = "standard",
    device=None,
) -> Tuple[bool, Optional[str]]:
    """Does the batched core run this (scheme, path, with_field)?

    A static answer from `LANE_MODES` (wavetpu probes a tiny batched solve;
    the port's lane modes are known ahead, and a kernel that fails to
    build or launch raises instead of falling back).  Returns (ok, reason);
    every verdict asked for is kept for `probe_results()`.  `k` is
    wavetpu's argument (any k the kernels take is covered)."""
    backend = "cpu" if device is not None and \
        torch.device(device).type == "cpu" else "cuda"
    key = (scheme, path, bool(with_field), False, backend)
    ok = (scheme, path, bool(with_field)) in LANE_MODES
    verdict = (ok, None if ok else
               f"no lane mode covers scheme {scheme!r} path {path!r} "
               f"with_field={bool(with_field)}")
    _PROBE_CACHE[key] = verdict
    return verdict


def probe_results() -> list:
    """Every capability verdict asked for, as dicts (wavetpu's shape, for
    the serve layer's GET /metrics -> program_cache.vmap_probes)."""
    return [
        {
            "scheme": k[0], "path": k[1], "with_field": k[2],
            "interpret": k[3], "backend": k[4],
            "ok": v[0], "reason": v[1],
        }
        for k, v in sorted(_PROBE_CACHE.items(), key=lambda kv: kv[0])
    ]


# ---- lane-loop fallback ----

def _solve_lane_loop(
    problem, lanes, dtype, scheme, path, k, compute_errors, block_x,
    reason, device=None,
):
    """Sequential solo solves behind the EnsembleResult interface - the
    recorded fallback where no lane mode covers the batch."""
    kernel = "roll" if path == "roll" else "pallas"
    results = []
    init_total = solve_total = 0.0
    for lane in lanes:
        kw = dict(dtype=dtype, compute_errors=compute_errors,
                  stop_step=lane.stop(problem), device=device,
                  phase=lane.phase)
        if scheme == "compensated" and path == "kfused":
            res = kfused_comp.solve_kfused_comp(problem, k=k,
                                                block_x=block_x, **kw)
        elif scheme == "compensated":
            res = leapfrog.solve_compensated(problem, kernel=kernel, **kw)
        elif path == "kfused":
            res = kfused.solve_kfused(problem, k=k,
                                      c2tau2_field=lane.c2tau2_field, **kw)
        else:
            res = leapfrog.solve(problem, c2tau2_field=lane.c2tau2_field,
                                 kernel=kernel, **kw)
        init_total += res.init_seconds
        solve_total += res.solve_seconds
        results.append(res)
    return EnsembleResult(
        problem=problem,
        results=results,
        path=path,
        batched=False,
        fallback_reason=reason,
        batch_size=len(lanes),
        n_lanes=len(lanes),
        init_seconds=init_total,
        solve_seconds=solve_total,
    )


def solve_ensemble(
    problem: Problem,
    lanes: Sequence[LaneSpec],
    dtype=torch.float32,
    scheme: str = "standard",
    path: str = "roll",
    k: int = 4,
    compute_errors: bool = True,
    block_x: Optional[int] = None,
    pad_to: Optional[int] = None,
    solver: Optional[EnsembleSolver] = None,
    device=None,
) -> EnsembleResult:
    """Solve a batch of lanes as one batched march (or the recorded
    lane-loop fallback), on the CUDA device unless `device` names another
    (`device="cpu"` runs the kernels' plain versions).

    `pad_to` rounds the batch up to a program-cache bucket with
    `padding_lane()`s (dropped from `results`).  Pass a pre-built `solver`
    (the serve engine's cached program) to skip rebuilding; its geometry
    must match.  Every lane is bitwise equal to the solo port solve of
    that lane (leapfrog.solve / solve_compensated, kfused.solve_kfused,
    kfused_comp.solve_kfused_comp with its `phase` and `stop_step`).
    """
    lanes = list(lanes)
    with_field = _validate(problem, lanes, path, k, compute_errors, scheme)
    device = leapfrog.resolve_device(device)
    ok, why = vmap_capability(path, k=k, with_field=with_field,
                              scheme=scheme, device=device)
    if not ok:
        return _solve_lane_loop(
            problem, lanes, dtype, scheme, path, k, compute_errors,
            block_x,
            f"vmap capability probe failed on scheme {scheme!r} path "
            f"{path!r}: {why}", device,
        )
    if with_field:
        lanes = fill_fields(problem, lanes)
    batch = lanes
    if pad_to is not None:
        if pad_to < len(lanes):
            raise ValueError(
                f"pad_to={pad_to} < {len(lanes)} real lanes"
            )
        pad = [padding_lane()] * (pad_to - len(lanes))
        batch = lanes + (fill_fields(problem, pad) if with_field else pad)
    if solver is None:
        solver = EnsembleSolver(
            problem, len(batch), dtype=dtype, path=path, k=k,
            compute_errors=compute_errors, block_x=block_x,
            with_field=with_field, scheme=scheme, device=device,
        )
    outputs, init_s, solve_s = solver.run(batch)
    return EnsembleResult(
        problem=problem,
        results=_lane_results(problem, outputs, lanes, init_s, solve_s),
        path=path,
        batched=True,
        fallback_reason=None,
        batch_size=len(batch),
        n_lanes=len(lanes),
        init_seconds=init_s,
        solve_seconds=solve_s,
        u_prev_batch=outputs[0],
        u_cur_batch=outputs[1],
    )
