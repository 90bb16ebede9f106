"""Sharded x batched: an ensemble axis composed with the device mesh (torch
port of wavetpu/ensemble/sharded.py).

`batched.py` batches single-device solves; this module composes the lane
axis with the (MX, MY, MZ) mesh, so a batch of SHARDED solves runs as one
march - the pod-scale throughput composition of arXiv:2108.11076 (batch
axis x device mesh).

wavetpu runs shard_map-of-vmap.  The port keeps solver/sharded.py's
shards and writes the lane axis out: each shard holds its block for every
lane, (B,) + block, on its device (a device may repeat, as in the solo
sharded solvers); each layer exchanges the face ghosts of all live lanes
in one copy per face (comm/halo.collect_ghosts with lanes), then launches
K6's lane mode once per shard (`stencil_cuda.sharded_fused_step_lanes`).
Every lane's per-shard ops are the solo `sharded.solve_sharded`'s, so each
lane equals its solo sharded solve bit for bit, errors included (the
cross-shard max taken at the read-back, as there).

Lane identity is (phase, stop_step): per-lane time-factor tables, the
per-lane analytic layer-1 bootstrap for shifted phases, and the
live-prefix march of batched.py (lanes ordered by stop; a lane that
stops is copied aside once).  Constant speed, standard scheme, kernel
"roll" (K6's plain version) or "pallas" (K6), as wavetpu's.
`vmap_capability(mesh_shape, ...)` is the static table of what the lane
mode covers; the lane-loop fallback (sequential solo sharded solves) is
reached only where it says no, with the reason recorded.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from wavetpu_torch.comm import halo
from wavetpu_torch.core.grid import ShardedArray
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble.batched import (
    EnsembleResult,
    LaneSpec,
    _lane_results,
    _march_lanes,
    padding_lane,
)
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import leapfrog, phases, sharded
from wavetpu_torch.verify import oracle

KERNELS = ("roll", "pallas")


def _validate(problem: Problem, lanes: Sequence[LaneSpec], kernel: str,
              compute_errors: bool) -> None:
    if kernel not in KERNELS:
        raise ValueError(
            f"kernel must be one of {KERNELS}, got {kernel!r}"
        )
    if not lanes:
        raise ValueError("an ensemble needs at least one lane")
    for i, lane in enumerate(lanes):
        if lane.c2tau2_field is not None:
            raise ValueError(
                f"lane {i}: per-lane c2tau2 fields are not wired through "
                f"the sharded ensemble (constant speed only)"
            )
        s = lane.stop(problem)
        if not 1 <= s <= problem.timesteps:
            raise ValueError(
                f"lane {i}: stop_step must be in [1, {problem.timesteps}],"
                f" got {s}"
            )


class ShardedEnsembleSolver:
    """The batched sharded march for (problem, mesh, batch size).

    The sharded twin of `batched.EnsembleSolver` - the same
    compile()/pack()/run() contract, so the serve engine's program cache
    holds either.  Each lane runs `sharded.make_sharded_solver`'s per-shard
    op sequence (kernel "roll" or "pallas", serial exchange, standard
    scheme).
    """

    def __init__(
        self,
        problem: Problem,
        n_lanes: int,
        mesh_shape: Tuple[int, int, int],
        dtype=torch.float32,
        kernel: str = "roll",
        compute_errors: bool = True,
        devices=None,
    ):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if kernel not in KERNELS:
            raise ValueError(
                f"kernel must be one of {KERNELS}, got {kernel!r}"
            )
        self.problem = problem
        self.n_lanes = n_lanes
        self.mesh_shape = tuple(int(m) for m in mesh_shape)
        self.dtype = dtype
        self.kernel = kernel
        self.compute_errors = compute_errors
        self._f = stencil_ref.compute_dtype(dtype)
        self._compiled = False
        self.compile_seconds: Optional[float] = None
        self.topo, self.mesh = sharded._resolve_mesh(
            problem, self.mesh_shape, devices)
        f = self._f
        ct = oracle.time_factor_table(problem, f)
        factors = sharded._padded_factors(problem, self.topo)
        masks = sharded._masks(problem, self.topo)
        self.shards = [
            sharded._Shard(problem, self.topo, coord, dev, f, factors, masks,
                           ct, kernel)
            for coord, dev in zip(self.mesh.coords, self.mesh.devices)]

    # ---- packing / compiling / running (EnsembleSolver contract) ----

    def pack(self, lanes: Sequence[LaneSpec]):
        """(order, stops, taylor, per-shard (B, T+1) time-factor tables),
        lanes ordered by stop, latest first (`batched.EnsembleSolver.pack`)."""
        if len(lanes) != self.n_lanes:
            raise ValueError(
                f"batch has {len(lanes)} lanes; this program wants "
                f"{self.n_lanes} (pad with padding_lane())"
            )
        stops = np.asarray([lane.stop(self.problem) for lane in lanes])
        order = np.argsort(-stops, kind="stable")
        phases = [lanes[i].phase for i in order]
        cts = torch.tensor(
            np.stack([oracle.time_factor_table_np(self.problem, ph)
                      for ph in phases]), dtype=self._f)
        on = {dev: cts.to(dev) for dev in set(self.mesh.devices)}
        taylor = np.asarray([ph == oracle.TWO_PI for ph in phases])
        return order, stops[order], taylor, [on[sh.device]
                                             for sh in self.shards]

    @property
    def libraries(self) -> Tuple[str, ...]:
        """The kernel libraries this program launches: K6's lane mode
        (sharded.cu) and the error pass (errors.cu) on the card, none for
        the plain versions."""
        if self.kernel != "pallas" or not any(
                d.type == "cuda" for d in self.mesh.devices):
            return ()
        return stencil_cuda.libraries_for("pallas", mesh=self.mesh_shape)

    def compile(self) -> float:
        """Build and load the kernels; idempotent (0.0 on a warm hit)."""
        if self._compiled:
            return 0.0
        t0 = time.perf_counter()
        if self.libraries:
            stencil_cuda.load_libraries(self.libraries)
        self._compiled = True
        self.compile_seconds = time.perf_counter() - t0
        return self.compile_seconds

    def executable_payload(self):
        """The program cache's entry (`batched.EnsembleSolver`'s twin)."""
        from wavetpu_torch.serve import progcache

        return (progcache.library_payload(self.libraries)
                if self._compiled else None)

    def adopt_executable(self, payload) -> float:
        """Adopt this program's libraries from a cache entry
        (`batched.EnsembleSolver.adopt_executable`'s twin)."""
        from wavetpu_torch.serve import progcache

        t0 = time.perf_counter()
        progcache.adopt_libraries(payload, self.libraries)
        self.compile()
        return time.perf_counter() - t0

    def _step(self):
        """The lane step over all shards, `step(prev, cur)` -> the next
        blocks: the ghosts of every lane of `cur` (one copy per face), then
        K6's lane mode (its plain version with kernel="roll") per shard."""
        problem, topo, mesh = self.problem, self.topo, self.mesh
        k6 = (stencil_cuda.sharded_fused_step_lanes if self.kernel == "pallas"
              else stencil_cuda.sharded_fused_step_lanes_plain)

        def step(prev, cur):
            ghosts = halo.collect_ghosts(cur, topo, mesh, lanes=True)
            u_in = halo.absorb_hi_ghosts(cur, ghosts, topo, mesh, lanes=True)
            return [k6(p, u, g, sh.offsets, problem.N,
                       inv_h2=problem.inv_h2, mesh_shape=topo.mesh_shape,
                       r_last=topo.r_last, coeff=problem.a2tau2)
                    for p, u, g, sh in zip(prev, u_in, ghosts, self.shards)]

        return step

    def run(self, lanes: Sequence[LaneSpec]):
        """March the batch; returns (outputs, init_seconds, solve_seconds)
        with outputs = (u_prev, u_cur, abs_b, rel_b): per-shard (B,) +
        block states in the caller's lane order (mesh order) and the (B,
        T+1) host f64 cross-shard error maxima."""
        t0 = time.perf_counter()
        self.compile()
        order, stops, taylor, cts = self.pack(lanes)
        problem, dtype, f = self.problem, self.dtype, self._f
        b, t = self.n_lanes, problem.timesteps
        u0 = [torch.stack([sh.analytic(ct[i, 0], dtype) for i in range(b)])
              for sh, ct in zip(self.shards, cts)]
        errs = [[torch.zeros((b, t + 1), dtype=f, device=sh.device)
                 for sh in self.shards] for _ in range(2)]
        out = [[torch.empty_like(u) for u in u0] for _ in range(2)]
        orders = [torch.as_tensor(order, device=sh.device)
                  for sh in self.shards]
        step = self._step()
        phases.sync(*self.mesh.devices)
        t1 = time.perf_counter()

        def record(cur, layer, n):
            if not self.compute_errors:
                return
            for j, (sh, u, ct) in enumerate(zip(self.shards, cur, cts)):
                pairs = [sh.errors_at(u[i], ct[i, layer]) for i in range(n)]
                errs[0][j][:n, layer] = torch.stack([a for a, _ in pairs])
                errs[1][j][:n, layer] = torch.stack([r for _, r in pairs])

        # Layer 1: the step-derived layer 1 of the reference-phase lanes
        # (one lane step per shard), the analytic one elsewhere.
        u1 = [torch.empty_like(u) for u in u0]
        idx = np.flatnonzero(taylor)
        if idx.size:
            its = [torch.as_tensor(idx, device=u.device) for u in u0]
            u0t = [u.index_select(0, it) for u, it in zip(u0, its)]
            for u, it, a, s in zip(u1, its, u0t, step(u0t, u0t)):
                u[it] = (0.5 * (a.to(f) + s.to(f))).to(dtype)
        for i in np.flatnonzero(~taylor):
            for u, sh, ct in zip(u1, self.shards, cts):
                u[i] = sh.analytic(ct[i, 1], dtype)
        record(u1, 1, b)

        def keep(st, lo, hi):
            for o, blocks in zip(out, st):
                for ob, blk, od in zip(o, blocks, orders):
                    ob.index_copy_(0, od[lo:hi], blk[lo:hi])

        def one_step(st, layer, n):
            prev, cur = st
            nxt = step(prev, cur)
            record(nxt, layer + 1, n)
            return cur, nxt

        _march_lanes(stops, (u0, u1), [(1, one_step)] * (t - 1),
                     lambda st, n: tuple([x[:n] for x in c] for c in st),
                     keep)
        abs_b, rel_b = (np.empty((b, t + 1)) for _ in range(2))
        abs_b[order] = sharded._reduce(errs[0], self.mesh)
        rel_b[order] = sharded._reduce(errs[1], self.mesh)
        phases.sync(*self.mesh.devices)
        t2 = time.perf_counter()
        return (out[0], out[1], abs_b, rel_b), t1 - t0, t2 - t1


# ---- capability table ----

_PROBE_CACHE = {}


def vmap_capability(
    mesh_shape: Tuple[int, int, int],
    kernel: str = "roll",
    device=None,
) -> Tuple[bool, Optional[str]]:
    """Does the batched sharded march run this (mesh, kernel)?  A static
    answer - K6's lane mode covers every mesh and both kernels - kept for
    `probe_results()` beside the single-device verdicts."""
    backend = "cpu" if device is not None and \
        torch.device(device).type == "cpu" else "cuda"
    key = (tuple(int(m) for m in mesh_shape), kernel, False, backend)
    ok = kernel in KERNELS
    verdict = (ok, None if ok else f"no lane mode for kernel {kernel!r}")
    _PROBE_CACHE[key] = verdict
    return verdict


def probe_results() -> list:
    """The sharded capability verdicts asked for, as dicts (wavetpu's
    shape, for /metrics)."""
    return [
        {
            "mesh": list(k[0]), "kernel": k[1], "interpret": k[2],
            "backend": k[3], "ok": v[0], "reason": v[1],
        }
        for k, v in sorted(_PROBE_CACHE.items(), key=lambda kv: str(kv[0]))
    ]


# ---- lane-loop fallback + entry point ----

def _path(mesh_shape, kernel) -> str:
    return f"sharded{tuple(mesh_shape)}:{kernel}"


def _solve_lane_loop(problem, lanes, mesh_shape, dtype, kernel,
                     compute_errors, devices, reason):
    """Sequential solo sharded solves behind the EnsembleResult
    interface - the recorded fallback."""
    results = []
    init_total = solve_total = 0.0
    for lane in lanes:
        res = sharded.solve_sharded(
            problem, mesh_shape=mesh_shape, devices=devices, dtype=dtype,
            compute_errors=compute_errors, kernel=kernel,
            stop_step=lane.stop(problem), phase=lane.phase,
        )
        init_total += res.init_seconds
        solve_total += res.solve_seconds
        results.append(res)
    return EnsembleResult(
        problem=problem,
        results=results,
        path=_path(mesh_shape, kernel),
        batched=False,
        fallback_reason=reason,
        batch_size=len(lanes),
        n_lanes=len(lanes),
        init_seconds=init_total,
        solve_seconds=solve_total,
    )


def solve_ensemble_sharded(
    problem: Problem,
    lanes: Sequence[LaneSpec],
    mesh_shape: Tuple[int, int, int],
    dtype=torch.float32,
    kernel: str = "roll",
    compute_errors: bool = True,
    devices=None,
    pad_to: Optional[int] = None,
    solver: Optional[ShardedEnsembleSolver] = None,
) -> EnsembleResult:
    """Solve a batch of lanes as ONE batched sharded march over
    `mesh_shape` (or the recorded lane-loop fallback), on `devices`
    (default: every visible card; `["cpu"] * 4` runs four shards on the
    CPU).  Same padding / pre-built-solver contract as
    `batched.solve_ensemble`; every lane is bitwise equal to its solo
    `sharded.solve_sharded` on the same mesh (each lane's u_prev / u_cur
    is a ShardedArray in the padded layout, as the solo solver returns
    it)."""
    lanes = list(lanes)
    _validate(problem, lanes, kernel, compute_errors)
    devs = leapfrog.resolve_devices(devices)
    ok, why = vmap_capability(mesh_shape, kernel=kernel, device=devs[0])
    if not ok:
        return _solve_lane_loop(
            problem, lanes, mesh_shape, dtype, kernel, compute_errors,
            devices,
            f"sharded vmap capability probe failed on mesh "
            f"{tuple(mesh_shape)} kernel {kernel!r}: {why}",
        )
    batch = lanes
    if pad_to is not None:
        if pad_to < len(lanes):
            raise ValueError(f"pad_to={pad_to} < {len(lanes)} real lanes")
        batch = lanes + [padding_lane()] * (pad_to - len(lanes))
    if solver is None:
        solver = ShardedEnsembleSolver(
            problem, len(batch), mesh_shape, dtype=dtype, kernel=kernel,
            compute_errors=compute_errors, devices=devices,
        )
    (upb, ucb, ab, rb), init_s, solve_s = solver.run(batch)

    def lane(blocks, i):
        return ShardedArray([blk[i] for blk in blocks], solver.topo,
                            solver.mesh)

    views = ([lane(upb, i) for i in range(len(lanes))],
             [lane(ucb, i) for i in range(len(lanes))], ab, rb)
    return EnsembleResult(
        problem=problem,
        results=_lane_results(problem, views, lanes, init_s, solve_s),
        path=_path(mesh_shape, kernel),
        batched=True,
        fallback_reason=None,
        batch_size=len(batch),
        n_lanes=len(lanes),
        init_seconds=init_s,
        solve_seconds=solve_s,
        u_prev_batch=upb,
        u_cur_batch=ucb,
    )
