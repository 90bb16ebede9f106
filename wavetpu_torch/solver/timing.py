"""Phase-timing probes: loop (stencil) vs exchange cost (the port of
wavetpu/solver/timing.py).

The reference accumulates `total_loop_time` / `total_exchange_time` with
host timers around each phase of every step (mpi_new.cpp:33-34, 200-240,
368-371).  A timer around each phase of a queued GPU march would time the
enqueue, and a synchronisation per phase would change the march it
measures.  Instead the breakdown is measured as wavetpu measures it: two
probe marches over identical state,

  * full    - the PRODUCTION step (`sharded._make_local_step`: the
    selected kernel, its ghost exchange and copies; for k-fusion the
    production exchange `sharded_kfused.exchange` and the k-step kernel,
    K8 on an (MX, 1, 1) mesh and K10 on MY > 1, or the compensated K11 /
    K12), errors off;
  * compute - the same step with each shard its own neighbour: the
    block's own wrap planes in place of the exchanged ghosts
    (`sharded._self_ghosts`, `_self_exchange`) - the same copies of the
    same sizes and the same kernels, no data from another shard;

each timed over `iters` steps (k-blocks) after a warm-up, the best of
`repeats`: CUDA events where every shard lives on one card, the host
clock around a synchronisation otherwise (and on the CPU).  `exchange =
full - compute` (clamped at 0).  With every shard on one card both
variants copy the same bytes within the card, so the exchange reads ~0
there; the loop then times the kernels and the copies.

A --backend single run is probed on a (1, 1, 1) mesh: the sharded kernel
(K6, or K8 for k-fusion) on the whole state stands for K1 (K3), as
wavetpu's probe does.  The 1-step compensated scheme has no probe; the
CLI rejects that combination.  The numbers are extrapolated from the
probe's steps to the full solve length; the report labels them so.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import torch

from wavetpu_torch.comm import halo
from wavetpu_torch.core.grid import Topology, build_mesh, choose_mesh_shape
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, leapfrog
from wavetpu_torch.solver import sharded as _sharded
from wavetpu_torch.solver import sharded_kfused as _skf


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    """Per-solve phase attribution, scaled to `timesteps` steps."""

    loop_seconds: float       # stencil update cost (compute probe)
    exchange_seconds: float   # ghost exchange cost (full - compute, >= 0)
    steps_measured: int       # probe steps behind the extrapolation

    @property
    def total_seconds(self) -> float:
        return self.loop_seconds + self.exchange_seconds


def _time_best(run, state, devices, repeats: int) -> float:
    """Best-of-`repeats` seconds of `run(*state)` after one warm-up call
    (kernel builds and first launches excluded).  CUDA events when every
    shard is on one card; the host clock around a synchronisation of
    every card otherwise (and on the CPU)."""
    cards = sorted({d for d in devices if d.type == "cuda"}, key=str)

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    run(*state)
    sync()
    best = float("inf")
    for _ in range(repeats):
        if len(cards) == 1 and all(d.type == "cuda" for d in devices):
            with torch.cuda.device(cards[0]):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run(*state)
                b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            run(*state)
            sync()
            best = min(best, time.perf_counter() - t0)
    return best


def _probe_runner(problem: Problem, topo: Topology, mesh, kernel: str,
                  overlap: bool, with_halo: bool, iters: int):
    """`iters` PRODUCTION 1-step updates of every shard (errors off)."""
    offsets = [_sharded._shard_offsets(topo, c) for c in mesh.coords]
    step = _sharded._make_local_step(problem, topo, mesh, offsets, kernel,
                                     overlap, exchange=with_halo)
    fields = [None] * len(offsets)

    def run(prev, cur):
        for _ in range(iters):
            prev, cur = cur, step(prev, cur, fields)
        return cur

    return run


def _self_exchange(blocks, mesh, kk: int):
    """`sharded_kfused.exchange` with every shard its own neighbour: the
    same copies (on MY > 1 a y extension from the block's own rows; x
    windows copied from the block, views of it on one x shard as the
    exchange takes them), no data from another shard."""
    n_x, n_y, _ = mesh.shape
    if n_y > 1:
        ext = []
        for b in blocks:
            bx, by, bz = b.shape
            e = torch.empty((bx, by + 2 * kk, bz), dtype=b.dtype,
                            device=b.device)
            e[:, :kk].copy_(b[:, by - kk:], non_blocking=True)
            e[:, kk:kk + by].copy_(b, non_blocking=True)
            e[:, kk + by:].copy_(b[:, :kk], non_blocking=True)
            ext.append(e)
        blocks = ext
    if n_x == 1:
        return list(blocks), [(b[-kk:], b[:kk]) for b in blocks]
    return list(blocks), [(halo.send(b[-kk:], b.device),
                           halo.send(b[:kk], b.device)) for b in blocks]


def _oracle_planes(problem: Problem, mesh, f, k: int, depth: int):
    """Each shard's central (N/MY, N) oracle planes and a zero (k, depth)
    sxct, as the production march hands them to the kernels (the probe
    runs with errors off)."""
    n_y = mesh.shape[1]
    nl_y = problem.N // n_y
    _, _, syz, rsyz, _, _ = kfused._oracle_parts(problem, f,
                                                 torch.device("cpu"))
    return [(tuple(a[cy * nl_y:(cy + 1) * nl_y].to(dev).contiguous()
                   for a in (syz, rsyz)),
             torch.zeros((k, depth), dtype=f, device=dev))
            for dev, (_, cy, _) in zip(mesh.devices, mesh.coords)]


def _kfused_probe_runner(problem: Problem, mesh, dtype, k: int,
                         with_halo: bool, iters: int):
    """`iters` PRODUCTION k-blocks over an even (MX, MY, 1) mesh: the
    k-step exchange of u_prev and u, then K8 (MY = 1) or K10 (MY > 1) on
    every shard, errors off; `with_halo=False` exchanges with
    `_self_exchange`."""
    n_x, n_y, _ = mesh.shape
    n = problem.N
    nl, nl_y = n // n_x, n // n_y
    f = stencil_ref.compute_dtype(dtype)
    planes = _oracle_planes(problem, mesh, f, k, nl)
    xch = _skf.exchange if with_halo else _self_exchange
    kw = dict(k=k, coeff=problem.a2tau2, inv_h2=problem.inv_h2,
              with_errors=False)

    def run(prev, cur):
        for _ in range(iters):
            pe, pg = xch(prev, mesh, k)
            ce, cg = xch(cur, mesh, k)
            outs = []
            for i, ((syz, rsyz), sxct) in enumerate(planes):
                if n_y == 1:
                    outs.append(stencil_cuda.fused_kstep_sharded(
                        pe[i], ce[i], pg[i], cg[i], syz, rsyz, sxct, **kw))
                else:
                    cy = mesh.coords[i][1]
                    outs.append(stencil_cuda.fused_kstep_sharded_xy(
                        pe[i], ce[i], pg[i], cg[i], syz, rsyz, sxct,
                        cy * nl_y, n, nl_y=nl_y, **kw))
            prev, cur = [o[0] for o in outs], [o[1] for o in outs]
        return cur

    return run


def _kfused_comp_probe_runner(problem: Problem, mesh, dtype, k: int,
                              with_halo: bool, iters: int):
    """`_kfused_probe_runner` for the distributed flagship: the state is
    (u, v, carry) and both u and v exchange k-plane windows per block (the
    carry stays with its shard, as in production); K11 (MY = 1) or K12
    (MY > 1) with the production carry slab."""
    n_x, n_y, _ = mesh.shape
    n = problem.N
    nl, nl_y = n // n_x, n // n_y
    f = stencil_ref.compute_dtype(dtype)
    planes = _oracle_planes(problem, mesh, f, k, nl)
    xch = _skf.exchange if with_halo else _self_exchange
    kw = dict(k=k, coeff=problem.a2tau2, inv_h2=problem.inv_h2,
              block_x=stencil_cuda.default_block_x(nl, k),
              with_errors=False)

    def run(u, v, carry):
        for _ in range(iters):
            ue, ug = xch(u, mesh, k)
            ve, vg = xch(v, mesh, k)
            outs = []
            for i, ((syz, rsyz), sxct) in enumerate(planes):
                if n_y == 1:
                    outs.append(stencil_cuda.fused_kstep_comp_sharded(
                        ue[i], ve[i], carry[i], ug[i], vg[i], syz, rsyz,
                        sxct, **kw))
                else:
                    cy = mesh.coords[i][1]
                    outs.append(stencil_cuda.fused_kstep_comp_sharded_xy(
                        ue[i], ve[i], carry[i], ug[i], vg[i], syz, rsyz,
                        sxct, cy * nl_y, n, nl_y=nl_y, **kw))
            u, v, carry = ([o[j] for o in outs] for j in range(3))
        return u

    return run


def measure_phase_breakdown(
    problem: Problem,
    mesh_shape: Optional[Tuple[int, int, int]] = None,
    devices: Optional[Sequence] = None,
    dtype=torch.float32,
    kernel: str = "pallas",
    overlap: bool = False,
    iters: int = 10,
    repeats: int = 3,
    fuse_steps: int = 1,
    scheme: str = "standard",
    v_dtype=None,
) -> PhaseBreakdown:
    """Measure the loop/exchange split and scale it to the full solve
    length.

    Runs on zero state - a step's cost does not depend on the data, and
    the probes exist for timing, not numerics.  `devices` (default: every
    visible card) lists the mesh's devices in mesh order and may repeat
    one.  `kernel`/`overlap` select the step the production solver would
    run; `fuse_steps > 1` probes the sharded k-fused march instead (any
    even (MX, MY, 1) decomposition; `iters` then counts k-blocks and the
    breakdown is scaled by the layers they cover); `scheme="compensated"`
    with `fuse_steps > 1` probes the distributed flagship, including the
    carry-less bf16-increment mode via `v_dtype=torch.bfloat16` (the
    1-step compensated scheme has no probe)."""
    devices = leapfrog.resolve_devices(devices)
    if mesh_shape is None:
        mesh_shape = choose_mesh_shape(len(devices))
    mesh_shape = tuple(mesh_shape)
    if scheme == "compensated" and fuse_steps < 2:
        raise ValueError(
            "the compensated probe covers fuse_steps > 1 programs; the "
            "1-step compensated scheme has none")
    if fuse_steps > 1:
        k = fuse_steps
        n_x, n_y = mesh_shape[0], mesh_shape[1]
        if mesh_shape[2] != 1:
            raise ValueError(
                f"k-fused probe needs an (MX, MY, 1) mesh, got {mesh_shape}"
            )
        _skf._validate(problem, k, n_x, n_y)  # same errors as production
        if not _skf._is_even(problem, k, n_x):
            raise ValueError(
                f"k-fused probe covers even decompositions "
                f"(k | N/MX); got N={problem.N}, MX={n_x}, k={k}"
            )
        if len(devices) < n_x * n_y:
            raise ValueError(f"mesh {mesh_shape} needs {n_x * n_y} "
                             f"devices, only {len(devices)} available")
        mesh = build_mesh(mesh_shape, devices[:n_x * n_y])
        if any(d.type == "cuda" for d in mesh.devices):
            stencil_cuda.load_libraries()
        shape = (problem.N // n_x, problem.N // n_y, problem.N)

        def zeros(dt):
            return [torch.zeros(shape, dtype=dt, device=d)
                    for d in mesh.devices]

        if scheme == "compensated":
            from wavetpu_torch.solver import kfused_comp as _kc

            vd = dtype if v_dtype is None else v_dtype
            carry_on = vd != torch.bfloat16 or dtype == torch.bfloat16
            state = (zeros(dtype), zeros(vd),
                     zeros(_kc._default_carry_dtype(dtype)) if carry_on
                     else [None] * (n_x * n_y))
            runner = _kfused_comp_probe_runner
        else:
            state = (zeros(dtype), zeros(dtype))
            runner = _kfused_probe_runner
        t_full = _time_best(runner(problem, mesh, dtype, k, True, iters),
                            state, mesh.devices, repeats)
        t_comp = _time_best(runner(problem, mesh, dtype, k, False, iters),
                            state, mesh.devices, repeats)
        scale = problem.timesteps / (iters * k)
        return PhaseBreakdown(
            loop_seconds=t_comp * scale,
            exchange_seconds=max(0.0, t_full - t_comp) * scale,
            steps_measured=iters * k,
        )
    topo, mesh = _sharded._resolve_mesh(problem, mesh_shape, devices)
    if kernel == "pallas" and any(d.type == "cuda" for d in mesh.devices):
        stencil_cuda.load_libraries()
    state = tuple([torch.zeros(topo.block, dtype=dtype, device=d)
                   for d in mesh.devices] for _ in range(2))
    t_full = _time_best(
        _probe_runner(problem, topo, mesh, kernel, overlap, True, iters),
        state, mesh.devices, repeats)
    t_comp = _time_best(
        _probe_runner(problem, topo, mesh, kernel, overlap, False, iters),
        state, mesh.devices, repeats)
    scale = problem.timesteps / iters
    return PhaseBreakdown(
        loop_seconds=t_comp * scale,
        exchange_seconds=max(0.0, t_full - t_comp) * scale,
        steps_measured=iters,
    )
