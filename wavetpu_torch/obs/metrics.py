"""Domain instruments over the process-wide registry (the port of
wavetpu/obs/metrics.py).

Thin helpers the solver / checkpoint / supervisor layers call at their
natural host boundaries (end of a solve, end of a checkpoint write) so
each call site stays one line.  Everything lands in
`registry.get_registry()` - the process-wide registry the telemetry
heartbeat snapshots and `wavetpu-torch trace-report` complements.  The
metric names and label sets are wavetpu's, so one scrape reads either
package.

Metric catalog (the README's port section is the user-facing copy):

  wavetpu_solves_total{path}            completed solve entry points
  wavetpu_solve_layers_total{path}      leapfrog layers marched
  wavetpu_solve_cells_total{path}       cell updates ((N+1)^3 x layers)
  wavetpu_solve_seconds_total{path}     solve wall seconds (excl compile)
  wavetpu_last_solve_gcells_per_s{path} gauge: most recent throughput
  wavetpu_checkpoint_ops_total{op,kind}      save/load x single/sharded
  wavetpu_checkpoint_bytes_total{op,kind}    file bytes moved
  wavetpu_checkpoint_seconds_total{op,kind}  wall seconds
  wavetpu_supervisor_chunks_total       chunk programs executed
  wavetpu_supervisor_checkpoints_total  rotation entries written
  wavetpu_supervisor_retries_total      watchdog auto-retries taken
  wavetpu_supervisor_watchdog_trips_total   health-check failures
  wavetpu_supervisor_step               gauge: last completed layer

Roofline + device-memory instruments (obs/perf.py owns the catalog):
`record_solve` also stamps the analytic cost model's verdict (modeled
GB/s, roofline fraction) for the config that ran and samples device
memory - host-side arithmetic and one allocator read per solve, after
the solve's own synchronisation (no per-step host sync).

Accuracy instruments (obs/accuracy.py owns the catalog): a solve that
computed oracle errors additionally stamps
`wavetpu_solve_max_abs_err{path,scheme,dtype}` plus the per-plan
log-bucketed `wavetpu_solve_abs_err` histogram and appends one
accuracy-ledger line under --telemetry-dir.
"""

from __future__ import annotations

from typing import Optional, Tuple

from wavetpu_torch.obs.registry import get_registry


def record_solve(result, path: str, *, scheme: str = "standard",
                 k: int = 1, v_itemsize: Optional[int] = None,
                 carry: bool = True, carry_itemsize: Optional[int] = None,
                 with_field: bool = False,
                 block: Optional[Tuple[int, int, int]] = None,
                 mesh_shape: Optional[Tuple[int, int, int]] = None,
                 rows: bool = False) -> Optional[dict]:
    """Per-solve throughput counters, called once at the end of each
    solver entry point.  `result` is a leapfrog.SolveResult; `path` names
    the solver family (leapfrog / compensated / kfused / kfused_comp[_
    sharded] / sharded / sharded_kfused).  The keyword args describe the
    config for the roofline model (obs/perf.py) - sharded paths pass the
    shard `block`, the `mesh_shape` and whether the kernels wrote error
    `rows`.  Returns the roofline attribution dict (None when the config
    has no model); the gauges it stamps are the canonical read path
    (cli.py reads them back for the cli.solve span)."""
    reg = get_registry()
    problem = result.problem
    steps = (
        result.steps_computed
        if result.steps_computed else problem.timesteps
    )
    cells = float(problem.cells_per_step) * steps
    reg.counter(
        "wavetpu_solves_total", "completed solve entry points", ("path",)
    ).inc(path=path)
    reg.counter(
        "wavetpu_solve_layers_total", "leapfrog layers marched", ("path",)
    ).inc(steps, path=path)
    reg.counter(
        "wavetpu_solve_cells_total",
        "cell updates marched ((N+1)^3 per layer)", ("path",)
    ).inc(cells, path=path)
    reg.counter(
        "wavetpu_solve_seconds_total",
        "solve wall seconds (excludes compile)", ("path",)
    ).inc(float(result.solve_seconds or 0.0), path=path)
    reg.gauge(
        "wavetpu_last_solve_gcells_per_s",
        "throughput of the most recent solve", ("path",)
    ).set(float(result.gcells_per_second or 0.0), path=path)
    # Accuracy observatory (obs/accuracy.py): a solve that computed
    # errors against the analytic oracle stamps its measured
    # max_abs_err (gauge + log-bucketed histogram) and appends one
    # accuracy-ledger line under --telemetry-dir.  Guarded separately
    # from the roofline block so neither X-ray can starve the other.
    try:
        from wavetpu_torch.obs import accuracy

        accuracy.observe_solve(result, path, scheme=scheme, k=k,
                               with_field=with_field, registry=reg)
    except Exception:
        pass
    # Roofline attribution + device-memory sample (obs/perf.py): both a
    # few host-side ops per solve; memory sampling short-circuits after
    # one probe without a card.  Guarded: the X-ray must never fail the
    # solve it measures.
    try:
        from wavetpu_torch.obs import perf

        attribution = perf.record_roofline(reg, path, perf.solve_perf(
            float(result.gcells_per_second or 0.0), path, scheme=scheme,
            k=k, n=problem.N, itemsize=result.u_cur.dtype.itemsize,
            v_itemsize=v_itemsize, carry=carry,
            carry_itemsize=carry_itemsize, with_field=with_field,
            block=block, mesh_shape=mesh_shape, rows=rows,
        ))
        perf.record_memory(reg, context="solve")
        return attribution
    except Exception:
        return None


def record_checkpoint_io(op: str, kind: str, nbytes: float,
                         seconds: float) -> None:
    """Checkpoint I/O accounting: `op` save|load, `kind` single|sharded."""
    reg = get_registry()
    labels = dict(op=op, kind=kind)
    reg.counter(
        "wavetpu_checkpoint_ops_total", "checkpoint operations",
        ("op", "kind")
    ).inc(**labels)
    reg.counter(
        "wavetpu_checkpoint_bytes_total", "checkpoint file bytes moved",
        ("op", "kind")
    ).inc(float(nbytes), **labels)
    reg.counter(
        "wavetpu_checkpoint_seconds_total", "checkpoint I/O wall seconds",
        ("op", "kind")
    ).inc(float(seconds), **labels)


def supervisor_counter(name: str, help: str):
    return get_registry().counter(f"wavetpu_supervisor_{name}", help)


def supervisor_step_gauge():
    return get_registry().gauge(
        "wavetpu_supervisor_step", "last completed layer of the "
        "supervised march"
    )
