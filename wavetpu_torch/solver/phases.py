"""The phases of a solver call, as spans that also give its timings.

Every timed solver entry point (`leapfrog.solve`, `resume`,
`solve_compensated`, `resume_compensated`, `kfused.solve_kfused`,
`resume_kfused`, the `kfused_comp` and `sharded*` solves and resumes)
runs inside one `SolveSpans`:

    solver.solve       path, N, steps, k
      solver.init        kernels loaded, oracle tables, state on the
                         device, up to a device synchronisation
      solver.bootstrap   layer 1 and its error row (entries that start
                         at layer 0; inside the `make_*solver` runner)
      solver.march       the layers after it
      solver.readback    the error vectors to the host and the final
                         synchronisation
      obs.record_solve   the solve's counters and gauges (obs/metrics.py)

`init_seconds` is solver.init's duration and `solve_seconds` runs from
its end to the end of solver.readback: the reference's two timing phases,
taken from the spans' own clock readings (obs/tracing.TimedSpan), so a
JSONL record's `dur_s` and the SolveResult agree.  The spans are host
time and add no synchronisation: in a profiler's trace the device work
of a phase is the work its host span launched (launch correlation).
With neither a tracer nor a recording profiler a span costs a flag read.
"""

from __future__ import annotations

from wavetpu_torch.obs import metrics as obs_metrics
from wavetpu_torch.obs import tracing


def bootstrap():
    """The span of layer 1 and its error row."""
    return tracing.span("solver.bootstrap")


def march():
    """The span of the layers after the bootstrap."""
    return tracing.span("solver.march")


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
