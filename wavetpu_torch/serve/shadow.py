"""Shadow-solve sampling: measured accuracy telemetry off the hot path
(the port of wavetpu/serve/shadow.py).

`serve --shadow-sample-rate P` re-solves a sampled fraction of eligible
production requests with the REFERENCE plan - compensated f32 at k=1,
the most accurate config the solver family has - and
ledgers the measured L-infinity divergence of the SERVED plan's answer
vs its reference twin (obs/accuracy.py, `source: "shadow"`).  That is
accuracy telemetry even where no analytic oracle exists (custom c2
fields, shifted phases): the oracle-error ledger lines cover requests
the server could verify analytically; shadow divergence covers the
rest, and for bf16/onion plans it measures exactly the rounding gap
the speed-accuracy plan table (`plan-report`) trades against.

On the card the twin runs the reference plan through K2's lane mode
(path `pallas`); on the CPU through its plain version (path `roll`, as
wavetpu).  K2 equals its plain version bit for bit on the card, so the
divergence is the same number; `_is_reference` treats roll and pallas
alike at compensated / k=1 / f32.  The twin compares final layers, so a
replica with a sampler keeps each lane's final layer after the
engine's release (`ServeEngine.keep_final_state`).

The shadow contract (every clause chaos-drilled in tests):

 * OFF THE HOT PATH - the primary response is computed, sent, and
   byte-identical whether or not its shadow runs; the sampler only
   ever runs AFTER the primary 200 is on the wire.
 * best_effort priority - a shadow enters the scheduler at the lowest
   QoS class, so the deficit round-robin starves it before any
   production class feels it.
 * deadline-capped - a shadow that cannot be served within
   `deadline_s` is dropped by the scheduler like any expired-budget
   request (counted as a shadow failure, nothing more).
 * ONE IN FLIGHT - a second sample while one shadow runs is skipped
   (counted), so shadow load is bounded at one lane regardless of P.
 * NEVER feeds the circuit breaker - a batch of only shadow lanes runs
   with the breaker bypassed (engine.solve(feed_breaker=False)), so a
   failing reference plan can never quarantine a program production
   traffic depends on.
 * chaos seam `WAVETPU_FAULT=serve-shadow-fail` crashes the shadow
   worker before the twin runs, proving a shadow failure is counted
   and invisible to the primary.

Shadow spans (`serve.shadow`) adopt the origin request's trace context
as their remote parent, so `trace-report --request ID` shows
the sampled request and its reference twin in one tree.

Eligibility (the rest is counted under
`wavetpu_shadow_skipped_total{reason}`):

  reason           skipped when
  ---------------  ------------------------------------------------
  unsampled        the rate draw said no (or rate is 0)
  reference-plan   the request already IS the reference plan -
                   divergence would be identically zero
  resume           resume-token continuation (partial march; the
                   twin would not solve the same thing)
  mesh             sharded request (the reference twin is single-
                   device by definition)
  busy             one shadow already in flight
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Optional, Tuple

from wavetpu_torch.obs import accuracy, tracing

# The reference plan: the compensated velocity form in f32 at k=1, on
# the roll path (the plain versions) on the CPU and on K2's lane mode
# (`pallas`) on the card.
REFERENCE_SCHEME = "compensated"
REFERENCE_PATH = "roll"
REFERENCE_PATHS = ("roll", "pallas")
REFERENCE_DTYPE = "f32"

DEFAULT_DEADLINE_S = 120.0

_SKIP_REASONS = ("unsampled", "reference-plan", "resume", "mesh", "busy")


class ShadowSampler:
    """One per server (ServerState.shadow); `offer()` is the only hot-
    path touch point and does a rate draw + a non-blocking busy check
    before spawning the off-path worker."""

    def __init__(self, batcher, registry, rate: float,
                 fault_plan=None, deadline_s: float = DEFAULT_DEADLINE_S,
                 seed: Optional[int] = None,
                 reference_path: str = REFERENCE_PATH):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(
                f"--shadow-sample-rate must be in [0, 1], got {rate}"
            )
        self.batcher = batcher
        self.registry = registry
        self.rate = float(rate)
        self.fault_plan = fault_plan
        self.deadline_s = float(deadline_s)
        # "pallas" on the card (K2's lane mode), "roll" on the CPU.
        self.reference_path = reference_path
        self._rng = random.Random(seed)
        self._busy = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._solves = registry.counter(
            "wavetpu_shadow_solves_total",
            "completed shadow solves (divergence measured + ledgered)",
        )
        self._failures = registry.counter(
            "wavetpu_shadow_failures_total",
            "shadow solves that crashed, timed out, or were injected "
            "to fail - never visible to the primary answer",
        )
        self._skipped = registry.counter(
            "wavetpu_shadow_skipped_total",
            "offered requests not shadowed, by reason", ("reason",),
        )

    # ---- eligibility ----

    def _is_reference(self, request) -> bool:
        k = request.k if request.path == "kfused" else 1
        return (
            request.scheme == REFERENCE_SCHEME
            and request.path in REFERENCE_PATHS
            and k == 1
            and request.dtype_name == REFERENCE_DTYPE
        )

    def ineligible_reason(self, request) -> Optional[str]:
        """None = eligible; else the skip-counter reason label."""
        if request.resume_token is not None:
            return "resume"
        if request.mesh_shape is not None:
            return "mesh"
        if self._is_reference(request):
            return "reference-plan"
        return None

    def reference_request(self, request):
        """The reference twin: same problem, same lane (phase, stop
        step, c2 field all ride along - the twin must solve the SAME
        physics), reference plan, best_effort class.  A c2-field lane
        keeps the standard scheme (the compensated velocity form has
        no field variant) - still the f32 roll reference for that
        physics."""
        scheme = (
            "standard" if request.lane.c2tau2_field is not None
            else REFERENCE_SCHEME
        )
        return dataclasses.replace(
            request, scheme=scheme, path=self.reference_path, k=1,
            dtype_name=REFERENCE_DTYPE, resume_token=None,
            priority="best_effort", shadow=True, probes=None,
        )

    # ---- hot-path touch point ----

    def offer(self, request, lane_result, request_id: Optional[str],
              trace_context: Optional[Tuple[str, str]] = None) -> bool:
        """Called by the HTTP handler AFTER a successful primary
        response is ready; returns True when a shadow was launched.
        Everything here is host-side bookkeeping - the twin itself
        runs on the sampler's own daemon thread."""
        reason = self.ineligible_reason(request)
        if reason is None and (
            self.rate <= 0.0
            or (self.rate < 1.0 and self._rng.random() >= self.rate)
        ):
            reason = "unsampled"
        if reason is None and not self._busy.acquire(blocking=False):
            reason = "busy"
        if reason is not None:
            self._skipped.inc(reason=reason)
            return False
        t = threading.Thread(
            target=self._run, name="wavetpu-shadow", daemon=True,
            args=(request, lane_result, request_id, trace_context),
        )
        self._thread = t
        t.start()
        return True

    # ---- off-path worker ----

    def _run(self, request, lane_result, request_id, trace_context):
        span = None
        try:
            if tracing.enabled():
                span = tracing.begin_span(
                    "serve.shadow", remote=trace_context,
                    request_id=request_id,
                    scheme=request.scheme, path=request.path,
                    k=request.k, dtype=request.dtype_name,
                )
            # Chaos seam: the shadow worker dies before the twin runs.
            # Fired HERE - outside the engine - so the drill also
            # proves the breaker never hears a shadow crash.
            plan = self.fault_plan
            if plan is not None and plan.active and plan.fire(
                "shadow-fail", n=request.problem.N,
                timesteps=request.problem.timesteps,
                scheme=request.scheme, path=request.path,
                k=request.k, dtype=request.dtype_name,
            ):
                from wavetpu_torch.run.faults import InjectedFault

                raise InjectedFault("injected shadow-solve crash")
            div = self._solve_twin(request, lane_result, request_id,
                                   trace_context)
            self._solves.inc()
            if span is not None:
                tracing.end_span(span, status="ok", divergence=div)
                span = None
        except Exception as e:
            # ANY shadow failure is a counter tick and nothing else -
            # the primary answer went out before this thread existed.
            self._failures.inc()
            if span is not None:
                tracing.end_span(span, error=str(e))
                span = None
        finally:
            if span is not None:
                tracing.end_span(span, status="ok")
            self._busy.release()

    def _solve_twin(self, request, lane_result, request_id,
                    trace_context) -> float:
        import numpy as np

        ref_req = self.reference_request(request)
        rid = f"{request_id}.shadow" if request_id else None
        deadline = time.monotonic() + self.deadline_s
        fut = self.batcher.submit(
            ref_req, request_id=rid, deadline=deadline,
            trace_context=trace_context,
        )
        ref_result, ref_error, _info = fut.result(self.deadline_s + 5.0)
        if ref_error is not None:
            raise RuntimeError(f"reference twin unhealthy: {ref_error}")
        served = _host_f32(lane_result.u_cur)
        ref = _host_f32(ref_result.u_cur)
        div = float(np.max(np.abs(served - ref)))
        problem = request.problem
        steps = (
            getattr(lane_result, "steps_computed", None)
            or problem.timesteps
        )
        plan = accuracy.make_plan(
            request.scheme, request.path, request.k,
            request.dtype_name,
            with_field=request.lane.c2tau2_field is not None,
        )
        accuracy.record_error_metrics(self.registry, plan, div,
                                      shadow=True)
        accuracy.record_accuracy(
            plan, problem.N, problem.timesteps, div,
            float(lane_result.solve_seconds or 0.0),
            float(problem.cells_per_step) * steps, source="shadow",
        )
        return div

    # ---- introspection ----

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Join the in-flight shadow, if any (tests + drain): True when
        no shadow is running on return."""
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
            return not t.is_alive()
        return True

    def snapshot(self) -> dict:
        """The /metrics JSON `shadow` block."""
        skipped = {
            reason: self._skipped.value(reason=reason)
            for reason in _SKIP_REASONS
            if self._skipped.value(reason=reason)
        }
        return {
            "rate": self.rate,
            "solves": self._solves.value(),
            "failures": self._failures.value(),
            "skipped": skipped,
        }


def _host_f32(u):
    """A final layer (tensor on any device, or array) as host f32."""
    import numpy as np
    import torch

    if isinstance(u, torch.Tensor):
        return u.detach().to(torch.float32).cpu().numpy()
    return np.asarray(u, dtype=np.float32)
