"""Scenario traces: the loadgen workload format, generators, recorder
(the port's copy of wavetpu/loadgen/trace.py; the format is wavetpu's).

Format (JSONL, one request per line, `t`-ordered):

    {"t": 0.153, "scenario": "small-standard",
     "body": {"N": 8, "timesteps": 20, "phase": 1.0},
     "error_budget": 1e-3}

 * `t`        - seconds since trace start: the OPEN-LOOP replay offset
                (closed-loop replay ignores it and drives by
                concurrency).
 * `scenario` - the tier label per-tier SLO reporting groups by; when
                absent it is derived from the body (`scenario_label`).
 * `body`     - the verbatim POST /solve JSON (serve/api.py request
                fields: N, timesteps, steps, scheme, kernel,
                fuse_steps, dtype, phase, c2_field, mesh, ...).
 * `error_budget` - ADVISORY accuracy SLO for the tier, recorded so
                traces stay forward-compatible with the accuracy-aware
                autotuner direction (ROADMAP #5: requests declare an
                error budget instead of a scheme).  Not sent to the
                server today.
 * `tenant` / `api_key` / `priority` - OPTIONAL multi-tenant QoS
                fields: the runner sends them as X-Wavetpu-Tenant /
                X-Api-Key / X-Priority request headers (wavetpu's
                docs/fleet.md "API keys", docs/serving.md "Priority
                classes"), and
                the report breaks latency/429 rates down per tenant
                and per class.  The `tenants` mix generates a seeded
                aggressor-vs-victim two-tenant trace with them set.

Generators are seeded and deterministic: the same (mix, duration, qps,
seed) always emits the same trace, so a CI regression gate compares
like against like.  `TraceRecorder` is the server-side half: `python -m
wavetpu_torch serve --record-trace FILE` appends every ACCEPTED /solve
body with its arrival offset, producing a trace that replays real
traffic.
"""

from __future__ import annotations

import json
import math
import os
import random
import threading
import time
from typing import Dict, List, Optional, Sequence

MIXES = ("uniform", "poisson", "diurnal", "hotkey", "tenants")

# The multi-tenant QoS record fields (optional per record; the runner
# maps them onto request headers).
QOS_FIELDS = ("tenant", "api_key", "priority")


def scenario_label(body: dict) -> str:
    """A stable tier label derived from the program-identity-ish body
    fields - what the recorder and the report use when a record carries
    no explicit scenario name."""
    parts = [f"N{body.get('N', '?')}/{body.get('timesteps', 20)}"]
    parts.append(str(body.get("scheme", "standard")))
    if body.get("fuse_steps", 1) and int(body.get("fuse_steps", 1)) > 1:
        parts.append(f"k{body['fuse_steps']}")
    if body.get("kernel"):
        parts.append(str(body["kernel"]))
    if body.get("dtype", "f32") != "f32":
        parts.append(str(body["dtype"]))
    if body.get("c2_field"):
        parts.append(str(body["c2_field"]))
    if body.get("steps") is not None:
        parts.append(f"stop{body['steps']}")
    if body.get("mesh"):
        parts.append("mesh" + "x".join(str(m) for m in body["mesh"]))
    return "-".join(parts)


def default_scenarios(n: int = 8, timesteps: int = 20,
                      pallas: bool = False) -> List[dict]:
    """The standard mixed-traffic tier set: N, steps, scheme, phase and
    c2-field presets all vary (every knob the batcher shape-buckets on),
    with per-tier advisory error budgets.  `pallas=True` adds a k-fused
    tier (`kernel: pallas`, k=2: the CUDA k-step kernel on a card).
    Bodies deliberately omit `kernel` so the server's --kernel default
    resolves per backend."""
    t = int(timesteps)
    tiers = [
        {"name": "small-standard", "weight": 4, "error_budget": 1e-3,
         "body": {"N": n, "timesteps": t}},
        # Shifted phase: distinct per-lane work that still batches with
        # the reference-phase tier (same program identity).
        {"name": "small-phase", "weight": 3, "error_budget": 1e-3,
         "body": {"N": n, "timesteps": t, "phase": 1.0}},
        # Early stop: exercises per-lane stop masking and (when the
        # server runs --length-bucket-steps) the length buckets.
        {"name": "small-stop", "weight": 2, "error_budget": 1e-3,
         "body": {"N": n, "timesteps": t, "steps": max(2, t // 2)}},
        # The flagship accuracy scheme through the vmapped core.
        {"name": "compensated", "weight": 2, "error_budget": 1e-5,
         "body": {"N": n, "timesteps": t, "scheme": "compensated"}},
        # Variable-c preset: no analytic oracle, field-keyed programs.
        {"name": "lens-field", "weight": 1, "error_budget": None,
         "body": {"N": n, "timesteps": t, "c2_field": "gaussian-lens"}},
        # A longer march: a distinct program identity (timesteps is in
        # the bucket key), so the mix always spans >= 2 programs.
        {"name": "long", "weight": 1, "error_budget": 1e-3,
         "body": {"N": n, "timesteps": 2 * t}},
    ]
    if pallas:
        tiers.append(
            {"name": "kfused", "weight": 2, "error_budget": 1e-3,
             "body": {"N": n, "timesteps": t, "kernel": "pallas",
                      "fuse_steps": 2}},
        )
    return tiers


def _record(t: float, tier: dict, body: Optional[dict] = None) -> dict:
    rec = {
        "t": round(t, 6),
        "scenario": tier["name"],
        "body": dict(body if body is not None else tier["body"]),
    }
    if tier.get("error_budget") is not None:
        rec["error_budget"] = tier["error_budget"]
    for f in QOS_FIELDS:
        if tier.get(f):
            rec[f] = tier[f]
    return rec


def _weighted(rng: random.Random, scenarios: Sequence[dict]) -> dict:
    return rng.choices(
        list(scenarios),
        weights=[s.get("weight", 1) for s in scenarios],
    )[0]


def gen_uniform(duration: float, qps: float, scenarios: Sequence[dict],
                seed: int = 0) -> List[dict]:
    """Evenly spaced arrivals, scenarios drawn by weight: the baseline
    steady-state mix."""
    rng = random.Random(seed)
    n = max(1, int(duration * qps))
    gap = duration / n
    return [
        _record(i * gap, _weighted(rng, scenarios)) for i in range(n)
    ]


def gen_poisson(duration: float, qps: float, scenarios: Sequence[dict],
                seed: int = 0) -> List[dict]:
    """Open-loop Poisson arrivals (exponential inter-arrival times):
    the bursty mix - back-to-back clusters that fill batches and gaps
    that let the max-wait window idle out."""
    rng = random.Random(seed)
    out, t = [], 0.0
    while True:
        t += rng.expovariate(qps)
        if t >= duration:
            break
        out.append(_record(t, _weighted(rng, scenarios)))
    if not out:  # a tiny duration*qps must still emit one request
        out.append(_record(0.0, _weighted(rng, scenarios)))
    return out


def gen_diurnal(duration: float, qps: float, scenarios: Sequence[dict],
                seed: int = 0) -> List[dict]:
    """A ramp-up/ramp-down day compressed into `duration`: Poisson
    thinning of a peak-rate `qps` process against a raised-cosine rate
    curve (0 at the edges, `qps` mid-trace).  Exercises both the
    under-occupied ramp and the saturated peak in one trace."""
    rng = random.Random(seed)
    out, t = [], 0.0
    while True:
        t += rng.expovariate(qps)
        if t >= duration:
            break
        rate_frac = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / duration))
        if rng.random() < rate_frac:
            out.append(_record(t, _weighted(rng, scenarios)))
    if not out:
        out.append(_record(duration / 2.0, _weighted(rng, scenarios)))
    return out


def gen_hotkey(duration: float, qps: float, scenarios: Sequence[dict],
               seed: int = 0, distinct: int = 12,
               hot_frac: float = 0.7) -> List[dict]:
    """Cache-adversarial: `hot_frac` of requests hit one hot program
    key, the rest cycle through `distinct` cold keys (the hot body with
    shifted `timesteps`, each a distinct ProgramKey).  With `distinct`
    above the server's --max-programs this thrashes the LRU - the mix
    that makes cold-vs-warm compile counts and eviction rates in the
    report mean something."""
    rng = random.Random(seed)
    hot = scenarios[0]
    out, t, i = [], 0.0, 0
    while True:
        t += rng.expovariate(qps)
        if t >= duration:
            break
        if rng.random() < hot_frac:
            out.append(_record(t, hot))
        else:
            body = dict(hot["body"])
            body["timesteps"] = int(body.get("timesteps", 20)) + 1 + (
                i % max(1, distinct)
            )
            cold = {"name": f"cold-{i % max(1, distinct)}",
                    "error_budget": hot.get("error_budget")}
            out.append(_record(t, cold, body))
            i += 1
    if not out:
        out.append(_record(0.0, hot))
    return out


def gen_tenants(duration: float, qps: float, scenarios: Sequence[dict],
                seed: int = 0, victim_frac: float = 0.4,
                victim_tenant: str = "victim",
                aggressor_tenant: str = "aggressor",
                victim_key: Optional[str] = None,
                aggressor_key: Optional[str] = None,
                aggressor_mult: int = 4) -> List[dict]:
    """The aggressor-vs-victim isolation drill: two interleaved Poisson
    streams.  The VICTIM replays the weighted scenario mix at
    `victim_frac` of `qps`, every request `interactive`; the AGGRESSOR
    fires long marches (the first scenario's body with `timesteps`
    multiplied by `aggressor_mult` - a heavier, distinct program
    identity) at the remaining rate, every request `best_effort`.  Each
    record carries its tenant label (and api_key when given), so a
    replay through a quota-enforcing router shows the aggressor eating
    429s while the victim's interactive p95 holds - the bench `qos`
    row's and the CI QoS smoke's workload.  Deterministic in
    (duration, qps, seed, scenarios)."""
    rng = random.Random(seed)
    v_qps = max(qps * victim_frac, 1e-9)
    a_qps = max(qps - v_qps, 1e-9)
    out: List[dict] = []
    t = 0.0
    while True:
        t += rng.expovariate(v_qps)
        if t >= duration:
            break
        tier = dict(_weighted(rng, scenarios))
        tier["name"] = f"victim-{tier['name']}"
        tier["tenant"] = victim_tenant
        tier["priority"] = "interactive"
        if victim_key:
            tier["api_key"] = victim_key
        out.append(_record(t, tier))
    hot = scenarios[0]
    body = dict(hot["body"])
    body["timesteps"] = int(
        body.get("timesteps", 20)
    ) * max(1, aggressor_mult)
    agg_tier = {
        "name": "aggressor-long",
        "error_budget": None,
        "tenant": aggressor_tenant,
        "priority": "best_effort",
    }
    if aggressor_key:
        agg_tier["api_key"] = aggressor_key
    t = 0.0
    while True:
        t += rng.expovariate(a_qps)
        if t >= duration:
            break
        out.append(_record(t, agg_tier, body))
    if not out:
        out.append(_record(0.0, agg_tier, body))
    out.sort(key=lambda r: r["t"])
    return out


_GENERATORS = {
    "uniform": gen_uniform,
    "poisson": gen_poisson,
    "diurnal": gen_diurnal,
    "hotkey": gen_hotkey,
    "tenants": gen_tenants,
}


def generate(mix: str, duration: float, qps: float,
             scenarios: Optional[Sequence[dict]] = None, seed: int = 0,
             **kw) -> List[dict]:
    """Generate a synthetic scenario trace.  Deterministic in
    (mix, duration, qps, seed, scenarios)."""
    if mix not in _GENERATORS:
        raise ValueError(f"mix must be one of {MIXES}, got {mix!r}")
    if duration <= 0 or qps <= 0:
        raise ValueError(
            f"duration and qps must be > 0, got {duration}/{qps}"
        )
    if scenarios is None:
        scenarios = default_scenarios()
    return _GENERATORS[mix](duration, qps, scenarios, seed=seed, **kw)


def save_scenario_trace(path: str, records: Sequence[dict]) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def load_scenario_trace(path: str) -> List[dict]:
    """Parse + validate a scenario trace; returns records sorted by t.
    Raises ValueError on a structurally broken record (a bad trace must
    fail the replay loudly, not fire garbage at a production server)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}")
            if not isinstance(rec, dict) or not isinstance(
                rec.get("body"), dict
            ):
                raise ValueError(
                    f"{path}:{lineno}: record needs an object 'body'"
                )
            t = rec.get("t", 0.0)
            if not isinstance(t, (int, float)) or t < 0:
                raise ValueError(
                    f"{path}:{lineno}: 't' must be a number >= 0, "
                    f"got {t!r}"
                )
            for f in QOS_FIELDS:
                v = rec.get(f)
                if v is not None and (
                    not isinstance(v, str) or not v
                ):
                    raise ValueError(
                        f"{path}:{lineno}: {f!r} must be a non-empty "
                        f"string, got {v!r}"
                    )
            rec.setdefault("scenario", scenario_label(rec["body"]))
            out.append(rec)
    if not out:
        raise ValueError(f"{path}: empty trace")
    out.sort(key=lambda r: r["t"])
    return out


class TraceRecorder:
    """Server-side traffic capture: one accepted /solve body per line,
    timestamped relative to the FIRST recorded request, so the file is
    directly a replayable scenario trace.  Thread-safe (handler threads
    record concurrently); writes are best-effort - recording must never
    fail the request it observes (same discipline as obs/tracing.py)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._t0: Optional[float] = None

    def record(self, body: dict, request_id: Optional[str] = None,
               scenario: Optional[str] = None) -> None:
        now = time.monotonic()
        rec: Dict = {"body": body}
        try:
            with self._lock:
                if self._t0 is None:
                    self._t0 = now
                rec["t"] = round(now - self._t0, 6)
                rec["scenario"] = scenario or scenario_label(body)
                if request_id:
                    rec["id"] = request_id
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()
        except (OSError, ValueError, TypeError):
            pass

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()
