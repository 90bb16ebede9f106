"""Fault-injection harness: break things on purpose, prove recovery fires
(the run side of wavetpu/run/faults.py).

io/checkpoint.py and io/nativeio.py carry rejection branches (CRC
footers, truncation checks, mixed-step detection); the injectors below
drive each one:

 * on-disk faults - `flip_byte` (CRC failure), `truncate_tail`
   (structural truncation), `rewrite_shard_step` (stale-step shard with a
   VALID CRC, i.e. the mixed-step fallback, not the checksum)
 * in-flight faults - chunk hooks for run/supervisor.py's fault port:
   `nan_at_step` (a NaN the watchdog must catch), `preempt_at_step` (a
   real SIGTERM delivered to this process mid-march - the kill-and-resume
   drill)

Chunk hooks have signature `hook(state, step) -> state` and run after a
chunk completes, BEFORE the health check and checkpoint save - exactly
where a hardware glitch would land.  `hook_from_env` wires the same
injectors to the `WAVETPU_FAULT` env var ("nan:STEP" | "preempt:STEP") so
CLI-level tests can drill the full exit-code path of a live process.
The same env var ports the harness into the serving replica: its
semicolon-separated `serve-*` specs build a `ServeFaultPlan`
(`serve_plan_from_env`) that the engine, scheduler and HTTP layer consult
at their seams - `serve-compile-fail` (the program build raises
`InjectedFault`: the circuit breaker and the retrying client),
`serve-execute-nan` (a batch's final state poisoned after the solve: the
per-lane watchdog 422s it), `serve-slow-batch:seconds=S` (the worker
sleeps before the batch), `serve-worker-crash` (the scheduler worker
raises mid-batch: its supervisor restarts it) and `serve-conn-drop` (the
handler closes the socket unanswered); the program cache's
(`progcache-truncate`, `progcache-fingerprint`: serve/progcache.py), the
preemptible long solves' (`chunk-crash`, `handoff-corrupt`: the
scheduler), the result cache's (`resultcache-*`) and the shadow
sampler's (`shadow-fail`).  The router tier's kinds (`router-*`,
`store-*`; ROADMAP.md queue 1 item 12c) parse now and fire once their
seams exist.  Selectors (`n`, `timesteps`, `scheme`,
`path`, `k`, `dtype`) match the batch's program identity; every firing is
counted as `wavetpu_serve_fault_injections_total{kind=}`.  The run side
ignores the serving and router specs.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, List, Optional


class InjectedFault(RuntimeError):
    """A deliberately injected failure; its type matters only to tests."""


# ---------------------------------------------------------------- on disk


def flip_byte(path: str, offset: Optional[int] = None, xor: int = 0x01):
    """XOR one byte of `path` in place (default: mid-file, where a shard's
    array payload lives) - the minimal corruption a CRC must catch."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path} is empty; nothing to flip")
    if offset is None:
        offset = size // 2
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ (xor & 0xFF)]))
    return offset


def truncate_tail(path: str, drop_bytes: int = 16) -> int:
    """Chop `drop_bytes` off the end of `path` (a torn write / full disk /
    killed writer).  Returns the new size."""
    size = os.path.getsize(path)
    new = max(0, size - drop_bytes)
    with open(path, "r+b") as f:
        f.truncate(new)
    return new


def rewrite_shard_step(ckpt_dir: str, new_step: int,
                       shard_name: Optional[str] = None) -> str:
    """Rewrite one WTS shard of a sharded checkpoint with `new_step` in its
    meta - CRC-valid but disagreeing with meta.npz, i.e. the stale shard a
    preempted save over an older checkpoint leaves behind.  Returns the
    shard path."""
    from wavetpu_torch.io import nativeio

    if shard_name is None:
        shards = sorted(
            f for f in os.listdir(ckpt_dir)
            if f.startswith("shard_") and f.endswith(".wts")
        )
        if not shards:
            raise FileNotFoundError(f"no .wts shards in {ckpt_dir}")
        shard_name = shards[0]
    path = os.path.join(ckpt_dir, shard_name)
    fields, meta = nativeio.read_container(path)
    meta = dict(meta, step=int(new_step))
    nativeio.write_container_sync(path, fields, meta)
    return path


# --------------------------------------------------------------- in flight


def _poison(a):
    """A copy of one state array (tensor or ShardedArray) with its first
    element NaN (under --distributed, where the rank holds shard 0)."""
    blocks = getattr(a, "blocks", None)
    if blocks is not None:
        import dataclasses

        if blocks[0] is None:
            return a
        first = blocks[0].clone()
        first.view(-1)[0] = float("nan")
        return dataclasses.replace(a, blocks=[first] + list(blocks[1:]))
    out = a.clone()
    out.view(-1)[0] = float("nan")
    return out


def nan_at_step(step: int, array_index: int = 1, once: bool = True):
    """Chunk hook: poison one element of state array `array_index` (default
    1 = u_cur of a standard state, v of a compensated one) with NaN at the
    first chunk boundary >= `step`.  With `once` (the transient-fault
    model) the second attempt after an auto-retry reload runs clean."""
    fired = [False]

    def hook(state, cur_step):
        if cur_step < step or (once and fired[0]):
            return state
        fired[0] = True
        state = list(state)
        state[array_index] = _poison(state[array_index])
        return tuple(state)

    return hook


def preempt_at_step(step: int, sig: int = signal.SIGTERM, once: bool = True):
    """Chunk hook: deliver `sig` to THIS process at the first chunk
    boundary >= `step` - a deterministic stand-in for the scheduler's
    preemption notice.  The supervisor's handler must then finish the
    bookkeeping, save, and exit resumable (exit code 3)."""
    fired = [False]

    def hook(state, cur_step):
        if cur_step >= step and not (once and fired[0]):
            fired[0] = True
            os.kill(os.getpid(), sig)
        return state

    return hook


ENV_FAULT = "WAVETPU_FAULT"
# Specs of the serving and router tiers, ignored by the run side.
_OTHER_TIERS = ("serve-", "router-", "store-")


def hook_from_env(env: Optional[dict] = None):
    """The CLI port of the harness: WAVETPU_FAULT="nan:STEP" or
    "preempt:STEP" returns the matching chunk hook (None when unset).
    Semicolon-separated specs of the serving and router tiers are ignored,
    so such an env leaking into a run must not crash it; more than one
    run-side spec is an error (a second one would never fire)."""
    env = os.environ if env is None else env
    spec = env.get(ENV_FAULT)
    if not spec:
        return None
    run_specs = [part.strip() for part in spec.split(";")
                 if part.strip() and not part.strip().startswith(
                     _OTHER_TIERS)]
    if not run_specs:
        return None
    if len(run_specs) > 1:
        raise ValueError(
            f"{ENV_FAULT}: at most one run-side spec, got {run_specs}"
        )
    kind, _, at = run_specs[0].partition(":")
    try:
        step = int(at)
    except ValueError:
        step = None
    if kind == "nan" and step is not None:
        return nan_at_step(step)
    if kind == "preempt" and step is not None:
        return preempt_at_step(step)
    raise ValueError(
        f"{ENV_FAULT}={run_specs[0]!r}: want 'nan:STEP' or 'preempt:STEP'"
    )


# ------------------------------------------------------------ serve path


SERVE_KINDS = ("compile-fail", "execute-nan", "slow-batch",
               "worker-crash", "conn-drop", "progcache-truncate",
               "progcache-fingerprint", "chunk-crash",
               "handoff-corrupt", "resultcache-corrupt",
               "resultcache-stale-fingerprint", "shadow-fail")

# Router-tier chaos kinds (full spec names - they keep their prefix,
# unlike serve specs, because `router-` and `store-` faults fire in
# DIFFERENT modules: the router data path, fleet/store.py loads, and
# fleet/ha.py lease renewals respectively).
ROUTER_KINDS = ("router-crash", "store-corrupt", "store-stale-lease")
_ROUTER_PREFIXES = ("router-", "store-")

# Program-identity fields a selector may match on (ctx keys the serve
# seams pass to `fire`).
_SELECTOR_FIELDS = ("n", "timesteps", "scheme", "path", "k", "dtype")


class ServeInjection:
    """One armed serve-path injection: a kind, an optional program-
    identity selector, and firing budgets (`after` eligible events are
    skipped first; `count` bounds total fires, None = unlimited)."""

    def __init__(self, kind: str, match: Optional[Dict[str, str]] = None,
                 count: Optional[int] = None, after: int = 0,
                 seconds: float = 0.0):
        if kind not in SERVE_KINDS and kind not in ROUTER_KINDS:
            raise ValueError(
                f"unknown serve fault kind {kind!r}; want one of "
                f"{SERVE_KINDS + ROUTER_KINDS}"
            )
        self.kind = kind
        self.match = dict(match or {})
        if kind == "conn-drop" and self.match:
            # conn-drop fires before the body is parsed - there is no
            # program identity to match, so a selector would silently
            # never fire (the inverse of the counted-firings goal).
            raise ValueError(
                "serve-conn-drop takes no selector (it fires before "
                f"the request is parsed); got {sorted(self.match)}"
            )
        for f in self.match:
            if f not in _SELECTOR_FIELDS:
                raise ValueError(
                    f"serve-{kind}: unknown selector field {f!r}; want "
                    f"one of {_SELECTOR_FIELDS}"
                )
        self.count = count
        self.after = after
        self.seconds = seconds
        self.fired = 0

    def matches(self, ctx: Dict) -> bool:
        return all(
            str(ctx.get(f)) == str(v) for f, v in self.match.items()
        )

    def snapshot(self) -> dict:
        return {
            "kind": self.kind,
            "match": dict(self.match),
            "fired": self.fired,
            "remaining": self.count,
            "after": self.after,
            "seconds": self.seconds,
        }


class ServeFaultPlan:
    """The serve stack's injection registry: engine, scheduler, and HTTP
    layer call `fire(kind, **program_identity)` at their seams; the plan
    decides (thread-safely, budget-counted) whether THIS event breaks.

    One plan per server (build_server shares one object across all
    seams) so `count=` budgets mean what they say.  `bind_registry`
    attaches the `wavetpu_serve_fault_injections_total{kind=}` counter;
    an unbound plan still fires (unit tests), it just counts privately.
    """

    def __init__(self, injections: List[ServeInjection] = ()):
        self._inj = list(injections)
        self._lock = threading.Lock()
        self._counter = None

    @property
    def active(self) -> bool:
        return bool(self._inj)

    def bind_registry(self, registry) -> None:
        self._counter = registry.counter(
            "wavetpu_serve_fault_injections_total",
            "chaos-harness injections fired on the serve path",
            ("kind",),
        )

    def fire(self, kind: str, **ctx) -> Optional[ServeInjection]:
        """The matching armed injection if this event fires (budgets
        decremented, firing counted), else None."""
        if not self._inj:
            return None
        with self._lock:
            for inj in self._inj:
                if inj.kind != kind or not inj.matches(ctx):
                    continue
                if inj.after > 0:
                    inj.after -= 1
                    continue
                if inj.count is not None and inj.count <= 0:
                    continue
                if inj.count is not None:
                    inj.count -= 1
                inj.fired += 1
                if self._counter is not None:
                    self._counter.inc(kind=kind)
                return inj
        return None

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [inj.snapshot() for inj in self._inj]


def parse_serve_spec(spec: str) -> Optional[ServeFaultPlan]:
    """Parse the `serve-*` halves of a WAVETPU_FAULT value into a plan
    (None when the value carries no serve specs).  Grammar per spec:
    `serve-KIND[:key=value,...]` with params `count`/`after`/`seconds`
    and selector fields n/timesteps/scheme/path/k/dtype; specs are
    ';'-separated and may mix with run-side `nan:`/`preempt:` specs."""
    injections: List[ServeInjection] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part or not part.startswith("serve-"):
            continue
        kind, _, params = part[len("serve-"):].partition(":")
        match: Dict[str, str] = {}
        count: Optional[int] = None
        after = 0
        seconds = 0.0
        if params:
            for kv in params.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, sep, v = kv.partition("=")
                if not sep:
                    raise ValueError(
                        f"{ENV_FAULT}: serve-{kind} wants key=value "
                        f"params, got {kv!r}"
                    )
                if k == "count":
                    count = int(v)
                elif k == "after":
                    after = int(v)
                elif k == "seconds":
                    seconds = float(v)
                else:
                    match[k] = v
        injections.append(
            ServeInjection(kind, match, count=count, after=after,
                           seconds=seconds)
        )
    return ServeFaultPlan(injections) if injections else None


def serve_plan_from_env(env: Optional[dict] = None
                        ) -> Optional[ServeFaultPlan]:
    """The serve stack's WAVETPU_FAULT port (None when unset or when the
    value carries only run-side specs)."""
    env = os.environ if env is None else env
    spec = env.get(ENV_FAULT)
    if not spec:
        return None
    return parse_serve_spec(spec)


# ------------------------------------------------------------ router tier


def parse_router_spec(spec: str) -> Optional[ServeFaultPlan]:
    """Parse the router-tier halves of a WAVETPU_FAULT value (None when
    the value carries none).  Grammar mirrors the serve specs -
    `KIND[:key=value,...]` with `count`/`after` budgets, ';'-separated,
    freely mixed with serve-side and run-side specs:

     * `router-crash[:after=K,count=N]` - the router process delivers
       SIGKILL to ITSELF just before proxying a matching /solve
       (`after=K` skips the first K), the real-dead-active half of the
       failover drill: no flush, no lease release, nothing graceful;
     * `store-corrupt[:count=N]` - the control-plane WAL tail is
       truncated just before a store load, driving the per-line
       checksum rejection branch (a counted recoverable miss);
     * `store-stale-lease[:count=N]` - one lease renewal observes a
       stale/foreign lease and fails, forcing the active to demote and
       re-elect (the paused-then-resumed-process drill).

    Every firing is counted; the router exposes the plan's state as
    `wavetpu_router_fault_injections_total{kind=}`."""
    injections: List[ServeInjection] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part or not part.startswith(_ROUTER_PREFIXES):
            continue
        kind, _, params = part.partition(":")
        count: Optional[int] = None
        after = 0
        if params:
            for kv in params.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, sep, v = kv.partition("=")
                if not sep:
                    raise ValueError(
                        f"{ENV_FAULT}: {kind} wants key=value params, "
                        f"got {kv!r}"
                    )
                if k == "count":
                    count = int(v)
                elif k == "after":
                    after = int(v)
                else:
                    raise ValueError(
                        f"{ENV_FAULT}: {kind} takes only count=/after= "
                        f"params, got {kv!r}"
                    )
        injections.append(ServeInjection(kind, count=count, after=after))
    return ServeFaultPlan(injections) if injections else None


def router_plan_from_env(env: Optional[dict] = None
                         ) -> Optional[ServeFaultPlan]:
    """The router tier's WAVETPU_FAULT port (None when unset or when
    the value carries only run/serve-side specs).  One plan per router
    process, shared across the data path, the store, and the lease so
    `count=` budgets mean what they say."""
    env = os.environ if env is None else env
    spec = env.get(ENV_FAULT)
    if not spec:
        return None
    return parse_router_spec(spec)
