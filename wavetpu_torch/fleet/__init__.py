"""Fleet tier: N `python -m wavetpu_torch serve` replicas behind one
affinity router (the port's copy of wavetpu/fleet/).

One replica process is one scheduler worker in front of one card; a
fleet is N of them behind `python -m wavetpu_torch router` - a stdlib
ThreadingHTTPServer front (same discipline as serve/api.py) that:

 * derives each /solve body's program identity with the SAME shared
   key derivation the engine uses (`wavetpu_torch.progkey`, so router
   and engine cannot drift),
 * routes warm keys to the replica that already holds the built
   program (warm-key tables learned from replica `/metrics`
   `program_cache.warm_keys` polls plus every proxied response's
   `Server-Timing: warm;desc=` label),
 * falls back to least-loaded power-of-two-choices for cold keys,
 * health-gates membership on `/healthz` polls (`ready: false` or
   repeated transport failures eject; recovery re-admits),
 * absorbs a draining replica's 503s by retrying on a live member, and
 * aggregates member Prometheus counters (including frozen snapshots
   of departed members) so `python -m wavetpu_torch loadgen` pointed at
   the router sees fleet-wide monotonic deltas across a rolling deploy.

`python -m wavetpu_torch fleet roll` is the zero-cold-build deploy
driver: start the successor with `--warmup-manifest` built from the
fleet's shared compile ledger, wait for readiness, join it to the
router, then drain and remove the predecessor - clients retrying
through `WavetpuClient` (or the router's own retry) never see the
cutover.

The wire contract is wavetpu's, name for name (headers, the
`wavetpu_router_*` metrics, /healthz and /metrics keys, control-plane
files), so an unmodified `wavetpu router` fronts port replicas and
either router restarts from the other's store.  Every module here is
stdlib-only and imports neither torch nor jax: routers run on hosts
with no accelerator stack.

  membership.py  health-gated member table + poll loop
  affinity.py    warm-key table + hit/rerouted/cold routing decisions
  edgecache.py   the router's result cache
  quota.py       per-tenant token buckets and priority ceilings
  store.py       the crash-safe control-plane store
  ha.py          the single-writer lease of router HA
  router.py      the HTTP proxy tier (`python -m wavetpu_torch router`)
  roll.py        the rolling-deploy driver (`python -m wavetpu_torch
                 fleet roll`)

Contract and runbook: wavetpu's docs/fleet.md.
"""

from wavetpu_torch.fleet.affinity import AffinityTable  # noqa: F401
from wavetpu_torch.fleet.membership import (  # noqa: F401
    Member,
    MembershipTable,
)
