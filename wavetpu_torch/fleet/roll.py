"""`python -m wavetpu_torch fleet roll` - zero-cold-build rolling deploys
(the port's copy of wavetpu/fleet/roll.py).

Replace one fleet member with a successor WITHOUT paying a single
client-visible error or a single fresh kernel build:

  1. Build a warmup manifest from the fleet's shared compile ledger
     (`--ledger DIR`, the telemetry dir every replica appends to; or
     hand one in with `--manifest FILE`) - the exact key set the fleet
     has ever compiled, in the shape `python -m wavetpu_torch serve
     --warmup-manifest` consumes.
  2. Spawn the successor (everything after `--` is its command line,
     e.g. `python -m wavetpu_torch serve --port 8078
     --program-cache-dir /shared`)
     with `--warmup-manifest MANIFEST` appended, so it answers
     `ready: false` while it pre-adopts every program - from the
     SHARED persistent program cache where possible (disk adoption,
     not compilation: `--max-cold-compiles 0` stays green).
  3. Wait for the successor's /healthz to flip ready.
  4. Join it to the router (`POST /admin/join`) and wait until the
     router reports it `up` - the fleet now has N+1 serving members,
     every warm key still has a live holder.
  5. Leave the predecessor (`POST /admin/leave`): the router drains it
     (503 + Retry-After absorbed by the router's own member retry),
     snapshots its final counters (frozen into the fleet /metrics
     aggregate - loadgen deltas across the roll stay monotonic), and
     retires it.  With `--solve-state-dir` shared across replicas, the
     drain CHECKPOINTS any in-flight chunked long solve and answers a
     503 + resume_token; the router re-injects the token on its member
     retry, so the successor resumes the march from the last completed
     chunk - the roll hands half-done solves over instead of burning
     them (wavetpu's docs/robustness.md "Preemptible solves").  The
     driver reads the router's `resume_handoffs_total` across the
     cutover and logs how many solves were handed off.

Usage:

    python -m wavetpu_torch fleet roll --router URL --old URL --new URL
        (--ledger DIR | --manifest FILE) [--timeout-s S]
        [--no-spawn] -- SUCCESSOR ARGV...

`--no-spawn` skips step 2 (the successor is already running - e.g. a
container orchestrator started it); steps 3-5 still gate and cut over.
Exit codes: 0 rolled; 1 the roll FAILED SAFE (successor never became
ready / never joined - the predecessor keeps serving untouched);
2 usage errors.

Stdlib-only; imports neither torch nor jax.  Runbook: wavetpu's
docs/fleet.md.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence

from wavetpu_torch.core.flags import split_flags

_USAGE = (
    "usage: python -m wavetpu_torch fleet roll --router URL --old URL "
    "--new URL "
    "(--ledger DIR | --manifest FILE) [--timeout-s S] [--no-spawn] "
    "-- SUCCESSOR ARGV..."
)


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _post_json(url: str, body: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def build_manifest(ledger_dir: str, out_path: Optional[str] = None
                   ) -> str:
    """Ledger dir (or file) -> warmup manifest file; returns its path.
    An empty ledger still writes a valid zero-key manifest (a brand-new
    fleet has nothing to warm - the roll proceeds, trivially)."""
    from wavetpu_torch.obs import ledger as ledger_mod

    path = ledger_mod.resolve_ledger_path(ledger_dir)
    records = ledger_mod.load_ledger(path) if os.path.exists(path) else []
    manifest = ledger_mod.warmup_manifest(records)
    if out_path is None:
        fd, out_path = tempfile.mkstemp(
            prefix="wavetpu-roll-manifest-", suffix=".json"
        )
        os.close(fd)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return out_path


def _router_handoffs(router_url: str) -> int:
    """The router's resume_handoffs_total counter (0 when unreadable -
    the handoff log line is best-effort, never a roll failure)."""
    try:
        snap = _get_json(router_url.rstrip("/") + "/metrics",
                         timeout=5.0)
        return int(snap.get("resume_handoffs_total", 0))
    except (OSError, ValueError, urllib.error.URLError):
        return 0


def wait_ready(base_url: str, timeout_s: float,
               interval_s: float = 0.25) -> bool:
    """Poll /healthz until ready (True) or the budget is gone (False).
    Transport errors are just 'not yet' - the successor may still be
    binding its port."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            health = _get_json(base_url.rstrip("/") + "/healthz",
                               timeout=5.0)
            if (health.get("status") == "ok"
                    and health.get("ready") is not False):
                return True
        except (OSError, ValueError, urllib.error.URLError):
            pass
        time.sleep(interval_s)
    return False


def wait_member_state(router_url: str, member_url: str, state: str,
                      timeout_s: float, interval_s: float = 0.25
                      ) -> bool:
    """Poll the router's /healthz member summary until `member_url`
    reports `state`."""
    member_url = member_url.rstrip("/")
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            health = _get_json(router_url.rstrip("/") + "/healthz",
                               timeout=5.0)
            for m in health.get("members", ()):
                if m.get("url") == member_url and m.get("state") == state:
                    return True
        except (OSError, ValueError, urllib.error.URLError):
            pass
        time.sleep(interval_s)
    return False


def roll(router_url: str, old_url: str, new_url: str,
         spawn_argv: Optional[Sequence[str]] = None,
         manifest_path: Optional[str] = None,
         timeout_s: float = 300.0,
         leave_sync: bool = False,
         log=print) -> int:
    """The deploy sequence (module docstring).  Returns an exit code;
    fails SAFE - the predecessor is only drained AFTER the successor is
    ready and routed."""
    # HA guard: admin mutations against a STANDBY router land in state
    # the next promotion overwrites from the control-plane store - the
    # join would silently vanish.  Fail before touching anything.
    try:
        router_health = _get_json(router_url.rstrip("/") + "/healthz")
    except (OSError, ValueError, urllib.error.URLError) as e:
        log(f"roll: FAILED - cannot reach router {router_url}: {e}",
            file=sys.stderr)
        return 1
    if router_health.get("role") == "standby":
        log(f"roll: FAILED - {router_url} is a STANDBY router (not the "
            f"lease holder); a join/leave there would be overwritten "
            f"on promotion.  Point --router at the active.",
            file=sys.stderr)
        return 1
    proc = None
    if spawn_argv:
        argv = list(spawn_argv)
        if manifest_path is not None:
            argv += ["--warmup-manifest", manifest_path]
        log(f"roll: spawning successor: {' '.join(argv)}")
        proc = subprocess.Popen(argv)
    try:
        log(f"roll: waiting for {new_url} to become ready "
            f"(warmup runs now, budget {timeout_s:g}s)")
        if not wait_ready(new_url, timeout_s):
            log(f"roll: FAILED - {new_url} never became ready; "
                f"predecessor untouched", file=sys.stderr)
            if proc is not None:
                proc.terminate()
            return 1
        log(f"roll: joining {new_url} to router {router_url}")
        _post_json(router_url.rstrip("/") + "/admin/join",
                   {"url": new_url})
        if not wait_member_state(router_url, new_url, "up", timeout_s):
            log(f"roll: FAILED - router never admitted {new_url}; "
                f"predecessor untouched", file=sys.stderr)
            return 1
        log(f"roll: draining + retiring predecessor {old_url}")
        handoffs_before = _router_handoffs(router_url)
        _post_json(router_url.rstrip("/") + "/admin/leave",
                   {"url": old_url, "drain": True, "sync": leave_sync})
        if not wait_member_state(router_url, old_url, "left",
                                 timeout_s):
            log(f"roll: WARNING - {old_url} did not reach 'left' in "
                f"{timeout_s:g}s (drain may still be flushing)",
                file=sys.stderr)
        handed = _router_handoffs(router_url) - handoffs_before
        if handed > 0:
            log(f"roll: {handed} in-flight long solve(s) handed off "
                f"to the successor via resume tokens")
        log(f"roll: done - {new_url} serving, {old_url} retired")
        return 0
    except (OSError, urllib.error.URLError) as e:
        log(f"roll: FAILED - {e}", file=sys.stderr)
        if proc is not None:
            proc.terminate()
        return 1


def _log(msg, file=None):
    print(msg, file=file or sys.stdout, flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    spawn_argv: Optional[Sequence[str]] = None
    if "--" in argv:
        cut = argv.index("--")
        argv, spawn_argv = argv[:cut], argv[cut + 1:]
    try:
        _, flags = split_flags(
            argv,
            known=("router", "old", "new", "ledger", "manifest",
                   "timeout-s", "no-spawn"),
            valueless=("no-spawn",),
            allow_positionals=False,
        )
        for need in ("router", "old", "new"):
            if need not in flags:
                raise ValueError(f"fleet roll needs --{need} URL")
        if ("ledger" in flags) == ("manifest" in flags):
            raise ValueError(
                "fleet roll needs exactly one of --ledger DIR / "
                "--manifest FILE"
            )
        timeout_s = float(flags.get("timeout-s", "300"))
        if "no-spawn" in flags:
            if spawn_argv:
                raise ValueError("--no-spawn and a `-- ARGV` conflict")
            spawn_argv = None
        elif not spawn_argv:
            raise ValueError(
                "missing successor command after `--` "
                "(or pass --no-spawn for an already-running successor)"
            )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2
    manifest_path = flags.get("manifest")
    if manifest_path is None:
        manifest_path = build_manifest(flags["ledger"])
        with open(manifest_path, encoding="utf-8") as f:
            n_keys = len(json.load(f).get("keys", []))
        print(f"roll: warmup manifest from {flags['ledger']}: "
              f"{n_keys} key(s) -> {manifest_path}")
    return roll(
        flags["router"], flags["old"], flags["new"],
        spawn_argv=spawn_argv, manifest_path=manifest_path,
        timeout_s=timeout_s, log=_log,
    )


if __name__ == "__main__":
    sys.exit(main())
