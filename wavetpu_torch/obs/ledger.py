"""Persistent compile-cost ledger + `wavetpu-torch ledger-report` (the
port's copy of wavetpu/obs/ledger.py).

Compile spend is a cold-start cost that a process restart erases and
nothing adds up.  In the port a "compile" is what a solve pays before
its kernels run the first time in a process: the nvcc build of the
kernel libraries (kernels/build.py; a library found already built in the
build directory is a load from disk) and the first launch of each
template instantiation it uses (where the CUDA runtime loads it;
`stencil_cuda.first_launch_seconds`).  The CLI records every solve's
compile into
an APPEND-ONLY JSONL file under `--telemetry-dir`:

    {"type": "compile", "ts": 1754300000.0, "pid": 4242, "cold": true,
     "compile_s": 31.25,
     "key": {"N": 512, "Lx": 1.0, ..., "scheme": "compensated",
             "path": "kfused", "k": 4, "dtype": "f32",
             "with_field": false, "compute_errors": true,
             "batch": 4, "mesh": null}}

`key` is a `progkey.ProgramKey` as a JSON object (a CLI solve records
a batch=1 key).  `cold` marks the first
compile of a key IN THIS PROCESS; a later entry with cold=false is an
in-process recompile (LRU eviction churn).  The file is deliberately
EXEMPT from the telemetry size rotation (one line per compile - a
ledger that rotated away its history could not answer the cross-restart
questions it exists for) and is opened in append mode, so entries
accumulate across process lifetimes.

`wavetpu-torch ledger-report DIR` then answers the questions a restart
erases:

 * compile spend per ProgramKey (count / cold count / seconds),
 * keys recompiled across restarts (cold in >= 2 distinct pids - the
   exact keys a persistent cross-process AOT cache would have served),
 * a WHAT-IF simulation of that cache: replay the ledger through an
   infinite persistent cache - every cold compile of an already-seen
   key is a hit, and the seconds saved are those compiles' MEASURED
   seconds (validated: saved_s + residual first-compile seconds ==
   total recorded compile seconds, exactly).

Everything here is pure stdlib (never imports torch): the report tool
runs off-accelerator against a scraped telemetry dir, like
trace-report.  When no ledger is configured, `record_compile` is a
None-check no-op and NO file is ever created.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

from wavetpu_torch.progkey import canonical_key, normalize_key

LEDGER_FILENAME = "compile_ledger.jsonl"


# ------------------------------------------------- request context
#
# The serving replica's scheduler worker binds the batch leader's tenant
# label here (THREAD-local: the worker thread, not the HTTP handler that
# knew the tenant, pays the compile) so every ledger line a solve records
# carries `tenant` without threading it through the engine's call chain.

_request_ctx = threading.local()


def set_request_context(tenant: Optional[str] = None) -> None:
    """Bind per-request attribution for ledger lines recorded on THIS
    thread until `clear_request_context`.  None values are dropped."""
    ctx = {}
    if tenant:
        ctx["tenant"] = str(tenant)
    _request_ctx.fields = ctx


def clear_request_context() -> None:
    _request_ctx.fields = {}


def request_context() -> dict:
    return dict(getattr(_request_ctx, "fields", None) or {})


def solo_key(problem, scheme: str, path: str, k: int, dtype: str,
             with_field: bool, compute_errors: bool,
             mesh=None) -> dict:
    """A batch=1 key for a solo CLI solve, same shape as the serve
    engine's (`k` is forced to 1 off the kfused path, like
    ProgramKey.for_batch)."""
    return normalize_key({
        "N": problem.N, "Lx": problem.Lx, "Ly": problem.Ly,
        "Lz": problem.Lz, "T": problem.T,
        "timesteps": problem.timesteps, "scheme": scheme, "path": path,
        "k": k if path == "kfused" else 1, "dtype": dtype,
        "with_field": bool(with_field),
        "compute_errors": bool(compute_errors), "batch": 1,
        "mesh": None if mesh is None else list(mesh),
    })


class CompileLedger:
    """Append-only JSONL writer for one ledger file.

    Best-effort like the Tracer: a full disk must never crash the run
    the ledger observes.  `_seen` tracks keys compiled by THIS process
    (the cold/warm verdict); the file itself accumulates across
    processes."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._seen: set = set()

    def record(self, key: dict, compile_s: float,
               cold: Optional[bool] = None, ts: Optional[float] = None,
               pid: Optional[int] = None, source: Optional[str] = None,
               fresh_compile_s: Optional[float] = None) -> dict:
        """`source`: "fresh" = a real compile (nvcc ran), "disk" = the
        persistent cache (the build directory) served it -
        `compile_s` is then the DESERIALIZE wall and `fresh_compile_s`
        the compile the entry replaced (the measured-savings credit).
        None omits the field - the pre-cache line format, which
        `aggregate` treats as fresh."""
        canon = canonical_key(key)
        with self._lock:
            if cold is None:
                cold = canon not in self._seen
            self._seen.add(canon)
            rec = {
                "type": "compile",
                "ts": round(time.time() if ts is None else ts, 3),
                "pid": os.getpid() if pid is None else int(pid),
                "cold": bool(cold),
                "compile_s": round(float(compile_s), 6),
                "key": normalize_key(key),
            }
            if source is not None:
                rec["source"] = str(source)
            if fresh_compile_s is not None:
                rec["fresh_compile_s"] = round(float(fresh_compile_s), 6)
            # Serving attribution: whatever request context the recording
            # thread bound (the tenant); absent outside the serve path.
            rec.update(request_context())
            try:
                if not self._f.closed:
                    self._f.write(json.dumps(rec) + "\n")
                    self._f.flush()
            except (OSError, ValueError):
                pass
        return rec

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


# ------------------------------------------------- process singleton

_ledger: Optional[CompileLedger] = None
_config_lock = threading.Lock()


def configure(path: str) -> CompileLedger:
    """Bind the process ledger (telemetry.start does this under
    `--telemetry-dir`); replaces a previous one."""
    global _ledger
    with _config_lock:
        if _ledger is not None:
            _ledger.close()
        _ledger = CompileLedger(path)
        return _ledger


def disable() -> None:
    global _ledger
    with _config_lock:
        if _ledger is not None:
            _ledger.close()
        _ledger = None


def get_ledger() -> Optional[CompileLedger]:
    return _ledger


def enabled() -> bool:
    return _ledger is not None


def record_compile(key: dict, compile_s: float, **kw) -> None:
    """Record one compile into the process ledger; a None-check no-op
    (zero file I/O) when no telemetry dir configured one."""
    led = _ledger
    if led is not None:
        led.record(key, compile_s, **kw)


# ------------------------------------------------- report / what-if


def resolve_ledger_path(path: str) -> str:
    """Accept a telemetry DIR (the common case) or the ledger file."""
    if os.path.isdir(path):
        return os.path.join(path, LEDGER_FILENAME)
    return path


def load_ledger(path: str) -> List[dict]:
    """Parse the ledger; malformed lines counted, not fatal (the file
    may be mid-append, and an append-only cross-version file may hold
    records a newer/older wavetpu wrote - a key with fields this
    version does not know, a missing compile_s - which must be skipped,
    never crash the report)."""
    records, bad = [], 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            if not (
                isinstance(rec, dict) and rec.get("type") == "compile"
                and isinstance(rec.get("key"), dict)
                and isinstance(rec.get("compile_s"), (int, float))
            ):
                bad += 1
                continue
            try:
                rec["key"] = normalize_key(rec["key"])
            except (ValueError, TypeError):
                bad += 1
                continue
            records.append(rec)
    if bad:
        print(f"note: skipped {bad} malformed ledger line(s)",
              file=sys.stderr)
    return records


def aggregate(records: Sequence[dict]) -> dict:
    """Per-key compile spend, cross-restart recompile detection, and
    the persistent-cache what-if (see module docstring for the saving
    rule).  `what_if.saved_s + what_if.residual_s` equals the total
    recorded compile seconds EXACTLY - the self-validation the tests
    pin.

    Since the persistent-cache round, `source: disk` records (the
    cache actually serving a key; compile_s is the deserialize wall)
    are partitioned OUT of the compile accounting - they are not
    compiles - and reported as `measured_persistent_cache`: measured
    savings next to the simulation.  Old-format lines with no `source`
    are fresh compiles, so pre-cache ledgers aggregate bit-identically
    to before."""
    records = sorted(
        records, key=lambda r: (r.get("ts", 0.0), r.get("pid", 0))
    )
    disk_records = [
        r for r in records if r.get("source") == "disk"
    ]
    records = [r for r in records if r.get("source") != "disk"]
    per: Dict[str, dict] = {}
    pids = set()
    for rec in records:
        canon = canonical_key(rec["key"])
        pids.add(rec.get("pid"))
        row = per.setdefault(canon, {
            "key": normalize_key(rec["key"]),
            "compiles": 0, "cold_compiles": 0,
            "total_s": 0.0, "cold_s": 0.0,
            "pids": [], "first_cold_s": None, "saved_s": 0.0,
        })
        row["compiles"] += 1
        row["total_s"] += rec["compile_s"]
        if rec.get("pid") not in row["pids"]:
            row["pids"].append(rec.get("pid"))
        if rec.get("cold"):
            row["cold_compiles"] += 1
            row["cold_s"] += rec["compile_s"]
            if row["first_cold_s"] is None:
                # The one compile even a persistent cache must pay.
                row["first_cold_s"] = rec["compile_s"]
            else:
                # A cold compile of a key some process already built:
                # a persistent cross-process cache serves it instead,
                # saving exactly the measured seconds.
                row["saved_s"] += rec["compile_s"]
    cross_restart = [
        row for row in per.values() if len(row["pids"]) > 1
    ]
    total_s = sum(r["compile_s"] for r in records)
    saved_s = sum(row["saved_s"] for row in per.values())
    # Residual: first cold compiles (unavoidable) plus in-process warm
    # recompiles (eviction churn a persistent cache would ALSO absorb,
    # but conservatively not credited - they were warm in-process and
    # their cost is jax-cache dependent).
    residual_s = total_s - saved_s
    keys = sorted(per.values(), key=lambda r: -r["total_s"])
    for row in keys:
        row["total_s"] = round(row["total_s"], 6)
        row["cold_s"] = round(row["cold_s"], 6)
        row["saved_s"] = round(row["saved_s"], 6)
    # Measured reconciliation of the what-if: every `source: disk`
    # record is one compile the REAL persistent cache served -
    # compile_s is its deserialize wall, fresh_compile_s the compile it
    # replaced.  Where both exist the measured saving is their
    # difference (floored at 0); hits whose entry predates the
    # fresh_compile_s field are counted unattributed.
    measured_saved = 0.0
    unattributed = 0
    for rec in disk_records:
        fresh = rec.get("fresh_compile_s")
        if isinstance(fresh, (int, float)):
            measured_saved += max(0.0, fresh - rec["compile_s"])
        else:
            unattributed += 1
    return {
        "entries": len(records),
        "distinct_keys": len(per),
        "processes": len(pids),
        "total_compile_s": round(total_s, 6),
        "keys": keys,
        "recompiled_across_restarts": len(cross_restart),
        "what_if_persistent_cache": {
            "saved_s": round(saved_s, 6),
            "residual_s": round(residual_s, 6),
            "served_compiles": sum(
                row["cold_compiles"] - 1
                for row in per.values() if row["cold_compiles"] > 1
            ),
        },
        "measured_persistent_cache": {
            "disk_hits": len(disk_records),
            "load_s": round(
                sum(r["compile_s"] for r in disk_records), 6
            ),
            "measured_saved_s": round(measured_saved, 6),
            "unattributed_hits": unattributed,
        },
    }


def _key_label(key: dict) -> str:
    mesh = key.get("mesh")
    return (
        f"N={key['N']}/{key['timesteps']} {key['scheme']}:{key['path']}"
        f" k={key['k']} {key['dtype']}"
        + (" field" if key.get("with_field") else "")
        + f" b={key['batch']}"
        + (f" mesh={tuple(mesh)}" if mesh else "")
    )


def format_report(agg: dict) -> str:
    lines = [
        f"compile ledger: {agg['entries']} compiles, "
        f"{agg['distinct_keys']} distinct keys, "
        f"{agg['processes']} process(es), "
        f"{agg['total_compile_s']:.3f}s total compile spend",
        "",
        f"{'program key':<58} {'n':>3} {'cold':>4} {'total_s':>9} "
        f"{'procs':>5}",
    ]
    lines.append("-" * len(lines[-1]))
    for row in agg["keys"]:
        lines.append(
            f"{_key_label(row['key']):<58} {row['compiles']:>3} "
            f"{row['cold_compiles']:>4} {row['total_s']:>9.3f} "
            f"{len(row['pids']):>5}"
        )
    wi = agg["what_if_persistent_cache"]
    lines += [
        "",
        f"recompiled across restarts: "
        f"{agg['recompiled_across_restarts']} key(s)",
        f"what-if persistent AOT cache (ROADMAP direction 2): "
        f"{wi['saved_s']:.3f}s saved over {wi['served_compiles']} "
        f"served compile(s); {wi['residual_s']:.3f}s residual "
        f"(first-compile + in-process churn)",
    ]
    mp = agg.get("measured_persistent_cache") or {}
    if mp.get("disk_hits"):
        # The what-if became a measured fact: print them side by side.
        line = (
            f"measured persistent cache: {mp['disk_hits']} disk "
            f"hit(s) served in {mp['load_s']:.3f}s deserialize, "
            f"{mp['measured_saved_s']:.3f}s compile spend saved "
            f"(measured)"
        )
        if mp.get("unattributed_hits"):
            line += (
                f"; {mp['unattributed_hits']} hit(s) without a "
                f"recorded fresh-compile cost"
            )
        lines.append(line)
    return "\n".join(lines)


_USAGE = (
    "usage: wavetpu-torch ledger-report TELEMETRY_DIR|LEDGER.jsonl "
    "[--json]"
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    as_json = False
    try:
        for a in argv:
            if a == "--json":
                as_json = True
            elif a.startswith("--"):
                raise ValueError(f"unknown flag {a}")
            elif path is None:
                path = a
            else:
                raise ValueError(f"unexpected positional {a!r}")
        if path is None:
            raise ValueError("missing telemetry dir / ledger path")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2
    ledger_path = resolve_ledger_path(path)
    try:
        records = load_ledger(ledger_path)
    except OSError as e:
        print(f"error: cannot read ledger: {e}", file=sys.stderr)
        return 2
    agg = aggregate(records)
    if as_json:
        print(json.dumps(agg, indent=1, sort_keys=True))
    else:
        print(format_report(agg))
        # Companion pointer (quota cost-model carry-over): when the same
        # telemetry dir also holds an accuracy ledger, `wavetpu
        # plan-report DIR` joins the two into plan_table.json, whose
        # MEASURED wall s/request per plan is the drop-in replacement
        # for the analytic cells pricing fleet/quota.py charges today.
        if os.path.isdir(path):
            from wavetpu_torch.obs import accuracy as _accuracy

            acc = os.path.join(path, _accuracy.ACCURACY_FILENAME)
            if os.path.exists(acc):
                print(
                    f"\naccuracy ledger present ({acc}): run `wavetpu-torch "
                    f"plan-report {path}` for the measured "
                    f"speed-accuracy plan table; its wall s/request "
                    f"replaces the analytic cells pricing in "
                    f"fleet/quota.py"
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
