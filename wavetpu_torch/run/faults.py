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
wavetpu's serve-side (`serve-*`) and router-side (`router-*`, `store-*`)
specs come with serving (ROADMAP.md queue 1 item 12); here they are
ignored, as wavetpu's run side ignores them.
"""

from __future__ import annotations

import os
import signal
from typing import Optional


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
    element NaN."""
    blocks = getattr(a, "blocks", None)
    if blocks is not None:
        import dataclasses

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
# Specs of the serving and router tiers (item 12), ignored by the run side.
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
