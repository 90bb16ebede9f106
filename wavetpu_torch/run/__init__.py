"""Supervised-run subsystem (the port of wavetpu/run/): periodic
checkpointing, numerical-health watchdog, preemption handling, bounded
auto-retry, and the fault-injection harness that proves the recovery
paths fire.

 * run/supervisor.py - the solve supervisor (chunked march over the
   solvers' chunk runners, rotating checkpoints, signals, retries, exit
   codes)
 * run/health.py     - the non-finite/amplitude guard
 * run/faults.py     - fault injectors (bit-flip, truncation, stale-step
   shard, NaN-at-step, preempt-at-step) for tests and drills

Modules here import nothing heavy at module import, so the CLI can parse
flags and resolve checkpoint pointers first.
"""
