"""Workload observability: scenario traces, replay harness, SLO gate
(the port's copy of wavetpu/loadgen/).

The telemetry spans make ONE request's latency attributable (queue vs
compile vs execute vs padding); `python -m wavetpu_torch loadgen` makes
the service observable under realistic MIXED traffic - tail latency
under load, not solo-solve Gcell/s.  Its trace JSONL and report JSON
are wavetpu's, key for key, so either package's loadgen replays the
other's traces and gates the other's reports.

    trace.py   JSONL scenario-trace format, synthetic generators
               (uniform / poisson / diurnal / hotkey), and the recorder
               `python -m wavetpu_torch serve --record-trace` uses to capture
               real
               /solve traffic into replayable traces
    runner.py  open-/closed-loop replay against a live server: preflight
               health check, warmup phase, per-request Server-Timing
               capture, /metrics scrapes bracketing the run
    report.py  loadgen_report.json builder + the regression gate
               (`--baseline OLD.json` diffs, exit != 0 on SLO violation)
    cli.py     `python -m wavetpu_torch loadgen generate | replay | gate`

Pure stdlib HTTP client + host-side math; imports neither torch nor
jax - the load generator must be runnable from a machine that has no
accelerator.
"""
