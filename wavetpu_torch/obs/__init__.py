"""Unified telemetry of the port (wavetpu/obs/, copied, never imported):
metrics registry, span tracing, heartbeat files, ledgers and reports.

 * `obs.registry`  - process-wide counters/gauges/histograms, JSON
   snapshot + Prometheus text exposition (one consistency lock).
 * `obs.tracing`   - JSONL span/event emission; a span also opens a
   `torch.profiler.record_function` when torch is loaded.
 * `obs.metrics`   - the domain instruments (per-solve throughput,
   checkpoint I/O, supervisor counters).
 * `obs.perf`      - performance X-ray: the port's analytic cost model
   + roofline gauges, CUDA allocator watermarks, `wavetpu-torch profile`.
 * `obs.ledger`    - persistent compile-cost ledger and
   `wavetpu-torch ledger-report` (what-if cache, warmup manifest).
 * `obs.accuracy`  - the accuracy ledger and `wavetpu-torch plan-report`.
 * `obs.telemetry` - `--telemetry-dir` glue: trace file + periodic
   registry snapshots (heartbeat.jsonl / metrics.prom) + the ledgers.
 * `obs.report`    - `wavetpu-torch trace-report`: per-kind span stats
   and per-request critical-path views over a trace file.

Metric catalog and span kinds: the README's port section.
"""

from wavetpu_torch.obs.registry import MetricsRegistry, get_registry  # noqa: F401
