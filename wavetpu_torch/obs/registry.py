"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The framework's observability was three disconnected fragments (a bespoke
JSON snapshot at `GET /metrics`, one-shot phase probes, a CLI-only
profiler flag).  This module is the standard serving-stack answer: one
thread-safe registry of named metrics with label support, rendered two
ways from the same state -

 * `snapshot()` - a JSON-friendly dict (the serve layer's existing
   `/metrics` JSON fields write through this registry and stay
   byte-compatible);
 * `render_prometheus()` - Prometheus text exposition (version 0.0.4),
   content-negotiated on `GET /metrics` via `Accept: text/plain` and
   dumped to `metrics.prom` by the telemetry heartbeat.

Concurrency discipline: ONE registry-wide lock guards every read and
write, so a snapshot (or a Prometheus scrape) is a CONSISTENT cut - no
scrape can see counter A after an update that counter B has not received
yet.  That is deliberate and cheap: metric updates are host-side integer
adds on chunk/batch boundaries, never in the device hot loop.

Instruments:

 * `Counter` - monotonically increasing float (`.inc(v)`).
 * `Gauge`   - settable float (`.set(v)` / `.inc` / `.dec`).
 * `Histogram` - fixed cumulative buckets + sum + count
   (`.observe(v)`); renders the standard `_bucket{le=...}`, `_sum`,
   `_count` sample triplet.  `observe(v, exemplar={...})` additionally
   pins an OpenMetrics exemplar (e.g. a request id) to the bucket the
   observation landed in, so a scraped p99 bucket is JOINABLE to the
   exact trace record that filled it (`wavetpu-torch trace-report --request`).
   Exemplars only render under `render_prometheus(openmetrics=True)` -
   the classic 0.0.4 text view stays byte-stable for parsers that do
   not speak the `# {label="v"} value ts` suffix.

Labels: declare `labelnames` at registration, address a child with
keyword labels on every call (`c.inc(1, path="kfused")`).  Re-registering
the same name is idempotent when the type/labelnames match and a
ValueError otherwise - two subsystems cannot silently fight over a name.

This module imports neither jax nor numpy: it must be safe to import
before the backend exists (same discipline as run/supervisor.py).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0, 30.0, 60.0, 120.0, 300.0,
)


def escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def escape_help(v: str) -> str:
    """# HELP line escaping: backslash and newline only (no quotes)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def format_value(v: float) -> str:
    """Sample-value formatting: integers render bare (1, not 1.0)."""
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Metric:
    """Base: one named metric family; per-label-tuple children."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self._registry = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name} wants labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}"
            )
        return tuple(str(labels[n]) for n in self.labelnames)

    def _labelstr(self, key: Tuple[str, ...],
                  extra: Optional[Tuple[str, str]] = None) -> str:
        pairs = list(zip(self.labelnames, key))
        if extra is not None:
            pairs.append(extra)
        if not pairs:
            return ""
        body = ",".join(
            f'{n}="{escape_label_value(v)}"' for n, v in pairs
        )
        return "{" + body + "}"


class Counter(_Metric):
    kind = "counter"

    def __init__(self, registry, name, help, labelnames=()):
        super().__init__(registry, name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._registry.lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._registry.lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every label child (the JSON snapshot's single-number
        view of a labeled counter)."""
        with self._registry.lock:
            return sum(self._values.values())

    def _samples(self) -> List[Tuple[str, float, Optional[str]]]:
        return [
            (self.name + self._labelstr(key), v, None)
            for key, v in sorted(self._values.items())
        ]

    def _snapshot_value(self):
        if not self.labelnames:
            return self._values.get((), 0.0)
        return {
            ",".join(key): v for key, v in sorted(self._values.items())
        }


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, registry, name, help, labelnames=()):
        super().__init__(registry, name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._registry.lock:
            self._values[key] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._registry.lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._registry.lock:
            return self._values.get(key, 0.0)

    _samples = Counter._samples
    _snapshot_value = Counter._snapshot_value


class Histogram(_Metric):
    """Fixed cumulative buckets (upper bounds) + sum + count."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = bs
        # key -> (per-bucket counts, +Inf count, sum)
        self._values: Dict[Tuple[str, ...], list] = {}
        # key -> {bucket index (len(buckets) = +Inf) -> (labels, v, ts)}:
        # the LATEST exemplar per bucket, OpenMetrics-rendered.
        self._exemplars: Dict[Tuple[str, ...], dict] = {}

    def observe(self, value: float,
                exemplar: Optional[Dict[str, str]] = None,
                **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._registry.lock:
            slot = self._values.get(key)
            if slot is None:
                slot = [[0] * len(self.buckets), 0, 0.0]
                self._values[key] = slot
            landed = len(self.buckets)  # +Inf unless a bound catches it
            for i, b in enumerate(self.buckets):
                if v <= b:
                    slot[0][i] += 1
                    landed = min(landed, i)
            slot[1] += 1
            slot[2] += v
            if exemplar:
                self._exemplars.setdefault(key, {})[landed] = (
                    dict(exemplar), v, time.time()
                )

    def count(self, **labels) -> int:
        key = self._key(labels)
        with self._registry.lock:
            slot = self._values.get(key)
            return 0 if slot is None else slot[1]

    def _exemplar_str(self, key: Tuple[str, ...], idx: int) -> Optional[str]:
        ex = self._exemplars.get(key, {}).get(idx)
        if ex is None:
            return None
        labels, v, ts = ex
        body = ",".join(
            f'{n}="{escape_label_value(x)}"' for n, x in sorted(labels.items())
        )
        return f"# {{{body}}} {format_value(v)} {round(ts, 3)}"

    def _samples(self) -> List[Tuple[str, float, Optional[str]]]:
        out = []
        for key, (counts, total, vsum) in sorted(self._values.items()):
            for i, (b, c) in enumerate(zip(self.buckets, counts)):
                out.append((
                    self.name + "_bucket"
                    + self._labelstr(key, ("le", format_value(b))),
                    c,
                    self._exemplar_str(key, i),
                ))
            out.append((
                self.name + "_bucket" + self._labelstr(key, ("le", "+Inf")),
                total,
                self._exemplar_str(key, len(self.buckets)),
            ))
            out.append((self.name + "_sum" + self._labelstr(key), vsum, None))
            out.append((self.name + "_count" + self._labelstr(key), total,
                        None))
        return out

    def _snapshot_value(self):
        def one(slot):
            counts, total, vsum = slot
            return {"count": total, "sum": vsum}

        if not self.labelnames:
            slot = self._values.get(())
            return one(slot) if slot is not None else {"count": 0, "sum": 0.0}
        return {
            ",".join(key): one(slot)
            for key, slot in sorted(self._values.items())
        }


class MetricsRegistry:
    """A named collection of metrics with one consistency lock.

    `lock` is public on purpose: a caller holding state that must stay
    consistent WITH the registry (the serve layer's latency reservoir)
    may guard it under the same lock, so one snapshot sees one cut of
    everything."""

    def __init__(self):
        self.lock = threading.RLock()
        self._metrics: "Dict[str, _Metric]" = {}
        self.created = time.time()

    def _register(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self.lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{existing.kind}{existing.labelnames}"
                    )
                if "buckets" in kw and tuple(
                    sorted(float(b) for b in kw["buckets"])
                ) != existing.buckets:
                    # A silently-ignored bucket declaration would bin the
                    # second caller's observations into bounds it never
                    # asked for - loud error, same as a type mismatch.
                    raise ValueError(
                        f"histogram {name} already registered with "
                        f"buckets {existing.buckets}"
                    )
                return existing
            m = cls(self, name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def names(self) -> List[str]:
        with self.lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict:
        """One consistent JSON-friendly cut of every metric."""
        with self.lock:
            return {
                name: m._snapshot_value()
                for name, m in sorted(self._metrics.items())
            }

    def render_prometheus(self, openmetrics: bool = False) -> str:
        """Text exposition - one consistent cut.

        `openmetrics=False` (the default) is the classic 0.0.4 format
        every textfile collector parses; `openmetrics=True` renders the
        same families with histogram EXEMPLARS (`# {request_id="..."} v
        ts` bucket suffixes) and the `# EOF` terminator - the subset of
        OpenMetrics the serve layer content-negotiates for
        `Accept: application/openmetrics-text` scrapes."""
        with self.lock:
            lines = []
            for name, m in sorted(self._metrics.items()):
                family = name
                if (openmetrics and m.kind == "counter"
                        and name.endswith("_total")):
                    # OpenMetrics names a counter FAMILY without the
                    # _total suffix; the samples keep it.  The 0.0.4
                    # view keeps the historical full-name TYPE line.
                    family = name[: -len("_total")]
                lines.append(f"# HELP {family} {escape_help(m.help)}")
                lines.append(f"# TYPE {family} {m.kind}")
                for sample, value, exemplar in m._samples():
                    line = f"{sample} {format_value(value)}"
                    if openmetrics and exemplar is not None:
                        line += f" {exemplar}"
                    lines.append(line)
            if openmetrics:
                lines.append("# EOF")
            return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (solver / checkpoint /
    supervisor counters).  The serve layer builds its OWN registry per
    server so concurrent test servers do not share counters."""
    return _REGISTRY
