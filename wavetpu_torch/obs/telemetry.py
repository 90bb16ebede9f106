"""`--telemetry-dir`: tracing + heartbeat snapshots for one run.

One call wires the whole observability surface to a directory a
babysitting operator can tail:

    DIR/trace.jsonl      structured spans/events (obs/tracing.py)
    DIR/heartbeat.jsonl  one registry snapshot per interval, appended -
                         `tail -f` shows counters move while a
                         multi-hour march is mid-chunk
    DIR/metrics.prom     the LATEST Prometheus text exposition,
                         atomically replaced each beat - node-exporter
                         textfile-collector compatible, so even a batch
                         CLI run is scrapable from disk

`start()` returns a `Telemetry` handle; `stop()` writes one final beat
(so short runs always leave a snapshot), joins the heartbeat thread,
and closes the tracer.  The heartbeat thread is a daemon: a crashed run
never hangs on telemetry.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Optional

from wavetpu_torch.obs import accuracy as accuracy_ledger
from wavetpu_torch.obs import ledger as compile_ledger
from wavetpu_torch.obs import tracing
from wavetpu_torch.obs.registry import MetricsRegistry, get_registry

TRACE_FILENAME = "trace.jsonl"
HEARTBEAT_FILENAME = "heartbeat.jsonl"
PROM_FILENAME = "metrics.prom"

# Size cap per telemetry file before rotation (keep-last-ROTATE_KEEP
# segments, atomic os.replace shifts): a long-lived `wavetpu-torch serve`
# under sustained traffic must not append trace.jsonl/heartbeat.jsonl
# forever.  64 MiB x 4 segments bounds the dir at ~512 MiB worst case
# while keeping hours of serve spans at production request rates.
DEFAULT_MAX_BYTES = 64 * 1024 * 1024
ROTATE_KEEP = 4


class Telemetry:
    def __init__(self, directory: str,
                 registry: Optional[MetricsRegistry] = None,
                 interval: float = 10.0,
                 max_bytes: Optional[int] = DEFAULT_MAX_BYTES,
                 keep: int = ROTATE_KEEP):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self.directory = directory
        self.registry = registry if registry is not None else get_registry()
        self.interval = interval
        self.max_bytes = max_bytes
        self.keep = max(1, int(keep))
        os.makedirs(directory, exist_ok=True)
        self.trace_path = os.path.join(directory, TRACE_FILENAME)
        self.heartbeat_path = os.path.join(directory, HEARTBEAT_FILENAME)
        self.prom_path = os.path.join(directory, PROM_FILENAME)
        self.ledger_path = os.path.join(
            directory, compile_ledger.LEDGER_FILENAME
        )
        self.accuracy_path = os.path.join(
            directory, accuracy_ledger.ACCURACY_FILENAME
        )
        tracing.configure(self.trace_path, max_bytes=max_bytes, keep=keep)
        # Compile-cost + accuracy ledgers: append-only and deliberately
        # EXEMPT from the size rotation below - one line per compile /
        # measured solve, and rotating away history would defeat the
        # cross-restart accounting `wavetpu-torch ledger-report` and
        # `wavetpu-torch plan-report` exist for (obs/ledger.py,
        # obs/accuracy.py).
        compile_ledger.configure(self.ledger_path)
        accuracy_ledger.configure(self.accuracy_path)
        self._stop = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, name="wavetpu-heartbeat", daemon=True
        )
        self._thread.start()
        # Safety net for error exits that never reach an explicit
        # stop() (a CLI usage error after telemetry started, an
        # uncaught exception): the final beat still lands.  stop()
        # unregisters it again, so repeated start/stop cycles (tests,
        # bench) do not pin dead Telemetry objects for process life.
        atexit.register(self.stop)

    def beat(self) -> None:
        """Write one heartbeat line + refresh the Prometheus dump.
        The heartbeat file rotates like the trace (size cap, keep-last-K
        atomic segment shift) - a week-long server cannot grow it
        unbounded."""
        snap = {
            "ts": round(time.time(), 3),
            "metrics": self.registry.snapshot(),
        }
        if self.max_bytes is not None:
            try:
                if os.path.getsize(self.heartbeat_path) > self.max_bytes:
                    tracing.rotate_file(self.heartbeat_path, self.keep)
            except OSError:
                pass  # not created yet
        with open(self.heartbeat_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(snap) + "\n")
        tmp = f"{self.prom_path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(self.registry.render_prometheus())
        os.replace(tmp, self.prom_path)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except OSError:
                # A torn-down telemetry dir must not kill the run the
                # telemetry exists to observe.
                pass

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        atexit.unregister(self.stop)
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            self.beat()  # final snapshot: short runs still leave one
        except OSError:
            pass
        # Only tear the tracer down if it is still THIS telemetry's (a
        # later configure() - another Telemetry, a test - owns it now).
        t = tracing.get_tracer()
        if t is not None and t.path == self.trace_path:
            tracing.disable()
        led = compile_ledger.get_ledger()
        if led is not None and led.path == self.ledger_path:
            compile_ledger.disable()
        acc = accuracy_ledger.get_ledger()
        if acc is not None and acc.path == self.accuracy_path:
            accuracy_ledger.disable()


def start(directory: str, registry: Optional[MetricsRegistry] = None,
          interval: float = 10.0,
          max_bytes: Optional[int] = DEFAULT_MAX_BYTES,
          keep: int = ROTATE_KEEP) -> Telemetry:
    return Telemetry(directory, registry=registry, interval=interval,
                     max_bytes=max_bytes, keep=keep)
