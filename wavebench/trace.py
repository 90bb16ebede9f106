"""The traced run's device record, read from torch.profiler in memory.

`Window` profiles the measured window (CPU and CUDA activity) and keeps
nothing on disk.  Afterwards it holds:

  kernels   {base name: [launches, device seconds]} of every CUDA kernel
  busy_s    the union of all device intervals (kernels, copies, sets)
  window_s  the window's length, taken from the harness's `wb.window` span
  gaps      the idle intervals of the device inside the window, each
            labelled with what the host was doing then: the harness's
            innermost `wb.*` span and the host operation in flight

The harness's own spans (`wb.setup`, `wb.solve`, `wb.window`)
are `torch.profiler.record_function` ranges around its calls into the
program.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function


def base_name(kernel: str) -> str:
    """A demangled kernel name without its return type, namespaces,
    template arguments and parameters: "void (anonymous namespace)::
    step_kernel<float>(...)" -> "step_kernel"."""
    s = kernel.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    s = s.split("(")[0].split("<")[0]
    return s.split("::")[-1].strip() or kernel


class Window:
    """Profile a window: `with Window(enabled) as w: ...`, then read w.kernels, w.busy_s,
    w.window_s and w.breakdown()."""

    def __init__(self, enabled: bool, cuda: bool = True):
        self.enabled = enabled
        self.cuda = cuda
        self.kernels: Dict[str, List[float]] = {}
        self.busy_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.gaps: List[Tuple[str, float]] = []
        self._stack = contextlib.ExitStack()
        self._prof = None

    def __enter__(self):
        if self.enabled:
            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self._prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(record_function("wb.window"))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        if self._prof is not None and exc[0] is None:
            self._read(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False

    def _read(self, events) -> None:
        dev, spans, host = [], [], []
        window = None
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                name = e.name()
                # The harness's spans are mirrored on the device's timeline
                # as annotations: they are not device work.
                if e.is_user_annotation() or name.startswith("wb."):
                    continue
                dev.append((start, end))
                if not (name.startswith("Memcpy") or name.startswith("Memset")
                        or name.startswith("Memory")):
                    k = self.kernels.setdefault(base_name(name), [0, 0.0])
                    k[0] += 1
                    k[1] += (end - start) * 1e-9
            elif e.name() == "wb.window":
                window = (start, end)
            elif e.name().startswith("wb."):
                spans.append((start, end, e.name()))
            else:
                host.append((start, end, e.name()))
        if window is None:
            return
        w0, w1 = window
        self.window_s = (w1 - w0) * 1e-9
        busy, gaps = 0, []
        cursor = w0
        for s, e in sorted(dev):
            s, e = max(s, w0), min(e, w1)
            if e <= cursor:
                continue
            if s > cursor:
                gaps.append((cursor, s))
                busy += e - s
            else:
                busy += e - cursor
            cursor = e
        if cursor < w1:
            gaps.append((cursor, w1))
        self.busy_s = busy * 1e-9
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        spans.sort()
        host.sort()
        host_starts = [h[0] for h in host]
        self.gaps = [(self._label(g, spans, host, host_starts),
                      (g[1] - g[0]) * 1e-9) for g in longest]

    @staticmethod
    def _label(gap, spans, host, host_starts) -> str:
        mid = (gap[0] + gap[1]) // 2
        inner = [n for s, e, n in spans if s <= mid <= e]
        label = inner[-1] if inner else "outside wb spans"
        # The host operation in flight at the gap's middle: the latest to
        # start before it that has not ended.
        i = bisect.bisect_right(host_starts, mid)
        for s, e, n in reversed(host[max(0, i - 4096):i]):
            if e >= mid:
                return f"{label}: {n}"
        return f"{label}: no host op"

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[n, v[1]] for n, v in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps]}
