"""Performance X-ray: roofline attribution + device-memory watermarks (the
port of wavetpu/obs/perf.py).

ROOFLINE ATTRIBUTION.  `model_bytes_per_cell` is the one analytic cost
model of every solver path: the device-memory bytes one launch of the
path's kernel must move - each input read once, each output written once
- at the shapes the port's solvers give it, over the cell updates the
launch makes.  These are the bytes behind the bound column of PERF.md
§6 (chip_smoke.py phase 6): the whole-domain kernels count their state
and field streams (K1 12 B per cell f32, K5 16, K2 24; K3 16 and K4 20
per cell of one k-step launch, so 4 and 5 per cell update at k=4), the
sharded kernels every tensor of the launch - the block, its ghost faces
or k-plane windows, the field and its windows, the oracle planes and the
error rows (K8 on a mesh-4,1,1 block of (128, 512, 512) at k=4: 555751424
bytes).  The geometry comes from the port's own layout: the shard block
(`core.grid.Topology`, or the k-fused x depth), the k-row y extension of
an (MX, MY > 1) mesh, the bf16 carry of the compensated pipeline
(`solver.kfused_comp._default_carry_dtype`); not from wavetpu's TPU
block choosers.  From it `solve_perf` turns a measured Gcell/s into

    model_gbps        = bytes_per_cell x achieved Gcell/s
    roofline_fraction = model_gbps / peak_gbps
    arithmetic_intensity = flops_per_cell / bytes_per_cell

so a fraction of 1 is a solve at the card's memory bound.
`metrics.record_solve` stamps these on every instrumented solve.
`peak_gbps` is the card's published HBM rate, looked up by its name (the
H100 SXM's 3350 GB/s), overridable with WAVETPU_PEAK_GBPS; the CPU gets a
nominal figure whose fractions exercise the plumbing, not the analysis.

DEVICE-MEMORY OBSERVABILITY.  `memory_snapshot()` reads the CUDA caching
allocator (`torch.cuda.memory_stats`: allocated bytes, current and
peak); `record_memory()` samples it into gauges around solves, keeps a
process-lifetime high-watermark gauge, counts watermark raises, and fires
a `memory.warn` trace event + counter when bytes in use cross
WAVETPU_MEM_WARN_BYTES.  Without a card the "unsupported" verdict is
probed once and cached, so every later call is a dict lookup.

`wavetpu-torch profile` (profile_main) runs one full command line under
`torch.profiler.profile` (CPU and CUDA activities), so the spans'
`record_function` annotations land inside the trace, exports a Chrome
trace into --out DIR and prints the top device operations.

Metric catalog additions:

  wavetpu_solve_roofline_fraction{path}   gauge: last solve's fraction
  wavetpu_solve_model_gbps{path}          gauge: last solve's modeled GB/s
  wavetpu_solve_gbps{path}                histogram: modeled-GB/s dist
  wavetpu_device_bytes_in_use{context}    gauge: last sample
  wavetpu_device_peak_bytes{context}      gauge: allocator peak at sample
  wavetpu_device_memory_watermark_bytes   gauge: process-lifetime max
  wavetpu_device_memory_watermark_raises_total  counter: times it rose
  wavetpu_device_memory_warn_total        counter: threshold crossings

torch is never imported at module level: `sys.modules` is consulted for
the device-dependent defaults, and `profile_main` imports it when it
runs.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from wavetpu_torch.obs import tracing
from wavetpu_torch.obs.registry import MetricsRegistry, get_registry

# f32 operations per cell update, read off the kernels (chip_smoke.py
# phase 6): the 7-point Laplacian is 14, the leapfrog combine
# 2u + C*lap - u_prev 5 more, the compensated increment and Kahan
# two-sum 6.  They feed the arithmetic intensity only - every kernel is
# bound by its bytes.
FLOPS_PER_CELL = {"standard": 19.0, "compensated": 20.0}

# Nominal figure without a card: CPU fractions exercise the plumbing.
FALLBACK_PEAK_GBPS = 25.0

# CLI / ledger dtype names -> state itemsize.
DTYPE_ITEMSIZE = {"f32": 4, "f64": 8, "bf16": 2}


def hbm_gbps(name: str) -> float:
    """Published HBM rate (GB/s) of a card, from its name: H100 SXM 3350,
    PCIe 2000, NVL 3900; H200 4800."""
    if "H200" in name:
        return 4800.0
    if "PCIe" in name:
        return 2000.0
    if "NVL" in name:
        return 3900.0
    return 3350.0


def peak_gbps() -> float:
    """The roofline ceiling: WAVETPU_PEAK_GBPS env override, else the
    published HBM rate of CUDA device 0 when torch has one, else the
    nominal CPU figure."""
    env = os.environ.get("WAVETPU_PEAK_GBPS")
    if env:
        try:
            v = float(env)
            if v > 0:
                return v
        except ValueError:
            pass
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_available():
                return hbm_gbps(torch.cuda.get_device_name(0))
        except Exception:
            pass
    return FALLBACK_PEAK_GBPS


def _field_itemsize(itemsize: int) -> int:
    """A field rides in the compute dtype: f32 for f32 and bf16 states."""
    return max(itemsize, 4)


def launch_bytes(
    kind: str,
    block: Tuple[int, int, int],
    *,
    k: int = 1,
    itemsize: int = 4,
    v_itemsize: Optional[int] = None,
    carry_itemsize: Optional[int] = None,
    with_field: bool = False,
    ghost_axes: Sequence[int] = (),
    windows: bool = False,
    y_ext: int = 0,
    rows: bool = False,
) -> int:
    """Bytes one kernel launch must move (each input read once, each
    output written once) over a block of (d, ny, nz) central cells.

    kind "step" (K1, K5, K6): u_prev and u in, u_next out, the field in;
    `ghost_axes` adds two face planes per axis.  "comp_step" (K2, K7): u,
    v and carry in and out; ghosts of u.  "kstep" (K3, K8-K10): u_prev and
    u in (y-extended by `y_ext` rows per side), both layers out; with
    `windows` four k-plane x windows (and a field's two), with `rows` the
    oracle planes and per-x-plane rows.  "kstep_comp" (K4, K11, K12): u
    and v (y-extended), the carry, and u's and v's windows in; u, v and
    the carry out (`carry_itemsize` None: no carry)."""
    d, ny, nz = block
    central = d * ny * nz
    fi = _field_itemsize(itemsize)
    if kind in ("step", "comp_step"):
        streams = 3 if kind == "step" else 6
        faces = sum(2 * central // block[a] for a in ghost_axes)
        total = itemsize * (streams * central + faces)
        if with_field and kind == "step":
            total += fi * central
        return total
    py = ny + 2 * y_ext
    ext = d * py * nz
    window = k * py * nz
    nwin = 2 if windows else 0
    if kind == "kstep":
        total = itemsize * (2 * ext + 2 * nwin * window + 2 * central)
    elif kind == "kstep_comp":
        vi = itemsize if v_itemsize is None else v_itemsize
        ci = carry_itemsize or 0
        total = ((itemsize + vi) * (ext + nwin * window + central)
                 + 2 * ci * central)
    else:
        raise ValueError(f"unknown launch kind {kind!r}")
    if with_field:
        total += fi * (ext + nwin * window)
    if rows:
        # syz and rsyz (ny, nz) and sxct (k, d) in; dmax and rmax out.
        total += 4 * (2 * ny * nz + 3 * k * d)
    return total


def _is_comp_onion(path: str, scheme: str) -> bool:
    return path in ("kfused_comp", "kfused_comp_sharded") or (
        path == "kfused" and scheme == "compensated"
    )


def model_bytes_per_cell(
    path: str,
    *,
    scheme: str = "standard",
    k: int = 1,
    n: Optional[int] = None,
    itemsize: int = 4,
    v_itemsize: Optional[int] = None,
    carry: bool = True,
    carry_itemsize: Optional[int] = None,
    with_field: bool = False,
    block: Optional[Tuple[int, int, int]] = None,
    mesh_shape: Optional[Tuple[int, int, int]] = None,
    rows: bool = False,
) -> Optional[float]:
    """Bytes per cell update of the path's kernel launch (`launch_bytes`
    over k times its central cells).

     * `leapfrog` / `compensated` (K1/K5, K2): the whole (n, n, n) state;
     * `kfused` / `kfused_comp` (K3, K4): one k-step launch over the whole
       state (its windows are the state's own wrap planes; the k=1 tail
       is not modeled); the carry is bf16 for f32 state
       (`carry_itemsize` overrides), none with `carry=False`;
     * `sharded` (K6/K6f, K7): one shard `block`, with ghost faces on the
       axes whose `mesh_shape` dim is > 1;
     * `sharded_kfused` / `kfused_comp_sharded` (K8-K10, K11/K12): one
       shard block of (depth, n/MY, n) - its k-plane x window operands
       (copies from the neighbours, or views of the block on one x
       shard), k-row y extension where MY > 1, the oracle planes and rows
       with `rows` (errors on).

    The whole-domain kernels count their state and field streams only,
    as PERF.md §6's bound does.  Returns None when the config gives no
    shape to model (no `n` and no `block`)."""
    comp_onion = _is_comp_onion(path, scheme)
    onion = path in ("kfused", "sharded_kfused") and not comp_onion
    mesh = tuple(mesh_shape) if mesh_shape is not None else (1, 1, 1)
    if block is None:
        if n is None:
            return None
        block = (n, n, n)
    if not onion and not comp_onion:
        kind = ("comp_step" if scheme == "compensated"
                or path == "compensated" else "step")
        axes = [a for a in range(3) if mesh[a] > 1]
        nbytes = launch_bytes(kind, block, itemsize=itemsize,
                              with_field=with_field, ghost_axes=axes)
        return nbytes / (block[0] * block[1] * block[2])
    sharded = path in ("sharded_kfused", "kfused_comp_sharded")
    kw = dict(k=k, itemsize=itemsize, with_field=with_field,
              windows=sharded,
              y_ext=k if sharded and mesh[1] > 1 else 0,
              rows=sharded and rows)
    if comp_onion:
        if carry and carry_itemsize is None:
            carry_itemsize = 2 if itemsize == 4 else itemsize
        nbytes = launch_bytes(
            "kstep_comp", block, v_itemsize=v_itemsize,
            carry_itemsize=carry_itemsize if carry else None, **kw)
    else:
        nbytes = launch_bytes("kstep", block, **kw)
    return nbytes / (k * block[0] * block[1] * block[2])


def flops_per_cell(scheme: str = "standard") -> float:
    return FLOPS_PER_CELL.get(scheme, FLOPS_PER_CELL["standard"])


def solve_perf(
    gcells_per_s: float,
    path: str,
    *,
    scheme: str = "standard",
    k: int = 1,
    n: Optional[int] = None,
    itemsize: int = 4,
    v_itemsize: Optional[int] = None,
    carry: bool = True,
    carry_itemsize: Optional[int] = None,
    with_field: bool = False,
    block: Optional[Tuple[int, int, int]] = None,
    mesh_shape: Optional[Tuple[int, int, int]] = None,
    rows: bool = False,
) -> Optional[Dict[str, float]]:
    """One solve's roofline attribution, or None when no model exists
    for the config (no shape, zero throughput)."""
    if not gcells_per_s or gcells_per_s <= 0:
        return None
    bpc = model_bytes_per_cell(
        path, scheme=scheme, k=k, n=n, itemsize=itemsize,
        v_itemsize=v_itemsize, carry=carry, carry_itemsize=carry_itemsize,
        with_field=with_field, block=block, mesh_shape=mesh_shape,
        rows=rows,
    )
    if bpc is None:
        return None
    peak = peak_gbps()
    model_gbps = gcells_per_s * bpc
    fpc = flops_per_cell(scheme)
    return {
        "model_bytes_per_cell": round(bpc, 4),
        "model_gbps": round(model_gbps, 3),
        "peak_gbps": peak,
        "roofline_fraction": round(model_gbps / peak, 4),
        "flops_per_cell": fpc,
        "arithmetic_intensity": round(fpc / bpc, 4),
    }


_GBPS_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                 1000.0, 2000.0, 3000.0, 4000.0)


def record_roofline(registry: Optional[MetricsRegistry], path: str,
                    perf: Optional[Dict[str, float]]
                    ) -> Optional[Dict[str, float]]:
    """Stamp one solve's roofline attribution into `registry` (the
    process registry by default).  Returns `perf` unchanged so call
    sites can also attach the attrs to an open span."""
    if perf is None:
        return None
    reg = registry if registry is not None else get_registry()
    reg.gauge(
        "wavetpu_solve_roofline_fraction",
        "modeled-GB/s share of the memory roofline, most recent solve",
        ("path",),
    ).set(perf["roofline_fraction"], path=path)
    reg.gauge(
        "wavetpu_solve_model_gbps",
        "achieved HBM GB/s under the path's traffic model, most recent "
        "solve", ("path",),
    ).set(perf["model_gbps"], path=path)
    reg.histogram(
        "wavetpu_solve_gbps",
        "per-solve modeled-GB/s distribution", ("path",),
        buckets=_GBPS_BUCKETS,
    ).observe(perf["model_gbps"], path=path)
    return perf


# ------------------------------------------------- device memory


_mem_lock = threading.Lock()
# None = not yet probed; False = no CUDA device (every later call
# short-circuits); True = supported.
_mem_supported: Optional[bool] = None
# Test hook: a callable returning a memory_stats-shaped dict (or None)
# instead of reading the real device.
_stats_provider: Optional[Callable[[], Optional[dict]]] = None
_warn_bytes_override: Optional[int] = None


def set_memory_stats_provider(
    fn: Optional[Callable[[], Optional[dict]]]
) -> None:
    """Test hook: replace the device read (None restores it and resets
    the cached supported/unsupported verdict)."""
    global _stats_provider, _mem_supported
    with _mem_lock:
        _stats_provider = fn
        _mem_supported = None


def configure_memory_warn(warn_bytes: Optional[int]) -> None:
    """Set (or clear) the warn threshold programmatically; the
    WAVETPU_MEM_WARN_BYTES env var is the CLI-facing knob."""
    global _warn_bytes_override
    _warn_bytes_override = warn_bytes


def memory_warn_bytes() -> Optional[int]:
    if _warn_bytes_override is not None:
        return _warn_bytes_override
    env = os.environ.get("WAVETPU_MEM_WARN_BYTES")
    if env:
        try:
            v = int(float(env))
            if v > 0:
                return v
        except ValueError:
            pass
    return None


def _cuda_stats() -> Optional[dict]:
    """`torch.cuda.memory_stats()` of the current card, {} without a card,
    None while torch is not imported (not a verdict)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    if not torch.cuda.is_available():
        return {}
    return torch.cuda.memory_stats(torch.cuda.current_device())


def memory_snapshot() -> Optional[Dict[str, int]]:
    """{bytes_in_use, peak_bytes} from the CUDA caching allocator
    (`allocated_bytes.all.current` / `.peak`), or None without a card.
    The unsupported verdict is cached - later calls cost a dict lookup."""
    global _mem_supported
    if _mem_supported is False:
        return None
    provider = _stats_provider or _cuda_stats
    try:
        stats = provider()
    except Exception:
        # A transient read failure is NOT an "unsupported" verdict - do
        # not latch, just skip this sample and re-probe next time.
        return None
    if stats is None:
        return None  # torch not up yet: not a verdict, re-probe
    if not stats:
        # An empty answer: no device to read (the CPU) - cache that.
        with _mem_lock:
            _mem_supported = False
        return None
    with _mem_lock:
        _mem_supported = True
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    return {
        "bytes_in_use": in_use,
        "peak_bytes": int(stats.get("allocated_bytes.all.peak", in_use)),
    }


def record_memory(registry: Optional[MetricsRegistry] = None,
                  context: str = "solve") -> Optional[Dict[str, int]]:
    """Sample device memory into gauges (labeled by where the sample was
    taken), raise the process high-watermark gauge when exceeded (counting
    each raise), and fire the configurable warn-threshold event.  No-op
    (None) without a card."""
    snap = memory_snapshot()
    if snap is None:
        return None
    reg = registry if registry is not None else get_registry()
    reg.gauge(
        "wavetpu_device_bytes_in_use",
        "device-allocator bytes in use at the last sample", ("context",),
    ).set(snap["bytes_in_use"], context=context)
    reg.gauge(
        "wavetpu_device_peak_bytes",
        "device-allocator peak bytes at the last sample", ("context",),
    ).set(snap["peak_bytes"], context=context)
    wm = reg.gauge(
        "wavetpu_device_memory_watermark_bytes",
        "highest device bytes-in-use observed this process",
    )
    with reg.lock:
        if snap["bytes_in_use"] > wm.value():
            wm.set(snap["bytes_in_use"])
            reg.counter(
                "wavetpu_device_memory_watermark_raises_total",
                "times the high watermark rose",
            ).inc()
    warn = memory_warn_bytes()
    if warn is not None and snap["bytes_in_use"] > warn:
        reg.counter(
            "wavetpu_device_memory_warn_total",
            "samples above the WAVETPU_MEM_WARN_BYTES threshold",
        ).inc()
        tracing.event(
            "memory.warn", context=context,
            bytes_in_use=snap["bytes_in_use"], warn_bytes=warn,
        )
    return snap


# ------------------------------------------------- profiling


TRACE_FILENAME = "trace.json"
OPS_FILENAME = "device_ops.json"


def profiler_activities():
    """CPU, and CUDA where a card is visible."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def top_device_ops(prof, limit: int = 15) -> list:
    """[{name, count, device_ms, cpu_ms}] of a finished profiler's
    operations, by device time (host time where nothing ran on a card)."""
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0.0)
        rows.append({"name": ev.key, "count": int(ev.count),
                     "device_ms": float(dev) / 1e3,
                     "cpu_ms": float(ev.cpu_time_total) / 1e3})
    key = ("device_ms" if any(r["device_ms"] > 0 for r in rows)
           else "cpu_ms")
    rows.sort(key=lambda r: -r[key])
    return rows[:limit]


def export_profile(prof, out_dir: str, limit: int = 40) -> list:
    """Write the Chrome trace (`trace.json`) and the top operations
    (`device_ops.json`) of a finished profiler into `out_dir`; returns
    the top operations."""
    import json

    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILENAME))
    ops = top_device_ops(prof, limit)
    with open(os.path.join(out_dir, OPS_FILENAME), "w",
              encoding="utf-8") as f:
        json.dump(ops, f, indent=1)
    return ops


def trace_kernels(trace_path: str) -> dict:
    """The device kernels of an exported Chrome trace: {"kernels": {name:
    {count, ms}}, "kernel_ms": their sum, "span_ms": first start to last
    end, "busy": kernel_ms / span_ms (the device's busy share over the
    traced window; 1 - busy is its idle share)}."""
    import json

    with open(trace_path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    kernels: Dict[str, dict] = {}
    t0, t1, total = None, None, 0.0
    for ev in events:
        if ev.get("cat") != "kernel" or "dur" not in ev:
            continue
        row = kernels.setdefault(ev["name"], {"count": 0, "ms": 0.0})
        row["count"] += 1
        row["ms"] += ev["dur"] / 1e3
        total += ev["dur"] / 1e3
        t0 = ev["ts"] if t0 is None else min(t0, ev["ts"])
        end = ev["ts"] + ev["dur"]
        t1 = end if t1 is None else max(t1, end)
    span = 0.0 if t0 is None else (t1 - t0) / 1e3
    return {"kernels": kernels, "kernel_ms": total, "span_ms": span,
            "busy": total / span if span else 0.0}


def format_ops(ops: list, limit: int = 10) -> str:
    lines = [f"{'operation':<60} {'calls':>6} {'device ms':>10} "
             f"{'host ms':>9}"]
    for r in ops[:limit]:
        lines.append(f"{r['name'][:60]:<60} {r['count']:>6} "
                     f"{r['device_ms']:>10.3f} {r['cpu_ms']:>9.3f}")
    return "\n".join(lines)


_PROFILE_USAGE = (
    "usage: wavetpu-torch profile --out DIR [--] ARGS...\n"
    "  ARGS is a full wavetpu-torch command line: solver positionals +\n"
    "  flags for one solve.  The run gets a --telemetry-dir under DIR\n"
    "  unless ARGS already carries one, so the span annotations land\n"
    "  inside the trace."
)


def _dir_file_summary(root: str) -> Sequence[str]:
    lines = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            try:
                size = os.path.getsize(p)
            except OSError:
                continue
            lines.append(f"  {os.path.relpath(p, root)}  {size} B")
    return lines


def profile_main(argv: Sequence[str]) -> int:
    """`wavetpu-torch profile`: run one solve under `torch.profiler` so
    the application spans land in its trace, then print a post-capture
    summary (span stats, top device operations, captured files).  Do not
    combine with the inner `--profile` flag - this subcommand IS the
    bracket."""
    argv = list(argv)
    out = None
    inner = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--out" and i + 1 < len(argv):
            out = argv[i + 1]
            i += 2
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
            i += 1
        elif a == "--":
            inner = argv[i + 1:]
            i = len(argv)
        else:
            inner = argv[i:]
            i = len(argv)
    if not out or not inner:
        print(_PROFILE_USAGE, file=sys.stderr)
        return 2
    if "--profile" in inner or any(
        a.startswith("--profile=") for a in inner
    ):
        print("error: do not pass --profile under `wavetpu-torch profile` "
              "(the subcommand owns the bracket)", file=sys.stderr)
        return 2
    telemetry_dir = None
    for j, a in enumerate(inner):
        if a == "--telemetry-dir" and j + 1 < len(inner):
            telemetry_dir = inner[j + 1]
        elif a.startswith("--telemetry-dir="):
            telemetry_dir = a.split("=", 1)[1]
    if telemetry_dir is None:
        telemetry_dir = os.path.join(out, "telemetry")
        inner = inner + ["--telemetry-dir", telemetry_dir]
    os.makedirs(out, exist_ok=True)

    import torch

    from wavetpu_torch import cli as port_cli

    print(f"profiling `wavetpu-torch {' '.join(inner)}` -> {out}")
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=profiler_activities()) as prof:
        rc = port_cli.main(inner)
    wall = time.perf_counter() - t0
    ops = export_profile(prof, out)

    print(f"\nprofile capture: {wall:.3f}s wall, exit {rc}")
    trace_path = os.path.join(telemetry_dir, "trace.jsonl")
    if os.path.exists(trace_path):
        from wavetpu_torch.obs import report as obs_report

        records = obs_report.load_trace(trace_path)
        print("span summary (these kinds are annotated inside the "
              "trace):")
        print(obs_report.format_summary(obs_report.summarize(records)))
    print("top operations:")
    print(format_ops(ops))
    files = _dir_file_summary(out)
    print(f"captured files under {out}:")
    for line in files[:40]:
        print(line)
    if len(files) > 40:
        print(f"  ... {len(files) - 40} more")
    print(f"open {os.path.join(out, TRACE_FILENAME)} in chrome://tracing "
          f"or Perfetto")
    return rc
