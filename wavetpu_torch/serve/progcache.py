"""Persistent program cache: built kernel libraries survive restarts (the
port of wavetpu/serve/progcache.py).

On the card a cold replica's first request pays the nvcc build of the
kernel libraries it launches (kernels/build.py, about a minute for all
four), and a fresh container or a fresh build directory pays it again.
This module is the disk tier under the serve engine's in-memory LRU
(`--program-cache-dir`):

    memory LRU  ->  disk (this module)  ->  fresh build (nvcc)

What wavetpu stores is a serialized XLA executable; what a "compiled
program" is in the port is the set of built kernel libraries the key
launches (`stencil_cuda.libraries_for`; none for the plain versions on the
CPU or on the roll path).  An entry is one file per (ProgramKey,
environment fingerprint):

    DIR/<sha256(key)[:20]>-<sha256(fingerprint)[:8]>.wtpc

    MAGIC | u32 header_len | header JSON | payload

The payload is raw bytes with a JSON index, never a pickle:

    u32 index_len | index JSON | library bytes, one after another

where the index names each library (`name`, its hashed build file name
`kernels/build.lib_path`, `sha256`, `len`) and the template
instantiations the process launched before it stored the entry
(`stencil_cuda.launched_instantiations`; empty where the entry was stored
at build time, before any launch).  The header carries the full key, the
fingerprint, the FRESH build seconds the entry replaces (the measured
savings credit) and the payload's sha256 and length.  Writes are atomic
(tmp + os.replace); loads check the magic, the fingerprint, the length
and the checksum - a truncated or stale entry is a COUNTED miss that falls
through to a fresh build, never a crash and never a circuit-breaker feed.

`env_fingerprint()` names everything a built library is valid under: the
port's version, torch's, the CUDA runtime and driver versions, the
device's name and compute capability, nvcc's version and flags, and a
hash of csrc/*.cu and *.cuh.  An edited kernel source therefore changes
the fingerprint: its entries are never read, and a load that finds only
entries of the same key under another fingerprint counts
`fingerprint_mismatch`.  On the CPU the fingerprint names the CPU and the
payload holds no library (the plain versions need no build), so store,
load, GC and the corruption drills run for real in the CPU tests.

wavetpu probes whether its jaxlib can serialize executables and falls
back to XLA's own compilation cache when it cannot; the port has nothing
to probe - a library is a file - so `usable` is always True and the
/metrics block reports a static verdict under wavetpu's names.

Adopting an entry (`adopt_libraries`, through the ensembles'
`adopt_executable`): each library's sha256 is checked, its bytes are
written atomically into the build directory under its hashed name
(`build.install`), and `build.load` loads it as a disk load, not an nvcc
run.  A library this process loaded already is kept (a memory hit), so
adoption must come before a name's first load to matter.  An adopt that
fails is a counted `corrupt` or `fingerprint_mismatch` and the caller
builds fresh (nvcc, which raises without nvcc) - never the plain versions.
CUDA still loads each template instantiation at its first launch
(`stencil_cuda.first_launch_seconds`), so an adopted program pays that on
its first batch: it is reported in Server-Timing's `compile`.

Size is bounded by `--program-cache-max-bytes`: LRU by access time (entry
mtime, refreshed on every hit), oldest evicted first, the newest entry
never evicted.

`python -m wavetpu_torch warmup --manifest MANIFEST.json
[--program-cache-dir DIR]` (main below) consumes `ledger-report
--emit-warmup-manifest`'s output verbatim (wavetpu's or the port's) and
fills a replica's disk cache, printing per-key timings; `serve
--warmup-manifest` runs the same keys through the engine on the
background warmup thread, so /healthz readiness flips once the manifest
is warm.  Stdlib at import; torch only inside functions.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform as _platform
import struct
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

from wavetpu_torch import progkey
from wavetpu_torch.obs import ledger as compile_ledger

MAGIC = b"WTPC0001"
ENTRY_SUFFIX = ".wtpc"

FINGERPRINT_FIELDS = ("wavetpu_torch", "torch", "cuda_runtime",
                      "cuda_driver", "device_name", "compute_capability",
                      "nvcc", "nvcc_flags", "csrc_sha256")

_fp_lock = threading.Lock()
_nvcc_version: Optional[str] = None


def _csrc_sha256() -> str:
    """One hash over every kernel source and header (csrc/*.cu, *.cuh)."""
    from wavetpu_torch.kernels import build

    h = hashlib.sha256()
    for p in sorted(build.CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    """nvcc's version line, or "none" where there is no nvcc (cached)."""
    global _nvcc_version
    with _fp_lock:
        if _nvcc_version is None:
            from wavetpu_torch.kernels import build

            try:
                out = subprocess.run(
                    [build.find_nvcc(), "--version"], capture_output=True,
                    text=True, timeout=60).stdout
                lines = [ln for ln in out.splitlines() if ln.strip()]
                _nvcc_version = lines[-1].strip() if lines else "unknown"
            except Exception:
                _nvcc_version = "none"
        return _nvcc_version


def _cuda_driver() -> str:
    """The CUDA driver's version (cuDriverGetVersion), or "unknown"."""
    try:
        import ctypes

        v = ctypes.c_int()
        if ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(
                ctypes.byref(v)) == 0:
            return f"{v.value // 1000}.{v.value % 1000 // 10}"
    except Exception:
        pass
    return "unknown"


def env_fingerprint(device=None) -> dict:
    """The environment identity a built library is valid under, for
    `device` (default: the CUDA device when there is one, else the CPU).
    Any field drifting invalidates every entry written under the old
    value - by file name, so stale entries are never adopted."""
    import torch

    from wavetpu_torch import __version__
    from wavetpu_torch.kernels import build

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        name = props.name
        cc = f"{props.major}.{props.minor}"
        driver = _cuda_driver()
    else:
        name = f"cpu:{_platform.machine() or 'unknown'}"
        cc = "none"
        driver = "none"
    return {
        "wavetpu_torch": __version__,
        "torch": torch.__version__,
        "cuda_runtime": str(torch.version.cuda),
        "cuda_driver": driver,
        "device_name": name,
        "compute_capability": cc,
        "nvcc": _nvcc(),
        "nvcc_flags": " ".join(build.NVCC_FLAGS),
        "csrc_sha256": _csrc_sha256(),
    }


def fingerprint_tag(fp: Optional[dict]) -> str:
    """The short hash of a fingerprint (entry file names, the result
    cache's `X-Wavetpu-Cache: store;fp=TAG`)."""
    return hashlib.sha256(
        json.dumps(fp, sort_keys=True).encode()).hexdigest()[:8]


def probe_results() -> list:
    """The /metrics `aot_probes` rows: a static verdict (wavetpu probes
    its jaxlib here; a library payload has nothing to probe)."""
    return [{"probe": "kernel_library_payload", "ok": True, "reason": None}]


# ------------------------------------------------------- library payloads


class FingerprintMismatch(ValueError):
    """A payload's library was built from other sources or flags than
    this checkout's."""


def library_payload(names: Sequence[str], insts=None) -> dict:
    """The payload of a program that launches the libraries `names`: each
    built library's name, hashed file name and bytes, plus the template
    instantiations launched so far (default: this process's)."""
    from wavetpu_torch.kernels import build, stencil_cuda

    libs = []
    for name in names:
        path = build.lib_path(name)
        data = path.read_bytes()
        libs.append({"name": name, "file": path.name, "data": data,
                     "sha256": hashlib.sha256(data).hexdigest()})
    if insts is None:
        insts = stencil_cuda.launched_instantiations()
    return {"libraries": libs, "insts": [list(i) for i in insts]}


def encode_payload(payload: dict) -> bytes:
    """u32 index_len | index JSON | library bytes (no pickle)."""
    index = {"format": 1, "insts": payload.get("insts", []),
             "libraries": []}
    datas = []
    for lib in payload["libraries"]:
        data = bytes(lib["data"])
        index["libraries"].append({
            "name": lib["name"], "file": lib["file"],
            "sha256": lib["sha256"], "len": len(data)})
        datas.append(data)
    raw = json.dumps(index, sort_keys=True).encode()
    return struct.pack(">I", len(raw)) + raw + b"".join(datas)


def decode_payload(blob: bytes) -> dict:
    (n,) = struct.unpack(">I", blob[:4])
    index = json.loads(blob[4:4 + n])
    off = 4 + n
    libs = []
    for lib in index["libraries"]:
        data = blob[off:off + int(lib["len"])]
        if len(data) != int(lib["len"]):
            raise ValueError("payload shorter than its index")
        off += len(data)
        libs.append(dict(lib, data=data))
    if off != len(blob):
        raise ValueError("payload longer than its index")
    return {"libraries": libs, "insts": index.get("insts", [])}


def adopt_libraries(payload: dict, need: Sequence[str]) -> dict:
    """Install and load each library a program needs from `payload`;
    returns {name: "memory" | "present" | "written"}.  A library missing
    from the payload or failing its sha256 raises ValueError; one built
    from other sources or flags raises FingerprintMismatch.  Nothing is
    written or loaded unless every library checks out."""
    from wavetpu_torch.kernels import build, stencil_cuda

    by_name = {lib["name"]: lib for lib in payload.get("libraries", ())}
    missing = [n for n in need if n not in by_name]
    if missing:
        raise ValueError(f"payload lacks the libraries {missing}")
    for name in need:
        lib = by_name[name]
        if lib["file"] != build.lib_path(name).name:
            raise FingerprintMismatch(
                f"library {name} was built as {lib['file']}, this "
                f"checkout builds {build.lib_path(name).name}")
        if hashlib.sha256(lib["data"]).hexdigest() != lib["sha256"]:
            raise ValueError(f"library {name}: bytes do not hash to "
                             f"their recorded sha256")
    placed = {name: build.install(name, by_name[name]["file"],
                                  by_name[name]["data"],
                                  by_name[name]["sha256"])
              for name in need}
    for name in need:
        stencil_cuda._LOADERS[name]()
    return placed


# ------------------------------------------------------ the disk tier


class ProgramCache:
    """Disk-backed library store for one directory.

    Thread-safe; every failure mode (corrupt entry, stale fingerprint,
    full disk) is a counted event in
    `wavetpu_progcache_events_total{event=}` and a None/False return -
    the serve path treats disk problems as cache misses, never as request
    failures.  `read_only` (a --distributed rank other than 0) loads
    entries and changes nothing on disk: no directory made, no LRU
    touch, no corrupt entry removed."""

    def __init__(self, directory: str,
                 max_bytes: Optional[int] = None,
                 registry=None, fault_plan=None, device=None,
                 read_only: bool = False):
        self.directory = directory
        self.read_only = read_only
        if not read_only:
            os.makedirs(directory, exist_ok=True)
        self.max_bytes = max_bytes
        self.fault_plan = fault_plan
        self._lock = threading.Lock()
        self.counts: dict = {}
        self._counter = None
        self._saved = None
        if registry is not None:
            self._counter = registry.counter(
                "wavetpu_progcache_events_total",
                "persistent program-cache events", ("event",),
            )
            self._saved = registry.counter(
                "wavetpu_progcache_saved_seconds_total",
                "build seconds served from disk instead of nvcc "
                "(fresh build seconds minus adopt seconds)",
            )
        self.fingerprint = env_fingerprint(device)
        self._fp_hash = fingerprint_tag(self.fingerprint)

    # ---- bookkeeping ----

    @property
    def usable(self) -> bool:
        """Always True: a library payload needs no capability probe."""
        return True

    def count(self, event: str, n: int = 1) -> None:
        with self._lock:
            self.counts[event] = self.counts.get(event, 0) + n
        if self._counter is not None:
            self._counter.inc(n, event=event)

    def credit_saved(self, fresh_compile_s: float,
                     load_s: float) -> float:
        saved = max(0.0, float(fresh_compile_s) - float(load_s))
        if self._saved is not None and saved > 0:
            self._saved.inc(saved)
        return saved

    def _key_hash(self, key: dict) -> str:
        return hashlib.sha256(
            progkey.canonical_key(key).encode()).hexdigest()[:20]

    def entry_path(self, key: dict) -> str:
        return os.path.join(
            self.directory,
            f"{self._key_hash(key)}-{self._fp_hash}{ENTRY_SUFFIX}")

    def _entries(self):
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not name.endswith(ENTRY_SUFFIX):
                continue
            p = os.path.join(self.directory, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            out.append((p, st.st_size, st.st_mtime))
        return out

    # ---- store / load ----

    def put(self, key: dict, payload: dict, compile_s: float) -> bool:
        """Atomically persist one program's payload; returns True on
        success.  `compile_s` is the fresh build this entry spares later
        processes - the measured-savings credit a later load reports."""
        try:
            blob = encode_payload(payload)
            header = {
                "format": 1,
                "key": progkey.normalize_key(key),
                "fingerprint": dict(self.fingerprint),
                "created_unix": round(time.time(), 3),
                "compile_s": round(float(compile_s), 6),
                "payload_sha256": hashlib.sha256(blob).hexdigest(),
                "payload_len": len(blob),
                "libraries": [lib["name"] for lib in payload["libraries"]],
            }
            hdr = json.dumps(header, sort_keys=True).encode()
            path = self.entry_path(key)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(MAGIC)
                f.write(struct.pack(">I", len(hdr)))
                f.write(hdr)
                f.write(blob)
            os.replace(tmp, path)
        except Exception:
            self.count("store_error")
            return False
        self.count("store")
        if self.max_bytes is not None:
            self.gc()
        return True

    def load(self, key: dict) -> Optional[Tuple[dict, dict]]:
        """(payload, header) for a valid entry, else None - with the
        reason counted (`disk_miss` / `corrupt` /
        `fingerprint_mismatch`).  A hit refreshes the entry's mtime (the
        GC's LRU clock); a corrupt entry is deleted so later processes
        pay a plain disk_miss.  Never raises."""
        path = self.entry_path(key)
        if not os.path.exists(path):
            # Entries of this key under another fingerprint (an edited
            # kernel source, another card or toolkit) are stale, never
            # adopted: counted apart from a plain miss.
            prefix = self._key_hash(key) + "-"
            stale = any(os.path.basename(p).startswith(prefix)
                        for p, _s, _m in self._entries())
            self.count("fingerprint_mismatch" if stale else "disk_miss")
            return None

        def _corrupt():
            self.count("corrupt")
            if self.read_only:
                return None
            try:
                os.remove(path)
            except OSError:
                pass
            return None

        # Chaos seams (run/faults.py): drive the REAL detection branches
        # - truncate the entry on disk, or poison the expected
        # fingerprint, then read normally.
        expected_fp = self.fingerprint
        if self.fault_plan is not None:
            ctx = {
                "n": key.get("N"), "timesteps": key.get("timesteps"),
                "scheme": key.get("scheme"), "path": key.get("path"),
                "k": key.get("k"), "dtype": key.get("dtype"),
            }
            if self.fault_plan.fire("progcache-truncate", **ctx):
                from wavetpu_torch.run import faults as _faults

                try:
                    _faults.truncate_tail(path, drop_bytes=64)
                except OSError:
                    pass
            if self.fault_plan.fire("progcache-fingerprint", **ctx):
                expected_fp = dict(self.fingerprint,
                                   wavetpu_torch="injected-other-version")
        try:
            with open(path, "rb") as f:
                if f.read(len(MAGIC)) != MAGIC:
                    return _corrupt()
                raw_len = f.read(4)
                if len(raw_len) != 4:
                    return _corrupt()
                (hdr_len,) = struct.unpack(">I", raw_len)
                hdr = f.read(hdr_len)
                if len(hdr) != hdr_len:
                    return _corrupt()
                header = json.loads(hdr)
                if header.get("fingerprint") != expected_fp:
                    self.count("fingerprint_mismatch")
                    return None
                blob = f.read()
            if (
                len(blob) != header.get("payload_len")
                or hashlib.sha256(blob).hexdigest()
                != header.get("payload_sha256")
            ):
                return _corrupt()
            payload = decode_payload(blob)
        except Exception:
            return _corrupt()
        try:
            if not self.read_only:
                os.utime(path)
        except OSError:
            pass
        self.count("disk_hit")
        return payload, header

    def gc(self) -> int:
        """Evict oldest-accessed entries until the directory fits
        `max_bytes`; the newest entry is never evicted (a budget smaller
        than one program degrades to keep-latest, not keep-nothing).
        Returns the eviction count."""
        if self.max_bytes is None:
            return 0
        entries = sorted(self._entries(), key=lambda e: e[2])
        total = sum(e[1] for e in entries)
        evicted = 0
        while total > self.max_bytes and len(entries) > 1:
            path, size, _mtime = entries.pop(0)
            try:
                os.remove(path)
            except OSError:
                continue
            total -= size
            evicted += 1
        if evicted:
            self.count("gc_evict", evicted)
        return evicted

    def entry_keys(self) -> List[dict]:
        """ProgramKey dicts of every ADOPTABLE entry: same-fingerprint
        `.wtpc` files whose header parses (headers only) - the disk half
        of /metrics' `program_cache.warm_keys`."""
        suffix = f"-{self._fp_hash}{ENTRY_SUFFIX}"
        out: List[dict] = []
        for path, _size, _mtime in self._entries():
            if not os.path.basename(path).endswith(suffix):
                continue
            try:
                with open(path, "rb") as f:
                    if f.read(len(MAGIC)) != MAGIC:
                        continue
                    raw_len = f.read(4)
                    if len(raw_len) != 4:
                        continue
                    (hdr_len,) = struct.unpack(">I", raw_len)
                    if hdr_len > 1 << 20:
                        continue
                    header = json.loads(f.read(hdr_len))
            except Exception:
                continue
            key = header.get("key")
            if isinstance(key, dict):
                out.append(key)
        return out

    def stats(self) -> dict:
        """The /metrics `program_cache.progcache` block (wavetpu's keys:
        `aot` is True, the XLA-cache fields False - the port has neither
        a probe nor a fallback)."""
        entries = self._entries()
        with self._lock:
            counts = dict(self.counts)
        return {
            "enabled": True,
            "dir": self.directory,
            "aot": True,
            "xla_cache": False,
            "xla_fallback": False,
            "entries": len(entries),
            "bytes": sum(e[1] for e in entries),
            "max_bytes": self.max_bytes,
            "events": counts,
            "aot_probes": probe_results(),
        }


# ----------------------------------------- manifest-driven warmup CLI

def _dtype_from_name(name: str):
    import torch

    table = {"f32": torch.float32, "f64": torch.float64,
             "bf16": torch.bfloat16}
    if name not in table:
        raise ValueError(f"unknown dtype {name!r}")
    return table[name]


def _problem(pk):
    from wavetpu_torch.core.problem import Problem

    return Problem(N=pk.N, Np=1, Lx=pk.Lx, Ly=pk.Ly, Lz=pk.Lz, T=pk.T,
                   timesteps=pk.timesteps)


def build_solver_for_key(pk, device):
    """The (unbuilt) program a ProgramKey describes - the same constructor
    calls `ServeEngine._program` makes, honoring the key's own
    compute_errors; a `path@chunkL` key is a chunk runner
    (serve/preempt.py)."""
    from wavetpu_torch.ensemble import batched as ensemble
    from wavetpu_torch.ensemble import sharded as ens_sharded

    problem = _problem(pk)
    if "@chunk" in pk.path:
        from wavetpu_torch.serve import preempt

        base, _, clen = pk.path.partition("@chunk")
        return preempt.ChunkRunner(
            problem, pk.scheme, base, pk.k, _dtype_from_name(pk.dtype),
            pk.dtype, pk.compute_errors, chunk_steps=int(clen),
            device=device)
    if pk.mesh is not None:
        n = pk.mesh[0] * pk.mesh[1] * pk.mesh[2]
        return ens_sharded.ShardedEnsembleSolver(
            problem, pk.batch, pk.mesh, dtype=_dtype_from_name(pk.dtype),
            kernel=pk.path, compute_errors=pk.compute_errors,
            devices=_mesh_devices(device, n),
        )
    return ensemble.EnsembleSolver(
        problem, pk.batch, dtype=_dtype_from_name(pk.dtype), path=pk.path,
        k=pk.k, compute_errors=pk.compute_errors,
        with_field=pk.with_field, scheme=pk.scheme, device=device,
    )


def _mesh_devices(device, n: int):
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def cannot_hold(pk, device) -> Optional[str]:
    """Why the device cannot hold this key's program (a mesh whose shards
    own no real plane, or states larger than the card's memory), or None.
    Such a key is skipped, not failed."""
    import torch

    if pk.mesh is not None:
        from wavetpu_torch.core.grid import Topology

        need = pk.mesh[0] * pk.mesh[1] * pk.mesh[2]
        try:
            Topology(N=pk.N, mesh_shape=tuple(pk.mesh))
        except ValueError as e:
            return f"mesh needs {need} shards of N={pk.N}: {e}"
    device = torch.device(device)
    if device.type == "cuda":
        itemsize = {"f32": 4, "f64": 8, "bf16": 2}.get(pk.dtype, 4)
        # Four (B, N, N, N) state arrays and a field per lane at most.
        need_bytes = 5 * max(1, pk.batch) * pk.N ** 3 * itemsize
        total = torch.cuda.get_device_properties(device).total_memory
        if need_bytes > total:
            return (f"states need {need_bytes} bytes, the card holds "
                    f"{total}")
    return None


def load_manifest(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) or not manifest.get(
        compile_ledger.MANIFEST_FLAG
    ):
        raise ValueError(
            f"{path} is not a warmup manifest (missing "
            f"{compile_ledger.MANIFEST_FLAG!r}; produce one with "
            f"`ledger-report DIR --emit-warmup-manifest OUT`)"
        )
    if not isinstance(manifest.get("keys"), list):
        raise ValueError(f"{path}: manifest `keys` must be a list")
    return manifest


def warm_manifest_into_cache(
    manifest: dict, cache: Optional[ProgramCache] = None, device="cpu",
    out=None,
) -> dict:
    """Build (or disk-adopt) every manifest key on `device`, storing fresh
    builds into `cache`; prints one per-key timing line to `out` and
    returns the summary.  Builds only: nothing launches.  Per-key
    failures are recorded and do not stop the sweep."""
    out = sys.stdout if out is None else out
    summary = {"keys": 0, "disk_hits": 0, "compiled": 0, "skipped": 0,
               "failed": 0, "compile_s": 0.0, "errors": []}
    for raw in manifest.get("keys", ()):
        summary["keys"] += 1
        try:
            pk = progkey.program_key_from_dict(raw)
        except Exception as e:
            summary["failed"] += 1
            summary["errors"].append(f"bad key {raw!r}: {e}")
            print(f"  bad key: {e}", file=out)
            continue
        key_dict = progkey.key_from_program_key(pk)
        label = compile_ledger._key_label(key_dict)
        why = cannot_hold(pk, device)
        if why is not None:
            summary["skipped"] += 1
            print(f"  {label}: skip ({why})", file=out)
            continue
        try:
            t0 = time.perf_counter()
            solver = build_solver_for_key(pk, device)
            if cache is not None:
                entry = cache.load(key_dict)
                if entry is not None:
                    try:
                        solver.adopt_executable(entry[0])
                        dt = time.perf_counter() - t0
                        summary["disk_hits"] += 1
                        print(f"  {label}: disk hit ({dt:.3f}s)", file=out)
                        continue
                    except FingerprintMismatch:
                        cache.count("fingerprint_mismatch")
                    except Exception:
                        cache.count("corrupt")
            compile_s = (solver.prime() if hasattr(solver, "prime")
                         else solver.compile())
            summary["compiled"] += 1
            summary["compile_s"] += compile_s
            stored = False
            if cache is not None:
                payload = solver.executable_payload()
                if payload is not None:
                    stored = cache.put(key_dict, payload, compile_s)
            print(f"  {label}: compiled {compile_s:.3f}s"
                  + (" -> cached" if stored else ""), file=out)
        except Exception as e:
            summary["failed"] += 1
            summary["errors"].append(f"{label}: {e}")
            print(f"  {label}: FAILED ({type(e).__name__}: {e})", file=out)
    summary["compile_s"] = round(summary["compile_s"], 6)
    return summary


_USAGE = (
    "usage: python -m wavetpu_torch warmup --manifest MANIFEST.json "
    "[--program-cache-dir DIR] [--program-cache-max-bytes B] "
    "[--platform gpu|cpu]"
)

_KNOWN = ("manifest", "program-cache-dir", "program-cache-max-bytes",
          "platform")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """`warmup`: fill a replica's program cache from a ledger-report
    manifest.  Exit 0 on success (skips are not failures), 1 when a key
    failed to build, 2 on usage or without a card on `--platform gpu`
    (the default)."""
    from wavetpu_torch.core.flags import split_flags

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        _, flags = split_flags(argv, _KNOWN, (), allow_positionals=False)
        if "manifest" not in flags:
            raise ValueError("missing --manifest MANIFEST.json")
        manifest = load_manifest(flags["manifest"])
        max_bytes = (int(flags["program-cache-max-bytes"])
                     if "program-cache-max-bytes" in flags else None)
        platform = flags.get("platform", "gpu")
        if platform not in ("gpu", "cpu"):
            raise ValueError(f"--platform must be gpu|cpu, got {platform}")
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        print(_USAGE, file=sys.stderr)
        return 2

    import torch

    if platform == "gpu" and not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU unless "
              "--platform cpu is given", file=sys.stderr)
        return 2
    device = "cuda" if platform == "gpu" else "cpu"
    cache = None
    if "program-cache-dir" in flags:
        cache = ProgramCache(flags["program-cache-dir"],
                             max_bytes=max_bytes, device=device)
        print(f"program cache: {cache.directory} [built kernel libraries, "
              f"fingerprint {cache._fp_hash}]")
    else:
        print("note: no --program-cache-dir; builds will not persist "
              "beyond this process")
    t0 = time.perf_counter()
    summary = warm_manifest_into_cache(manifest, cache, device=device)
    wall = time.perf_counter() - t0
    print(
        f"warmed {summary['keys']} key(s) in {wall:.3f}s: "
        f"{summary['disk_hits']} disk hit(s), "
        f"{summary['compiled']} compiled "
        f"({summary['compile_s']:.3f}s), "
        f"{summary['skipped']} skipped, {summary['failed']} failed"
    )
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
