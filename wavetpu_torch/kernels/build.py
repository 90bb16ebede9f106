"""Build and load the CUDA kernels of `kernels/csrc/`.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
compiled by nvcc for Hopper and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
         -Xcompiler -fPIC -o <build dir>/lib<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes about a minute
(comp_sharded.cu and kstep_pipe.cu hold about a hundred instantiations each
of the compensated pipeline of K4, K11 and K12 and of the standard one of
K3 and K8-K10; the sources build side by side).  Sources
share `csrc/*.cuh`, which every library's hash covers.  The build directory
is `kernels/_build/` inside the checkout (git ignores it; the
WAVETPU_TORCH_BUILD_DIR environment variable moves it).  The file name
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  `build_all()` starts one nvcc per source,
all at once, and waits for them together.

Nothing here runs at import: the first kernel launch (or an explicit
`build_all()`) builds.  A missing nvcc or a failed build raises.

`stats` counts what the process paid for its kernels: nvcc runs and their
wall seconds, and libraries loaded (`disk_loads` of them found already
built in the build directory) with the load's wall seconds - the compile
ledger's record of a solve (obs/ledger.py).

`install()` is the persistent program cache's way in (serve/progcache.py):
it places a library's bytes, checked against their sha256 and the name
this process would build them under, atomically in the build directory,
where the next `load` finds it and counts a disk load, not an nvcc run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
stats = {"nvcc_runs": 0, "nvcc_seconds": 0.0, "loads": 0, "disk_loads": 0,
         "load_seconds": 0.0}


def build_dir() -> Path:
    return Path(
        os.environ.get("WAVETPU_TORCH_BUILD_DIR")
        or Path(__file__).resolve().parent / "_build"
    )


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (on PATH or in the CUDA toolkit's bin): the CUDA "
            "kernels of wavetpu_torch build at first use"
        )
    return nvcc


def sources() -> List[str]:
    """Names of the kernel sources (csrc/<name>.cu)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    """Where csrc/<name>.cu's library is built: the name carries a hash of
    the source, every csrc/*.cuh and the flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, extra_flags=()):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for one nvcc; publish the library atomically.  Returns the
    compiler's output (ptxas statistics with -Xptxas -v)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(verbose: bool = False,
              names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Build every csrc/*.cu (or each of `names`) that is not built yet,
    one nvcc per source, all started together.  With `verbose` nvcc also
    prints ptxas's register / shared-memory / spill report.  Returns
    {name: compiler output}."""
    extra = ("-Xptxas", "-v") if verbose else ()
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n, extra)
                   for n in (sources() if names is None else names)}
        logs = {n: _finish(n, s) for n, s in started.items()}
        runs = sum(s is not None for s in started.values())
        if runs:
            stats["nvcc_runs"] += runs
            stats["nvcc_seconds"] += time.perf_counter() - t0
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            started = _start(name)
            _finish(name, started)
            t1 = time.perf_counter()
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
            if started is None:
                stats["disk_loads"] += 1
            else:
                stats["nvcc_runs"] += 1
                stats["nvcc_seconds"] += t1 - t0
            stats["loads"] += 1
            stats["load_seconds"] += time.perf_counter() - t1
        return lib


def install(name: str, file_name: str, data: bytes, sha256: str) -> str:
    """Place a built library of csrc/<name>.cu from elsewhere (the program
    cache) in the build directory, so `load` finds it: the bytes must hash
    to `sha256` and `file_name` must be the name this process builds the
    library under (the same sources and flags), else ValueError.  Returns
    "memory" (already loaded here: kept), "present" (the build directory
    holds it already) or "written" (placed atomically, tmp + rename)."""
    if hashlib.sha256(data).hexdigest() != sha256:
        raise ValueError(f"library {name}: bytes do not hash to their "
                         f"recorded sha256")
    out = lib_path(name)
    if file_name != out.name:
        raise ValueError(f"library {name}: built as {file_name}, this "
                         f"checkout builds {out.name} (sources or flags "
                         f"differ)")
    with _lock:
        if name in _libs:
            return "memory"
        if out.exists():
            return "present"
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp-{os.getpid()}")
        tmp.write_bytes(data)
        os.replace(tmp, out)
        return "written"
