"""Build and load the CUDA kernels of `kernels/csrc/`.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
compiled by nvcc for Hopper and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -shared
         -Xcompiler -fPIC -o <build dir>/lib<name>-<hash>.so csrc/<name>.cu

No PyTorch headers are included, so a build takes about a minute (stencil.cu
holds 64 instantiations of the k-step kernel).  The build
directory is `kernels/_build/` inside the checkout (git ignores it; the
WAVETPU_TORCH_BUILD_DIR environment variable moves it).  The file name
carries a hash of the source and the flags, so an edited source rebuilds
and an unchanged one is reused.  `build_all()` starts one nvcc per source,
all at once, and waits for them together.

Nothing here runs at import: the first kernel launch (or an explicit
`build_all()`) builds.  A missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, extra_flags=()):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = _lib_path(name)
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


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Build every csrc/*.cu that is not built yet, one nvcc per source, all
    started together.  With `verbose` nvcc also prints ptxas's register /
    shared-memory / spill report.  Returns {name: compiler output}."""
    extra = ("-Xptxas", "-v") if verbose else ()
    with _lock:
        started = {n: _start(n, extra) for n in sources()}
        return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
