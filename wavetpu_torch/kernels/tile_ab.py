"""A/B timing of K4's compile-time tile depth on the card.

    python -m wavetpu_torch.kernels.tile_ab [--n 512] [--reps 30]

csrc/stencil.cu instantiates the k-step kernel twice per storage mode and
k: with the tile depth tx fixed at compile time (tx = kMaxTx = 8, what the
main path launches) and with tx read at run time (any other tx).  This
script builds the source as it is (A) and a copy whose dispatch always
takes the run-time instantiation (B), holds B's outputs bitwise against
A's, and times both at N (f32 v, bf16 carry; k=4 and k=1) in the order
A, B, B, A - median of `reps` launches each, CUDA events.  It prints the
card's name and power limit and one JSON line of the times.  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time

import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import build, stencil_cuda
from wavetpu_torch.solver import kfused

_FIXED = "return tx == kMaxTx"
_RUNTIME = "return false"


def _build_variants() -> dict:
    """{'A': library of the source, 'B': the run-time-tx-only copy}."""
    src = (build.CSRC / "stencil.cu").read_text()
    if src.count(_FIXED) != 1:
        raise RuntimeError("csrc/stencil.cu: K4 dispatch not found")
    out = build.build_dir() / "tile_ab"
    out.mkdir(parents=True, exist_ok=True)
    (out / "runtime_tx.cu").write_text(src.replace(_FIXED, _RUNTIME))
    paths = {"A": build.CSRC / "stencil.cu", "B": out / "runtime_tx.cu"}
    procs = {
        k: subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                             str(out / f"{k}.so"), str(p)])
        for k, p in paths.items()
    }
    for k, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {k}")
    return {k: ctypes.CDLL(str(out / f"{k}.so")) for k in paths}


def _median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_ab needs a CUDA device")
    t0 = time.perf_counter()
    libs = _build_variants()
    print(f"built A and B in {time.perf_counter() - t0:.1f} s")

    n = args.n
    p = Problem(N=n, timesteps=1000)
    g = torch.Generator().manual_seed(0)

    def field(scale, dtype=torch.float32):
        a = torch.randn((n, n, n), generator=g) * scale
        a[:, 0, :] = 0.0
        a[:, :, 0] = 0.0
        return a.to("cuda", dtype)

    u, v, c = field(1.0), field(1e-3), field(1e-8, torch.bfloat16)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cuda")

    def use(name):
        build._libs["stencil"] = libs[name]

    def k4(k):
        sxct = ct[2:2 + k][:, None] * sx[None, :]
        return lambda: stencil_cuda.fused_kstep_comp(
            u, v, c, syz, rsyz, sxct, k=k, coeff=p.a2tau2, inv_h2=p.inv_h2)

    result = {}
    for k in (4, 1):
        outs = {}
        for name in ("A", "B"):
            use(name)
            outs[name] = k4(k)()
        for i, (a, b) in enumerate(zip(outs["A"], outs["B"])):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise SystemExit(f"k={k} output {i}: A and B differ")
        runs = []
        for name in ("A", "B", "B", "A"):
            use(name)
            runs.append([name, _median_ms(k4(k), args.reps)])
        result[f"k{k}"] = runs
        print(f"k={k} N={n}: A and B bitwise equal; median ms {runs}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "n": n, "ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
