"""A/B timing of the cone kernels' compile-time tile depth on the card.

    python -m wavetpu_torch.kernels.tile_ab [--n 512] [--reps 30]

csrc/stencil.cu (K4) and csrc/kstep.cu (K3) instantiate their k-step
kernel twice per mode and k: with the tile depth tx fixed at compile time
(tx = kMaxTx = 8, what the main path launches) and with tx read at run
time (any other tx).  For each source this script builds it as it is (A)
and a copy whose dispatch always takes the run-time instantiation (B),
holds B's outputs bitwise against A's, and times both at N in the order
A, B, B, A - median of `reps` launches each, CUDA events: K4 with f32 v
and a bf16 carry at k=4 and k=1, K3 with an f32 state at k=4, error rows
on.  It prints the card's name and power limit and one JSON line of the
times.  Needs a CUDA device and nvcc.
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


def _build_variants(sources) -> dict:
    """{(source, 'A'): library of the source, (source, 'B'): its
    run-time-tx-only copy}, every nvcc started at once."""
    out = build.build_dir() / "tile_ab"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name in sources:
        src = (build.CSRC / f"{name}.cu").read_text()
        if src.count(_FIXED) != 1:
            raise RuntimeError(f"csrc/{name}.cu: tile dispatch not found")
        (out / f"{name}_runtime_tx.cu").write_text(
            src.replace(_FIXED, _RUNTIME))
        paths[name, "A"] = build.CSRC / f"{name}.cu"
        paths[name, "B"] = out / f"{name}_runtime_tx.cu"
    procs = {
        key: subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS,
                               "-I", str(build.CSRC), "-o",
                               str(out / f"{key[0]}_{key[1]}.so"), str(p)])
        for key, p in paths.items()
    }
    for key, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {key}")
    return {key: ctypes.CDLL(str(out / f"{key[0]}_{key[1]}.so"))
            for key in paths}


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
    libs = _build_variants(("stencil", "kstep"))
    print(f"built A and B of stencil.cu and kstep.cu in "
          f"{time.perf_counter() - t0:.1f} s")

    n = args.n
    p = Problem(N=n, timesteps=1000)
    g = torch.Generator().manual_seed(0)

    def field(scale, dtype=torch.float32):
        a = torch.randn((n, n, n), generator=g) * scale
        a[:, 0, :] = 0.0
        a[:, :, 0] = 0.0
        return a.to("cuda", dtype)

    u, v, c = field(1.0), field(1e-3), field(1e-8, torch.bfloat16)
    up = field(1.0)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cuda")

    def sxct(k):
        return ct[2:2 + k][:, None] * sx[None, :]

    def k4(k):
        s = sxct(k)
        return lambda: stencil_cuda.fused_kstep_comp(
            u, v, c, syz, rsyz, s, k=k, coeff=p.a2tau2, inv_h2=p.inv_h2)

    def k3(k):
        s = sxct(k)
        return lambda: stencil_cuda.fused_kstep(
            up, u, syz, rsyz, s, k=k, coeff=p.a2tau2, inv_h2=p.inv_h2)

    result = {}
    for label, source, fn in (("K4 k=4", "stencil", k4(4)),
                              ("K4 k=1", "stencil", k4(1)),
                              ("K3 k=4", "kstep", k3(4))):
        def use(variant):
            build._libs[source] = libs[source, variant]

        outs = {}
        for variant in ("A", "B"):
            use(variant)
            outs[variant] = fn()
        for i, (a, b) in enumerate(zip(outs["A"], outs["B"])):
            if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
                raise SystemExit(f"{label} output {i}: A and B differ")
        runs = []
        for variant in ("A", "B", "B", "A"):
            use(variant)
            runs.append([variant, _median_ms(fn, args.reps)])
        result[label] = runs
        print(f"{label} N={n}: A and B bitwise equal; median ms {runs}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "n": n, "ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
