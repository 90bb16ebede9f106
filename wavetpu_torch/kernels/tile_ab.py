"""A/B timing of the k-step kernels' tiles on the card.

    python -m wavetpu_torch.kernels.tile_ab [--n 512] [--reps 30]
                                            [--parts tx,pipe]

Part `tx`: csrc/kstep.cu (K3) instantiates its k-step kernel twice per
k: with the tile depth tx fixed at compile time (tx = kMaxTx = 8, what the
main path launches) and with tx read at run time (any other tx).  This
script builds the source as it is (A) and a copy whose dispatch always
takes the run-time instantiation (B), holds B's outputs bitwise against
A's, and times both at N in the order A, B, B, A: K3 with an f32 state at
k=4, error rows on.

Part `pipe`: the x-streaming pipeline of K4, K11 and K12
(csrc/comp_sharded.cu) as K11 on the main path's mesh-4,1,1 block (N/4,
N, N), k=4, f32 u/v, a bf16 carry, rows on (and K11f rows off): its
segment length L and its y/z face, each against the default tile
(`comp_pipe_tile`) in the order default, other, other, default; and the
carry slab's depth block_x (8, 16, 32, 64: L and the slab cap) for K11
and for K4 on the whole (N, N, N) state.  Every variant's outputs are
held bitwise against the plain version's.

Times: median of `reps` launches each, CUDA events.  It prints the card's
name and power limit and one JSON line of the times.  Needs a CUDA device
and nvcc.
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


def _equal(label, got, want) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a.view(torch.uint8),
                                                  b.view(torch.uint8))):
            raise SystemExit(f"{label} output {i} differs")


def _abba(label, fn_a, fn_b, reps, result) -> None:
    runs = [[name, _median_ms(fn, reps)]
            for name, fn in (("A", fn_a), ("B", fn_b), ("B", fn_b),
                             ("A", fn_a))]
    result[label] = runs
    print(f"{label}: median ms {runs}", flush=True)


def _tx_part(n, reps, result) -> None:
    t0 = time.perf_counter()
    libs = _build_variants(("kstep",))
    print(f"built A and B of kstep.cu in "
          f"{time.perf_counter() - t0:.1f} s")
    p = Problem(N=n, timesteps=1000)
    g = torch.Generator().manual_seed(0)

    def field(scale, dtype=torch.float32):
        a = torch.randn((n, n, n), generator=g) * scale
        a[:, 0, :] = 0.0
        a[:, :, 0] = 0.0
        return a.to("cuda", dtype)

    u, up = field(1.0), field(1.0)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cuda")

    k = 4
    sxct = ct[2:2 + k][:, None] * sx[None, :]

    def fn():
        return stencil_cuda.fused_kstep(up, u, syz, rsyz, sxct, k=k,
                                        coeff=p.a2tau2, inv_h2=p.inv_h2)

    def use(variant):
        build._libs["kstep"] = libs["kstep", variant]

    outs = {}
    for variant in ("A", "B"):
        use(variant)
        outs[variant] = fn()
    label = f"K3 k={k}"
    _equal(f"{label} A vs B", outs["A"], outs["B"])
    runs = []
    for variant in ("A", "B", "B", "A"):
        use(variant)
        runs.append([variant, _median_ms(fn, reps)])
    use("A")
    result[label] = runs
    print(f"{label} N={n}: A and B bitwise equal; median ms {runs}")


def _pipe_part(n, reps, result) -> None:
    k = 4
    build.build_all()
    p = Problem(N=n, timesteps=1000)
    d = n // 4
    g = torch.Generator().manual_seed(1)

    def rand(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)

    def c2(shape):
        return p.a2tau2 * (0.5 + torch.rand(shape, generator=g)).to("cuda")

    u, v, c = rand((d, n, n)), rand((d, n, n), 1e-3), rand(
        (d, n, n), 1e-8, torch.bfloat16)
    gu = (rand((k, n, n)), rand((k, n, n)))
    gv = (rand((k, n, n), 1e-3), rand((k, n, n), 1e-3))
    fld, fg = c2((d, n, n)), (c2((k, n, n)), c2((k, n, n)))
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cuda")
    sxct = (ct[2:2 + k][:, None] * sx[None, :d]).contiguous()
    plains = {}

    def k11(bx, tile=None, field=False):
        """K11 (rows on) or K11f (rows off) at block_x bx, its outputs held
        against the plain version's; returns the launch."""
        kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, block_x=bx,
                  c2tau2_block=fld if field else None,
                  c2_ghosts=fg if field else None, with_errors=not field,
                  y0=0, nl_y=None)
        args = (u, v, c, gu, gv, syz, rsyz, sxct)
        if (bx, field) not in plains:
            plains[bx, field] = stencil_cuda._comp_chain_plain(*args, **kw)

        def fn():
            return stencil_cuda._comp_chain("kstep_comp_sharded", *args,
                                            tile=tile, **kw)
        _equal(f"K11 bx={bx} tile={tile} field={field}", fn(),
               plains[bx, field])
        return fn

    base = stencil_cuda.comp_pipe_tile(k, 64)
    _, ty, tz = base
    for field in (False, True):
        name = "K11f" if field else "K11"
        ref = k11(64, field=field)
        for seg in (8, 16, 64):
            _abba(f"{name} L={seg} vs L={base[0]}", ref,
                  k11(64, (seg, ty, tz), field), reps, result)
    ref = k11(64)
    for face in ((16, 24), (8, 24), (24, 8), (4, 56), (12, 12)):
        _abba(f"K11 face={face} vs face={(ty, tz)}", ref,
              k11(64, (base[0],) + face), reps, result)
    ref_f = k11(64, field=True)
    for bx in (8, 16, 32):
        _abba(f"K11 block_x={bx} vs block_x=64", ref, k11(bx), reps, result)
        _abba(f"K11f block_x={bx} vs block_x=64", ref_f,
              k11(bx, field=True), reps, result)
    # K4: the pipeline on the whole state, its windows the wrap planes.
    uw, vw, cw = rand((n, n, n)), rand((n, n, n), 1e-3), rand(
        (n, n, n), 1e-8, torch.bfloat16)
    sxw = (ct[2:2 + k][:, None] * sx[None, :]).contiguous()

    def k4(bx):
        kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, block_x=bx)
        args = (uw, vw, cw, syz, rsyz, sxw)

        def fn():
            return stencil_cuda.fused_kstep_comp(*args, **kw)
        _equal(f"K4 bx={bx}", fn(),
               stencil_cuda.fused_kstep_comp_plain(*args, **kw))
        return fn
    ref4 = k4(32)
    for bx in (8, 16, 64):
        _abba(f"K4 block_x={bx} vs block_x=32", ref4, k4(bx), reps, result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--parts", default="tx,pipe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_ab needs a CUDA device")
    result = {}
    parts = args.parts.split(",")
    if "tx" in parts:
        _tx_part(args.n, args.reps, result)
    if "pipe" in parts:
        _pipe_part(args.n, args.reps, result)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "n": args.n, "ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
