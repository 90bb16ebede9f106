"""A/B timing of the k-step pipelines' tiles on the card.

    python -m wavetpu_torch.kernels.tile_ab [--n 512] [--reps 30]
                                            [--parts pipe,kpipe]

Part `pipe`: the x-streaming pipeline of K4, K11 and K12
(csrc/comp_sharded.cu) as K11 on the main path's mesh-4,1,1 block (N/4,
N, N), k=4, f32 u/v, a bf16 carry, rows on (and K11f rows off): its
segment length L and its y/z face, each against the default tile
(`comp_pipe_tile`); and the carry slab's depth block_x (8, 16, 32, 64: L
and the slab cap) for K11 and for K4 on the whole (N, N, N) state.

Part `kpipe`: the standard pipeline of K3 and K8-K10 (csrc/kstep_pipe.cu)
as K3 on the whole (N, N, N) state, K8 on a mesh-4,1,1 block (N/4, N, N),
K9 on the pad-and-mask block of N-2 on one shard (N, N-2, N-2; N-2 real
planes) and K10 on the y-extended block of mesh 2,2,1 (N/2, N/2 + 2k, N;
the y0 = N/2 shard), k=4, f32, rows on (K8f: the field, rows off): its
segment length L (8, 16, 32, 64 against the default 128) and its y/z
face, each against the default tile (`kstep_pipe_tile`).

Each comparison runs default, other, other, default; each run is the
median of `reps` launches (CUDA events), and the printed ratio is the
mean of the two `other` runs over the mean of the two default runs.
Every variant's outputs are held bitwise against the plain version's.
It prints the card's name and power limit and one JSON line of the
times.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import build, stencil_cuda
from wavetpu_torch.solver import kfused, sharded_kfused


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
    a_ms = (runs[0][1] + runs[3][1]) / 2
    b_ms = (runs[1][1] + runs[2][1]) / 2
    result[label] = dict(runs=runs, a_ms=a_ms, b_ms=b_ms,
                         b_over_a=b_ms / a_ms)
    print(f"{label}: median ms {runs}; B/A {b_ms / a_ms:.4f}", flush=True)


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


def _kpipe_part(n, reps, result) -> None:
    k = 4
    build.build_all()
    p = Problem(N=n, timesteps=1000)
    g = torch.Generator().manual_seed(2)

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to("cuda")

    def c2(shape):
        return p.a2tau2 * (0.5 + torch.rand(shape, generator=g)).to("cuda")

    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cuda")
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2)
    cases = {}
    # K3: the whole state, its windows the wrap planes.
    up, u = rand((n, n, n)), rand((n, n, n))
    sxct = (ct[2:2 + k][:, None] * sx[None, :]).contiguous()
    args = (up, u, stencil_cuda.wrap_planes(up, k),
            stencil_cuda.wrap_planes(u, k), syz, rsyz, sxct)
    cases["K3"] = ("kstep", args, dict(kw, c2tau2_block=None,
                                       c2_ghosts=None, with_errors=True),
                   lambda: stencil_cuda.fused_kstep_plain(
                       up, u, syz, rsyz, sxct, **kw))
    # K8 and K8f: a mesh-4,1,1 block and synthetic ghost windows.
    d = n // 4
    bp, bu = rand((d, n, n)), rand((d, n, n))
    wins = ((rand((k, n, n)), rand((k, n, n))),
            (rand((k, n, n)), rand((k, n, n))))
    fld, fg = c2((d, n, n)), (c2((k, n, n)), c2((k, n, n)))
    sxd = (ct[2:2 + k][:, None] * sx[None, :d]).contiguous()
    args8 = (bp, bu, *wins, syz, rsyz, sxd)
    for name, field in (("K8", False), ("K8f", True)):
        kw8 = dict(kw, c2tau2_block=fld if field else None,
                   c2_ghosts=fg if field else None, with_errors=not field)
        cases[name] = ("kstep_sharded", args8, kw8,
                       lambda kw8=kw8: stencil_cuda.fused_kstep_sharded_plain(
                           *args8, **kw8))

    # K9: N-2 planes do not divide into k=4 blocks on one shard, so the
    # solver pads them to the layout's depth (N, N-2, N-2 at N=512).
    p9 = Problem(N=n - 2, timesteps=1000)
    _, d9, r9 = sharded_kfused.uneven_layout(p9, k, 1)
    sx9, ct9, syz9, rsyz9, _, _ = kfused._oracle_parts(p9, torch.float32,
                                                       "cuda")
    sxct9 = torch.zeros((k, d9), device="cuda")
    sxct9[:, :r9] = ct9[2:2 + k][:, None] * sx9[None, :]
    m = n - 2
    a9 = (rand((d9, m, m)), rand((d9, m, m)),
          (rand((k, m, m)), rand((k, m, m))),
          (rand((k, m, m)), rand((k, m, m))), syz9, rsyz9, sxct9)
    kw9 = dict(k=k, coeff=p9.a2tau2, inv_h2=p9.inv_h2)
    cases["K9"] = ("kstep_padded", a9,
                   dict(kw9, c2tau2_block=None, c2_ghosts=None,
                        with_errors=True, n_real=r9),
                   lambda: stencil_cuda.fused_kstep_padded_plain(
                       a9[0], a9[1], r9, *a9[2:], **kw9))
    # K10: the y = N/2 shard of mesh 2,2,1, extended by k rows per side.
    dx, ny, y0 = n // 2, n // 2, n // 2
    py = ny + 2 * k
    a10 = (rand((dx, py, n)), rand((dx, py, n)),
           (rand((k, py, n)), rand((k, py, n))),
           (rand((k, py, n)), rand((k, py, n))),
           syz[y0:y0 + ny].contiguous(), rsyz[y0:y0 + ny].contiguous(),
           (ct[2:2 + k][:, None] * sx[None, :dx]).contiguous())
    cases["K10"] = ("kstep_sharded_xy", a10,
                    dict(kw, c2tau2_block=None, c2_ghosts=None,
                         with_errors=True, y0=y0, nl_y=ny),
                    lambda: stencil_cuda.fused_kstep_sharded_xy_plain(
                        *a10, y0, n, nl_y=ny, **kw))

    def launch(name, tile=None):
        counter, a, kwa, plain = cases[name]

        def fn():
            return stencil_cuda._kstep_pipe(counter, *a, tile=tile, **kwa)
        _equal(f"{name} tile={tile}", fn(), plain())
        return fn

    for name in cases:
        d_ = cases[name][1][1].shape[0]
        base = stencil_cuda.kstep_pipe_tile(k, d_)
        _, ty, tz = base
        ref = launch(name)
        for seg in (8, 16, 32, 64, 128):
            if seg != base[0] and d_ % seg == 0:
                _abba(f"{name} L={seg} vs L={base[0]}", ref,
                      launch(name, (seg, ty, tz)), reps, result)
        for face in ((16, 24), (8, 24), (24, 8), (4, 56), (12, 12)):
            _abba(f"{name} face={face} vs face={(ty, tz)}", ref,
                  launch(name, (base[0],) + face), reps, result)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--parts", default="pipe,kpipe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_ab needs a CUDA device")
    result = {}
    parts = args.parts.split(",")
    if "pipe" in parts:
        _pipe_part(args.n, args.reps, result)
    if "kpipe" in parts:
        _kpipe_part(args.n, args.reps, result)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "n": args.n, "ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
