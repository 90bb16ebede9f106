"""A/B timing of the k-step pipelines' tiles on the card.

    python -m wavetpu_torch.kernels.tile_ab [--n 512] [--reps 30]
                                            [--parts pipe,pipesplit,kpipe,kpipesplit,k6lanes,k6solo,overlap]
                                            [--ens-reps 5]

Part `pipe`: the x-streaming pipeline of K4, K11 and K12
(csrc/comp_sharded.cu).  First its split (`pipesplit` alone): K4 on the
whole (N, N, N) state and K4's lane mode on B=8 states of N/2, f32 u/v, a
bf16 carry, at k = 1, 2, 3, 4 with the error rows on and off, each at
`comp_pipe_block`'s shape (what a stage and the rows cost a launch); then
at k=4, rows on, every shape of PIPE_SHAPES (R face rows a thread and the
face), swept in order and back, each held bitwise against the plain
version.  The split runs on any checkout of the package (it calls the
public wrappers alone), so a parent's body can be timed beside this one.
Then K11 on the main path's mesh-4,1,1 block (N/4, N, N), k=4, rows on
(and K11f rows off): its segment length L and its y/z face at R = 1,
each against `comp_pipe_tile`'s; and the carry slab's depth block_x (8,
16, 32, 64: L and the slab cap) for K11 and for K4 on the whole state.

Part `kpipe`: the standard pipeline of K3 and K8-K10 (csrc/kstep_pipe.cu).
First its split (`kpipesplit` alone): K3 on the whole (N, N, N) f32
state at k = 1, 2, 3, 4 with the error rows on and off, each at
`kstep_pipe_block`'s shape (what a stage and the rows cost a launch; k=1
through `fused_kstep_sharded` on the state's wrap planes, which is K3's
launch, k=3 on the largest multiple of 3 below N); like
`pipesplit` it calls the public wrappers alone.  Then, k=4, f32, each
variant held bitwise against the plain version: K3 on the whole state
(rows on; K3f the field, rows off), K8 on a mesh-4,1,1 block (N/4, N, N;
K8f rows off), K9 on the pad-and-mask block of N-2 on one shard (N, N-2,
N-2; N-2 real planes; K9f rows off), K10 on the y-extended block of mesh
2,2,1 (N/2, N/2 + 2k, N; the y0 = N/2 shard; K10f rows off) and K3's
lane mode on B=8 states of N/2 (rows on; K3f lanes rows off): every shape
built for it (R = 1 at `kstep_pipe_tile`'s face, and each blocked (R,
block size) of `kstep_pipe_shapes` at its face of 32 columns), swept in
order and back; then the segment length L (32, 64 against the default)
at `kstep_pipe_block`'s shape, and at R = 1 the y/z faces of
`kstep_pipe_tile`'s alternatives, each A B B A against the default.

Part `k6lanes`: K6's lane mode (csrc/sharded.cu) at the sharded
ensemble's blocks, B=8 lanes on the mesh-2,2,1 block of N/2 and of N
(N/4 x N/4 x N/2 and N/2 x N/2 x N, x and y ghosts as (B, face) planes):
the x-streaming kernel's ty and segment against `k6_lane_tile`'s tile,
and the solo K6 (the streaming kernel at one lane) against the
one-thread-per-cell solo body (`k6_solo_old`); eight solo launches are
timed beside them.

Part `k6solo`: the solo K6 at constant speed on thin and thick blocks of
the mesh-2,2,1 shard of N (bx x by x N: the overlap mode's one-plane x
and y faces, then 4-32 planes or 4-8 rows, then the whole N/2 x N/2 x N
block): the one-thread-per-cell body (`k6_solo_old`) against the
x-streaming kernel on one lane, each timed twice: its device time alone
(`reps` launches in a CUDA graph, `_graph_ms`) and with the host's work,
launches enqueued back to back as a march enqueues them (`_batched_ms`;
a thin block's launch takes less device time than its Python wrapper's
host time).  The wrapper takes the streaming kernel where
`stencil_cuda.k6_solo_streams` says so.

Part `overlap`: the sharded march with `overlap=True` on mesh 2,2,1 at
N, 1000 steps, the four shards on the card (chip_smoke.py phase 7's
overlap_221), with the solo K6 on the one-thread-per-cell body on every
block (`body`), on the streaming kernel on every block (`streaming`,
the overlap mode's one-plane faces included) and as
`stencil_cuda.k6_solo_streams` chooses (`dispatch`), run body,
streaming, dispatch, dispatch, streaming, body, each run the median
solve seconds of `--ens-reps` solves; the three states are held
bitwise equal.

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
from wavetpu_torch.solver import kfused, sharded, sharded_kfused


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


def _batched_ms(fn, reps: int) -> float:
    """Device time (ms) of one call: CUDA events around `reps` calls
    enqueued back to back (the host's work per call hides behind the
    device's unless it is longer), the median of three such runs."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _graph_ms(fn, reps: int) -> float:
    """Device time (ms) of one call without the host's: `reps` calls
    captured in one CUDA graph, replayed three times (CUDA events around
    each replay), the median replay over `reps`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def _equal(label, got, want) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a.view(torch.uint8),
                                                  b.view(torch.uint8))):
            raise SystemExit(f"{label} output {i} differs")


def _abba(label, fn_a, fn_b, reps, result, timer=_median_ms) -> None:
    runs = [[name, timer(fn, reps)]
            for name, fn in (("A", fn_a), ("B", fn_b), ("B", fn_b),
                             ("A", fn_a))]
    a_ms = (runs[0][1] + runs[3][1]) / 2
    b_ms = (runs[1][1] + runs[2][1]) / 2
    result[label] = dict(runs=runs, a_ms=a_ms, b_ms=b_ms,
                         b_over_a=b_ms / a_ms)
    print(f"{label}: median ms {runs}; B/A {b_ms / a_ms:.4f}", flush=True)


# K4's shapes at k=4 (seg, ty, tz, r): the one-cell-a-thread face (1024
# threads), then R = 2 on 512 and 640 of the 640-thread block (32 and 40
# rows) and R = 3 on 512 (48 rows); the face 32 columns wide.
PIPE_SHAPES = [(32, 24, 24, 1), (32, 24, 24, 2), (32, 32, 24, 2),
               (32, 40, 24, 3)]


def _pipe_split(n, reps, result, lanes=8, shapes=True) -> None:
    """K4 on the whole (n, n, n) state and K4's lane mode on `lanes`
    states of n/2 (the flagship's storage): k = 1..4 with rows on and off
    at the default shape (k = 3 on the largest multiple of 3 below: its
    time and the time scaled to the full grid); with `shapes`, every
    PIPE_SHAPES shape at k=4, rows on, in order and back."""
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator().manual_seed(2)

    def rand(shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=g) * scale).to("cuda", dtype)

    for label, m, b in (("K4", n, None), ("K4 lanes", n // 2, lanes)):
        p = Problem(N=m, timesteps=1000)
        shape = (m,) * 3 if b is None else (b, m, m, m)
        u, v, c = rand(shape), rand(shape, 1e-3), rand(shape, 1e-8, bf16)
        where = f"{label} N={m}" + ("" if b is None else f" B={b}")

        def launch(k, rows, tile=None):
            """(kernel, plain version) at k on the state's leading m - m % k
            planes a side."""
            mk = m - m % k
            pk = p if mk == m else Problem(N=mk, timesteps=1000)
            sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(pk, f32, "cuda")
            cut = (slice(None),) * (b is not None) + (slice(0, mk),) * 3
            uk, vk, ck = (t[cut].contiguous() if mk < m else t
                          for t in (u, v, c))
            sxct = (ct[2:2 + k][:, None] * sx[None, :]).contiguous()
            kw = dict(k=k, coeff=pk.a2tau2, inv_h2=pk.inv_h2,
                      block_x=stencil_cuda.default_block_x(mk, k),
                      with_errors=rows)
            tkw = {} if tile is None else dict(tile=tile)
            if b is not None:
                sxct = sxct.expand(b, k, mk).contiguous()
                return (lambda: stencil_cuda.fused_kstep_comp_lanes(
                    uk, vk, ck, syz, rsyz, sxct, **kw, **tkw)), (
                    lambda: stencil_cuda.fused_kstep_comp_lanes_plain(
                        uk, vk, ck, syz, rsyz, sxct, **kw))
            plain = (lambda: stencil_cuda.fused_kstep_comp_plain(
                uk, vk, ck, syz, rsyz, sxct, **kw))
            if tile is None:
                return (lambda: stencil_cuda.fused_kstep_comp(
                    uk, vk, ck, syz, rsyz, sxct, **kw)), plain
            args = (uk, vk, ck, stencil_cuda.wrap_planes(uk, k),
                    stencil_cuda.wrap_planes(vk, k), syz, rsyz, sxct)
            return (lambda: stencil_cuda._comp_chain(
                "kstep_comp", *args, c2tau2_block=None, c2_ghosts=None,
                y0=0, nl_y=None, tile=tile, **kw)), plain

        for k in (1, 2, 3, 4):
            for rows in (True, False):
                key = f"{where} k={k} rows {'on' if rows else 'off'}"
                ms = _median_ms(launch(k, rows)[0], reps)
                result[key] = ms * (m / (m - m % k)) ** 3
                print(f"{key}: {ms:.4f} ms ({result[key]:.4f} ms at N={m})",
                      flush=True)
        if not shapes:
            continue
        fns = []
        for tile in PIPE_SHAPES:
            fn, plain = launch(4, True, tile)
            _equal(f"{where} shape={tile}", fn(), plain())
            fns.append(fn)
        times = [[] for _ in fns]
        for i in list(range(len(fns))) + list(range(len(fns)))[::-1]:
            times[i].append(_median_ms(fns[i], reps))
        for tile, t in zip(PIPE_SHAPES, times):
            key = f"{where} k=4 rows on shape={tile}"
            result[key] = dict(runs=t, ms=sum(t) / len(t))
            print(f"{key}: {t} ms", flush=True)
        del u, v, c
        torch.cuda.empty_cache()


def _pipe_part(n, reps, result) -> None:
    k = 4
    build.build_all()
    _pipe_split(n, reps, result)
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

    base = stencil_cuda.comp_pipe_tile(k, 64)  # R = 1
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


def _kpipe_split(n, reps, result) -> None:
    """Part `kpipesplit` (module docstring): K3 at k = 1..4, rows on and
    off, through the public wrappers."""
    g = torch.Generator().manual_seed(3)
    up = torch.randn((n,) * 3, generator=g).to("cuda")
    u = torch.randn((n,) * 3, generator=g).to("cuda")
    for k in (1, 2, 3, 4):
        m = n - n % k
        p = Problem(N=m, timesteps=1000)
        sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32,
                                                       "cuda")
        sxct = (ct[2:2 + k][:, None] * sx[None, :]).contiguous()
        upk, uk = ((t[:m, :m, :m].contiguous() if m < n else t)
                   for t in (up, u))
        for rows in (True, False):
            kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
                      with_errors=rows)
            if k > 1:
                def fn(kw=kw):
                    return stencil_cuda.fused_kstep(upk, uk, syz, rsyz, sxct,
                                                    **kw)
            else:  # K3's launch: K8 over the state's own wrap planes
                def fn(kw=kw):
                    return stencil_cuda.fused_kstep_sharded(
                        upk, uk, stencil_cuda.wrap_planes(upk, k),
                        stencil_cuda.wrap_planes(uk, k), syz, rsyz, sxct,
                        **kw)
            key = f"K3 N={m} k={k} rows {'on' if rows else 'off'}"
            ms = _median_ms(fn, reps)
            result[key] = ms * (n / m) ** 3
            print(f"{key}: {ms:.4f} ms ({result[key]:.4f} ms at N={n})",
                  flush=True)
        del upk, uk
    del up, u
    torch.cuda.empty_cache()


def _kpipe_cases(n):
    """{name: (launch(tile), plain(), depth, kstep_pipe_block's keys)} of
    part `kpipe` (module docstring), k=4, f32, made on the card."""
    k = 4
    p = Problem(N=n, timesteps=1000)
    g = torch.Generator().manual_seed(2)

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to("cuda")

    def c2(shape):
        return p.a2tau2 * (0.5 + torch.rand(shape, generator=g)).to("cuda")

    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cuda")
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2)
    cases = {}

    def chain(name, counter, args, kwa, plain, keys):
        def launch(tile=None):
            return stencil_cuda._kstep_pipe(counter, *args, tile=tile, **kwa)
        cases[name] = (launch, plain, args[1].shape[0], keys)

    # K3 and K3f: the whole state, its windows the wrap planes.
    up, u, fld = rand((n, n, n)), rand((n, n, n)), c2((n, n, n))
    sxct = (ct[2:2 + k][:, None] * sx[None, :]).contiguous()
    for name, field in (("K3", False), ("K3f", True)):
        kwf = dict(kw, c2tau2_block=fld if field else None,
                   c2_ghosts=stencil_cuda.wrap_planes(fld, k) if field
                   else None, with_errors=not field)
        chain(name, "kstep", (up, u, stencil_cuda.wrap_planes(up, k),
                              stencil_cuda.wrap_planes(u, k), syz, rsyz,
                              sxct), kwf,
              lambda field=field: stencil_cuda.fused_kstep_plain(
                  up, u, syz, rsyz, sxct, **kw,
                  c2tau2_field=fld if field else None,
                  with_errors=not field),
              dict(field=field))
    # K8 and K8f: a mesh-4,1,1 block and synthetic ghost windows.
    d = n // 4
    bp, bu = rand((d, n, n)), rand((d, n, n))
    wins = ((rand((k, n, n)), rand((k, n, n))),
            (rand((k, n, n)), rand((k, n, n))))
    bf, fg = c2((d, n, n)), (c2((k, n, n)), c2((k, n, n)))
    sxd = (ct[2:2 + k][:, None] * sx[None, :d]).contiguous()
    args8 = (bp, bu, *wins, syz, rsyz, sxd)
    for name, field in (("K8", False), ("K8f", True)):
        kw8 = dict(kw, c2tau2_block=bf if field else None,
                   c2_ghosts=fg if field else None, with_errors=not field)
        chain(name, "kstep_sharded", args8, kw8,
              lambda kw8=kw8: stencil_cuda.fused_kstep_sharded_plain(
                  *args8, **kw8), dict(field=field))
    # K9 and K9f: N-2 planes do not divide into k=4 blocks on one shard,
    # so the solver pads them to the layout's depth (N, N-2, N-2 at N=512).
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
    f9, fg9 = c2((d9, m, m)), (c2((k, m, m)), c2((k, m, m)))
    kw9 = dict(k=k, coeff=p9.a2tau2, inv_h2=p9.inv_h2)
    for name, field in (("K9", False), ("K9f", True)):
        kwf = dict(kw9, c2tau2_block=f9 if field else None,
                   c2_ghosts=fg9 if field else None, with_errors=not field)
        chain(name, "kstep_padded", a9, dict(kwf, n_real=r9),
              lambda kwf=kwf: stencil_cuda.fused_kstep_padded_plain(
                  a9[0], a9[1], r9, *a9[2:], **kwf),
              dict(field=field, pad=True))
    # K10 and K10f: the y = N/2 shard of mesh 2,2,1, extended by k rows a
    # side.
    dx, ny, y0 = n // 2, n // 2, n // 2
    py = ny + 2 * k
    a10 = (rand((dx, py, n)), rand((dx, py, n)),
           (rand((k, py, n)), rand((k, py, n))),
           (rand((k, py, n)), rand((k, py, n))),
           syz[y0:y0 + ny].contiguous(), rsyz[y0:y0 + ny].contiguous(),
           (ct[2:2 + k][:, None] * sx[None, :dx]).contiguous())
    f10, fg10 = c2((dx, py, n)), (c2((k, py, n)), c2((k, py, n)))
    for name, field in (("K10", False), ("K10f", True)):
        kwf = dict(kw, c2tau2_block=f10 if field else None,
                   c2_ghosts=fg10 if field else None, with_errors=not field)
        chain(name, "kstep_sharded_xy", a10, dict(kwf, y0=y0, nl_y=ny),
              lambda kwf=kwf: stencil_cuda.fused_kstep_sharded_xy_plain(
                  *a10, y0, n, nl_y=ny, c2tau2_ext=kwf["c2tau2_block"],
                  **{x: v for x, v in kwf.items() if x != "c2tau2_block"}),
              dict(field=field, ext=True))
    # K3 lanes and K3f lanes: B=8 states of N/2.
    h, b = n // 2, 8
    ph = Problem(N=h, timesteps=1000)
    sxh, cth, syzh, rsyzh, _, _ = kfused._oracle_parts(ph, torch.float32,
                                                       "cuda")
    lu, lp = rand((b, h, h, h)), rand((b, h, h, h))
    lf = ph.a2tau2 * (0.5 + torch.rand((b, h, h, h), generator=g)).to("cuda")
    lsx = (cth[2:2 + k][:, None] * sxh[None, :]).expand(b, k, h).contiguous()
    kwl = dict(k=k, coeff=ph.a2tau2, inv_h2=ph.inv_h2)
    for name, field in (("K3 lanes", False), ("K3f lanes", True)):
        kwf = dict(kwl, c2tau2_field=lf if field else None,
                   with_errors=not field)

        def launch(tile=None, kwf=kwf):
            return stencil_cuda.fused_kstep_lanes(lp, lu, syzh, rsyzh, lsx,
                                                  tile=tile, **kwf)
        cases[name] = (launch,
                       lambda kwf=kwf: stencil_cuda.fused_kstep_lanes_plain(
                           lp, lu, syzh, rsyzh, lsx, **kwf),
                       h, dict(field=field, lanes=True))
    return cases


def _kpipe_part(n, reps, result) -> None:
    k = 4
    build.build_all(names=["kstep_pipe"])
    _kpipe_split(n, reps, result)
    for name, (launch, plain, d, keys) in _kpipe_cases(n).items():
        want = plain()

        def checked(tile):
            _equal(f"{name} tile={tile}", launch(tile), want)
            return lambda: launch(tile)

        seg, ty, tz = stencil_cuda.kstep_pipe_tile(k, d)
        shapes = [(seg, ty, tz, 1)] + [
            (seg, nt // 32 * r - 2 * k, 32 - 2 * k, r, nt)
            for r, nt in stencil_cuda.kstep_pipe_shapes(
                k, torch.float32, keys.get("field", False),
                keys.get("pad", False), keys.get("lanes", False))[1:]]
        fns = [checked(tile) for tile in shapes]
        times = [[] for _ in fns]
        for i in list(range(len(fns))) + list(range(len(fns)))[::-1]:
            times[i].append(_median_ms(fns[i], reps))
        for tile, t in zip(shapes, times):
            key = f"{name} k=4 shape={tile}"
            result[key] = dict(runs=t, ms=sum(t) / len(t))
            print(f"{key}: {t} ms", flush=True)
        block = stencil_cuda.kstep_pipe_block(k, d, torch.float32, **keys)
        ref = checked(None)
        for s in (32, 64):
            if s < block[0]:
                _abba(f"{name} L={s} vs {block}", ref,
                      checked((s,) + block[1:]), reps, result)
        if name in ("K3", "K8", "K9", "K10"):
            ref1 = checked((seg, ty, tz))
            for face in ((16, 24), (8, 24), (24, 8), (4, 56), (12, 12)):
                _abba(f"{name} R=1 face={face} vs face={(ty, tz)}", ref1,
                      checked((seg,) + face), reps, result)
        del want
        torch.cuda.empty_cache()


def k6_solo_old(u_prev, u, ghosts, offsets, n_global, *, inv_h2,
                mesh_shape, r_last=None, alpha=2.0, beta=1.0, coeff=None):
    """The solo K6 body at constant speed (one thread per cell), which
    `sharded_fused_step` keeps for thin blocks and replaced by the
    x-streaming kernel at one lane on the others: the A/B's old side.
    Counts no launch."""
    sc = stencil_cuda
    sc._check_block_state(u, tuple(sc._CODE), "K6", u_prev=u_prev)
    need, pads = sc._need_pads(u.shape, mesh_shape, r_last)
    out = torch.empty_like(u)
    sc._run(sc._load("sharded").wt_sharded_step, u_prev.data_ptr(),
            u.data_ptr(), out.data_ptr(), None,
            *sc._ghost_ptrs(u, ghosts, need),
            *sc._block_geometry(u, offsets, n_global, pads),
            sc._CODE[u.dtype], float(alpha), float(beta), float(coeff),
            *(float(h) for h in inv_h2), int(beta != 0),
            inst=("sharded_step_old", u.dtype, beta != 0))
    return out


def k6_lanes_case(n, lanes=8, seed=5):
    """K6's lane operands on the mesh-2,2,1 block of n (the block at
    x offset n/2): (args, kwargs) of `sharded_fused_step_lanes`, x and y
    ghosts as (lanes, face) planes, made on the card from `seed`."""
    p = Problem(N=n, timesteps=1000)
    h = n // 2
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape):
        return torch.randn(shape, generator=g, device="cuda")

    ghosts = []
    for axis in range(3):
        face = [lanes, h, h, n]
        face[axis + 1] = 1
        ghosts.append((rand(face), rand(face)))
    args = (rand((lanes, h, h, n)), rand((lanes, h, h, n)), ghosts,
            (h, 0, 0), n)
    return args, dict(inv_h2=p.inv_h2, mesh_shape=(2, 2, 1),
                      coeff=p.a2tau2)


def k6_lanes_ab(n, reps, result, lanes=8, variants=True) -> None:
    """Part `k6lanes` at the mesh-2,2,1 block of n (module docstring)."""
    build.build_all(names=["sharded"])
    sc = stencil_cuda
    args, kw = k6_lanes_case(n, lanes)
    plain = sc.sharded_fused_step_lanes_plain(*args, **kw)
    up, u, ghosts, off, ng = args

    def checked(label, fn, want=plain):
        _equal(label, [fn()], [want])
        return fn

    def new(tile=None):
        return checked(f"K6 lanes N={n} tile={tile}",
                       lambda: sc.sharded_fused_step_lanes(*args, tile=tile,
                                                           **kw))

    ref = new()
    solo_g = [[tuple(x[i] for x in a) for a in ghosts] for i in range(lanes)]
    result[f"K6 lanes N={n} B={lanes}: 8 solo launches ms"] = _median_ms(
        lambda: [sc.sharded_fused_step(up[i], u[i], solo_g[i], off, ng, **kw)
                 for i in range(lanes)], reps)
    print(f"K6 lanes N={n}: {lanes} solo launches "
          f"{result[f'K6 lanes N={n} B={lanes}: 8 solo launches ms']:.4f} "
          f"ms", flush=True)
    if not variants:
        return
    block = tuple(u.shape[1:])
    tile = sc.k6_lane_tile(block, lanes)
    for t in (4, 6):
        _abba(f"K6 lanes N={n} ty={t} vs {tile}", ref,
              new((tile[0], t, tile[2])), reps, result)
    for s in (8, 32, 64, block[0]):
        if s != tile[0]:
            _abba(f"K6 lanes N={n} seg={s} vs {tile}", ref,
                  new((s,) + tile[1:]), reps, result)
    # One lane: the solo wrapper (the streaming kernel) against the old
    # solo body.
    want = plain[:1]
    old1 = checked(f"K6 old solo body N={n}", lambda: k6_solo_old(
        up[0], u[0], solo_g[0], off, ng, **kw)[None], want)
    new1 = checked(f"K6 N={n}", lambda: sc.sharded_fused_step(
        up[0], u[0], solo_g[0], off, ng, **kw)[None], want)
    _abba(f"K6 N={n}: streaming (one lane) vs old solo body", old1, new1,
          reps, result)


def _k6solo_part(n, reps, result) -> None:
    """Part `k6solo` (module docstring)."""
    build.build_all(names=["sharded"])
    sc = stencil_cuda
    h = n // 2
    p = Problem(N=n, timesteps=1000)
    kw = dict(inv_h2=p.inv_h2, mesh_shape=(2, 2, 1), coeff=p.a2tau2)
    g = torch.Generator(device="cuda").manual_seed(7)

    def rand(shape):
        return torch.randn(shape, generator=g, device="cuda")

    for block in ((1, h, n), (h, 1, n), (4, h, n), (8, h, n), (16, h, n),
                  (32, h, n), (64, h, n), (h, 4, n), (h, 8, n), (h, 16, n),
                  (h, 32, n), (h, h, n)):
        up, u = rand((1,) + block), rand((1,) + block)
        ghosts = []
        for axis in range(3):
            face = [1, *block]
            face[axis + 1] = 1
            ghosts.append((rand(face), rand(face)))
        args = (up, u, ghosts, (h, 0, 0), n)
        solo = (up[0], u[0], [tuple(x[0] for x in a) for a in ghosts],
                (h, 0, 0), n)
        want = sc.sharded_fused_step_lanes_plain(*args, **kw)
        old = lambda: k6_solo_old(*solo, **kw)[None]  # noqa: E731
        stream = lambda: sc.sharded_fused_step_lanes(*args, **kw)  # noqa
        _equal(f"K6 old solo body {block}", [old()], [want])
        _equal(f"K6 streaming one lane {block}", [stream()], [want])
        label = (f"K6 solo {block} (streams: {sc.k6_solo_streams(block)}): "
                 f"streaming vs old body")
        _abba(f"{label}, device", old, stream, reps, result,
              timer=_graph_ms)
        _abba(f"{label}, back to back", old, stream, reps, result,
              timer=_batched_ms)
        del up, u, ghosts, args, solo, want


def _overlap_part(n, reps, result) -> None:
    """Part `overlap` (module docstring)."""
    build.build_all(names=["sharded"])
    sc = stencil_cuda
    p = Problem(N=n, timesteps=1000)
    rule = sc.k6_solo_streams
    variants = {"body": lambda block: False,
                "streaming": lambda block: True, "dispatch": rule}

    def solve(name):
        sc.k6_solo_streams = variants[name]
        try:
            res = sharded.solve_sharded(p, (2, 2, 1), devices=["cuda"] * 4,
                                        overlap=True)
            torch.cuda.synchronize()
        finally:
            sc.k6_solo_streams = rule
        return res

    ref = solve("dispatch")
    for name in ("body", "streaming"):
        got = solve(name)
        if not all(torch.equal(a, b) for a, b in zip(got.u_cur.blocks,
                                                     ref.u_cur.blocks)):
            raise SystemExit(f"overlap_221: the {name} march differs")
    del ref, got
    runs = [[name, statistics.median(solve(name).solve_seconds
                                     for _ in range(reps))]
            for name in ("body", "streaming", "dispatch", "dispatch",
                         "streaming", "body")]
    mean = {name: statistics.mean(r for v, r in runs if v == name)
            for name in variants}
    result["overlap_221 solve s"] = dict(runs=runs, **mean)
    print(f"overlap_221 solve s (median of {reps}): {runs}; means {mean}",
          flush=True)


def _k6lanes_part(n, reps, result) -> None:
    for m in (n // 2, n):
        k6_lanes_ab(m, reps, result)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--parts", default="pipe,kpipe")
    ap.add_argument("--ens-reps", type=int, default=5,
                    help="solves a run in part overlap")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_ab needs a CUDA device")
    result = {}
    parts = args.parts.split(",")
    if "pipe" in parts:
        _pipe_part(args.n, args.reps, result)
    elif "pipesplit" in parts:
        build.build_all(names=["comp_sharded"])
        _pipe_split(args.n, args.reps, result)
    if "kpipe" in parts:
        _kpipe_part(args.n, args.reps, result)
    elif "kpipesplit" in parts:
        build.build_all(names=["kstep_pipe"])
        _kpipe_split(args.n, args.reps, result)
    if "k6lanes" in parts:
        _k6lanes_part(args.n, args.reps, result)
    if "k6solo" in parts:
        _k6solo_part(args.n, args.reps, result)
    if "overlap" in parts:
        _overlap_part(args.n, args.ens_reps, result)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "n": args.n, "ms": result}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
