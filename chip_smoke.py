"""Chip smoke test of the PyTorch/CUDA port (wavetpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result line,
without them or when any phase fails.  Phases:

 1. build    - nvcc builds every kernel source of wavetpu_torch/kernels/csrc
               (one process per source, in parallel; ptxas register /
               shared-memory report in build.log under OUT_DIR; the
               k-step kernels' registers are printed).
 2. kernels  - each CUDA kernel against its plain PyTorch version on the
               same inputs on the card: at N=128 in every mode - K1, K2,
               K5, K3 and K3f (k = 2, 4, 8; f32 and bf16; rows on and
               off; K3 runs K8's pipeline over the whole state), K4 and
               K4f (all three storage modes, k = 4 and 1, K4f rows on and
               off, and its k=1 bootstrap form; K4 runs K11's pipeline
               over the whole state), K6/K6f
               (no ghosts, x+y, x+y+z and an uneven padded block; f32, bf16,
               f64), K7 (f32, f64), K8/K8f and K9/K9f (k = 1, 2, 4, 8; f32
               and bf16; rows on and off; K9 with pad planes; and the
               standard pipeline's stress cases: K8 blocks as deep as k
               = 1, 4, 8, of one 96-plane and of two 128-plane x
               segments, K3 at N = 200, whose y and z extents are no
               multiple of the y/z face and whose segments are 100
               planes, K9 with its real planes ending inside a segment,
               on a segment boundary and below k, and on a depth of two
               overlapping segments), K10/K10f
               (k = 1, 2, 4, 8; f32 and bf16; rows and field on and off;
               the first and the last y shard, nl_y = k), K11/K11f and
               K12/K12f (k = 1, 2, 4, 8; K4's four storage modes; rows and
               field on and off; K12 on both y edges and nl_y = k; and the
               pipeline's stress cases: the deepest slab, bx = 64 = D,
               and the shallowest, bx = k, two slabs of two x segments,
               k = 1, 3 and 8 at bx = D, nl_y = k at k = 4 and 8, and
               N = 200 on mesh 2,2,1, whose y and z extents are no
               multiple of the y/z face) - and
               at the shapes the main-path runs launch: K1, K2, K5, K3
               (k=4, rows on), K3f (k=4, rows on and off), K4 (f32 v + bf16
               carry, k=4 and 1, rows on), K4f (the same, rows on and off,
               and the bootstrap: k=1, half the field, zero v and carry,
               zero oracle planes, rows off), K6/K6f/K7 on the mesh-2,2,1,
               1,1,1 and uneven 4,1,1 blocks, K8/K9 (k=4 rows on, k=1 rows
               on and off) and K8f/K9f (k=4 and 1, rows off) on the 4,1,1
               and N=510 blocks, K10-K12 on the mesh-2,2,1 (extended) and
               4,1,1 blocks (k=4 rows on, k=1 rows on and off, the lens
               forms rows off, the flagship's k=1 bootstrap on zero v and
               carry with C/2 or half the field); the error pass
               (csrc/errors.cu) on the interior view of a layer near the
               closed form at N=128 (f32, bf16, f64) and N=512 (f32),
               against `oracle.separable_layer_errors`.  Held bitwise, every
               output (the Kahan carry and the error rows included):
               --fmad=false makes the kernel round every multiply and add
               separately, as the plain version does, in the same order.
 3. main-path runs at 1000 steps, f32, each with the launch counters set
    to 0 just before and read just after (every counter must equal the
    expected count, the others 0).  Through the port's CLI at N=512:
      default        `512 1 1 1 1 1 1000`: K1 x1000 and the error pass
                     (csrc/errors.cu) x1000; max abs error < 5e-3
                     (f32 rounding-accumulation class).
      flagship       `... --scheme compensated --fuse-steps 4`: K2 x1, K4
                     x252 (249 at k=4, 3 at k=1); max abs error < 2e-5
                     (f32 discretization class, ~6e-6 here).
      kfused         `... --fuse-steps 4`: K3 x249, K1 x4 (bootstrap + 3
                     tail layers), the error pass x4 (the same layers);
                     max abs error < 5e-3 and within 1e-6 of
                     the default run's (the same states; the in-kernel rows
                     multiply the oracle in another order).
      varc           `... --c2-field gaussian-lens`: K5 x1000, errors off,
                     the sidecar names the field.
      kfused_varc    `... --fuse-steps 4 --c2-field gaussian-lens`: K3f
                     x249, K5 x4.
      flagship_varc  `... --scheme compensated --fuse-steps 4 --c2-field
                     gaussian-lens`: K4f x253 (1 bootstrap at k=1, 249 at
                     k=4, 3 at k=1), K2 x0.
      uneven_kfused  `510 ... --fuse-steps 4` (4 does not divide 510: the
                     pad-and-mask march on one shard): K9 x253.
      sharded        `... --mesh 1,1,1`: K6 x1000 and the error pass x1000,
                     the default run's error.
      flagship_mesh  `... --scheme compensated --fuse-steps 4 --mesh 1,1,1`:
                     the distributed flagship on one shard, K11 x253;
                     error < 2e-5.
    Through the sharded solvers' API with all four shards on the card
    (launches per shard times shards):
      sharded_221           mesh 2,2,1: K6 x4000 and the error pass x4000,
                            the default run's error.
      sharded_comp_221      mesh 2,2,1, compensated: K7 x4000, error < 2e-5.
      sharded_kfused_411    mesh 4,1,1, k=4: K8 x1012.
      sharded_uneven_411    N=510, mesh 4,1,1, k=4: K9 x1012.
      sharded_kfused_221    mesh 2,2,1, k=4: K10 x1012, the default
                            run's error within 1e-6.
      sharded_flagship_411  mesh 4,1,1, compensated, k=4: K11 x1012,
                            error < 2e-5.
      sharded_flagship_221  mesh 2,2,1, compensated, k=4: K12 x1012,
                            error < 2e-5.
      sharded_221_varc, sharded_kfused_411_varc, sharded_uneven_411_varc,
      sharded_kfused_221_varc, sharded_flagship_411_varc,
      sharded_flagship_221_varc:
                            the same with gaussian-lens, errors off: K6f
                            x4000, K8f x1012, K9f x1012, K10f, K11f and
                            K12f x1012.
 4. contracts - through the solver API on the card, bit for bit: the
               k-fused state at N=512 / 1000 steps equals the 1-step state,
               with constant c and with the lens, and the sharded k-fused
               runs equal it; sharded_221 equals the 1-step solve (states
               and error vectors), bf16 on mesh 2,2,1 at N=128 too; at
               N=510 K6 on mesh 4,1,1, the pad-and-mask march on one shard
               and sharded_uneven_411 equal the 1-step solve, pad planes 0;
               a last shard with r < k real planes (N=50, mesh 4,1,1)
               too; sharded_kfused_221 (and its lens form) equals the
               k-fused march; sharded_comp_221 against the 1-step
               compensated solve (bitwise, or within 2e-7); the distributed
               flagships (meshes 4,1,1 and 2,2,1, constant c and the lens)
               against the single-device flagship: bitwise on mesh 4,1,1
               (u and the carry), within 1e-6 on mesh 2,2,1;
               flagship_mesh's max abs error is the flagship's, bit for
               bit; C1: sharded_flagship_221 against the flagship at
               2000 and 4000 steps (tau kept, T = 2 and 4), max |du| and
               the error vectors' max distance beside the 1000-step pair;
               and at N=128 / 1000 steps the
               compensated variable-c state lies nearer an f64 plain
               variable-c march than the standard one does (wavetpu's
               tests/test_kfused_varc.py contract).
 5. agree    - every solver at N=32 on the card against the same solver on
               the CPU (the plain versions): max |diff| <= 1e-5.
 6. times    - per-kernel times at the main-path shapes (CUDA events
               around 20 launches enqueued back to back, the median of
               three such runs), the plain versions' times (the same with
               3 launches), and each kernel's bound: the bytes it must
               move over the card's memory rate vs its f32 operations over
               the card's f32 rate; the pipelines' times at k=4 (K3, K3f,
               K8-K10f on kstep_pipe.cu; K4, K4f, K11, K11f, K12, K12f on
               comp_sharded.cu) beside the replaced cone kernels' and
               their own times recorded in PERF.md (the phase fails if
               one is more than 8% over its recorded time), K1 inside a
               300-layer march beside the error kernel and beside its
               plain version (CUDA events around each K1), K4 and
               K11-K12f also at k=1 (and K6 held to its recorded time
               the same way); the solo K6 (constant speed: the
               x-streaming lane kernel on one lane on blocks of >= 32
               planes and 32 rows, the one-thread-per-cell body on
               thinner ones) against that body alone
               (kernels/tile_ab.py, held bitwise), old, new, new, old, on
               the main block and on the overlap mode's one-plane x and y
               face blocks of it; the k-block exchange of
               one field over four shards, apart (mesh 2,2,1: y
               extension and x windows; mesh 4,1,1: x windows).

 7. measurement - the sharded API with `overlap=True` (the ghost copies on
               side streams): mesh 2,2,1 at N=512 / 1000 steps bitwise
               equal to phase 3's serial sharded_221 (states and error
               vectors), mesh 2,2,2 with the lens (K6f) at 100 steps
               bitwise equal to its serial run, each solve time beside
               serial's; the phase-timing probes (solver/timing.py) at
               N=512, iters=10 - 1-step mesh 2,2,1 (K6), k-fused mesh
               2,2,1 (K10) and the flagship on mesh 4,1,1 (K11), k=4 -
               each loop between phase 6's time per launch (rows off) x
               the launches its 1000 steps make and that plus the time of
               the copies they make, within 10%, each exchange >= 0; the
               flagship through the CLI with --telemetry-dir and --profile
               (the solve span in trace.jsonl, a heartbeat, the roofline
               fraction in metrics.prom in (0, 1.05], the allocator peak
               above 0 and below the card's memory, K4's kernel in the
               profiler's operations >= 252 times, the top operations by
               device time printed); the default CLI run under --profile
               (its kernels by device time and the device's busy share);
               --kernel roll against --kernel pallas
               at N=128 / 100 steps (bitwise, API and report lines); the
               profile subcommand over a small solve; and the nine CLI
               runs of phase 3 within 8% of their PERF.md §5 solve times.
 8. resilience - checkpoints and supervision at N=512 / 1000 steps, f32
               (the flagship with its bf16 carry), in a temporary
               directory deleted at the end: the C++ writer is built and
               native, and its .wts file of one shard is byte for byte
               the Python writer's; stop and resume through the CLI
               (`--stop-step S --save-state CK`, then `--resume CK`) on
               default (K1, S = 500), kfused (K3) and flagship (K4), S = 501
               for these two, on their block grid (off it the flagship's
               k-blocks shift, and the standard march's layers around the
               stop take full-field errors, within 1e-6 of the rows'), and
               through the API on sharded_221 (K6), sharded_kfused_221
               (K10) and sharded_flagship_221 (K12) with four shards on
               the card, each from a shard directory: final state and both
               error vectors bit-equal to phase 3's uninterrupted run, and
               the two runs' launches adding up to its launches; the
               flagship supervised in a fresh process (`--ckpt-every 250`,
               chunks of 248 layers): bit-equal, one rotation entry per
               chunk boundary (249, 497, 745, 993, 1000), the newest two
               kept, `latest` on the newest, no library built or loaded
               after the first chunk (chunk spans, compile ledger), each
               chunk's solve seconds beside its share of the unsupervised
               run's, its solve seconds beside those of the unsupervised
               flagship in a fresh process too; the supervisor's flagship chunk calls in this
               process, no saves, uninterrupted, back to back and with the
               card idle 1.5 s between chunks (where the supervised run's
               extra solve seconds go); uneven_kfused (K9, N=510)
               supervised with `--ckpt-every 250` through the CLI,
               bit-equal with phase 3's launches;
               `WAVETPU_FAULT=preempt:500` exits 3 at step 745 printing
               `resumable checkpoint:`, `--resume D --ckpt-every 250`
               exits 0 bit-equal (the errors joined at 745);
               `WAVETPU_FAULT=nan:300` exits 4 with step 249 the last good
               entry, and with `--retries 1` exits 0 bit-equal.  Prints
               save and load seconds, bytes and GB/s of each checkpoint
               kind, the parts of a shard directory's save and load
               (copies to pinned and pageable memory, CRC32, WTS1 write +
               fsync, verified read, copy to the card), the supervised
               runs' solve seconds and overhead against the unsupervised
               ones, and the phase's wall time, beside the card's name and
               power limit.
 9. ensembles  - the ensemble slice (wavetpu_torch/ensemble): each lane
               mode (K1, K5, K2, K3, K3f, K4, K6 over a batch of lanes)
               bitwise against its plain version and, lane by lane,
               against the solo kernel, at N=128 on 3 and 2 lanes and at
               its run's N on 3; its time on 8 lanes beside 8 solo
               launches, the plain version and 8 x the solo bound (K6's
               lane mode also on the mesh-2,2,1 block of N=512, the main
               path's block, held lane by lane against the solo K6
               too, beside its N=256 row, and failing if it is more than
               8% over its time recorded in PERF.md; every K6 lane
               check also holds each lane against the
               one-thread-per-cell solo body; there and at N=256
               also the solo body's lane instantiation that the
               x-streaming K6 lane kernel replaced, from
               kernels/tile_ab.py, held bitwise and timed old, new, new,
               old beside it); five
               main-path runs through `solve_ensemble` /
               `solve_ensemble_sharded`, each with the counters zeroed
               just before and read just after (exact counts, the same
               for any B): the flagship ensemble at N=512/1000 (B=8:
               phases 2 pi, 1.0-1.4, 1.6 stopping at 501, one padding
               lane; K2 lanes x1, K4 lanes x252), the pallas ensemble at
               N=512/1000 (B=4; K1 lanes x1000), the k-fused ensemble
               (N=256/1000, B=4; K3 lanes x249, K1 lanes x4), the lens
               field batch (N=256/1000, errors off, B=3; K3f lanes x249,
               K5 lanes x4) and the sharded ensemble on mesh 2,2,1 with
               the four shards on the card (N=256/200, B=4; K6 lanes
               x800), every run batched (no fallback), its held lanes
               (the reference phase, a shifted phase, the early stop)
               bit-equal to solo port solves, states and error vectors
               from layer 0; and the aggregate Gcell/s at B = 1, 2, 4, 8
               (pallas and flagship at N=256/100, the flagship at
               N=512/1000 for B = 1 and 8) with speedup_vs_batch1, beside
               the card's name and power limit.
10. serve      - the serving replica (wavetpu_torch/serve): `build_server`
               in this process on the card, driven over HTTP, the launch
               counters zeroed just before each run and read just after:
               three concurrent flagship requests at N=512/1000 (phases
               2 pi, 1.0, and 1.6 stopping at 501) coalesce into one batch
               (occupancy 3, bucket 4; K2 lanes x1, K4 lanes x252), their
               error vectors bit-equal to phase 9's ens_flagship lanes, the
               2 pi answer's max abs error phase 3's flagship's bits, each
               report_text byte for byte the port's report of the lane,
               and the allocator's peak printed; two mesh-2,2,1 requests
               at N=256/200 (K6 lanes x800), two `fuse_steps` 4 requests at
               N=256/1000 (K3 lanes x249, K1 lanes x4) and a lens pair
               (K3f lanes x249, K5 lanes x4), each batched and, where it
               has errors, bit-equal to `solve_ensemble(_sharded)` of the
               same lanes; a Courant-unstable field beside a stable one in
               one batch answers [200, 422]; /healthz's memory fields from
               the card, /metrics JSON against its Prometheus text,
               Server-Timing's components against its total (the gap
               held to 10% + 10 ms beside the request's parse, timed in
               its handler thread: a c2-field body builds its preset
               there, before the queue wait), no fallback;
               and bench.py's serving rows (N=256/100, errors on, 2B
               requests through a warmed replica of max_batch B = 1, 2, 4,
               8; pallas and flagship): aggregate Gcell/s by the batches'
               solve seconds and by wall, p50/p95 latency and
               speedup_vs_batch1 beside phase 9's solve_ensemble rows.
11. warm state - serving's warm state and long solves, counters zeroed
               just before each counted run and read just after:
               a. cold start: the port's `ledger-report
               --emit-warmup-manifest` writes a manifest of four keys
               (N=512/1000 pallas and kfused k=4 at b=1, the flagship at
               b=4, N=256/100 pallas at b=8); `python -m wavetpu_torch
               warmup` fills a fresh `--program-cache-dir` from phase 1's
               build directory; a replica process with a new, empty
               build directory and that cache answers each key with zero
               nvcc runs (its shutdown line, /metrics: 0 misses and 4
               disk hits, its compile ledger: source disk), each answer
               bit-equal to phase 3's default and kfused runs, phase 9's
               flagship lanes and `solve_ensemble`; a cold replica (empty
               build directory, no cache) pays one nvcc run a library of
               the 1-step path (stencil.cu, errors.cu); both arms'
               time to first solve, the adopt walls, the first launches;
               b. chunked long solves (`--chunk-threshold 500
               --chunk-steps 200`): pallas N=512/1000 K1 x1000 and kfused
               K3 x249 + K1 x4, each in 5 chunks, bit-equal to phase 3;
               six N=256/100 requests sent while the long pallas march
               runs are all answered before it ends, their p95 beside a
               monolithic replica's, the walls side by side;
               c. a deadline of 400 ms answers 504 with a resume_token;
               a second replica sharing `--solve-state-dir` resumes it
               to the uninterrupted answer, K1 launches of the halves
               summing to 1000; a byte-flipped token file answers 422;
               d. `--result-cache`: a repeated N=256/100 request answers
               byte-identical and no counter moves;
               e. `--shadow-sample-rate 1.0`: an N=256/100 kfused answer
               equals a shadow-less replica's, its twin runs K2's lane
               mode x100 (never the plain versions), the divergence
               lands in the accuracy ledger (source "shadow").
12. fleet    - the fleet tier (wavetpu_torch/fleet, loadgen) in front of
               replica processes on the card: two `warmup` processes fill
               replica A's program cache (the N=256/100 tiers at every
               bucket, the flagship and the N=512/1000 standard tier with
               its chunk runner) and replica B's (the N=256/100 tiers
               only); `python -m wavetpu_torch router --member A --member
               B` in its own process.
               a. affinity: the three flagship bodies through the router
               all land on A (X-Wavetpu-Member), K2 lanes x1 + K4 lanes
               x252 per batch there (A's /admin/launches), none on B,
               bit-equal to phase 9's lanes, the 2 pi answer's max abs
               error phase 3's flagship's bits;
               b. a roll: the N=512/1000 standard march in flight on A
               (chunks of 200, A holding each chunk after the first
               FLEET_HOLD_S seconds), `fleet roll --old A --new C --
               python -m wavetpu_torch serve ...` spawns C; A's drain
               answers 503 + resume_token, the router re-injects it, C
               resumes: one 200 bit-equal to phase 3's default run, K1 on
               A (its shutdown line) and on C summing to 1000,
               resume_handoffs_total +1, roll exit 0, C 0 nvcc runs, the
               router's Prometheus counters monotonic across the roll;
               c. load: `loadgen generate --pallas --n 256 --timesteps
               100 --duration 15 --qps 4` replayed through the router
               (`--retries 2 --error-budget 0 --max-cold-compiles 0`):
               p50/p95/p99 per tier, requests/s, requests per member,
               affinity hits; bench.py's B=8 serving rows through the
               router with a fresh connection per request and with the
               keep-alive WavetpuClient, both p95s;
               d. B's `--record-trace` file parses as a loadgen trace and
               replays through the router, all 200.
13. distributed - `--distributed`: the port's CLI as separate rank
               processes (explicit env:// variables, each with its own
               --out-dir, libraries loaded from phase 1's build
               directory: 0 nvcc runs) at N=512/1000: mesh 2,1,1 on 2
               ranks (K6 x1000 per rank), the flagship on 2,1,1 (K11
               x253 per rank), mesh 2,2,1 on 4 ranks with --fuse-steps 4
               (K10 x253) and the flagship (K12 x253); each run's errors
               bit-equal to the same mesh solved in one process with
               every shard on the card; `--stop-step 500 --save-state`
               (meta.npz once, each rank's shard container) then
               `--resume` on 2 ranks, bit-equal from layer 501; an NCCL
               run (mesh 2,1,1 on two cards, or one rank holding both
               shards where the machine shows one card).  Rank 1 writes
               nothing and prints neither the Courant nor the report
               line.  Each run's backend, ranks, wall, solve seconds and
               rank 0's share of the solve in the cross-rank exchange.

Each phase prints its wall time.

Launches made by the comparisons, contracts and timings do not count.
The last lines are the card's name and power limit (nvidia-smi), one JSON
`kernels` line, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from wavetpu_torch import cli
from wavetpu_torch.core.grid import Topology, build_mesh
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as ensemble
from wavetpu_torch.ensemble import sharded as ensemble_sharded
from wavetpu_torch.io import checkpoint, nativeio, state
from wavetpu_torch.kernels import build, stencil_cuda, stencil_ref, tile_ab
from wavetpu_torch.obs import perf as obs_perf
from wavetpu_torch.solver import (
    kfused, kfused_comp, leapfrog, sharded, sharded_kfused, timing,
)
from wavetpu_torch.verify import oracle

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
CSRC = "wavetpu_torch/kernels/csrc"
PALLAS = "wavetpu/kernels/stencil_pallas.py"
# Kernel rows: launch counter, source, TPU kernel body replaced, the
# main-path run that launches it, and the bytes per cell the function must
# move there (f32 state; each input read once, each output written once).
KERNELS = {
    "K1": dict(counter="step", source=f"{CSRC}/stencil.cu",
               replaces=f"{PALLAS}:130",
               what="_step_kernel: alpha*u + coeff*lap(u) - beta*u_prev",
               run="default", bytes_per_cell=12),
    "K2": dict(counter="comp_step", source=f"{CSRC}/stencil.cu",
               replaces=f"{PALLAS}:544",
               what="_comp_step_kernel: 1-step compensated (Kahan) update",
               run="flagship", bytes_per_cell=24),
    "K3": dict(counter="kstep", source=f"{CSRC}/kstep_pipe.cu",
               replaces=f"{PALLAS}:745",
               what="_kstep_kernel: k leapfrog substeps + error rows "
                    "(k=4, f32)",
               run="kfused", bytes_per_cell=16),
    "K3f": dict(counter="kstep_field", source=f"{CSRC}/kstep_pipe.cu",
                replaces=f"{PALLAS}:721",
                what="_kstep_kernel has_field: k variable-c substeps "
                     "(k=4, f32, rows off)",
                run="kfused_varc", bytes_per_cell=20),
    "K4": dict(counter="kstep_comp", source=f"{CSRC}/comp_sharded.cu",
               replaces=f"{PALLAS}:970",
               what="_kstep_comp_kernel: k velocity-form substeps + error "
                    "rows (f32 u/v, bf16 carry; K11's pipeline over the "
                    "whole state)",
               run="flagship", bytes_per_cell=20),
    "K4f": dict(counter="kstep_comp_field",
                source=f"{CSRC}/comp_sharded.cu",
                replaces=f"{PALLAS}:1043",
                what="_kstep_comp_kernel has_field: k variable-c "
                     "velocity-form substeps (f32 u/v, bf16 carry, rows off)",
                run="flagship_varc", bytes_per_cell=24),
    "K5": dict(counter="var_step", source=f"{CSRC}/stencil.cu",
               replaces=f"{PALLAS}:147",
               what="_var_step_kernel: (2u + c2tau2*lap(u)) - u_prev",
               run="varc", bytes_per_cell=16),
    # The sharded kernels: their bound counts the bytes of the launch's
    # own tensors (block, ghosts, field, rows), phase_times.
    "K6": dict(counter="sharded_step", source=f"{CSRC}/sharded.cu",
               replaces=f"{PALLAS}:316",
               what="_sharded_kernel: K1's update of a shard block, ghost "
                    "faces + global mask (mesh 2,2,1 block)",
               run="sharded_221"),
    "K6f": dict(counter="sharded_step_field", source=f"{CSRC}/sharded.cu",
                replaces=f"{PALLAS}:316",
                what="_sharded_kernel has_field: K5's update of a shard "
                     "block (mesh 2,2,1 block)",
                run="sharded_221_varc"),
    "K7": dict(counter="sharded_comp_step", source=f"{CSRC}/sharded.cu",
               replaces=f"{PALLAS}:364",
               what="_sharded_comp_kernel: K2's update of a shard block "
                    "(mesh 2,2,1 block)",
               run="sharded_comp_221"),
    "K8": dict(counter="kstep_sharded", source=f"{CSRC}/kstep_pipe.cu",
               replaces=f"{PALLAS}:1609",
               what="_kstep_sharded_kernel: k substeps of an x-sharded "
                    "block with ghost windows + rows (k=4, mesh 4,1,1)",
               run="sharded_kfused_411"),
    "K8f": dict(counter="kstep_sharded_field",
                source=f"{CSRC}/kstep_pipe.cu",
                replaces=f"{PALLAS}:1593",
                what="_kstep_sharded_kernel has_field: k variable-c "
                     "substeps (k=4, mesh 4,1,1, rows off)",
                run="sharded_kfused_411_varc"),
    "K9": dict(counter="kstep_padded", source=f"{CSRC}/kstep_pipe.cu",
               replaces=f"{PALLAS}:1782",
               what="_kstep_padded_kernel: pad-and-mask k substeps + rows "
                    "(k=4, N=510 on one shard)",
               run="uneven_kfused"),
    "K9f": dict(counter="kstep_padded_field",
                source=f"{CSRC}/kstep_pipe.cu",
                replaces=f"{PALLAS}:1782",
                what="_kstep_padded_kernel has_field: pad-and-mask "
                     "variable-c substeps (k=4, N=510 mesh 4,1,1, rows off)",
                run="sharded_uneven_411_varc"),
    "K10": dict(counter="kstep_sharded_xy",
                source=f"{CSRC}/kstep_pipe.cu",
                replaces=f"{PALLAS}:1972",
                what="_kstep_sharded_xy_kernel: k substeps of a y-extended "
                     "block + rows (k=4, mesh 2,2,1)",
                run="sharded_kfused_221"),
    "K10f": dict(counter="kstep_sharded_xy_field",
                 source=f"{CSRC}/kstep_pipe.cu", replaces=f"{PALLAS}:1593",
                 what="_kstep_sharded_xy_kernel has_field: k variable-c "
                      "substeps (k=4, mesh 2,2,1, rows off)",
                 run="sharded_kfused_221_varc"),
    "K11": dict(counter="kstep_comp_sharded",
                source=f"{CSRC}/comp_sharded.cu", replaces=f"{PALLAS}:1163",
                what="_kstep_comp_sharded_kernel: k velocity-form substeps "
                     "of an x-sharded block + rows (k=4, mesh 4,1,1, f32 "
                     "u/v, bf16 carry)",
                run="sharded_flagship_411"),
    "K11f": dict(counter="kstep_comp_sharded_field",
                 source=f"{CSRC}/comp_sharded.cu", replaces=f"{PALLAS}:1593",
                 what="_kstep_comp_sharded_kernel has_field: k variable-c "
                      "velocity-form substeps (k=4, mesh 4,1,1, rows off)",
                 run="sharded_flagship_411_varc"),
    "K12": dict(counter="kstep_comp_sharded_xy",
                source=f"{CSRC}/comp_sharded.cu", replaces=f"{PALLAS}:1369",
                what="_kstep_comp_sharded_xy_kernel: k velocity-form "
                     "substeps of a y-extended block + rows (k=4, mesh "
                     "2,2,1, f32 u/v, bf16 carry)",
                run="sharded_flagship_221"),
    "K12f": dict(counter="kstep_comp_sharded_xy_field",
                 source=f"{CSRC}/comp_sharded.cu", replaces=f"{PALLAS}:1593",
                 what="_kstep_comp_sharded_xy_kernel has_field: k variable-c "
                      "velocity-form substeps (k=4, mesh 2,2,1, rows off)",
                 run="sharded_flagship_221_varc"),
    # The 1-step error pass: its bound counts the interior view it reads,
    # (N-1)^3 cells (phase_times).
    "errors": dict(counter="layer_errors", source=f"{CSRC}/errors.cu",
                   replaces="none: wavetpu/solver/leapfrog.py:106 "
                            "(_error_fn, fused by XLA)",
                   what="layer_errors_kernel: L-inf abs/rel error of the "
                        "interior against the separable closed form",
                   run="default", bytes_per_cell=4),
}
# The lane modes (the ensembles' batch axis, phase 9): the solo row each
# batches (its bound per lane), and the phase-9 run that launches it.
LANE_KERNELS = {
    "K1 lanes": dict(counter="step_lanes", solo="K1",
                     source=f"{CSRC}/stencil.cu", replaces=f"{PALLAS}:130",
                     what="K1's lane mode: B leapfrog steps in one launch "
                          "(pallas ensemble, N=512, B=8)",
                     run="ens_pallas", bytes_per_cell=12, ops=19),
    "K5 lanes": dict(counter="var_step_lanes", solo="K5",
                     source=f"{CSRC}/stencil.cu", replaces=f"{PALLAS}:147",
                     what="K5's lane mode: B variable-c steps, per-lane "
                          "fields (lens batch, N=256, B=8)",
                     run="ens_kfused_lens", bytes_per_cell=16, ops=19),
    "K2 lanes": dict(counter="comp_step_lanes", solo="K2",
                     source=f"{CSRC}/stencil.cu", replaces=f"{PALLAS}:544",
                     what="K2's lane mode: B Kahan steps (the flagship "
                          "ensemble's bootstrap, N=512, B=8)",
                     run="ens_flagship", bytes_per_cell=24, ops=20),
    "K3 lanes": dict(counter="kstep_lanes", solo="K3",
                     source=f"{CSRC}/kstep_pipe.cu",
                     replaces=f"{PALLAS}:745",
                     what="K3's lane mode: k substeps of B states + per-lane "
                          "rows (kfused ensemble, k=4, N=256, B=8)",
                     run="ens_kfused", bytes_per_cell=16, ops=22 * 4),
    "K3f lanes": dict(counter="kstep_field_lanes", solo="K3f",
                      source=f"{CSRC}/kstep_pipe.cu",
                      replaces=f"{PALLAS}:721",
                      what="K3f's lane mode: k variable-c substeps, per-lane "
                           "fields (lens batch, k=4, N=256, B=8, rows off)",
                      run="ens_kfused_lens", bytes_per_cell=20, ops=19 * 4),
    "K4 lanes": dict(counter="kstep_comp_lanes", solo="K4",
                     source=f"{CSRC}/comp_sharded.cu",
                     replaces=f"{PALLAS}:970",
                     what="K4's lane mode: k velocity-form substeps of B "
                          "states + per-lane rows (flagship ensemble, k=4, "
                          "N=512, B=8)",
                     run="ens_flagship", bytes_per_cell=20, ops=23 * 4),
    "K6 lanes": dict(counter="sharded_step_lanes", solo="K6",
                     source=f"{CSRC}/sharded.cu", replaces=f"{PALLAS}:316",
                     what="K6's lane mode: B shard blocks with (B, face) "
                          "ghosts (sharded ensemble, mesh 2,2,1 block, "
                          "N=256, B=8)",
                     run="ens_sharded_221", ops=19),
}
KERNELS.update(LANE_KERNELS)
# The one-thread-per-cell solo K6 body on each lane of K6's lane-mode
# batch (tile_ab.k6_solo_old): a lane-by-lane witness apart from the
# streaming kernel, which the solo wrapper also takes on these blocks.
K6_SOLO_BODY = "K6 solo body"
N_FULL, N_ODD, STEPS, K = 512, 510, 1000, 4
LENS = "gaussian-lens"
NB, REM = (STEPS - 1) // K, (STEPS - 1) % K
# The face rows a thread of the flagship's k=4 launches (its k=1 tail
# takes R = 1).
FLAGSHIP_R = stencil_cuda.comp_pipe_block(
    K, stencil_cuda.default_block_x(N_FULL, K))[3]
# ... and of the standard k-fused path's k=4 launches (K3).
KFUSED_R = stencil_cuda.kstep_pipe_block(K, N_FULL)[3]
# The main-path CLI runs: N, the flags after `N 1 1 1 1 1 1000` and the
# launch count of every counter that must move (all others stay 0).
# The error pass (`layer_errors`) runs once a layer on the 1-step marches
# and once a shard a layer on the sharded 1-step ones; on the k-fused
# paths for layer 1 and the tail (the k-step kernels' rows do the rest;
# the flagship's layer 1 is its masked plain pass).
RUNS = {
    "default": (N_FULL, [], {"step": STEPS, "layer_errors": STEPS}),
    "flagship": (N_FULL, ["--scheme", "compensated", "--fuse-steps", str(K)],
                 {"comp_step": 1, "kstep_comp": NB + REM}),
    "kfused": (N_FULL, ["--fuse-steps", str(K)],
               {"kstep": NB, "step": 1 + REM, "layer_errors": 1 + REM}),
    "varc": (N_FULL, ["--c2-field", LENS], {"var_step": STEPS}),
    "kfused_varc": (N_FULL, ["--fuse-steps", str(K), "--c2-field", LENS],
                    {"kstep_field": NB, "var_step": 1 + REM}),
    "flagship_varc": (N_FULL, ["--scheme", "compensated", "--fuse-steps",
                               str(K), "--c2-field", LENS],
                      {"kstep_comp_field": 1 + NB + REM}),
    # K does not divide N: the pad-and-mask march on a (1,1,1) mesh (K9:
    # bootstrap at k=1, 249 blocks at k=4, 3 tail layers at k=1).
    "uneven_kfused": (N_ODD, ["--fuse-steps", str(K)],
                      {"kstep_padded": 1 + NB + REM}),
    "sharded": (N_FULL, ["--mesh", "1,1,1"],
                {"sharded_step": STEPS, "layer_errors": STEPS}),
    # The distributed flagship on one shard: K11 at k=1 for layer 1, 249
    # blocks at k=4, 3 tail layers at k=1.
    "flagship_mesh": (N_FULL, ["--scheme", "compensated", "--fuse-steps",
                               str(K), "--mesh", "1,1,1"],
                      {"kstep_comp_sharded": 1 + NB + REM}),
}
# The main-path runs through the API with every shard on the card: N, the
# solver call, and the launch counts (per shard times shards).
SHARDS = 4
API_RUNS = {
    "sharded_221": (N_FULL, dict(mesh=(2, 2, 1)),
                    {"sharded_step": SHARDS * STEPS,
                     "layer_errors": SHARDS * STEPS}),
    "sharded_comp_221": (N_FULL, dict(mesh=(2, 2, 1), scheme="compensated"),
                         {"sharded_comp_step": SHARDS * STEPS,
                          "layer_errors": SHARDS * STEPS}),
    "sharded_kfused_411": (N_FULL, dict(k=K),
                           {"kstep_sharded": SHARDS * (1 + NB + REM)}),
    "sharded_uneven_411": (N_ODD, dict(k=K),
                           {"kstep_padded": SHARDS * (1 + NB + REM)}),
    "sharded_221_varc": (N_FULL, dict(mesh=(2, 2, 1), field=LENS),
                         {"sharded_step_field": SHARDS * STEPS}),
    "sharded_kfused_411_varc": (N_FULL, dict(k=K, field=LENS),
                                {"kstep_sharded_field":
                                 SHARDS * (1 + NB + REM)}),
    "sharded_uneven_411_varc": (N_ODD, dict(k=K, field=LENS),
                                {"kstep_padded_field":
                                 SHARDS * (1 + NB + REM)}),
    "sharded_kfused_221": (N_FULL, dict(k=K, mesh=(2, 2, 1)),
                           {"kstep_sharded_xy": SHARDS * (1 + NB + REM)}),
    "sharded_flagship_411": (N_FULL, dict(k=K, mesh=(4, 1, 1),
                                          scheme="compensated"),
                             {"kstep_comp_sharded": SHARDS * (1 + NB + REM)}),
    "sharded_flagship_221": (N_FULL, dict(k=K, mesh=(2, 2, 1),
                                          scheme="compensated"),
                             {"kstep_comp_sharded_xy":
                              SHARDS * (1 + NB + REM)}),
    "sharded_kfused_221_varc": (N_FULL, dict(k=K, mesh=(2, 2, 1),
                                             field=LENS),
                                {"kstep_sharded_xy_field":
                                 SHARDS * (1 + NB + REM)}),
    "sharded_flagship_411_varc": (N_FULL, dict(k=K, mesh=(4, 1, 1),
                                               scheme="compensated",
                                               field=LENS),
                                  {"kstep_comp_sharded_field":
                                   SHARDS * (1 + NB + REM)}),
    "sharded_flagship_221_varc": (N_FULL, dict(k=K, mesh=(2, 2, 1),
                                               scheme="compensated",
                                               field=LENS),
                                  {"kstep_comp_sharded_xy_field":
                                   SHARDS * (1 + NB + REM)}),
}
# The error class of each run with errors at N=512/510, 1000 steps: f32
# rounding accumulation on the standard scheme, the f32 discretization
# limit (~6e-6 here) on the compensated one.
ERROR_CLASS = {"default": 5e-3, "flagship": 2e-5, "kfused": 5e-3,
               "uneven_kfused": 5e-3, "sharded": 5e-3, "sharded_221": 5e-3,
               "sharded_comp_221": 2e-5, "sharded_kfused_411": 5e-3,
               "sharded_uneven_411": 5e-3, "flagship_mesh": 2e-5,
               "sharded_kfused_221": 5e-3, "sharded_flagship_411": 2e-5,
               "sharded_flagship_221": 2e-5}
# The phase-6 times of the redesigned kernels as recorded in PERF.md §6
# (NVIDIA H100 80GB HBM3, 700.00 W; launches back to back): the pipelines
# at k=4, K3-K10f on kstep_pipe.cu's, K4-K12f on comp_sharded.cu's, and
# the x-streaming K6 on the mesh-2,2,1 block of N=512.  Phase 6 fails if
# a kernel times more than GUARD_SLACK over its recorded time; phase 9
# holds K6's lane mode at the main block (B=8 on that block) to
# LANE_GUARD_MS the same way.
GUARD_MS = {"K3": 2.7660, "K3f": 2.5176, "K8": 0.8123, "K8f": 0.8317,
            "K9": 2.3818, "K9f": 0.6663, "K10": 0.7982, "K10f": 0.7403,
            "K4": 3.0284, "K4f": 3.6361, "K11": 0.7930, "K11f": 0.9362,
            "K12": 0.7846, "K12f": 0.9333, "K6": 0.1775}
LANE_GUARD_MS = {"K6 lanes": 1.3227}
GUARD_SLACK = 0.08
# The phase-6 times of the cone kernels that the pipelines replaced, as
# recorded in PERF.md (same card and limit; k=4, the main-path shapes;
# K3-K10f launched back to back, K4-K12f isolated launches), printed beside
# this run's times.
CONE_MS = {"K3": 5.7130, "K3f": 6.1087, "K4": 7.6665, "K4f": 6.1981,
           "K8": 1.6131, "K8f": 2.1786, "K9": 6.3452, "K9f": 2.1011,
           "K10": 1.6122, "K10f": 2.1153, "K11": 2.2481, "K11f": 2.7473,
           "K12": 2.1770, "K12f": 2.7102}
DEV = "cuda"
CLI_EXTRA = []  # the CLI's default platform is the GPU
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def fail(msg):
    raise RuntimeError(f"chip_smoke FAILED: {msg}")


# The counters by face rows a thread (`kstep_comp_r<R>`, csrc/
# comp_sharded.cu's shapes; `kstep_pipe_r<R>`, csrc/kstep_pipe.cu's) count
# each pipeline's launches once more.  Every run's exact counts are of the
# kernels' own counters: `kernel_launches` checks that each family's
# counters by R add up to them and drops them; `rows_launches` keeps them
# alone.
ROWS_COUNTER = re.compile(r"kstep_(comp|pipe)_r\d+$")
PIPE_COUNTERS = {
    "comp": ("kstep_comp", "kstep_comp_field", "kstep_comp_sharded",
             "kstep_comp_sharded_field", "kstep_comp_sharded_xy",
             "kstep_comp_sharded_xy_field", "kstep_comp_lanes"),
    "pipe": ("kstep", "kstep_field", "kstep_sharded", "kstep_sharded_field",
             "kstep_padded", "kstep_padded_field", "kstep_sharded_xy",
             "kstep_sharded_xy_field", "kstep_lanes", "kstep_field_lanes"),
}


def kernel_launches(counts, nonzero=False):
    for family, names in PIPE_COUNTERS.items():
        by_r = sum(n for c, n in counts.items()
                   if c.startswith(f"kstep_{family}_r"))
        launched = sum(counts.get(c, 0) for c in names)
        if by_r != launched:
            fail(f"launches by face rows {rows_launches(counts)} add up to "
                 f"{by_r}, the {family} pipeline's counters to {launched}")
    return {c: n for c, n in counts.items()
            if not ROWS_COUNTER.match(c) and (n or not nonzero)}


def rows_launches(counts):
    return {c: n for c, n in counts.items() if ROWS_COUNTER.match(c) and n}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def field(n, seed, scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.randn((n, n, n), generator=g, dtype=torch.float32) * scale
    a[:, 0, :] = 0.0
    a[:, :, 0] = 0.0
    return a.to(DEV)


def c2_field(p, seed):
    """A positive f32 tau^2 c^2 field around a2tau2 (0.5x to 1.5x)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = 0.5 + torch.rand((p.N,) * 3, generator=g, dtype=torch.float64)
    return (p.a2tau2 * a).to(DEV, torch.float32)


def check_outputs(label, got, want, errs):
    """Every output bitwise equal to the plain version's (NaN bits too)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None and b is None:
            continue
        if a is None or b is None:
            fail(f"{label} output {i}: {a} vs {b}")
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{label} output {i}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        err = (a.double() - b.double()).abs().max().item()
        same = torch.equal(a, b) or torch.equal(a.view(torch.uint8),
                                                b.view(torch.uint8))
        print(f"  {label} out{i}: max_abs_err={err:.3e} bitwise={same}")
        if not same:
            fail(f"{label} output {i} is not bitwise equal to the plain "
                 f"version (max |diff| {err:.3e})")
        errs.append(err)


def error_pass_inputs(n, dtype, layer=3):
    """An error-pass launch's operands as the 1-step march has them: the
    interior view of layer `layer` of the closed form plus 1e-3 noise, in
    the state dtype; the interior factors and the time factor in the
    compute dtype."""
    p = Problem(N=n, timesteps=STEPS)
    f = stencil_ref.compute_dtype(dtype)
    sx, sy, sz = oracle.spatial_factors(p, f, DEV)
    ct = oracle.time_factor_table(p, f, DEV)[layer]
    u = (oracle.analytic_field(sx, sy, sz, ct)
         + field(n, 9, 1e-3).to(f)).to(dtype)
    return u[1:, 1:, 1:], sx[1:], sy[1:], sz[1:], ct


def oracle_inputs(n, k):
    p = Problem(N=n, timesteps=STEPS)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, DEV)
    ctk = ct[2: 2 + k]
    return p, syz, rsyz, ctk[:, None] * sx[None, :]


def k4_inputs(n, k, mode):
    v_dt, c_dt = mode
    u = field(n, 3)
    v = field(n, 4, 1e-3).to(v_dt)
    c = None if c_dt is None else field(n, 5, 1e-8).to(c_dt)
    return u, v, c


K4_MODES = {
    "f32v+bf16carry": (torch.float32, torch.bfloat16),
    "f32v+f32carry": (torch.float32, torch.float32),
    "bf16v+nocarry": (torch.bfloat16, None),
}


def phase_kernels(errs):
    """Each kernel against its plain version on the card."""
    for n in (128, N_FULL):
        p = Problem(N=n, timesteps=STEPS)
        up, u = field(n, 1), field(n, 2)
        fld = c2_field(p, 8)
        for coeffs in ((2.0, 1.0, p.a2tau2), (1.0, 0.0, 0.5 * p.a2tau2)):
            a, b, c = coeffs
            kw = dict(inv_h2=p.inv_h2, alpha=a, beta=b, coeff=c)
            got = stencil_cuda.fused_step(up, u, **kw)
            want = stencil_cuda.fused_step_plain(up, u, **kw)
            check_outputs(f"K1 N={n} (a,b)=({a},{b})", [got], [want],
                          errs["K1"])
        for dt in ((torch.float32, torch.bfloat16) if n == 128
                   else (torch.float32,)):
            kw = dict(inv_h2=p.inv_h2, c2tau2_field=fld)
            got = stencil_cuda.fused_step(up.to(dt), u.to(dt), **kw)
            want = stencil_cuda.fused_step_plain(up.to(dt), u.to(dt), **kw)
            check_outputs(f"K5 N={n} {dt}", [got], [want], errs["K5"])
        k3_cases = (
            [(k, dt, rows, f) for k in (2, 4, 8)
             for dt in (torch.float32, torch.bfloat16)
             for rows in (True, False) for f in (False, True)]
            if n == 128 else [(K, torch.float32, True, False),
                              (K, torch.float32, True, True),
                              (K, torch.float32, False, True)])
        for k, dt, rows, with_f in k3_cases:
            check_k3(p, up, u, fld, k, dt, rows, with_f, errs)
        v, cy = field(n, 6, 1e-3), field(n, 7, 1e-8)
        z = torch.zeros_like(u)
        for label, args in (("C", (u, v, cy, p.a2tau2)),
                            ("C/2 zero v,carry", (u, z, z, 0.5 * p.a2tau2))):
            got = stencil_cuda.compensated_step(*args[:3], p, args[3])
            want = stencil_cuda.compensated_step_plain(
                *args[:3], inv_h2=p.inv_h2, coeff=args[3])
            check_outputs(f"K2 N={n} {label}", got, want, errs["K2"])
        modes = K4_MODES if n == 128 else {
            "f32v+bf16carry": K4_MODES["f32v+bf16carry"]}
        for k in (K, 1):
            _, syz, rsyz, sxct = oracle_inputs(n, k)
            for mname, mode in modes.items():
                u4, v4, c4 = k4_inputs(n, k, mode)
                kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
                          block_x=stencil_cuda.default_block_x(n, k))
                got = stencil_cuda.fused_kstep_comp(u4, v4, c4, syz, rsyz,
                                                    sxct, **kw)
                want = stencil_cuda.fused_kstep_comp_plain(
                    u4, v4, c4, syz, rsyz, sxct, **kw)
                check_outputs(f"K4 N={n} k={k} {mname}", got, want,
                              errs["K4"])
                # Rows off: how the variable-c flagship launches K4f.
                for rows in (True, False):
                    kwf = dict(kw, c2tau2_field=fld, with_errors=rows)
                    got = stencil_cuda.fused_kstep_comp(
                        u4, v4, c4, syz, rsyz, sxct, **kwf)
                    want = stencil_cuda.fused_kstep_comp_plain(
                        u4, v4, c4, syz, rsyz, sxct, **kwf)
                    check_outputs(f"K4f N={n} k={k} {mname} rows={rows}",
                                  got, want, errs["K4f"])
        # The variable-c flagship's layer 1 (kfused_comp._bootstrap).
        zero_plane = torch.zeros((n, n), device=DEV)
        for mname, (v_dt, c_dt) in modes.items():
            v0 = torch.zeros((n,) * 3, dtype=v_dt, device=DEV)
            c0 = (None if c_dt is None
                  else torch.zeros((n,) * 3, dtype=c_dt, device=DEV))
            args = (u, v0, c0, zero_plane, zero_plane,
                    torch.zeros((1, n), device=DEV))
            kw = dict(k=1, coeff=None, inv_h2=p.inv_h2,
                      block_x=stencil_cuda.default_block_x(n, 1),
                      with_errors=False, c2tau2_field=0.5 * fld)
            got = stencil_cuda.fused_kstep_comp(*args, **kw)
            want = stencil_cuda.fused_kstep_comp_plain(*args, **kw)
            check_outputs(f"K4f N={n} bootstrap {mname}", got, want,
                          errs["K4f"])
        for dt in ((torch.float32, torch.bfloat16, torch.float64) if n == 128
                   else (torch.float32,)):
            args = error_pass_inputs(n, dt)
            check_outputs(f"errors N={n} {dt}", stencil_cuda.layer_errors(
                *args), oracle.separable_layer_errors(*args), errs["errors"])
    # K3 at N = 200: y and z extents no multiple of the pipeline's 24 x 24
    # face, x segments of 100 planes.
    p = Problem(N=200, timesteps=STEPS)
    up, u, fld = field(200, 1), field(200, 2), c2_field(p, 8)
    for k in (4, 8):
        for rows in (True, False):
            for with_f in (False, True):
                check_k3(p, up, u, fld, k, torch.float32, rows, with_f, errs)
    torch.cuda.synchronize()


def check_k3(p, up, u, fld, k, dt, rows, with_f, errs):
    _, syz, rsyz, sxct = oracle_inputs(p.N, k)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
              c2tau2_field=fld if with_f else None, with_errors=rows)
    args = (up.to(dt), u.to(dt), syz, rsyz, sxct)
    got = stencil_cuda.fused_kstep(*args, **kw)
    want = stencil_cuda.fused_kstep_plain(*args, **kw)
    name = "K3f" if with_f else "K3"
    shape = stencil_cuda.kstep_pipe_block(k, p.N, dt, with_f)
    check_outputs(f"{name} N={p.N} k={k} {dt} rows={rows} shape={shape}",
                  got, want, errs[name])


def rand(shape, seed, scale=1.0, dtype=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(DEV, dtype)


def face_ghosts(shape, seed, dtype):
    """Synthetic face ghosts of a block: ((xlo, xhi), (ylo, yhi), (zlo,
    zhi)), each shaped like the block's face."""
    out = []
    for axis in range(3):
        face = list(shape)
        face[axis] = 1
        out.append(tuple(rand(face, seed + 2 * axis + i, dtype=dtype)
                         for i in range(2)))
    return out


# Shard blocks of K6/K7: (label, mesh, N, block, r_last, offsets).
K6_BLOCKS_128 = [
    ("1,1,1", (1, 1, 1), 128, (128, 128, 128), None, (0, 0, 0)),
    ("2,2,1", (2, 2, 1), 128, (64, 64, 128), None, (64, 0, 0)),
    ("2,2,2", (2, 2, 2), 128, (64, 64, 64), None, (0, 64, 64)),
    ("4,1,1 uneven", (4, 1, 1), 127, (32, 127, 127), (31, 127, 127),
     (96, 0, 0)),
]
# The blocks the main-path runs launch K6/K7 on: mesh 2,2,1 and 1,1,1 at
# N=512, and the last shard of mesh 4,1,1 at N=510 (128 planes, 126 real).
_H, _B, _R = N_FULL // 2, -(-N_ODD // 4), N_ODD - 3 * -(-N_ODD // 4)
K6_BLOCKS_FULL = [
    ("2,2,1", (2, 2, 1), N_FULL, (_H, _H, N_FULL), None, (_H, 0, 0)),
    ("1,1,1", (1, 1, 1), N_FULL, (N_FULL,) * 3, None, (0, 0, 0)),
    ("4,1,1 uneven", (4, 1, 1), N_ODD, (_B, N_ODD, N_ODD),
     (_R, N_ODD, N_ODD), (3 * _B, 0, 0)),
]


def chain_shapes():
    """(name, D, N, n_real) of the K8/K9 launches of the main-path runs:
    sharded_kfused_411 (a quarter of N=512), uneven_kfused (N=510 on one
    shard) and the last shard of sharded_uneven_411."""
    _, d1, r1 = sharded_kfused.uneven_layout(Problem(N=N_ODD, timesteps=1),
                                             K, 1)
    _, d4, r4 = sharded_kfused.uneven_layout(Problem(N=N_ODD, timesteps=1),
                                             K, SHARDS)
    return (("K8", N_FULL // SHARDS, N_FULL, N_FULL // SHARDS),
            ("K9", d1, N_ODD, r1), ("K9", d4, N_ODD, r4))


def k6_args(block, dtype, seed, field=False):
    label, mesh, n, shape, r_last, offsets = block
    p = Problem(N=n, timesteps=STEPS)
    up, u = rand(shape, seed, dtype=dtype), rand(shape, seed + 1, dtype=dtype)
    f = stencil_ref.compute_dtype(dtype)
    fld = ((p.a2tau2 * (0.5 + rand(shape, seed + 9).abs())).to(f)
           if field else None)
    kw = dict(inv_h2=p.inv_h2, mesh_shape=mesh, r_last=r_last,
              coeff=p.a2tau2, c2tau2_block=fld)
    return (up, u, face_ghosts(shape, seed + 2, dtype), offsets, n), kw


def chain_args(d, n, k, n_real, dtype, seed, field=False):
    """A K8/K9 launch's operands: (D, N, N) state with zero pad past
    n_real, (k, N, N) ghost windows, the oracle planes and (k, D) row."""
    p = Problem(N=n, timesteps=STEPS)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, DEV)
    sxp = torch.cat([sx, torch.zeros(d, device=DEV)])[:d]
    sxct = (ct[2:2 + k][:, None] * sxp[None, :]).contiguous()
    up, u = (rand((d, n, n), seed + i, dtype=dtype) for i in range(2))
    up[n_real:], u[n_real:], sxct[:, n_real:] = 0.0, 0.0, 0.0
    gh = [rand((k, n, n), seed + 2 + i, dtype=dtype) for i in range(4)]
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2)
    if field:
        kw.update(c2tau2_block=p.a2tau2 * (0.5 + rand((d, n, n),
                                                       seed + 6).abs()),
                  c2_ghosts=tuple(p.a2tau2 * (0.5 + rand((k, n, n),
                                                         seed + 7 + i).abs())
                                  for i in range(2)))
    return (up, u, (gh[0], gh[1]), (gh[2], gh[3]), syz, rsyz, sxct), kw


def check_chain(name, d, n, k, n_real, dtype, rows, field, errs, seed=60):
    args, kw = chain_args(d, n, k, n_real, dtype, seed, field)
    kw["with_errors"] = rows
    if name.startswith("K8"):
        got = stencil_cuda.fused_kstep_sharded(*args, **kw)
        want = stencil_cuda.fused_kstep_sharded_plain(*args, **kw)
    else:
        got = stencil_cuda.fused_kstep_padded(*args[:2], n_real, *args[2:],
                                              **kw)
        want = stencil_cuda.fused_kstep_padded_plain(*args[:2], n_real,
                                                     *args[2:], **kw)
    check_outputs(f"{name} D={d} N={n} k={k} n_real={n_real} {dtype} "
                  f"rows={rows}", got, want, errs[name])


def phase_sharded_kernels(errs):
    """K6-K9 against their plain versions on the card: at N=128 in every
    mode, then at the shapes the main-path runs launch."""
    for block in K6_BLOCKS_128:
        for dt in (torch.float32, torch.bfloat16, torch.float64):
            for field in (False, True):
                name = "K6f" if field else "K6"
                args, kw = k6_args(block, dt, 10, field)
                got = stencil_cuda.sharded_fused_step(*args, **kw)
                want = stencil_cuda.sharded_fused_step_plain(*args, **kw)
                check_outputs(f"{name} {block[0]} block {block[3]} {dt}",
                              [got], [want], errs[name])
    for block in K6_BLOCKS_128[1:] + K6_BLOCKS_FULL[:1]:
        for dt in ((torch.float32, torch.float64) if block[2] < N_ODD
                   else (torch.float32,)):
            (up, u, g, offsets, n), kw = k6_args(block, dt, 20)
            kw.pop("c2tau2_block")
            v, c = rand(u.shape, 30, 1e-3, dt), rand(u.shape, 31, 1e-8, dt)
            got = stencil_cuda.sharded_compensated_step(u, v, c, g, offsets,
                                                        n, **kw)
            want = stencil_cuda.sharded_compensated_step_plain(
                u, v, c, g, offsets, n, **kw)
            check_outputs(f"K7 {block[0]} block {block[3]} {dt}", got, want,
                          errs["K7"])
    for block in K6_BLOCKS_FULL:
        for field in ((False, True) if block[0] == "2,2,1" else (False,)):
            name = "K6f" if field else "K6"
            args, kw = k6_args(block, torch.float32, 40, field)
            got = stencil_cuda.sharded_fused_step(*args, **kw)
            want = stencil_cuda.sharded_fused_step_plain(*args, **kw)
            check_outputs(f"{name} {block[0]} block {block[3]} f32", [got],
                          [want], errs[name])
            del args, got, want
    # N=128: a (4,1,1) block of 32 planes, and the pad-and-mask blocks of
    # N=127 over 4 shards (32 planes, 31 real) and over one (128, 127 real).
    for k in (1, 2, 4, 8):
        for dt in (torch.float32, torch.bfloat16):
            for rows in (True, False):
                for field in (False, True):
                    f = "f" if field else ""
                    check_chain("K8" + f, 32, 128, k, 32, dt, rows, field,
                                errs)
                    check_chain("K9" + f, 32, 127, k, 31, dt, rows, field,
                                errs)
    check_chain("K9", 128, 127, K, 127, torch.float32, True, False, errs)
    # K9 on the pipeline: the real planes ending inside a segment (150 of
    # two 100-plane segments) and on a segment boundary (100), below k (3:
    # the hi window then holds planes of two shards), and a depth of two
    # 101-plane segments that overlap by one plane (201, 199 real).
    for d, n_real in ((200, 150), (200, 100), (32, 3), (201, 199)):
        for dt in (torch.float32, torch.bfloat16):
            for rows in (True, False):
                for field in (False, True):
                    check_chain("K9" + ("f" if field else ""), d, 128, K,
                                n_real, dt, rows, field, errs)
    # K8's pipeline (csrc/kstep_pipe.cu): blocks as deep as k (one segment
    # of k planes), of one 96-plane and of two 128-plane segments.
    for rows in (True, False):
        for field in (False, True):
            f = "f" if field else ""
            for k in (1, 4, 8):
                check_chain("K8" + f, k, 128, k, k, torch.float32, rows,
                            field, errs)
            for d, dt in ((96, torch.float32), (256, torch.bfloat16)):
                check_chain("K8" + f, d, 128, K, d, dt, rows, field, errs)
    # The main-path shapes: sharded_kfused_411 (D=128 of 512), uneven_kfused
    # (D=512, 510 real), sharded_uneven_411 (D=128, the last 126 real).
    for i, (name, d, n, n_real) in enumerate(chain_shapes()):
        check_chain(name, d, n, K, n_real, torch.float32, True, False, errs)
        check_chain(name, d, n, 1, n_real, torch.float32, True, False, errs)
        check_chain(name, d, n, 1, n_real, torch.float32, False, False, errs)
        if i != 1:
            check_chain(name + "f", d, n, K, n_real, torch.float32, False,
                        True, errs)
            check_chain(name + "f", d, n, 1, n_real, torch.float32, False,
                        True, errs)
    torch.cuda.synchronize()


# K11/K12 take K4's four storage modes (v, carry).
COMP_MODES = dict(K4_MODES, **{"f32v+nocarry": (torch.float32, None)})


def plane_case(d, n, k, ny, y0, whole=False):
    """The oracle operands of a K10-K12 launch on a (d, py, n) block: the
    central (ny, n) oracle planes from global row y0, the (k, d) rows, and
    py = n (whole y, K11) or ny + 2k (y-extended, K10 and K12)."""
    p = Problem(N=n, timesteps=STEPS)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, DEV)
    planes = tuple(a[y0:y0 + ny].contiguous() for a in (syz, rsyz))
    sxct = (ct[2:2 + k][:, None] * sx[None, :d]).contiguous()
    return p, planes, sxct, n if whole else ny + 2 * k


def c2_chain(p, d, k, py, seed):
    """A positive f32 field block (d, py, N) and its (k, py, N) windows."""
    fld = p.a2tau2 * (0.5 + rand((d, py, p.N), seed).abs())
    return fld, tuple(p.a2tau2 * (0.5 + rand((k, py, p.N),
                                              seed + 1 + i).abs())
                      for i in range(2))


def check_k10(d, n, k, ny, y0, dtype, rows, field, errs, seed=100):
    p, planes, sxct, py = plane_case(d, n, k, ny, y0)
    up, u = (rand((d, py, n), seed + i, dtype=dtype) for i in range(2))
    gh = [rand((k, py, n), seed + 2 + i, dtype=dtype) for i in range(4)]
    fld, fg = c2_chain(p, d, k, py, seed + 6) if field else (None, None)
    args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), *planes, sxct, y0, n)
    kw = dict(k=k, nl_y=ny, coeff=p.a2tau2, inv_h2=p.inv_h2,
              c2tau2_ext=fld, c2_ghosts=fg, with_errors=rows)
    got = stencil_cuda.fused_kstep_sharded_xy(*args, **kw)
    want = stencil_cuda.fused_kstep_sharded_xy_plain(*args, **kw)
    name = "K10f" if field else "K10"
    check_outputs(f"{name} D={d} N={n} k={k} nl_y={ny} y0={y0} {dtype} "
                  f"rows={rows}", got, want, errs[name])


def comp_call(name, d, n, k, ny, y0, mode, rows, field, seed=120,
              bootstrap=False, bx=None):
    """The kernel and the plain version of one K11 or K12 launch (name
    "K11"/"K12", "f" for the field form) on synthetic operands at carry
    slab `bx` (default `default_block_x(d, k)`); with `bootstrap` the
    layer-1 form: k=1, coeff C/2 (half the field), zero v and carry, rows
    off."""
    v_dt, c_dt = mode
    whole = name.startswith("K11")
    p, planes, sxct, py = plane_case(d, n, k, ny, y0, whole)
    scale = 0.0 if bootstrap else 1.0
    u = rand((d, py, n), seed)
    v = rand((d, py, n), seed + 1, 1e-3 * scale, v_dt)
    c = None if c_dt is None else rand((d, ny, n), seed + 2, 1e-8 * scale,
                                       c_dt)
    gu = tuple(rand((k, py, n), seed + 3 + i) for i in range(2))
    gv = tuple(rand((k, py, n), seed + 5 + i, 1e-3 * scale, v_dt)
               for i in range(2))
    fld, fg = c2_chain(p, d, k, py, seed + 7) if field else (None, None)
    coeff = p.a2tau2
    if bootstrap:
        coeff = 0.5 * coeff
        if field:
            fld, fg = 0.5 * fld, tuple(0.5 * g for g in fg)
    args = (u, v, c, gu, gv, *planes, sxct)
    kw = dict(k=k, coeff=coeff, inv_h2=p.inv_h2, c2_ghosts=fg,
              block_x=bx or stencil_cuda.default_block_x(d, k),
              with_errors=rows)
    if whole:
        return (lambda: stencil_cuda.fused_kstep_comp_sharded(
                    *args, c2tau2_block=fld, **kw),
                lambda: stencil_cuda.fused_kstep_comp_sharded_plain(
                    *args, c2tau2_block=fld, **kw), args, fld, fg)
    kw.update(nl_y=ny, c2tau2_ext=fld)
    return (lambda: stencil_cuda.fused_kstep_comp_sharded_xy(
                *args, y0, n, **kw),
            lambda: stencil_cuda.fused_kstep_comp_sharded_xy_plain(
                *args, y0, n, **kw), args, fld, fg)


def check_comp(name, d, n, k, ny, y0, mname, rows, field, errs,
               bootstrap=False, bx=None):
    kern, plain, _, _, _ = comp_call(name, d, n, k, ny, y0,
                                     COMP_MODES[mname], rows, field,
                                     bootstrap=bootstrap, bx=bx)
    name += "f" if field else ""
    bx = bx or stencil_cuda.default_block_x(d, k)
    shape = stencil_cuda.comp_pipe_block(k, bx, *COMP_MODES[mname], field)
    check_outputs(f"{name} D={d} N={n} k={k} nl_y={ny} y0={y0} bx={bx} "
                  f"shape={shape} {mname} "
                  f"rows={rows}{' bootstrap' if bootstrap else ''}", kern(),
                  plain(), errs[name])


# The main-path blocks of K10-K12: mesh 2,2,1 (the y0 = 256 shard, x depth
# 256, 256 central rows) and mesh 4,1,1 (x depth 128).
XY_FULL = (N_FULL // 2, N_FULL, N_FULL // 2, N_FULL // 2)
X_FULL = (N_FULL // SHARDS, N_FULL, N_FULL, 0)


def phase_xy_kernels(errs):
    """K10-K12 (and their field forms) against their plain versions on the
    card: at N=128 in every mode - k = 1, 2, 4, 8; f32/bf16 state (K10),
    K4's four storage modes (K11/K12); rows on and off; field on and off;
    the first (y0 = 0) and the last (y0 = N - nl_y) y shard, and nl_y = k -
    then at the shapes and in the modes the main-path runs launch them."""
    n = 128
    for k in (1, 2, 4, 8):
        for dt in (torch.float32, torch.bfloat16):
            for rows in (True, False):
                for field in (False, True):
                    check_k10(32, n, k, 64, 64 if rows else 0, dt, rows,
                              field, errs)
            check_k10(32, n, k, k, n - k, dt, True, False, errs)
        for mname in COMP_MODES:
            for rows in (True, False):
                for field in (False, True):
                    check_comp("K11", 32, n, k, n, 0, mname, rows, field,
                               errs)
                    check_comp("K12", 64, n, k, 64, 64 if rows else 0,
                               mname, rows, field, errs)
            check_comp("K12", 64, n, k, k, n - k, mname, True, False, errs)
    # The pipeline's stress cases (csrc/comp_sharded.cu), every storage
    # mode, field and rows on and off: the deepest slab (bx = 64 = D, two
    # x segments) and the shallowest (bx = k: one segment of k planes) at
    # k = 4, two slabs of two segments at D = 128, k = 1, 3 and 8 at
    # bx = D; K12 with nl_y = k; and N = 200 on mesh 2,2,1 (D = 100,
    # ny = 100, bx = 20), whose z and y extents are no multiple of the
    # 24 x 24 face.
    stress = [(64, 4, 64), (64, 4, 4), (128, 4, 64), (64, 1, 64),
              (48, 3, 48), (64, 8, 64)]
    for mname in COMP_MODES:
        for rows in (True, False):
            for field in (False, True):
                for d, k, bx in stress:
                    check_comp("K11", d, n, k, n, 0, mname, rows, field, errs,
                               bx=bx)
                    check_comp("K12", d, n, k, 64, 0 if rows else 64, mname,
                               rows, field, errs, bx=bx)
                check_comp("K12", 64, n, 4, 4, n - 4, mname, rows, field,
                           errs, bx=64)
                check_comp("K12", 64, n, 8, 8, 40, mname, rows, field, errs,
                           bx=64)
                check_comp("K11", 100, 200, 4, 200, 0, mname, rows, field,
                           errs)
                check_comp("K12", 100, 200, 4, 100, 100 if rows else 0,
                           mname, rows, field, errs)
    # Main path: k=4 blocks with rows, the k=1 tail with rows, the
    # bootstrap (k=1 without rows; the flagship's on zero v and carry with
    # half the coefficient), and the lens forms without rows.
    mode = "f32v+bf16carry"
    d, nn, ny, y0 = XY_FULL
    dx, _, nyx, _ = X_FULL
    for k, rows, field in ((K, True, False), (1, True, False),
                           (1, False, False), (K, False, True),
                           (1, False, True)):
        check_k10(d, nn, k, ny, y0, torch.float32, rows, field, errs)
        check_comp("K11", dx, nn, k, nyx, 0, mode, rows, field, errs)
        check_comp("K12", d, nn, k, ny, y0, mode, rows, field, errs)
    for field in (False, True):
        check_comp("K11", dx, nn, 1, nyx, 0, mode, False, field, errs,
                   bootstrap=True)
        check_comp("K12", d, nn, 1, ny, y0, mode, False, field, errs,
                   bootstrap=True)
    torch.cuda.synchronize()


def run_cli(label):
    """One main-path run through the CLI with the counters zeroed just
    before and read just after; every counter must equal RUNS[label]'s
    count (0 when not listed).  Returns (sidecar dict, launches)."""
    n, flags, want = RUNS[label]
    argv = [str(n), "1", "1", "1", "1", "1", str(STEPS)] + flags
    out = os.path.join(OUT_DIR, label)
    stencil_cuda.reset_launches()
    rc = cli.main(argv + CLI_EXTRA + ["--out-dir", out])
    torch.cuda.synchronize()
    by_rows = rows_launches(stencil_cuda.launches)
    counts = kernel_launches(stencil_cuda.launches)
    if rc != 0:
        fail(f"{label}: CLI exit code {rc}")
    name = f"output_N{argv[0]}_Np1_CUDA"
    if not os.path.exists(os.path.join(out, name + ".txt")):
        fail(f"{label}: no report file")
    with open(os.path.join(out, name + ".json")) as f:
        side = json.load(f)
    print(f"  {label}: launches={counts} by face rows={by_rows} "
          f"max_abs_error={side['max_abs_error']!r} gcells_per_second="
          f"{side['gcells_per_second']!r} solve_seconds="
          f"{side['solve_seconds']!r}")
    expected = {c: want.get(c, 0) for c in counts}
    if counts != expected:
        fail(f"{label}: launches {counts}, expected {expected}")
    if label == "flagship" and by_rows.get(f"kstep_comp_r{FLAGSHIP_R}") \
            != NB:
        fail(f"flagship: its {NB} k=4 launches are not all at "
             f"R={FLAGSHIP_R}: {by_rows}")
    if label == "kfused" and by_rows != {f"kstep_pipe_r{KFUSED_R}": NB}:
        fail(f"kfused: its {NB} k=4 launches are not all at "
             f"R={KFUSED_R}: {by_rows}")
    errors_on = "--c2-field" not in flags
    if side["errors_computed"] != errors_on:
        fail(f"{label}: errors_computed {side['errors_computed']}")
    if not errors_on and side["run_config"]["c2_field"] != LENS:
        fail(f"{label}: sidecar c2_field {side['run_config']['c2_field']}")
    return side, counts


def run_api(label):
    """One main-path run through the sharded solvers' API with every shard
    on the card, the counters zeroed just before and read just after (as
    run_cli).  Returns (result, summary dict, launches)."""
    n, spec, want = API_RUNS[label]
    p = Problem(N=n, timesteps=STEPS)
    devices = [DEV] * SHARDS
    kw = {}
    if "field" in spec:
        kw = dict(c2tau2_field=stencil_ref.make_preset_c2tau2_field(
            p, spec["field"]), compute_errors=False)
    stencil_cuda.reset_launches()
    if "k" in spec and spec.get("scheme") == "compensated":
        res = kfused_comp.solve_kfused_comp_sharded(
            p, mesh_shape=spec["mesh"], k=spec["k"], devices=devices, **kw)
    elif "k" in spec:
        res = sharded_kfused.solve_sharded_kfused(
            p, mesh_shape=spec.get("mesh", (SHARDS, 1, 1)), k=spec["k"],
            devices=devices, **kw)
    else:
        res = sharded.solve_sharded(p, spec["mesh"], devices=devices,
                                    scheme=spec.get("scheme", "standard"),
                                    **kw)
    torch.cuda.synchronize()
    counts = kernel_launches(stencil_cuda.launches)
    side = {"max_abs_error": (float(res.abs_errors.max()) if not kw
                              else None),
            "gcells_per_second": res.gcells_per_second,
            "solve_seconds": res.solve_seconds,
            "init_seconds": res.init_seconds}
    print(f"  {label}: launches={counts} max_abs_error="
          f"{side['max_abs_error']!r} gcells_per_second="
          f"{side['gcells_per_second']!r} solve_seconds="
          f"{side['solve_seconds']!r}")
    expected = {c: want.get(c, 0) for c in counts}
    if counts != expected:
        fail(f"{label}: launches {counts}, expected {expected}")
    if not kw and not np.isfinite(res.abs_errors).all():
        fail(f"{label}: non-finite errors")
    return res, side, counts


def same_state(label, got, want, errors=None):
    """Fail unless the sharded result's states (and, given, its error
    vectors) equal the single-device result's bit for bit; returns the
    max |du| printed."""
    u_cur = got.u_cur.fundamental(DEV) if hasattr(got.u_cur, "blocks") \
        else got.u_cur
    u_prev = got.u_prev.fundamental(DEV) if hasattr(got.u_prev, "blocks") \
        else got.u_prev
    same = torch.equal(u_cur, want.u_cur) and torch.equal(u_prev,
                                                          want.u_prev)
    d = (u_cur.double() - want.u_cur.double()).abs().max().item()
    msg = f"  {label}: bitwise={same} max|du|={d:.3e}"
    if errors:
        same_e = (np.array_equal(got.abs_errors, want.abs_errors)
                  and np.array_equal(got.rel_errors, want.rel_errors))
        msg += f" errors bitwise={same_e}"
        same = same and same_e
    print(msg)
    if not same:
        fail(f"{label}: not bitwise equal")
    return d


def padded_planes_zero(label, res):
    n = res.problem.N
    full = res.u_cur.assemble(DEV)
    if full[n:].any() or full[:, n:].any() or full[:, :, n:].any():
        fail(f"{label}: a pad plane is nonzero")


def phase_contracts(api):
    """Bitwise k-fused == 1-step at full width (constant c and the lens),
    with the sharded k-fused marches (K8 on mesh 4,1,1, K10 on mesh 2,2,1,
    four shards on the card) equal to both, and compensated variable c
    nearer f64 than standard at N=128."""
    p = Problem(N=N_FULL, timesteps=STEPS)
    lens = stencil_ref.make_preset_c2tau2_field(p, LENS)
    for label, with_f in (("constant c", False), (LENS, True)):
        kw = dict(compute_errors=False, device=DEV,
                  c2tau2_field=lens if with_f else None)
        fused = kfused.solve_kfused(p, k=K, **kw)
        one = leapfrog.solve(p, **kw)
        same = (torch.equal(fused.u_cur, one.u_cur)
                and torch.equal(fused.u_prev, one.u_prev))
        d = (fused.u_cur - one.u_cur).abs().max().item()
        print(f"  k-fused == 1-step at N={N_FULL}/{STEPS} ({label}): "
              f"bitwise={same} max|du|={d:.3e}")
        if not same:
            fail(f"k-fused state differs from the 1-step state ({label})")
        for run in ("sharded_kfused_411", "sharded_kfused_221"):
            run += "_varc" if with_f else ""
            same_state(f"{run} == k-fused ({label})", api.pop(run), fused)
        if with_f:
            same_state(f"sharded_221_varc == 1-step ({label})",
                       api.pop("sharded_221_varc"), one)
        del fused, one
    small = Problem(N=128, timesteps=STEPS)
    lens = stencil_ref.make_preset_c2tau2_field(small, LENS)
    kw = dict(compute_errors=False, device=DEV)
    ref = leapfrog.solve(
        small, torch.float64, stencil_ref.make_variable_c_step(
            state.c2tau2_field(lens, torch.float64, DEV)), **kw).u_cur
    std = kfused.solve_kfused(small, k=K, c2tau2_field=lens, **kw).u_cur
    comp = kfused_comp.solve_kfused_comp(small, k=K, c2tau2_field=lens,
                                         **kw).u_cur
    e_std = (std.double() - ref).abs().max().item()
    e_comp = (comp.double() - ref).abs().max().item()
    print(f"  variable c at N=128/{STEPS} vs f64 plain: standard "
          f"{e_std!r}, compensated {e_comp!r}")
    if not e_comp < e_std:
        fail("the compensated variable-c state is not nearer f64")
    return {"varc_n128_err_vs_f64_standard": e_std,
            "varc_n128_err_vs_f64_compensated": e_comp}


def phase_sharded_contracts(api):
    """The sharded marches against the single-device ones through the API
    on the card, bit for bit: states, and the error vectors where both
    take them the same way."""
    out = {}
    p = Problem(N=N_FULL, timesteps=STEPS)
    one = leapfrog.solve(p, device=DEV)
    same_state("sharded_221 == 1-step (errors on)", api.pop("sharded_221"),
               one, errors=True)
    del one
    small = Problem(N=128, timesteps=STEPS)
    same_state("bf16 mesh 2,2,1 N=128 == 1-step",
               sharded.solve_sharded(small, (2, 2, 1), devices=[DEV] * 4,
                                     dtype=torch.bfloat16),
               leapfrog.solve(small, torch.bfloat16, device=DEV),
               errors=True)
    odd = Problem(N=N_ODD, timesteps=STEPS)
    one = leapfrog.solve(odd, device=DEV)
    k6 = sharded.solve_sharded(odd, (4, 1, 1), devices=[DEV] * 4)
    same_state(f"K6 mesh 4,1,1 N={N_ODD} == 1-step (errors on)", k6, one,
               errors=True)
    padded_planes_zero("K6 mesh 4,1,1", k6)
    del k6
    k9 = sharded_kfused.solve_sharded_kfused(odd, n_shards=1, k=K,
                                             devices=[DEV])
    d = same_state(f"uneven_kfused N={N_ODD} == 1-step", k9, one)
    de = float(np.max(np.abs(k9.abs_errors - one.abs_errors)))
    print(f"    its errors (in-kernel rows) vs 1-step: max|d|={de:.3e}")
    if de > 1e-6:
        fail("uneven_kfused errors differ from the 1-step errors by > 1e-6")
    del k9
    k9 = api.pop("sharded_uneven_411")
    same_state("sharded_uneven_411 == 1-step", k9, one)
    padded_planes_zero("sharded_uneven_411", k9)
    del k9, one
    # A last shard with fewer real planes than k: N=50 over 4 shards at
    # k=4 leaves it r=2 (the two-hop seam windows).
    tiny = Problem(N=50, timesteps=STEPS)
    bx, dd, r = sharded_kfused.uneven_layout(tiny, K, 4)
    same_state(f"r={r} < k={K} (N=50, D={dd}, mesh 4,1,1) == 1-step",
               sharded_kfused.solve_sharded_kfused(tiny, n_shards=4, k=K,
                                                   devices=[DEV] * 4),
               leapfrog.solve(tiny, device=DEV))
    comp = api.pop("sharded_comp_221")
    single = leapfrog.solve_compensated(p, device=DEV)
    got = comp.u_cur.fundamental(DEV)
    bitwise = (torch.equal(got, single.u_cur)
               and torch.equal(comp.comp_carry.fundamental(DEV),
                               single.comp_carry))
    d = (got - single.u_cur).abs().max().item()
    out["sharded_comp_221_vs_single"] = {
        "bitwise": bitwise, "max_abs_du": d,
        "max_abs_error": float(comp.abs_errors.max()),
        "single_max_abs_error": float(single.abs_errors.max())}
    print(f"  sharded_comp_221 vs 1-step compensated: bitwise={bitwise} "
          f"max|du|={d:.3e}; max abs error {comp.abs_errors.max()!r} vs "
          f"{single.abs_errors.max()!r}")
    if not (bitwise or d <= 2e-7):
        fail("sharded_comp_221 is not within 2e-7 of the 1-step "
             "compensated state")
    if not comp.abs_errors.max() < ERROR_CLASS["sharded_comp_221"]:
        fail("sharded_comp_221 is out of the compensated error class")
    return out


def phase_flagship_contracts(api, sides):
    """The distributed flagships against the single-device flagship at
    full width, constant c with errors and the lens: bit for bit on mesh
    4,1,1 (u and the carry: K11 runs K4's op sequence, the shard's
    default slab being the global one), within 1e-6 on mesh 2,2,1 (K12's
    carry is zero on the y ghost rows too).  flagship_mesh, the
    distributed flagship on one shard through the CLI (K11), must report
    the flagship's error bits."""
    fm, fl = (sides[x]["max_abs_error"] for x in ("flagship_mesh",
                                                   "flagship"))
    print(f"  flagship_mesh max abs error {fm!r}, flagship {fl!r}")
    if fm != fl:
        fail(f"flagship_mesh max abs error {fm!r} is not the flagship's "
             f"{fl!r}")
    out = {"flagship_mesh_vs_flagship": {"max_abs_error": fm,
                                         "flagship_max_abs_error": fl}}
    p = Problem(N=N_FULL, timesteps=STEPS)
    lens = stencil_ref.make_preset_c2tau2_field(p, LENS)
    for label, kw in (("", {}), ("_varc", dict(c2tau2_field=lens,
                                                compute_errors=False))):
        single = kfused_comp.solve_kfused_comp(p, k=K, device=DEV, **kw)
        for mesh in ("411", "221"):
            run = f"sharded_flagship_{mesh}{label}"
            res = api.pop(run)
            u = res.u_cur.fundamental(DEV)
            bitwise = (torch.equal(u, single.u_cur) and torch.equal(
                res.comp_carry.fundamental(DEV), single.comp_carry))
            d = (u - single.u_cur).abs().max().item()
            rec = {"bitwise": bitwise, "max_abs_du": d}
            if not label:
                rec["max_abs_d_abs_errors"] = float(np.max(np.abs(
                    res.abs_errors - single.abs_errors)))
            out[f"{run}_vs_flagship{label}"] = rec
            print(f"  {run} vs flagship{label}: "
                  f"{'bitwise' if bitwise else f'max|du|={d!r}'} {rec}")
            if mesh == "411" and not bitwise:
                fail(f"{run} is not bitwise equal to the single-device "
                     f"flagship (max |du| {d!r})")
            if not (bitwise or d <= 1e-6):
                fail(f"{run} is not within 1e-6 of the single-device "
                     f"flagship (max |du| {d!r})")
            del res, u
        del single
    return out


def phase_agree():
    """Every solver at a small size: card vs CPU (plain versions)."""
    small = Problem(N=32, timesteps=21)
    lens = stencil_ref.make_preset_c2tau2_field(small, LENS)
    varc = dict(c2tau2_field=lens, compute_errors=False)
    for label, fn in (
        ("standard", lambda d: leapfrog.solve(small, device=d)),
        ("flagship", lambda d: kfused_comp.solve_kfused_comp(
            small, k=K, device=d)),
        ("kfused", lambda d: kfused.solve_kfused(small, k=K, device=d)),
        ("varc", lambda d: leapfrog.solve(small, device=d, **varc)),
        ("kfused_varc", lambda d: kfused.solve_kfused(
            small, k=K, device=d, **varc)),
        ("flagship_varc", lambda d: kfused_comp.solve_kfused_comp(
            small, k=K, device=d, **varc)),
        ("sharded", lambda d: sharded.solve_sharded(
            small, (2, 2, 1), devices=[d] * 4)),
        ("sharded_comp", lambda d: sharded.solve_sharded(
            small, (2, 2, 1), devices=[d] * 4, scheme="compensated")),
        ("sharded_kfused", lambda d: sharded_kfused.solve_sharded_kfused(
            small, n_shards=4, k=K, devices=[d] * 4)),
        ("sharded_uneven", lambda d: sharded_kfused.solve_sharded_kfused(
            small, n_shards=3, k=K, devices=[d] * 3)),
        ("sharded_kfused_xy", lambda d: sharded_kfused.solve_sharded_kfused(
            small, mesh_shape=(2, 2, 1), k=K, devices=[d] * 4)),
        ("sharded_flagship_x", lambda d: kfused_comp.solve_kfused_comp_sharded(
            small, n_shards=4, k=K, devices=[d] * 4)),
        ("sharded_flagship_xy",
         lambda d: kfused_comp.solve_kfused_comp_sharded(
             small, mesh_shape=(2, 2, 1), k=K, devices=[d] * 4)),
    ):
        gpu, cpu = fn(DEV), fn("cpu")
        if hasattr(gpu.u_cur, "blocks"):
            gpu.u_cur, cpu.u_cur = gpu.u_cur.assemble(), cpu.u_cur.assemble()
        d = (gpu.u_cur.cpu().double() - cpu.u_cur.double()).abs().max().item()
        de = float(np.max(np.abs(gpu.abs_errors - cpu.abs_errors)))
        print(f"  {label} N=32: card vs cpu max|du|={d:.3e} "
              f"max|d abs_err|={de:.3e}")
        if not (np.isfinite(gpu.abs_errors).all() and d <= 1e-5
                and de <= 1e-5):
            fail(f"{label}: card and CPU disagree at N=32")


def time_launches(fn, reps, warmup=2):
    """Device time (ms) of one call: CUDA events around `reps` calls
    enqueued back to back, divided by `reps`; the median of three such
    runs.  Enqueued back to back, as the solvers enqueue them, the calls'
    host work (operand checks, allocation) overlaps the device's, so the
    time is the device's and not the host's."""
    for _ in range(warmup):
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


def phase_times(dev_name):
    n = N_FULL
    p = Problem(N=n, timesteps=STEPS)
    cells = n ** 3
    rate = obs_perf.hbm_gbps(dev_name) * 1e9
    up, u = field(n, 1), field(n, 2)
    v, cy = field(n, 6, 1e-3), field(n, 7, 1e-8)
    fld = c2_field(p, 8)
    kw1 = dict(inv_h2=p.inv_h2, alpha=2.0, beta=1.0, coeff=p.a2tau2)
    kw5 = dict(inv_h2=p.inv_h2, c2tau2_field=fld)
    _, syz, rsyz, sxct = oracle_inputs(n, K)
    _, syz1, rsyz1, sxct1 = oracle_inputs(n, 1)
    cb = cy.to(torch.bfloat16)
    kw4 = dict(k=K, coeff=p.a2tau2, inv_h2=p.inv_h2)
    kw41 = dict(k=1, coeff=p.a2tau2, inv_h2=p.inv_h2)
    # K3f and K4f as their main-path runs launch them: rows off.
    kw3f = dict(kw4, c2tau2_field=fld, with_errors=False)
    kw4f = dict(kw3f, block_x=stencil_cuda.default_block_x(n, K))
    # The error pass as the march launches it: into zeroed slots of the
    # error vectors (later launches fold into what the first left there:
    # the same reads and the same work).
    eargs = error_pass_inputs(n, torch.float32)
    slots = torch.zeros((2, 1), device=DEV)
    eout = (slots[0, 0], slots[1, 0])
    # (kernel, plain version, f32 operations per cell the function needs:
    # K1 14 for the Laplacian + 5 for the update, K5 the same, K2 14 + 6;
    # per substep K3 14 + 5 + 3 for the error rows, K3f 14 + 5, K4
    # 14 + 6 + 3, K4f 14 + 6; the error pass 2 multiplies, a subtraction,
    # two absolute values, a division and two maxima.)
    runs = {
        "K1": (lambda: stencil_cuda.fused_step(up, u, **kw1),
               lambda: stencil_cuda.fused_step_plain(up, u, **kw1), 19),
        "K2": (lambda: stencil_cuda.compensated_step(u, v, cy, p),
               lambda: stencil_cuda.compensated_step_plain(
                   u, v, cy, inv_h2=p.inv_h2, coeff=p.a2tau2), 20),
        "K3": (lambda: stencil_cuda.fused_kstep(up, u, syz, rsyz, sxct,
                                                **kw4),
               lambda: stencil_cuda.fused_kstep_plain(up, u, syz, rsyz, sxct,
                                                      **kw4), 22 * K),
        "K3f": (lambda: stencil_cuda.fused_kstep(up, u, None, None, None,
                                                 **kw3f),
                lambda: stencil_cuda.fused_kstep_plain(
                    up, u, None, None, None, **kw3f), 19 * K),
        "K4": (lambda: stencil_cuda.fused_kstep_comp(
                   u, v, cb, syz, rsyz, sxct, **kw4),
               lambda: stencil_cuda.fused_kstep_comp_plain(
                   u, v, cb, syz, rsyz, sxct,
                   block_x=stencil_cuda.default_block_x(n, K), **kw4),
               23 * K),
        "K4f": (lambda: stencil_cuda.fused_kstep_comp(
                    u, v, cb, syz, rsyz, sxct, **kw4f),
                lambda: stencil_cuda.fused_kstep_comp_plain(
                    u, v, cb, syz, rsyz, sxct, **kw4f), 20 * K),
        "K5": (lambda: stencil_cuda.fused_step(up, u, **kw5),
               lambda: stencil_cuda.fused_step_plain(up, u, **kw5), 19),
        "errors": (lambda: stencil_cuda.layer_errors(*eargs, eout),
                   lambda: oracle.separable_layer_errors(*eargs, eout), 8),
    }
    times = {}
    for name, (kern, plain, ops) in runs.items():
        ms = time_launches(kern, 20)
        plain_ms = time_launches(plain, 3, warmup=1)
        n_cells = (n - 1) ** 3 if name == "errors" else cells
        byte_ms = KERNELS[name]["bytes_per_cell"] * n_cells / rate * 1e3
        op_ms = ops * n_cells / F32_OPS_PER_S * 1e3
        times[name] = dict(ms=ms, plain_ms=plain_ms,
                           bound_ms=max(byte_ms, op_ms),
                           bound_by="bytes" if byte_ms >= op_ms
                           else "operations")
        print(f"  {name} N={n}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
              f"bound {times[name]['bound_ms']:.4f} ms by "
              f"{times[name]['bound_by']})")
    k1_ms = time_launches(lambda: stencil_cuda.fused_kstep_comp(
        u, v, cb, syz1, rsyz1, sxct1, **kw41), 20)
    times["K4"]["ms_k1"] = k1_ms
    print(f"  K4 N={n} k=1 (the tail): {k1_ms:.4f} ms "
          f"(bound {20 * cells / rate * 1e3:.4f} ms by bytes)")
    times["K1"].update(k1_in_march())
    del up, u, v, cy, cb, fld, eargs
    times.update(phase_times_sharded(rate))
    guard_times(times)
    return times, rate


def k1_in_march(layers=300):
    """K1's device time a launch inside a 1-step march at N=512, f32: CUDA
    events around each K1 launch of `layers` layers, the median; once with
    the error kernel between the launches, as the default path runs, and
    once with its plain version there.  Whether the pass beside K1 moves
    K1's own time, untraced (a profiler adds its own cost to each
    kernel)."""
    p = Problem(N=N_FULL, timesteps=layers + 1)
    dev = torch.device(DEV)
    out = {}
    for label, kernel in (("march_ms", "pallas"),
                          ("march_ms_plain_errors", "roll")):
        errors = leapfrog.error_fn(p, torch.float32, dev, kernel=kernel)
        u_prev = leapfrog.initial_layer0(p, device=dev)
        u = leapfrog.step_layer1(u_prev, stencil_cuda.leapfrog_step, p,
                                 torch.float32)
        vec = torch.zeros((2, layers + 2), device=dev)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(layers)]
        for i, (a, b) in enumerate(events):
            a.record()
            u_next = stencil_cuda.leapfrog_step(u_prev, u, p)
            b.record()
            errors(u_next, i + 2, (vec[0, i + 2], vec[1, i + 2]))
            u_prev, u = u, u_next
        torch.cuda.synchronize()
        out[label] = statistics.median(a.elapsed_time(b) for a, b in events)
        del u_prev, u, u_next
    print(f"  K1 in a {layers}-layer march: {out['march_ms']:.4f} ms a "
          f"launch beside the error kernel, "
          f"{out['march_ms_plain_errors']:.4f} ms beside its plain version")
    return out


def guard_times(times):
    """Each pipeline kernel's time against its cone predecessor's, and
    against its own recorded time: fail if it is more than GUARD_SLACK
    over."""
    for name, cone in CONE_MS.items():
        ms = times[name]["ms"]
        line = (f"  {name} k=4: {ms:.4f} ms; the cone kernel's {cone:.4f} "
                f"ms ({cone / ms:.2f}x faster)")
        if name in GUARD_MS:
            line += (f"; recorded {GUARD_MS[name]:.4f} ms "
                     f"({100 * (ms / GUARD_MS[name] - 1):+.1f}%)")
        if "ms_k1" in times[name]:
            line += f"; k=1: {times[name]['ms_k1']:.4f} ms"
        print(line)
    for name, recorded in GUARD_MS.items():
        ms = times[name]["ms"]
        if ms > (1 + GUARD_SLACK) * recorded:
            fail(f"{name} times {ms:.4f} ms, more than "
                 f"{100 * GUARD_SLACK:.0f}% over the {recorded:.4f} ms "
                 f"recorded in PERF.md")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def phase_times_sharded(rate):
    """K6-K9 at the shapes the main-path runs launch them, f32.  The bound
    counts every input read once and every output written once - the
    block, its ghosts, the field and the oracle rows - against the f32
    operations per cell (K6 as K1, K7 as K2, K8/K9 as K3 per substep)."""
    times, k1_ms, rows_off = {}, {}, {}
    k6_block = K6_BLOCKS_FULL[0]
    runs = {}
    for name, field in (("K6", False), ("K6f", True)):
        args, kw = k6_args(k6_block, torch.float32, 70, field)
        ins = list(args[:2]) + [x for g in args[2][:2] for x in g] + [
            kw["c2tau2_block"]]
        runs[name] = (
            lambda a=args, k=kw: stencil_cuda.sharded_fused_step(*a, **k),
            lambda a=args, k=kw: stencil_cuda.sharded_fused_step_plain(
                *a, **k),
            nbytes(*ins, args[1]), 19 * args[1].numel())
    (_, u, g, offsets, n), kw = k6_args(k6_block, torch.float32, 80)
    kw.pop("c2tau2_block")
    v, c = rand(u.shape, 81, 1e-3), rand(u.shape, 82, 1e-8)
    k7 = (u, v, c, g, offsets, n)
    runs["K7"] = (
        lambda k=kw: stencil_cuda.sharded_compensated_step(*k7, **k),
        lambda k=kw: stencil_cuda.sharded_compensated_step_plain(*k7, **k),
        2 * nbytes(u, v, c) + nbytes(*(x for gg in g[:2] for x in gg)),
        20 * u.numel())
    k8, k9, k9_4 = chain_shapes()
    for name, d, nn, n_real, rows, field in (
            k8 + (True, False), ("K8f",) + k8[1:] + (False, True),
            k9 + (True, False), ("K9f",) + k9_4[1:] + (False, True)):
        args, kw = chain_args(d, nn, K, n_real, torch.float32, 90, field)
        kw["with_errors"] = rows
        if name.startswith("K8"):
            fn = stencil_cuda.fused_kstep_sharded
            plain = stencil_cuda.fused_kstep_sharded_plain
        else:
            fn = (lambda *a, _n=n_real, **k:
                  stencil_cuda.fused_kstep_padded(a[0], a[1], _n, *a[2:],
                                                  **k))
            plain = (lambda *a, _n=n_real, **k:
                     stencil_cuda.fused_kstep_padded_plain(
                         a[0], a[1], _n, *a[2:], **k))
        state = list(args[:2]) + [x for g in args[2:4] for x in g]
        planes = list(args[4:]) if rows else []
        fld = ([kw["c2tau2_block"], *kw["c2_ghosts"]] if field else [])
        out_bytes = 2 * nbytes(args[1]) + (2 * nbytes(args[6]) if rows
                                           else 0)
        ops = (22 if rows else 19) * K * args[1].numel()
        runs[name] = (lambda a=args, k=kw, f=fn: f(*a, **k),
                      lambda a=args, k=kw, f=plain: f(*a, **k),
                      nbytes(*state, *planes, *fld) + out_bytes, ops)
    # K10-K12 on the main-path blocks (K10/K12: the y = 256 shard of mesh
    # 2,2,1, extended to 264 rows; K11: a mesh-4,1,1 block): k=4, K10 and
    # K12 with rows, the field forms without, f32 u/v and a bf16 carry.
    d, nn, ny, y0 = XY_FULL
    for name, rows, field in (("K10", True, False), ("K10f", False, True)):
        p, planes, sxct, py = plane_case(d, nn, K, ny, y0)
        up, u = rand((d, py, nn), 200), rand((d, py, nn), 201)
        gh = [rand((K, py, nn), 202 + i) for i in range(4)]
        fld, fg = c2_chain(p, d, K, py, 206) if field else (None, None)
        args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), *planes, sxct, y0, nn)
        kw = dict(k=K, nl_y=ny, coeff=p.a2tau2, inv_h2=p.inv_h2,
                  c2tau2_ext=fld, c2_ghosts=fg, with_errors=rows)
        ins = [up, u, *gh] + ([*planes, sxct] if rows else []) + (
            [fld, *fg] if field else [])
        cells = d * ny * nn
        if rows:
            rows_off[name] = (
                lambda a=args, k=dict(kw, with_errors=False):
                stencil_cuda.fused_kstep_sharded_xy(*a, **k))
        runs[name] = (
            lambda a=args, k=kw: stencil_cuda.fused_kstep_sharded_xy(*a, **k),
            lambda a=args, k=kw: stencil_cuda.fused_kstep_sharded_xy_plain(
                *a, **k),
            nbytes(*ins) + 8 * cells + (8 * K * d if rows else 0),
            (22 if rows else 19) * K * cells)
    for name, rows, field in (("K11", True, False), ("K11f", False, True),
                              ("K12", True, False), ("K12f", False, True)):
        dd, n_, nyy, yy = X_FULL if name.startswith("K11") else XY_FULL
        kern, plain, args, fld, fg = comp_call(
            name, dd, n_, K, nyy, yy, COMP_MODES["f32v+bf16carry"], rows,
            field, seed=210)
        u, v, c, gu, gv = args[:5]
        ins = [u, v, c, *gu, *gv] + (list(args[5:]) if rows else []) + (
            [fld, *fg] if field else [])
        cells = dd * nyy * n_
        runs[name] = (kern, plain,
                      nbytes(*ins) + 10 * cells + (8 * K * dd if rows else 0),
                      (23 if rows else 20) * K * cells)
        # The k=1 launch of the same run (the tail; the bootstrap without
        # rows), timed beside the k=4 one.
        kern1 = comp_call(name, dd, n_, 1, nyy, yy,
                          COMP_MODES["f32v+bf16carry"], rows, field,
                          seed=230)[0]
        k1_ms[name] = time_launches(kern1, 20)
        if rows:
            rows_off[name] = comp_call(name, dd, n_, K, nyy, yy,
                                       COMP_MODES["f32v+bf16carry"], False,
                                       field, seed=210)[0]
    for name, (kern, plain, nb, ops) in runs.items():
        ms = time_launches(kern, 20)
        plain_ms = time_launches(plain, 3, warmup=1)
        byte_ms = nb / rate * 1e3
        op_ms = ops / F32_OPS_PER_S * 1e3
        times[name] = dict(ms=ms, plain_ms=plain_ms,
                           bound_ms=max(byte_ms, op_ms),
                           bound_by="bytes" if byte_ms >= op_ms
                           else "operations", bytes=nb)
        print(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
              f"{times[name]['bound_ms']:.4f} ms by {times[name]['bound_by']}"
              f", {nb} bytes)")
        if name in k1_ms:
            times[name]["ms_k1"] = k1_ms[name]
            print(f"  {name} k=1: {k1_ms[name]:.4f} ms")
        if name in rows_off:
            # The same launch with rows off, as the phase-timing probes
            # run it (phase 7).
            times[name]["ms_rows_off"] = time_launches(rows_off[name], 20)
            print(f"  {name} rows off: {times[name]['ms_rows_off']:.4f} ms")
    times["K6"].update(k6_solo_old_vs_new(k6_block))
    times["K6"]["face_ab"] = {
        label: k6_solo_old_vs_new(face, reps=100)
        for label, face in k6_face_blocks(k6_block)}
    # The k-block exchange of one field over the four shards, apart from
    # the kernels: mesh 2,2,1 (y extension by K rows, then the x windows of
    # the extended blocks) and mesh 4,1,1 (x windows only).
    for label, shape, blk in (("exchange_221", (2, 2, 1), (d, ny, nn)),
                              ("exchange_411", (SHARDS, 1, 1),
                               X_FULL[:3])):
        mesh = build_mesh(shape, [DEV] * SHARDS)
        blocks = [rand(blk, 300 + i) for i in range(SHARDS)]
        ms = time_launches(lambda b=blocks, m=mesh:
                           sharded_kfused.exchange(b, m, K), 10)
        ext, wins = sharded_kfused.exchange(blocks, mesh, K)
        moved = 2 * nbytes(*(ext if shape[1] > 1 else []),
                           *(w for pair in wins for w in pair))
        times[label] = dict(ms=ms, bytes=moved)
        print(f"  {label} (one field, {SHARDS} shards, depth {K}): "
              f"{ms:.4f} ms, {moved} bytes read and written")
        del blocks, ext, wins
    return times


def k6_face_blocks(block):
    """The overlap mode's one-plane face blocks of a mesh-2,2,1 shard
    block (solver/sharded.py `patch`): (label, block) for its x and y
    faces at q = 0."""
    label, mesh, n, shape, r_last, offsets = block
    out = []
    for axis in range(2):
        face = list(shape)
        face[axis] = 1
        out.append((f"{'xy'[axis]} face {tuple(face)}",
                    (label, mesh, n, tuple(face), r_last, offsets)))
    return out


def k6_solo_old_vs_new(block, reps=20):
    """The solo K6 at constant speed (`sharded_fused_step`: the
    x-streaming kernel on one lane where `k6_solo_streams` says so, else
    the one-thread-per-cell body) against the one-thread-per-cell body
    alone (tile_ab.k6_solo_old) on `block`: the old body held bitwise
    against the plain version, then timed old, new, new, old
    (time_launches each, `reps` launches)."""
    args, kw = k6_args(block, torch.float32, 70)
    kw.pop("c2tau2_block")
    streams = stencil_cuda.k6_solo_streams(args[1].shape)

    def new():
        return stencil_cuda.sharded_fused_step(*args, **kw)

    def old():
        return tile_ab.k6_solo_old(*args, **kw)
    check_outputs("K6 old solo body", [old()],
                  [stencil_cuda.sharded_fused_step_plain(*args, **kw)], [])
    runs = [time_launches(f, reps) for f in (old, new, new, old)]
    old_ms, new_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    print(f"  K6 {tuple(args[1].shape)} (streams: {streams}) old, new, "
          f"new, old: {', '.join(f'{r:.4f}' for r in runs)} ms; new / old "
          f"{new_ms / old_ms:.3f} ({smi()})")
    return dict(old_body_ms=old_ms, ab_ms=new_ms, ab_runs=runs,
                streams=streams)


# Phase 7: the measurement slice.  The CLI runs' solve times recorded in
# PERF.md (§5; default and sharded since the error kernel, §6) (NVIDIA
# H100 80GB HBM3, 700.00 W): phase 7 fails
# if one of this run's phase-3 CLI runs is more than RUN_SLACK over, which
# would show that record_solve, the spans or the memory sample cost
# something per step.
RUN_S = {"default": 0.8804647000000045, "flagship": 1.1683708649999858,
         "kfused": 1.1246251889999996, "varc": 0.7651891879999937,
         "kfused_varc": 1.005125410000005,
         "flagship_varc": 1.064270434000008,
         "uneven_kfused": 1.0255811730000062, "sharded": 0.872170331999996,
         "flagship_mesh": 1.155902287999993}
RUN_SLACK = 0.08
# The phase-timing probes: (label, measure_phase_breakdown arguments, the
# phase-6 kernel that the probe's k-blocks (steps) launch on each shard,
# the copies of one k-block: their time's name and how many times a
# k-block makes them).  The probes run rows off, so they are held against
# the kernels' rows-off times where the kernel has rows.  A probe's loop
# lies between its kernels' time and its kernels' plus its copies' time,
# each widened by PROBE_SLACK: the small copies' time, timed alone, is
# the host's, which the kernels' device time hides in the probe.
PROBES = (
    ("1step_221", dict(mesh_shape=(2, 2, 1)), "K6", "ghosts_221", 1),
    ("kfused_221", dict(mesh_shape=(2, 2, 1), fuse_steps=K), "K10",
     "exchange_221", 2),
    ("flagship_411", dict(mesh_shape=(4, 1, 1), fuse_steps=K,
                          scheme="compensated"), "K11", "exchange_411", 2),
)
PROBE_SLACK = 0.10


def prom_samples(path):
    """{sample with labels: value} of a Prometheus text file."""
    out = {}
    for line in open(path):
        if line.strip() and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value.replace("+Inf", "inf"))
    return out


def phase_overlap(ref221, card):
    """--overlap on the sharded API: mesh 2,2,1 at N=512 / 1000 steps
    against phase 3's serial sharded_221 bit for bit (states and error
    vectors), and mesh 2,2,2 with the lens (K6f) over the first 100 of the
    1000 steps against its
    serial run."""
    p = Problem(N=N_FULL, timesteps=STEPS)
    stencil_cuda.reset_launches()
    ovl = sharded.solve_sharded(p, (2, 2, 1), devices=[DEV] * SHARDS,
                                overlap=True)
    torch.cuda.synchronize()
    # K6 on every block, then on its four face planes (x and y), per step.
    if stencil_cuda.launches["sharded_step"] != 5 * SHARDS * STEPS:
        fail(f"overlap_221: K6 launches {stencil_cuda.launches}")
    same = all(torch.equal(a, b) for x, y in (
        (ovl.u_cur, ref221.u_cur), (ovl.u_prev, ref221.u_prev))
        for a, b in zip(x.blocks, y.blocks))
    same_e = (np.array_equal(ovl.abs_errors, ref221.abs_errors)
              and np.array_equal(ovl.rel_errors, ref221.rel_errors))
    print(f"  overlap_221 N={N_FULL}/{STEPS}: states bitwise={same}, "
          f"errors bitwise={same_e}; solve {ovl.solve_seconds!r} s, serial "
          f"{ref221.solve_seconds!r} s ({card})")
    if not (same and same_e):
        fail("overlap_221 is not bitwise the serial sharded_221")
    out = {"overlap_221_solve_seconds": ovl.solve_seconds,
           "serial_221_solve_seconds": ref221.solve_seconds}
    del ovl
    # The first 100 of the 1000 steps (tau as in every run; 100 steps of
    # T = 1 would break the Courant bound).
    p = Problem(N=N_FULL, timesteps=STEPS)
    lens = stencil_ref.make_preset_c2tau2_field(p, LENS)
    kw = dict(devices=[DEV] * 8, c2tau2_field=lens, compute_errors=False,
              stop_step=100)
    ser = sharded.solve_sharded(p, (2, 2, 2), **kw)
    ovl = sharded.solve_sharded(p, (2, 2, 2), overlap=True, **kw)
    same = all(torch.equal(a, b) for x, y in (
        (ovl.u_cur, ser.u_cur), (ovl.u_prev, ser.u_prev))
        for a, b in zip(x.blocks, y.blocks))
    if not all(torch.isfinite(b).all() for b in ovl.u_cur.blocks):
        fail("overlap_222_lens: non-finite state")
    print(f"  overlap_222_lens N={N_FULL}, steps 1-100: bitwise={same}; solve "
          f"{ovl.solve_seconds!r} s, serial {ser.solve_seconds!r} s ({card})")
    if not same:
        fail("overlap_222_lens is not bitwise its serial run")
    out.update(overlap_222_lens_solve_seconds=ovl.solve_seconds,
               serial_222_lens_solve_seconds=ser.solve_seconds)
    return out


def ghost_copies_ms():
    """Device time (ms) of one step's ghost copies in the 1-step probe's
    exchange-free variant: `sharded._self_ghosts` of the four mesh-2,2,1
    blocks at N=512."""
    _, shape, n, blk = K6_BLOCKS_FULL[0][:4]
    topo = Topology(N=n, mesh_shape=shape)
    blocks = [rand(blk, 400 + i) for i in range(SHARDS)]
    return time_launches(
        lambda: [sharded._self_ghosts(b, topo) for b in blocks], 20)


def phase_probes(times, card):
    """The phase-timing probes at N=512, iters=10: each probe's loop (its
    exchange-free march extrapolated to 1000 steps) between phase 6's time
    per launch (rows off) x the launches those steps make, less
    PROBE_SLACK, and that plus the time of the copies they make, more
    PROBE_SLACK; and a non-negative exchange."""
    p = Problem(N=N_FULL, timesteps=STEPS)
    copies = dict(times, ghosts_221=dict(ms=ghost_copies_ms()))
    out = {}
    for label, kw, kern, copy, per_block in PROBES:
        n_dev = kw["mesh_shape"][0] * kw["mesh_shape"][1]
        pb = timing.measure_phase_breakdown(p, devices=[DEV] * n_dev,
                                            iters=10, **kw)
        blocks = STEPS // kw.get("fuse_steps", 1)
        kern_ms = times[kern].get("ms_rows_off", times[kern]["ms"])
        copy_ms = copies[copy]["ms"]
        lo = kern_ms * n_dev * blocks / 1e3
        hi = lo + copy_ms * per_block * blocks / 1e3
        print(f"  probe {label}: loop_seconds={pb.loop_seconds!r} "
              f"exchange_seconds={pb.exchange_seconds!r} (steps "
              f"{pb.steps_measured}); {kern} {kern_ms:.4f} ms x {n_dev} x "
              f"{blocks} = {lo:.4f} s (ratio {pb.loop_seconds / lo:.3f}), "
              f"+ {copy} {copy_ms:.4f} ms x {per_block} x {blocks} = "
              f"{hi:.4f} s (ratio {pb.loop_seconds / hi:.3f}) ({card})")
        if not (pb.exchange_seconds >= 0
                and lo * (1 - PROBE_SLACK) <= pb.loop_seconds
                <= hi * (1 + PROBE_SLACK)):
            fail(f"probe {label}: loop {pb.loop_seconds} s outside "
                 f"[{lo}, {hi}] s of {kern} and {copy} +-{PROBE_SLACK}, "
                 f"exchange {pb.exchange_seconds}")
        out[label] = dict(loop_seconds=pb.loop_seconds,
                          exchange_seconds=pb.exchange_seconds,
                          steps_measured=pb.steps_measured,
                          kernel_ms=kern_ms, copies_ms=copy_ms,
                          kernel_seconds=lo, kernel_and_copies_seconds=hi)
    return out


def phase_telemetry(card):
    """The flagship through the CLI with --telemetry-dir and --profile:
    the solve span, a heartbeat, the roofline gauge in (0, 1.05], the
    allocator peak, and K4's kernel in the profiler's trace."""
    tel = os.path.join(OUT_DIR, "telemetry")
    prof = os.path.join(OUT_DIR, "profile")
    argv = [str(N_FULL), "1", "1", "1", "1", "1", str(STEPS), "--scheme",
            "compensated", "--fuse-steps", str(K), "--out-dir",
            os.path.join(OUT_DIR, "flagship_traced"), "--telemetry-dir",
            tel, "--profile", prof]
    # The allocator peak of this run, not of the phases before it.
    torch.cuda.reset_peak_memory_stats()
    if cli.main(argv + CLI_EXTRA) != 0:
        fail("the traced flagship run failed")
    spans = [json.loads(line) for line in
             open(os.path.join(tel, "trace.jsonl"))]
    solve = [r for r in spans if r["kind"] == "cli.solve"]
    if len(solve) != 1 or solve[0]["attrs"].get("final_step") != STEPS:
        fail(f"trace.jsonl holds no finished solve span: {spans}")
    if not os.path.exists(os.path.join(tel, "heartbeat.jsonl")):
        fail("no heartbeat.jsonl")
    prom = prom_samples(os.path.join(tel, "metrics.prom"))
    frac = prom.get('wavetpu_solve_roofline_fraction{path="kfused_comp"}')
    peak = prom.get('wavetpu_device_peak_bytes{context="solve"}')
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"  traced flagship: solve span {solve[0]['dur_s']!r} s, "
          f"roofline_fraction {frac!r} (model "
          f"{solve[0]['attrs'].get('model_gbps')!r} GB/s of "
          f"{obs_perf.peak_gbps()} GB/s), allocator peak {peak!r} B of "
          f"{total} B ({card})")
    if frac is None or not 0 < frac <= 1.05:
        fail(f"roofline fraction {frac}")
    if peak is None or not 0 < peak < total:
        fail(f"allocator peak {peak}")
    ops = json.load(open(os.path.join(prof, obs_perf.OPS_FILENAME)))
    k4 = sum(o["count"] for o in ops
             if "kstep_comp_pipe_kernel" in o["name"])
    print(f"  profiler trace: K4 (kstep_comp_pipe_kernel) x{k4}; top "
          f"operations by device time ({card}):")
    print(obs_perf.format_ops(ops, 12))
    if k4 < NB + REM:
        fail(f"the profiler trace shows K4 x{k4}, not >= {NB + REM}")
    return {"flagship_roofline_fraction": frac,
            "flagship_peak_bytes": peak, "profiled_k4_launches": k4,
            "top_device_ops": ops[:12]}


def phase_trace_default(card):
    """The reference's default CLI solve (N=512 / 1000 steps, errors on)
    under --profile: where its device time goes, kernel by kernel, and the
    device's busy share over the traced window."""
    prof = os.path.join(OUT_DIR, "profile_default")
    argv = [str(N_FULL), "1", "1", "1", "1", "1", str(STEPS), "--out-dir",
            os.path.join(OUT_DIR, "default_traced"), "--profile", prof]
    if cli.main(argv + CLI_EXTRA) != 0:
        fail("the traced default run failed")
    tk = obs_perf.trace_kernels(os.path.join(prof, obs_perf.TRACE_FILENAME))
    top = sorted(tk["kernels"].items(), key=lambda kv: -kv[1]["ms"])
    print(f"  traced default: {tk['kernel_ms']:.1f} ms of kernels in a "
          f"{tk['span_ms']:.1f} ms window, device busy {tk['busy']:.3f} "
          f"({card}); kernels by device time:")
    for name, row in top[:12]:
        print(f"    {row['ms']:10.3f} ms  x{row['count']:<5d} "
              f"{name[:90]}")
    k1 = sum(r["count"] for n, r in top if "step_kernel" in n
             and "comp" not in n and "sharded" not in n)
    if k1 != STEPS:
        fail(f"the default run's trace shows K1 x{k1}, not x{STEPS}")
    return {"default_trace": {"kernel_ms": tk["kernel_ms"],
                              "span_ms": tk["span_ms"], "busy": tk["busy"],
                              "kernels": dict(top[:12])}}


def phase_kernel_choice(card):
    """--kernel roll against --kernel pallas at N=128 / 100 steps: the
    same states bit for bit (API) and the same report layer lines (CLI);
    then the profile subcommand over a small solve."""
    p = Problem(N=128, timesteps=100)
    roll = leapfrog.solve(p, device=DEV, kernel="roll")
    pallas = leapfrog.solve(p, device=DEV, kernel="pallas")
    same = (torch.equal(roll.u_cur, pallas.u_cur)
            and torch.equal(roll.u_prev, pallas.u_prev)
            and np.array_equal(roll.abs_errors, pallas.abs_errors))
    lines = {}
    for kernel in ("roll", "pallas"):
        out = os.path.join(OUT_DIR, f"kernel_{kernel}")
        if cli.main(["128", "1", "1", "1", "1", "1", "100", "--kernel",
                     kernel, "--out-dir", out]) != 0:
            fail(f"--kernel {kernel} failed")
        with open(os.path.join(out, "output_N128_Np1_CUDA.txt")) as f:
            lines[kernel] = [ln for ln in f if ln.startswith("max abs")]
    print(f"  --kernel roll == pallas at N=128/100: states bitwise={same}, "
          f"report lines equal={lines['roll'] == lines['pallas']}; solve "
          f"roll {roll.solve_seconds!r} s, pallas {pallas.solve_seconds!r} "
          f"s ({card})")
    if not same or lines["roll"] != lines["pallas"]:
        fail("--kernel roll differs from --kernel pallas")
    prof = os.path.join(OUT_DIR, "profile_subcommand")
    if cli.main(["profile", "--out", prof, "64", "1", "1", "1", "1", "1",
                 "20", "--out-dir", prof]) != 0:
        fail("the profile subcommand failed")
    if not os.path.exists(os.path.join(prof, obs_perf.TRACE_FILENAME)):
        fail("the profile subcommand wrote no trace")
    return {"roll_solve_seconds": roll.solve_seconds,
            "pallas_solve_seconds": pallas.solve_seconds}


def guard_runs(sides, card):
    """The nine phase-3 CLI runs against their PERF.md §5 solve times."""
    for label, recorded in RUN_S.items():
        got = sides[label]["solve_seconds"]
        print(f"  {label}: solve {got!r} s, recorded {recorded:.4f} s "
              f"({100 * (got / recorded - 1):+.1f}%) ({card})")
        if got > (1 + RUN_SLACK) * recorded:
            fail(f"{label} solves in {got} s, more than "
                 f"{100 * RUN_SLACK:.0f}% over the {recorded} s recorded "
                 f"in PERF.md")


# Phase 8: the resilience slice.  The stop layers of the stop-and-resume
# runs, the supervised chunking and the fault drills' layers.  The
# single-device k-fused stops lie on the block grid (1 + 125k): elsewhere
# the flagship's k-blocks shift (its state is then not the uninterrupted
# one bit for bit), and the standard k-fused march's state stays bitwise
# but the layers around the stop take their errors from the full-field
# pass instead of the kernel's rows (within 1e-6, not bit for bit).
STOP = {"default": 500, "kfused": 501, "flagship": 501,
        "sharded_221": 500, "sharded_kfused_221": 500,
        "sharded_flagship_221": 501}
CKPT_EVERY, PREEMPT_AT, NAN_AT = 250, 500, 300
SUP_STEPS = [249, 497, 745, 993, 1000]   # chunk_length(250, 4) = 248


def host_state(res):
    """A result's state on the host (padded global arrays for sharded
    results) and its error vectors: phase 8's reference."""
    def h(a):
        if a is None:
            return None
        return a.assemble("cpu") if hasattr(a, "blocks") else a.cpu()

    return dict(u_prev=h(res.u_prev), u_cur=h(res.u_cur), v=h(res.comp_v),
                carry=h(res.comp_carry), abs=np.asarray(res.abs_errors),
                rel=np.asarray(res.rel_errors))


def same_bits(label, got: dict, want: dict, errors_from=None):
    """Fail unless the states (and, from layer `errors_from` on, the error
    vectors) are bit-equal."""
    for key in ("u_prev", "u_cur", "v", "carry"):
        a, b = got.get(key), want.get(key)
        if a is None or b is None:
            continue
        if a.dtype != b.dtype or not torch.equal(a, b):
            d = (a.double() - b.double()).abs().max().item()
            fail(f"{label}: {key} is not bit-equal (max |d| {d!r})")
    if errors_from is not None:
        for key in ("abs", "rel"):
            if not np.array_equal(got[key][errors_from:],
                                  want[key][errors_from:]):
                fail(f"{label}: {key} errors are not bit-equal")
    print(f"  {label}: bit-equal")


def timed(fn, *args):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def io_line(kind, op, nbytes, seconds, card):
    print(f"  checkpoint {kind} {op}: {seconds!r} s, {nbytes} bytes, "
          f"{nbytes / seconds / 1e9!r} GB/s ({card})")
    return {"seconds": seconds, "bytes": nbytes,
            "gb_per_s": nbytes / seconds / 1e9}


def dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def cli_quiet(argv):
    """cli.main with its standard output captured; returns (rc, out)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def entry_state(path):
    """A rotation entry's (.npz) state on the host."""
    _, u_prev, u_cur, step = checkpoint.load_checkpoint(path)
    out = dict(u_prev=u_prev, u_cur=u_cur)
    aux = checkpoint.load_checkpoint_aux(path)
    if aux is not None:
        out.update(v=aux[0], carry=aux[1])
    return out, step


def load_single(path):
    """A single-file checkpoint's fields loaded onto the card."""
    fields = list(checkpoint.load_checkpoint(path)[1:3])
    fields += list(checkpoint.load_checkpoint_aux(path) or ())
    return [t.to(DEV) for t in fields]


def side_errors(side):
    return dict(abs=np.asarray(side["abs_errors"]),
                rel=np.asarray(side["rel_errors"]))


def save_parts(res, tmp, card):
    """Where a shard directory's save and load seconds go: the parts of
    save_sharded_checkpoint / load_sharded_checkpoint timed one by one on
    a sharded result's state (both fields, every block)."""
    blocks = [b for f in (res.u_prev, res.u_cur) for b in f.blocks]
    nb = nbytes(*blocks)
    out = {}

    def part(name, fn):
        r, s_ = timed(fn)
        out[name] = {"seconds": s_, "gb_per_s": nb / s_ / 1e9}
        print(f"  shard save/load part {name}: {s_!r} s, "
              f"{nb / s_ / 1e9!r} GB/s ({card})")
        return r

    part("d2h_pinned", lambda: [checkpoint._host(b) for b in blocks])
    host = part("d2h_pageable", lambda: [b.cpu() for b in blocks])
    arrays = [h.numpy() for h in host]
    part("crc32", lambda: [nativeio.crc32(a) for a in arrays])
    d = os.path.join(tmp, "parts")
    os.makedirs(d)
    files = [os.path.join(d, f"{i}.wts") for i in range(len(arrays) // 2)]
    part("write_fsync", lambda: [nativeio.write_container_sync(
        f_, {"u_prev": (a, "float32"), "u_cur": (b, "float32")}, {"step": 1})
        for f_, a, b in zip(files, arrays, arrays[len(files):])])
    read = part("read_verified", lambda: [nativeio.read_container(f_)
                                          for f_ in files])
    payload = [torch.from_numpy(r[0][key][0]) for r in read
               for key in ("u_prev", "u_cur")]
    part("h2d", lambda: [t.to(DEV) for t in payload])
    shutil.rmtree(d)
    return out


def phase_resilience(sides, counts, refs, card):
    """Phase 8 (see the module docstring)."""
    out = {"io": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        out.update(_resilience(sides, counts, refs, card, tmp, out["io"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _resilience(sides, counts, refs, card, tmp, io_rec):
    out = {}
    p = Problem(N=N_FULL, timesteps=STEPS)
    base = [str(N_FULL), "1", "1", "1", "1", "1", str(STEPS)]
    # -- the native writer ------------------------------------------------
    if not nativeio.native_available():
        fail("the C++ checkpoint writer did not build")
    blk = state.to_tensor(np.random.default_rng(8).standard_normal(
        (N_FULL // 2, N_FULL // 2, N_FULL)).astype(np.float32), "cpu")
    fields = {"u_prev": (blk.numpy(), "float32"),
              "u_cur": ((blk * 2).numpy(), "float32")}
    nat, py = os.path.join(tmp, "native.wts"), os.path.join(tmp, "py.wts")
    nativeio.write_container_sync(nat, fields, {"step": 7})
    lib = nativeio._lib
    nativeio._lib = None
    try:
        nativeio.write_container_sync(py, fields, {"step": 7})
    finally:
        nativeio._lib = lib
    with open(nat, "rb") as a, open(py, "rb") as b:
        if a.read() != b.read():
            fail("the native .wts file differs from the Python writer's")
    print(f"  native writer: {nativeio.lib_path()}; one shard "
          f"({os.path.getsize(nat)} bytes) byte-identical to the Python "
          f"writer's")
    os.remove(nat)
    os.remove(py)

    # -- stop and resume through the CLI ---------------------------------
    for label in ("default", "kfused", "flagship"):
        flags = RUNS[label][1]
        stop = STOP[label]
        ck = os.path.join(tmp, f"{label}_ck")
        fin = os.path.join(tmp, f"{label}_final")
        stencil_cuda.reset_launches()
        rc1, _ = cli_quiet(base + flags + CLI_EXTRA + [
            "--stop-step", str(stop), "--save-state", ck, "--out-dir",
            os.path.join(OUT_DIR, f"resil_{label}_stop")])
        extra = ["--fuse-steps", str(K)] if "--fuse-steps" in flags else []
        rc2, _ = cli_quiet(["--resume", ck + ".npz"] + extra + CLI_EXTRA + [
            "--save-state", fin, "--out-dir",
            os.path.join(OUT_DIR, f"resil_{label}_resume")])
        torch.cuda.synchronize()
        launched = kernel_launches(stencil_cuda.launches, nonzero=True)
        if (rc1, rc2) != (0, 0):
            fail(f"{label} stop/resume exit codes {rc1}, {rc2}")
        want = {c: n for c, n in counts[label].items() if n}
        print(f"  {label}: --stop-step {stop} + --resume launches "
              f"{launched}")
        if launched != want:
            fail(f"{label}: stop + resume launched {launched}, the "
                 f"uninterrupted run {want}")
        got, step = entry_state(fin + ".npz")
        name = f"output_N{N_FULL}_Np1_CUDA.json"
        with open(os.path.join(OUT_DIR, f"resil_{label}_stop", name)) as f:
            head = side_errors(json.load(f))
        with open(os.path.join(OUT_DIR, f"resil_{label}_resume",
                               name)) as f:
            tail = side_errors(json.load(f))
        for key in ("abs", "rel"):
            got[key] = np.concatenate([head[key][:stop + 1],
                                       tail[key][stop + 1:]])
        same_bits(f"{label} stop {stop} + resume", got, refs[label], 0)
        if label in ("default", "flagship"):
            # The single-file checkpoint's save and load through the API.
            res = leapfrog.SolveResult(
                problem=p, u_prev=got["u_prev"].to(DEV),
                u_cur=got["u_cur"].to(DEV), abs_errors=None,
                rel_errors=None, final_step=STEPS,
                comp_v=None if got.get("v") is None else got["v"].to(DEV),
                comp_carry=(None if got.get("carry") is None
                            else got["carry"].to(DEV)))
            kind = "single_" + label
            path, s_save = timed(checkpoint.save_checkpoint,
                                 os.path.join(tmp, kind), res)
            nb = os.path.getsize(path)
            _, s_load = timed(load_single, path)
            io_rec[kind] = {"save": io_line(kind, "save", nb, s_save, card),
                            "load": io_line(kind, "load", nb, s_load, card)}
            os.remove(path)
            del res
        for f_ in (ck + ".npz", fin + ".npz"):
            os.remove(f_)

    # -- stop and resume through the API, four shards on the card --------
    devs = [DEV] * SHARDS
    for label in ("sharded_221", "sharded_kfused_221",
                  "sharded_flagship_221"):
        stop = STOP[label]
        stencil_cuda.reset_launches()
        if label == "sharded_221":
            half = sharded.solve_sharded(p, (2, 2, 1), devs, stop_step=stop)
        elif label == "sharded_kfused_221":
            half = sharded_kfused.solve_sharded_kfused(
                p, k=K, mesh_shape=(2, 2, 1), devices=devs, stop_step=stop)
        else:
            half = kfused_comp.solve_kfused_comp_sharded(
                p, k=K, mesh_shape=(2, 2, 1), devices=devs, stop_step=stop)
        if label == "sharded_221":
            io_rec["shard_parts"] = save_parts(half, tmp, card)
        d = os.path.join(tmp, label)
        _, s_save = timed(checkpoint.save_sharded_checkpoint, d, half)
        head = host_state(half)
        del half
        loaded, s_load = timed(checkpoint.load_sharded_checkpoint, d, devs)
        nb = dir_bytes(d)
        io_rec[label] = {"save": io_line(label, "save", nb, s_save, card),
                         "load": io_line(label, "load", nb, s_load, card)}
        _, u_prev, u_cur, step, mesh, scheme, aux = loaded
        if step != stop or mesh != (2, 2, 1):
            fail(f"{label}: loaded step {step} mesh {mesh}")
        if label == "sharded_221":
            res = sharded.resume_sharded(p, u_prev, u_cur, step, mesh, devs)
        elif label == "sharded_kfused_221":
            res = sharded_kfused.resume_sharded_kfused(
                p, u_prev, u_cur, step, k=K, mesh_shape=mesh, devices=devs)
        else:
            res = kfused_comp.resume_kfused_comp_sharded(
                p, u_cur, *aux, step, k=K, mesh_shape=mesh, devices=devs)
        torch.cuda.synchronize()
        launched = kernel_launches(stencil_cuda.launches, nonzero=True)
        want = {c: n for c, n in counts[label].items() if n}
        print(f"  {label}: stop {stop} + resume launches {launched}")
        if launched != want:
            fail(f"{label}: stop + resume launched {launched}, the "
                 f"uninterrupted run {want}")
        got = host_state(res)
        del res, loaded, u_prev, u_cur, aux
        for key in ("abs", "rel"):
            got[key] = np.concatenate([head[key][:stop + 1],
                                       got[key][stop + 1:]])
        same_bits(f"{label} stop {stop} + resume", got, refs[label], 0)
        shutil.rmtree(d)

    flag_ref = dict(refs["flagship"], **side_errors(sides["flagship"]))
    flags = RUNS["flagship"][1]
    # -- the unsupervised and the supervised flagship, each in a fresh
    # process (a process's first solve pays for what phase 3's warm runs
    # no longer do) ---------------------------------------------------
    cwd = os.path.dirname(os.path.abspath(__file__))
    fresh_out = os.path.join(OUT_DIR, "resil_unsupervised_fresh")
    proc = subprocess.run(
        [sys.executable, "-m", "wavetpu_torch"] + base + flags + CLI_EXTRA
        + ["--out-dir", fresh_out],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"fresh unsupervised flagship exit {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    with open(os.path.join(fresh_out,
                           f"output_N{N_FULL}_Np1_CUDA.json")) as f:
        fresh = json.load(f)["solve_seconds"]
    rot = os.path.join(tmp, "rot")
    tel = os.path.join(OUT_DIR, "resil_supervised_telemetry")
    shutil.rmtree(tel, ignore_errors=True)
    sup_out = os.path.join(OUT_DIR, "resil_supervised")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wavetpu_torch"] + base + flags + CLI_EXTRA + [
            "--ckpt-every", str(CKPT_EVERY), "--ckpt-dir", rot,
            "--telemetry-dir", tel, "--out-dir", sup_out],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"supervised flagship exit {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("supervisor:")]
    print(f"  supervised flagship (fresh process, {wall:.1f} s wall): "
          f"{line}")
    if f"{len(SUP_STEPS)} checkpoint(s)" not in proc.stdout:
        fail(f"supervised flagship: {line}")
    entries = sorted(e for e in os.listdir(rot) if e.startswith("step-"))
    newest = [f"step-{s_:08d}.npz" for s_ in SUP_STEPS[-2:]]
    with open(os.path.join(rot, "latest")) as f:
        latest = f.read().strip()
    if entries != newest or latest != newest[-1]:
        fail(f"rotation holds {entries}, latest {latest}")
    spans = [json.loads(ln) for ln in open(os.path.join(tel, "trace.jsonl"))]
    spans = [r for r in spans if r.get("type") == "span"]
    ck_steps = [r["attrs"]["step"] for r in spans
                if r["kind"] == "supervisor.checkpoint"]
    chunks = [r["attrs"] for r in spans if r["kind"] == "supervisor.chunk"]
    if ck_steps != SUP_STEPS:
        fail(f"checkpoints at {ck_steps}, expected {SUP_STEPS}")
    later = [(c["start"], c["nvcc_runs"], c["loads"]) for c in chunks[1:]]
    if any(n or ld for _, n, ld in later):
        fail(f"a library was built or loaded after the first chunk: {later}")
    first_launch = [(c["start"], c["length"], c["first_launch_seconds"])
                    for c in chunks]
    led_path = os.path.join(tel, "compile_ledger.jsonl")
    ledger_lines = ([json.loads(ln) for ln in open(led_path)]
                    if os.path.exists(led_path) else [])
    print(f"  chunks (start, length, first-launch s): {first_launch}; "
          f"first chunk: nvcc {chunks[0]['nvcc_runs']}, loads "
          f"{chunks[0]['loads']}; compile-ledger records: "
          f"{len(ledger_lines)}")
    if len(ledger_lines) != 1:
        fail(f"the compile ledger holds {len(ledger_lines)} records, "
             f"expected the first chunk's one")
    overhead = sum(r["dur_s"] for r in spans if r["kind"] in (
        "supervisor.checkpoint", "supervisor.health"))
    with open(os.path.join(sup_out, f"output_N{N_FULL}_Np1_CUDA.json")) as f:
        side = json.load(f)
    got, step = entry_state(os.path.join(rot, latest))
    got.update(side_errors(side))
    same_bits("supervised flagship vs unsupervised", got, flag_ref, 0)
    unsup = sides["flagship"]["solve_seconds"]
    print(f"  supervised flagship: solve {side['solve_seconds']!r} s "
          f"(unsupervised {unsup!r} s, in a fresh process {fresh!r} s), "
          f"overhead_seconds {overhead!r} (checkpoints + health checks, "
          f"{len(SUP_STEPS)} saves) ({card})")
    # Each chunk's solve seconds beside its share of the unsupervised
    # march's (layers / STEPS of it).
    per_chunk = [(c["start"], c["length"], c["solve_seconds"],
                  c["solve_seconds"] - unsup * c["length"] / STEPS)
                 for c in chunks]
    print(f"  supervised flagship chunks (start, length, solve s, over its "
          f"share of the unsupervised run s): {per_chunk} ({card})")
    out["supervised"] = {
        "solve_seconds": side["solve_seconds"],
        "unsupervised_solve_seconds": unsup,
        "fresh_unsupervised_solve_seconds": fresh,
        "overhead_seconds": overhead,
        "wall_seconds": wall, "checkpoint_steps": ck_steps,
        "first_launch_seconds": first_launch, "chunks": per_chunk,
        "ledger_records": len(ledger_lines)}
    shutil.rmtree(rot)
    out["reentry"] = reentry_split(p, card)
    out["supervised_uneven"] = supervised_uneven(sides, counts, refs, card,
                                                 tmp)

    # -- preempt and resume, watchdog and retry (in this process) --------
    def drill(fault, argv):
        if fault:
            os.environ["WAVETPU_FAULT"] = fault
        try:
            return cli_quiet(argv)
        finally:
            os.environ.pop("WAVETPU_FAULT", None)

    rot = os.path.join(tmp, "preempt")
    sup_flags = ["--ckpt-every", str(CKPT_EVERY), "--ckpt-dir", rot]
    stencil_cuda.reset_launches()
    rc, text = drill(f"preempt:{PREEMPT_AT}", base + flags + CLI_EXTRA + sup_flags + [
        "--out-dir", os.path.join(OUT_DIR, "resil_preempt")])
    last = SUP_STEPS[2]      # the chunk boundary after the signal
    if rc != 3 or "resumable checkpoint:" not in text or \
            f"checkpointed at step {last}" not in text:
        fail(f"preempt:{PREEMPT_AT} exit {rc}: {text[-500:]}")
    print(f"  preempt:{PREEMPT_AT}: exit 3, "
          f"{[ln for ln in text.splitlines() if 'resumable' in ln]}")
    rc, text = drill(None, ["--resume", rot] + sup_flags[:2] + CLI_EXTRA + [
        "--fuse-steps", str(K), "--out-dir",
        os.path.join(OUT_DIR, "resil_preempt_resume")])
    launched = kernel_launches(stencil_cuda.launches, nonzero=True)
    if rc != 0:
        fail(f"--resume after the preemption exit {rc}")
    if launched != {c: n for c, n in counts["flagship"].items() if n}:
        fail(f"preempt + resume launched {launched}")
    got, step = entry_state(resolve(rot))
    # The preempted run's errors up to its last checkpoint, the resumed
    # run's after it (the CLI's stop/resume contract).
    name = f"output_N{N_FULL}_Np1_CUDA.json"
    with open(os.path.join(OUT_DIR, "resil_preempt", name)) as f:
        head = side_errors(json.load(f))
    with open(os.path.join(OUT_DIR, "resil_preempt_resume", name)) as f:
        tail = side_errors(json.load(f))
    for key in ("abs", "rel"):
        got[key] = np.concatenate([head[key][:last + 1],
                                   tail[key][last + 1:]])
    same_bits("preempt + --resume flagship", got, flag_ref, 0)
    shutil.rmtree(rot)
    rot = os.path.join(tmp, "nan")
    sup_flags = ["--ckpt-every", str(CKPT_EVERY), "--ckpt-dir", rot]
    rc, text = drill(f"nan:{NAN_AT}", base + flags + CLI_EXTRA + sup_flags
                     + ["--out-dir", os.path.join(OUT_DIR, "resil_nan")])
    last_good = os.path.basename(resolve(rot))
    print(f"  nan:{NAN_AT}: exit {rc}, last good entry {last_good}")
    if rc != 4 or last_good != "step-00000249.npz" or \
            "last good step 249" not in text:
        fail(f"nan:{NAN_AT}: exit {rc}, latest {last_good}")
    shutil.rmtree(rot)
    rc, text = drill(f"nan:{NAN_AT}", base + flags + CLI_EXTRA + sup_flags
                     + ["--retries", "1", "--out-dir",
                        os.path.join(OUT_DIR, "resil_retry")])
    if rc != 0 or "1 retry" not in text:
        fail(f"nan:{NAN_AT} with --retries 1: exit {rc}")
    got, _ = entry_state(resolve(rot))
    with open(os.path.join(OUT_DIR, "resil_retry",
                           f"output_N{N_FULL}_Np1_CUDA.json")) as f:
        got.update(side_errors(json.load(f)))
    same_bits("nan + --retries 1 flagship", got, flag_ref, 0)
    shutil.rmtree(rot)
    return out


def reentry_split(p, card, gap=1.5):
    """Where a supervised flagship's extra solve seconds go: the
    supervisor's own chunk calls (`supervisor._Path`, as `supervise` makes
    them, no saves) timed uninterrupted (one chunk of STEPS layers), back
    to back, with the card idle for `gap` s between chunks (about one
    save's time), and uninterrupted again.  Each chunk's seconds end at its
    error read-back."""
    from wavetpu_torch.run import supervisor as sup

    spec = sup.PathSpec(scheme="compensated", fuse_steps=K, devices=(DEV,))
    length = sup.chunk_length(CKPT_EVERY, K)
    runs = {}
    for name, wait in (("uninterrupted", None), ("back_to_back", 0.0),
                       ("idle_gaps", gap), ("uninterrupted_again", None)):
        path = sup._Path(p, spec)
        if wait is None:
            state, _, _, _, s_ = path.first(STEPS)
            runs[name] = [s_]
        else:
            state, _, _, _, s_ = path.first(1 + length)
            runs[name], cur = [s_], 1 + length
            while cur < STEPS:
                time.sleep(wait)
                n = min(length, STEPS - cur)
                state, _, _, s_, _ = path.chunk(state, cur, n)
                runs[name].append(s_)
                cur += n
        if name == "uninterrupted":
            ref = state[0]
        elif not torch.equal(state[0], ref):
            fail(f"the flagship's {name} run left another state")
        del state, path
    base = min(runs["uninterrupted"] + runs["uninterrupted_again"])
    out = {}
    for name, ts in runs.items():
        out[name] = {"chunks": ts, "solve_seconds": sum(ts),
                     "over_uninterrupted": sum(ts) - base}
        print(f"  flagship chunk calls, {name}: {ts} s, sum {sum(ts)!r} s, "
              f"{sum(ts) - base!r} s over the faster uninterrupted run "
              f"({card})")
    return out


def supervised_uneven(sides, counts, refs, card, tmp):
    """The K9 route (N=510, --fuse-steps 4) supervised with --ckpt-every
    250: bit-equal to phase 3's uneven_kfused run, its launches, and its
    solve seconds beside that run's (the chunk runner re-cuts the state
    between the Topology and the pad-and-mask layouts on the card)."""
    label = "uneven_kfused"
    rot = os.path.join(tmp, "uneven")
    out_dir = os.path.join(OUT_DIR, "resil_supervised_uneven")
    stencil_cuda.reset_launches()
    rc, text = cli_quiet(
        [str(N_ODD), "1", "1", "1", "1", "1", str(STEPS)] + RUNS[label][1]
        + CLI_EXTRA + ["--ckpt-every", str(CKPT_EVERY), "--ckpt-dir", rot,
                       "--out-dir", out_dir])
    torch.cuda.synchronize()
    launched = kernel_launches(stencil_cuda.launches, nonzero=True)
    if rc != 0:
        fail(f"supervised {label} exit {rc}: {text[-500:]}")
    if launched != {c: n for c, n in counts[label].items() if n}:
        fail(f"supervised {label} launched {launched}")
    with open(os.path.join(out_dir, f"output_N{N_ODD}_Np1_CUDA.json")) as f:
        side = json.load(f)
    got, _ = entry_state(resolve(rot))
    got.update(side_errors(side))
    same_bits(f"supervised {label} vs unsupervised", got, refs[label], 0)
    unsup = sides[label]["solve_seconds"]
    print(f"  supervised {label}: solve {side['solve_seconds']!r} s "
          f"(unsupervised {unsup!r} s), launches {launched} ({card})")
    shutil.rmtree(rot)
    return {"solve_seconds": side["solve_seconds"],
            "unsupervised_solve_seconds": unsup}


def resolve(root):
    from wavetpu_torch.run import supervisor

    path = supervisor.resolve_latest(root)
    if path is None:
        fail(f"{root} holds no checkpoint")
    return path


def single_refs():
    """The uninterrupted single-device runs of phase 8's stop-and-resume
    paths, through the API (the CLI's solver calls), on the host."""
    p = Problem(N=N_FULL, timesteps=STEPS)
    refs = {}
    for label, solve in (("default", lambda: leapfrog.solve(p, device=DEV)),
                         ("kfused", lambda: kfused.solve_kfused(
                             p, k=K, device=DEV)),
                         ("flagship", lambda: kfused_comp.solve_kfused_comp(
                             p, k=K, device=DEV)),
                         ("uneven_kfused",
                          lambda: sharded_kfused.solve_sharded_kfused(
                              Problem(N=N_ODD, timesteps=STEPS), n_shards=1,
                              k=K, devices=[DEV]))):
        refs[label] = host_state(solve())
    return refs


# Phase 9: the ensemble slice (wavetpu_torch/ensemble).  The main-path runs
# through the entry points a user calls (`solve_ensemble`,
# `solve_ensemble_sharded`): label -> (N, steps, the call's arguments,
# the lanes, the launch count of every counter that must move - all
# others stay 0 - and the lanes held bitwise against solo port solves).
# The lanes: the reference phase, shifted phases and an early stop on the
# k-block grid (1 + 125k), padded with `padding_lane()`s to B (pad_to);
# launch counts do not depend on B (every layer or k-block is one lane
# launch over the live lanes).
L = ensemble.LaneSpec
ENS_SHARDED_STEPS = 200


def ens_lanes(label, p):
    if label == "ens_flagship":
        return ([L()] + [L(phase=1.0 + 0.1 * i) for i in range(5)]
                + [L(phase=1.6, stop_step=501)])
    if label == "ens_kfused_lens":
        lens = stencil_ref.make_preset_c2tau2_field(p, LENS)
        return [L(c2tau2_field=lens), L(c2tau2_field=0.8 * lens),
                L(stop_step=501)]
    stop = ENS_SHARDED_STEPS // 2 if label == "ens_sharded_221" else 501
    return [L(), L(phase=1.0), L(phase=1.3, stop_step=stop)]


def lane_layers(steps, stop):
    """Error-pass launches of a phase-9 batch on a 1-step march: four
    lanes at layer 1 (the padding lane stops there), three to `stop`,
    two to the end."""
    return 4 + 3 * (stop - 1) + 2 * (steps - stop)


ENS_RUNS = {
    "ens_flagship": (N_FULL, STEPS, dict(scheme="compensated", path="kfused",
                                         k=K, pad_to=8),
                     {"comp_step_lanes": 1, "kstep_comp_lanes": NB + REM},
                     (0, 1, 6)),
    "ens_pallas": (N_FULL, STEPS, dict(path="pallas", pad_to=4),
                   {"step_lanes": STEPS,
                    "layer_errors": lane_layers(STEPS, 501)}, (0, 1, 2)),
    # Layer 1 on four lanes, the three tail layers on the two that run on.
    "ens_kfused": (N_FULL // 2, STEPS, dict(path="kfused", k=K, pad_to=4),
                   {"kstep_lanes": NB, "step_lanes": 1 + REM,
                    "layer_errors": 4 + 2 * REM}, (0, 1, 2)),
    "ens_kfused_lens": (N_FULL // 2, STEPS, dict(path="kfused", k=K,
                                                 compute_errors=False),
                        {"kstep_field_lanes": NB, "var_step_lanes": 1 + REM},
                        (0, 2)),
    "ens_sharded_221": (N_FULL // 2, ENS_SHARDED_STEPS,
                        dict(mesh=(2, 2, 1), kernel="pallas", pad_to=4),
                        {"sharded_step_lanes": SHARDS * ENS_SHARDED_STEPS,
                         "layer_errors": SHARDS * lane_layers(
                             ENS_SHARDED_STEPS, ENS_SHARDED_STEPS // 2)},
                        (0, 1, 2)),
}


def solo_lane(p, kw, lane):
    """The solo port solve of one lane on its ensemble's path (launches
    made here do not count: the counters were read before)."""
    common = dict(stop_step=lane.stop(p), phase=lane.phase,
                  compute_errors=kw.get("compute_errors", True))
    if "mesh" in kw:
        return sharded.solve_sharded(p, kw["mesh"], devices=[DEV] * SHARDS,
                                     **common)
    if kw.get("scheme") == "compensated":
        return kfused_comp.solve_kfused_comp(p, k=K, device=DEV, **common)
    if kw["path"] == "kfused":
        return kfused.solve_kfused(p, k=K, device=DEV,
                                   c2tau2_field=lane.c2tau2_field, **common)
    return leapfrog.solve(p, device=DEV, **common)


def run_ensemble(label):
    """One phase-9 main-path run with the counters zeroed just before and
    read just after; every counter must equal ENS_RUNS[label]'s count, the
    batch must have run batched (no fallback), and the lanes named there
    must equal their solo port solves bit for bit (states and error vectors
    from layer 0).  Returns (summary dict, launches)."""
    n, steps, kw, want, held = ENS_RUNS[label]
    p = Problem(N=n, timesteps=steps)
    lanes = ens_lanes(label, p)
    stencil_cuda.reset_launches()
    if "mesh" in kw:
        res = ensemble_sharded.solve_ensemble_sharded(
            p, lanes, kw["mesh"], kernel=kw["kernel"], pad_to=kw["pad_to"],
            devices=[DEV] * SHARDS)
    else:
        res = ensemble.solve_ensemble(p, lanes, **kw)
    torch.cuda.synchronize()
    counts = kernel_launches(stencil_cuda.launches)
    expected = {c: want.get(c, 0) for c in counts}
    if counts != expected:
        fail(f"{label}: launches {counts}, expected {expected}")
    if not res.batched or res.fallback_reason is not None:
        fail(f"{label}: not batched ({res.fallback_reason})")
    errs = [r.abs_errors.max() for r in res.results]
    side = {"batch": res.batch_size, "lanes": res.n_lanes,
            "solve_seconds": res.solve_seconds,
            "aggregate_gcells_per_second": res.aggregate_gcells_per_second,
            "max_abs_error": (float(max(errs))
                              if kw.get("compute_errors", True) else None)}
    bound = ERROR_CLASS["flagship" if kw.get("scheme") else "default"]
    if side["max_abs_error"] is not None and not side["max_abs_error"] < \
            bound:
        fail(f"{label}: max abs error {side['max_abs_error']}")
    print(f"  {label}: B={res.batch_size} ({res.n_lanes} real) launches="
          f"{ {c: v for c, v in counts.items() if v} } solve "
          f"{res.solve_seconds!r} s, aggregate "
          f"{res.aggregate_gcells_per_second!r} Gcell/s, max abs error "
          f"{side['max_abs_error']!r}")
    for i in held:
        same_bits(f"{label} lane {i} (phase {lanes[i].phase:.3f}, stop "
                  f"{lanes[i].stop(p)}) == solo",
                  host_state(res.results[i]),
                  host_state(solo_lane(p, kw, lanes[i])), errors_from=0)
    # The held lanes' error vectors: phase 10's reference.
    side["lane_errors"] = {i: (res.results[i].abs_errors,
                               res.results[i].rel_errors) for i in held}
    return side, counts


def lane_cases(n, lanes, names):
    """{name: (lane call, plain call, solo call on lane i, bytes moved,
    f32 operations)} of the named lane modes on `lanes` lanes of (n, n, n)
    (K6's on the mesh-2,2,1 block of n, x and y ghosts as (B, face)
    planes), f32, k=4 with rows on for K3/K4 (off for K3f, as the lens
    batch launches it).  Operands are made on first use, so a call holds
    only what its kernels read."""
    p = Problem(N=n, timesteps=STEPS)
    made = {}

    def t(key):
        if key not in made:
            seed = {"up": 1, "u": 20, "v": 40, "cy": 60}.get(key)
            if key == "cb":
                made[key] = t("cy").to(torch.bfloat16)
            elif key == "fld":
                made[key] = torch.stack([c2_field(p, 80 + i)
                                         for i in range(lanes)])
            elif key == "sxct":
                sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(
                    p, torch.float32, DEV)
                made.update(syz=syz, rsyz=rsyz)
                made[key] = torch.stack([ct[2 + i: 2 + i + K, None]
                                         * sx[None, :]
                                         for i in range(lanes)])
            else:
                scale = {"v": 1e-3, "cy": 1e-8}.get(key, 1.0)
                made[key] = torch.stack([rand((n, n, n), seed + i, scale)
                                         for i in range(lanes)])
        return made[key]

    def rows():
        return t("sxct"), made["syz"], made["rsyz"]

    kw1 = dict(inv_h2=p.inv_h2, alpha=2.0, beta=1.0, coeff=p.a2tau2)
    kw5 = dict(inv_h2=p.inv_h2)
    kw4 = dict(k=K, coeff=p.a2tau2, inv_h2=p.inv_h2)
    kw3f = dict(kw4, with_errors=False)
    sc = stencil_cuda
    h = n // 2
    off = (h, 0, 0)
    kb = dict(inv_h2=p.inv_h2, mesh_shape=(2, 2, 1), coeff=p.a2tau2)

    def block(key):
        return t(key)[:, :h, :h].contiguous()

    def ghosts():
        if "g" not in made:
            g = []
            for axis in range(3):
                face = [h, h, n]
                face[axis] = 1
                g.append(tuple(
                    torch.stack([rand(face, 100 + 10 * axis + 2 * i + j)
                                 for i in range(lanes)]) for j in range(2)))
            made.update(g=g, bu=block("up"), bc=block("u"))
        return made["g"], made["bu"], made["bc"]

    def solo_ghosts(i):
        return [tuple(x[i] for x in a) for a in ghosts()[0]]

    def k6(fn):
        g, bu, bc = ghosts()
        return fn(bu, bc, g, off, n, **kb)

    cases = {
        "K1 lanes": (lambda: sc.fused_step_lanes(t("up"), t("u"), **kw1),
                     lambda: sc.fused_step_lanes_plain(t("up"), t("u"),
                                                       **kw1),
                     lambda i: sc.fused_step(t("up")[i], t("u")[i], **kw1)),
        "K5 lanes": (lambda: sc.fused_step_lanes(
                         t("up"), t("u"), c2tau2_field=t("fld"), **kw5),
                     lambda: sc.fused_step_lanes_plain(
                         t("up"), t("u"), c2tau2_field=t("fld"), **kw5),
                     lambda i: sc.fused_step(t("up")[i], t("u")[i],
                                             c2tau2_field=t("fld")[i],
                                             **kw5)),
        "K2 lanes": (lambda: sc.compensated_step_lanes(t("u"), t("v"),
                                                       t("cy"), p),
                     lambda: sc.compensated_step_lanes_plain(
                         t("u"), t("v"), t("cy"), inv_h2=p.inv_h2,
                         coeff=p.a2tau2),
                     lambda i: sc.compensated_step(t("u")[i], t("v")[i],
                                                   t("cy")[i], p)),
        "K3 lanes": (lambda: sc.fused_kstep_lanes(
                         t("up"), t("u"), *rows()[1:], rows()[0], **kw4),
                     lambda: sc.fused_kstep_lanes_plain(
                         t("up"), t("u"), *rows()[1:], rows()[0], **kw4),
                     lambda i: sc.fused_kstep(t("up")[i], t("u")[i],
                                              *rows()[1:], rows()[0][i],
                                              **kw4)),
        "K3f lanes": (lambda: sc.fused_kstep_lanes(
                          t("up"), t("u"), None, None, None,
                          c2tau2_field=t("fld"), **kw3f),
                      lambda: sc.fused_kstep_lanes_plain(
                          t("up"), t("u"), None, None, None,
                          c2tau2_field=t("fld"), **kw3f),
                      lambda i: sc.fused_kstep(
                          t("up")[i], t("u")[i], None, None, None,
                          c2tau2_field=t("fld")[i], **kw3f)),
        "K4 lanes": (lambda: sc.fused_kstep_comp_lanes(
                         t("u"), t("v"), t("cb"), *rows()[1:], rows()[0],
                         **kw4),
                     lambda: sc.fused_kstep_comp_lanes_plain(
                         t("u"), t("v"), t("cb"), *rows()[1:], rows()[0],
                         block_x=sc.default_block_x(n, K), **kw4),
                     lambda i: sc.fused_kstep_comp(
                         t("u")[i], t("v")[i], t("cb")[i], *rows()[1:],
                         rows()[0][i], **kw4)),
        "K6 lanes": (lambda: k6(sc.sharded_fused_step_lanes),
                     lambda: k6(sc.sharded_fused_step_lanes_plain),
                     lambda i: sc.sharded_fused_step(
                         ghosts()[1][i], ghosts()[2][i], solo_ghosts(i), off,
                         n, **kb)),
    }
    cases[K6_SOLO_BODY] = (None, cases["K6 lanes"][1],
                           lambda i: tile_ab.k6_solo_old(
                               ghosts()[1][i], ghosts()[2][i],
                               solo_ghosts(i), off, n, **kb))
    out = {}
    cells = lanes * n ** 3
    for name in names:
        meta = LANE_KERNELS[name if name != K6_SOLO_BODY else "K6 lanes"]
        if meta is LANE_KERNELS["K6 lanes"]:
            g, _, bc = ghosts()
            nb = 3 * nbytes(bc) + nbytes(*(x for a in g[:2] for x in a))
            ops = meta["ops"] * bc.numel()
        else:
            nb, ops = meta["bytes_per_cell"] * cells, meta["ops"] * cells
        out[name] = cases[name] + (nb, ops)
    return out


# The shapes each lane mode is checked and timed at: the main-path run's
# N (per lane) and B=8.
LANE_SHAPES = ((N_FULL, ("K1 lanes", "K2 lanes", "K4 lanes")),
               (N_FULL // 2, ("K5 lanes", "K3 lanes", "K3f lanes",
                              "K6 lanes")))


def phase_lane_kernels(errs, rate):
    """Each lane mode against its plain version (the solo plain version
    lane by lane) and, lane by lane, against the solo kernel - bitwise -
    at N=128 on B=3 and B=2 lanes and at its main-path run's N (512 for K1,
    K2, K4; 256 for the rest) on B=3; then timed there on B=8: CUDA events
    around 10 launches back to back, against 8 solo launches back to back
    and the plain version; bound = the bytes and f32 operations of the 8
    lanes (8 x the solo row's)."""
    names = tuple(LANE_KERNELS)
    for n, lanes, subset in [(128, 3, names), (128, 2, names)] + [
            (n, 3, sub) for n, sub in LANE_SHAPES]:
        cases = lane_cases(n, lanes, subset + ((K6_SOLO_BODY,)
                                               if "K6 lanes" in subset
                                               else ()))
        body = cases.pop(K6_SOLO_BODY, None)
        for name, (fn, plain, solo, _, _) in cases.items():
            got = _as_list(fn())
            check_outputs(f"{name} N={n} B={lanes}", got, _as_list(plain()),
                          errs[name])
            check_outputs(f"{name} N={n} B={lanes} lane by lane", got,
                          _stack_solo(solo, lanes), errs[name])
            if name == "K6 lanes":
                check_outputs(f"{name} N={n} B={lanes} lane by lane, the "
                              f"one-thread-per-cell solo body", got,
                              _stack_solo(body[2], lanes), errs[name])
            del got
        del cases, body
        torch.cuda.empty_cache()
    times = {}
    for n, subset in LANE_SHAPES:
        cases = lane_cases(n, 8, subset)
        for name, (fn, plain, solo, nb, ops) in cases.items():
            ms = time_launches(fn, 10)
            solo_ms = time_launches(lambda: [solo(i) for i in range(8)], 10)
            plain_ms = time_launches(plain, 1, warmup=1)
            byte_ms = nb / rate * 1e3
            op_ms = ops / F32_OPS_PER_S * 1e3
            times[name] = dict(ms=ms, plain_ms=plain_ms, solo_x8_ms=solo_ms,
                               bound_ms=max(byte_ms, op_ms),
                               bound_by="bytes" if byte_ms >= op_ms
                               else "operations")
            print(f"  {name} N={n} B=8: {ms:.4f} ms; 8 solo launches "
                  f"{solo_ms:.4f} ms ({solo_ms / ms:.3f}x); plain "
                  f"{plain_ms:.3f} ms; bound {times[name]['bound_ms']:.4f} "
                  f"ms by {times[name]['bound_by']}")
        del cases
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    times["K6 lanes"].update(k6_lanes_main_block(errs, rate))
    return times


def k6_lanes_main_block(errs, rate):
    """K6's lane mode at the main path's block: B=8 lanes on the
    mesh-2,2,1 block of N=512 (~3.2 GB of state), held against its plain
    version and, lane by lane, the solo K6 (its wrapper, and the
    one-thread-per-cell solo body), and timed beside eight solo launches;
    bound = 8 x K6's.  Fails if it is more than
    GUARD_SLACK over LANE_GUARD_MS."""
    cases = lane_cases(N_FULL, 8, ["K6 lanes", K6_SOLO_BODY])
    fn, plain, solo, nb, ops = cases["K6 lanes"]
    got = _as_list(fn())
    check_outputs(f"K6 lanes N={N_FULL} B=8", got, _as_list(plain()),
                  errs["K6 lanes"])
    check_outputs(f"K6 lanes N={N_FULL} B=8 lane by lane", got,
                  _stack_solo(solo, 8), errs["K6 lanes"])
    check_outputs(f"K6 lanes N={N_FULL} B=8 lane by lane, the "
                  f"one-thread-per-cell solo body", got,
                  _stack_solo(cases[K6_SOLO_BODY][2], 8), errs["K6 lanes"])
    del got
    ms = time_launches(fn, 10)
    solo_ms = time_launches(lambda: [solo(i) for i in range(8)], 10)
    plain_ms = time_launches(plain, 1, warmup=1)
    byte_ms, op_ms = nb / rate * 1e3, ops / F32_OPS_PER_S * 1e3
    out = dict(ms_N512=ms, solo_x8_ms_N512=solo_ms, plain_ms_N512=plain_ms,
               bound_ms_N512=max(byte_ms, op_ms),
               bound_by_N512="bytes" if byte_ms >= op_ms else "operations")
    print(f"  K6 lanes N={N_FULL} B=8 (mesh-2,2,1 block): {ms:.4f} ms; 8 "
          f"solo launches {solo_ms:.4f} ms ({solo_ms / ms:.3f}x); plain "
          f"{plain_ms:.3f} ms; bound {out['bound_ms_N512']:.4f} ms by "
          f"{out['bound_by_N512']} ({out['bound_ms_N512'] / ms:.3f} of "
          f"it reached)")
    del cases
    recorded = LANE_GUARD_MS["K6 lanes"]
    print(f"  K6 lanes N={N_FULL} B=8: recorded {recorded:.4f} ms "
          f"({100 * (ms / recorded - 1):+.1f}%)")
    if ms > (1 + GUARD_SLACK) * recorded:
        fail(f"K6 lanes times {ms:.4f} ms at the main block, more than "
             f"{100 * GUARD_SLACK:.0f}% over the {recorded:.4f} ms "
             f"recorded in PERF.md")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def _as_list(out):
    return [out] if isinstance(out, torch.Tensor) else list(out)


def _stack_solo(solo, lanes):
    outs = [_as_list(solo(i)) for i in range(lanes)]
    return [None if o[0] is None else torch.stack(o) for o in zip(*outs)]


# Aggregate throughput: bench.py's serving shape (N=256, 100 steps, f32,
# errors on; bench.py:454-470) at B = 1, 2, 4, 8 on the pallas and
# flagship paths, and the flagship at N=512/1000 for B = 1 and 8.  Every
# lane marches the full run (phases 2*pi, 1.1, 1.2, ...).
THROUGHPUT = (
    ("pallas", N_FULL // 2, 100, dict(path="pallas"), (1, 2, 4, 8)),
    ("flagship", N_FULL // 2, 100, dict(scheme="compensated", path="kfused",
                                        k=K), (1, 2, 4, 8)),
    ("flagship", N_FULL, STEPS, dict(scheme="compensated", path="kfused",
                                     k=K), (1, 8)),
)


def phase_throughput(card):
    out = {}
    for label, n, steps, kw, sizes in THROUGHPUT:
        p = Problem(N=n, timesteps=steps)
        row = {}
        for b in sizes:
            lanes = [L(phase=oracle_phase(i)) for i in range(b)]
            solver = ensemble.EnsembleSolver(p, b, **kw)
            if n < N_FULL:  # warm the allocator at this shape first
                ensemble.solve_ensemble(p, lanes, solver=solver, **kw)
            res = ensemble.solve_ensemble(p, lanes, solver=solver, **kw)
            if not res.batched or res.fallback_reason is not None:
                fail(f"throughput {label} B={b}: not batched")
            row[b] = dict(solve_seconds=res.solve_seconds,
                          aggregate_gcells_per_second=(
                              res.aggregate_gcells_per_second))
            del res, solver
        base = row[1]["aggregate_gcells_per_second"]
        for b in sizes:
            row[b]["speedup_vs_batch1"] = (
                row[b]["aggregate_gcells_per_second"] / base)
            print(f"  throughput {label} N={n}/{steps} B={b}: aggregate "
                  f"{row[b]['aggregate_gcells_per_second']!r} Gcell/s, "
                  f"solve {row[b]['solve_seconds']!r} s, speedup_vs_batch1 "
                  f"{row[b]['speedup_vs_batch1']!r} ({card})")
        out[f"{label}_N{n}_{steps}"] = row
        torch.cuda.empty_cache()
    return out


def oracle_phase(i):
    return ensemble.LaneSpec().phase if i == 0 else 1.0 + 0.1 * i


def phase_ensemble(errs, rate, card):
    """Phase 9: the lane modes against their plain versions and timed, the
    five main-path ensemble runs (counted, lanes held bitwise against solo
    solves), and the aggregate throughput table."""
    torch.cuda.empty_cache()
    times = phase_lane_kernels(errs, rate)
    sides, counts = {}, {}
    for label in ENS_RUNS:
        sides[label], counts[label] = run_ensemble(label)
        torch.cuda.empty_cache()
    throughput = phase_throughput(card)
    lane_errors = {label: side.pop("lane_errors")
                   for label, side in sides.items()}
    return times, sides, counts, throughput, lane_errors


# Phase 10: the serving replica (wavetpu_torch/serve) in this process on
# the card, over HTTP.  Each run: the bodies sent concurrently (one batch),
# the launch count of every counter that must move (all others stay 0),
# and the phase-9 run and lanes its answers are bit-equal to (None: held
# against a `solve_ensemble` of the same lanes here).
SERVE_N = N_FULL // 2
FLAGSHIP_BODY = dict(N=N_FULL, T=1.0, timesteps=STEPS, scheme="compensated",
                     fuse_steps=K)
SERVE_RUNS = {
    "serve_flagship": (
        [dict(FLAGSHIP_BODY), dict(FLAGSHIP_BODY, phase=1.0),
         dict(FLAGSHIP_BODY, phase=1.6, steps=501)],
        {"comp_step_lanes": 1, "kstep_comp_lanes": NB + REM},
        ("ens_flagship", (0, 1, 6))),
    "serve_sharded_221": (
        [dict(N=SERVE_N, timesteps=ENS_SHARDED_STEPS, mesh=[2, 2, 1]),
         dict(N=SERVE_N, timesteps=ENS_SHARDED_STEPS, mesh=[2, 2, 1],
              phase=1.0)],
        {"sharded_step_lanes": SHARDS * ENS_SHARDED_STEPS,
         "layer_errors": SHARDS * 2 * ENS_SHARDED_STEPS}, None),
    "serve_kfused": (
        [dict(N=SERVE_N, timesteps=STEPS, fuse_steps=K),
         dict(N=SERVE_N, timesteps=STEPS, fuse_steps=K, phase=1.0,
              steps=501)],
        {"kstep_lanes": NB, "step_lanes": 1 + REM, "layer_errors": 2 + REM},
        None),
    "serve_kfused_lens": (
        [dict(N=SERVE_N, timesteps=STEPS, fuse_steps=K, c2_field=LENS),
         dict(N=SERVE_N, timesteps=STEPS, fuse_steps=K, c2_field=LENS,
              steps=501)],
        {"kstep_field_lanes": NB, "var_step_lanes": 1 + REM}, None),
}
# The watchdog pair (tests/test_serve.py:1437-1462): C = 0.55 is stable
# under c^2 = a^2, but the two-layer preset doubles c^2 in half the domain.
POISON_BODIES = [dict(N=8, T=26.0, timesteps=60, c2_field="constant"),
                 dict(N=8, T=26.0, timesteps=60, c2_field="two-layer")]
# bench.py's serving rows (bench.py:454-560): N=256/100 f32 errors on, 2B
# requests through a replica capped at max_batch B, program warmed first.
SERVE_ROWS = (("pallas", {}, "pallas_N256_100"),
              ("flagship", dict(scheme="compensated", fuse_steps=K),
               "flagship_N256_100"))


def serve_post(base, body, timeout=900):
    """POST /solve -> (status, payload, headers); never raises on 4xx/5xx."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + "/solve", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def serve_get(base, path, accept=None):
    import urllib.request

    req = urllib.request.Request(
        base + path, headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=60) as r:
        text = r.read().decode()
    return text if accept else json.loads(text)


def serve_concurrent(base, bodies):
    """Send the bodies at once (one thread each); returns [(status,
    payload, headers, client seconds)] in body order."""
    import threading

    out = [None] * len(bodies)

    def go(i):
        t0 = time.perf_counter()
        code, payload, headers = serve_post(base, bodies[i])
        out[i] = (code, payload, headers, time.perf_counter() - t0)

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    if any(o is None for o in out):
        fail("a /solve request did not return")
    return out


def start_replica(**kw):
    import threading

    from wavetpu_torch.serve.api import build_server

    httpd, state = build_server(host="127.0.0.1", port=0, device=DEV, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop_replica(httpd, state):
    httpd.shutdown()
    state.batcher.close(timeout=60.0)
    httpd.server_close()


def server_timing(header):
    parts = {}
    for item in (header or "").split(","):
        name, _, rest = item.strip().partition(";")
        if rest.startswith("dur="):
            parts[name] = float(rest[4:]) / 1e3
    return parts


def serve_lane(body):
    return ensemble.LaneSpec(
        phase=float(body.get("phase", ensemble.LaneSpec().phase)),
        stop_step=body.get("steps"))


def serve_reference(label, bodies, lane_errors):
    """The error vectors each body's answer must equal bit for bit: phase
    9's lanes, or a `solve_ensemble` / `solve_ensemble_sharded` of the
    same lanes (errors off for the lens pair: None)."""
    ref = SERVE_RUNS[label][2]
    if ref is not None:
        run, held = ref
        return [lane_errors[run][i] for i in held]
    b0 = bodies[0]
    if b0.get("c2_field"):
        return [None] * len(bodies)
    p = Problem(N=b0["N"], timesteps=b0["timesteps"])
    lanes = [serve_lane(b) for b in bodies]
    if "mesh" in b0:
        res = ensemble_sharded.solve_ensemble_sharded(
            p, lanes, tuple(b0["mesh"]), kernel="pallas",
            devices=[DEV] * SHARDS)
    else:
        res = ensemble.solve_ensemble(p, lanes, path="kfused", k=K,
                                      device=DEV)
    out = [(r.abs_errors, r.rel_errors) for r in res.results]
    del res
    torch.cuda.empty_cache()
    return out


def serve_run(base, label, lane_errors, card):
    """One phase-10 run: the bodies concurrently, counters zeroed just
    before and read just after; one batched batch of every body, the
    exact counts, 200s, each answer's errors bit-equal to its reference.
    Returns (counts, answers, summary)."""
    from wavetpu_torch.io import report
    from wavetpu_torch.solver.leapfrog import SolveResult

    bodies, want, _ = SERVE_RUNS[label]
    stencil_cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    answers = serve_concurrent(base, bodies)
    torch.cuda.synchronize()
    counts = kernel_launches(stencil_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    expected = {c: want.get(c, 0) for c in counts}
    if counts != expected:
        fail(f"{label}: launches {counts}, expected {expected}")
    for i, (code, payload, headers, wall) in enumerate(answers):
        if code != 200:
            fail(f"{label} request {i}: {code} {payload}")
        b = payload["batch"]
        if not (b["batched"] and b["occupancy"] == len(bodies)
                and b["batch_size"] == (4 if len(bodies) == 3 else 2)
                and b["fallback_reason"] is None):
            fail(f"{label} request {i}: batch {b}")
    for i, ref in enumerate(serve_reference(label, bodies, lane_errors)):
        rep = answers[i][1]["report"]
        if ref is None:
            if rep["errors_computed"]:
                fail(f"{label} request {i}: a field request with errors")
            continue
        if not (np.array_equal(rep["abs_errors"], ref[0])
                and np.array_equal(rep["rel_errors"], ref[1])):
            fail(f"{label} request {i}: errors differ from its reference")
        # The report text, byte for byte: the lane's errors with the
        # response's own timings.
        shown = SolveResult(
            problem=Problem(N=bodies[i]["N"], T=1.0,
                            timesteps=bodies[i]["timesteps"]),
            u_prev=None, u_cur=None, abs_errors=np.asarray(ref[0]),
            rel_errors=np.asarray(ref[1]),
            init_seconds=rep["init_seconds"],
            solve_seconds=rep["solve_seconds"],
            steps_computed=rep["final_step"], final_step=rep["final_step"])
        if answers[i][1]["report_text"] != report.format_report(shown):
            fail(f"{label} request {i}: report_text differs")
    b = answers[0][1]["batch"]
    timing = answers[0][1]["batch"]["timing"]
    summary = dict(
        batch_solve_seconds=answers[0][1]["report"]["solve_seconds"],
        aggregate_gcells_per_s=b["aggregate_gcells_per_s"],
        request_seconds=[a[3] for a in answers], compile_s=timing[
            "compile_s"], warm=b["warm"], peak_bytes=peak)
    print(f"  {label}: occupancy {b['occupancy']} in bucket "
          f"{b['batch_size']}, launches "
          f"{ {c: v for c, v in counts.items() if v} }, batch solve "
          f"{summary['batch_solve_seconds']!r} s, aggregate "
          f"{b['aggregate_gcells_per_s']!r} Gcell/s, requests "
          f"{summary['request_seconds']!r} s, compile {timing['compile_s']!r}"
          f" s (warm {b['warm']}), allocator peak {peak} B ({card})")
    return counts, answers, summary


def body_key(body):
    return json.dumps(body, sort_keys=True)


def time_parses(walls):
    """Wrap the replica's `parse_solve_request` so each body's parse wall,
    as its handler thread pays it (a c2-field body builds its preset
    there, before the queue wait begins), lands in `walls` under the
    body.  Returns the function to put back."""
    from wavetpu_torch.serve import api

    parse = api.parse_solve_request

    def timed(body, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return parse(body, *args, **kwargs)
        finally:
            walls[body_key(body)] = time.perf_counter() - t0

    api.parse_solve_request = timed
    return parse


def parse_walls(walls, bodies):
    """The bodies' recorded parse walls, taken out of `walls`."""
    missing = [b for b in bodies if body_key(b) not in walls]
    if missing:
        fail(f"no parse wall recorded for {missing}")
    return [walls.pop(body_key(b)) for b in bodies]


def serve_contract(base, answers):
    """/healthz's memory fields from the card, /metrics JSON against its
    Prometheus text, Server-Timing's components against its total, and no
    fallback.  `answers`: [(the bodies sent together, their answers,
    their parse walls)].  Server-Timing's queue + compile + execute must
    be the total within 10% + 10 ms (tests/test_serve.py's bound); the
    total also holds the body's parse, which the handler pays before the
    queue wait begins (a c2-field body builds its preset there), so an
    answer may exceed that bound by its own parse wall, measured in the
    handler thread as it runs."""
    health = serve_get(base, "/healthz")
    for key in ("memory_bytes_in_use", "memory_peak_bytes"):
        if not (isinstance(health[key], int) and health[key] > 0):
            fail(f"/healthz {key} = {health[key]!r}")
    if health["backend"] != "gpu" or not health["ready"]:
        fail(f"/healthz {health}")
    snap = serve_get(base, "/metrics")
    samples = prom_text_samples(serve_get(base, "/metrics", "text/plain"))
    occ_sum = samples["wavetpu_serve_batch_occupancy_sum"]
    occ_n = samples["wavetpu_serve_batch_occupancy_count"]
    agg = (samples["wavetpu_serve_cells_total"]
           / samples["wavetpu_serve_solve_seconds_total"] / 1e9)
    if not (samples["wavetpu_serve_requests_total"]
            == snap["requests_total"]
            and occ_n == snap["batches_total"]
            and abs(occ_sum / occ_n - snap["batch_occupancy_mean"]) < 1e-9
            and abs(agg - snap["aggregate_gcells_per_s"]) <= 5e-5):
        fail(f"/metrics JSON {snap} and Prometheus {samples} disagree")
    if snap["fallback_batches"] or snap["program_cache"]["fallbacks"]:
        fail(f"fallbacks: {snap['fallback_batches']} "
             f"{snap['program_cache']['fallbacks']}")
    gaps = []
    for bodies, got, parsed in answers:
        for body, (code, payload, headers, wall), parse in zip(
                bodies, got, parsed):
            st = server_timing(headers.get("Server-Timing"))
            gap = st["total"] - (st["queue"] + st["compile"]
                                 + st["execute"])
            if not (-0.1 * st["total"] - 0.010 <= gap
                    <= 0.1 * st["total"] + 0.010 + parse) or \
                    st["total"] > wall + 0.010:
                fail(f"Server-Timing {st} (client {wall} s, parse "
                     f"{parse} s)")
            if body.get("c2_field"):
                gaps.append((body["N"], gap, parse))
    print(f"  Server-Timing: queue + compile + execute within 10% + 10 ms "
          f"of total beside each request's parse; the field requests' gap "
          f"beside their parse (N, gap s, parse s): {gaps}")
    print(f"  contract: /healthz memory {health['memory_bytes_in_use']} B "
          f"in use, peak {health['memory_peak_bytes']} B; /metrics "
          f"requests {snap['requests_total']}, batches "
          f"{snap['batches_total']}, occupancy mean "
          f"{snap['batch_occupancy_mean']!r}, aggregate "
          f"{snap['aggregate_gcells_per_s']!r} Gcell/s (JSON = Prometheus),"
          f" fallbacks 0, Server-Timing sums within 10% of its total")
    return dict(requests=snap["requests_total"],
                batches=snap["batches_total"],
                aggregate_gcells_per_s=snap["aggregate_gcells_per_s"],
                memory_peak_bytes=health["memory_peak_bytes"])


def prom_text_samples(text):
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def serve_rows(throughput, card):
    """bench.py's serving rows through a replica on the card: for B = 1,
    2, 4, 8 a replica of bucket B and max_batch B, its program warmed,
    2B concurrent requests; aggregate Gcell/s from /metrics (the batches'
    solve seconds, bench.py's) and from the requests' wall, p50/p95
    latency, speedup_vs_batch1, beside phase 9's solve_ensemble row."""
    out = {}
    for label, extra, ref in SERVE_ROWS:
        row = {}
        p = Problem(N=SERVE_N, timesteps=100)
        for b in (1, 2, 4, 8):
            httpd, state, base = start_replica(bucket_sizes=(b,),
                                               max_batch=b, max_wait=0.25)
            try:
                path = "kfused" if extra else "pallas"
                if not state.engine.warmup(
                        p, scheme=extra.get("scheme", "standard"),
                        path=path, k=K, batches=[b]):
                    fail(f"serve row {label} B={b}: warmup fell back")
                bodies = [dict(N=SERVE_N, timesteps=100,
                               phase=oracle_phase(i), **extra)
                          for i in range(2 * b)]
                t0 = time.perf_counter()
                answers = serve_concurrent(base, bodies)
                wall = time.perf_counter() - t0
                if any(a[0] != 200 or not a[1]["batch"]["batched"]
                       for a in answers):
                    fail(f"serve row {label} B={b}: {answers[0][1]}")
                snap = serve_get(base, "/metrics")
            finally:
                stop_replica(httpd, state)
            lat = sorted(a[3] for a in answers)

            def pct(q):
                return lat[min(len(lat) - 1,
                               int(round(q * (len(lat) - 1))))]

            row[b] = dict(
                aggregate_gcells_per_s=snap["aggregate_gcells_per_s"],
                wall_gcells_per_s=(p.cells_per_step * 100 * 2 * b / wall
                                   / 1e9),
                latency_p50_s=pct(0.50), latency_p95_s=pct(0.95),
                occupancy_max=snap["batch_occupancy_max"],
                solve_ensemble_gcells_per_s=throughput[ref][b][
                    "aggregate_gcells_per_second"])
        base1 = row[1]["aggregate_gcells_per_s"]
        for b, r in row.items():
            r["speedup_vs_batch1"] = r["aggregate_gcells_per_s"] / base1
            print(f"  serve row {label} N={SERVE_N}/100 B={b}: aggregate "
                  f"{r['aggregate_gcells_per_s']!r} Gcell/s (by wall "
                  f"{r['wall_gcells_per_s']!r}), p50 "
                  f"{r['latency_p50_s']!r} s, p95 {r['latency_p95_s']!r} s,"
                  f" speedup_vs_batch1 {r['speedup_vs_batch1']!r}, occupancy"
                  f" max {r['occupancy_max']}; solve_ensemble "
                  f"{r['solve_ensemble_gcells_per_s']!r} Gcell/s ({card})")
        out[label] = row
        torch.cuda.empty_cache()
    return out


def phase_serve(card, lane_errors, throughput, flagship_err):
    """Phase 10: the replica in this process on the card, over HTTP - the
    flagship at full width and the other lane modes with exact counts,
    held bit-equal; the watchdog pair; the HTTP contract; the serving
    rows.  Returns (launches per run, measurements)."""
    from wavetpu_torch.serve import api

    torch.cuda.empty_cache()
    counts, measured, answers, walls = {}, {}, [], {}
    parse = time_parses(walls)
    httpd, state, base = start_replica(max_wait=1.0)
    try:
        for label in SERVE_RUNS:
            counts[label], got, measured[label] = serve_run(
                base, label, lane_errors, card)
            bodies = SERVE_RUNS[label][0]
            answers.append((bodies, got, parse_walls(walls, bodies)))
            torch.cuda.empty_cache()
        err = answers[0][1][0][1]["report"]["max_abs_error"]
        if err != flagship_err:
            fail(f"serve_flagship 2 pi max abs error {err!r} is not phase "
                 f"3's flagship's {flagship_err!r}")
        codes = serve_concurrent(base, POISON_BODIES)
        if [c[0] for c in codes] != [200, 422] or \
                "amax" not in codes[1][1]["error"] or \
                codes[0][1]["batch"]["occupancy"] != 2:
            fail(f"watchdog pair: "
                 f"{[(c[0], c[1].get('error')) for c in codes]}")
        print(f"  watchdog pair: [200, 422] in one batch, the 422 "
              f"{codes[1][1]['error']!r}")
        measured["contract"] = serve_contract(
            base, answers + [(POISON_BODIES, codes,
                              parse_walls(walls, POISON_BODIES))])
    finally:
        stop_replica(httpd, state)
        api.parse_solve_request = parse
    measured["rows"] = serve_rows(throughput, card)
    return counts, measured


# C1 (ROADMAP.md queue 3): K12's distance from the single-device flagship
# as the march lengthens.  tau stays 1e-3 (T grows with the steps), so the
# runs march the same scheme further; 1000 steps is phase 4's pair.
C1_STEPS = (2000, 4000)


def phase_c1(accuracy):
    """sharded_flagship_221 (K12) against the flagship (K4) at N=512 for
    2000 and 4000 steps: max |du| and the error vectors' max distance,
    beside phase 4's 1000-step pair."""
    rec = accuracy["sharded_flagship_221_vs_flagship"]
    out = {STEPS: dict(max_abs_du=rec["max_abs_du"],
                       max_abs_d_abs_errors=rec["max_abs_d_abs_errors"])}
    for steps in C1_STEPS:
        p = Problem(N=N_FULL, T=steps / STEPS, timesteps=steps)
        single = kfused_comp.solve_kfused_comp(p, k=K, device=DEV)
        res = kfused_comp.solve_kfused_comp_sharded(
            p, mesh_shape=(2, 2, 1), k=K, devices=[DEV] * SHARDS)
        du = (res.u_cur.fundamental(DEV) - single.u_cur).abs().max().item()
        de = float(np.max(np.abs(res.abs_errors - single.abs_errors)))
        out[steps] = dict(max_abs_du=du, max_abs_d_abs_errors=de,
                          flagship_max_abs_error=float(
                              single.abs_errors.max()))
        del single, res
        torch.cuda.empty_cache()
    for steps, r in out.items():
        print(f"  C1: sharded_flagship_221 vs flagship at {steps} steps: "
              f"max|du| {r['max_abs_du']!r}, max|d abs_errors| "
              f"{r['max_abs_d_abs_errors']!r}")
    return out


# Phase 11: serving's warm state and long solves (serve/progcache.py,
# serve/preempt.py, serve/resultcache.py, serve/shadow.py) through the
# replica at full width: N=512/1000 and bench.py's serving shape N=256/100.
LONG_BODY = dict(N=N_FULL, T=1.0, timesteps=STEPS)
SHORT_BODY = dict(N=SERVE_N, T=1.0, timesteps=100)
CHUNK_THRESHOLD, CHUNK_STEPS = 500, 200
N_CHUNKS = -(-(STEPS - 1) // CHUNK_STEPS)
# The deadline of the request that the second replica resumes: a few
# chunks into the march (the N=512 1-step march runs ~0.9 s, a 200-step
# chunk ~0.18 s; the deadline is read at chunk boundaries).
RESUME_DEADLINE_MS = 400
# The warmup manifest's keys (ledger-report's shape): the N=512/1000 f32
# standard key with these fields changed.
WARM_KEYS = (dict(path="pallas"), dict(path="kfused", k=K),
             dict(scheme="compensated", path="kfused", k=K, batch=4),
             dict(N=SERVE_N, timesteps=100, path="pallas", batch=8))


def warm_key(over):
    key = dict(N=N_FULL, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=STEPS,
               scheme="standard", path="pallas", k=1, dtype="f32",
               with_field=False, compute_errors=True, batch=1, mesh=None)
    key.update(over)
    return key


def short_bodies(n):
    return [dict(SHORT_BODY, phase=oracle_phase(i)) for i in range(n)]


def serve_post_raw(base, body, headers=None, timeout=900):
    """POST /solve -> (status, raw body bytes, headers)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + "/solve", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def same_errors(label, payload, want):
    """A /solve answer's error vectors bit-equal to (abs, rel)."""
    rep = payload["report"]
    if not (np.array_equal(rep["abs_errors"], want[0])
            and np.array_equal(rep["rel_errors"], want[1])):
        fail(f"{label}: error vectors differ from the reference")


def phase3_errors(sides, label):
    e = side_errors(sides[label])
    return e["abs"], e["rel"]


def counted(label, want, fn):
    """Run fn() with the counters zeroed just before and read just after;
    every counter must equal want's (0 when not listed)."""
    stencil_cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = kernel_launches(stencil_cuda.launches)
    expected = {c: want.get(c, 0) for c in got}
    if got != expected:
        fail(f"{label}: launches {got}, expected {expected}")
    return out, {c: v for c, v in got.items() if v}


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_replica(tmp, name, flags, build_dir, telemetry=None, env=None):
    """`python -m wavetpu_torch serve` started in its own process with its
    own build directory (and its own telemetry directory unless
    `telemetry` names a shared one); returns (process, base URL, spawn
    time, log path) without waiting."""
    port = free_port()
    log_path = os.path.join(tmp, f"{name}.log")
    env = dict(os.environ, WAVETPU_TORCH_BUILD_DIR=build_dir, **(env or {}))
    t_spawn = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "wavetpu_torch", "serve", "--port",
             str(port), "--max-wait-ms", "200", "--telemetry-dir",
             telemetry or os.path.join(tmp, f"tel_{name}")]
            + flags + CLI_EXTRA,
            env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
    return proc, f"http://127.0.0.1:{port}", t_spawn, log_path


def wait_healthz(proc, base, name, log_path, timeout=300):
    """Wait until the process answers /healthz; fail if it exits first."""
    deadline = time.monotonic() + timeout
    while True:
        if proc.poll() is not None:
            fail(f"{name} exited {proc.returncode}: "
                 f"{open(log_path).read()[-2000:]}")
        try:
            return serve_get(base, "/healthz")
        except OSError:
            if time.monotonic() > deadline:
                proc.kill()
                fail(f"{name} never answered /healthz")
            time.sleep(0.1)


def replica_process(tmp, name, flags, build_dir):
    """`python -m wavetpu_torch serve` in its own process with its own
    build directory and telemetry; returns (process, base URL, spawn
    time, log path) once /healthz answers."""
    proc, base, t_spawn, log_path = spawn_replica(tmp, name, flags,
                                                  build_dir)
    wait_healthz(proc, base, f"replica {name}", log_path)
    return proc, base, t_spawn, log_path


def stop_process(proc, log_path):
    """SIGTERM (drain), wait, and the replica's log."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)
    with open(log_path) as f:
        return f.read()


def kernel_stats(log):
    """The replica's shutdown line: nvcc runs, their seconds, disk loads
    and first-launch seconds."""
    m = re.search(r"kernel libraries: (\d+) nvcc run\(s\) \(([\d.]+) s\), "
                  r"(\d+) disk load\(s\), (\d+) load\(s\); first launches "
                  r"([\d.]+) s", log)
    if m is None:
        fail(f"no kernel-library line in the replica's log: {log[-2000:]}")
    return dict(nvcc_runs=int(m.group(1)), nvcc_s=float(m.group(2)),
                disk_loads=int(m.group(3)), loads=int(m.group(4)),
                first_launch_s=float(m.group(5)))


def phase_cold_start(card, sides, lane_errors):
    """11a (bench.py's _cold_start_row at the port's scale): `warmup`
    fills a fresh --program-cache-dir from a ledger-report manifest with
    phase 1's libraries; a replica with an empty build directory and that
    cache answers every manifest key with zero nvcc runs (its shutdown
    line, /metrics and its compile ledger: source disk), each answer
    bit-equal to phases 3, 9 and 10; a cold replica (empty build
    directory, no cache) pays nvcc once a library of the 1-step path.
    Time to first solve of both."""
    from wavetpu_torch.obs import ledger

    tmp = tempfile.mkdtemp(prefix="wt-coldstart-")
    procs = []
    try:
        lp = os.path.join(tmp, "compile_ledger.jsonl")
        led = ledger.CompileLedger(lp)
        for over in WARM_KEYS:
            led.record(warm_key(over), 0.0, ts=1.0, pid=1)
        led.close()
        mp = os.path.join(tmp, "manifest.json")
        with contextlib.redirect_stdout(io.StringIO()):
            if ledger.main([lp, "--emit-warmup-manifest", mp]) != 0:
                fail("ledger-report --emit-warmup-manifest failed")
        cache = os.path.join(tmp, "pc")
        t0 = time.perf_counter()
        warm = subprocess.run(
            [sys.executable, "-m", "wavetpu_torch", "warmup", "--manifest",
             mp, "--program-cache-dir", cache] + CLI_EXTRA,
            env=dict(os.environ,
                     WAVETPU_TORCH_BUILD_DIR=str(build.build_dir())),
            capture_output=True, text=True, timeout=600)
        warmup_s = time.perf_counter() - t0
        if warm.returncode != 0 or \
                f"{len(WARM_KEYS)} compiled" not in warm.stdout:
            fail(f"warmup: rc {warm.returncode} {warm.stdout} "
                 f"{warm.stderr}")
        cache_bytes = dir_bytes(cache)
        print(f"  warmup: {len(WARM_KEYS)} keys into {cache_bytes} B of "
              f"cache in {warmup_s!r} s (subprocess wall)")

        # The adopting replica: a new, empty build directory.
        proc, base, t_spawn, log = replica_process(
            tmp, "adopt", ["--program-cache-dir", cache],
            os.path.join(tmp, "build_adopt"))
        procs.append((proc, log))
        ready_s = time.perf_counter() - t_spawn
        code, first, _ = serve_post(base, LONG_BODY)
        ttfs_adopt = time.perf_counter() - t_spawn
        if code != 200:
            fail(f"adopting replica: {code} {first}")
        same_errors("adopted pallas N=512", first,
                    phase3_errors(sides, "default"))
        code, kf, _ = serve_post(base, dict(LONG_BODY, fuse_steps=K))
        if code != 200:
            fail(f"adopting replica kfused: {code} {kf}")
        same_errors("adopted kfused N=512", kf,
                    phase3_errors(sides, "kfused"))
        bodies = SERVE_RUNS["serve_flagship"][0]
        flag = serve_concurrent(base, bodies)
        for i, ref in enumerate(serve_reference("serve_flagship", bodies,
                                                lane_errors)):
            if flag[i][0] != 200 or flag[i][1]["batch"]["batch_size"] != 4:
                fail(f"adopted flagship {i}: {flag[i][0]} {flag[i][1]}")
            same_errors(f"adopted flagship {i}", flag[i][1], ref)
        shorts = serve_concurrent(base, short_bodies(8))
        if any(a[0] != 200 or a[1]["batch"]["batch_size"] != 8
               for a in shorts):
            fail(f"adopted N=256 batch: {[a[0] for a in shorts]}")
        metrics = serve_get(base, "/metrics")["program_cache"]
        log_text = stop_process(proc, log)
        procs.pop()
        stats = kernel_stats(log_text)
        lines = ledger.load_ledger(os.path.join(tmp, "tel_adopt",
                                                ledger.LEDGER_FILENAME))
        sources = [line.get("source") for line in lines]
        if not (stats["nvcc_runs"] == 0 and metrics["misses"] == 0
                and metrics["disk_hits"] == len(WARM_KEYS)
                and sources == ["disk"] * len(WARM_KEYS)):
            fail(f"adopting replica: nvcc runs {stats['nvcc_runs']}, "
                 f"misses {metrics['misses']}, disk hits "
                 f"{metrics['disk_hits']}, ledger sources {sources}")
        adopt_s = {f"{ln['key']['path']} b={ln['key']['batch']} "
                   f"N={ln['key']['N']}": ln["compile_s"] for ln in lines}
        # Phase 3/9/10's references for the N=256 batch: solve_ensemble
        # of the same lanes here.
        p = Problem(N=SHORT_BODY["N"], timesteps=SHORT_BODY["timesteps"])
        ens = ensemble.solve_ensemble(
            p, [serve_lane(b) for b in short_bodies(8)], path="pallas",
            device=DEV)
        for i, r in enumerate(ens.results):
            same_errors(f"adopted N=256 lane {i}", shorts[i][1],
                        (r.abs_errors, r.rel_errors))
        del ens

        # The cold arm: an empty build directory and no cache.
        proc, base, t_spawn, log = replica_process(
            tmp, "cold", [], os.path.join(tmp, "build_cold"))
        procs.append((proc, log))
        cold_ready_s = time.perf_counter() - t_spawn
        code, cold, _ = serve_post(base, LONG_BODY)
        ttfs_cold = time.perf_counter() - t_spawn
        if code != 200:
            fail(f"cold replica: {code} {cold}")
        same_errors("cold pallas N=512", cold,
                    phase3_errors(sides, "default"))
        cold_stats = kernel_stats(stop_process(proc, log))
        procs.pop()
        # One nvcc run a library the 1-step pallas path launches.
        cold_libs = stencil_cuda.libraries_for("pallas")
        if cold_stats["nvcc_runs"] != len(cold_libs):
            fail(f"cold replica: {cold_stats['nvcc_runs']} nvcc runs, "
                 f"expected {len(cold_libs)} ({cold_libs})")
        out = dict(
            warmup_s=warmup_s, cache_bytes=cache_bytes,
            ttfs_adopt_s=ttfs_adopt, ttfs_cold_s=ttfs_cold,
            ready_adopt_s=ready_s, ready_cold_s=cold_ready_s,
            adopt_compile_s=adopt_s, adopt=stats, cold=cold_stats,
            first_compile_s_adopt=first["batch"]["timing"]["compile_s"],
            first_compile_s_cold=cold["batch"]["timing"]["compile_s"])
        print(f"  time to first solve (N=512/1000 pallas, spawn to "
              f"answer): adopted {ttfs_adopt!r} s (ready {ready_s!r} s; "
              f"its compile {out['first_compile_s_adopt']!r} s), cold "
              f"{ttfs_cold!r} s (ready {cold_ready_s!r} s; nvcc "
              f"{cold_stats['nvcc_s']!r} s, compile "
              f"{out['first_compile_s_cold']!r} s) ({card})")
        print(f"  adopt walls per key {adopt_s}; first launches: adopted "
              f"replica {stats['first_launch_s']!r} s over its keys, cold "
              f"{cold_stats['first_launch_s']!r} s; nvcc runs 0 and "
              f"{cold_stats['nvcc_runs']} ({card})")
        return out
    finally:
        for proc, log in procs:
            stop_process(proc, log)
        shutil.rmtree(tmp, ignore_errors=True)


def interleaved(base, state, chunked):
    """The long pallas march with six N=256/100 requests submitted at once
    while it runs: (long wall, short latencies, every short answered
    before the long)."""
    import threading

    before = state.metrics.snapshot()["chunks_total"]
    out = {}

    def long_one():
        t = time.perf_counter()
        out["long"] = serve_post(base, LONG_BODY)
        out["long_wall"] = time.perf_counter() - t
        out["long_done"] = time.perf_counter()

    th = threading.Thread(target=long_one)
    th.start()
    # Wait for the march to be running: its first chunk done (chunked),
    # or its batch formed (monolithic: the queue empty again).
    t_start = time.monotonic()
    while time.monotonic() < t_start + 60:
        snap = state.metrics.snapshot()
        if chunked and snap["chunks_total"] > before:
            break
        if not chunked and snap["queue_depth"] == 0 and \
                time.monotonic() > t_start + 0.1:
            break
        time.sleep(0.005)
    shorts = serve_concurrent(base, short_bodies(6))
    done = time.perf_counter()
    th.join(900)
    if out["long"][0] != 200 or any(a[0] != 200 for a in shorts):
        fail(f"interleaved run (chunked {chunked}): "
             f"{out['long'][0]} {[a[0] for a in shorts]}")
    lat = sorted(a[3] for a in shorts)
    return out["long_wall"], lat, done < out["long_done"]


def phase_long_solves(card, sides):
    """11b-c (bench.py's _preemptible_row at N=512/1000): chunked pallas
    and kfused marches with exact counts, bit-equal to phase 3; six
    N=256/100 requests answered while the long march runs, their p95
    beside a monolithic replica's; a deadline that expires mid-march
    answers 504 with a token, which a second replica sharing the state
    directory resumes to the uninterrupted answer (K1 launches of the two
    halves summing to 1000); a byte-flipped token file answers 422."""
    tmp = tempfile.mkdtemp(prefix="wt-state-")
    chunked_kw = dict(max_wait=0.01, chunk_threshold=CHUNK_THRESHOLD,
                      chunk_steps=CHUNK_STEPS, solve_state_dir=tmp)
    replicas = []
    try:
        replicas.append(start_replica(**chunked_kw))
        replicas.append(start_replica(max_wait=0.01))
        (_, cstate, cbase), (_, mstate, mbase) = replicas
        out, counts = {}, {}
        for label, body, want, ref in (
                ("chunked_pallas", LONG_BODY,
                 {"step": STEPS, "layer_errors": STEPS}, "default"),
                ("chunked_kfused", dict(LONG_BODY, fuse_steps=K),
                 {"kstep": NB, "step": 1 + REM, "layer_errors": 1 + REM},
                 "kfused")):
            t0 = time.perf_counter()
            (code, payload, _), counts[label] = counted(
                label, want, lambda b=body: serve_post(cbase, b))
            wall = time.perf_counter() - t0
            b = payload.get("batch", {})
            if code != 200 or not b.get("chunked") or \
                    b.get("chunks") != N_CHUNKS:
                fail(f"{label}: {code} {b}")
            same_errors(label, payload, phase3_errors(sides, ref))
            out[label] = dict(wall_s=wall, launches=counts[label],
                              timing=b["timing"])
            print(f"  {label}: {N_CHUNKS} chunks of {b['chunk_len']}, "
                  f"launches {counts[label]}, wall {wall!r} s, solve "
                  f"{b['timing']['execute_s']!r} s, bit-equal to phase 3 "
                  f"({card})")
        for base in (cbase, mbase):  # the shorts' program, warm
            serve_concurrent(base, short_bodies(6))
        t0 = time.perf_counter()
        code, mono, _ = serve_post(mbase, LONG_BODY)
        mono_wall = time.perf_counter() - t0
        if code != 200 or mono["batch"].get("chunked"):
            fail(f"monolithic long: {code}")
        same_errors("monolithic long", mono, phase3_errors(sides,
                                                           "default"))
        c_long, c_lat, c_before = interleaved(cbase, cstate, True)
        m_long, m_lat, _ = interleaved(mbase, mstate, False)
        if not c_before:
            fail("a short request was answered after the chunked march")
        p95 = {arm: lat[min(len(lat) - 1, int(0.95 * len(lat)))]
               for arm, lat in (("chunked", c_lat), ("monolithic", m_lat))}
        out["interleave"] = dict(
            short_latencies_s=dict(chunked=c_lat, monolithic=m_lat),
            short_p95_s=p95, long_wall_s=dict(chunked=c_long,
                                              monolithic=m_long),
            long_alone_wall_s=dict(chunked=out["chunked_pallas"]["wall_s"],
                                   monolithic=mono_wall))
        print(f"  six N=256/100 requests behind the N=512/1000 march: p95 "
              f"{p95['chunked']!r} s chunked vs {p95['monolithic']!r} s "
              f"monolithic, all answered before the chunked march ended; "
              f"long wall alone {out['chunked_pallas']['wall_s']!r} s "
              f"chunked vs {mono_wall!r} s monolithic (with the shorts "
              f"{c_long!r} vs {m_long!r} s) ({card})")

        # 11c: resume across replicas.
        replicas.append(start_replica(**chunked_kw))
        rbase = replicas[-1][2]
        stencil_cuda.reset_launches()
        t0 = time.perf_counter()
        code, cut, _ = serve_post(cbase, dict(
            LONG_BODY, deadline_ms=RESUME_DEADLINE_MS))
        cut_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        first_half = kernel_launches(stencil_cuda.launches, nonzero=True)
        token = cut.get("resume_token")
        if code != 504 or token is None:
            fail(f"deadline mid-march: {code} {cut}")
        stencil_cuda.reset_launches()
        t0 = time.perf_counter()
        code, resumed, _ = serve_post(rbase, dict(LONG_BODY,
                                                  resume_token=token))
        resume_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        second_half = kernel_launches(stencil_cuda.launches, nonzero=True)
        step = resumed.get("batch", {}).get("resumed_from")
        if code != 200 or not step:
            fail(f"resume on the second replica: {code} {resumed}")
        if not (first_half == {"step": step, "layer_errors": step}
                and second_half == {"step": STEPS - step,
                                    "layer_errors": STEPS - step}):
            fail(f"resume launches {first_half} + {second_half}, expected "
                 f"K1 x{step} + x{STEPS - step}")
        same_errors("resumed", resumed, phase3_errors(sides, "default"))
        path = os.path.join(tmp, f"st-{token}.npz")
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        code, bad, _ = serve_post(rbase, dict(LONG_BODY,
                                              resume_token=token))
        if code != 422:
            fail(f"byte-flipped token: {code} {bad}")
        out["resume"] = dict(step=step, first_half=first_half,
                             second_half=second_half, cut_wall_s=cut_wall,
                             resume_wall_s=resume_wall,
                             token_bytes=os.path.getsize(path),
                             resumed_timing=resumed["batch"]["timing"])
        print(f"  deadline {RESUME_DEADLINE_MS} ms: 504 with a token at "
              f"step {step} after {cut_wall!r} s; the second replica "
              f"resumed it in {resume_wall!r} s, K1 x{step} + "
              f"x{STEPS - step}, "
              f"bit-equal to phase 3; token file "
              f"{out['resume']['token_bytes']} B; flipped byte -> 422 "
              f"({card})")
        return out, counts
    finally:
        for httpd, state, _ in replicas:
            stop_replica(httpd, state)
        shutil.rmtree(tmp, ignore_errors=True)


def phase_result_cache_and_shadow(card):
    """11d-e: with --result-cache a repeated N=256/100 request answers
    byte-identical and no launch counter moves; with --shadow-sample-rate
    1.0 an N=256/100 kfused request's answer equals a shadow-less
    replica's, its twin runs K2's lane mode (counted exactly: the
    reference plan, compensated k=1 f32, through `pallas` on the card)
    and the divergence reaches the accuracy ledger (source "shadow")."""
    from wavetpu_torch.obs import accuracy as obs_accuracy
    from wavetpu_torch.obs import telemetry

    out = {}
    httpd, state, base = start_replica(max_wait=0.01, result_cache=True)
    try:
        code, fresh, h1 = serve_post_raw(base, SHORT_BODY)
        (code2, hit, h2), moved = counted(
            "result-cache hit", {}, lambda: serve_post_raw(base, SHORT_BODY))
        if not (code == code2 == 200 and hit == fresh
                and h2.get("X-Wavetpu-Cache") == "hit"
                and h1.get("X-Wavetpu-Cache", "").startswith("store;fp=")):
            fail(f"result cache: {code} {code2} {h1.get('X-Wavetpu-Cache')}"
                 f" {h2.get('X-Wavetpu-Cache')} equal={hit == fresh}")
        out["result_cache"] = dict(bytes=len(fresh), store=h1.get(
            "X-Wavetpu-Cache"), hit_server_timing=h2.get("Server-Timing"))
        print(f"  result cache: the repeat is byte-identical ({len(fresh)} "
              f"B, {h1.get('X-Wavetpu-Cache')}), no launch between "
              f"({h2.get('Server-Timing')})")
    finally:
        stop_replica(httpd, state)

    body = dict(SHORT_BODY, fuse_steps=K)
    tmp = tempfile.mkdtemp(prefix="wt-shadow-")
    replicas = []
    try:
        replicas.append(start_replica(max_wait=0.01, shadow_sample_rate=1.0))
        replicas.append(start_replica(max_wait=0.01))
        (_, sstate, sbase), (_, _, pbase) = replicas
        for base in (sbase, pbase):  # warm both tiers
            serve_post(base, dict(body, phase=1.0))
        sstate.shadow.wait_idle(300)
        deadline = time.monotonic() + 60
        while sstate.shadow.snapshot()["solves"] < 1 and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        tel = telemetry.start(tmp, registry=sstate.metrics.registry)
        try:
            def primary_and_twin():
                answer = serve_post(sbase, body)
                t_end = time.monotonic() + 300
                while sstate.shadow.snapshot()["solves"] < 2 and \
                        time.monotonic() < t_end:
                    time.sleep(0.01)
                sstate.shadow.wait_idle(300)
                return answer

            steps = SHORT_BODY["timesteps"]
            (code, shadowed, _), moved = counted(
                "shadowed kfused N=256/100",
                {"kstep_lanes": (steps - 1) // K,
                 "step_lanes": 1 + (steps - 1) % K,
                 "comp_step_lanes": steps,
                 # The primary's layer 1 and tail, every layer of the
                 # 1-step compensated twin.
                 "layer_errors": 1 + (steps - 1) % K + steps},
                primary_and_twin)
        finally:
            tel.stop()
        code2, plain, _ = serve_post(pbase, body)
        if code != 200 or code2 != 200:
            fail(f"shadow: {code} {code2}")
        keys = ("abs_errors", "rel_errors", "max_abs_error", "final_step")
        if {k: shadowed["report"][k] for k in keys} != \
                {k: plain["report"][k] for k in keys} or \
                set(shadowed) != set(plain):
            fail("the shadowed answer differs from the shadow-less one")
        recs = obs_accuracy.load_accuracy_ledger(
            os.path.join(tmp, obs_accuracy.ACCURACY_FILENAME))
        lines = [r for r in recs if r["source"] == "shadow"]
        snap = sstate.shadow.snapshot()
        if len(lines) != 1 or snap["failures"]:
            fail(f"shadow ledger lines {lines}, sampler {snap}")
        out["shadow"] = dict(launches=moved, divergence=lines[0][
            "max_abs_err"], plan=lines[0]["plan"], sampler=snap)
        print(f"  shadow: primary equal to a shadow-less replica's; "
              f"launches {moved} (the twin: K2 lanes x{steps}); "
              f"divergence "
              f"{lines[0]['max_abs_err']!r} ledgered for "
              f"{lines[0]['plan']} ({card})")
    finally:
        for httpd, state, _ in replicas:
            stop_replica(httpd, state)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_warm_state(card, sides, lane_errors):
    """Phase 11: 11a cold start through the disk tier, 11b-c chunked long
    solves and resume across replicas, 11d-e the result cache and shadow
    sampling.  Returns (launches per counted run, measurements)."""
    torch.cuda.empty_cache()
    measured = {"cold_start": phase_cold_start(card, sides, lane_errors)}
    torch.cuda.empty_cache()
    long_solves, counts = phase_long_solves(card, sides)
    measured["long_solves"] = long_solves
    torch.cuda.empty_cache()
    measured.update(phase_result_cache_and_shadow(card))
    counts["shadow_kfused_N256"] = measured["shadow"]["launches"]
    return counts, measured


# Phase 12: the fleet tier (wavetpu_torch/fleet, wavetpu_torch/loadgen) in
# front of replica processes on the card.  Replica A holds the flagship and
# the N=512 standard tier in its program cache, replica B the N=256 tiers
# only (A holds those too): with one cache shared by both, every member
# would advertise every disk key and the router could not single one out.
# A's march of the N=512 standard tier is slowed before each chunk pass
# after the first (serve-slow-batch, selected by that tier's identity
# alone), so the roll's drain lands mid-march.
FLEET_HOLD_S = 10
FLEET_QPS = 4.0
FLEET_DURATION_S = 15
FLEET_POLL_S = 0.5
# bench.py's B=8 serving rows through the router: 2B requests of N=256/100.
FLEET_ROW_B = 8


def fleet_config():
    """Phase 12's sizes on the card: the main path's width and depth, the
    N=256/100 serving tier and phase 11's chunking.  (A CPU rehearsal at a
    small size passes its own, with `count` False: the CPU launches no
    CUDA kernel to count.)"""
    return dict(n=N_FULL, steps=STEPS, serve_n=SERVE_N, short_steps=100,
                chunk_threshold=CHUNK_THRESHOLD, chunk_steps=CHUNK_STEPS,
                hold_s=FLEET_HOLD_S, qps=FLEET_QPS,
                duration=FLEET_DURATION_S, count=True)


def fleet_keys(cfg):
    """(the keys both replicas' caches hold, the keys only A's holds):
    ProgramKey dicts.  Both: the loadgen tiers at N=256/100 (standard,
    compensated, the lens, the 200-step tier, k-fused k=2) and the
    flagship serving row, at every batch bucket.  A only: the flagship
    at N=512/1000 (buckets 1, 2, 4) and the standard tier with its chunk
    runner."""
    auto = "pallas" if DEV == "cuda" else "roll"

    def key(**over):
        k = dict(N=cfg["serve_n"], Lx=1.0, Ly=1.0, Lz=1.0, T=1.0,
                 timesteps=cfg["short_steps"], scheme="standard",
                 path=auto, k=1, dtype="f32", with_field=False,
                 compute_errors=True, batch=1, mesh=None)
        k.update(over)
        return k

    tiers = (dict(), dict(timesteps=2 * cfg["short_steps"]),
             dict(scheme="compensated"),
             dict(with_field=True, compute_errors=False),
             dict(path="kfused", k=2),
             dict(scheme="compensated", path="kfused", k=K))
    both = [key(batch=b, **t) for t in tiers for b in (1, 2, 4, 8)]
    big = dict(N=cfg["n"], timesteps=cfg["steps"])
    a_only = [key(scheme="compensated", path="kfused", k=K, batch=b, **big)
              for b in (1, 2, 4)]
    a_only += [key(**big),
               key(path=f"{auto}@chunk{cfg['chunk_steps']}", **big)]
    return both, a_only


def write_manifest(tmp, name, keys):
    """A ledger-report warmup manifest of `keys` (phase 11's route)."""
    from wavetpu_torch.obs import ledger

    lp = os.path.join(tmp, f"{name}_ledger.jsonl")
    led = ledger.CompileLedger(lp)
    for k in keys:
        led.record(k, 0.0, ts=1.0, pid=1)
    led.close()
    mp = os.path.join(tmp, f"{name}_manifest.json")
    with contextlib.redirect_stdout(io.StringIO()):
        if ledger.main([lp, "--emit-warmup-manifest", mp]) != 0:
            fail(f"ledger-report --emit-warmup-manifest ({name}) failed")
    return mp


def admin_post(base, path):
    """POST an empty JSON body to an admin endpoint; its JSON answer."""
    import urllib.request

    req = urllib.request.Request(base + path, data=b"{}", headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def fleet_launches(base, reset=False):
    """A replica process's launch counters (its /admin/launches; POST sets
    them to 0 and answers what it cleared), the non-zero ones."""
    got = (admin_post(base, "/admin/launches") if reset
           else serve_get(base, "/admin/launches"))
    return kernel_launches(got["launches"], nonzero=True)


def launches_in_log(log):
    """The `kernel launches: {...}` line a replica prints at shutdown."""
    m = re.search(r"^kernel launches: (\{.*\})$", log, re.M)
    if m is None:
        fail(f"no kernel-launches line in the replica's log: {log[-2000:]}")
    return kernel_launches(json.loads(m.group(1)), nonzero=True)


def wait_until(what, predicate, timeout=300, every=0.05):
    deadline = time.monotonic() + timeout
    while True:
        got = predicate()
        if got:
            return got
        if time.monotonic() > deadline:
            fail(f"timed out waiting for {what}")
        time.sleep(every)


def counter_samples(text):
    """The monotonic samples of a Prometheus text cut (counters, histogram
    counts, sums and buckets), without the store and HA families, which
    are per router process by design."""
    from wavetpu_torch.loadgen.runner import parse_prometheus_text

    out = {}
    for name, v in parse_prometheus_text(text).items():
        base = name.split("{")[0]
        if base.startswith(("wavetpu_store_", "wavetpu_fleet_ha_")):
            continue
        if base.endswith(("_total", "_count", "_sum", "_bucket")):
            out[name] = v
    return out


def fleet_member_rows(router):
    return {row["url"]: row for row in serve_get(router, "/metrics")[
        "members"]}


def fleet_rows_b8(router, cfg, card):
    """bench.py's B=8 serving rows (phase 10's bodies: N=256/100, pallas
    and flagship), 2B concurrent requests through the router, twice: with
    a fresh connection per request (urllib, no retry), and through one
    keep-alive WavetpuClient (a connection per thread; retries=2 absorb
    what the first round's connection burst meets).  Each of the 2B
    threads sends a first request (connections open, programs warm),
    waits at a barrier, then the timed one.  The keep-alive arm must
    answer every timed request 200 at its first attempt; the fresh arm's
    transport errors are counted, not failed on: they are what this row
    measures (the listen backlog against a burst of new connections)."""
    import threading

    from wavetpu_torch.client import WavetpuClient

    out = {}
    for label, extra, _ in SERVE_ROWS:
        n = 2 * FLEET_ROW_B
        bodies = [dict(N=cfg["serve_n"], timesteps=cfg["short_steps"],
                       phase=oracle_phase(i), **extra,
                       **cfg.get("body_extra", {})) for i in range(n)]
        row = {}
        for arm in ("fresh", "keepalive"):
            client = WavetpuClient(router, retries=2, timeout=600)
            barrier = threading.Barrier(n, timeout=600)
            lat, codes = [None] * n, [[] for _ in range(n)]

            def go(i, arm=arm, client=client, barrier=barrier):
                for timed in (False, True):
                    if timed:
                        barrier.wait()
                    t0 = time.perf_counter()
                    try:
                        if arm == "fresh":
                            code = serve_post(router, bodies[i])[0]
                        else:
                            res = client.solve(bodies[i])
                            code = (res.status if not timed
                                    or res.attempts == 1
                                    else f"{res.status} at attempt "
                                         f"{res.attempts}")
                    except Exception as e:  # a transport error, counted
                        code = repr(e)
                    codes[i].append(code)
                    if timed:
                        lat[i] = time.perf_counter() - t0

            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(900)
            client.close()
            if None in lat or any(len(c) != 2 for c in codes):
                fail(f"B=8 row {label} ({arm}): a thread did not finish")
            errors = [c for pair in codes for c in pair if c != 200]
            if arm == "keepalive" and any(pair[1] != 200 for pair in codes):
                fail(f"B=8 row {label} keep-alive: timed answers "
                     f"{[pair[1] for pair in codes]}")
            if any(isinstance(c, int) and c != 200 for c in errors):
                fail(f"B=8 row {label} ({arm}): answers {codes}")
            lat.sort()
            row[arm] = dict(p50_s=lat[n // 2],
                            p95_s=lat[min(n - 1, int(0.95 * n))],
                            max_s=lat[-1], latencies_s=lat,
                            transport_errors=errors)
        out[label] = row
        print(f"  B=8 row {label} through the router, {n} requests: p95 "
              f"{row['fresh']['p95_s']!r} s with a fresh connection each "
              f"({len(row['fresh']['transport_errors'])} transport errors "
              f"in its {2 * n} requests), {row['keepalive']['p95_s']!r} s "
              f"keep-alive (p50 {row['fresh']['p50_s']!r} / "
              f"{row['keepalive']['p50_s']!r} s) ({card})")
    return out


def phase_fleet(card, sides, lane_errors, cfg=None):
    """Phase 12: the router (a process) in front of two replica processes
    on the card.  Affinity: the three flagship bodies land on A, the
    member whose cache holds the flagship tier, K2 lanes x1 + K4 lanes
    x252 per batch there and nothing on B, each answer bit-equal to phase
    9's lanes (body 0's max abs error phase 3's flagship's bits).  A
    roll: `fleet roll` spawns C while the N=512/1000 standard march is
    mid-flight on A; A's drain checkpoints it (503 + resume_token), the
    router re-injects the token, C resumes: one 200 bit-equal to phase
    3's default run, K1 on A and C summing to 1000,
    resume_handoffs_total +1, C 0 nvcc runs, roll exit 0, the router's
    fleet-wide counters monotonic across the roll.  Load: a loadgen trace
    replayed through the router, zero errors and zero cold compiles;
    bench.py's B=8 rows with fresh connections and keep-alive; B's
    --record-trace file replayed, all 200s."""
    import threading

    from wavetpu_torch import progkey
    from wavetpu_torch.client import WavetpuClient
    from wavetpu_torch.loadgen import trace as lg_trace

    cfg = cfg or fleet_config()
    count = cfg["count"]
    tmp = tempfile.mkdtemp(prefix="wt-fleet-")
    procs = {}   # name -> (process, log path)
    out = {}
    roll = None
    c_base = None
    try:
        both, a_only = fleet_keys(cfg)
        m_a = write_manifest(tmp, "a", both + a_only)
        m_b = write_manifest(tmp, "b", both)
        big = dict(N=cfg["n"], timesteps=cfg["steps"], T=1.0)
        m_c = write_manifest(tmp, "c", a_only[-2:])
        cache = {name: os.path.join(tmp, f"pc_{name}") for name in "ab"}
        state_dir = os.path.join(tmp, "state")
        tel = os.path.join(tmp, "tel")
        record = os.path.join(tmp, "b_recorded.jsonl")
        t0 = time.perf_counter()
        warms = {
            name: subprocess.Popen(
                [sys.executable, "-m", "wavetpu_torch", "warmup",
                 "--manifest", mp, "--program-cache-dir", cache[name]]
                + CLI_EXTRA,
                env=dict(os.environ,
                         WAVETPU_TORCH_BUILD_DIR=str(build.build_dir())),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, mp in (("a", m_a), ("b", m_b))}
        chunked = ["--chunk-threshold", str(cfg["chunk_threshold"]),
                   "--chunk-steps", str(cfg["chunk_steps"]),
                   "--solve-state-dir", state_dir, "--max-programs", "64"]
        hold = (f"serve-slow-batch:seconds={cfg['hold_s']},after=1,"
                f"scheme=standard,n={cfg['n']},timesteps={cfg['steps']}")
        reps = {
            "A": spawn_replica(tmp, "A", ["--program-cache-dir", cache["a"]]
                               + chunked, os.path.join(tmp, "build_A"),
                               telemetry=tel,
                               env={"WAVETPU_FAULT": hold}),
            "B": spawn_replica(tmp, "B", ["--program-cache-dir", cache["b"],
                                          "--record-trace", record]
                               + chunked, os.path.join(tmp, "build_B"),
                               telemetry=tel),
        }
        for name, (proc, _, _, log) in reps.items():
            procs[name] = (proc, log)
        a_base, b_base = reps["A"][1], reps["B"][1]
        r_port = free_port()
        router = f"http://127.0.0.1:{r_port}"
        r_log = os.path.join(tmp, "router.log")
        with open(r_log, "w") as log:
            procs["router"] = (subprocess.Popen(
                [sys.executable, "-m", "wavetpu_torch", "router", "--port",
                 str(r_port), "--member", a_base, "--member", b_base,
                 "--poll-interval-s", str(FLEET_POLL_S),
                 "--proxy-timeout-s", "900", "--telemetry-dir",
                 os.path.join(tmp, "tel_router")],
                stdout=log, stderr=subprocess.STDOUT, text=True), r_log)
        for name, w in warms.items():
            text, _ = w.communicate(timeout=600)
            want = len(both) + (len(a_only) if name == "a" else 0)
            if w.returncode != 0 or (count and f"{want} compiled" not in text):
                fail(f"warmup {name}: rc {w.returncode} {text[-2000:]}")
        warm_s = time.perf_counter() - t0
        for name, (proc, base, _, log) in reps.items():
            wait_healthz(proc, base, f"replica {name}", log)
        wait_healthz(procs["router"][0], router, "router", r_log)
        # The router has polled both members' warm keys (each member's
        # distinct affinity keys).
        n_warm = {a_base: len(progkey.warm_keys_to_affinity(
                      {"disk": both + a_only})),
                  b_base: len(progkey.warm_keys_to_affinity(
                      {"disk": both}))}
        wait_until("the router's view of both caches", lambda: all(
            row["state"] == "up" and row["warm_keys"] == n_warm[url]
            for url, row in fleet_member_rows(router).items()))
        up_s = time.perf_counter() - t0
        print(f"  caches (two warmup processes, {len(both) + len(a_only)} "
              f"and {len(both)} keys) {warm_s!r} s; two replicas and the "
              f"router up, both caches polled, {up_s!r} s after the first "
              f"spawn ({card})")

        # -- 2. affinity: the flagship tier lands on A --
        bodies = cfg.get("flagship_bodies") or SERVE_RUNS[
            "serve_flagship"][0]
        refs = cfg.get("flagship_refs") or serve_reference(
            "serve_flagship", bodies, lane_errors)
        for base in (a_base, b_base):
            fleet_launches(base, reset=True)
        batches0 = serve_get(a_base, "/metrics")["batches_total"]
        aff0 = serve_get(router, "/metrics")["affinity"]
        answers = serve_concurrent(router, bodies)
        launches_a = fleet_launches(a_base)
        launches_b = fleet_launches(b_base)
        nb = serve_get(a_base, "/metrics")["batches_total"] - batches0
        aff = serve_get(router, "/metrics")["affinity"]
        for i, (code, payload, headers, _) in enumerate(answers):
            if code != 200 or headers.get("X-Wavetpu-Member") != a_base:
                fail(f"fleet flagship {i}: {code} from "
                     f"{headers.get('X-Wavetpu-Member')} {payload}")
            same_errors(f"fleet flagship {i}", payload, refs[i])
        flag_err = (cfg["flagship_max_err"] if "flagship_max_err" in cfg
                    else sides["flagship"]["max_abs_error"])
        if answers[0][1]["report"]["max_abs_error"] != flag_err:
            fail(f"fleet flagship 2 pi max abs error "
                 f"{answers[0][1]['report']['max_abs_error']!r} is not "
                 f"phase 3's flagship's {flag_err!r}")
        # One batch (the bodies arrive within A's 200 ms max-wait): K2
        # lanes once for its reference-phase lane, K4 lanes per k-block.
        want_a = {"comp_step_lanes": 1, "kstep_comp_lanes": NB + REM}
        if count and (nb != 1 or launches_a != want_a or launches_b):
            fail(f"fleet flagship launches: A {launches_a} (expected "
                 f"{want_a}), B {launches_b} (expected none)")
        if aff["hits"] - aff0["hits"] != len(bodies):
            fail(f"fleet affinity: hits {aff0} -> {aff}")
        out["affinity"] = dict(batches=nb, launches_a=launches_a,
                               launches_b=launches_b, stats=aff,
                               walls_s=[a[3] for a in answers])
        print(f"  affinity: {len(bodies)} flagship N={cfg['n']}/"
              f"{cfg['steps']} bodies all on A in one batch, A "
              f"{launches_a}, B {launches_b or 'none'}, bit-equal to "
              f"phase 9's lanes, the 2 pi answer's max abs error phase "
              f"3's flagship's; router hit_rate {aff['hit_rate']!r} "
              f"(hits {aff['hits']}, cold {aff['cold']}) ({card})")

        # -- 3. a roll that hands the chunked march from A to C --
        prom0 = counter_samples(serve_get(router, "/metrics", "text/plain"))
        handoffs0 = serve_get(router, "/metrics")["resume_handoffs_total"]
        fleet_launches(a_base, reset=True)
        chunks0 = serve_get(a_base, "/metrics")["chunks_total"]
        victim = {}

        def long_solve():
            t = time.perf_counter()
            victim["out"] = WavetpuClient(router, retries=0,
                                          timeout=900).solve(dict(big))
            victim["wall"] = time.perf_counter() - t

        vt = threading.Thread(target=long_solve, daemon=True)
        vt.start()
        wait_until("the march mid-flight on A", lambda: serve_get(
            a_base, "/metrics")["chunks_total"] > chunks0, timeout=120)
        c_port = free_port()
        c_base = f"http://127.0.0.1:{c_port}"
        roll_log = os.path.join(tmp, "roll.log")
        t_roll = time.perf_counter()
        with open(roll_log, "w") as log:
            roll = subprocess.Popen(
                [sys.executable, "-m", "wavetpu_torch", "fleet", "roll",
                 "--router", router, "--old", a_base, "--new", c_base,
                 "--manifest", m_c, "--timeout-s", "600", "--",
                 sys.executable, "-m", "wavetpu_torch", "serve", "--port",
                 str(c_port), "--max-wait-ms", "200", "--telemetry-dir",
                 tel, "--program-cache-dir", cache["a"]] + chunked
                + CLI_EXTRA,
                env=dict(os.environ, WAVETPU_TORCH_BUILD_DIR=os.path.join(
                    tmp, "build_C")),
                stdout=log, stderr=subprocess.STDOUT, text=True,
                start_new_session=True)
        roll_rc = roll.wait(900)
        roll_s = time.perf_counter() - t_roll
        vt.join(900)
        res = victim.get("out")
        if roll_rc != 0:
            fail(f"fleet roll exited {roll_rc}: "
                 f"{open(roll_log).read()[-3000:]}")
        if res is None or not res.ok or res.attempts != 1 or \
                res.headers.get("X-Wavetpu-Member") != c_base:
            names = {a_base: "A", b_base: "B", c_base: "C"}
            fail(f"rolled march: {res and (res.status, res.error)}, "
                 f"attempts {res and res.attempts}, member "
                 f"{res and names.get(res.headers.get('X-Wavetpu-Member'))}"
                 f"; roll: {open(roll_log).read()[-2000:]}")
        step = res.payload["batch"].get("resumed_from")
        if not step:
            fail(f"rolled march was not resumed: {res.payload['batch']}")
        same_errors("rolled march", res.payload,
                    cfg.get("default_phase3")
                    or phase3_errors(sides, "default"))
        a_proc, a_log = procs.pop("A")
        a_text = stop_process(a_proc, a_log)
        launches_a = launches_in_log(a_text)
        launches_c = fleet_launches(c_base)
        if count and not (
                set(launches_a) | set(launches_c) <= {"step", "layer_errors"}
                and all(m.get("layer_errors", 0) == m.get("step", 0)
                        for m in (launches_a, launches_c))
                and launches_a.get("step", 0) + launches_c.get("step", 0)
                == cfg["steps"] and launches_c.get("step", 0)
                == cfg["steps"] - step):
            fail(f"rolled march launches: A {launches_a} + C {launches_c}, "
                 f"expected K1 summing to {cfg['steps']} (C from step "
                 f"{step})")
        handoffs = serve_get(router, "/metrics")["resume_handoffs_total"]
        if handoffs - handoffs0 != 1:
            fail(f"resume_handoffs_total {handoffs0} -> {handoffs}")
        prom1 = counter_samples(serve_get(router, "/metrics", "text/plain"))
        back = {k: (v, prom1[k]) for k, v in prom0.items()
                if k in prom1 and prom1[k] < v}
        if back:
            fail(f"router counters went backwards across the roll: {back}")
        rows = fleet_member_rows(router)
        if rows[a_base]["state"] != "left" or rows[c_base]["state"] != "up":
            fail(f"after the roll: {rows}")
        out["roll"] = dict(
            resumed_from=step, launches_a=launches_a, launches_c=launches_c,
            roll_s=roll_s, victim_wall_s=victim["wall"],
            timing=res.payload["batch"].get("timing"),
            samples_held=len([k for k in prom0 if k in prom1]))
        print(f"  roll: march resumed on C from step {step}; K1 A "
              f"{launches_a} + C {launches_c}; bit-equal to phase 3's "
              f"default; one attempt, {victim['wall']!r} s (A holds "
              f"{cfg['hold_s']} s before each chunk after the first); roll "
              f"{roll_s!r} s, exit 0; resume_handoffs_total +1; "
              f"{out['roll']['samples_held']} router counter samples "
              f"monotonic ({card})")

        # -- 4. load: a loadgen trace through the router (B and C) --
        trace_path = os.path.join(tmp, "trace.jsonl")
        report_path = os.path.join(tmp, "report.json")
        gen = subprocess.run(
            [sys.executable, "-m", "wavetpu_torch", "loadgen", "generate",
             "--out", trace_path, "--pallas", "--n", str(cfg["serve_n"]),
             "--timesteps", str(cfg["short_steps"]), "--duration",
             str(cfg["duration"]), "--seed", "0", "--qps", str(cfg["qps"])],
            capture_output=True, text=True, timeout=120)
        if gen.returncode != 0:
            fail(f"loadgen generate: {gen.stdout} {gen.stderr}")
        rows0 = fleet_member_rows(router)
        aff0 = serve_get(router, "/metrics")["affinity"]
        rep = subprocess.run(
            [sys.executable, "-m", "wavetpu_torch", "loadgen", "replay",
             trace_path, "--target", router, "--retries", "2",
             "--error-budget", "0", "--max-cold-compiles", "0",
             "--timeout", "600", "--out", report_path],
            capture_output=True, text=True, timeout=900)
        if rep.returncode != 0:
            fail(f"loadgen replay rc {rep.returncode}: {rep.stdout[-3000:]}"
                 f" {rep.stderr[-2000:]}")
        with open(report_path) as f:
            report = json.load(f)
        rows1 = fleet_member_rows(router)
        aff1 = serve_get(router, "/metrics")["affinity"]
        if report["ok"] != report["requests"] or \
                report["server"]["cold_compiles"] != 0:
            fail(f"loadgen report: {report['ok']}/{report['requests']} ok, "
                 f"{report['server']['cold_compiles']} cold compiles")
        per_member = {url: rows1[url]["proxied_total"]
                      - rows0[url]["proxied_total"]
                      for url in (b_base, c_base)}
        out["load"] = dict(
            qps=cfg["qps"], requests=report["requests"],
            requests_per_s=report["requests_per_s"],
            latency_ms=report["latency_ms"],
            tiers={t: {k: row[k] for k in ("requests", "p50_ms", "p95_ms",
                                             "p99_ms")}
                   for t, row in report["tiers"].items()},
            server=report["server"], per_member=per_member,
            affinity_hits=aff1["hits"] - aff0["hits"],
            affinity_cold=aff1["cold"] - aff0["cold"])
        print(f"  load: {report['requests']} requests offered at "
              f"{cfg['qps']} /s for {cfg['duration']} s, "
              f"{report['requests_per_s']!r} /s answered, all 200, 0 cold "
              f"compiles; per member B {per_member[b_base]}, C "
              f"{per_member[c_base]}; affinity hits "
              f"{out['load']['affinity_hits']} (cold "
              f"{out['load']['affinity_cold']}) ({card})")
        for tier, row in sorted(out["load"]["tiers"].items()):
            print(f"    {tier}: {row['requests']} requests, p50 "
                  f"{row['p50_ms']!r} p95 {row['p95_ms']!r} p99 "
                  f"{row['p99_ms']!r} ms")
        out["rows_b8"] = fleet_rows_b8(router, cfg, card)

        # -- 5. B's recording replays through the router --
        recorded = lg_trace.load_scenario_trace(record)
        replay2 = os.path.join(tmp, "replay_recorded.json")
        rep = subprocess.run(
            [sys.executable, "-m", "wavetpu_torch", "loadgen", "replay",
             record, "--target", router, "--mode", "closed",
             "--concurrency", "4", "--retries", "2", "--error-budget", "0",
             "--timeout", "600", "--out", replay2],
            capture_output=True, text=True, timeout=900)
        if rep.returncode != 0 or not recorded:
            fail(f"replay of B's recording ({len(recorded)} records): rc "
                 f"{rep.returncode} {rep.stdout[-3000:]} {rep.stderr[-2000:]}")
        with open(replay2) as f:
            report2 = json.load(f)
        if report2["ok"] != len(recorded) or \
                report2["requests"] != len(recorded):
            fail(f"replay of B's recording: {report2['ok']}/"
                 f"{report2['requests']} ok of {len(recorded)} records")
        out["recorded"] = dict(records=len(recorded),
                               p95_ms=report2["latency_ms"]["p95_ms"])
        print(f"  B's --record-trace: {len(recorded)} records, replayed "
              f"through the router all 200 (p95 "
              f"{report2['latency_ms']['p95_ms']!r} ms) ({card})")

        # -- 6. the fleet's counters monotonic since before the roll --
        prom2 = counter_samples(serve_get(router, "/metrics", "text/plain"))
        back = {k: (v, prom2[k]) for k, v in prom0.items()
                if k in prom2 and prom2[k] < v}
        if back:
            fail(f"router counters went backwards: {back}")

        # Shut down: C drains through its admin endpoint (roll spawned it
        # in roll's session), B and the router by SIGTERM.
        admin_post(c_base, "/admin/drain")
        wait_until("C's shutdown", lambda: "shut down cleanly" in open(
            roll_log).read(), timeout=180, every=0.1)
        c_stats = kernel_stats(open(roll_log).read())
        b_proc, b_log = procs.pop("B")
        b_stats = kernel_stats(stop_process(b_proc, b_log))
        a_stats = kernel_stats(a_text)
        if count and (c_stats["nvcc_runs"] or b_stats["nvcc_runs"]
                      or a_stats["nvcc_runs"]):
            fail(f"nvcc runs: A {a_stats['nvcc_runs']}, B "
                 f"{b_stats['nvcc_runs']}, C {c_stats['nvcc_runs']}")
        out["nvcc_runs"] = dict(A=a_stats["nvcc_runs"],
                                B=b_stats["nvcc_runs"],
                                C=c_stats["nvcc_runs"])
        print(f"  nvcc runs: A {a_stats['nvcc_runs']}, B "
              f"{b_stats['nvcc_runs']}, C {c_stats['nvcc_runs']} (every "
              f"library from a program cache) ({card})")
        return out
    finally:
        for proc, log in procs.values():
            stop_process(proc, log)
        if roll is not None:
            import signal

            if roll.poll() is None:
                roll.kill()
                roll.wait(30)
            try:  # C and anything else roll's session still holds
                os.killpg(roll.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        shutil.rmtree(tmp, ignore_errors=True)


# ---- phase 13: --distributed ----

# One rank of a --distributed run: the port's CLI (its `main`), then the
# rank's kernel launch counters, nvcc runs and cross-rank exchange costs
# into the file CHIP_SMOKE_RANK_STATS names.
RANK_MAIN = (
    "import json, os, sys\n"
    "from wavetpu_torch import cli\n"
    "from wavetpu_torch.comm import halo\n"
    "from wavetpu_torch.kernels import build, stencil_cuda\n"
    "rc = cli.main(sys.argv[1:])\n"
    "with open(os.environ['CHIP_SMOKE_RANK_STATS'], 'w') as f:\n"
    "    json.dump(dict(launches=stencil_cuda.launches,\n"
    "                   nvcc_runs=build.stats['nvcc_runs'],\n"
    "                   disk_loads=build.stats['disk_loads'],\n"
    "                   cross_rank=halo.cross_rank), f)\n"
    "sys.exit(rc)\n")
DIST_N = 512


def dist_run(tmp, label, world, argv, want=None):
    """`world` ranks of the port's CLI with `--distributed`, each a process
    of its own with explicit env:// variables and its own --out-dir, on
    the card; every rank must exit 0, load its libraries from phase 1's
    build directory (0 nvcc runs) and, with `want` (the counters of ONE
    rank), launch exactly those kernels.  Rank 0 alone writes and speaks.
    Returns dict(wall, outs, dirs, stats, side)."""
    port = free_port()
    procs, dirs, paths = [], [], []
    t0 = time.perf_counter()
    for r in range(world):
        dirs.append(os.path.join(tmp, label, str(r)))
        os.makedirs(dirs[-1])
        paths.append(os.path.join(tmp, f"{label}.rank{r}.json"))
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(r), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world),
                   WAVETPU_TORCH_BUILD_DIR=str(build.build_dir()),
                   CHIP_SMOKE_RANK_STATS=paths[-1])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_MAIN] + argv
            + ["--distributed", "--out-dir", dirs[-1]] + CLI_EXTRA,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{label}: rank {r} exited {p.returncode}: {out[-3000:]}")
    stats = []
    for path in paths:
        with open(path) as f:
            stats.append(json.load(f))
    for r, st in enumerate(stats):
        if st["nvcc_runs"]:
            fail(f"{label}: rank {r} ran nvcc {st['nvcc_runs']} time(s)")
        if want is not None:
            got = kernel_launches(st["launches"], nonzero=True)
            if got != want:
                fail(f"{label}: rank {r} launched {got}, want {want}")
    if not ("C = " in outs[0] and "report:" in outs[0]):
        fail(f"{label}: rank 0 printed no Courant or report line")
    for r in range(1, world):
        if os.listdir(dirs[r]):
            fail(f"{label}: rank {r} wrote {os.listdir(dirs[r])}")
        if "C = " in outs[r] or "report:" in outs[r]:
            fail(f"{label}: rank {r} spoke: {outs[r][-1000:]}")
    n = int(argv[0]) if argv[0] != "--resume" else DIST_N
    n_procs = 1
    for m in re.search(r"mesh: (\d+),(\d+),(\d+)", outs[0]).groups():
        n_procs *= int(m)
    with open(os.path.join(dirs[0],
                           f"output_N{n}_Np{n_procs}_CUDA.json")) as f:
        side = json.load(f)
    if side["run_config"]["distributed"] is not True:
        fail(f"{label}: the sidecar says distributed "
             f"{side['run_config']['distributed']}")
    backend = re.search(r"distributed: (.*)", outs[0]).group(1)
    cross = stats[0]["cross_rank"]
    share = cross["seconds"] / side["solve_seconds"]
    print(f"  {label}: {backend}; wall {wall!r} s, solve "
          f"{side['solve_seconds']!r} s, max abs error "
          f"{side['max_abs_error']!r}; rank 0's cross-rank exchange "
          f"{cross['exchanges']} x, {cross['bytes']} B, "
          f"{cross['seconds']!r} s = {share!r} of the solve", flush=True)
    return dict(wall=wall, outs=outs, dirs=dirs, stats=stats, side=side,
                backend=backend, exchange_share=share,
                cross_rank=cross)


def same_error_bits(label, got, want):
    """The sidecar's error vector against a host vector, bit for bit."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(
            got.view(np.int64), want.view(np.int64)):
        bad = np.flatnonzero(got != want)[:5] if got.shape == want.shape \
            else "shape"
        fail(f"{label}: errors differ from the in-process solve at {bad}")


def phase_distributed(card, sides, device="cuda"):
    """--distributed on the card: the port's CLI as 2 and 4 rank processes
    (gloo with the crossing planes staged through pinned host memory when
    they share the one card; NCCL where each has a card), each run held
    bit-equal to the same mesh solved in one process with every shard on
    the card; rank 1 silent; a stop + resume across processes; an NCCL
    run.  Returns the runs' numbers.  `device="cpu"` (with CLI_EXTRA
    `--platform cpu`) rehearses it on the CPU, the last run over gloo."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    out = {}
    n, base = DIST_N, [str(DIST_N), "1", "1", "1", "1", "1", str(STEPS)]
    p = Problem(N=n, timesteps=STEPS)
    nb = (STEPS - 1) // K + (STEPS - 1) % K + 1
    cuda2, cuda4 = [device] * 2, [device] * 4
    run = dist_run
    if device == "cpu":
        # The plain versions run on the CPU: no launch to count.
        def run(tmp, label, world, argv, want=None):
            return dist_run(tmp, label, world, argv)
    try:
        # 1. K6 on mesh 2,1,1.
        r1 = run(tmp, "dist_211", 2, base + ["--mesh", "2,1,1"],
                 {"sharded_step": STEPS, "layer_errors": STEPS})
        ref = sharded.solve_sharded(p, (2, 1, 1), devices=cuda2)
        same_error_bits("dist_211", r1["side"]["abs_errors"],
                        ref.abs_errors)
        if r1["side"]["max_abs_error"] != sides["default"]["max_abs_error"]:
            fail("dist_211: not the default run's max abs error")
        del ref
        # 2. The distributed flagship, K11 on mesh 2,1,1.
        flag = ["--scheme", "compensated", "--fuse-steps", str(K)]
        r2 = run(tmp, "dist_flagship_211", 2,
                 base + flag + ["--mesh", "2,1,1"],
                 {"kstep_comp_sharded": nb})
        ref = kfused_comp.solve_kfused_comp_sharded(
            p, k=K, mesh_shape=(2, 1, 1), devices=cuda2)
        same_error_bits("dist_flagship_211", r2["side"]["abs_errors"],
                        ref.abs_errors)
        err = r2["side"]["max_abs_error"]
        if device == "cuda" and not err < ERROR_CLASS["flagship"]:
            fail(f"dist_flagship_211: max abs error {err}")
        print(f"  dist_flagship_211 max abs error {err!r} against phase "
              f"3's flagship {sides['flagship']['max_abs_error']!r} "
              f"(equal: {err == sides['flagship']['max_abs_error']})")
        del ref
        # 3. Mesh 2,2,1 on four ranks: K10 and K12.
        r3 = run(tmp, "dist_kfused_221", 4,
                 base + ["--fuse-steps", str(K), "--mesh", "2,2,1"],
                 {"kstep_sharded_xy": nb})
        ref = sharded_kfused.solve_sharded_kfused(
            p, k=K, mesh_shape=(2, 2, 1), devices=cuda4)
        same_error_bits("dist_kfused_221", r3["side"]["abs_errors"],
                        ref.abs_errors)
        del ref
        r4 = run(tmp, "dist_flagship_221", 4,
                 base + flag + ["--mesh", "2,2,1"],
                 {"kstep_comp_sharded_xy": nb})
        ref = kfused_comp.solve_kfused_comp_sharded(
            p, k=K, mesh_shape=(2, 2, 1), devices=cuda4)
        same_error_bits("dist_flagship_221", r4["side"]["abs_errors"],
                        ref.abs_errors)
        del ref
        # 4. A checkpoint across processes: stop at 500, resume.
        ck = os.path.join(tmp, "ck")
        half = STEPS // 2
        r5 = run(tmp, "dist_stop", 2,
                 base + ["--mesh", "2,1,1", "--stop-step", str(half),
                         "--save-state", ck],
                 {"sharded_step": half, "layer_errors": half})
        files = sorted(os.listdir(ck))
        if files != ["meta.npz", "shard_0_0_0.wts",
                     f"shard_{n // 2}_0_0.wts"]:
            fail(f"dist_stop: the checkpoint holds {files}")
        r6 = run(tmp, "dist_resume", 2, ["--resume", ck],
                 {"sharded_step": STEPS - half,
                  "layer_errors": STEPS - half})
        same_error_bits("dist_resume", r6["side"]["abs_errors"][half + 1:],
                        r1["side"]["abs_errors"][half + 1:])
        print(f"  dist_stop + dist_resume: {files}, errors from layer "
              f"{half + 1} bit-equal to dist_211")
        # 5. NCCL: one card per rank where there are two, else one rank
        # holding both shards.
        if torch.cuda.device_count() >= 2:
            label, world, want = "dist_211_nccl", 2, {
                "sharded_step": STEPS, "layer_errors": STEPS}
        else:
            label, world, want = ("dist_211_nccl_1rank", 1,
                                  {"sharded_step": 2 * STEPS,
                                   "layer_errors": 2 * STEPS})
        r7 = run(tmp, label, world, base + ["--mesh", "2,1,1"], want)
        if device == "cuda" and not r7["backend"].startswith("nccl"):
            fail(f"{label}: backend {r7['backend']}, not nccl")
        same_error_bits(label, r7["side"]["abs_errors"],
                        r1["side"]["abs_errors"])
        print(f"  NCCL ran as {label} ({world} rank(s))")
        for label, r in (("dist_211", r1), ("dist_flagship_211", r2),
                         ("dist_kfused_221", r3), ("dist_flagship_221", r4),
                         ("dist_stop", r5), ("dist_resume", r6),
                         (label, r7)):
            out[label] = dict(
                backend=r["backend"], ranks=len(r["dirs"]), wall=r["wall"],
                solve_seconds=r["side"]["solve_seconds"],
                max_abs_error=r["side"]["max_abs_error"],
                exchange_share=r["exchange_share"],
                cross_rank=r["cross_rank"],
                launches_per_rank=[kernel_launches(st["launches"], True)
                                   for st in r["stats"]])
        print(f"  ({card}) ranks sharing one card measure the transport, "
              f"not the scaling")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def comp_kernel(k, field, lanes):
    """The mangled name's parts ('*' between them) of the compensated
    pipeline's instantiation that a main-path launch at k takes (f32 v, a
    bf16 carry): its shape `Shape<R, block size, blocks an SM>` as the
    chooser gives it, the storage, the field, the lane mode."""
    seg, ty, tz, r, block = stencil_cuda._comp_shape(
        k, stencil_cuda.default_block_x(N_FULL, k), None, torch.float32,
        torch.bfloat16, field, lanes)
    return (f"22kstep_comp_pipe_kernelILi{k}ENS_5ShapeILi{r}ELi{block}E*"
            f"EEf13__nv_bfloat16Lb1ELb{int(field)}ELb{int(lanes)}EE")


def kpipe_kernel(k, r, block, field, pad, lanes):
    """The mangled name's parts ('*' between them) of the standard
    pipeline's f32 instantiation at k in shape `Shape<r, block>`, with or
    without a field, in the pad or lane mode."""
    return (f"17kstep_pipe_kernelILi{k}ENS_5ShapeILi{r}ELi{block}E*"
            f"EEfLb{int(field)}ELb{int(pad)}ELb{int(lanes)}EE")


def kpipe_main_kernels():
    """{label: name parts} of the standard pipeline's f32 instantiations:
    k=4 in each mode at the shape `kstep_pipe_block` gives it (what the
    main paths launch) and at R = 1 (the body the other k and dtypes
    keep), and k=1 (K8/K9's tails)."""
    out = {}
    for label, keys in (("K3/K8", {}), ("K3f/K8f", dict(field=True)),
                        ("K10", dict(ext=True)),
                        ("K10f", dict(ext=True, field=True)),
                        ("K9", dict(pad=True)),
                        ("K9f", dict(pad=True, field=True)),
                        ("K3 lanes", dict(lanes=True)),
                        ("K3f lanes", dict(lanes=True, field=True))):
        r, block = stencil_cuda.kstep_pipe_block(K, N_FULL, torch.float32,
                                                 **keys)[3:]
        for rr, bb in sorted({(1, stencil_cuda.pipe_max_threads(K)),
                              (r, block)}):
            out[f"{label} k={K} R={rr}/{bb}"] = kpipe_kernel(
                K, rr, bb, keys.get("field", False), keys.get("pad", False),
                keys.get("lanes", False))
    for label, pad in (("K3/K8/K10", False), ("K9", True)):
        out[f"{label} k=1"] = kpipe_kernel(
            1, 1, stencil_cuda.pipe_max_threads(1), False, pad, False)
    return out


def pipe_registers(logs):
    """ptxas's registers (and spill stores) of the k-step kernels at their
    main-path instantiations, from the verbose build log: the standard
    pipeline of K3, K8 and K10 at k=4 (f32, without and with a field) and
    k=1, its pad mode (K9 on a block with pad planes) alike, its lane mode
    (K3, K3f) at k=4, and the compensated pipeline of K4 and K11/K12 at
    k=4 (f32 v, bf16 carry, without and with a field) and k=1, and its
    lane mode (K4) at k=4 and 1; and K6 (f32): the solo body and the
    x-streaming lane kernel."""
    want = {
        **kpipe_main_kernels(),
        "K4/K11/K12 k=4": comp_kernel(K, False, False),
        "K4f/K11f/K12f k=4": comp_kernel(K, True, False),
        "K4/K11/K12 k=1": comp_kernel(1, False, False),
        "K4 lanes k=4": comp_kernel(K, False, True),
        "K4 lanes k=1": comp_kernel(1, False, True),
        "K6": "19sharded_step_kernelIfLb0EE",
        "K6 lanes": "20sharded_lanes_kernelIfEE",
    }
    found, func, spill = {}, None, None
    for line in "\n".join(logs.values()).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func, spill = m.group(1), None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and func:
            for label, key in want.items():
                if all(part in func for part in key.split("*")):
                    found[label] = {"registers": int(m.group(1)),
                                    "spill_stores": spill}
    return found


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    card = smi()
    dev_name = torch.cuda.get_device_name(0)
    print(f"device: {dev_name} ({card}); torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    phase_s = {}
    t0 = time.perf_counter()

    def done(phase, t):
        """Record and print a phase's wall time; returns the next start."""
        phase_s[phase] = time.perf_counter() - t
        print(f"  [{phase}: {phase_s[phase]:.1f} s wall]", flush=True)
        return time.perf_counter()

    print("phase 1: build")
    logs = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    registers = pipe_registers(logs)
    print(f"  built {sorted(logs)} in {build_s:.1f} s; k-step kernels' "
          f"registers: {registers}")
    t = done("build", t0)

    print("phase 2: kernels vs plain versions")
    errs = {name: [] for name in KERNELS}
    phase_kernels(errs)
    phase_sharded_kernels(errs)
    phase_xy_kernels(errs)
    t = done("kernels", t)

    print(f"phase 3: main-path runs, {STEPS} steps")
    sides, counts = {}, {}
    for label in RUNS:
        sides[label], counts[label] = run_cli(label)
    api = {}
    for label in API_RUNS:
        api[label], sides[label], counts[label] = run_api(label)
    std = sides["default"]
    for label, bound in ERROR_CLASS.items():
        err = sides[label]["max_abs_error"]
        if not (np.isfinite(err) and err < bound):
            fail(f"{label} max abs error {err}")
    # The same states as the default run: the same error bits for the
    # 1-step sharded runs, within 1e-6 for the in-kernel rows.
    for label in ("sharded", "sharded_221"):
        if sides[label]["max_abs_error"] != std["max_abs_error"]:
            fail(f"{label} max abs error {sides[label]['max_abs_error']} "
                 f"is not the default run's {std['max_abs_error']}")
    for label in ("kfused", "sharded_kfused_411", "sharded_kfused_221"):
        if abs(sides[label]["max_abs_error"] - std["max_abs_error"]) > 1e-6:
            fail(f"{label} max abs error {sides[label]['max_abs_error']} is "
                 f"not within 1e-6 of the default run's "
                 f"{std['max_abs_error']}")
    t = done("runs", t)

    ref221 = api["sharded_221"]  # phase 7's serial reference
    refs = {label: host_state(api[label]) for label in (
        "sharded_221", "sharded_kfused_221", "sharded_flagship_221")}
    print("phase 4: contracts at full width")
    accuracy = phase_contracts(api)
    accuracy.update(phase_sharded_contracts(api))
    accuracy.update(phase_flagship_contracts(api, sides))
    del api
    accuracy["c1"] = phase_c1(accuracy)
    t = done("contracts", t)

    print("phase 5: card vs CPU at N=32")
    phase_agree()
    t = done("agree", t)

    print(f"phase 6: times at the main-path shapes ({card})")
    times, rate = phase_times(dev_name)
    t = done("times", t)

    print(f"phase 7: measurement ({card})")
    measured = phase_overlap(ref221, card)
    del ref221
    measured["probes"] = phase_probes(times, card)
    measured.update(phase_telemetry(card))
    measured.update(phase_trace_default(card))
    measured.update(phase_kernel_choice(card))
    guard_runs(sides, card)
    t = done("measurement", t)

    print(f"phase 8: resilience ({card})")
    refs.update(single_refs())
    for label in ("default", "kfused", "flagship", "uneven_kfused"):
        # The CLI runs' error vectors are phase 3's own.
        refs[label].update(side_errors(sides[label]))
    measured["resilience"] = phase_resilience(sides, counts, refs, card)
    del refs
    t = done("resilience", t)
    print(f"  phase 8 wall: {phase_s['resilience']!r} s ({card})")

    print(f"phase 9: ensembles ({card})")
    lane_times, ens_sides, ens_counts, throughput, lane_errors = \
        phase_ensemble(errs, rate, card)
    times.update(lane_times)
    counts.update(ens_counts)
    measured["ensemble"] = dict(runs=ens_sides, throughput=throughput)
    t = done("ensemble", t)
    print(f"  phase 9 wall: {phase_s['ensemble']!r} s ({card})")

    print(f"phase 10: the serving replica ({card})")
    serve_counts, measured["serve"] = phase_serve(
        card, lane_errors, throughput, sides["flagship"]["max_abs_error"])
    counts.update(serve_counts)
    t = done("serve", t)
    print(f"  phase 10 wall: {phase_s['serve']!r} s ({card})")

    print(f"phase 11: serving's warm state and long solves ({card})")
    warm_counts, measured["warm_state"] = phase_warm_state(
        card, sides, lane_errors)
    counts.update(warm_counts)
    t = done("warm_state", t)
    print(f"  phase 11 wall: {phase_s['warm_state']!r} s ({card})")

    print(f"phase 12: the fleet ({card})")
    measured["fleet"] = phase_fleet(card, sides, lane_errors)
    del lane_errors
    t = done("fleet", t)
    print(f"  phase 12 wall: {phase_s['fleet']!r} s ({card})")

    print(f"phase 13: --distributed ({card})")
    measured["distributed"] = phase_distributed(card, sides)
    done("distributed", t)
    print(f"  phase 13 wall: {phase_s['distributed']!r} s ({card})")
    rows = []
    for name, meta in KERNELS.items():
        row = {
            "name": f"{name} {meta['what']}",
            "route": "cuda",
            "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": counts[meta["run"]][meta["counter"]],
            "max_abs_err": max(errs[name]),
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": times[name]["bound_by"],
            "library_ms": None,
        }
        for extra in ("ms_k1", "march_ms", "march_ms_plain_errors",
                      "solo_x8_ms", "ms_N512", "solo_x8_ms_N512",
                      "plain_ms_N512", "bound_ms_N512", "bound_by_N512",
                      "old_body_ms", "ab_ms", "face_ab"):
            if extra in times[name]:
                row[extra] = times[name][extra]
        rows.append(row)
    keys = ("max_abs_error", "gcells_per_second", "solve_seconds",
            "init_seconds")
    summary = {
        "card": card, "device": dev_name, "mem_rate_bytes_per_s": rate,
        "build_seconds": build_s,
        "phase_seconds": phase_s,
        "pipe_registers": registers,
        **{label: {k: side[k] for k in keys} for label, side in sides.items()},
        "launches": counts,
        "accuracy": accuracy,
        "kernels": rows,
        "times": times,
        "measurement": measured,
    }
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for label, side in sides.items():
        print(f"{label}: {side['gcells_per_second']!r} Gcell/s, solve "
              f"{side['solve_seconds']!r} s, max abs error "
              f"{side['max_abs_error']!r} ({card})")
    print(f"phase wall times (s): {phase_s}; total "
          f"{sum(phase_s.values()):.1f}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
