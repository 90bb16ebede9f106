"""Chip smoke test of the PyTorch/CUDA port (wavetpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result line,
without them or when any phase fails.  Phases:

 1. build    - nvcc builds every kernel source of wavetpu_torch/kernels/csrc
               (ptxas register/shared-memory report in
               chiprun_out/chip_smoke/build.log).
 2. kernels  - each CUDA kernel against its plain PyTorch version on the
               same inputs on the card, at N=128 in every mode and at the
               main path's N=512.  Held bitwise, every output (the Kahan
               carry and the error rows included): --fmad=false makes the
               kernel round every multiply and add separately, as the
               plain version does, in the same order.
 3. default  - the port's CLI runs `512 1 1 1 1 1 1000` (standard scheme):
               K1 launches exactly 1000 times, the report is written, the
               max abs error is finite and < 5e-3 (f32 rounding-accumulation
               class).
 4. flagship - the CLI runs `512 1 1 1 1 1 1000 --scheme compensated
               --fuse-steps 4`: K2 launches once, K4 252 times (249 at k=4,
               3 at k=1), max abs error < 2e-5 (the f32 discretization
               class, ~4e-6 at this configuration).
 5. agree    - both solvers at N=32 on the card against the same solvers on
               the CPU (the plain versions): max |diff| <= 1e-5.
 6. times    - per-kernel times at N=512 (CUDA events around each launch,
               median), the plain versions' times, and each kernel's bound:
               the bytes it must move over the card's memory rate vs its
               f32 operations over the card's f32 rate.

Launch counters are set to 0 just before each main-path run and read just
after; launches made by the comparisons and timings do not count.  The
last lines are the card's name and power limit (nvidia-smi), one JSON
`kernels` line, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from wavetpu_torch import cli
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import build, stencil_cuda
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
SOURCE = "wavetpu_torch/kernels/csrc/stencil.cu"
PALLAS = "wavetpu/kernels/stencil_pallas.py"
# Kernel rows: launch counter, TPU kernel body replaced, the main-path run
# that launches it, and the bytes per cell the function must move there
# (f32 state; each input read once, each output written once).
KERNELS = {
    "K1": dict(counter="step", replaces=f"{PALLAS}:130",
               what="_step_kernel: alpha*u + coeff*lap(u) - beta*u_prev",
               run="default", bytes_per_cell=12),
    "K2": dict(counter="comp_step", replaces=f"{PALLAS}:544",
               what="_comp_step_kernel: 1-step compensated (Kahan) update",
               run="flagship", bytes_per_cell=24),
    "K4": dict(counter="kstep_comp", replaces=f"{PALLAS}:970",
               what="_kstep_comp_kernel: k velocity-form substeps + error "
                    "rows (f32 u/v, bf16 carry)",
               run="flagship", bytes_per_cell=20),
}
N_FULL, STEPS, K = 512, 1000, 4
DEV = "cuda"
CLI_EXTRA = []  # the CLI's default platform is the GPU
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def fail(msg):
    raise RuntimeError(f"chip_smoke FAILED: {msg}")


def mem_rate(name: str) -> float:
    """Published HBM rate of the card (bytes/s): H100 SXM 3.35 TB/s, PCIe
    2.0 TB/s, NVL 3.9 TB/s; H200 4.8 TB/s."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


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
        for coeffs in ((2.0, 1.0, p.a2tau2), (1.0, 0.0, 0.5 * p.a2tau2)):
            a, b, c = coeffs
            kw = dict(inv_h2=p.inv_h2, alpha=a, beta=b, coeff=c)
            got = stencil_cuda.fused_step(up, u, **kw)
            want = stencil_cuda.fused_step_plain(up, u, **kw)
            check_outputs(f"K1 N={n} (a,b)=({a},{b})", [got], [want],
                          errs["K1"])
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
    torch.cuda.synchronize()


def run_cli(argv, label):
    """One main-path run through the CLI with the counters zeroed just
    before and read just after; returns (sidecar dict, launches)."""
    out = os.path.join(OUT_DIR, label)
    stencil_cuda.reset_launches()
    rc = cli.main(argv + CLI_EXTRA + ["--out-dir", out])
    torch.cuda.synchronize()
    counts = dict(stencil_cuda.launches)
    if rc != 0:
        fail(f"{label}: CLI exit code {rc}")
    name = f"output_N{argv[0]}_Np1_CUDA"
    if not os.path.exists(os.path.join(out, name + ".txt")):
        fail(f"{label}: no report file")
    with open(os.path.join(out, name + ".json")) as f:
        side = json.load(f)
    print(f"  {label}: launches={counts} max_abs_error="
          f"{side['max_abs_error']!r} gcells_per_second="
          f"{side['gcells_per_second']!r} solve_seconds="
          f"{side['solve_seconds']!r}")
    return side, counts


def phase_agree():
    """Both solvers at a small size: card vs CPU (plain versions)."""
    small = Problem(N=32, timesteps=21)
    for label, fn in (
        ("standard", lambda d: leapfrog.solve(small, device=d)),
        ("flagship", lambda d: kfused_comp.solve_kfused_comp(
            small, k=K, device=d)),
    ):
        gpu, cpu = fn(DEV), fn("cpu")
        d = (gpu.u_cur.cpu().double() - cpu.u_cur.double()).abs().max().item()
        de = float(np.max(np.abs(gpu.abs_errors - cpu.abs_errors)))
        print(f"  {label} N=32: card vs cpu max|du|={d:.3e} "
              f"max|d abs_err|={de:.3e}")
        if not (np.isfinite(gpu.abs_errors).all() and d <= 1e-5
                and de <= 1e-5):
            fail(f"{label}: card and CPU disagree at N=32")


def time_launches(fn, reps, warmup=2):
    """Median device time (ms) of one call, CUDA events around each."""
    for _ in range(warmup):
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


def phase_times(dev_name):
    n = N_FULL
    p = Problem(N=n, timesteps=STEPS)
    cells = n ** 3
    rate = mem_rate(dev_name)
    up, u = field(n, 1), field(n, 2)
    v, cy = field(n, 6, 1e-3), field(n, 7, 1e-8)
    kw1 = dict(inv_h2=p.inv_h2, alpha=2.0, beta=1.0, coeff=p.a2tau2)
    _, syz, rsyz, sxct = oracle_inputs(n, K)
    _, syz1, rsyz1, sxct1 = oracle_inputs(n, 1)
    cb = cy.to(torch.bfloat16)
    kw4 = dict(k=K, coeff=p.a2tau2, inv_h2=p.inv_h2)
    kw41 = dict(k=1, coeff=p.a2tau2, inv_h2=p.inv_h2)
    # (kernel, plain version, f32 operations per cell the function needs:
    # K1 14 for the Laplacian + 5 for the update, K2 14 + 6, K4 per
    # substep 14 + 6 + 3 for the error rows.)
    runs = {
        "K1": (lambda: stencil_cuda.fused_step(up, u, **kw1),
               lambda: stencil_cuda.fused_step_plain(up, u, **kw1), 19),
        "K2": (lambda: stencil_cuda.compensated_step(u, v, cy, p),
               lambda: stencil_cuda.compensated_step_plain(
                   u, v, cy, inv_h2=p.inv_h2, coeff=p.a2tau2), 20),
        "K4": (lambda: stencil_cuda.fused_kstep_comp(
                   u, v, cb, syz, rsyz, sxct, **kw4),
               lambda: stencil_cuda.fused_kstep_comp_plain(
                   u, v, cb, syz, rsyz, sxct,
                   block_x=stencil_cuda.default_block_x(n, K), **kw4),
               23 * K),
    }
    times = {}
    for name, (kern, plain, ops) in runs.items():
        ms = time_launches(kern, 20)
        plain_ms = time_launches(plain, 3, warmup=1)
        byte_ms = KERNELS[name]["bytes_per_cell"] * cells / rate * 1e3
        op_ms = ops * cells / F32_OPS_PER_S * 1e3
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
    return times, rate


def main() -> int:
    if not torch.cuda.is_available():
        print("error: chip_smoke needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    card = smi()
    dev_name = torch.cuda.get_device_name(0)
    print(f"device: {dev_name} ({card}); torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    print("phase 1: build")
    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    print(f"  built {sorted(logs)} in {build_s:.1f} s")

    print("phase 2: kernels vs plain versions")
    errs = {name: [] for name in KERNELS}
    phase_kernels(errs)

    print("phase 3: default path")
    std, std_counts = run_cli(
        [str(N_FULL), "1", "1", "1", "1", "1", str(STEPS)], "default")
    if std_counts["step"] != STEPS:
        fail(f"K1 launched {std_counts['step']} times, expected {STEPS}")
    if not (np.isfinite(std["max_abs_error"])
            and std["max_abs_error"] < 5e-3):
        fail(f"default max abs error {std['max_abs_error']}")

    print("phase 4: flagship")
    flag, flag_counts = run_cli(
        [str(N_FULL), "1", "1", "1", "1", "1", str(STEPS), "--scheme",
         "compensated", "--fuse-steps", str(K)], "flagship")
    want = (STEPS - 1) // K + (STEPS - 1) % K
    if flag_counts["comp_step"] != 1 or flag_counts["kstep_comp"] != want:
        fail(f"flagship launches {flag_counts}, expected comp_step=1 "
             f"kstep_comp={want}")
    if not (np.isfinite(flag["max_abs_error"])
            and flag["max_abs_error"] < 2e-5):
        fail(f"flagship max abs error {flag['max_abs_error']}")

    print("phase 5: card vs CPU at N=32")
    phase_agree()

    print(f"phase 6: times at N={N_FULL} ({card})")
    times, rate = phase_times(dev_name)
    counts = {"default": std_counts, "flagship": flag_counts}
    rows = []
    for name, meta in KERNELS.items():
        row = {
            "name": f"{name} {meta['what']}",
            "route": "cuda",
            "source": SOURCE,
            "replaces": meta["replaces"],
            "launches": counts[meta["run"]][meta["counter"]],
            "max_abs_err": max(errs[name]),
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": times[name]["bound_by"],
            "library_ms": None,
        }
        if "ms_k1" in times[name]:
            row["ms_k1"] = times[name]["ms_k1"]
        rows.append(row)
    summary = {
        "card": card, "device": dev_name, "mem_rate_bytes_per_s": rate,
        "build_seconds": build_s,
        "default": {k: std[k] for k in ("max_abs_error", "gcells_per_second",
                                        "solve_seconds", "init_seconds")},
        "flagship": {k: flag[k] for k in ("max_abs_error",
                                          "gcells_per_second",
                                          "solve_seconds", "init_seconds")},
        "kernels": rows,
    }
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"default path: {std['gcells_per_second']!r} Gcell/s, max abs "
          f"error {std['max_abs_error']!r}; flagship: "
          f"{flag['gcells_per_second']!r} Gcell/s, max abs error "
          f"{flag['max_abs_error']!r} ({card})")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
