"""Chip smoke test of the PyTorch/CUDA port (wavetpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result line,
without them or when any phase fails.  Phases:

 1. build    - nvcc builds every kernel source of wavetpu_torch/kernels/csrc
               (one process per source, in parallel; ptxas register /
               shared-memory report in build.log under OUT_DIR).
 2. kernels  - each CUDA kernel against its plain PyTorch version on the
               same inputs on the card: at N=128 in every mode - K1, K2,
               K5, K3 and K3f (k = 2, 4, 8; f32 and bf16; rows on and
               off), K4 and K4f (all three storage modes, k = 4 and 1,
               K4f rows on and off, and its k=1 bootstrap form) - and at
               N=512 in every mode the main-path runs launch: K1, K2, K5,
               K3 (k=4, rows on), K3f (k=4, rows on and off), K4 (f32 v +
               bf16 carry, k=4 and 1, rows on), K4f (the same, rows on
               and off, and the bootstrap: k=1, half the field, zero v
               and carry, zero oracle planes, rows off).  Held
               bitwise, every output (the Kahan carry and the error rows
               included): --fmad=false makes the kernel round every
               multiply and add separately, as the plain version does, in
               the same order.
 3. main-path runs through the port's CLI at N=512, 1000 steps, f32, each
    with the launch counters set to 0 just before and read just after
    (every counter must equal the expected count, the others 0):
      default        `512 1 1 1 1 1 1000`: K1 x1000; max abs error < 5e-3
                     (f32 rounding-accumulation class).
      flagship       `... --scheme compensated --fuse-steps 4`: K2 x1, K4
                     x252 (249 at k=4, 3 at k=1); max abs error < 2e-5
                     (f32 discretization class, ~6e-6 here).
      kfused         `... --fuse-steps 4`: K3 x249, K1 x4 (bootstrap + 3
                     tail layers); max abs error < 5e-3 and within 1e-6 of
                     the default run's (the same states; the in-kernel rows
                     multiply the oracle in another order).
      varc           `... --c2-field gaussian-lens`: K5 x1000, errors off,
                     the sidecar names the field.
      kfused_varc    `... --fuse-steps 4 --c2-field gaussian-lens`: K3f
                     x249, K5 x4.
      flagship_varc  `... --scheme compensated --fuse-steps 4 --c2-field
                     gaussian-lens`: K4f x253 (1 bootstrap at k=1, 249 at
                     k=4, 3 at k=1), K2 x0.
 4. contracts - through the solver API on the card: the k-fused state at
               N=512 / 1000 steps equals the 1-step state bit for bit
               (u_cur and u_prev), with constant c and with the
               gaussian-lens field; at N=128 / 1000 steps the compensated
               variable-c state lies nearer an f64 plain variable-c march
               than the standard one does (wavetpu's
               tests/test_kfused_varc.py contract).
 5. agree    - every solver at N=32 on the card against the same solver on
               the CPU (the plain versions): max |diff| <= 1e-5.
 6. times    - per-kernel times at N=512 (CUDA events around each launch,
               median), the plain versions' times, and each kernel's bound:
               the bytes it must move over the card's memory rate vs its
               f32 operations over the card's f32 rate.

Launches made by the comparisons, contracts and timings do not count.
The last lines are the card's name and power limit (nvidia-smi), one JSON
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
from wavetpu_torch.io import state
from wavetpu_torch.kernels import build, stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog

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
    "K3": dict(counter="kstep", source=f"{CSRC}/kstep.cu",
               replaces=f"{PALLAS}:745",
               what="_kstep_kernel: k leapfrog substeps + error rows "
                    "(k=4, f32)",
               run="kfused", bytes_per_cell=16),
    "K3f": dict(counter="kstep_field", source=f"{CSRC}/kstep.cu",
                replaces=f"{PALLAS}:721",
                what="_kstep_kernel has_field: k variable-c substeps "
                     "(k=4, f32, rows off)",
                run="kfused_varc", bytes_per_cell=20),
    "K4": dict(counter="kstep_comp", source=f"{CSRC}/stencil.cu",
               replaces=f"{PALLAS}:970",
               what="_kstep_comp_kernel: k velocity-form substeps + error "
                    "rows (f32 u/v, bf16 carry)",
               run="flagship", bytes_per_cell=20),
    "K4f": dict(counter="kstep_comp_field", source=f"{CSRC}/stencil.cu",
                replaces=f"{PALLAS}:1043",
                what="_kstep_comp_kernel has_field: k variable-c "
                     "velocity-form substeps (f32 u/v, bf16 carry, rows off)",
                run="flagship_varc", bytes_per_cell=24),
    "K5": dict(counter="var_step", source=f"{CSRC}/stencil.cu",
               replaces=f"{PALLAS}:147",
               what="_var_step_kernel: (2u + c2tau2*lap(u)) - u_prev",
               run="varc", bytes_per_cell=16),
}
N_FULL, STEPS, K = 512, 1000, 4
LENS = "gaussian-lens"
# The main-path runs: CLI flags after `512 1 1 1 1 1 1000` and the launch
# count of every counter that must move (all others stay 0).
NB, REM = (STEPS - 1) // K, (STEPS - 1) % K
RUNS = {
    "default": ([], {"step": STEPS}),
    "flagship": (["--scheme", "compensated", "--fuse-steps", str(K)],
                 {"comp_step": 1, "kstep_comp": NB + REM}),
    "kfused": (["--fuse-steps", str(K)], {"kstep": NB, "step": 1 + REM}),
    "varc": (["--c2-field", LENS], {"var_step": STEPS}),
    "kfused_varc": (["--fuse-steps", str(K), "--c2-field", LENS],
                    {"kstep_field": NB, "var_step": 1 + REM}),
    "flagship_varc": (["--scheme", "compensated", "--fuse-steps", str(K),
                       "--c2-field", LENS],
                      {"kstep_comp_field": 1 + NB + REM}),
}
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
            _, syz, rsyz, sxct = oracle_inputs(n, k)
            kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
                      c2tau2_field=fld if with_f else None,
                      with_errors=rows)
            args = (up.to(dt), u.to(dt), syz, rsyz, sxct)
            got = stencil_cuda.fused_kstep(*args, **kw)
            want = stencil_cuda.fused_kstep_plain(*args, **kw)
            name = "K3f" if with_f else "K3"
            check_outputs(f"{name} N={n} k={k} {dt} rows={rows}", got, want,
                          errs[name])
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
    torch.cuda.synchronize()


def run_cli(label):
    """One main-path run through the CLI with the counters zeroed just
    before and read just after; every counter must equal RUNS[label]'s
    count (0 when not listed).  Returns (sidecar dict, launches)."""
    flags, want = RUNS[label]
    argv = [str(N_FULL), "1", "1", "1", "1", "1", str(STEPS)] + flags
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
    expected = {c: want.get(c, 0) for c in counts}
    if counts != expected:
        fail(f"{label}: launches {counts}, expected {expected}")
    errors_on = "--c2-field" not in flags
    if side["errors_computed"] != errors_on:
        fail(f"{label}: errors_computed {side['errors_computed']}")
    if not errors_on and side["run_config"]["c2_field"] != LENS:
        fail(f"{label}: sidecar c2_field {side['run_config']['c2_field']}")
    return side, counts


def phase_contracts():
    """Bitwise k-fused == 1-step at full width (constant c and the lens),
    and compensated variable c nearer f64 than standard at N=128."""
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
    # (kernel, plain version, f32 operations per cell the function needs:
    # K1 14 for the Laplacian + 5 for the update, K5 the same, K2 14 + 6;
    # per substep K3 14 + 5 + 3 for the error rows, K3f 14 + 5, K4
    # 14 + 6 + 3, K4f 14 + 6.)
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

    print(f"phase 3: main-path runs at N={N_FULL}, {STEPS} steps")
    sides, counts = {}, {}
    for label in RUNS:
        sides[label], counts[label] = run_cli(label)
    std, flag, kf = sides["default"], sides["flagship"], sides["kfused"]
    for label, side, bound in (("default", std, 5e-3),
                               ("flagship", flag, 2e-5),
                               ("kfused", kf, 5e-3)):
        if not (np.isfinite(side["max_abs_error"])
                and side["max_abs_error"] < bound):
            fail(f"{label} max abs error {side['max_abs_error']}")
    if abs(kf["max_abs_error"] - std["max_abs_error"]) > 1e-6:
        fail(f"kfused max abs error {kf['max_abs_error']} is not within "
             f"1e-6 of the default run's {std['max_abs_error']}")

    print("phase 4: contracts at full width")
    accuracy = phase_contracts()

    print("phase 5: card vs CPU at N=32")
    phase_agree()

    print(f"phase 6: times at N={N_FULL} ({card})")
    times, rate = phase_times(dev_name)
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
        if "ms_k1" in times[name]:
            row["ms_k1"] = times[name]["ms_k1"]
        rows.append(row)
    keys = ("max_abs_error", "gcells_per_second", "solve_seconds",
            "init_seconds")
    summary = {
        "card": card, "device": dev_name, "mem_rate_bytes_per_s": rate,
        "build_seconds": build_s,
        **{label: {k: side[k] for k in keys} for label, side in sides.items()},
        "launches": counts,
        "accuracy": accuracy,
        "kernels": rows,
    }
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    for label, side in sides.items():
        print(f"{label}: {side['gcells_per_second']!r} Gcell/s, solve "
              f"{side['solve_seconds']!r} s, max abs error "
              f"{side['max_abs_error']!r} ({card})")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
