"""Back-to-back solves: the generator of the solver cells.

The mix names one solver entry of the program (`entry`, "module:function",
called as fn(problem, dtype, **args, device=, phase=[, stop_step=])), its
scheme and its arguments.  Set-up builds the problem and warms the entry
with one short solve of the same problem (`warmup_stop_step` layers: every
kernel and shape the window launches).  The window then starts solves back
to back, each at its own phase from the seed, until `seconds` have passed;
it ends when the last started solve returns.  Each call's own set-up, its
bootstrap, march and read-back all lie inside the window.

One solve of the window, drawn from the seed (a reservoir sample over all
of them), is checked: its final two layers and its per-layer absolute
error vector against the plain reference's march at its phase, after the
window (the relative error vector is not compared: PERF.md, section 2).
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Callable, Optional

from torch.profiler import record_function

from wavebench import judge, stats
from wavebench.loadgen import phases as seeded
from wavebench.reference import wave
from wavebench.trace import Window

_DTYPES = ("float64", "float32", "bfloat16")


def _torch_args(args: dict) -> dict:
    import torch

    return {k: getattr(torch, v) if v in _DTYPES else v
            for k, v in args.items()}


def problem_of(cfg: dict):
    from wavetpu_torch.core.problem import Problem

    return Problem(N=int(cfg["N"]), Np=int(cfg.get("Np", 1)),
                   Lx=float(cfg["Lx"]), Ly=float(cfg["Ly"]),
                   Lz=float(cfg["Lz"]), T=float(cfg["T"]),
                   timesteps=int(cfg["timesteps"]))


def entry(cfg: dict, mix: dict, device, args: Optional[dict] = None
          ) -> Callable:
    """fn(problem, phase, stop_step=None) -> the program's SolveResult."""
    import torch

    module, name = mix["entry"].split(":")
    fn = getattr(importlib.import_module(module), name)
    kw = _torch_args(mix.get("args", {}) if args is None else args)
    dtype = kw.pop("dtype", getattr(torch, cfg["dtype"]))

    def call(problem, phase, stop_step=None):
        return fn(problem, dtype, **kw, device=device, phase=phase,
                  stop_step=stop_step)

    return call


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _release(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _numbers(cfg, mix, kept, device) -> dict:
    phase, u, u_prev, abs_p = kept
    ref = wave.march(wave.Wave.from_config(cfg), phase, mix["scheme"],
                     device)
    return {"u_gap": max(judge.field_gap(u, ref["u"]),
                         judge.field_gap(u_prev, ref["u_prev"])),
            "abs_gap": judge.abs_gap(abs_p, ref["abs"])}


def run(cfg: dict, mix: dict, *, seed: int, seconds: float, trace: bool,
        device, t0: float) -> dict:
    import torch

    cuda = torch.device(device).type == "cuda"
    with record_function("wb.setup"):
        problem = problem_of(cfg)
        call = entry(cfg, mix, device)
        marks = [["program imported", time.perf_counter() - t0]]
        call(problem, next(seeded.phases(seed, "warmup")),
             stop_step=int(mix["warmup_stop_step"]))
        _sync(device)
    setup_s = time.perf_counter() - t0
    marks.append(["warm-up solved", setup_s])

    pick = seeded.stream(seed, "sample")
    stream = seeded.phases(seed)
    done, failed, inits, kept, error = 0, 0, [], None, None
    with Window(trace, cuda=cuda) as win:
        start = time.perf_counter()
        while True:
            phase = next(stream)
            try:
                with record_function("wb.solve"):
                    res = call(problem, phase)
            except Exception as e:  # a failed solve ends the window
                failed, error = 1, f"{type(e).__name__}: {e}"
                break
            done += 1
            inits.append(res.init_seconds)
            if pick.random() * done < 1.0:
                kept = (phase, res.u_cur, res.u_prev, res.abs_errors)
            del res
            if time.perf_counter() - start >= seconds:
                break
        end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    _release(device)

    numbers = {}
    if kept is not None:
        with torch.no_grad():
            numbers = _numbers(cfg, mix, kept, device)
        kept = None
        _release(device)
    window_s = end - start
    rec = {"N": problem.N, "timesteps": problem.timesteps,
           "k": mix.get("args", {}).get("k"), "solves": done,
           "init_seconds": inits, "window_s": window_s}
    if win.busy_s is not None:
        rec.update(kernels=win.kernels, busy_s=win.busy_s,
                   trace_window_s=win.window_s)
    rate = (stats.rate_gcells(problem.cells_per_step, problem.timesteps,
                              done, window_s) if done else None)
    return {
        "e2e": {"gcells_per_s": rate, "setup_s": setup_s},
        "records": rec, "numbers": numbers, "attempted": done + failed,
        "failed": failed, "error": error, "memory_peak_bytes": peak,
        "window": win, "setup_marks": marks,
        "log": f"{done} solves in {window_s:.3f} s",
    }


def control(cfg: dict, mix: dict, *, seed: int, device) -> dict:
    """The control: the program's own lower-precision path (the mix's
    `control.args`) in the program's place, on the first phase of the
    seed, judged as a run judges its sampled solve."""
    import torch

    problem = problem_of(cfg)
    call = entry(cfg, mix, device, mix["control"]["args"])
    phase = next(seeded.phases(seed))
    res = call(problem, phase)
    kept = (phase, res.u_cur, res.u_prev, res.abs_errors)
    del res
    _release(device)
    with torch.no_grad():
        return _numbers(cfg, mix, kept, device)
