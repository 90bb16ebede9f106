"""Wrappers of the CUDA stencil kernels (csrc/stencil.cu,
csrc/kstep_pipe.cu, csrc/sharded.cu, csrc/comp_sharded.cu) and of the
1-step error pass (csrc/errors.cu), each with its plain PyTorch version
and a launch counter - the port of wavetpu/kernels/stencil_pallas.py's
kernels.

| kernel | replaces (wavetpu/kernels/stencil_pallas.py)          | wrapper            | counter            |
|--------|-------------------------------------------------------|--------------------|--------------------|
| K1     | `_step_kernel` via `_fused_step` :180 (call :209)     | `fused_step`       | `step`             |
| K5     | `_var_step_kernel` :147 via `_fused_step(c2tau2_field=)` | `fused_step(c2tau2_field=)` | `var_step` |
| K2     | `_comp_step_kernel` via `compensated_step` :575       | `compensated_step` | `comp_step`        |
| K3     | `_kstep_kernel` :745 via `fused_kstep` :824           | `fused_kstep`      | `kstep`            |
| K3f    | K3 with `c2tau2_field` (`_field_onion` :721)          | `fused_kstep(c2tau2_field=)` | `kstep_field` |
| K4     | `_kstep_comp_kernel` via `fused_kstep_comp` :1071     | `fused_kstep_comp` | `kstep_comp`       |
| K4f    | K4 with `c2tau2_field` (`has_field` :1043)            | `fused_kstep_comp(c2tau2_field=)` | `kstep_comp_field` |
| K6     | `_sharded_kernel` :316 via `sharded_fused_step` :448  | `sharded_fused_step` | `sharded_step` (`sharded_step_field` with a field) |
| K7     | `_sharded_comp_kernel` :364 via `sharded_compensated_step` :505 | `sharded_compensated_step` | `sharded_comp_step` |
| K8     | `_kstep_sharded_kernel` :1609 via `fused_kstep_sharded` :1690 | `fused_kstep_sharded` | `kstep_sharded` (`kstep_sharded_field`) |
| K9     | `_kstep_padded_kernel` :1782 via `fused_kstep_padded` :1882 | `fused_kstep_padded` | `kstep_padded` (`kstep_padded_field`) |
| K10    | `_kstep_sharded_xy_kernel` :1972 via `fused_kstep_sharded_xy` :2066 | `fused_kstep_sharded_xy` | `kstep_sharded_xy` (`kstep_sharded_xy_field`) |
| K11    | `_kstep_comp_sharded_kernel` :1163 via `fused_kstep_comp_sharded` :1264 | `fused_kstep_comp_sharded` | `kstep_comp_sharded` (`kstep_comp_sharded_field`) |
| K12    | `_kstep_comp_sharded_xy_kernel` :1369 via `fused_kstep_comp_sharded_xy` :1478 | `fused_kstep_comp_sharded_xy` | `kstep_comp_sharded_xy` (`kstep_comp_sharded_xy_field`) |
| errors | none (wavetpu's `verify/oracle.layer_errors`, fused by XLA) | `layer_errors` | `layer_errors` |

Lane modes (the ensembles' batch axis, wavetpu's `jax.vmap` of the same
Pallas bodies in ensemble/batched.py and ensemble/sharded.py; one launch
of the solo kernel over B lanes): K1 `fused_step_lanes` (`step_lanes`),
K5 `fused_step_lanes(c2tau2_field=)` (`var_step_lanes`), K2
`compensated_step_lanes` (`comp_step_lanes`), K3 `fused_kstep_lanes`
(`kstep_lanes`), K3f `fused_kstep_lanes(c2tau2_field=)`
(`kstep_field_lanes`), K4 `fused_kstep_comp_lanes` (`kstep_comp_lanes`),
K6 `sharded_fused_step_lanes` (`sharded_step_lanes`; a kernel of its
own, csrc/sharded.cu's x-streaming `sharded_lanes_kernel`, tiled by
`k6_lane_tile`).

The sharded kernels (K6-K12) take one shard's block and the ghost planes
that comm/halo.py (or the sharded k-fused solvers) delivered from the
neighbour shards.  K3, K8, K9 and K10 are one CUDA kernel
(csrc/kstep_pipe.cu `kstep_pipe_kernel`, an x-streaming pipeline of the
standard substep, its shape from `kstep_pipe_block`; K3 runs it over the
whole domain, its x windows the domain's own wrap planes; K9 masks the
planes past its real-plane count),
and so are K4, K11 and K12 (csrc/comp_sharded.cu `kstep_comp_pipe_kernel`,
the compensated substep's pipeline, K4 over the whole domain).  K10 and
K12 take a block of an (MX, MY, 1) mesh extended in y by k ghost rows per
side; the others whole y rows.

Dispatch is by the tensor's device and nothing else: a CPU tensor goes to
the plain version (that is how the CPU tests and `--platform cpu` run); a
CUDA tensor launches the kernel or raises - there is no fallback.  A
solver that is asked for the plain versions on the card (`--kernel roll`)
calls them by name (`make_step_fn(kernel=)`, `make_compensated_step_fn`,
`solver.sharded._make_local_step`), never through a wrapper.  Each
wrapper adds one to `launches[<counter>]` right after its kernel launched,
and nowhere else, so a run can show that it went through the kernels (a
field launch counts under its own name, so a run shows the field path
ran).  A field `c2tau2_field` is a tau^2 c^2 (N, N, N) tensor in the
compute dtype (f32 for f32 and bf16 states; `io.state.c2tau2_field`).

The plain versions repeat the kernels' arithmetic in the same order (the
Pallas kernels' order, which for K1 is `alpha*u + coeff*lap - beta*u_prev`,
not stencil_ref's `2u - u_prev + c*lap`); they are references, not
yardsticks of speed.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Dict, Optional, Tuple

import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import build
from wavetpu_torch.kernels.stencil_ref import (
    compute_dtype, ghost_extend, laplacian, laplacian_ext,
)
from wavetpu_torch.verify import oracle

launches: Dict[str, int] = {
    "step": 0, "var_step": 0, "comp_step": 0, "kstep": 0, "kstep_field": 0,
    "kstep_comp": 0, "kstep_comp_field": 0,
    "sharded_step": 0, "sharded_step_field": 0, "sharded_comp_step": 0,
    "kstep_sharded": 0, "kstep_sharded_field": 0,
    "kstep_padded": 0, "kstep_padded_field": 0,
    "kstep_sharded_xy": 0, "kstep_sharded_xy_field": 0,
    "kstep_comp_sharded": 0, "kstep_comp_sharded_field": 0,
    "kstep_comp_sharded_xy": 0, "kstep_comp_sharded_xy_field": 0,
    # Every launch of csrc/comp_sharded.cu's pipeline (K4, K11, K12, their
    # field forms and K4's lane mode) once more, by the face rows R a
    # thread owns (`comp_pipe_block`).
    "kstep_comp_r1": 0, "kstep_comp_r2": 0, "kstep_comp_r3": 0,
    # Every launch of csrc/kstep_pipe.cu's pipeline (K3, K8, K9, K10,
    # their field forms and K3's lane mode) once more, by the face rows R
    # a thread owns (`kstep_pipe_block`).
    "kstep_pipe_r1": 0, "kstep_pipe_r2": 0, "kstep_pipe_r3": 0,
    "kstep_pipe_r4": 0,
    # The lane modes (the ensembles' batch axis; see the end of the file).
    "step_lanes": 0, "var_step_lanes": 0, "comp_step_lanes": 0,
    "kstep_lanes": 0, "kstep_field_lanes": 0, "kstep_comp_lanes": 0,
    "sharded_step_lanes": 0,
    # The 1-step error pass (csrc/errors.cu).
    "layer_errors": 0,
}

# dtype codes of csrc/stencil.cu.
_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_NONE = -1

# K3 takes 2 <= k <= 8 (k = 1 is K1's job), the other k-step kernels
# 1 <= k <= 8.
_KSTEP_MAX_K = 8
# The carry slab's cap (`default_block_x`), and the pipelines of
# csrc/kstep_pipe.cu (K3, K8-K10, `kstep_pipe_tile`; blocked shapes
# `kstep_pipe_block`) and csrc/comp_sharded.cu (K4, K11/K12,
# `comp_pipe_tile`; blocked shapes `comp_pipe_block`): one thread per
# column of the (ty+2k)(tz+2k) halo face, at most 1024 for k <= 4 and 640
# above (the per-stage registers grow with k), or R cells of a column a
# thread in the blocked shapes; x segments of up to _PIPE_SEG planes
# inside one carry slab (K4, K11, K12), of up to _KPIPE_SEG planes (K3,
# K8-K10: kernels/tile_ab.py part `kpipe`, PERF.md).
_SLAB_CAP = 32
_PIPE_SEG = 32
_PIPE_MAX_SEG = 64  # kPipeMaxSeg: a segment's oracle rows in shared memory
_KPIPE_SEG = 128  # kStdMaxSeg of csrc/kstep_pipe.cu
_PIPE_FACE_Z = 32
# K4, K11 and K12's blocked shapes (csrc/comp_sharded.cu `launch_shape`):
# R face rows a thread -> the block size built for it, where `Blocked`
# builds them: k = 4, f32 v and a bf16 carry, no field, solo and lanes.
# `_COMP_CHOICE` is the R each (k, v dtype, carry dtype, field, lanes)
# launches, from the A/B of kernels/tile_ab.py part `pipe` (PERF.md): the
# fastest shape that ptxas builds without spilling; every other one takes
# R = 1 at `comp_pipe_tile`'s face.  The face is _COMP_FACE_Z columns wide,
# one warp per row, as many rows as the block's threads hold.
_COMP_SHAPES = {2: 640, 3: 512}
_COMP_FACE_Z = 32
_COMP_MAX_EZ = 64  # kPipeMaxEz: the widest face (tz + 2k) a block takes
_COMP_CHOICE = {
    (4, torch.float32, torch.bfloat16, False, False): 2,
    (4, torch.float32, torch.bfloat16, False, True): 3,
}
# K3 and K8-K10's shapes (csrc/kstep_pipe.cu `launch_shape`):
# `_KSTEP_CHOICE` is the (R face rows a thread, block size) each (k, state
# dtype, field, pad, lanes, y-extended) launches, from the A/B of
# kernels/tile_ab.py part `kpipe` (PERF.md): the fastest that ptxas builds
# without spilling.  The kernel builds these blocked shapes and no others;
# every other key takes R = 1 at `kstep_pipe_tile`'s face.  A blocked face
# is _COMP_FACE_Z columns wide, one warp per row, as many rows as the
# block's threads hold.
_KSTEP_CHOICE = {
    (4, torch.float32, False, False, False, False): (4, 512),  # K3, K8
    (4, torch.float32, False, False, False, True): (4, 512),   # K10
    (4, torch.float32, True, False, False, False): (3, 512),   # K3f, K8f
    (4, torch.float32, True, False, False, True): (2, 640),    # K10f
    (4, torch.float32, False, True, False, False): (2, 768),   # K9
    (4, torch.float32, True, True, False, False): (3, 512),    # K9f
    (4, torch.float32, False, False, True, False): (4, 512),   # K3 lanes
    (4, torch.float32, True, False, True, False): (3, 512),    # K3f lanes
}


def pipe_max_threads(k: int) -> int:
    """Threads of one block of either pipeline (StdThreads and PipeThreads
    in csrc/): one per column of the (ty+2k)(tz+2k) halo face, 1024 for
    k <= 4 and 640 above, where the per-stage registers add up."""
    return 1024 if k <= 4 else 640


# The template instantiations launched so far in this process, and the
# host seconds their first launches took (`_run`).
_launched: set = set()
first_launch_seconds = 0.0


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


_P, _I, _D, _I64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                    ctypes.c_int64)
# {library: {entry point: (argtypes, restype)}}, one library per source of
# csrc/: stencil.cu (K1/K5, K2), kstep_pipe.cu (K3, K8, K9, K10),
# sharded.cu (K6, K7), comp_sharded.cu (K4, K11/K12), errors.cu (the
# 1-step error pass).  Every entry point takes the stream last and returns
# a cudaError_t code.
_SIGNATURES = {
    "stencil": {
        "wt_error_string": ([_I], ctypes.c_char_p),
        "wt_step": ([_P] * 4 + [_I] * 2 + [_D] * 6 + [_I] * 2 + [_P], _I),
        "wt_comp_step": ([_P] * 6 + [_I] * 2 + [_D] * 4 + [_I, _P], _I),
    },
    "kstep_pipe": {
        "wt_kstep_pipe": ([_P] * 16 + [_I] * 13 + [_D] * 4 + [_I, _I64, _P],
                          _I),
    },
    "sharded": {
        "wt_sharded_step": ([_P] * 10 + [_I] * 11 + [_D] * 6 + [_I, _P], _I),
        "wt_sharded_comp_step": ([_P] * 12 + [_I] * 11 + [_D] * 4 + [_P],
                                 _I),
        "wt_sharded_lanes": ([_P] * 9 + [_I] * 11 + [_D] * 6 + [_I] * 4
                             + [_P], _I),
    },
    "comp_sharded": {
        "wt_kstep_comp_chain": ([_P] * 18 + [_I] * 13 + [_D] * 4
                                + [_I, _I64, _P], _I),
    },
    "errors": {
        "wt_layer_errors": ([_P, _I, _I, _I, _I64, _I64] + [_P] * 6
                            + [_I, _P], _I),
    },
}


def _load(name: str) -> ctypes.CDLL:
    """Library `name` (built, loaded), its entry points typed once."""
    lib = build.load(name)
    if not getattr(lib, "_wt_typed", False):
        for symbol, (argtypes, restype) in _SIGNATURES[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, restype
        lib._wt_typed = True
    return lib


_LOADERS = {name: functools.partial(_load, name) for name in _SIGNATURES}


def load_libraries(names=None) -> None:
    """Build every kernel library of `names` (default: all) not built yet
    (one nvcc per source, in parallel) and load them, so no build lands
    inside a timed region."""
    names = tuple(_LOADERS) if names is None else tuple(names)
    build.build_all(names=names)
    for name in names:
        _LOADERS[name]()


def libraries_for(path: str, scheme: str = "standard", k: int = 1,
                  mesh=None) -> Tuple[str, ...]:
    """The kernel libraries a serve program of this identity launches
    (ensemble/batched.py, ensemble/sharded.py): "roll" runs the plain
    versions and builds none; a mesh K6's lane mode (sharded.cu) and the
    error pass (errors.cu); 1-step pallas K1/K5 or K2 (stencil.cu) and the
    error pass; kfused K3/K3f, the K1/K5 bootstrap and the error pass of
    layer 1 and the 1-step tail (kstep_pipe.cu, stencil.cu, errors.cu) or,
    compensated, K4 and the K2 bootstrap, whose layer-1 errors are the
    masked plain pass (comp_sharded.cu, stencil.cu)."""
    if path == "roll":
        return ()
    if mesh is not None:
        return ("sharded", "errors")
    if path == "kfused" and k > 1 and scheme == "compensated":
        return ("comp_sharded", "stencil")
    if path == "kfused" and k > 1:
        return ("kstep_pipe", "stencil", "errors")
    return ("stencil", "errors")


def launched_instantiations() -> list:
    """The template instantiations launched so far in this process
    (`_run`'s `inst` tuples), sorted."""
    return sorted(_launched, key=repr)


def _check_cuda(n: int, **tensors) -> None:
    """Raise unless every given tensor is a contiguous (n, n, n) CUDA tensor
    on one device (what the kernels index)."""
    dev = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        dev = t.device
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() == 3 and tuple(t.shape) != (n, n, n):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {(n, n, n)}")


def _run(fn, *args, inst: tuple) -> None:
    """Call a C entry point on the current stream; raise on a CUDA error
    (a refused launch never runs, and synchronize would not report it).
    Every library returns cudaError_t codes; stencil's wt_error_string
    names them.  `inst` names the template instantiation the call
    launches (its launch counter and template parameters): the host wall
    time of its first launch in the process - the CUDA runtime loads the
    instantiation there - is added to `first_launch_seconds` (the compile
    ledger's share of the solve that paid it; no synchronisation)."""
    global first_launch_seconds
    first = inst not in _launched
    t0 = time.perf_counter() if first else 0.0
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if first:
        _launched.add(inst)
        first_launch_seconds += time.perf_counter() - t0
    if err != 0:
        msg = _load("stencil").wt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_field(field, u) -> None:
    """A field on the card: (N, N, N), contiguous, on u's device, in u's
    compute dtype (what the kernels read)."""
    n = u.shape[0]
    _check_cuda(n, u=u, c2tau2_field=field)
    if field.dim() != 3 or field.dtype != compute_dtype(u.dtype):
        raise ValueError(
            f"c2tau2_field must be ({n}, {n}, {n}) "
            f"{compute_dtype(u.dtype)}, got {field.dtype}{tuple(field.shape)}"
        )


# ---------------------------------------------------------------------------
# K1: the 1-step stencil.


def fused_step_plain(u_prev, u, *, inv_h2, alpha=2.0, beta=1.0, coeff=None,
                     c2tau2_field=None):
    """Plain K1: out = alpha*u + coeff*lap(u) - beta*u_prev (beta term only
    if beta != 0) in the compute dtype, y=0 / z=0 planes masked.  With
    `c2tau2_field`, plain K5: (alpha, beta) = (2, 1) and the field's cell in
    place of coeff (`alpha`, `beta`, `coeff` ignored, as the TPU kernel)."""
    f = compute_dtype(u.dtype)
    if c2tau2_field is not None:
        alpha, beta, coeff = 2.0, 1.0, c2tau2_field.to(f)
    c = u.to(f)
    out = alpha * c + coeff * laplacian(c, inv_h2)
    if beta:
        out = out - beta * u_prev.to(f)
    out[:, 0, :] = 0.0
    out[:, :, 0] = 0.0
    return out.to(u.dtype)


def fused_step(u_prev, u, *, inv_h2, alpha=2.0, beta=1.0, coeff=None,
               c2tau2_field=None):
    """K1 (replaces stencil_pallas._fused_step's constant-speed kernel);
    with `c2tau2_field`, K5 (its variable-speed kernel, `_var_step_kernel`):
    out = (2u + c2tau2*lap(u)) - u_prev, `alpha`/`beta`/`coeff` ignored."""
    if u.device.type == "cpu":
        return fused_step_plain(u_prev, u, inv_h2=inv_h2, alpha=alpha,
                                beta=beta, coeff=coeff,
                                c2tau2_field=c2tau2_field)
    n = u.shape[0]
    _check_cuda(n, u=u, u_prev=u_prev)
    if u.dtype not in _CODE or u_prev.dtype != u.dtype:
        raise ValueError(f"K1/K5 take f32/f64/bf16 state, got "
                         f"{u.dtype}/{u_prev.dtype}")
    if c2tau2_field is not None:
        _check_field(c2tau2_field, u)
        alpha, beta, coeff = 2.0, 1.0, 0.0
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        _run(_load("stencil").wt_step, u_prev.data_ptr(), u.data_ptr(),
             out.data_ptr(), _ptr(c2tau2_field), n, _CODE[u.dtype],
             float(alpha), float(beta), float(coeff),
             *(float(h) for h in inv_h2), int(beta != 0), 1,
             inst=("step" if c2tau2_field is None else "var_step", u.dtype,
                   beta != 0))
    launches["step" if c2tau2_field is None else "var_step"] += 1
    return out


def leapfrog_step(u_prev, u, problem: Problem):
    """u_next = 2u + a2tau2*lap(u) - u_prev, Dirichlet re-imposed."""
    return fused_step(u_prev, u, inv_h2=problem.inv_h2, alpha=2.0, beta=1.0,
                      coeff=problem.a2tau2)


def taylor_half_step(u0, problem: Problem):
    """u1 = u0 + (a2tau2/2)*lap(u0), Dirichlet re-imposed."""
    return fused_step(u0, u0, inv_h2=problem.inv_h2, alpha=1.0, beta=0.0,
                      coeff=0.5 * problem.a2tau2)


def check_kernel(kernel: str) -> None:
    """`kernel` selects what a solver launches: "pallas" the CUDA kernels
    (wavetpu's Pallas kernels' counterparts), "roll" their plain PyTorch
    versions on the same device (the CLI's --kernel)."""
    if kernel not in ("pallas", "roll"):
        raise ValueError(f"kernel must be 'pallas' or 'roll', got {kernel!r}")


def make_step_fn(c2tau2_field=None, kernel: str = "pallas"):
    """A `(u_prev, u, problem) -> u_next` step for `leapfrog.solve(step_fn=)`
    (stencil_pallas.make_step_fn :2166): K1 for constant speed, K5 over
    `c2tau2_field` (a device tensor in the compute dtype, placed once by
    the caller) for variable speed; with kernel="roll" their plain
    versions."""
    check_kernel(kernel)
    if c2tau2_field is None and kernel == "pallas":
        return leapfrog_step
    fn = fused_step if kernel == "pallas" else fused_step_plain

    def step(u_prev, u, problem: Problem):
        if c2tau2_field is not None:
            return fn(u_prev, u, inv_h2=problem.inv_h2,
                      c2tau2_field=c2tau2_field)
        return fn(u_prev, u, inv_h2=problem.inv_h2, alpha=2.0, beta=1.0,
                  coeff=problem.a2tau2)

    return step


def make_compensated_step_fn(kernel: str = "pallas"):
    """A `(u, v, carry, problem, coeff) -> (u', v', carry')` step for
    `leapfrog.solve_compensated(comp_step_fn=)`
    (stencil_pallas.make_compensated_step_fn): K2, or with kernel="roll"
    its plain version."""
    check_kernel(kernel)
    if kernel == "pallas":
        return compensated_step

    def step(u, v, carry, problem: Problem, coeff=None):
        return compensated_step_plain(
            u, v, carry, inv_h2=problem.inv_h2,
            coeff=problem.a2tau2 if coeff is None else coeff)

    return step


# ---------------------------------------------------------------------------
# K2: the 1-step compensated step.


def compensated_step_plain(u, v, carry, *, inv_h2, coeff):
    """Plain K2: d = mask(coeff*lap(u)); v' = v + d; Kahan two-sum
    u' = u + v' through the carry."""
    f = compute_dtype(u.dtype)
    c = u.to(f)
    d = coeff * laplacian(c, inv_h2)
    d[:, 0, :] = 0.0
    d[:, :, 0] = 0.0
    v_next = v.to(f) + d
    y = v_next - carry.to(f)
    t = c + y
    carry_next = (t - c) - y
    return t.to(u.dtype), v_next.to(u.dtype), carry_next.to(u.dtype)


def compensated_step(u, v, carry, problem: Problem, coeff=None):
    """K2 (replaces stencil_pallas.compensated_step): (u, v, carry) ->
    (u', v', carry'), all three in u's dtype.  `coeff` defaults to a2tau2;
    the layer-1 bootstrap passes a2tau2/2 with v = carry = 0."""
    coeff = problem.a2tau2 if coeff is None else coeff
    if u.device.type == "cpu":
        return compensated_step_plain(u, v, carry, inv_h2=problem.inv_h2,
                                      coeff=coeff)
    n = u.shape[0]
    _check_cuda(n, u=u, v=v, carry=carry)
    if u.dtype not in (torch.float32, torch.float64) or not (
        v.dtype == carry.dtype == u.dtype
    ):
        raise ValueError("K2 takes f32 or f64 u, v and carry of one dtype")
    outs = tuple(torch.empty_like(u) for _ in range(3))
    with torch.cuda.device(u.device):
        _run(_load("stencil").wt_comp_step, u.data_ptr(), v.data_ptr(),
             carry.data_ptr(), *(o.data_ptr() for o in outs), n,
             _CODE[u.dtype], float(coeff),
             *(float(h) for h in problem.inv_h2), 1,
             inst=("comp_step", u.dtype))
    launches["comp_step"] += 1
    return outs


# ---------------------------------------------------------------------------
# The 1-step error pass.


def layer_errors(u, sx, sy, sz, ct, out=None):
    """The L-inf abs / rel error of layer `u` against the separable closed
    form, csrc/errors.cu `layer_errors_kernel`: bit for bit its plain
    version `oracle.separable_layer_errors`, which it runs for CPU tensors
    (NaN in u -> abs NaN, rel finite; 0/0 -> 0; an inf kept), in one read
    of `u` and one launch.

    `u` is a 3-D view (f32, bf16 or f64; last stride 1, e.g. the interior
    u[1:, 1:, 1:] or a shard's error box), `sx`, `sy`, `sz` its 1-D
    factors (contiguous, one value per plane, row and column of the view,
    in the compute dtype: f32 for bf16), `ct` the 0-d time factor on the
    device (a layer's entry of the time-factor table: no host sync).
    `out` = (abs slot, rel slot), 0-d tensors of the compute dtype on u's
    device, e.g. `abs_all[n]`, that hold 0: the kernel folds its maxima
    into them with atomicMax (the solvers' error vectors are allocated
    zeroed and each slot is written once).  Without `out` a fresh zeroed
    pair is allocated.  Returns the pair."""
    if u.device.type == "cpu":
        return oracle.separable_layer_errors(u, sx, sy, sz, ct, out)
    _require_cuda(u)
    f = compute_dtype(u.dtype)
    if u.dtype not in _CODE or u.dim() != 3 or u.stride(2) != 1:
        raise ValueError(f"the error pass takes a 3-D f32/bf16/f64 view "
                         f"with last stride 1, got {u.dtype} shape "
                         f"{tuple(u.shape)} strides {u.stride()}")
    if u.numel() == 0:
        raise ValueError("the error pass needs a non-empty view")
    if out is None:
        pair = torch.zeros(2, dtype=f, device=u.device)
        out = (pair[0], pair[1])
    _check_on_card(u.device, f, sx=(sx, u.shape[:1]), sy=(sy, u.shape[1:2]),
                   sz=(sz, u.shape[2:]), ct=(ct, ()), abs_out=(out[0], ()),
                   rel_out=(out[1], ()))
    with torch.cuda.device(u.device):
        _run(_load("errors").wt_layer_errors, u.data_ptr(), *u.shape,
             u.stride(0), u.stride(1), sx.data_ptr(), sy.data_ptr(),
             sz.data_ptr(), ct.data_ptr(), out[0].data_ptr(),
             out[1].data_ptr(), _CODE[u.dtype],
             inst=("layer_errors", u.dtype))
    launches["layer_errors"] += 1
    return out


def make_layer_errors_fn(kernel: str = "pallas"):
    """The error pass a solver runs, `(u, sx, sy, sz, ct, out=None) ->
    (abs, rel)`: the error kernel (`layer_errors`), or with kernel="roll"
    its plain version."""
    check_kernel(kernel)
    return (layer_errors if kernel == "pallas"
            else oracle.separable_layer_errors)


# ---------------------------------------------------------------------------
# K3: k fused leapfrog substeps.


def fused_kstep_plain(u_prev, u, syz, rsyz, sxct, *, k, coeff, inv_h2,
                      c2tau2_field=None, with_errors=True):
    """Plain K3: k full-field leapfrog substeps, each op for op K1's
    (2u + coeff*lap(u)) - u_prev with the y=0 / z=0 planes masked (the
    field's cell in place of coeff with `c2tau2_field`), a bf16 state
    rounded to bf16 and back after every substep.  The TPU kernel's x
    onion computes the same cells, so no slab depth enters.  Returns
    (u_{n+k-1}, u_{n+k}, dmax, rmax) with the (k, N) f32 per-substep
    per-x-plane error maxes of each new layer against sxct[s-1, x] * syz
    (None, None without `with_errors`)."""
    n = u.shape[0]
    if n % k:
        raise ValueError(f"k={k} must divide N={n}")
    f = compute_dtype(u.dtype)
    co = coeff if c2tau2_field is None else c2tau2_field.to(f)
    prev, cur = u_prev.to(f), u.to(f)
    dmax = rmax = None
    if with_errors:
        dmax = torch.zeros((k, n), dtype=torch.float32, device=u.device)
        rmax = torch.zeros((k, n), dtype=torch.float32, device=u.device)
        syz_f, rsyz_f = syz.to(f), rsyz.to(f)
    for s in range(1, k + 1):
        new = 2.0 * cur + co * laplacian(cur, inv_h2)
        new = new - prev
        new[:, 0, :] = 0.0
        new[:, :, 0] = 0.0
        if u.dtype != f:
            new = new.to(u.dtype).to(f)
        if with_errors:
            diff = (new - sxct[s - 1].to(f)[:, None, None] * syz_f).abs()
            dmax[s - 1] = diff.amax(dim=(1, 2)).float()
            rmax[s - 1] = (diff * rsyz_f).amax(dim=(1, 2)).float()
        prev, cur = cur, new
    return prev.to(u.dtype), cur.to(u.dtype), dmax, rmax


def fused_kstep(u_prev, u, syz, rsyz, sxct, *, k, coeff, inv_h2,
                c2tau2_field=None, with_errors=True):
    """K3 (replaces stencil_pallas.fused_kstep): k temporally fused
    leapfrog steps of the (N,N,N) state, bitwise equal to k K1 steps (K5
    steps with `c2tau2_field`, which then replaces `coeff`).  Returns
    (u_{n+k-1}, u_{n+k}, dmax, rmax); dmax/rmax are the (k, N) f32
    per-substep per-x-plane error maxes (None, None without
    `with_errors`; then syz, rsyz and sxct are not read).  On the card:
    f32 or bf16 state, 2 <= k <= 8, k | N.

    On the card K3 launches K8's kernel (`_kstep_pipe`, the x-streaming
    pipeline of csrc/kstep_pipe.cu) over the whole state: its x windows are
    the state's own wrap planes (`wrap_planes`), views read in place."""
    n = u.shape[0]
    if u.device.type == "cpu":
        return fused_kstep_plain(
            u_prev, u, syz, rsyz, sxct, k=k, coeff=coeff, inv_h2=inv_h2,
            c2tau2_field=c2tau2_field, with_errors=with_errors,
        )
    if not 2 <= k <= _KSTEP_MAX_K or n % k:
        raise ValueError(f"k={k}: the K3 kernel takes 2 <= k <= "
                         f"{_KSTEP_MAX_K} dividing N={n} (k=1 is K1's step)")
    _check_cuda(n, u=u, u_prev=u_prev)
    if u.dtype not in (torch.float32, torch.bfloat16) or \
            u_prev.dtype != u.dtype:
        raise ValueError(f"K3 takes an f32 or bf16 state, got "
                         f"{u.dtype}/{u_prev.dtype}")
    if c2tau2_field is not None:
        _check_field(c2tau2_field, u)
    if with_errors:
        _check_cuda(n, syz=syz, rsyz=rsyz, sxct=sxct)
        _check_planes(n, k, syz, rsyz, sxct)
    return _kstep_pipe("kstep", u_prev, u, wrap_planes(u_prev, k),
                       wrap_planes(u, k), syz, rsyz, sxct, k=k, coeff=coeff,
                       inv_h2=inv_h2, c2tau2_block=c2tau2_field,
                       c2_ghosts=wrap_planes(c2tau2_field, k),
                       with_errors=with_errors)


def wrap_planes(t, k: int):
    """The x windows of a whole (N, ., .) state as the k-step pipelines
    read it (K3, K4): its last and its first k planes, (t[N-k:], t[:k]),
    views of `t` (no copy); None for None."""
    return None if t is None else (t[t.shape[0] - k:], t[:k])


# ---------------------------------------------------------------------------
# K4: k fused velocity-form substeps.


def default_block_x(n: int, k: int) -> int:
    """The x slab whose carry halo starts at zero (the TPU kernel's block_x
    semantics) of K4 and K11/K12: the deepest multiple of k that divides n,
    up to `_SLAB_CAP` planes (k when k does not divide n).  Deeper slabs
    zero-seed fewer carry planes, and the pipeline's x segments lie inside
    one slab.  A shard's slab default_block_x(N/MX, k) equals the single-device
    default_block_x(N, k) wherever the latter divides N/MX, so one
    partition serves both."""
    bx = k
    for depth in range(k, min(n, _SLAB_CAP) + 1, k):
        if n % depth == 0:
            bx = depth
    return bx


def kstep_pipe_tile(k: int, d: int) -> Tuple[int, int, int]:
    """(seg, ty, tz) of K3 and K8-K10's x-streaming pipeline
    (csrc/kstep_pipe.cu): the fewest x segments of at most _KPIPE_SEG
    planes that cover the depth d, seg = ceil(d / ceil(d / _KPIPE_SEG))
    planes each (no slab: the standard substep's cells are a function of
    the inputs alone, so where seg does not divide d the last segment ends
    at d and remakes a few planes of the one before), and the y/z face of
    `comp_pipe_tile`.  Every depth of at most _KPIPE_SEG planes is one
    segment; 512 is four of 128."""
    if d < 1:
        raise ValueError(f"depth {d} must be positive")
    seg = -(-d // -(-d // _KPIPE_SEG))
    return (seg,) + comp_pipe_tile(k, seg)[1:]


def kstep_pipe_smem(k: int, ty: int, tz: int, r: int = 1,
                    block: int = 0) -> int:
    """Shared memory of one K3/K8-K10 pipeline block (bytes): at r = 1
    each stage's two-slot ring of the halo face's u; in the blocked shape
    of r face rows a thread on `block` threads each stage's three-slot
    ring, r planes of `block` words and their guards of _COMP_MAX_EZ words
    either side, and the cells' (syz, rsyz) pairs in one such plane set
    (dynamic); the static error slots [2][8][2][32] words and oracle rows
    [8][128]."""
    static = (2 * 8 * 2 * 32 + 8 * 128) * 4
    if r == 1:
        return 2 * k * (ty + 2 * k) * (tz + 2 * k) * 4 + static
    plane = block + 2 * _COMP_MAX_EZ
    return (3 * k + 2) * r * plane * 4 + static


def kstep_pipe_shapes(k: int, dtype=torch.float32, field: bool = False,
                      pad: bool = False, lanes: bool = False) -> list:
    """The (R, block size) pairs csrc/kstep_pipe.cu builds for this k,
    state dtype, field and mode (K9's pad, K3's lanes): R = 1 at
    `pipe_max_threads(k)`, then the blocked shapes `_KSTEP_CHOICE` names
    for it (K10's y-extended block shares the solo instantiation)."""
    return [(1, pipe_max_threads(k))] + sorted(
        {shape for key, shape in _KSTEP_CHOICE.items()
         if key[:5] == (k, dtype, field, pad, lanes)}, reverse=True)


def kstep_pipe_block(k: int, d: int, dtype=torch.float32,
                     field: bool = False, pad: bool = False,
                     lanes: bool = False, ext: bool = False
                     ) -> Tuple[int, int, int, int, int]:
    """(seg, ty, tz, r, block) of K3, K8-K10 and K3's lane mode on a depth
    d: `kstep_pipe_tile`'s segment, and the face, face rows a thread r and
    block size of the shape `_KSTEP_CHOICE` names for (k, state dtype,
    field, K9's pad, lanes, K10's y-extended block): (block /
    _COMP_FACE_Z) x r rows of _COMP_FACE_Z columns, or `kstep_pipe_tile`'s
    face at r = 1."""
    seg, ty, tz = kstep_pipe_tile(k, d)
    r, nt = _KSTEP_CHOICE.get((k, dtype, field, pad, lanes, ext),
                              (1, pipe_max_threads(k)))
    if r == 1:
        return seg, ty, tz, 1, nt
    ey = nt // _COMP_FACE_Z * r
    return seg, ey - 2 * k, _COMP_FACE_Z - 2 * k, r, nt


def _kstep_shape(k, d, tile, dtype, field, pad, lanes, ext):
    """The launch's (seg, ty, tz, r, block): `tile` ((seg, ty, tz) at r =
    1, (seg, ty, tz, r) at the block size built for r, or (seg, ty, tz, r,
    block)) or `kstep_pipe_block`'s, checked against the depth and the
    shapes built."""
    shapes = kstep_pipe_shapes(k, dtype, field, pad, lanes)
    if tile is None:
        tile = kstep_pipe_block(k, d, dtype, field, pad, lanes, ext)
    tile = tuple(tile) + (1,) * (len(tile) == 3)
    if len(tile) == 4:
        tile += (next((nt for r, nt in shapes if r == tile[3]), 0),)
    seg, ty, tz, r, nt = tile
    ok = min(seg, ty, tz, r) > 0
    threads = comp_pipe_threads(k, ty, tz, r) if ok else 0
    if (not ok or seg > min(d, _KPIPE_SEG) or (r, nt) not in shapes
            or threads > nt or (r > 1 and tz + 2 * k > _COMP_MAX_EZ)):
        raise ValueError(f"tile {tuple(tile)} does not fit depth {d} and "
                         f"k={k} (shapes built here: {shapes})")
    return seg, ty, tz, r, nt


def comp_pipe_tile(k: int, bx: int) -> Tuple[int, int, int]:
    """(seg, ty, tz) of the one-cell-a-thread pipeline face: an x segment
    of seg planes, the largest divisor of the carry slab bx up to
    _PIPE_SEG (a segment of K4, K11/K12 lies in one slab), and a (ty, tz)
    y/z output face whose halo face, (ty+2k) rows of _PIPE_FACE_Z = tz+2k
    columns (one warp per row), fills `pipe_max_threads(k)` threads.  The
    face of K3 and K8-K10 (`kstep_pipe_tile`) and of K4's shapes at R = 1
    (`comp_pipe_block`)."""
    if not 1 <= k <= _KSTEP_MAX_K:
        raise ValueError(f"k={k}: the pipeline takes 1 <= k <= "
                         f"{_KSTEP_MAX_K}")
    seg = max(s for s in range(1, min(bx, _PIPE_SEG) + 1) if bx % s == 0)
    ey = pipe_max_threads(k) // _PIPE_FACE_Z
    return seg, ey - 2 * k, _PIPE_FACE_Z - 2 * k


def comp_pipe_smem(k: int, r: int, block: int) -> int:
    """Shared memory of one K4/K11/K12 block of the shape with r face rows
    a thread and `block` threads at most (bytes): each stage's three-slot
    ring of the halo face's u, r planes of `block` words and their guards
    of _COMP_MAX_EZ words either side, and the cells' (syz, rsyz) pairs in
    one such plane set (dynamic); the static error slots [2][8][2][32]
    words (a slot per warp) and oracle rows [8][64]."""
    plane = block + 2 * _COMP_MAX_EZ
    return (3 * k + 2) * r * plane * 4 + (2 * 8 * 2 * 32 + 8 * 64) * 4


def comp_pipe_threads(k: int, ty: int, tz: int, r: int) -> int:
    """Threads of one block of either pipeline (K4/K11/K12, K3/K8-K10):
    ceil((ty + 2k) / r) rows of tz + 2k columns, padded to whole warps."""
    cols = -(-(ty + 2 * k) // r) * (tz + 2 * k)
    return -(-cols // 32) * 32


def comp_pipe_shapes(k: int, v_dtype, carry_dtype, field: bool) -> Dict:
    """R -> the block size csrc/comp_sharded.cu builds for this k, storage
    and field: R = 1 at `pipe_max_threads(k)` everywhere, the blocked
    shapes (`_COMP_SHAPES`) where `Blocked` builds them."""
    shapes = {1: pipe_max_threads(k)}
    if (k == 4 and not field and v_dtype == torch.float32
            and carry_dtype == torch.bfloat16):
        shapes.update(_COMP_SHAPES)
    return shapes


def comp_pipe_block(k: int, bx: int, v_dtype=torch.float32,
                    carry_dtype=torch.bfloat16, field: bool = False,
                    lanes: bool = False) -> Tuple[int, int, int, int]:
    """(seg, ty, tz, r) of K4, K11/K12 and K4's lane mode: `comp_pipe_tile`'s
    segment, and the face and face rows a thread r of the shape
    `_COMP_CHOICE` names for (k, storage, field, lane mode):
    (threads / _COMP_FACE_Z) x r rows of _COMP_FACE_Z columns, or
    `comp_pipe_tile`'s face at r = 1."""
    seg, ty, tz = comp_pipe_tile(k, bx)
    r = _COMP_CHOICE.get((k, v_dtype, carry_dtype, field, lanes), 1)
    if r == 1:
        return seg, ty, tz, 1
    ey = _COMP_SHAPES[r] // _COMP_FACE_Z * r
    return seg, ey - 2 * k, _COMP_FACE_Z - 2 * k, r


def _comp_shape(k, bx, tile, v_dtype, carry_dtype, field, lanes=False):
    """The launch's (seg, ty, tz, r, block size): `tile` ((seg, ty, tz) at
    r = 1, or (seg, ty, tz, r)) or `comp_pipe_block`'s, checked against the
    slab and the shapes built."""
    if tile is None:
        tile = comp_pipe_block(k, bx, v_dtype, carry_dtype, field, lanes)
    seg, ty, tz, r = tuple(tile) + (1,) * (4 - len(tile))
    shapes = comp_pipe_shapes(k, v_dtype, carry_dtype, field)
    ok = min(seg, ty, tz, r) > 0
    threads = comp_pipe_threads(k, ty, tz, r) if ok else 0
    if (not ok or bx % seg or seg > _PIPE_MAX_SEG or r not in shapes
            or threads > shapes[r] or tz + 2 * k > _COMP_MAX_EZ):
        raise ValueError(f"tile {tuple(tile)} does not fit block_x={bx} and "
                         f"k={k} (face rows a thread built here: "
                         f"{sorted(shapes)})")
    return seg, ty, tz, r, shapes[r]


def _check_kstep(n, k, bx):
    if n % k:
        raise ValueError(f"k={k} must divide N={n}")
    if n % bx or bx % k:
        raise ValueError(f"block_x={bx} must divide N={n} and be a multiple "
                         f"of k={k}")


def _check_planes(n, k, syz, rsyz, sxct):
    for name, t, shape in (("syz", syz, (n, n)), ("rsyz", rsyz, (n, n)),
                           ("sxct", sxct, (k, n))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32 {shape}")


def fused_kstep_comp_plain(u, v, carry, syz, rsyz, sxct, *, k, coeff,
                           inv_h2, block_x, with_errors=True,
                           c2tau2_field=None):
    """Plain K4, slab by slab exactly as the TPU kernel: u and v onions of
    block_x + 2k planes with wrapped x halos, the carry zero on the halo
    planes, k substeps shrinking the onion by one plane per side; with
    `c2tau2_field` (plain K4f) the field's onion, whose slice
    [s, bx + 2k - s) is substep s's coefficient in place of coeff.  Returns
    (u', v', carry' | None, dmax, rmax) with (k, N) f32 error rows (None
    without `with_errors`)."""
    n = u.shape[0]
    bx = block_x
    _check_kstep(n, k, bx)
    f = compute_dtype(u.dtype)
    ix, iy, iz = inv_h2
    dev = u.device
    iyz = torch.arange(n, device=dev)
    mask = ((iyz[:, None] != 0) & (iyz[None, :] != 0))[None]
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    c_out = None if carry is None else torch.empty_like(carry)
    dmax = rmax = None
    if with_errors:
        dmax = torch.zeros((k, n), dtype=torch.float32, device=dev)
        rmax = torch.zeros((k, n), dtype=torch.float32, device=dev)
    for x0 in range(0, n, bx):
        idx = torch.arange(x0 - k, x0 + bx + k, device=dev) % n
        U = u[idx].to(f)
        V = v[idx].to(f)
        if c2tau2_field is not None:
            F = c2tau2_field[idx].to(f)
        if carry is not None:
            zpad = torch.zeros((k, n, n), dtype=f, device=dev)
            C = torch.cat([zpad, carry[x0:x0 + bx].to(f), zpad], 0)
        for s in range(1, k + 1):
            uc = U[1:-1]
            lap = (U[:-2] + U[2:] - 2.0 * uc) * ix
            lap = lap + (
                torch.roll(uc, 1, 1) + torch.roll(uc, -1, 1) - 2.0 * uc
            ) * iy
            lap = lap + (
                torch.roll(uc, 1, 2) + torch.roll(uc, -1, 2) - 2.0 * uc
            ) * iz
            co = (coeff if c2tau2_field is None
                  else F[s: bx + 2 * k - s])
            d = torch.where(mask, co * lap, 0.0)
            vn = V[1:-1] + d
            y = vn - C[1:-1] if carry is not None else vn
            t = uc + y
            if carry is not None:
                C = (t - uc) - y
            if with_errors:
                ctr = t[k - s: k - s + bx]
                sxc = sxct[s - 1, x0:x0 + bx].to(f)
                diff = (ctr - sxc[:, None, None] * syz.to(f)).abs()
                dmax[s - 1, x0:x0 + bx] = diff.amax(dim=(1, 2)).float()
                rmax[s - 1, x0:x0 + bx] = (
                    diff * rsyz.to(f)
                ).amax(dim=(1, 2)).float()
            U, V = t, vn
        u_out[x0:x0 + bx] = U.to(u.dtype)
        v_out[x0:x0 + bx] = V.to(v.dtype)
        if carry is not None:
            c_out[x0:x0 + bx] = C.to(carry.dtype)
    return u_out, v_out, c_out, dmax, rmax


def fused_kstep_comp(u, v, carry, syz, rsyz, sxct, *, k, coeff, inv_h2,
                     block_x: Optional[int] = None, with_errors=True,
                     c2tau2_field=None):
    """K4 (replaces stencil_pallas.fused_kstep_comp): k compensated
    velocity-form substeps of the (N,N,N) state.  `carry=None` is the
    carry-less increment form.  Returns (u', v', carry' | None, dmax, rmax)
    with the (k, N) f32 per-substep per-x-plane error rows (None, None
    without `with_errors`).  `block_x` (default `default_block_x`: the
    deepest multiple of k dividing N, up to 32 planes) is the carry slab
    depth; results equal the TPU kernel's for the same block_x.
    With `c2tau2_field` (f32 (N,N,N)), K4f: the increment is
    v' = v + mask(c2tau2*lap(u)) and `coeff` is ignored.

    On the card K4 launches K11's kernel (`_comp_chain`, the x-streaming
    pipeline of csrc/comp_sharded.cu) over the whole state: its x windows
    are the state's own wrap planes, views read in place, so every slab's
    onion is the TPU kernel's.
    """
    n = u.shape[0]
    bx = block_x or default_block_x(n, k)
    if u.device.type == "cpu":
        return fused_kstep_comp_plain(
            u, v, carry, syz, rsyz, sxct, k=k, coeff=coeff, inv_h2=inv_h2,
            block_x=bx, with_errors=with_errors, c2tau2_field=c2tau2_field,
        )
    _check_kstep(n, k, bx)
    _check_cuda(n, u=u, v=v, carry=carry, syz=syz, rsyz=rsyz, sxct=sxct)
    if u.dtype != torch.float32 or v.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise ValueError(f"K4 takes f32 u and f32/bf16 v, got "
                         f"{u.dtype}/{v.dtype}")
    if carry is not None and (carry.dtype not in (torch.float32,
                                                  torch.bfloat16)
                              or v.dtype != torch.float32):
        raise ValueError(f"K4 takes an f32/bf16 carry with an f32 v, got "
                         f"{carry.dtype} with {v.dtype}")
    _check_planes(n, k, syz, rsyz, sxct)
    if c2tau2_field is not None:
        _check_field(c2tau2_field, u)

    return _comp_chain("kstep_comp", u, v, carry, wrap_planes(u, k),
                       wrap_planes(v, k), syz, rsyz, sxct, k=k, coeff=coeff,
                       inv_h2=inv_h2, block_x=bx, c2tau2_block=c2tau2_field,
                       c2_ghosts=wrap_planes(c2tau2_field, k),
                       with_errors=with_errors, y0=0, nl_y=None)


# ---------------------------------------------------------------------------
# The sharded kernels (csrc/sharded.cu).  A shard's `ghosts` are
# ((xlo, xhi), (ylo, yhi), (zlo, zhi)) as comm/halo.collect_ghosts returns
# them; only the axes whose mesh dim is > 1 are read (elsewhere the block
# wraps onto itself, as the TPU kernel's in-block roll does).  `offsets`
# are the block's global cell offsets, `n_global` the fundamental N, and
# `r_last` (with `mesh_shape`) says which axes carry pad planes.


def _need_pads(shape, mesh_shape, r_last):
    need = tuple(m > 1 for m in mesh_shape)
    if r_last is None:
        return need, (False, False, False)
    return need, tuple(r != b for r, b in zip(r_last, shape))


def _global_mask(offsets, shape, pads, n_global, device):
    """The TPU kernel's `_global_mask`: y and z global index != 0, and
    global index < N on the axes that carry pad planes."""
    g = [o + torch.arange(b, device=device) for o, b in zip(offsets, shape)]
    mask = (g[1] != 0)[None, :, None] & (g[2] != 0)[None, None, :]
    for axis, pad in enumerate(pads):
        if pad:
            view = [1, 1, 1]
            view[axis] = -1
            mask = mask & (g[axis] < n_global).view(view)
    return mask


def _ghost_lap(c, ghosts, need, inv_h2):
    """The Laplacian of block `c` (compute dtype) with the delivered ghosts
    on the axes that need them and the block's own wrap planes elsewhere."""
    planes = []
    for axis in range(3):
        if need[axis]:
            planes.append(tuple(g.to(c.dtype) for g in ghosts[axis]))
        else:
            b = c.shape[axis]
            planes.append((c.narrow(axis, b - 1, 1), c.narrow(axis, 0, 1)))
    return laplacian_ext(ghost_extend(c, planes), inv_h2)


def _check_on_card(dev, dtype, **tensors) -> None:
    """Raise unless every given (tensor, shape) is a contiguous CUDA tensor
    of that shape and `dtype` on `dev`."""
    for name, (t, shape) in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the kernel needs "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}{tuple(shape)}, got "
                             f"{t.dtype}{tuple(t.shape)}")


def _ghost_ptrs(u, ghosts, need):
    """The six ghost pointers K6/K7 take (None on axes that need none),
    each ghost checked to be the block's face shape on u's device."""
    ptrs = []
    for axis in range(3):
        if not need[axis]:
            ptrs += [None, None]
            continue
        face = list(u.shape)
        face[axis] = 1
        lo, hi = ghosts[axis]
        _check_on_card(u.device, u.dtype, **{f"ghost {axis} lo": (lo, face),
                                             f"ghost {axis} hi": (hi, face)})
        ptrs += [lo.data_ptr(), hi.data_ptr()]
    return ptrs


def _block_geometry(u, offsets, n_global, pads):
    return (*u.shape, *(int(o) for o in offsets), int(n_global),
            *(int(p) for p in pads))


def _require_cuda(u) -> None:
    if u.device.type != "cuda":
        raise ValueError(f"u is on {u.device}, the kernel needs CUDA")


def _check_block_state(u, dtypes, kernel, **tensors) -> None:
    _require_cuda(u)
    if u.dtype not in dtypes:
        raise ValueError(f"{kernel} takes a {'/'.join(map(str, dtypes))} "
                         f"state, got {u.dtype}")
    _check_on_card(u.device, u.dtype, u=(u, u.shape),
                   **{k: (t, u.shape) for k, t in tensors.items()})


# K6: the 1-step update of a shard block.


def sharded_fused_step_plain(u_prev, u, ghosts, offsets, n_global, *,
                             inv_h2, mesh_shape, r_last=None, alpha=2.0,
                             beta=1.0, coeff=None, c2tau2_block=None):
    """Plain K6: alpha*u + coeff*lap(u) - beta*u_prev (beta term only if
    beta != 0; the block's field cell in place of coeff with
    `c2tau2_block`) in the compute dtype, the Laplacian over the ghost
    extension (`laplacian_ext`), the store masked by global index."""
    f = compute_dtype(u.dtype)
    need, pads = _need_pads(u.shape, mesh_shape, r_last)
    c = u.to(f)
    lap = _ghost_lap(c, ghosts, need, inv_h2)
    co = coeff if c2tau2_block is None else c2tau2_block.to(f)
    out = alpha * c + co * lap
    if beta:
        out = out - beta * u_prev.to(f)
    mask = _global_mask(offsets, u.shape, pads, n_global, u.device)
    return torch.where(mask, out, 0.0).to(u.dtype)


def sharded_fused_step(u_prev, u, ghosts, offsets, n_global, *, inv_h2,
                       mesh_shape, r_last=None, alpha=2.0, beta=1.0,
                       coeff=None, c2tau2_block=None):
    """K6 (replaces stencil_pallas.sharded_fused_step): one update of a
    shard block (bx, by, bz) with pre-exchanged ghosts, K1's arithmetic
    (K5's with `c2tau2_block`, the block's tau^2 c^2 in the compute dtype;
    `coeff` is then ignored).  On an uneven axis the last shard's hi ghost
    must already sit in its first pad plane (comm/halo.absorb_hi_ghosts).
    On the card: f32/f64/bf16 state; constant speed runs csrc/sharded.cu's
    x-streaming kernel (the lane mode's, one lane) where `k6_solo_streams`
    says so, else - and with a field - the one-thread-per-cell body
    `sharded_step_kernel`."""
    if u.device.type == "cpu":
        return sharded_fused_step_plain(
            u_prev, u, ghosts, offsets, n_global, inv_h2=inv_h2,
            mesh_shape=mesh_shape, r_last=r_last, alpha=alpha, beta=beta,
            coeff=coeff, c2tau2_block=c2tau2_block)
    _check_block_state(u, tuple(_CODE), "K6", u_prev=u_prev)
    need, pads = _need_pads(u.shape, mesh_shape, r_last)
    if c2tau2_block is not None:
        _check_on_card(u.device, compute_dtype(u.dtype),
                       c2tau2_block=(c2tau2_block, u.shape))
    ghost_ptrs = _ghost_ptrs(u, ghosts, need)
    geom = _block_geometry(u, offsets, n_global, pads)
    field = c2tau2_block is not None
    if not field and k6_solo_streams(u.shape):
        out = _k6_stream(u_prev, u, ghost_ptrs, geom, 1, alpha, beta,
                         coeff, inv_h2, None, "sharded_step")
        launches["sharded_step"] += 1
        return out
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        _run(_load("sharded").wt_sharded_step, u_prev.data_ptr(),
             u.data_ptr(), out.data_ptr(), _ptr(c2tau2_block), *ghost_ptrs,
             *geom, _CODE[u.dtype], float(alpha), float(beta),
             float(0.0 if field else coeff), *(float(h) for h in inv_h2),
             int(beta != 0),
             inst=("sharded_step", u.dtype, field, beta != 0))
    launches["sharded_step_field" if field else "sharded_step"] += 1
    return out


def k6_solo_streams(block) -> bool:
    """Whether the solo K6 at constant speed takes the x-streaming kernel
    (on one lane) for a shard block (bx, by, bz): where the block has at
    least _K6_SOLO_MIN planes and rows.  Thinner blocks - the overlap
    mode's one-plane face blocks (solver/sharded.py `patch`) among them -
    keep the one-thread-per-cell body, whose device time is lower there:
    a block of few rows leaves the streaming tile's rows of threads idle,
    and one of few planes gives each block too short a march to fill its
    ring (`tile_ab.py --parts k6solo` times both bodies either side of
    the limit)."""
    bx, by, _ = (int(b) for b in block)
    return bx >= _K6_SOLO_MIN and by >= _K6_SOLO_MIN


# K7: the 1-step compensated update of a shard block.


def sharded_compensated_step_plain(u, v, carry, ghosts, offsets, n_global,
                                   *, inv_h2, mesh_shape, r_last=None,
                                   coeff):
    """Plain K7: d = mask(coeff*lap(u)); v' = v + d; Kahan two-sum
    u' = u + v' through the carry; u' masked as d."""
    f = compute_dtype(u.dtype)
    need, pads = _need_pads(u.shape, mesh_shape, r_last)
    c = u.to(f)
    mask = _global_mask(offsets, u.shape, pads, n_global, u.device)
    d = torch.where(mask, coeff * _ghost_lap(c, ghosts, need, inv_h2), 0.0)
    v_next = v.to(f) + d
    y = v_next - carry.to(f)
    t = c + y
    carry_next = (t - c) - y
    return (torch.where(mask, t, 0.0).to(u.dtype), v_next.to(u.dtype),
            carry_next.to(u.dtype))


def sharded_compensated_step(u, v, carry, ghosts, offsets, n_global, *,
                             inv_h2, mesh_shape, r_last=None, coeff):
    """K7 (replaces stencil_pallas.sharded_compensated_step): K2's
    compensated update of a shard block with K6's ghosts and mask.
    Returns (u', v', carry'); on the card f32 or f64, all of one dtype."""
    if u.device.type == "cpu":
        return sharded_compensated_step_plain(
            u, v, carry, ghosts, offsets, n_global, inv_h2=inv_h2,
            mesh_shape=mesh_shape, r_last=r_last, coeff=coeff)
    _check_block_state(u, (torch.float32, torch.float64), "K7", v=v,
                       carry=carry)
    need, pads = _need_pads(u.shape, mesh_shape, r_last)
    ghost_ptrs = _ghost_ptrs(u, ghosts, need)
    outs = tuple(torch.empty_like(u) for _ in range(3))
    with torch.cuda.device(u.device):
        _run(_load("sharded").wt_sharded_comp_step, u.data_ptr(),
             v.data_ptr(), carry.data_ptr(), *(o.data_ptr() for o in outs),
             *ghost_ptrs, *_block_geometry(u, offsets, n_global, pads),
             _CODE[u.dtype], float(coeff), *(float(h) for h in inv_h2),
             inst=("sharded_comp_step", u.dtype))
    launches["sharded_comp_step"] += 1
    return outs


# K8 and K9: k fused substeps of an x-sharded block (D, N, N) whose x
# neighbours come from (k, N, N) ghost windows (lo, hi) of u_prev and u.
# K8, K9, K10 (and K3 over the whole state) launch csrc/kstep_pipe.cu's
# pipeline (`_kstep_pipe`).


def _y_mask(w, nz, nl_y, y0, device):
    """The (1, w, nz) Dirichlet mask of a block of w rows: y and z index
    != 0 over whole rows (nl_y None), or, over a y-extended block (k ghost
    rows, nl_y central rows, k ghost rows), the wrapped global row
    (y0 - k + row) mod N != 0 (the TPU xy kernels' `gy % n_global`).
    Returns (mask, the first central row, the number of central rows)."""
    ny = w if nl_y is None else nl_y
    yo = (w - ny) // 2
    gy = (y0 - yo + torch.arange(w, device=device)) % nz
    mask = (gy != 0)[:, None] & (torch.arange(nz, device=device) != 0)[None]
    return mask[None], yo, ny


def _kstep_chain_plain(u_prev, u, n_real, prev_ghosts, cur_ghosts, syz, rsyz,
                       sxct, *, k, coeff, inv_h2, c2tau2_block, c2_ghosts,
                       with_errors, y0=0, nl_y=None):
    """Plain K8/K9/K10: each field's x chain lo | block[:n_real] | hi | zero
    (the TPU pad-and-mask kernel's extended array), k substeps on an onion
    that shrinks one plane per side each, each op for op K3's; outputs and
    (k, D) error rows zero past n_real.  With `nl_y` (K10) the blocks are
    y-extended by k rows per side (`_y_mask`): rows roll over the extended
    width as the TPU kernel's do, and outputs and rows keep the central
    nl_y rows."""
    d, w, nz = u.shape
    f = compute_dtype(u.dtype)
    dev = u.device

    def chain(blk, ghosts):
        lo, hi = ghosts
        ext = torch.zeros((d + 2 * k, w, nz), dtype=f, device=dev)
        ext[:k] = lo.to(f)
        ext[k:k + n_real] = blk[:n_real].to(f)
        ext[k + n_real:2 * k + n_real] = hi.to(f)
        return ext

    prev, cur = chain(u_prev, prev_ghosts), chain(u, cur_ghosts)
    fld = None if c2tau2_block is None else chain(c2tau2_block, c2_ghosts)
    mask, yo, ny = _y_mask(w, nz, nl_y, y0, dev)
    real = torch.arange(d, device=dev) < n_real
    ix, iy, iz = inv_h2
    dmax = rmax = None
    if with_errors:
        dmax = torch.zeros((k, d), dtype=torch.float32, device=dev)
        rmax = torch.zeros((k, d), dtype=torch.float32, device=dev)
        syz_f, rsyz_f = syz.to(f), rsyz.to(f)
    for s in range(1, k + 1):
        c = cur[1:-1]
        lap = (cur[:-2] + cur[2:] - 2.0 * c) * ix
        lap = lap + (
            torch.roll(c, 1, 1) + torch.roll(c, -1, 1) - 2.0 * c) * iy
        lap = lap + (
            torch.roll(c, 1, 2) + torch.roll(c, -1, 2) - 2.0 * c) * iz
        co = coeff if fld is None else fld[s:fld.shape[0] - s]
        new = 2.0 * c + co * lap
        new = new - prev[1:-1]
        new = torch.where(mask, new, 0.0)
        if u.dtype != f:
            new = new.to(u.dtype).to(f)
        if with_errors:
            diff = (new[k - s:k - s + d, yo:yo + ny]
                    - sxct[s - 1].to(f)[:, None, None] * syz_f).abs()
            dmax[s - 1] = torch.where(real, diff.amax(dim=(1, 2)).float(),
                                      0.0)
            rmax[s - 1] = torch.where(
                real, (diff * rsyz_f).amax(dim=(1, 2)).float(), 0.0)
        prev, cur = c, new
    keep = real[:, None, None]
    return (torch.where(keep, prev[:, yo:yo + ny], 0.0).to(u.dtype),
            torch.where(keep, cur[:, yo:yo + ny], 0.0).to(u.dtype), dmax,
            rmax)


def _check_chain_operands(u_prev, u, prev_ghosts, cur_ghosts, syz, rsyz,
                          sxct, *, k, c2tau2_block, c2_ghosts, with_errors,
                          nl_y=None):
    """Raise unless a K3/K8/K9/K10 launch's operands are what the pipeline
    reads: an f32/bf16 (D, W, N) block pair on the card (W = N, or nl_y +
    2k for K10's y-extended block, whose shape `_check_xy` has checked),
    (k, W, N) windows of it, an f32 field block and windows, f32 (ny, N)
    oracle planes of the central rows and (k, D) rows."""
    d, w, n = u.shape
    if not 1 <= k <= _KSTEP_MAX_K:
        raise ValueError(f"k={k}: the k-step pipeline takes 1 <= k <= "
                         f"{_KSTEP_MAX_K}")
    if nl_y is None and w != n:
        raise ValueError(f"the block's y and z extents must be N, got "
                         f"{tuple(u.shape)}")
    _check_block_state(u, (torch.float32, torch.bfloat16), "K3/K8/K9/K10",
                       u_prev=u_prev)
    dev = u.device
    window = (k, w, n)
    _check_on_card(dev, u.dtype, prev_lo=(prev_ghosts[0], window),
                   prev_hi=(prev_ghosts[1], window),
                   cur_lo=(cur_ghosts[0], window),
                   cur_hi=(cur_ghosts[1], window))
    f32 = torch.float32
    if c2tau2_block is not None:
        _check_on_card(dev, f32, c2tau2_block=(c2tau2_block, u.shape),
                       c2_lo=(c2_ghosts[0], window),
                       c2_hi=(c2_ghosts[1], window))
    if with_errors:
        ny = w if nl_y is None else nl_y
        _check_on_card(dev, f32, syz=(syz, (ny, n)), rsyz=(rsyz, (ny, n)),
                       sxct=(sxct, (k, d)))


def _kstep_rows(k, d, dev, with_errors):
    """The zeroed (k, D) error rows a k-step kernel combines into (None,
    None without errors)."""
    if not with_errors:
        return None, None
    return tuple(torch.zeros((k, d), dtype=torch.int32, device=dev)
                 for _ in range(2))


def _kstep_pipe(counter, u_prev, u, prev_ghosts, cur_ghosts, syz, rsyz,
                sxct, *, k, coeff, inv_h2, c2tau2_block, c2_ghosts,
                with_errors, n_real=None, y0=0, nl_y=None, tile=None):
    """Launch csrc/kstep_pipe.cu's pipeline (K3, K8, K9 or K10, counted
    under `counter`, `counter`_field with a field) after checking every
    operand.  `n_real` (K9; default: every plane) masks the planes past
    it; `nl_y` (K10) marks a y-extended block whose central rows start at
    global row `y0`.  Counted once more under its face rows a thread
    (`kstep_pipe_r<R>`).  `tile` (seg, ty, tz) at r = 1, or (seg, ty, tz,
    r[, block]), replaces `kstep_pipe_block`'s (the A/B of
    kernels/tile_ab.py; the results do not depend on it)."""
    _check_chain_operands(u_prev, u, prev_ghosts, cur_ghosts, syz, rsyz,
                          sxct, k=k, c2tau2_block=c2tau2_block,
                          c2_ghosts=c2_ghosts, with_errors=with_errors,
                          nl_y=nl_y)
    d, w, n = u.shape
    ny = w if nl_y is None else nl_y
    n_real = d if n_real is None else int(n_real)
    field = c2tau2_block is not None
    seg, ty, tz, r, nt = _kstep_shape(k, d, tile, u.dtype, field,
                                      n_real < d, False, nl_y is not None)
    dev = u.device
    dmax, rmax = _kstep_rows(k, d, dev, with_errors)
    prev_out = torch.empty((d, ny, n), dtype=u.dtype, device=dev)
    out = torch.empty_like(prev_out)
    c2g = (None, None) if c2tau2_block is None else c2_ghosts
    with torch.cuda.device(dev):
        _run(_load("kstep_pipe").wt_kstep_pipe, u_prev.data_ptr(),
             prev_ghosts[0].data_ptr(), prev_ghosts[1].data_ptr(),
             u.data_ptr(), cur_ghosts[0].data_ptr(),
             cur_ghosts[1].data_ptr(), prev_out.data_ptr(), out.data_ptr(),
             _ptr(c2tau2_block), _ptr(c2g[0]), _ptr(c2g[1]),
             *((syz.data_ptr(), rsyz.data_ptr(), sxct.data_ptr())
               if with_errors else (None, None, None)),
             _ptr(dmax), _ptr(rmax), d, n, n_real, w, ny, int(y0), k, seg,
             ty, tz, r, nt, _CODE[u.dtype],
             float(coeff if c2tau2_block is None else 0.0),
             *(float(h) for h in inv_h2), 1, 0,
             inst=("kstep_pipe", k, u.dtype, field, n_real < d, r, nt))
    launches[counter if c2tau2_block is None else counter + "_field"] += 1
    launches[f"kstep_pipe_r{r}"] += 1
    if with_errors:
        # The kernel combined the rows as the bits of non-negative floats.
        dmax, rmax = dmax.view(torch.float32), rmax.view(torch.float32)
    return prev_out, out, dmax, rmax


def fused_kstep_sharded_plain(u_prev, u, prev_ghosts, cur_ghosts, syz, rsyz,
                              sxct, *, k, coeff, inv_h2, c2tau2_block=None,
                              c2_ghosts=None, with_errors=True):
    """Plain K8: `_kstep_chain_plain` with every plane of the block real."""
    return _kstep_chain_plain(
        u_prev, u, u.shape[0], prev_ghosts, cur_ghosts, syz, rsyz, sxct, k=k,
        coeff=coeff, inv_h2=inv_h2, c2tau2_block=c2tau2_block,
        c2_ghosts=c2_ghosts, with_errors=with_errors)


def fused_kstep_sharded(u_prev, u, prev_ghosts, cur_ghosts, syz, rsyz, sxct,
                        *, k, coeff, inv_h2, c2tau2_block=None,
                        c2_ghosts=None, with_errors=True):
    """K8 (replaces stencil_pallas.fused_kstep_sharded): k temporally fused
    leapfrog steps of one x-sharded (N/MX, N, N) block whose x halos come
    from the (k, N, N) ghost windows `prev_ghosts` / `cur_ghosts` = (lo, hi)
    of the cyclic x neighbours (bitwise equal to K3 on the whole domain).
    `sxct` is the shard's (k, N/MX) oracle row slice; returns (u_{n+k-1},
    u_{n+k}, dmax, rmax) with (k, N/MX) rows (None without `with_errors`).
    With `c2tau2_block` and its ghost pair `c2_ghosts` the variable-c
    substep runs and `coeff` is ignored.  k must divide the shard depth;
    on the card f32 or bf16 state, 1 <= k <= 8, launched on
    csrc/kstep_pipe.cu's pipeline (`_kstep_pipe`)."""
    if u.shape[0] % k:
        raise ValueError(f"k={k} must divide the shard depth {u.shape[0]}")
    kw = dict(k=k, coeff=coeff, inv_h2=inv_h2, c2tau2_block=c2tau2_block,
              c2_ghosts=c2_ghosts, with_errors=with_errors)
    if u.device.type == "cpu":
        return fused_kstep_sharded_plain(u_prev, u, prev_ghosts, cur_ghosts,
                                         syz, rsyz, sxct, **kw)
    return _kstep_pipe("kstep_sharded", u_prev, u, prev_ghosts, cur_ghosts,
                       syz, rsyz, sxct, **kw)


def fused_kstep_padded_plain(u_prev, u, n_real, prev_ghosts, cur_ghosts, syz,
                             rsyz, sxct, *, k, coeff, inv_h2,
                             c2tau2_block=None, c2_ghosts=None,
                             with_errors=True):
    """Plain K9: `_kstep_chain_plain` over the shard's `n_real` planes."""
    return _kstep_chain_plain(
        u_prev, u, n_real, prev_ghosts, cur_ghosts, syz, rsyz, sxct, k=k,
        coeff=coeff, inv_h2=inv_h2, c2tau2_block=c2tau2_block,
        c2_ghosts=c2_ghosts, with_errors=with_errors)


def fused_kstep_padded(u_prev, u, n_real, prev_ghosts, cur_ghosts, syz, rsyz,
                       sxct, *, k, coeff, inv_h2, c2tau2_block=None,
                       c2_ghosts=None, with_errors=True):
    """K9 (replaces stencil_pallas.fused_kstep_padded): k fused leapfrog
    steps of an uneven (pad-and-mask) x-sharded block (D, N, N) that owns
    `n_real` <= D real planes.  The ghost windows are the k real planes
    before its first plane and after its last real one; the kernel reads
    them where the TPU kernel's extended array [lo | D | junk] holds them
    (hi at n_real), so no extended copy is made.  Returns (D, N, N) blocks
    with the pad planes zero and (k, D) error rows zero at pad columns;
    `sxct` is (k, D) with zero pad columns.  k = 1 is the bootstrap and
    the remainder tail.  On the card f32 or bf16 state, 1 <= k <= 8,
    launched on csrc/kstep_pipe.cu's pipeline (`_kstep_pipe`)."""
    if not 1 <= n_real <= u.shape[0]:
        raise ValueError(f"n_real={n_real} must be in [1, {u.shape[0]}]")
    kw = dict(k=k, coeff=coeff, inv_h2=inv_h2, c2tau2_block=c2tau2_block,
              c2_ghosts=c2_ghosts, with_errors=with_errors)
    if u.device.type == "cpu":
        return fused_kstep_padded_plain(u_prev, u, n_real, prev_ghosts,
                                        cur_ghosts, syz, rsyz, sxct, **kw)
    return _kstep_pipe("kstep_padded", u_prev, u, prev_ghosts, cur_ghosts,
                       syz, rsyz, sxct, n_real=n_real, **kw)


# K10: k fused substeps of a block of an (MX, MY, 1) mesh, y-extended by k
# ghost rows per side, whose x neighbours come from (k, W, N) windows of the
# x neighbours' extended blocks (W = nl_y + 2k).


def fused_kstep_sharded_xy_plain(u_prev_ext, u_ext, prev_ghosts, cur_ghosts,
                                 syz_c, rsyz_c, sxct, y0, n_global, *, k,
                                 nl_y, coeff, inv_h2, c2tau2_ext=None,
                                 c2_ghosts=None, with_errors=True):
    """Plain K10: `_kstep_chain_plain` over the y-extended block, the mask
    on the wrapped global row, the central nl_y rows kept."""
    _check_xy(u_ext, k, nl_y, n_global)
    return _kstep_chain_plain(
        u_prev_ext, u_ext, u_ext.shape[0], prev_ghosts, cur_ghosts, syz_c,
        rsyz_c, sxct, k=k, coeff=coeff, inv_h2=inv_h2,
        c2tau2_block=c2tau2_ext, c2_ghosts=c2_ghosts,
        with_errors=with_errors, y0=int(y0), nl_y=nl_y)


def _check_xy(u_ext, k, nl_y, n_global):
    """The shape rules of the y-extended kernels (K10, K12), as wavetpu's."""
    d, w, nz = u_ext.shape
    if w != nl_y + 2 * k:
        raise ValueError(f"extended y width {w} != nl_y + 2k = "
                         f"{nl_y + 2 * k}")
    if d % k:
        raise ValueError(f"k={k} must divide the shard depth {d}")
    if nz != n_global:
        raise ValueError(f"the block's z extent {nz} must be the global N="
                         f"{n_global} (z is not sharded)")


def fused_kstep_sharded_xy(u_prev_ext, u_ext, prev_ghosts, cur_ghosts, syz_c,
                           rsyz_c, sxct, y0, n_global, *, k, nl_y, coeff,
                           inv_h2, c2tau2_ext=None, c2_ghosts=None,
                           with_errors=True):
    """K10 (replaces stencil_pallas.fused_kstep_sharded_xy): k fused
    leapfrog steps of one block of an (MX, MY, 1) mesh.  `u_prev_ext` /
    `u_ext` are the (N/MX, W, N) blocks extended in y by k ghost rows per
    side (W = nl_y + 2k); `prev_ghosts` / `cur_ghosts` are their (k, W, N)
    x windows (lo, hi), cut from the x neighbours' extended blocks (which
    carries the corner cells); `syz_c` / `rsyz_c` the central (nl_y, N)
    oracle planes, `sxct` the shard's (k, N/MX) oracle rows, `y0` the
    global y of its first central row.  Returns the central (N/MX, nl_y, N)
    layers (u_{n+k-1}, u_{n+k}) and (k, N/MX) rows over this shard's y
    range (None without `with_errors`), bitwise equal to K3 on the whole
    domain.  With `c2tau2_ext` (the field block extended alike) and its
    window pair `c2_ghosts`, the variable-c substep runs and `coeff` is
    ignored.  On the card f32 or bf16 state, 1 <= k <= 8, 0 <= y0 < N,
    launched on csrc/kstep_pipe.cu's pipeline (`_kstep_pipe`) in its
    y-extended mode."""
    if u_ext.device.type == "cpu":
        return fused_kstep_sharded_xy_plain(
            u_prev_ext, u_ext, prev_ghosts, cur_ghosts, syz_c, rsyz_c, sxct,
            y0, n_global, k=k, nl_y=nl_y, coeff=coeff, inv_h2=inv_h2,
            c2tau2_ext=c2tau2_ext, c2_ghosts=c2_ghosts,
            with_errors=with_errors)
    _check_xy(u_ext, k, nl_y, n_global)
    y0 = int(y0)
    if not 0 <= y0 < n_global:
        raise ValueError(f"y0={y0} must lie in [0, {n_global})")
    return _kstep_pipe("kstep_sharded_xy", u_prev_ext, u_ext, prev_ghosts,
                       cur_ghosts, syz_c, rsyz_c, sxct, k=k, coeff=coeff,
                       inv_h2=inv_h2, c2tau2_block=c2tau2_ext,
                       c2_ghosts=c2_ghosts, with_errors=with_errors, y0=y0,
                       nl_y=nl_y)


# K11 and K12: k fused velocity-form substeps of a shard block of the
# distributed flagship.  K11 takes an x-sharded (N/MX, N, N) block, K12 a
# y-extended block of an (MX, MY, 1) mesh; both reach their x neighbours
# through (k, ., N) windows of u and v (lo, hi).


def _comp_chain_plain(u, v, carry, u_ghosts, v_ghosts, syz, rsyz, sxct, *,
                      k, coeff, inv_h2, block_x, c2tau2_block, c2_ghosts,
                      with_errors, y0=0, nl_y=None):
    """Plain K11/K12: K4's slab loop (`fused_kstep_comp_plain`) over the x
    chain lo | block | hi of u and v (and of the field): per block_x slab
    u and v onions of bx + 2k planes cut from the chain, the carry zero
    outside the slab.  With `nl_y` (K12) the blocks are y-extended
    (`_y_mask`): the carry is the central rows, zero on the ghost rows,
    and outputs and rows keep the central nl_y rows."""
    d, w, nz = u.shape
    bx = block_x
    f = compute_dtype(u.dtype)
    dev = u.device
    ix, iy, iz = inv_h2
    mask, yo, ny = _y_mask(w, nz, nl_y, y0, dev)

    def chain(blk, ghosts):
        return torch.cat([ghosts[0].to(f), blk.to(f), ghosts[1].to(f)])

    u_all, v_all = chain(u, u_ghosts), chain(v, v_ghosts)
    f_all = None if c2tau2_block is None else chain(c2tau2_block, c2_ghosts)
    u_out = torch.empty((d, ny, nz), dtype=u.dtype, device=dev)
    v_out = torch.empty((d, ny, nz), dtype=v.dtype, device=dev)
    c_out = None if carry is None else torch.empty(
        (d, ny, nz), dtype=carry.dtype, device=dev)
    dmax = rmax = None
    if with_errors:
        dmax = torch.zeros((k, d), dtype=torch.float32, device=dev)
        rmax = torch.zeros((k, d), dtype=torch.float32, device=dev)
        syz_f, rsyz_f = syz.to(f), rsyz.to(f)
    for x0 in range(0, d, bx):
        U = u_all[x0:x0 + bx + 2 * k]
        V = v_all[x0:x0 + bx + 2 * k]
        if carry is not None:
            C = torch.zeros((bx + 2 * k, w, nz), dtype=f, device=dev)
            C[k:k + bx, yo:yo + ny] = carry[x0:x0 + bx].to(f)
        for s in range(1, k + 1):
            uc = U[1:-1]
            lap = (U[:-2] + U[2:] - 2.0 * uc) * ix
            lap = lap + (
                torch.roll(uc, 1, 1) + torch.roll(uc, -1, 1) - 2.0 * uc
            ) * iy
            lap = lap + (
                torch.roll(uc, 1, 2) + torch.roll(uc, -1, 2) - 2.0 * uc
            ) * iz
            co = (coeff if f_all is None
                  else f_all[x0 + s:x0 + bx + 2 * k - s])
            dd = torch.where(mask, co * lap, 0.0)
            vn = V[1:-1] + dd
            yy = vn - C[1:-1] if carry is not None else vn
            t = uc + yy
            if carry is not None:
                C = (t - uc) - yy
            if with_errors:
                ctr = t[k - s:k - s + bx, yo:yo + ny]
                sxc = sxct[s - 1, x0:x0 + bx].to(f)
                diff = (ctr - sxc[:, None, None] * syz_f).abs()
                dmax[s - 1, x0:x0 + bx] = diff.amax(dim=(1, 2)).float()
                rmax[s - 1, x0:x0 + bx] = (
                    diff * rsyz_f).amax(dim=(1, 2)).float()
            U, V = t, vn
        u_out[x0:x0 + bx] = U[:, yo:yo + ny].to(u.dtype)
        v_out[x0:x0 + bx] = V[:, yo:yo + ny].to(v.dtype)
        if carry is not None:
            c_out[x0:x0 + bx] = C[:, yo:yo + ny].to(carry.dtype)
    return u_out, v_out, c_out, dmax, rmax


def _comp_chain(counter, u, v, carry, u_ghosts, v_ghosts, syz, rsyz, sxct,
                *, k, coeff, inv_h2, block_x, c2tau2_block, c2_ghosts,
                with_errors, y0, nl_y, tile=None):
    """Launch csrc/comp_sharded.cu's kernel (K4 and K11 with nl_y None,
    K12 with the central row count), counted under `counter` and under
    its face rows a thread, after checking every operand.  `tile`
    (seg, ty, tz, r), or (seg, ty, tz) at r = 1, replaces
    `comp_pipe_block`'s (the A/B of kernels/tile_ab.py; the results do not
    depend on it)."""
    d, w, n = u.shape
    ny = w if nl_y is None else nl_y
    if not 1 <= k <= _KSTEP_MAX_K:
        raise ValueError(f"k={k}: K11/K12 take 1 <= k <= {_KSTEP_MAX_K}")
    if not 0 <= y0 < n:
        raise ValueError(f"y0={y0} must lie in [0, {n})")
    _check_kstep(d, k, block_x)
    _require_cuda(u)
    dev = u.device
    f32 = torch.float32
    if u.dtype != f32 or v.dtype not in (f32, torch.bfloat16):
        raise ValueError(f"K11/K12 take f32 u and f32/bf16 v, got "
                         f"{u.dtype}/{v.dtype}")
    if carry is not None and (carry.dtype not in (f32, torch.bfloat16)
                              or v.dtype != f32):
        raise ValueError(f"K11/K12 take an f32/bf16 carry with an f32 v, "
                         f"got {carry.dtype} with {v.dtype}")
    window = (k, w, n)
    _check_on_card(dev, f32, u=(u, u.shape), u_lo=(u_ghosts[0], window),
                   u_hi=(u_ghosts[1], window))
    _check_on_card(dev, v.dtype, v=(v, u.shape), v_lo=(v_ghosts[0], window),
                   v_hi=(v_ghosts[1], window))
    if carry is not None:
        _check_on_card(dev, carry.dtype, carry=(carry, (d, ny, n)))
    if c2tau2_block is not None:
        _check_on_card(dev, f32, c2tau2_block=(c2tau2_block, u.shape),
                       c2_lo=(c2_ghosts[0], window),
                       c2_hi=(c2_ghosts[1], window))
    dmax = rmax = None
    if with_errors:
        _check_on_card(dev, f32, syz=(syz, (ny, n)), rsyz=(rsyz, (ny, n)),
                       sxct=(sxct, (k, d)))
        dmax = torch.zeros((k, d), dtype=torch.int32, device=dev)
        rmax = torch.zeros((k, d), dtype=torch.int32, device=dev)
    seg, ty, tz, r, nt = _comp_shape(
        k, block_x, tile, v.dtype, None if carry is None else carry.dtype,
        c2tau2_block is not None)
    u_out = torch.empty((d, ny, n), dtype=f32, device=dev)
    v_out = torch.empty((d, ny, n), dtype=v.dtype, device=dev)
    c_out = None if carry is None else torch.empty(
        (d, ny, n), dtype=carry.dtype, device=dev)
    c2g = (None, None) if c2tau2_block is None else c2_ghosts
    with torch.cuda.device(dev):
        _run(_load("comp_sharded").wt_kstep_comp_chain, u.data_ptr(),
             u_ghosts[0].data_ptr(), u_ghosts[1].data_ptr(), v.data_ptr(),
             v_ghosts[0].data_ptr(), v_ghosts[1].data_ptr(), _ptr(carry),
             u_out.data_ptr(), v_out.data_ptr(), _ptr(c_out),
             _ptr(c2tau2_block), _ptr(c2g[0]), _ptr(c2g[1]),
             *((syz.data_ptr(), rsyz.data_ptr(), sxct.data_ptr())
               if with_errors else (None, None, None)),
             _ptr(dmax), _ptr(rmax), d, n, w, ny, y0, k, block_x, seg, ty,
             tz, r, _CODE[v.dtype],
             _NONE if carry is None else _CODE[carry.dtype],
             float(coeff if c2tau2_block is None else 0.0),
             *(float(h) for h in inv_h2), 1, 0,
             inst=("kstep_comp_pipe", k, v.dtype,
                   None if carry is None else carry.dtype,
                   c2tau2_block is not None, r, nt))
    launches[counter if c2tau2_block is None else counter + "_field"] += 1
    launches[f"kstep_comp_r{r}"] += 1
    if with_errors:
        # The kernel combined the rows as the bits of non-negative floats.
        dmax, rmax = dmax.view(torch.float32), rmax.view(torch.float32)
    return u_out, v_out, c_out, dmax, rmax


def fused_kstep_comp_sharded_plain(u, v, carry, u_ghosts, v_ghosts, syz,
                                   rsyz, sxct, *, k, coeff, inv_h2, block_x,
                                   c2tau2_block=None, c2_ghosts=None,
                                   with_errors=True):
    """Plain K11: `_comp_chain_plain` over whole y rows."""
    _check_kstep(u.shape[0], k, block_x)
    return _comp_chain_plain(
        u, v, carry, u_ghosts, v_ghosts, syz, rsyz, sxct, k=k, coeff=coeff,
        inv_h2=inv_h2, block_x=block_x, c2tau2_block=c2tau2_block,
        c2_ghosts=c2_ghosts, with_errors=with_errors)


def fused_kstep_comp_sharded(u, v, carry, u_ghosts, v_ghosts, syz, rsyz,
                             sxct, *, k, coeff, inv_h2, c2tau2_block=None,
                             c2_ghosts=None, block_x: Optional[int] = None,
                             with_errors=True):
    """K11 (replaces stencil_pallas.fused_kstep_comp_sharded): k compensated
    velocity-form steps of one x-sharded (N/MX, N, N) block, K4's update
    with the x halos of u and v from their (k, N, N) windows `u_ghosts` /
    `v_ghosts` = (lo, hi) of the cyclic x neighbours.  `carry=None` is the
    carry-less increment form; the carry is zero outside each `block_x`
    slab (default `default_block_x(N/MX, k)`, which must divide N/MX and
    equals the single-device default wherever that divides N/MX), so for
    one block_x the result equals K4's on the whole domain.  `sxct` is
    the shard's (k, N/MX) oracle row slice.  Returns (u', v', carry' |
    None, dmax, rmax) with (k, N/MX) rows (None without `with_errors`).
    With `c2tau2_block` and its window pair `c2_ghosts` (K11f) the
    increment is v' = v + mask(c2tau2*lap(u)) and `coeff` is ignored."""
    bx = block_x or default_block_x(u.shape[0], k)
    kw = dict(k=k, coeff=coeff, inv_h2=inv_h2, block_x=bx,
              c2tau2_block=c2tau2_block, c2_ghosts=c2_ghosts,
              with_errors=with_errors)
    if u.device.type == "cpu":
        return fused_kstep_comp_sharded_plain(u, v, carry, u_ghosts,
                                              v_ghosts, syz, rsyz, sxct,
                                              **kw)
    if u.shape[1] != u.shape[2]:
        raise ValueError(f"the block's y and z extents must be N, got "
                         f"{tuple(u.shape)}")
    return _comp_chain("kstep_comp_sharded", u, v, carry, u_ghosts,
                       v_ghosts, syz, rsyz, sxct, y0=0, nl_y=None, **kw)


def fused_kstep_comp_sharded_xy_plain(u_ext, v_ext, carry, u_ghosts,
                                      v_ghosts, syz_c, rsyz_c, sxct, y0,
                                      n_global, *, k, nl_y, coeff, inv_h2,
                                      block_x, c2tau2_ext=None,
                                      c2_ghosts=None, with_errors=True):
    """Plain K12: `_comp_chain_plain` over the y-extended block."""
    _check_xy(u_ext, k, nl_y, n_global)
    _check_kstep(u_ext.shape[0], k, block_x)
    return _comp_chain_plain(
        u_ext, v_ext, carry, u_ghosts, v_ghosts, syz_c, rsyz_c, sxct, k=k,
        coeff=coeff, inv_h2=inv_h2, block_x=block_x,
        c2tau2_block=c2tau2_ext, c2_ghosts=c2_ghosts,
        with_errors=with_errors, y0=int(y0), nl_y=nl_y)


def fused_kstep_comp_sharded_xy(u_ext, v_ext, carry, u_ghosts, v_ghosts,
                                syz_c, rsyz_c, sxct, y0, n_global, *, k,
                                nl_y, coeff, inv_h2, c2tau2_ext=None,
                                c2_ghosts=None, block_x: Optional[int] = None,
                                with_errors=True):
    """K12 (replaces stencil_pallas.fused_kstep_comp_sharded_xy): K11 on a
    block of an (MX, MY, 1) mesh.  `u_ext` / `v_ext` are the (N/MX, W, N)
    blocks extended in y by k ghost rows per side (W = nl_y + 2k), their
    (k, W, N) x windows cut from the x neighbours' extended blocks;
    `carry` is the central (N/MX, nl_y, N) block (or None), zero-seeded on
    the ghost rows as on the x halo planes, so K12 is not bitwise equal to
    the single-device K4.  The mask tests the wrapped global row (y0 the
    global y of the first central row).  Returns central (N/MX, nl_y, N)
    u', v', carry' and (k, N/MX) rows over this shard's y range.  With
    `c2tau2_ext` and `c2_ghosts` (K12f) the field's cells replace coeff."""
    bx = block_x or default_block_x(u_ext.shape[0], k)
    kw = dict(k=k, coeff=coeff, inv_h2=inv_h2, block_x=bx,
              with_errors=with_errors)
    if u_ext.device.type == "cpu":
        return fused_kstep_comp_sharded_xy_plain(
            u_ext, v_ext, carry, u_ghosts, v_ghosts, syz_c, rsyz_c, sxct,
            y0, n_global, nl_y=nl_y, c2tau2_ext=c2tau2_ext,
            c2_ghosts=c2_ghosts, **kw)
    _check_xy(u_ext, k, nl_y, n_global)
    return _comp_chain("kstep_comp_sharded_xy", u_ext, v_ext, carry,
                       u_ghosts, v_ghosts, syz_c, rsyz_c, sxct,
                       c2tau2_block=c2tau2_ext, c2_ghosts=c2_ghosts,
                       y0=int(y0), nl_y=nl_y, **kw)


# ---------------------------------------------------------------------------
# Lane modes: the ensemble's batch axis (wavetpu's `jax.vmap` of K1/K5, K2,
# K3/K3f and K4 in ensemble/batched.py, and of K6 inside
# ensemble/sharded.py's shard_map).  A lane mode takes B states side by
# side, (B, N, N, N) contiguous (a shard's (B, bx, by, bz) for K6), and is
# ONE launch of the solo kernel with the lane index taken from the grid
# (csrc/*.cu "Lane mode"): every lane's cells run the solo kernel's op
# sequence, so lane i equals the solo launch on lane i's state bit for bit.
# Per-lane operands ride the batch axis: K5/K3f's field (B, N, N, N), K3/K4's
# sxct and error rows (B, k, N).  The plain version is the solo plain
# version applied lane by lane.  A caller passes a batch's live prefix
# (`u[:n]`, a contiguous view) to launch over those lanes only.  The Pallas
# bodies batched (wavetpu/kernels/stencil_pallas.py): K1 `_step_kernel`
# :130, K5 `_var_step_kernel` :147, K2 `_comp_step_kernel` :544, K3/K3f
# `_kstep_kernel` :745 (`_field_onion` :721), K4 `_kstep_comp_kernel` :970,
# K6 `_sharded_kernel` :316.


def _lanes_of(name, u, z_planes) -> int:
    """The lane count of a (B, ...) batch, checked against the grid's z
    extent: B * z_planes blocks (x planes or x segments) must fit 65535."""
    b = u.shape[0]
    if u.dim() != 4 or b < 1:
        raise ValueError(f"{name} takes a (B, ...) batch, got "
                         f"{tuple(u.shape)}")
    if b * z_planes > 65535:
        raise ValueError(
            f"{name}: {b} lanes x {z_planes} x blocks exceed the grid's z "
            f"extent (65535); split the batch")
    return b


def _check_lane_batch(n, **tensors) -> None:
    """Raise unless every given tensor is a contiguous (B, n, n, n) CUDA
    tensor on one device with the first one's lane count."""
    dev = lanes = None
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device.type != "cuda" or (dev is not None and t.device != dev):
            raise ValueError(f"{name} is on {t.device}, the kernel needs "
                             f"{dev or 'CUDA'}")
        dev = t.device
        lanes = t.shape[0] if lanes is None else lanes
        if not t.is_contiguous() or tuple(t.shape) != (lanes, n, n, n):
            raise ValueError(f"{name} must be a contiguous {(lanes, n, n, n)}"
                             f" batch, got {tuple(t.shape)}")


def _lane_field(field, i):
    return None if field is None else field[i]


def fused_step_lanes_plain(u_prev, u, *, inv_h2, alpha=2.0, beta=1.0,
                           coeff=None, c2tau2_field=None):
    """Plain K1/K5 lane mode: `fused_step_plain` lane by lane."""
    return torch.stack([
        fused_step_plain(u_prev[i], u[i], inv_h2=inv_h2, alpha=alpha,
                         beta=beta, coeff=coeff,
                         c2tau2_field=_lane_field(c2tau2_field, i))
        for i in range(u.shape[0])])


def fused_step_lanes(u_prev, u, *, inv_h2, alpha=2.0, beta=1.0, coeff=None,
                     c2tau2_field=None):
    """K1 lane mode (K5's with a (B, N, N, N) field in the compute dtype,
    which then replaces alpha/beta/coeff): (B, N, N, N) -> (B, N, N, N),
    one launch of `fused_step`'s kernel over every lane."""
    if u.device.type == "cpu":
        return fused_step_lanes_plain(u_prev, u, inv_h2=inv_h2, alpha=alpha,
                                      beta=beta, coeff=coeff,
                                      c2tau2_field=c2tau2_field)
    n = u.shape[-1]
    lanes = _lanes_of("K1/K5 lanes", u, n)
    _check_lane_batch(n, u=u, u_prev=u_prev, c2tau2_field=c2tau2_field)
    if u.dtype not in _CODE or u_prev.dtype != u.dtype:
        raise ValueError(f"K1/K5 take f32/f64/bf16 state, got "
                         f"{u.dtype}/{u_prev.dtype}")
    if c2tau2_field is not None:
        if c2tau2_field.dtype != compute_dtype(u.dtype):
            raise ValueError(f"c2tau2_field must be "
                             f"{compute_dtype(u.dtype)}")
        alpha, beta, coeff = 2.0, 1.0, 0.0
    out = torch.empty_like(u)
    name = "step_lanes" if c2tau2_field is None else "var_step_lanes"
    with torch.cuda.device(u.device):
        _run(_load("stencil").wt_step, u_prev.data_ptr(), u.data_ptr(),
             out.data_ptr(), _ptr(c2tau2_field), n, _CODE[u.dtype],
             float(alpha), float(beta), float(coeff),
             *(float(h) for h in inv_h2), int(beta != 0), lanes,
             inst=(name, u.dtype, beta != 0))
    launches[name] += 1
    return out


def compensated_step_lanes_plain(u, v, carry, *, inv_h2, coeff):
    """Plain K2 lane mode: `compensated_step_plain` lane by lane."""
    return _stack_lanes([
        compensated_step_plain(u[i], v[i], carry[i], inv_h2=inv_h2,
                               coeff=coeff) for i in range(u.shape[0])])


def compensated_step_lanes(u, v, carry, problem: Problem, coeff=None):
    """K2 lane mode: (B, N, N, N) u, v and carry of one dtype -> (u', v',
    carry'), one launch of `compensated_step`'s kernel over every lane."""
    coeff = problem.a2tau2 if coeff is None else coeff
    if u.device.type == "cpu":
        return compensated_step_lanes_plain(u, v, carry,
                                            inv_h2=problem.inv_h2,
                                            coeff=coeff)
    n = u.shape[-1]
    lanes = _lanes_of("K2 lanes", u, n)
    _check_lane_batch(n, u=u, v=v, carry=carry)
    if u.dtype not in (torch.float32, torch.float64) or not (
        v.dtype == carry.dtype == u.dtype
    ):
        raise ValueError("K2 takes f32 or f64 u, v and carry of one dtype")
    outs = tuple(torch.empty_like(u) for _ in range(3))
    with torch.cuda.device(u.device):
        _run(_load("stencil").wt_comp_step, u.data_ptr(), v.data_ptr(),
             carry.data_ptr(), *(o.data_ptr() for o in outs), n,
             _CODE[u.dtype], float(coeff),
             *(float(h) for h in problem.inv_h2), lanes,
             inst=("comp_step_lanes", u.dtype))
    launches["comp_step_lanes"] += 1
    return outs


def _stack_lanes(outs):
    """Per-lane output tuples stacked output by output (an output that is
    None - rows off, no carry - stays None)."""
    return tuple(None if o[0] is None else torch.stack(o)
                 for o in zip(*outs))


def fused_kstep_lanes_plain(u_prev, u, syz, rsyz, sxct, *, k, coeff, inv_h2,
                            c2tau2_field=None, with_errors=True):
    """Plain K3/K3f lane mode: `fused_kstep_plain` lane by lane, with lane
    i's sxct row block (sxct[i], (k, N)) and field."""
    return _stack_lanes([
        fused_kstep_plain(u_prev[i], u[i], syz, rsyz,
                          None if sxct is None else sxct[i], k=k,
                          coeff=coeff, inv_h2=inv_h2,
                          c2tau2_field=_lane_field(c2tau2_field, i),
                          with_errors=with_errors)
        for i in range(u.shape[0])])


def _window_ptrs(t, k):
    """(lo, blk, hi) pointers of a (B, N, ., .) batch's x chain in lane 0:
    the last k planes, the state, the first k planes (the other lanes one
    lane stride on, in the kernel)."""
    n = t.shape[1]
    return (t[0, n - k:].data_ptr(), t.data_ptr(), t.data_ptr())


def fused_kstep_lanes(u_prev, u, syz, rsyz, sxct, *, k, coeff, inv_h2,
                      c2tau2_field=None, with_errors=True, tile=None):
    """K3 lane mode (K3f's with a (B, N, N, N) f32 field): k fused leapfrog
    substeps of every lane of a (B, N, N, N) f32/bf16 batch in one launch
    of `fused_kstep`'s pipeline, each lane's x windows its own wrap planes.
    sxct is (B, k, N) f32 (per-lane time factors); returns (u_{n+k-1},
    u_{n+k}, dmax, rmax) with (B, k, N) rows (None without errors).
    `tile` as `_kstep_pipe`'s."""
    if u.device.type == "cpu":
        return fused_kstep_lanes_plain(
            u_prev, u, syz, rsyz, sxct, k=k, coeff=coeff, inv_h2=inv_h2,
            c2tau2_field=c2tau2_field, with_errors=with_errors)
    n = u.shape[-1]
    if not 2 <= k <= _KSTEP_MAX_K or n % k:
        raise ValueError(f"k={k}: the K3 kernel takes 2 <= k <= "
                         f"{_KSTEP_MAX_K} dividing N={n}")
    seg, ty, tz, r, nt = _kstep_shape(k, n, tile, u.dtype,
                                      c2tau2_field is not None, False, True,
                                      False)
    lanes = _lanes_of("K3 lanes", u, -(-n // seg))
    _check_lane_batch(n, u=u, u_prev=u_prev, c2tau2_field=c2tau2_field)
    if u.dtype not in (torch.float32, torch.bfloat16) or \
            u_prev.dtype != u.dtype:
        raise ValueError(f"K3 takes an f32 or bf16 state, got "
                         f"{u.dtype}/{u_prev.dtype}")
    dev, f32 = u.device, torch.float32
    if c2tau2_field is not None and c2tau2_field.dtype != f32:
        raise ValueError("the K3f lane field must be f32")
    dmax = rmax = None
    if with_errors:
        _check_on_card(dev, f32, syz=(syz, (n, n)), rsyz=(rsyz, (n, n)),
                       sxct=(sxct, (lanes, k, n)))
        dmax, rmax = (torch.zeros((lanes, k, n), dtype=torch.int32,
                                  device=dev) for _ in range(2))
    prev_out, out = torch.empty_like(u), torch.empty_like(u)
    c2 = ((None, None, None) if c2tau2_field is None
          else _window_ptrs(c2tau2_field, k))
    up, uc = _window_ptrs(u_prev, k), _window_ptrs(u, k)
    name = "kstep_lanes" if c2tau2_field is None else "kstep_field_lanes"
    with torch.cuda.device(dev):
        _run(_load("kstep_pipe").wt_kstep_pipe, up[1], up[0], up[2], uc[1],
             uc[0], uc[2], prev_out.data_ptr(), out.data_ptr(), c2[1],
             c2[0], c2[2],
             *((syz.data_ptr(), rsyz.data_ptr(), sxct.data_ptr())
               if with_errors else (None, None, None)),
             _ptr(dmax), _ptr(rmax), n, n, n, n, n, 0, k, seg, ty, tz, r,
             nt, _CODE[u.dtype],
             float(coeff if c2tau2_field is None else 0.0),
             *(float(h) for h in inv_h2), lanes, n ** 3,
             inst=(name, k, u.dtype, r, nt))
    launches[name] += 1
    launches[f"kstep_pipe_r{r}"] += 1
    if with_errors:
        dmax, rmax = dmax.view(f32), rmax.view(f32)
    return prev_out, out, dmax, rmax


def fused_kstep_comp_lanes_plain(u, v, carry, syz, rsyz, sxct, *, k, coeff,
                                 inv_h2, block_x, with_errors=True):
    """Plain K4 lane mode: `fused_kstep_comp_plain` lane by lane, with lane
    i's sxct row block."""
    return _stack_lanes([
        fused_kstep_comp_plain(u[i], v[i], _lane_field(carry, i), syz, rsyz,
                               None if sxct is None else sxct[i], k=k,
                               coeff=coeff, inv_h2=inv_h2, block_x=block_x,
                               with_errors=with_errors)
        for i in range(u.shape[0])])


def fused_kstep_comp_lanes(u, v, carry, syz, rsyz, sxct, *, k, coeff, inv_h2,
                           block_x: Optional[int] = None, with_errors=True,
                           tile=None):
    """K4 lane mode: k compensated velocity-form substeps of every lane of
    a (B, N, N, N) batch in one launch of `fused_kstep_comp`'s pipeline,
    each lane's x windows its own wrap planes, slab by slab as the solo
    launch (`block_x` as `fused_kstep_comp`).  On the card it takes the
    flagship's storage, the compensated ensemble's only one: f32 u and v, a
    bf16 carry (the plain version takes every storage mode K4 takes).
    sxct is (B, k, N) f32; returns (u', v', carry', dmax, rmax) with
    (B, k, N) rows (None without errors).  `tile` as `_comp_chain`'s."""
    n = u.shape[-1]
    bx = block_x or default_block_x(n, k)
    if u.device.type == "cpu":
        return fused_kstep_comp_lanes_plain(
            u, v, carry, syz, rsyz, sxct, k=k, coeff=coeff, inv_h2=inv_h2,
            block_x=bx, with_errors=with_errors)
    _check_kstep(n, k, bx)
    if not 1 <= k <= _KSTEP_MAX_K:
        raise ValueError(f"k={k}: K4 takes 1 <= k <= {_KSTEP_MAX_K}")
    seg, ty, tz, r, nt = _comp_shape(k, bx, tile, torch.float32,
                                     torch.bfloat16, False, lanes=True)
    lanes = _lanes_of("K4 lanes", u, n // seg)
    _check_lane_batch(n, u=u, v=v, carry=carry)
    f32 = torch.float32
    if u.dtype != f32 or v.dtype != f32 or carry is None or \
            carry.dtype != torch.bfloat16:
        raise ValueError(
            f"K4's lane mode takes f32 u and v with a bf16 carry, got "
            f"{u.dtype}/{v.dtype}/{None if carry is None else carry.dtype}")
    dev = u.device
    dmax = rmax = None
    if with_errors:
        _check_on_card(dev, f32, syz=(syz, (n, n)), rsyz=(rsyz, (n, n)),
                       sxct=(sxct, (lanes, k, n)))
        dmax, rmax = (torch.zeros((lanes, k, n), dtype=torch.int32,
                                  device=dev) for _ in range(2))
    u_out, v_out, c_out = (torch.empty_like(t) for t in (u, v, carry))
    uc, vc = _window_ptrs(u, k), _window_ptrs(v, k)
    with torch.cuda.device(dev):
        _run(_load("comp_sharded").wt_kstep_comp_chain, uc[1], uc[0], uc[2],
             vc[1], vc[0], vc[2], carry.data_ptr(), u_out.data_ptr(),
             v_out.data_ptr(), c_out.data_ptr(), None, None, None,
             *((syz.data_ptr(), rsyz.data_ptr(), sxct.data_ptr())
               if with_errors else (None, None, None)),
             _ptr(dmax), _ptr(rmax), n, n, n, n, 0, k, bx, seg, ty, tz, r,
             _CODE[v.dtype], _CODE[carry.dtype], float(coeff),
             *(float(h) for h in inv_h2), lanes, n ** 3,
             inst=("kstep_comp_lanes", k, r, nt))
    launches["kstep_comp_lanes"] += 1
    launches[f"kstep_comp_r{r}"] += 1
    if with_errors:
        dmax, rmax = dmax.view(f32), rmax.view(f32)
    return u_out, v_out, c_out, dmax, rmax


def _lane_ghosts(ghosts, i):
    return tuple((lo[i], hi[i]) for lo, hi in ghosts)


def sharded_fused_step_lanes_plain(u_prev, u, ghosts, offsets, n_global, *,
                                   inv_h2, mesh_shape, r_last=None,
                                   alpha=2.0, beta=1.0, coeff=None):
    """Plain K6 lane mode: `sharded_fused_step_plain` lane by lane, lane
    i's ghosts the i-th planes of the (B, face) ghosts."""
    return torch.stack([
        sharded_fused_step_plain(u_prev[i], u[i], _lane_ghosts(ghosts, i),
                                 offsets, n_global, inv_h2=inv_h2,
                                 mesh_shape=mesh_shape, r_last=r_last,
                                 alpha=alpha, beta=beta, coeff=coeff)
        for i in range(u.shape[0])])


# K6's lane mode tiles a lane's block (bx, by, bz) into y/z tiles of
# ty x _K6L_TZ cells (one thread per column; kLaneTz and kLaneMaxTy of
# csrc/sharded.cu) and x segments; segments are cut until the launch has
# about _K6L_BLOCKS blocks (~5 waves of the H100's 132 SMs at six
# 256-thread blocks each), but none shorter than _K6L_MIN_SEG planes (each
# segment reads one extra plane per end).  ty = 8 and the kernel's
# prefetch depth of 8 planes won a sweep on the card (PERF.md §6).
_K6L_TZ = 32
_K6L_MIN_TY, _K6L_MAX_TY = 3, 8  # 3: the halo's 2 (32 + ty) cells fit
_K6L_BLOCKS = 4096
_K6L_MIN_SEG = 16
_K6_SOLO_MIN = 32  # k6_solo_streams: the solo K6's planes and rows
_GRID_X_MAX = 2 ** 31 - 1


def k6_lane_tile(block, lanes: int) -> Tuple[int, int, int]:
    """(seg, ty, tz) of K6's lane mode on `lanes` blocks of shape `block`
    (bx, by, bz): tz = 32 z columns (a warp per tile row), ty = 8 rows (4
    where by is that small), and x segments of seg planes, the fewest
    equal ones (the last may be shorter) that bring the launch to
    _K6L_BLOCKS blocks, none shorter than _K6L_MIN_SEG planes unless the
    block is.  The grid is one dimension of nzt * nyt * ceil(bx / seg) *
    lanes blocks."""
    bx, by, bz = (int(b) for b in block)
    if min(bx, by, bz) < 1 or lanes < 1:
        raise ValueError(f"K6 lanes: block {tuple(block)} x {lanes} lanes")
    ty = 4 if by <= 4 else _K6L_MAX_TY
    cols = -(-bz // _K6L_TZ) * -(-by // ty) * lanes
    nseg = min(max(1, -(-_K6L_BLOCKS // cols)),
               max(1, bx // _K6L_MIN_SEG))
    seg = -(-bx // nseg)
    return seg, ty, _K6L_TZ


def k6_lane_grid(block, lanes: int, tile) -> int:
    """The blocks of a K6 lane launch with `tile` = (seg, ty, tz)."""
    seg, ty, tz = tile
    bx, by, bz = block
    return -(-bz // tz) * -(-by // ty) * -(-bx // seg) * lanes


def _k6_lane_operands(u_prev, u, ghosts, offsets, n_global, mesh_shape,
                      r_last):
    """Check a K6 lane batch on the card; returns (lanes, ghost pointers,
    geometry ints): the six (B, face) ghost pointers (None on axes whose
    mesh dim is 1), then (bx, by, bz, ox, oy, oz, n, padx, pady, padz)."""
    if u.dim() != 4 or u.shape[0] < 1:
        raise ValueError(f"K6 lanes takes a (B, ...) batch, got "
                         f"{tuple(u.shape)}")
    lanes, block = u.shape[0], tuple(u.shape[1:])
    _check_block_state(u, tuple(_CODE), "K6 lanes", u_prev=u_prev)
    need, pads = _need_pads(block, mesh_shape, r_last)
    ptrs = []
    for axis in range(3):
        if not need[axis]:
            ptrs += [None, None]
            continue
        face = [lanes, *block]
        face[axis + 1] = 1
        lo, hi = ghosts[axis]
        _check_on_card(u.device, u.dtype, **{f"ghost {axis} lo": (lo, face),
                                             f"ghost {axis} hi": (hi, face)})
        ptrs += [lo.data_ptr(), hi.data_ptr()]
    geom = (*block, *(int(o) for o in offsets), int(n_global),
            *(int(p) for p in pads))
    return lanes, ptrs, geom


def sharded_fused_step_lanes(u_prev, u, ghosts, offsets, n_global, *,
                             inv_h2, mesh_shape, r_last=None, alpha=2.0,
                             beta=1.0, coeff=None, tile=None):
    """K6 lane mode: one update of B shard blocks (B, bx, by, bz) in one
    launch of csrc/sharded.cu's x-streaming `sharded_lanes_kernel`, each
    lane with its ghosts - the (B, face) planes comm/halo.collect_ghosts
    delivers for a batch (one copy per face for every lane) - and each
    lane bit for bit the solo `sharded_fused_step`.  Constant speed: the
    sharded ensemble takes no field.  `tile` (seg, ty, tz) overrides
    `k6_lane_tile` (kernels/tile_ab.py's A/B)."""
    if u.device.type == "cpu":
        return sharded_fused_step_lanes_plain(
            u_prev, u, ghosts, offsets, n_global, inv_h2=inv_h2,
            mesh_shape=mesh_shape, r_last=r_last, alpha=alpha, beta=beta,
            coeff=coeff)
    lanes, ptrs, geom = _k6_lane_operands(u_prev, u, ghosts, offsets,
                                          n_global, mesh_shape, r_last)
    out = _k6_stream(u_prev, u, ptrs, geom, lanes, alpha, beta, coeff,
                     inv_h2, tile, "sharded_step_lanes")
    launches["sharded_step_lanes"] += 1
    return out


@functools.lru_cache(maxsize=256)
def _k6_launch_tile(block, lanes, tile):
    """`tile` (or `k6_lane_tile`'s for None) checked against what the
    kernel takes; cached per shape, as a march launches one shape per
    shard over and over."""
    seg, ty, tz = tile or k6_lane_tile(block, lanes)
    if tz != _K6L_TZ or not _K6L_MIN_TY <= ty <= _K6L_MAX_TY or seg < 1:
        raise ValueError(f"K6 lanes: tile {(seg, ty, tz)} (tz must be "
                         f"{_K6L_TZ}, {_K6L_MIN_TY} <= ty <= {_K6L_MAX_TY})")
    if k6_lane_grid(block, lanes, (seg, ty, tz)) > _GRID_X_MAX:
        raise ValueError(f"K6 lanes: {lanes} lanes of {block} exceed the "
                         f"grid's {_GRID_X_MAX} blocks; split the batch")
    return seg, ty


def _k6_stream(u_prev, u, ptrs, geom, lanes, alpha, beta, coeff, inv_h2,
               tile, counter):
    """Launch csrc/sharded.cu's x-streaming K6 kernel on `lanes` blocks
    (checked operands: ghost pointers and geometry ints as
    `_k6_lane_operands` returns them) at `tile` or `k6_lane_tile`'s."""
    seg, ty = _k6_launch_tile(geom[:3], lanes,
                              None if tile is None else tuple(tile))
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        _run(_load("sharded").wt_sharded_lanes, u_prev.data_ptr(),
             u.data_ptr(), out.data_ptr(), *ptrs, *geom, _CODE[u.dtype],
             float(alpha), float(beta), float(coeff),
             *(float(h) for h in inv_h2), int(beta != 0), lanes, seg, ty,
             inst=(counter, u.dtype))
    return out
