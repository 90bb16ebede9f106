"""Wrappers of the CUDA stencil kernels (csrc/stencil.cu), each with its
plain PyTorch version and a launch counter - the port of
wavetpu/kernels/stencil_pallas.py's single-device kernels.

| kernel | replaces (wavetpu/kernels/stencil_pallas.py)      | wrapper            |
|--------|---------------------------------------------------|--------------------|
| K1     | `_step_kernel` via `_fused_step` :180 (call :209) | `fused_step`       |
| K2     | `_comp_step_kernel` via `compensated_step` :575   | `compensated_step` |
| K4     | `_kstep_comp_kernel` via `fused_kstep_comp` :1071 | `fused_kstep_comp` |

Dispatch is by the tensor's device and nothing else: a CPU tensor goes to
the plain version (that is how the CPU tests and `--platform cpu` run); a
CUDA tensor launches the kernel or raises - there is no fallback.  Each
wrapper adds one to `launches[<kernel>]` right after its kernel launched,
and nowhere else, so a run can show that it went through the kernels.

The plain versions repeat the kernels' arithmetic in the same order (the
Pallas kernels' order, which for K1 is `alpha*u + coeff*lap - beta*u_prev`,
not stencil_ref's `2u - u_prev + c*lap`); they are references, not
yardsticks of speed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import build
from wavetpu_torch.kernels.stencil_ref import compute_dtype, laplacian

launches: Dict[str, int] = {"step": 0, "comp_step": 0, "kstep_comp": 0}

# dtype codes of csrc/stencil.cu.
_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_NONE = -1

# K4's tile limits (kMaxTx and kConeThreads in csrc/stencil.cu): at most 8
# output planes in x, and one thread per (y, z) column of the cone, 640 at
# most (the column's u, v and carry live in registers).
_KSTEP_MAX_TX = 8
_K4_MAX_THREADS = 640
_K4_MAX_K = 8


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("stencil")
    if not getattr(lib, "_wt_typed", False):
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.wt_error_string.argtypes = [i]
        lib.wt_error_string.restype = ctypes.c_char_p
        lib.wt_step.argtypes = [p, p, p, i, i, d, d, d, d, d, d, i, p]
        lib.wt_step.restype = i
        lib.wt_comp_step.argtypes = [p, p, p, p, p, p, i, i, d, d, d, d, p]
        lib.wt_comp_step.restype = i
        lib.wt_kstep_comp.argtypes = (
            [p] * 11 + [i] * 8 + [d] * 4 + [p]
        )
        lib.wt_kstep_comp.restype = i
        lib._wt_typed = True
    return lib


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


def _run(fn, *args) -> None:
    """Call a C entry point on the current stream; raise on a CUDA error
    (a refused launch never runs, and synchronize would not report it)."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = _lib().wt_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")


# ---------------------------------------------------------------------------
# K1: the 1-step stencil.


def fused_step_plain(u_prev, u, *, inv_h2, alpha=2.0, beta=1.0, coeff):
    """Plain K1: out = alpha*u + coeff*lap(u) - beta*u_prev (beta term only
    if beta != 0) in the compute dtype, y=0 / z=0 planes masked."""
    f = compute_dtype(u.dtype)
    c = u.to(f)
    out = alpha * c + coeff * laplacian(c, inv_h2)
    if beta:
        out = out - beta * u_prev.to(f)
    out[:, 0, :] = 0.0
    out[:, :, 0] = 0.0
    return out.to(u.dtype)


def fused_step(u_prev, u, *, inv_h2, alpha=2.0, beta=1.0, coeff):
    """K1 (replaces stencil_pallas._fused_step's constant-speed kernel)."""
    if u.device.type == "cpu":
        return fused_step_plain(u_prev, u, inv_h2=inv_h2, alpha=alpha,
                                beta=beta, coeff=coeff)
    n = u.shape[0]
    _check_cuda(n, u=u, u_prev=u_prev)
    if u.dtype not in _CODE or u_prev.dtype != u.dtype:
        raise ValueError(f"K1 takes f32/f64/bf16 state, got "
                         f"{u.dtype}/{u_prev.dtype}")
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        _run(_lib().wt_step, u_prev.data_ptr(), u.data_ptr(),
             out.data_ptr(), n, _CODE[u.dtype], float(alpha), float(beta),
             float(coeff), *(float(h) for h in inv_h2), int(beta != 0))
    launches["step"] += 1
    return out


def leapfrog_step(u_prev, u, problem: Problem):
    """u_next = 2u + a2tau2*lap(u) - u_prev, Dirichlet re-imposed."""
    return fused_step(u_prev, u, inv_h2=problem.inv_h2, alpha=2.0, beta=1.0,
                      coeff=problem.a2tau2)


def taylor_half_step(u0, problem: Problem):
    """u1 = u0 + (a2tau2/2)*lap(u0), Dirichlet re-imposed."""
    return fused_step(u0, u0, inv_h2=problem.inv_h2, alpha=1.0, beta=0.0,
                      coeff=0.5 * problem.a2tau2)


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
        _run(_lib().wt_comp_step, u.data_ptr(), v.data_ptr(),
             carry.data_ptr(), *(o.data_ptr() for o in outs), n,
             _CODE[u.dtype], float(coeff),
             *(float(h) for h in problem.inv_h2))
    launches["comp_step"] += 1
    return outs


# ---------------------------------------------------------------------------
# K4: k fused velocity-form substeps.


def default_block_x(n: int, k: int) -> int:
    """The x slab whose carry halo starts at zero (the TPU kernel's block_x
    semantics): the smallest multiple of k that is >= 8 and divides n, else
    k.  Deeper slabs zero-seed fewer carry planes."""
    bx = k
    while bx < 8:
        bx += k
    while bx <= n:
        if n % bx == 0:
            return bx
        bx += k
    return k


def kstep_tile(k: int, bx: int) -> Tuple[int, int, int]:
    """(tx, ty, tz) output tile of the K4 kernel.  tx is the largest divisor
    of bx up to 8 (a tile lies in one carry slab); tz is 32 (a warp-wide z
    row) or 16 where a 32-wide cone leaves no room; ty is the most rows
    whose cone, (ty+2k)(tz+2k) columns, fits 640 threads."""
    if not 1 <= k <= _K4_MAX_K:
        raise ValueError(f"k={k}: the K4 kernel takes 1 <= k <= {_K4_MAX_K}")
    tx = max(d for d in range(1, _KSTEP_MAX_TX + 1) if bx % d == 0)
    for tz in (32, 16):
        ty = _K4_MAX_THREADS // (tz + 2 * k) - 2 * k
        if ty >= 2:
            return tx, ty, tz
    raise ValueError(f"k={k} does not fit the K4 kernel's tile")


def _check_kstep(n, k, bx):
    if n % k:
        raise ValueError(f"k={k} must divide N={n}")
    if n % bx or bx % k:
        raise ValueError(f"block_x={bx} must divide N={n} and be a multiple "
                         f"of k={k}")


def fused_kstep_comp_plain(u, v, carry, syz, rsyz, sxct, *, k, coeff,
                           inv_h2, block_x, with_errors=True):
    """Plain K4, slab by slab exactly as the TPU kernel: u and v onions of
    block_x + 2k planes with wrapped x halos, the carry zero on the halo
    planes, k substeps shrinking the onion by one plane per side.  Returns
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
            d = torch.where(mask, coeff * lap, 0.0)
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
                     block_x: Optional[int] = None, with_errors=True):
    """K4 (replaces stencil_pallas.fused_kstep_comp): k compensated
    velocity-form substeps of the (N,N,N) state.  `carry=None` is the
    carry-less increment form.  Returns (u', v', carry' | None, dmax, rmax)
    with the (k, N) f32 per-substep per-x-plane error rows (None, None
    without `with_errors`).  `block_x` (default `default_block_x`) is the
    carry slab depth; results equal the TPU kernel's for the same block_x.
    """
    n = u.shape[0]
    bx = block_x or default_block_x(n, k)
    if u.device.type == "cpu":
        return fused_kstep_comp_plain(
            u, v, carry, syz, rsyz, sxct, k=k, coeff=coeff, inv_h2=inv_h2,
            block_x=bx, with_errors=with_errors,
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
    for name, t, shape in (("syz", syz, (n, n)), ("rsyz", rsyz, (n, n)),
                           ("sxct", sxct, (k, n))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be f32 {shape}")
    tx, ty, tz = kstep_tile(k, bx)
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    c_out = None if carry is None else torch.empty_like(carry)
    dmax = rmax = None
    if with_errors:
        dmax = torch.zeros((k, n), dtype=torch.int32, device=u.device)
        rmax = torch.zeros((k, n), dtype=torch.int32, device=u.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(u.device):
        _run(_lib().wt_kstep_comp, u.data_ptr(), v.data_ptr(), ptr(carry),
             u_out.data_ptr(), v_out.data_ptr(), ptr(c_out), syz.data_ptr(),
             rsyz.data_ptr(), sxct.data_ptr(), ptr(dmax), ptr(rmax), n, k,
             bx, tx, ty, tz, _CODE[v.dtype],
             _NONE if carry is None else _CODE[carry.dtype], float(coeff),
             *(float(h) for h in inv_h2))
    launches["kstep_comp"] += 1
    if with_errors:
        # The kernel combined the rows as the bits of non-negative floats.
        dmax, rmax = dmax.view(torch.float32), rmax.view(torch.float32)
    return u_out, v_out, c_out, dmax, rmax
