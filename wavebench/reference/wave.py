"""The plain reference of the wave cells: plain PyTorch, no kernels.

The problem is the reference solver's (aleksgri/3D-wave-equation-MPI-CUDA):
u_tt = a^2 lap(u) on [0,Lx] x [0,Ly] x [0,Lz], a^2 = 1/(4 pi^2), periodic in
x, zero on the y and z faces, with the closed-form solution

    u(t, x, y, z) = sin(2 pi x/Lx) sin(pi y/Ly) sin(pi z/Lz) cos(a_t t + phase)
    a_t = 0.5 sqrt(4/Lx^2 + 1/Ly^2 + 1/Lz^2)

on N points per axis: x = i Lx/N (the periodic domain), y = j Ly/N and
z = k Lz/N for j, k in 0..N-1 (the faces y = Ly, z = Lz are zero and not
held; y = 0 and z = 0 are held and stay zero).  Everything here is worked
out from the configuration and the phase alone: nothing of the program
under test is imported or read.

Layer 0 is the closed form at t = 0.  Layer 1 is the closed form at t = tau
when the phase is not the reference's 2 pi (the initial velocity is then not
zero), else the Taylor half-step u0 + (C/2) lap(u0) with C = a^2 tau^2.
Then 7-point leapfrog steps, in one of two forms:

  * "standard": u_{n+1} = 2 u_n - u_{n-1} + C lap(u_n);
  * "compensated": the increment form v_{n+1} = v_n + C lap(u_n),
    u_{n+1} = u_n + v_{n+1}, the add carried through a Kahan two-sum
    wherever the state is held below float64.

The state is held in `dtype` (float64 for the reference itself) and
computed in float32 or float64; a control below the stated precision holds
it in bfloat16 and computes in float32, rounding after every step.

Per-layer errors are the reference solver's L-inf absolute error |u - f|
over the interior points (indices 1..N-1 on every axis).  Its relative
error is not worked out: it swings with the layer nearest a zero of the
time factor, and a lower precision reads no higher than the program does
(PERF.md, section 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class Wave:
    """One problem: the reference CLI's `N Np Lx Ly Lz T timesteps`."""

    N: int
    Lx: float
    Ly: float
    Lz: float
    T: float
    timesteps: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Wave":
        return cls(N=int(cfg["N"]), Lx=float(cfg["Lx"]), Ly=float(cfg["Ly"]),
                   Lz=float(cfg["Lz"]), T=float(cfg["T"]),
                   timesteps=int(cfg["timesteps"]))

    @property
    def tau(self) -> float:
        return self.T / self.timesteps

    @property
    def coeff(self) -> float:
        """C = a^2 tau^2."""
        return self.tau * self.tau / (4.0 * math.pi * math.pi)

    @property
    def a_t(self) -> float:
        return 0.5 * math.sqrt(4.0 / self.Lx ** 2 + 1.0 / self.Ly ** 2
                               + 1.0 / self.Lz ** 2)

    @property
    def inv_h2(self):
        n = self.N
        return ((n / self.Lx) ** 2, (n / self.Ly) ** 2, (n / self.Lz) ** 2)

    @property
    def cells_per_step(self) -> int:
        """The reference's (N+1)^3 grid points."""
        return (self.N + 1) ** 3

    def time_factor(self, n: int, phase: float) -> float:
        return math.cos(self.a_t * self.tau * n + phase)


def _factors(w: Wave):
    """The closed form's three 1-D factors on the held points, float64."""
    i = np.arange(w.N, dtype=np.float64)
    sx = np.sin(2.0 * math.pi * i / w.N)
    sy = np.sin(math.pi * i / w.N)
    sz = np.sin(math.pi * i / w.N)
    return sx, sy, sz


def spatial(w: Wave, device) -> torch.Tensor:
    """Sx(x) Sy(y) Sz(z) on the (N, N, N) held grid, float64."""
    sx, sy, sz = (torch.tensor(a, dtype=torch.float64, device=device)
                  for a in _factors(w))
    return sx[:, None, None] * sy[None, :, None] * sz[None, None, :]


def _zero_faces(u: torch.Tensor) -> torch.Tensor:
    u[:, 0, :] = 0.0
    u[:, :, 0] = 0.0
    return u


def laplacian(u: torch.Tensor, inv_h2, out: torch.Tensor) -> torch.Tensor:
    """7-point Laplacian of `u` into `out`: cyclic neighbours in x; in y and
    z the neighbour past index N-1 is the zero face.  The y = 0 and z = 0
    planes of `out` are left for the caller to zero."""
    ix, iy, iz = inv_h2
    torch.mul(u, -2.0 * (ix + iy + iz), out=out)
    out[1:].add_(u[:-1], alpha=ix)
    out[:1].add_(u[-1:], alpha=ix)
    out[:-1].add_(u[1:], alpha=ix)
    out[-1:].add_(u[:1], alpha=ix)
    out[:, 1:].add_(u[:, :-1], alpha=iy)
    out[:, :-1].add_(u[:, 1:], alpha=iy)
    out[:, :, 1:].add_(u[:, :, :-1], alpha=iz)
    out[:, :, :-1].add_(u[:, :, 1:], alpha=iz)
    return out


class Oracle:
    """Per-layer L-inf absolute errors against the closed form, on the
    device, with no host round trip until `vector`."""

    def __init__(self, w: Wave, phase: float, device):
        self.w, self.phase = w, phase
        self.s = spatial(w, device)[1:, 1:, 1:].contiguous()
        self.buf = torch.empty_like(self.s)
        self.abs: list = []

    def layer(self, u: torch.Tensor, n: int) -> None:
        d = self.buf
        torch.sub(u[1:, 1:, 1:].to(torch.float64), self.s,
                  alpha=self.w.time_factor(n, self.phase), out=d)
        self.abs.append(d.abs_().amax())

    def vector(self) -> np.ndarray:
        """float64 errors over layers 0..n; layer 0 is the closed form
        itself, its error 0."""
        return np.concatenate([np.zeros(1),
                               torch.stack(self.abs).cpu().numpy()])


def march(w: Wave, phase: float, scheme: str, device,
          dtype=torch.float64, stop: Optional[int] = None,
          errors: bool = True) -> Dict[str, object]:
    """March layers 0..stop (default: timesteps) of the problem at `phase`.

    Returns {"u": layer stop, "u_prev": layer stop-1, "abs": per-layer
    absolute errors} (the fields float64 on `device`, the errors a float64
    numpy vector over layers 0..stop, or None with errors=False).  `dtype`
    is the held precision: float64 or float32 compute as held; bfloat16
    computes in float32 and rounds the state to bfloat16 after every step.
    """
    if scheme not in ("standard", "compensated"):
        raise ValueError(f"unknown scheme {scheme!r}")
    stop = w.timesteps if stop is None else stop
    comp = torch.float64 if dtype == torch.float64 else torch.float32

    def held(t):
        return t if dtype == comp else t.to(dtype).to(comp)

    s = spatial(w, device)
    u0 = held((s * w.time_factor(0, phase)).to(comp))
    lap = torch.empty_like(u0)
    if phase != TWO_PI:
        u1 = held((s * w.time_factor(1, phase)).to(comp))
        v = held((s * (w.time_factor(1, phase)
                       - w.time_factor(0, phase))).to(comp))
    else:
        laplacian(u0, w.inv_h2, lap)
        v = held(_zero_faces(lap.mul_(0.5 * w.coeff)).clone())
        u1 = held(u0 + v)
    del s
    oracle = Oracle(w, phase, device) if errors else None
    if oracle is not None:
        oracle.layer(u1, 1)
    u_prev, u = u0, u1
    carry = torch.zeros_like(u) if (scheme == "compensated"
                                    and comp != torch.float64) else None
    for n in range(2, stop + 1):
        laplacian(u, w.inv_h2, lap)
        _zero_faces(lap)
        if scheme == "standard":
            # u_prev's buffer becomes layer n.
            u_prev.mul_(-1.0).add_(u, alpha=2.0).add_(lap, alpha=w.coeff)
            _zero_faces(u_prev)
            u_prev, u = u, held(u_prev)
        else:
            v.add_(lap, alpha=w.coeff)
            v = held(v)
            if carry is None:
                u.add_(v)
            else:
                y = v - carry
                t = u + y
                carry = held((t - u) - y)
                u = held(t)
        if oracle is not None:
            oracle.layer(u, n)
    u = u.to(torch.float64)
    if scheme == "compensated":
        u_prev = u - v.to(torch.float64)
    return {"u": u, "u_prev": u_prev.to(torch.float64),
            "abs": None if oracle is None else oracle.vector()}
