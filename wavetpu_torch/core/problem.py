"""Problem specification for the 3D acoustic wave equation.

The PDE solved is  u_tt = a^2 * laplace(u)  on [0,Lx] x [0,Ly] x [0,Lz] x [0,T]
with a^2 = 1/(4*pi^2), periodic boundary in x and homogeneous Dirichlet in y/z,
validated against the closed-form analytic solution

    u(t,x,y,z) = sin(2*pi*x/Lx) * sin(pi*y/Ly) * sin(pi*z/Lz) * cos(a_t*t + 2*pi)
    a_t = 0.5 * sqrt(4/Lx^2 + 1/Ly^2 + 1/Lz^2)

This mirrors the reference solver's constants and derived quantities
(reference: openmp_sol.cpp:192-214, mpi_new.cpp:376-404) but is organised as a
single immutable spec shared by every backend instead of file-scope globals.

The port's own copy of wavetpu/core/problem.py (it imports nothing of
wavetpu); the two must stay field-for-field identical.

Grid representation:

The reference stores an (N+1)^3 grid in which the periodic x seam node is
duplicated (global x index 0 and N hold the same value; openmp_sol.cpp:114-120)
and the Dirichlet planes y,z in {0,N} are explicitly zeroed every step
(openmp_sol.cpp:104-112).  Here the state is an (N, N, N) cube:

 * x: the fundamental periodic domain, indices 0..N-1.  The reference's
   special seam update (its `prepare_layer`) is mathematically the ordinary
   leapfrog update with a cyclic neighbour, so no seam code exists at all.
 * y, z: indices 0..N-1.  The y=N and z=N Dirichlet planes are identically
   zero and therefore not stored; the y=0 / z=0 planes are stored and forced
   to zero ("Dirichlet invariant").  Because of that invariant, a *cyclic*
   shift in y/z yields the correct zero neighbour at j=N-1 (it wraps to the
   zero plane j=0), which makes all three axes pure rolls - the property the
   torch.roll reference stencil and the CUDA kernels' wrapped indexing
   build on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

# Deliberate deviation from the reference: its CPU variants hardcode the
# 10-digit truncation PI = 3.1415926535 (openmp_sol.cpp:20) while its CUDA
# variant uses full precision (cuda_sol_kernels.cu:3).  We use math.pi
# everywhere - self-consistent and at least as accurate - so error parity
# with reference *output files* can diverge around the 10th digit.
PI = math.pi


def parse_length(token: str | float) -> float:
    """Parse a CLI length argument; the literal string "pi" means math.pi.

    Mirrors the reference CLI contract (openmp_sol.cpp:195-200).
    """
    if isinstance(token, str):
        if token.strip().lower() == "pi":
            return PI
        return float(token)
    return float(token)


@dataclasses.dataclass(frozen=True)
class Problem:
    """Immutable problem spec; all derived constants are properties.

    Fields mirror the reference positional CLI `N Np Lx Ly Lz T timesteps`
    (openmp_sol.cpp:192-204).  `Np` is kept for CLI compatibility; like the
    reference MPI/CUDA variants it does not influence the computation
    (mpi_sol.cpp:381 parses it and never uses it).
    """

    N: int = 32
    Np: int = 1
    Lx: float = 1.0
    Ly: float = 1.0
    Lz: float = 1.0
    T: float = 1.0
    timesteps: int = 20

    def __post_init__(self):
        if self.N < 4:
            raise ValueError(f"N must be >= 4, got {self.N}")
        if self.timesteps < 1:
            raise ValueError(f"timesteps must be >= 1, got {self.timesteps}")

    # ---- derived constants (reference: openmp_sol.cpp:207-214) ----
    @property
    def a2(self) -> float:
        return 1.0 / (4.0 * PI * PI)

    @property
    def a(self) -> float:
        return math.sqrt(self.a2)

    @property
    def a_t(self) -> float:
        return 0.5 * math.sqrt(
            4.0 / (self.Lx * self.Lx)
            + 1.0 / (self.Ly * self.Ly)
            + 1.0 / (self.Lz * self.Lz)
        )

    @property
    def tau(self) -> float:
        return self.T / self.timesteps

    @property
    def hx(self) -> float:
        return self.Lx / self.N

    @property
    def hy(self) -> float:
        return self.Ly / self.N

    @property
    def hz(self) -> float:
        return self.Lz / self.N

    @property
    def courant(self) -> float:
        """Stability number C = a*tau/min(h); printed before every run
        (openmp_sol.cpp:214)."""
        return self.a * self.tau / min(self.hx, self.hy, self.hz)

    @property
    def inv_h2(self) -> Tuple[float, float, float]:
        return (1.0 / self.hx**2, 1.0 / self.hy**2, 1.0 / self.hz**2)

    @property
    def a2tau2(self) -> float:
        return self.a2 * self.tau * self.tau

    @property
    def cells_per_step(self) -> int:
        """Cell updates per time step for throughput accounting.

        Uses the reference's (N+1)^3 grid-point count (BASELINE.md throughput
        definition) even though the stored state is N^3.
        """
        return (self.N + 1) ** 3

    @classmethod
    def from_argv(cls, argv: Sequence[str]) -> "Problem":
        """Build from reference-style positional args: N Np Lx Ly Lz T timesteps.

        T and timesteps are optional with defaults 1 and 20
        (openmp_sol.cpp:201-204).
        """
        if len(argv) < 5:
            raise ValueError(
                "usage: N Np Lx Ly Lz [T] [timesteps]  (Lx/Ly/Lz accept 'pi')"
            )
        return cls(
            N=int(argv[0]),
            Np=int(argv[1]),
            Lx=parse_length(argv[2]),
            Ly=parse_length(argv[3]),
            Lz=parse_length(argv[4]),
            T=float(argv[5]) if len(argv) >= 6 else 1.0,
            timesteps=int(argv[6]) if len(argv) >= 7 else 20,
        )
