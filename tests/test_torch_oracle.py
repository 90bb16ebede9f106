"""The port's oracle (wavetpu_torch.verify.oracle) against wavetpu's on the
same problems and the same states: the host-f64 factors cast once must be
bit-equal, and the per-layer errors agree to the dtype's rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.verify import oracle as jor
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.verify import oracle

CASES = [
    dict(N=16, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=10),
    dict(N=15, Lx=np.pi, Ly=2.0, Lz=0.5, T=0.3, timesteps=7),
]
DT = [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]


def both(case):
    return Problem(**case), JProblem(**case)


@pytest.mark.parametrize("case", CASES)
def test_problem_copy_matches(case):
    p, jp = both(case)
    for name in ("a2", "a_t", "tau", "courant", "inv_h2", "a2tau2",
                 "cells_per_step"):
        assert getattr(p, name) == getattr(jp, name)
    assert Problem.from_argv(["8", "1", "pi", "1", "1"]).Lx == np.pi


@pytest.mark.parametrize("dt,jdt", DT)
@pytest.mark.parametrize("case", CASES)
def test_spatial_and_time_factors(case, dt, jdt):
    p, jp = both(case)
    for a, b in zip(oracle.spatial_factors(p, dt),
                    jor.spatial_factors(jp, jdt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        oracle.time_factor_table(p, dt).numpy(),
        np.asarray(jor.time_factor_table(jp, jdt)),
    )
    assert oracle.time_factor(p, 3, dt).item() == float(
        jor.time_factor(jp, 3, jdt))


def test_interior_masks():
    np.testing.assert_array_equal(oracle.interior_masks_1d(8, 0),
                                  jor.interior_masks_1d(8, 0))
    np.testing.assert_array_equal(oracle.interior_masks_1d(8, 4),
                                  jor.interior_masks_1d(8, 4))


@pytest.mark.parametrize("dt,jdt", DT)
@pytest.mark.parametrize("case", CASES)
def test_analytic_field(case, dt, jdt):
    p, jp = both(case)
    sx, sy, sz = oracle.spatial_factors(p, dt)
    jsx, jsy, jsz = jor.spatial_factors(jp, jdt)
    ours = oracle.analytic_field(sx, sy, sz, oracle.time_factor(p, 4, dt))
    ref = jor.analytic_field(jsx, jsy, jsz, jor.time_factor(jp, 4, jdt))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dt,jdt", DT)
@pytest.mark.parametrize("case", CASES)
def test_layer_errors(case, dt, jdt):
    p, jp = both(case)
    n = p.N
    sx, sy, sz = oracle.spatial_factors(p, dt)
    f = oracle.analytic_field(sx, sy, sz, oracle.time_factor(p, 2, dt))
    noise = np.random.default_rng(0).standard_normal((n, n, n)) * 1e-3
    u = (f.to(torch.float64).numpy() + noise).astype(
        np.float32 if dt == torch.float32 else np.float64)
    m = oracle.interior_masks_1d(n)
    ours = oracle.layer_errors(torch.from_numpy(u), f, torch.from_numpy(m),
                               torch.from_numpy(m), torch.from_numpy(m))
    jm = jnp.asarray(jor.interior_masks_1d(n))
    ref = jor.layer_errors(jnp.asarray(u), jnp.asarray(f.numpy()), jm, jm, jm)
    rtol = 1e-6 if dt == torch.float32 else 1e-13
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.item(), float(b), rtol=rtol)


def test_layer_errors_zero_over_zero_and_nan():
    # 0/0 contributes 0 to rel (the reference's NaN-skip); a NaN state
    # still surfaces in abs.
    n = 6
    f = torch.zeros((n, n, n), dtype=torch.float64)
    m = torch.from_numpy(oracle.interior_masks_1d(n))
    a, r = oracle.layer_errors(f.clone(), f, m, m, m)
    assert a.item() == 0.0 and r.item() == 0.0
    u = f.clone()
    u[2, 2, 2] = float("nan")
    a, _ = oracle.layer_errors(u, f, m, m, m)
    assert np.isnan(a.item())
