"""The port's oracle (wavetpu_torch.verify.oracle) against wavetpu's on the
same problems and the same states: the host-f64 factors cast once must be
bit-equal, and the per-layer errors agree to the dtype's rounding.  Then
the 1-step error pass (`stencil_cuda.layer_errors`) on the CPU, where its
plain version runs: bit for bit the composition it replaced."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.verify import oracle as jor
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import build, stencil_cuda, stencil_ref
from wavetpu_torch.solver import leapfrog
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


# ---------------------------------------------------------------------------
# The 1-step error pass (stencil_cuda.layer_errors): on the CPU its plain
# version, which must give the composition it replaced bit for bit.

STATES = [torch.float32, torch.bfloat16, torch.float64]


def _state(p, dtype, n=3, seed=0):
    """Layer n of the closed form plus 1e-3 noise, in the state dtype."""
    f = stencil_ref.compute_dtype(dtype)
    sx, sy, sz = oracle.spatial_factors(p, torch.float64)
    exact = oracle.analytic_field(sx, sy, sz, oracle.time_factor(
        p, n, torch.float64))
    noise = np.random.default_rng(seed).standard_normal(exact.shape) * 1e-3
    return (exact + torch.from_numpy(noise)).to(f).to(dtype)


def _replaced(u, sx, sy, sz, ct):
    """The error pass as the 1-step solvers took it before the kernel: the
    spatial product formed once, times ct, against the view in the
    compute dtype."""
    f = stencil_ref.compute_dtype(u.dtype)
    spatial = sx[:, None, None] * sy[None, :, None] * sz[None, None, :]
    return oracle.layer_errors(u.to(f), spatial * ct)


def _same_bits(got, want):
    for a, b in zip(got, want):
        a, b = a.numpy(), b.numpy()
        assert (np.isnan(a) and np.isnan(b)) or a.tobytes() == b.tobytes(), (
            a, b)


def _factors(p, dtype):
    f = stencil_ref.compute_dtype(dtype)
    return oracle.spatial_factors(p, f), oracle.time_factor_table(p, f)


@pytest.mark.parametrize("dtype", STATES)
@pytest.mark.parametrize("n", [15, 16])
def test_error_pass_plain_is_the_replaced_composition(n, dtype):
    p = Problem(N=n, timesteps=8)
    u = _state(p, dtype)
    (sx, sy, sz), ct = _factors(p, dtype)
    want = _replaced(u[1:, 1:, 1:], sx[1:], sy[1:], sz[1:], ct[3])
    _same_bits(stencil_cuda.layer_errors(u[1:, 1:, 1:], sx[1:], sy[1:],
                                         sz[1:], ct[3]), want)
    _same_bits(oracle.separable_layer_errors(u[1:, 1:, 1:], sx[1:], sy[1:],
                                             sz[1:], ct[3]), want)
    for kernel in ("pallas", "roll"):
        errors = leapfrog.lane_error_fn(p, dtype, "cpu", kernel)
        _same_bits(errors(u, ct[3]), want)
        slots = torch.zeros((2, 5), dtype=ct.dtype)
        out = errors(u, ct[3], (slots[0, 2], slots[1, 2]))
        _same_bits(out, want)
        _same_bits((slots[0, 2], slots[1, 2]), want)
        assert not slots[:, [0, 1, 3, 4]].any()


@pytest.mark.parametrize("kernel,want", [
    ("pallas", stencil_cuda.layer_errors),
    ("roll", oracle.separable_layer_errors)])
def test_error_pass_choice_is_the_kernel_or_its_plain_version(kernel, want):
    assert stencil_cuda.make_layer_errors_fn(kernel) is want


def test_error_pass_choice_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="kernel must be"):
        stencil_cuda.make_layer_errors_fn("xla")


@pytest.mark.parametrize("dtype", STATES)
def test_error_pass_plain_on_a_strided_box_with_factor_offsets(dtype):
    # A shard's error box: a strided view of its block, the factors sliced
    # at the box's offsets (solver/sharded.py `_Shard.errors_at`).
    p = Problem(N=16, timesteps=8)
    u = _state(p, dtype, n=5, seed=1)
    (sx, sy, sz), ct = _factors(p, dtype)
    box = (slice(3, 9), slice(1, 7), slice(2, 11))
    fac = [v[b] for v, b in zip((sx, sy, sz), box)]
    assert u[box].stride() == (256, 16, 1)
    _same_bits(stencil_cuda.layer_errors(u[box], *fac, ct[5]),
               _replaced(u[box], *fac, ct[5]))


def test_error_pass_nan_reaches_abs_not_rel():
    p = Problem(N=16, timesteps=8)
    u = _state(p, torch.float32)
    (sx, sy, sz), ct = _factors(p, torch.float32)
    u[4, 7, 15] = float("nan")
    a, r = stencil_cuda.layer_errors(u[1:, 1:, 1:], sx[1:], sy[1:], sz[1:],
                                     ct[3])
    assert np.isnan(a.item()) and np.isfinite(r.item())
    _same_bits((a, r), _replaced(u[1:, 1:, 1:], sx[1:], sy[1:], sz[1:],
                                 ct[3]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_error_pass_zero_over_zero_is_zero_and_inf_stays(dtype):
    # The whole field, x = 0 plane included: there f = 0 (sx[0] = 0), so
    # u = f gives 0/0 at every cell of the plane.
    p = Problem(N=12, timesteps=8)
    (sx, sy, sz), ct = _factors(p, dtype)
    u = oracle.analytic_field(sx, sy, sz, ct[2])
    assert (u[0] == 0).all()
    a, r = stencil_cuda.layer_errors(u, sx, sy, sz, ct[2])
    assert a.item() == 0.0 and r.item() == 0.0
    u[5, 6, 7] = float("inf")
    a, r = stencil_cuda.layer_errors(u, sx, sy, sz, ct[2])
    assert a.item() == float("inf") and r.item() == float("inf")
    u[0, 6, 7] = float("-inf")  # where |f| = 0: inf / 0
    got = stencil_cuda.layer_errors(u, sx, sy, sz, ct[2])
    assert got[0].item() == got[1].item() == float("inf")
    _same_bits(got, _replaced(u, sx, sy, sz, ct[2]))


def test_error_pass_keeps_the_even_n_half_plane_rel():
    # At even N the x = 1/2 plane's factor is sin(pi) in float64, cast:
    # ~1e-16, not 0, so rel there is huge; the pass keeps that value.
    p = Problem(N=16, timesteps=8)
    u = _state(p, torch.float32)
    (sx, sy, sz), ct = _factors(p, torch.float32)
    h = p.N // 2
    assert 0 < abs(sx[h].item()) < 1e-15
    _, rel = stencil_cuda.layer_errors(u[1:, 1:, 1:], sx[1:], sy[1:], sz[1:],
                                       ct[3])
    _, plane = stencil_cuda.layer_errors(u[h:h + 1, 1:, 1:], sx[h:h + 1],
                                         sy[1:], sz[1:], ct[3])
    assert rel.item() > 1e9 and rel.item() == plane.item()
    _, off = stencil_cuda.layer_errors(u[1:h, 1:, 1:], sx[1:h], sy[1:],
                                       sz[1:], ct[3])
    assert off.item() < 1e3


def test_error_pass_on_the_cpu_loads_no_library_and_counts_nothing(
        monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU route loaded csrc/{name}.cu")

    monkeypatch.setattr(build, "load", no_build)
    before = stencil_cuda.launches["layer_errors"]
    p = Problem(N=12, timesteps=6)
    res = leapfrog.solve(p, device="cpu")
    assert np.isfinite(res.abs_errors).all() and res.abs_errors[1:].all()
    res = leapfrog.solve_compensated(p, device="cpu")
    assert res.abs_errors[1:].all()
    assert stencil_cuda.launches["layer_errors"] == before
