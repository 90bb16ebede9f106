"""The port's scheme against the original MPI+CUDA formulation: the
reference-grid helpers (`leapfrog.solve_history`, `to_reference_grid`,
`oracle.full_analytic_grid`) and the f64 march, layer by layer, against
the independent (N+1)^3-with-seam numpy implementation
(tests/reference_impl.py, a test helper).  The four checks of
tests/test_single_device.py, on the port, within 1e-12."""

import numpy as np
import pytest
import torch

from tests import reference_impl
from wavetpu.core.problem import Problem as WProblem
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.solver import leapfrog
from wavetpu_torch.verify import oracle

SMALL = dict(N=16, Np=1, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=10)
MEDIUM = dict(N=32, Np=1, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=20)


@pytest.fixture(scope="module")
def ref_history():
    return reference_impl.solve_reference(WProblem(**SMALL))


@pytest.fixture(scope="module")
def history():
    return leapfrog.solve_history(Problem(**SMALL), dtype=torch.float64,
                                  device="cpu")


def test_history_matches_reference_scheme(history, ref_history):
    """Every layer of the (N,N,N) history, expanded to the reference's
    grid, equals the seam formulation to rounding error."""
    assert history.shape == (SMALL["timesteps"] + 1,) + (SMALL["N"],) * 3
    assert history.shape[0] == ref_history.shape[0]
    for n in range(history.shape[0]):
        np.testing.assert_allclose(
            leapfrog.to_reference_grid(history[n]), ref_history[n],
            atol=1e-12, rtol=0.0, err_msg=f"layer {n} mismatch")


def test_fused_march_matches_reference_scheme(ref_history):
    """The port's f64 1-step march (K1's plain version, the solver's op
    order) holds every layer against the seam formulation."""
    p = Problem(**SMALL)
    for stop in range(1, p.timesteps + 1):
        res = leapfrog.solve(p, dtype=torch.float64, device="cpu",
                             stop_step=stop)
        np.testing.assert_allclose(
            leapfrog.to_reference_grid(res.u_cur), ref_history[stop],
            atol=1e-12, rtol=0.0, err_msg=f"layer {stop} mismatch")


def test_seam_duplication_consistency(history, ref_history):
    """The reference grid's x=0 and x=N planes are identical (from layer 1
    on an exact copy; layer 0 is analytic, sin(2*pi) ~ 1e-16), and the
    port's expansion re-attaches the seam and the zero faces."""
    np.testing.assert_allclose(ref_history[0][0], ref_history[0][-1],
                               atol=1e-15)
    for n in range(1, ref_history.shape[0]):
        np.testing.assert_array_equal(ref_history[n][0], ref_history[n][-1])
    for n in range(history.shape[0]):
        full = leapfrog.to_reference_grid(history[n])
        np.testing.assert_array_equal(full[-1], full[0])
        assert not full[:, -1, :].any() and not full[:, :, -1].any()


def test_fused_errors_match_posthoc(history, ref_history):
    """The solver's fused per-layer errors equal the post-hoc errors of the
    seam formulation; a denominator-thresholded rel error agrees between
    the two histories (the raw rel max is rounding noise on nodal
    planes)."""
    p = Problem(**SMALL)
    res = leapfrog.solve(p, dtype=torch.float64, device="cpu")
    ref_abs, _ = reference_impl.reference_errors(WProblem(**SMALL),
                                                 ref_history)
    np.testing.assert_allclose(res.abs_errors, ref_abs, atol=1e-12)
    assert np.all(res.rel_errors >= res.abs_errors - 1e-15)
    sl = (slice(1, -1),) * 3
    for n in range(history.shape[0]):
        f = oracle.full_analytic_grid(p, n)
        den_ok = np.abs(f) > 1e-3
        ours = np.abs(leapfrog.to_reference_grid(history[n]) - f)
        refs = np.abs(ref_history[n] - f)
        r1 = np.where(den_ok, ours / np.where(den_ok, np.abs(f), 1.0),
                      0.0)[sl].max()
        r2 = np.where(den_ok, refs / np.where(den_ok, np.abs(f), 1.0),
                      0.0)[sl].max()
        np.testing.assert_allclose(r1, r2, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("cfg", [SMALL, MEDIUM], ids=["N16", "N32"])
def test_layer0_error_is_zero(cfg):
    """The reported layer-0 error is zero by definition, so the actual
    layer-0 state is pinned against the host-f64 oracle too."""
    p = Problem(**cfg)
    res = leapfrog.solve(p, dtype=torch.float64, device="cpu")
    assert res.abs_errors[0] == 0.0 and res.rel_errors[0] == 0.0
    hist = leapfrog.solve_history(p, dtype=torch.float64, device="cpu")
    f0 = oracle.full_analytic_grid(p, 0)[:-1, :-1, :-1]
    f0[:, 0, :] = 0.0
    f0[:, :, 0] = 0.0
    assert np.abs(hist[0] - f0).max() < 1e-14


def test_full_analytic_grid_matches_wavetpu():
    """The oracle's reference-indexed grid is wavetpu's, bit for bit."""
    from wavetpu.verify import oracle as w_oracle

    for n in (0, 3, 10):
        np.testing.assert_array_equal(
            oracle.full_analytic_grid(Problem(**SMALL), n),
            w_oracle.full_analytic_grid(WProblem(**SMALL), n))
