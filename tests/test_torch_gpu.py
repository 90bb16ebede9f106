"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; every test skips where there is no CUDA device (decided in a
fixture, never at import).  This file imports neither JAX nor wavetpu, so
it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(`--noconftest` skips tests/conftest.py, which configures JAX.)  Expected
bitwise: the kernels are built with --fmad=false and round every multiply
and add separately, as the plain versions' PyTorch ops do.
"""

import numpy as np
import pytest
import torch

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda
from wavetpu_torch.solver import kfused, kfused_comp, leapfrog

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def field(n, seed, scale=1.0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn((n, n, n), generator=g, dtype=torch.float64) * scale
    a[:, 0, :] = 0.0
    a[:, :, 0] = 0.0
    return a.to(dtype)


def equal(got, want):
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("n", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("coeffs", [(2.0, 1.0, 1.0), (1.0, 0.0, 0.5)])
def test_k1(cuda, n, dtype, coeffs):
    p = Problem(N=n, timesteps=10)
    up, u = field(n, 1, dtype=dtype).to(cuda), field(n, 2, dtype=dtype).to(cuda)
    a, b, c = coeffs
    kw = dict(inv_h2=p.inv_h2, alpha=a, beta=b, coeff=c * p.a2tau2)
    before = stencil_cuda.launches["step"]
    got = stencil_cuda.fused_step(up, u, **kw)
    assert stencil_cuda.launches["step"] == before + 1
    equal([got], [stencil_cuda.fused_step_plain(up, u, **kw)])


@pytest.mark.parametrize("n", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2(cuda, n, dtype):
    p = Problem(N=n, timesteps=10)
    u, v, c = (field(n, s, w, dtype).to(cuda)
               for s, w in ((3, 1.0), (4, 1e-3), (5, 1e-8)))
    for args in ((u, v, c, p.a2tau2),
                 (u, torch.zeros_like(u), torch.zeros_like(u),
                  0.5 * p.a2tau2)):
        got = stencil_cuda.compensated_step(*args[:3], p, args[3])
        want = stencil_cuda.compensated_step_plain(
            *args[:3], inv_h2=p.inv_h2, coeff=args[3])
        equal(got, want)


MODES = {
    "f32v_bf16carry": (torch.float32, torch.bfloat16),
    "f32v_f32carry": (torch.float32, torch.float32),
    "bf16v_nocarry": (torch.bfloat16, None),
    "f32v_nocarry": (torch.float32, None),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,k,bx", [(16, 1, 8), (16, 2, 4), (16, 4, 8),
                                    (48, 4, 8), (15, 3, 15), (64, 8, 8),
                                    (40, 5, 40), (42, 7, 14), (36, 6, 12)])
def test_k4(cuda, n, k, bx, mode):
    v_dt, c_dt = MODES[mode]
    p = Problem(N=n, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, cuda)
    sxct = ct[2:2 + k][:, None] * sx[None, :]
    u = field(n, 6).to(cuda)
    v = field(n, 7, 1e-3).to(cuda, v_dt)
    c = None if c_dt is None else field(n, 8, 1e-8).to(cuda, c_dt)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, block_x=bx)
    got = stencil_cuda.fused_kstep_comp(u, v, c, syz, rsyz, sxct, **kw)
    want = stencil_cuda.fused_kstep_comp_plain(u, v, c, syz, rsyz, sxct, **kw)
    equal(got, want)


def test_k4_error_rows_propagate_nan(cuda):
    p = Problem(N=16, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, cuda)
    sxct = ct[2:4][:, None] * sx[None, :]
    u = field(16, 9)
    u[5, 3, 3] = float("nan")
    u = u.to(cuda)
    out = stencil_cuda.fused_kstep_comp(
        u, torch.zeros_like(u), None, syz, rsyz, sxct, k=2,
        coeff=p.a2tau2, inv_h2=p.inv_h2, block_x=8)
    assert torch.isnan(out[3][0, 5]) and torch.isnan(out[4][0, 5])


def test_cuda_tensors_never_fall_back(cuda):
    p = Problem(N=16, timesteps=10)
    u = field(16, 10).to(cuda)
    with pytest.raises(ValueError):
        stencil_cuda.compensated_step(u, u.cpu(), u, p)
    with pytest.raises(ValueError):  # K4 takes no f64 state on the card
        d = u.double()
        stencil_cuda.fused_kstep_comp(
            d, d, None, d[0], d[0], d[:2, 0], k=2, coeff=1.0,
            inv_h2=p.inv_h2)


@pytest.mark.parametrize("solver", ["standard", "compensated", "flagship"])
def test_solvers_card_vs_cpu(cuda, solver):
    p = Problem(N=16, timesteps=11)
    run = {
        "standard": lambda d: leapfrog.solve(p, device=d),
        "compensated": lambda d: leapfrog.solve_compensated(p, device=d),
        "flagship": lambda d: kfused_comp.solve_kfused_comp(p, device=d),
    }[solver]
    stencil_cuda.reset_launches()
    gpu = run(cuda)
    assert sum(stencil_cuda.launches.values()) > 0
    cpu = run("cpu")
    assert (gpu.u_cur.cpu() - cpu.u_cur).abs().max().item() <= 1e-5
    assert np.max(np.abs(gpu.abs_errors - cpu.abs_errors)) <= 1e-5
