"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; every test skips where there is no CUDA device (decided in a
fixture, never at import).  This file imports neither JAX nor wavetpu, so
it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

(`--noconftest` skips tests/conftest.py, which configures JAX.)  Expected
bitwise: the kernels are built with --fmad=false and round every multiply
and add separately, as the plain versions' PyTorch ops do.
"""

import os

import numpy as np
import pytest
import torch

from wavetpu_torch import cli
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import (
    kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
)

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


def c2_field(p, seed, dtype=torch.float32):
    """A positive tau^2 c^2 field around a2tau2 (0.5x to 1.5x)."""
    g = torch.Generator().manual_seed(seed)
    return (p.a2tau2 * (0.5 + torch.rand((p.N,) * 3, generator=g,
                                         dtype=torch.float64))).to(dtype)


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


@pytest.mark.parametrize("n", [16, 48])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_k5(cuda, n, dtype):
    p = Problem(N=n, timesteps=10)
    up, u = field(n, 1, dtype=dtype).to(cuda), field(n, 2, dtype=dtype).to(cuda)
    fld = c2_field(p, 3, stencil_ref.compute_dtype(dtype)).to(cuda)
    before = dict(stencil_cuda.launches)
    got = stencil_cuda.fused_step(up, u, inv_h2=p.inv_h2, c2tau2_field=fld)
    assert stencil_cuda.launches["var_step"] == before["var_step"] + 1
    assert stencil_cuda.launches["step"] == before["step"]
    equal([got], [stencil_cuda.fused_step_plain(up, u, inv_h2=p.inv_h2,
                                                c2tau2_field=fld)])


# (n, k): n = 15, 21 take the run-time tile depth (tx = 5, 7).
@pytest.mark.parametrize("n,k", [(16, 2), (16, 4), (16, 8), (48, 3), (48, 4),
                                 (48, 6), (15, 3), (15, 5), (21, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_k3(cuda, n, k, dtype, with_field, with_errors):
    p = Problem(N=n, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, cuda)
    sxct = ct[2:2 + k][:, None] * sx[None, :]
    up, u = field(n, 11, dtype=dtype).to(cuda), field(n, 12, dtype=dtype).to(cuda)
    fld = c2_field(p, 13).to(cuda) if with_field else None
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, c2tau2_field=fld,
              with_errors=with_errors)
    name = "kstep_field" if with_field else "kstep"
    before = stencil_cuda.launches[name]
    got = stencil_cuda.fused_kstep(up, u, syz, rsyz, sxct, **kw)
    assert stencil_cuda.launches[name] == before + 1
    want = stencil_cuda.fused_kstep_plain(up, u, syz, rsyz, sxct, **kw)
    assert got[0].dtype == dtype and got[1].dtype == dtype
    equal(got, want)


def test_k3_error_rows_propagate_nan(cuda):
    p = Problem(N=16, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, cuda)
    sxct = ct[2:4][:, None] * sx[None, :]
    u = field(16, 14)
    u[5, 3, 3] = float("nan")
    u = u.to(cuda)
    out = stencil_cuda.fused_kstep(u, u, syz, rsyz, sxct, k=2,
                                   coeff=p.a2tau2, inv_h2=p.inv_h2)
    assert torch.isnan(out[2][0, 5]) and torch.isnan(out[3][0, 5])


MODES = {
    "f32v_bf16carry": (torch.float32, torch.bfloat16),
    "f32v_f32carry": (torch.float32, torch.float32),
    "bf16v_nocarry": (torch.bfloat16, None),
    "f32v_nocarry": (torch.float32, None),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,k,bx", [(16, 1, 8), (16, 2, 4), (16, 4, 8),
                                    (48, 4, 8), (15, 3, 15), (64, 8, 8),
                                    (40, 5, 40), (42, 7, 14), (36, 6, 12),
                                    (64, 4, 32), (64, 4, 64), (96, 8, 32),
                                    (64, 1, 32), (8, 4, 4)])
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


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,k,bx", [(16, 1, 8), (16, 4, 8), (48, 4, 8),
                                    (15, 3, 15)])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_k4f(cuda, n, k, bx, mode, with_errors):
    # Rows off is how the variable-c flagship launches K4f.
    v_dt, c_dt = MODES[mode]
    p = Problem(N=n, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, cuda)
    sxct = ct[2:2 + k][:, None] * sx[None, :]
    u = field(n, 6).to(cuda)
    v = field(n, 7, 1e-3).to(cuda, v_dt)
    c = None if c_dt is None else field(n, 8, 1e-8).to(cuda, c_dt)
    fld = c2_field(p, 9).to(cuda)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, block_x=bx,
              c2tau2_field=fld, with_errors=with_errors)
    before = dict(stencil_cuda.launches)
    got = stencil_cuda.fused_kstep_comp(u, v, c, syz, rsyz, sxct, **kw)
    assert (stencil_cuda.launches["kstep_comp_field"]
            == before["kstep_comp_field"] + 1)
    assert stencil_cuda.launches["kstep_comp"] == before["kstep_comp"]
    want = stencil_cuda.fused_kstep_comp_plain(u, v, c, syz, rsyz, sxct, **kw)
    equal(got, want)


@pytest.mark.parametrize("mode", list(MODES))
def test_k4f_bootstrap(cuda, mode):
    # The variable-c flagship's layer 1: K4f at k=1 with half the field,
    # zero v and carry, zero oracle planes and no error rows.
    v_dt, c_dt = MODES[mode]
    n = 48
    p = Problem(N=n, timesteps=20)
    u = field(n, 6).to(cuda)
    v = torch.zeros((n,) * 3, dtype=v_dt, device=cuda)
    c = None if c_dt is None else torch.zeros((n,) * 3, dtype=c_dt,
                                              device=cuda)
    zero = torch.zeros((n, n), device=cuda)
    sxct = torch.zeros((1, n), device=cuda)
    kw = dict(k=1, coeff=None, inv_h2=p.inv_h2, block_x=8,
              with_errors=False, c2tau2_field=0.5 * c2_field(p, 9).to(cuda))
    got = stencil_cuda.fused_kstep_comp(u, v, c, zero, zero, sxct, **kw)
    want = stencil_cuda.fused_kstep_comp_plain(u, v, c, zero, zero, sxct,
                                               **kw)
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
    d = u.double()
    with pytest.raises(ValueError):  # K3 takes no f64 state on the card
        stencil_cuda.fused_kstep(d, d, None, None, None, k=2, coeff=1.0,
                                 inv_h2=p.inv_h2, with_errors=False)
    with pytest.raises(ValueError):  # K3 takes no k = 1 (K1's job)
        stencil_cuda.fused_kstep(u, u, None, None, None, k=1, coeff=1.0,
                                 inv_h2=p.inv_h2, with_errors=False)
    with pytest.raises(ValueError):  # k must divide N
        stencil_cuda.fused_kstep(u, u, None, None, None, k=3, coeff=1.0,
                                 inv_h2=p.inv_h2, with_errors=False)
    with pytest.raises(ValueError):  # a field in the wrong dtype
        stencil_cuda.fused_step(u, u, inv_h2=p.inv_h2, c2tau2_field=d)
    with pytest.raises(ValueError):  # a field on the CPU
        stencil_cuda.fused_kstep(u, u, None, None, None, k=2, coeff=1.0,
                                 inv_h2=p.inv_h2, with_errors=False,
                                 c2tau2_field=u.cpu())
    with pytest.raises(ValueError):  # a field of the wrong shape
        stencil_cuda.fused_kstep_comp(
            u, u, None, u[0], u[0], u[:2, 0].contiguous(), k=2, coeff=1.0,
            inv_h2=p.inv_h2, c2tau2_field=u[:8].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("n,k", [(16, 4), (48, 3)])
def test_kfused_equals_1step_on_card(cuda, dtype, with_field, n, k):
    p = Problem(N=n, timesteps=14)
    if with_field:
        fld = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
        a = kfused.solve_kfused(p, dtype=dtype, k=k, c2tau2_field=fld,
                                compute_errors=False, device=cuda)
        b = leapfrog.solve(p, dtype=dtype, c2tau2_field=fld,
                           compute_errors=False, device=cuda)
    else:
        a = kfused.solve_kfused(p, dtype=dtype, k=k, device=cuda)
        b = leapfrog.solve(p, dtype=dtype, device=cuda)
    assert torch.equal(a.u_cur, b.u_cur) and torch.equal(a.u_prev, b.u_prev)


@pytest.mark.parametrize("solver", ["standard", "compensated", "flagship",
                                    "kfused", "varc", "kfused_varc",
                                    "flagship_varc"])
def test_solvers_card_vs_cpu(cuda, solver):
    p = Problem(N=16, timesteps=11)
    fld = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
    run = {
        "standard": lambda d: leapfrog.solve(p, device=d),
        "compensated": lambda d: leapfrog.solve_compensated(p, device=d),
        "flagship": lambda d: kfused_comp.solve_kfused_comp(p, device=d),
        "kfused": lambda d: kfused.solve_kfused(p, device=d),
        "varc": lambda d: leapfrog.solve(
            p, c2tau2_field=fld, compute_errors=False, device=d),
        "kfused_varc": lambda d: kfused.solve_kfused(
            p, c2tau2_field=fld, compute_errors=False, device=d),
        "flagship_varc": lambda d: kfused_comp.solve_kfused_comp(
            p, c2tau2_field=fld, compute_errors=False, device=d),
    }[solver]
    stencil_cuda.reset_launches()
    gpu = run(cuda)
    assert sum(stencil_cuda.launches.values()) > 0
    cpu = run("cpu")
    assert (gpu.u_cur.cpu() - cpu.u_cur).abs().max().item() <= 1e-5
    assert np.max(np.abs(gpu.abs_errors - cpu.abs_errors)) <= 1e-5


# ---------------------------------------------------------------------------
# The sharded kernels K6-K9, with synthetic ghosts from a seed.


def rand(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def ghosts_of(shape, seed, dtype, cuda):
    out = []
    for axis in range(3):
        face = list(shape)
        face[axis] = 1
        out.append(tuple(rand(face, seed + 2 * axis + i, dtype).to(cuda)
                         for i in range(2)))
    return out


# (mesh, N, block, r_last, offsets): every ghost pattern - none, x, y, z,
# pairs, all three - and uneven pads (r_last < block) on x, y and z.
K6_BLOCKS = [
    ((1, 1, 1), 15, (15, 15, 15), None, (0, 0, 0)),
    ((2, 1, 1), 32, (16, 32, 32), None, (16, 0, 0)),
    ((1, 2, 1), 32, (32, 16, 32), None, (0, 0, 0)),
    ((1, 1, 2), 32, (32, 32, 16), None, (0, 0, 16)),
    ((2, 2, 1), 48, (24, 24, 48), None, (24, 24, 0)),
    ((1, 3, 2), 30, (30, 10, 15), None, (0, 10, 15)),
    ((2, 2, 2), 64, (32, 32, 32), None, (0, 32, 32)),
    ((4, 1, 1), 15, (4, 15, 15), (3, 15, 15), (12, 0, 0)),
    ((2, 3, 4), 17, (9, 6, 5), (8, 5, 2), (9, 12, 15)),
]


@pytest.mark.parametrize("mesh,n,shape,r_last,offsets", K6_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k6(cuda, mesh, n, shape, r_last, offsets, dtype, with_field):
    p = Problem(N=n, timesteps=10)
    up, u = rand(shape, 1, dtype).to(cuda), rand(shape, 2, dtype).to(cuda)
    g = ghosts_of(shape, 3, dtype, cuda)
    f = stencil_ref.compute_dtype(dtype)
    fld = (p.a2tau2 * (0.5 + rand(shape, 9).abs())).to(cuda, f) \
        if with_field else None
    kw = dict(inv_h2=p.inv_h2, mesh_shape=mesh, r_last=r_last, coeff=p.a2tau2,
              c2tau2_block=fld)
    name = "sharded_step_field" if with_field else "sharded_step"
    for alpha, beta in ((2.0, 1.0), (1.0, 0.0)):
        before = stencil_cuda.launches[name]
        got = stencil_cuda.sharded_fused_step(up, u, g, offsets, n,
                                              alpha=alpha, beta=beta, **kw)
        assert stencil_cuda.launches[name] == before + 1
        want = stencil_cuda.sharded_fused_step_plain(
            up.cpu(), u.cpu(), [tuple(x.cpu() for x in a) for a in g],
            offsets, n, alpha=alpha, beta=beta,
            **dict(kw, c2tau2_block=None if fld is None else fld.cpu()))
        equal([got.cpu()], [want])
        # The plain version on the card's tensors is the same function.
        equal([got], [stencil_cuda.sharded_fused_step_plain(
            up, u, g, offsets, n, alpha=alpha, beta=beta, **kw)])


@pytest.mark.parametrize("mesh,n,shape,r_last,offsets", K6_BLOCKS[4:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7(cuda, mesh, n, shape, r_last, offsets, dtype):
    p = Problem(N=n, timesteps=10)
    u = rand(shape, 4, dtype).to(cuda)
    v = (rand(shape, 5, dtype) * 1e-3).to(cuda)
    c = (rand(shape, 6, dtype) * 1e-8).to(cuda)
    g = ghosts_of(shape, 7, dtype, cuda)
    kw = dict(inv_h2=p.inv_h2, mesh_shape=mesh, r_last=r_last,
              coeff=p.a2tau2)
    before = stencil_cuda.launches["sharded_comp_step"]
    got = stencil_cuda.sharded_compensated_step(u, v, c, g, offsets, n, **kw)
    assert stencil_cuda.launches["sharded_comp_step"] == before + 1
    equal(got, stencil_cuda.sharded_compensated_step_plain(
        u, v, c, g, offsets, n, **kw))


def chain_case(cuda, d, n, k, dtype, seed):
    p = Problem(N=n, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, cuda)
    sxp = torch.cat([sx, torch.zeros(d, device=cuda)])[:d]
    sxct = (ct[3:3 + k][:, None] * sxp[None, :]).contiguous()
    up, u = (rand((d, n, n), seed + i, dtype).to(cuda) for i in range(2))
    gh = [rand((k, n, n), seed + 10 + i, dtype).to(cuda) for i in range(4)]
    fg = [(p.a2tau2 * (0.5 + rand((k, n, n), seed + 20 + i).abs())).to(cuda)
          for i in range(2)]
    fld = (p.a2tau2 * (0.5 + rand((d, n, n), seed + 30).abs())).to(cuda)
    return p, syz, rsyz, sxct, up, u, gh, fld, fg


# (D, N, k): every k, depths of one segment (kstep_pipe_tile's seg = D),
# N = D and N not a multiple of the 24 x 24 face.
@pytest.mark.parametrize("d,n,k", [(16, 32, 1), (8, 16, 2), (12, 24, 3),
                                   (16, 32, 4), (15, 15, 5), (12, 36, 6),
                                   (14, 16, 7), (8, 48, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_k8(cuda, d, n, k, dtype, with_field, with_errors):
    p, syz, rsyz, sxct, up, u, gh, fld, fg = chain_case(cuda, d, n, k, dtype,
                                                        40)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
              c2tau2_block=fld if with_field else None,
              c2_ghosts=tuple(fg) if with_field else None,
              with_errors=with_errors)
    args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), syz, rsyz, sxct)
    name = "kstep_sharded_field" if with_field else "kstep_sharded"
    before = stencil_cuda.launches[name]
    got = stencil_cuda.fused_kstep_sharded(*args, **kw)
    assert stencil_cuda.launches[name] == before + 1
    equal(got, stencil_cuda.fused_kstep_sharded_plain(*args, **kw))


@pytest.mark.parametrize("d,n,k,n_real", [(16, 32, 1, 13), (8, 16, 2, 8),
                                          (12, 24, 3, 7), (16, 32, 4, 2),
                                          (15, 15, 5, 11), (12, 36, 6, 1),
                                          (16, 16, 7, 9), (8, 48, 8, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_k9(cuda, d, n, k, n_real, dtype, with_field, with_errors):
    p, syz, rsyz, sxct, up, u, gh, fld, fg = chain_case(cuda, d, n, k, dtype,
                                                        50)
    up[n_real:], u[n_real:], sxct[:, n_real:] = 0.0, 0.0, 0.0
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
              c2tau2_block=fld if with_field else None,
              c2_ghosts=tuple(fg) if with_field else None,
              with_errors=with_errors)
    args = (up, u, n_real, (gh[0], gh[1]), (gh[2], gh[3]), syz, rsyz, sxct)
    name = "kstep_padded_field" if with_field else "kstep_padded"
    before = stencil_cuda.launches[name]
    got = stencil_cuda.fused_kstep_padded(*args, **kw)
    assert stencil_cuda.launches[name] == before + 1
    equal(got, stencil_cuda.fused_kstep_padded_plain(*args, **kw))
    assert not got[1][n_real:].any()


# (seg, ty, tz) tiles of K3 and K8's pipeline (csrc/kstep_pipe.cu) beside
# kstep_pipe_tile's: segments 128 (= the depth), 64, 32, 16, 8, 4 and 1,
# and K11/K12's faces.  The results do not depend on the tile.
KPIPE_TILES = [(128, 24, 24), (64, 24, 24), (32, 24, 24), (16, 10, 12),
               (8, 3, 5), (4, 24, 8), (32, 7, 24), (1, 1, 1)]


@pytest.mark.parametrize("tile", KPIPE_TILES)
@pytest.mark.parametrize("kernel", ["K3", "K8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k3_k8_pipeline_tiles(cuda, tile, kernel, dtype, with_field):
    k = 4
    d, n = (128, 128) if kernel == "K3" else (128, 40)
    p, syz, rsyz, sxct, up, u, gh, fld, fg = chain_case(cuda, d, n, k, dtype,
                                                        60)
    if kernel == "K3":  # the whole state, its windows the wrap planes
        gh = [*stencil_cuda.wrap_planes(up, k),
              *stencil_cuda.wrap_planes(u, k)]
        fg = stencil_cuda.wrap_planes(fld, k)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
              c2tau2_block=fld if with_field else None,
              c2_ghosts=tuple(fg) if with_field else None, with_errors=True)
    args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), syz, rsyz, sxct)
    got = stencil_cuda._kstep_pipe("kstep_sharded", *args, tile=tile, **kw)
    equal(got, stencil_cuda.fused_kstep_sharded_plain(*args, **kw))
    if kernel == "K3":
        kw3 = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=True,
                   c2tau2_field=fld if with_field else None)
        equal(got, stencil_cuda.fused_kstep_plain(up, u, syz, rsyz, sxct,
                                                  **kw3))


# (seg, ty, tz) tiles of K9 and K10 on the pipeline beside kstep_pipe_tile's
# (128, 24, 24): segments 64 to 8, 48 (not dividing D = 128: the last
# segment overlaps the one before), and K11/K12's faces.  K9 with its real
# planes ending inside a segment (100) and on a segment boundary (96), N =
# 40; K10 on the last y shard of N = 128 with 20 central rows, not a
# multiple of ty (the face overhangs the extension).
K9_K10_TILES = [(128, 24, 24), (64, 24, 24), (48, 24, 24), (32, 24, 24),
                (16, 10, 12), (8, 3, 5), (64, 7, 24), (32, 24, 8)]


@pytest.mark.parametrize("tile", K9_K10_TILES)
@pytest.mark.parametrize("kernel", ["K9 n_real=100", "K9 n_real=96", "K10"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k9_k10_pipeline_tiles(cuda, tile, kernel, dtype, with_field):
    d, k = 128, 4
    if kernel == "K10":
        n, ny, y0 = 128, 20, 108
        p, planes, sxct, (up, u), gh, fld, fg = xy_case(cuda, d, n, k, ny,
                                                        y0, dtype, 110)
        args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), *planes, sxct)
    else:
        n, n_real = 40, int(kernel.split("=")[1])
        p, syz, rsyz, sxct, up, u, gh, fld, fg = chain_case(cuda, d, n, k,
                                                            dtype, 100)
        args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), syz, rsyz, sxct)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=True,
              c2_ghosts=tuple(fg) if with_field else None)
    fld = fld if with_field else None
    if kernel == "K10":
        got = stencil_cuda._kstep_pipe("kstep_sharded_xy", *args, tile=tile,
                                       c2tau2_block=fld, y0=y0, nl_y=ny,
                                       **kw)
        want = stencil_cuda.fused_kstep_sharded_xy_plain(
            *args, y0, n, nl_y=ny, c2tau2_ext=fld, **kw)
    else:
        got = stencil_cuda._kstep_pipe("kstep_padded", *args, tile=tile,
                                       c2tau2_block=fld, n_real=n_real, **kw)
        want = stencil_cuda.fused_kstep_padded_plain(
            up, u, n_real, *args[2:], c2tau2_block=fld, **kw)
        assert not got[1][n_real:].any() and not got[2][:, n_real:].any()
    equal(got, want)


@pytest.mark.parametrize("kernel", ["K9", "K10"])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k9_k10_read_their_chains_in_place(cuda, kernel, with_field):
    # The launch allocates its two outputs and the rows, nothing more: no
    # extended chain (K9's [lo | block[:n_real] | hi | 0], K10's x windows
    # spliced onto the extended block) is assembled.
    d, n, k = 64, 64, 4
    if kernel == "K9":
        p, syz, rsyz, sxct, up, u, gh, fld, fg = chain_case(
            cuda, d, n, k, torch.float32, 120)
        args = (up, u, 50, (gh[0], gh[1]), (gh[2], gh[3]), syz, rsyz, sxct)
        kw = dict(c2tau2_block=fld if with_field else None,
                  c2_ghosts=tuple(fg) if with_field else None)
        fn, plain = (stencil_cuda.fused_kstep_padded,
                     stencil_cuda.fused_kstep_padded_plain)
        out_cells = d * n * n
    else:
        ny, y0 = 32, 32
        p, planes, sxct, (up, u), gh, fld, fg = xy_case(
            cuda, d, n, k, ny, y0, torch.float32, 130)
        args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), *planes, sxct, y0, n)
        kw = dict(nl_y=ny, c2tau2_ext=fld if with_field else None,
                  c2_ghosts=fg if with_field else None)
        fn, plain = (stencil_cuda.fused_kstep_sharded_xy,
                     stencil_cuda.fused_kstep_sharded_xy_plain)
        out_cells = d * ny * n
    kw.update(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2)
    before = [t.clone() for t in (up, u, *gh)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    out_bytes = 2 * out_cells * 4
    window = k * up.shape[1] * n * 4
    assert out_bytes <= grown < out_bytes + window
    for t, t0 in zip((up, u, *gh), before):
        assert torch.equal(t, t0)
    equal(got, plain(*args, **kw))


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k8_block_as_deep_as_k(cuda, k, with_field):
    # D = k: one segment of k planes, every plane's x neighbours k deep
    # in the windows.
    p, syz, rsyz, sxct, up, u, gh, fld, fg = chain_case(cuda, k, 24, k,
                                                        torch.float32, 70)
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
              c2tau2_block=fld if with_field else None,
              c2_ghosts=tuple(fg) if with_field else None, with_errors=True)
    args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), syz, rsyz, sxct)
    assert stencil_cuda.kstep_pipe_tile(k, k)[0] == k
    equal(stencil_cuda.fused_kstep_sharded(*args, **kw),
          stencil_cuda.fused_kstep_sharded_plain(*args, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_reads_its_wrap_windows_in_place(cuda, dtype):
    n, k = 64, 4
    p = Problem(N=n, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, cuda)
    sxct = ct[2:2 + k][:, None] * sx[None, :]
    up = field(n, 21, dtype=dtype).to(cuda)
    u = field(n, 22, dtype=dtype).to(cuda)
    fld = c2_field(p, 23).to(cuda)
    before = [t.clone() for t in (up, u, fld)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = stencil_cuda.fused_kstep(up, u, syz, rsyz, sxct, k=k,
                                   coeff=p.a2tau2, inv_h2=p.inv_h2,
                                   c2tau2_field=fld)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    state = u.numel() * u.element_size()
    window = k * n * n * u.element_size()
    # The two outputs and the rows: no window of u_prev, u or the field
    # was copied.
    assert 2 * state <= grown < 2 * state + window
    for t, t0 in zip((up, u, fld), before):
        assert torch.equal(t, t0)
    equal(got, stencil_cuda.fused_kstep_plain(up, u, syz, rsyz, sxct, k=k,
                                              coeff=p.a2tau2,
                                              inv_h2=p.inv_h2,
                                              c2tau2_field=fld))


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k3_equals_k_k1_steps(cuda, k, dtype, with_field):
    n = 64
    p = Problem(N=n, timesteps=20)
    up = field(n, 31, dtype=dtype).to(cuda)
    u = field(n, 32, dtype=dtype).to(cuda)
    fld = c2_field(p, 33).to(cuda) if with_field else None
    prev, cur = up, u
    for _ in range(k):
        prev, cur = cur, stencil_cuda.fused_step(
            prev, cur, inv_h2=p.inv_h2, alpha=2.0, beta=1.0,
            coeff=p.a2tau2, c2tau2_field=fld)
    got = stencil_cuda.fused_kstep(up, u, None, None, None, k=k,
                                   coeff=p.a2tau2, inv_h2=p.inv_h2,
                                   c2tau2_field=fld, with_errors=False)
    assert torch.equal(got[0], prev) and torch.equal(got[1], cur)


def test_sharded_kernels_never_fall_back(cuda):
    p = Problem(N=16, timesteps=10)
    u = rand((8, 16, 16), 1).to(cuda)
    g = ghosts_of((8, 16, 16), 2, torch.float32, cuda)
    kw = dict(inv_h2=p.inv_h2, mesh_shape=(2, 1, 1), coeff=p.a2tau2)
    with pytest.raises(ValueError):  # a ghost on the CPU
        stencil_cuda.sharded_fused_step(
            u, u, [(g[0][0].cpu(), g[0][1])] + g[1:], (0, 0, 0), 16, **kw)
    with pytest.raises(ValueError):  # a ghost of the wrong shape
        stencil_cuda.sharded_fused_step(
            u, u, [(g[1][0], g[0][1])] + g[1:], (0, 0, 0), 16, **kw)
    with pytest.raises(ValueError):  # K7 takes no bf16
        b = u.to(torch.bfloat16)
        stencil_cuda.sharded_compensated_step(
            b, b, b, [tuple(x.to(torch.bfloat16) for x in a) for a in g],
            (0, 0, 0), 16, **kw)
    w = rand((2, 16, 16), 3).to(cuda)
    with pytest.raises(ValueError):  # K8/K9 take no f64
        d = u.double()
        stencil_cuda.fused_kstep_sharded(
            d, d, (w.double(), w.double()), (w.double(), w.double()), None,
            None, None, k=2, coeff=1.0, inv_h2=p.inv_h2, with_errors=False)
    with pytest.raises(ValueError):  # a ghost window of the wrong depth
        stencil_cuda.fused_kstep_padded(
            u, u, 5, (w, w), (w, w), None, None, None, k=4, coeff=1.0,
            inv_h2=p.inv_h2, with_errors=False)


@pytest.mark.parametrize("mesh", [(2, 2, 1), (4, 1, 1), (1, 2, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_on_one_card_equals_single_device(cuda, mesh, dtype):
    p = Problem(N=15, timesteps=9)
    a = sharded.solve_sharded(p, mesh, devices=[cuda] * 8, dtype=dtype)
    b = leapfrog.solve(p, dtype, device=cuda)
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.u_prev.fundamental(), b.u_prev)
    assert np.array_equal(a.abs_errors, b.abs_errors)


@pytest.mark.parametrize("mesh", [(2, 2, 1), (4, 1, 1)])
def test_sharded_compensated_on_one_card_equals_single_device(cuda, mesh):
    p = Problem(N=15, timesteps=9)
    a = sharded.solve_sharded(p, mesh, devices=[cuda] * 4,
                              scheme="compensated")
    b = leapfrog.solve_compensated(p, device=cuda)
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.comp_carry.fundamental(), b.comp_carry)


@pytest.mark.parametrize("n,k,mx", [(16, 4, 4), (16, 2, 2), (15, 4, 2),
                                    (13, 4, 4), (15, 4, 1)])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_sharded_kfused_on_one_card_equals_single_device(cuda, n, k, mx,
                                                         with_field):
    p = Problem(N=n, timesteps=12)
    kw = {}
    if with_field:
        kw = dict(compute_errors=False, c2tau2_field=stencil_ref.
                  make_preset_c2tau2_field(p, "gaussian-lens"))
    a = sharded_kfused.solve_sharded_kfused(p, n_shards=mx, k=k,
                                            devices=[cuda] * mx, **kw)
    if sharded_kfused._is_even(p, k, mx):
        b = kfused.solve_kfused(p, k=k, device=cuda, **kw)
    else:
        b = leapfrog.solve(p, device=cuda, **kw)
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.u_prev.fundamental(), b.u_prev)


# ---------------------------------------------------------------------------
# K10-K12: y-extended blocks (py = ny + 2k rows) and the distributed
# flagship's chain, with synthetic blocks and windows from a seed.


def xy_case(cuda, d, n, k, ny, y0, dtype, seed, whole=False):
    """A launch's operands: blocks (d, py, n) with py = n (whole y) or
    ny + 2k, (k, py, n) windows, the central oracle planes and (k, d)
    rows, a field chain."""
    p = Problem(N=n, timesteps=20)
    py = n if whole else ny + 2 * k
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, cuda)
    planes = tuple(a[y0:y0 + ny].contiguous() for a in (syz, rsyz))
    sxct = (ct[3:3 + k][:, None] * sx[None, :d]).contiguous()
    blocks = [rand((d, py, n), seed + i, dtype).to(cuda) for i in range(2)]
    gh = [rand((k, py, n), seed + 10 + i, dtype).to(cuda) for i in range(4)]
    fld = (p.a2tau2 * (0.5 + rand((d, py, n), seed + 30).abs())).to(cuda)
    fg = tuple((p.a2tau2 * (0.5 + rand((k, py, n), seed + 20 + i).abs()))
               .to(cuda) for i in range(2))
    return p, planes, sxct, blocks, gh, fld, fg


# (D, N, k, nl_y, y0): the last shard's y0 = N - nl_y, the first's 0, and
# nl_y = k (a ghost strip spans a whole neighbour block); every k.
XY_CASES = [(8, 16, 2, 8, 8), (8, 16, 4, 4, 12), (12, 24, 3, 6, 0),
            (16, 32, 1, 16, 16), (15, 15, 5, 5, 10), (6, 36, 6, 9, 27),
            (14, 16, 7, 8, 0), (8, 48, 8, 8, 40)]


@pytest.mark.parametrize("d,n,k,ny,y0", XY_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_k10(cuda, d, n, k, ny, y0, dtype, with_field, with_errors):
    p, planes, sxct, (up, u), gh, fld, fg = xy_case(cuda, d, n, k, ny, y0,
                                                    dtype, 60)
    kw = dict(k=k, nl_y=ny, coeff=p.a2tau2, inv_h2=p.inv_h2,
              c2tau2_ext=fld if with_field else None,
              c2_ghosts=fg if with_field else None, with_errors=with_errors)
    args = (up, u, (gh[0], gh[1]), (gh[2], gh[3]), *planes, sxct, y0, n)
    name = "kstep_sharded_xy_field" if with_field else "kstep_sharded_xy"
    before = stencil_cuda.launches[name]
    got = stencil_cuda.fused_kstep_sharded_xy(*args, **kw)
    assert stencil_cuda.launches[name] == before + 1
    assert got[1].shape == (d, ny, n)
    equal(got, stencil_cuda.fused_kstep_sharded_xy_plain(*args, **kw))


# (D, N, k, block_x) of K11 and (D, N, k, block_x, nl_y, y0) of K12.  The
# pipeline's stress cases follow the first rows: deep slabs (block_x = 64,
# = D, two slabs of two x segments), the shallowest (block_x = k), k = 1,
# 3 and 8, y/z faces that do not divide N, and nl_y = k for K12.
K11_CASES = [(8, 16, 1, 8), (8, 16, 2, 4), (16, 32, 4, 8), (12, 12, 3, 12),
             (16, 64, 8, 8), (10, 40, 5, 10), (14, 42, 7, 14), (12, 36, 6, 12),
             (64, 64, 4, 64), (128, 128, 4, 64), (16, 20, 4, 4),
             (64, 64, 1, 64), (64, 66, 8, 64), (48, 50, 3, 48),
             (24, 30, 2, 2)]
K12_CASES = [(8, 16, 1, 8, 8, 8), (8, 16, 4, 8, 4, 12), (16, 32, 4, 8, 8, 0),
             (12, 24, 3, 12, 6, 18), (16, 48, 8, 8, 8, 40),
             (10, 40, 5, 10, 10, 30), (14, 28, 7, 14, 7, 0),
             (64, 64, 4, 64, 32, 32), (64, 64, 4, 64, 4, 60),
             (64, 66, 8, 64, 8, 0), (48, 50, 3, 48, 25, 25),
             (64, 64, 1, 64, 16, 48), (16, 20, 4, 4, 10, 10)]


def comp_case(cuda, d, n, k, ny, y0, mode, with_field, whole, seed=70):
    v_dt, c_dt = MODES[mode]
    p, planes, sxct, (u, v), gh, fld, fg = xy_case(cuda, d, n, k, ny, y0,
                                                   torch.float32, seed,
                                                   whole)
    v = (1e-3 * v).to(v_dt)
    c = (None if c_dt is None
         else (1e-8 * rand((d, ny, n), seed + 40)).to(cuda, c_dt))
    vg = tuple((1e-3 * g).to(v_dt) for g in gh[2:])
    return p, (u, v, c, (gh[0], gh[1]), vg, *planes, sxct), dict(
        k=k, coeff=p.a2tau2, inv_h2=p.inv_h2,
        c2_ghosts=fg if with_field else None), fld if with_field else None


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d,n,k,bx", K11_CASES)
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_k11(cuda, d, n, k, bx, mode, with_field, with_errors):
    p, args, kw, fld = comp_case(cuda, d, n, k, n, 0, mode, with_field, True)
    kw.update(block_x=bx, with_errors=with_errors, c2tau2_block=fld)
    name = "kstep_comp_sharded_field" if with_field else "kstep_comp_sharded"
    before = stencil_cuda.launches[name]
    got = stencil_cuda.fused_kstep_comp_sharded(*args, **kw)
    assert stencil_cuda.launches[name] == before + 1
    equal(got, stencil_cuda.fused_kstep_comp_sharded_plain(*args, **kw))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d,n,k,bx,ny,y0", K12_CASES)
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("with_errors", [True, False], ids=["rows", "norows"])
def test_k12(cuda, d, n, k, bx, ny, y0, mode, with_field, with_errors):
    p, args, kw, fld = comp_case(cuda, d, n, k, ny, y0, mode, with_field,
                                 False)
    kw.update(block_x=bx, with_errors=with_errors, c2tau2_ext=fld, nl_y=ny)
    name = ("kstep_comp_sharded_xy_field" if with_field
            else "kstep_comp_sharded_xy")
    before = stencil_cuda.launches[name]
    got = stencil_cuda.fused_kstep_comp_sharded_xy(*args, y0, n, **kw)
    assert stencil_cuda.launches[name] == before + 1
    assert got[0].shape == (d, ny, n)
    equal(got, stencil_cuda.fused_kstep_comp_sharded_xy_plain(*args, y0, n,
                                                              **kw))


# (seg, ty, tz) tiles of K11/K12's pipeline beside comp_pipe_tile's: the
# results do not depend on the tile.
PIPE_TILES = [(64, 24, 24), (16, 10, 12), (8, 3, 5), (1, 1, 1), (4, 24, 8),
              (32, 7, 24)]


@pytest.mark.parametrize("tile", PIPE_TILES)
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kernel", ["K11", "K12"])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_k11_k12_pipeline_tiles(cuda, tile, mode, kernel, with_field):
    d, n, k, bx = 64, 64, 4, 64
    whole = kernel == "K11"
    ny, y0 = (n, 0) if whole else (20, 44)
    p, args, kw, fld = comp_case(cuda, d, n, k, ny, y0, mode, with_field,
                                 whole)
    kw.update(block_x=bx, with_errors=True, c2tau2_block=fld,
              y0=y0, nl_y=None if whole else ny)
    got = stencil_cuda._comp_chain("kstep_comp_sharded", *args, tile=tile,
                                   **kw)
    equal(got, stencil_cuda._comp_chain_plain(*args, **kw))


def test_k10_k12_error_rows_propagate_nan(cuda):
    p, planes, sxct, (up, u), gh, _, _ = xy_case(cuda, 8, 16, 2, 8, 8,
                                                 torch.float32, 80)
    u[5, 5, 3] = float("nan")  # a central cell (extended row 5 = row 3)
    kw = dict(k=2, nl_y=8, coeff=p.a2tau2, inv_h2=p.inv_h2)
    out = stencil_cuda.fused_kstep_sharded_xy(
        up, u, (gh[0], gh[1]), (gh[2], gh[3]), *planes, sxct, 8, 16, **kw)
    assert torch.isnan(out[2][0, 5]) and torch.isnan(out[3][0, 5])
    out = stencil_cuda.fused_kstep_comp_sharded_xy(
        u, torch.zeros_like(u), None, (gh[0], gh[1]),
        tuple(torch.zeros_like(g) for g in gh[2:]), *planes, sxct, 8, 16,
        block_x=8, **kw)
    assert torch.isnan(out[3][0, 5]) and torch.isnan(out[4][0, 5])


def test_xy_and_comp_kernels_never_fall_back(cuda):
    p, planes, sxct, (up, u), gh, fld, fg = xy_case(cuda, 8, 16, 2, 8, 8,
                                                    torch.float32, 90)
    kw = dict(k=2, nl_y=8, coeff=p.a2tau2, inv_h2=p.inv_h2)
    win = ((gh[0], gh[1]), (gh[2], gh[3]))
    with pytest.raises(ValueError):  # K10 takes no f64
        stencil_cuda.fused_kstep_sharded_xy(
            up.double(), u.double(), *[tuple(g.double() for g in w)
                                       for w in win], *planes, sxct, 8, 16,
            **kw)
    with pytest.raises(ValueError):  # a window on the CPU
        stencil_cuda.fused_kstep_sharded_xy(
            up, u, (gh[0].cpu(), gh[1]), win[1], *planes, sxct, 8, 16, **kw)
    with pytest.raises(ValueError):  # an extension that is not 2k rows
        stencil_cuda.fused_kstep_sharded_xy(
            up, u, *win, *planes, sxct, 8, 16, **dict(kw, nl_y=10))
    with pytest.raises(ValueError):  # K12's carry must be the central rows
        stencil_cuda.fused_kstep_comp_sharded_xy(
            u, u, u, *win, *planes, sxct, 8, 16, block_x=8, **kw)
    with pytest.raises(ValueError):  # K11 takes no bf16 u
        b = u.to(torch.bfloat16)
        stencil_cuda.fused_kstep_comp_sharded(
            b, b, None, (gh[0], gh[1]), (gh[0], gh[1]), None, None, None,
            k=2, coeff=1.0, inv_h2=p.inv_h2, with_errors=False)


@pytest.mark.parametrize("mesh", [(2, 2, 1), (1, 2, 1), (2, 4, 1),
                                  (4, 2, 1)])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_sharded_kfused_xy_on_one_card_equals_single_device(cuda, mesh,
                                                            with_field):
    p = Problem(N=16, timesteps=13)
    kw = {}
    if with_field:
        kw = dict(compute_errors=False, c2tau2_field=stencil_ref.
                  make_preset_c2tau2_field(p, "gaussian-lens"))
    stencil_cuda.reset_launches()
    a = sharded_kfused.solve_sharded_kfused(p, mesh_shape=mesh, k=4,
                                            devices=[cuda] * 8, **kw)
    name = "kstep_sharded_xy_field" if with_field else "kstep_sharded_xy"
    assert stencil_cuda.launches[name] == mesh[0] * mesh[1] * 4
    b = kfused.solve_kfused(p, k=4, device=cuda, **kw)
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.u_prev.fundamental(), b.u_prev)


@pytest.mark.parametrize("mesh", [(1, 1, 1), (2, 1, 1), (4, 1, 1),
                                  (2, 2, 1), (2, 4, 1)])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_sharded_flagship_on_one_card(cuda, mesh, with_field):
    # MY = 1 (K11) runs K4's op sequence at one block_x: bitwise; MY > 1
    # (K12) zero-seeds the carry on the y ghost rows too: within 1e-6.
    p = Problem(N=16, timesteps=13)
    kw = {}
    if with_field:
        kw = dict(compute_errors=False, c2tau2_field=stencil_ref.
                  make_preset_c2tau2_field(p, "gaussian-lens"))
    stencil_cuda.reset_launches()
    a = kfused_comp.solve_kfused_comp_sharded(p, mesh_shape=mesh, k=4,
                                              block_x=4,
                                              devices=[cuda] * 8, **kw)
    name = "kstep_comp_sharded" + ("_xy" if mesh[1] > 1 else "") + (
        "_field" if with_field else "")
    assert stencil_cuda.launches[name] == mesh[0] * mesh[1] * 4
    b = kfused_comp.solve_kfused_comp(p, k=4, block_x=4, device=cuda, **kw)
    if mesh[1] == 1:
        assert torch.equal(a.u_cur.fundamental(), b.u_cur)
        assert torch.equal(a.comp_carry.fundamental(), b.comp_carry)
    assert (a.u_cur.fundamental() - b.u_cur).abs().max().item() < 1e-6


@pytest.mark.parametrize("solver", ["kfused_xy", "flagship_x",
                                    "flagship_xy", "flagship_bf16"])
def test_sharded_kfused_solvers_card_vs_cpu(cuda, solver):
    p = Problem(N=16, timesteps=11)
    run = {
        "kfused_xy": lambda d: sharded_kfused.solve_sharded_kfused(
            p, mesh_shape=(2, 2, 1), k=4, devices=[d] * 4),
        "flagship_x": lambda d: kfused_comp.solve_kfused_comp_sharded(
            p, n_shards=4, k=4, devices=[d] * 4),
        "flagship_xy": lambda d: kfused_comp.solve_kfused_comp_sharded(
            p, mesh_shape=(2, 2, 1), k=4, devices=[d] * 4),
        "flagship_bf16": lambda d: kfused_comp.solve_kfused_comp_sharded(
            p, mesh_shape=(2, 2, 1), k=4, devices=[d] * 4,
            v_dtype=torch.bfloat16, carry=False),
    }[solver]
    gpu, cpu = run(cuda), run("cpu")
    d = (gpu.u_cur.fundamental().cpu() - cpu.u_cur.fundamental()).abs()
    assert d.max().item() <= 1e-5
    assert np.max(np.abs(gpu.abs_errors - cpu.abs_errors)) <= 1e-5


def test_mesh_larger_than_the_cards_exits_2(cuda, capsys):
    n_cards = torch.cuda.device_count()
    assert cli.main(["16", "1", "1", "1", "1", "--mesh",
                     f"{n_cards + 1},1,1"]) == 2
    assert "visible" in capsys.readouterr().err


# The measurement slice: --overlap (side streams), the phase-timing
# probes, the allocator read, and the profiler's view of the kernels.


@pytest.mark.parametrize("mesh", [(2, 2, 1), (2, 2, 2), (4, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_overlap_equals_serial_on_one_card(cuda, mesh, dtype, with_field):
    p = Problem(N=32, timesteps=12)
    kw = {}
    if with_field:
        kw = dict(c2tau2_field=stencil_ref.make_preset_c2tau2_field(
            p, "gaussian-lens"), compute_errors=False)
    devs = [cuda] * (mesh[0] * mesh[1] * mesh[2])
    ser = sharded.solve_sharded(p, mesh, devs, dtype=dtype, **kw)
    stencil_cuda.reset_launches()
    ovl = sharded.solve_sharded(p, mesh, devs, dtype=dtype, overlap=True,
                                **kw)
    # One K6 launch per block and one per face plane of each multi-shard
    # axis (blocks of 16 or more planes: two faces per axis) per step.
    counter = "sharded_step_field" if with_field else "sharded_step"
    faces = 2 * sum(m > 1 for m in mesh)
    assert stencil_cuda.launches[counter] == \
        len(devs) * p.timesteps * (1 + faces)
    for a, b in ((ser.u_cur, ovl.u_cur), (ser.u_prev, ovl.u_prev)):
        assert torch.equal(a.assemble(cuda), b.assemble(cuda))
    assert np.array_equal(ser.abs_errors, ovl.abs_errors)
    assert np.array_equal(ser.rel_errors, ovl.rel_errors)


@pytest.mark.parametrize("mesh", [(2, 2, 1), (2, 2, 2), (4, 1, 1)])
@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
def test_overlap_equals_serial_across_cards(cuda, mesh, with_field):
    """The shards dealt round the visible cards: every ghost copy between
    cards goes on its sender's and receiver's side streams."""
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        pytest.skip("needs two or more CUDA devices")
    p = Problem(N=32, timesteps=12)
    kw = {}
    if with_field:
        kw = dict(c2tau2_field=stencil_ref.make_preset_c2tau2_field(
            p, "gaussian-lens"), compute_errors=False)
    devs = [torch.device("cuda", i % n_cards)
            for i in range(mesh[0] * mesh[1] * mesh[2])]
    ser = sharded.solve_sharded(p, mesh, devs, **kw)
    ovl = sharded.solve_sharded(p, mesh, devs, overlap=True, **kw)
    for a, b in ((ser.u_cur, ovl.u_cur), (ser.u_prev, ovl.u_prev)):
        assert torch.equal(a.assemble(cuda), b.assemble(cuda))
    assert np.array_equal(ser.abs_errors, ovl.abs_errors)
    assert np.array_equal(ser.rel_errors, ovl.rel_errors)


@pytest.mark.parametrize("kw", [
    dict(mesh_shape=(2, 2, 1)),
    dict(mesh_shape=(2, 2, 1), overlap=True),
    dict(mesh_shape=(1, 1, 1), kernel="roll"),
    dict(mesh_shape=(4, 1, 1), fuse_steps=4),
    dict(mesh_shape=(2, 2, 1), fuse_steps=4),
    dict(mesh_shape=(4, 1, 1), fuse_steps=4, scheme="compensated"),
    dict(mesh_shape=(2, 2, 1), fuse_steps=4, scheme="compensated"),
], ids=["1step", "overlap", "roll", "kfused", "kfused-xy", "flagship",
        "flagship-xy"])
def test_phase_probes_time_the_card(cuda, kw):
    from wavetpu_torch.solver import timing

    n = kw["mesh_shape"][0] * kw["mesh_shape"][1]
    pb = timing.measure_phase_breakdown(
        Problem(N=64, timesteps=40), devices=[cuda] * n, iters=3,
        repeats=2, **kw)
    assert np.isfinite(pb.loop_seconds) and pb.loop_seconds > 0
    assert np.isfinite(pb.exchange_seconds) and pb.exchange_seconds >= 0


def test_kernel_roll_equals_pallas_on_the_card(cuda, tmp_path, capsys):
    for kernel in ("roll", "pallas"):
        assert cli.main(["32", "1", "1", "1", "1", "1", "20", "--kernel",
                         kernel, "--out-dir", str(tmp_path / kernel)]) == 0
    capsys.readouterr()
    p = Problem(N=32, timesteps=20)
    a = leapfrog.solve(p, device=cuda, kernel="roll")
    stencil_cuda.reset_launches()
    b = leapfrog.solve(p, device=cuda)
    assert stencil_cuda.launches["step"] == 20
    assert torch.equal(a.u_cur, b.u_cur) and torch.equal(a.u_prev, b.u_prev)
    assert np.array_equal(a.abs_errors, b.abs_errors)


def test_memory_snapshot_reads_the_card(cuda):
    from wavetpu_torch.obs import perf

    perf.set_memory_stats_provider(None)
    keep = torch.empty(1 << 20, device=cuda)
    snap = perf.memory_snapshot()
    assert snap is not None and snap["bytes_in_use"] >= keep.numel() * 4
    assert snap["peak_bytes"] >= snap["bytes_in_use"]
    assert snap["peak_bytes"] < torch.cuda.get_device_properties(
        cuda).total_memory


def test_profiler_sees_the_kernels(cuda, tmp_path):
    from wavetpu_torch.obs import perf

    p = Problem(N=32, timesteps=9)
    leapfrog.solve(p, device=cuda)  # build and first launches
    with torch.profiler.profile(
            activities=perf.profiler_activities()) as prof:
        kfused_comp.solve_kfused_comp(p, k=4, device=cuda)
    ops = perf.export_profile(prof, str(tmp_path))
    names = {o["name"]: o for o in perf.top_device_ops(prof, 1000)}
    k4 = [o for n, o in names.items() if "kstep_comp_pipe_kernel" in n]
    assert sum(o["count"] for o in k4) == 2  # 2 blocks at k=4, 0 tail
    assert all(o["device_ms"] > 0 for o in k4)
    assert ops and (tmp_path / perf.TRACE_FILENAME).exists()


# Checkpoints and supervision on the card (ROADMAP.md queue 1 items 8, 9):
# the resumed and the supervised chunked marches on the card equal the
# uninterrupted march on the card bit for bit, and the same marches on the
# CPU (the plain versions) within 1e-5.

RESILIENCE_PATHS = {
    "K1": dict(),
    "K3": dict(fuse_steps=4),
    "K4": dict(scheme="compensated", fuse_steps=4),
    "K6": dict(backend="sharded", mesh_shape=(2, 2, 1)),
    "K10": dict(backend="sharded", fuse_steps=4, mesh_shape=(2, 2, 1)),
    "K12": dict(backend="sharded", scheme="compensated", fuse_steps=4,
                mesh_shape=(2, 2, 1)),
}


def _fundamental(a):
    return (a.fundamental("cpu") if hasattr(a, "blocks") else a).cpu()


@pytest.mark.parametrize("path", list(RESILIENCE_PATHS))
def test_resume_and_supervised_on_the_card(cuda, tmp_path, path):
    from wavetpu_torch.io import checkpoint
    from wavetpu_torch.run import faults
    from wavetpu_torch.run import supervisor as sup

    p = Problem(N=32, timesteps=30)
    kw = RESILIENCE_PATHS[path]
    n_dev = 4 if kw.get("backend") == "sharded" else 1
    results = {}
    for dev in ("cuda", "cpu"):
        spec = sup.PathSpec(devices=(dev,) * n_dev,
                            kernel="pallas" if dev == "cuda" else "roll",
                            **kw)
        opts = sup.SupervisorOptions(
            ckpt_every=8, ckpt_dir=str(tmp_path / f"{dev}-rot"),
            chunk_hook=faults.preempt_at_step(13))
        pre = sup.supervise(p, spec, opts)
        assert pre.status == "preempted" and pre.final_step == 17
        state, step = sup._Path(p, spec).load(pre.checkpoint_path)
        opts = sup.SupervisorOptions(ckpt_every=8,
                                     ckpt_dir=str(tmp_path / f"{dev}-rot"))
        resumed = sup.supervise(p, spec, opts, state=state, start_step=step)
        plain = sup.supervise(p, spec, sup.SupervisorOptions(
            ckpt_every=10**6, ckpt_dir=str(tmp_path / f"{dev}-one")))
        assert plain.checkpoints_written == 1     # one chunk: unsupervised
        for r in (resumed, plain):
            assert r.status == "complete"
        assert torch.equal(_fundamental(resumed.result.u_cur),
                           _fundamental(plain.result.u_cur))
        np.testing.assert_array_equal(resumed.result.abs_errors[18:],
                                      plain.result.abs_errors[18:])
        results[dev] = plain.result
        if kw.get("backend") != "sharded":
            assert os.path.exists(checkpoint.save_checkpoint(
                str(tmp_path / f"{dev}.npz"), plain.result))
    d = (_fundamental(results["cuda"].u_cur).double()
         - _fundamental(results["cpu"].u_cur).double()).abs().max().item()
    assert d <= 1e-5, d


@pytest.mark.parametrize("n,n_shards", [(30, 1), (26, 4)])
def test_uneven_chunk_runner_keeps_the_state_on_the_card(cuda, monkeypatch,
                                                         n, n_shards):
    """The K9 route's chunk runner re-cuts the Topology layout into the
    pad-and-mask blocks and back on the card (no state passes through the
    host), and its chunks equal the uninterrupted march bit for bit."""
    from wavetpu_torch.core.grid import ShardedArray

    p = Problem(N=n, timesteps=17)       # K9's pad and mask: D != N / MX
    kw = dict(n_shards=n_shards, k=4, devices=["cuda"] * n_shards)
    whole = sharded_kfused.solve_sharded_kfused(p, **kw)
    half = sharded_kfused.solve_sharded_kfused(p, stop_step=9, **kw)
    seen = []
    assemble = ShardedArray.assemble

    def spy(self, device=None):
        seen.append(torch.device(device or self.blocks[0].device))
        return assemble(self, device)

    monkeypatch.setattr(ShardedArray, "assemble", spy)
    run = sharded_kfused.make_chunk_runner(p, 4, **kw)
    prev, cur, start = half.u_prev, half.u_cur, 9
    while start < p.timesteps:
        prev, cur, _, _ = run(prev, cur, start)
        start += 4
    assert seen and all(dv.type == "cuda" for dv in seen), seen
    assert all(b.device.type == "cuda" for b in prev.blocks + cur.blocks)
    monkeypatch.undo()
    for got, want in ((prev, whole.u_prev), (cur, whole.u_cur)):
        assert torch.equal(got.assemble("cpu"), want.assemble("cpu"))


def test_health_guard_on_the_card_equals_the_cpu(cuda):
    from wavetpu_torch.core.grid import Topology, build_mesh, split_global
    from wavetpu_torch.run import health

    for dt in (torch.float32, torch.bfloat16, torch.float64):
        a = field(24, 7, dtype=dt)
        for poison in (None, float("nan"), float("inf"), -float("inf")):
            b = a.clone()
            if poison is not None:
                b[3, 4, 5] = poison
            assert health.guarded_amax(b.to(cuda)) == health.guarded_amax(b)
    topo = Topology(N=24, mesh_shape=(2, 2, 1))
    g = torch.zeros(topo.padded)
    g[13, 2, 3] = -5.5
    on_card = split_global(g, topo, build_mesh((2, 2, 1), ["cuda"] * 4))
    assert health.guarded_amax(on_card) == 5.5


def test_checkpoint_writer_is_native_and_loads_onto_the_card(cuda, tmp_path):
    from wavetpu_torch.io import checkpoint, nativeio

    assert nativeio.native_available()
    p = Problem(N=32, timesteps=8)
    res = sharded.solve_sharded(p, (2, 2, 1), ["cuda"] * 4, stop_step=4)
    d = str(tmp_path / "ck")
    checkpoint.save_sharded_checkpoint(d, res)
    _, _, u_cur, step, _, _, _ = checkpoint.load_sharded_checkpoint(
        d, ["cuda"] * 4)
    assert step == 4 and all(b.device.type == "cuda" for b in u_cur.blocks)
    assert torch.equal(u_cur.assemble("cpu"), res.u_cur.assemble("cpu"))


# ---------------------------------------------------------------------------
# The lane modes (the ensembles' batch axis): each against its plain version
# (the solo plain version lane by lane) and, lane by lane, against the solo
# kernel on that lane's state - bitwise; over the whole batch and over a
# live prefix (a contiguous view of its first lanes).

LANES = 3


def batch(n, seed, lanes=LANES, scale=1.0, dtype=torch.float32):
    return torch.stack([field(n, seed + i, scale, dtype)
                        for i in range(lanes)])


def lane_fields(p, seed, lanes=LANES):
    return torch.stack([c2_field(p, seed + i) for i in range(lanes)])


def per_lane(solo, *batches, live):
    """The solo launch on each of the first `live` lanes, stacked output
    by output."""
    outs = [solo(*(None if b is None else b[i] for b in batches))
            for i in range(live)]
    if isinstance(outs[0], torch.Tensor):
        return [torch.stack(outs)]
    return [None if o[0] is None else torch.stack(o) for o in zip(*outs)]


@pytest.mark.parametrize("n", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["K1", "K5"])
@pytest.mark.parametrize("live", [LANES, 2])
def test_k1_k5_lanes(cuda, n, dtype, with_field, live):
    p = Problem(N=n, timesteps=10)
    up = batch(n, 1, dtype=dtype).to(cuda)[:live]
    u = batch(n, 11, dtype=dtype).to(cuda)[:live]
    f = stencil_ref.compute_dtype(dtype)
    fld = lane_fields(p, 21).to(cuda, f)[:live] if with_field else None
    kw = dict(inv_h2=p.inv_h2, alpha=2.0, beta=1.0, coeff=p.a2tau2)
    name = "var_step_lanes" if with_field else "step_lanes"
    before = dict(stencil_cuda.launches)
    got = stencil_cuda.fused_step_lanes(up, u, c2tau2_field=fld, **kw)
    assert stencil_cuda.launches[name] == before[name] + 1
    equal([got], [stencil_cuda.fused_step_lanes_plain(
        up, u, c2tau2_field=fld, **kw)])
    equal([got], per_lane(lambda a, b, c: stencil_cuda.fused_step(
        a, b, c2tau2_field=c, **kw), up, u, fld, live=live))


@pytest.mark.parametrize("n", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("live", [LANES, 1])
def test_k2_lanes(cuda, n, dtype, live):
    p = Problem(N=n, timesteps=10)
    u, v, c = (batch(n, s, scale=w, dtype=dtype).to(cuda)[:live]
               for s, w in ((3, 1.0), (13, 1e-3), (23, 1e-8)))
    z = torch.zeros_like(u)
    for args in ((u, v, c, None), (u, z, z, 0.5 * p.a2tau2)):
        before = stencil_cuda.launches["comp_step_lanes"]
        got = stencil_cuda.compensated_step_lanes(*args[:3], p, args[3])
        assert stencil_cuda.launches["comp_step_lanes"] == before + 1
        co = p.a2tau2 if args[3] is None else args[3]
        equal(got, stencil_cuda.compensated_step_lanes_plain(
            *args[:3], inv_h2=p.inv_h2, coeff=co))
        equal(got, per_lane(lambda a, b, cc: stencil_cuda.compensated_step(
            a, b, cc, p, co), *args[:3], live=live))


def lane_sxct(n, k, lanes=LANES):
    """Per-lane (k, N) oracle rows: lane i's time factors from phase i."""
    p = Problem(N=n, timesteps=20)
    rows = []
    for i in range(lanes):
        sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(
            p, torch.float32, "cpu", 0.3 * i + 1.0)
        rows.append(ct[2:2 + k, None] * sx[None, :])
    return syz, rsyz, torch.stack(rows)


@pytest.mark.parametrize("n,k", [(32, 2), (32, 4), (128, 4), (64, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_field", [False, True], ids=["K3", "K3f"])
@pytest.mark.parametrize("with_errors", [True, False])
@pytest.mark.parametrize("live", [LANES, 2])
def test_k3_lanes(cuda, n, k, dtype, with_field, with_errors, live):
    p = Problem(N=n, timesteps=20)
    up = batch(n, 1, dtype=dtype).to(cuda)[:live]
    u = batch(n, 11, dtype=dtype).to(cuda)[:live]
    fld = lane_fields(p, 21).to(cuda)[:live] if with_field else None
    syz, rsyz, sxct = (t.to(cuda) for t in lane_sxct(n, k))
    sxct = sxct[:live]
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors)
    name = "kstep_field_lanes" if with_field else "kstep_lanes"
    before = stencil_cuda.launches[name]
    got = stencil_cuda.fused_kstep_lanes(up, u, syz, rsyz, sxct,
                                         c2tau2_field=fld, **kw)
    assert stencil_cuda.launches[name] == before + 1
    equal(got, stencil_cuda.fused_kstep_lanes_plain(
        up, u, syz, rsyz, sxct, c2tau2_field=fld, **kw))
    equal(got, per_lane(lambda a, b, s, c: stencil_cuda.fused_kstep(
        a, b, syz, rsyz, s, c2tau2_field=c, **kw), up, u, sxct, fld,
        live=live))


@pytest.mark.parametrize("n,k", [(32, 4), (128, 4), (128, 1), (64, 8),
                                 (48, 3)])
@pytest.mark.parametrize("with_errors", [True, False])
@pytest.mark.parametrize("live", [LANES, 2])
def test_k4_lanes(cuda, n, k, with_errors, live):
    """The flagship's storage (f32 u and v, bf16 carry): the compensated
    ensemble's only form, the lane mode's only instantiation."""
    p = Problem(N=n, timesteps=20)
    u = batch(n, 3).to(cuda)[:live]
    v = batch(n, 13, scale=1e-3).to(cuda)[:live]
    c = batch(n, 23, scale=1e-8).to(cuda, torch.bfloat16)[:live]
    syz, rsyz, sxct = (t.to(cuda) for t in lane_sxct(n, k))
    sxct = sxct[:live]
    kw = dict(k=k, coeff=p.a2tau2, inv_h2=p.inv_h2, with_errors=with_errors,
              block_x=stencil_cuda.default_block_x(n, k))
    before = stencil_cuda.launches["kstep_comp_lanes"]
    got = stencil_cuda.fused_kstep_comp_lanes(u, v, c, syz, rsyz, sxct,
                                              **kw)
    assert stencil_cuda.launches["kstep_comp_lanes"] == before + 1
    equal(got, stencil_cuda.fused_kstep_comp_lanes_plain(
        u, v, c, syz, rsyz, sxct, **kw))
    equal(got, per_lane(lambda a, b, cc, s: stencil_cuda.fused_kstep_comp(
        a, b, cc, syz, rsyz, s, **kw), u, v, c, sxct, live=live))


def lane_ghosts(shape, seed, dtype, cuda, lanes=LANES):
    """(lanes, face) ghosts: lane i's are ghosts_of(shape, seed + 10 i)."""
    per = [ghosts_of(shape, seed + 10 * i, dtype, cuda) for i in range(lanes)]
    return [tuple(torch.stack([per[i][a][j] for i in range(lanes)])
                  for j in range(2)) for a in range(3)]


@pytest.mark.parametrize("mesh,n,shape,r_last,offsets", K6_BLOCKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_k6_lanes(cuda, mesh, n, shape, r_last, offsets, dtype):
    p = Problem(N=n, timesteps=10)
    up = torch.stack([rand(shape, 1 + i, dtype) for i in range(LANES)])
    u = torch.stack([rand(shape, 11 + i, dtype) for i in range(LANES)])
    up, u = up.to(cuda), u.to(cuda)
    g = lane_ghosts(shape, 3, dtype, cuda)
    kw = dict(inv_h2=p.inv_h2, mesh_shape=mesh, r_last=r_last,
              coeff=p.a2tau2)
    for live in (LANES, 2):
        gl = [tuple(x[:live].contiguous() for x in a) for a in g]
        before = stencil_cuda.launches["sharded_step_lanes"]
        got = stencil_cuda.sharded_fused_step_lanes(up[:live], u[:live], gl,
                                                    offsets, n, **kw)
        assert stencil_cuda.launches["sharded_step_lanes"] == before + 1
        equal([got], [stencil_cuda.sharded_fused_step_lanes_plain(
            up[:live], u[:live], gl, offsets, n, **kw)])
        equal([got], [torch.stack([stencil_cuda.sharded_fused_step(
            up[i], u[i], [tuple(x[i] for x in a) for a in g], offsets, n,
            **kw) for i in range(live)])])


def test_lane_modes_refuse_what_they_do_not_take(cuda):
    """lanes x N x planes past the grid's z extent, and a K4 storage other
    than the flagship's, raise before any launch."""
    u = torch.zeros((2, 8, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="grid"):
        stencil_cuda._lanes_of("K1/K5 lanes", u, 40000)
    assert stencil_cuda._lanes_of("K1/K5 lanes", u, 8) == 2
    p = Problem(N=8, timesteps=10)
    syz, rsyz, sxct = (t.to(cuda) for t in lane_sxct(8, 4, 2))
    before = dict(stencil_cuda.launches)
    for v_dt, c_dt in ((torch.float32, torch.float32),
                       (torch.bfloat16, None)):
        c = None if c_dt is None else torch.zeros_like(u, dtype=c_dt)
        with pytest.raises(ValueError, match="bf16 carry"):
            stencil_cuda.fused_kstep_comp_lanes(
                u, u.to(v_dt), c, syz, rsyz, sxct, k=4, coeff=p.a2tau2,
                inv_h2=p.inv_h2)
    assert stencil_cuda.launches == before


@pytest.mark.parametrize("scheme,path", [
    ("standard", "roll"), ("standard", "pallas"), ("standard", "kfused"),
    ("compensated", "roll"), ("compensated", "pallas"),
    ("compensated", "kfused")])
def test_ensemble_lanes_equal_solo_on_card(cuda, scheme, path):
    """Every lane of a batched march on the card equals the solo port
    solve of that lane, states and error vectors; one lane launch per
    layer or k-block."""
    from wavetpu_torch.ensemble import batched
    p = Problem(N=32, timesteps=17)
    lanes = [batched.LaneSpec(), batched.LaneSpec(phase=1.0),
             batched.LaneSpec(phase=0.5, stop_step=9)]
    stencil_cuda.reset_launches()
    res = batched.solve_ensemble(p, lanes, scheme=scheme, path=path,
                                 pad_to=4)
    counts = dict(stencil_cuda.launches)
    assert res.batched and res.fallback_reason is None
    solo_launches = {k: v for k, v in counts.items()
                     if not k.endswith("_lanes")}
    assert not any(solo_launches.values()), solo_launches
    if path == "kfused":
        name = ("kstep_comp_lanes" if scheme == "compensated"
                else "kstep_lanes")
        assert counts[name] == 4  # (17 - 1) / 4 blocks
    for lane, got in zip(lanes, res.results):
        kw = dict(stop_step=lane.stop(p), phase=lane.phase)
        kernel = "roll" if path == "roll" else "pallas"
        if scheme == "compensated" and path == "kfused":
            want = kfused_comp.solve_kfused_comp(p, k=4, **kw)
        elif scheme == "compensated":
            want = leapfrog.solve_compensated(p, kernel=kernel, **kw)
        elif path == "kfused":
            want = kfused.solve_kfused(p, k=4, **kw)
        else:
            want = leapfrog.solve(p, kernel=kernel, **kw)
        assert torch.equal(got.u_cur, want.u_cur)
        assert torch.equal(got.u_prev, want.u_prev)
        assert np.array_equal(got.abs_errors, want.abs_errors)
        assert np.array_equal(got.rel_errors, want.rel_errors)


@pytest.mark.parametrize("path", ["pallas", "kfused"])
def test_field_ensemble_lanes_equal_solo_on_card(cuda, path):
    from wavetpu_torch.ensemble import batched
    p = Problem(N=32, timesteps=13)
    lens = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
    lanes = [batched.LaneSpec(c2tau2_field=lens),
             batched.LaneSpec(stop_step=5)]
    res = batched.solve_ensemble(p, lanes, path=path, compute_errors=False)
    for lane, got in zip(batched.fill_fields(p, lanes), res.results):
        kw = dict(stop_step=lane.stop(p), compute_errors=False,
                  c2tau2_field=lane.c2tau2_field)
        want = (kfused.solve_kfused(p, k=4, **kw) if path == "kfused"
                else leapfrog.solve(p, **kw))
        assert torch.equal(got.u_cur, want.u_cur)
        assert torch.equal(got.u_prev, want.u_prev)


@pytest.mark.parametrize("mesh", [(2, 2, 1), (2, 1, 1), (4, 1, 1)])
def test_sharded_ensemble_lanes_equal_solo_on_card(cuda, mesh):
    from wavetpu_torch.ensemble import batched, sharded as esh
    p = Problem(N=30, timesteps=9)
    lanes = [batched.LaneSpec(), batched.LaneSpec(phase=1.0),
             batched.LaneSpec(phase=0.5, stop_step=5)]
    stencil_cuda.reset_launches()
    res = esh.solve_ensemble_sharded(p, lanes, mesh, kernel="pallas",
                                     devices=["cuda"] * 4, pad_to=4)
    n_shards = mesh[0] * mesh[1] * mesh[2]
    # Bootstrap + 8 layers, one lane launch per shard each.
    assert stencil_cuda.launches["sharded_step_lanes"] == 9 * n_shards
    for lane, got in zip(lanes, res.results):
        want = sharded.solve_sharded(p, mesh, devices=["cuda"] * 4,
                                     stop_step=lane.stop(p),
                                     phase=lane.phase)
        assert torch.equal(got.u_cur.fundamental(), want.u_cur.fundamental())
        assert torch.equal(got.u_prev.fundamental(),
                           want.u_prev.fundamental())
        assert np.array_equal(got.abs_errors, want.abs_errors)
        assert np.array_equal(got.rel_errors, want.rel_errors)


# ---- the serving replica on the card ----


@pytest.mark.parametrize("body", [
    {"N": 64, "timesteps": 40, "scheme": "compensated", "fuse_steps": 4},
    {"N": 64, "timesteps": 40},
], ids=["flagship", "pallas"])
def test_replica_batch_equals_solve_ensemble_on_card(cuda, body):
    """Two concurrent /solve requests through `build_server` on the card
    coalesce into one batch (kernel auto -> the lane modes); each answer's
    error vectors are bit for bit its lane of `solve_ensemble`."""
    import json
    import threading
    import urllib.request

    from wavetpu_torch.ensemble import batched as eb
    from wavetpu_torch.serve.api import build_server

    httpd, state = build_server(port=0, max_wait=0.5, device=cuda)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [dict(body, phase=1.0), dict(body, steps=25)]
    out = [None, None]

    def post(i):
        req = urllib.request.Request(
            base + "/solve", data=json.dumps(bodies[i]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            out[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
    finally:
        httpd.shutdown()
        state.batcher.close()
        httpd.server_close()
    assert all(o["batch"]["occupancy"] == 2 and o["batch"]["batched"]
               for o in out)
    kw = (dict(scheme="compensated", path="kfused", k=4)
          if "scheme" in body else dict(path="pallas"))
    p = Problem(N=64, timesteps=40)
    ens = eb.solve_ensemble(
        p, [eb.LaneSpec(phase=1.0), eb.LaneSpec(stop_step=25)],
        pad_to=2, **kw)
    for res, ref in zip(out, ens.results):
        assert np.array_equal(res["report"]["abs_errors"], ref.abs_errors)
        assert np.array_equal(res["report"]["rel_errors"], ref.rel_errors)
