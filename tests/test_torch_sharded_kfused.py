"""The port's x-sharded k-fused march (K8, K9, solver/sharded_kfused.py)
against wavetpu's, on the CPU.

wavetpu runs in interpret mode on the 8 virtual CPU devices of
tests/conftest.py; the port puts every shard on the CPU, where the
kernels' plain versions run.  Inputs come from a numpy seed or the
analytic problem.

Tolerances against wavetpu: f32 states within 2k ulp of the peak after k
substeps for one kernel call (XLA-CPU contracts multiply-adds into FMAs
where torch rounds twice, as in tests/test_torch_kfused.py) and within
2e-6 after a solve; bf16 within one bf16 ulp of the value for a kernel
call and 1e-2 after a solve; errors within rtol 1e-5 / atol 1e-7
(tests/test_sharded_kfused.py:73-76).  Against the port's own
single-device solves the states are bitwise: the even march (K8) equals
`kfused.solve_kfused` and the pad-and-mask march (K9) `leapfrog.solve`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.kernels import stencil_pallas as jpallas
from wavetpu.solver import sharded_kfused as jsk
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.kernels import stencil_cuda, stencil_ref
from wavetpu_torch.solver import kfused, leapfrog, sharded_kfused

CPU8 = ["cpu"] * 8
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def as64(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x, jnp.float64))


def ulps_of_peak(a, b):
    a, b = as64(a), as64(b)
    peak = np.max(np.maximum(np.abs(a), np.abs(b)))
    return float(np.max(np.abs(a - b)) / np.spacing(np.float32(peak)))


def assert_bf16_close(a, b):
    a, b = as64(a), as64(b)
    assert np.all(np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7)


def rand(shape, seed, dirichlet=True):
    a = np.random.default_rng(seed).standard_normal(shape)
    if dirichlet:
        a[:, 0, :] = 0.0
        a[:, :, 0] = 0.0
    return a.astype(np.float32)


# ---------------------------------------------------------------------------
# uneven_layout


def test_uneven_layout_accepts_everything_wavetpu_accepts():
    for n in range(8, 41):
        for mx in range(1, 9):
            for k in range(2, 9):
                jp, p = JProblem(N=n, timesteps=4), Problem(N=n, timesteps=4)
                try:
                    jsk.uneven_layout(jp, k, mx)
                except ValueError:
                    continue
                bx, d, r = sharded_kfused.uneven_layout(p, k, mx)
                assert bx % k == 0 and bx <= 8 and d % bx == 0
                assert 1 <= r <= d and (mx - 1) * d + r == n


# ---------------------------------------------------------------------------
# K8 and K9: the plain versions against wavetpu's kernels (interpret mode)


def _kernel_case(d, n, k, dtype, seed=1):
    p, jp = Problem(N=n, timesteps=20), JProblem(N=n, timesteps=20)
    sx, ct, syz, rsyz, _, _ = kfused._oracle_parts(p, torch.float32, "cpu")
    sxct = (ct[3:3 + k][:, None]
            * torch.cat([sx, torch.zeros(d)])[None, :d]).contiguous()
    arrs = [rand((d, n, n), seed + i) for i in range(2)]
    ghosts = [rand((k, n, n), seed + 2 + i) for i in range(4)]
    return p, jp, syz, rsyz, sxct, arrs, ghosts


def _t(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype):
    return jnp.asarray(a, JDT[dtype])


def _close(ours, ref, dtype, k):
    for a, b in zip(ours[:2], ref[:2]):
        assert a.dtype == dtype
        if dtype == torch.bfloat16:
            assert_bf16_close(a, b)
        else:
            assert ulps_of_peak(a, b) <= 2 * k
    if ours[2] is not None:
        for a, b in zip(ours[2:], ref[2:]):
            assert ulps_of_peak(a, b) <= 2 * k


@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,k", [(8, 2), (4, 4), (8, 1)])
def test_k8_plain_matches_wavetpu(d, k, dtype, with_field):
    n = 12
    p, jp, syz, rsyz, sxct, (up, u), (plo, phi, clo, chi) = _kernel_case(
        d, n, k, dtype)
    fld = fg = None
    if with_field:
        fld = p.a2tau2 * (0.5 + np.random.default_rng(9).random((d, n, n)))
        fg = [p.a2tau2 * (0.5 + np.random.default_rng(10 + i).random(
            (k, n, n))) for i in range(2)]
        fld, fg = fld.astype(np.float32), [g.astype(np.float32) for g in fg]
    ours = stencil_cuda.fused_kstep_sharded(
        _t(up, dtype), _t(u, dtype), (_t(plo, dtype), _t(phi, dtype)),
        (_t(clo, dtype), _t(chi, dtype)), syz, rsyz, sxct, k=k,
        coeff=p.a2tau2, inv_h2=p.inv_h2,
        c2tau2_block=None if fld is None else torch.from_numpy(fld),
        c2_ghosts=None if fg is None else tuple(map(torch.from_numpy, fg)),
        with_errors=not with_field)
    ref = jpallas.fused_kstep_sharded(
        _j(up, dtype), _j(u, dtype), (_j(plo, dtype), _j(phi, dtype)),
        (_j(clo, dtype), _j(chi, dtype)), jnp.asarray(syz.numpy()),
        jnp.asarray(rsyz.numpy()), jnp.asarray(sxct.numpy()), k=k,
        coeff=jp.a2tau2, inv_h2=jp.inv_h2,
        c2tau2_block=None if fld is None else jnp.asarray(fld),
        c2_ghosts=None if fg is None else tuple(map(jnp.asarray, fg)),
        with_errors=not with_field, interpret=True)
    _close(ours, ref, dtype, k)


def _ext(block, lo, hi, n_real, k):
    """wavetpu's extended array (sharded_kfused.py:548-556)."""
    ext = np.concatenate([lo, block, np.zeros_like(lo)], 0)
    ext[k + n_real:2 * k + n_real] = hi
    return ext


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,k,n_real,bx", [(8, 4, 5, 4), (8, 2, 8, 8),
                                           (8, 4, 2, 8), (4, 1, 3, 4)])
def test_k9_plain_matches_wavetpu(d, k, n_real, bx, dtype):
    n = 12
    p, jp, syz, rsyz, sxct, (up, u), (plo, phi, clo, chi) = _kernel_case(
        d, n, k, dtype, seed=20)
    sxct[:, n_real:] = 0.0
    # The pad planes hold zero, as the march keeps them.
    up[n_real:] = 0.0
    u[n_real:] = 0.0
    ours = stencil_cuda.fused_kstep_padded(
        _t(up, dtype), _t(u, dtype), n_real, (_t(plo, dtype), _t(phi, dtype)),
        (_t(clo, dtype), _t(chi, dtype)), syz, rsyz, sxct, k=k,
        coeff=p.a2tau2, inv_h2=p.inv_h2)
    ref = jpallas.fused_kstep_padded(
        _j(_ext(up, plo, phi, n_real, k), dtype),
        _j(_ext(u, clo, chi, n_real, k), dtype), jnp.int32(n_real),
        jnp.asarray(syz.numpy()), jnp.asarray(rsyz.numpy()),
        jnp.asarray(sxct.numpy()), k=k, coeff=jp.a2tau2, inv_h2=jp.inv_h2,
        block_x=bx, interpret=True)
    _close(ours, ref, dtype, k)
    assert not ours[0][n_real:].any() and not ours[1][n_real:].any()
    assert not ours[2][:, n_real:].any() and not ours[3][:, n_real:].any()


def test_k8_k9_cpu_tensors_count_no_launch_and_validate():
    stencil_cuda.reset_launches()
    p, _, syz, rsyz, sxct, (up, u), gh = _kernel_case(4, 8, 2, torch.float32)
    g = [torch.from_numpy(x) for x in gh]
    args = ((g[0], g[1]), (g[2], g[3]), syz, rsyz, sxct)
    kw = dict(k=2, coeff=p.a2tau2, inv_h2=p.inv_h2)
    a = stencil_cuda.fused_kstep_sharded(torch.from_numpy(up),
                                         torch.from_numpy(u), *args, **kw)
    b = stencil_cuda.fused_kstep_padded(torch.from_numpy(up),
                                        torch.from_numpy(u), 4, *args, **kw)
    # With every plane real, K9 is K8.
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert all(v == 0 for v in stencil_cuda.launches.values())
    with pytest.raises(ValueError, match="divide the shard depth"):
        stencil_cuda.fused_kstep_sharded(
            torch.from_numpy(up[:3]), torch.from_numpy(u[:3]), *args, **kw)
    with pytest.raises(ValueError, match="n_real"):
        stencil_cuda.fused_kstep_padded(torch.from_numpy(up),
                                        torch.from_numpy(u), 5, *args, **kw)


# ---------------------------------------------------------------------------
# solver/sharded_kfused.py


def _ours(n, steps, k, n_shards, dtype=torch.float32, **kw):
    return sharded_kfused.solve_sharded_kfused(
        Problem(N=n, timesteps=steps), n_shards=n_shards, dtype=dtype, k=k,
        devices=CPU8, **kw)


def _ref(n, steps, k, n_shards, dtype=torch.float32, **kw):
    return jsk.solve_sharded_kfused(
        JProblem(N=n, timesteps=steps), n_shards=n_shards, dtype=JDT[dtype],
        k=k, interpret=True, **kw)


def _match(ours, ref, tol):
    a, b = ours.u_cur.assemble(), np.asarray(ref.u_cur)
    assert tuple(a.shape) == b.shape
    assert np.max(np.abs(as64(a) - as64(b))) <= tol
    assert np.max(np.abs(as64(ours.u_prev.assemble())
                         - as64(ref.u_prev))) <= tol


# (N, timesteps, k, MX): even (K8) with n_shards in {1, 2, 4}, k in {2, 4};
# uneven (K9) with N in {13, 15} and MX in {1, 2, 4} - (13, k=4, MX=4)
# leaves the last shard r = 1 < k real planes (the two-hop seam).
CASES = [
    (16, 11, 2, 2), (16, 9, 4, 1), (16, 13, 4, 4),
    (13, 9, 4, 1), (13, 9, 4, 4), (15, 13, 4, 2),
]


@pytest.mark.parametrize("n,steps,k,mx", CASES)
def test_matches_wavetpu(n, steps, k, mx):
    # f32: the states and errors move by XLA-CPU's FMA contraction
    # (ROADMAP.md queue 3), ~1e-7 per step.
    ours, ref = _ours(n, steps, k, mx), _ref(n, steps, k, mx)
    _match(ours, ref, 2e-6)
    np.testing.assert_allclose(ours.abs_errors, ref.abs_errors, rtol=0,
                               atol=2e-6)
    assert ours.abs_errors.shape == (steps + 1,)


# wavetpu's f64 onion cannot store its f64 row maxima into its f32 rows
# under this jax (ROADMAP.md queue 3), so f64 runs without errors.
@pytest.mark.parametrize("n,steps,k,mx", [(16, 9, 2, 4), (15, 11, 3, 2)])
def test_f64_states_match_wavetpu(n, steps, k, mx):
    ours = _ours(n, steps, k, mx, torch.float64, compute_errors=False)
    ref = jsk.solve_sharded_kfused(
        JProblem(N=n, timesteps=steps), n_shards=mx, dtype=jnp.float64, k=k,
        interpret=True, compute_errors=False)
    _match(ours, ref, 1e-12)


@pytest.mark.parametrize("n,steps,k,mx", [(16, 11, 2, 2), (16, 13, 4, 4),
                                          (13, 11, 4, 4), (15, 12, 4, 2)])
def test_errors_match_single_device_rows(n, steps, k, mx):
    # wavetpu's contract between the sharded and the single-device k-fused
    # errors (tests/test_sharded_kfused.py:73-76), held on the port's own
    # marches: the k-fused solve at N, or at the uneven N the 1-step solve
    # (its full-field errors multiply the oracle in another order).
    p = Problem(N=n, timesteps=steps)
    a = _ours(n, steps, k, mx)
    if sharded_kfused._is_even(p, k, mx):
        b = kfused.solve_kfused(p, k=k, device="cpu")
        np.testing.assert_allclose(a.abs_errors, b.abs_errors, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(a.rel_errors, b.rel_errors, rtol=1e-5)
    else:
        b = leapfrog.solve(p, device="cpu")
        np.testing.assert_allclose(a.abs_errors, b.abs_errors, rtol=1e-5,
                                   atol=1e-7)


def test_bf16_field_and_errors_off_match_wavetpu():
    _match(_ours(15, 9, 4, 2, torch.bfloat16),
           _ref(15, 9, 4, 2, torch.bfloat16), 1e-2)
    p = Problem(N=16, timesteps=9)
    fld = stencil_ref.make_preset_c2tau2_field(p, "gaussian-lens")
    ours = _ours(16, 9, 4, 2, c2tau2_field=fld, compute_errors=False)
    ref = _ref(16, 9, 4, 2, c2tau2_field=fld, compute_errors=False)
    _match(ours, ref, 2e-6)
    assert not ours.abs_errors.any() and not ours.rel_errors.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("n,steps,k,mx", [(16, 13, 4, 4), (16, 11, 2, 2),
                                          (16, 9, 4, 1)])
def test_even_equals_single_device_kfused_bitwise(n, steps, k, mx, dtype):
    p = Problem(N=n, timesteps=steps)
    a = _ours(n, steps, k, mx, dtype)
    b = kfused.solve_kfused(p, dtype, k, device="cpu")
    assert a.u_cur.dtype == dtype
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.u_prev.fundamental(), b.u_prev)
    # The same rows but for layer 1 and the tail, where the single-device
    # march takes full-field errors (another oracle multiply order).
    np.testing.assert_allclose(a.abs_errors, b.abs_errors, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_field", [False, True], ids=["const", "field"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("n,steps,k,mx", [(13, 11, 4, 4), (15, 12, 4, 1),
                                          (15, 10, 3, 2), (13, 12, 4, 2)])
def test_uneven_equals_one_step_bitwise(n, steps, k, mx, dtype, with_field):
    p = Problem(N=n, timesteps=steps)
    kw = {}
    if with_field:
        kw = dict(compute_errors=False, c2tau2_field=stencil_ref.
                  make_preset_c2tau2_field(p, "gaussian-lens"))
    a = _ours(n, steps, k, mx, dtype, **kw)
    b = leapfrog.solve(p, dtype, device="cpu", **kw)
    assert torch.equal(a.u_cur.fundamental(), b.u_cur)
    assert torch.equal(a.u_prev.fundamental(), b.u_prev)
    pad = a.u_cur.assemble()[n:]
    assert not pad.any()
    if not with_field:
        np.testing.assert_allclose(a.abs_errors, b.abs_errors, rtol=0,
                                   atol=1e-6)


def test_stop_step():
    full = _ours(13, 12, 4, 2)
    part = _ours(13, 12, 4, 2, stop_step=7)
    one = leapfrog.solve(Problem(N=13, timesteps=12), stop_step=7,
                         device="cpu")
    assert part.final_step == 7 and part.abs_errors.shape == (8,)
    assert torch.equal(part.u_cur.fundamental(), one.u_cur)
    np.testing.assert_allclose(part.abs_errors[:5], full.abs_errors[:5],
                               rtol=0, atol=0)


@pytest.mark.parametrize("kwargs,match", [
    (dict(k=1), "k must be >= 2"),
    (dict(k=9), "k must be <= 8"),
    (dict(k=4, mesh_shape=(2, 2, 1)), "2D-mesh k-fusion needs"),
    (dict(k=4, mesh_shape=(2, 1, 2)), r"\(MX, MY, 1\)"),
    (dict(k=4, n_shards=8), "no pad-and-mask layout"),
    (dict(k=4, c2tau2_field=np.ones((13,) * 3)), "oracle"),
    (dict(k=4, n_shards=4, devices=["cpu"] * 2), "needs 4 devices"),
])
def test_validation(kwargs, match):
    with pytest.raises(ValueError, match=match):
        sharded_kfused.solve_sharded_kfused(Problem(N=13, timesteps=8),
                                            **{"devices": CPU8, **kwargs})
