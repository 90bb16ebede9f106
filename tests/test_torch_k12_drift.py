"""K12's drift from the single-device flagship, held to wavetpu's own.

The distributed flagship on a y-sharded mesh (K12, mesh 2,2,1) zero-seeds
the Kahan carry on the y ghost rows of its extended block, as wavetpu's
kernel does by design (`wavetpu/kernels/stencil_pallas.py:1167-1176`, the
docstring :1377-1382 and the zeroing :1427-1434): its march is not bitwise
the single-device flagship's and drifts from it by roundings that grow
with the step count.  The port copies that approximation
(`stencil_cuda._comp_chain_plain`), so its distance from its own flagship
must be wavetpu's distance from wavetpu's flagship.

At N=16, mesh (2, 2, 1), k=4, block_x=4, tau = 1e-2 (T = steps x 1e-2),
for 64, 256 and 1024 steps, wavetpu in interpret mode on the virtual CPU
devices, the port with every shard on the CPU (the kernels' plain
versions).  Held:

 (a) the port's max |du| from its flagship differs from wavetpu's by at
     most one f32 ulp at the field's peak (6e-8);
 (b) the same for the max distance of the abs-error vectors;
 (c) the port's sharded march equals wavetpu's sharded march, field and
     abs-error vector, within one f32 ulp at the peak (the direct check
     that the port copies wavetpu's zero-seeded carry; (a) and (b) alone
     would pass a port with a different error of the same size);
 (d) both packages' distances never shrink from 64 steps on and grow
     from 64 to 1024 steps (measured: du 5.96e-8, 1.19e-7, 2.38e-7 on
     both; the error vectors 5.96e-8, 5.96e-8, 2.38e-7) - a side that
     drops the zero-seeded y-ghost carry (and so stops drifting) shows
     here.
"""

import functools

import numpy as np
import pytest

from wavetpu.core.problem import Problem as JProblem
from wavetpu.solver import kfused_comp as jkc
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.solver import kfused_comp

N, MESH, K, BX, TAU = 16, (2, 2, 1), 4, 4, 1e-2
ULP_AT_PEAK = 6e-8  # one f32 ulp at the analytic field's peak (~1)
STEPS = [64, 256, 1024]


def _dist(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@functools.lru_cache(maxsize=None)
def distances(steps):
    """{"wavetpu": (du, d abs_errors), "port": (du, d abs_errors)} of the
    sharded flagship on MESH from its package's single-device flagship,
    and "across": (du, d abs_errors) of the port's sharded flagship from
    wavetpu's."""
    kw = dict(N=N, timesteps=steps, T=steps * TAU)
    jp = JProblem(**kw)
    j_sh = jkc.solve_kfused_comp_sharded(jp, mesh_shape=MESH, k=K,
                                         block_x=BX, interpret=True)
    j_one = jkc.solve_kfused_comp(jp, k=K, block_x=BX, interpret=True)
    p = Problem(**kw)
    t_sh = kfused_comp.solve_kfused_comp_sharded(
        p, mesh_shape=MESH, k=K, block_x=BX, devices=["cpu"] * 4)
    t_one = kfused_comp.solve_kfused_comp(p, k=K, block_x=BX, device="cpu")
    j_u = np.asarray(j_sh.u_cur)[:N, :N, :N]
    t_u = t_sh.u_cur.fundamental().numpy()
    return {
        "wavetpu": (_dist(j_u, j_one.u_cur),
                    _dist(j_sh.abs_errors, j_one.abs_errors)),
        "port": (_dist(t_u, t_one.u_cur.numpy()),
                 _dist(t_sh.abs_errors, t_one.abs_errors)),
        "across": (_dist(t_u, j_u), _dist(t_sh.abs_errors, j_sh.abs_errors)),
    }


@pytest.mark.parametrize("steps", STEPS)
def test_k12_drift_is_wavetpus(steps):
    d = distances(steps)
    (j_du, j_de), (t_du, t_de) = d["wavetpu"], d["port"]
    assert abs(t_du - j_du) <= ULP_AT_PEAK, d
    assert abs(t_de - j_de) <= ULP_AT_PEAK, d
    assert max(d["across"]) <= ULP_AT_PEAK, d
    if steps > STEPS[0]:
        first = distances(STEPS[0])
        grew = (lambda a, b: a > b) if steps == STEPS[-1] else \
            (lambda a, b: a >= b)
        for side in ("wavetpu", "port"):
            for i in range(2):
                assert grew(d[side][i], first[side][i]), (side, d, first)
