"""The port's checkpoints (wavetpu_torch/io/checkpoint.py) and resume entry
points against wavetpu's (wavetpu/io/checkpoint.py) on the CPU.

The on-disk format is wavetpu's: a checkpoint either package writes loads
in the other with the very arrays saved (bf16 bits included), single-file
and sharded.  A port checkpoint resumed in the port is bitwise the port's
uninterrupted run.  A wavetpu checkpoint resumed in the port is held to
wavetpu's uninterrupted run within XLA-CPU's FMA tolerance (ROADMAP.md
queue 3: XLA-CPU contracts multiply-adds the port rounds twice, so the two
packages' states already differ by an ulp at the stop layer): 1e-5 for
f32, 1e-12 for f64.  wavetpu's Pallas paths run in interpret mode on the 8
virtual CPU devices, as its own tests run them; its flagship with a pinned
block_x (the port's default carry slab is deeper, queue 3).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavetpu.core.problem import Problem as JProblem
from wavetpu.io import checkpoint as jckpt
from wavetpu.solver import kfused as jkfused
from wavetpu.solver import kfused_comp as jkcomp
from wavetpu.solver import leapfrog as jleap
from wavetpu.solver import sharded as jsharded
from wavetpu.solver import sharded_kfused as jskfused
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import checkpoint, state
from wavetpu_torch.run import faults
from wavetpu_torch.solver import (
    kfused, kfused_comp, leapfrog, sharded, sharded_kfused,
)

N, T = 15, 12
ARGS = dict(N=N, Ly=np.pi, timesteps=T)
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64,
       torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 1e-2}


def bits(a):
    """A state array (tensor, ShardedArray, jax or numpy) as raw bytes of
    its padded global layout."""
    if hasattr(a, "blocks"):
        a = a.assemble("cpu")
    if isinstance(a, torch.Tensor):
        return state.to_numpy(a).tobytes(), str(a.dtype).split(".")[-1]
    a = np.asarray(a)
    return a.tobytes(), a.dtype.name


def as64(a):
    """A state array as f64 numpy, a ShardedArray as its padded global
    array (the layout of wavetpu's sharded arrays)."""
    if hasattr(a, "blocks"):
        a = a.assemble("cpu")
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a, jnp.float64))


def same(a, b):
    assert bits(a) == bits(b)


# ---------------------------------------------------------------------------
# single-device files


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_standard_roundtrip_bitwise_and_wavetpu_reads_it(tmp_path, dtype):
    p = Problem(**ARGS)
    half = leapfrog.solve(p, dtype=dtype, device="cpu", kernel="roll",
                          stop_step=5)
    path = checkpoint.save_checkpoint(str(tmp_path / "ck"), half)
    assert path.endswith(".npz")
    q, u_prev, u_cur, step = checkpoint.load_checkpoint(path)
    assert (q, step) == (p, 5)
    same(u_prev, half.u_prev)
    same(u_cur, half.u_cur)
    assert checkpoint.checkpoint_scheme(path) == "standard"
    assert checkpoint.load_checkpoint_aux(path) is None
    # wavetpu loads the very arrays the port saved.
    jp, ju_prev, ju_cur, jstep = jckpt.load_checkpoint(path)
    assert jstep == 5 and jp.N == N and jp.timesteps == T
    same(ju_prev, half.u_prev)
    same(ju_cur, half.u_cur)
    # The port's resume of its own checkpoint is its uninterrupted run.
    full = leapfrog.solve(p, dtype=dtype, device="cpu", kernel="roll")
    res = checkpoint.resume_solve(path, device="cpu", kernel="roll")
    same(res.u_cur, full.u_cur)
    same(res.u_prev, full.u_prev)
    np.testing.assert_array_equal(res.abs_errors[6:], full.abs_errors[6:])
    assert not res.abs_errors[:6].any()


@pytest.mark.parametrize("mode", ["f32", "bf16carry", "increment"])
def test_flagship_roundtrip_and_wavetpu_reads_it(tmp_path, mode):
    p = Problem(N=12, timesteps=10)
    kw = {"f32": dict(carry_dtype=torch.float32), "bf16carry": {},
          "increment": dict(v_dtype=torch.bfloat16, carry=False)}[mode]
    half = kfused_comp.solve_kfused_comp(p, k=3, stop_step=7, device="cpu",
                                         **kw)
    path = checkpoint.save_checkpoint(str(tmp_path / "ck.npz"), half)
    assert checkpoint.checkpoint_scheme(path) == "compensated"
    v, c = checkpoint.load_checkpoint_aux(path)
    same(v, half.comp_v)
    if mode == "increment":
        # The carry-less form stores a zero carry; the bf16 v marks it.
        assert v.dtype == torch.bfloat16 and not c.any()
    else:
        same(c, half.comp_carry)
    jv, jc = jckpt.load_checkpoint_aux(path)
    same(jv, half.comp_v)
    same(jc, c)
    assert jckpt.checkpoint_scheme(path) == "compensated"
    # Block-aligned stop (7 = 1 + 2k): the resumed march is bitwise.
    full = kfused_comp.solve_kfused_comp(p, k=3, device="cpu", **kw)
    _, _, u_cur, step = checkpoint.load_checkpoint(path)
    res = kfused_comp.resume_kfused_comp(
        p, u_cur, v, None if mode == "increment" else c, step, k=3,
        device="cpu")
    same(res.u_cur, full.u_cur)
    same(res.comp_v, full.comp_v)
    if mode != "increment":
        same(res.comp_carry, full.comp_carry)
    np.testing.assert_array_equal(res.abs_errors[8:], full.abs_errors[8:])


def _wavetpu_half(kind, dtype, stop):
    jp = JProblem(**ARGS)
    jdt = JDT[dtype]
    if kind == "standard":
        return (jleap.solve(jp, dtype=jdt, stop_step=stop),
                jleap.solve(jp, dtype=jdt))
    if kind == "compensated":
        return (jleap.solve_compensated(jp, dtype=jdt, stop_step=stop),
                jleap.solve_compensated(jp, dtype=jdt))
    if kind == "kfused":
        return (jkfused.solve_kfused(jp, dtype=jdt, k=3, stop_step=stop,
                                     interpret=True, compute_errors=False),
                jkfused.solve_kfused(jp, dtype=jdt, k=3, interpret=True,
                                     compute_errors=False))
    return (jkcomp.solve_kfused_comp(jp, dtype=jdt, k=3, stop_step=stop,
                                     block_x=3, interpret=True),
            jkcomp.solve_kfused_comp(jp, dtype=jdt, k=3, block_x=3,
                                     interpret=True))


@pytest.mark.parametrize("kind,dtype,stop", [
    ("standard", torch.float32, 5),
    ("standard", torch.float64, 5),
    ("standard", torch.bfloat16, 6),
    ("compensated", torch.float32, 5),
    ("kfused", torch.float32, 4),
    ("flagship", torch.float32, 7),
], ids=["standard-f32", "standard-f64", "standard-bf16", "compensated",
        "kfused", "flagship"])
def test_wavetpu_checkpoint_resumes_in_the_port(tmp_path, kind, dtype,
                                                stop):
    jhalf, jfull = _wavetpu_half(kind, dtype, stop)
    path = jckpt.save_checkpoint(str(tmp_path / "j.npz"), jhalf)
    p, u_prev, u_cur, step = checkpoint.load_checkpoint(path)
    assert step == stop and p == Problem(**ARGS)
    # The port reads wavetpu's very arrays, in their dtype.
    same(u_prev, jhalf.u_prev)
    same(u_cur, jhalf.u_cur)
    assert u_cur.dtype == dtype
    if kind == "standard":
        res = checkpoint.resume_solve(path, device="cpu", kernel="roll")
    elif kind == "compensated":
        v, c = checkpoint.load_checkpoint_aux(path)
        same(v, jhalf.comp_v)
        same(c, jhalf.comp_carry)
        res = checkpoint.resume_solve(path, device="cpu", kernel="roll")
    elif kind == "kfused":
        res = kfused.resume_kfused(p, u_prev, u_cur, step, k=3,
                                   device="cpu", compute_errors=False)
    else:
        v, c = checkpoint.load_checkpoint_aux(path)
        same(c, jhalf.comp_carry)
        res = kfused_comp.resume_kfused_comp(p, u_cur, v, c, step, k=3,
                                             block_x=3, device="cpu")
    assert res.u_cur.dtype == dtype
    d = np.abs(as64(res.u_cur) - as64(jfull.u_cur)).max()
    assert d <= TOL[dtype], d
    if kind not in ("kfused",):
        np.testing.assert_allclose(res.abs_errors[stop + 1:],
                                   np.asarray(jfull.abs_errors)[stop + 1:],
                                   rtol=0, atol=TOL[dtype])


# ---------------------------------------------------------------------------
# sharded directories


@pytest.mark.parametrize("mesh,scheme", [
    ((2, 2, 1), "standard"), ((4, 1, 1), "standard"),
    ((2, 2, 1), "compensated"),
], ids=["221", "411", "221-compensated"])
def test_sharded_port_roundtrip_and_wavetpu_reads_it(tmp_path, mesh,
                                                     scheme):
    p = Problem(**ARGS)
    devs = ["cpu"] * 4
    half = sharded.solve_sharded(p, mesh, devs, scheme=scheme, stop_step=5)
    d = str(tmp_path / "ck")
    checkpoint.save_sharded_checkpoint(d, half)
    shards = sorted(f for f in os.listdir(d) if f.endswith(".wts"))
    assert len(shards) == 4 and "meta.npz" in os.listdir(d)
    q, u_prev, u_cur, step, ms, sch, aux = (
        checkpoint.load_sharded_checkpoint(d, devs))
    assert (q, step, ms, sch) == (p, 5, mesh, scheme)
    same(u_cur, half.u_cur)
    same(u_prev, half.u_prev)
    # wavetpu loads the same padded global arrays on its 8 CPU devices.
    jq, ju_prev, ju_cur, jstep, jms, jsch, jaux = (
        jckpt.load_sharded_checkpoint(d))
    assert (jstep, jms, jsch) == (5, mesh, scheme)
    same(ju_cur, half.u_cur)
    same(ju_prev, half.u_prev)
    if scheme == "compensated":
        same(aux[0], half.comp_v)
        same(jaux[1], half.comp_carry)
    full = sharded.solve_sharded(p, mesh, devs, scheme=scheme)
    res = checkpoint.resume_sharded_solve(d, devices=devs)
    same(res.u_cur, full.u_cur)
    np.testing.assert_array_equal(res.abs_errors[6:], full.abs_errors[6:])


@pytest.mark.parametrize("mesh", [(2, 2, 1), (4, 1, 1)],
                         ids=["221", "411"])
def test_wavetpu_sharded_checkpoint_resumes_in_the_port(tmp_path, mesh):
    jp, p = JProblem(**ARGS), Problem(**ARGS)
    jhalf = jsharded.solve_sharded(jp, mesh_shape=mesh, kernel="roll",
                                   dtype=jnp.float64, stop_step=5)
    jfull = jsharded.solve_sharded(jp, mesh_shape=mesh, kernel="roll",
                                   dtype=jnp.float64)
    d = str(tmp_path / "j")
    jckpt.save_sharded_checkpoint(d, jhalf)
    _, u_prev, u_cur, step, ms, _, _ = checkpoint.load_sharded_checkpoint(
        d, ["cpu"] * 4)
    assert ms == mesh and step == 5
    same(u_cur, jhalf.u_cur)
    same(u_prev, jhalf.u_prev)
    res = sharded.resume_sharded(p, u_prev, u_cur, step, mesh, ["cpu"] * 4,
                                 dtype=torch.float64)
    assert np.abs(as64(res.u_cur) - as64(jfull.u_cur)).max() < 1e-12
    np.testing.assert_allclose(res.abs_errors[6:], jfull.abs_errors[6:],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("mesh,n,k", [((2, 2, 1), 16, 4), ((2, 1, 1), 15, 4)],
                         ids=["K10-221", "K9-uneven"])
def test_sharded_kfused_checkpoints_cross_both_ways(tmp_path, mesh, n, k):
    """K10's y-extended blocks and K9's pad layout never reach the files:
    the shard files of both packages hold the Topology blocks."""
    p, jp = Problem(N=n, timesteps=11), JProblem(N=n, timesteps=11)
    devs = ["cpu"] * 4
    half = sharded_kfused.solve_sharded_kfused(
        p, k=k, mesh_shape=mesh, devices=devs, stop_step=6)
    full = sharded_kfused.solve_sharded_kfused(p, k=k, mesh_shape=mesh,
                                               devices=devs)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    checkpoint.save_sharded_checkpoint(ours, half)
    jhalf = jskfused.solve_sharded_kfused(
        jp, k=k, mesh_shape=mesh, stop_step=6, interpret=True,
        compute_errors=False)
    jckpt.save_sharded_checkpoint(theirs, jhalf)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    _, ju_prev, ju_cur, _, _, _, _ = jckpt.load_sharded_checkpoint(ours)
    same(ju_cur, half.u_cur)
    same(ju_prev, half.u_prev)
    _, u_prev, u_cur, step, _, _, _ = checkpoint.load_sharded_checkpoint(
        theirs, devs)
    same(u_cur, jhalf.u_cur)
    res = sharded_kfused.resume_sharded_kfused(
        p, u_prev, u_cur, step, k=k, mesh_shape=mesh, devices=devs)
    assert np.abs(as64(res.u_cur) - as64(full.u_cur)).max() < 1e-5
    _, u_prev, u_cur, step, _, _, _ = checkpoint.load_sharded_checkpoint(
        ours, devs)
    res = sharded_kfused.resume_sharded_kfused(
        p, u_prev, u_cur, step, k=k, mesh_shape=mesh, devices=devs)
    same(res.u_cur, full.u_cur)
    same(res.u_prev, full.u_prev)


def test_sharded_flagship_checkpoint_cross_and_bitwise(tmp_path):
    p, jp = Problem(N=16, timesteps=9), JProblem(N=16, timesteps=9)
    devs = ["cpu"] * 4
    half = kfused_comp.solve_kfused_comp_sharded(
        p, mesh_shape=(2, 2, 1), k=4, devices=devs, stop_step=5)
    full = kfused_comp.solve_kfused_comp_sharded(
        p, mesh_shape=(2, 2, 1), k=4, devices=devs)
    d = str(tmp_path / "ck")
    checkpoint.save_sharded_checkpoint(d, half)
    _, _, u_cur, step, ms, scheme, (v, c) = (
        checkpoint.load_sharded_checkpoint(d, devs))
    assert c.dtype == torch.bfloat16 and scheme == "compensated"
    res = kfused_comp.resume_kfused_comp_sharded(
        p, u_cur, v, c, step, mesh_shape=ms, k=4, devices=devs)
    same(res.u_cur, full.u_cur)
    same(res.comp_carry, full.comp_carry)
    np.testing.assert_array_equal(res.abs_errors[6:], full.abs_errors[6:])
    _, _, ju_cur, _, _, _, (jv, jc) = jckpt.load_sharded_checkpoint(d)
    same(ju_cur, half.u_cur)
    same(jc, half.comp_carry)
    # wavetpu's own checkpoint of its distributed flagship resumes here.
    jhalf = jkcomp.solve_kfused_comp_sharded(
        jp, mesh_shape=(2, 2, 1), k=4, block_x=4, stop_step=5,
        interpret=True)
    jd = str(tmp_path / "j")
    jckpt.save_sharded_checkpoint(jd, jhalf)
    _, _, u_cur, step, ms, _, (v, c) = checkpoint.load_sharded_checkpoint(
        jd, devs)
    same(c, jhalf.comp_carry)
    res = kfused_comp.resume_kfused_comp_sharded(
        p, u_cur, v, c, step, mesh_shape=ms, k=4, devices=devs)
    assert np.abs(as64(res.u_cur) - as64(full.u_cur)).max() < 1e-5


# ---------------------------------------------------------------------------
# faults on disk (tests/test_faults.py, tests/test_sharded_checkpoint.py)


@pytest.fixture(scope="module")
def sharded_ck(tmp_path_factory):
    p = Problem(N=16, timesteps=6)
    res = sharded.solve_sharded(p, (2, 1, 1), ["cpu"] * 2, stop_step=3)
    d = tmp_path_factory.mktemp("ck") / "ck"
    checkpoint.save_sharded_checkpoint(str(d), res)
    return p, res, str(d)


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _first_shard(d):
    return os.path.join(d, sorted(f for f in os.listdir(d)
                                  if f.endswith(".wts"))[0])


def test_bitflip_rejected_by_crc(sharded_ck, tmp_path):
    d = _copy(sharded_ck[2], tmp_path / "c")
    faults.flip_byte(_first_shard(d))
    with pytest.raises(ValueError, match="CRC mismatch"):
        checkpoint.load_sharded_checkpoint(d, ["cpu"] * 2)


def test_truncated_shard_rejected(sharded_ck, tmp_path):
    d = _copy(sharded_ck[2], tmp_path / "t")
    faults.truncate_tail(_first_shard(d), drop_bytes=64)
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.load_sharded_checkpoint(d, ["cpu"] * 2)


def test_mixed_step_shard_rejected_and_legacy_fallback(sharded_ck,
                                                       tmp_path):
    p, res, src = sharded_ck
    d = _copy(src, tmp_path / "m")
    shard = faults.rewrite_shard_step(d, 2)
    with pytest.raises(ValueError, match="interrupted mid-save"):
        checkpoint.load_sharded_checkpoint(d, ["cpu"] * 2)
    # A legacy .npz shard that records meta's step is the fallback.
    fields, _ = checkpoint.nativeio.read_container(shard)
    legacy = shard[:-4] + ".npz"
    np.savez(legacy, step=3, **{k: a for k, (a, _) in fields.items()},
             **{f"{k}_dtype": t for k, (_, t) in fields.items()})
    _, _, u_cur, step, _, _, _ = checkpoint.load_sharded_checkpoint(
        d, ["cpu"] * 2)
    assert step == 3
    same(u_cur, res.u_cur)


def test_missing_shard_reported_by_its_wts_name(sharded_ck, tmp_path):
    d = _copy(sharded_ck[2], tmp_path / "x")
    os.remove(_first_shard(d))
    with pytest.raises(FileNotFoundError, match=r"\.wts"):
        checkpoint.load_sharded_checkpoint(d, ["cpu"] * 2)


def test_save_cleans_stale_tmps_and_load_ignores_them(sharded_ck,
                                                      tmp_path):
    p, res, src = sharded_ck
    d = _copy(src, tmp_path / "s")
    shard = os.path.basename(_first_shard(d))
    stale = [os.path.join(d, f"{shard}.tmp-99999"),
             os.path.join(d, "meta.npz.tmp-99999.npz")]
    for s in stale:
        with open(s, "wb") as f:
            f.write(b"\0" * 64)
    assert checkpoint.load_sharded_checkpoint(d, ["cpu"] * 2)[3] == 3
    checkpoint.save_sharded_checkpoint(d, res)
    for s in stale:
        assert not os.path.exists(s), s


def test_sharded_load_needs_devices_unless_given(sharded_ck):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the load goes to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_sharded_checkpoint(sharded_ck[2])
    with pytest.raises(ValueError, match="needs 2 devices"):
        checkpoint.load_sharded_checkpoint(sharded_ck[2], ["cpu"])


def test_state_blocks_cross_both_ways():
    """io/state.py: a checkpoint's arrays - bf16 included - become the
    port's blocks and go back, from ShardedArrays and from wavetpu's padded
    global arrays."""
    from wavetpu_torch.core.grid import Topology, build_mesh

    topo = Topology(N=15, mesh_shape=(2, 2, 1))
    mesh = build_mesh(topo.mesh_shape, ["cpu"] * 4)
    g = np.random.default_rng(1).standard_normal(topo.padded)
    g[15:], g[:, 15:] = 0.0, 0.0
    for dt in (np.float32, np.float64):
        blocks = state.to_blocks(g.astype(dt), topo, mesh)
        sa = state.split_sharded(g.astype(dt), 15, topo.mesh_shape,
                                 ["cpu"] * 4)
        for a, b in zip(blocks, sa.blocks):
            assert torch.equal(a, b)
        assert state.to_blocks(sa, topo, mesh)[3].data_ptr() == \
            sa.blocks[3].data_ptr()
        np.testing.assert_array_equal(state.assemble_sharded(sa),
                                      g.astype(dt))
    bf = jnp.asarray(g, jnp.bfloat16)
    blocks = state.to_blocks(np.asarray(bf), topo, mesh)
    assert blocks[0].dtype == torch.bfloat16
    sa = type(sa)(blocks, topo, mesh)
    assert bits(sa) == bits(np.asarray(bf))
