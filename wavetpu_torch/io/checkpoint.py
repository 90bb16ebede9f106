"""Checkpoint / resume: dump the live solver state, re-enter the march (the
port's copy of wavetpu/io/checkpoint.py; the on-disk format is wavetpu's,
so a wavetpu checkpoint resumes in the port and the reverse).

The reference has no checkpointing; the full solver state is two rolling
buffers plus the step index (the three-buffer rotation of mpi_new.cpp:131
collapses to (u^{n-1}, u^n)).  A single-device checkpoint is one `.npz`
holding those two (N, N, N) fields, the step index and the Problem spec -
and, for the compensated scheme, the increment v and the Kahan carry;
`resume_solve` feeds them back into the solver's resume entry point, whose
per-step operation sequence is an uninterrupted run's, so the resumed
final state is bitwise equal.

Sharded runs use the per-shard format (`save_sharded_checkpoint`): one
`meta.npz` plus one WTS1 container (io/nativeio.py) per shard,
`shard_{x0}_{y0}_{z0}.wts`, keyed by the global start offsets of the
shard's block of the padded global array (`Topology.padded`).  A shard
file holds that block and nothing the march carries inside (K10/K12's
y-extended blocks, the K9 pad layout): the solvers return their state on
the Topology layout and the chunk runners convert it back
(solver/sharded_kfused.py).  Pad planes are zeros.

Under `--distributed` (comm/dist.py) every rank writes the containers of
its own shards, and rank 0 writes `meta.npz` after a barrier, so meta
never names a step before every shard has landed; a load reads each
rank's own shards.  The files are the same as one process writes.

bf16 travels as its uint16 bits with a dtype tag, as wavetpu stores it;
numpy has no bf16, so the bits are reinterpreted as `torch.bfloat16` on
load (exact), and no `ml_dtypes` is needed.  Loads return CPU tensors
(single-device) or `ShardedArray`s on the mesh's devices (sharded).

Device-to-host: the state is copied shard by shard into pinned host
buffers; the native writer's background thread writes shard i while shard
i+1 is copied (the port's form of wavetpu's overlap of writing and
assembling).  Saves and loads record their bytes and seconds through
`obs.metrics.record_checkpoint_io`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from wavetpu_torch.comm import dist
from wavetpu_torch.core.grid import ShardedArray, Topology, build_mesh
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.io import nativeio
from wavetpu_torch.obs import tracing

_FORMAT_VERSION = 1

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
}


def dtype_name(dtype) -> str:
    """The numpy-style name of a torch dtype ("float32", "bfloat16", ...),
    the tag wavetpu writes."""
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"cannot checkpoint dtype {dtype}: only float32, "
                     f"float64, float16 and bfloat16 are supported")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a checkpoint's dtype name."""
    return _DTYPES[name]


def _host(t: torch.Tensor) -> torch.Tensor:
    """A tensor's contiguous host copy: into pinned memory from a card (the
    caching host allocator keeps the buffers for the next save)."""
    if isinstance(t, ShardedArray):
        t = t.fundamental("cpu")
    if t.device.type != "cuda":
        return t.detach().contiguous()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _encode_field(t) -> Tuple[np.ndarray, str]:
    """(storable numpy array, dtype tag) for one state field (a tensor on
    any device, a ShardedArray - saved as its fundamental domain - or a
    numpy array).  bf16 becomes its uint16 bits tagged "bfloat16"."""
    if isinstance(t, np.ndarray):
        if t.dtype.name == "bfloat16":
            return t.view(np.uint16), "bfloat16"
        return t, t.dtype.name
    t = _host(t)
    tag = dtype_name(t.dtype)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), tag
    return t.numpy(), tag


def _decode_field(arr: np.ndarray, tag: Optional[str]) -> torch.Tensor:
    """Inverse of `_encode_field` as a CPU tensor; also recovers legacy
    untagged checkpoints whose bf16 fields were stored as void |V2 (the
    same raw bytes)."""
    if tag == "bfloat16" or (tag is None and arr.dtype.kind == "V"):
        bits = np.ascontiguousarray(arr).view(np.uint16)
        if not bits.flags.writeable:
            bits = bits.copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr))


def _record_io(op: str, kind: str, nbytes: float, seconds: float) -> None:
    """Checkpoint I/O telemetry; never lets an obs failure break a
    checkpoint."""
    try:
        from wavetpu_torch.obs import metrics as obs_metrics

        obs_metrics.record_checkpoint_io(op, kind, nbytes, seconds)
    except Exception:
        pass


def _tree_bytes(path_dir: str) -> int:
    """Directory byte total for telemetry, best-effort (a file removed
    mid-walk must not fail a checkpoint op that already succeeded)."""
    total = 0
    try:
        entries = os.listdir(path_dir)
    except OSError:
        return 0
    for e in entries:
        try:
            p = os.path.join(path_dir, e)
            if os.path.isfile(p):
                total += os.path.getsize(p)
        except OSError:
            pass
    return total


def _file_bytes(path: str) -> int:
    try:
        return os.path.getsize(path) if os.path.exists(path) else 0
    except OSError:
        return 0


def _problem_fields(p: Problem) -> dict:
    return {f"problem_{k}": v for k, v in dataclasses.asdict(p).items()}


def _final_step(result) -> int:
    return (result.final_step if result.final_step is not None
            else result.problem.timesteps)


def save_checkpoint(path: str, result) -> str:
    """Write (u_prev, u_cur, step, problem) from a (possibly partial) solve
    as one .npz; the compensated scheme adds (v, carry) - a zero carry for
    the carry-less increment form, whose bf16 v marks the mode.  Returns
    the file's path (".npz" appended as np.savez does)."""
    t0 = time.perf_counter()
    p = result.problem
    step = _final_step(result)
    u_prev, prev_tag = _encode_field(result.u_prev)
    u_cur, cur_tag = _encode_field(result.u_cur)
    extra = {}
    if result.comp_v is not None:
        comp_v, v_tag = _encode_field(result.comp_v)
        carry = result.comp_carry
        comp_carry, c_tag = (_encode_field(carry) if carry is not None
                             else (np.zeros_like(u_cur), cur_tag))
        extra = dict(scheme="compensated", comp_v=comp_v,
                     comp_carry=comp_carry, comp_v_dtype=v_tag,
                     comp_carry_dtype=c_tag)
    np.savez(path, format_version=_FORMAT_VERSION, step=step, u_prev=u_prev,
             u_cur=u_cur, u_prev_dtype=prev_tag, u_cur_dtype=cur_tag,
             **extra, **_problem_fields(p))
    out = path if path.endswith(".npz") else path + ".npz"
    seconds = time.perf_counter() - t0
    nbytes = _file_bytes(out)
    _record_io("save", "single", nbytes, seconds)
    tracing.event("checkpoint.save", kind="single", step=step,
                  bytes=nbytes, seconds=round(seconds, 6), path=out)
    return out


def _problem_from_npz(z) -> Problem:
    return Problem(
        N=int(z["problem_N"]), Np=int(z["problem_Np"]),
        Lx=float(z["problem_Lx"]), Ly=float(z["problem_Ly"]),
        Lz=float(z["problem_Lz"]), T=float(z["problem_T"]),
        timesteps=int(z["problem_timesteps"]),
    )


def _tag(z, name):
    return str(z[name]) if name in z.files else None


def load_checkpoint(path: str):
    """Read a checkpoint back as (problem, u_prev, u_cur, step), the
    fields as CPU tensors."""
    t0 = time.perf_counter()
    with np.load(path) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {version} != supported {_FORMAT_VERSION}"
            )
        problem = _problem_from_npz(z)
        u_prev = _decode_field(z["u_prev"], _tag(z, "u_prev_dtype"))
        u_cur = _decode_field(z["u_cur"], _tag(z, "u_cur_dtype"))
        step = int(z["step"])
    _record_io("load", "single", _file_bytes(path), time.perf_counter() - t0)
    return problem, u_prev, u_cur, step


def load_checkpoint_aux(path: str):
    """The compensated-scheme auxiliary state (v, carry) of a single-file
    checkpoint as CPU tensors, or None for a standard-scheme one."""
    with np.load(path) as z:
        if "comp_v" not in z.files:
            return None
        return (_decode_field(z["comp_v"], _tag(z, "comp_v_dtype")),
                _decode_field(z["comp_carry"], _tag(z, "comp_carry_dtype")))


def checkpoint_scheme(path: str) -> str:
    """The scheme a single-file checkpoint was saved under: "compensated"
    or "standard"."""
    with np.load(path) as z:
        return str(z["scheme"]) if "scheme" in z.files else "standard"


def _shard_filename(starts) -> str:
    return f"shard_{starts[0]}_{starts[1]}_{starts[2]}.wts"


def _legacy_shard_filename(starts) -> str:
    return f"shard_{starts[0]}_{starts[1]}_{starts[2]}.npz"


def _legacy_shard_has_step(legacy_path: str, step: int) -> bool:
    """True iff a legacy .npz shard exists AND records `step`: the gate of
    the WTS-mismatch fallback (a step-less legacy shard must never be mixed
    into a partially written WTS checkpoint)."""
    if not os.path.exists(legacy_path):
        return False
    with np.load(legacy_path) as z:
        return "step" in z.files and int(z["step"]) == step


def _starts(topo: Topology, coord) -> Tuple[int, int, int]:
    return tuple(c * b for c, b in zip(coord, topo.block))


def save_sharded_checkpoint(path_dir: str, result) -> str:
    """Write a sharded solve's state as one WTS1 file per shard plus a
    meta file (see the module docstring); nothing is gathered.

    Crash consistency: every file is written to a temp name and renamed
    (atomic per file), each shard carries a CRC32 footer and the step it
    belongs to, and the loader rejects any shard whose CRC fails or whose
    step disagrees with meta - so a preemption mid-way through
    overwriting an older checkpoint cannot be resumed as mixed-step or
    torn state.  Stale `*.tmp-<pid>*` files of a crashed writer are
    removed before each shard is rewritten (the loader opens exact names
    only).  A supervised run saves each checkpoint to a fresh directory
    and flips a `latest` pointer (run/supervisor.py)."""
    t0 = time.perf_counter()
    p = result.problem
    step = _final_step(result)
    u_prev, u_cur = result.u_prev, result.u_cur
    if not isinstance(u_cur, ShardedArray):
        raise ValueError("save_sharded_checkpoint takes a sharded result "
                         "(ShardedArray state); use save_checkpoint")
    topo, mesh = u_cur.topo, u_cur.mesh
    os.makedirs(path_dir, exist_ok=True)

    def clean_stale_tmps(filename):
        prefix = f"{filename}.tmp-"
        for e in os.listdir(path_dir):
            if e.startswith(prefix):
                try:
                    os.remove(os.path.join(path_dir, e))
                except OSError:
                    pass

    compensated = result.comp_v is not None
    carry = result.comp_carry
    in_flight = []
    try:
        for i in mesh.local:
            starts = _starts(topo, mesh.coords[i])
            fields = dict(u_prev=_encode_field(u_prev.blocks[i]),
                          u_cur=_encode_field(u_cur.blocks[i]))
            if compensated:
                fields["comp_v"] = _encode_field(result.comp_v.blocks[i])
                fields["comp_carry"] = _encode_field(
                    carry.blocks[i] if carry is not None
                    else torch.zeros_like(u_cur.blocks[i]))
            name = _shard_filename(starts)
            clean_stale_tmps(name)
            # The writer thread writes this shard while the next one is
            # copied to the host.
            in_flight.append(nativeio.write_container(
                os.path.join(path_dir, name), fields, meta={"step": step}))
        for w in in_flight:
            nativeio.finish_container(w)
    except Exception:
        for w in in_flight:
            w.abort()
        raise
    # Every rank's shards are on disk before meta names their step.
    dist.barrier()
    if mesh.rank == 0:
        _write_meta(path_dir, clean_stale_tmps, step, topo, u_cur.dtype,
                    compensated, p)
    dist.barrier()
    seconds = time.perf_counter() - t0
    nbytes = _tree_bytes(path_dir)
    _record_io("save", "sharded", nbytes, seconds)
    tracing.event("checkpoint.save", kind="sharded", step=step,
                  bytes=nbytes, seconds=round(seconds, 6), path=path_dir)
    return path_dir


def _write_meta(path_dir, clean_stale_tmps, step, topo, dtype, compensated,
                problem) -> None:
    meta = os.path.join(path_dir, "meta.npz")
    clean_stale_tmps("meta.npz")
    tmp = f"{meta}.tmp-{os.getpid()}.npz"
    try:
        np.savez(tmp, format_version=_FORMAT_VERSION, step=step,
                 mesh_shape=np.asarray(topo.mesh_shape),
                 state_dtype=np.asarray(dtype_name(dtype)),
                 scheme=np.asarray("compensated" if compensated
                                   else "standard"),
                 **_problem_fields(problem))
        os.replace(tmp, meta)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_sharded_meta(path_dir: str):
    """Only a per-shard checkpoint's meta file: (problem, step, mesh_shape,
    state_dtype_name, scheme)."""
    with np.load(os.path.join(path_dir, "meta.npz")) as z:
        version = int(z["format_version"])
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {version} != supported {_FORMAT_VERSION}"
            )
        problem = _problem_from_npz(z)
        step = int(z["step"])
        mesh_shape = tuple(int(v) for v in z["mesh_shape"])
        state_dtype = _tag(z, "state_dtype")
        scheme = str(z["scheme"]) if "scheme" in z.files else "standard"
    return problem, step, mesh_shape, state_dtype, scheme


def mesh_devices(n: int, devices=None):
    """The devices of an n-shard mesh: `devices` as given (a device may
    repeat), or one visible card per shard - raising without a card or
    with too few, as the sharded solvers do."""
    from wavetpu_torch.solver import leapfrog

    devices = leapfrog.resolve_devices(devices)
    if len(devices) < n:
        raise ValueError(f"the checkpoint's mesh needs {n} devices, only "
                         f"{len(devices)} available")
    return devices[:n]


def load_sharded_checkpoint(path_dir: str, devices=None):
    """Load a per-shard checkpoint onto a device mesh: (problem, u_prev,
    u_cur, step, mesh_shape, scheme, aux), the fields `ShardedArray`s on
    the stored mesh shape over `devices` (`mesh_devices`), `aux` the
    compensated (comp_v, comp_carry) pair or None."""
    t0 = time.perf_counter()
    problem, step, mesh_shape, _, scheme = load_sharded_meta(path_dir)
    topo = Topology(N=problem.N, mesh_shape=mesh_shape)
    mesh = build_mesh(mesh_shape, mesh_devices(topo.n_devices, devices))
    compensated = scheme == "compensated"
    keys = ["u_prev", "u_cur"] + (["comp_v", "comp_carry"]
                                  if compensated else [])
    blocks = {key: [] for key in keys}

    def place(t, dev, name):
        if tuple(t.shape) != topo.block:
            raise ValueError(f"{name}: block shape {tuple(t.shape)} is not "
                             f"the mesh's {topo.block}")
        return t.to(dev)

    for i, (coord, dev) in enumerate(zip(mesh.coords, mesh.devices)):
        if not mesh.is_local(i):
            for key in keys:
                blocks[key].append(None)
            continue
        starts = _starts(topo, coord)
        wts_path = os.path.join(path_dir, _shard_filename(starts))
        legacy_path = os.path.join(path_dir, _legacy_shard_filename(starts))
        if os.path.exists(wts_path):
            fields, shard_meta = nativeio.read_container(wts_path)
            if shard_meta.get("step") == step:
                for key in keys:
                    arr, dt = fields[key]
                    blocks[key].append(place(_decode_field(arr, dt), dev,
                                             wts_path))
                continue
            # A WTS1 save overwriting a legacy .npz checkpoint was
            # preempted: fall back to the legacy shard only when it
            # carries meta's step.
            if not _legacy_shard_has_step(legacy_path, step):
                raise ValueError(
                    f"shard {_shard_filename(starts)} holds step "
                    f"{shard_meta.get('step')} but meta says {step}: "
                    f"checkpoint was interrupted mid-save; discard it "
                    f"(if this directory held an older .npz checkpoint, "
                    f"its shards may still be intact and recoverable)"
                )
        if not os.path.exists(legacy_path):
            raise FileNotFoundError(f"checkpoint shard missing: {wts_path}")
        with np.load(legacy_path) as z:
            if "step" in z.files and int(z["step"]) != step:
                raise ValueError(
                    f"shard {_legacy_shard_filename(starts)} holds step "
                    f"{int(z['step'])} but meta says {step}: checkpoint "
                    f"was interrupted mid-save; discard it"
                )
            for key in keys:
                blocks[key].append(place(
                    _decode_field(z[key], _tag(z, f"{key}_dtype")), dev,
                    legacy_path))

    def sharded(key):
        return ShardedArray(blocks[key], topo, mesh)

    aux = (sharded("comp_v"), sharded("comp_carry")) if compensated else None
    _record_io("load", "sharded", _tree_bytes(path_dir),
               time.perf_counter() - t0)
    return (problem, sharded("u_prev"), sharded("u_cur"), step, mesh_shape,
            scheme, aux)


def resume_solve(path: str, dtype=None, compute_errors: bool = True,
                 device=None, kernel: str = "pallas"):
    """Load a single-device checkpoint and march from its step to
    `problem.timesteps` under its scheme: a compensated checkpoint
    re-enters the 1-step compensated march from (u, v, carry)
    (`leapfrog.resume_compensated`), a standard one the leapfrog march
    (`leapfrog.resume`).  `dtype` defaults to the stored arrays'."""
    from wavetpu_torch.solver import leapfrog

    problem, u_prev, u_cur, step = load_checkpoint(path)
    dtype = u_cur.dtype if dtype is None else dtype
    if checkpoint_scheme(path) == "compensated":
        v, carry = load_checkpoint_aux(path)
        return leapfrog.resume_compensated(
            problem, u_cur, v, carry, start_step=step, dtype=dtype,
            compute_errors=compute_errors, device=device, kernel=kernel)
    return leapfrog.resume(problem, u_prev, u_cur, start_step=step,
                           dtype=dtype, compute_errors=compute_errors,
                           device=device, kernel=kernel)


def resume_sharded_solve(path_dir: str, dtype=None, kernel: str = "pallas",
                         overlap: bool = False, compute_errors: bool = True,
                         devices=None):
    """Load a per-shard checkpoint and march to problem.timesteps with the
    1-step sharded march (K6, K7 compensated) on the mesh it was saved
    from, under the scheme it was saved with."""
    from wavetpu_torch.solver import sharded

    problem, u_prev, u_cur, step, mesh_shape, scheme, aux = (
        load_sharded_checkpoint(path_dir, devices))
    comp_v, comp_carry = aux if aux is not None else (None, None)
    return sharded.resume_sharded(
        problem, u_prev, u_cur, start_step=step, mesh_shape=mesh_shape,
        devices=list(u_cur.mesh.devices),
        dtype=u_cur.dtype if dtype is None else dtype, kernel=kernel,
        overlap=overlap if scheme == "standard" else False,
        compute_errors=compute_errors, scheme=scheme, comp_v=comp_v,
        comp_carry=comp_carry)

