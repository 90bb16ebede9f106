"""Native checkpoint IO: async writer, CRC32, shard container (the port's
copy of wavetpu/io/nativeio.py; the on-disk format is the same, byte for
byte).

The C++ side (`native/ckptio.cc`) is a background-thread file writer with
zlib-compatible CRC32 and atomic temp-file rename - the runtime IO layer
the reference keeps in C++ (its variants are C++ binaries writing their own
output files, openmp_sol.cpp:216-243).  It is compiled on first use with
g++ (no pip deps, ctypes binding, ~1 s) into the kernels' build directory
(`kernels/build.build_dir()`: `kernels/_build/` inside the checkout, which
git ignores, or WAVETPU_TORCH_BUILD_DIR), as `libckptio-<hash>.so` with a
hash of the source and the flags, so an edited source rebuilds.  When no
compiler is available every entry point falls back to a pure-Python
implementation that produces byte-identical files, so the container format
below is THE format, not "the native format".

Shard container ("WTS1"): the per-shard checkpoint file written by
io/checkpoint.py's sharded path.  Layout:

    8  bytes   magic  b"WTSCKPT1"
    4  bytes   u32 little-endian header length H
    H  bytes   UTF-8 JSON: {"arrays": [{name, dtype, shape, nbytes}...],
                            "meta": {...}}   (offsets implicit, in order)
    payloads   raw C-order array bytes, in header order
    12 bytes   footer: u32 CRC32 of everything before the footer + b"WTSEND\x00\x00"

One CRC covers header+payloads, so a torn or bit-flipped file is detected
at load; the atomic rename means a file with the final name is always
complete (reader double-checks via the footer magic + CRC anyway).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import subprocess
import sys
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from wavetpu_torch.kernels import build

_MAGIC = b"WTSCKPT1"
_FOOTER_MAGIC = b"WTSEND\x00\x00"

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "ckptio.cc")
_GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lib = None
_lib_tried = False


def lib_path() -> str:
    """Where the built library lives: the kernels' build directory, named
    by a hash of the source and the flags."""
    h = hashlib.sha256(open(_SRC, "rb").read())
    h.update(" ".join(_GXX_FLAGS).encode())
    return str(build.build_dir() / f"libckptio-{h.hexdigest()[:16]}.so")


def _load_native():
    """Compile (once) and dlopen the native library; None if unavailable.

    Build failures are demoted to the Python fallback with a one-line
    stderr note - checkpointing must never be the thing that kills a run.
    """
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        path = lib_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.build-{os.getpid()}"
            subprocess.run(
                ["g++", *_GXX_FLAGS, _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        lib.ckpt_writer_open.argtypes = [ctypes.c_char_p]
        lib.ckpt_writer_open.restype = ctypes.c_void_p
        lib.ckpt_writer_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64
        ]
        lib.ckpt_writer_write.restype = ctypes.c_int
        lib.ckpt_writer_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ckpt_writer_finish.restype = ctypes.c_int
        lib.ckpt_writer_abort.argtypes = [ctypes.c_void_p]
        lib.ckpt_writer_abort.restype = ctypes.c_int
        _lib = lib
    except Exception as e:  # missing g++, sandboxed fs, bad toolchain, ...
        print(f"wavetpu_torch: native ckpt IO unavailable ({e}); "
              f"using Python fallback", file=sys.stderr)
        _lib = None
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def crc32(data, seed: int = 0) -> int:
    """zlib's CRC32 of a buffer (it releases the GIL on large buffers, so
    a save's CRC pass overlaps the writer thread)."""
    return zlib.crc32(memoryview(data).cast("B"), seed) & 0xFFFFFFFF


class AsyncFileWriter:
    """Background-thread file writer with CRC32 and atomic rename.

    ZERO-COPY: every buffer passed to `write` must stay alive and
    unmodified until `finish`/`abort` returns (this class keeps Python
    references to enforce the lifetime half of that contract).  Falls back
    to synchronous Python IO when the native library is unavailable - the
    bytes on disk and the returned CRC are identical either way.
    """

    def __init__(self, final_path: str):
        self.final_path = final_path
        self.tmp_path = f"{final_path}.tmp-{os.getpid()}"
        self._bufs = []           # lifetime anchors for zero-copy chunks
        self._lib = _load_native()
        self._handle = None
        self._file = None
        self._crc = 0
        if self._lib is not None:
            self._handle = self._lib.ckpt_writer_open(
                self.tmp_path.encode()
            )
        if self._handle is None:
            self._lib = None
            self._file = open(self.tmp_path, "wb")

    def write(self, data) -> None:
        if self._lib is not None and self._handle is None:
            # finish()/abort() already ran; the native call would
            # dereference a NULL handle (SIGSEGV, not an exception).
            raise IOError("write after finish/abort")
        mv = memoryview(data).cast("B")
        if not mv.nbytes:
            return
        if self._lib is not None:
            # ctypes needs a raw address; a numpy view provides it without
            # copying (works for writable and read-only buffers alike).
            arr = np.frombuffer(mv, dtype=np.uint8)
            self._bufs.append(arr)  # lifetime anchor until finish/abort
            rc = self._lib.ckpt_writer_write(
                self._handle, arr.ctypes.data_as(ctypes.c_void_p), mv.nbytes
            )
            if rc != 0:
                raise IOError("ckpt_writer_write after close")
        else:
            self._file.write(mv)
            self._crc = zlib.crc32(mv, self._crc) & 0xFFFFFFFF

    def sync(self) -> int:
        """Drain and fsync the TEMP file (no rename); returns the stream
        CRC32.  The temp file stays on disk until `commit` renames it -
        callers that cross-check the CRC (finish_container) do so between
        the two phases, so a detected corruption can discard the temp file
        without having replaced the previous good file at `final_path`."""
        if self._lib is not None:
            crc = ctypes.c_uint64(0)
            # Renaming the temp file onto itself is a POSIX no-op, so the
            # native finish becomes drain+fsync+close with the temp kept.
            rc = self._lib.ckpt_writer_finish(
                self._handle, self.tmp_path.encode(), ctypes.byref(crc)
            )
            self._handle = None
            self._bufs.clear()
            if rc != 0:
                raise IOError(
                    f"native checkpoint write failed: errno {-rc} "
                    f"({os.strerror(-rc)})"
                )
            return int(crc.value) & 0xFFFFFFFF
        try:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
        except Exception:
            # Never leave the temp file behind.
            if not self._file.closed:
                self._file.close()
            if os.path.exists(self.tmp_path):
                os.remove(self.tmp_path)
            raise
        self._bufs.clear()
        return self._crc

    def commit(self) -> None:
        """Atomically rename the synced temp file to `final_path`."""
        try:
            os.replace(self.tmp_path, self.final_path)
        except Exception:
            # Keep the never-leave-a-temp-behind invariant on rename
            # failure (abort() is a no-op once sync() has closed the file).
            self.discard()
            raise

    def discard(self) -> None:
        """Remove the synced temp file (CRC cross-check failed)."""
        try:
            os.remove(self.tmp_path)
        except OSError:
            pass

    def finish(self) -> int:
        """Drain, fsync, atomically rename; returns the stream CRC32."""
        crc = self.sync()
        self.commit()
        return crc

    def abort(self) -> None:
        if self._lib is not None and self._handle is not None:
            self._lib.ckpt_writer_abort(self._handle)
            self._handle = None
        elif self._file is not None and not self._file.closed:
            self._file.close()
            if os.path.exists(self.tmp_path):
                os.remove(self.tmp_path)
        self._bufs.clear()


def write_container(
    path: str,
    arrays: Dict[str, Tuple[np.ndarray, str]],
    meta: Optional[dict] = None,
) -> "AsyncFileWriter":
    """Start writing a WTS1 container; returns the in-flight writer.

    `arrays` maps name -> (C-contiguous array, dtype tag); `meta` is small
    JSON-serializable data (e.g. the step index).  The caller overlaps
    further work with the disk write and completes the file with
    `finish_container` (or uses `write_container_sync`).  All chunks -
    including the CRC footer - are enqueued here; `finish_container` just
    drains, fsyncs, renames, and cross-checks the stream CRC.
    """
    entries = []
    payloads = []
    for name, (arr, tag) in arrays.items():
        arr = np.ascontiguousarray(arr)
        entries.append(dict(
            name=name, dtype=tag, shape=list(arr.shape),
            nbytes=int(arr.nbytes),
        ))
        payloads.append(arr)
    header = json.dumps(
        {"arrays": entries, "meta": meta or {}}, sort_keys=True
    ).encode()
    head = _MAGIC + struct.pack("<I", len(header)) + header

    w = AsyncFileWriter(path)
    try:
        # Enqueue everything first, THEN compute the footer CRC: the host
        # CRC pass runs concurrently with the writer thread's disk IO (the
        # thread computes its own stream CRC; finish cross-checks the two).
        w.write(head)
        for p in payloads:
            w.write(p)
        crc = crc32(head)
        for p in payloads:
            crc = crc32(p, crc)
        w.write(struct.pack("<I", crc) + _FOOTER_MAGIC)
    except Exception:
        w.abort()
        raise
    w._expected_crc = crc  # cross-checked in finish_container
    return w


def finish_container(w: "AsyncFileWriter") -> int:
    """Complete a `write_container` writer, verifying the stream CRC the
    writer thread computed against the host-side one BEFORE the rename.

    On a mismatch the temp file is discarded and the previous good file at
    the final name (if any) is left intact - a corrupt container never
    replaces a good shard."""
    stream_crc = w.sync()
    expected = crc32(
        struct.pack("<I", w._expected_crc) + _FOOTER_MAGIC, w._expected_crc
    )
    if stream_crc != expected:
        w.discard()
        raise IOError(
            f"checkpoint writer CRC mismatch on {w.final_path}: a buffer "
            f"was modified during the asynchronous write"
        )
    w.commit()
    return w._expected_crc


def write_container_sync(path, arrays, meta=None) -> int:
    return finish_container(write_container(path, arrays, meta))


def read_container(path: str, verify: bool = True):
    """Read a WTS1 container -> (dict name -> (array, dtype_tag), meta).

    With `verify`, the CRC footer is checked over the raw bytes - a torn
    or corrupted shard raises instead of resuming garbage.
    """
    # Read into writable memory, so the arrays below can back tensors
    # without a copy.
    blob = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        blob = blob[:f.readinto(blob)]
    if len(blob) < len(_MAGIC) + 4 + 12 or blob[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a WTS1 checkpoint container")
    if blob[-8:] != _FOOTER_MAGIC:
        raise ValueError(f"{path}: truncated checkpoint (no footer)")
    stored_crc = struct.unpack("<I", blob[-12:-8])[0]
    if verify:
        actual = crc32(memoryview(blob)[:-12])
        if actual != stored_crc:
            raise ValueError(
                f"{path}: checkpoint CRC mismatch "
                f"(stored {stored_crc:#010x}, actual {actual:#010x}) - "
                f"the file is corrupt; discard it"
            )
    hlen = struct.unpack("<I", blob[len(_MAGIC):len(_MAGIC) + 4])[0]
    hstart = len(_MAGIC) + 4
    payload_end = len(blob) - 12  # footer: u32 CRC + 8-byte magic
    # Structural bounds checks run even with verify=False (the documented
    # forensic mode): a malformed file must surface as this module's own
    # errors, not a raw json/numpy exception downstream.
    if hstart + hlen > payload_end:
        raise ValueError(
            f"{path}: truncated checkpoint (header length {hlen} exceeds "
            f"file payload)"
        )
    try:
        header = json.loads(blob[hstart:hstart + hlen].decode())
        entries = header["arrays"]
        meta = header["meta"]
        # Schema-check every field the loop below will access, so a
        # corrupt-but-parseable header also surfaces as this module's error.
        total = sum(int(e["nbytes"]) for e in entries)
        for e in entries:
            e["name"], list(e["shape"])
            if e["dtype"] != "bfloat16":
                np.dtype(e["dtype"])  # TypeError here, not in the loop
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        raise ValueError(
            f"{path}: corrupt checkpoint header ({e})"
        ) from None
    if hstart + hlen + total != payload_end:
        raise ValueError(
            f"{path}: truncated checkpoint (arrays declare {total} payload "
            f"bytes, file carries {payload_end - hstart - hlen})"
        )
    out = {}
    off = hstart + hlen
    for e in entries:
        nbytes = int(e["nbytes"])
        dtype = (
            np.dtype(np.uint16) if e["dtype"] == "bfloat16"
            else np.dtype(e["dtype"])
        )
        try:
            arr = np.frombuffer(
                blob, dtype=dtype, count=nbytes // dtype.itemsize, offset=off
            ).reshape(e["shape"])
        except ValueError as err:
            raise ValueError(
                f"{path}: corrupt checkpoint array {e.get('name')!r} ({err})"
            ) from None
        off += nbytes
        out[e["name"]] = (arr, e["dtype"])
    return out, meta
