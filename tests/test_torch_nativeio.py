"""The port's WTS1 container and its C++ writer (wavetpu_torch/io/nativeio.py,
io/native/ckptio.cc) against wavetpu's (wavetpu/io/nativeio.py) on the CPU.

The format is wavetpu's byte for byte: the same arrays and meta written by
either package's writer - the port's native one or its pure-Python
fallback - give identical files, and each package reads the other's.
"""

import os
import zlib

import numpy as np
import pytest

from wavetpu.io import nativeio as jnative
from wavetpu_torch.io import nativeio


@pytest.fixture
def fallback(monkeypatch):
    """Force the pure-Python writer (as where no compiler exists)."""
    monkeypatch.setattr(nativeio, "_lib", None)
    monkeypatch.setattr(nativeio, "_lib_tried", True)


def arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "u_prev": (rng.standard_normal((4, 6, 5)).astype(np.float32),
                   "float32"),
        "u_cur": (rng.standard_normal((4, 6, 5)), "float64"),
        "comp_carry": (rng.integers(0, 2**16, (4, 6, 5), dtype=np.uint16),
                       "bfloat16"),
    }


def test_native_builds_into_the_build_directory():
    from wavetpu_torch.kernels import build

    assert nativeio.native_available()
    path = nativeio.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == str(build.build_dir())
    assert not path.startswith(os.path.dirname(jnative.__file__))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000, 1 << 16])
def test_crc32_matches_zlib(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    assert nativeio.crc32(data.tobytes()) == zlib.crc32(data.tobytes())
    seed = 0x1234ABCD
    assert nativeio.crc32(data.tobytes(), seed) == zlib.crc32(
        data.tobytes(), seed)


def _roundtrip(tmp_path):
    path = str(tmp_path / "a.wts")
    crc = nativeio.write_container_sync(path, arrays(), {"step": 7})
    fields, meta = nativeio.read_container(path)
    assert meta == {"step": 7}
    for name, (arr, tag) in arrays().items():
        got, got_tag = fields[name]
        assert got_tag == tag
        np.testing.assert_array_equal(got, arr)
        assert got.dtype == (np.uint16 if tag == "bfloat16" else arr.dtype)
    with open(path, "rb") as f:
        blob = f.read()
    assert crc == zlib.crc32(blob[:-12])
    assert not [e for e in os.listdir(tmp_path) if ".tmp-" in e]


def test_writer_roundtrip_native(tmp_path):
    assert nativeio.native_available()
    _roundtrip(tmp_path)


def test_writer_roundtrip_python(tmp_path, fallback):
    assert not nativeio.native_available()
    _roundtrip(tmp_path)


@pytest.mark.parametrize("writer", ["native", "python"])
def test_bytes_identical_to_wavetpu(tmp_path, writer, monkeypatch):
    if writer == "python":
        monkeypatch.setattr(nativeio, "_lib", None)
        monkeypatch.setattr(nativeio, "_lib_tried", True)
    meta = {"step": 12, "note": "x"}
    ours, ref = str(tmp_path / "ours.wts"), str(tmp_path / "ref.wts")
    nativeio.write_container_sync(ours, arrays(3), meta)
    jnative.write_container_sync(ref, arrays(3), meta)
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    # Each package reads the other's file.
    for reader, path in ((nativeio, ref), (jnative, ours)):
        fields, got_meta = reader.read_container(path)
        assert got_meta == meta
        np.testing.assert_array_equal(fields["u_cur"][0],
                                      arrays(3)["u_cur"][0])


def test_native_and_python_writers_bytes_identical(tmp_path, monkeypatch):
    a, b = str(tmp_path / "n.wts"), str(tmp_path / "p.wts")
    nativeio.write_container_sync(a, arrays(5), {"step": 1})
    monkeypatch.setattr(nativeio, "_lib", None)
    monkeypatch.setattr(nativeio, "_lib_tried", True)
    nativeio.write_container_sync(b, arrays(5), {"step": 1})
    assert open(a, "rb").read() == open(b, "rb").read()


def test_corruption_rejected(tmp_path):
    from wavetpu_torch.run import faults

    path = str(tmp_path / "c.wts")
    nativeio.write_container_sync(path, arrays(), {"step": 1})
    faults.flip_byte(path)
    with pytest.raises(ValueError, match="CRC mismatch"):
        nativeio.read_container(path)
    # The forensic mode skips the CRC and reads the (corrupt) payload.
    fields, _ = nativeio.read_container(path, verify=False)
    assert set(fields) == set(arrays())


@pytest.mark.parametrize("drop", [4, 12, 200])
def test_truncation_rejected(tmp_path, drop):
    from wavetpu_torch.run import faults

    path = str(tmp_path / "t.wts")
    nativeio.write_container_sync(path, arrays(), {"step": 1})
    faults.truncate_tail(path, drop_bytes=drop)
    with pytest.raises(ValueError, match="truncated|not a WTS1"):
        nativeio.read_container(path)


def test_foreign_file_rejected(tmp_path):
    path = tmp_path / "f.wts"
    path.write_bytes(b"PK\x03\x04" + b"\0" * 64)
    with pytest.raises(ValueError, match="not a WTS1"):
        nativeio.read_container(str(path))


def test_write_after_finish_raises_and_abort_leaves_no_temp(tmp_path):
    w = nativeio.AsyncFileWriter(str(tmp_path / "w.bin"))
    w.write(b"abc")
    w.finish()
    with pytest.raises(IOError):
        w.write(b"more")
    assert (tmp_path / "w.bin").read_bytes() == b"abc"
    w = nativeio.AsyncFileWriter(str(tmp_path / "x.bin"))
    w.write(np.arange(10, dtype=np.float32))
    w.abort()
    assert not os.path.exists(tmp_path / "x.bin")
    assert not [e for e in os.listdir(tmp_path) if ".tmp-" in e]
