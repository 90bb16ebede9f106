"""The port's persistent program cache (serve/progcache.py): the intent of
wavetpu's tests/test_progcache.py, on the CPU.

On the CPU the payload holds no library (the plain versions need no
build), so store, load, adoption, GC, the corruption drills and the
warmup round trip run for real; the library half of adoption - bytes
checked against their sha256 and their hashed name, placed atomically in
the build directory - is held here on arbitrary bytes, and loading them is
left to the card (tests/test_torch_gpu.py).  Both of wavetpu's `TestGC`
cases pass on the port (wavetpu's own fail on this jax: its `put` needs
an AOT probe the port does not have).
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from wavetpu_torch.core.problem import Problem
from wavetpu_torch.ensemble import batched as eb
from wavetpu_torch.kernels import build
from wavetpu_torch.obs import ledger, telemetry
from wavetpu_torch.run import faults
from wavetpu_torch.serve import progcache
from wavetpu_torch.serve.engine import ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_problem():
    return Problem(N=8, timesteps=4)


def _engine(d=None, **kw):
    eng = ServeEngine(bucket_sizes=(1,), device="cpu",
                      program_cache_dir=d, **kw)
    eng.keep_final_state = True
    return eng


def _solve(engine, timing=None, path="roll", k=1):
    result, health = engine.solve(_tiny_problem(), [eb.LaneSpec()],
                                  path=path, k=k, timing=timing)
    assert health == [None]
    return result.results[0].u_cur.numpy()


def _key(**over):
    base = dict(
        N=8, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=4,
        scheme="standard", path="roll", k=1, dtype="f32",
        with_field=False, compute_errors=True, batch=1, mesh=None,
    )
    base.update(over)
    return base


def _payload(n_bytes=4096):
    """A payload of one arbitrary library (never loaded on the CPU)."""
    data = b"x" * n_bytes
    return {"libraries": [{
        "name": "stencil", "file": build.lib_path("stencil").name,
        "data": data, "sha256": hashlib.sha256(data).hexdigest()}],
        "insts": []}


class TestDiskTier:
    @pytest.mark.parametrize("path,k", [("roll", 1), ("pallas", 1),
                                        ("kfused", 4)])
    def test_second_engine_adopts_from_disk_bitwise(self, tmp_path, path,
                                                    k):
        """Engine A builds and stores; engine B (a restarted replica)
        adopts from disk with zero fresh builds, bit for bit a fresh
        twin's answer."""
        d = str(tmp_path / "cache")
        a = _engine(d)
        t = {}
        u_a = _solve(a, t, path, k)
        assert t["warm"] == "false"
        assert a.misses == 1 and a.disk_hits == 0
        assert a.progcache.counts.get("store") == 1
        b = _engine(d)
        t = {}
        u_b = _solve(b, t, path, k)
        assert t["warm"] == "disk"
        assert b.misses == 0 and b.disk_hits == 1
        u_fresh = _solve(_engine(), None, path, k)
        assert np.array_equal(u_a, u_b) and np.array_equal(u_b, u_fresh)

    def test_memory_hit_still_wins_over_disk(self, tmp_path):
        eng = _engine(str(tmp_path / "cache"))
        _solve(eng)
        t = {}
        _solve(eng, t)
        assert t["warm"] == "true"
        assert eng.hits == 1 and eng.disk_hits == 0

    def test_cache_stats_exposes_disk_tier(self, tmp_path):
        eng = _engine(str(tmp_path / "cache"))
        _solve(eng)
        stats = eng.cache_stats()
        pc = stats["progcache"]
        assert pc["enabled"] is True and pc["aot"] is True
        assert pc["xla_cache"] is False and pc["xla_fallback"] is False
        assert pc["entries"] == 1 and pc["bytes"] > 0
        assert pc["aot_probes"][0]["ok"] is True
        assert stats["warm_keys"]["disk"] == [_key()]
        assert _engine().cache_stats()["progcache"] == {"enabled": False}

    def test_disk_hit_writes_source_disk_ledger_line(self, tmp_path):
        d = str(tmp_path / "cache")
        _solve(_engine(d))
        tel_d = str(tmp_path / "tel")
        tel = telemetry.start(tel_d, interval=60.0)
        try:
            _solve(_engine(d))
        finally:
            tel.stop()
        entries = ledger.load_ledger(
            os.path.join(tel_d, ledger.LEDGER_FILENAME))
        assert [e.get("source") for e in entries] == ["disk"]
        assert entries[0]["fresh_compile_s"] is not None

    def test_chunk_runner_key_adopts_from_disk(self, tmp_path):
        d = str(tmp_path / "cache")
        p = Problem(N=8, timesteps=17)
        _, source, _ = _engine(d).chunk_runner(p, "standard", "roll", 1,
                                               "f32", 4)
        assert source == "fresh"
        eng = _engine(d)
        runner, source, _ = eng.chunk_runner(p, "standard", "roll", 1,
                                             "f32", 4)
        assert source == "disk" and eng.misses == 0
        assert runner.chunk_len == 4
        assert eng.cache_stats()["warm_keys"]["disk"][0]["path"] == \
            "roll@chunk4"


class TestCorruptionDrills:
    def _warm_cache(self, tmp_path):
        d = str(tmp_path / "cache")
        return d, _solve(_engine(d))

    def test_truncated_entry_is_counted_miss(self, tmp_path):
        d, u_ref = self._warm_cache(tmp_path)
        (entry,) = [os.path.join(d, n) for n in os.listdir(d)
                    if n.endswith(progcache.ENTRY_SUFFIX)]
        faults.truncate_tail(entry, drop_bytes=16)
        eng = _engine(d)
        t = {}
        u = _solve(eng, t)
        assert t["warm"] == "false"
        assert eng.misses == 1 and eng.disk_hits == 0
        assert eng.progcache.counts.get("corrupt") == 1
        # The fresh build re-stores a good entry.
        assert eng.progcache.counts.get("store") == 1
        again = _engine(d)
        t = {}
        u2 = _solve(again, t)
        assert t["warm"] == "disk"
        assert np.array_equal(u, u_ref) and np.array_equal(u2, u_ref)

    def test_fault_harness_truncate_counted_never_breaker(self, tmp_path):
        d, _ = self._warm_cache(tmp_path)
        plan = faults.parse_serve_spec("serve-progcache-truncate:count=1")
        eng = _engine(d, fault_plan=plan)
        t = {}
        _solve(eng, t)
        assert t["warm"] == "false"
        assert eng.progcache.counts.get("corrupt") == 1
        snap = eng.breaker.snapshot()
        assert snap["open"] == 0 and snap["keys"] == []

    def test_fault_harness_fingerprint_mismatch(self, tmp_path):
        d, _ = self._warm_cache(tmp_path)
        plan = faults.parse_serve_spec(
            "serve-progcache-fingerprint:count=1")
        eng = _engine(d, fault_plan=plan)
        t = {}
        _solve(eng, t)
        assert t["warm"] == "false"
        assert eng.progcache.counts.get("fingerprint_mismatch") == 1
        assert eng.breaker.snapshot()["open"] == 0
        t = {}
        _solve(_engine(d, fault_plan=plan), t)
        assert t["warm"] == "disk"

    def test_env_fingerprint_keys_the_filename(self, tmp_path):
        cache = progcache.ProgramCache(str(tmp_path / "c"))
        assert cache.put(_key(), _payload(64), 1.0)
        other = progcache.ProgramCache(str(tmp_path / "c"))
        other._fp_hash = "deadbeef"
        assert other.load(_key()) is None
        assert other.counts.get("fingerprint_mismatch") == 1
        assert other.load(_key(batch=2)) is None
        assert other.counts.get("disk_miss") == 1

    def test_edited_kernel_source_is_a_counted_mismatch(self, tmp_path,
                                                        monkeypatch):
        """An edited csrc source changes the fingerprint: the old entry is
        never adopted, and the load counts `fingerprint_mismatch`."""
        d, _ = self._warm_cache(tmp_path)
        fp = progcache.env_fingerprint("cpu")
        monkeypatch.setattr(progcache, "_csrc_sha256", lambda: "0" * 64)
        assert progcache.env_fingerprint("cpu") != fp
        eng = _engine(d)
        t = {}
        _solve(eng, t)
        assert t["warm"] == "false"
        assert eng.progcache.counts.get("fingerprint_mismatch") == 1

    def test_fingerprint_fields(self):
        fp = progcache.env_fingerprint("cpu")
        assert tuple(sorted(fp)) == tuple(sorted(
            progcache.FINGERPRINT_FIELDS))
        assert fp["device_name"].startswith("cpu")
        assert fp["nvcc_flags"] == " ".join(build.NVCC_FLAGS)

    def test_failed_adopt_builds_fresh_never_plain(self, tmp_path,
                                                   monkeypatch):
        """A library that does not check out is a counted `corrupt`, then
        the normal build path: nvcc, which raises without nvcc - never the
        plain versions."""
        d = str(tmp_path / "cache")
        monkeypatch.setenv("WAVETPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
        monkeypatch.setattr(eb.EnsembleSolver, "libraries",
                            property(lambda self: ("stencil",)))

        def no_nvcc():
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(build, "find_nvcc", no_nvcc)
        eng = _engine(d)
        bad = _payload()
        bad["libraries"][0]["sha256"] = "0" * 64
        eng.progcache.put(_key(), bad, 1.0)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _solve(eng)
        assert eng.progcache.counts.get("corrupt") == 1
        assert eng.disk_hits == 0 and eng.misses == 1
        # Nothing of the refused entry was placed in the build directory.
        build_dir = tmp_path / "b"
        assert not build_dir.exists() or not os.listdir(build_dir)


class TestLibraryAdopt:
    """The library half of adoption, on arbitrary bytes in a temporary
    build directory (loading is the card's)."""

    def test_install_checks_hash_and_name_atomically(self, tmp_path,
                                                     monkeypatch):
        monkeypatch.setenv("WAVETPU_TORCH_BUILD_DIR", str(tmp_path))
        payload = _payload(1000)
        lib = payload["libraries"][0]
        assert build.install("stencil", lib["file"], lib["data"],
                             lib["sha256"]) == "written"
        out = tmp_path / lib["file"]
        assert out.read_bytes() == lib["data"]
        assert os.listdir(tmp_path) == [lib["file"]]  # no temp left
        assert build.install("stencil", lib["file"], lib["data"],
                             lib["sha256"]) == "present"
        with pytest.raises(ValueError, match="sha256"):
            build.install("stencil", lib["file"], b"y", lib["sha256"])
        with pytest.raises(ValueError, match="this checkout builds"):
            build.install("stencil", "libstencil-0000.so", lib["data"],
                          lib["sha256"])

    def test_loaded_library_is_kept(self, tmp_path, monkeypatch):
        monkeypatch.setenv("WAVETPU_TORCH_BUILD_DIR", str(tmp_path))
        monkeypatch.setitem(build._libs, "stencil", object())
        lib = _payload()["libraries"][0]
        assert build.install("stencil", lib["file"], lib["data"],
                             lib["sha256"]) == "memory"
        assert not os.listdir(tmp_path)

    def test_adopt_refuses_before_writing(self, tmp_path, monkeypatch):
        monkeypatch.setenv("WAVETPU_TORCH_BUILD_DIR", str(tmp_path))
        stale = _payload()
        stale["libraries"][0]["file"] = "libstencil-0000000000000000.so"
        with pytest.raises(progcache.FingerprintMismatch):
            progcache.adopt_libraries(stale, ("stencil",))
        bad = _payload()
        bad["libraries"][0]["data"] = b"z" * 10
        with pytest.raises(ValueError, match="sha256"):
            progcache.adopt_libraries(bad, ("stencil",))
        with pytest.raises(ValueError, match="lacks"):
            progcache.adopt_libraries(_payload(), ("stencil", "sharded"))
        assert not os.listdir(tmp_path)

    def test_payload_round_trip(self):
        p = _payload(300)
        p["insts"] = [["step", 0, 1]]
        back = progcache.decode_payload(progcache.encode_payload(p))
        assert back["insts"] == [["step", 0, 1]]
        assert back["libraries"][0]["data"] == p["libraries"][0]["data"]
        with pytest.raises(ValueError):
            progcache.decode_payload(progcache.encode_payload(p) + b"!")


class TestGC:
    def test_over_budget_evicts_oldest_newest_survives(self, tmp_path):
        cache = progcache.ProgramCache(str(tmp_path / "c"))
        paths = []
        for i in range(3):
            k = _key(batch=i + 1)
            assert cache.put(k, _payload(4096), 1.0)
            p = cache.entry_path(k)
            os.utime(p, (100.0 + i, 100.0 + i))  # deterministic LRU
            paths.append(p)
        sizes = [os.path.getsize(p) for p in paths]
        cache.max_bytes = sizes[1] + sizes[2]  # room for exactly two
        assert cache.gc() == 1
        assert not os.path.exists(paths[0])
        assert os.path.exists(paths[1]) and os.path.exists(paths[2])
        assert cache.counts.get("gc_evict") == 1

    def test_budget_smaller_than_one_entry_keeps_latest(self, tmp_path):
        cache = progcache.ProgramCache(str(tmp_path / "c"), max_bytes=1)
        for i in range(2):
            k = _key(batch=i + 1)
            cache.put(k, _payload(4096), 1.0)
            os.utime(cache.entry_path(k), (100.0 + i, 100.0 + i))
        cache.gc()
        remaining = [n for n in os.listdir(cache.directory)
                     if n.endswith(progcache.ENTRY_SUFFIX)]
        assert len(remaining) == 1  # keep-latest, never keep-nothing
        assert os.path.basename(cache.entry_path(_key(batch=2))) in \
            remaining

    def test_hit_refreshes_lru_clock(self, tmp_path):
        cache = progcache.ProgramCache(str(tmp_path / "c"))
        for i in range(2):
            k = _key(batch=i + 1)
            cache.put(k, _payload(64), 1.0)
            os.utime(cache.entry_path(k), (100.0 + i, 100.0 + i))
        assert cache.load(_key(batch=1)) is not None  # touch the oldest
        entries = sorted(cache._entries(), key=lambda e: e[2])
        assert entries[-1][0] == cache.entry_path(_key(batch=1))


def _manifest(tmp_path, keys=None):
    lp = str(tmp_path / "compile_ledger.jsonl")
    led = ledger.CompileLedger(lp)
    for k in keys or [_key()]:
        led.record(k, 1.0, ts=1.0, pid=1)
    led.close()
    mp = str(tmp_path / "warmup_manifest.json")
    assert ledger.main([lp, "--emit-warmup-manifest", mp]) == 0
    return mp


class TestWarmupCLI:
    def test_round_trip_second_run_all_disk_hits(self, tmp_path, capsys):
        mp = _manifest(tmp_path, [_key(), _key(path="kfused", k=4,
                                              timesteps=9, batch=2)])
        d = str(tmp_path / "cache")
        argv = ["--manifest", mp, "--program-cache-dir", d,
                "--platform", "cpu"]
        assert progcache.main(argv) == 0
        out = capsys.readouterr().out
        assert "compiled" in out and "-> cached" in out
        assert progcache.main(argv) == 0
        assert "2 disk hit(s), 0 compiled" in capsys.readouterr().out

    def test_manifest_matches_wavetpu(self, tmp_path):
        """The manifest is wavetpu's shape, key for key: wavetpu's
        ledger-report emits the same keys from the same ledger, and each
        round-trips through both packages' ProgramKey."""
        from wavetpu.obs import ledger as wledger

        mp = _manifest(tmp_path)
        wp = str(tmp_path / "w.json")
        assert wledger.main([str(tmp_path / "compile_ledger.jsonl"),
                             "--emit-warmup-manifest", wp]) == 0
        mine, theirs = (json.load(open(p)) for p in (mp, wp))
        assert mine["keys"] == theirs["keys"]
        assert set(mine) == set(theirs)
        assert progcache.load_manifest(wp)["keys"] == mine["keys"]

    def test_usage_errors(self, tmp_path, capsys):
        assert progcache.main([]) == 2
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        assert progcache.main(["--manifest", str(bad)]) == 2
        assert progcache.main(
            ["--manifest", str(tmp_path / "missing.json")]) == 2
        assert progcache.main(["--manifest", _manifest(tmp_path),
                               "--platform", "tpu"]) == 2
        capsys.readouterr()

    def test_oversized_mesh_key_skipped_not_failed(self, tmp_path,
                                                   capsys):
        manifest = {
            ledger.MANIFEST_FLAG: True, "version": 1,
            "keys": [ledger.normalize_key(_key(mesh=[64, 64, 64]))],
        }
        mp = str(tmp_path / "m.json")
        with open(mp, "w") as f:
            json.dump(manifest, f)
        assert progcache.main(["--manifest", mp, "--program-cache-dir",
                               str(tmp_path / "c"), "--platform",
                               "cpu"]) == 0
        assert "skip (mesh needs" in capsys.readouterr().out

    def test_without_a_card_exits_2(self, tmp_path, capsys):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        assert progcache.main(["--manifest", _manifest(tmp_path)]) == 2
        assert "no CUDA device" in capsys.readouterr().err


class TestCrossProcess:
    def test_subprocess_warms_parent_serves_zero_fresh(self, tmp_path):
        """A subprocess fills the cache through `python -m wavetpu_torch
        warmup` from a ledger-report manifest; this process then serves
        the tier with zero fresh builds, a ledger of only `source: disk`,
        and an answer bit for bit a fresh twin's."""
        mp = _manifest(tmp_path)
        d = str(tmp_path / "cache")
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.run(
            [sys.executable, "-m", "wavetpu_torch", "warmup",
             "--manifest", mp, "--program-cache-dir", d, "--platform",
             "cpu"], capture_output=True, text=True, env=env, timeout=300,
            cwd=ROOT)
        assert proc.returncode == 0, proc.stderr
        assert "1 compiled" in proc.stdout
        assert any(n.endswith(progcache.ENTRY_SUFFIX)
                   for n in os.listdir(d))
        tel_d = str(tmp_path / "tel")
        tel = telemetry.start(tel_d, interval=60.0)
        try:
            eng = _engine(d)
            t = {}
            u = _solve(eng, t)
        finally:
            tel.stop()
        assert t["warm"] == "disk"
        assert eng.misses == 0 and eng.disk_hits == 1
        entries = ledger.load_ledger(
            os.path.join(tel_d, ledger.LEDGER_FILENAME))
        assert {e.get("source") for e in entries} == {"disk"}
        assert np.array_equal(u, _solve(_engine()))


class TestMeasuredLedger:
    def test_aggregate_partitions_disk_records(self):
        old = [
            {"key": _key(), "compile_s": 30.0, "cold": True,
             "ts": 1.0, "pid": 1},
            {"key": _key(), "compile_s": 28.0, "cold": True,
             "ts": 10.0, "pid": 2},
        ]
        mixed = old + [
            {"key": _key(), "compile_s": 0.05, "cold": True,
             "ts": 20.0, "pid": 3, "source": "disk",
             "fresh_compile_s": 28.0},
            {"key": _key(batch=8), "compile_s": 0.02, "cold": True,
             "ts": 21.0, "pid": 3, "source": "disk"},
        ]
        base = ledger.aggregate(old)
        agg = ledger.aggregate(mixed)
        mp = agg.pop("measured_persistent_cache")
        base.pop("measured_persistent_cache")
        assert agg == base
        assert mp["disk_hits"] == 2
        assert mp["load_s"] == pytest.approx(0.07)
        assert mp["measured_saved_s"] == pytest.approx(28.0 - 0.05)
        assert mp["unattributed_hits"] == 1

    def test_report_line_only_with_disk_hits(self):
        recs = [{"key": _key(), "compile_s": 30.0, "cold": True,
                 "ts": 1.0, "pid": 1}]
        assert "measured persistent cache" not in ledger.format_report(
            ledger.aggregate(recs))
        recs.append({"key": _key(), "compile_s": 0.05, "cold": True,
                     "ts": 2.0, "pid": 2, "source": "disk",
                     "fresh_compile_s": 30.0})
        assert "measured persistent cache: 1 disk hit(s)" in \
            ledger.format_report(ledger.aggregate(recs))

    def test_saved_seconds_metric_credits_disk_hits(self, tmp_path):
        d = str(tmp_path / "cache")
        cache = progcache.ProgramCache(d)
        assert cache.put(_key(), {"libraries": [], "insts": []}, 5.0)
        eng = _engine(d)
        _solve(eng)
        assert eng.disk_hits == 1
        saved = eng.registry.counter(
            "wavetpu_progcache_saved_seconds_total", "")
        assert 4.0 < saved.value() <= 5.0


class TestCLIProgramCache:
    def test_solo_cli_stores_then_adopts(self, tmp_path, capsys):
        from wavetpu_torch import cli

        argv = ["8", "1", "1", "1", "1", "1", "4", "--platform", "cpu",
                "--out-dir", str(tmp_path), "--program-cache-dir",
                str(tmp_path / "pc")]
        assert cli.main(argv) == 0
        assert "program cache:" in capsys.readouterr().out
        assert len(os.listdir(tmp_path / "pc")) == 1
        assert cli.main(argv) == 0
        assert "[adopted:" in capsys.readouterr().out
