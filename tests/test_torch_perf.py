"""The port's performance X-ray (wavetpu_torch/obs/perf.py) on the CPU: the
cost model against the bytes behind PERF.md §6's bound column
(chip_smoke.py phase 6), `solve_perf`'s fields, the CUDA-allocator memory
hook and its cached "unsupported" verdict without a card, and the
`profile` subcommand (mirroring tests/test_perf.py's intent).
"""

import json
import os

import pytest
import torch

from wavetpu.obs import perf as jperf
from wavetpu_torch import cli
from wavetpu_torch.obs import perf, tracing
from wavetpu_torch.obs.registry import MetricsRegistry

N = 512
CELLS = N ** 3

# Per-launch bytes of the sharded rows of PERF.md §6 (each input read
# once, each output written once; f32, a bf16 carry on K11/K12):
# (path, mesh, block, k, rows, field) -> bytes.
SHARDED_ROWS = [
    ("K6", "sharded", (2, 2, 1), (256, 256, 512), 1, False, False,
     404750336),
    ("K6f", "sharded", (2, 2, 1), (256, 256, 512), 1, False, True,
     538968064),
    ("K8", "sharded_kfused", (4, 1, 1), (128, 512, 512), 4, True, False,
     555751424),
    ("K8f", "sharded_kfused", (4, 1, 1), (128, 512, 512), 4, False, True,
     696254464),
    ("K9", "sharded_kfused", (1, 1, 1), (512, 510, 510), 4, True, False,
     2149490976),
    ("K9f", "sharded_kfused", (4, 1, 1), (128, 510, 510), 4, False, True,
     690825600),
    ("K10", "sharded_kfused", (2, 2, 1), (256, 256, 512), 4, True, False,
     554971136),
    ("K10f", "sharded_kfused", (2, 2, 1), (256, 256, 512), 4, False, True,
     696647680),
    ("K11", "kfused_comp_sharded", (4, 1, 1), (128, 512, 512), 4, True,
     False, 689969152),
    ("K11f", "kfused_comp_sharded", (4, 1, 1), (128, 512, 512), 4, False,
     True, 830472192),
    ("K12", "kfused_comp_sharded", (2, 2, 1), (256, 256, 512), 4, True,
     False, 689188864),
    ("K12f", "kfused_comp_sharded", (2, 2, 1), (256, 256, 512), 4, False,
     True, 830865408),
]


@pytest.mark.parametrize("kw,per_launch_cell", [
    (dict(path="leapfrog"), 12.0),                          # K1
    (dict(path="leapfrog", with_field=True), 16.0),         # K5
    (dict(path="compensated", scheme="compensated"), 24.0),  # K2
    (dict(path="kfused", k=4), 16.0),                       # K3
    (dict(path="kfused", k=4, with_field=True), 20.0),      # K3f
    (dict(path="kfused_comp", scheme="compensated", k=4), 20.0),  # K4
    (dict(path="kfused_comp", scheme="compensated", k=4,
          with_field=True), 24.0),                          # K4f
    (dict(path="leapfrog", itemsize=8), 24.0),              # f64
    (dict(path="leapfrog", itemsize=2, with_field=True), 10.0),  # bf16
], ids=["K1", "K5", "K2", "K3", "K3f", "K4", "K4f", "K1-f64", "K5-bf16"])
def test_whole_state_models_are_the_bound_bytes(kw, per_launch_cell):
    """K1 12 B/cell, K3 16 B per cell of one k=4 launch, K4 20 B (f32 u/v,
    bf16 carry) - PERF.md §6's bound bytes, per cell update here."""
    path = kw.pop("path")
    k = kw.get("k", 1)
    bpc = perf.model_bytes_per_cell(path, n=N, **kw)
    assert bpc * k == pytest.approx(per_launch_cell)


@pytest.mark.parametrize(
    "name,path,mesh,block,k,rows,field,nbytes", SHARDED_ROWS,
    ids=[r[0] for r in SHARDED_ROWS])
def test_sharded_models_are_the_launch_bytes(name, path, mesh, block, k,
                                             rows, field, nbytes):
    scheme = "compensated" if "comp" in path else "standard"
    bpc = perf.model_bytes_per_cell(path, scheme=scheme, k=k, n=N,
                                    block=block, mesh_shape=mesh, rows=rows,
                                    with_field=field)
    cells = block[0] * block[1] * block[2]
    assert round(bpc * k * cells) == nbytes


def test_k7_launch_bytes():
    assert perf.launch_bytes("comp_step", (256, 256, 512),
                             ghost_axes=(0, 1)) == 807403520


def test_carry_less_and_carry_dtype_models():
    base = perf.model_bytes_per_cell("kfused_comp", scheme="compensated",
                                     k=4, n=N)
    no_carry = perf.model_bytes_per_cell("kfused_comp",
                                         scheme="compensated", k=4, n=N,
                                         carry=False, v_itemsize=2)
    f32_carry = perf.model_bytes_per_cell("kfused_comp",
                                          scheme="compensated", k=4, n=N,
                                          carry_itemsize=4)
    assert base * 4 == 20.0 and no_carry * 4 == 12.0
    assert f32_carry * 4 == 24.0


def test_no_model_without_a_shape():
    assert perf.model_bytes_per_cell("kfused", k=4) is None
    assert perf.solve_perf(10.0, "kfused", k=4) is None
    assert perf.solve_perf(0.0, "leapfrog", n=8) is None


def test_solve_perf_fields(monkeypatch):
    monkeypatch.setenv("WAVETPU_PEAK_GBPS", "1000")
    out = perf.solve_perf(50.0, "leapfrog", n=N)
    ref = jperf.solve_perf(50.0, "leapfrog", n=N)
    assert set(out) == set(ref)
    assert out["model_bytes_per_cell"] == 12.0
    assert out["model_gbps"] == pytest.approx(600.0)
    assert out["peak_gbps"] == 1000.0
    assert out["roofline_fraction"] == pytest.approx(0.6)
    assert out["arithmetic_intensity"] == pytest.approx(19.0 / 12.0,
                                                         abs=1e-4)


def test_peak_is_the_cards_published_rate(monkeypatch):
    monkeypatch.delenv("WAVETPU_PEAK_GBPS", raising=False)
    assert perf.hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert perf.hbm_gbps("NVIDIA H100 PCIe") == 2000.0
    assert perf.hbm_gbps("NVIDIA H100 NVL") == 3900.0
    assert perf.hbm_gbps("NVIDIA H200") == 4800.0
    if not torch.cuda.is_available():
        assert perf.peak_gbps() == perf.FALLBACK_PEAK_GBPS
    monkeypatch.setenv("WAVETPU_PEAK_GBPS", "bogus")
    assert perf.peak_gbps() in (perf.FALLBACK_PEAK_GBPS, 3350.0)


class TestDeviceMemory:
    def teardown_method(self):
        perf.set_memory_stats_provider(None)
        perf.configure_memory_warn(None)

    def test_no_card_is_none_and_cached(self):
        """Without a card the allocator answers nothing: None, and the
        verdict is cached (later calls do not probe again)."""
        calls = []

        def provider():
            calls.append(1)
            return {}

        perf.set_memory_stats_provider(provider)
        assert perf.memory_snapshot() is None
        assert perf.memory_snapshot() is None
        assert perf.record_memory(MetricsRegistry()) is None
        assert calls == [1]

    def test_real_read_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: tests/test_torch_gpu.py "
                        "reads it")
        perf.set_memory_stats_provider(None)
        assert perf.memory_snapshot() is None
        assert perf._mem_supported is False

    def test_transient_failure_and_torch_absent_do_not_latch(self):
        def boom():
            raise RuntimeError("transient")

        perf.set_memory_stats_provider(boom)
        assert perf.memory_snapshot() is None
        assert perf._mem_supported is None
        perf.set_memory_stats_provider(lambda: None)
        assert perf.memory_snapshot() is None
        assert perf._mem_supported is None

    def test_gauges_watermark_and_warn(self, tmp_path):
        stats = {"allocated_bytes.all.current": 1000,
                 "allocated_bytes.all.peak": 1500}
        perf.set_memory_stats_provider(lambda: dict(stats))
        perf.configure_memory_warn(1200)
        reg = MetricsRegistry()
        tracing.configure(str(tmp_path / "trace.jsonl"))
        try:
            assert perf.record_memory(reg, context="solve") == {
                "bytes_in_use": 1000, "peak_bytes": 1500}
            wm = reg.gauge("wavetpu_device_memory_watermark_bytes", "")
            raises = reg.counter(
                "wavetpu_device_memory_watermark_raises_total", "")
            warns = reg.counter("wavetpu_device_memory_warn_total", "")
            assert wm.value() == 1000 and raises.value() == 1
            stats["allocated_bytes.all.current"] = 800
            perf.record_memory(reg, context="solve")
            assert wm.value() == 1000 and raises.value() == 1
            assert warns.value() == 0
            stats["allocated_bytes.all.current"] = 2000
            perf.record_memory(reg, context="solve")
            assert warns.value() == 1 and wm.value() == 2000
            assert raises.value() == 2
            assert reg.gauge("wavetpu_device_peak_bytes", "",
                             ("context",)).value(context="solve") == 1500
        finally:
            tracing.disable()
        recs = [json.loads(line) for line in open(tmp_path / "trace.jsonl")]
        assert [r["kind"] for r in recs] == ["memory.warn"]

    def test_env_warn_threshold(self, monkeypatch):
        monkeypatch.setenv("WAVETPU_MEM_WARN_BYTES", "1e6")
        assert perf.memory_warn_bytes() == 1_000_000
        monkeypatch.setenv("WAVETPU_MEM_WARN_BYTES", "junk")
        assert perf.memory_warn_bytes() is None


class TestProfile:
    @pytest.mark.parametrize("argv", [
        ["profile"],
        ["profile", "--out"],
        ["profile", "--out", "d"],
        ["profile", "8", "1", "1", "1", "1"],
    ], ids=["nothing", "out-no-dir", "no-command", "no-out"])
    def test_profile_usage_errors(self, argv, capsys):
        assert cli.main(argv) == 2
        assert "usage:" in capsys.readouterr().err

    def test_profile_refuses_an_inner_profile(self, tmp_path, capsys):
        assert cli.main(["profile", "--out", str(tmp_path), "8", "1", "1",
                         "1", "1", "--profile", str(tmp_path / "p")]) == 2
        assert "owns the bracket" in capsys.readouterr().err

    def test_profile_brackets_a_cpu_solve(self, tmp_path, capsys):
        out = tmp_path / "prof"
        rc = cli.main(["profile", "--out", str(out), "8", "1", "1", "1",
                       "1", "1", "3", "--platform", "cpu", "--out-dir",
                       str(tmp_path / "run")])
        assert rc == 0
        text = capsys.readouterr().out
        assert "profile capture:" in text and "cli.solve" in text
        assert (out / perf.TRACE_FILENAME).exists()
        trace = json.loads((out / perf.TRACE_FILENAME).read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert "cli.solve" in names
        ops = json.loads((out / perf.OPS_FILENAME).read_text())
        assert "cli.solve" in {o["name"] for o in ops}
        # The run got a telemetry dir under --out.
        assert (out / "telemetry" / "trace.jsonl").exists()

    def test_profile_flag_writes_a_trace(self, tmp_path, capsys):
        prof = tmp_path / "p"
        assert cli.main(["8", "1", "1", "1", "1", "1", "3", "--platform",
                         "cpu", "--out-dir", str(tmp_path), "--profile",
                         str(prof)]) == 0
        assert "profile trace:" in capsys.readouterr().out
        assert sorted(os.listdir(prof)) == [perf.OPS_FILENAME,
                                            perf.TRACE_FILENAME]
