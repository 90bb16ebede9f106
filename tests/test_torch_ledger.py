"""The port's compile and accuracy ledgers (wavetpu_torch/obs/ledger.py,
obs/accuracy.py, progkey.py) and their reports against wavetpu's, on the
CPU: the same records give byte-equal ledger lines, and `ledger-report` /
`plan-report` print the same text (and JSON, less the generation time and
the roofline join, whose cost model is the port's own) over the same
files.
"""

import json

import pytest

from wavetpu import progkey as jprogkey
from wavetpu.core.problem import Problem as JProblem
from wavetpu.obs import accuracy as jaccuracy
from wavetpu.obs import ledger as jledger
from wavetpu_torch import cli, progkey
from wavetpu_torch.core.problem import Problem
from wavetpu_torch.obs import accuracy, ledger


def _key(**over):
    base = dict(
        N=512, Lx=1.0, Ly=1.0, Lz=1.0, T=1.0, timesteps=1000,
        scheme="compensated", path="kfused", k=4, dtype="f32",
        with_field=False, compute_errors=True, batch=1, mesh=None,
    )
    base.update(over)
    return base


def _session(mod, path):
    """A two-restart session: cold compiles, a disk load, a warm one."""
    led = mod.CompileLedger(path)
    led.record(_key(), 70.5, ts=1.0, pid=111, source="fresh")
    led.record(_key(path="pallas", k=1, scheme="standard"), 0.25, ts=2.0,
               pid=111)
    led.record(_key(), 0.01, ts=3.0, pid=111)
    led.close()
    led = mod.CompileLedger(path)
    led.record(_key(), 0.75, ts=10.0, pid=222, source="disk",
               fresh_compile_s=70.5)
    led.record(_key(mesh=[2, 2, 1], path="pallas", k=1), 1.5, ts=11.0,
               pid=222)
    led.record(_key(path="pallas", k=1, scheme="standard"), 0.5, ts=12.0,
               pid=222)
    led.close()


def test_ledger_lines_equal_wavetpus(tmp_path):
    ours, ref = tmp_path / "ours.jsonl", tmp_path / "ref.jsonl"
    _session(ledger, str(ours))
    _session(jledger, str(ref))
    assert ours.read_text() == ref.read_text()


def test_solo_key_equals_wavetpus():
    for mesh in (None, (2, 2, 1)):
        ours = ledger.solo_key(Problem(N=15, Ly=3.0, timesteps=12),
                               "standard", "kfused", 3, "f64", True, False,
                               mesh=mesh)
        ref = jledger.solo_key(JProblem(N=15, Ly=3.0, timesteps=12),
                               "standard", "kfused", 3, "f64", True, False,
                               mesh=mesh)
        assert ours == ref


def test_progkey_copy_matches_wavetpu():
    assert progkey.KEY_FIELDS == jprogkey.KEY_FIELDS
    key = _key(mesh=(2, 1, 1))
    assert progkey.canonical_key(key) == jprogkey.canonical_key(key)
    pk = progkey.program_key_from_dict(key)
    assert tuple(pk) == tuple(jprogkey.program_key_from_dict(key))
    with pytest.raises(ValueError):
        progkey.normalize_key(dict(key, bogus=1))


@pytest.mark.parametrize("flag,platform,want", [
    ("auto", "gpu", "pallas"), ("auto", "cpu", "roll"),
    ("roll", "gpu", "roll"), ("pallas", "gpu", "pallas"),
])
def test_resolve_kernel(flag, platform, want):
    assert progkey.resolve_kernel(flag, platform) == want


def test_resolve_kernel_rejects_unknown():
    with pytest.raises(ValueError, match="auto|roll|pallas"):
        progkey.resolve_kernel("cuda", "gpu")


@pytest.mark.parametrize("extra", [[], ["--json"]], ids=["text", "json"])
def test_ledger_report_equals_wavetpus(tmp_path, capsys, extra):
    path = str(tmp_path / "compile_ledger.jsonl")
    _session(ledger, path)
    assert cli.main(["ledger-report", path] + extra) == 0
    ours = capsys.readouterr().out
    assert jledger.main([path] + extra) == 0
    assert ours == capsys.readouterr().out


def test_ledger_keys_round_trip_through_program_key(tmp_path):
    path = str(tmp_path / "compile_ledger.jsonl")
    _session(ledger, path)
    keys = [r["key"] for r in ledger.load_ledger(path)]
    assert keys == [r["key"] for r in jledger.load_ledger(path)]
    for key in keys:
        assert progkey.key_from_program_key(
            progkey.program_key_from_dict(key)) == key


def _accuracy_session(mod, path):
    led = mod.AccuracyLedger(path)
    plans = [mod.make_plan("standard", "leapfrog", 1, "f32"),
             mod.make_plan("compensated", "kfused_comp", 4, "f32"),
             mod.make_plan("standard", "kfused", 4, "bf16")]
    for i, (plan, err, wall) in enumerate([
            (plans[0], 1.0886788e-3, 3.64), (plans[1], 5.8710575e-6, 1.17),
            (plans[2], 0.66, 0.9), (plans[0], 1.1e-3, 3.7),
            (plans[1], 6.0e-6, 1.2)]):
        led.record(plan, 512, 1000, err, wall, 1.3e11, ts=float(i),
                   pid=4242)
    led.record(plans[1], 100, 50, 3e-5, 0.01, 5e7, ts=9.0, pid=4242,
               source="shadow")
    led.close()


def test_accuracy_lines_equal_wavetpus(tmp_path):
    ours, ref = tmp_path / "ours.jsonl", tmp_path / "ref.jsonl"
    _accuracy_session(accuracy, str(ours))
    _accuracy_session(jaccuracy, str(ref))
    assert ours.read_text() == ref.read_text()


def _telemetry_dir(tmp_path):
    d = tmp_path / "tel"
    d.mkdir()
    _accuracy_session(accuracy, str(d / accuracy.ACCURACY_FILENAME))
    _session(ledger, str(d / ledger.LEDGER_FILENAME))
    return str(d)


def test_plan_report_text_equals_wavetpus(tmp_path, capsys):
    d = _telemetry_dir(tmp_path)
    assert cli.main(["plan-report", d]) == 0
    ours = capsys.readouterr().out
    assert jaccuracy.main([d]) == 0
    assert ours == capsys.readouterr().out


def test_plan_report_json_equals_wavetpus_but_the_model(tmp_path, capsys):
    d = _telemetry_dir(tmp_path)
    assert cli.main(["plan-report", d, "--json"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jaccuracy.main([d, "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    own = ("generated_unix",)
    model = ("roofline_fraction", "model_gbps")
    assert {k: v for k, v in ours.items() if k not in own + ("rows",)} == \
        {k: v for k, v in ref.items() if k not in own + ("rows",)}
    assert len(ours["rows"]) == len(ref["rows"])
    for a, b in zip(ours["rows"], ref["rows"]):
        assert {k: v for k, v in a.items() if k not in model} == \
            {k: v for k, v in b.items() if k not in model}
        if a["plan"]["path"] == "leapfrog":
            # The port's model: 12 B per cell at the CPU's nominal peak.
            assert a["model_gbps"] == pytest.approx(
                a["gcells_per_s"] * 12.0, rel=1e-3)


def test_report_usage_errors(tmp_path, capsys):
    assert cli.main(["ledger-report"]) == 2
    assert cli.main(["plan-report"]) == 2
    assert cli.main(["ledger-report", str(tmp_path / "none")]) == 2
    assert cli.main(["plan-report", str(tmp_path), "--bogus"]) == 2
    assert "usage: wavetpu-torch" in capsys.readouterr().err


def test_cli_records_compile_and_accuracy_lines(tmp_path, capsys):
    tel = tmp_path / "tel"
    for extra in ([], ["--fuse-steps", "2"], []):
        assert cli.main(["8", "1", "1", "1", "1", "1", "4", "--platform",
                         "cpu", "--out-dir", str(tmp_path),
                         "--telemetry-dir", str(tel)] + extra) == 0
    capsys.readouterr()
    recs = ledger.load_ledger(str(tel / ledger.LEDGER_FILENAME))
    assert [r["key"]["path"] for r in recs] == ["roll", "kfused", "roll"]
    assert [r["key"]["k"] for r in recs] == [1, 2, 1]
    # Each telemetry start binds a fresh ledger: cold per process-run,
    # as wavetpu's.  No kernel library is built on the CPU.
    assert all(r["cold"] for r in recs)
    assert all(r["compile_s"] == 0.0 and "source" not in r for r in recs)
    acc = accuracy.load_accuracy_ledger(
        str(tel / accuracy.ACCURACY_FILENAME))
    assert [r["plan"]["path"] for r in acc] == ["leapfrog", "kfused",
                                                "leapfrog"]
    assert all(0 < r["max_abs_err"] < 0.1 for r in acc)
    assert cli.main(["ledger-report", str(tel)]) == 0
    out = capsys.readouterr().out
    assert "compile ledger: 3 compiles, 2 distinct keys" in out
    assert "accuracy ledger present" in out
    assert cli.main(["plan-report", str(tel)]) == 0
    assert "standard:kfused k=2 f32" in capsys.readouterr().out
