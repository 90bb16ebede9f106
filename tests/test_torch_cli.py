"""The port's CLI (`python -m wavetpu_torch`) against wavetpu's on the CPU.

At f64 the report's layer lines are byte-identical to wavetpu's.  N is odd
there: with an even N the x = N/2 plane holds sin(pi) ~ 1e-16 instead of 0,
and its rel error is a ratio of rounding noise that any change of summation
order moves in the first digit (wavetpu's own kernels disagree on it).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from wavetpu import cli as jcli
from wavetpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["15", "1", "1", "pi", "1", "1", "12"]


def layer_lines(path):
    with open(path) as f:
        return [ln for ln in f if ln.startswith("max abs and rel errors")]


@pytest.mark.parametrize("extra", [
    [],
    ["--scheme", "compensated"],
    ["--scheme", "compensated", "--fuse-steps", "3"],
], ids=["standard", "compensated", "flagship"])
def test_f64_layer_lines_byte_identical(tmp_path, extra, capsys):
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    rc = cli.main(ARGS + extra + ["--dtype", "f64", "--platform", "cpu",
                                  "--out-dir", str(ours_dir)])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("C = ")
    for key in ("grids initialized in", "numerical solution calculated in",
                "max abs error:", "throughput:", "report:"):
        assert key in out
    # --backend single: the test session's 8 virtual CPU devices would
    # otherwise send wavetpu's auto backend onto a sharded mesh.
    assert jcli.main(ARGS + extra + ["--dtype", "f64", "--platform", "cpu",
                                     "--backend", "single",
                                     "--out-dir", str(ref_dir)]) == 0
    ours = layer_lines(ours_dir / "output_N15_Np1_CUDA.txt")
    ref = layer_lines(ref_dir / "output_N15_Np1_TPU.txt")
    assert len(ours) == 13
    assert ours == ref


def test_f32_report_and_sidecar(tmp_path, capsys):
    rc = cli.main(["16", "1", "1", "1", "1", "1", "8", "--platform", "cpu",
                   "--scheme", "compensated", "--fuse-steps", "4",
                   "--out-dir", str(tmp_path)])
    assert rc == 0
    side = json.loads((tmp_path / "output_N16_Np1_CUDA.json").read_text())
    assert side["variant"] == "CUDA"
    assert side["run_config"]["platform"] == "cpu"
    assert side["run_config"]["fuse_steps"] == 4
    assert 0 < side["max_abs_error"] < 1e-2  # N=16: discretization-limited
    assert len(side["abs_errors"]) == 9


def test_no_errors_marker(tmp_path, capsys):
    assert cli.main(["8", "1", "1", "1", "1", "1", "3", "--no-errors",
                     "--platform", "cpu", "--out-dir", str(tmp_path)]) == 0
    text = (tmp_path / "output_N8_Np1_CUDA.txt").read_text()
    assert "errors not computed" in text
    assert "max abs error" not in capsys.readouterr().out


def test_without_cuda_exits_2_unless_cpu_asked(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs on it")
    rc = cli.main(["8", "1", "1", "1", "1", "1", "3", "--out-dir",
                   str(tmp_path)])
    assert rc == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("argv,needle", [
    (["8", "1", "1", "1", "1", "--mesh", "2,1,1"], "queue 1 item 10"),
    (["8", "1", "1", "1", "1", "--c2-field", "constant"], "K5"),
    (["8", "1", "1", "1", "1", "--ckpt-every", "2"], "queue 1 item 9"),
    (["8", "1", "1", "1", "1", "--resume", "x.npz"], "queue 1 item 8"),
    (["8", "1", "1", "1", "1", "--fuse-steps", "2"], "K3"),
    (["serve"], "queue 1 item 12"),
], ids=["mesh", "c2-field", "ckpt-every", "resume", "standard-kfused",
        "serve"])
def test_unported_flags_name_their_roadmap_item(argv, needle, capsys):
    assert cli.main(argv + ["--platform", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP.md" in err and needle in err


@pytest.mark.parametrize("argv", [
    ["8", "1", "1", "1", "1", "--dtype", "f64"],  # f64 only on the CPU
    ["8", "1", "1", "1", "1", "--dtype", "bf16", "--platform", "cpu"],
    ["8", "1", "1", "1", "1", "--platform", "tpu"],
    ["8", "1", "1", "1", "1", "--v-dtype", "bf16", "--platform", "cpu"],
    ["8", "1", "1", "1", "1", "--scheme", "compensated", "--fuse-steps",
     "3", "--platform", "cpu"],  # 3 does not divide 8
    ["8", "1", "1", "1", "--platform", "cpu"],  # too few positionals
    ["8", "1", "1", "1", "1", "--bogus", "--platform", "cpu"],
])
def test_usage_errors_exit_2(argv, capsys):
    assert cli.main(argv) == 2
    assert "error:" in capsys.readouterr().err


def test_module_entry_point(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "wavetpu_torch", "8", "1", "1", "1", "1", "1",
         "3", "--platform", "cpu", "--out-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "output_N8_Np1_CUDA.txt").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "wavetpu_torch", "--version"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.stdout.startswith("wavetpu_torch ")
