"""The port's CLI (`python -m wavetpu_torch`) against wavetpu's on the CPU.

At f64 the report's layer lines are byte-identical to wavetpu's.  N is odd
there: with an even N the x = N/2 plane holds sin(pi) ~ 1e-16 instead of 0,
and its rel error is a ratio of rounding noise that any change of summation
order moves in the first digit (wavetpu's own kernels disagree on it).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
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


def layer_numbers(path):
    return np.array([[float(x) for x in ln.split(":")[1].split()]
                     for ln in layer_lines(path)])


@pytest.mark.parametrize("k", ["3", "5"])
def test_f64_kfused_layer_lines_byte_identical(tmp_path, k, capsys):
    # wavetpu's own f64 onion cannot store its f64 row maxima into its f32
    # rows under this jax (ROADMAP.md queue 3), so the port's k-fused
    # report is held against wavetpu's 1-step report: the k-fused march is
    # the 1-step march, bit for bit.
    assert cli.main(ARGS + ["--fuse-steps", k, "--dtype", "f64",
                            "--platform", "cpu", "--out-dir",
                            str(tmp_path / "ours")]) == 0
    assert f"fuse-steps: {k}" in capsys.readouterr().out
    assert jcli.main(ARGS + ["--dtype", "f64", "--platform", "cpu",
                             "--backend", "single", "--out-dir",
                             str(tmp_path / "ref")]) == 0
    ours = layer_lines(tmp_path / "ours" / "output_N15_Np1_CUDA.txt")
    assert len(ours) == 13
    assert ours == layer_lines(tmp_path / "ref" / "output_N15_Np1_TPU.txt")


# f32 and bf16 against wavetpu's run of the same flags: XLA-CPU's FMA
# contraction moves the states by an ulp (queue 3), so the layer errors
# agree to 1e-6 absolute, not byte for byte.
@pytest.mark.parametrize("extra", [
    ["--fuse-steps", "3"],
    ["--dtype", "bf16"],
    ["--dtype", "bf16", "--fuse-steps", "5"],
], ids=["kfused-f32", "bf16", "kfused-bf16"])
def test_layer_errors_match_wavetpu(tmp_path, extra, capsys):
    assert cli.main(ARGS + extra + ["--platform", "cpu", "--out-dir",
                                    str(tmp_path / "ours")]) == 0
    assert jcli.main(ARGS + extra + ["--platform", "cpu", "--backend",
                                     "single", "--out-dir",
                                     str(tmp_path / "ref")]) == 0
    ours = layer_numbers(tmp_path / "ours" / "output_N15_Np1_CUDA.txt")
    ref = layer_numbers(tmp_path / "ref" / "output_N15_Np1_TPU.txt")
    assert ours.shape == (13, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    side = json.loads(
        (tmp_path / "ours" / "output_N15_Np1_CUDA.json").read_text())
    assert side["run_config"]["dtype"] == (
        "bfloat16" if "bf16" in extra else "float32")


@pytest.mark.parametrize("extra", [
    [],
    ["--fuse-steps", "3"],
    ["--scheme", "compensated", "--fuse-steps", "3"],
], ids=["varc", "kfused-varc", "flagship-varc"])
def test_c2_field_preset(tmp_path, extra, capsys):
    assert cli.main(ARGS + extra + ["--c2-field", "gaussian-lens",
                                    "--platform", "cpu", "--out-dir",
                                    str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "errors: disabled (--c2-field has no analytic oracle)" in out
    assert "max abs error" not in out
    side = json.loads((tmp_path / "output_N15_Np1_CUDA.json").read_text())
    assert side["run_config"]["c2_field"] == "gaussian-lens"
    assert side["errors_computed"] is False
    text = (tmp_path / "output_N15_Np1_CUDA.txt").read_text()
    assert "errors not computed" in text


def test_c2_field_npy(tmp_path, capsys):
    # An .npy of c^2 on the grid (times tau^2 by the CLI), as wavetpu reads
    # it: here the constant a^2, the constant-speed physics.
    from wavetpu_torch.core.problem import Problem

    p = Problem.from_argv(ARGS)
    path = tmp_path / "c2.npy"
    np.save(path, np.full((15, 15, 15), p.a2))
    assert cli.main(ARGS + ["--c2-field", str(path), "--fuse-steps", "3",
                            "--platform", "cpu", "--out-dir",
                            str(tmp_path / "o")]) == 0
    side = json.loads(
        (tmp_path / "o" / "output_N15_Np1_CUDA.json").read_text())
    assert side["run_config"]["c2_field"] == str(path)
    np.save(tmp_path / "bad.npy", np.ones((15, 15, 14)))
    assert cli.main(ARGS + ["--c2-field", str(tmp_path / "bad.npy"),
                            "--platform", "cpu"]) == 2
    assert "array shape" in capsys.readouterr().err
    assert cli.main(ARGS + ["--c2-field", "no-such-preset", "--platform",
                            "cpu"]) == 2
    assert "neither a preset" in capsys.readouterr().err


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


# The sidecar carries wavetpu's keys (ROADMAP.md queue 3, F1): a reader of
# wavetpu's sidecar finds every key in the port's.  The port's run_config
# adds the device it ran on (`device`, `platform`).
# A resumed run and a supervised run carry the features' values, held
# against wavetpu's for the same command lines.
@pytest.mark.parametrize("extra", [[], ["--fuse-steps", "3"], "resumed",
                                   "supervised"],
                         ids=["1step", "kfused", "resumed", "supervised"])
def test_sidecar_keys_match_wavetpu(tmp_path, extra, capsys):
    tail = ["--platform", "cpu"]
    ours_argv, ref_argv = ARGS + tail, ARGS + tail + ["--backend", "single"]
    if extra == "resumed":
        for main, argv, ck in ((cli.main, ours_argv, "ck_ours"),
                               (jcli.main, ref_argv, "ck_ref")):
            assert main(argv + ["--stop-step", "5", "--save-state",
                                str(tmp_path / ck), "--out-dir",
                                str(tmp_path / "half")]) == 0
        ours_argv = ["--resume", str(tmp_path / "ck_ours.npz")] + tail
        ref_argv = ["--resume", str(tmp_path / "ck_ref.npz")] + tail
    elif extra == "supervised":
        ours_argv = ours_argv + ["--ckpt-every", "4", "--ckpt-dir",
                                 str(tmp_path / "rot_ours")]
        ref_argv = ref_argv + ["--ckpt-every", "4", "--ckpt-dir",
                               str(tmp_path / "rot_ref")]
    else:
        ours_argv, ref_argv = ours_argv + extra, ref_argv + extra
    assert cli.main(ours_argv + ["--out-dir", str(tmp_path / "ours")]) == 0
    assert jcli.main(ref_argv + ["--out-dir", str(tmp_path / "ref")]) == 0
    ours = json.loads(
        (tmp_path / "ours" / "output_N15_Np1_CUDA.json").read_text())
    ref = json.loads(
        (tmp_path / "ref" / "output_N15_Np1_TPU.json").read_text())
    assert set(ours) == set(ref)
    assert set(ours["run_config"]) == set(ref["run_config"]) | {"device",
                                                                "platform"}
    for key in ("exchange_seconds", "loop_seconds", "phase_probe_steps"):
        assert ours[key] is None and ref[key] is None
    for key in ("distributed", "resumed", "supervised", "ckpt_every",
                "supervisor_status", "backend", "scheme", "fuse_steps",
                "mesh", "dtype", "v_dtype", "c2_field"):
        assert ours["run_config"][key] == ref["run_config"][key], key
    # The CPU runs the kernels' plain versions: wavetpu's roll path.
    assert ours["run_config"]["kernel"] == "roll"
    cfg = ours["run_config"]
    assert cfg["resumed"] is (extra == "resumed")
    assert cfg["supervised"] is (extra == "supervised")
    assert cfg["ckpt_every"] == (4 if extra == "supervised" else None)
    assert cfg["supervisor_status"] == ("complete" if extra == "supervised"
                                        else None)
    np.testing.assert_allclose(ours["abs_errors"], ref["abs_errors"],
                               rtol=0, atol=1e-6)


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
    (["8", "1", "1", "1", "1", "--program-cache-dir", "d"],
     "queue 1 item 12b"),
    (["router"], "queue 1 item 12c"),
    (["warmup"], "queue 1 item 12b"),
    (["serve", "--chunk-threshold", "64"], "queue 1 item 12b"),
    (["serve", "--record-trace", "t.jsonl"], "queue 1 item 12c"),
], ids=["program-cache-dir", "router", "warmup", "serve-chunk-threshold",
        "serve-record-trace"])
def test_unported_flags_name_their_roadmap_item(argv, needle, capsys):
    assert cli.main(argv + ["--platform", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP.md" in err and needle in err


@pytest.mark.parametrize("argv", [
    ["8", "1", "1", "1", "1", "--dtype", "f64"],  # f64 only on the CPU
    ["8", "1", "1", "1", "1", "--dtype", "bf16", "--scheme", "compensated",
     "--platform", "cpu"],  # bf16 runs on the standard scheme only
    ["8", "1", "1", "1", "1", "--platform", "tpu"],
    ["8", "1", "1", "1", "1", "--v-dtype", "bf16", "--platform", "cpu"],
    ["8", "1", "1", "1", "1", "--scheme", "compensated", "--fuse-steps",
     "3", "--platform", "cpu"],  # 3 does not divide 8
    ["8", "1", "1", "1", "--platform", "cpu"],  # too few positionals
    ["8", "1", "1", "1", "1", "--bogus", "--platform", "cpu"],
    ["8", "1", "1", "1", "1", "--scheme", "compensated", "--c2-field",
     "constant", "--platform", "cpu"],  # needs --fuse-steps K
    ["8", "1", "1", "1", "1", "--fuse-steps", "16", "--platform", "cpu"],
    ["8", "1", "1", "1", "1", "--dtype", "f16", "--platform", "cpu"],
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


def test_mesh_f64_layer_lines_byte_identical(tmp_path, capsys):
    # The sharded 1-step march (K6 on four CPU shards) against wavetpu's
    # pallas kernel on the same mesh: report Np4, variant CUDA.
    assert cli.main(ARGS + ["--mesh", "2,2,1", "--dtype", "f64",
                            "--platform", "cpu", "--out-dir",
                            str(tmp_path / "ours")]) == 0
    assert "mesh: 2,2,1" in capsys.readouterr().out
    assert jcli.main(ARGS + ["--mesh", "2,2,1", "--kernel", "pallas",
                             "--dtype", "f64", "--platform", "cpu",
                             "--out-dir", str(tmp_path / "ref")]) == 0
    ours = layer_lines(tmp_path / "ours" / "output_N15_Np4_CUDA.txt")
    assert len(ours) == 13
    assert ours == layer_lines(tmp_path / "ref" / "output_N15_Np4_TPU.txt")
    side = json.loads(
        (tmp_path / "ours" / "output_N15_Np4_CUDA.json").read_text())
    assert side["variant"] == "CUDA" and side["n_procs"] == 4
    assert side["run_config"]["backend"] == "sharded"
    assert side["run_config"]["mesh"] == [2, 2, 1]


@pytest.mark.parametrize("extra", [[], ["--mesh", "2,1,1"]],
                         ids=["single", "mesh"])
def test_uneven_kfused_f64_layer_lines_byte_identical(tmp_path, extra,
                                                      capsys):
    # --fuse-steps 4 does not divide N=15: the pad-and-mask march (K9), on
    # a (1,1,1) mesh or two CPU shards.  wavetpu's f64 onion cannot store
    # its f64 row maxima (ROADMAP.md queue 3), so the report is held
    # against wavetpu's f64 1-step report: the same layers, bit for bit.
    assert cli.main(ARGS + ["--fuse-steps", "4", "--dtype", "f64",
                            "--platform", "cpu", "--out-dir",
                            str(tmp_path / "ours")] + extra) == 0
    assert jcli.main(ARGS + ["--dtype", "f64", "--platform", "cpu",
                             "--backend", "single", "--out-dir",
                             str(tmp_path / "ref")]) == 0
    name = f"output_N15_Np{2 if extra else 1}_CUDA.txt"
    ours = layer_lines(tmp_path / "ours" / name)
    assert len(ours) == 13
    assert ours == layer_lines(tmp_path / "ref" / "output_N15_Np1_TPU.txt")


@pytest.mark.parametrize("argv,needle", [
    (["--distributed"], "item 10, step 5"),
], ids=["distributed"])
def test_sharded_paths_not_ported_name_their_item(argv, needle, capsys):
    assert cli.main(["16", "1", "1", "1", "1"] + argv
                    + ["--platform", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP.md" in err and needle in err


# The k-fused marches on a mesh, each on CPU shards: k-fusion on a
# y-sharded mesh (K10, with and without a field), the distributed flagship
# on a backend-sharded (1,1,1) mesh and on (2,1,1) (K11), and k-fusion on
# (1,2,1).  Report Np{MX*MY*MZ}, variant CUDA.
@pytest.mark.parametrize("argv,n_procs,mesh", [
    (["8", "1", "1", "1", "1", "--mesh", "2,2,1", "--fuse-steps", "2"], 4,
     [2, 2, 1]),
    (["8", "1", "1", "1", "1", "--c2-field", "constant", "--fuse-steps",
      "2", "--mesh", "1,2,1"], 2, [1, 2, 1]),
    (["8", "1", "1", "1", "1", "--fuse-steps", "2", "--scheme",
      "compensated", "--backend", "sharded"], 1, [1, 1, 1]),
    (["16", "1", "1", "1", "1", "--mesh", "2,1,1", "--scheme",
      "compensated", "--fuse-steps", "4"], 2, [2, 1, 1]),
    (["16", "1", "1", "1", "1", "--mesh", "1,2,1", "--fuse-steps", "4"], 2,
     [1, 2, 1]),
], ids=["mesh", "c2-field", "standard-kfused", "comp-kfused-mesh",
        "kfused-y-mesh"])
def test_sharded_kfused_paths_run(tmp_path, argv, n_procs, mesh, capsys):
    assert cli.main(argv + ["--platform", "cpu", "--out-dir",
                            str(tmp_path)]) == 0
    assert f"mesh: {','.join(map(str, mesh))}" in capsys.readouterr().out
    name = f"output_N{argv[0]}_Np{n_procs}_CUDA"
    assert (tmp_path / f"{name}.txt").exists()
    side = json.loads((tmp_path / f"{name}.json").read_text())
    assert side["variant"] == "CUDA" and side["n_procs"] == n_procs
    cfg = side["run_config"]
    assert cfg["backend"] == "sharded" and cfg["mesh"] == mesh
    assert cfg["fuse_steps"] == int(argv[argv.index("--fuse-steps") + 1])
    assert cfg["scheme"] == ("compensated" if "compensated" in argv
                             else "standard")
    if "--c2-field" in argv:
        assert side["errors_computed"] is False
    else:  # N = 8-16: discretization-limited
        assert 0 < side["max_abs_error"] < 5e-2


@pytest.mark.parametrize("extra", [
    ["--fuse-steps", "5", "--mesh", "3,3,1"],
    ["--fuse-steps", "3", "--mesh", "1,3,1"],
], ids=["mesh-3-3-1", "mesh-1-3-1"])
def test_xy_kfused_f64_layer_lines_byte_identical(tmp_path, extra, capsys):
    # K10 on a y-sharded mesh of CPU shards.  wavetpu's f64 onion cannot
    # store its f64 row maxima (ROADMAP.md queue 3), so the report is held
    # against wavetpu's f64 1-step report: the same layers, bit for bit.
    assert cli.main(ARGS + extra + ["--dtype", "f64", "--platform", "cpu",
                                    "--out-dir", str(tmp_path / "ours")]) == 0
    assert jcli.main(ARGS + ["--dtype", "f64", "--platform", "cpu",
                             "--backend", "single", "--out-dir",
                             str(tmp_path / "ref")]) == 0
    mx, my, mz = (int(m) for m in extra[-1].split(","))
    ours = layer_lines(tmp_path / "ours" /
                       f"output_N15_Np{mx * my * mz}_CUDA.txt")
    assert len(ours) == 13
    assert ours == layer_lines(tmp_path / "ref" / "output_N15_Np1_TPU.txt")


def test_sharded_flagship_f64_layer_lines_byte_identical(tmp_path, capsys):
    # K11 on three x shards of the CPU against wavetpu's sharded flagship on
    # the same mesh (its rows are f32 diagnostics, so f64 runs there).
    extra = ["--scheme", "compensated", "--fuse-steps", "5", "--mesh",
             "3,1,1", "--dtype", "f64", "--platform", "cpu"]
    assert cli.main(ARGS + extra + ["--out-dir", str(tmp_path / "ours")]) == 0
    assert jcli.main(ARGS + extra + ["--out-dir", str(tmp_path / "ref")]) == 0
    ours = layer_lines(tmp_path / "ours" / "output_N15_Np3_CUDA.txt")
    assert len(ours) == 13
    assert ours == layer_lines(tmp_path / "ref" / "output_N15_Np3_TPU.txt")


@pytest.mark.parametrize("argv,needle", [
    (["--mesh", "2,2"], "--mesh wants MX,MY,MZ"),
    (["--mesh", "1,1,1", "--backend", "single"], "contradicts"),
    (["--backend", "bogus"], "--backend must be"),
    (["--mesh", "2,1,2", "--fuse-steps", "2"], "(MX,MY,1)"),
    (["--mesh", "8,1,1", "--fuse-steps", "4"], "no pad-and-mask layout"),
    (["--mesh", "14,1,1"], "too large for N=13"),
])
def test_mesh_usage_errors_exit_2(argv, needle, capsys):
    assert cli.main(["13", "1", "1", "1", "1"] + argv
                    + ["--platform", "cpu"]) == 2
    assert needle in capsys.readouterr().err



# --phase-timing, --overlap and --kernel (ROADMAP.md queue 1 items 10
# steps 3-4 and 4).

PHASE_LINE = re.compile(r"^total ICI exchange time: \d+ms\n"
                        r"total loop time: \d+ms\n"
                        r"\(phase times probe-extrapolated from (\d+) "
                        r"steps\)\n$")


def report_tail(path, n_layers=13):
    """The report's lines after the layer lines (the phase lines)."""
    lines = open(path).readlines()
    return "".join(lines[2 + n_layers:])


@pytest.mark.parametrize("extra", [["--mesh", "3,1,1"], []],
                         ids=["mesh", "single"])
def test_phase_timing_report_matches_wavetpu(tmp_path, extra, capsys):
    """The 1-step march with --phase-timing at odd N, f64: layer lines
    byte-identical to wavetpu's, and the same phase lines and probe
    label (the times are each package's own)."""
    flags = ["--phase-timing", "--dtype", "f64", "--platform", "cpu"]
    assert cli.main(ARGS + extra + flags + [
        "--out-dir", str(tmp_path / "ours")]) == 0
    out = capsys.readouterr().out
    assert re.search(r"total ICI exchange time: \d+ms\ntotal loop time: "
                     r"\d+ms\n", out)
    ref_extra = extra + ["--kernel", "pallas"] if extra else [
        "--backend", "single"]
    assert jcli.main(ARGS + ref_extra + flags + [
        "--out-dir", str(tmp_path / "ref")]) == 0
    n = 3 if extra else 1
    ours = tmp_path / "ours" / f"output_N15_Np{n}_CUDA.txt"
    ref = tmp_path / "ref" / f"output_N15_Np{n}_TPU.txt"
    assert layer_lines(ours) == layer_lines(ref)
    tail, ref_tail = report_tail(ours), report_tail(ref)
    assert PHASE_LINE.match(tail) and PHASE_LINE.match(ref_tail)
    assert tail.splitlines()[-1] == ref_tail.splitlines()[-1]
    side = json.loads(ours.with_suffix(".json").read_text())
    assert side["loop_seconds"] > 0 and side["exchange_seconds"] >= 0
    assert side["phase_probe_steps"] == 10


@pytest.mark.parametrize("argv,steps", [
    (["--fuse-steps", "3"], 30),
    (["--fuse-steps", "5", "--mesh", "1,3,1"], 50),
    (["--fuse-steps", "5", "--mesh", "3,1,1", "--scheme", "compensated"],
     50),
], ids=["kfused", "kfused-y-mesh", "flagship-mesh"])
def test_phase_timing_kfused_probe_label_and_sidecar(tmp_path, argv, steps,
                                                     capsys):
    assert cli.main(ARGS + argv + ["--phase-timing", "--platform", "cpu",
                                   "--out-dir", str(tmp_path)]) == 0
    capsys.readouterr()
    name = [f for f in os.listdir(tmp_path) if f.endswith(".txt")][0]
    m = PHASE_LINE.match(report_tail(tmp_path / name))
    assert m and int(m.group(1)) == steps
    side = json.loads((tmp_path / name).with_suffix(".json").read_text())
    assert side["phase_probe_steps"] == steps
    assert side["loop_seconds"] > 0 and side["exchange_seconds"] >= 0
    assert side["run_config"]["kernel"] == "roll"


@pytest.mark.parametrize("mesh", ["3,1,1", "1,5,1"])
def test_overlap_report_matches_wavetpu_and_serial(tmp_path, mesh, capsys):
    """--overlap at odd N (even splits), f64: layer lines byte-identical
    to wavetpu's overlap run and to the port's serial run."""
    flags = ["--mesh", mesh, "--dtype", "f64", "--platform", "cpu"]
    assert cli.main(ARGS + flags + ["--overlap", "--out-dir",
                                    str(tmp_path / "ovl")]) == 0
    assert cli.main(ARGS + flags + ["--out-dir", str(tmp_path / "ser")]) == 0
    assert jcli.main(ARGS + flags + ["--overlap", "--kernel", "pallas",
                                     "--out-dir", str(tmp_path / "ref")]) == 0
    n = 3 if mesh == "3,1,1" else 5
    ovl = layer_lines(tmp_path / "ovl" / f"output_N15_Np{n}_CUDA.txt")
    assert len(ovl) == 13
    assert ovl == layer_lines(tmp_path / "ser" / f"output_N15_Np{n}_CUDA.txt")
    assert ovl == layer_lines(tmp_path / "ref" / f"output_N15_Np{n}_TPU.txt")


@pytest.mark.parametrize("extra", [[], ["--kernel", "roll"],
                                   ["--kernel", "auto"],
                                   ["--kernel", "roll", "--mesh", "3,1,1"],
                                   ["--kernel", "roll", "--scheme",
                                    "compensated"]],
                         ids=["default", "roll", "auto", "roll-mesh",
                              "roll-compensated"])
def test_kernel_roll_on_the_cpu(tmp_path, extra, capsys):
    assert cli.main(ARGS + extra + ["--platform", "cpu", "--out-dir",
                                    str(tmp_path)]) == 0
    assert "kernel: roll" in capsys.readouterr().out
    (side,) = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert json.loads((tmp_path / side).read_text())[
        "run_config"]["kernel"] == "roll"


@pytest.mark.parametrize("argv,needle", [
    (["--kernel", "pallas", "--platform", "cpu"], "need the card"),
    (["--kernel", "cuda", "--platform", "cpu"], "--kernel must be"),
], ids=["pallas-on-cpu", "bogus"])
def test_kernel_usage_errors(argv, needle, capsys):
    assert cli.main(["8", "1", "1", "1", "1"] + argv) == 2
    assert needle in capsys.readouterr().err


# wavetpu's flag-combination rules (wavetpu/cli.py:354-375, 641-643,
# 718-731): both CLIs refuse each combination with the same message.
@pytest.mark.parametrize("argv,needle", [
    (["--fuse-steps", "2", "--kernel", "roll"],
     "--fuse-steps needs the pallas kernel"),
    (["--fuse-steps", "2", "--overlap"], "not --fuse-steps"),
    (["--backend", "single", "--overlap"], "applies to the sharded backend"),
    (["--c2-field", "constant", "--phase-timing"],
     "probe times the constant-c step"),
    (["--scheme", "compensated", "--phase-timing"],
     "the 1-step scheme has none"),
    (["--scheme", "compensated", "--overlap", "--mesh", "2,1,1"],
     "--overlap is not available for the compensated scheme"),
    (["--fuse-steps", "3", "--phase-timing"],
     "covers even decompositions"),
], ids=["kfused-roll", "kfused-overlap", "single-overlap",
        "field-phase-timing", "comp-phase-timing", "comp-overlap",
        "uneven-phase-timing"])
def test_flag_combinations_refused_as_wavetpu(argv, needle, capsys):
    base = ["8", "1", "1", "1", "1", "1", "3", "--platform", "cpu"]
    assert cli.main(base + argv) == 2
    assert needle in capsys.readouterr().err
    assert jcli.main(base + argv) == 2
    assert needle in capsys.readouterr().err


# Checkpoints and supervision (ROADMAP.md queue 1 items 8 and 9).

def sidecar(d, n=15, procs=1):
    return json.loads((d / f"output_N{n}_Np{procs}_CUDA.json").read_text())


@pytest.mark.parametrize("extra", [
    [],
    ["--fuse-steps", "3"],
    ["--scheme", "compensated"],
    ["--scheme", "compensated", "--fuse-steps", "3"],
    ["--fuse-steps", "4"],
    ["--dtype", "bf16"],
    ["--c2-field", "gaussian-lens", "--fuse-steps", "3"],
    ["--mesh", "2,2,1"],
    ["--mesh", "2,2,1", "--scheme", "compensated"],
    ["--mesh", "3,1,1", "--fuse-steps", "3"],
    ["--mesh", "1,3,1", "--fuse-steps", "3", "--scheme", "compensated"],
], ids=["default", "kfused", "compensated", "flagship", "uneven", "bf16",
        "kfused-varc", "sharded", "sharded-compensated", "K8", "K12"])
def test_stop_save_resume_equals_the_uninterrupted_run(tmp_path, extra,
                                                       capsys):
    """--stop-step S --save-state CK, then --resume CK, gives the report of
    the uninterrupted run layer for layer (flagship stops on its block
    grid: 7 = 1 + 2k)."""
    run = ARGS + extra + ["--platform", "cpu"]
    stop = "7" if "--fuse-steps" in extra else "6"
    procs = 1
    if "--mesh" in extra:
        m = extra[extra.index("--mesh") + 1].split(",")
        procs = int(m[0]) * int(m[1]) * int(m[2])
    assert cli.main(run + ["--out-dir", str(tmp_path / "full"),
                           "--save-state", str(tmp_path / "full_ck")]) == 0
    ck = str(tmp_path / "ck")
    assert cli.main(run + ["--stop-step", stop, "--save-state", ck,
                           "--out-dir", str(tmp_path / "half")]) == 0
    out = capsys.readouterr().out
    sharded = procs > 1
    ck_path = ck if sharded else ck + ".npz"
    assert f"checkpoint: {ck_path}" in out
    assert os.path.isdir(ck) == sharded
    half = sidecar(tmp_path / "half", procs=procs)
    assert half["abs_errors"] is None or \
        len(half["abs_errors"]) == int(stop) + 1
    resume = ["--resume", ck_path, "--platform", "cpu"]
    for flag in ("--fuse-steps", "--c2-field"):
        if flag in extra:
            resume += [flag, extra[extra.index(flag) + 1]]
    assert cli.main(resume + ["--out-dir", str(tmp_path / "res"),
                              "--save-state", str(tmp_path / "res_ck")]) == 0
    # The final states, bit for bit (saved by --save-state).
    from wavetpu_torch.io import checkpoint

    if sharded:
        a = checkpoint.load_sharded_checkpoint(str(tmp_path / "full_ck"),
                                               ["cpu"] * procs)
        b = checkpoint.load_sharded_checkpoint(str(tmp_path / "res_ck"),
                                               ["cpu"] * procs)
        assert torch.equal(a[2].assemble("cpu"), b[2].assemble("cpu"))
        assert a[3] == b[3] == 12
    else:
        a = checkpoint.load_checkpoint(str(tmp_path / "full_ck.npz"))
        b = checkpoint.load_checkpoint(str(tmp_path / "res_ck.npz"))
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        assert a[3] == b[3] == 12
    full = sidecar(tmp_path / "full", procs=procs)
    res = sidecar(tmp_path / "res", procs=procs)
    s = int(stop) + 1
    if full["errors_computed"]:
        assert res["abs_errors"][s:] == full["abs_errors"][s:]
        assert res["rel_errors"][s:] == full["rel_errors"][s:]
    for key in ("scheme", "dtype", "mesh", "backend", "fuse_steps"):
        assert res["run_config"][key] == full["run_config"][key], key
    assert res["run_config"]["resumed"] is True


def test_supervised_exit_codes_and_resume(tmp_path, capsys, monkeypatch):
    """WAVETPU_FAULT drills through the CLI: preempt -> exit 3 with the
    resumable path; --resume of the rotation root -> exit 0 on the
    uninterrupted errors; NaN -> exit 4 with the last good step; NaN with
    --retries 1 -> exit 0; an unstable config trips the watchdog alone."""
    from wavetpu_torch.run import faults

    base = ["16", "1", "1", "1", "1", "1", "10", "--platform", "cpu"]
    assert cli.main(base + ["--out-dir", str(tmp_path / "full")]) == 0
    rot = str(tmp_path / "rot")
    monkeypatch.setenv(faults.ENV_FAULT, "preempt:5")
    assert cli.main(base + ["--ckpt-every", "3", "--ckpt-dir", rot,
                            "--out-dir", str(tmp_path / "pre")]) == 3
    out = capsys.readouterr().out
    assert "preempted: checkpointed at step 7" in out
    assert f"resumable checkpoint: {rot}/step-00000007.npz" in out
    monkeypatch.delenv(faults.ENV_FAULT)
    assert cli.main(["--resume", rot, "--ckpt-every", "3", "--platform",
                     "cpu", "--out-dir", str(tmp_path / "res")]) == 0
    full = sidecar(tmp_path / "full", n=16)
    res = sidecar(tmp_path / "res", n=16)
    assert res["abs_errors"][8:] == full["abs_errors"][8:]
    assert res["run_config"]["supervisor_status"] == "complete"
    monkeypatch.setenv(faults.ENV_FAULT, "nan:5")
    assert cli.main(base + ["--ckpt-every", "3", "--ckpt-dir",
                            str(tmp_path / "wd"), "--out-dir",
                            str(tmp_path / "wd_out")]) == 4
    out = capsys.readouterr().out
    assert "watchdog: numerical-health trip (guarded amax inf); last good " \
           "step 4" in out
    assert "resumable checkpoint:" in out
    wd = sidecar(tmp_path / "wd_out", n=16)
    assert wd["run_config"]["supervisor_status"] == "watchdog"
    assert cli.main(base + ["--ckpt-every", "3", "--ckpt-dir",
                            str(tmp_path / "rt"), "--retries", "1",
                            "--out-dir", str(tmp_path / "rt_out")]) == 0
    assert sidecar(tmp_path / "rt_out", n=16)["abs_errors"] == \
        full["abs_errors"]
    monkeypatch.delenv(faults.ENV_FAULT)
    capsys.readouterr()
    assert cli.main(["16", "1", "1", "1", "1", "10", "10", "--platform",
                     "cpu", "--ckpt-every", "4", "--ckpt-dir",
                     str(tmp_path / "unstable"), "--out-dir",
                     str(tmp_path)]) == 4
    assert "watchdog: numerical-health trip" in capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    (["--ckpt-every", "3", "--stop-step", "5", "--ckpt-dir", "r"],
     "exclusive with --stop-step"),
    (["--retries", "2"], "requires --ckpt-every"),
    (["--max-amp", "5"], "requires --ckpt-every"),
    (["--no-watchdog"], "requires --ckpt-every"),
    (["--ckpt-dir", "r"], "requires --ckpt-every"),
    (["--ckpt-every", "0", "--ckpt-dir", "r"], "must be >= 1"),
    (["--ckpt-every", "3"], "needs --ckpt-dir"),
    (["--ckpt-every", "3", "--ckpt-dir", "r", "--retries", "-1"],
     "must be >= 0"),
    (["--ckpt-every", "3", "--ckpt-dir", "r", "--max-amp", "0"],
     "must be > 0"),
    (["--ckpt-every", "3", "--debug-nans"], "needs --ckpt-dir"),
    (["--stop-step", "0"], "--stop-step must be in [1, 12]"),
    (["--stop-step", "13"], "--stop-step must be in [1, 12]"),
    (["--resume", "x.npz", "--stop-step", "3"], "exclusive"),
], ids=["ckpt-stop", "retries", "max-amp", "no-watchdog", "ckpt-dir",
        "ckpt-every-0", "no-dir", "retries-neg", "max-amp-0", "debug-nans",
        "stop-0", "stop-past", "resume-stop"])
def test_resilience_flag_contradictions_exit_2(tmp_path, argv, needle,
                                               capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(ARGS + ["--platform", "cpu"] + argv) == 2
    assert needle in capsys.readouterr().err


def test_resume_contradictions_and_torn_checkpoints_exit_2(tmp_path,
                                                           capsys):
    from wavetpu_torch.run import faults

    run = ARGS + ["--platform", "cpu"]
    ck = str(tmp_path / "ck")
    assert cli.main(run + ["--stop-step", "4", "--save-state", ck,
                           "--out-dir", str(tmp_path)]) == 0
    sck = str(tmp_path / "sck")
    assert cli.main(run + ["--mesh", "2,2,1", "--stop-step", "4",
                           "--save-state", sck, "--out-dir",
                           str(tmp_path)]) == 0
    capsys.readouterr()
    cases = [
        (["--resume", ck + ".npz", "--scheme", "compensated"],
         "saved with scheme standard"),
        (["--resume", ck + ".npz", "--mesh", "2,1,1"], "single-device .npz"),
        (["--resume", ck + ".npz", "--backend", "sharded"],
         "single-device .npz"),
        (["--resume", sck, "--backend", "single"], "per-shard directory"),
        (["--resume", sck, "--mesh", "2,1,1"], "contradicts the checkpoint"),
        (["--resume", str(tmp_path / "empty")], "cannot load checkpoint"),
    ]
    os.makedirs(tmp_path / "empty")
    os.makedirs(tmp_path / "rot")
    open(tmp_path / "rot" / "latest", "w").write("step-00000009.npz\n")
    cases.append((["--resume", str(tmp_path / "rot")],
                  "holds no resumable checkpoint"))
    for argv, needle in cases:
        assert cli.main(argv + ["--platform", "cpu"]) == 2, argv
        assert needle in capsys.readouterr().err, argv
    # A .npz torn by a preemption mid-save, and a shard with a flipped
    # byte: clean exits 2, never a traceback.
    faults.truncate_tail(ck + ".npz", drop_bytes=256)
    assert cli.main(["--resume", ck + ".npz", "--platform", "cpu"]) == 2
    assert "cannot load checkpoint" in capsys.readouterr().err
    shard = sorted(f for f in os.listdir(sck) if f.endswith(".wts"))[0]
    faults.flip_byte(os.path.join(sck, shard))
    assert cli.main(["--resume", sck, "--platform", "cpu"]) == 2
    assert "CRC mismatch" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [[], ["--fuse-steps", "4"],
                                   ["--scheme", "compensated",
                                    "--fuse-steps", "4"],
                                   ["--mesh", "2,2,1"]],
                         ids=["1step", "kfused", "flagship", "sharded"])
def test_debug_nans(tmp_path, extra, capsys):
    """--debug-nans checks each launch's output: the same report as the
    unchecked run, and a run that overflows stops naming the layers."""
    run = ["16", "1", "1", "1", "1", "1", "11", "--platform", "cpu"] + extra
    procs = 4 if "--mesh" in extra else 1
    assert cli.main(run + ["--out-dir", str(tmp_path / "plain")]) == 0
    assert cli.main(run + ["--debug-nans", "--out-dir",
                           str(tmp_path / "checked")]) == 0
    plain = sidecar(tmp_path / "plain", n=16, procs=procs)
    checked = sidecar(tmp_path / "checked", n=16, procs=procs)
    assert plain["abs_errors"] == checked["abs_errors"]
    with pytest.raises(FloatingPointError, match="non-finite value "
                                                 "appeared in layers"):
        cli.main(["16", "1", "1", "1", "1", "100", "100", "--platform",
                  "cpu", "--debug-nans", "--out-dir", str(tmp_path)]
                 + extra)


# --debug-nans under --ckpt-every: every supervised chunk marches launch by
# launch, each launch's output checked.


@pytest.mark.parametrize("extra", [[], ["--fuse-steps", "4"],
                                   ["--scheme", "compensated",
                                    "--fuse-steps", "4"],
                                   ["--mesh", "2,2,1"]],
                         ids=["1step", "kfused", "flagship", "sharded"])
def test_supervised_debug_nans_bit_equal_to_the_march(tmp_path, extra,
                                                      capsys):
    run = ["16", "1", "1", "1", "1", "1", "20", "--platform", "cpu"] + extra
    procs = 4 if "--mesh" in extra else 1
    assert cli.main(run + ["--out-dir", str(tmp_path / "plain")]) == 0
    assert cli.main(run + ["--ckpt-every", "5", "--ckpt-dir",
                           str(tmp_path / "rot"), "--debug-nans",
                           "--out-dir", str(tmp_path / "sup")]) == 0
    assert "supervisor: complete" in capsys.readouterr().out
    plain = sidecar(tmp_path / "plain", n=16, procs=procs)
    sup = sidecar(tmp_path / "sup", n=16, procs=procs)
    assert sup["abs_errors"] == plain["abs_errors"]
    assert sup["rel_errors"] == plain["rel_errors"]
    assert (tmp_path / "plain" / f"output_N16_Np{procs}_CUDA.txt"
            ).read_text().split("max abs and rel")[1:] == \
        (tmp_path / "sup" / f"output_N16_Np{procs}_CUDA.txt"
         ).read_text().split("max abs and rel")[1:]


def test_supervised_debug_nans_drill_names_the_chunk(tmp_path, monkeypatch):
    """WAVETPU_FAULT=nan:8 under --ckpt-every 5 --debug-nans: the chunk of
    layers 7..11 holds layer 8; the poison lands at its boundary and the
    run raises there, naming those layers, before layer 11's checkpoint."""
    from wavetpu_torch.run import faults

    monkeypatch.setenv(faults.ENV_FAULT, "nan:8")
    rot = tmp_path / "rot"
    with pytest.raises(FloatingPointError,
                       match=r"layers 7\.\.11 \(the supervised chunk"):
        cli.main(["16", "1", "1", "1", "1", "1", "20", "--platform", "cpu",
                  "--ckpt-every", "5", "--ckpt-dir", str(rot),
                  "--debug-nans", "--out-dir", str(tmp_path)])
    assert (rot / "latest").read_text().strip() == "step-00000006.npz"


def test_supervised_debug_nans_names_launch_and_chunk(tmp_path):
    """A run that overflows inside a supervised chunk stops at the launch
    that made the first non-finite value, naming it and its chunk."""
    with pytest.raises(FloatingPointError,
                       match=r"the launch that computed layer \d+, in the "
                             r"supervised chunk of layers \d+\.\.\d+\)"):
        cli.main(["16", "1", "1", "1", "1", "100", "100", "--platform",
                  "cpu", "--ckpt-every", "50", "--ckpt-dir",
                  str(tmp_path / "rot"), "--no-watchdog", "--debug-nans",
                  "--out-dir", str(tmp_path)])


def test_supervised_debug_nans_as_wavetpu(tmp_path, monkeypatch, capsys):
    """wavetpu on the same argv: it accepts the pair, exits 0 on the clean
    run, and its NaN drill raises FloatingPointError at the same chunk
    boundary (jax_debug_nans traps the injection itself), leaving the same
    rotation entry latest."""
    import jax

    from wavetpu_torch.run import faults

    run = ["16", "1", "1", "1", "1", "1", "20", "--platform", "cpu",
           "--ckpt-every", "5", "--debug-nans"]
    try:
        assert jcli.main(run + ["--backend", "single", "--ckpt-dir",
                                str(tmp_path / "j"), "--out-dir",
                                str(tmp_path / "jo")]) == 0
        assert cli.main(run + ["--ckpt-dir", str(tmp_path / "t"),
                               "--out-dir", str(tmp_path / "to")]) == 0
        monkeypatch.setenv(faults.ENV_FAULT, "nan:8")
        for main, d, extra in ((jcli.main, "jd", ["--backend", "single"]),
                               (cli.main, "td", [])):
            with pytest.raises(FloatingPointError):
                main(run + extra + ["--ckpt-dir", str(tmp_path / d),
                                    "--out-dir", str(tmp_path / "x")])
            assert (tmp_path / d / "latest").read_text().strip() == \
                "step-00000006.npz"
    finally:
        jax.config.update("jax_debug_nans", False)
