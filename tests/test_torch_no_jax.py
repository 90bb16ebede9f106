"""The port imports nothing of JAX and nothing of wavetpu.

A fresh interpreter puts a finder on `sys.meta_path` that refuses `jax`,
`jaxlib` and `wavetpu` (and their submodules), then imports every module
of `wavetpu_torch` and `chip_smoke`.  Any import of them, direct or
through another module, fails the test.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "wavetpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
sys.meta_path.insert(0, Block())

import wavetpu_torch
names = ["wavetpu_torch"] + [
    m.name for m in pkgutil.walk_packages(wavetpu_torch.__path__,
                                          "wavetpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""

# The modules of the measurement slice, each of which must be among those
# imported (they copy wavetpu's jax-free obs modules and progkey).
MEASUREMENT_MODULES = (
    "wavetpu_torch.progkey", "wavetpu_torch.solver.timing",
    "wavetpu_torch.obs.registry", "wavetpu_torch.obs.tracing",
    "wavetpu_torch.obs.metrics", "wavetpu_torch.obs.perf",
    "wavetpu_torch.obs.ledger", "wavetpu_torch.obs.accuracy",
    "wavetpu_torch.obs.telemetry", "wavetpu_torch.obs.report",
)

# The warm-state and long-solve slice (each a copy, never an import, of
# its wavetpu module).
SERVING_12B_MODULES = (
    "wavetpu_torch.serve.progcache", "wavetpu_torch.serve.preempt",
    "wavetpu_torch.serve.shadow", "wavetpu_torch.serve.resultcache",
)


def test_port_imports_neither_jax_nor_wavetpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    # Every module of the port was imported (package + 30 modules).
    assert len(names) >= 31
    for name in MEASUREMENT_MODULES + SERVING_12B_MODULES:
        assert name in names


# The fleet tier runs on hosts with no accelerator stack: its modules (and
# the CLI's dispatch to them) load neither torch nor jax nor wavetpu.
HOST_ONLY_SCRIPT = r"""
import contextlib, importlib, io, pkgutil, sys

import wavetpu_torch.fleet, wavetpu_torch.loadgen
names = []
for pkg in (wavetpu_torch.fleet, wavetpu_torch.loadgen):
    names.append(pkg.__name__)
    names += [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                    pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from wavetpu_torch import cli
with contextlib.redirect_stderr(io.StringIO()):
    codes = [cli.main(argv) for argv in (["router"], ["fleet", "roll"],
                                         ["loadgen", "replay"])]
assert codes == [2, 2, 2], codes
leaked = sorted(n for n in sys.modules
                if n.split(".")[0] in ("torch", "jax", "jaxlib", "wavetpu"))
assert not leaked, leaked
print(" ".join(names))
"""

HOST_ONLY_MODULES = (
    "wavetpu_torch.fleet.router", "wavetpu_torch.fleet.roll",
    "wavetpu_torch.fleet.membership", "wavetpu_torch.fleet.affinity",
    "wavetpu_torch.fleet.edgecache", "wavetpu_torch.fleet.quota",
    "wavetpu_torch.fleet.store", "wavetpu_torch.fleet.ha",
    "wavetpu_torch.loadgen.trace", "wavetpu_torch.loadgen.report",
    "wavetpu_torch.loadgen.runner", "wavetpu_torch.loadgen.cli",
)


def test_fleet_and_loadgen_import_neither_torch_nor_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", HOST_ONLY_SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    for name in HOST_ONLY_MODULES:
        assert name in names
