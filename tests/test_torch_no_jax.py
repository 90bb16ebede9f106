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
print(len(names))
"""


def test_port_imports_neither_jax_nor_wavetpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    # Every module of the slice was imported (package + 20 modules).
    assert int(proc.stdout.split()[-1]) >= 17
