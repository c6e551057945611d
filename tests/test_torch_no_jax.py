"""The port imports neither ``jax`` nor anything of the JAX package: every
module of ``repro_torch``, and ``chip_smoke.py``, import in a fresh
interpreter where both are blocked."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "repro")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import repro_torch

names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401

leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT)],
        cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60  # every module was walked
