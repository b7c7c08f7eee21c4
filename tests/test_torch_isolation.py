"""The PyTorch port stands alone: no module of workloads_torch and not
chip_smoke.py imports jax or anything of the JAX package (workloads),
checked by importing everything with both blocked and by scanning the
sources."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "workloads_torch")

# An import statement naming jax or the JAX package (workloads_torch is
# a different name and passes).
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|workloads)(?![\w])", re.MULTILINE
)


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_scan_catches_forbidden_lines():
    """The scan itself: it flags the JAX package and jax, not the port."""
    flagged = [
        "im" + "port jax", "fr" + "om jax import numpy", "  im" + "port workloads.model",
        "fr" + "om workloads import serve", "fr" + "om workloads.ops import x",
    ]
    allowed = ["fr" + "om workloads_torch import serve", "im" + "port workloads_torch.model",
               "x = 'import jax'"]
    assert all(_FORBIDDEN.search(line) for line in flagged)
    assert not any(_FORBIDDEN.search(line) for line in allowed)


def test_every_module_imports_with_jax_and_workloads_blocked():
    """Import every module of the port, and chip_smoke, in a fresh
    interpreter where importing jax or workloads raises."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "sys.modules['jax'] = None",
        "sys.modules['workloads'] = None",
        f"sys.path.insert(0, {ROOT!r})",
        "pkg = importlib.import_module('workloads_torch')",
        "names = ['chip_smoke'] + [m.name for m in pkgutil.walk_packages("
        "pkg.__path__, 'workloads_torch.')]",
        "for name in names:",
        "    importlib.import_module(name)",
        "assert sys.modules['jax'] is None and sys.modules['workloads'] is None",
        "print(len(names))",
    ])
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 14  # chip_smoke + every port module
