"""openr_tpu_torch stands alone: it imports neither jax nor openr_tpu.

A fresh interpreter imports every module of the port and must end with
no `jax*` and no `openr_tpu` module loaded; `chip_smoke.py` and the port
name neither in an import statement.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import openr_tpu_torch
names = [
    m.name
    for m in pkgutil.walk_packages(openr_tpu_torch.__path__, "openr_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "openr_tpu")
)
print(len(names))
print(",".join(bad))
"""


def test_importing_every_module_loads_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.splitlines()
    assert int(n_modules) >= 35
    assert bad == "", bad


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_and_chip_smoke_import_statements():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "openr_tpu_torch").rglob("*.py"))]
    for path in files:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "openr_tpu"}, path
