"""openr_tpu_torch stands alone: it imports neither jax nor openr_tpu.

A fresh interpreter imports every module of the port and must end with
no `jax*` and no `openr_tpu` module loaded; `chip_smoke.py` and the port
name neither in an import statement; arming the port's race detector
with its own config tracks only the port's classes.
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
print(",".join(names))
print(",".join(bad))
"""

# the daemon layer's modules, which the walk must reach
DAEMON_MODULES = {
    "openr_tpu_torch.main",
    "openr_tpu_torch.config",
    "openr_tpu_torch.config_store.persistent_store",
    "openr_tpu_torch.allocators.prefix_allocator",
    "openr_tpu_torch.allocators.range_allocator",
    "openr_tpu_torch.monitor.monitor",
    "openr_tpu_torch.monitor.watchdog",
    "openr_tpu_torch.plugin",
    "openr_tpu_torch.ctrl.client",
    "openr_tpu_torch.ctrl.server",
    "openr_tpu_torch.ctrl.tls",
    "openr_tpu_torch.cli.breeze",
    # the rest of the node: rtnetlink, the FIB agent, the Thrift shim
    "openr_tpu_torch.nl",
    "openr_tpu_torch.nl.netlink",
    "openr_tpu_torch.platform",
    "openr_tpu_torch.platform.fib_agent",
    "openr_tpu_torch.interop",
    "openr_tpu_torch.interop.thrift_binary",
    "openr_tpu_torch.interop.shim",
    # observability: the tracer and the histogram
    "openr_tpu_torch.obs",
    "openr_tpu_torch.obs.trace",
    "openr_tpu_torch.obs.histogram",
    # the analysis layer: checker, race detector, schedule explorer
    "openr_tpu_torch.analysis",
    "openr_tpu_torch.analysis.core",
    "openr_tpu_torch.analysis.counters",
    "openr_tpu_torch.analysis.threads",
    "openr_tpu_torch.analysis.cli",
    "openr_tpu_torch.analysis.race",
    "openr_tpu_torch.analysis.sched",
    "openr_tpu_torch.analysis.pytest_tsan",
    # the chaos layer: injectors, scenarios, OCS, load generator, fuzzer
    "openr_tpu_torch.chaos",
    "openr_tpu_torch.chaos.chaos",
    "openr_tpu_torch.chaos.scenario",
    "openr_tpu_torch.chaos.flapstorm",
    "openr_tpu_torch.chaos.ocs",
    "openr_tpu_torch.chaos.overload",
    "openr_tpu_torch.chaos.replicafleet",
    "openr_tpu_torch.chaos.fuzz",
}


def test_importing_every_module_loads_no_jax_and_no_reference():
    proc = subprocess.run(
        [sys.executable, "-c", PROBE],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    names, bad = proc.stdout.splitlines()
    names = set(names.split(","))
    assert len(names) >= 74
    assert DAEMON_MODULES <= names, DAEMON_MODULES - names
    assert bad == "", bad


ARM_PROBE = """
import sys
from openr_tpu_torch.analysis import race
det = race.enable()
tracked = sorted(f"{c.__module__}.{c.__qualname__}" for c in race._TRACKED)
race.disable()
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "openr_tpu")
)
print(",".join(tracked))
print(",".join(bad))
"""


def test_arming_with_the_ports_config_tracks_only_port_classes():
    """`race.enable()` resolves the tracked classes of the package's
    analysis.toml: the port's three, never the reference's, and loading
    them imports no jax and no openr_tpu."""
    proc = subprocess.run(
        [sys.executable, "-c", ARM_PROBE],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    tracked, bad = proc.stdout.splitlines()
    assert tracked.split(",") == [
        "openr_tpu_torch.runtime.eventbase.OpenrEventBase",
        "openr_tpu_torch.serving.router.ReplicaRouter",
        "openr_tpu_torch.serving.router.SchedulerReplica",
    ]
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
