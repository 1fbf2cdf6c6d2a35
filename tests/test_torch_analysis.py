"""The port's static invariant checker (`openr_tpu_torch.analysis`)
against the reference's (`openr_tpu.analysis`), on the CPU.

Oracles: tests/test_analysis.py and the static half of
tests/test_race.py.  Both checkers parse the same
`tests/analysis_fixtures/*.py` files and must report equal sorted
`(rule, line)` pairs, findings and suppressed ones, for every rule the
port has; each family's seeded pairs are also pinned exactly, as the
reference's tests pin them.  The reference's `jit-*` family becomes the
port's `device-*` dispatch rules (`TestJitRules` and
`TestUnbucketedDispatchRule` here): their fixtures are JAX programs, so
the port's counterparts, tests/torch_analysis_fixtures/, mirror them
construct for construct, and `JIT_TO_DEVICE` maps each reference pair to
the port's.  The port's own tree must be clean, its
config is its package's `analysis.toml` (never pyproject.toml's
`[tool.openr-analysis]`), and its CLI keeps the exit-code contract.

Pure AST: nothing is imported from the fixtures.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from openr_tpu.analysis import AnalysisConfig as JAnalysisConfig
from openr_tpu.analysis import run_analysis as j_run_analysis
from openr_tpu_torch.analysis import (
    ALL_RULES,
    AnalysisConfig,
    AnalysisError,
    load_config,
    read_config,
    run_analysis,
)

pytestmark = pytest.mark.analysis

REPO_ROOT = Path(__file__).resolve().parent.parent
FIXTURES = REPO_ROOT / "tests" / "analysis_fixtures"
PACKAGE = REPO_ROOT / "openr_tpu_torch"
FIXTURE_NAMES = sorted(p.name for p in FIXTURES.glob("*.py"))

# stands in for a parsed OpenrCtrlHandler._all_counters surface, as in
# the reference's tests
EXTRA_PREFIXES = ["kvstore", "fib", "queue"]


def _port(*names: str):
    config = AnalysisConfig(counter_extra_prefixes=EXTRA_PREFIXES)
    return run_analysis([FIXTURES / n for n in names], config, REPO_ROOT)


def _ref(*names: str):
    config = JAnalysisConfig(
        jit_paths=["tests/analysis_fixtures"],
        counter_extra_prefixes=EXTRA_PREFIXES,
    )
    return j_run_analysis([FIXTURES / n for n in names], config, REPO_ROOT)


def _ported(finding) -> bool:
    """A reference finding of a rule family the port has.  A
    suppression-unused finding counts only when the marker it names is
    of such a rule (the reference also reports idle jit-* markers)."""
    if finding.rule not in ALL_RULES:
        return False
    if finding.rule == "suppression-unused":
        return "'jit-" not in finding.message and "'program-" not in finding.message
    return True


def _pairs(findings) -> list:
    return sorted((f.rule, f.line) for f in findings)


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_findings_equal_reference(name):
    port, ref = _port(name), _ref(name)
    assert _pairs(port.findings) == _pairs(f for f in ref.findings if _ported(f))
    assert _pairs(port.suppressed) == _pairs(f for f in ref.suppressed if _ported(f))
    # the same messages, so the operator reads the same diagnostics
    assert sorted(f.message for f in port.findings) == sorted(
        f.message for f in ref.findings if _ported(f)
    )


# each family's seeded (rule, line) pairs and suppressions, as the
# reference's tests pin them
SEEDED = {
    "thread_violations.py": (
        [("thread-cross-module-write", 29), ("thread-cross-module-write", 49),
         ("thread-queue-registration", 23)],
        [("thread-cross-module-write", 33)],
    ),
    "blocking_eventbase.py": (
        [("blocking-call-in-eventbase", 21), ("blocking-call-in-eventbase", 28),
         ("blocking-call-in-eventbase", 37), ("blocking-call-in-eventbase", 40)],
        [("blocking-call-in-eventbase", 45)],
    ),
    "counter_violations.py": (
        [("counter-duplicate", 28), ("counter-duplicate", 31), ("counter-name", 22),
         ("counter-registry", 25)],
        [("counter-name", 34)],
    ),
    "counter_unbumped.py": (
        [("counter-unbumped", 16), ("counter-unbumped", 24)],
        [("counter-unbumped", 27)],
    ),
    "suppression_unused.py": (
        [("suppression-unused", 25), ("suppression-unused", 26)],
        [("counter-name", 24), ("counter-name", 26)],
    ),
    "race_lockorder.py": (
        [("guarded-by", 57), ("lock-order", 19), ("lock-order", 24)],
        [("guarded-by", 61)],
    ),
    "shutdown_order.py": (
        [("thread-shutdown-order", 21), ("thread-shutdown-order", 23)],
        [],
    ),
}


@pytest.mark.parametrize("name", sorted(SEEDED))
def test_seeded_violations_by_rule_and_line(name):
    findings, suppressed = SEEDED[name]
    rep = _port(name)
    assert _pairs(rep.findings) == findings
    assert [(s.rule, s.line) for s in rep.suppressed] == suppressed


def test_blocking_rule_clean_constructs_not_flagged():
    # awaited .get(), bounded timeouts, caller-thread blocking, a local
    # import alias shadowing a method name and dict.get stay silent
    flagged = {line for _, line in _pairs(_port("blocking_eventbase.py").findings)}
    assert not flagged & set(range(47, 80))


def test_program_and_jit_markers_never_reported_unused():
    # the program-dtype marker of line 28 names a rule the port has no
    # checker for; flagging it would train people to delete markers the
    # reference's --programs run still needs
    rep = _port("suppression_unused.py", "jit_violations.py", "unbucketed_daemon.py")
    assert all(f.rule != "suppression-unused" or "jit_" not in f.path for f in rep.findings)
    assert all(f.line != 28 for f in rep.findings if f.path.endswith("suppression_unused.py"))
    assert not [f for f in rep.findings if f.path.endswith(("jit_violations.py",
                                                            "unbucketed_daemon.py"))]


def test_lock_order_messages_cite_the_reverse_site():
    rep = _port("race_lockorder.py")
    by_line = {f.line: f.message for f in rep.findings if f.rule == "lock-order"}
    assert "race_lockorder.py:24" in by_line[19]
    assert "race_lockorder.py:19" in by_line[24]


def test_shutdown_order_messages():
    messages = sorted(f.message for f in _port("shutdown_order.py").findings)
    assert "never closed" in messages[1]
    assert "runs before `self.updates` closes" in messages[0]


def test_rules_are_the_references_less_jit_and_program():
    """The reference's rules, the jit-* family renamed to the port's
    device-* rules (jit-static-hygiene has no counterpart) and the
    program-* ids kept; the descriptions of the shared families are the
    reference's."""
    from openr_tpu.analysis import ALL_RULES as J_ALL_RULES

    renamed = {
        "jit-host-sync": "device-host-sync",
        "jit-tracer-branch": "device-tensor-branch",
        "jit-dispatch-sync": "device-dispatch-sync",
        "jit-unbucketed-dispatch": "device-unbucketed-dispatch",
        "jit-static-hygiene": None,
    }
    assert set(renamed) == {r for r in J_ALL_RULES if r.startswith("jit-")}
    want = {r for r in J_ALL_RULES if not r.startswith("jit-")}
    want |= {r for r in renamed.values() if r}
    assert set(ALL_RULES) == want
    shared = [r for r in J_ALL_RULES if not r.startswith(("jit-", "program-"))]
    assert {r: ALL_RULES[r] for r in shared} == {r: J_ALL_RULES[r] for r in shared}


PORT_FIXTURES = REPO_ROOT / "tests" / "torch_analysis_fixtures"

# tests/test_analysis.py's pinned (rule, line) pairs of jit_violations.py
# and the unbucketed_* fixtures, each beside its counterpart in the
# port's fixtures (None: jit-static-hygiene, no counterpart)
JIT_TO_DEVICE = {
    "jit_violations.py": {
        ("jit-host-sync", 18): ("device-host-sync", 18),
        ("jit-host-sync", 19): ("device-host-sync", 19),
        ("jit-host-sync", 20): ("device-host-sync", 20),
        ("jit-host-sync", 21): ("device-host-sync", 21),
        ("jit-tracer-branch", 28): ("device-tensor-branch", 27),
        ("jit-tracer-branch", 30): ("device-tensor-branch", 29),
        ("jit-tracer-branch", 55): ("device-tensor-branch", 43),
        ("jit-dispatch-sync", 73): ("device-dispatch-sync", 59),
        ("jit-dispatch-sync", 74): ("device-dispatch-sync", 60),
        ("jit-static-hygiene", 43): None,
        ("jit-static-hygiene", 49): None,
        ("jit-static-hygiene", 87): None,
    },
    "unbucketed": {
        ("jit-unbucketed-dispatch", 22): ("device-unbucketed-dispatch", 19),
        ("jit-unbucketed-dispatch", 23): ("device-unbucketed-dispatch", 20),
        ("jit-unbucketed-dispatch", 27): ("device-unbucketed-dispatch", 24),
    },
}
# the suppressed pairs, likewise
JIT_TO_DEVICE_SUPPRESSED = {
    "jit_violations.py": {("jit-host-sync", 68): ("device-host-sync", 54)},
    "unbucketed": {("jit-unbucketed-dispatch", 38): ("device-unbucketed-dispatch", 35)},
}


def _dispatch_findings():
    config = AnalysisConfig(device_paths=["tests/torch_analysis_fixtures"])
    return run_analysis([PORT_FIXTURES / "dispatch_violations.py"], config, REPO_ROOT)


def _unbucketed_findings(port: bool):
    names = ("unbucketed_ops.py", "unbucketed_daemon.py", "unbucketed_engine.py")
    if port:
        config = AnalysisConfig(
            device_paths=["tests/torch_analysis_fixtures/unbucketed_ops.py"],
            engine_dispatch_paths=["tests/torch_analysis_fixtures/unbucketed_engine.py"],
        )
        return run_analysis([PORT_FIXTURES / n for n in names], config, REPO_ROOT)
    config = JAnalysisConfig(
        jit_paths=["tests/analysis_fixtures/unbucketed_ops.py"],
        engine_dispatch_paths=["tests/analysis_fixtures/unbucketed_engine.py"],
    )
    return j_run_analysis([FIXTURES / n for n in names], config, REPO_ROOT)


def _mapped(table: dict, pairs) -> list:
    return sorted(table[p] for p in pairs if table[p] is not None)


class TestJitRules:
    """The dispatch rules (analysis/dispatch.py) on the mirror of the
    reference's jit_violations.py."""

    def test_seeded_violations_by_rule_and_line(self):
        assert _pairs(_dispatch_findings().findings) == [
            ("device-dispatch-sync", 59),
            ("device-dispatch-sync", 60),
            ("device-host-sync", 18),
            ("device-host-sync", 19),
            ("device-host-sync", 20),
            ("device-host-sync", 21),
            ("device-tensor-branch", 27),
            ("device-tensor-branch", 29),
            ("device-tensor-branch", 43),
        ]

    def test_pairs_map_onto_the_references(self):
        """Every reference pair maps onto exactly the port's pair (the
        static-argument ones onto none)."""
        ref = _ref("jit_violations.py")
        table = JIT_TO_DEVICE["jit_violations.py"]
        jit_pairs = [p for p in _pairs(ref.findings) if p[0].startswith("jit-")]
        assert sorted(jit_pairs) == sorted(table)
        assert _mapped(table, jit_pairs) == _pairs(_dispatch_findings().findings)
        sup = JIT_TO_DEVICE_SUPPRESSED["jit_violations.py"]
        assert [(s.rule, s.line) for s in ref.suppressed] == list(sup)
        assert [(s.rule, s.line) for s in _dispatch_findings().suppressed] == list(
            sup.values()
        )

    def test_interprocedural_propagation(self):
        # line 43 lives in a private function only reached from a device
        # root; flagging it proves call-graph propagation
        assert ("device-tensor-branch", 43) in _pairs(_dispatch_findings().findings)

    def test_clean_constructs_not_flagged(self):
        # host-argument branches, is-None checks, shape/dtype reads,
        # torch.where, a declared fetch point and fetch-based dispatch
        # must all be silent: host_arg_branch (34-38),
        # dispatch_explicit_fetch (64-69), clean_kernel (72-84)
        flagged = {line for _, line in _pairs(_dispatch_findings().findings)}
        for line in [*range(34, 39), *range(64, 70), *range(72, 85)]:
            assert line not in flagged

    def test_static_hygiene_has_no_counterpart(self):
        assert "jit-static-hygiene" not in ALL_RULES
        assert all(not r.startswith("jit-") for r in ALL_RULES)


class TestUnbucketedDispatchRule:
    """device-unbucketed-dispatch over three fixture layers: kernels
    (device_paths), the sanctioned front-end (engine_dispatch_paths), and
    a daemon module whose direct root calls are the seeded violations."""

    def test_seeded_violations_by_rule_and_line(self):
        # 19: a root by `from` import, 20: a root by module alias,
        # 24: a module-level partial over a root, made in the daemon
        assert _pairs(_unbucketed_findings(True).findings) == [
            ("device-unbucketed-dispatch", 19),
            ("device-unbucketed-dispatch", 20),
            ("device-unbucketed-dispatch", 24),
        ]

    def test_pairs_map_onto_the_references(self):
        ref = _unbucketed_findings(False)
        table = JIT_TO_DEVICE["unbucketed"]
        assert _pairs(ref.findings) == sorted(table)
        assert _mapped(table, _pairs(ref.findings)) == _pairs(
            _unbucketed_findings(True).findings
        )
        sup = JIT_TO_DEVICE_SUPPRESSED["unbucketed"]
        assert [(s.rule, s.line) for s in ref.suppressed] == list(sup)

    def test_rationale_suppression_is_honored(self):
        rep = _unbucketed_findings(True)
        assert [(s.rule, s.line) for s in rep.suppressed] == [
            ("device-unbucketed-dispatch", 35)
        ]

    def test_kernel_and_engine_layers_exempt(self):
        rep = _unbucketed_findings(True)
        assert all(f.path.endswith("unbucketed_daemon.py") for f in rep.findings)

    def test_the_ports_tree_routes_through_the_engine(self):
        """The port's own daemon code calls no device root directly
        outside the protection API's three marked calls."""
        config, root = load_config(PACKAGE)
        rep = run_analysis([PACKAGE], config, root)
        marked = [
            (s.path, s.rule) for s in rep.suppressed if s.rule == "device-unbucketed-dispatch"
        ]
        assert marked == [("openr_tpu_torch/decision/protection_api.py",
                           "device-unbucketed-dispatch")] * 3


class TestChangedOnly:
    def test_filter_scopes_findings(self, monkeypatch):
        from openr_tpu_torch.analysis import cli

        fixture = str(FIXTURES / "counter_violations.py")
        monkeypatch.setattr(cli, "_changed_files", lambda root: {"some/other_file.py"})
        assert cli.main([fixture, "--changed-only"]) == 0
        monkeypatch.setattr(
            cli, "_changed_files",
            lambda root: {"tests/analysis_fixtures/counter_violations.py"},
        )
        assert cli.main([fixture, "--changed-only"]) == 1

    def test_lock_discipline_findings_survive_the_filter(self, monkeypatch):
        from openr_tpu_torch.analysis import cli

        monkeypatch.setattr(cli, "_changed_files", lambda root: {"some/other_file.py"})
        assert cli.main([str(FIXTURES / "race_lockorder.py"), "--changed-only"]) == 1

    def test_git_failure_is_exit_2(self, tmp_path):
        """Outside a git work tree the flag is an infrastructure error,
        never a silent 'no changes, clean' pass."""
        (tmp_path / "probe.py").write_text("x = 1\n")
        proc = subprocess.run(
            [sys.executable, "-m", "openr_tpu_torch.analysis", "probe.py", "--changed-only"],
            cwd=tmp_path, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(REPO_ROOT)},
        )
        assert proc.returncode == 2, proc.stdout + proc.stderr
        assert "--changed-only needs" in proc.stderr


class TestConfig:
    def test_the_package_config_names_the_ports_paths(self):
        config, root = load_config(PACKAGE)
        assert root == REPO_ROOT
        assert config.exclude == ["openr_tpu_torch/platform"]
        assert config.tsan_tracked_paths == [
            "openr_tpu_torch.runtime.eventbase.OpenrEventBase",
            "openr_tpu_torch.serving.router.ReplicaRouter",
            "openr_tpu_torch.serving.router.SchedulerReplica",
        ]
        assert config.active_rules() == set(ALL_RULES)

    def test_pyproject_section_is_never_read(self, tmp_path):
        # a project whose pyproject disables every rule and excludes
        # everything: the port's checker ignores it
        (tmp_path / "pyproject.toml").write_text(
            "[tool.openr-analysis]\n"
            f"disable = {sorted(ALL_RULES)!r}\n".replace("'", '"')
            + 'exclude = ["probe.py"]\n'
        )
        (tmp_path / "probe.py").write_text(
            "class C:\n    def f(self):\n        self.counters['BadName'] = 1\n"
        )
        config, root = load_config(tmp_path / "probe.py")
        assert config.disable == [] and config.exclude == ["openr_tpu_torch/platform"]
        rep = run_analysis([tmp_path / "probe.py"], config, root)
        assert [f.rule for f in rep.findings] == ["counter-name"]

    def test_minimal_parser_reads_the_config_as_tomllib_does(self):
        import tomllib

        from openr_tpu_torch.analysis.core import CONFIG_PATH, _parse_toml_minimal

        text = CONFIG_PATH.read_text()
        assert _parse_toml_minimal(text) == tomllib.loads(text)

    def test_an_unreadable_config_is_an_analysis_error(self, tmp_path):
        with pytest.raises(AnalysisError):
            read_config(tmp_path / "missing.toml")


class TestTreeIsClean:
    def test_package_has_zero_unsuppressed_findings(self):
        """`python -m openr_tpu_torch.analysis openr_tpu_torch/` exits 0,
        run in-process; findings are printed on failure."""
        config, root = load_config(PACKAGE)
        reporter = run_analysis([PACKAGE], config, root)
        findings = reporter.sorted_findings()
        assert not findings, "\n" + "\n".join(f.format() for f in findings)
        # every suppression in the tree is one the reference carries for
        # the same construct, the serving family's wire-parity seed, or
        # the chaos harness's pin-trace seam (the reference's checker
        # skips its chaos/ altogether; the port's checks it)
        # the dispatch rules' markers are deliberate host reads of values
        # already fetched (fleet.py, delta.py, te/exact.py) and the
        # protection API's runner calls, which the reference suppresses too
        assert sorted({(f.rule, f.path) for f in reporter.suppressed}) == [
            ("counter-name", "openr_tpu_torch/fib/fib.py"),
            ("counter-unbumped", "openr_tpu_torch/serving/scheduler.py"),
            ("device-dispatch-sync", "openr_tpu_torch/decision/fleet.py"),
            ("device-dispatch-sync", "openr_tpu_torch/te/exact.py"),
            ("device-tensor-branch", "openr_tpu_torch/ops/delta.py"),
            ("device-unbucketed-dispatch", "openr_tpu_torch/decision/protection_api.py"),
            ("guarded-by", "openr_tpu_torch/allocators/prefix_allocator.py"),
            ("guarded-by", "openr_tpu_torch/config_store/persistent_store.py"),
            ("thread-cross-module-write", "openr_tpu_torch/chaos/replicafleet.py"),
            ("thread-cross-module-write", "openr_tpu_torch/main.py"),
        ]

    def test_registry_discovery_parsed_ctrl_handler(self):
        from openr_tpu_torch.analysis.core import SourceFile
        from openr_tpu_torch.analysis.counters import _exported_prefixes

        sf = SourceFile.parse(PACKAGE / "ctrl" / "server.py", REPO_ROOT)
        prefixes = _exported_prefixes([sf])
        assert {
            "kvstore", "decision", "fib", "link_monitor", "prefix_manager", "spark",
            "monitor", "watchdog", "netlink", "queue", "sched", "obs", "snapshot",
        } <= prefixes

    def test_cli_exit_codes(self):
        dirty = subprocess.run(
            [sys.executable, "-m", "openr_tpu_torch.analysis", str(FIXTURES)],
            cwd=REPO_ROOT, capture_output=True, text=True,
        )
        assert dirty.returncode == 1, dirty.stdout + dirty.stderr
        assert "counter-name" in dirty.stdout
        clean = subprocess.run(
            [sys.executable, "-m", "openr_tpu_torch.analysis", "openr_tpu_torch/"],
            cwd=REPO_ROOT, capture_output=True, text=True,
        )
        assert clean.returncode == 0, clean.stdout + clean.stderr
        missing = subprocess.run(
            [sys.executable, "-m", "openr_tpu_torch.analysis", "no/such/path"],
            cwd=REPO_ROOT, capture_output=True, text=True,
        )
        assert missing.returncode == 2

    def test_list_rules_and_json_format(self, capsys):
        import json

        from openr_tpu_torch.analysis import cli

        assert cli.main(["--list-rules"]) == 0
        listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
        assert listed == sorted(ALL_RULES)
        assert cli.main([str(FIXTURES / "counter_violations.py"), "--format", "json"]) == 1
        out = json.loads(capsys.readouterr().out)
        rep = run_analysis([FIXTURES / "counter_violations.py"], read_config(), REPO_ROOT)
        assert sorted((f["rule"], f["line"]) for f in out["findings"]) == _pairs(rep.findings)
        assert out["suppressed"] == 1
