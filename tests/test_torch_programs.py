"""The port's program-level invariant auditor
(`openr_tpu_torch/analysis/programs.py`), on the CPU.

Oracle: tests/test_programs.py, class for class, less its golden-jaxpr
snapshot (it reads jaxpr structure, which eager PyTorch does not have).
Three halves:

- the TREE is clean: the full ``--programs`` audit (every device root of
  device_paths run under the recording dispatch mode by the
  deterministic CPU drivers, against the dtype / callback / constant /
  donation / op-count contracts) reports zero findings and zero
  coverage gaps.  This is the expensive half (the drivers build ring,
  grid, blocked, delta, KSP, TE and snapshot scenarios) and runs once
  per module;
- the AUDITOR is correct: each program rule catches a seeded violation
  built from a deliberately broken function (a writer that copies
  instead of writing in place, a float promotion, a host sync, a large
  host constant) and stays silent on its correct twin;
- the budget machinery and the CLI's exit codes: a corrupt budget file
  or a broken driver is an analyzer error (2), a dirty tree is 1.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from openr_tpu_torch.analysis import (
    AnalysisError,
    Reporter,
    load_config,
    run_analysis,
)
from openr_tpu_torch.analysis import programs as P
from openr_tpu_torch.analysis.core import SourceFile

pytestmark = pytest.mark.analysis

REPO_ROOT = Path(__file__).resolve().parent.parent
PACKAGE = REPO_ROOT / "openr_tpu_torch"
BUDGETS = PACKAGE / "analysis" / "program_budgets.json"


@pytest.fixture(scope="module")
def audit():
    """One full program audit for the whole module (the expensive half)."""
    config, root = load_config(PACKAGE)
    return run_analysis([PACKAGE], config, root, programs=True)


@pytest.fixture()
def harness():
    """(reporter, audit, sf, loc) wired to a real SourceFile so seeded
    programs can be checked in isolation."""
    config, root = load_config(PACKAGE)
    reporter = Reporter(config)
    sf = SourceFile.parse(PACKAGE / "analysis" / "programs.py", root)
    return reporter, P._ProgramAudit(reporter, config, root), sf, (1, 0)


def _rules(reporter):
    return sorted(f.rule for f in reporter.findings)


def _check(harness, fn, *args, name="seed"):
    reporter, audit, sf, loc = harness
    float_ok = name in audit.config.program_float_allowed
    record = P.record_program(fn, *args, float_ok=float_ok)
    audit.check_record(sf, loc, name, record)
    return _rules(reporter)


class TestTreeIsProgramClean:
    def test_zero_findings_full_audit(self, audit):
        """The acceptance gate: every root reached, every contract holds.
        A coverage gap (a root no driver reaches) fails here too."""
        findings = audit.sorted_findings()
        assert not findings, "\n" + "\n".join(f.format() for f in findings)

    def test_budget_file_covers_every_program(self):
        budgets = json.loads(BUDGETS.read_text())
        assert len(budgets) >= 25
        assert all(isinstance(v, int) and v > 0 for v in budgets.values())
        config, root = load_config(PACKAGE)
        roots = P._discover_roots(P._root_files([], config, root), config)
        assert set(budgets) == {f"{m}.{f}" for m, f in roots}
        # a kernel wrapper's call is one op, as a pallas_call is one
        # primitive in the reference's count
        for mod, fn in P.KERNEL_ROOTS:
            assert budgets[f"{mod}.{fn}"] == 1


class TestSeededViolations:
    def test_dropped_donation_is_caught(self):
        """A writer that copies the resident and writes the copy (the
        port's form of a dropped donation): the resident is not written
        in place and a copy of its shape is allocated."""
        resident = torch.zeros(64, dtype=torch.int32)

        def copies(target, idx, vals):
            target = target.clone()
            target[idx] = vals
            return target

        problems = P.record_writer(
            copies, [resident], resident, torch.tensor([3]), torch.tensor([7], dtype=torch.int32)
        )
        assert any("copy of a resident" in p for p in problems)
        assert any("no version bump" in p for p in problems)

    def test_honored_donation_stays_silent(self):
        resident = torch.zeros(64, dtype=torch.int32)

        def writes(target, idx, vals):
            target[idx] = vals
            return target

        problems = P.record_writer(
            writes, [resident], resident, torch.tensor([3]), torch.tensor([7], dtype=torch.int32)
        )
        assert problems == []

    def test_weak_float_promotion_is_caught(self, harness):
        def promotes(x):
            return x / 2  # true division of integers -> float32

        assert "program-dtype" in _check(harness, promotes, torch.arange(4))

    def test_float_allowlist_spares_loss_kernels(self, harness):
        harness[1].config.program_float_allowed = ["blessed"]

        def blessed(x):
            return x * 2.5

        assert _check(harness, blessed, torch.ones(4), name="blessed") == []

    def test_host_callback_is_caught(self, harness):
        def chatty(x):
            if x.sum() > 0:  # a host read inside the program
                x = x + 1
            return x[x > 2]  # a data-dependent shape

        assert _check(harness, chatty, torch.arange(4)).count("program-callback") == 2

    def test_large_closed_over_constant_is_caught(self, harness):
        embedded = np.arange(4096, dtype=np.int32)  # 16 KiB

        def closes_over(x):
            return x + torch.from_numpy(embedded)

        assert "program-constants" in _check(
            harness, closes_over, torch.zeros(4096, dtype=torch.int32)
        )

    def test_integer_min_plus_program_stays_silent(self, harness):
        def relax(d, m):
            return torch.minimum(d, d + m)

        args = (torch.arange(8, dtype=torch.int32), torch.ones(8, dtype=torch.int32))
        assert _check(harness, relax, *args) == []


class TestBudgetMachinery:
    def test_corrupt_budget_file_is_analyzer_error(self, tmp_path):
        bad = tmp_path / "program_budgets.json"
        bad.write_text("{not json")
        with pytest.raises(AnalysisError, match="unreadable budget file"):
            P._load_budgets(bad)
        bad.write_text("[1, 2]")
        with pytest.raises(AnalysisError, match="JSON object"):
            P._load_budgets(bad)

    def test_missing_budget_file_means_no_budgets(self, tmp_path):
        assert P._load_budgets(tmp_path / "absent.json") == {}

    def test_analyzer_errors_exit_2_findings_exit_1(self, monkeypatch):
        """The CLI's split: a broken auditor (driver/config failure) is
        rc 2, a dirty tree is rc 1 — CI must not confuse the two."""
        from openr_tpu_torch.analysis import cli

        def boom(*a, **kw):
            raise AnalysisError("program auditor driver 'x' failed")

        monkeypatch.setattr(cli, "run_analysis", boom)
        assert cli.main(["openr_tpu_torch", "--programs"]) == 2

        fixture = str(
            REPO_ROOT / "tests" / "analysis_fixtures" / "counter_violations.py"
        )
        monkeypatch.undo()
        assert cli.main([fixture]) == 1

    def test_broken_driver_exits_2(self, monkeypatch, capsys):
        """A driver that fails is a broken analyzer, never a silently
        smaller audit."""
        from openr_tpu_torch.analysis import cli

        def broken(state):
            raise RuntimeError("seeded driver failure")

        monkeypatch.setattr(P, "DRIVERS", (("broken", broken),))
        assert cli.main([str(PACKAGE), "--programs"]) == 2
        assert "driver 'broken' failed" in capsys.readouterr().err
