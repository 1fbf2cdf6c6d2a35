"""Command line front end: ``python -m openr_tpu_torch.analysis [paths...]``.

Port of `openr_tpu.analysis.cli`, less its ``--programs`` and
``--write-budgets`` flags (the jaxpr audit has no counterpart).  Exit
codes gate CI precisely:

- ``0`` — clean tree (no unsuppressed findings)
- ``1`` — findings: the tree is dirty, the analyzer worked
- ``2`` — the ANALYZER is broken or misused: bad paths, an unreadable
  config file, git unavailable for ``--changed-only``.  CI must treat 2
  as infra failure, not as "findings".

``--changed-only`` restricts *reported* findings to files touched in the
working tree (staged, unstaged or untracked, per ``git status``).
Analysis still runs over the full target set — counter cross-referencing
and the suppression audit are whole-tree properties, and scoping the
*analysis* would fabricate false positives (a counter seeded in a
changed file but bumped in an unchanged one).  The lock-discipline
families (``lock-order``, ``guarded-by``, ``thread-shutdown-order``)
always survive the filter: a cycle through the whole-tree lock graph or
a shutdown-order hole can anchor to an unchanged file that an edit
elsewhere just made reachable.

``--races <pytest expr...>`` runs pytest over the given expressions in a
subprocess with the port's OPENR_TSAN detector (analysis/race.py) armed
by the ``openr_tpu_torch.analysis.pytest_tsan`` plugin, which fails any
test whose run produced an unsuppressed race.  The subprocess leaves
``OPENR_TSAN`` unset, so the reference's own detector is never armed
beside the port's.  Same exit-code contract (0 clean, 1 findings, 2
infra failure).

``--sched`` runs the deterministic schedule explorer (analysis/sched.py)
over the scenario library: exhaustive DPOR with certificate on the
smallest scenarios, POS sampling on the rest, under OPENR_SCHED_BUDGET_S.
``--sched-replay <id>`` re-executes one schedule bit-identically;
``--sched-shrink <id>`` ddmin-minimizes a failing schedule's choice
string.  Setting OPENR_SCHED=1 in the environment implies ``--sched``.
Same exit-code contract: 0 clean, 1 failing schedules, 2 infra failure.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from .core import ALL_RULES, AnalysisError, load_config, run_analysis


def _changed_files(root: Path) -> set[str]:
    """Repo-relative posix paths of files touched in the working tree."""
    try:
        proc = subprocess.run(
            ["git", "-C", str(root), "status", "--porcelain"],
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise AnalysisError(f"--changed-only needs git: {e}") from e
    if proc.returncode != 0:
        raise AnalysisError(
            "--changed-only needs a git work tree: "
            f"git status failed: {proc.stderr.strip()}"
        )
    changed: set[str] = set()
    for line in proc.stdout.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        # renames report "old -> new"; the new path is the analyzable one
        if " -> " in path:
            path = path.split(" -> ", 1)[1]
        path = path.strip().strip('"')
        changed.add(Path(path).as_posix())
    return changed


def _run_races(exprs: list[str]) -> int:
    """Run pytest over `exprs` in a subprocess with the port's detector
    armed by its pytest plugin (the detector patches threading and
    futures — that must happen in a fresh interpreter, before the tests'
    objects exist).  OPENR_TSAN is removed from the subprocess's
    environment: under it the suite's conftest would arm the reference's
    detector too."""
    env = dict(os.environ)
    env.pop("OPENR_TSAN", None)
    env.setdefault("JAX_PLATFORMS", "cpu")
    cmd = [
        sys.executable,
        "-m",
        "pytest",
        "-q",
        "-p",
        "openr_tpu_torch.analysis.pytest_tsan",
        *exprs,
    ]
    try:
        proc = subprocess.run(cmd, env=env)
    except OSError as e:
        print(f"error: --races could not launch pytest: {e}", file=sys.stderr)
        return 2
    if proc.returncode == 0:
        return 0
    if proc.returncode == 1:
        return 1  # test failures, incl. the plugin's race findings
    # collection error, usage error, interrupted, ... -> infra failure
    return 2


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m openr_tpu_torch.analysis",
        description=(
            "openr_tpu_torch static invariant checker: thread "
            "discipline and counter hygiene"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["openr_tpu_torch"],
        help="files or directories to analyze (default: openr_tpu_torch)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt"
    )
    parser.add_argument(
        "--show-suppressed",
        action="store_true",
        help="also print findings silenced by '# openr: disable=' markers",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rule ids and exit"
    )
    parser.add_argument(
        "--changed-only",
        action="store_true",
        help=(
            "report findings only for files touched in the git working "
            "tree; lock-discipline findings are always whole-tree"
        ),
    )
    parser.add_argument(
        "--races",
        nargs="+",
        metavar="TEST_EXPR",
        help=(
            "run the given pytest expressions with the port's dynamic "
            "happens-before race detector armed; any unsuppressed race "
            "fails the run with exit code 1"
        ),
    )
    parser.add_argument(
        "--sched",
        action="store_true",
        help=(
            "run the deterministic schedule explorer over the scenario "
            "library (DPOR + POS sampling under OPENR_SCHED_BUDGET_S); "
            "OPENR_SCHED=1 in the environment implies this flag"
        ),
    )
    parser.add_argument(
        "--sched-replay",
        metavar="SCHEDULE_ID",
        help=(
            "re-execute one schedule bit-identically from its id "
            "(scenario[+plant]:s<seed>:<c0.c1...>); implies --sched"
        ),
    )
    parser.add_argument(
        "--sched-shrink",
        metavar="SCHEDULE_ID",
        help=(
            "ddmin-minimize a failing schedule's choice string to the "
            "shortest prefix-subsequence preserving the failure; "
            "implies --sched"
        ),
    )
    parser.add_argument(
        "--sched-seed",
        type=int,
        default=0,
        help="base seed for the --sched sampled-exploration passes",
    )
    args = parser.parse_args(argv)

    if args.races:
        return _run_races(args.races)

    if (
        args.sched
        or args.sched_replay
        or args.sched_shrink
        or os.environ.get("OPENR_SCHED", "") == "1"
    ):
        from . import sched as _sched

        return _sched.run_cli(args)

    if args.list_rules:
        for rule, desc in sorted(ALL_RULES.items()):
            print(f"{rule:28s} {desc}")
        return 0

    targets = [Path(p) for p in args.paths]
    missing = [p for p in targets if not p.exists()]
    if missing:
        print(
            f"error: no such path: {', '.join(map(str, missing))}",
            file=sys.stderr,
        )
        return 2

    try:
        config, root = load_config(targets[0])
        changed = _changed_files(root) if args.changed_only else None
        reporter = run_analysis(targets, config, root)
    except AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    findings = reporter.sorted_findings()
    if changed is not None:
        # counter hygiene is cross-referenced whole-tree, so a serving.*
        # counter finding can anchor to an UNCHANGED file (e.g. a key
        # seeded in serving/ but orphaned by an edit elsewhere) — the
        # serving layer's SLO counters must never be filtered out of a
        # pre-commit pass
        _WHOLE_TREE_RULES = {"lock-order", "guarded-by", "thread-shutdown-order"}
        findings = [
            f
            for f in findings
            if f.rule in _WHOLE_TREE_RULES
            or f.path in changed
            or (f.rule.startswith("counter-") and "serving." in f.message)
        ]

    if args.fmt == "json":
        print(
            json.dumps(
                {
                    "findings": [
                        {
                            "rule": f.rule,
                            "path": f.path,
                            "line": f.line,
                            "col": f.col,
                            "severity": f.severity.value,
                            "message": f.message,
                        }
                        for f in findings
                    ],
                    "suppressed": len(reporter.suppressed),
                },
                indent=2,
            )
        )
    else:
        for f in findings:
            print(f.format())
        if args.show_suppressed:
            for f in sorted(
                reporter.suppressed, key=lambda f: (f.path, f.line, f.col)
            ):
                print(f"(suppressed) {f.format()}")
        n = len(findings)
        print(
            f"{n} finding{'s' if n != 1 else ''} "
            f"({len(reporter.suppressed)} suppressed)"
        )
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
