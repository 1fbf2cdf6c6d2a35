"""Core machinery of the port's static analyzer.

Port of `openr_tpu.analysis.core`.  Pure stdlib (``ast`` + ``tokenize``):
``python -m openr_tpu_torch.analysis`` runs as a lint step anywhere,
without torch's device stack.  The reference's jaxpr and XLA-program
families (``jit-*``, ``program-*``) audit JAX programs and have no
counterpart here.

The pieces here are shared by both checker families (thread discipline,
counter hygiene):

- :class:`Finding` / :class:`Severity` — one diagnostic, pointing at a
  rule id, file, line and column.
- suppression parsing — ``# openr: disable=<rule>[,<rule>...]`` on the
  flagged line (or on a comment line directly above it, for long lines)
  silences matching findings.  ``# openr: disable=all`` silences every rule
  on that line.
- :class:`AnalysisConfig` — loaded from the port's own
  ``analysis.toml`` beside this module (never from pyproject.toml's
  ``[tool.openr-analysis]``, which names the reference's paths and
  classes).  Python 3.10 has no ``tomllib``, so a minimal parser for the
  small subset it uses (strings, booleans, arrays of strings) backs the
  stdlib import when it is unavailable.
- :class:`SourceFile` / :func:`walk_python_files` — parsed-file cache and
  target discovery.
"""

from __future__ import annotations

import ast
import enum
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Sequence


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value


class AnalysisError(Exception):
    """The analyzer itself could not run (bad config, git failure) —
    distinct from findings, so the CLI can exit 2 ("broken analyzer")
    instead of 1 ("dirty tree")."""


@dataclass(frozen=True)
class Finding:
    """One diagnostic raised by a rule against a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: Severity = Severity.ERROR

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.severity.value}[{self.rule}] {self.message}"
        )


# ---------------------------------------------------------------------------
# Suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*openr:\s*disable=([A-Za-z0-9_\-,\s]+)")


@dataclass
class SuppressionDecl:
    """One ``# openr: disable=`` comment: the declaration line, the rules
    it names, the code lines it covers, and which rules actually matched a
    finding (feeds the suppression-unused rule)."""

    line: int
    rules: frozenset[str]
    covered: set[int] = field(default_factory=set)
    used_rules: set[str] = field(default_factory=set)


@dataclass
class Suppressions:
    """Per-file map of line -> set of suppressed rule ids ('all' wildcard)."""

    by_line: dict[int, set[str]] = field(default_factory=dict)
    #: one record per disable comment, for unused-suppression reporting
    decls: list[SuppressionDecl] = field(default_factory=list)
    #: suppressions that matched a finding, keyed (covered line, rule)
    used: set[tuple[int, str]] = field(default_factory=set)

    def matches(self, line: int, rule: str) -> bool:
        rules = self.by_line.get(line)
        if not rules or (rule not in rules and "all" not in rules):
            return False
        self.used.add((line, rule))
        for decl in self.decls:
            if line in decl.covered and (
                rule in decl.rules or "all" in decl.rules
            ):
                decl.used_rules.add(rule)
        return True


def collect_suppressions(source: str) -> Suppressions:
    """Scan comments for ``# openr: disable=`` markers.

    A marker on a *standalone* comment line applies to the next non-comment
    line as well, so long statements can carry their suppression above them.
    """
    sup = Suppressions()
    pending: set[str] | None = None
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return sup
    # Lines that contain any non-comment code, to tell standalone comment
    # lines apart from trailing comments.
    code_lines: set[int] = set()
    for tok in tokens:
        if tok.type in (
            tokenize.COMMENT,
            tokenize.NL,
            tokenize.NEWLINE,
            tokenize.INDENT,
            tokenize.DEDENT,
            tokenize.ENCODING,
            tokenize.ENDMARKER,
        ):
            continue
        for ln in range(tok.start[0], tok.end[0] + 1):
            code_lines.add(ln)
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        line = tok.start[0]
        covered = {line}
        sup.by_line.setdefault(line, set()).update(rules)
        if line not in code_lines:
            # Standalone comment: also cover the next code line.
            nxt = min((ln for ln in code_lines if ln > line), default=None)
            if nxt is not None:
                sup.by_line.setdefault(nxt, set()).update(rules)
                covered.add(nxt)
        sup.decls.append(
            SuppressionDecl(line=line, rules=frozenset(rules), covered=covered)
        )
    return sup


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

ALL_RULES: dict[str, str] = {
    # thread discipline (openr_tpu_torch/analysis/threads.py)
    "thread-cross-module-write": (
        "attribute write into another module, bypassing queue/ctrl seams"
    ),
    "thread-queue-registration": (
        "ReplicateQueue created in the daemon but absent from the named-queue dict"
    ),
    "lock-order": (
        "lock acquisition order inconsistent across the whole-tree lock "
        "graph (cycle: a deadlock is one unlucky schedule away)"
    ),
    "guarded-by": (
        "attribute written under a lock at one site and bare at another "
        "(the lock protects nothing if any writer skips it)"
    ),
    "thread-shutdown-order": (
        "consumer module stopped before its registered queue is closed "
        "(stop() can wedge on a get() nobody will ever wake)"
    ),
    "blocking-call-in-eventbase": (
        "unbounded blocking call (time.sleep / Future.result / Queue.get "
        "without timeout) reachable from code running on a module's "
        "event-base loop — one such call parks every fiber on the module"
    ),
    # counter hygiene (openr_tpu_torch/analysis/counters.py)
    "counter-name": "counter literal violates the module.name convention",
    "counter-registry": (
        "counter bumped but unreachable from OpenrCtrlHandler._all_counters"
    ),
    "counter-duplicate": "one counter bumped under two spellings",
    "counter-unbumped": (
        "counter pre-seeded in a registry literal but never bumped anywhere"
    ),
    # lint of the lint (openr_tpu_torch/analysis/core.py)
    "suppression-unused": (
        "'# openr: disable=' marker whose rule never fires on that line"
    ),
}

#: the port's configuration file, shipped inside the package
CONFIG_PATH = Path(__file__).with_name("analysis.toml")

_CONFIG_LISTS = (
    "enable",
    "disable",
    "exclude",
    "counter_extra_prefixes",
    "module_attrs",
    "tsan_tracked_paths",
    "lock_order_exclude",
)


@dataclass
class AnalysisConfig:
    """Knobs read from the port's ``analysis.toml``."""

    #: rule ids to run; defaults to every known rule
    enable: list[str] = field(default_factory=lambda: sorted(ALL_RULES))
    #: rule ids to drop from `enable`
    disable: list[str] = field(default_factory=list)
    #: path prefixes (relative to the package root's parent) skipped entirely
    exclude: list[str] = field(default_factory=list)
    #: extra top-level counter prefixes treated as exported (beyond the ones
    #: discovered by parsing OpenrCtrlHandler._all_counters)
    counter_extra_prefixes: list[str] = field(default_factory=list)
    #: attribute names treated as module handles by the thread checker
    module_attrs: list[str] = field(default_factory=list)
    #: dotted class paths the OPENR_TSAN dynamic race detector instruments
    #: (openr_tpu_torch/analysis/race.py); empty means its built-in defaults
    tsan_tracked_paths: list[str] = field(default_factory=list)
    #: `Class.attr` lock-graph nodes excluded from the lock-order rule
    lock_order_exclude: list[str] = field(default_factory=list)

    def active_rules(self) -> set[str]:
        return {r for r in self.enable if r in ALL_RULES} - set(self.disable)

    def is_excluded(self, path: Path, root: Path) -> bool:
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        return any(
            rel == ex.rstrip("/") or rel.startswith(ex.rstrip("/") + "/")
            for ex in self.exclude
        )


def _parse_toml_minimal(text: str) -> dict[str, dict[str, object]]:
    """Parse the tiny TOML subset the analyzer config uses.

    Handles ``[section.headers]``, ``key = "string" | true | false`` and
    (possibly multiline) arrays of strings.  Python 3.10 ships no tomllib;
    this keeps the analyzer dependency-free there.
    """
    out: dict[str, dict[str, object]] = {}
    section: dict[str, object] | None = None
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        raw = lines[i].strip()
        i += 1
        if not raw or raw.startswith("#"):
            continue
        if raw.startswith("[") and raw.endswith("]"):
            name = raw[1:-1].strip().strip('"')
            section = out.setdefault(name, {})
            continue
        if section is None or "=" not in raw:
            continue
        key, _, val = raw.partition("=")
        key = key.strip().strip('"')
        val = val.strip()
        if val.startswith("["):
            # Accumulate until the closing bracket (arrays may span lines).
            buf = val
            while "]" not in buf and i < len(lines):
                buf += " " + lines[i].strip()
                i += 1
            items = re.findall(r'"((?:[^"\\]|\\.)*)"|\'([^\']*)\'', buf)
            section[key] = [a if a else b for a, b in items]
        elif val in ("true", "false"):
            section[key] = val == "true"
        elif re.fullmatch(r"-?\d+", val.split("#")[0].strip()):
            section[key] = int(val.split("#")[0].strip())
        else:
            m = re.match(r'"((?:[^"\\]|\\.)*)"|\'([^\']*)\'', val)
            if m:
                section[key] = m.group(1) if m.group(1) is not None else m.group(2)
    return out


def read_config(path: Path = CONFIG_PATH) -> AnalysisConfig:
    """The ``[analysis]`` table of the port's config file as an
    AnalysisConfig.  A missing or unreadable file is an AnalysisError
    (CLI exit 2), never a silent default."""
    try:
        text = path.read_text(encoding="utf-8")
    except OSError as e:
        raise AnalysisError(f"cannot read analyzer config {path}: {e}") from e
    try:
        import tomllib  # Python 3.11+

        data = tomllib.loads(text)
    except ModuleNotFoundError:
        data = _parse_toml_minimal(text)
    except ValueError as e:
        raise AnalysisError(f"malformed analyzer config {path}: {e}") from e
    raw = data.get("analysis", {})
    cfg = AnalysisConfig()
    if isinstance(raw, dict):
        for key in _CONFIG_LISTS:
            val = raw.get(key)
            if isinstance(val, list):
                setattr(cfg, key, [str(v) for v in val])
    return cfg


def load_config(start: Path) -> tuple[AnalysisConfig, Path]:
    """Return (the port's config, project root).

    The config is always the package's own ``analysis.toml``.  The root,
    which the config's paths and the findings' paths are relative to, is
    the nearest directory at or above `start` that holds the
    ``openr_tpu_torch`` package, else `start` itself.
    """
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    marker = Path("openr_tpu_torch") / "analysis" / CONFIG_PATH.name
    root = next(
        (c for c in [cur, *cur.parents] if (c / marker).is_file()), cur
    )
    return read_config(), root


# ---------------------------------------------------------------------------
# Source files
# ---------------------------------------------------------------------------


@dataclass
class SourceFile:
    """A parsed source file plus its suppression map."""

    path: Path
    rel: str
    source: str
    tree: ast.Module
    suppressions: Suppressions

    @classmethod
    def parse(cls, path: Path, root: Path) -> "SourceFile | None":
        try:
            source = path.read_text(encoding="utf-8")
            tree = ast.parse(source, filename=str(path))
        except (OSError, SyntaxError):
            return None
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        return cls(
            path=path,
            rel=rel,
            source=source,
            tree=tree,
            suppressions=collect_suppressions(source),
        )


def walk_python_files(targets: Sequence[Path]) -> Iterator[Path]:
    seen: set[Path] = set()
    for target in targets:
        if target.is_file() and target.suffix == ".py":
            p = target.resolve()
            if p not in seen:
                seen.add(p)
                yield target
        elif target.is_dir():
            for dirpath, dirnames, filenames in os.walk(target):
                dirnames[:] = [
                    d for d in dirnames if d != "__pycache__" and not d.startswith(".")
                ]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        p = (Path(dirpath) / fn).resolve()
                        if p not in seen:
                            seen.add(p)
                            yield Path(dirpath) / fn


class Reporter:
    """Collects findings, applying per-line suppressions."""

    def __init__(self, config: AnalysisConfig) -> None:
        self.config = config
        self.findings: list[Finding] = []
        self.suppressed: list[Finding] = []
        self._active = config.active_rules()
        self._seen: set[tuple[str, str, int, int, str]] = set()

    def emit(
        self,
        sf: SourceFile,
        rule: str,
        node: ast.AST | tuple[int, int],
        message: str,
        severity: Severity = Severity.ERROR,
    ) -> None:
        if rule not in self._active:
            return
        if isinstance(node, tuple):
            line, col = node
        else:
            line = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
        key = (rule, sf.rel, line, col, message)
        if key in self._seen:
            return
        self._seen.add(key)
        f = Finding(rule, sf.rel, line, col, message, severity)
        if sf.suppressions.matches(line, rule):
            self.suppressed.append(f)
        else:
            self.findings.append(f)

    def sorted_findings(self) -> list[Finding]:
        return sorted(self.findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def run_analysis(
    targets: Sequence[Path],
    config: AnalysisConfig | None = None,
    root: Path | None = None,
) -> Reporter:
    """Run every enabled checker family over `targets`; return the Reporter."""
    if config is None or root is None:
        cfg, found_root = load_config(targets[0] if targets else Path.cwd())
        config = config or cfg
        root = root or found_root

    files: list[SourceFile] = []
    for path in walk_python_files(targets):
        if config.is_excluded(path, root):
            continue
        sf = SourceFile.parse(path, root)
        if sf is not None:
            files.append(sf)

    reporter = Reporter(config)
    active = config.active_rules()
    # Rules whose checker actually executed this run: a suppression for a
    # rule that never ran (the reference's jit-* / program-* families, which
    # have no counterpart here) must not be reported unused.
    executed: set[str] = set()

    thread_rules = {
        "thread-cross-module-write",
        "thread-queue-registration",
        "lock-order",
        "guarded-by",
        "thread-shutdown-order",
        "blocking-call-in-eventbase",
    }
    if active & thread_rules:
        from . import threads

        threads.check(files, reporter, config, root)
        executed |= active & thread_rules
    counter_rules = {
        "counter-name",
        "counter-registry",
        "counter-duplicate",
        "counter-unbumped",
    }
    if active & counter_rules:
        from . import counters

        counters.check(files, reporter, config, root)
        executed |= active & counter_rules

    if "suppression-unused" in active:
        executed.add("suppression-unused")
        _check_unused_suppressions(files, reporter, executed)
    return reporter


def _check_unused_suppressions(
    files: list[SourceFile], reporter: Reporter, executed: set[str]
) -> None:
    """Lint of the lint: report disable markers whose rule was checked on
    this run but never fired on the covered line(s)."""
    for sf in files:
        for decl in sf.suppressions.decls:
            if "all" in decl.rules:
                # wildcard: unused only when nothing at all matched it
                if not decl.used_rules:
                    reporter.emit(
                        sf,
                        "suppression-unused",
                        (decl.line, 0),
                        "'# openr: disable=all' suppresses nothing here; "
                        "remove it (or name the intended rule)",
                    )
                continue
            dead = sorted(
                r
                for r in decl.rules
                if r in executed and r not in decl.used_rules
            )
            for rule in dead:
                reporter.emit(
                    sf,
                    "suppression-unused",
                    (decl.line, 0),
                    f"suppression for '{rule}' is unused: the rule does not "
                    "fire on this line; remove the marker (stale "
                    "suppressions hide future regressions)",
                )
