"""Counter-hygiene checkers.

Port of `openr_tpu.analysis.counters`; the registry is discovered from
the port's own `OpenrCtrlHandler._all_counters` (ctrl/server.py).

fb303-style counters only matter if an operator can see them.  The dump
path is ``OpenrCtrlHandler._all_counters`` (ctrl/server.py), which merges
each module's ``get_counters()`` / ``counters`` surface plus the queue
registry.  Three rules keep every bump site on that path:

- ``counter-name``: every counter *literal* bumped anywhere must follow
  the ``module.name`` convention — lowercase ``[a-z0-9_]`` segments, at
  least two, dot-separated — so prefix-based aggregation and the registry
  check below are meaningful.
- ``counter-registry``: the first segment must match a module surface
  consulted by ``_all_counters`` (discovered by parsing that method's own
  AST, so wiring a new module in automatically extends the allowed set),
  or an extra prefix granted in the config's
  ``counter_extra_prefixes``.  A counter that
  fails this is bumped into a dict nothing ever dumps.
- ``counter-duplicate``: no metric may be bumped under two spellings.
  Spellings are compared after normalizing a leading ``num_`` on each
  segment (``queue.x.num_overflows`` vs ``queue.x.overflows`` collide).

- ``counter-unbumped`` (the inverse direction): a counter *pre-seeded* in
  a registry literal — ``self.counters = {"mod.key": 0, ...}`` or the
  ``{k: 0 for k in MODULE_KEYS}`` comprehension over a module-level tuple
  of literals (the ``ENGINE_COUNTER_KEYS`` pattern) — that is never bumped
  anywhere in the analyzed tree.  A seeded-but-dead counter reads as a
  permanent zero on the operator surface, which is worse than absent: it
  asserts "this event never happens" while nothing measures it.  Only
  convention-clean (``module.name``) seeds are checked; bare-keyed mock
  surfaces are out of scope.

Bump sites recognized: ``*. _bump("lit", ...)`` calls and subscript
writes into counters-like dicts (``...counters["lit"] = / +=``).  The
``stats()`` dict literals in ``runtime/queue.py`` are treated as synthetic
``queue.<name>.<key>`` counters, because ``queue_counters`` exports them
verbatim under that prefix.  An ``export_histogram(counters, "<family>",
hist)`` call (obs/histogram.py) is a bump site for each
``<family>.p50_us/.p99_us/.p999_us`` percentile key it emits — the
family argument must be a string LITERAL at the call site so the wire
keys stay statically checkable.
"""

from __future__ import annotations

import ast
import re
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

from .core import AnalysisConfig, Reporter, SourceFile

_NAME_RE = re.compile(r"[a-z][a-z0-9_]*(\.[a-z0-9_]+)+")
_SEGMENT_RE = re.compile(r"[a-z][a-z0-9_]*")


@dataclass(frozen=True)
class BumpSite:
    literal: str
    sf: SourceFile
    node: ast.AST
    #: synthetic sites (queue stats keys) skip the full-name lexical check
    synthetic: bool = False


def check(
    files: list[SourceFile],
    reporter: Reporter,
    config: AnalysisConfig,
    root: Path,
) -> None:
    sites: list[BumpSite] = []
    for sf in files:
        sites.extend(_collect_bumps(sf))
        if sf.rel.endswith("runtime/queue.py") or sf.rel == "queue.py":
            sites.extend(_collect_queue_stats_keys(sf))

    prefixes = _exported_prefixes(files)
    prefixes |= set(config.counter_extra_prefixes)

    well_named: list[BumpSite] = []
    for site in sites:
        if site.synthetic:
            key = site.literal.split(".")[-1]
            if _SEGMENT_RE.fullmatch(key):
                well_named.append(site)
            else:
                reporter.emit(
                    site.sf,
                    "counter-name",
                    site.node,
                    f"queue stats key '{key}' is not a valid counter segment "
                    "(lowercase [a-z0-9_]); it is exported as "
                    f"queue.<name>.{key}",
                )
            continue
        if _NAME_RE.fullmatch(site.literal):
            well_named.append(site)
        else:
            reporter.emit(
                site.sf,
                "counter-name",
                site.node,
                f"counter '{site.literal}' violates the module.name "
                "convention (lowercase dot-separated segments, at least "
                "two: e.g. 'kvstore.sent_publications')",
            )

    # registry reachability — only meaningful if we found (or were given)
    # an export surface to check against
    if prefixes:
        for site in well_named:
            first = site.literal.split(".")[0]
            if first not in prefixes:
                reporter.emit(
                    site.sf,
                    "counter-registry",
                    site.node,
                    f"counter '{site.literal}' has prefix '{first}' which is "
                    "not reachable from OpenrCtrlHandler._all_counters "
                    f"(exported surfaces: {', '.join(sorted(prefixes))}); "
                    "wire the module into the ctrl handler or rename the "
                    "counter onto an exported surface",
                )

    # seeded-but-never-bumped registry keys (inverse hygiene).  Seeds are
    # matched against every bump literal in the analyzed file set, so the
    # check is tree-wide when run over the package.
    bumped_literals = {s.literal for s in sites if not s.synthetic}
    for sf in files:
        for literal, node in _collect_seeds(sf):
            if literal not in bumped_literals:
                reporter.emit(
                    sf,
                    "counter-unbumped",
                    node,
                    f"counter '{literal}' is pre-seeded in a registry but "
                    "never bumped anywhere; it reads as a permanent zero on "
                    "the operator surface — bump it or drop the seed",
                )

    # duplicate spellings
    by_norm: dict[str, dict[str, list[BumpSite]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for site in well_named:
        norm = _normalize(site.literal)
        by_norm[norm][site.literal].append(site)
    for norm, spellings in sorted(by_norm.items()):
        if len(spellings) < 2:
            continue
        names = sorted(spellings)
        for lit, sts in sorted(spellings.items()):
            others = [n for n in names if n != lit]
            for site in sts:
                reporter.emit(
                    site.sf,
                    "counter-duplicate",
                    site.node,
                    f"counter '{lit}' is also bumped as "
                    f"{', '.join(repr(o) for o in others)}; pick one "
                    "canonical spelling",
                )


def _normalize(literal: str) -> str:
    return ".".join(
        seg[4:] if seg.startswith("num_") and len(seg) > 4 else seg
        for seg in literal.split(".")
    )


# ---------------------------------------------------------------------------
# Bump-site collection
# ---------------------------------------------------------------------------


def _collect_bumps(sf: SourceFile) -> list[BumpSite]:
    out: list[BumpSite] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr == "_bump"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                out.append(BumpSite(node.args[0].value, sf, node.args[0]))
                continue
            name = (
                f.id
                if isinstance(f, ast.Name)
                else f.attr
                if isinstance(f, ast.Attribute)
                else None
            )
            if (
                name == "export_histogram"
                and len(node.args) >= 2
                and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)
            ):
                fam = node.args[1].value
                for suffix in ("p50_us", "p99_us", "p999_us"):
                    out.append(BumpSite(f"{fam}.{suffix}", sf, node.args[1]))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                if not isinstance(tgt, ast.Subscript):
                    continue
                if not _is_counters_dict(tgt.value):
                    continue
                sl = tgt.slice
                if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                    out.append(BumpSite(sl.value, sf, sl))
    return out


def _collect_seeds(sf: SourceFile) -> list[tuple[str, ast.AST]]:
    """Registry seeds: convention-clean string keys of dict literals (or of
    ``{k: 0 for k in KEYS}`` comprehensions over module-level literal
    tuples) assigned to counters-like targets."""
    # module-level NAME = ("lit", ...) tuples, for the comprehension form
    mod_tuples: dict[str, list[ast.Constant]] = {}
    for node in sf.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, (ast.Tuple, ast.List))
            and node.value.elts
            and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in node.value.elts
            )
        ):
            mod_tuples[node.targets[0].id] = list(node.value.elts)

    out: list[tuple[str, ast.AST]] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not any(_is_counters_dict(t) for t in targets):
            continue
        if isinstance(value, ast.Dict):
            for k in value.keys:
                if (
                    isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and _NAME_RE.fullmatch(k.value)
                ):
                    out.append((k.value, k))
        elif isinstance(value, ast.DictComp) and value.generators:
            it = value.generators[0].iter
            if isinstance(it, ast.Name) and it.id in mod_tuples:
                for e in mod_tuples[it.id]:
                    if _NAME_RE.fullmatch(e.value):
                        out.append((e.value, e))
    return out


def _is_counters_dict(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Attribute):
        return "counters" in expr.attr
    if isinstance(expr, ast.Name):
        return "counters" in expr.id
    return False


def _collect_queue_stats_keys(sf: SourceFile) -> list[BumpSite]:
    out: list[BumpSite] = []
    for cls in sf.tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for meth in cls.body:
            if (
                isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef))
                and meth.name == "stats"
            ):
                for node in ast.walk(meth):
                    if isinstance(node, ast.Dict):
                        for k in node.keys:
                            if isinstance(k, ast.Constant) and isinstance(
                                k.value, str
                            ):
                                out.append(
                                    BumpSite(
                                        f"queue.x.{k.value}",
                                        sf,
                                        k,
                                        synthetic=True,
                                    )
                                )
    return out


# ---------------------------------------------------------------------------
# Export-surface discovery
# ---------------------------------------------------------------------------


def _exported_prefixes(files: list[SourceFile]) -> set[str]:
    """Parse OpenrCtrlHandler._all_counters for the module surfaces it dumps.

    Every ``self.<attr>`` the method touches is an exported surface; a call
    to ``queue_counters`` exports the ``queue`` prefix.  Counters are then
    required to lead with one of those attrs, so the check self-updates
    when a new module is wired into the handler.
    """
    prefixes: set[str] = set()
    for sf in files:
        for cls in ast.walk(sf.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            for meth in cls.body:
                if (
                    not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef))
                    or meth.name != "_all_counters"
                ):
                    continue
                for node in ast.walk(meth):
                    if (
                        isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "self"
                    ):
                        prefixes.add(node.attr)
                    if isinstance(node, ast.Call):
                        f = node.func
                        name = (
                            f.id
                            if isinstance(f, ast.Name)
                            else f.attr
                            if isinstance(f, ast.Attribute)
                            else None
                        )
                        if name == "queue_counters":
                            prefixes.add("queue")
    return prefixes
