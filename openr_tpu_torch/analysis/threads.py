"""Thread-discipline checkers.

Port of `openr_tpu.analysis.threads`, rule for rule.

Open/R's module invariant: each module (an ``OpenrEventBase`` subclass)
owns its state on its own thread + asyncio loop; modules communicate only
through ``RWQueue`` / ``ReplicateQueue`` streams or the ctrl handler's
``run_in_event_base_thread`` RPC seam.  Two rules enforce the static part:

- ``thread-cross-module-write``: an attribute *write* whose base is a
  module handle (``self.kvstore.x = ...`` or a local named after a module
  handle) from code outside that module's own class.  Reads are allowed —
  plenty of code inspects counters — but a write from another thread races
  the owner loop.  Composition-root wiring (performed in ``main.py`` before
  the module threads start) is expected to carry an explicit suppression.
- ``thread-queue-registration``: every ``ReplicateQueue``/``RWQueue``
  created on the daemon in ``main.py`` must be registered in the named
  ``self._queues`` dict — that dict is the introspection surface
  (``queue.<name>.*`` counters, drain-on-shutdown, chaos hooks); an
  unregistered queue is invisible to all three.

Three lock-discipline rules back the OPENR_TSAN dynamic detector
(``analysis/race.py``) with whole-tree static evidence:

- ``lock-order``: build the whole-tree lock graph (node = ``Class.attr``
  of a ``self.X = Lock()/RLock()/Condition()`` site; ``Condition(self._y)``
  aliases to ``_y``'s node; edge = inner acquisition while an outer is
  held) and flag every edge that sits on a cycle — an inconsistent
  acquisition order is a deadlock waiting for one unlucky schedule.
  ``lock_order_exclude`` in config drops known-hierarchical nodes.
- ``guarded-by``: within one class, an attribute written under
  ``with self.<lock>`` at one site and bare at another (outside
  ``__init__``) — the lock protects nothing if any writer skips it.
- ``thread-shutdown-order``: in classes carrying the ``self._queues``
  registry, every queue with a consumer (a module constructed with
  ``self.Q.get_reader()``) must be closed in ``stop()`` *before* that
  consumer's ``stop()`` — otherwise shutdown can wedge on a ``get()``
  nobody will ever wake.  Today only convention enforces this ordering.

One liveness rule guards the event-base loops themselves:

- ``blocking-call-in-eventbase``: an unbounded blocking call —
  ``time.sleep``, ``Future.result()`` with no timeout, ``Queue.get()``
  with no timeout — inside code that runs ON a module's event-base
  thread: any ``async def`` body (fiber tasks run on the loop) or any
  callable marshalled via ``run_in_event_base_thread`` /
  ``call_soon_threadsafe`` / ``schedule_timeout``.  Context propagates
  through the intra-file call graph (``self.helper()`` / ``helper()``),
  so a blocking call buried two helpers deep is still flagged.  One such
  call parks the whole loop: every fiber, timer and heartbeat on that
  module stalls until it returns — the watchdog fires on exactly this.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .core import AnalysisConfig, Reporter, SourceFile

_QUEUE_CLASSES = {"ReplicateQueue", "RWQueue"}

#: default module-handle attribute names (overridable via config)
DEFAULT_MODULE_ATTRS = [
    "kvstore",
    "decision",
    "fib",
    "link_monitor",
    "spark",
    "monitor",
    "prefix_manager",
    "ctrl_server",
    "thrift_shim",
    "netlink",
    "watchdog",
    "serving",
    # post-PR-13 serving surface: the coalescing scheduler, the replica
    # front door, and the fleet's replica handles / front-door handler
    "scheduler",
    "router",
    "handler",
    "daemons",
]


def _class_owns_attr(class_name: str, attr: str) -> bool:
    """`KvStore` owns `kvstore`, `LinkMonitor` owns `link_monitor`, ..."""
    snake = "".join(
        ("_" + c.lower()) if c.isupper() else c for c in class_name
    ).lstrip("_")
    return snake == attr or class_name.lower() == attr.replace("_", "")


def check(
    files: list[SourceFile],
    reporter: Reporter,
    config: AnalysisConfig,
    root: Path,
) -> None:
    module_attrs = set(config.module_attrs or DEFAULT_MODULE_ATTRS)
    lock_edges: list[tuple[str, str, SourceFile, ast.AST]] = []
    for sf in files:
        _check_cross_module_writes(sf, reporter, module_attrs)
        # self-gates on the presence of a `self._queues = {...}` registry
        _check_queue_registration(sf, reporter)
        _check_guarded_by(sf, reporter)
        _check_shutdown_order(sf, reporter)
        _check_blocking_in_eventbase(sf, reporter)
        lock_edges.extend(_collect_lock_edges(sf))
    _check_lock_order(lock_edges, reporter, set(config.lock_order_exclude))


def _check_cross_module_writes(
    sf: SourceFile, reporter: Reporter, module_attrs: set[str]
) -> None:
    class_stack: list[str] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, ast.ClassDef):
            class_stack.append(node.name)
            for child in node.body:
                visit(child)
            class_stack.pop()
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            for tgt in targets:
                _check_target(tgt, node)
        for child in ast.iter_child_nodes(node):
            visit(child)

    def _check_target(tgt: ast.AST, stmt: ast.stmt) -> None:
        if not isinstance(tgt, ast.Attribute):
            # `self.kvstore.counters["x"] = 1` has a Subscript target whose
            # value chain still bottoms out in a module handle
            if isinstance(tgt, ast.Subscript):
                _check_target_base(tgt.value, None, stmt)
            return
        _check_target_base(tgt.value, tgt.attr, stmt)

    def _check_target_base(
        base: ast.AST, attr: str | None, stmt: ast.stmt
    ) -> None:
        # Find a module handle anywhere along the base chain, so both
        # `self.kvstore.x = ...` and `self.kvstore.counters["x"] = ...`
        # (a Subscript target) are caught.
        handle: str | None = None
        cur = base
        while isinstance(cur, (ast.Attribute, ast.Subscript)):
            if (
                isinstance(cur, ast.Attribute)
                and isinstance(cur.value, ast.Name)
                and cur.value.id == "self"
                and cur.attr in module_attrs
            ):
                handle = cur.attr
                break
            cur = cur.value
        if handle is None and isinstance(cur, ast.Name) and cur.id in module_attrs:
            handle = cur.id
        if handle is None:
            return
        if class_stack and _class_owns_attr(class_stack[-1], handle):
            return
        what = f".{attr}" if attr else "[...]"
        reporter.emit(
            sf,
            "thread-cross-module-write",
            stmt,
            f"write to `{handle}{what}` crosses a module-thread boundary; "
            "modules own their state — communicate through a queue or "
            "run_in_event_base_thread (pre-start wiring in the composition "
            "root should carry an explicit suppression)",
        )

    visit(sf.tree)


def _check_queue_registration(sf: SourceFile, reporter: Reporter) -> None:
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        created: dict[str, ast.stmt] = {}
        registered: set[str] = set()
        has_registry = False
        for node in ast.walk(cls):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                value = node.value
                if value is None:
                    continue
                for tgt in targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        if _creates_queue(value):
                            created[tgt.attr] = node
                        if tgt.attr == "_queues" and isinstance(value, ast.Dict):
                            has_registry = True
                            for v in value.values:
                                if (
                                    isinstance(v, ast.Attribute)
                                    and isinstance(v.value, ast.Name)
                                    and v.value.id == "self"
                                ):
                                    registered.add(v.attr)
        if not has_registry:
            continue
        for attr, node in sorted(created.items()):
            if attr not in registered:
                reporter.emit(
                    sf,
                    "thread-queue-registration",
                    node,
                    f"queue `self.{attr}` is not registered in the named "
                    "`self._queues` dict; unregistered queues are invisible "
                    "to queue.<name>.* counters, shutdown drain, and chaos "
                    "hooks",
                )


def _creates_queue(value: ast.AST) -> bool:
    """True for `ReplicateQueue(...)` and `injected or ReplicateQueue(...)`."""
    if isinstance(value, ast.BoolOp):
        return any(_creates_queue(v) for v in value.values)
    return (
        isinstance(value, ast.Call)
        and _call_class_name(value) in _QUEUE_CLASSES
    )


def _call_class_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


# ---------------------------------------------------------------------------
# Lock-discipline rules (static companions to the OPENR_TSAN detector)
# ---------------------------------------------------------------------------

_LOCK_CLASSES = {"Lock", "RLock", "Condition"}


def _self_attr(node: ast.AST) -> str | None:
    """`self.X` -> `X`, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _class_lock_attrs(cls: ast.ClassDef) -> dict[str, str]:
    """Lock-holding attrs of a class: {attr: canonical attr}.  A
    ``Condition(self._y)`` shares ``_y``'s underlying lock, so its attr
    aliases to ``_y``'s node in the lock graph."""
    locks: dict[str, str] = {}
    aliases: dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        name = _call_class_name(value)
        if name not in _LOCK_CLASSES:
            continue
        for tgt in node.targets:
            attr = _self_attr(tgt)
            if attr is None:
                continue
            locks[attr] = attr
            if name == "Condition" and value.args:
                inner = _self_attr(value.args[0])
                if inner is not None:
                    aliases[attr] = inner
    for attr, inner in aliases.items():
        if inner in locks:
            locks[attr] = inner
    return locks


def _iter_class_functions(cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _collect_lock_edges(
    sf: SourceFile,
) -> list[tuple[str, str, SourceFile, ast.AST]]:
    """Whole-tree lock-graph edges for one file: (held_node, inner_node,
    file, site) for every acquisition of `inner` while `held` is held.
    Node names are `Class.attr` with Condition aliasing applied."""
    edges: list[tuple[str, str, SourceFile, ast.AST]] = []
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _class_lock_attrs(cls)
        if not locks:
            continue

        def node_name(attr: str) -> str:
            return f"{cls.name}.{locks[attr]}"

        def walk(node: ast.AST, held: list[str]) -> None:
            if isinstance(node, ast.With):
                acquired: list[str] = []
                for item in node.items:
                    ctx = item.context_expr
                    attr = _self_attr(ctx)
                    if attr is not None and attr in locks:
                        # `with self._a, self._b:` acquires _b while _a
                        # is already held — same edge as nesting
                        _edge(attr, node, held + acquired)
                        acquired.append(attr)
                for child in node.body:
                    walk(child, held + acquired)
                return
            if isinstance(node, ast.Call):
                # explicit self.X.acquire() while something is held: edge
                # only (scope of the manual hold is not tracked)
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "acquire":
                    attr = _self_attr(f.value)
                    if attr is not None and attr in locks:
                        _edge(attr, node, held)
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        def _edge(attr: str, site: ast.AST, held: list[str]) -> None:
            inner = node_name(attr)
            for h in held:
                outer = node_name(h)
                if outer != inner:
                    edges.append((outer, inner, sf, site))

        for fn in _iter_class_functions(cls):
            walk(fn, [])
    return edges


def _check_lock_order(
    edges: list[tuple[str, str, SourceFile, ast.AST]],
    reporter: Reporter,
    exclude: set[str],
) -> None:
    edges = [
        (a, b, sf, site)
        for (a, b, sf, site) in edges
        if a not in exclude and b not in exclude
    ]
    adj: dict[str, set[str]] = {}
    for a, b, _sf, _site in edges:
        adj.setdefault(a, set()).add(b)

    def reaches(src: str, dst: str) -> bool:
        seen = {src}
        stack = [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            for nxt in adj.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return False

    reverse_sites: dict[tuple[str, str], tuple[SourceFile, ast.AST]] = {}
    for a, b, sf, site in edges:
        reverse_sites.setdefault((a, b), (sf, site))
    for a, b, sf, site in edges:
        if not reaches(b, a):
            continue
        counter = reverse_sites.get((b, a))
        if counter is not None:
            csf, csite = counter
            where = f"{csf.rel}:{getattr(csite, 'lineno', '?')}"
            detail = f"the reverse order `{b}` -> `{a}` is taken at {where}"
        else:
            detail = (
                f"`{b}` reaches back to `{a}` through the whole-tree lock "
                "graph"
            )
        reporter.emit(
            sf,
            "lock-order",
            site,
            f"lock `{b}` acquired while holding `{a}`, but {detail}; "
            "inconsistent acquisition order deadlocks on the schedule "
            "where both threads hold their first lock",
        )


def _check_guarded_by(sf: SourceFile, reporter: Reporter) -> None:
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = _class_lock_attrs(cls)
        if not locks:
            continue
        # attr -> list of (held_locks_at_write, site)
        writes: dict[str, list[tuple[frozenset[str], ast.AST]]] = {}

        def walk(node: ast.AST, held: frozenset[str]) -> None:
            if isinstance(node, ast.With):
                acquired = set()
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and attr in locks:
                        acquired.add(locks[attr])
                for child in node.body:
                    walk(child, held | acquired)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in targets:
                    # Subscript writes (counters["x"] = 1) mutate through a
                    # stable container reference, not the attribute binding
                    attr = _self_attr(tgt)
                    if attr is not None and attr not in locks:
                        writes.setdefault(attr, []).append((held, node))
            for child in ast.iter_child_nodes(node):
                walk(child, held)

        for fn in _iter_class_functions(cls):
            if fn.name == "__init__":
                continue  # construction happens-before every other thread
            walk(fn, frozenset())

        for attr, sites in sorted(writes.items()):
            guarded = [s for s in sites if s[0]]
            bare = [s for s in sites if not s[0]]
            if not guarded or not bare:
                continue
            glocks = sorted(guarded[0][0])
            gline = getattr(guarded[0][1], "lineno", "?")
            for _held, node in bare:
                reporter.emit(
                    sf,
                    "guarded-by",
                    node,
                    f"`self.{attr}` written bare here but under "
                    f"`{'`/`'.join(glocks)}` at line {gline}; a lock only "
                    "protects state if every writer takes it",
                )


def _check_shutdown_order(sf: SourceFile, reporter: Reporter) -> None:
    """Queues in the `self._queues` registry must close before the modules
    consuming them stop."""
    for cls in ast.walk(sf.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        registered = _registered_queue_attrs(cls)
        if not registered:
            continue
        consumers = _queue_consumers(cls, registered)
        if not consumers:
            continue
        stop_fn = next(
            (f for f in _iter_class_functions(cls) if f.name == "stop"), None
        )
        if stop_fn is None:
            continue
        close_lines, stop_lines = _stop_method_events(cls, stop_fn, registered)
        for module, (queues, _site) in sorted(consumers.items()):
            mod_stop = stop_lines.get(module)
            if mod_stop is None:
                continue
            for q in sorted(queues):
                q_close = close_lines.get(q)
                if q_close is None:
                    reporter.emit(
                        sf,
                        "thread-shutdown-order",
                        (mod_stop, 0),
                        f"`self.{module}.stop()` but its input queue "
                        f"`self.{q}` is never closed in stop(); the "
                        "consumer can wedge on a get() nobody will wake",
                    )
                elif q_close > mod_stop:
                    reporter.emit(
                        sf,
                        "thread-shutdown-order",
                        (mod_stop, 0),
                        f"`self.{module}.stop()` runs before `self.{q}` "
                        f"closes (line {q_close}); close/drain the queue "
                        "first so the consumer's final get() returns",
                    )


def _registered_queue_attrs(cls: ast.ClassDef) -> set[str]:
    registered: set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        value = node.value
        if value is None or not isinstance(value, ast.Dict):
            continue
        for tgt in targets:
            if _self_attr(tgt) == "_queues":
                for v in value.values:
                    attr = _self_attr(v)
                    if attr is not None:
                        registered.add(attr)
    return registered


def _queue_consumers(
    cls: ast.ClassDef, registered: set[str]
) -> dict[str, tuple[set[str], ast.AST]]:
    """Modules constructed with a `self.Q.get_reader()` argument:
    {module_attr: ({queue_attrs}, construction site)}."""
    consumers: dict[str, tuple[set[str], ast.AST]] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if not isinstance(value, ast.Call):
            continue
        queues: set[str] = set()
        for sub in ast.walk(value):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "get_reader"
            ):
                qattr = _self_attr(sub.func.value)
                if qattr is not None and qattr in registered:
                    queues.add(qattr)
        if not queues:
            continue
        for tgt in node.targets:
            mattr = _self_attr(tgt)
            if mattr is not None:
                prev = consumers.get(mattr)
                if prev is not None:
                    prev[0].update(queues)
                else:
                    consumers[mattr] = (queues, node)
    return consumers


def _stop_method_events(
    cls: ast.ClassDef, stop_fn: ast.AST, registered: set[str]
) -> tuple[dict[str, int], dict[str, int]]:
    """(queue close lines, module stop lines) observed in stop().

    Recognizes the close-all loop `for q in self._queues.values():
    q.close()` (closes every registered queue at that line), per-queue
    `self.Q.close()`, direct `self.M.stop()`, and the gather-then-stop
    idiom `modules = [self.A, ...]` + `for m in modules: m.stop()`."""
    close_lines: dict[str, int] = {}
    stop_lines: dict[str, int] = {}
    # Name -> list of self-attrs it holds (list-literal resolution)
    list_vars: dict[str, list[str]] = {}
    for node in ast.walk(stop_fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.List):
            attrs = [
                a
                for a in (_self_attr(el) for el in node.value.elts)
                if a is not None
            ]
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and attrs:
                    list_vars[tgt.id] = attrs
        if isinstance(node, ast.For):
            loop_attrs: list[str] | None = None
            close_all = False
            it = node.iter
            if (
                isinstance(it, ast.Call)
                and isinstance(it.func, ast.Attribute)
                and it.func.attr == "values"
                and _self_attr(it.func.value) == "_queues"
            ):
                close_all = True
            elif isinstance(it, ast.Name) and it.id in list_vars:
                loop_attrs = list_vars[it.id]
            if close_all or loop_attrs is not None:
                var = node.target.id if isinstance(node.target, ast.Name) else None
                for sub in ast.walk(node):
                    if not (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id == var
                    ):
                        continue
                    if close_all and sub.func.attr == "close":
                        for q in registered:
                            close_lines.setdefault(q, node.lineno)
                    if loop_attrs is not None and sub.func.attr == "stop":
                        for m in loop_attrs:
                            stop_lines.setdefault(m, node.lineno)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            owner = _self_attr(node.func.value)
            if owner is None:
                continue
            if node.func.attr == "close" and owner in registered:
                close_lines.setdefault(owner, node.lineno)
            if node.func.attr == "stop":
                stop_lines.setdefault(owner, node.lineno)
    return close_lines, stop_lines


# ---------------------------------------------------------------------------
# blocking-call-in-eventbase: loop-liveness rule
# ---------------------------------------------------------------------------

#: APIs whose callable arguments execute on a module's event-base thread
_MARSHAL_APIS = {
    "run_in_event_base_thread",
    "call_soon_threadsafe",
    "schedule_timeout",
}


def _iter_own_body(fn: ast.AST):
    """Yield nodes of a function body excluding nested def/class bodies
    (those are separate call-graph nodes); lambdas are included — a
    lambda closed over in a reachable body runs in the same context."""
    body = getattr(fn, "body", fn)
    stack = list(body) if isinstance(body, list) else [body]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _local_shadows(fn: ast.AST) -> set[str]:
    """Names a function rebinds locally (parameters, assignments, local
    import aliases): calls through them must NOT resolve to same-named
    defs elsewhere in the file (`from x import what_if as run` would
    otherwise alias the module's `run` method into the call graph)."""
    shadows: set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in list(args.args) + list(args.posonlyargs) + list(args.kwonlyargs):
            shadows.add(a.arg)
        if args.vararg:
            shadows.add(args.vararg.arg)
        if args.kwarg:
            shadows.add(args.kwarg.arg)
    for node in _iter_own_body(fn):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                shadows.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    shadows.add(tgt.id)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                shadows.add(node.target.id)
    return shadows


def _awaited_calls(fn: ast.AST) -> set[int]:
    """ids of Call nodes directly under an `await`: those suspend the
    coroutine instead of blocking the loop (asyncio.Queue.get() vs
    queue.Queue.get())."""
    out: set[int] = set()
    for node in _iter_own_body(fn):
        if isinstance(node, ast.Await) and isinstance(node.value, ast.Call):
            out.add(id(node.value))
    return out


def _timeout_unbounded(call: ast.Call) -> bool:
    """True when the call can block forever: `.result()`, `.get()`,
    `.result(None)`, `.get(timeout=None)`.  A variable timeout is given
    the benefit of the doubt — only literal-None / absent is flagged."""
    if call.args:
        return len(call.args) == 1 and (
            isinstance(call.args[0], ast.Constant) and call.args[0].value is None
        )
    for kw in call.keywords:
        if kw.arg == "timeout":
            return isinstance(kw.value, ast.Constant) and kw.value.value is None
    return True


def _blocking_call(call: ast.Call, sleep_names: set[str]) -> str | None:
    f = call.func
    if isinstance(f, ast.Name) and f.id in sleep_names:
        return "time.sleep()"
    if not isinstance(f, ast.Attribute):
        return None
    if (
        f.attr == "sleep"
        and isinstance(f.value, ast.Name)
        and f.value.id == "time"
    ):
        return "time.sleep()"
    if f.attr == "result" and _timeout_unbounded(call):
        return "Future.result() with no timeout"
    if f.attr == "get" and not call.args and _timeout_unbounded(call):
        # zero-positional-arg .get(): the queue idiom (dict.get takes a
        # key); a bounded .get(timeout=5) passes
        return "Queue.get() with no timeout"
    return None


def _check_blocking_in_eventbase(sf: SourceFile, reporter: Reporter) -> None:
    # `from time import sleep` makes the bare name a blocking call too
    sleep_names: set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "sleep":
                    sleep_names.add(alias.asname or alias.name)

    # every def in the file (any nesting), with its enclosing class
    defs: list[tuple[ast.AST, str | None]] = []

    def collect(node: ast.AST, cls: str | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                collect(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.append((child, cls))
                collect(child, cls)
            else:
                collect(child, cls)

    collect(sf.tree, None)
    by_name: dict[str, list[ast.AST]] = {}
    for fn, _cls in defs:
        by_name.setdefault(fn.name, []).append(fn)

    # roots: async defs (fiber tasks run on the loop) + callables handed
    # to the cross-thread marshal APIs; lambdas handed directly are
    # scanned in place
    reason: dict[int, str] = {}  # id(fn) -> why it runs on the loop
    queue: list[ast.AST] = []
    lambda_roots: list[tuple[ast.Lambda, str]] = []
    for fn, _cls in defs:
        if isinstance(fn, ast.AsyncFunctionDef):
            reason[id(fn)] = f"fiber task `{fn.name}`"
            queue.append(fn)
    for node in ast.walk(sf.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        api = node.func.attr
        if api not in _MARSHAL_APIS:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Lambda):
                lambda_roots.append((arg, api))
                continue
            cb: str | None = None
            if isinstance(arg, ast.Name):
                cb = arg.id
            elif isinstance(arg, ast.Attribute) and _self_attr(arg) is not None:
                cb = arg.attr
            if cb is None:
                continue
            for fn in by_name.get(cb, ()):
                if id(fn) not in reason:
                    reason[id(fn)] = f"callback passed to {api}()"
                    queue.append(fn)

    # propagate through the intra-file call graph: `helper()` and
    # `self.helper()` from a loop-context body put `helper` on the loop
    while queue:
        fn = queue.pop()
        why = reason[id(fn)]
        shadows = _local_shadows(fn)
        for node in _iter_own_body(fn):
            if not isinstance(node, ast.Call):
                continue
            callee: str | None = None
            if isinstance(node.func, ast.Name) and node.func.id not in shadows:
                callee = node.func.id
            elif isinstance(node.func, ast.Attribute) and _self_attr(node.func):
                callee = node.func.attr
            if callee is None:
                continue
            for target in by_name.get(callee, ()):
                if id(target) not in reason:
                    reason[id(target)] = f"`{target.name}` called from {why}"
                    queue.append(target)

    def scan(body_owner: ast.AST, why: str) -> None:
        awaited = _awaited_calls(body_owner)
        for node in _iter_own_body(body_owner):
            if not isinstance(node, ast.Call) or id(node) in awaited:
                continue
            what = _blocking_call(node, sleep_names)
            if what is not None:
                reporter.emit(
                    sf,
                    "blocking-call-in-eventbase",
                    node,
                    f"blocking {what} runs on a module event-base thread "
                    f"({why}); one blocked callback parks the loop — every "
                    "fiber, timer and heartbeat on that module stalls.  "
                    "Use await/aget(), a bounded timeout, or marshal the "
                    "wait onto a worker thread",
                )

    for fn, _cls in defs:
        if id(fn) in reason:
            scan(fn, reason[id(fn)])
    for lam, api in lambda_roots:
        scan(lam, f"lambda passed to {api}()")
