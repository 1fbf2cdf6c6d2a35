"""Dispatch-hygiene checkers: the port's counterpart of the reference's
jit-hygiene rules (`openr_tpu.analysis.jit`).

Eager PyTorch runs every op as it is called: there is no trace, and a
read of a device value on the host waits for the device stream there and
then.  Four rules over the call graphs rooted in the configured
``device_paths`` (the ops/ kernels and wrappers, the fleet dispatch
layer, the blocked rung's phases, the TE kernels):

- ``device-host-sync`` (reference: ``jit-host-sync``): inside a *device*
  context (a device root, or any function it calls with device
  arguments), constructs that read a device value on the host:
  ``float()`` / ``int()`` / ``bool()`` on a device value, ``np.asarray``
  / ``np.array`` / any numpy call on one, ``.item()`` / ``.tolist()`` /
  ``.cpu()`` / ``.numpy()`` / ``.to("cpu")``, and ``print`` of one.
- ``device-tensor-branch`` (reference: ``jit-tracer-branch``): Python
  ``if`` / ``while`` / ``assert`` (and conditional expressions) whose test
  depends on a tensor value — an implicit ``bool()`` and so a sync.
  ``x is None`` / ``x is not None`` checks, ``isinstance`` and the
  metadata reads (``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` /
  ``len()`` / ``.numel()`` ...) are exempt: they never touch the data.
- ``device-dispatch-sync`` (reference: ``jit-dispatch-sync``): in *host*
  code within the same files (classes, and functions no device root
  reaches), the same syncs and branches on values that device roots,
  torch calls, or functions that return either produce.
- ``device-unbucketed-dispatch`` (reference: ``jit-unbucketed-dispatch``):
  daemon modules (analyzed files outside ``device_paths`` and
  ``engine_dispatch_paths``) calling a device root directly.  Dispatch
  belongs behind the device engine (``openr_tpu_torch/device``), which
  keeps the graph resident, stages host data explicitly and accounts
  dispatches and launches; a direct call gets none of that.

A deliberate read is declared, not hidden: `sanitizer.fetch(t, why)`
returns a host copy, and the reads inside ``with
sanitizer.fetch_point(why):`` are sanctioned — the counterparts of the
reference's single ``jax.device_get``.  The same two helpers are what the
runtime guard (`device.sanitizer.EngineSanitizer.transfer_guard`) lets
through, so the static rule and the dynamic guard agree on what a fetch
point is.  A read that stays raw carries ``# openr: disable=<rule>`` and
its reason.

The reference's fifth rule, ``jit-static-hygiene`` (static arguments that
break tracing or defeat the jit cache), has no counterpart: eager
PyTorch has no static arguments and no program cache.

Device roots are the public (not underscore-prefixed) module-level
functions of ``device_paths`` files with at least one device parameter.
A parameter is a device value when its annotation names ``Tensor``, or
when it is unannotated with no default or a ``None`` default; any other
annotation, or a constant default, makes it a host value.  The analysis
is the reference's fixpoint over an interprocedural "device-ness"
propagation: roots seed their device parameters; direct calls (by local
name, ``from x import f`` alias, or module-alias attribute) into other
``device_paths`` files propagate per-parameter flags.  Method calls are
not resolved — the kernels in scope are free functions, which keeps the
checker sound enough without a type system.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from .core import AnalysisConfig, Reporter, Severity, SourceFile

DISPATCH_RULES = frozenset(
    (
        "device-host-sync",
        "device-tensor-branch",
        "device-dispatch-sync",
        "device-unbucketed-dispatch",
    )
)

# Attributes that are host metadata even on device tensors.
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "size", "device", "is_cuda", "layout",
    "nbytes", "itemsize", "numel", "dim", "element_size", "stride",
    "data_ptr", "is_contiguous", "get_device", "storage_offset", "nelement",
    "_version",
}
# Builtins whose result is a host value (and which sync on tensors).
_CONVERSIONS = {"float", "int", "bool", "complex"}
# Builtins that never return device values.
_HOST_BUILTINS = {
    "len", "isinstance", "range", "enumerate", "zip", "max", "min",
    "type", "id", "hasattr", "getattr", "callable", "repr", "str",
}
# numpy entry points that pull device buffers to the host.
_NUMPY_SYNCS = {"numpy.asarray", "numpy.array", "numpy.copy"}
# numpy entry points that read a tensor's metadata only
_NUMPY_META = {"numpy.shape", "numpy.ndim"}
# tensor methods that read the data on the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# torch entry points that read device values on the host and return a
# host value
_TORCH_SYNCS = {"torch.equal", "torch.is_nonzero"}
# torch entry points that return host objects, never device values
_HOST_TORCH = {
    "torch.device", "torch.iinfo", "torch.finfo", "torch.Size",
    "torch.is_tensor", "torch.get_default_dtype", "torch.dtype",
    "torch.Generator", "torch.manual_seed", "torch.no_grad",
    "torch.inference_mode", "torch.from_numpy",
}
_HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.profiler.", "torch.utils.", "torch.ops.")
# the declared fetch points (device/sanitizer.py)
_FETCH = "sanitizer.fetch"
_FETCH_POINT = "sanitizer.fetch_point"


def _in_paths(rel: str, paths: list[str]) -> bool:
    for p in paths:
        p = p.rstrip("/")
        if rel == p or rel.startswith(p + "/"):
            return True
    return False


def _module_name(rel: str) -> str:
    parts = rel[:-3].split("/") if rel.endswith(".py") else rel.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _is_fetch(dotted: str | None) -> bool:
    return dotted is not None and (dotted == "fetch" or dotted.endswith(_FETCH))


def _is_fetch_point(dotted: str | None) -> bool:
    return dotted is not None and (
        dotted == "fetch_point" or dotted.endswith(_FETCH_POINT)
    )


def _torch_call_kind(dotted: str | None) -> str | None:
    """'device' for a torch entry point that returns a device value,
    'host' for one that returns a host object, None for a non-torch
    name."""
    if dotted is None or not (dotted == "torch" or dotted.startswith("torch.")):
        return None
    if (
        dotted in _HOST_TORCH
        or dotted in _TORCH_SYNCS
        or dotted.startswith(_HOST_TORCH_PREFIXES)
    ):
        return "host"
    return "device"


def _device_param(arg: ast.arg, default: ast.AST | None) -> bool:
    """A parameter seeded as a device value (module doc)."""
    if arg.annotation is not None:
        return "Tensor" in ast.unparse(arg.annotation)
    if default is None:
        return True
    return isinstance(default, ast.Constant) and default.value is None


def _param_defaults(node) -> list[tuple[ast.arg, ast.AST | None]]:
    a = node.args
    pos = a.posonlyargs + a.args
    defaults: list = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    return list(zip(pos, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))


@dataclass
class FuncRecord:
    node: ast.FunctionDef | ast.AsyncFunctionDef
    sf: SourceFile
    module: str
    name: str
    params: list[str] = field(default_factory=list)
    #: a device root: public, in device_paths, with device parameters
    is_root: bool = False
    device_params: frozenset = frozenset()
    #: parameters annotated with a non-tensor type
    host_params: frozenset = frozenset()

    @property
    def key(self) -> tuple[str, str]:
        return (self.module, self.name)


@dataclass
class FileIndex:
    sf: SourceFile
    module: str
    #: local name -> ("module", dotted) or ("obj", dotted_module, attr)
    imports: dict[str, tuple] = field(default_factory=dict)
    #: module-level function defs by name
    funcs: dict[str, FuncRecord] = field(default_factory=dict)


class _Index:
    """Cross-file name resolution over the analyzed file set; device roots
    are marked in files under `device_paths`."""

    def __init__(self, files: list[SourceFile], device_paths: list[str]) -> None:
        self.by_module: dict[str, FileIndex] = {}
        self.funcs: dict[tuple[str, str], FuncRecord] = {}
        for sf in files:
            fi = FileIndex(sf=sf, module=_module_name(sf.rel))
            self.by_module[fi.module] = fi
        for fi in self.by_module.values():
            self._index_imports(fi)
            self._index_functions(fi, _in_paths(fi.sf.rel, device_paths))
            for rec in fi.funcs.values():
                self.funcs[rec.key] = rec
        for fi in self.by_module.values():
            self._index_aliases(fi)

    def _index_imports(self, fi: FileIndex) -> None:
        pkg_parts = fi.module.split(".")
        for node in ast.walk(fi.sf.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    dotted = a.name if a.asname else a.name.split(".")[0]
                    fi.imports[local] = ("module", dotted)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg_parts[: len(pkg_parts) - node.level]
                    mod = ".".join(base + (node.module.split(".") if node.module else []))
                else:
                    mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    local = a.asname or a.name
                    if (mod + "." + a.name) in self.by_module or a.name == "numpy":
                        fi.imports[local] = ("module", mod + "." + a.name)
                    else:
                        fi.imports[local] = ("obj", mod, a.name)

    def _index_functions(self, fi: FileIndex, in_device_paths: bool) -> None:
        for node in fi.sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                pd = _param_defaults(node)
                dev = frozenset(a.arg for a, d in pd if _device_param(a, d))
                fi.funcs[node.name] = FuncRecord(
                    node=node,
                    sf=fi.sf,
                    module=fi.module,
                    name=node.name,
                    params=[a.arg for a, _ in pd],
                    is_root=(
                        in_device_paths
                        and not node.name.startswith("_")
                        and bool(dev)
                    ),
                    device_params=dev,
                    host_params=frozenset(
                        a.arg
                        for a, _ in pd
                        if a.annotation is not None
                        and "Tensor" not in ast.unparse(a.annotation)
                    ),
                )

    def _index_aliases(self, fi: FileIndex) -> None:
        """`fast = kernel` / `fast = functools.partial(kernel, ...)` at
        module level: the name resolves to the function it wraps."""
        for node in fi.sf.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            if (
                isinstance(value, ast.Call)
                and self.resolve_dotted(fi, value.func) == "functools.partial"
                and value.args
            ):
                value = value.args[0]
            rec = self.resolve_func(fi, value)
            if rec is None:
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    fi.imports[tgt.id] = ("obj", rec.module, rec.name)

    def resolve_dotted(self, fi: FileIndex, node: ast.AST) -> str | None:
        """Resolve an expression to a dotted path like 'torch.zeros'."""
        if isinstance(node, ast.Name):
            ent = fi.imports.get(node.id)
            if ent is None:
                if node.id in fi.funcs:
                    return fi.module + "." + node.id
                return None
            if ent[0] == "module":
                return ent[1]
            return ent[1] + "." + ent[2]
        if isinstance(node, ast.Attribute):
            base = self.resolve_dotted(fi, node.value)
            if base is None:
                return None
            return base + "." + node.attr
        return None

    def resolve_func(self, fi: FileIndex, node: ast.AST) -> FuncRecord | None:
        dotted = self.resolve_dotted(fi, node)
        if dotted is None:
            return None
        mod, _, name = dotted.rpartition(".")
        return self.funcs.get((mod, name))


def _param_names(node) -> list[str]:
    a = node.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


def _target_names(tgt: ast.AST) -> set[str]:
    return {sub.id for sub in ast.walk(tgt) if isinstance(sub, ast.Name)}


def _is_none_check(node: ast.AST) -> bool:
    """`x is None`, `x is not y`: identity tests never read the data."""
    return isinstance(node, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
    )


def _cpu_target(node: ast.Call) -> bool:
    """`.to("cpu")` / `.to(device="cpu")` / `.to(torch.device("cpu"))`."""
    vals = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
        if (
            isinstance(v, ast.Call)
            and v.args
            and isinstance(v.args[0], ast.Constant)
            and v.args[0].value == "cpu"
        ):
            return True
    return False


class _Walker:
    """Shared walk of one function body with a set of device names: the
    device-context walker (rules device-host-sync / device-tensor-branch)
    and the host-dispatch walker (device-dispatch-sync) differ in what
    makes a value a device value and in the rule they report under."""

    #: rule ids of (sync, branch) findings
    sync_rule = "device-host-sync"
    branch_rule = "device-tensor-branch"
    severity = Severity.ERROR

    def __init__(self, index: _Index, fi: FileIndex, reporter) -> None:
        self.index = index
        self.fi = fi
        self.reporter = reporter
        self.sf = fi.sf
        # depth of `with fetch_point(...)` blocks around the statement
        self.fetching = 0

    # -- classification ---------------------------------------------------
    def dev(self, node: ast.AST, env: set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in env
        if isinstance(node, (ast.Constant, ast.JoinedStr)):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and ("self." + node.attr) in env
            ):
                return True
            return self.dev(node.value, env)
        if isinstance(node, ast.Call):
            return self.call_dev(node, env)
        if isinstance(node, ast.Subscript):
            return self.dev(node.value, env) or self.dev(node.slice, env)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.dev(el, env) for el in node.elts)
        if isinstance(node, ast.Starred):
            return self.dev(node.value, env)
        if isinstance(node, ast.BinOp):
            return self.dev(node.left, env) or self.dev(node.right, env)
        if isinstance(node, ast.UnaryOp):
            return self.dev(node.operand, env)
        if isinstance(node, ast.BoolOp):
            return any(self.dev(v, env) for v in node.values)
        if isinstance(node, ast.Compare):
            if _is_none_check(node):
                return False
            return self.dev(node.left, env) or any(
                self.dev(c, env) for c in node.comparators
            )
        if isinstance(node, ast.IfExp):
            return self.dev(node.body, env) or self.dev(node.orelse, env)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            inner = set(env)
            for gen in node.generators:
                if self.dev(gen.iter, env):
                    inner |= _target_names(gen.target)
            return self.dev(node.elt, inner)
        if isinstance(node, ast.Slice):
            return any(
                self.dev(x, env)
                for x in (node.lower, node.upper, node.step)
                if x is not None
            )
        return False

    def call_dev(self, node: ast.Call, env: set[str]) -> bool:
        if isinstance(node.func, ast.Name):
            if node.func.id in _CONVERSIONS or node.func.id in _HOST_BUILTINS:
                return False
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _SYNC_METHODS or node.func.attr in _STATIC_ATTRS:
                return False
        dotted = self.index.resolve_dotted(self.fi, node.func)
        if _is_fetch(dotted):
            return False
        if dotted is not None and (dotted == "numpy" or dotted.startswith("numpy.")):
            return False
        kind = _torch_call_kind(dotted)
        if kind is not None:
            return kind == "device"
        return self.other_call_dev(node, dotted, env)

    def other_call_dev(self, node: ast.Call, dotted: str | None, env: set[str]) -> bool:
        args_dev = any(self.dev(a, env) for a in node.args) or any(
            self.dev(kw.value, env) for kw in node.keywords
        )
        return args_dev or self.dev(node.func, env)

    def branch_dev(self, node: ast.AST, env: set[str]) -> bool:
        """Device-ness of a branch test, with the metadata exemptions."""
        if _is_none_check(node):
            return False
        if isinstance(node, ast.BoolOp):
            return any(self.branch_dev(v, env) for v in node.values)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            return self.branch_dev(node.operand, env)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            # bool(x)/int(x) in a test is reported as a sync already
            if node.func.id in _CONVERSIONS:
                return False
        return self.dev(node, env)

    # -- emission ---------------------------------------------------------
    def emit(self, rule: str, node: ast.AST, msg: str) -> None:
        if self.fetching:
            return
        self.reporter.emit(self.sf, rule, node, msg, severity=self.severity)

    # -- body walk --------------------------------------------------------
    def walk_body(self, body: list[ast.stmt], env: set[str]) -> None:
        for stmt in body:
            self._stmt(stmt, env)

    def nested_def(self, stmt, env: set[str]) -> None:
        inner = set(env) - set(_param_names(stmt))
        self.walk_body(stmt.body, inner)

    def _stmt(self, stmt: ast.stmt, env: set[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested_def(stmt, env)
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._expr(stmt.value, env)
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            if value is not None:
                self._expr(value, env)
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            if self.fetching:
                flag = False  # read at a declared fetch point: a host value
            elif isinstance(stmt, ast.AugAssign):
                flag = value is not None and (
                    self.dev(value, env) or self.dev(stmt.target, env)
                )
            else:
                flag = value is not None and self.dev(value, env)
            for tgt in targets:
                self._bind(tgt, value, flag, env)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._expr(stmt.test, env)
            if self.branch_dev(stmt.test, env):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                self.emit(
                    self.branch_rule,
                    stmt,
                    f"`{kind}` on a device value "
                    f"({ast.unparse(stmt.test)[:60]}) waits for the device "
                    "stream; keep the decision on the device (torch.where) "
                    "or read it once through sanitizer.fetch",
                )
            self.walk_body(stmt.body, env)
            self.walk_body(stmt.orelse, env)
            return
        if isinstance(stmt, ast.Assert):
            self._expr(stmt.test, env)
            if self.branch_dev(stmt.test, env):
                self.emit(
                    self.branch_rule,
                    stmt,
                    "`assert` on a device value forces a sync; move the "
                    "check to the host or read it through sanitizer.fetch",
                )
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, env)
            if self.dev(stmt.iter, env):
                env |= _target_names(stmt.target)
            self.walk_body(stmt.body, env)
            self.walk_body(stmt.orelse, env)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            fetch_blocks = 0
            for item in stmt.items:
                self._expr(item.context_expr, env)
                if isinstance(item.context_expr, ast.Call) and _is_fetch_point(
                    self.index.resolve_dotted(self.fi, item.context_expr.func)
                ):
                    fetch_blocks += 1
            self.fetching += fetch_blocks
            try:
                self.walk_body(stmt.body, env)
            finally:
                self.fetching -= fetch_blocks
            return
        if isinstance(stmt, ast.Try):
            self.walk_body(stmt.body, env)
            for h in stmt.handlers:
                self.walk_body(h.body, env)
            self.walk_body(stmt.orelse, env)
            self.walk_body(stmt.finalbody, env)
            return
        if isinstance(stmt, ast.Expr):
            self._expr(stmt.value, env)
            return
        if isinstance(stmt, ast.Raise) and stmt.exc is not None:
            self._expr(stmt.exc, env)

    def _bind(self, tgt: ast.AST, value, flag: bool, env: set[str]) -> None:
        if isinstance(tgt, ast.Name):
            if flag:
                env.add(tgt.id)
            else:
                env.discard(tgt.id)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(
                tgt.elts
            ):
                for t, v in zip(tgt.elts, value.elts):
                    self._bind(t, v, self.dev(v, env), env)
            else:
                for t in tgt.elts:
                    self._bind(t, None, flag, env)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, None, flag, env)
        elif (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
            and flag
        ):
            env.add("self." + tgt.attr)

    # -- expression checks ------------------------------------------------
    def _expr(self, node: ast.AST, env: set[str]) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Lambda):
                self._lambda(sub, env)
            elif isinstance(sub, ast.IfExp):
                if self.branch_dev(sub.test, env):
                    self.emit(
                        self.branch_rule,
                        sub,
                        "conditional expression on a device value forces a "
                        "sync; use torch.where",
                    )
            elif isinstance(sub, ast.Call):
                self.check_call(sub, env)

    def _lambda(self, node: ast.Lambda, env: set[str]) -> None:
        inner = set(env) - set(_param_names(node))
        for sub in ast.walk(node.body):
            if isinstance(sub, ast.Call):
                self.check_call(sub, inner)

    def check_call(self, node: ast.Call, env: set[str]) -> bool:
        """Report a sync construct; True when one was reported."""
        args_dev = any(self.dev(a, env) for a in node.args) or any(
            self.dev(kw.value, env) for kw in node.keywords
        )
        if isinstance(node.func, ast.Name):
            fname = node.func.id
            if fname in _CONVERSIONS and args_dev:
                self.emit(
                    self.sync_rule,
                    node,
                    f"{fname}() on a device value reads it on the host and "
                    "waits for the device stream; keep it on the device or "
                    "read it once through sanitizer.fetch",
                )
                return True
            if fname == "print" and args_dev:
                self.emit(
                    self.sync_rule,
                    node,
                    "print of a device value reads it on the host",
                )
                return True
        dotted = self.index.resolve_dotted(self.fi, node.func)
        if dotted in _TORCH_SYNCS and args_dev:
            self.emit(
                self.sync_rule,
                node,
                f"{dotted}() of device values returns a host bool and waits "
                "for the device stream; read it through sanitizer.fetch_point",
            )
            return True
        if dotted is not None and args_dev and dotted not in _NUMPY_META and (
            dotted in _NUMPY_SYNCS or dotted.startswith("numpy.")
        ):
            self.emit(
                self.sync_rule,
                node,
                f"{dotted.replace('numpy', 'np', 1)} on a device value "
                "copies it to the host; read it once through sanitizer.fetch",
            )
            return True
        if isinstance(node.func, ast.Attribute) and self.dev(node.func.value, env):
            attr = node.func.attr
            if attr in _SYNC_METHODS or (attr == "to" and _cpu_target(node)):
                self.emit(
                    self.sync_rule,
                    node,
                    f".{attr}() on a device value reads it on the host and "
                    "waits for the device stream; read it through "
                    "sanitizer.fetch",
                )
                return True
        return False


class _DeviceWalker(_Walker):
    """Walk one device-context body, enqueuing analyzed callees that
    receive device arguments."""

    def __init__(self, index, fi, reporter, enqueue) -> None:
        super().__init__(index, fi, reporter)
        self.enqueue = enqueue

    def nested_def(self, stmt, env: set[str]) -> None:
        # the body is checked with its parameters as device values; calls
        # yield device values when the closure returns one on its own
        closure = set(env) - set(_param_names(stmt))
        if any(
            isinstance(sub, ast.Return)
            and sub.value is not None
            and self.dev(sub.value, closure)
            for sub in ast.walk(stmt)
        ):
            env.add("fn:" + stmt.name)
        self.walk_body(stmt.body, set(env) | set(_param_names(stmt)))

    def other_call_dev(self, node, dotted, env) -> bool:
        if isinstance(node.func, ast.Name) and ("fn:" + node.func.id) in env:
            return True
        return super().other_call_dev(node, dotted, env)

    def check_call(self, node: ast.Call, env: set[str]) -> bool:
        if super().check_call(node, env):
            return True
        rec = self.index.resolve_func(self.fi, node.func)
        if rec is not None:
            dev_params: set[str] = set()
            for i, a in enumerate(node.args):
                if i < len(rec.params) and self.dev(a, env):
                    dev_params.add(rec.params[i])
            for kw in node.keywords:
                if kw.arg in rec.params and self.dev(kw.value, env):
                    dev_params.add(kw.arg)
            dev_params -= rec.host_params
            if dev_params:
                self.enqueue(rec, frozenset(dev_params))
        return False


_RET_DEV: dict[tuple[str, str], bool] = {}


class _DispatchWalker(_Walker):
    """Track device values through host dispatch code: values of device
    roots, torch calls and functions known to return either."""

    sync_rule = "device-dispatch-sync"
    branch_rule = "device-dispatch-sync"
    severity = Severity.WARNING

    def other_call_dev(self, node, dotted, env) -> bool:
        if isinstance(node.func, ast.Name) and ("fn:" + node.func.id) in env:
            return True
        if isinstance(node.func, ast.Attribute) and self.dev(node.func.value, env):
            return True  # a method of a device value
        if dotted is not None:
            mod, _, fname = dotted.rpartition(".")
            rec = self.index.funcs.get((mod, fname))
            if rec is not None and (rec.is_root or _RET_DEV.get(rec.key, False)):
                return True
        return False

    def nested_def(self, stmt, env: set[str]) -> None:
        # a nested dispatch helper: walk its body with the outer env and
        # record whether it returns device values
        inner = set(env) - set(_param_names(stmt))
        self.walk_body(stmt.body, inner)
        if self._returns_dev(stmt, env):
            env.add("fn:" + stmt.name)

    def _returns_dev(self, node, env: set[str]) -> bool:
        inner = set(env)
        return any(
            isinstance(sub, ast.Return)
            and sub.value is not None
            and self.dev(sub.value, inner)
            for sub in ast.walk(node)
        )

    def walk_body_silent(self, body, env: set[str]) -> None:
        saved = self.reporter
        self.reporter = _NullReporter()
        try:
            self.walk_body(body, env)
        finally:
            self.reporter = saved


class _NullReporter:
    def emit(self, *a, **kw) -> None:
        pass


def _compute_ret_dev(index: _Index, scope: list[FileIndex]) -> None:
    """Fixpoint: which host functions return device values."""
    _RET_DEV.clear()
    changed = True
    while changed:
        changed = False
        for fi in scope:
            walker = _DispatchWalker(index, fi, _NullReporter())
            for rec in fi.funcs.values():
                if rec.is_root or _RET_DEV.get(rec.key, False):
                    continue
                env: set[str] = set()
                walker.walk_body_silent(rec.node.body, env)
                for sub in ast.walk(rec.node):
                    if isinstance(sub, ast.Return) and sub.value is not None:
                        if walker.dev(sub.value, env):
                            _RET_DEV[rec.key] = True
                            changed = True
                            break


# ---------------------------------------------------------------------------
# Engine-bypass detection (device-unbucketed-dispatch)
# ---------------------------------------------------------------------------


def _check_unbucketed_dispatch(
    files: list[SourceFile], reporter: Reporter, config: AnalysisConfig
) -> None:
    """Daemon modules must not dispatch device roots directly.

    Every analyzed file outside ``device_paths`` (the kernel/dispatch
    layer) and ``engine_dispatch_paths`` (the device engine and the
    sanctioned front-ends) is daemon code: a direct call to a device root
    there bypasses the engine, so the dispatch misses residency, explicit
    staging and the device.engine.* accounting.  Deliberate low-level call
    sites carry rationale suppressions.
    """
    index = _Index(files, config.device_paths)
    for sf in files:
        if _in_paths(sf.rel, config.device_paths) or _in_paths(
            sf.rel, config.engine_dispatch_paths
        ):
            continue
        fi = index.by_module.get(_module_name(sf.rel))
        if fi is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            rec = index.resolve_func(fi, node.func)
            if rec is None or not rec.is_root:
                continue
            reporter.emit(
                sf,
                "device-unbucketed-dispatch",
                node,
                f"direct dispatch of device root {rec.name}() from a daemon "
                "module; route through the device engine front-end "
                "(DeviceResidencyEngine.spf_results/dispatch) so residency, "
                "staging and accounting apply",
            )


def device_roots(files: list[SourceFile], config: AnalysisConfig) -> dict:
    """(module, name) -> FuncRecord of every device root in `files` (the
    program auditor's root set)."""
    index = _Index(
        [sf for sf in files if _in_paths(sf.rel, config.device_paths)],
        config.device_paths,
    )
    return {rec.key: rec for rec in index.funcs.values() if rec.is_root}


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def check(
    files: list[SourceFile],
    reporter: Reporter,
    config: AnalysisConfig,
    root: Path,
) -> None:
    active = config.active_rules()
    # R4: engine-bypass dispatch scans every analyzed file, so it runs
    # before the scope cut below
    if "device-unbucketed-dispatch" in active:
        _check_unbucketed_dispatch(files, reporter, config)

    scope_files = [sf for sf in files if _in_paths(sf.rel, config.device_paths)]
    if not scope_files:
        return
    index = _Index(scope_files, config.device_paths)
    scope = [index.by_module[_module_name(sf.rel)] for sf in scope_files]

    # R1/R2: device-context fixpoint from the roots
    seen: set[tuple[tuple[str, str], frozenset]] = set()
    queue: list[tuple[FuncRecord, frozenset]] = []

    def enqueue(rec: FuncRecord, dev: frozenset) -> None:
        key = (rec.key, dev)
        if key not in seen and _in_paths(rec.sf.rel, config.device_paths):
            seen.add(key)
            queue.append((rec, dev))

    for fi in scope:
        for rec in fi.funcs.values():
            if rec.is_root:
                enqueue(rec, rec.device_params)
    while queue:
        rec, dev = queue.pop()
        walker = _DeviceWalker(index, index.by_module[rec.module], reporter, enqueue)
        walker.walk_body(rec.node.body, set(dev))

    # R3: host dispatch syncs; a parameter annotated as a tensor holds a
    # device value here too
    device_fn_keys = {k for (k, _d) in seen}
    _compute_ret_dev(index, scope)
    for fi in scope:
        walker = _DispatchWalker(index, fi, reporter)
        for node in fi.sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                rec = fi.funcs.get(node.name)
                if rec is not None and rec.key in device_fn_keys:
                    continue
                walker.walk_body(node.body, _tensor_params(node))
            elif isinstance(node, ast.ClassDef):
                # two passes: first learn which self attrs hold device values
                self_dev: set[str] = set()
                for meth in node.body:
                    if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        env = _tensor_params(meth)
                        walker.walk_body_silent(meth.body, env)
                        self_dev |= {n for n in env if n.startswith("self.")}
                for meth in node.body:
                    if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        walker.walk_body(meth.body, self_dev | _tensor_params(meth))


def _tensor_params(node) -> set[str]:
    """The parameters of `node` annotated as tensors."""
    return {
        a.arg
        for a, _ in _param_defaults(node)
        if a.annotation is not None and "Tensor" in ast.unparse(a.annotation)
    }
