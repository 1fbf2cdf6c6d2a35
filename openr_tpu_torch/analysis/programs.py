"""Program-level invariant auditor: op-level contracts for every device
root.

Port of `openr_tpu.analysis.programs`.  The AST families can only see
source text; this family — the only one that imports torch — checks what
the device roots actually run:

- it discovers every device root the dispatch checker knows about (the
  public functions of ``device_paths`` with device parameters,
  analysis/dispatch.py);
- it runs a fixed set of deterministic CPU drivers (ring and grid
  fleets, residency-engine queries, rewires, the delta and blocked rungs,
  both kernel wrappers, KSP, protection, direct exercisers, TE, engine
  snapshots) with every root replaced by a recording wrapper, so each
  root's real production arguments are captured without hand-kept spec
  tables;
- the first calls of each root with a new argument spec (shapes, dtypes
  and scalar values; at most ``MAX_SPECS_PER_ROOT``) run under a
  recording dispatch mode that sees every aten op.  Eager PyTorch has no
  trace to replay: the recorded call *is* the program, with the data the
  driver gave it.  Its ops are checked:

  ``program-dtype``     no float64 anywhere, and no floating-point tensor
                        in roots outside ``program_float_allowed`` (the TE
                        soft kernels): the relax pipeline is integer
                        min-plus end to end.
  ``program-callback``  no host sync (``aten._local_scalar_dense``,
                        ``aten.equal``, ``aten.is_nonzero``) and no
                        data-dependent-shape op (``nonzero``,
                        ``masked_select``, ``unique``, a boolean index)
                        outside the root's declared fetch points
                        (`device.sanitizer.fetch_point`): each one is a
                        device->host round trip inside the program.
  ``program-constants`` no tensor made from host data above
                        ``program_const_max_bytes`` inside a root: it is
                        uploaded again on every call instead of living on
                        the device.
  ``program-budget``    the aten op count per root (the largest over its
                        recorded specs) against the checked-in budget
                        file (``openr_tpu_torch/analysis/
                        program_budgets.json``), so op-count blowups fail
                        loudly; regenerate with ``--write-budgets`` after
                        reviewing a growth.  A kernel wrapper's call (K1
                        ``fused_epilogue``, K2 ``blocked_outer``) counts
                        as one op, as a ``pallas_call`` is one primitive
                        in the reference's count; on the CPU the wrapper
                        runs its plain version, whose ops are not counted.
  ``program-donation``  the port's stated replacement for donation: the
                        engine's indexed writes (``_write``), its rewire
                        replay (``_apply_rewire``) and the delta slab's
                        column and row writes (``ops.delta.delta_relax``,
                        ``delta_rows_bitmap``) must leave every resident
                        they write where it was — the same storage, a
                        bumped version counter, and no allocation of its
                        shape and dtype on the way.
  ``program-coverage``  a device root no driver reached — keeps the
                        driver set honest as roots are added.

Every driver runs on the CPU; a driver failure raises
:class:`AnalysisError` so the CLI exits 2 ("broken analyzer"), never
silently shrinking coverage.
"""

from __future__ import annotations

import ast
import functools
import importlib
import json
import sys
import threading
from pathlib import Path
from typing import Any, Callable, Optional

from .core import AnalysisConfig, AnalysisError, Reporter, SourceFile

BUDGET_FILE = "openr_tpu_torch/analysis/program_budgets.json"

#: the engine, whose in-place writers the donation rule audits
ENGINE_FILE = "openr_tpu_torch/device/engine.py"

#: at most this many distinct argument specs are recorded per root
MAX_SPECS_PER_ROOT = 4

#: kernel wrappers: a call counts as one op, its body (the plain version
#: on the CPU) as none
KERNEL_ROOTS = (
    ("openr_tpu_torch.ops.epilogue", "fused_epilogue"),
    ("openr_tpu_torch.ops.blocked_outer", "blocked_outer"),
)

#: roots that write resident tensors in place: (module, name) -> the
#: names of the parameters they write
DONATING_ROOTS = {
    ("openr_tpu_torch.ops.delta", "delta_relax"): ("dist", "bitmap"),
    ("openr_tpu_torch.ops.delta", "delta_rows_bitmap"): ("bitmap",),
}


# ---------------------------------------------------------------------------
# Root discovery (AST, shared with the dispatch family)
# ---------------------------------------------------------------------------


def _root_files(
    files: list[SourceFile], config: AnalysisConfig, root: Path
) -> list[SourceFile]:
    """device_paths as SourceFiles, parsed from the tree regardless of the
    `targets` the caller passed (program rules always audit the whole
    tree)."""
    from .core import walk_python_files

    by_rel = {sf.rel: sf for sf in files}
    out: dict[str, SourceFile] = {}
    for path in walk_python_files([root / p for p in config.device_paths]):
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        sf = by_rel.get(rel) or SourceFile.parse(path, root)
        if sf is not None:
            out[rel] = sf
    return list(out.values())


def _discover_roots(root_files: list[SourceFile], config: AnalysisConfig) -> dict:
    """(module, name) -> FuncRecord of every device root in the root set."""
    from .dispatch import device_roots

    return device_roots(root_files, config)


# ---------------------------------------------------------------------------
# Recording: the dispatch mode and the root wrappers
# ---------------------------------------------------------------------------


class _Tls(threading.local):
    def __init__(self) -> None:
        # active recorders of this thread, outermost first
        self.recorders: list = []
        # depth of kernel-wrapper calls
        self.kernel = 0


_TLS = _Tls()


def _aten_ops():
    import torch

    aten = torch.ops.aten
    syncs = {aten._local_scalar_dense.default, aten.equal.default, aten.is_nonzero.default}
    dynamic = set()
    for name in (
        "nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
        "unique_consecutive", "argwhere",
    ):
        packet = getattr(aten, name, None)
        if packet is not None:
            dynamic |= {getattr(packet, o) for o in packet.overloads()}
    lifts = {aten.lift_fresh.default, aten.lift_fresh_copy.default}
    index = {
        aten.index.Tensor, aten.index_put.default, aten.index_put_.default,
        aten._index_put_impl_.default,
    }
    return syncs, dynamic, lifts, index, aten.repeat_interleave.Tensor


def _tensors(obj, depth: int = 0):
    import torch

    if isinstance(obj, torch.Tensor):
        yield obj
    elif depth < 2 and isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x, depth + 1)
    elif depth < 2 and isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x, depth + 1)


def _make_mode_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..device.sanitizer import fetch_reason, staging_depth

    syncs, dynamic, lifts, index, repeat_interleave = _aten_ops()
    float64 = torch.float64

    class _RecordingMode(TorchDispatchMode):
        """Counts a root's aten ops and collects what the program rules
        check (module doc)."""

        def __init__(self, float_ok: bool, const_limit: int) -> None:
            super().__init__()
            self.float_ok = float_ok
            self.const_limit = const_limit
            self.ops = 0
            self.dtypes: set = set()
            self.callbacks: set = set()
            self.constants: list = []
            self.allocs: list = []
            # open kernel-wrapper calls made inside this root: their
            # bodies are not this root's ops
            self.suspended = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if self.suspended:
                return func(*args, **kwargs)
            self.ops += 1
            declared = fetch_reason() is not None
            if not declared:
                if func in syncs or func in dynamic:
                    self.callbacks.add(str(func))
                elif func in index and any(
                    t.dtype in (torch.bool, torch.uint8) for t in _tensors(args[1])
                ):
                    self.callbacks.add(f"{func} (boolean index)")
                elif func is repeat_interleave and kwargs.get("output_size") is None:
                    self.callbacks.add(str(func))
            out = func(*args, **kwargs)
            for t in (*_tensors((args, kwargs)), *_tensors(out)):
                dt = t.dtype
                if dt == float64 or (dt.is_floating_point and not self.float_ok):
                    self.dtypes.add(str(dt).replace("torch.", ""))
            if isinstance(out, torch.Tensor):
                if func in lifts:
                    nbytes = out.numel() * out.element_size()
                    if nbytes > self.const_limit:
                        self.constants.append(
                            (str(out.dtype).replace("torch.", ""), list(out.shape), nbytes)
                        )
                elif (
                    not staging_depth()
                    and out._base is None
                    and all(out.data_ptr() != t.data_ptr() for t in _tensors(args))
                ):
                    self.allocs.append((tuple(out.shape), out.dtype))
            return out

    return _RecordingMode


def _spec(obj, depth: int = 0):
    """A hashable argument spec: tensors and arrays by shape and dtype,
    scalars by value, containers element-wise, anything else by type."""
    import numpy as np
    import torch

    if isinstance(obj, torch.Tensor):
        return ("t", tuple(obj.shape), str(obj.dtype))
    if isinstance(obj, np.ndarray):
        return ("a", obj.shape, str(obj.dtype))
    if obj is None or isinstance(obj, (bool, int, float, str, np.generic)):
        return obj if not isinstance(obj, np.generic) else obj.item()
    if depth < 3 and isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(_spec(x, depth + 1) for x in obj))
    if depth < 3 and isinstance(obj, dict):
        return ("d", tuple(sorted((k, _spec(v, depth + 1)) for k, v in obj.items())))
    return type(obj).__name__


class _Recorder:
    """Runs the first calls of each root with a new spec under the
    recording mode and keeps what the rules check, per root label."""

    def __init__(self, config: AnalysisConfig) -> None:
        self.config = config
        self.mode_cls = _make_mode_class()
        #: label -> list of per-spec records
        self.records: dict[str, list[dict]] = {}
        #: label -> calls seen (recorded or not)
        self.calls: dict[str, int] = {}
        self._seen: set = set()
        #: donation checks: label -> list of (label, problems) per call
        self.donations: dict[str, list[list[str]]] = {}

    def wrap(self, key: tuple[str, str], orig: Callable) -> Callable:
        label = f"{key[0]}.{key[1]}"
        kernel = key in KERNEL_ROOTS
        float_ok = key[1] in self.config.program_float_allowed
        written = DONATING_ROOTS.get(key)
        rec = self

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            rec.calls[label] = rec.calls.get(label, 0) + 1
            outer = list(_TLS.recorders) if kernel else []
            if kernel:
                if not _TLS.kernel:
                    for mode in outer:
                        mode.ops += 1
                    rec._record_kernel(label, args, kwargs)
                for mode in outer:
                    mode.suspended += 1
                _TLS.kernel += 1
            targets = _bound_targets(orig, written, args, kwargs) if written else ()
            mode = rec._mode_for(label, float_ok, args, kwargs) if not kernel else None
            before = [(t, t.data_ptr(), t._version) for t in targets]
            try:
                if mode is None:
                    out = orig(*args, **kwargs)
                else:
                    _TLS.recorders.append(mode)
                    try:
                        with mode:
                            out = orig(*args, **kwargs)
                    finally:
                        _TLS.recorders.pop()
                    rec.records.setdefault(label, []).append(_summary(mode))
            finally:
                if kernel:
                    _TLS.kernel -= 1
                    for m in outer:
                        m.suspended -= 1
            if written:
                rec.donations.setdefault(label, []).append(
                    _donation_problems(before, mode, out)
                )
            return out

        wrapper.__openr_audit_orig__ = orig
        return wrapper

    def _mode_for(self, label, float_ok, args, kwargs):
        try:
            spec = _spec((args, kwargs))
            hash(spec)
        except TypeError:
            spec = repr(_spec((args, kwargs)))
        if (label, spec) in self._seen:
            return None
        if len(self.records.get(label, ())) >= MAX_SPECS_PER_ROOT:
            return None
        self._seen.add((label, spec))
        return self.mode_cls(float_ok, self.config.program_const_max_bytes)

    def _record_kernel(self, label, args, kwargs) -> None:
        spec = repr(_spec((args, kwargs)))
        if (label, spec) in self._seen or len(self.records.get(label, ())) >= MAX_SPECS_PER_ROOT:
            return
        self._seen.add((label, spec))
        self.records.setdefault(label, []).append(
            {"ops": 1, "dtypes": set(), "callbacks": set(), "constants": []}
        )


def record_program(fn: Callable, *args, float_ok: bool = False,
                   const_limit: int = 4096) -> dict:
    """Run `fn(*args)` once under the recording mode and return what the
    program rules check (the seeded tests' entry)."""
    mode = _make_mode_class()(float_ok, const_limit)
    with mode:
        fn(*args)
    return _summary(mode)


def record_writer(fn: Callable, targets: list, *args) -> list[str]:
    """Run the in-place writer `fn(*args)` once and return its donation
    problems over `targets` (the seeded tests' entry)."""
    mode = _make_mode_class()(True, 1 << 62)
    before = [(t, t.data_ptr(), t._version) for t in targets]
    with mode:
        out = fn(*args)
    return _donation_problems(before, mode, out)


def _summary(mode) -> dict:
    return {
        "ops": mode.ops,
        "dtypes": set(mode.dtypes),
        "callbacks": set(mode.callbacks),
        "constants": list(mode.constants),
    }


def _bound_targets(fn, names, args, kwargs) -> tuple:
    import inspect

    import torch

    bound = inspect.signature(fn).bind_partial(*args, **kwargs)
    return tuple(
        bound.arguments[n]
        for n in names
        if isinstance(bound.arguments.get(n), torch.Tensor)
    )


def _donation_problems(before, mode, out) -> list[str]:
    """What an in-place writer did wrong with the residents it wrote: a
    moved storage, no version bump, an allocation of a resident's shape
    and dtype (a copy of it)."""
    problems = []
    allocs = set(mode.allocs) if mode is not None else set()
    bumped = False
    for t, ptr, version in before:
        if t.data_ptr() != ptr:
            problems.append(f"resident {list(t.shape)} moved its storage")
        bumped |= t._version > version
        if (tuple(t.shape), t.dtype) in allocs:
            problems.append(
                f"allocated a {str(t.dtype).replace('torch.', '')}"
                f"{list(t.shape)} copy of a resident it writes"
            )
    if before and not bumped and not _skipped(out):
        problems.append("wrote no resident in place (no version bump)")
    return problems


def _skipped(out) -> bool:
    """A delta slab whose verdict failed writes nothing, by design."""
    return isinstance(out, tuple) and len(out) == 4 and out[2] is False


def _patch_roots(roots: dict, recorder: _Recorder):
    """Install recording wrappers over every alias of every root across
    the imported openr_tpu_torch modules.  A function-level ``from .x
    import f`` re-resolves per call, but a MODULE-level import binds an
    alias in the importer's namespace — so every module attribute that
    *is* the root object gets patched, not just the defining module's.

    Returns (undo list of (module, attr, original), originals)."""
    undo: list[tuple[Any, str, Any]] = []
    originals: dict[tuple[str, str], Any] = {}
    for mod_name, fn_name in roots:
        try:
            module = importlib.import_module(mod_name)
        except Exception as e:
            raise AnalysisError(
                f"program auditor could not import {mod_name}: {e}"
            ) from e
        orig = getattr(module, fn_name, None)
        if orig is not None and callable(orig):
            originals[(mod_name, fn_name)] = orig
    for key, orig in originals.items():
        wrapper = recorder.wrap(key, orig)
        for mod in list(sys.modules.values()):
            if not getattr(mod, "__name__", "").startswith("openr_tpu_torch"):
                continue
            for attr, val in list(vars(mod).items()):
                if val is orig:
                    undo.append((mod, attr, orig))
                    setattr(mod, attr, wrapper)
    return undo, originals


def _patch_engine_writers(recorder: _Recorder):
    """Donation checks around the engine's in-place writers: `_write`
    (the indexed attribute write) and `_apply_rewire` (the rewire
    replay, every resident array and ELL table it may touch)."""
    from ..device.engine import RESIDENT_ARRAYS, DeviceResidencyEngine

    def resident_tensors(res) -> list:
        out = [getattr(res, n) for n in RESIDENT_ARRAYS]
        out += [t for bk in res.ell.buckets for t in bk]
        return out

    undo = []
    for name, targets_of in (
        ("_write", lambda args: [args[1]]),
        ("_apply_rewire", lambda args: resident_tensors(args[1])),
    ):
        orig = getattr(DeviceResidencyEngine, name)
        label = f"openr_tpu_torch.device.engine.DeviceResidencyEngine.{name}"

        def wrapper(*args, _orig=orig, _label=label, _targets=targets_of):
            mode = recorder.mode_cls(True, 1 << 62)
            before = [(t, t.data_ptr(), t._version) for t in _targets(args)]
            with mode:
                out = _orig(*args)
            recorder.calls[_label] = recorder.calls.get(_label, 0) + 1
            recorder.donations.setdefault(_label, []).append(
                _donation_problems(before, mode, None)
            )
            return out

        undo.append((DeviceResidencyEngine, name, orig))
        setattr(DeviceResidencyEngine, name, wrapper)
    return undo


# ---------------------------------------------------------------------------
# Deterministic drivers
# ---------------------------------------------------------------------------


def _ring_link_state(n: int = 64, metric_fn=None, drop: Optional[dict] = None):
    """n-node circulant ring (d = +-1, +-2): the smallest topology the
    banded rung accepts (n >= 64), so the fleet warm paths actually
    engage (the ELL fallback ignores warm seeds and would hide those
    roots)."""
    from ..decision.link_state import LinkState

    ls = LinkState()
    for i in range(n):
        _update_ring_node(ls, i, n, metric_fn, (drop or {}).get(i))
    return ls


def _update_ring_node(
    ls, i: int, n: int = 64, metric_fn=None, drop=None, overloaded=False
):
    from ..types import Adjacency, AdjacencyDatabase

    metric_fn = metric_fn or (lambda i, j: 20)

    def name(j: int) -> str:
        return f"r{j % n:03d}"

    me = name(i)
    adjs = [
        Adjacency(
            other_node_name=name(i + d),
            if_name=f"{me}/{name(i + d)}",
            other_if_name=f"{name(i + d)}/{me}",
            metric=metric_fn(i, (i + d) % n),
            next_hop_v6=f"fe80::{i}:{d % 7}",
            next_hop_v4=f"10.0.{i}.{d % 7}",
        )
        for d in (1, -1, 2, -2)
        if d != drop
    ]
    ls.update_adjacency_database(
        AdjacencyDatabase(
            this_node_name=me,
            adjacencies=adjs,
            is_overloaded=overloaded,
            node_label=1000 + i,
        )
    )


def _engine():
    from ..device.engine import DeviceResidencyEngine

    return DeviceResidencyEngine("cpu")


def _drive_engine(state: dict) -> None:
    """Residency-engine queries over two S buckets, plus the incremental
    indexed writes: a metric write (int32) and an overload flip (bool)."""
    from ..decision.csr import CsrTopology

    ls = _ring_link_state()
    csr = CsrTopology.from_link_state(ls)
    eng = _engine()
    eng.spf_results(csr, ["r000"])  # S bucket 1
    eng.spf_results(csr, ["r001", "r002", "r003"])  # S bucket 8
    _update_ring_node(ls, 5, metric_fn=lambda i, j: 35)
    assert csr.refresh(ls)
    eng.spf_results(csr, ["r004"])
    _update_ring_node(ls, 7, overloaded=True)
    assert csr.refresh(ls)
    eng.spf_results(csr, ["r006"])
    assert eng.get_counters()["device.engine.incremental_updates"] == 2


def _drive_rewire(state: dict) -> None:
    """Edge-set rewire rung: retire a ring link and re-add it, so the
    engine's slot and ELL-row writes run.  The asserts keep the driver
    honest: a demotion to a restage would leave the rewire writer
    unaudited."""
    from ..decision.csr import CsrTopology

    ls = _ring_link_state()
    csr = CsrTopology.from_link_state(ls)
    engine = _engine()
    engine.spf_results(csr, ["r000"])
    _update_ring_node(ls, 20, drop=1)
    assert csr.refresh(ls), "ring link drop must ride the rewire path"
    engine.spf_results(csr, ["r001"])
    _update_ring_node(ls, 20)
    assert csr.refresh(ls), "ring link re-add must ride the rewire path"
    engine.spf_results(csr, ["r002"])
    c = engine.get_counters()
    assert c["device.engine.full_restages"] == 1, c
    assert c["device.engine.rewires"] == 2, c
    assert c["device.engine.rewire_rows"] > 0, c


def _drive_fleet_ring(state: dict) -> None:
    """Fleet product on the banded ring through the engine (K1's wrapper):
    cold, warm-improve and warm-worsen rebuilds."""
    from ..decision.fleet import FleetViewCache

    dests = ["r000", "r031", "r063"]
    cache = FleetViewCache()
    engine = _engine()
    ls = _ring_link_state()
    v1 = cache.view(ls, dests, engine=engine)
    assert v1 is not None and v1.converged
    _update_ring_node(ls, 5, metric_fn=lambda i, j: 15)
    v2 = cache.view(ls, dests, engine=engine)
    assert v2 is not None and v2.converged and v2.warm_mode == "improve"
    _update_ring_node(ls, 10, drop=1)
    v3 = cache.view(ls, dests, engine=engine)
    assert v3 is not None and v3.converged and v3.warm_mode == "worsen"
    v3.next_hop_neighbors("r007", "r031")
    state["fleet_view"] = v3


def _drive_delta(state: dict) -> None:
    """Incremental delta rung (ops.delta): frontier certification and the
    frontier-sized relax on a metric worsening, then an adjacency drop so
    the changed out-rows re-encode (delta_rows_bitmap) runs too.  The
    asserts keep the driver honest: a silent fallback to the full path
    would leave the delta roots unrecorded."""
    from ..decision.fleet import FleetViewCache

    ls = _ring_link_state()
    dests = [f"r{i:03d}" for i in range(64)]
    engine = _engine()
    cache = FleetViewCache(delta=True)
    v1 = cache.view(ls, dests, engine=engine)
    assert v1 is not None and v1.converged
    _update_ring_node(ls, 5, metric_fn=lambda i, j: 90 if j == 6 else 20)
    v2 = cache.view(ls, dests, engine=engine)
    assert v2 is not None and v2.converged and v2.warm_mode == "delta"
    _update_ring_node(ls, 40, drop=1)
    v3 = cache.view(ls, dests, engine=engine)
    assert v3 is not None and v3.converged and v3.warm_mode == "delta"


def _drive_blocked(state: dict) -> None:
    """Node-axis sharding rung (parallel.blocked) through the fleet view,
    the pipelined lookahead loop and the bulk loop (pinned), so the
    phase roots, K2's wrapper and the extract record specs; the asserts
    keep the driver honest about which loop ran."""
    from ..decision.fleet import FleetViewCache

    ls = _ring_link_state()
    dests = ["r000", "r031", "r063"]
    engine = _engine()
    engine.blocked.node_shard_threshold = 0
    view = FleetViewCache().view(ls, dests, engine=engine)
    assert view is not None and view.converged and view.node_sharded
    c = engine.blocked.counters
    assert c["mesh.blocked.products"] == 1 and c["mesh.blocked.fallbacks"] == 0
    assert c["mesh.blocked.pipeline_prefetch_issues"] > 0

    engine2 = _engine()
    engine2.blocked.node_shard_threshold = 0
    engine2.blocked.pipeline_mode = "0"
    view2 = FleetViewCache().view(ls, dests, engine=engine2)
    assert view2 is not None and view2.converged and view2.node_sharded
    assert engine2.blocked.counters["mesh.blocked.pipeline_prefetch_issues"] == 0


def _drive_kernels(state: dict) -> None:
    """Both kernel wrappers (the reference's Pallas rung): K1
    (`fused_epilogue`) through an engine's fleet product in both variants
    (a uint16 product on the ring's small metrics, an int32 one past the
    uint16 bound) and K2 (`blocked_outer`) through a blocked closure.  The
    asserts keep the driver honest: each wrapper must have been called."""
    from ..decision.fleet import FleetViewCache

    rec = state["recorder"]
    k1 = "openr_tpu_torch.ops.epilogue.fused_epilogue"
    k2 = "openr_tpu_torch.ops.blocked_outer.blocked_outer"
    before = dict(rec.calls)
    dests = ["r000", "r031", "r063"]
    small = FleetViewCache().view(_ring_link_state(), dests, engine=_engine())
    wide = FleetViewCache().view(
        _ring_link_state(metric_fn=lambda i, j: 6000), dests, engine=_engine()
    )
    assert str(small._dist_dev.dtype) == "torch.uint16"
    assert str(wide._dist_dev.dtype) == "torch.int32"
    engine = _engine()
    engine.blocked.node_shard_threshold = 0
    FleetViewCache().view(_ring_link_state(), dests, engine=engine)
    assert rec.calls.get(k1, 0) >= before.get(k1, 0) + 2
    assert rec.calls.get(k2, 0) > before.get(k2, 0)


def _drive_fleet_grid_ell(state: dict) -> None:
    """Fleet product on a grid: no banded structure, so the ELL fallback
    and its fixed-sweep forwards run."""
    from ..decision.fleet import FleetViewCache
    from ..decision.link_state import LinkState
    from ..utils.topo import grid_topology

    ls = LinkState()
    for db in grid_topology(4):
        ls.update_adjacency_database(db)
    nodes = sorted(ls.node_names)
    view = FleetViewCache().view(ls, [nodes[0], nodes[-1]], engine=_engine())
    assert view is not None and view.converged and view._runner.bg is None


def _drive_ksp(state: dict) -> None:
    """2-shortest-paths: the device backend's masked prefetch and the
    fused KSP2 runner, on a 65-ring (the fused runner needs a spare
    padding edge, which the 64-ring's exactly-full edge table lacks)."""
    import numpy as np

    from ..decision.fleet import FleetViewCache
    from ..decision.spf_solver import DeviceSpfBackend
    from ..ops.ksp import FusedKsp2Runner
    from ..ops.protection import build_reverse_edge_ids

    backend = DeviceSpfBackend("cpu")
    backend.prefetch_kth_paths(_ring_link_state(), "r000", ["r005", "r010"])

    view = FleetViewCache().view(_ring_link_state(65), ["r000", "r031"], engine=_engine())
    assert view is not None and view.converged
    csr = view.csr
    e = csr.n_edges
    rev = build_reverse_edge_ids(csr.edge_src[:e], csr.edge_dst[:e])
    fk = FusedKsp2Runner(
        view._runner, csr.edge_dst, e, len(csr.node_names), rev, [csr.edge_metric]
    )
    res = fk.run(
        csr.node_id["r000"],
        np.asarray([csr.node_id["r005"], csr.node_id["r010"]], dtype=np.int32),
    )
    assert len(res) == 1


def _drive_protection(state: dict) -> None:
    """SRLG what-if and TI-LFA reports on the mirror's forward runner."""
    from ..decision.link_state import LinkState
    from ..decision.protection_api import ti_lfa, what_if
    from ..utils.topo import ring_topology

    ls = LinkState()
    for db in ring_topology(4):
        ls.update_adjacency_database(db)
    rows = what_if(ls, [[("r0", "r1")]], device="cpu")
    assert rows and rows[0]["unknown_links"] == []
    report = ti_lfa(ls, "r0", device="cpu")
    assert report["node"] == "r0"


def _drive_forward_direct(state: dict) -> None:
    """Direct exercisers for roots no default dispatch path reaches: the
    dense edge-list relax of the small-graph protection path, the ELL
    forwards (plain and masked), the non-fused bitmap, the ELL and dense
    protection kernels, and the uint16 helpers.  These exercisers ARE the
    audit harness: they call roots directly, on purpose, to put a spec on
    roots no production path reaches."""
    import numpy as np
    import torch

    from ..decision.csr import CsrTopology
    from ..device.sanitizer import stage
    from ..ops import allsources as asrc
    from ..ops import protection as prot
    from ..ops import sssp as ops

    cpu = torch.device("cpu")
    ls = _ring_link_state()
    csr = CsrTopology.from_link_state(ls)
    ell = csr.ell.to(cpu)
    e_src, e_dst, metric, up, ov = (
        stage(a, cpu)
        for a in (csr.edge_src, csr.edge_dst, csr.edge_metric, csr.edge_up,
                  csr.node_overloaded)
    )
    src = stage(np.asarray([csr.node_id["r000"], csr.node_id["r007"]], np.int32), cpu)
    ops.spf_forward_ell(src, ell, e_src, e_dst, metric, up, ov)
    survives = torch.ones((2, metric.shape[0]), dtype=torch.bool)
    ops.spf_forward_ell_masked(src, ell, e_src, e_dst, metric, up, ov, survives)
    allowed = ops.make_relax_allowed(src, e_src, up, ov)
    dist = ops.batched_sssp(
        ops.make_dist0(src, int(ov.shape[0])), e_src, e_dst, metric, allowed
    )
    ops.sp_dag_mask(dist, e_src, e_dst, metric, allowed)
    small = ops.to_u16(torch.clamp(dist, max=ops.INF16))
    ops.u16_dist_to_i32(small)
    ops.clamp_metric_u16(metric)
    # dense and ELL protection kernels (the daemon takes the runner path)
    masks = np.ones((1, csr.edge_capacity), dtype=bool)
    masks[0, 0] = False
    sources = np.asarray([csr.node_id["r000"]], np.int32)
    base = prot.srlg_what_if(
        sources, csr.edge_src, csr.edge_dst, csr.edge_metric, csr.edge_up,
        csr.node_overloaded, np.ones((1, csr.edge_capacity), dtype=bool),
        device=cpu,
    )
    scen = prot.srlg_what_if(
        sources, csr.edge_src, csr.edge_dst, csr.edge_metric, csr.edge_up,
        csr.node_overloaded, masks, ell=ell,
    )
    prot.srlg_reachability_loss(base[0], scen)
    rev = prot.build_reverse_edge_ids(csr.edge_src[: csr.n_edges], csr.edge_dst[: csr.n_edges])
    rev_full = np.full(csr.edge_capacity, -1, np.int32)
    rev_full[: csr.n_edges] = rev
    outs = np.flatnonzero(csr.edge_src[: csr.n_edges] == csr.node_id["r000"]).astype(np.int32)
    prot.ti_lfa_backups(
        int(csr.node_id["r000"]), outs, csr.edge_src, csr.edge_dst,
        csr.edge_metric, csr.edge_up, csr.node_overloaded, rev_full,
        max_degree=len(outs), device=cpu,
    )
    # the blocked rung's phases 1 and 2 on one tile tensor (the rung
    # itself runs them vectorized over every round)
    from ..parallel.blocked import blocked_diag, blocked_panels

    rng = np.random.default_rng(5)
    d = rng.integers(1, 60, size=(1, 64, 64)).astype(np.int32)
    d[rng.random(d.shape) < 0.3] = ops.INF32
    d[0][np.arange(64), np.arange(64)] = 0
    tiles = stage(d.reshape(1, 4, 16, 4, 16), cpu)
    ov_t = stage(np.zeros(64, dtype=bool), cpu)
    blocked_panels(tiles, blocked_diag(tiles, ov_t, 1), ov_t, 1)
    # the non-fused bitmap from a fleet view's reversed distances
    view = state["fleet_view"]
    asrc.ecmp_bitmap_from_reverse_dist(
        view._dist_dev, view._out, view.csr.edge_metric, view.csr.edge_up,
        view.csr.node_overloaded, int(view._bitmap_dev.shape[2]),
    )


def _drive_te(state: dict) -> None:
    """Differentiable-TE soft kernels (the tree's only float roots) and
    one exact-gate round trip through the optimizer front end: soft
    distances must anneal toward the exact solver's, and the rounded
    candidate must score through the integer product."""
    import numpy as np
    import torch

    from ..decision.csr import CsrTopology
    from ..device.sanitizer import stage
    from ..te import TeOptimizer, TeProblem
    from ..te import soft
    from ..te.exact import INF32

    # an 8-node ring with one chord: small, asymmetric, cyclic
    from ..decision.link_state import LinkState
    from ..utils.topo import ring_topology

    ls = LinkState()
    dbs = ring_topology(8)
    for db in dbs:
        ls.update_adjacency_database(db)
    csr = CsrTopology.from_link_state(ls)
    n = csr.n_nodes
    dests = np.asarray([0, 3], dtype=np.int32)
    demand = np.zeros((csr.node_capacity, 2), dtype=np.float32)
    demand[1:n] = 1.0
    demand[3, 1] = 0.0
    problem = TeProblem.from_topology(csr, dests, demand, metric_hi=8)
    cpu = torch.device("cpu")
    args = (
        stage(problem.edge_src, cpu),
        stage(problem.edge_dst, cpu),
        stage(problem.edge_metric, cpu, torch.float32),
        stage(problem.edge_up, cpu),
        stage(problem.node_overloaded, cpu),
        stage(problem.dest_ids, cpu),
    )
    dist = soft.soft_sssp(*args, 0.05, n_sweeps=8).numpy()
    opt = TeOptimizer(device="cpu")
    exact = opt._evaluator(problem).distances(problem.edge_metric)
    finite = exact[:n] < INF32
    assert np.abs(dist[:n][finite] - exact[:n][finite]).max() < 0.5
    res = opt.optimize(problem, steps=2, round_trips=1, n_sweeps=8, flow_sweeps=8)
    assert res.metrics.dtype == np.int32
    soft.soft_objective_value(
        args[2], args[0], args[1], args[3], args[4], args[5],
        stage(problem.demand, cpu, torch.float32),
        stage(problem.capacity, cpu, torch.float32),
        0.1, 0.1, n_sweeps=8, flow_sweeps=8,
    )


def _drive_snapshot(state: dict) -> None:
    """Engine-snapshot restore rungs over the banded ring: take a
    checkpoint, drift the donor mirror (replay rung: the incremental
    writes run under restore), install the serialized artifact into a
    fresh engine over a content-identical fresh mirror (install rung and
    the manifest prewarm), and demote against a drifted foreign mirror
    (cold rung).  The asserts keep the driver honest about each rung."""
    from ..decision.csr import CsrTopology
    from ..snapshot import EngineSnapshot

    ls = _ring_link_state()
    csr = CsrTopology.from_link_state(ls)
    donor = _engine()
    donor.spf_results(csr, ["r000"])
    snap = EngineSnapshot.take(donor, csr)
    blob = snap.to_bytes()
    _update_ring_node(ls, 9, metric_fn=lambda i, j: 31)
    assert csr.refresh(ls), "attribute flap must stay in place"
    assert snap.restore(donor, csr) == "replay"
    donor.spf_results(csr, ["r001"])
    fresh_ls = _ring_link_state()
    _update_ring_node(fresh_ls, 9, metric_fn=lambda i, j: 31)
    fresh_csr = CsrTopology.from_link_state(fresh_ls)
    joiner = _engine()
    warm = EngineSnapshot.take(donor, csr)
    assert warm.restore(joiner, fresh_csr) == "install"
    joiner.spf_results(fresh_csr, ["r002"])
    drifted_ls = _ring_link_state()
    _update_ring_node(drifted_ls, 3, metric_fn=lambda i, j: 29)
    drifted_csr = CsrTopology.from_link_state(drifted_ls)
    cold_eng = _engine()
    assert EngineSnapshot.from_bytes(blob).restore(cold_eng, drifted_csr) == "cold"
    cold_eng.spf_results(drifted_csr, ["r003"])


#: the reference's drivers, less `allsources_legacy`: the port has only
#: the fused product (no `fused=False` two-dispatch path, no progressive
#: early-exit runner), and its one non-fused root, the bitmap of reversed
#: distances, is driven in `forward_direct`
DRIVERS: tuple[tuple[str, Callable[[dict], None]], ...] = (
    ("engine", _drive_engine),
    ("rewire", _drive_rewire),
    ("fleet_ring", _drive_fleet_ring),
    ("delta", _drive_delta),
    ("blocked", _drive_blocked),
    ("kernels", _drive_kernels),
    ("fleet_grid_ell", _drive_fleet_grid_ell),
    ("ksp", _drive_ksp),
    ("protection", _drive_protection),
    ("forward_direct", _drive_forward_direct),
    ("te", _drive_te),
    ("snapshot", _drive_snapshot),
)


def _run_drivers(roots: dict, recorder: _Recorder) -> dict:
    state: dict = {"recorder": recorder}
    undo, originals = _patch_roots(roots, recorder)
    undo += _patch_engine_writers(recorder)
    try:
        for name, driver in DRIVERS:
            try:
                driver(state)
            except Exception as e:
                raise AnalysisError(
                    f"program auditor driver '{name}' failed: "
                    f"{type(e).__name__}: {e}"
                ) from e
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)
    state["originals"] = originals
    return state


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


class _ProgramAudit:
    """Per-program checks; emission goes to the Reporter against a stable
    source location (the root's def line, or the engine writer's)."""

    def __init__(self, reporter: Reporter, config: AnalysisConfig, root: Path) -> None:
        self.reporter = reporter
        self.config = config
        self.root = root
        self.op_counts: dict[str, int] = {}

    def check_record(self, sf, node, label: str, record: dict) -> None:
        for dt in sorted(record["dtypes"]):
            kind = "float64" if dt == "float64" else dt
            self.reporter.emit(
                sf,
                "program-dtype",
                node,
                f"{label}: {kind} tensor inside the root; the relax "
                "pipeline is integer min-plus end to end — chase the "
                "promotion (a true division, a Python float, an np.float64 "
                "array) or list the root in program_float_allowed",
            )
        for op in sorted(record["callbacks"]):
            self.reporter.emit(
                sf,
                "program-callback",
                node,
                f"{label}: {op} outside a declared fetch point — a "
                "device->host round trip inside the program; keep it on the "
                "device or declare it with sanitizer.fetch_point",
            )
        limit = self.config.program_const_max_bytes
        for dtype, shape, nbytes in record["constants"]:
            self.reporter.emit(
                sf,
                "program-constants",
                node,
                f"{label}: host data made a {dtype}{shape} tensor "
                f"({nbytes} bytes > {limit}) inside the root, uploaded again "
                "on every call; stage it once and pass it as an argument",
            )
        if record["ops"] > self.op_counts.get(label, -1):
            self.op_counts[label] = record["ops"]

    def check_donation(self, sf, node, label: str, calls: list) -> None:
        for problem in sorted({p for call in calls for p in call}):
            self.reporter.emit(
                sf,
                "program-donation",
                node,
                f"{label}: {problem}; the port's indexed writes replace the "
                "TPU's donated programs and must write the resident where "
                "it lives",
            )


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def check(
    files: list[SourceFile],
    reporter: Reporter,
    config: AnalysisConfig,
    root: Path,
    write_budgets: bool = False,
) -> dict[str, int]:
    """Run the program auditor; returns the measured op counts (the CLI
    uses them for --write-budgets)."""
    try:
        import torch  # noqa: F401
    except Exception as e:  # pragma: no cover - torch is in the image
        raise AnalysisError(f"program rules need torch to run roots: {e}") from e

    root_files = _root_files(files, config, root)
    roots = _discover_roots(root_files, config)
    if not roots:
        raise AnalysisError(
            f"program auditor found no device roots under device_paths={config.device_paths}"
        )
    engine_sf = SourceFile.parse(root / ENGINE_FILE, root)
    if engine_sf is None:
        raise AnalysisError(f"{ENGINE_FILE} not found for the donation audit")

    recorder = _Recorder(config)
    state = _run_drivers(roots, recorder)
    originals = state["originals"]
    audit = _ProgramAudit(reporter, config, root)

    for key, rec in sorted(roots.items()):
        label = f"{key[0]}.{key[1]}"
        records = recorder.records.get(label)
        if not records:
            if key in originals:
                reporter.emit(
                    rec.sf,
                    "program-coverage",
                    rec.node,
                    f"device root {label} was never reached by the program "
                    "auditor's drivers; add a driver (or an exerciser to "
                    "_drive_forward_direct) in openr_tpu_torch/analysis/programs.py",
                )
            continue
        for record in records:
            audit.check_record(rec.sf, rec.node, label, record)

    # -- donation -------------------------------------------------------------
    for label, calls in sorted(recorder.donations.items()):
        sf, node = _location(label, roots, engine_sf)
        audit.check_donation(sf, node, label, calls)
    writers = {f"{m}.{f}" for m, f in DONATING_ROOTS} | {
        f"openr_tpu_torch.device.engine.DeviceResidencyEngine.{n}"
        for n in ("_write", "_apply_rewire")
    }
    missing = sorted(writers - set(recorder.donations))
    if missing:
        raise AnalysisError(
            f"program auditor's drivers never reached the in-place writers "
            f"{missing}; the donation audit would be vacuous"
        )

    # -- op-count budgets ---------------------------------------------------
    budget_path = root / BUDGET_FILE
    if write_budgets:
        budget_path.write_text(
            json.dumps(dict(sorted(audit.op_counts.items())), indent=2) + "\n",
            encoding="utf-8",
        )
    else:
        budgets = _load_budgets(budget_path)
        for label in sorted(audit.op_counts):
            count = audit.op_counts[label]
            sf, node = _location(label, roots, engine_sf)
            if label not in budgets:
                reporter.emit(
                    sf,
                    "program-budget",
                    node,
                    f"{label}: no op-count budget entry ({count} aten ops "
                    "measured); run `python -m openr_tpu_torch.analysis "
                    "--programs --write-budgets` and commit the updated "
                    "budget file",
                )
            elif count > budgets[label]:
                reporter.emit(
                    sf,
                    "program-budget",
                    node,
                    f"{label}: grew to {count} aten ops (budget "
                    f"{budgets[label]}); if the growth is intentional, "
                    "regenerate with --write-budgets and justify it in the "
                    "change",
                )
    return audit.op_counts


def _load_budgets(path: Path) -> dict[str, int]:
    if not path.is_file():
        return {}
    try:
        data = json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError) as e:
        raise AnalysisError(f"unreadable budget file {path}: {e}") from e
    if not isinstance(data, dict):
        raise AnalysisError(f"budget file {path} must be a JSON object")
    return {str(k): int(v) for k, v in data.items()}


def _location(label: str, roots: dict, engine_sf: SourceFile):
    """(SourceFile, node) of a label: the root's def, or the engine
    writer's def."""
    mod, _, fn = label.rpartition(".")
    rec = roots.get((mod, fn))
    if rec is not None:
        return rec.sf, rec.node
    for node in ast.walk(engine_sf.tree):
        if isinstance(node, ast.FunctionDef) and node.name == fn:
            return engine_sf, node
    return engine_sf, (1, 0)
