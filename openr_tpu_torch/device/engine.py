"""Device engine: the resolved device, residency and dispatch accounting.

Port of `openr_tpu.device.engine.DeviceResidencyEngine`.  It holds the
device the port computes on and two kinds of work:

- **Per-source SPF** (`spf_results`, the path DeviceSpfBackend serves):
  one `_Resident` per CsrTopology mirror keeps the forward ELL and the
  edge/node arrays on the device.  `sync` brings it to the mirror's
  version on the cheapest rung: attribute changes are written in place
  at the indices whose host shadow differs (`_incremental`), bounded
  edge-set rewires replay the mirror's RewireDelta log (`_rewire_sync`),
  and only a rebuilt mirror (a new `csr.ell` object) restages.  A query
  pads its sources up the S_BUCKETS ladder and runs the fixed-sweep
  forward (ops.sssp.spf_forward_full) at the resident's learned sweep
  hint, doubling it on a False verdict.
- **Fleet work**: it stages a view's reversed runner, owns the blocked
  APSP rung (`blocked`), and counts dispatches and kernel launches, in
  all and per kernel, and the ELL sweeps and affected-set passes.
- **The delta rung** (`delta_bucket`, `delta_register`,
  `delta_dispatch`): the front end of decision.delta's incremental
  fleet updates, with the affected-column bucket ladder, the epoch pin
  and the `device.engine.delta_*` accounting (DELTA_COUNTER_KEYS).

The reference writes attribute and rewire deltas with scatter-free
masked programs padded to power-of-two counts (a TPU scatter leaves the
runtime's fast dispatch path) and caches jit programs per S bucket; here
the deltas are plain indexed writes of the real indices, and there is no
program cache.  Where the reference demotes any rewire failure to a
restage, the port demotes only a gap in the rewire log (a resident that
fell behind the log's window) and an injected `rewire` fault, and lets
every other error propagate.

`counters` holds the fleet path's keys (ENGINE_COUNTER_KEYS) from the
start and each residency key (RESIDENCY_COUNTER_KEYS), masked-batch
key (MASKED_COUNTER_KEYS, `forward`) or delta-rung key
(DELTA_COUNTER_KEYS) once bumped; `get_counters()` lists every family.

The snapshot seams (`export_resident`, `install_resident`,
`cached_program_keys`, `prewarm`) serve `snapshot.EngineSnapshot`.  With
no program cache, the engine records instead the ladder key
`(topo_key, s_bucket, n_words, n_sweeps, small, use_link_metric)` of
every forward run `spf_results` has made (`small` is always False: the
port has one program shape), and `prewarm` runs one discarded forward
per key of a snapshot's manifest on an installed resident, which pays
CUDA's cold costs (lazy module loading, the caching allocator's first
blocks of the [N_cap, S] scratch) before the first query.

With tracing armed (`obs.trace`), every rung tags the spans of the
active scope with `engine.rung`: `spf` for a query on a warm resident,
upgraded by `sync` to `restage`, `rewire` or `incremental` when the
residency moved, and `delta` for a delta-rung program (the blocked
runner tags `blocked`).  `blocked_outer` tags `engine.kernel` with
`outer:cuda` when it launched K2 and `outer:plain` when its tensors lay
on the CPU.

`fault_hook` is the chaos layer's seam (`chaos.ChaosSpfBackend`, the
OCS controller, the fuzzer): a callable of the op name, fired where the
reference fires it — `sync`, `rewire` (top of the rewire replay), `spf`,
`dispatch`'s op, `delta_<op>` — plus `kernel`, fired in `_launch` before
a kernel wrapper is called (the reference's gate is `pallas`, inside its
Pallas-or-XLA chooser).  A hook that raises stops the call: the fault
propagates, and no other path runs in its place.  The one exception is
`rewire`: the hook's own exception there demotes to a restage counted
in `device.engine.rewire_fallbacks`, as a log gap does; it fires before
any slot is written, and any other exception of the replay propagates.
"""

from __future__ import annotations

import logging
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from ..obs import trace as _trace
from ..ops import blocked_outer as _outer
from ..ops import epilogue as _epilogue
from ..ops import sssp as ops
from ..parallel.blocked import BlockedApspEngine
from . import sanitizer as _san

log = logging.getLogger(__name__)

KERNELS = ("fused_epilogue", "blocked_outer")

ENGINE_COUNTER_KEYS = (
    "device.engine.dispatches",
    "device.engine.kernel_launches",
    *(f"device.engine.kernel_launches.{name}" for name in KERNELS),
    # K1's launches per variant (the product's dtype)
    *(
        f"device.engine.kernel_launches.fused_epilogue.{v}"
        for v in ("int32", "uint16")
    ),
    # plain-PyTorch device work that shows which path a view took: ELL
    # relax sweeps (verification sweeps and hint probes included) and
    # affected-set passes of worsening warm starts
    "device.engine.ell_sweeps",
    "device.engine.affected_passes",
    # fleet products whose uint16 run saturated, latched the mode off
    # and ran again in int32
    "device.engine.small_dist_retries",
)

# masked forward-runner batches (KSP2 through `forward`): the batches,
# their rows, and their fixed-sweep runs (attempts and hint probes);
# names of the port's choosing, the reference counts none
MASKED_COUNTER_KEYS = (
    "device.engine.masked_batches",
    "device.engine.masked_rows",
    "device.engine.masked_runs",
)

# the per-source SPF path's residency accounting (reference: engine.py
# ENGINE_COUNTER_KEYS less the jit program cache and the delta rung)
RESIDENCY_COUNTER_KEYS = (
    "device.engine.bytes_staged",
    "device.engine.incremental_updates",
    "device.engine.full_restages",
    "device.engine.queries",
    "device.engine.stage_us",
    "device.engine.dispatch_us",
    "device.engine.epoch_invalidations",
    "device.engine.rewires",
    "device.engine.rewire_dispatches",
    "device.engine.rewire_slots",
    "device.engine.rewire_rows",
    "device.engine.rewire_bytes_staged",
    "device.engine.rewire_us",
    "device.engine.rewire_fallbacks",
)

# the delta rung's accounting (reference: engine.py ENGINE_COUNTER_KEYS)
DELTA_COUNTER_KEYS = (
    "device.engine.delta_dispatches",
    "device.engine.delta_dispatch_us",
    "device.engine.delta_bucket_hits",
    "device.engine.delta_bucket_misses",
    "device.engine.delta_overflow_fallbacks",
)

# forward runs made by `prewarm` (a name of the port's choosing: the
# reference counts the programs it compiles, the port compiles none)
PREWARM_COUNTER_KEYS = ("device.engine.prewarm_runs",)

# the serial order of a resident's edge and node arrays (the reference's
# export_resident names)
RESIDENT_ARRAYS = (
    "edge_src",
    "edge_dst",
    "edge_metric",
    "edge_up",
    "node_overloaded",
    "out_slot",
)

# source-batch padding ladder; above the last rung, next power of two
S_BUCKETS = (1, 8, 64, 512)

# affected-column padding ladder of the delta rung: a frontier of n_cols
# columns runs at the smallest rung >= n_cols
DELTA_P_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """`device`, or the CUDA card when None.  Raises when CUDA is asked
    for (explicitly or by default) and not available: the port never
    drops to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to compute on the CPU"
        )
    return dev


class EpochMismatchError(RuntimeError):
    """The caller pinned a topology epoch (`expect_epoch`) that no longer
    matches the CsrTopology: a change landed between coalescing and
    dispatch, so the caller recomputes instead of serving stale routes."""

    def __init__(self, expected: int, actual: int) -> None:
        super().__init__(
            f"topology epoch moved: expected {expected}, now {actual}"
        )
        self.expected = expected
        self.actual = actual


def _s_bucket(s: int) -> int:
    for b in S_BUCKETS:
        if s <= b:
            return b
    b = S_BUCKETS[-1]
    while b < s:
        b *= 2
    return b


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array (a copy on the CPU too, so the
    resident never aliases the mirror's arrays): the engine's explicit
    staging (sanitizer.stage), the one upload its transfer guard allows."""
    return _san.stage(a, device)


def ell_leaves(ell) -> list:
    """An EllGraph's arrays in the reference's pytree order: each bucket's
    `nbr, w, edge_id, ok, transit_ok` in bucket order, then `new_of_old`,
    `old_of_new` (the snapshot's serial order)."""
    return [a for bk in ell.buckets for a in bk] + [ell.new_of_old, ell.old_of_new]


def _host(t: torch.Tensor, why: str = "resident image") -> np.ndarray:
    """A host copy of a tensor that never aliases it, read at a declared
    fetch point (sanitizer.fetch) named `why`."""
    return _san.fetch(t, why)


@dataclass
class _Resident:
    """Device mirror of one CsrTopology plus host shadows of its three
    mutable attribute arrays.  `ell_host` pins the host ELL object: a new
    object means csr.refresh() rebuilt the mirror and the resident must
    restage."""

    topo_key: tuple  # (node_capacity, edge_capacity)
    ell_host: Any
    version: int
    ell: ops.EllGraph  # tensors
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_metric: torch.Tensor
    edge_up: torch.Tensor
    node_overloaded: torch.Tensor
    out_slot: torch.Tensor
    shadow_metric: np.ndarray = field(repr=False, default=None)
    shadow_up: np.ndarray = field(repr=False, default=None)
    shadow_overloaded: np.ndarray = field(repr=False, default=None)
    sweep_hint: int = 16
    # last CsrTopology.rewire_seq applied; a gap against csr.rewire_seq
    # routes sync() through the rewire rung
    rewire_seq: int = 0


class DeviceResidencyEngine:
    def __init__(self, device: Union[str, torch.device, None] = None) -> None:
        self.device = resolve_device(device)
        self.counters = {k: 0 for k in ENGINE_COUNTER_KEYS}
        # id(csr) -> _Resident (mirrors are long-lived per area)
        self._residents: dict[int, _Resident] = {}
        # per-query attribution: bytes staged and wall time of the last
        # spf_results call
        self.last_query_bytes = 0
        self.last_query_us = 0
        # third dispatch rung (delta < fused full < blocked); it reads
        # this engine's device and launches phase 3 through
        # `blocked_outer` below
        self.blocked = BlockedApspEngine(parent=self)
        # delta bucket keys seen: a first sighting is a miss
        self._delta_buckets_seen: set = set()
        # ladder keys of the forward runs made (spf_results and prewarm),
        # in first-run order: the snapshot manifest's source
        self._program_keys: dict[tuple, None] = {}
        # chaos seam: called with the op name at each gate (module doc)
        self.fault_hook: Optional[Callable[[str], None]] = None

    # -- counters -----------------------------------------------------------

    def get_counters(self) -> dict[str, int]:
        """Every key of the counter families, unbumped ones at 0."""
        return {
            **{
                k: 0
                for k in RESIDENCY_COUNTER_KEYS
                + MASKED_COUNTER_KEYS
                + DELTA_COUNTER_KEYS
                + PREWARM_COUNTER_KEYS
            },
            **self.counters,
        }

    def _bump(self, name: str, delta: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + delta

    # -- fleet work ---------------------------------------------------------

    def stage(self, runner) -> None:
        """Pin a runner's tables and runtime arrays on this device."""
        runner.stage(self.device)

    def stage_forward(self, runner, csr) -> None:
        """Point `csr`'s forward runner at `csr`'s resident, synced first:
        the per-source path and the runner share one device copy of the
        mirror, and the resident's in-place attribute writes reach the
        runner too.  Only a banded runner's band tables are its own."""
        res = self.sync(csr)
        self._bump(
            "device.engine.bytes_staged",
            runner.share(
                res.ell, res.edge_src, res.edge_dst, res.edge_metric,
                res.edge_up, res.node_overloaded,
            ),
        )

    def forward(self, runner, sources, extra_edge_mask=None, **kwargs):
        """`runner.forward` (ops.banded.SpfRunner) of a staged forward
        runner, counted as one dispatch; a batch with `extra_edge_mask`
        also counts as a masked batch of len(sources) rows and the
        fixed-sweep runs it took."""
        runs = runner.masked_runs
        out = self.dispatch(
            "forward", runner.forward, sources,
            extra_edge_mask=extra_edge_mask, **kwargs,
        )
        if extra_edge_mask is not None:
            self._bump("device.engine.masked_batches")
            self._bump("device.engine.masked_rows", len(sources))
            self._bump("device.engine.masked_runs", runner.masked_runs - runs)
        return out

    def dispatch(self, op: str, fn: Callable, *args, **kwargs):
        """Run one unit of device work (`op` names it), count it and time
        it into `device.engine.dispatch_us` (host wall time of the call,
        which includes the device work it waits for).  The fault hook
        sees `op` first."""
        if self.fault_hook is not None:
            self.fault_hook(op)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.counters["device.engine.dispatches"] += 1
            self._bump(
                "device.engine.dispatch_us",
                int((time.perf_counter() - t0) * 1e6),
            )

    def _launch(self, name: str, kernel: Callable, *args):
        """Call a kernel wrapper and count the launches it made.  The
        fault hook's `kernel` gate fires first: an injected fault leaves
        before the wrapper runs, so neither the kernel nor its plain
        version runs in its place."""
        if self.fault_hook is not None:
            self.fault_hook("kernel")
        before = kernel.launches
        out = kernel(*args)
        launched = kernel.launches - before
        self.counters["device.engine.kernel_launches"] += launched
        self.counters[f"device.engine.kernel_launches.{name}"] += launched
        return out

    def epilogue(self, d, idx, w, ov, slot, n_words: int):
        """ops.epilogue.fused_epilogue, counting the kernel launches in
        all and per variant."""
        before = _epilogue.fused_epilogue.launches
        out = self._launch(
            "fused_epilogue",
            _epilogue.fused_epilogue,
            d, idx, w, ov, slot, n_words,
        )
        variant = _epilogue.variant_name(d.dtype)
        self.counters[f"device.engine.kernel_launches.fused_epilogue.{variant}"] += (
            _epilogue.fused_epilogue.launches - before
        )
        return out

    def blocked_outer(self, dist, row_p, col_p, node_overloaded, k: int,
                      lanes=(0, 0)):
        """ops.blocked_outer.blocked_outer, counting the kernel launches
        (one per shard of a sharded tile tensor); armed, the scope's spans
        get `engine.kernel` = `outer:cuda` when K2 launched,
        `outer:plain` when the plain version ran."""
        before = _outer.blocked_outer.launches
        out = self._launch(
            "blocked_outer",
            _outer.blocked_outer,
            dist, row_p, col_p, node_overloaded, k, lanes,
        )
        tr = _trace.TRACE
        if tr is not None:
            flavor = "cuda" if _outer.blocked_outer.launches > before else "plain"
            tr.annotate("engine.kernel", f"outer:{flavor}")
        return out

    # -- delta rung ---------------------------------------------------------

    def delta_bucket(self, n_cols: int, p: int) -> Optional[int]:
        """Padded slab width for an affected frontier of `n_cols` columns
        out of a `p`-wide product, or None when the frontier bound is
        exceeded (the frontier covers more than half the product, or its
        bucket is at least p): the full product is then the cheaper
        program and the caller's fallback."""
        if n_cols <= 0:
            return None
        if 2 * n_cols > p:
            self._bump("device.engine.delta_overflow_fallbacks")
            return None
        for b in DELTA_P_BUCKETS:
            if n_cols <= b:
                if b >= p:
                    self._bump("device.engine.delta_overflow_fallbacks")
                    return None
                return b
        self._bump("device.engine.delta_overflow_fallbacks")
        return None

    def delta_register(self, nbytes: int) -> None:
        """Account the one full product a delta sequence starts from: a
        storm keeps full_restages at 1, everything after it is folded
        into that product."""
        self._bump("device.engine.full_restages")
        self._bump("device.engine.bytes_staged", int(nbytes))

    def delta_dispatch(
        self,
        op: str,
        fn: Callable,
        *args,
        csr=None,
        expect_epoch: Optional[int] = None,
        bucket_key: Optional[tuple] = None,
        **kwargs,
    ):
        """Run one program of the delta rung (`op` names it): the epoch pin
        (`expect_epoch` against `csr.version`) is checked before any
        device work and raises EpochMismatchError; `bucket_key` names the
        slab's shape cell, a first sighting counted as a miss and a
        repeat as a hit; the call is counted and timed, a raising call
        included, and armed it tags the scope `engine.rung` = `delta`.
        The fault hook sees `delta_<op>` first."""
        if self.fault_hook is not None:
            self.fault_hook("delta_" + op)
        if (
            expect_epoch is not None
            and csr is not None
            and int(csr.version) != int(expect_epoch)
        ):
            self._bump("device.engine.epoch_invalidations")
            raise EpochMismatchError(int(expect_epoch), int(csr.version))
        if bucket_key is not None:
            if bucket_key in self._delta_buckets_seen:
                self._bump("device.engine.delta_bucket_hits")
            else:
                self._delta_buckets_seen.add(bucket_key)
                self._bump("device.engine.delta_bucket_misses")
        tr = _trace.TRACE
        if tr is not None:
            tr.annotate("engine.rung", "delta")
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self._bump("device.engine.delta_dispatches")
            self._bump(
                "device.engine.delta_dispatch_us",
                int((time.perf_counter() - t0) * 1e6),
            )

    # -- residency ----------------------------------------------------------

    def has_residency(self, csr) -> bool:
        """True when `csr`'s graph is resident (attribute drift is fine:
        the next sync applies it incrementally)."""
        res = self._residents.get(id(csr))
        return res is not None and res.ell_host is csr.ell

    def is_warm(self, csr) -> bool:
        """True when `csr`'s graph is resident and current."""
        res = self._residents.get(id(csr))
        return (
            res is not None
            and res.ell_host is csr.ell
            and res.version == csr.version
        )

    def sync(self, csr) -> _Resident:
        """Bring `csr`'s residency to csr.version: a restage only when the
        ELL object changed (a rebuild) or the rewire log has a gap; the
        rewire rung for pending RewireDeltas; the incremental rung for
        attribute changes.  The fault hook sees `sync` first."""
        if self.fault_hook is not None:
            self.fault_hook("sync")
        t0 = time.perf_counter()
        res = self._residents.get(id(csr))
        if res is None or res.ell_host is not csr.ell:
            res = self._restage(csr)
        else:
            if csr.rewire_seq != res.rewire_seq:
                if self._rewire_sync(res, csr):
                    tr = _trace.TRACE
                    if tr is not None:
                        tr.annotate("engine.rung", "rewire")
                else:
                    self._bump("device.engine.rewire_fallbacks")
                    res = self._restage(csr)
            if res.version != csr.version:
                self._incremental(res, csr)
                tr = _trace.TRACE
                if tr is not None:
                    tr.annotate("engine.rung", "incremental")
        self._bump(
            "device.engine.stage_us", int((time.perf_counter() - t0) * 1e6)
        )
        return res

    def _restage(self, csr) -> _Resident:
        tr = _trace.TRACE
        if tr is not None:
            tr.annotate("engine.rung", "restage")
        dev = self.device
        host = {name: getattr(csr, name) for name in RESIDENT_ARRAYS}
        ell = csr.ell.to(dev)
        leaves = ell_leaves(csr.ell)
        res = _Resident(
            topo_key=(csr.node_capacity, csr.edge_capacity),
            ell_host=csr.ell,
            version=csr.version,
            ell=ell,
            **{name: _put(a, dev) for name, a in host.items()},
            shadow_metric=csr.edge_metric.copy(),
            shadow_up=csr.edge_up.copy(),
            shadow_overloaded=csr.node_overloaded.copy(),
            sweep_hint=csr._sweep_hint,
            rewire_seq=csr.rewire_seq,
        )
        self._adopt(csr, res)
        self._bump("device.engine.full_restages")
        self._bump(
            "device.engine.bytes_staged",
            sum(a.nbytes for a in host.values()) + sum(a.nbytes for a in leaves),
        )
        return res

    def _adopt(self, csr, res: _Resident) -> None:
        """Make `res` the resident of `csr`; a retired mirror frees its
        resident with it (residents key on id(csr), which a later mirror
        may reuse)."""
        if id(csr) not in self._residents:
            weakref.finalize(csr, self._residents.pop, id(csr), None)
        self._residents[id(csr)] = res

    def _write(self, target: torch.Tensor, idx: np.ndarray, vals: np.ndarray) -> int:
        """target[idx] = vals on the device (rows when `vals` is 2-D);
        returns the bytes uploaded."""
        i = _put(idx.astype(np.int64), self.device)
        target[i] = _put(vals, self.device)
        return i.nbytes + vals.nbytes

    def _incremental(self, res: _Resident, csr) -> None:
        """Write the attribute entries whose host shadow differs from the
        mirror — O(changed entries) uploaded, never the graph."""
        staged = 0
        for target, shadow, host in (
            (res.edge_metric, res.shadow_metric, csr.edge_metric),
            (res.edge_up, res.shadow_up, csr.edge_up),
            (res.node_overloaded, res.shadow_overloaded, csr.node_overloaded),
        ):
            changed = np.flatnonzero(shadow != host)
            if changed.size:
                staged += self._write(target, changed, host[changed])
                shadow[changed] = host[changed]
        res.version = csr.version
        self._bump("device.engine.incremental_updates")
        self._bump("device.engine.bytes_staged", staged)

    def _rewire_sync(self, res: _Resident, csr) -> bool:
        """Replay the pending tail of csr's rewire log: slot writes for
        the rewritten edge slots and row writes for every re-encoded ELL
        row, O(touched slots + rows) uploaded.  Returns False, touching
        nothing, when the log no longer holds a contiguous chain from the
        resident's position, or when the fault hook raises at `rewire`
        (the caller restages); the hook fires before anything is
        written, and only its own exception demotes."""
        t0 = time.perf_counter()
        if self.fault_hook is not None:
            try:
                self.fault_hook("rewire")
            except Exception:
                log.warning("rewire fault injected: demoting to a restage",
                            exc_info=True)
                return False
        pending = [d for d in csr._rewire_log if d.seq > res.rewire_seq]
        if (
            not pending
            or pending[0].seq != res.rewire_seq + 1
            or pending[-1].seq != csr.rewire_seq
            or any(b.seq != a.seq + 1 for a, b in zip(pending, pending[1:]))
        ):
            return False
        staged = n_slots = n_rows = 0
        for delta in pending:
            staged += self._apply_rewire(res, delta)
            n_slots += len(delta.slots)
            n_rows += len(delta.ell_rows)
            self._bump("device.engine.rewires")
        res.rewire_seq = csr.rewire_seq
        # the touched slots are current in the shadows; when nothing else
        # drifted, the resident is at csr.version and the attribute rung
        # is skipped
        if (
            np.array_equal(res.shadow_metric, csr.edge_metric)
            and np.array_equal(res.shadow_up, csr.edge_up)
            and np.array_equal(res.shadow_overloaded, csr.node_overloaded)
        ):
            res.version = csr.version
        self._bump("device.engine.rewire_dispatches")
        self._bump("device.engine.rewire_slots", n_slots)
        self._bump("device.engine.rewire_rows", n_rows)
        self._bump("device.engine.rewire_bytes_staged", staged)
        self._bump("device.engine.bytes_staged", staged)
        self._bump(
            "device.engine.rewire_us", int((time.perf_counter() - t0) * 1e6)
        )
        return True

    def _apply_rewire(self, res: _Resident, delta) -> int:
        """Apply one RewireDelta to the resident; returns bytes uploaded."""
        staged = 0
        for target, idx, vals, shadow in (
            (res.edge_src, delta.slots, delta.src, None),
            (res.edge_dst, delta.slots, delta.dst, None),
            (res.edge_metric, delta.slots, delta.metric, res.shadow_metric),
            (res.edge_up, delta.slots, delta.up, res.shadow_up),
            (res.out_slot, delta.out_idx, delta.out_val, None),
        ):
            if len(idx):
                staged += self._write(target, idx, vals)
                if shadow is not None:
                    shadow[idx] = vals
        by_bucket: dict[int, list] = {}
        for row in delta.ell_rows:
            by_bucket.setdefault(row[0], []).append(row)
        for b_idx, rows in by_bucket.items():
            bkt = res.ell.buckets[b_idx]
            row_idx = np.asarray([r[1] for r in rows], dtype=np.int64)
            for f, target in enumerate(bkt):
                staged += self._write(
                    target, row_idx, np.stack([r[2 + f] for r in rows])
                )
        return staged

    def drop(self, csr) -> None:
        """Forget `csr`'s residency (mirror retired)."""
        self._residents.pop(id(csr), None)

    # -- snapshot seams (snapshot.EngineSnapshot) ---------------------------

    def export_resident(self, csr) -> dict:
        """Host image of `csr`'s residency for EngineSnapshot.take: synced
        first (the checkpoint is at the mirror's current version), then
        one host copy per surface (a copy on the CPU too, so the image
        never aliases the resident), the ELL's in `ell_leaves` order."""
        res = self.sync(csr)
        return {
            "topo_key": res.topo_key,
            "version": res.version,
            "rewire_seq": res.rewire_seq,
            "sweep_hint": res.sweep_hint,
            "arrays": {
                name: _host(getattr(res, name)) for name in RESIDENT_ARRAYS
            },
            "ell_leaves": [_host(t) for t in ell_leaves(res.ell)],
        }

    def install_resident(
        self,
        csr,
        state: dict,
        *,
        version: Optional[int] = None,
        rewire_seq: Optional[int] = None,
    ) -> _Resident:
        """Install a host image (export_resident's shape) as `csr`'s
        residency: host to device copies, the shadows taken from the
        image, so a following sync() reconciles any drift between the
        image and `csr` on the ordinary rungs.  `version` / `rewire_seq`
        override the image's position when the caller proved `csr`'s
        content equal to it (the snapshot's install rung)."""
        dev = self.device
        arrays = {name: np.asarray(state["arrays"][name]) for name in RESIDENT_ARRAYS}
        leaves = [np.asarray(a) for a in state["ell_leaves"]]
        n_buckets = len(csr.ell.buckets)
        if len(leaves) != 5 * n_buckets + 2:
            raise ValueError(
                f"resident image has {len(leaves)} ELL leaves, the mirror's "
                f"ELL takes {5 * n_buckets + 2}"
            )
        ell = ops.EllGraph(
            tuple(
                ops.EllBucket(*(_put(a, dev) for a in leaves[5 * b: 5 * b + 5]))
                for b in range(n_buckets)
            ),
            _put(leaves[-2], dev),
            _put(leaves[-1], dev),
        )
        res = _Resident(
            topo_key=tuple(int(x) for x in state["topo_key"]),
            ell_host=csr.ell,
            version=int(state["version"] if version is None else version),
            ell=ell,
            **{name: _put(arrays[name], dev) for name in RESIDENT_ARRAYS},
            shadow_metric=arrays["edge_metric"].copy(),
            shadow_up=arrays["edge_up"].copy(),
            shadow_overloaded=arrays["node_overloaded"].copy(),
            sweep_hint=int(state.get("sweep_hint", 16)),
            rewire_seq=int(state["rewire_seq"] if rewire_seq is None else rewire_seq),
        )
        self._adopt(csr, res)
        self._bump(
            "device.engine.bytes_staged",
            sum(a.nbytes for a in arrays.values()) + sum(a.nbytes for a in leaves),
        )
        return res

    def cached_program_keys(self) -> list[tuple]:
        """Ladder keys of the forward runs made, in first-run order."""
        return list(self._program_keys)

    @staticmethod
    def _ladder_key(key) -> tuple:
        """A manifest key as this engine records it: `small` is False,
        since the port has one program shape for every size."""
        topo, s_bucket, n_words, n_sweeps, _small, use_link_metric = key
        return (
            tuple(int(x) for x in topo),
            int(s_bucket),
            int(n_words),
            int(n_sweeps),
            False,
            bool(use_link_metric),
        )

    def prewarm(self, csr, keys) -> int:
        """One discarded forward run per ladder key on `csr`'s installed
        resident, every source the resident's first node: it pays CUDA's
        cold costs before the first query.  Keys of another topology, or
        already run, are skipped; nothing runs without a current
        resident.  Returns how many keys ran."""
        res = self._residents.get(id(csr))
        if res is None or res.ell_host is not csr.ell:
            return 0
        ran = 0
        for key in map(self._ladder_key, keys):
            if key in self._program_keys or key[0] != res.topo_key:
                continue
            _topo, s_bucket, n_words, n_sweeps, _small, use_link_metric = key
            src = torch.zeros(s_bucket, dtype=torch.int32, device=self.device)
            *_, ok = ops.spf_forward_full(
                src,
                res.ell,
                res.edge_src,
                res.edge_dst,
                res.edge_metric,
                res.edge_up,
                res.node_overloaded,
                res.out_slot,
                n_words,
                n_sweeps,
                use_link_metric=use_link_metric,
            )
            _host(ok, "prewarm run")  # waits for the run
            self._program_keys[key] = None
            self._bump("device.engine.prewarm_runs")
            ran += 1
        return ran

    # -- queries ------------------------------------------------------------

    def spf_results(
        self,
        csr,
        sources: list,
        use_link_metric: bool = True,
        expect_epoch: Optional[int] = None,
    ):
        """Distances, SP-DAG and bit-packed first hops of `sources` on the
        resident mirror, as reference-shaped SpfResults.

        The sources are padded up the S_BUCKETS ladder with the first
        source (pad columns compute real, discarded results, so the
        verdict stays meaningful).  Each attempt runs the resident's
        sweep hint and reads the converged verdict once; a False verdict
        doubles the hint (shared with csr._sweep_hint).  The converged
        attempt's dist, DAG and words are fetched once.

        `expect_epoch` pins the csr.version the caller coalesced against:
        a moved topology raises EpochMismatchError before any device
        work.  The fault hook sees `spf` first."""
        if self.fault_hook is not None:
            self.fault_hook("spf")
        if expect_epoch is not None and int(csr.version) != int(expect_epoch):
            self._bump("device.engine.epoch_invalidations")
            raise EpochMismatchError(int(expect_epoch), int(csr.version))
        if not sources:
            return {}
        tr = _trace.TRACE
        if tr is not None:
            # the warm rung; sync() upgrades it when the residency moves
            tr.annotate("engine.rung", "spf")
        t_query = time.perf_counter()
        bytes_before = self.counters.get("device.engine.bytes_staged", 0)
        res = self.sync(csr)

        src_ids = np.asarray([csr.node_id[s] for s in sources], dtype=np.int32)
        s = len(sources)
        s_bucket = _s_bucket(s)
        if s_bucket > s:
            src_ids = np.concatenate(
                [src_ids, np.full(s_bucket - s, src_ids[0], np.int32)]
            )
        # topology-wide word count: unset high words decode to no bits
        n_words = max(1, -(-csr.max_out_slots // 32))
        t0 = time.perf_counter()
        src_dev = _put(src_ids, self.device)
        self._bump("device.engine.bytes_staged", src_ids.nbytes)
        while True:
            n_sweeps = res.sweep_hint
            self._program_keys[
                (res.topo_key, s_bucket, n_words, n_sweeps, False, bool(use_link_metric))
            ] = None
            dist, dag, nh, ok = ops.spf_forward_full(
                src_dev,
                res.ell,
                res.edge_src,
                res.edge_dst,
                res.edge_metric,
                res.edge_up,
                res.node_overloaded,
                res.out_slot,
                n_words,
                n_sweeps,
                use_link_metric=use_link_metric,
            )
            if _host(ok, "forward verdict"):
                break
            res.sweep_hint = n_sweeps * 2
            # share the learned relax depth with the mirror
            csr._sweep_hint = res.sweep_hint
        dist, dag, nh = (_host(t[:s], "forward result") for t in (dist, dag, nh))
        self._bump(
            "device.engine.dispatch_us", int((time.perf_counter() - t0) * 1e6)
        )
        self._bump("device.engine.queries")
        self.last_query_bytes = (
            self.counters["device.engine.bytes_staged"] - bytes_before
        )
        self.last_query_us = int((time.perf_counter() - t_query) * 1e6)
        return csr.to_spf_results(sources, dist, dag, nh)
