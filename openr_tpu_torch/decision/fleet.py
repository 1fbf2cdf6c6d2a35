"""Fleet route view: the route build's consumer of the fleet product.

Port of `openr_tpu.decision.fleet`.  One reverse-SSSP round
(ops.allsources) answers every router's route build toward the
destination set route construction reads — the prefix-advertising nodes
plus every labeled node.  The reverse distances dist[v, p] ==
dist(v -> p) cover every router v, so for any router `me` the route
build has reachability (dist(me -> advertiser) < INF), best metric (min
over advertisers) and LFA-free ECMP (link me -> u is a next hop toward p
iff metric + dist(u -> p) == dist(me -> p), Decision.cpp:1296-1300,
with the drain exception) — all reads of the same [N, P] product.

Above the engine's node threshold the view is served by the blocked
APSP rung (parallel.blocked).  Below it, banded topologies run the
progressive banded relax and the fused epilogue, and topologies without
bands (fat-trees, small or oddly named graphs) the bucketed-ELL relax.
Both take the reference's uint16 distance mode when every metric is
below 5000 (ops.banded.pick_small_dist): the view's product is then a
torch.uint16 tensor with the INF16 sentinel, exactly the reference's,
and every reader widens it through `_row_i32` or keys on its dtype.  A
run that saturates latches the mode off for the view's runner and
retries in int32 (`device.engine.small_dist_retries`).  The blocked rung
is int32, as in the reference.

A view is a snapshot of one LinkState version: the mirror it is built
on refreshes its arrays in place at later versions, so everything a view
reads after its build (node ids, overload bits, the usable-edge table,
the out-edge table, the reverse runner) is copied at build time.

The cache warm-starts a rebuild over the same node and destination
universe from the previous banded product, in both directions: an
improvement-only change (metric decrease, link up, overload clear) seeds
the whole previous product; a worsening or mixed change (metric
increase, link down, drain) seeds it with the certified affected set
re-set to INF (`_affected_init`).  The blocked rung and the ELL path
always compute cold.

Deliberate difference from the reference: its cache retries a failed
warm rebuild cold on ANY exception.  The port re-runs cold only on the
two designed verdicts, an affected set not certified within its pass
budget and a warm relax that ends without its convergence certificate;
both set `cold_fallback` (counted as `decision.fleet_warm_fallbacks`).
An exception, such as a kernel launch or a CUDA error, propagates, so no
failure of a kernel hides behind a second attempt.

`FleetViewCache(delta=True)` (or OPENR_FLEET_DELTA=1; off by default,
as in the reference) puts the incremental delta rung (decision.delta,
ops.delta) before those gates: a rebuild over the same universe first
folds the whole pending event batch into the previous banded product at
a cost proportional to the affected columns, its slab epilogue
launching K1, and labels the view `warm_mode == "delta"`; a designed
gate failure falls through to the warm and cold paths.  The rung runs
only on an engine the caller passes, as in the reference, whose
engine-less views never take it.
"""

from __future__ import annotations

import os
import weakref
from typing import Optional

import numpy as np
import torch

from ..device.engine import DeviceResidencyEngine
from ..ops import allsources as asrc
from ..ops.banded import SpfRunner, affected_mask, build_banded
from ..ops.sssp import (
    INF16,
    INF32,
    build_ell,
    to_u16,
    u16_index_select,
    u16_to_i32,
)
from .csr import CsrTopology
from .link_state import LinkState

# passes the affected-set propagation may take before a worsening
# rebuild gives up its warm start (the reference's bound)
AFFECTED_MAX_ITERS = 128


def _row_i32(row: np.ndarray) -> np.ndarray:
    """Normalize a fetched distance row to the int32/INF32 contract (a
    uint16 row carries the INF16 sentinel of the uint16 distance mode)."""
    if row.dtype == np.uint16:
        return np.where(row >= INF16, INF32, row.astype(np.int32))
    return row


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor of distances as numpy, dtype kept (a uint16 tensor
    travels as its int16 view, which every device copies)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _usable_edge_table(csr: CsrTopology):
    """Canonical (directed-pair key, min metric) table of USABLE edges —
    the warm-start gates' comparison unit.  Distances depend only on the
    min metric per usable directed (src, dst) pair.

    The key is (dst << 32) | src (the reference keys (src << 32) | dst):
    the mirror's edges are sorted by (dst, src), so the keys arrive in
    order and the sort is skipped unless an edge is out of place."""
    e = csr.n_edges
    up = np.asarray(csr.edge_up[:e], dtype=bool)
    src = np.asarray(csr.edge_src[:e], dtype=np.int64)[up]
    dst = np.asarray(csr.edge_dst[:e], dtype=np.int64)[up]
    met = np.asarray(csr.edge_metric[:e], dtype=np.int64)[up]
    key = (dst << 32) | src
    if np.any(key[1:] < key[:-1]):
        order = np.argsort(key, kind="stable")
        key, met = key[order], met[order]
    first = np.r_[True, key[1:] != key[:-1]]
    uniq = key[first]
    min_met = np.minimum.reduceat(met, np.flatnonzero(first))
    return uniq, min_met


def _improvement_only(
    old_keys, old_met, old_ov, new_keys, new_met, new_ov
) -> bool:
    """True iff the new graph can only have SHORTER-OR-EQUAL distances
    than the old one: every old usable directed pair is still usable
    with metric <= old, and no node gained the overload bit.  Under it
    the previous product is an elementwise upper bound."""
    if np.any(new_ov & ~old_ov):
        return False
    pos = np.searchsorted(new_keys, old_keys)
    if np.any(pos >= len(new_keys)) or np.any(
        new_keys[np.minimum(pos, max(len(new_keys) - 1, 0))] != old_keys
    ):
        return False
    return bool(np.all(new_met[pos] <= old_met))


def _in_sorted(keys: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Vectorized membership of q in the sorted key array."""
    if len(keys) == 0:
        return np.zeros(q.shape, dtype=bool)
    pos = np.searchsorted(keys, q)
    pos_c = np.minimum(pos, len(keys) - 1)
    return (pos < len(keys)) & (keys[pos_c] == q)


def _worsened_masks(prev: "FleetRouteView", new_keys, new_met, new_ov):
    """Per-reverse-slot masks of WORSENED forward edges in the layout of
    the previous view's reverse runner (residual slots [N, K], band
    positions [B, N]): the seed of `affected_mask`.

    Worsened: an old usable directed pair now unusable, or still usable
    with a larger min metric, or any reverse edge sourced at a newly
    overloaded node (the destination-row exception included, which only
    over-marks).  Improved or new edges are not worsened: they only
    loosen the upper bound, which the relax fixes."""
    old_keys, old_met = prev._edge_keys, prev._edge_met
    present = _in_sorted(new_keys, old_keys)
    pos = np.minimum(
        np.searchsorted(new_keys, old_keys), max(len(new_keys) - 1, 0)
    )
    worse = ~present
    if len(new_keys):
        worse |= present & (new_met[pos] > old_met)
    bad_keys = old_keys[worse]
    newly_ov = new_ov & ~prev._overloaded
    bg = prev._runner.bg
    n = bg.n_nodes
    rn, re_ = bg.resid_nbr, bg.resid_eid
    # reverse edge u -> v is forward edge v -> u: key (u << 32) | v
    v_ids = np.arange(n, dtype=np.int64)
    qk = (rn.astype(np.int64) << 32) | v_ids[:, None]
    worsened_resid = (re_ >= 0) & (_in_sorted(bad_keys, qk) | newly_ov[rn])
    rows = []
    for b, c in enumerate(bg.offsets):
        u = (v_ids - c) % n
        qk = (u << 32) | v_ids
        rows.append(
            (bg.band_eid[b] >= 0) & (_in_sorted(bad_keys, qk) | newly_ov[u])
        )
    return worsened_resid, np.stack(rows)


def _affected_init(prev: "FleetRouteView", new: "FleetRouteView"):
    """Seed of a worsening-direction warm start: the previous distances
    with every possibly-affected entry re-set to INF (INF16, and a uint16
    seed, when the previous product is uint16), or None when the
    affected-set propagation did not certify its fixpoint within
    AFFECTED_MAX_ITERS passes (the caller must then cold-start).

    Every kept entry has an old shortest path that avoids the worsened
    edges, so its old value is still an upper bound in the new graph,
    and the warm relax plus its verification reproduce the cold fixed
    point bit for bit.  The passes run are counted in the new view's
    engine (`device.engine.affected_passes`)."""
    runner = prev._runner
    worsened_resid, worsened_band = _worsened_masks(
        prev, new._edge_keys, new._edge_met, new._overloaded
    )
    device = prev._dist_dev.device
    aff, done, passes = affected_mask(
        prev._dist_dev,
        runner.bg,
        runner.call_arrays(),
        torch.from_numpy(worsened_resid).to(device),
        torch.from_numpy(worsened_band).to(device),
        max_iters=AFFECTED_MAX_ITERS,
    )
    new._engine.counters["device.engine.affected_passes"] += passes
    new.affected_passes = passes
    new.affected_share = int(aff.count_nonzero()) / aff.numel()
    if not done:
        return None
    kept = prev._dist_dev[: runner.bg.n_nodes]
    if kept.dtype == torch.uint16:
        return to_u16(torch.where(aff, INF16, u16_to_i32(kept)))
    return torch.where(aff, INF32, kept)


def _reverse_runner(csr: CsrTopology, hint: Optional[int] = None) -> SpfRunner:
    """SpfRunner over the REVERSED directed edges of a CsrTopology
    snapshot, edges sorted by (dst, src) like the forward mirror: the
    banded decomposition when the graph has one, else the ELL.  `hint`
    seeds the learned fixed-sweep count.  Retired freelist slots inside
    [:n_edges] (`edge_live` False) are dropped: the snapshot renumbers
    edges into its own dense space.

    The reference builds the ELL beside the bands on every rebuild; the
    port builds it only where it runs (a banded runner never reads it),
    which saves its host build on every banded view."""
    ids = np.flatnonzero(csr.edge_live[: csr.n_edges])
    e = len(ids)
    src = csr.edge_dst[ids]
    dst = csr.edge_src[ids]
    met = csr.edge_metric[ids]
    up = csr.edge_up[ids]
    order = np.lexsort((src, dst))
    pad_node = csr.node_capacity - 1
    edge_src = np.full(csr.edge_capacity, pad_node, dtype=np.int32)
    edge_dst = np.full(csr.edge_capacity, pad_node, dtype=np.int32)
    edge_metric = np.ones(csr.edge_capacity, dtype=np.int32)
    edge_up = np.zeros(csr.edge_capacity, dtype=bool)
    edge_src[:e] = src[order]
    edge_dst[:e] = dst[order]
    edge_metric[:e] = met[order]
    edge_up[:e] = up[order]
    node_overloaded = csr.node_overloaded.copy()
    bg = build_banded(edge_src, edge_dst, e, csr.n_nodes)
    ell = None
    if bg is None:
        ell = build_ell(
            edge_src, edge_dst, edge_metric, edge_up, node_overloaded, e
        )
    runner = SpfRunner(
        ell,
        bg,
        edge_src,
        edge_dst,
        edge_metric,
        edge_up,
        node_overloaded,
        e,
    )
    if hint is not None:
        runner.hint = hint
    return runner


class FleetRouteView:
    """Snapshot answering dist/ECMP queries for every (router, dest) pair.

    `dest_names` must cover every node route construction asks distances
    to: prefix advertisers + labeled nodes (fleet_destinations)."""

    def __init__(
        self, csr: CsrTopology, dest_names: list[str], engine: DeviceResidencyEngine
    ) -> None:
        self.csr = csr
        self.version = csr.version
        self._engine = engine
        self.dest_names = list(dest_names)
        self.p_index = {name: i for i, name in enumerate(self.dest_names)}
        self._node_id = dict(csr.node_id)
        self._node_names = list(csr.node_names)
        self._overloaded = csr.node_overloaded.copy()
        # usable-edge table the next view's warm-start gates compare with
        self._edge_keys, self._edge_met = _usable_edge_table(csr)
        # [N*, P]: int32, or uint16 (INF16) in the uint16 distance mode
        self._dist_dev: Optional[torch.Tensor] = None
        self._bitmap_dev: Optional[torch.Tensor] = None  # [N, P, W] int32
        # out-edge table of the build: the bitmap's slot -> neighbour map
        self._out: Optional[asrc.OutEll] = None
        self._rows: dict[int, np.ndarray] = {}  # node id -> [P] int32
        self.converged = False
        # a warm gate admitted a seed but the designed verdict (affected
        # set not certified, warm relax not converged) sent it cold
        self.cold_fallback = False
        self.warm = False  # computed from a previous view's distances
        # None | "improve" | "worsen": which warm gate seeded the relax
        self.warm_mode: Optional[str] = None
        self.sweep_hint: Optional[int] = None
        # affected-set passes and share of [N, P] of a worsening gate
        self.affected_passes: Optional[int] = None
        self.affected_share: Optional[float] = None
        # True when the blocked APSP rung served this view
        self.node_sharded = False
        # kept for the NEXT view's worsening warm start: the affected set
        # propagates over THIS view's reverse graph and distances
        self._runner: Optional[SpfRunner] = None

    def compute(
        self,
        hint_seed: Optional[int] = None,
        init_from: Optional["FleetRouteView"] = None,
        warm_seed: Optional[int] = None,
        down_from: Optional["FleetRouteView"] = None,
    ) -> None:
        """One device round.  Above the engine's node threshold (or with
        OPENR_NODE_SHARD=1) the blocked APSP rung serves it; a failure
        there raises, counted in `mesh.blocked.fallbacks` — the port
        never swaps the rung for another path.  Otherwise the P-source
        reverse relax: banded, or the ELL fallback.

        `hint_seed` carries the cache's learned cold sweep count.  The
        caller (FleetViewCache.view) proves the gates: `init_from` (an
        improvement-only change) seeds the whole previous product,
        `down_from` (a worsening change) the previous product minus its
        certified affected set.  Seeds apply only on the banded path;
        `warm_seed` is then the sweep hint.  A warm relax that ends
        without its certificate re-runs cold; raises when a cold product
        does not converge."""
        dest_ids = np.asarray(
            [self._node_id[d] for d in self.dest_names], dtype=np.int32
        )
        out = self._out = asrc.build_out_ell(
            self.csr.edge_src,
            self.csr.edge_dst,
            self.csr.n_edges,
            self.csr.n_nodes,
            out_slot=self.csr.out_slot,
        )
        blocked = self._engine.blocked
        if blocked.should_engage(self.csr.n_nodes):
            try:
                dist, bitmap, _ = blocked.fleet_product(self.csr, dest_ids, out)
            except Exception:
                blocked._bump("mesh.blocked.fallbacks")
                raise
            self._dist_dev = dist
            self._bitmap_dev = bitmap
            self.converged = True
            self.node_sharded = True
            return
        runner = _reverse_runner(self.csr, hint=hint_seed)
        self._engine.stage(runner)
        init = None
        if runner.bg is not None:
            if init_from is not None:
                init = init_from._dist_dev
                self.warm_mode = "improve"
            elif down_from is not None:
                init = _affected_init(down_from, self)
                if init is None:
                    self.cold_fallback = True
                else:
                    self.warm_mode = "worsen"
        if init is not None and warm_seed is not None:
            runner.hint = warm_seed
        maps = (
            asrc.build_epilogue_maps(runner.bg, out)
            if runner.bg is not None
            else None
        )

        def product(init_dist):
            return self._engine.dispatch(
                "fleet_product",
                asrc.reduced_all_sources,
                dest_ids,
                runner,
                out,
                self.csr.edge_metric,
                self.csr.edge_up,
                self.csr.node_overloaded,
                init_dist=init_dist,
                maps=maps,
                epilogue=self._engine.epilogue,
            )

        dist, bitmap, ok = product(init)
        if not ok and init is not None:
            # the warm relax used up its block budget without the
            # certificate: pay the cold run rather than serve it
            init = None
            self.warm_mode = None
            self.cold_fallback = True
            if hint_seed is not None:
                runner.hint = hint_seed
            dist, bitmap, ok = product(None)
        if runner.bg is None:
            self._engine.counters["device.engine.ell_sweeps"] += runner.sweeps
        if not runner.small_allowed:  # a fresh runner latched it off
            self._engine.counters["device.engine.small_dist_retries"] += 1
        if not ok:
            raise RuntimeError(
                "fleet reverse SSSP did not reach its fixed point"
            )
        self._dist_dev = dist
        self._bitmap_dev = bitmap
        self.converged = True
        self.warm = init is not None
        self.sweep_hint = runner.hint
        self._runner = runner

    # -- host queries --------------------------------------------------------

    def covers(self, node: str) -> bool:
        return node in self._node_id

    def is_dest(self, node: str) -> bool:
        return node in self.p_index

    def _row(self, node: str) -> np.ndarray:
        """dist(node -> every dest), [P] int32; fetched lazily and cached."""
        i = self._node_id[node]
        hit = self._rows.get(i)
        if hit is None:
            hit = _row_i32(_to_host(self._dist_dev[i]))
            self._rows[i] = hit
        return hit

    def prefetch_rows(self, nodes: list[str]) -> None:
        """Fetch many routers' rows in one device gather (fleet dumps)."""
        ids = [self._node_id[n] for n in nodes if n in self._node_id]
        missing = [i for i in ids if i not in self._rows]
        if not missing:
            return
        d = self._dist_dev
        index = torch.as_tensor(missing, device=d.device)
        if d.dtype == torch.uint16:
            rows = u16_index_select(d, 0, index)
        else:
            rows = d.index_select(0, index)
        rows = _row_i32(_to_host(rows))
        for k, i in enumerate(missing):
            self._rows[i] = rows[k]

    def dist(self, node: str, dest: str) -> int:
        """dist(node -> dest); INF32 when unreachable."""
        return int(self._row(node)[self.p_index[dest]])

    def reachable(self, node: str, dest: str) -> bool:
        return self.dist(node, dest) < INF32

    def is_overloaded_id(self, node: str) -> bool:
        return bool(self._overloaded[self._node_id[node]])

    def next_hop_neighbors(self, node: str, dest: str) -> set[str]:
        """Decode the device bitmap: slot-named ECMP next-hop neighbors of
        `node` toward `dest` (parallel links share a slot)."""
        i = self._node_id[node]
        words = self._bitmap_dev[i, self.p_index[dest]].cpu().numpy()
        has = self._out.eid[i] >= 0
        slot_names = dict(
            zip(self._out.slot[i][has].tolist(), self._out.nbr[i][has].tolist())
        )
        out: set[str] = set()
        for w, word in enumerate(words.view(np.uint32).tolist()):
            bits = int(word)
            while bits:
                b = bits & -bits
                out.add(self._node_names[slot_names[32 * w + b.bit_length() - 1]])
                bits ^= b
        return out


def fleet_destinations(ls: LinkState, prefix_state) -> list[str]:
    """The destination set route construction reads distances to, for one
    area: prefix-advertising nodes (reachability filter + unicast ECMP,
    Decision.cpp:445-613) + labeled nodes (MPLS node-label routes,
    Decision.cpp:655-745).  Sorted for a deterministic cache key."""
    dests: set[str] = set()
    for entries in prefix_state.prefixes.values():
        for node, _area in entries:
            if ls.has_node(node):
                dests.add(node)
    for node, adj_db in ls.get_adjacency_databases().items():
        if adj_db.node_label != 0 and ls.has_node(node):
            dests.add(node)
    return sorted(dests)


class FleetViewCache:
    """Per-LinkState cached FleetRouteView, recomputed on topology version
    or destination-set change (warm-started where a gate proves it).
    Weakly keyed on the LinkState.

    Learned sweep hints are keyed by topology shape (node and edge
    counts): `_hints` holds cold counts, `_warm_hints` the counts of
    warm rebuilds, which would undersize every later cold rebuild.

    `delta` opts in to the incremental delta rung (None reads
    OPENR_FLEET_DELTA, off unless "1"); `bump` is its counter sink
    (`decision.delta.*`), `delta_min_p` the fewest destinations it
    takes, `delta_parity` its cold parity gate (None reads
    OPENR_DELTA_PARITY)."""

    def __init__(
        self,
        delta: Optional[bool] = None,
        bump=None,
        delta_min_p: int = 32,
        delta_parity: Optional[bool] = None,
    ) -> None:
        if delta is None:
            delta = os.environ.get("OPENR_FLEET_DELTA", "0") == "1"
        self._delta = None
        if delta:
            from .delta import DeltaProductUpdater

            self._delta = DeltaProductUpdater(
                bump=bump, min_p=delta_min_p, parity=delta_parity
            )
        self._views: "weakref.WeakKeyDictionary[LinkState, FleetRouteView]" = (
            weakref.WeakKeyDictionary()
        )
        self._hints: dict[tuple[int, int], int] = {}
        self._warm_hints: dict[tuple[int, int], int] = {}

    def is_warm(self, ls: LinkState, dest_names: list[str]) -> bool:
        """True when a cached view already answers this (version, dests)."""
        cached = self._views.get(ls)
        return (
            cached is not None
            and cached.version == ls.version
            and cached.dest_names == list(dest_names)
        )

    def view(
        self,
        ls: LinkState,
        dest_names: list[str],
        csr: Optional[CsrTopology] = None,
        engine: Optional[DeviceResidencyEngine] = None,
        device=None,
    ) -> Optional[FleetRouteView]:
        """Computed view for this (version, dests); None when empty.
        Computes on `engine`'s device, else on `device` (the CUDA card
        when None).  A given mirror `csr` is refreshed in place to the
        LinkState's version; without one the view builds a fresh mirror.

        A rebuild over the same node and destination universe as the
        cached view warm-starts from it: an improvement-only change
        seeds the whole previous product, any other change the previous
        product minus its certified affected set (banded previous views
        only).  The blocked rung's views seed nothing.  With the delta
        rung on and an `engine` given, a rebuild first tries to fold the
        change into the cached product (decision.delta)."""
        delta = self._delta if engine is not None else None
        if engine is None:
            engine = DeviceResidencyEngine(device)
        if not dest_names:
            return None
        if self.is_warm(ls, dest_names):
            return self._views[ls]
        if csr is None:
            csr = CsrTopology.from_link_state(ls)
        elif csr.version != ls.version:
            csr.refresh(ls)
        prev = self._views.get(ls)
        view = FleetRouteView(csr, dest_names, engine)
        if (
            delta is not None
            and (prev is None or not prev.node_sharded)
            and delta.eligible(prev)
            and delta.update(prev, view, engine)
        ):
            self._views[ls] = view
            return view
        key = (csr.n_nodes, csr.n_edges)
        init_from = None
        down_from = None
        if (
            prev is not None
            and prev.converged
            and not prev.node_sharded
            and prev._dist_dev is not None
            and prev.dest_names == view.dest_names
            and prev._node_id == view._node_id
            and prev._overloaded.shape == view._overloaded.shape
        ):
            if _improvement_only(
                prev._edge_keys,
                prev._edge_met,
                prev._overloaded,
                view._edge_keys,
                view._edge_met,
                view._overloaded,
            ):
                init_from = prev
            elif prev._runner is not None and prev._runner.bg is not None:
                down_from = prev
        view.compute(
            hint_seed=self._hints.get(key),
            init_from=init_from,
            warm_seed=self._warm_hints.get(key, 4),
            down_from=down_from,
        )
        if view.sweep_hint is not None:
            store = self._warm_hints if view.warm else self._hints
            store[key] = max(store.get(key, 0), view.sweep_hint)
        self._views[ls] = view
        return view
