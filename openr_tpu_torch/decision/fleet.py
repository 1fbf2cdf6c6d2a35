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

A view is a snapshot of one LinkState version; the cache recomputes it
cold when the version or the destination set changes.  The warm-start
gates and the incremental delta rung come in a later slice.
"""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from ..device.engine import DeviceResidencyEngine
from ..ops import allsources as asrc
from ..ops.banded import SpfRunner, build_banded
from ..ops.sssp import INF16, INF32
from .csr import CsrTopology
from .link_state import LinkState


def _row_i32(row: np.ndarray) -> np.ndarray:
    """Normalize a fetched distance row to the int32/INF32 contract (a
    uint16 row carries the INF16 sentinel of the reference's uint16
    distance mode)."""
    if row.dtype == np.uint16:
        return np.where(row >= INF16, INF32, row.astype(np.int32))
    return row


def _reverse_runner(csr: CsrTopology) -> SpfRunner:
    """SpfRunner over the REVERSED directed edges of a CsrTopology
    snapshot, edges sorted by (dst, src) like the forward mirror."""
    e = csr.n_edges
    src = csr.edge_dst[:e].copy()
    dst = csr.edge_src[:e].copy()
    met = csr.edge_metric[:e].copy()
    up = csr.edge_up[:e].copy()
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
    return SpfRunner(
        build_banded(edge_src, edge_dst, e, csr.n_nodes),
        edge_src,
        edge_dst,
        edge_metric,
        edge_up,
        csr.node_overloaded.copy(),
        e,
    )


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
        self._node_id = csr.node_id
        self._overloaded = csr.node_overloaded.copy()
        self._dist_dev: Optional[torch.Tensor] = None  # [N, P] int32
        self._bitmap_dev: Optional[torch.Tensor] = None  # [N, P, W] int32
        self._rows: dict[int, np.ndarray] = {}  # node id -> [P] int32
        self.converged = False

    def compute(self) -> None:
        """One device round: the P-source reverse relax to its fixed point
        and the fused verify + bitmap epilogue.  Raises when the product
        does not converge."""
        dest_ids = np.asarray(
            [self._node_id[d] for d in self.dest_names], dtype=np.int32
        )
        out = asrc.build_out_ell(
            self.csr.edge_src,
            self.csr.edge_dst,
            self.csr.n_edges,
            self.csr.n_nodes,
            out_slot=self.csr.out_slot,
        )
        runner = _reverse_runner(self.csr)
        self._engine.stage(runner)
        dist, bitmap, ok = self._engine.dispatch(
            "fleet_product",
            asrc.reduced_all_sources,
            dest_ids,
            runner,
            out,
            epilogue=self._engine.epilogue,
        )
        if not ok:
            raise RuntimeError(
                "fleet reverse SSSP did not reach its fixed point"
            )
        self._dist_dev = dist
        self._bitmap_dev = bitmap
        self.converged = True

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
            hit = _row_i32(self._dist_dev[i].cpu().numpy())
            self._rows[i] = hit
        return hit

    def prefetch_rows(self, nodes: list[str]) -> None:
        """Fetch many routers' rows in one device gather (fleet dumps)."""
        ids = [self._node_id[n] for n in nodes if n in self._node_id]
        missing = [i for i in ids if i not in self._rows]
        if not missing:
            return
        index = torch.as_tensor(missing, device=self._dist_dev.device)
        rows = _row_i32(self._dist_dev.index_select(0, index).cpu().numpy())
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
        slot_names = self.csr.slot_neighbors(node)
        out: set[str] = set()
        for w, word in enumerate(words.view(np.uint32).tolist()):
            bits = int(word)
            while bits:
                b = bits & -bits
                out.add(slot_names[32 * w + b.bit_length() - 1])
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
    or destination-set change.  Weakly keyed on the LinkState."""

    def __init__(self) -> None:
        self._views: "weakref.WeakKeyDictionary[LinkState, FleetRouteView]" = (
            weakref.WeakKeyDictionary()
        )

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
        when None)."""
        if engine is None:
            engine = DeviceResidencyEngine(device)
        if not dest_names:
            return None
        if self.is_warm(ls, dest_names):
            return self._views[ls]
        if csr is None or csr.version != ls.version:
            csr = CsrTopology.from_link_state(ls)
        view = FleetRouteView(csr, dest_names, engine)
        view.compute()
        self._views[ls] = view
        return view
