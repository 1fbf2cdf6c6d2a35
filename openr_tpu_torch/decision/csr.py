"""Padded directed-edge mirror of the link-state graph.

Port of `openr_tpu.decision.csr` (CsrTopology :102, RewireDelta :74,
_build_out_slots :35).  Node names are interned to dense int32 ids in
sorted-name order; each link gives two directed edges sorted by (dst,
src); capacities are padded to powers of two, and padding edges are down
and point at the last padding node.  The mirror also holds the forward
bucketed ELL (`ell`, ops.sssp.build_ell), which the residency engine
stages for per-source SPF.

`refresh` brings the mirror to a new LinkState version in place where
it can: attribute changes (metric, up, overload) are re-read from the
shared Link objects into the same arrays, and a bounded edge-set change
(an OCS rewire) recycles retired edge slots through a freelist,
re-ranks `out_slot` and re-encodes only the affected ELL rows, logging a
`RewireDelta` the engine replays.  Anything else (a node-set change,
capacity overflow, an oversized rewire) rebuilds the mirror, reusing the
capacities when they still fit.

The forward band decomposition (`banded`) and its fixed-sweep runner
(`runner`, ops.banded.SpfRunner) carry the masked batches of KSP2,
what-if and TI-LFA (`run_batched_spf`).  Unlike the reference, which
builds the bands with every mirror, both are built on first use, so a
mirror that only serves per-source queries never pays for them.  The
runner reads the tensors of the mirror's resident in the engine, which
an attribute refresh updates in place (a banded runner stages only its
band tables), and is dropped on a rewire or a rebuild.  `row_path_links` turns one row of a masked run
into the metric and path_links the KSP path trace walks, and
`edges_of_links` maps each link to its directed edge ids.
"""

from __future__ import annotations

import bisect
import gc
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..ops.banded import BandedGraph, SpfRunner, build_banded
from ..ops.sssp import INF32, EllGraph, build_ell
from .link_state import LinkState, NodeSpfResult, SpfResult


def _ids(objs) -> np.ndarray:
    """id() of each object, 0 for None, as uint64."""
    return np.fromiter((0 if o is None else id(o) for o in objs), dtype=np.uint64)


@contextmanager
def _gc_paused():
    """The cyclic garbage collector off for the block (and back on only
    if it was on)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _next_pow2(n: int, floor: int = 8) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


def _build_out_slots(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_edges: int,
    live: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, int]:
    """out_slot[e] = rank of edge e's dst among src(e)'s sorted unique
    out-neighbors (parallel links share the slot); -1 for padding.
    Node ids are assigned in sorted-name order, so id rank == the
    reference's name-sorted neighbor ordering.

    `live` excludes edge slots inside [:n_edges]: they rank as padding."""
    e_cap = len(edge_src)
    out_slot = np.full(e_cap, -1, dtype=np.int32)
    if n_edges == 0:
        return out_slot, 0
    if live is None:
        ids = np.arange(n_edges, dtype=np.int64)
    else:
        ids = np.flatnonzero(live[:n_edges]).astype(np.int64)
        if ids.size == 0:
            return out_slot, 0
    src = edge_src[ids].astype(np.int64)
    dst = edge_dst[ids].astype(np.int64)
    order = np.lexsort((dst, src))
    s_o, d_o = src[order], dst[order]
    new_grp = np.r_[True, s_o[1:] != s_o[:-1]]
    new_nbr = new_grp | np.r_[False, d_o[1:] != d_o[:-1]]
    nbr_rank = np.cumsum(new_nbr) - 1  # global distinct-neighbor counter
    grp_id = np.cumsum(new_grp) - 1
    first_rank = nbr_rank[new_grp]  # [n_groups]
    slots = (nbr_rank - first_rank[grp_id]).astype(np.int32)
    out_slot[ids[order]] = slots
    return out_slot, int(slots.max()) + 1


# the numpy fields `from_arrays` reads, as the reference mirror names them
ARRAY_FIELDS = (
    "edge_src",
    "edge_dst",
    "edge_metric",
    "edge_up",
    "node_overloaded",
)


@dataclass
class RewireDelta:
    """One bounded in-place edge-set change applied by
    CsrTopology._try_rewire: what the residency engine writes into its
    device mirror instead of restaging — the rewritten edge slots
    (post-rewire values), the out_slot entries whose rank moved, and the
    full post-rewire contents of every re-encoded ELL destination row."""

    seq: int  # csr.rewire_seq after this rewire (contiguous chain)
    version: int  # LinkState.version the rewire landed at
    slots: np.ndarray  # [M] int32 — edge slots rewritten in place
    src: np.ndarray  # [M] int32
    dst: np.ndarray  # [M] int32
    metric: np.ndarray  # [M] int32
    up: np.ndarray  # [M] bool
    live: np.ndarray  # [M] bool
    out_idx: np.ndarray  # int32 — out_slot entries whose rank changed
    out_val: np.ndarray  # int32
    # [(bucket index, local row, nbr, w, eid, ok, transit_ok)] — full
    # post-rewire row contents in the ELL bucket layout
    ell_rows: list
    n_edges: int  # post-rewire high-water edge count
    max_out_slots: int  # post-rewire first-hop slot ceiling
    links_added: int
    links_removed: int


@dataclass
class CsrTopology:
    """Padded directed-edge arrays + host-side interning tables."""

    node_names: list[str]  # dense id -> name (sorted)
    node_id: dict[str, int]
    n_nodes: int  # real node count
    node_capacity: int
    edge_capacity: int
    edge_src: np.ndarray  # [E_cap] int32
    edge_dst: np.ndarray  # [E_cap] int32
    edge_metric: np.ndarray  # [E_cap] int32
    edge_up: np.ndarray  # [E_cap] bool
    node_overloaded: np.ndarray  # [N_cap] bool
    n_edges: int  # high-water edge count (retired slots included)
    version: int  # LinkState.version this mirror was built from
    # out_slot[e]: rank of edge e's destination among its source node's
    # sorted unique out-neighbors (-1 padding) — the ECMP bit position
    out_slot: np.ndarray
    max_out_slots: int
    # forward bucketed ELL (ops.sssp.EllGraph) — the per-source relax
    # tables; its identity is what the engine's residency keys on
    ell: EllGraph
    # directed edge id -> (Link, from_node_name), None for a retired
    # slot; len == n_edges.  None for a mirror built `from_arrays`,
    # which has no Link objects and cannot refresh or decode results
    edge_links: Optional[list] = None
    # edge-slot freelist: live mask over [:n_edges] — a retired slot
    # keeps its position, styled as padding (src = dst = pad node, down)
    edge_live: Optional[np.ndarray] = None  # [E_cap] bool
    n_live: int = 0  # live directed edges (2 x live links)
    rewire_seq: int = 0  # bumped once per applied in-place rewire
    _free_slots: list = field(default_factory=list)
    # bounded chain of RewireDeltas for the engine; a resident that fell
    # behind the window restages (engine.DeviceResidencyEngine.sync)
    _rewire_log: list = field(default_factory=list)
    # fixed-sweep hint of the per-source relax; doubles when a run does
    # not reach the fixed point (engine.spf_results)
    _sweep_hint: int = 16
    # forward band decomposition and runner, built on first use (the
    # reference builds the bands with the mirror); `_banded_built` tells
    # a topology without bands (None) from one not yet examined
    _banded: Optional[BandedGraph] = None
    _banded_built: bool = False
    _runner: Optional[SpfRunner] = None
    _runner_engine: object = None

    # directed-edge slots one rewire may touch before its in-place writes
    # rival a restage and the rebuild is the cheaper path
    REWIRE_MAX_SLOTS = 256
    # RewireDeltas kept for engine catch-up; a resident more than this
    # many rewires behind restages instead of replaying
    REWIRE_LOG_DEPTH = 32

    # -- construction -------------------------------------------------------

    @classmethod
    def from_link_state(
        cls,
        ls: LinkState,
        node_capacity: Optional[int] = None,
        edge_capacity: Optional[int] = None,
    ) -> "CsrTopology":
        names = ls.node_names
        node_id = {n: i for i, n in enumerate(names)}
        links = sorted(ls.all_links)
        n_links = len(links)
        ends = np.empty((n_links, 2), dtype=np.int64)
        metric = np.empty((n_links, 2), dtype=np.int64)
        up = np.empty(n_links, dtype=bool)
        pairs = []
        for k, link in enumerate(links):
            ends[k] = (node_id[link.n1], node_id[link.n2])
            metric[k] = (link.metric1, link.metric2)
            up[k] = link.is_up()
            pairs.append((link, link.n1))
            pairs.append((link, link.n2))
        if n_links and int(metric.min()) < 1:
            raise ValueError(
                "edge metrics must be >= 1 (int32 distance math and the "
                "d == 0 source exception rely on positive metrics)"
            )
        # per link: n1 -> n2 then n2 -> n1; stable sort by (dst, src)
        src = ends.ravel()
        dst = ends[:, ::-1].ravel()
        order = np.lexsort((src, dst))
        overloaded = np.array(
            [ls.is_node_overloaded(name) for name in names], dtype=bool
        )
        return cls._build(
            names,
            src[order],
            dst[order],
            metric.ravel()[order],
            np.repeat(up, 2)[order],
            overloaded,
            ls.version,
            edge_links=[pairs[i] for i in order.tolist()],
            node_capacity=node_capacity,
            edge_capacity=edge_capacity,
        )

    @classmethod
    def from_arrays(
        cls, fields: dict, node_names: list[str], version: int = -1
    ) -> "CsrTopology":
        """The port's mirror of the graph in another mirror's numpy fields
        (ARRAY_FIELDS plus `n_edges`, as `openr_tpu`'s CsrTopology holds
        them), so both packages compute on the identical graph.  Retired
        edge slots (`edge_live` False) are dropped."""
        n = len(node_names)
        e = int(fields["n_edges"])
        live = fields.get("edge_live")
        ids = (
            np.arange(e) if live is None else np.flatnonzero(live[:e])
        )
        return cls._build(
            list(node_names),
            np.asarray(fields["edge_src"])[ids],
            np.asarray(fields["edge_dst"])[ids],
            np.asarray(fields["edge_metric"])[ids],
            np.asarray(fields["edge_up"])[ids],
            np.asarray(fields["node_overloaded"])[:n],
            version,
        )

    @classmethod
    def _build(
        cls, names, src, dst, metric, up, overloaded, version,
        edge_links=None, node_capacity=None, edge_capacity=None,
    ) -> "CsrTopology":
        n = len(names)
        e = len(src)
        n_cap = node_capacity or _next_pow2(n + 1)
        e_cap = edge_capacity or _next_pow2(e)
        if n_cap <= n or e_cap < e:
            raise ValueError("capacities must exceed the node and edge counts")
        pad_node = n_cap - 1
        edge_src = np.full(e_cap, pad_node, dtype=np.int32)
        edge_dst = np.full(e_cap, pad_node, dtype=np.int32)
        edge_metric = np.ones(e_cap, dtype=np.int32)
        edge_up = np.zeros(e_cap, dtype=bool)
        edge_src[:e] = src
        edge_dst[:e] = dst
        edge_metric[:e] = metric
        edge_up[:e] = up
        node_overloaded = np.zeros(n_cap, dtype=bool)
        node_overloaded[:n] = overloaded
        edge_live = np.zeros(e_cap, dtype=bool)
        edge_live[:e] = True
        out_slot, max_out_slots = _build_out_slots(edge_src, edge_dst, e)
        return cls(
            node_names=list(names),
            node_id={name: i for i, name in enumerate(names)},
            n_nodes=n,
            node_capacity=n_cap,
            edge_capacity=e_cap,
            edge_src=edge_src,
            edge_dst=edge_dst,
            edge_metric=edge_metric,
            edge_up=edge_up,
            node_overloaded=node_overloaded,
            n_edges=e,
            version=version,
            out_slot=out_slot,
            max_out_slots=max_out_slots,
            ell=build_ell(
                edge_src, edge_dst, edge_metric, edge_up, node_overloaded, e
            ),
            edge_links=edge_links,
            edge_live=edge_live,
            n_live=e,
        )

    # -- in-place refresh ---------------------------------------------------

    def refresh(self, ls: LinkState) -> bool:
        """Bring the mirror to `ls.version`, in place when possible.

        Returns True when the mirror stayed in place: either only link or
        node ATTRIBUTES changed (metric, up, overload) — the edge arrays
        are updated in place and the ELL is untouched, because the relax
        reads edge_up / node_overloaded / edge_metric at call time — or
        the edge-set change was a BOUNDED rewire (`_try_rewire`), applied
        to the same array and ELL objects, so device residency survives.

        Returns False when the mirror was REBUILT: a node-set change,
        capacity overflow, or an oversized rewire.  Capacities are reused
        while the new topology fits; the learned sweep hint is kept."""
        if self.edge_links is None:
            raise ValueError("a mirror built from arrays has no links to refresh")
        if ls.version == self.version:
            return True
        names = ls.node_names
        slot_ids = self._slot_link_ids()
        new_links = list(ls.all_links)
        new_ids = _ids(new_links)
        # the same link OBJECTS: Link.__eq__ keys on (node, iface) pairs
        # only, so a link removed and re-added as a new object compares
        # equal while edge_links holds the retired one
        same_topology = (
            names == self.node_names
            and len(new_links) * 2 == self.n_live
            and np.array_equal(np.unique(slot_ids[slot_ids != 0]), np.unique(new_ids))
        )
        if not same_topology:
            if self._try_rewire(ls, slot_ids, new_links, new_ids):
                return True
            hint = self._sweep_hint
            rebuilt = CsrTopology.from_link_state(
                ls,
                node_capacity=(
                    self.node_capacity
                    if len(names) < self.node_capacity
                    else None
                ),
                edge_capacity=(
                    self.edge_capacity
                    if len(ls.all_links) * 2 <= self.edge_capacity
                    else None
                ),
            )
            self.__dict__.update(rebuilt.__dict__)
            # the relax depth is a property of the topology shape
            self._sweep_hint = hint
            return False
        self._refresh_attributes(ls)
        self.version = ls.version
        if self._runner is not None:
            # write the changed attributes into the resident it reads
            self._runner_engine.stage_forward(self._runner, self)
        return True

    # -- forward runner (KSP2, what-if, TI-LFA) -----------------------------

    @property
    def banded(self) -> Optional[BandedGraph]:
        """The forward circulant-band decomposition (ops.banded
        build_banded), None on a topology without bands; built on first
        use."""
        if not self._banded_built:
            self._banded = build_banded(
                self.edge_src, self.edge_dst, self.n_edges, self.n_nodes
            )
            self._banded_built = True
        return self._banded

    def runner(self, engine) -> SpfRunner:
        """The forward SpfRunner over this mirror's arrays (the bands when
        the topology has them, else the ELL), built on first use.  On
        every call it reads the mirror's resident on `engine`, synced
        (`engine.stage_forward`), so it shares the per-source path's
        device copy.  It reads the same numpy arrays `refresh` rewrites
        in place, so its learned hints survive attribute changes; a
        rewire or a rebuild drops it."""
        if self._runner is None or self._runner_engine is not engine:
            runner = SpfRunner(
                self.ell,
                self.banded,
                self.edge_src,
                self.edge_dst,
                self.edge_metric,
                self.edge_up,
                self.node_overloaded,
                self.n_edges,
            )
            self._runner, self._runner_engine = runner, engine
        engine.stage_forward(self._runner, self)
        return self._runner

    def run_batched_spf(
        self,
        sources: list[str],
        engine,
        use_link_metric: bool = True,
        extra_edge_mask: Optional[np.ndarray] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """One batch of sources through the forward runner on `engine`'s
        device (reference: CsrTopology.run_batched_spf): (dist [S, N*],
        dag [S, E_cap]) as numpy, N* being n_nodes on the banded path and
        node_capacity on the ELL path.  `extra_edge_mask` [S, E_cap] bool
        (False excludes) is the per-row exclusion of a masked batch."""
        src_ids = np.asarray([self.node_id[s] for s in sources], dtype=np.int32)
        return engine.forward(
            self.runner(engine),
            src_ids,
            use_link_metric=use_link_metric,
            extra_edge_mask=extra_edge_mask,
        )

    def spf_from(
        self, sources: list[str], engine, use_link_metric: bool = True
    ) -> dict[str, SpfResult]:
        """Distances, SP-DAG and first hops of `sources` as SpfResults
        (reference: CsrTopology.spf_from).  The port has no engine-less
        path: this is the engine's per-source query."""
        return engine.spf_results(self, sources, use_link_metric=use_link_metric)

    def row_path_links(self, dist_row: np.ndarray, dag_row: np.ndarray) -> SpfResult:
        """One row of a dist/DAG batch as an SpfResult with metrics and
        path_links only, no first hops (reference:
        CsrTopology.row_path_links): the shape `trace_one_path` walks."""
        n, e = self.n_nodes, self.n_edges
        reach = np.flatnonzero(dist_row[:n] < INF32)
        names = self.node_names
        result: SpfResult = {
            names[i]: NodeSpfResult(m)
            for i, m in zip(reach.tolist(), dist_row[reach].tolist())
        }
        links = self.edge_links
        eids = np.flatnonzero(dag_row[:e])
        for eid, v in zip(eids.tolist(), self.edge_dst[eids].tolist()):
            result[names[v]].path_links.append(links[eid])
        self._host_order_path_links(result)
        return result

    def edges_of_links(self) -> dict:
        """Link -> its directed edge ids, both directions (reference:
        CsrTopology.edges_of_links); parallel links map to their own
        edges, retired slots to nothing."""
        out: dict = {}
        for e, lp in enumerate(self.edge_links):
            if lp is not None:
                out.setdefault(lp[0], []).append(e)
        return out

    def _refresh_attributes(self, ls: LinkState) -> None:
        """Re-read metric/up/overload from the shared link objects into
        the arrays, in place.  A retired slot reads as padding (metric 1,
        down), the values it already holds."""
        links = self.edge_links
        e = len(links)
        self.edge_metric[:e] = [
            1 if lp is None else lp[0].metric_from_node(lp[1]) for lp in links
        ]
        self.edge_up[:e] = [lp is not None and lp[0].is_up() for lp in links]
        self.node_overloaded[: self.n_nodes] = [
            ls.is_node_overloaded(name) for name in self.node_names
        ]

    def _slot_link_ids(self) -> np.ndarray:
        """id() of each edge slot's Link, 0 for a retired slot (the
        mirror holds the Links, so no id is reused while it lives)."""
        return _ids(None if lp is None else lp[0] for lp in self.edge_links)

    def _try_rewire(self, ls: LinkState, slot_ids, new_links, new_ids) -> bool:
        """Bounded in-place edge-set change through the slot freelist.

        Retires the removed links' edge slots (styled as padding inside
        [:n_edges]), points recycled or appended slots at the added links,
        re-reads attributes, re-ranks out_slot and re-encodes only the
        affected ELL destination rows — all in the SAME numpy and ELL
        objects — and appends a RewireDelta to the bounded log.

        Returns False, leaving the rebuild to the caller, on a node-set
        change, freelist plus tail exhaustion, an affected ELL row that
        outgrew its bucket's K, or an oversized delta.  A False return
        may leave the arrays partly patched: the rebuild replaces every
        field, so no torn state survives it."""
        if ls.node_names != self.node_names:
            return False
        held = slot_ids != 0
        retiring = np.flatnonzero(held & ~np.isin(slot_ids, new_ids)).tolist()
        added = sorted(
            new_links[k]
            for k in np.flatnonzero(~np.isin(new_ids, slot_ids[held])).tolist()
        )
        if not retiring and not added:
            return False  # count drift without identity drift: rebuild
        pool = sorted(set(self._free_slots) | set(retiring))
        tail = self.edge_capacity - self.n_edges
        if 2 * len(added) > len(pool) + tail:
            return False  # capacity overflow: rebuild (may grow buckets)
        if len(retiring) + 2 * len(added) > self.REWIRE_MAX_SLOTS:
            return False  # oversized delta: the restage is cheaper

        pad_node = self.node_capacity - 1
        touched: list[int] = []
        affected_dst: set[int] = set()
        for s in retiring:
            affected_dst.add(int(self.edge_dst[s]))
            self.edge_src[s] = pad_node
            self.edge_dst[s] = pad_node
            self.edge_metric[s] = 1
            self.edge_up[s] = False
            self.edge_live[s] = False
            self.edge_links[s] = None
            touched.append(s)
        for link in added:
            for u_name in (link.n1, link.n2):
                metric = link.metric_from_node(u_name)
                if metric < 1:
                    raise ValueError("edge metrics must be >= 1")
                if pool:
                    s = pool.pop(0)
                else:
                    s = self.n_edges
                    self.n_edges += 1
                    self.edge_links.append(None)
                self.edge_src[s] = self.node_id[u_name]
                self.edge_dst[s] = self.node_id[link.other_node_name(u_name)]
                self.edge_metric[s] = metric
                self.edge_up[s] = link.is_up()
                self.edge_live[s] = True
                self.edge_links[s] = (link, u_name)
                affected_dst.add(int(self.edge_dst[s]))
                touched.append(s)
        self._free_slots = pool
        self.n_live = int(self.edge_live[: self.n_edges].sum())
        # attribute changes of the same version ride along, so the delta
        # and the ELL rows below read post-refresh state
        self._refresh_attributes(ls)

        # re-encode the affected ELL destination rows; the relabelling is
        # frozen at build time, so a node's row never moves
        new_of_old = self.ell.new_of_old
        row_lo = []
        lo = 0
        for b in self.ell.buckets:
            row_lo.append(lo)
            lo += b.nbr.shape[0]
        dst_v = self.edge_dst[: self.n_edges]
        live_v = self.edge_live[: self.n_edges]
        rows_patch = []
        for d in sorted(affected_dst):
            eids = np.flatnonzero((dst_v == d) & live_v)
            r = int(new_of_old[d])
            b_idx = bisect.bisect_right(row_lo, r) - 1
            k_cap = self.ell.buckets[b_idx].nbr.shape[1]
            if len(eids) > k_cap:
                return False  # in-degree outgrew the row's K headroom
            row_nbr = np.zeros(k_cap, dtype=np.int32)
            row_w = np.ones(k_cap, dtype=np.int32)
            row_eid = np.full(k_cap, -1, dtype=np.int32)
            row_ok = np.zeros(k_cap, dtype=bool)
            row_tok = np.zeros(k_cap, dtype=bool)
            k = len(eids)
            if k:
                row_nbr[:k] = new_of_old[self.edge_src[eids]]
                row_w[:k] = self.edge_metric[eids]
                row_eid[:k] = eids.astype(np.int32)
                row_ok[:k] = self.edge_up[eids]
                row_tok[:k] = ~self.node_overloaded[self.edge_src[eids]]
            rows_patch.append(
                (b_idx, r - row_lo[b_idx], row_nbr, row_w, row_eid,
                 row_ok, row_tok)
            )
        for b_idx, lr, rn, rw, re_, ro, rt in rows_patch:
            bkt = self.ell.buckets[b_idx]
            bkt.nbr[lr] = rn
            bkt.w[lr] = rw
            bkt.edge_id[lr] = re_
            bkt.ok[lr] = ro
            bkt.transit_ok[lr] = rt

        new_out, new_max = _build_out_slots(
            self.edge_src, self.edge_dst, self.n_edges, live=self.edge_live
        )
        out_changed = np.flatnonzero(new_out != self.out_slot).astype(np.int32)
        self.out_slot[:] = new_out
        self.max_out_slots = new_max
        # the bands follow the live edges: rebuilt with the runner on use
        self._banded_built = False
        self._banded = None
        self._runner = None

        # a slot retired and recycled in the same rewire is touched twice;
        # the delta reads the final state, so its indices are unique
        slots_v = np.asarray(sorted(set(touched)), dtype=np.int32)
        self.rewire_seq += 1
        self._rewire_log.append(
            RewireDelta(
                seq=self.rewire_seq,
                version=ls.version,
                slots=slots_v,
                src=self.edge_src[slots_v].copy(),
                dst=self.edge_dst[slots_v].copy(),
                metric=self.edge_metric[slots_v].copy(),
                up=self.edge_up[slots_v].copy(),
                live=self.edge_live[slots_v].copy(),
                out_idx=out_changed,
                out_val=new_out[out_changed].copy(),
                ell_rows=rows_patch,
                n_edges=self.n_edges,
                max_out_slots=new_max,
                links_added=len(added),
                links_removed=len(retiring) // 2,
            )
        )
        del self._rewire_log[: -self.REWIRE_LOG_DEPTH]
        self.version = ls.version
        return True

    # -- result reconstruction (parity with the host Dijkstra) --------------

    def slot_neighbors(self, node: str) -> list[str]:
        """Sorted unique out-neighbor names of `node` — the slot order of
        the first-hop bitmaps (ids are assigned in sorted-name order, so
        id rank == name rank).  Retired slots point at the padding node
        and never match."""
        e = self.n_edges
        mine = self.edge_src[:e] == self.node_id[node]
        return [self.node_names[j] for j in np.unique(self.edge_dst[:e][mine])]

    def to_spf_results(
        self,
        sources: list[str],
        dist: np.ndarray,  # [S, N_cap] int32
        dag: np.ndarray,  # [S, E_cap] bool
        nh_words: np.ndarray,  # [S, N_cap, W] int32 (uint32 bit patterns)
    ) -> dict[str, SpfResult]:
        """Device output as the host Dijkstra's SpfResults: per reachable
        node its metric, its tie-retaining path_links in the Dijkstra's
        append order, and its first-hop `next_hops` decoded from the
        bitmaps (reference: CsrTopology.to_spf_results with nh_words).

        Host work is O(reachable + DAG edges): next-hop sets are decoded
        once per distinct word row.  The decode allocates a few acyclic
        objects per reachable node, so the cyclic garbage collector is
        paused meanwhile: its full collections would walk the whole heap
        and find nothing to free."""
        with _gc_paused():
            return {
                src: self._spf_result(src, dist[row], dag[row], nh_words[row])
                for row, src in enumerate(sources)
            }

    def _spf_result(self, src_name, dist_row, dag_row, words) -> SpfResult:
        names = self.node_names
        n, e = self.n_nodes, self.n_edges
        d = dist_row[:n]
        reach = np.flatnonzero(d < INF32)
        # next-hop sets: decode each distinct word row once
        w = words[reach].view(np.uint32)
        if w.shape[1] == 1:
            uniq, inv = np.unique(w[:, 0], return_inverse=True)
            uniq = uniq[:, None]
        else:
            uniq, inv = np.unique(w, axis=0, return_inverse=True)
        slot_names = self.slot_neighbors(src_name)
        hop_sets = []
        for ws in uniq.tolist():
            hops = []
            for k, bits in enumerate(ws):
                while bits:
                    b = bits & -bits
                    hops.append(slot_names[32 * k + b.bit_length() - 1])
                    bits ^= b
            hop_sets.append(hops)
        inv = inv.ravel()
        # the source's own entry has no next hops
        inv[reach == self.node_id[src_name]] = len(hop_sets)
        hop_sets.append(())
        nodes = [
            NodeSpfResult(m, [], set(hop_sets[k]))
            for m, k in zip(d[reach].tolist(), inv.tolist())
        ]
        # path links from DAG edges, in host-Dijkstra append order
        pos = np.empty(n, dtype=np.int64)
        pos[reach] = np.arange(len(reach))
        eids = np.flatnonzero(dag_row[:e])
        links = self.edge_links
        for j, eid in zip(pos[self.edge_dst[eids]].tolist(), eids.tolist()):
            nodes[j].path_links.append(links[eid])
        result = dict(zip([names[i] for i in reach.tolist()], nodes))
        self._host_order_path_links(result)
        return result

    @staticmethod
    def _host_order_path_links(result: SpfResult) -> None:
        """Order each node's path_links as the host Dijkstra appends them
        — by (dist(prev), prev_name, link): run_spf pops the heap by
        (metric, node name) and walks each node's links sorted."""
        for res in result.values():
            if len(res.path_links) > 1:
                res.path_links.sort(
                    key=lambda lp: (result[lp[1]].metric, lp[1], lp[0])
                )
