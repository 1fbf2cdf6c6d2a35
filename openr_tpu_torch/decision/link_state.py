"""Link-state graph: the host-side topology model.

Port of `openr_tpu.decision.link_state` (reference:
openr/decision/LinkState.{h,cpp}):

- only bidirectional links exist (both ends advertise the adjacency with
  matching interface names — maybeMakeLink, LinkState.cpp:703)
- ordered-FIB holds (HoldableValue, LinkState.cpp:53-120) on link
  metrics, link overloads, node overloads and new links' hold-up TTL:
  every reader (the host Dijkstra, the CSR mirror's refresh, the route
  build) sees the HELD value, and `decrement_holds` reports the expiry
  as a topology change, which bumps `version`.  Values are plain
  attributes; a HoldableValue exists only while its value is held, so a
  100k-node graph carries no object per link for holds it does not have
- updateAdjacencyDatabase diffs the ordered link sets (LinkState.cpp:565-717)
  and updates the updating node's end of a surviving link on the existing
  Link object, so a CSR mirror that holds the object re-reads it in place;
  it reports a LinkStateChange, and only a topology change (or a new
  node) bumps `version`: next-hop addresses and adjacency labels change
  in place without a bump, and a surviving link keeps its weight
- the host Dijkstra keeps ECMP ties (runSpf, LinkState.cpp:809-878) and
  can ignore a set of links; k edge-disjoint shortest paths
  (getKthPaths, LinkState.cpp:763-793) re-run it with the earlier
  paths' links ignored and trace paths out of its path_links
  (`trace_one_path`), memoized until the next version bump

The Dijkstra is the host SPF backend (decision.spf_solver.HostSpfBackend)
and the oracle the tests and the chip smoke run hold the device paths
against.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Generic, Optional, TypeVar

from ..types import Adjacency, AdjacencyDatabase

T = TypeVar("T")


class HoldableValue(Generic[T]):
    """Reference: openr/decision/LinkState.cpp:53-120.

    update_value() holds the previous value for `ttl` decrements (the
    hold-up TTL when the change brings things up: a lower metric or an
    overload cleared; the hold-down TTL otherwise); an update while a
    hold is active cancels the hold (fast fallback)."""

    __slots__ = ("_val", "_held_val", "_hold_ttl")

    _NO_HOLD = object()  # the held value may be False or 0

    def __init__(self, val: T) -> None:
        self._val = val
        self._held_val = HoldableValue._NO_HOLD
        self._hold_ttl = 0

    @staticmethod
    def _is_bringing_up(old, new) -> bool:
        if isinstance(old, bool):
            return old and not new
        return new < old

    @property
    def value(self) -> T:
        return self._val if self._held_val is HoldableValue._NO_HOLD else self._held_val

    def has_hold(self) -> bool:
        return self._held_val is not HoldableValue._NO_HOLD

    def decrement_ttl(self) -> bool:
        """True iff the hold expired on this decrement."""
        if self.has_hold():
            self._hold_ttl -= 1
            if self._hold_ttl == 0:
                self._held_val = HoldableValue._NO_HOLD
                return True
        return False

    def update_value(self, val: T, hold_up_ttl: int, hold_down_ttl: int) -> bool:
        """True iff the *visible* value changed."""
        if val == self._val:
            return False
        if self.has_hold():
            # fall back to a fast update to avoid longer transient loops
            self._held_val = HoldableValue._NO_HOLD
            self._hold_ttl = 0
        else:
            ttl = hold_up_ttl if self._is_bringing_up(self._val, val) else hold_down_ttl
            if ttl != 0:
                self._held_val = self._val
                self._hold_ttl = ttl
        self._val = val
        return not self.has_hold()


def _hold_update(holds: dict, key, visible, val, hold_up_ttl, hold_down_ttl):
    """HoldableValue.update_value on a value shown as `visible` whose
    active hold, if any, is holds[key]: (the new visible value, whether
    it changed).  A HoldableValue lives in `holds` only while it holds,
    so a value without a hold costs no object."""
    hv = holds.get(key) or HoldableValue(visible)
    changed = hv.update_value(val, hold_up_ttl, hold_down_ttl)
    if hv.has_hold():
        holds[key] = hv
    else:
        holds.pop(key, None)
    return hv.value, changed


def _decrement_holds(holds: dict, store) -> bool:
    """One decrement of every hold in `holds`; an expired hold leaves it
    and `store(key, value)` shows its new value.  True iff one expired."""
    expired = False
    for key, hv in list(holds.items()):
        if hv.decrement_ttl():
            store(key, hv.value)
            del holds[key]
            expired = True
    return expired


class Link:
    """A single bidirectional link, one object shared by both endpoint
    nodes; keyed by the ordered pair of (node, iface) pairs.  `metric1`,
    `metric2`, `overload1` and `overload2` are the visible (held) values;
    `_holds` maps those of them under an ordered-FIB hold to their
    HoldableValue, and is None without holds."""

    __slots__ = (
        "area",
        "n1",
        "n2",
        "if1",
        "if2",
        "metric1",
        "metric2",
        "overload1",
        "overload2",
        "_holds",
        "adj_label1",
        "adj_label2",
        "nh_v4_1",
        "nh_v4_2",
        "nh_v6_1",
        "nh_v6_2",
        "weight1",
        "weight2",
        "_hold_up_ttl",
        "ordered_names",
        "_hash",
    )

    def __init__(
        self,
        area: str,
        node1: str,
        adj1: Adjacency,
        node2: str,
        adj2: Adjacency,
        metric_inc1: int = 0,
        metric_inc2: int = 0,
    ) -> None:
        self.area = area
        self.n1 = node1
        self.n2 = node2
        self.if1 = adj1.if_name
        self.if2 = adj2.if_name
        # soft-drain: each endpoint's nodeMetricIncrementVal is folded
        # into the metric it originates
        self.metric1 = adj1.metric + metric_inc1
        self.metric2 = adj2.metric + metric_inc2
        self.overload1 = adj1.is_overloaded
        self.overload2 = adj2.is_overloaded
        self._holds: Optional[dict[str, HoldableValue]] = None
        self.adj_label1 = adj1.adj_label
        self.adj_label2 = adj2.adj_label
        self.nh_v4_1 = adj1.next_hop_v4
        self.nh_v4_2 = adj2.next_hop_v4
        self.nh_v6_1 = adj1.next_hop_v6
        self.nh_v6_2 = adj2.next_hop_v6
        self.weight1 = adj1.weight
        self.weight2 = adj2.weight
        self._hold_up_ttl = 0
        a, b = (self.n1, self.if1), (self.n2, self.if2)
        self.ordered_names = (a, b) if a <= b else (b, a)
        self._hash = hash(self.ordered_names)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Link)
            and self.ordered_names == other.ordered_names
        )

    def __lt__(self, other: "Link") -> bool:
        return self.ordered_names < other.ordered_names

    def __repr__(self) -> str:
        return (
            f"Link({self.area} - {self.n1}%{self.if1} <---> "
            f"{self.n2}%{self.if2})"
        )

    def _first(self, node: str) -> bool:
        if node == self.n1:
            return True
        if node == self.n2:
            return False
        raise ValueError(f"{node} not an endpoint of {self!r}")

    def other_node_name(self, node: str) -> str:
        return self.n2 if self._first(node) else self.n1

    def first_node_name(self) -> str:
        return self.ordered_names[0][0]

    def second_node_name(self) -> str:
        return self.ordered_names[1][0]

    def iface_from_node(self, node: str) -> str:
        return self.if1 if self._first(node) else self.if2

    def metric_from_node(self, node: str) -> int:
        return self.metric1 if self._first(node) else self.metric2

    def adj_label_from_node(self, node: str) -> int:
        return self.adj_label1 if self._first(node) else self.adj_label2

    def nh_v4_from_node(self, node: str) -> str:
        return self.nh_v4_1 if self._first(node) else self.nh_v4_2

    def nh_v6_from_node(self, node: str) -> str:
        return self.nh_v6_1 if self._first(node) else self.nh_v6_2

    def weight_from_node(self, node: str) -> int:
        return self.weight1 if self._first(node) else self.weight2

    def overload_from_node(self, node: str) -> bool:
        return self.overload1 if self._first(node) else self.overload2

    def _set_from_node(self, node: str, attr: str, value) -> None:
        """Set `attr` ("adj_label", "nh_v4_", "nh_v6_") of `node`'s end."""
        setattr(self, attr + ("1" if self._first(node) else "2"), value)

    def _update_held(self, attr: str, val, hold_up_ttl: int, hold_down_ttl: int) -> bool:
        holds = self._holds if self._holds is not None else {}
        visible, changed = _hold_update(
            holds, attr, getattr(self, attr), val, hold_up_ttl, hold_down_ttl
        )
        setattr(self, attr, visible)
        self._holds = holds or None
        return changed

    def set_metric_from_node(
        self, node: str, metric: int, hold_up_ttl: int, hold_down_ttl: int
    ) -> bool:
        """True iff the visible metric changed."""
        attr = "metric1" if self._first(node) else "metric2"
        return self._update_held(attr, metric, hold_up_ttl, hold_down_ttl)

    def set_overload_from_node(
        self, node: str, overload: bool, hold_up_ttl: int, hold_down_ttl: int
    ) -> bool:
        """True iff the link went up or down (simplex overloads are not
        supported)."""
        was_up = self.is_up()
        attr = "overload1" if self._first(node) else "overload2"
        self._update_held(attr, overload, hold_up_ttl, hold_down_ttl)
        return was_up != self.is_up()

    # -- holds (reference: LinkState.h:82-175) ------------------------------

    def set_hold_up_ttl(self, ttl: int) -> None:
        self._hold_up_ttl = ttl

    def is_up(self) -> bool:
        return self._hold_up_ttl == 0 and not self.overload1 and not self.overload2

    def decrement_holds(self) -> bool:
        """True iff a hold of this link expired."""
        expired = False
        if self._hold_up_ttl != 0:
            self._hold_up_ttl -= 1
            expired = self._hold_up_ttl == 0
        if self._holds:
            expired |= _decrement_holds(
                self._holds, lambda attr, val: setattr(self, attr, val)
            )
            self._holds = self._holds or None
        return expired

    def has_holds(self) -> bool:
        return self._hold_up_ttl != 0 or self._holds is not None


@dataclass(slots=True)
class LinkStateChange:
    """What one database update changed (reference:
    LinkState::LinkStateChange, LinkState.h:306)."""

    topology_changed: bool = False
    link_attributes_changed: bool = False
    node_label_changed: bool = False


@dataclass(slots=True)
class NodeSpfResult:
    """path_links: (link, prev_node) SP-DAG in-edges toward this node;
    next_hops: first-hop neighbor names of shortest paths from the
    source."""

    metric: float
    path_links: list[tuple[Link, str]] = field(default_factory=list)
    next_hops: set[str] = field(default_factory=set)


SpfResult = dict[str, NodeSpfResult]
Path = list[Link]


def trace_one_path(
    src: str, dest: str, result: SpfResult, links_to_ignore: set
) -> Optional[Path]:
    """One shortest path from `src` to `dest` through `result`'s
    path_links that uses no link of `links_to_ignore`, consuming its
    links (reference: LinkState::traceOnePath, LinkState.cpp:399-418).
    Works on any SpfResult: the host Dijkstra's or one decoded from a
    device run (csr.row_path_links)."""
    if src == dest:
        return []
    for link, prev_node in result[dest].path_links:
        if link in links_to_ignore:
            continue
        links_to_ignore.add(link)
        path = trace_one_path(src, prev_node, result, links_to_ignore)
        if path is not None:
            path.append(link)
            return path
    return None


def path_a_in_path_b(a: Path, b: Path) -> bool:
    """True when path `a` appears contiguously inside path `b`
    (reference: LinkState::pathAInPathB, LinkState.h:396)."""
    if len(a) > len(b):
        return False
    return any(
        all(a[j] == b[i + j] for j in range(len(a)))
        for i in range(len(b) - len(a) + 1)
    )


class LinkState:
    """Host-side link-state graph for one area."""

    def __init__(self, area: str = "0") -> None:
        self.area = area
        self._link_map: dict[str, set[Link]] = {}
        self._all_links: set[Link] = set()
        self._node_overloads: dict[str, bool] = {}  # visible (held) values
        self._node_overload_holds: dict[str, HoldableValue] = {}
        self._adjacency_databases: dict[str, AdjacencyDatabase] = {}
        self._spf_results: dict[tuple[str, bool], SpfResult] = {}
        self._kth_path_results: dict[tuple[str, str, int], list[Path]] = {}
        # bumped on every change the CSR mirror must see
        self._version = 0

    # -- read API -----------------------------------------------------------

    def has_node(self, node: str) -> bool:
        return node in self._adjacency_databases

    def links_from_node(self, node: str) -> set[Link]:
        return self._link_map.get(node, set())

    def ordered_links_from_node(self, node: str) -> list[Link]:
        return sorted(self._link_map.get(node, set()))

    def is_node_overloaded(self, node: str) -> bool:
        return self._node_overloads.get(node, False)

    @property
    def all_links(self) -> set[Link]:
        return self._all_links

    def num_links(self) -> int:
        return len(self._all_links)

    def num_nodes(self) -> int:
        return len(self._link_map)

    def get_adjacency_databases(self) -> dict[str, AdjacencyDatabase]:
        return self._adjacency_databases

    @property
    def node_names(self) -> list[str]:
        return sorted(
            set(self._adjacency_databases.keys()) | set(self._link_map.keys())
        )

    @property
    def version(self) -> int:
        return self._version

    def has_holds(self) -> bool:
        return bool(self._node_overload_holds) or any(
            link.has_holds() for link in self._all_links
        )

    # -- graph mutation (reference: LinkState.cpp:421-447,565-737) ----------

    def _add_link(self, link: Link) -> None:
        self._link_map.setdefault(link.first_node_name(), set()).add(link)
        self._link_map.setdefault(link.second_node_name(), set()).add(link)
        self._all_links.add(link)

    def _remove_link(self, link: Link) -> None:
        self._link_map[link.first_node_name()].discard(link)
        self._link_map[link.second_node_name()].discard(link)
        self._all_links.discard(link)

    def _remove_node(self, node: str) -> None:
        for link in self._link_map.pop(node, set()):
            self._link_map.get(link.other_node_name(node), set()).discard(link)
            self._all_links.discard(link)
        self._node_overloads.pop(node, None)
        self._node_overload_holds.pop(node, None)

    def _update_node_overloaded(
        self, node: str, is_overloaded: bool, hold_up_ttl: int, hold_down_ttl: int
    ) -> bool:
        visible = self._node_overloads.get(node)
        if visible is None:
            self._node_overloads[node] = is_overloaded
            return False  # a new node is not a link-state change
        visible, changed = _hold_update(
            self._node_overload_holds, node, visible, is_overloaded,
            hold_up_ttl, hold_down_ttl,
        )
        self._node_overloads[node] = visible
        return changed

    def _maybe_make_link(self, node: str, adj: Adjacency) -> Optional[Link]:
        """Only bidirectional links: the far node must advertise the
        reverse adjacency with matching interface names."""
        other_db = self._adjacency_databases.get(adj.other_node_name)
        if other_db is None:
            return None
        for other_adj in other_db.adjacencies:
            if (
                node == other_adj.other_node_name
                and adj.other_if_name == other_adj.if_name
                and adj.if_name == other_adj.other_if_name
            ):
                return Link(
                    self.area,
                    node,
                    adj,
                    adj.other_node_name,
                    other_adj,
                    metric_inc1=self._metric_increment(node),
                    metric_inc2=self._metric_increment(adj.other_node_name),
                )
        return None

    def _metric_increment(self, node: str) -> int:
        db = self._adjacency_databases.get(node)
        return db.node_metric_increment_val if db is not None else 0

    def _invalidate(self) -> None:
        self._spf_results.clear()
        self._kth_path_results.clear()
        self._version += 1

    def update_adjacency_database(
        self,
        new_adj_db: AdjacencyDatabase,
        hold_up_ttl: int = 0,
        hold_down_ttl: int = 0,
    ) -> LinkStateChange:
        """Apply one node's adjacency database (reference:
        updateAdjacencyDatabase, LinkState.cpp:565-717).

        A new node bumps `version` once for the node set.  The topology
        changed when the node's visible overload bit flipped, an up link
        came or went, or a surviving link's visible metric from this node
        changed or its overload took it up or down; that bumps `version`
        again.  With hold TTLs, a new link comes up only after
        `hold_up_ttl` decrements, and a changed metric or overload keeps
        its old value for the hold-up TTL (a change that brings things
        up) or the hold-down TTL (one that takes them down); a held change
        is no topology change until `decrement_holds` expires it.  A new
        next-hop address or adjacency label of this node's end is written
        in place as a link attribute change, without a bump; the node
        label's change is reported alone.  A surviving link keeps its
        weight."""
        node = new_adj_db.this_node_name
        if new_adj_db.area != self.area:
            raise ValueError(
                f"adjacency database of area {new_adj_db.area!r} given to "
                f"the link state of area {self.area!r}"
            )
        change = LinkStateChange()
        prior_db = self._adjacency_databases.get(node)
        self._adjacency_databases[node] = new_adj_db
        if prior_db is None:
            # the node set changed: the mirror must re-intern its names
            self._version += 1
        change.topology_changed |= self._update_node_overloaded(
            node, new_adj_db.is_overloaded, hold_up_ttl, hold_down_ttl
        )
        prior_label = prior_db.node_label if prior_db is not None else 0
        change.node_label_changed = prior_label != new_adj_db.node_label

        old_links = set(self.links_from_node(node))
        new_links = {
            link
            for link in (
                self._maybe_make_link(node, adj)
                for adj in new_adj_db.adjacencies
            )
            if link is not None
        }
        for link in old_links - new_links:
            change.topology_changed |= link.is_up()
            self._remove_link(link)
        by_key = {link: link for link in old_links}
        for link in new_links:
            old = by_key.get(link)
            if old is None:
                link.set_hold_up_ttl(hold_up_ttl)
                change.topology_changed |= link.is_up()
                self._add_link(link)
                continue
            # same (node, iface) pairs: update this node's end of the
            # existing object, whose identity the CSR mirror keys on
            metric = link.metric_from_node(node)
            if metric != old.metric_from_node(node):
                change.topology_changed |= old.set_metric_from_node(
                    node, metric, hold_up_ttl, hold_down_ttl
                )
            overload = link.overload_from_node(node)
            if overload != old.overload_from_node(node):
                change.topology_changed |= old.set_overload_from_node(
                    node, overload, hold_up_ttl, hold_down_ttl
                )
            for attr, get in (
                ("adj_label", Link.adj_label_from_node),
                ("nh_v4_", Link.nh_v4_from_node),
                ("nh_v6_", Link.nh_v6_from_node),
            ):
                if get(link, node) != get(old, node):
                    old._set_from_node(node, attr, get(link, node))
                    change.link_attributes_changed = True
        if change.topology_changed:
            self._invalidate()
        return change

    def delete_adjacency_database(self, node: str) -> LinkStateChange:
        """Forget `node` and its links (reference:
        LinkState::deleteAdjacencyDatabase)."""
        change = LinkStateChange()
        if node in self._adjacency_databases:
            self._remove_node(node)
            del self._adjacency_databases[node]
            self._invalidate()
            change.topology_changed = True
        return change

    def decrement_holds(self) -> LinkStateChange:
        """One ordered-FIB step: every hold's TTL down by one; an expired
        hold is a topology change (reference: LinkState::decrementHolds)."""
        change = LinkStateChange()
        for link in self._all_links:
            change.topology_changed |= link.decrement_holds()
        change.topology_changed |= _decrement_holds(
            self._node_overload_holds, self._node_overloads.__setitem__
        )
        if change.topology_changed:
            self._invalidate()
        return change

    # -- SPF (reference: runSpf, LinkState.cpp:809-878) ---------------------

    def run_spf(
        self,
        src: str,
        use_link_metric: bool = True,
        links_to_ignore: Optional[set] = None,
    ) -> SpfResult:
        """Dijkstra with ECMP tie retention — the conformance oracle.

        Pop order is (metric, node_name); the relax step uses >= so all
        equal-cost predecessors and next hops are kept.  Overloaded nodes
        other than the source are recorded but never relaxed from.
        Without `use_link_metric` every link costs 1 (hop counts); links
        in `links_to_ignore` are treated as down."""
        links_to_ignore = links_to_ignore or set()
        result: SpfResult = {}
        pending: dict[str, NodeSpfResult] = {src: NodeSpfResult(0)}
        heap: list[tuple[float, str]] = [(0, src)]
        while heap:
            metric, node = heapq.heappop(heap)
            state = pending.get(node)
            if state is None or node in result or metric > state.metric:
                continue  # stale heap entry
            result[node] = state
            del pending[node]
            if self.is_node_overloaded(node) and node != src:
                continue  # no transit through a drained node
            for link in sorted(self.links_from_node(node)):
                other = link.other_node_name(node)
                if not link.is_up() or other in result or link in links_to_ignore:
                    continue
                cand = metric + (
                    link.metric_from_node(node) if use_link_metric else 1
                )
                other_state = pending.get(other)
                if other_state is None:
                    other_state = pending[other] = NodeSpfResult(cand)
                    heapq.heappush(heap, (cand, other))
                if other_state.metric >= cand:
                    if other_state.metric > cand:
                        other_state.metric = cand
                        other_state.path_links = []
                        other_state.next_hops = set()
                        heapq.heappush(heap, (cand, other))
                    other_state.path_links.append((link, node))
                    other_state.next_hops |= state.next_hops
                    if not other_state.next_hops:
                        other_state.next_hops.add(other)  # directly connected
        return result

    def get_spf_result(self, node: str, use_link_metric: bool = True) -> SpfResult:
        key = (node, use_link_metric)
        res = self._spf_results.get(key)
        if res is None:
            res = self._spf_results[key] = self.run_spf(node, use_link_metric)
        return res

    def get_metric_from_a_to_b(
        self, a: str, b: str, use_link_metric: bool = True
    ) -> Optional[float]:
        if a == b:
            return 0
        res = self.get_spf_result(a, use_link_metric)
        return res[b].metric if b in res else None

    def get_hops_from_a_to_b(self, a: str, b: str) -> Optional[float]:
        return self.get_metric_from_a_to_b(a, b, use_link_metric=False)

    def get_max_hops_to_node(self, node: str) -> int:
        res = self.get_spf_result(node, use_link_metric=False)
        return max((int(r.metric) for r in res.values()), default=0)

    # -- k edge-disjoint paths (reference: LinkState.cpp:399-418,763-793) ---

    def get_kth_paths(self, src: str, dest: str, k: int) -> list[Path]:
        """The k-th set of edge-disjoint shortest paths from `src` to
        `dest`: Dijkstra with every link of the sets 1..k-1 ignored, then
        paths traced out of its path_links until none is left (reference:
        LinkState::getKthPaths).  Memoized until the next version bump."""
        if k < 1:
            raise ValueError(f"k must be at least 1, not {k}")
        key = (src, dest, k)
        cached = self._kth_path_results.get(key)
        if cached is not None:
            return cached
        links_to_ignore: set = set()
        for i in range(1, k):
            for path in self.get_kth_paths(src, dest, i):
                links_to_ignore.update(path)
        res = (
            self.run_spf(src, True, links_to_ignore)
            if links_to_ignore
            else self.get_spf_result(src, True)
        )
        paths: list[Path] = []
        if dest in res:
            visited: set = set()
            while path := trace_one_path(src, dest, res, visited):
                paths.append(path)
        self._kth_path_results[key] = paths
        return paths
