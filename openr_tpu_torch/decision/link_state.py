"""Link-state graph: the host-side topology model.

Port of `openr_tpu.decision.link_state` (reference:
openr/decision/LinkState.{h,cpp}) without the ordered-FIB holds and the
k-path machinery, which later slices bring:

- only bidirectional links exist (both ends advertise the adjacency with
  matching interface names — maybeMakeLink, LinkState.cpp:703)
- updateAdjacencyDatabase diffs the ordered link sets (LinkState.cpp:565-717)
- the host Dijkstra keeps ECMP ties (runSpf, LinkState.cpp:809-878)

The Dijkstra is the oracle the tests and the chip smoke run hold the
fleet product against; it never serves a route.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional

from ..types import Adjacency, AdjacencyDatabase


class Link:
    """A single bidirectional link, one object shared by both endpoint
    nodes; keyed by the ordered pair of (node, iface) pairs."""

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
        "adj_label1",
        "adj_label2",
        "nh_v4_1",
        "nh_v4_2",
        "nh_v6_1",
        "nh_v6_2",
        "weight1",
        "weight2",
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
        self.adj_label1 = adj1.adj_label
        self.adj_label2 = adj2.adj_label
        self.nh_v4_1 = adj1.next_hop_v4
        self.nh_v4_2 = adj2.next_hop_v4
        self.nh_v6_1 = adj1.next_hop_v6
        self.nh_v6_2 = adj2.next_hop_v6
        self.weight1 = adj1.weight
        self.weight2 = adj2.weight
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

    def is_up(self) -> bool:
        return not self.overload1 and not self.overload2


@dataclass(slots=True)
class NodeSpfResult:
    """path_links: (link, prev_node) SP-DAG in-edges toward this node;
    next_hops: first-hop neighbor names of shortest paths from the
    source."""

    metric: float
    path_links: list[tuple[Link, str]] = field(default_factory=list)
    next_hops: set[str] = field(default_factory=set)


SpfResult = dict[str, NodeSpfResult]


class LinkState:
    """Host-side link-state graph for one area."""

    def __init__(self, area: str = "0") -> None:
        self.area = area
        self._link_map: dict[str, set[Link]] = {}
        self._all_links: set[Link] = set()
        self._node_overloads: dict[str, bool] = {}
        self._adjacency_databases: dict[str, AdjacencyDatabase] = {}
        self._spf_results: dict[str, SpfResult] = {}
        # bumped on every change the CSR mirror must see
        self._version = 0

    # -- read API -----------------------------------------------------------

    def has_node(self, node: str) -> bool:
        return node in self._adjacency_databases

    def links_from_node(self, node: str) -> set[Link]:
        return self._link_map.get(node, set())

    def is_node_overloaded(self, node: str) -> bool:
        return self._node_overloads.get(node, False)

    @property
    def all_links(self) -> set[Link]:
        return self._all_links

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

    # -- graph mutation (reference: LinkState.cpp:421-447,565-737) ----------

    def _add_link(self, link: Link) -> None:
        self._link_map.setdefault(link.first_node_name(), set()).add(link)
        self._link_map.setdefault(link.second_node_name(), set()).add(link)
        self._all_links.add(link)

    def _remove_link(self, link: Link) -> None:
        self._link_map[link.first_node_name()].discard(link)
        self._link_map[link.second_node_name()].discard(link)
        self._all_links.discard(link)

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
        self._version += 1

    def update_adjacency_database(self, new_adj_db: AdjacencyDatabase) -> bool:
        """Apply one node's adjacency database; returns True when the
        topology changed (reference: updateAdjacencyDatabase)."""
        node = new_adj_db.this_node_name
        if new_adj_db.area != self.area:
            raise ValueError(
                f"adjacency database of area {new_adj_db.area!r} given to "
                f"the link state of area {self.area!r}"
            )
        prior_db = self._adjacency_databases.get(node)
        self._adjacency_databases[node] = new_adj_db
        changed = prior_db is None
        old_ov = self._node_overloads.get(node)
        self._node_overloads[node] = new_adj_db.is_overloaded
        changed |= old_ov is not None and old_ov != new_adj_db.is_overloaded

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
            self._remove_link(link)
            changed = True
        by_key = {link: link for link in old_links}
        for link in new_links:
            old = by_key.get(link)
            if old is None:
                self._add_link(link)
                changed = True
            elif _link_attrs(old) != _link_attrs(link):
                # same (node, iface) pairs, new attributes: replace
                self._remove_link(old)
                self._add_link(link)
                changed = True
        if changed:
            self._invalidate()
        return changed

    # -- SPF (reference: runSpf, LinkState.cpp:809-878) ---------------------

    def run_spf(self, src: str) -> SpfResult:
        """Dijkstra with ECMP tie retention — the conformance oracle.

        Pop order is (metric, node_name); the relax step uses >= so all
        equal-cost predecessors and next hops are kept.  Overloaded nodes
        other than the source are recorded but never relaxed from."""
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
                if not link.is_up() or other in result:
                    continue
                cand = metric + link.metric_from_node(node)
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

    def get_spf_result(self, node: str) -> SpfResult:
        res = self._spf_results.get(node)
        if res is None:
            res = self._spf_results[node] = self.run_spf(node)
        return res


def _link_attrs(link: Link) -> tuple:
    return (
        link.metric1,
        link.metric2,
        link.overload1,
        link.overload2,
        link.adj_label1,
        link.adj_label2,
        link.nh_v4_1,
        link.nh_v4_2,
        link.nh_v6_1,
        link.nh_v6_2,
        link.weight1,
        link.weight2,
    )
