"""SpfSolver: per-prefix route construction over the fleet product.

Port of `openr_tpu.decision.spf_solver` (reference:
SpfSolver::SpfSolverImpl, openr/decision/Decision.cpp:164-1395) for the
fleet route build: reachability filtering, best-route selection,
drained-node filtering, SP_ECMP next hops (IP and SR_MPLS forwarding),
min-nexthop thresholds and MPLS node-label routes, all answered from the
per-area FleetRouteView instead of per-source SPF.

Not ported yet, and refused with NotImplementedError when a route needs
them: KSP2_ED_ECMP, UCMP weights, BGP best-path selection, static routes
and adjacency-label routes.  Where the reference solver catches a fleet
failure and serves per-source from its host oracle, this solver raises.
"""

from __future__ import annotations

import ipaddress
from typing import Optional

from ..device.engine import DeviceResidencyEngine
from ..types import (
    MplsAction,
    MplsActionCode,
    NextHop,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    PrefixType,
    normalize_prefix,
)
from .fleet import FleetRouteView, FleetViewCache, fleet_destinations
from .link_state import LinkState
from .prefix_state import NodeAndArea, PrefixEntries, PrefixState
from .rib import DecisionRouteDb, RibMplsEntry, RibUnicastEntry
from ..ops.sssp import INF32

MPLS_LABEL_MIN = 16
MPLS_LABEL_MAX = (1 << 20) - 1


def is_mpls_label_valid(label: int) -> bool:
    """Reference: isMplsLabelValid (openr/common/Util.h)."""
    return MPLS_LABEL_MIN <= label <= MPLS_LABEL_MAX


def select_best_prefix_metrics(entries: PrefixEntries) -> set[NodeAndArea]:
    """Reference: selectBestPrefixMetrics (openr/common/Util.h:434,493):
    ordered compare on (path_preference desc, source_preference desc,
    distance asc); ties all kept."""
    best: Optional[tuple[int, int, int]] = None
    best_keys: set[NodeAndArea] = set()
    for key, entry in entries.items():
        m = entry.metrics
        t = (m.path_preference, m.source_preference, -m.distance)
        if best is None or t > best:
            best = t
            best_keys = {key}
        elif t == best:
            best_keys.add(key)
    return best_keys


def select_best_node_area(
    all_node_areas: set[NodeAndArea], my_node_name: str
) -> NodeAndArea:
    """Deterministic representative: prefer self, else smallest key
    (reference: selectBestNodeArea, openr/common/Util.cpp:902)."""
    for node_area in sorted(all_node_areas):
        if node_area[0] == my_node_name:
            return node_area
    return min(all_node_areas)


class BestRouteSelectionResult:
    """Reference: BestRouteSelectionResult (openr/decision/Decision.h:96)."""

    __slots__ = ("all_node_areas", "best_node_area")

    def __init__(self) -> None:
        self.all_node_areas: set[NodeAndArea] = set()
        self.best_node_area: NodeAndArea = ("", "")

    def has_node(self, node: str) -> bool:
        return any(n == node for n, _ in self.all_node_areas)


class SpfSolver:
    """Reference: SpfSolver (openr/decision/Decision.h:199-266).  Computes
    on `device` (the CUDA card when None; raises when CUDA is absent
    unless the caller passes device="cpu")."""

    def __init__(
        self,
        my_node_name: str,
        enable_v4: bool = True,
        enable_best_route_selection: bool = False,
        device=None,
    ) -> None:
        self.my_node_name = my_node_name
        self.enable_v4 = enable_v4
        self.enable_best_route_selection = enable_best_route_selection
        self.engine = DeviceResidencyEngine(device)
        self.fleet = FleetViewCache()
        self._fleet_views: dict[str, FleetRouteView] = {}
        self.counters: dict[str, int] = {}

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def update_static_unicast_routes(self, routes_to_update, routes_to_delete):
        raise NotImplementedError("static routes are not ported yet")

    def update_static_mpls_routes(self, routes_to_update, routes_to_delete):
        raise NotImplementedError("static routes are not ported yet")

    def _view(self, area: str) -> FleetRouteView:
        view = self._fleet_views.get(area)
        if view is None:
            raise RuntimeError(f"no fleet view for area {area!r}")
        return view

    # -- per-prefix route construction --------------------------------------

    def create_route_for_prefix(
        self,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        prefix: str,
    ) -> Optional[RibUnicastEntry]:
        """Reference: createRouteForPrefix (Decision.cpp:445-613)."""
        self._bump("decision.get_route_for_prefix")
        prefix = normalize_prefix(prefix)
        all_prefix_entries = prefix_state.prefixes.get(prefix)
        if not all_prefix_entries:
            return None

        # keep entries of reachable nodes only (per area): the fleet
        # product answers dist(me -> advertiser) < INF
        prefix_entries: PrefixEntries = dict(all_prefix_entries)
        me = self.my_node_name
        for area in area_link_states:
            view = self._fleet_views.get(area)
            if view is not None and view.covers(me):
                def reachable(node, view=view):
                    return view.covers(node) and view.reachable(me, node)
            else:
                # a router outside the area's graph reaches only itself
                def reachable(node):
                    return node == me
            prefix_entries = {
                (node, parea): entry
                for (node, parea), entry in prefix_entries.items()
                if area != parea or reachable(node)
            }
        if not prefix_entries:
            self._bump("decision.no_route_to_prefix")
            return None

        is_v4 = ipaddress.ip_network(prefix).version == 4
        if is_v4 and not self.enable_v4:
            self._bump("decision.skipped_unicast_route")
            return None

        has_bgp = has_non_bgp = False
        has_self_prepend_label = True
        for (node, _area), entry in prefix_entries.items():
            is_bgp = entry.type == PrefixType.BGP
            has_bgp |= is_bgp
            has_non_bgp |= not is_bgp
            if node == me:
                has_self_prepend_label &= entry.prepend_label is not None
        if has_bgp and has_non_bgp and not self.enable_best_route_selection:
            # mixed BGP/non-BGP advertisement is rejected (Decision.cpp:527)
            self._bump("decision.skipped_unicast_route")
            return None

        best = self.select_best_routes(prefix_entries, has_bgp, area_link_states)
        if not best.all_node_areas:
            self._bump("decision.no_route_to_prefix")
            return None

        # skip self-advertised prefixes unless advertised w/ prepend label
        # (Decision.cpp:570-579)
        if best.has_node(me) and not has_self_prepend_label:
            return None

        forwarding_type, forwarding_algo = self._forwarding_type_and_algorithm(
            prefix_entries, best.all_node_areas
        )
        if forwarding_algo != PrefixForwardingAlgorithm.SP_ECMP:
            raise NotImplementedError(
                f"{forwarding_algo.name} forwarding is not ported yet"
            )
        return self._select_best_paths_spf(
            prefix, best, prefix_entries, forwarding_type, area_link_states
        )

    @staticmethod
    def _forwarding_type_and_algorithm(
        prefix_entries: PrefixEntries, best_node_areas: set[NodeAndArea]
    ) -> tuple[PrefixForwardingType, PrefixForwardingAlgorithm]:
        """Minimum over best entries — most-compatible wins (reference:
        getPrefixForwardingTypeAndAlgorithm, openr/common/Util.cpp)."""
        entries = [prefix_entries[na] for na in best_node_areas]
        return (
            min(e.forwarding_type for e in entries),
            min(e.forwarding_algorithm for e in entries),
        )

    # -- best route selection -----------------------------------------------

    def select_best_routes(
        self,
        prefix_entries: PrefixEntries,
        has_bgp: bool,
        area_link_states: dict[str, LinkState],
    ) -> BestRouteSelectionResult:
        """Reference: selectBestRoutes (Decision.cpp:795-827)."""
        result = BestRouteSelectionResult()
        if self.enable_best_route_selection:
            result.all_node_areas = select_best_prefix_metrics(prefix_entries)
            result.best_node_area = select_best_node_area(
                result.all_node_areas, self.my_node_name
            )
        elif has_bgp:
            raise NotImplementedError("BGP best-path selection is not ported yet")
        else:
            result.all_node_areas = set(prefix_entries)
            result.best_node_area = min(result.all_node_areas)
        return self._maybe_filter_drained_nodes(result, area_link_states)

    def _maybe_filter_drained_nodes(
        self,
        result: BestRouteSelectionResult,
        area_link_states: dict[str, LinkState],
    ) -> BestRouteSelectionResult:
        """Drop overloaded advertisers unless all are overloaded
        (reference: maybeFilterDrainedNodes, Decision.cpp:847-870)."""
        filtered = BestRouteSelectionResult()
        filtered.best_node_area = result.best_node_area
        filtered.all_node_areas = {
            (node, area)
            for node, area in result.all_node_areas
            if not area_link_states[area].is_node_overloaded(node)
        }
        if not filtered.all_node_areas:
            return result
        if filtered.best_node_area not in filtered.all_node_areas:
            filtered.best_node_area = min(filtered.all_node_areas)
        return filtered

    @staticmethod
    def _min_nexthop_threshold(
        best: BestRouteSelectionResult, prefix_entries: PrefixEntries
    ) -> Optional[int]:
        """Max over best entries' min_nexthop (reference:
        getMinNextHopThreshold, Decision.cpp:830-845)."""
        thresholds = [
            prefix_entries[na].min_nexthop
            for na in best.all_node_areas
            if prefix_entries[na].min_nexthop is not None
        ]
        return max(thresholds) if thresholds else None

    # -- SP_ECMP -------------------------------------------------------------

    def _select_best_paths_spf(
        self,
        prefix: str,
        best: BestRouteSelectionResult,
        prefix_entries: PrefixEntries,
        forwarding_type: PrefixForwardingType,
        area_link_states: dict[str, LinkState],
    ) -> Optional[RibUnicastEntry]:
        """Reference: selectBestPathsSpf (Decision.cpp:905-963)."""
        is_v4 = ipaddress.ip_network(prefix).version == 4
        per_destination = forwarding_type == PrefixForwardingType.SR_MPLS

        # self-originated SR prefix w/ prepend label: compute next hops to
        # the *other* advertisers (Decision.cpp:917-933)
        filtered_node_areas = set(best.all_node_areas)
        if best.has_node(self.my_node_name) and per_destination:
            for node_area, entry in prefix_entries.items():
                if (
                    node_area[0] == self.my_node_name
                    and entry.prepend_label is not None
                ):
                    filtered_node_areas.discard(node_area)

        min_metric, nexthop_nodes = self._get_next_hops_with_metric(
            filtered_node_areas, per_destination, area_link_states
        )
        if not nexthop_nodes:
            self._bump("decision.no_route_to_prefix")
            return None

        nexthops = self._get_next_hops(
            best.all_node_areas,
            is_v4,
            per_destination,
            min_metric,
            nexthop_nodes,
            None,
            area_link_states,
            prefix_entries,
        )
        min_nexthop = self._min_nexthop_threshold(best, prefix_entries)
        if min_nexthop is not None and min_nexthop > len(nexthops):
            return None
        return RibUnicastEntry(
            prefix=prefix,
            nexthops=frozenset(nexthops),
            best_prefix_entry=prefix_entries[best.best_node_area],
            best_area=best.best_node_area[1],
        )

    # -- nexthop computation -------------------------------------------------

    def _get_next_hops_with_metric(
        self,
        dst_node_areas: set[NodeAndArea],
        per_destination: bool,
        area_link_states: dict[str, LinkState],
    ) -> tuple[float, dict[tuple[str, str], float]]:
        """Reference: getNextHopsWithMetric (Decision.cpp:1182-1228),
        answered from the fleet product.  Returns (min metric,
        {(nexthop node, dst | "") -> dist from nexthop to dst})."""
        nexthop_nodes: dict[tuple[str, str], float] = {}
        shortest = float("inf")
        for area, link_state in area_link_states.items():
            view = self._view(area)
            if not view.covers(self.my_node_name) or not all(
                view.is_dest(node) or not view.covers(node)
                for node, _area in dst_node_areas
            ):
                raise RuntimeError(
                    f"the fleet view of area {area!r} cannot answer the "
                    f"next hops of {self.my_node_name!r}"
                )
            shortest = self._fleet_next_hops_with_metric(
                view,
                link_state,
                dst_node_areas,
                per_destination,
                shortest,
                nexthop_nodes,
            )
        return shortest, nexthop_nodes

    def _fleet_next_hops_with_metric(
        self,
        view: FleetRouteView,
        link_state: LinkState,
        dst_node_areas: set[NodeAndArea],
        per_destination: bool,
        shortest: float,
        nexthop_nodes: dict[tuple[str, str], float],
    ) -> float:
        """One area's contribution to getNextHopsWithMetric.  Stores
        dist(nh -> dst) under each qualifying (nh, dst_ref) key — the
        value the per-source path stores (shortest - dist(me, nh)) for
        every qualifying pair — so _get_next_hops' equality test
        (metric(link) + value == min_metric, Decision.cpp:1296-1300)
        selects the same links."""
        me = self.my_node_name
        min_metric = float("inf")
        min_cost_nodes: set[str] = set()
        for dst_node, _area in dst_node_areas:
            if not view.covers(dst_node):
                continue
            d = view.dist(me, dst_node)
            if d >= INF32:
                continue
            if min_metric >= d:
                if min_metric > d:
                    min_metric = d
                    min_cost_nodes = set()
                min_cost_nodes.add(dst_node)
        if shortest < min_metric:
            return shortest
        if shortest > min_metric:
            shortest = min_metric
            nexthop_nodes.clear()
        for dst_node in min_cost_nodes:
            dst_ref = dst_node if per_destination else ""
            d_me = view.dist(me, dst_node)
            for link in link_state.links_from_node(me):
                if not link.is_up():
                    continue
                u = link.other_node_name(me)
                if not view.covers(u):
                    continue
                d_u = view.dist(u, dst_node)
                if d_u >= INF32:
                    continue
                # drain: overloaded neighbor only as the destination
                # itself (the d == 0 source exception of the relax)
                if view.is_overloaded_id(u) and d_u != 0:
                    continue
                if link.metric_from_node(me) + d_u != d_me:
                    continue
                key = (u, dst_ref)
                prev = nexthop_nodes.get(key)
                if prev is None or d_u < prev:
                    nexthop_nodes[key] = d_u
        return shortest

    def _get_next_hops(
        self,
        dst_node_areas: set[NodeAndArea],
        is_v4: bool,
        per_destination: bool,
        min_metric: float,
        nexthop_nodes: dict[tuple[str, str], float],
        swap_label: Optional[int],
        area_link_states: dict[str, LinkState],
        prefix_entries: PrefixEntries,
    ) -> set[NextHop]:
        """Reference: getNextHopsThrift (Decision.cpp:1231-1338) — LFA-free
        ECMP: keep a link iff metric(link) + dist(neighbor, dst) equals the
        overall min metric."""
        me = self.my_node_name
        nexthops: set[NextHop] = set()
        for area, link_state in area_link_states.items():
            adj_dbs = link_state.get_adjacency_databases()
            for link in link_state.links_from_node(me):
                dst_iter = (
                    sorted(dst_node_areas) if per_destination else [("", "")]
                )
                for dst_node, dst_area in dst_iter:
                    if dst_area and area != dst_area:
                        continue
                    neighbor = link.other_node_name(me)
                    dist = nexthop_nodes.get((neighbor, dst_node))
                    if dist is None or not link.is_up():
                        continue
                    # don't reach dst via a neighbor that is itself another
                    # destination (Decision.cpp:1285-1291)
                    if (
                        dst_node
                        and (neighbor, area) in dst_node_areas
                        and neighbor != dst_node
                    ):
                        continue
                    dist_over_link = link.metric_from_node(me) + dist
                    if dist_over_link != min_metric:
                        continue

                    mpls_action: Optional[MplsAction] = None
                    if swap_label is not None:
                        nh_is_dst = (neighbor, area) in dst_node_areas
                        mpls_action = MplsAction(
                            MplsActionCode.PHP
                            if nh_is_dst
                            else MplsActionCode.SWAP,
                            swap_label=None if nh_is_dst else swap_label,
                        )
                    if dst_node:
                        push_labels: list[int] = []
                        dst_entry = prefix_entries.get((dst_node, area))
                        if (
                            dst_entry is not None
                            and dst_entry.prepend_label is not None
                        ):
                            push_labels.append(dst_entry.prepend_label)
                            if not is_mpls_label_valid(push_labels[-1]):
                                continue
                        if dst_node != neighbor:
                            push_labels.append(adj_dbs[dst_node].node_label)
                            if not is_mpls_label_valid(push_labels[-1]):
                                continue
                        if push_labels:
                            mpls_action = MplsAction(
                                MplsActionCode.PUSH,
                                push_labels=tuple(push_labels),
                            )

                    nexthops.add(
                        NextHop(
                            address=(
                                link.nh_v4_from_node(me)
                                if is_v4
                                else link.nh_v6_from_node(me)
                            ),
                            if_name=link.iface_from_node(me),
                            metric=int(dist_over_link),
                            mpls_action=mpls_action,
                            area=link.area,
                            neighbor_node_name=neighbor,
                        )
                    )
        return nexthops

    # -- full route DB -------------------------------------------------------

    def build_route_db(
        self,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        my_node_name: Optional[str] = None,
        fleet_views: Optional[dict[str, FleetRouteView]] = None,
    ) -> Optional[DecisionRouteDb]:
        """Reference: buildRouteDb (Decision.cpp:615-793), for any node
        `my_node_name`.  Reachability and next hops come from the per-area
        fleet views (`fleet_views`, computed here when None)."""
        me = my_node_name or self.my_node_name
        if not any(ls.has_node(me) for ls in area_link_states.values()):
            return None
        if fleet_views is None:
            fleet_views = self._build_fleet_views(area_link_states, prefix_state)
        self._bump("decision.route_build_runs")

        prev_me, self.my_node_name = self.my_node_name, me
        prev_views, self._fleet_views = self._fleet_views, fleet_views
        try:
            route_db = DecisionRouteDb()
            for prefix in prefix_state.prefixes:
                route = self.create_route_for_prefix(
                    area_link_states, prefix_state, prefix
                )
                if route is not None:
                    route_db.add_unicast_route(route)
            self._build_node_label_routes(area_link_states, route_db)
            self._check_no_adj_labels(area_link_states)
            return route_db
        finally:
            self.my_node_name = prev_me
            self._fleet_views = prev_views

    def _build_fleet_views(
        self,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> dict[str, FleetRouteView]:
        """Per-area fleet views on this solver's device."""
        views: dict[str, FleetRouteView] = {}
        for area, ls in area_link_states.items():
            dests = fleet_destinations(ls, prefix_state)
            if not dests:
                continue
            if not self.fleet.is_warm(ls, dests):
                self._bump("decision.fleet_rebuild_cold")
            views[area] = self.fleet.view(ls, dests, engine=self.engine)
        return views

    def any_node_route_db(
        self,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        node: str,
    ) -> Optional[DecisionRouteDb]:
        """Any-node ctrl query (reference: getDecisionRouteDb,
        Decision.cpp:1510-1530), served from the fleet product."""
        return self.build_route_db(area_link_states, prefix_state, node)

    def fleet_route_dbs(
        self,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        nodes: Optional[list[str]] = None,
    ) -> dict[str, DecisionRouteDb]:
        """Fleet-wide route dump: ONE reverse-SSSP device round per area
        answers every requested router's route build (default: every
        node).  Views are cached per (LinkState version, destination
        set)."""
        views = self._build_fleet_views(area_link_states, prefix_state)
        if nodes is None:
            nodes = sorted(
                {n for ls in area_link_states.values() for n in ls.node_names}
            )
        # queries touch each router and its neighbors: fetch their rows in
        # one device gather per area
        for area, view in views.items():
            ls = area_link_states[area]
            wanted = set()
            for n in nodes:
                if not view.covers(n):
                    continue
                wanted.add(n)
                for link in ls.links_from_node(n):
                    wanted.add(link.other_node_name(n))
            view.prefetch_rows(sorted(wanted))
        out: dict[str, DecisionRouteDb] = {}
        for node in nodes:
            db = self.build_route_db(
                area_link_states,
                prefix_state,
                my_node_name=node,
                fleet_views=views,
            )
            out[node] = db if db is not None else DecisionRouteDb()
        return out

    def _build_node_label_routes(
        self,
        area_link_states: dict[str, LinkState],
        route_db: DecisionRouteDb,
    ) -> None:
        """MPLS routes for every node label (Decision.cpp:655-745)."""
        label_to_node: dict[int, tuple[str, RibMplsEntry]] = {}
        for area, link_state in area_link_states.items():
            for node, adj_db in sorted(
                link_state.get_adjacency_databases().items()
            ):
                top_label = adj_db.node_label
                if top_label == 0:
                    continue
                if not is_mpls_label_valid(top_label):
                    self._bump("decision.skipped_mpls_route")
                    continue
                existing = label_to_node.get(top_label)
                if existing is not None:
                    self._bump("decision.duplicate_node_label")
                    # collision: smaller node name retained
                    # (Decision.cpp:679-689)
                    if existing[0] < node:
                        continue
                if node == self.my_node_name:
                    nh = NextHop(
                        address="::",
                        area=area,
                        mpls_action=MplsAction(MplsActionCode.POP_AND_LOOKUP),
                    )
                    label_to_node[top_label] = (
                        node,
                        RibMplsEntry(top_label, frozenset({nh})),
                    )
                    continue
                min_metric, nexthop_nodes = self._get_next_hops_with_metric(
                    {(node, area)}, False, area_link_states
                )
                if not nexthop_nodes:
                    self._bump("decision.no_route_to_label")
                    continue
                label_to_node[top_label] = (
                    node,
                    RibMplsEntry(
                        top_label,
                        frozenset(
                            self._get_next_hops(
                                {(node, area)},
                                False,
                                False,
                                min_metric,
                                nexthop_nodes,
                                top_label,
                                area_link_states,
                                {},
                            )
                        ),
                    ),
                )
        for _label, (_node, entry) in label_to_node.items():
            route_db.add_mpls_route(entry)

    def _check_no_adj_labels(
        self, area_link_states: dict[str, LinkState]
    ) -> None:
        """Adjacency-label MPLS routes (Decision.cpp:748-775) are not
        ported yet: refuse a router that has one rather than omit it."""
        for link_state in area_link_states.values():
            for link in link_state.links_from_node(self.my_node_name):
                if link.adj_label_from_node(self.my_node_name) != 0:
                    raise NotImplementedError(
                        "adjacency-label routes are not ported yet"
                    )
