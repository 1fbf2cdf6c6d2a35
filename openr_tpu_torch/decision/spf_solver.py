"""SpfSolver: per-prefix route construction over SPF results.

Port of `openr_tpu.decision.spf_solver` (reference:
SpfSolver::SpfSolverImpl, openr/decision/Decision.cpp:164-1395):
reachability filtering, best-route selection, drained-node filtering,
SP_ECMP next hops (IP and SR_MPLS forwarding), min-nexthop thresholds,
MPLS node-label and adjacency-label routes, and the static unicast and
MPLS route overlays.

A route build answers per source, through a pluggable SPF backend
(`SpfBackend`): `DeviceSpfBackend`, the default, keeps one CSR mirror
per LinkState, refreshes it in place on a version bump and serves
sources from the residency engine (device.engine.spf_results);
`HostSpfBackend` is the memoized host Dijkstra.  With fleet views
(`fleet_route_dbs`, `any_node_route_db`) reachability and next hops
come from the per-area FleetRouteView instead, built on the backend's
refreshed mirror.

Not ported yet, and refused with NotImplementedError when a route needs
them: KSP2_ED_ECMP (and the backends' k-path queries), UCMP weights and
BGP best-path selection.  Where the reference catches a device failure
and serves from its host oracle, this solver raises.
"""

from __future__ import annotations

import ipaddress
import weakref
from typing import Optional, Protocol

from ..device.engine import DeviceResidencyEngine
from ..types import (
    MplsAction,
    MplsActionCode,
    MplsRoute,
    NextHop,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    PrefixType,
    UnicastRoute,
    normalize_prefix,
)
from .csr import CsrTopology
from .fleet import FleetRouteView, FleetViewCache, fleet_destinations
from .link_state import LinkState, SpfResult
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


class SpfBackend(Protocol):
    """Seam for SPF computation: host Dijkstra or the device engine.
    `engine` is the backend's device engine and `csr_mirror` its
    refreshed CSR mirror of a LinkState (None for a host backend, whose
    solver computes fleet views only when asked for them by name)."""

    engine: Optional[DeviceResidencyEngine]

    def get_spf_result(self, link_state: LinkState, src: str) -> SpfResult: ...

    def csr_mirror(self, link_state: LinkState) -> Optional[CsrTopology]: ...


class HostSpfBackend:
    """Memoized host Dijkstra (the reference's exact behavior)."""

    engine = None

    def get_spf_result(self, link_state: LinkState, src: str) -> SpfResult:
        return link_state.get_spf_result(src)

    def csr_mirror(self, link_state: LinkState) -> None:
        return None

    def get_kth_paths(self, link_state, src, dest, k):
        raise NotImplementedError("k-shortest paths are not ported yet")


class DeviceSpfBackend:
    """SPF backend over a persistent CSR/ELL device mirror (reference:
    spf_solver.py DeviceSpfBackend).

    Per LinkState it keeps ONE mirror that refreshes in place on version
    bumps (csr.refresh) and whose residency the engine keeps in step
    incrementally.  Queries are lazy: a route build asks only for its own
    router, so each uncached source costs one device query (distances,
    SP-DAG, bit-packed first hops); batch consumers go through
    `prefetch`.  Every source with links is answered by the engine; the
    host Dijkstra serves only through HostSpfBackend.  (The reference
    sends small graphs and single questions to its host Dijkstra under
    thresholds measured on a TPU; this backend has no such policy.)
    Computes on `device` (the CUDA card when None), or on `engine`'s
    device when one is given."""

    def __init__(
        self, device=None, engine: Optional[DeviceResidencyEngine] = None
    ) -> None:
        self.engine = engine if engine is not None else DeviceResidencyEngine(device)
        # keyed on the LinkState object itself, weakly: ids recycle
        self._mirrors: "weakref.WeakKeyDictionary[LinkState, CsrTopology]" = (
            weakref.WeakKeyDictionary()
        )
        self._results: "weakref.WeakKeyDictionary[LinkState, tuple[int, dict[str, SpfResult]]]" = (
            weakref.WeakKeyDictionary()
        )
        # topology shape -> learned fixed-sweep hint (see _hint_key)
        self._hint_by_shape: dict[tuple, int] = {}

    def csr_mirror(self, link_state: LinkState) -> CsrTopology:
        """The CSR mirror of `link_state`, refreshed in place to its
        version (the engine's residency and the fleet views use it)."""
        csr = self._mirrors.get(link_state)
        if csr is None:
            csr = CsrTopology.from_link_state(link_state)
            # a fresh mirror of a same-shaped topology starts from the
            # learned hint instead of re-learning it by doubling
            learned = self._hint_by_shape.get(self._hint_key(csr))
            if learned is not None:
                csr._sweep_hint = learned
            self._mirrors[link_state] = csr
        elif csr.version != link_state.version:
            csr.refresh(link_state)
        return csr

    @staticmethod
    def _hint_key(csr: CsrTopology) -> tuple:
        # counts, not only the padded capacities: hints only grow, so a
        # deep topology must not poison a shallow one of the same bucket
        return (csr.n_nodes, csr.n_edges, csr.node_capacity, csr.edge_capacity)

    def _harvest_hint(self, csr: CsrTopology) -> None:
        key = self._hint_key(csr)
        self._hint_by_shape[key] = max(
            self._hint_by_shape.get(key, 0), csr._sweep_hint
        )

    def _result_cache(self, link_state: LinkState) -> dict[str, SpfResult]:
        cached = self._results.get(link_state)
        if cached is None or cached[0] != link_state.version:
            cached = (link_state.version, {})
            self._results[link_state] = cached
        return cached[1]

    def _query(self, link_state: LinkState, sources: list[str]) -> None:
        """One engine query of `sources`, cached."""
        csr = self.csr_mirror(link_state)
        self._result_cache(link_state).update(self.engine.spf_results(csr, sources))
        self._harvest_hint(csr)

    def prefetch(self, link_state: LinkState, sources: list[str]) -> None:
        """Compute many sources in one device query and cache them."""
        cache = self._result_cache(link_state)
        missing = [
            s
            for s in sources
            if s not in cache and link_state.links_from_node(s)
        ]
        if missing:
            self._query(link_state, missing)

    def get_spf_result(self, link_state: LinkState, src: str) -> SpfResult:
        cache = self._result_cache(link_state)
        hit = cache.get(src)
        if hit is not None:
            return hit
        if not link_state.links_from_node(src):
            # isolated or unknown node: the host's self-only result
            return link_state.get_spf_result(src)
        self._query(link_state, [src])
        return cache[src]

    def get_kth_paths(self, link_state, src, dest, k):
        raise NotImplementedError("k-shortest paths are not ported yet")

    def prefetch_kth_paths(self, link_state, src, dests):
        raise NotImplementedError("k-shortest paths are not ported yet")


class SpfSolver:
    """Reference: SpfSolver (openr/decision/Decision.h:199-266).  SPF
    comes from `spf_backend`, by default a DeviceSpfBackend on `device`
    (the CUDA card when None; it raises when CUDA is absent unless the
    caller passes device="cpu").  `engine` is the backend's device
    engine; a host backend's solver computes its fleet views on an
    engine of `device`, made when first needed."""

    def __init__(
        self,
        my_node_name: str,
        enable_v4: bool = True,
        enable_best_route_selection: bool = False,
        spf_backend: Optional[SpfBackend] = None,
        device=None,
    ) -> None:
        self.my_node_name = my_node_name
        self.enable_v4 = enable_v4
        self.enable_best_route_selection = enable_best_route_selection
        self.spf = spf_backend if spf_backend is not None else DeviceSpfBackend(device)
        self._device = device
        self._engine: Optional[DeviceResidencyEngine] = self.spf.engine
        self.fleet = FleetViewCache()
        self._fleet_views: dict[str, FleetRouteView] = {}
        # static route overlays (reference: Decision.cpp:372-425)
        self.static_unicast_routes: dict[str, list[NextHop]] = {}
        self.static_mpls_routes: dict[int, list[NextHop]] = {}
        self.counters: dict[str, int] = {}

    @property
    def engine(self) -> DeviceResidencyEngine:
        if self._engine is None:
            self._engine = DeviceResidencyEngine(self._device)
        return self._engine

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def _spf_result(self, link_state: LinkState, src: str) -> SpfResult:
        """The backend's SPF of `src`; a device error propagates."""
        return self.spf.get_spf_result(link_state, src)

    # -- static route overlays ----------------------------------------------

    def update_static_unicast_routes(
        self, routes_to_update: list[UnicastRoute], routes_to_delete: list[str]
    ) -> None:
        for route in routes_to_update:
            self.static_unicast_routes[normalize_prefix(route.dest)] = list(
                route.next_hops
            )
        for prefix in routes_to_delete:
            self.static_unicast_routes.pop(normalize_prefix(prefix), None)

    def update_static_mpls_routes(
        self, routes_to_update: list[MplsRoute], routes_to_delete: list[int]
    ) -> None:
        for route in routes_to_update:
            self.static_mpls_routes[route.top_label] = list(route.next_hops)
        for label in routes_to_delete:
            self.static_mpls_routes.pop(label, None)

    # -- per-prefix route construction --------------------------------------

    def create_route_for_prefix_or_get_static_route(
        self,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        prefix: str,
    ) -> Optional[RibUnicastEntry]:
        """Reference: createRouteForPrefixOrGetStaticRoute
        (Decision.cpp:427-449): a computed route wins over a static one."""
        route = self.create_route_for_prefix(area_link_states, prefix_state, prefix)
        if route is not None:
            return route
        prefix = normalize_prefix(prefix)
        nhs = self.static_unicast_routes.get(prefix)
        if nhs is None:
            return None
        return RibUnicastEntry(prefix=prefix, nexthops=frozenset(nhs))

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

        # keep entries of reachable nodes only (per area)
        prefix_entries: PrefixEntries = dict(all_prefix_entries)
        me = self.my_node_name
        for area, link_state in area_link_states.items():
            view = self._fleet_views.get(area)
            if view is not None and view.covers(me) and all(
                view.is_dest(node)
                for (node, parea) in prefix_entries
                if parea == area and view.covers(node)
            ):
                # the fleet product answers dist(me -> advertiser) < INF
                prefix_entries = {
                    (node, parea): entry
                    for (node, parea), entry in prefix_entries.items()
                    if area != parea
                    or (view.covers(node) and view.reachable(me, node))
                }
                continue
            my_spf = self._spf_result(link_state, me)
            prefix_entries = {
                (node, parea): entry
                for (node, parea), entry in prefix_entries.items()
                if area != parea or node in my_spf
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
        """Reference: selectBestPathsSpf (Decision.cpp:905-963) and
        addBestPaths (:1090-1150)."""
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

        # self-advertised anycast with a prepend label: merge in the static
        # next hops registered for that label (Decision.cpp:1113-1141)
        if best.has_node(self.my_node_name):
            prepend_label = next(
                (
                    entry.prepend_label
                    for (node, _a), entry in prefix_entries.items()
                    if node == self.my_node_name
                    and entry.prepend_label is not None
                ),
                None,
            )
            for nh in self.static_mpls_routes.get(prepend_label, ()):
                nexthops.add(NextHop(address=nh.address, metric=0))
        return RibUnicastEntry(
            prefix=prefix,
            nexthops=frozenset(nexthops),
            best_prefix_entry=prefix_entries[best.best_node_area],
            best_area=best.best_node_area[1],
        )

    # -- nexthop computation -------------------------------------------------

    def _get_min_cost_nodes(
        self, spf_result: SpfResult, dst_node_areas: set[NodeAndArea]
    ) -> tuple[float, set[str]]:
        """Reference: getMinCostNodes (Decision.cpp:1153-1178)."""
        shortest = float("inf")
        min_cost_nodes: set[str] = set()
        for dst_node, _area in dst_node_areas:
            res = spf_result.get(dst_node)
            if res is None:
                continue
            if shortest >= res.metric:
                if shortest > res.metric:
                    shortest = res.metric
                    min_cost_nodes = set()
                min_cost_nodes.add(dst_node)
        return shortest, min_cost_nodes

    def _get_next_hops_with_metric(
        self,
        dst_node_areas: set[NodeAndArea],
        per_destination: bool,
        area_link_states: dict[str, LinkState],
    ) -> tuple[float, dict[tuple[str, str], float]]:
        """Reference: getNextHopsWithMetric (Decision.cpp:1182-1228).
        Returns (min metric, {(nexthop node, dst | "") -> dist from nexthop
        to dst}), from the area's fleet view where it can answer, else
        from the router's own SPF."""
        nexthop_nodes: dict[tuple[str, str], float] = {}
        shortest = float("inf")
        for area, link_state in area_link_states.items():
            view = self._fleet_views.get(area)
            if view is not None and self._fleet_usable(view, dst_node_areas):
                shortest = self._fleet_next_hops_with_metric(
                    view,
                    link_state,
                    dst_node_areas,
                    per_destination,
                    shortest,
                    nexthop_nodes,
                )
                continue
            spf = self._spf_result(link_state, self.my_node_name)
            min_metric, min_cost_nodes = self._get_min_cost_nodes(
                spf, dst_node_areas
            )
            if shortest < min_metric:
                continue
            if shortest > min_metric:
                shortest = min_metric
                nexthop_nodes = {}
            for dst_node in min_cost_nodes:
                dst_ref = dst_node if per_destination else ""
                for nh_name in spf[dst_node].next_hops:
                    nexthop_nodes[(nh_name, dst_ref)] = (
                        shortest - spf[nh_name].metric
                    )
        return shortest, nexthop_nodes

    def _fleet_usable(
        self, view: FleetRouteView, dst_node_areas: set[NodeAndArea]
    ) -> bool:
        """The view can answer iff it covers the querying node and every
        destination it knows is in its destination set."""
        return view.covers(self.my_node_name) and all(
            view.is_dest(node) or not view.covers(node)
            for node, _area in dst_node_areas
        )

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
        `my_node_name`.  Reachability and next hops come from the router's
        own SPF through the backend, or, with `fleet_views` (area ->
        FleetRouteView), from the fleet product."""
        me = my_node_name or self.my_node_name
        if not any(ls.has_node(me) for ls in area_link_states.values()):
            return None
        self._bump("decision.route_build_runs")

        prev_me, self.my_node_name = self.my_node_name, me
        prev_views, self._fleet_views = self._fleet_views, fleet_views or {}
        try:
            route_db = DecisionRouteDb()
            for prefix in prefix_state.prefixes:
                route = self.create_route_for_prefix(
                    area_link_states, prefix_state, prefix
                )
                if route is not None:
                    route_db.add_unicast_route(route)
            for prefix, nhs in self.static_unicast_routes.items():
                if prefix not in route_db.unicast_routes:
                    route_db.add_unicast_route(
                        RibUnicastEntry(prefix=prefix, nexthops=frozenset(nhs))
                    )
            self._build_node_label_routes(area_link_states, route_db)
            self._build_adj_label_routes(area_link_states, route_db)
            for label, nhs in self.static_mpls_routes.items():
                if label not in route_db.mpls_routes:
                    route_db.add_mpls_route(
                        RibMplsEntry(label=label, nexthops=frozenset(nhs))
                    )
            return route_db
        finally:
            self.my_node_name = prev_me
            self._fleet_views = prev_views

    def _build_fleet_views(
        self,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        explicit: bool,
    ) -> dict[str, FleetRouteView]:
        """Per-area fleet views on the backend's refreshed mirror and on
        this solver's engine.  `explicit` (the operator asked for the
        fleet product) always computes; otherwise a view is computed only
        on a backend that keeps a device mirror (a host backend never
        computes one implicitly), or served from the cache.

        A view computed here (not served from the cache) bumps
        `decision.fleet_rebuild_warm` or `_cold`, `_warm_down` for a
        worsening warm start, and `decision.fleet_warm_fallbacks` when a
        warm gate's designed verdict sent it cold.  A failure raises."""
        views: dict[str, FleetRouteView] = {}
        for area, ls in area_link_states.items():
            dests = fleet_destinations(ls, prefix_state)
            if not dests:
                continue
            cached = self.fleet.is_warm(ls, dests)
            csr = self.spf.csr_mirror(ls)
            if not explicit and not cached and csr is None:
                continue
            view = self.fleet.view(ls, dests, csr=csr, engine=self.engine)
            views[area] = view
            if cached:
                continue
            self._bump(
                "decision.fleet_rebuild_warm"
                if view.warm
                else "decision.fleet_rebuild_cold"
            )
            if view.warm_mode == "worsen":
                self._bump("decision.fleet_rebuild_warm_down")
            if view.cold_fallback:
                self._bump("decision.fleet_warm_fallbacks")
        return views

    def _prefetch_view_rows(self, views, area_link_states, nodes) -> None:
        """Fetch the rows of `nodes` and their neighbours, the rows their
        route builds read, in one device gather per area."""
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

    def any_node_route_db(
        self,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        node: str,
    ) -> Optional[DecisionRouteDb]:
        """Any-node ctrl query (reference: getDecisionRouteDb,
        Decision.cpp:1510-1530): from the fleet product when the area's
        view is cached or the backend keeps a device mirror, per source
        otherwise."""
        views = self._build_fleet_views(
            area_link_states, prefix_state, explicit=False
        )
        self._prefetch_view_rows(views, area_link_states, [node])
        return self.build_route_db(
            area_link_states, prefix_state, my_node_name=node, fleet_views=views
        )

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
        views = self._build_fleet_views(
            area_link_states, prefix_state, explicit=True
        )
        if nodes is None:
            nodes = sorted(
                {n for ls in area_link_states.values() for n in ls.node_names}
            )
        self._prefetch_view_rows(views, area_link_states, nodes)
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

    def _build_adj_label_routes(
        self,
        area_link_states: dict[str, LinkState],
        route_db: DecisionRouteDb,
    ) -> None:
        """MPLS routes of this router's adjacency labels
        (Decision.cpp:748-775)."""
        me = self.my_node_name
        for link_state in area_link_states.values():
            for link in link_state.ordered_links_from_node(me):
                top_label = link.adj_label_from_node(me)
                if top_label == 0:
                    continue
                if not is_mpls_label_valid(top_label):
                    self._bump("decision.skipped_mpls_route")
                    continue
                nh = NextHop(
                    address=link.nh_v6_from_node(me),
                    if_name=link.iface_from_node(me),
                    metric=link.metric_from_node(me),
                    mpls_action=MplsAction(MplsActionCode.PHP),
                    area=link.area,
                    neighbor_node_name=link.other_node_name(me),
                )
                route_db.add_mpls_route(RibMplsEntry(top_label, frozenset({nh})))
