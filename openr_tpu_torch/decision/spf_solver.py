"""SpfSolver: per-prefix route construction over SPF results.

Port of `openr_tpu.decision.spf_solver` (reference:
SpfSolver::SpfSolverImpl, openr/decision/Decision.cpp:164-1395):
reachability filtering, best-route selection (the PrefixMetrics order,
or BGP's MetricVector comparison with `bgp_dry_run` marking BGP routes
do-not-install), drained-node filtering, SP_ECMP next hops (IP and
SR_MPLS forwarding) with the UCMP weights of both SP_UCMP_* algorithms,
KSP2_ED_ECMP label-stacked paths, min-nexthop thresholds, MPLS
node-label and adjacency-label routes, and the static unicast and MPLS
route overlays.

A route build answers per source, through a pluggable SPF backend
(`SpfBackend`): `DeviceSpfBackend`, the default, keeps one CSR mirror
per LinkState, refreshes it in place on a version bump and serves
sources from the residency engine (device.engine.spf_results);
`HostSpfBackend` is the memoized host Dijkstra.  With fleet views
(`fleet_route_dbs`, `any_node_route_db`) reachability and next hops
come from the per-area FleetRouteView instead, built on the backend's
refreshed mirror.

KSP2 asks the backend for k = 1 and 2 edge-disjoint paths per best
advertiser.  `DeviceSpfBackend.prefetch_kth_paths` answers a route's
whole destination set with one masked device run: k = 1 is traced from
the source's cached device SPF, and row d of the masked batch is the SPF
with destination d's first paths excluded.  Where the reference catches
a device failure (a failed KSP2 prefetch included) and serves from its
host oracle, this solver raises.
"""

from __future__ import annotations

import ipaddress
import logging
import math
import weakref
from dataclasses import replace
from typing import Optional, Protocol

import numpy as np

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
from .delta import DELTA_COUNTER_KEYS
from .fleet import FleetRouteView, FleetViewCache, fleet_destinations
from .link_state import LinkState, Path, SpfResult, path_a_in_path_b, trace_one_path
from .metric_vector import CompareResult, compare_metric_vectors
from .prefix_state import NodeAndArea, PrefixEntries, PrefixState
from .rib import DecisionRouteDb, RibMplsEntry, RibUnicastEntry
from ..ops.sssp import INF32

log = logging.getLogger(__name__)

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

    __slots__ = ("success", "all_node_areas", "best_node_area")

    def __init__(self) -> None:
        self.success = False
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

    def get_kth_paths(
        self, link_state: LinkState, src: str, dest: str, k: int
    ) -> list[Path]: ...

    def prefetch_kth_paths(
        self, link_state: LinkState, src: str, dests: list[str]
    ) -> None: ...


class HostSpfBackend:
    """Memoized host Dijkstra (the reference's exact behavior)."""

    engine = None

    def get_spf_result(self, link_state: LinkState, src: str) -> SpfResult:
        return link_state.get_spf_result(src)

    def csr_mirror(self, link_state: LinkState) -> None:
        return None

    def get_kth_paths(
        self, link_state: LinkState, src: str, dest: str, k: int
    ) -> list[Path]:
        return link_state.get_kth_paths(src, dest, k)

    def prefetch_kth_paths(
        self, link_state: LinkState, src: str, dests: list[str]
    ) -> None:
        """Nothing to batch: the host recursion answers per query."""


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
        # (src, dest, k) -> list[Path], version-guarded like _results
        self._kth_results: "weakref.WeakKeyDictionary[LinkState, tuple[int, dict]]" = (
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

    # -- batched k edge-disjoint shortest paths -------------------------------

    def _kth_cache(self, link_state: LinkState) -> dict:
        cached = self._kth_results.get(link_state)
        if cached is None or cached[0] != link_state.version:
            cached = (link_state.version, {})
            self._kth_results[link_state] = cached
        return cached[1]

    def get_kth_paths(
        self, link_state: LinkState, src: str, dest: str, k: int
    ) -> list[Path]:
        """The k-th edge-disjoint shortest paths, k = 1 or 2 (the reference
        answers larger k on its host; no route kind asks for them).  A
        miss runs `prefetch_kth_paths` for this one destination."""
        if k not in (1, 2):
            raise ValueError(f"the device backend serves k = 1 and 2, not {k}")
        cache = self._kth_cache(link_state)
        if (src, dest, k) not in cache:
            self.prefetch_kth_paths(link_state, src, [dest])
        return cache[(src, dest, k)]

    def prefetch_kth_paths(
        self, link_state: LinkState, src: str, dests: list[str]
    ) -> None:
        """k = 1 and k = 2 edge-disjoint paths from `src` to every one of
        `dests` (reference: DeviceSpfBackend.prefetch_kth_paths).

        k = 1 is traced out of the source's SPF (the device query,
        cached).  The host recursion would then re-run Dijkstra once per
        destination with its first paths' links excluded
        (LinkState.cpp:763-793); here those runs are the rows of ONE
        masked batch on the forward runner (row d = the SPF from `src`
        with destination d's first-path links down), whatever the batch
        size.  A device failure propagates."""
        cache = self._kth_cache(link_state)
        base = self.get_spf_result(link_state, src)
        need_second: list[tuple[str, set]] = []
        for dest in dests:
            if (src, dest, 1) not in cache:
                paths = []
                if dest in base:
                    visited: set = set()
                    while p := trace_one_path(src, dest, base, visited):
                        paths.append(p)
                cache[(src, dest, 1)] = paths
            if (src, dest, 2) not in cache:
                ignore = {link for path in cache[(src, dest, 1)] for link in path}
                if ignore:
                    need_second.append((dest, ignore))
                else:
                    cache[(src, dest, 2)] = []
        if not need_second:
            return
        csr = self.csr_mirror(link_state)
        link_edges = csr.edges_of_links()
        mask = np.ones((len(need_second), csr.edge_capacity), dtype=bool)
        for row, (_dest, ignore) in enumerate(need_second):
            for link in ignore:
                for e in link_edges.get(link, ()):
                    mask[row, e] = False
        dist, dag = csr.run_batched_spf(
            [src] * len(need_second), self.engine, extra_edge_mask=mask
        )
        for row, (dest, _ignore) in enumerate(need_second):
            res = csr.row_path_links(dist[row], dag[row])
            paths = []
            if dest in res:
                visited = set()
                while p := trace_one_path(src, dest, res, visited):
                    paths.append(p)
            cache[(src, dest, 2)] = paths


class SpfSolver:
    """Reference: SpfSolver (openr/decision/Decision.h:199-266).  SPF
    comes from `spf_backend`, by default a DeviceSpfBackend on `device`
    (the CUDA card when None; it raises when CUDA is absent unless the
    caller passes device="cpu").  `engine` is the backend's device
    engine; a host backend's solver computes its fleet views on an
    engine of `device`, made when first needed.  `bgp_dry_run` marks
    BGP routes do-not-install."""

    def __init__(
        self,
        my_node_name: str,
        enable_v4: bool = True,
        bgp_dry_run: bool = False,
        enable_best_route_selection: bool = False,
        spf_backend: Optional[SpfBackend] = None,
        device=None,
        fleet_delta: Optional[bool] = None,
    ) -> None:
        self.my_node_name = my_node_name
        self.enable_v4 = enable_v4
        self.bgp_dry_run = bgp_dry_run
        self.enable_best_route_selection = enable_best_route_selection
        self.spf = spf_backend if spf_backend is not None else DeviceSpfBackend(device)
        self._device = device
        self._engine: Optional[DeviceResidencyEngine] = self.spf.engine
        # `fleet_delta` opts the fleet views in to the incremental delta
        # rung (None: the OPENR_FLEET_DELTA default, off)
        self.fleet = FleetViewCache(delta=fleet_delta, bump=self._bump)
        self._fleet_views: dict[str, FleetRouteView] = {}
        # static route overlays (reference: Decision.cpp:372-425)
        self.static_unicast_routes: dict[str, list[NextHop]] = {}
        self.static_mpls_routes: dict[int, list[NextHop]] = {}
        # best-route selection cache (reference: bestRoutesCache_)
        self.best_routes_cache: dict[str, BestRouteSelectionResult] = {}
        # the decision.delta.* family is pre-seeded, as in the reference
        self.counters: dict[str, int] = {k: 0 for k in DELTA_COUNTER_KEYS}

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

    def _kth_paths(
        self, link_state: LinkState, src: str, dest: str, k: int
    ) -> list[Path]:
        """The backend's k-th edge-disjoint paths; a device error
        propagates."""
        return self.spf.get_kth_paths(link_state, src, dest, k)

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
        self.best_routes_cache.pop(prefix, None)

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
        if not best.success:
            return None
        if not best.all_node_areas:
            self._bump("decision.no_route_to_prefix")
            return None
        self.best_routes_cache[prefix] = best

        # skip self-advertised prefixes unless advertised w/ prepend label
        # (Decision.cpp:570-579)
        if best.has_node(me) and not has_self_prepend_label:
            return None

        forwarding_type, forwarding_algo = self._forwarding_type_and_algorithm(
            prefix_entries, best.all_node_areas
        )
        if forwarding_algo == PrefixForwardingAlgorithm.KSP2_ED_ECMP:
            return self._select_best_paths_ksp2(
                prefix, best, prefix_entries, has_bgp, forwarding_type,
                area_link_states,
            )
        # SP_ECMP and both SP_UCMP_* algorithms share the shortest-path
        # next hops; UCMP only weights them
        return self._select_best_paths_spf(
            prefix, best, prefix_entries, has_bgp, forwarding_type,
            area_link_states, forwarding_algo,
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
            return self._run_best_path_selection_bgp(
                prefix_entries, area_link_states
            )
        else:
            result.all_node_areas = set(prefix_entries)
            result.best_node_area = min(result.all_node_areas)
        result.success = True
        return self._maybe_filter_drained_nodes(result, area_link_states)

    def _run_best_path_selection_bgp(
        self,
        prefix_entries: PrefixEntries,
        area_link_states: dict[str, LinkState],
    ) -> BestRouteSelectionResult:
        """BGP best-path selection over the advertised MetricVectors
        (reference: runBestPathSelectionBgp, Decision.cpp:865-903, as the
        JAX package runs it): in sorted (node, area) order, WINNER resets
        the ECMP set, TIE_WINNER re-points the best entry and keeps the
        earlier ties, TIE_LOOSER joins the set, and TIE or ERROR drop the
        route.  When no advertiser attached a vector the PrefixMetrics
        order decides; a mix of entries with and without one drops the
        route."""
        result = BestRouteSelectionResult()
        if all(e.mv is None for e in prefix_entries.values()):
            result.all_node_areas = select_best_prefix_metrics(prefix_entries)
            result.best_node_area = select_best_node_area(
                result.all_node_areas, self.my_node_name
            )
            result.success = True
            return self._maybe_filter_drained_nodes(result, area_link_states)

        best_vector = None
        for node_area in sorted(prefix_entries):
            entry = prefix_entries[node_area]
            if entry.mv is None:
                log.error(
                    "BGP entry without metric vector from %s; skipping route",
                    node_area,
                )
                self._bump("decision.no_route_to_prefix")
                return BestRouteSelectionResult()
            cmp = (
                compare_metric_vectors(entry.mv, best_vector)
                if best_vector is not None
                else CompareResult.WINNER
            )
            if cmp in (CompareResult.TIE, CompareResult.ERROR):
                log.error("%s ordering BGP prefix entries; skipping route", cmp.value)
                self._bump("decision.no_route_to_prefix")
                return BestRouteSelectionResult()
            if cmp == CompareResult.WINNER:
                result.all_node_areas.clear()
            if cmp in (CompareResult.WINNER, CompareResult.TIE_WINNER):
                best_vector = entry.mv
                result.best_node_area = node_area
            if cmp in (
                CompareResult.WINNER,
                CompareResult.TIE_WINNER,
                CompareResult.TIE_LOOSER,
            ):
                result.all_node_areas.add(node_area)
        result.success = True
        return self._maybe_filter_drained_nodes(result, area_link_states)

    def _maybe_filter_drained_nodes(
        self,
        result: BestRouteSelectionResult,
        area_link_states: dict[str, LinkState],
    ) -> BestRouteSelectionResult:
        """Drop overloaded advertisers unless all are overloaded
        (reference: maybeFilterDrainedNodes, Decision.cpp:847-870)."""
        filtered = BestRouteSelectionResult()
        filtered.success = result.success
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
        is_bgp: bool,
        forwarding_type: PrefixForwardingType,
        area_link_states: dict[str, LinkState],
        forwarding_algo: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
    ) -> Optional[RibUnicastEntry]:
        """Reference: selectBestPathsSpf (Decision.cpp:905-963), with the
        UCMP weights of the SP_UCMP_* algorithms."""
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
        if forwarding_algo != PrefixForwardingAlgorithm.SP_ECMP:
            nexthops = self._apply_ucmp_weights(
                forwarding_algo,
                filtered_node_areas,
                nexthops,
                area_link_states,
                prefix_entries,
            )
        return self._add_best_paths(prefix, best, prefix_entries, is_bgp, nexthops)

    def _apply_ucmp_weights(
        self,
        algo: PrefixForwardingAlgorithm,
        dst_node_areas: set[NodeAndArea],
        nexthops: set[NextHop],
        area_link_states: dict[str, LinkState],
        prefix_entries: PrefixEntries,
    ) -> set[NextHop]:
        """UCMP weights over the selected ECMP set (reference:
        SpfSolver._apply_ucmp_weights).

        SP_UCMP_PREFIX_WEIGHT_PROPAGATION: each first-hop neighbour sums
        the `PrefixEntry.weight` of every min-metric advertiser it reaches
        on a shortest path (getNextHopsWithMetric's per-destination keys,
        from the router's SPF or the fleet view alike); parallel links to
        one neighbour share its weight.  SP_UCMP_ADJ_WEIGHT_PROPAGATION:
        each next hop takes its first-hop adjacency's weight.  Weights
        are divided by their gcd; when none is positive the set stays
        unweighted."""
        me = self.my_node_name
        link_w: dict[tuple[str, str], int] = {}
        if algo == PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION:
            for area, link_state in area_link_states.items():
                for link in link_state.links_from_node(me):
                    link_w[(area, link.iface_from_node(me))] = link.weight_from_node(me)

        acc: dict[str, int] = {}
        if algo == PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION:
            _, per_dst = self._get_next_hops_with_metric(
                dst_node_areas, True, area_link_states
            )
            by_dst: dict[str, int] = {}
            for node, area in dst_node_areas:
                w = prefix_entries[(node, area)].weight or 0
                by_dst[node] = max(by_dst.get(node, 0), w)
            for (nh_name, dst_node), _dist in per_dst.items():
                acc[nh_name] = acc.get(nh_name, 0) + by_dst.get(dst_node, 0)

        raw: list[tuple[NextHop, int]] = []
        for nh in nexthops:
            if algo == PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION:
                w = link_w.get((nh.area, nh.if_name), 0)
            else:
                w = acc.get(nh.neighbor_node_name, 0)
            raw.append((nh, max(w, 0)))
        norm = math.gcd(*(w for _nh, w in raw))
        if norm == 0:
            return nexthops
        return {replace(nh, weight=w // norm) for nh, w in raw}

    # -- KSP2_ED_ECMP --------------------------------------------------------

    def _select_best_paths_ksp2(
        self,
        prefix: str,
        best: BestRouteSelectionResult,
        prefix_entries: PrefixEntries,
        is_bgp: bool,
        forwarding_type: PrefixForwardingType,
        area_link_states: dict[str, LinkState],
    ) -> Optional[RibUnicastEntry]:
        """Reference: selectBestPathsKsp2 (Decision.cpp:966-1087): the
        first and second edge-disjoint shortest paths to every best
        advertiser, each a next hop over its first link pushing the node
        labels of the path's later nodes.  The backend prefetches the
        whole destination set first (one masked device run on the device
        backend); a failed prefetch raises."""
        if forwarding_type != PrefixForwardingType.SR_MPLS:
            self._bump("decision.incompatible_forwarding_type")
            return None

        me = self.my_node_name
        is_v4 = ipaddress.ip_network(prefix).version == 4
        nexthops: set[NextHop] = set()
        paths: list[tuple[str, Path]] = []  # (area, path)
        for area, link_state in area_link_states.items():
            self.spf.prefetch_kth_paths(
                link_state, me, sorted({node for node, _ in best.all_node_areas})
            )
            # shortest paths first
            for node, best_area in sorted(best.all_node_areas):
                if node == me and best_area == area:
                    continue
                for path in self._kth_paths(link_state, me, node, 1):
                    paths.append((area, path))
            # second shortest, skipping those containing a first path
            # (anti double-spray, Decision.cpp:1006-1037)
            first_paths_size = len(paths)
            for node, best_area in sorted(best.all_node_areas):
                if area != best_area:
                    continue
                for sec_path in self._kth_paths(link_state, me, node, 2):
                    if any(
                        path_a_in_path_b(paths[i][1], sec_path)
                        for i in range(first_paths_size)
                    ):
                        continue
                    paths.append((area, sec_path))
        if not paths:
            return None

        for area, path in paths:
            adj_dbs = area_link_states[area].get_adjacency_databases()
            cost = 0
            labels: list[int] = []  # front == bottom of stack
            next_node = me
            ok = True
            for link in path:
                cost += link.metric_from_node(next_node)
                next_node = link.other_node_name(next_node)
                if next_node not in adj_dbs:
                    ok = False
                    break
                labels.insert(0, adj_dbs[next_node].node_label)
            if not ok:
                continue
            labels.pop()  # the first hop's own label (PHP)
            entry = prefix_entries.get((next_node, area))
            if entry is None:
                continue
            if entry.prepend_label is not None:
                if not is_mpls_label_valid(entry.prepend_label):
                    continue
                labels.insert(0, entry.prepend_label)
            first_link = path[0]
            nexthops.add(
                NextHop(
                    address=(
                        first_link.nh_v4_from_node(me)
                        if is_v4
                        else first_link.nh_v6_from_node(me)
                    ),
                    if_name=first_link.iface_from_node(me),
                    metric=cost,
                    mpls_action=(
                        MplsAction(MplsActionCode.PUSH, push_labels=tuple(labels))
                        if labels
                        else None
                    ),
                    area=first_link.area,
                    neighbor_node_name=first_link.other_node_name(me),
                )
            )
        return self._add_best_paths(prefix, best, prefix_entries, is_bgp, nexthops)

    def _add_best_paths(
        self,
        prefix: str,
        best: BestRouteSelectionResult,
        prefix_entries: PrefixEntries,
        is_bgp: bool,
        nexthops: set[NextHop],
    ) -> Optional[RibUnicastEntry]:
        """Reference: addBestPaths (Decision.cpp:1090-1150)."""
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
            do_not_install=is_bgp and self.bgp_dry_run,
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
            self._prefetch_ksp2(area_link_states, prefix_state)
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

    def _prefetch_ksp2(
        self, area_link_states: dict[str, LinkState], prefix_state: PrefixState
    ) -> None:
        """One k-path prefetch per area for every advertiser of every
        prefix with a KSP2_ED_ECMP entry: the device backend answers all
        of a build's k = 2 runs as one masked batch, and the per-prefix
        prefetch of `_select_best_paths_ksp2` then finds them cached.
        The rows are independent, so the batch's make-up changes no
        route."""
        ksp2 = PrefixForwardingAlgorithm.KSP2_ED_ECMP
        me = self.my_node_name
        for area, link_state in area_link_states.items():
            dests = {
                node
                for entries in prefix_state.prefixes.values()
                if any(e.forwarding_algorithm == ksp2 for e in entries.values())
                for node, parea in entries
                if parea == area and node != me
            }
            if dests:
                self.spf.prefetch_kth_paths(link_state, me, sorted(dests))

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
        `decision.fleet_rebuild_warm` or `_cold` (a delta update counts
        as warm, as in the reference), `_warm_down` for a worsening warm
        start, and `decision.fleet_warm_fallbacks` when a warm gate's
        designed verdict sent it cold.  A failure raises."""
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
