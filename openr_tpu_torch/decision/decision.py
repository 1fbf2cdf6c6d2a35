"""Decision module: KvStore publications in, route-update deltas out.

Port of `openr_tpu.decision.decision` (reference: the Decision event
base, openr/decision/Decision.{h,cpp}:1398-2050): fiber readers over the
KvStore publication and static-routes queues, per-key publication
parsing ("adj:" / "prefix:" / "fibTime:"), pending-update batching with
oldest-wins perf events, the debounced full or incremental route
rebuild, the cold-start hold, RibPolicy with its TTL, and ordered-FIB
hold decrements.

The route build runs on the module's thread through its SpfSolver, on
the CUDA card unless the caller passes `device="cpu"` or an
`spf_backend`.  Where the reference demotes its solver to the host
Dijkstra for good when a rebuild raises, this module counts the failure
(`decision.route_rebuild_failures`), keeps the pending updates for the
next rebuild and lets the exception propagate.  `bgp_dry_run` marks
BGP routes do-not-install.  The operator queries `what_if` (SRLG
failure scenarios) and `get_ti_lfa` run on the event-base thread over
the device backend's refreshed mirror and its engine
(decision.protection_api).  `pending_event_hint` counts the topology
events admitted since the last rebuild, for the serving layer's
bounded batch hold.  With tracing armed (`obs.trace`), the publication
traces carried in on the KvStore updates queue wait for the debounced
rebuild, which opens one `decision` stage under each and runs with all
of them active (fan-in), so the engine's rung lands on each and the
route update carries them on to Fib.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..obs import trace as _trace
from ..runtime.async_util import AsyncDebounce
from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, ReplicateQueue, RQueue
from ..serializer import loads
from ..types import (
    ADJ_MARKER,
    PREFIX_MARKER,
    AdjacencyDatabase,
    PerfEvents,
    Publication,
    PrefixDatabase,
    add_perf_event,
    node_name_from_key,
    normalize_prefix,
    parse_prefix_key,
)
from .link_state import LinkState, LinkStateChange
from .prefix_state import PrefixState
from . import protection_api
from .rib import DecisionRouteDb, DecisionRouteUpdate
from .rib_policy import PolicyError, RibPolicy, RibPolicyConfig
from .spf_solver import SpfBackend, SpfSolver

log = logging.getLogger(__name__)

FIB_TIME_MARKER = "fibTime:"


class DecisionPendingUpdates:
    """Reference: detail::DecisionPendingUpdates
    (openr/decision/Decision.h:121-196, Decision.cpp:45-107)."""

    def __init__(self, my_node_name: str) -> None:
        self.my_node_name = my_node_name
        self.perf_events: Optional[PerfEvents] = None
        self.needs_full_rebuild = False
        self.updated_prefixes: set[str] = set()

    def needs_route_update(self) -> bool:
        return self.needs_full_rebuild or bool(self.updated_prefixes)

    def set_needs_full_rebuild(self) -> None:
        self.needs_full_rebuild = True

    def apply_link_state_change(
        self,
        node_name: str,
        change: LinkStateChange,
        perf_events: Optional[PerfEvents],
    ) -> None:
        self.needs_full_rebuild |= (
            change.topology_changed
            or change.node_label_changed
            # link attribute changes matter only locally (next hop, label)
            or (change.link_attributes_changed and node_name == self.my_node_name)
        )
        self._add_update(perf_events)

    def apply_prefix_state_change(
        self, change: set[str], perf_events: Optional[PerfEvents] = None
    ) -> None:
        self.updated_prefixes |= change
        self._add_update(perf_events)

    def reset(self) -> None:
        self.perf_events = None
        self.needs_full_rebuild = False
        self.updated_prefixes = set()

    def add_event(self, event: str) -> None:
        add_perf_event(self.perf_events, self.my_node_name, event)

    def move_out_events(self) -> Optional[PerfEvents]:
        events, self.perf_events = self.perf_events, None
        return events

    def _add_update(self, perf_events: Optional[PerfEvents]) -> None:
        # keep the OLDEST event list of the batch (convergence time)
        if self.perf_events is None or (
            perf_events is not None
            and perf_events.events
            and self.perf_events.events
            and self.perf_events.events[0].unix_ts_ms
            > perf_events.events[0].unix_ts_ms
        ):
            self.perf_events = (
                PerfEvents(list(perf_events.events)) if perf_events else PerfEvents()
            )
            self.add_event("DECISION_RECEIVED")


class Decision(OpenrEventBase):
    """The Decision event base.  `device`, `spf_backend` and
    `fleet_delta` (the fleet views' incremental delta rung) go to its
    SpfSolver (the default: a DeviceSpfBackend on the CUDA card, the
    rung off)."""

    # a fleet dump builds one route DB per node into one response; at
    # 100k nodes an unbounded dump is a multi-GB allocation on this
    # thread, so operators page with `nodes=`
    MAX_FLEET_DUMP_NODES = 8192

    def __init__(
        self,
        my_node_name: str,
        kvstore_updates: RQueue[Publication],
        static_routes_updates: Optional[RQueue[DecisionRouteUpdate]],
        route_updates_queue: ReplicateQueue[DecisionRouteUpdate],
        *,
        debounce_min_s: float = 0.01,
        debounce_max_s: float = 0.25,
        eor_time_s: Optional[float] = None,
        enable_v4: bool = True,
        enable_ordered_fib: bool = False,
        bgp_dry_run: bool = False,
        enable_best_route_selection: bool = False,
        enable_rib_policy: bool = False,
        spf_backend: Optional[SpfBackend] = None,
        device=None,
        fleet_delta: Optional[bool] = None,
    ) -> None:
        super().__init__(name="decision")
        self.my_node_name = my_node_name
        self._kvstore_updates = kvstore_updates
        self._static_routes_updates = static_routes_updates
        self._route_updates_queue = route_updates_queue
        self._debounce_bounds = (debounce_min_s, debounce_max_s)
        self._eor_time_s = eor_time_s
        self._enable_ordered_fib = enable_ordered_fib
        self._enable_rib_policy = enable_rib_policy

        self.spf_solver = SpfSolver(
            my_node_name,
            enable_v4=enable_v4,
            bgp_dry_run=bgp_dry_run,
            enable_best_route_selection=enable_best_route_selection,
            spf_backend=spf_backend,
            device=device,
            fleet_delta=fleet_delta,
        )
        self.area_link_states: dict[str, LinkState] = {}
        self.prefix_state = PrefixState()
        self.pending_updates = DecisionPendingUpdates(my_node_name)
        self.route_db = DecisionRouteDb()
        self.rib_policy: Optional[RibPolicy] = None
        self._rib_policy_timeout = None
        self._fib_times: dict[str, float] = {}  # node -> fib time (s)
        self._rebuild_debounced: Optional[AsyncDebounce] = None
        self._cold_start_pending = eor_time_s is not None
        self._ordered_fib_timeout = None
        # publications admitted that need a route update the last rebuild
        # has not folded in yet (pending_event_hint)
        self._pending_events = 0
        # OPENR_TRACE: publication spans carried in on the KvStore updates
        # queue, waiting for the rebuild that folds them in (event-base
        # thread only)
        self._trace_pending: list = []
        self.counters: dict[str, int] = {"decision.route_rebuild_failures": 0}

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def pending_event_hint(self) -> int:
        """Topology events admitted but not yet folded into routes: non-zero
        while a flap storm is being debounced.  A plain int read from any
        thread (the serving layer's hold on it is bounded)."""
        return self._pending_events

    def get_counters(self) -> dict[str, int]:
        """Module and solver counters merged."""
        out = dict(self.spf_solver.counters)
        for k, v in self.counters.items():
            out[k] = out.get(k, 0) + v
        return out

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        self.run_in_event_base_thread(self._setup).result()

    def _setup(self) -> None:
        engine = self.spf_solver.spf.engine
        if engine is not None and engine.device.type == "cuda":
            import torch

            # the route build's device work runs on this thread
            torch.cuda.set_device(engine.device.index or 0)
        self._rebuild_debounced = AsyncDebounce(
            self._debounce_bounds[0],
            self._debounce_bounds[1],
            lambda: self.rebuild_routes("DECISION_DEBOUNCE"),
        )
        if self._cold_start_pending:
            self.schedule_timeout(self._eor_time_s, self._cold_start_expired)
        self.add_fiber_task(self._kvstore_fiber(), name="kvStoreUpdates")
        if self._static_routes_updates is not None:
            self.add_fiber_task(self._static_routes_fiber(), name="staticRoutes")

    def _cold_start_expired(self) -> None:
        self._cold_start_pending = False
        self.pending_updates.set_needs_full_rebuild()
        self.rebuild_routes("COLD_START_UPDATE")

    async def _kvstore_fiber(self) -> None:
        while True:
            try:
                pub = await self._kvstore_updates.aget()
            except QueueClosedError:
                return
            tr = _trace.TRACE
            if tr is not None:
                self._trace_pending.extend(tr.take_carried())
            self.process_publication(pub)
            if self.pending_updates.needs_route_update():
                self._pending_events += 1
                self._rebuild_debounced()

    async def _static_routes_fiber(self) -> None:
        while True:
            try:
                update = await self._static_routes_updates.aget()
            except QueueClosedError:
                return
            self.process_static_routes_update(update)

    # -- publication processing ---------------------------------------------

    def process_publication(self, pub: Publication) -> None:
        """Reference: Decision::processPublication (Decision.cpp:1683-1790)."""
        area = pub.area
        if not area:
            log.error("decision: dropping publication without area")
            self._bump("decision.error")
            return
        link_state = self.area_link_states.setdefault(area, LinkState(area))
        for key, val in pub.key_vals.items():
            if val.value is None:
                continue  # TTL refresh only
            try:
                self._process_key_val(key, val, area, link_state)
            except Exception:
                # a corrupt value skips its key and keeps the fiber alive
                # (reference: per-key try/catch, Decision.cpp:1786-1789)
                log.exception("decision: failed to process key %r", key)
                self._bump("decision.error")
        for key in pub.expired_keys:
            try:
                self._process_expired_key(key, area, link_state)
            except Exception:
                log.exception("decision: failed to process expired key %r", key)
                self._bump("decision.error")

    def _process_expired_key(self, key: str, area: str, link_state: LinkState) -> None:
        if key.startswith(ADJ_MARKER):
            node = node_name_from_key(key)
            self.pending_updates.apply_link_state_change(
                node, link_state.delete_adjacency_database(node), None
            )
        elif key.startswith(PREFIX_MARKER):
            parsed = parse_prefix_key(key)
            if parsed is None:
                return
            node, _parea, prefix = parsed
            self.pending_updates.apply_prefix_state_change(
                self.prefix_state.delete_prefix(node, area, prefix), None
            )

    def _process_key_val(self, key: str, val, area: str, link_state: LinkState) -> None:
        if key.startswith(ADJ_MARKER):
            adj_db = loads(val.value, AdjacencyDatabase)
            adj_db.area = area
            hold_up_ttl = hold_down_ttl = 0
            if self._enable_ordered_fib:
                hops = link_state.get_hops_from_a_to_b(
                    self.my_node_name, adj_db.this_node_name
                )
                if hops is not None:
                    hold_up_ttl = int(hops)
                    hold_down_ttl = (
                        link_state.get_max_hops_to_node(adj_db.this_node_name)
                        - hold_up_ttl
                    )
            self._bump("decision.adj_db_update")
            self.pending_updates.apply_link_state_change(
                adj_db.this_node_name,
                link_state.update_adjacency_database(
                    adj_db, hold_up_ttl, hold_down_ttl
                ),
                adj_db.perf_events,
            )
            if (
                self._enable_ordered_fib
                and link_state.has_holds()
                and self._ordered_fib_timeout is None
            ):
                self._schedule_ordered_fib_decrement()
        elif key.startswith(PREFIX_MARKER):
            prefix_db = loads(val.value, PrefixDatabase)
            if len(prefix_db.prefix_entries) != 1:
                self._bump("decision.error")
                return
            entry = prefix_db.prefix_entries[0]
            # ignore the reflection of our own redistributed route
            if (
                prefix_db.this_node_name == self.my_node_name
                and entry.area_stack
                and entry.area_stack[-1] in self.area_link_states
            ):
                return
            self._bump("decision.prefix_db_update")
            node = prefix_db.this_node_name
            change = (
                self.prefix_state.delete_prefix(node, area, entry.prefix)
                if prefix_db.delete_prefix
                else self.prefix_state.update_prefix(node, area, entry)
            )
            self.pending_updates.apply_prefix_state_change(
                change, prefix_db.perf_events
            )
        elif key.startswith(FIB_TIME_MARKER):
            try:
                self._fib_times[node_name_from_key(key)] = (
                    float(val.value.decode()) / 1000.0
                )
            except (ValueError, AttributeError):
                pass

    def process_static_routes_update(self, delta: DecisionRouteUpdate) -> None:
        """Reference: processStaticRoutesUpdate (Decision.cpp:1829-1864)."""
        if delta.unicast_routes_to_update or delta.unicast_routes_to_delete:
            self.spf_solver.update_static_unicast_routes(
                [e.to_unicast_route() for e in delta.unicast_routes_to_update.values()],
                delta.unicast_routes_to_delete,
            )
            change = {
                normalize_prefix(p)
                for p in [
                    *delta.unicast_routes_to_update,
                    *delta.unicast_routes_to_delete,
                ]
            }
            self.pending_updates.apply_prefix_state_change(change, None)
        if delta.mpls_routes_to_update or delta.mpls_routes_to_delete:
            self.spf_solver.update_static_mpls_routes(
                [e.to_mpls_route() for e in delta.mpls_routes_to_update],
                delta.mpls_routes_to_delete,
            )
            self.pending_updates.set_needs_full_rebuild()
        if self._rebuild_debounced is not None:
            self._rebuild_debounced()

    # -- route rebuild -------------------------------------------------------

    def rebuild_routes(self, event: str) -> None:
        """Reference: rebuildRoutes (Decision.cpp:1866-1935).  A failed
        build is logged and counted, leaves the pending updates for the
        next rebuild, and raises."""
        if self._cold_start_pending:
            return
        tr = _trace.TRACE
        pending, self._trace_pending = self._trace_pending, []
        if tr is not None and pending:
            # fan-in: the debounced rebuild folds every carried publication
            # at once; a "decision" stage under each, all active, so the
            # route push carries them on
            spans = [
                tr.child_open(sp, "decision", event=event)
                for sp in dict.fromkeys(pending)
            ]
            try:
                with tr.activate(spans):
                    self._rebuild_routes_impl(event)
            finally:
                for sp in spans:
                    sp.finish()
            return
        self._rebuild_routes_impl(event)

    def _rebuild_routes_impl(self, event: str) -> None:
        self.pending_updates.add_event(event)
        try:
            update = self._compute_route_update()
        except Exception:
            log.exception("decision: route rebuild failed")
            self._bump("decision.route_rebuild_failures")
            raise
        self.route_db.update(update)
        self.pending_updates.add_event("ROUTE_UPDATE")
        update.perf_events = self.pending_updates.move_out_events()
        self.pending_updates.reset()
        # every admitted event is folded in
        self._pending_events = 0
        self._route_updates_queue.push(update)

    def _compute_route_update(self) -> DecisionRouteUpdate:
        update = DecisionRouteUpdate()
        if self.pending_updates.needs_full_rebuild:
            db = self.spf_solver.build_route_db(
                self.area_link_states, self.prefix_state
            ) or DecisionRouteDb()
            if self.rib_policy is not None:
                self.rib_policy.apply_policy(db.unicast_routes)
            return self.route_db.calculate_update(db)
        for prefix in self.pending_updates.updated_prefixes:
            route = self.spf_solver.create_route_for_prefix_or_get_static_route(
                self.area_link_states, self.prefix_state, prefix
            )
            if route is not None:
                update.add_route_to_update(route)
            else:
                update.unicast_routes_to_delete.append(prefix)
        if self.rib_policy is not None:
            changes = self.rib_policy.apply_policy(update.unicast_routes_to_update)
            update.unicast_routes_to_delete.extend(changes.deleted_routes)
        return update

    # -- ordered-FIB holds ---------------------------------------------------

    def _max_fib_time_s(self) -> float:
        return max(self._fib_times.values(), default=0.001)

    def _schedule_ordered_fib_decrement(self) -> None:
        self._ordered_fib_timeout = self.schedule_timeout(
            self._max_fib_time_s(), self._decrement_ordered_fib_holds
        )

    def _decrement_ordered_fib_holds(self) -> None:
        """Reference: decrementOrderedFibHolds (Decision.cpp:1938-1955)."""
        self._ordered_fib_timeout = None
        still_has_holds = False
        for link_state in self.area_link_states.values():
            self.pending_updates.apply_link_state_change(
                self.my_node_name, link_state.decrement_holds(), None
            )
            still_has_holds |= link_state.has_holds()
        if still_has_holds:
            self._schedule_ordered_fib_decrement()
        if self.pending_updates.needs_route_update():
            self.rebuild_routes("ORDERED_FIB_HOLDS_EXPIRED")

    # -- thread-safe control API (reference: Decision.cpp:1510-1680) ---------

    def get_route_db(self, node_name: str = "") -> DecisionRouteDb:
        """Any node's routes (reference: getDecisionRouteDb): another
        node's through the fleet product (spf_solver.any_node_route_db)."""

        def _compute() -> DecisionRouteDb:
            target = node_name or self.my_node_name
            if target != self.my_node_name:
                db = self.spf_solver.any_node_route_db(
                    self.area_link_states, self.prefix_state, target
                )
            else:
                db = self.spf_solver.build_route_db(
                    self.area_link_states, self.prefix_state
                )
            return db if db is not None else DecisionRouteDb()

        return self.run_in_event_base_thread(_compute).result()

    def get_fleet_route_dbs(
        self, nodes: Optional[list[str]] = None
    ) -> dict[str, DecisionRouteDb]:
        """Fleet-wide route dump from one fleet product per area
        (spf_solver.fleet_route_dbs); `nodes` defaults to every known
        node, at most MAX_FLEET_DUMP_NODES."""

        def _compute() -> dict[str, DecisionRouteDb]:
            total = (
                len({n for ls in self.area_link_states.values() for n in ls.node_names})
                if nodes is None
                else len(nodes)
            )
            if total > self.MAX_FLEET_DUMP_NODES:
                raise ValueError(
                    f"fleet dump of {total} nodes exceeds "
                    f"{self.MAX_FLEET_DUMP_NODES}; pass an explicit node list"
                )
            return self.spf_solver.fleet_route_dbs(
                self.area_link_states, self.prefix_state, nodes=nodes
            )

        return self.run_in_event_base_thread(_compute).result()

    def get_adjacency_databases(
        self, select_areas: Optional[set[str]] = None
    ) -> list[AdjacencyDatabase]:
        def _get() -> list[AdjacencyDatabase]:
            out: list[AdjacencyDatabase] = []
            for area, ls in self.area_link_states.items():
                if not select_areas or area in select_areas:
                    out.extend(ls.get_adjacency_databases().values())
            return out

        return self.run_in_event_base_thread(_get).result()

    def what_if(
        self,
        scenarios: list[list[tuple[str, str]]],
        area: str = "0",
        sources: Optional[list[str]] = None,
    ) -> list[dict]:
        """SRLG what-if failure analysis of `area` (protection_api.what_if):
        one masked batch on the card; the impact view defaults to this
        router (every source at scale is an output cubic in size and
        would stall this thread)."""

        def _compute() -> list[dict]:
            ls = self.area_link_states.get(area)
            if ls is None:
                return []
            srcs = sources if sources is not None else [self.my_node_name]
            return protection_api.what_if(
                ls, scenarios, srcs, csr=self._protection_csr(ls),
                engine=self.spf_solver.engine,
            )

        return self.run_in_event_base_thread(_compute).result()

    def get_ti_lfa(self, node: str = "", area: str = "0") -> dict:
        """Per-adjacency TI-LFA backups of `node` (this router by
        default; protection_api.ti_lfa): one masked batch with the
        SP-DAG on the card."""

        def _compute() -> dict:
            ls = self.area_link_states.get(area)
            if ls is None:
                return {"node": node or self.my_node_name, "error": "no area"}
            return protection_api.ti_lfa(
                ls, node or self.my_node_name, csr=self._protection_csr(ls),
                engine=self.spf_solver.engine,
            )

        return self.run_in_event_base_thread(_compute).result()

    def _protection_csr(self, ls: LinkState):
        """The backend's refreshed mirror of `ls`, whose forward runner the
        queries reuse (None on a host backend: the query builds one)."""
        return self.spf_solver.spf.csr_mirror(ls)

    def get_received_routes(self, **filters) -> list:
        return self.run_in_event_base_thread(
            lambda: self.prefix_state.get_received_routes_filtered(**filters)
        ).result()

    def set_rib_policy(self, cfg: RibPolicyConfig) -> None:
        if not self._enable_rib_policy:
            raise PolicyError("RibPolicy feature is not enabled")
        policy = RibPolicy(cfg)  # validated on the caller's thread

        def _set() -> None:
            self.rib_policy = policy
            if self._rib_policy_timeout is not None:
                self._rib_policy_timeout.cancel()
            self._rib_policy_timeout = self.schedule_timeout(
                policy.get_ttl_duration_s(), self._rib_policy_expired
            )
            self.pending_updates.set_needs_full_rebuild()
            self.rebuild_routes("RIB_POLICY_SET")

        self.run_in_event_base_thread(_set).result()

    def _rib_policy_expired(self) -> None:
        self._rib_policy_timeout = None
        self.pending_updates.set_needs_full_rebuild()
        self.rebuild_routes("RIB_POLICY_EXPIRED")

    def get_rib_policy(self) -> RibPolicyConfig:
        if not self._enable_rib_policy:
            raise PolicyError("RibPolicy feature is not enabled")

        def _get() -> RibPolicyConfig:
            if self.rib_policy is None:
                raise PolicyError("No RIB policy configured")
            return self.rib_policy.to_config()

        return self.run_in_event_base_thread(_get).result()

    def clear_rib_policy(self) -> None:
        if not self._enable_rib_policy:
            raise PolicyError("RibPolicy feature is not enabled")

        def _clear() -> None:
            if self.rib_policy is None:
                raise PolicyError("No RIB policy configured")
            self.rib_policy = None
            if self._rib_policy_timeout is not None:
                self._rib_policy_timeout.cancel()
                self._rib_policy_timeout = None
            self.pending_updates.set_needs_full_rebuild()
            self.rebuild_routes("RIB_POLICY_CLEARED")

        self.run_in_event_base_thread(_clear).result()
