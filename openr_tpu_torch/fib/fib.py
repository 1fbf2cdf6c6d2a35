"""Fib: consumes route deltas and programs the platform agent.

Port of `openr_tpu.fib.fib` (reference: openr/fib/Fib.{h,cpp}):

- fiber over the Decision route-updates queue; incremental
  add/delete programming via the FibService agent client;
- full `sync_fib` on cold start, on any programming failure (debounced
  with exponential backoff), and on agent restart detected by
  `alive_since` keep-alive polling;
- `do_not_install` routes tracked but never programmed;
- perf: end-to-end ROUTE_CONVERGENCE duration computed from the
  perf-event trail riding each update; ring buffer for `get_perf_db`;
- re-publishes programmed updates on `fib_updates_queue` for ctrl-API
  streaming subscribers.

The agent seam (`FibAgent`) is the thrift FibService surface
(openr/if/Platform.thrift:71); `MockFibAgent` mirrors
openr/tests/mocks/MockNetlinkFibHandler.  With tracing armed
(`obs.trace`), a route update that carries traces is programmed under a
`fib.program` stage of each, and each carried trace's root is finished
once: Fib is the terminal of the publication path.  The mock agent's
`chaos` seam takes a `chaos.FibChaosPlan`: before every FibService call
the plan's `on_call(op)` verdict lets it through (`ok`), fails it
(`fail`) or restarts the agent mid-call (`restart`), as the reference's.
"""

from __future__ import annotations

import ipaddress
import logging
import threading
import time
from collections import deque
from typing import Iterable, Optional, Protocol

from ..decision.rib import DecisionRouteUpdate, RibMplsEntry, RibUnicastEntry
from ..obs import trace as _trace
from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, ReplicateQueue, RQueue
from ..types import MplsRoute, PerfEvents, UnicastRoute, add_perf_event
from ..utils.backoff import ExponentialBackoff

log = logging.getLogger(__name__)

# reference: Constants::kFibInitialBackoff / kFibMaxBackoff
SYNC_INITIAL_BACKOFF_S = 0.008
SYNC_MAX_BACKOFF_S = 4.096
KEEPALIVE_INTERVAL_S = 1.0  # Constants::kKeepAliveCheckInterval
PERF_DB_SIZE = 10  # reference: kPerfBufferSize
FIB_CLIENT_OPENR = 786  # thrift::FibClient::OPENR (Platform.thrift:23)


class FibAgent(Protocol):
    """thrift FibService surface (openr/if/Platform.thrift:71-160)."""

    def add_unicast_routes(self, client_id: int, routes: list[UnicastRoute]) -> None: ...
    def delete_unicast_routes(self, client_id: int, prefixes: list[str]) -> None: ...
    def add_mpls_routes(self, client_id: int, routes: list[MplsRoute]) -> None: ...
    def delete_mpls_routes(self, client_id: int, labels: list[int]) -> None: ...
    def sync_fib(self, client_id: int, routes: list[UnicastRoute]) -> None: ...
    def sync_mpls_fib(self, client_id: int, routes: list[MplsRoute]) -> None: ...
    def get_route_table_by_client(self, client_id: int) -> list[UnicastRoute]: ...
    def get_mpls_route_table_by_client(self, client_id: int) -> list[MplsRoute]: ...
    def alive_since(self) -> int: ...


class MockFibAgent:
    """In-process fake agent counting programmed routes, with fault
    injection (reference: MockNetlinkFibHandler)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.unicast: dict[int, dict[str, UnicastRoute]] = {}
        self.mpls: dict[int, dict[int, MplsRoute]] = {}
        self._alive_since = int(time.time())
        self.fail = False  # raise on every call when set
        # seeded per-call failure/restart schedule (chaos.FibChaosPlan
        # duck type: on_call(op) -> "ok" | "fail" | "restart")
        self.chaos = None
        # Bare keys are the mock's public test surface (asserted as
        # agent.counters["sync_fib"] etc.); the daemon-side dump exports
        # them convention-clean as fib.agent.<key> via Fib.get_counters.
        self.counters = {
            "add_unicast": 0,
            "del_unicast": 0,
            "sync_fib": 0,
            "add_mpls": 0,
            "del_mpls": 0,
            "sync_mpls": 0,
        }

    def _check(self, op: str) -> None:
        if self.fail:
            raise RuntimeError("agent unavailable (injected)")
        plan = self.chaos
        if plan is not None:
            verdict = plan.on_call(op)
            if verdict == "restart":
                # spontaneous restart: tables wiped, aliveSince bumps, and
                # the in-flight call dies like a severed thrift channel
                self.restart()
                raise RuntimeError(f"agent restarted during {op} (injected)")
            if verdict == "fail":
                raise RuntimeError(f"injected agent failure on {op}")

    def restart(self) -> None:
        """Simulate agent restart: state wiped, aliveSince bumps."""
        with self._lock:
            self.unicast.clear()
            self.mpls.clear()
            self._alive_since = int(time.time() * 1000)  # strictly increases

    def add_unicast_routes(self, client_id: int, routes: list[UnicastRoute]) -> None:
        self._check("add_unicast_routes")
        with self._lock:
            table = self.unicast.setdefault(client_id, {})
            for route in routes:
                table[route.dest] = route
            self.counters["add_unicast"] += len(routes)  # openr: disable=counter-name

    def delete_unicast_routes(self, client_id: int, prefixes: list[str]) -> None:
        self._check("delete_unicast_routes")
        with self._lock:
            table = self.unicast.setdefault(client_id, {})
            for prefix in prefixes:
                table.pop(prefix, None)
            self.counters["del_unicast"] += len(prefixes)  # openr: disable=counter-name

    def add_mpls_routes(self, client_id: int, routes: list[MplsRoute]) -> None:
        self._check("add_mpls_routes")
        with self._lock:
            table = self.mpls.setdefault(client_id, {})
            for route in routes:
                table[route.top_label] = route
            self.counters["add_mpls"] += len(routes)  # openr: disable=counter-name

    def delete_mpls_routes(self, client_id: int, labels: list[int]) -> None:
        self._check("delete_mpls_routes")
        with self._lock:
            table = self.mpls.setdefault(client_id, {})
            for label in labels:
                table.pop(label, None)
            self.counters["del_mpls"] += len(labels)  # openr: disable=counter-name

    def sync_fib(self, client_id: int, routes: list[UnicastRoute]) -> None:
        self._check("sync_fib")
        with self._lock:
            self.unicast[client_id] = {r.dest: r for r in routes}
            self.counters["sync_fib"] += 1  # openr: disable=counter-name

    def sync_mpls_fib(self, client_id: int, routes: list[MplsRoute]) -> None:
        self._check("sync_mpls_fib")
        with self._lock:
            self.mpls[client_id] = {r.top_label: r for r in routes}
            self.counters["sync_mpls"] += 1  # openr: disable=counter-name

    def get_route_table_by_client(self, client_id: int) -> list[UnicastRoute]:
        with self._lock:
            return list(self.unicast.get(client_id, {}).values())

    def get_mpls_route_table_by_client(self, client_id: int) -> list[MplsRoute]:
        with self._lock:
            return list(self.mpls.get(client_id, {}).values())

    def alive_since(self) -> int:
        self._check("alive_since")
        with self._lock:
            return self._alive_since


def longest_prefix_match(addr: str, prefixes: Iterable[str]) -> Optional[str]:
    """Reference: Fib::longestPrefixMatch (openr/fib/Fib.h:80)."""
    ip = ipaddress.ip_address(addr)
    best: Optional[str] = None
    best_len = -1
    for prefix in prefixes:
        net = ipaddress.ip_network(prefix)
        if net.version == ip.version and ip in net and net.prefixlen > best_len:
            best = prefix
            best_len = net.prefixlen
    return best


class RouteState:
    """Reference: Fib::RouteState (openr/fib/Fib.h:191)."""

    __slots__ = ("unicast_routes", "mpls_routes", "dirty", "synced")

    def __init__(self) -> None:
        self.unicast_routes: dict[str, UnicastRoute] = {}
        self.mpls_routes: dict[int, MplsRoute] = {}
        self.dirty = False
        self.synced = False


class Fib(OpenrEventBase):
    def __init__(
        self,
        node_name: str,
        route_updates: RQueue[DecisionRouteUpdate],
        agent: FibAgent,
        *,
        fib_updates_queue: Optional[ReplicateQueue[DecisionRouteUpdate]] = None,
        log_sample_queue: Optional[ReplicateQueue] = None,
        client_id: int = FIB_CLIENT_OPENR,
        dryrun: bool = False,
        enable_segment_routing: bool = True,
        keepalive_interval_s: float = KEEPALIVE_INTERVAL_S,
        sync_initial_backoff_s: float = SYNC_INITIAL_BACKOFF_S,
        sync_max_backoff_s: float = SYNC_MAX_BACKOFF_S,
    ) -> None:
        super().__init__(name=f"fib-{node_name}")
        self.node_name = node_name
        self._route_updates = route_updates
        self.agent = agent
        self._fib_updates_queue = fib_updates_queue
        self._log_sample_queue = log_sample_queue
        self.client_id = client_id
        self.dryrun = dryrun
        self.enable_segment_routing = enable_segment_routing
        self._keepalive_interval_s = keepalive_interval_s
        # shared audited backoff (utils.backoff) instead of a hand-rolled
        # doubling — the KvStore peer FSM uses the same class
        self._sync_backoff = ExponentialBackoff(
            sync_initial_backoff_s, sync_max_backoff_s
        )

        self.route_state = RouteState()
        self._do_not_install: set[str] = set()
        self._latest_alive_since: Optional[int] = None
        self._sync_timer = None
        self.perf_db: deque[PerfEvents] = deque(maxlen=PERF_DB_SIZE)
        self.counters: dict[str, int] = {}

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def get_counters(self) -> dict[str, int]:
        """Own counters plus the in-process agent's programming counters
        namespaced as fib.agent.<key>, so the ctrl dump covers the whole
        programming path even when the agent is the in-process mock."""
        out = dict(self.counters)
        agent_counters = getattr(self.agent, "counters", None)
        if isinstance(agent_counters, dict):
            for key, val in agent_counters.items():
                if isinstance(key, str) and isinstance(val, int):
                    out[f"fib.agent.{key}"] = val
        return out

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        self.run_in_event_base_thread(self._setup).result()

    def _setup(self) -> None:
        self.add_fiber_task(self._route_updates_fiber(), name="routeUpdates")
        # cold start: full sync establishes agent state ownership; first
        # keep-alive fires immediately so the aliveSince baseline predates
        # any restart we must detect
        self._schedule_sync(0.0)
        self.schedule_timeout(0.0, self._keepalive_tick)

    async def _route_updates_fiber(self) -> None:
        while True:
            try:
                update = await self._route_updates.aget()
            except QueueClosedError:
                return
            tr = _trace.TRACE
            carried = tr.take_carried() if tr is not None else ()
            if carried:
                # the publication path's terminal: program under a
                # "fib.program" stage of each carried span, then finish
                # every carried trace's root
                spans = [tr.child_open(sp, "fib.program") for sp in carried]
                try:
                    with tr.activate(spans):
                        try:
                            self.process_route_updates(update)
                        except Exception:
                            log.exception("fib: route update processing failed")
                finally:
                    for sp in spans:
                        sp.finish()
                    for sp in carried:
                        tr.finish_root(sp)
                continue
            try:
                self.process_route_updates(update)
            except Exception:
                log.exception("fib: route update processing failed")

    # -- route processing (reference: processRouteUpdates/updateRoutes) ------

    def process_route_updates(self, update: DecisionRouteUpdate) -> None:
        add_perf_event(update.perf_events, self.node_name, "FIB_ROUTE_DB_RECVD")
        # update local state; a route flipping TO do_not_install must be
        # withdrawn from the agent even though it stays in our state
        newly_uninstalled: list[str] = []
        for prefix in update.unicast_routes_to_delete:
            self.route_state.unicast_routes.pop(prefix, None)
            self._do_not_install.discard(prefix)
        for prefix, entry in update.unicast_routes_to_update.items():
            self.route_state.unicast_routes[prefix] = entry.to_unicast_route()
            if entry.do_not_install:
                if prefix not in self._do_not_install:
                    newly_uninstalled.append(prefix)
                self._do_not_install.add(prefix)
            else:
                self._do_not_install.discard(prefix)
        for label in update.mpls_routes_to_delete:
            self.route_state.mpls_routes.pop(label, None)
        for entry in update.mpls_routes_to_update:
            self.route_state.mpls_routes[entry.label] = entry.to_mpls_route()

        if not self.route_state.synced:
            # initial sync still pending: it will program everything
            self.route_state.dirty = True
            return
        self._update_routes(update, newly_uninstalled)

    def _update_routes(
        self,
        update: DecisionRouteUpdate,
        newly_uninstalled: Iterable[str] = (),
    ) -> None:
        """Incremental programming (reference: updateRoutes)."""
        add_perf_event(update.perf_events, self.node_name, "FIB_DEBOUNCE")
        try:
            if not self.dryrun:
                to_add = [
                    entry.to_unicast_route()
                    for prefix, entry in update.unicast_routes_to_update.items()
                    if prefix not in self._do_not_install
                ]
                if to_add:
                    self.agent.add_unicast_routes(self.client_id, to_add)
                to_del = list(update.unicast_routes_to_delete) + list(
                    newly_uninstalled
                )
                if to_del:
                    self.agent.delete_unicast_routes(self.client_id, to_del)
                if self.enable_segment_routing:
                    if update.mpls_routes_to_update:
                        self.agent.add_mpls_routes(
                            self.client_id,
                            [e.to_mpls_route() for e in update.mpls_routes_to_update],
                        )
                    if update.mpls_routes_to_delete:
                        self.agent.delete_mpls_routes(
                            self.client_id, list(update.mpls_routes_to_delete)
                        )
            self._bump("fib.num_of_route_updates")
            self._publish_and_log(update)
        except Exception:
            log.exception("fib: incremental programming failed; scheduling sync")
            self._bump("fib.thrift.failure.add_del_route")
            self.route_state.dirty = True
            self._schedule_sync_backoff()

    def _publish_and_log(self, update: DecisionRouteUpdate) -> None:
        add_perf_event(update.perf_events, self.node_name, "OPENR_FIB_ROUTES_PROGRAMMED")
        if self._fib_updates_queue is not None:
            self._fib_updates_queue.push(update)
        self._log_perf_events(update.perf_events)

    def _log_perf_events(self, perf_events: Optional[PerfEvents]) -> None:
        """Reference: logPerfEvents (Fib.h:187) — ROUTE_CONVERGENCE."""
        if perf_events is None or not perf_events.events:
            return
        self.perf_db.append(perf_events)
        duration = perf_events.total_duration_ms()
        self._bump("fib.route_convergence_count")
        self.counters["fib.route_convergence_last_ms"] = duration
        if self._log_sample_queue is not None:
            self._log_sample_queue.push(
                {
                    "event": "ROUTE_CONVERGENCE",
                    "node": self.node_name,
                    "duration_ms": duration,
                    "events": [
                        (e.event_name, e.unix_ts_ms) for e in perf_events.events
                    ],
                }
            )

    # -- full sync (reference: syncRouteDb/syncRouteDbDebounced) -------------

    def _schedule_sync(self, delay_s: float) -> None:
        if self._sync_timer is not None:
            self._sync_timer.cancel()
        self._sync_timer = self.schedule_timeout(delay_s, self._sync_fib)

    def _schedule_sync_backoff(self) -> None:
        self._bump("fib.sync_retries")
        self._sync_backoff.report_error()
        self._schedule_sync(self._sync_backoff.get_current_backoff())

    def _sync_fib(self) -> None:
        self._sync_timer = None
        try:
            if not self.dryrun:
                routes = [
                    r
                    for prefix, r in self.route_state.unicast_routes.items()
                    if prefix not in self._do_not_install
                ]
                self.agent.sync_fib(self.client_id, routes)
                if self.enable_segment_routing:
                    self.agent.sync_mpls_fib(
                        self.client_id, list(self.route_state.mpls_routes.values())
                    )
            self._bump("fib.sync_fib_calls")
            was_dirty = self.route_state.dirty
            self.route_state.synced = True
            self.route_state.dirty = False
            self._sync_backoff.report_success()
            if was_dirty and self._fib_updates_queue is not None:
                # updates absorbed while unsynced (or failed incrementally)
                # were never published; emit the reconciled full state so
                # streaming subscribers converge
                self._fib_updates_queue.push(self._full_state_update())
        except Exception:
            log.exception("fib: syncFib failed; retrying with backoff")
            self._bump("fib.thrift.failure.sync_fib")
            self._schedule_sync_backoff()

    def _full_state_update(self) -> DecisionRouteUpdate:
        update = DecisionRouteUpdate()
        for prefix, route in self.route_state.unicast_routes.items():
            update.unicast_routes_to_update[prefix] = RibUnicastEntry(
                prefix=prefix,
                nexthops=frozenset(route.next_hops),
                do_not_install=prefix in self._do_not_install,
            )
        update.mpls_routes_to_update = [
            RibMplsEntry(label=label, nexthops=frozenset(route.next_hops))
            for label, route in self.route_state.mpls_routes.items()
        ]
        return update

    # -- keep-alive (reference: keepAliveCheck, Fib.h:181) -------------------

    def _keepalive_tick(self) -> None:
        try:
            alive_since = self.agent.alive_since()
        except Exception:
            alive_since = None
            self._bump("fib.thrift.failure.keepalive")
        if alive_since is not None:
            if (
                self._latest_alive_since is not None
                and alive_since != self._latest_alive_since
            ):
                # agent restarted: it lost all routes — full resync
                log.warning("fib: agent restart detected; resyncing")
                self._bump("fib.agent_restarts")
                self.route_state.synced = False
                self._schedule_sync(0.0)
            self._latest_alive_since = alive_since
        self.schedule_timeout(self._keepalive_interval_s, self._keepalive_tick)

    # -- introspection (reference: getRouteDb/getPerfDb) ---------------------

    def get_route_db(
        self, programmed_only: bool = False
    ) -> tuple[list[UnicastRoute], list[MplsRoute]]:
        """Tracked route state; with `programmed_only`, restricted to what
        is actually sent to the agent (do_not_install prefixes are tracked
        but never programmed, fib.py _update_routes/_sync_fib; MPLS
        programming is gated on enable_segment_routing; dryrun programs
        nothing at all)."""

        def _get():
            if programmed_only and self.dryrun:
                return [], []
            unicast = [
                r
                for p, r in self.route_state.unicast_routes.items()
                if not programmed_only or p not in self._do_not_install
            ]
            mpls = (
                []
                if programmed_only and not self.enable_segment_routing
                else list(self.route_state.mpls_routes.values())
            )
            return unicast, mpls

        return self.run_in_event_base_thread(_get).result()

    def get_unicast_routes(self, prefixes: Optional[list[str]] = None) -> list[UnicastRoute]:
        """Reference: Fib::getUnicastRoutesFiltered (openr/fib/Fib.cpp:268).

        Each filter entry is normalized through `ipaddress` (so
        "fc01::0001/64" finds the route keyed "fc01::/64") and answered
        by LONGEST-PREFIX MATCH: an exact (normalized) table hit wins,
        otherwise the most-specific table route that COVERS the queried
        prefix — so querying a host address returns its covering route,
        never a silent miss on string inequality.  Malformed filter
        entries match nothing; duplicates collapse (first occurrence
        order preserved)."""

        def _get() -> list[UnicastRoute]:
            routes = self.route_state.unicast_routes
            if not prefixes:
                return list(routes.values())
            table: list[tuple] = []
            for key in routes:
                try:
                    table.append((ipaddress.ip_network(key, strict=False), key))
                except ValueError:
                    continue
            out: list[UnicastRoute] = []
            seen: set[str] = set()
            for p in prefixes:
                try:
                    q = ipaddress.ip_network(p, strict=False)
                except ValueError:
                    continue
                best_key = None
                best_len = -1
                for net, key in table:
                    if (
                        net.version == q.version
                        and net.prefixlen <= q.prefixlen
                        and q.network_address in net
                        and net.prefixlen > best_len
                    ):
                        best_key, best_len = key, net.prefixlen
                if best_key is not None and best_key not in seen:
                    seen.add(best_key)
                    out.append(routes[best_key])
            return out

        return self.run_in_event_base_thread(_get).result()

    def get_perf_db(self) -> list[PerfEvents]:
        return self.run_in_event_base_thread(lambda: list(self.perf_db)).result()
