"""LinkMonitor: the glue between the kernel, Spark, and KvStore.

Port of `openr_tpu.link_monitor.link_monitor` (reference: LinkMonitor,
openr/link-monitor/LinkMonitor.{h,cpp}; doc
openr/docs/Protocol_Guide/LinkMonitor.md):

- consumes netlink link/addr events; maintains `InterfaceEntry` objects
  with exponential flap backoff before (re-)advertising an interface up
  (openr/link-monitor/InterfaceEntry.h);
- feeds the filtered interface database to Spark;
- converts Spark NeighborEvents into KvStore peer add/remove (PeerEvent)
  and `adj:<node>` advertisements via KvStoreClientInternal.persist_key;
- gates initial adjacency advertisement on the KvStore initial full-sync
  signal per peer (graceful-restart semantics, Main.cpp:474);
- holds drain state: node overload bit, per-link overloads, link/adj
  metric overrides — persisted as LinkMonitorState in the config store;
- optional RTT-derived adjacency metrics with NEIGHBOR_RTT_CHANGE updates.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Optional

from ..kvstore import KvStoreClientInternal
from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, ReplicateQueue, RQueue
from ..serializer import dumps
from ..types import (
    AddrEvent,
    Adjacency,
    AdjacencyDatabase,
    InterfaceDatabase,
    InterfaceInfo,
    KvStoreSyncEvent,
    LinkEvent,
    NeighborEvent,
    NeighborEventType,
    PeerEvent,
    PeerSpec,
    PerfEvents,
    PrefixEntry,
    PrefixType,
    PrefixUpdateRequest,
    adj_key,
)
from ..utils.backoff import ExponentialBackoff

log = logging.getLogger(__name__)

# reference: Constants::kInitialBackoff / kMaxBackoff for link flaps
LINK_FLAP_INITIAL_BACKOFF_S = 1.0
LINK_FLAP_MAX_BACKOFF_S = 60.0


AdjKey = tuple[str, str]  # (ifName, neighborNodeName)


@dataclass(slots=True)
class LinkMonitorState:
    """Persisted drain/override state (reference:
    thrift::LinkMonitorState, openr/if/Types.thrift:1148)."""

    is_overloaded: bool = False
    overloaded_links: set[str] = field(default_factory=set)
    link_metric_overrides: dict[str, int] = field(default_factory=dict)
    node_label: int = 0
    adj_metric_overrides: dict[AdjKey, int] = field(default_factory=dict)
    # soft-drain: added to every advertised adjacency metric
    # (nodeMetricIncrementVal) — steers traffic away without the hard
    # is_overloaded transit cutoff
    node_metric_increment_val: int = 0


CONFIG_KEY = "link-monitor-config"


class InterfaceEntry:
    """Interface with flap backoff (reference:
    openr/link-monitor/InterfaceEntry.h)."""

    __slots__ = ("if_name", "if_index", "is_up", "networks", "backoff", "_active_timer")

    def __init__(self, if_name: str, if_index: int = 0) -> None:
        self.if_name = if_name
        self.if_index = if_index
        self.is_up = False
        self.networks: set[str] = set()
        self.backoff = ExponentialBackoff(
            LINK_FLAP_INITIAL_BACKOFF_S, LINK_FLAP_MAX_BACKOFF_S
        )
        self._active_timer = None

    def update_status(self, is_up: bool) -> bool:
        """Returns True if the *advertised* state may have changed."""
        changed = self.is_up != is_up
        self.is_up = is_up
        if changed and not is_up:
            self.backoff.report_error()  # flap: penalize next up
        return changed

    def is_active(self) -> bool:
        """Up AND out of backoff (reference: InterfaceEntry::isActive)."""
        return self.is_up and self.backoff.can_try_now()

    def backoff_remaining_s(self) -> float:
        return self.backoff.get_time_remaining_until_retry()


class Neighbor:
    __slots__ = (
        "node_name",
        "if_name",
        "remote_if_name",
        "area",
        "rtt_us",
        "addr_v6",
        "addr_v4",
        "ctrl_port",
        "initial_synced",
        "restarting",
    )

    def __init__(self, event: NeighborEvent) -> None:
        self.node_name = event.node_name
        self.if_name = event.if_name
        self.remote_if_name = event.remote_if_name
        self.area = event.area
        self.rtt_us = event.rtt_us
        self.addr_v6 = event.neighbor_addr_v6
        self.addr_v4 = event.neighbor_addr_v4
        self.ctrl_port = event.ctrl_port
        self.initial_synced = False
        self.restarting = False


class LinkMonitor(OpenrEventBase):
    def __init__(
        self,
        node_name: str,
        *,
        # producer queues
        interface_updates_queue: ReplicateQueue[InterfaceDatabase],
        peer_updates_queue: ReplicateQueue[PeerEvent],
        prefix_updates_queue: Optional[ReplicateQueue[PrefixUpdateRequest]] = None,
        # consumer queues
        neighbor_updates: RQueue[NeighborEvent],
        kvstore_sync_events: Optional[RQueue[KvStoreSyncEvent]] = None,
        netlink_events: Optional[RQueue[object]] = None,
        # collaborators
        kvstore_client: Optional[KvStoreClientInternal] = None,
        config_store: Optional[object] = None,  # PersistentStore duck-type
        # config
        areas: tuple[str, ...] = ("0",),
        node_label: int = 0,
        enable_rtt_metric: bool = False,
        enable_perf_measurement: bool = False,
        include_if_regexes: tuple[str, ...] = (".*",),
        exclude_if_regexes: tuple[str, ...] = (),
        redistribute_if_regexes: tuple[str, ...] = (),
        assume_drained: bool = False,
        override_drain_state: bool = False,
        adj_hold_time_s: float = 0.0,
    ) -> None:
        super().__init__(name=f"link-monitor-{node_name}")
        self.node_name = node_name
        self._interface_updates_queue = interface_updates_queue
        self._peer_updates_queue = peer_updates_queue
        self._prefix_updates_queue = prefix_updates_queue
        self._neighbor_updates = neighbor_updates
        self._kvstore_sync_events = kvstore_sync_events
        self._netlink_events = netlink_events
        self.kvstore_client = kvstore_client
        self.config_store = config_store
        self.areas = areas
        self.enable_rtt_metric = enable_rtt_metric
        self.enable_perf_measurement = enable_perf_measurement
        self._include_res = [re.compile(p) for p in include_if_regexes]
        self._exclude_res = [re.compile(p) for p in exclude_if_regexes]
        self._redist_res = [re.compile(p) for p in redistribute_if_regexes]
        self._adj_hold_time_s = adj_hold_time_s
        self._adj_hold_active = adj_hold_time_s > 0

        self.state = LinkMonitorState(node_label=node_label)
        self._load_state(assume_drained, override_drain_state)
        self.interfaces: dict[str, InterfaceEntry] = {}
        self._redist_advertised: set[str] = set()
        # (area, nodeName, ifName) -> Neighbor  (parallel links are distinct
        # adjacencies; the KvStore peer lives while ANY of them is up)
        self.neighbors: dict[tuple[str, str, str], Neighbor] = {}
        self.counters: dict[str, int] = {}

    # -- persistence ---------------------------------------------------------

    def _load_state(self, assume_drained: bool, override: bool) -> None:
        loaded = False
        if self.config_store is not None:
            raw = self.config_store.load(CONFIG_KEY)
            if raw is not None:
                try:
                    import json

                    d = json.loads(raw.decode())
                    # parse completely before applying: a corrupt blob must
                    # not leave partially-applied state
                    is_overloaded = bool(d["is_overloaded"])
                    overloaded_links = set(d["overloaded_links"])
                    link_metric_overrides = {
                        k: int(v) for k, v in d["link_metric_overrides"].items()
                    }
                    node_label = int(d.get("node_label", 0))
                    node_metric_increment = int(
                        d.get("node_metric_increment_val", 0)
                    )
                    adj_metric_overrides = {}
                    for k, v in d.get("adj_metric_overrides", {}).items():
                        if_name, _, node = k.partition("|")
                        if not node:
                            raise ValueError(f"bad adj key {k!r}")
                        adj_metric_overrides[(if_name, node)] = int(v)
                    self.state.is_overloaded = is_overloaded
                    self.state.overloaded_links = overloaded_links
                    self.state.link_metric_overrides = link_metric_overrides
                    self.state.node_label = node_label or self.state.node_label
                    self.state.node_metric_increment_val = node_metric_increment
                    self.state.adj_metric_overrides = adj_metric_overrides
                    loaded = True
                except Exception:
                    log.exception("link-monitor: corrupt persisted state")
        if not loaded and assume_drained:
            self.state.is_overloaded = True
        if override:
            self.state.is_overloaded = assume_drained

    def _save_state(self) -> None:
        if self.config_store is None:
            return
        import json

        self.config_store.store(
            CONFIG_KEY,
            json.dumps(
                {
                    "is_overloaded": self.state.is_overloaded,
                    "overloaded_links": sorted(self.state.overloaded_links),
                    "link_metric_overrides": self.state.link_metric_overrides,
                    "node_label": self.state.node_label,
                    "node_metric_increment_val": (
                        self.state.node_metric_increment_val
                    ),
                    "adj_metric_overrides": {
                        f"{k[0]}|{k[1]}": v
                        for k, v in self.state.adj_metric_overrides.items()
                    },
                }
            ).encode(),
        )

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        self.run_in_event_base_thread(self._setup).result()

    def _setup(self) -> None:
        self.add_fiber_task(self._neighbor_fiber(), name="neighborUpdates")
        if self._kvstore_sync_events is not None:
            self.add_fiber_task(self._sync_events_fiber(), name="kvSyncEvents")
        if self._netlink_events is not None:
            self.add_fiber_task(self._netlink_fiber(), name="netlinkEvents")
        if self._adj_hold_active:
            self.schedule_timeout(self._adj_hold_time_s, self._adj_hold_expired)

    def _adj_hold_expired(self) -> None:
        self._adj_hold_active = False
        self.advertise_adjacencies()

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    # -- fibers --------------------------------------------------------------

    async def _neighbor_fiber(self) -> None:
        while True:
            try:
                event = await self._neighbor_updates.aget()
            except QueueClosedError:
                return
            try:
                self._process_neighbor_event(event)
            except Exception:
                log.exception("link-monitor: neighbor event failed")

    async def _sync_events_fiber(self) -> None:
        while True:
            try:
                event = await self._kvstore_sync_events.aget()
            except QueueClosedError:
                return
            self._process_sync_event(event)

    async def _netlink_fiber(self) -> None:
        while True:
            try:
                event = await self._netlink_events.aget()
            except QueueClosedError:
                return
            try:
                if isinstance(event, LinkEvent):
                    self._process_link_event(event)
                elif isinstance(event, AddrEvent):
                    self._process_addr_event(event)
            except Exception:
                log.exception("link-monitor: netlink event failed")

    # -- interface tracking (reference: processNetlinkEvent) ------------------

    def _if_included(self, if_name: str) -> bool:
        if any(p.fullmatch(if_name) for p in self._exclude_res):
            return False
        return any(p.fullmatch(if_name) for p in self._include_res)

    def _process_link_event(self, event: LinkEvent) -> None:
        if not self._if_included(event.if_name):
            return
        entry = self.interfaces.get(event.if_name)
        if entry is None:
            entry = self.interfaces[event.if_name] = InterfaceEntry(
                event.if_name, event.if_index
            )
        entry.if_index = event.if_index
        self._bump("link_monitor.link_event")
        if entry.update_status(event.is_up):
            if entry.is_active():
                self.advertise_interfaces()
            else:
                # flap backoff: advertise DOWN now, delay UP advertisement
                self.advertise_interfaces()
                if entry.is_up:
                    self._schedule_backoff_refresh(entry)

    def _schedule_backoff_refresh(self, entry: InterfaceEntry) -> None:
        delay = entry.backoff_remaining_s()
        if delay > 0:
            self.schedule_timeout(
                delay + 0.001, lambda: self._backoff_expired(entry.if_name)
            )

    def _backoff_expired(self, if_name: str) -> None:
        entry = self.interfaces.get(if_name)
        if entry is None:
            return
        if entry.is_active():
            self.advertise_interfaces()
        elif entry.is_up:
            self._schedule_backoff_refresh(entry)

    def _process_addr_event(self, event: AddrEvent) -> None:
        if not self._if_included(event.if_name):
            return
        entry = self.interfaces.get(event.if_name)
        if entry is None:
            entry = self.interfaces[event.if_name] = InterfaceEntry(event.if_name)
        if event.is_valid:
            entry.networks.add(event.prefix)
        else:
            entry.networks.discard(event.prefix)
        self.advertise_interfaces()
        self._advertise_redist_prefixes()

    def advertise_interfaces(self) -> None:
        """Publish the interface DB to Spark (active interfaces only count
        as up)."""
        db = InterfaceDatabase(this_node_name=self.node_name)
        for name, entry in self.interfaces.items():
            db.interfaces[name] = InterfaceInfo(
                if_name=name,
                is_up=entry.is_active(),
                if_index=entry.if_index,
                networks=sorted(entry.networks),
            )
        self._interface_updates_queue.push(db)

    def _advertise_redist_prefixes(self) -> None:
        if self._prefix_updates_queue is None or not self._redist_res:
            return
        current = {
            net
            for name, entry in self.interfaces.items()
            if entry.is_active()
            and any(p.fullmatch(name) for p in self._redist_res)
            for net in entry.networks
        }
        to_del = sorted(self._redist_advertised - current)
        self._redist_advertised = current
        self._prefix_updates_queue.push(
            PrefixUpdateRequest(
                prefixes_to_add=[
                    PrefixEntry(prefix=net, type=PrefixType.LOOPBACK)
                    for net in sorted(current)
                ],
                prefixes_to_del=to_del,
                type=PrefixType.LOOPBACK,
            )
        )

    # -- neighbor tracking (reference: neighborUpEvent/neighborDownEvent) ----

    def _node_links(self, area: str, node: str) -> list[Neighbor]:
        return [
            n
            for (a, nn, _), n in self.neighbors.items()
            if a == area and nn == node
        ]

    def _process_neighbor_event(self, event: NeighborEvent) -> None:
        key = (event.area, event.node_name, event.if_name)
        etype = event.event_type
        if etype == NeighborEventType.NEIGHBOR_UP:
            self._bump("link_monitor.neighbor_up")
            self.neighbors[key] = Neighbor(event)
            self._peer_updates_queue.push(
                PeerEvent(
                    area=event.area,
                    peers_to_add={
                        event.node_name: PeerSpec(
                            peer_addr=event.neighbor_addr_v6 or event.node_name,
                            ctrl_port=event.ctrl_port,
                        )
                    },
                )
            )
            # adjacency advertised when this peer finishes initial sync
            if self._kvstore_sync_events is None:
                self.neighbors[key].initial_synced = True
                self.advertise_adjacencies(event.area)
            else:
                # parallel link to an already-synced peer: no new sync
                # event will come, inherit synced state
                synced = any(
                    n.initial_synced
                    for n in self._node_links(event.area, event.node_name)
                )
                if synced:
                    self.neighbors[key].initial_synced = True
                    self.advertise_adjacencies(event.area)
        elif etype == NeighborEventType.NEIGHBOR_DOWN:
            self._bump("link_monitor.neighbor_down")
            self.neighbors.pop(key, None)
            if not self._node_links(event.area, event.node_name):
                # last parallel link gone: drop the KvStore peering
                self._peer_updates_queue.push(
                    PeerEvent(area=event.area, peers_to_del=[event.node_name])
                )
            self.advertise_adjacencies(event.area)
        elif etype == NeighborEventType.NEIGHBOR_RESTARTING:
            self._bump("link_monitor.neighbor_restarting")
            neighbor = self.neighbors.get(key)
            if neighbor is not None:
                neighbor.restarting = True
        elif etype == NeighborEventType.NEIGHBOR_RESTARTED:
            self._bump("link_monitor.neighbor_restarted")
            neighbor = self.neighbors.get(key)
            if neighbor is not None:
                neighbor.restarting = False
            self.advertise_adjacencies(event.area)
        elif etype == NeighborEventType.NEIGHBOR_RTT_CHANGE:
            neighbor = self.neighbors.get(key)
            if neighbor is not None:
                neighbor.rtt_us = event.rtt_us
                if self.enable_rtt_metric:
                    self.advertise_adjacencies(event.area)

    def _process_sync_event(self, event: KvStoreSyncEvent) -> None:
        """Initial-sync signal gates first adjacency advertisement
        (reference: kvStoreSyncEventsQueue wiring, Main.cpp:474)."""
        changed = False
        for neighbor in self._node_links(event.area, event.node_name):
            if not neighbor.initial_synced:
                neighbor.initial_synced = True
                changed = True
        if changed:
            self.advertise_adjacencies(event.area)

    # -- adjacency advertisement ---------------------------------------------

    def _adjacency_metric(self, neighbor: Neighbor) -> int:
        """Reference: getRttMetric + overrides precedence (adj override >
        link override > computed)."""
        override = self.state.adj_metric_overrides.get(
            (neighbor.if_name, neighbor.node_name)
        )
        if override is not None:
            return override
        link_override = self.state.link_metric_overrides.get(neighbor.if_name)
        if link_override is not None:
            return link_override
        if self.enable_rtt_metric and neighbor.rtt_us > 0:
            return max(1, neighbor.rtt_us // 100)
        return 1

    def build_adjacency_database(self, area: str) -> AdjacencyDatabase:
        adjacencies = []
        for (narea, _, _), neighbor in sorted(self.neighbors.items()):
            if narea != area or not neighbor.initial_synced:
                continue
            adjacencies.append(
                Adjacency(
                    other_node_name=neighbor.node_name,
                    if_name=neighbor.if_name,
                    other_if_name=neighbor.remote_if_name,
                    metric=self._adjacency_metric(neighbor),
                    adj_label=0,
                    is_overloaded=neighbor.if_name in self.state.overloaded_links,
                    rtt_us=neighbor.rtt_us,
                    next_hop_v6=neighbor.addr_v6,
                    next_hop_v4=neighbor.addr_v4,
                )
            )
        db = AdjacencyDatabase(
            this_node_name=self.node_name,
            adjacencies=adjacencies,
            is_overloaded=self.state.is_overloaded,
            node_label=self.state.node_label,
            area=area,
            node_metric_increment_val=self.state.node_metric_increment_val,
        )
        if self.enable_perf_measurement:
            db.perf_events = PerfEvents()
            db.perf_events.add(self.node_name, "ADJ_DB_UPDATED")
        return db

    def advertise_adjacencies(self, area: Optional[str] = None) -> None:
        if self._adj_hold_active:
            return  # cold-start hold (reference: adj_hold_time_s)
        if self.kvstore_client is None:
            return
        for a in self.areas if area is None else (area,):
            db = self.build_adjacency_database(a)
            self.kvstore_client.persist_key(a, adj_key(self.node_name), dumps(db))
            self._bump("link_monitor.advertise_adjacencies")

    # -- drain / metric control API (reference: OpenrCtrlHandler :280-298) ---

    def _update_and_advertise(self, mutate) -> None:
        def _do() -> None:
            mutate()
            self._save_state()
            self.advertise_adjacencies()

        self.run_in_event_base_thread(_do).result()

    def set_node_overload(self, overloaded: bool) -> None:
        self._update_and_advertise(
            lambda: setattr(self.state, "is_overloaded", overloaded)
        )

    def set_link_overload(self, if_name: str, overloaded: bool) -> None:
        def _mutate() -> None:
            if overloaded:
                self.state.overloaded_links.add(if_name)
            else:
                self.state.overloaded_links.discard(if_name)

        self._update_and_advertise(_mutate)

    def set_link_metric(self, if_name: str, metric: Optional[int]) -> None:
        def _mutate() -> None:
            if metric is None:
                self.state.link_metric_overrides.pop(if_name, None)
            else:
                self.state.link_metric_overrides[if_name] = metric

        self._update_and_advertise(_mutate)

    def set_adj_metric(
        self, if_name: str, node_name: str, metric: Optional[int]
    ) -> None:
        def _mutate() -> None:
            key = (if_name, node_name)
            if metric is None:
                self.state.adj_metric_overrides.pop(key, None)
            else:
                self.state.adj_metric_overrides[key] = metric

        self._update_and_advertise(_mutate)

    def set_node_label(self, label: int) -> None:
        self._update_and_advertise(
            lambda: setattr(self.state, "node_label", label)
        )

    def set_node_metric_increment(self, increment: int) -> None:
        """Soft-drain: advertise every adjacency with `increment` added to
        its metric (reference: semi-/undrain-interface increments,
        OpenrCtrlHandler::semiDrainNode).  0 restores normal costs."""
        if increment < 0:
            raise ValueError(f"negative metric increment {increment}")
        self._update_and_advertise(
            lambda: setattr(self.state, "node_metric_increment_val", increment)
        )

    # -- introspection --------------------------------------------------------

    def get_interfaces(self) -> dict[str, InterfaceInfo]:
        def _get() -> dict[str, InterfaceInfo]:
            return {
                name: InterfaceInfo(
                    if_name=name,
                    is_up=e.is_active(),
                    if_index=e.if_index,
                    networks=sorted(e.networks),
                )
                for name, e in self.interfaces.items()
            }

        return self.run_in_event_base_thread(_get).result()

    def get_adjacencies(self, area: str = "0") -> AdjacencyDatabase:
        return self.run_in_event_base_thread(
            lambda: self.build_adjacency_database(area)
        ).result()

    def get_state(self) -> LinkMonitorState:
        return self.run_in_event_base_thread(
            lambda: LinkMonitorState(
                is_overloaded=self.state.is_overloaded,
                overloaded_links=set(self.state.overloaded_links),
                link_metric_overrides=dict(self.state.link_metric_overrides),
                node_label=self.state.node_label,
                adj_metric_overrides=dict(self.state.adj_metric_overrides),
                node_metric_increment_val=self.state.node_metric_increment_val,
            )
        ).result()
