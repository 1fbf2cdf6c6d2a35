"""PrefixManager: owns what this node advertises into the network.

Port of `openr_tpu.prefix_manager.prefix_manager` (reference:
PrefixManager, openr/prefix-manager/PrefixManager.{h,cpp}; doc
openr/docs/Protocol_Guide/PrefixManager.md):

- tracks originated prefixes per source type (LOOPBACK / BGP / RIB /
  CONFIG / ...) from the prefixUpdatesQueue (ADD / WITHDRAW /
  WITHDRAW_BY_TYPE / SYNC_BY_TYPE semantics);
- advertises ONE KvStore key per prefix
  (`prefix:[node]:[area]:[prefix]`, PrefixDatabase with exactly one
  entry) via KvStoreClientInternal.persist_key; the best entry among
  competing source types is selected by PrefixMetrics then type priority;
- withdrawal: short-TTL tombstone with `delete_prefix = True` (Decision
  processes it as a delete) and the key stops being persisted;
- cross-area redistribution: consumes Decision route updates and
  re-advertises learned routes into every *other* area with the source
  area appended to `area_stack` (loop-prevented by Decision's
  self-reflection check);
- originated prefixes (config): aggregates advertised when at least
  `minimum_supporting_routes` more-specific RIB routes exist.
"""

from __future__ import annotations

import ipaddress
import logging
from dataclasses import dataclass, field
from typing import Iterable, Optional

from ..decision.rib import DecisionRouteUpdate
from ..kvstore import KvStoreClientInternal
from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import QueueClosedError, RQueue
from ..serializer import dumps
from ..types import (
    PrefixDatabase,
    PrefixEntry,
    PrefixType,
    PrefixUpdateRequest,
    normalize_prefix,
    prefix_key,
)

log = logging.getLogger(__name__)

WITHDRAW_TTL_MS = 10_000  # tombstone lifetime

# reference: higher type value wins ties only after metrics; the reference
# compares PrefixMetrics first (selectBestPrefixMetrics) then type
_TYPE_PRIORITY = {
    PrefixType.LOOPBACK: 10,
    PrefixType.CONFIG: 20,
    PrefixType.BREEZE: 30,
    PrefixType.PREFIX_ALLOCATOR: 40,
    PrefixType.RIB: 50,
    PrefixType.DEFAULT: 60,
    PrefixType.VIP: 70,
    PrefixType.BGP: 80,
}


@dataclass(slots=True)
class OriginatedPrefixConfig:
    """Reference: thrift::OriginatedPrefix (OpenrConfig.thrift:228)."""

    prefix: str
    minimum_supporting_routes: int = 1
    install_to_fib: bool = False
    forwarding_type: Optional[int] = None
    tags: tuple[str, ...] = ()


@dataclass(slots=True)
class OriginatedRouteState:
    config: OriginatedPrefixConfig
    supporting_routes: set[str] = field(default_factory=set)
    advertised: bool = False


class PrefixManager(OpenrEventBase):
    def __init__(
        self,
        node_name: str,
        kvstore_client: KvStoreClientInternal,
        *,
        prefix_updates: Optional[RQueue[PrefixUpdateRequest]] = None,
        route_updates: Optional[RQueue[DecisionRouteUpdate]] = None,
        areas: tuple[str, ...] = ("0",),
        originated_prefixes: Iterable[OriginatedPrefixConfig] = (),
    ) -> None:
        super().__init__(name=f"prefix-manager-{node_name}")
        self.node_name = node_name
        self.client = kvstore_client
        self._prefix_updates = prefix_updates
        self._route_updates = route_updates
        self.areas = areas
        # prefix -> type -> entry
        self.prefixes: dict[str, dict[PrefixType, PrefixEntry]] = {}
        # prefix -> set of areas currently advertised into
        self._advertised: dict[str, set[str]] = {}
        self.originated: dict[str, OriginatedRouteState] = {
            normalize_prefix(cfg.prefix): OriginatedRouteState(cfg)
            for cfg in originated_prefixes
        }
        self.counters: dict[str, int] = {}

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        self.run_in_event_base_thread(self._setup).result()

    def _setup(self) -> None:
        if self._prefix_updates is not None:
            self.add_fiber_task(self._prefix_updates_fiber(), name="prefixUpdates")
        if self._route_updates is not None:
            self.add_fiber_task(self._route_updates_fiber(), name="routeUpdates")

    async def _prefix_updates_fiber(self) -> None:
        while True:
            try:
                request = await self._prefix_updates.aget()
            except QueueClosedError:
                return
            try:
                self._process_prefix_request(request)
            except Exception:
                log.exception("prefix-manager: request failed")

    async def _route_updates_fiber(self) -> None:
        while True:
            try:
                update = await self._route_updates.aget()
            except QueueClosedError:
                return
            try:
                self._process_route_update(update)
            except Exception:
                log.exception("prefix-manager: route update failed")

    # -- origination API (reference: advertisePrefixes/withdrawPrefixes) -----

    def _process_prefix_request(self, request: PrefixUpdateRequest) -> None:
        ptype = request.type
        changed: set[str] = set()
        for entry in request.prefixes_to_add:
            # fall back to each entry's own origination type when the
            # request doesn't carry one
            changed |= self._add_entry(ptype or entry.type, entry)
        for prefix in request.prefixes_to_del:
            changed |= self._del_entry(ptype, prefix)
        for prefix in changed:
            self._sync_prefix(prefix, request.dst_areas or self.areas)

    def advertise_prefixes(
        self, ptype: PrefixType, entries: list[PrefixEntry]
    ) -> None:
        def _do() -> None:
            changed: set[str] = set()
            for entry in entries:
                changed |= self._add_entry(ptype, entry)
            for prefix in changed:
                self._sync_prefix(prefix, self.areas)

        self.run_in_event_base_thread(_do).result()

    def withdraw_prefixes(self, ptype: PrefixType, prefixes: list[str]) -> None:
        def _do() -> None:
            changed: set[str] = set()
            for prefix in prefixes:
                changed |= self._del_entry(ptype, prefix)
            for prefix in changed:
                self._sync_prefix(prefix, self.areas)

        self.run_in_event_base_thread(_do).result()

    def withdraw_prefixes_by_type(self, ptype: PrefixType) -> None:
        def _do() -> None:
            changed = {
                p for p, by_type in self.prefixes.items() if ptype in by_type
            }
            for prefix in changed:
                self._del_entry(ptype, prefix)
                self._sync_prefix(prefix, self.areas)

        self.run_in_event_base_thread(_do).result()

    def sync_prefixes_by_type(
        self, ptype: PrefixType, entries: list[PrefixEntry]
    ) -> None:
        """Replace the full set for a type (reference: SYNC_PREFIXES_BY_TYPE)."""

        def _do() -> None:
            new = {normalize_prefix(e.prefix) for e in entries}
            changed: set[str] = set()
            for prefix, by_type in list(self.prefixes.items()):
                if ptype in by_type and prefix not in new:
                    changed |= self._del_entry(ptype, prefix)
            for entry in entries:
                changed |= self._add_entry(ptype, entry)
            for prefix in changed:
                self._sync_prefix(prefix, self.areas)

        self.run_in_event_base_thread(_do).result()

    def get_prefixes(self, ptype: Optional[PrefixType] = None) -> list[PrefixEntry]:
        def _get() -> list[PrefixEntry]:
            out = []
            for by_type in self.prefixes.values():
                for t, entry in by_type.items():
                    if ptype is None or t == ptype:
                        out.append(entry)
            return out

        return self.run_in_event_base_thread(_get).result()

    # -- internals -----------------------------------------------------------

    def _add_entry(self, ptype: PrefixType, entry: PrefixEntry) -> set[str]:
        prefix = normalize_prefix(entry.prefix)
        by_type = self.prefixes.setdefault(prefix, {})
        if by_type.get(ptype) == entry:
            return set()
        by_type[ptype] = entry
        self._bump("prefix_manager.advertise_requests")
        return {prefix}

    def _del_entry(self, ptype: Optional[PrefixType], prefix: str) -> set[str]:
        prefix = normalize_prefix(prefix)
        by_type = self.prefixes.get(prefix)
        if by_type is None:
            return set()
        if ptype is None:
            by_type.clear()
        elif by_type.pop(ptype, None) is None:
            return set()
        if not by_type:
            del self.prefixes[prefix]
        self._bump("prefix_manager.withdraw_requests")
        return {prefix}

    def _best_entry(self, prefix: str) -> Optional[PrefixEntry]:
        """Best among source types: PrefixMetrics then type priority
        (reference: PrefixManager.cpp:290 selectBestPrefixMetrics)."""
        by_type = self.prefixes.get(prefix)
        if not by_type:
            return None
        best_type = max(
            by_type,
            key=lambda t: (
                by_type[t].metrics.path_preference,
                by_type[t].metrics.source_preference,
                -by_type[t].metrics.distance,
                _TYPE_PRIORITY.get(t, 0),
            ),
        )
        return by_type[best_type]

    def _sync_prefix(self, prefix: str, areas: Iterable[str]) -> None:
        """(Re-)advertise or withdraw one prefix key per area.

        Any area already present in the selected entry's own `area_stack`
        is treated as a withdrawal even though the entry exists (reference:
        PrefixManager.cpp:239-247 areaStack.count(toArea)): a redistributed
        route must never be advertised back into an area it traversed, and
        if the best-path shift added an area to the stack, the previously
        advertised key there gets tombstoned rather than left stale.
        Computed per-entry so a competing self-originated entry (empty
        stack) winning best-entry selection is unaffected."""
        entry = self._best_entry(prefix)
        skip_areas = set(entry.area_stack) if entry is not None else set()
        advertised = self._advertised.setdefault(prefix, set())
        for area in areas:
            key = prefix_key(self.node_name, prefix, area)
            if entry is not None and area not in skip_areas:
                db = PrefixDatabase(
                    this_node_name=self.node_name,
                    prefix_entries=[entry],
                    area=area,
                )
                self.client.persist_key(area, key, dumps(db))
                advertised.add(area)
                self._bump("prefix_manager.advertised_keys")
            elif area in advertised:
                tombstone = PrefixDatabase(
                    this_node_name=self.node_name,
                    prefix_entries=[PrefixEntry(prefix=prefix)],
                    delete_prefix=True,
                    area=area,
                )
                self.client.clear_key(area, key, dumps(tombstone), WITHDRAW_TTL_MS)
                advertised.discard(area)
                self._bump("prefix_manager.withdrawn_keys")
        if not advertised:
            self._advertised.pop(prefix, None)

    # -- redistribution + originated prefixes (route-update consumer) --------

    def _process_route_update(self, update: DecisionRouteUpdate) -> None:
        # cross-area redistribution (reference: PrefixManager route updates
        # consumer; only meaningful with >= 2 areas)
        if len(self.areas) > 1:
            for prefix, entry in update.unicast_routes_to_update.items():
                best = entry.best_prefix_entry
                if best is None:
                    continue
                src_area = entry.best_area
                redistributed = PrefixEntry(
                    prefix=prefix,
                    type=PrefixType.RIB,
                    forwarding_type=best.forwarding_type,
                    forwarding_algorithm=best.forwarding_algorithm,
                    metrics=best.metrics,
                    tags=best.tags,
                    area_stack=tuple(best.area_stack) + (src_area,),
                    min_nexthop=best.min_nexthop,
                )
                changed = self._add_entry(PrefixType.RIB, redistributed)
                # _sync_prefix skips every area in the entry's area_stack
                # (which includes src_area, appended above)
                for p in changed:
                    self._sync_prefix(p, self.areas)
            for prefix in update.unicast_routes_to_delete:
                for p in self._del_entry(PrefixType.RIB, prefix):
                    self._sync_prefix(p, self.areas)

        # originated-prefix aggregation
        if self.originated:
            self._update_originated(update)

    def _update_originated(self, update: DecisionRouteUpdate) -> None:
        """Count supporting routes per aggregate; advertise when threshold
        met (reference: originated prefixes w/ minimum_supporting_routes)."""
        changed: set[str] = set()
        for agg, state in self.originated.items():
            agg_net = ipaddress.ip_network(agg)
            for prefix in update.unicast_routes_to_update:
                net = ipaddress.ip_network(prefix)
                if (
                    net.version == agg_net.version
                    and net.prefixlen > agg_net.prefixlen
                    and net.subnet_of(agg_net)
                ):
                    state.supporting_routes.add(prefix)
            for prefix in update.unicast_routes_to_delete:
                state.supporting_routes.discard(prefix)
            should_advertise = (
                len(state.supporting_routes)
                >= state.config.minimum_supporting_routes
            )
            if should_advertise != state.advertised:
                state.advertised = should_advertise
                if should_advertise:
                    self._add_entry(
                        PrefixType.CONFIG,
                        PrefixEntry(
                            prefix=agg,
                            type=PrefixType.CONFIG,
                            tags=state.config.tags,
                        ),
                    )
                else:
                    self._del_entry(PrefixType.CONFIG, agg)
                changed.add(agg)
        for prefix in changed:
            self._sync_prefix(prefix, self.areas)

    def get_originated_prefixes(self) -> dict[str, tuple[int, bool]]:
        """prefix -> (supporting route count, advertised)."""
        return self.run_in_event_base_thread(
            lambda: {
                p: (len(s.supporting_routes), s.advertised)
                for p, s in self.originated.items()
            }
        ).result()
