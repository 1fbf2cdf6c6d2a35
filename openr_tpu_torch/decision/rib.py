"""RIB entries, the computed route DB and route-update deltas.

Port of `openr_tpu.decision.rib` (reference: openr/decision/RibEntry.h,
openr/decision/RouteUpdate.h, DecisionRouteDb in
openr/decision/Decision.h:56-88 and Decision.cpp:109-160).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..serializer import register_type
from ..types import (
    MplsRoute,
    NextHop,
    PerfEvents,
    PrefixEntry,
    PrefixType,
    UnicastRoute,
)


@register_type
@dataclass(slots=True)
class RibUnicastEntry:
    """Reference: RibUnicastEntry (openr/decision/RibEntry.h:38-100)."""

    prefix: str  # canonical CIDR
    nexthops: frozenset[NextHop] = frozenset()
    best_prefix_entry: Optional[PrefixEntry] = None
    best_area: str = ""
    do_not_install: bool = False

    def __eq__(self, other) -> bool:
        # bestArea intentionally excluded, matching the reference's
        # operator== (RibEntry.h:66-70)
        return (
            isinstance(other, RibUnicastEntry)
            and self.prefix == other.prefix
            and self.best_prefix_entry == other.best_prefix_entry
            and self.do_not_install == other.do_not_install
            and self.nexthops == other.nexthops
        )

    def to_unicast_route(self) -> UnicastRoute:
        return UnicastRoute(
            dest=self.prefix, next_hops=sorted(self.nexthops, key=_nh_sort_key)
        )

    @property
    def is_bgp(self) -> bool:
        return (
            self.best_prefix_entry is not None
            and self.best_prefix_entry.type == PrefixType.BGP
        )


@register_type
@dataclass(slots=True)
class RibMplsEntry:
    """Reference: RibMplsEntry (openr/decision/RibEntry.h:102-145)."""

    label: int
    nexthops: frozenset[NextHop] = frozenset()

    def to_mpls_route(self) -> MplsRoute:
        return MplsRoute(
            top_label=self.label, next_hops=sorted(self.nexthops, key=_nh_sort_key)
        )


def _nh_sort_key(nh: NextHop):
    return (
        nh.address,
        nh.if_name or "",
        nh.metric,
        nh.neighbor_node_name or "",
        nh.area or "",
    )


@register_type
@dataclass(slots=True)
class DecisionRouteUpdate:
    """The delta Decision publishes and Fib consumes (reference:
    openr/decision/RouteUpdate.h:23)."""

    unicast_routes_to_update: dict[str, RibUnicastEntry] = field(
        default_factory=dict
    )
    unicast_routes_to_delete: list[str] = field(default_factory=list)
    mpls_routes_to_update: list[RibMplsEntry] = field(default_factory=list)
    mpls_routes_to_delete: list[int] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None

    def add_route_to_update(self, route: RibUnicastEntry) -> None:
        if route.prefix in self.unicast_routes_to_update:
            raise ValueError(f"duplicate unicast route {route.prefix}")
        self.unicast_routes_to_update[route.prefix] = route

    def empty(self) -> bool:
        return not (
            self.unicast_routes_to_update
            or self.unicast_routes_to_delete
            or self.mpls_routes_to_update
            or self.mpls_routes_to_delete
        )


@register_type
@dataclass(slots=True)
class DecisionRouteDb:
    """Computed route state (reference: DecisionRouteDb)."""

    unicast_routes: dict[str, RibUnicastEntry] = field(default_factory=dict)
    mpls_routes: dict[int, RibMplsEntry] = field(default_factory=dict)

    def add_unicast_route(self, route: RibUnicastEntry) -> None:
        if route.prefix in self.unicast_routes:
            raise ValueError(f"duplicate unicast route {route.prefix}")
        self.unicast_routes[route.prefix] = route

    def add_mpls_route(self, route: RibMplsEntry) -> None:
        if route.label in self.mpls_routes:
            raise ValueError(f"duplicate MPLS route {route.label}")
        self.mpls_routes[route.label] = route

    def calculate_update(self, new_db: "DecisionRouteDb") -> DecisionRouteUpdate:
        """The delta from this DB to `new_db` (reference:
        DecisionRouteDb::calculateUpdate, Decision.cpp:111-147)."""
        delta = DecisionRouteUpdate()
        for prefix, entry in new_db.unicast_routes.items():
            if self.unicast_routes.get(prefix) != entry:
                delta.add_route_to_update(entry)
        delta.unicast_routes_to_delete = [
            p for p in self.unicast_routes if p not in new_db.unicast_routes
        ]
        delta.mpls_routes_to_update = [
            entry
            for label, entry in new_db.mpls_routes.items()
            if self.mpls_routes.get(label) != entry
        ]
        delta.mpls_routes_to_delete = [
            label for label in self.mpls_routes if label not in new_db.mpls_routes
        ]
        return delta

    def update(self, delta: DecisionRouteUpdate) -> None:
        """Apply a delta (reference: DecisionRouteDb::update,
        Decision.cpp:149-163)."""
        for prefix in delta.unicast_routes_to_delete:
            self.unicast_routes.pop(prefix, None)
        self.unicast_routes.update(delta.unicast_routes_to_update)
        for label in delta.mpls_routes_to_delete:
            self.mpls_routes.pop(label, None)
        for entry in delta.mpls_routes_to_update:
            self.mpls_routes[entry.label] = entry
