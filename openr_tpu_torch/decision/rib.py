"""RIB entries and the computed route DB.

Port of `openr_tpu.decision.rib` (reference: openr/decision/RibEntry.h,
DecisionRouteDb in openr/decision/Decision.h:56-88).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types import NextHop, PrefixEntry


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


@dataclass(slots=True)
class RibMplsEntry:
    """Reference: RibMplsEntry (openr/decision/RibEntry.h:102-145)."""

    label: int
    nexthops: frozenset[NextHop] = frozenset()


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
