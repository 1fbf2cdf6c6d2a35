"""RibPolicy: dynamic TTL'd transformation of computed routes.

Port of `openr_tpu.decision.rib_policy` (reference: RibPolicy,
openr/decision/RibPolicy.{h,cpp}; thrift types openr/if/OpenrCtrl.thrift:82-164):
match routes by prefix/tag, then re-weight next-hops (neighbor weight >
area weight > default weight; weight 0 drops the next-hop).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

from ..serializer import register_type
from ..types import normalize_prefix
from .rib import RibUnicastEntry


@register_type
@dataclass(slots=True)
class RibRouteActionWeight:
    """Reference: thrift::RibRouteActionWeight (OpenrCtrl.thrift:95)."""

    default_weight: int = 0
    area_to_weight: dict[str, int] = field(default_factory=dict)
    neighbor_to_weight: dict[str, int] = field(default_factory=dict)


@register_type
@dataclass(slots=True)
class RibPolicyStatementConfig:
    """Reference: thrift::RibPolicyStatement (OpenrCtrl.thrift:120)."""

    name: str = ""
    prefixes: list[str] | None = None
    tags: list[str] | None = None
    set_weight: RibRouteActionWeight | None = None


@register_type
@dataclass(slots=True)
class RibPolicyConfig:
    """Reference: thrift::RibPolicy (OpenrCtrl.thrift:140)."""

    statements: list[RibPolicyStatementConfig] = field(default_factory=list)
    ttl_secs: int = 0


class PolicyError(ValueError):
    pass


class RibPolicyStatement:
    """Reference: RibPolicyStatement (RibPolicy.cpp:19-160)."""

    def __init__(self, cfg: RibPolicyStatementConfig) -> None:
        if cfg.set_weight is None:
            raise PolicyError("Missing policy_statement.action.set_weight")
        if cfg.prefixes is None and cfg.tags is None:
            raise PolicyError(
                "Missing policy_statement.matcher.prefixes or tags"
            )
        self.name = cfg.name
        self.prefix_set = {normalize_prefix(p) for p in cfg.prefixes or ()}
        self.tag_set = set(cfg.tags or ())
        self.action = cfg.set_weight

    def to_config(self) -> RibPolicyStatementConfig:
        return RibPolicyStatementConfig(
            name=self.name,
            prefixes=sorted(self.prefix_set) or None,
            tags=sorted(self.tag_set) or None,
            set_weight=RibRouteActionWeight(
                default_weight=self.action.default_weight,
                area_to_weight=dict(self.action.area_to_weight),
                neighbor_to_weight=dict(self.action.neighbor_to_weight),
            ),
        )

    def match(self, route: RibUnicastEntry) -> bool:
        if not self.tag_set and not self.prefix_set:
            return False
        tag_match = not self.tag_set or bool(
            route.best_prefix_entry
            and self.tag_set.intersection(route.best_prefix_entry.tags)
        )
        prefix_match = not self.prefix_set or route.prefix in self.prefix_set
        return tag_match and prefix_match

    def apply_action(self, route: RibUnicastEntry) -> bool:
        """Re-weight next-hops in place; returns True iff transformed."""
        if not self.match(route):
            return False
        new_nexthops = set()
        for nh in route.nexthops:
            weight = self.action.default_weight
            if nh.area is not None:
                weight = self.action.area_to_weight.get(nh.area, weight)
            if nh.neighbor_node_name is not None:
                weight = self.action.neighbor_to_weight.get(
                    nh.neighbor_node_name, weight
                )
            if weight > 0:
                new_nexthops.add(replace(nh, weight=weight))
        if not new_nexthops:
            # retain existing next-hops rather than blackhole
            # (RibPolicy.cpp:146-158)
            return False
        route.nexthops = frozenset(new_nexthops)
        return True


@dataclass(slots=True)
class PolicyChange:
    updated_routes: list[str] = field(default_factory=list)
    deleted_routes: list[str] = field(default_factory=list)


class RibPolicy:
    """Reference: RibPolicy (RibPolicy.cpp:165-240)."""

    def __init__(self, cfg: RibPolicyConfig) -> None:
        if not cfg.statements:
            raise PolicyError("Missing policy.statements")
        self.statements = [RibPolicyStatement(s) for s in cfg.statements]
        self._valid_until = time.monotonic() + cfg.ttl_secs

    def to_config(self) -> RibPolicyConfig:
        return RibPolicyConfig(
            statements=[s.to_config() for s in self.statements],
            ttl_secs=max(0, int(self.get_ttl_duration_s())),
        )

    def get_ttl_duration_s(self) -> float:
        return self._valid_until - time.monotonic()

    def is_active(self) -> bool:
        return self.get_ttl_duration_s() > 0

    def match(self, route: RibUnicastEntry) -> bool:
        return any(s.match(route) for s in self.statements)

    def apply_action(self, route: RibUnicastEntry) -> bool:
        """First matching statement wins."""
        return any(s.apply_action(route) for s in self.statements)

    def apply_policy(
        self, unicast_entries: dict[str, RibUnicastEntry]
    ) -> PolicyChange:
        change = PolicyChange()
        if not self.is_active():
            return change
        for prefix, entry in unicast_entries.items():
            if self.apply_action(entry):
                assert entry.nexthops
                change.updated_routes.append(prefix)
        return change
