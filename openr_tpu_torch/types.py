"""Wire types of the Decision → Fib path.

Port of the part of `openr_tpu.types` that KvStore publications,
Decision, the route build and Fib carry (reference: openr/if/Types.thrift,
openr/if/Network.thrift), as slotted dataclasses with the reference's
field names, order and defaults, so `serializer.dumps` gives the same
bytes in both packages.  The Spark, KvStore-peer and DUAL messages are
not here yet.
"""

from __future__ import annotations

import enum
import ipaddress
import time
from dataclasses import dataclass, field
from typing import Optional


# -- perf events (reference: openr/if/Types.thrift:29-52) -------------------


@dataclass(slots=True)
class PerfEvent:
    node_name: str
    event_name: str
    unix_ts_ms: int


@dataclass(slots=True)
class PerfEvents:
    events: list[PerfEvent] = field(default_factory=list)

    def add(self, node_name: str, event_name: str, ts_ms: Optional[int] = None) -> None:
        ts = ts_ms if ts_ms is not None else int(time.time() * 1000)
        self.events.append(PerfEvent(node_name, event_name, ts))

    def total_duration_ms(self) -> int:
        if len(self.events) < 2:
            return 0
        return self.events[-1].unix_ts_ms - self.events[0].unix_ts_ms

    def duration_between_ms(self, start_event: str, end_event: str) -> int:
        """Reference: getDurationBetweenPerfEvents, openr/common/Util.h:147."""
        start = next((e for e in self.events if e.event_name == start_event), None)
        end = next((e for e in self.events if e.event_name == end_event), None)
        if start is None or end is None:
            missing = start_event if start is None else end_event
            raise ValueError(f"perf event {missing!r} not recorded")
        if end.unix_ts_ms < start.unix_ts_ms:
            raise ValueError(f"{end_event} precedes {start_event}")
        return end.unix_ts_ms - start.unix_ts_ms


def add_perf_event(perf_events: Optional[PerfEvents], node: str, event: str) -> None:
    if perf_events is not None:
        perf_events.add(node, event)


# -- adjacency / link state (reference: openr/if/Types.thrift:96-175) -------


@dataclass(slots=True)
class Adjacency:
    other_node_name: str
    if_name: str
    metric: int = 1
    adj_label: int = 0
    is_overloaded: bool = False
    rtt_us: int = 0
    timestamp_s: int = 0
    weight: int = 1
    other_if_name: str = ""
    next_hop_v6: str = ""
    next_hop_v4: str = ""


@dataclass(slots=True)
class AdjacencyDatabase:
    this_node_name: str
    adjacencies: list[Adjacency] = field(default_factory=list)
    is_overloaded: bool = False
    node_label: int = 0
    area: str = "0"
    perf_events: Optional[PerfEvents] = None
    # soft-drain (reference: nodeMetricIncrementVal): added to every
    # adjacency metric this node originates
    node_metric_increment_val: int = 0


# -- prefixes (reference: openr/if/Types.thrift:200-420) --------------------


class PrefixType(enum.IntEnum):
    LOOPBACK = 1
    DEFAULT = 2
    BGP = 3
    PREFIX_ALLOCATOR = 4
    BREEZE = 5
    RIB = 6
    CONFIG = 7
    VIP = 8


class PrefixForwardingType(enum.IntEnum):
    IP = 0
    SR_MPLS = 1


class PrefixForwardingAlgorithm(enum.IntEnum):
    SP_ECMP = 0
    KSP2_ED_ECMP = 1
    SP_UCMP_ADJ_WEIGHT_PROPAGATION = 3
    SP_UCMP_PREFIX_WEIGHT_PROPAGATION = 4


@dataclass(slots=True)
class PrefixMetrics:
    """Ordered comparison chain for best-route selection (higher is
    better for preferences, lower is better for distance)."""

    version: int = 1
    path_preference: int = 1000
    source_preference: int = 100
    distance: int = 0


@dataclass(slots=True)
class PrefixEntry:
    prefix: str  # CIDR string, canonicalized
    type: PrefixType = PrefixType.LOOPBACK
    forwarding_type: PrefixForwardingType = PrefixForwardingType.IP
    forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    )
    metrics: PrefixMetrics = field(default_factory=PrefixMetrics)
    tags: tuple[str, ...] = ()
    area_stack: tuple[str, ...] = ()
    min_nexthop: Optional[int] = None
    prepend_label: Optional[int] = None
    weight: Optional[int] = None
    # BGP best-path metric vector (reference: Types.thrift:389 `mv`);
    # carried, not interpreted: BGP selection is not ported yet
    mv: Optional["MetricVector"] = None


class CompareType(enum.IntEnum):
    """Reference: Types.thrift:235 CompareType."""

    WIN_IF_PRESENT = 1
    WIN_IF_NOT_PRESENT = 2
    IGNORE_IF_NOT_PRESENT = 3


@dataclass(slots=True)
class MetricEntity:
    """One BGP path attribute of a MetricVector (Types.thrift:237)."""

    type: int
    priority: int  # higher compares first
    op: CompareType = CompareType.IGNORE_IF_NOT_PRESENT
    is_best_path_tie_breaker: bool = False
    metric: tuple[int, ...] = ()  # lexicographic, larger wins


@dataclass(slots=True)
class MetricVector:
    """BGP-style best-path metric vector (Types.thrift:273)."""

    version: int = 1
    metrics: list[MetricEntity] = field(default_factory=list)


@dataclass(slots=True)
class PrefixDatabase:
    this_node_name: str
    prefix_entries: list[PrefixEntry] = field(default_factory=list)
    delete_prefix: bool = False
    area: str = "0"
    perf_events: Optional[PerfEvents] = None


# -- KvStore (reference: openr/if/Types.thrift:555-1000) --------------------


@dataclass(slots=True)
class Value:
    """Versioned KvStore value; `value is None` is a version-only
    advertisement (a TTL refresh), like an unset thrift optional."""

    version: int
    originator_id: str
    value: Optional[bytes] = None
    ttl_ms: int = -1  # -1 == infinity (Constants::kTtlInfinity)
    ttl_version: int = 0
    hash: Optional[int] = None


@dataclass(slots=True)
class Publication:
    key_vals: dict[str, Value] = field(default_factory=dict)
    expired_keys: list[str] = field(default_factory=list)
    node_ids: Optional[list[str]] = None
    tobe_updated_keys: Optional[list[str]] = None
    area: str = "0"
    flood_root_id: Optional[str] = None


# -- routes (reference: openr/if/Network.thrift:66-160) ---------------------


class MplsActionCode(enum.IntEnum):
    PUSH = 0
    SWAP = 1
    PHP = 2  # penultimate hop popping => POP_AND_LOOKUP for last hop
    POP_AND_LOOKUP = 3


@dataclass(slots=True, frozen=True)
class MplsAction:
    action: MplsActionCode
    swap_label: Optional[int] = None
    push_labels: Optional[tuple[int, ...]] = None


@dataclass(slots=True, frozen=True)
class NextHop:
    """Reference: NextHopThrift openr/if/Network.thrift:66."""

    address: str
    if_name: Optional[str] = None
    metric: int = 0
    weight: int = 0
    area: Optional[str] = None
    neighbor_node_name: Optional[str] = None
    mpls_action: Optional[MplsAction] = None


@dataclass(slots=True)
class UnicastRoute:
    dest: str
    next_hops: list[NextHop] = field(default_factory=list)


@dataclass(slots=True)
class MplsRoute:
    top_label: int
    next_hops: list[NextHop] = field(default_factory=list)


@dataclass(slots=True)
class RouteDatabase:
    this_node_name: str
    unicast_routes: list[UnicastRoute] = field(default_factory=list)
    mpls_routes: list[MplsRoute] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None


# -- keys and helpers -------------------------------------------------------


def normalize_prefix(prefix: str) -> str:
    """Canonicalize a CIDR string."""
    return str(ipaddress.ip_network(prefix, strict=False))


def prefix_key(node: str, prefix: str, area: str) -> str:
    """KvStore key of a prefix advertisement (reference:
    Constants::kPrefixDbMarker + PrefixKey, openr/common/Constants.h:212)."""
    return f"prefix:[{node}]:[{area}]:[{normalize_prefix(prefix)}]"


def parse_prefix_key(key: str) -> Optional[tuple[str, str, str]]:
    """`prefix:[node]:[area]:[cidr]` -> (node, area, prefix), or None
    (reference: PrefixKey::fromStr, openr/common/Util.cpp)."""
    if not key.startswith("prefix:"):
        return None
    parts = key[len("prefix:") :].split("]:[")
    if len(parts) != 3 or not parts[0].startswith("[") or not parts[2].endswith("]"):
        return None
    try:
        return parts[0][1:], parts[1], normalize_prefix(parts[2][:-1])
    except ValueError:
        return None


def node_name_from_key(key: str) -> str:
    """Second ':'-separated token, brackets stripped (reference:
    getNodeNameFromKey, openr/common/Util.cpp:891)."""
    parts = key.split(":")
    if len(parts) < 2:
        return ""
    node = parts[1]
    if node.startswith("[") and node.endswith("]"):
        return node[1:-1]
    return node[1:] if node.startswith("[") else node


def adj_key(node: str) -> str:
    """Reference: Constants::kAdjDbMarker (openr/common/Constants.h:209)."""
    return f"adj:{node}"


ADJ_MARKER = "adj:"
PREFIX_MARKER = "prefix:"
TTL_INFINITY = -1
