"""Wire types of the node.

Port of `openr_tpu.types` (reference: openr/if/Types.thrift,
openr/if/Network.thrift), as slotted dataclasses with the reference's
field names, order and defaults, so `serializer.dumps` gives the same
bytes in both packages: all 43 of the reference's wire classes, from
the route types to the KvStore-peer, Spark, interface and DUAL
messages.
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


class KvStorePeerState(enum.IntEnum):
    """Reference: openr/kvstore/KvStore.h:278 peer FSM."""

    IDLE = 0
    SYNCING = 1
    INITIALIZED = 2


@dataclass(slots=True)
class PeerSpec:
    peer_addr: str = ""
    ctrl_port: int = 0
    state: KvStorePeerState = KvStorePeerState.IDLE


@dataclass(slots=True)
class PeerEvent:
    area: str = "0"
    peers_to_add: dict[str, PeerSpec] = field(default_factory=dict)
    peers_to_del: list[str] = field(default_factory=list)


@dataclass(slots=True)
class KvStoreSyncEvent:
    node_name: str
    area: str


# -- Spark (reference: openr/if/Types.thrift:1276-1384) ---------------------


@dataclass(slots=True)
class SparkHelloMsg:
    domain_name: str
    node_name: str
    if_name: str
    seq_num: int
    # NOTE: no quotes around the value type — `from __future__ import
    # annotations` already defers evaluation, and an INNER string literal
    # would survive typing.get_type_hints as a plain str, which the wire
    # deserializer cannot resolve to the dataclass
    neighbor_infos: dict[str, ReflectedNeighborInfo] = field(default_factory=dict)
    version: int = 1
    solicit_response: bool = False
    restarting: bool = False
    sent_ts_us: int = 0


@dataclass(slots=True)
class ReflectedNeighborInfo:
    last_nbr_msg_sent_ts_us: int = 0
    last_my_msg_rcvd_ts_us: int = 0


@dataclass(slots=True)
class SparkHandshakeMsg:
    node_name: str
    is_adjacency_established: bool
    hold_time_ms: int
    gr_hold_time_ms: int
    transport_addr_v6: str
    transport_addr_v4: str
    openr_ctrl_port: int
    kvstore_cmd_port: int = 0
    area: str = "0"
    neighbor_node_name: Optional[str] = None


@dataclass(slots=True)
class SparkHeartbeatMsg:
    node_name: str
    seq_num: int
    hold_time_ms: int = 0


@dataclass(slots=True)
class SparkPacket:
    """One-of wrapper for the three Spark messages (reference:
    thrift::SparkPacket — exactly one member populated at a time)."""

    hello: Optional[SparkHelloMsg] = None
    handshake: Optional[SparkHandshakeMsg] = None
    heartbeat: Optional[SparkHeartbeatMsg] = None
    version: int = 1


class NeighborEventType(enum.IntEnum):
    NEIGHBOR_UP = 1
    NEIGHBOR_DOWN = 2
    NEIGHBOR_RESTARTED = 3
    NEIGHBOR_RTT_CHANGE = 4
    NEIGHBOR_RESTARTING = 5
    NEIGHBOR_ADJ_SYNCED = 6


@dataclass(slots=True)
class NeighborEvent:
    event_type: NeighborEventType
    node_name: str
    if_name: str
    remote_if_name: str = ""
    area: str = "0"
    neighbor_addr_v6: str = ""
    neighbor_addr_v4: str = ""
    ctrl_port: int = 0
    rtt_us: int = 0
    kvstore_port: int = 0
    adj_only_used_by_other_node: bool = False


# -- interfaces (reference: openr/if/Types.thrift:1100-1150) ----------------


@dataclass(slots=True)
class InterfaceInfo:
    if_name: str
    is_up: bool
    if_index: int
    networks: list[str] = field(default_factory=list)


@dataclass(slots=True)
class InterfaceDatabase:
    this_node_name: str
    interfaces: dict[str, InterfaceInfo] = field(default_factory=dict)


# -- netlink events, LinkMonitor's input (reference: openr/nl/NetlinkTypes.h)


@dataclass(slots=True)
class LinkEvent:
    if_name: str
    if_index: int
    is_up: bool


@dataclass(slots=True)
class AddrEvent:
    if_name: str
    prefix: str  # CIDR
    is_valid: bool  # False == address removed


@dataclass(slots=True)
class PrefixUpdateRequest:
    """Advertise/withdraw origination requests into PrefixManager
    (reference: PrefixUpdateRequest via prefixUpdatesQueue)."""

    prefixes_to_add: list[PrefixEntry] = field(default_factory=list)
    prefixes_to_del: list[str] = field(default_factory=list)
    type: Optional[PrefixType] = None  # origination source
    dst_areas: tuple[str, ...] = ()


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


# -- DUAL flood-topology wire types (reference: openr/if/Types.thrift:461-846)


class DualMessageType(enum.IntEnum):
    """Reference: thrift::DualMessageType (Types.thrift:461-468)."""

    UPDATE = 1
    QUERY = 2
    REPLY = 3


@dataclass(slots=True)
class DualMessage:
    """One DUAL protocol message for a given root
    (reference: thrift::DualMessage, Types.thrift:470-485)."""

    dst_id: str = ""  # root id this message is about
    distance: int = 0  # sender's report distance (INT64_MAX = infinity)
    type: DualMessageType = DualMessageType.UPDATE


@dataclass(slots=True)
class DualMessages:
    """Batch of DUAL messages from one neighbor
    (reference: thrift::DualMessages, Types.thrift:490-500)."""

    src_id: str = ""
    messages: list[DualMessage] = field(default_factory=list)


@dataclass(slots=True)
class FloodTopoSetParams:
    """Set/unset myself as a child of a peer's SPT
    (reference: thrift::FloodTopoSetParams, Types.thrift:787-805)."""

    root_id: str = ""
    src_id: str = ""
    set_child: bool = False
    all_roots: Optional[bool] = None


@dataclass(slots=True)
class SptInfo:
    """Per-root SPT view (reference: thrift::SptInfo, Types.thrift:819-835)."""

    passive: bool = False
    cost: int = 0
    parent: Optional[str] = None
    children: list[str] = field(default_factory=list)


@dataclass(slots=True)
class SptInfos:
    """FLOOD_TOPO_GET response
    (reference: thrift::SptInfos, Types.thrift:838-860)."""

    infos: dict[str, SptInfo] = field(default_factory=dict)
    flood_root_id: Optional[str] = None
    flood_peers: list[str] = field(default_factory=list)
