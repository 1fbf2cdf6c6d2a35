"""Wire types the route build reads.

The subset of `openr_tpu.types` that link state, prefix state and the
route build consume (reference: openr/if/Types.thrift,
openr/if/Network.thrift), as slotted dataclasses with the same field
names and defaults.
"""

from __future__ import annotations

import enum
import ipaddress
from dataclasses import dataclass, field
from typing import Optional


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
    # soft-drain (reference: nodeMetricIncrementVal): added to every
    # adjacency metric this node originates
    node_metric_increment_val: int = 0


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


def normalize_prefix(prefix: str) -> str:
    """Canonicalize a CIDR string."""
    return str(ipaddress.ip_network(prefix, strict=False))
