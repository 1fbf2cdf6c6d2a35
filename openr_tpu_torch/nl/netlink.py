"""rtnetlink codec + event socket, from scratch (no pyroute2 et al).

Port of `openr_tpu.nl.netlink` (reference surface, openr/nl/):
- message codec: NetlinkMessage framing (NetlinkMessage.h:39) for
  RTM_GETLINK / RTM_GETADDR / RTM_GETROUTE / RTM_GETNEIGH dumps, the
  RTM_NEWROUTE / DELROUTE (unicast, multipath, AF_MPLS, MPLS push
  encap), RTM_NEWADDR / DELADDR and RTM_NEWNEIGH / DELNEIGH request
  encoders, and the link / address / route / MPLS-route / neighbor
  parsers (NetlinkRoute.h:41-255); request bytes are the reference's
- `NetlinkProtocolSocket` (NetlinkProtocolSocket.h:96): AF_NETLINK socket
  in its own event base, initial full dumps, kernel multicast-group
  subscription (RTMGRP_LINK + v4/v6 IFADDR), typed events pushed to the
  daemon's netlink-events queue — the producer the LinkMonitor dataflow
  starts from (netlink -> netlinkEventsQueue -> LinkMonitor) — and the
  synchronous route, address and neighbor programming the platform
  agent's `KernelRouteTable` and the PrefixAllocator use.

Host code: it computes nothing and takes no device.
"""

from __future__ import annotations

import asyncio
import errno
import ipaddress
import socket
import struct
from dataclasses import dataclass
from typing import Iterator, Optional

from ..runtime.eventbase import OpenrEventBase
from ..runtime.queue import ReplicateQueue
from ..types import AddrEvent, LinkEvent

# netlink protocol constants (linux/netlink.h, linux/rtnetlink.h)
NETLINK_ROUTE = 0

NLMSG_NOOP = 1
NLMSG_ERROR = 2
NLMSG_DONE = 3

NLM_F_REQUEST = 0x01
NLM_F_MULTI = 0x02
NLM_F_ROOT = 0x100
NLM_F_MATCH = 0x200
NLM_F_DUMP = NLM_F_ROOT | NLM_F_MATCH

RTM_NEWLINK = 16
RTM_DELLINK = 17
RTM_GETLINK = 18
RTM_NEWADDR = 20
RTM_DELADDR = 21
RTM_GETADDR = 22
RTM_NEWROUTE = 24
RTM_DELROUTE = 25
RTM_GETROUTE = 26
RTM_NEWNEIGH = 28
RTM_DELNEIGH = 29
RTM_GETNEIGH = 30

NLM_F_CREATE = 0x400
NLM_F_REPLACE = 0x100
NLM_F_ACK = 0x04

RTMGRP_LINK = 0x1
RTMGRP_IPV4_IFADDR = 0x10
RTMGRP_IPV6_IFADDR = 0x100
RTMGRP_IPV4_ROUTE = 0x40
RTMGRP_IPV6_ROUTE = 0x400

IFF_UP = 0x1
IFF_RUNNING = 0x40

IFLA_IFNAME = 3
IFA_ADDRESS = 1
IFA_LOCAL = 2

# rtattr types for RTM_*ROUTE (linux/rtnetlink.h)
RTA_DST = 1
RTA_OIF = 4
RTA_GATEWAY = 5
RTA_PRIORITY = 6
RTA_MULTIPATH = 9
RTA_TABLE = 15
RTA_VIA = 18
RTA_NEWDST = 19
RTA_ENCAP_TYPE = 21
RTA_ENCAP = 22
# lwtunnel encap (linux/lwtunnel.h, linux/mpls_iptunnel.h) — label PUSH
# on IP routes rides an MPLS encap, exactly as the reference programs it
# (openr/nl/NetlinkRoute.cpp addNextHops push path)
LWTUNNEL_ENCAP_MPLS = 1
MPLS_IPTUNNEL_DST = 1

# ndattr types for RTM_*NEIGH (linux/neighbour.h)
NDA_DST = 1
NDA_LLADDR = 2

RT_TABLE_MAIN = 254
RT_SCOPE_UNIVERSE = 0
RT_SCOPE_LINK = 253
RTN_UNICAST = 1
# reference: openr's kernel route protocol id (Platform.thrift FibClient
# -> protocol mapping, openr/if/Platform.thrift:23; kRouteProtoId 99)
RTPROT_OPENR = 99

AF_MPLS = 28

_NLMSGHDR = struct.Struct("=IHHII")  # len, type, flags, seq, pid
_IFINFOMSG = struct.Struct("=BxHiII")  # family, type, index, flags, change
_IFADDRMSG = struct.Struct("=BBBBi")  # family, prefixlen, flags, scope, index
_RTMSG = struct.Struct("=BBBBBBBBI")  # family, dst_len, src_len, tos,
#   table, protocol, scope, type, flags
_RTNEXTHOP = struct.Struct("=HBBi")  # len, flags, hops (weight-1), ifindex
_NDMSG = struct.Struct("=BxxxiHBB")  # family, ifindex, state, flags, type
_RTATTR = struct.Struct("=HH")  # len, type
_GENMSG = struct.Struct("=Bxxx")  # rtgenmsg: family


class NetlinkError(OSError):
    pass


def _align4(n: int) -> int:
    return (n + 3) & ~3


def _walk_rtattrs(data: bytes) -> Iterator[tuple[int, bytes]]:
    """Yield (attr_type, payload) over an rtattr chain."""
    off = 0
    while off + _RTATTR.size <= len(data):
        alen, atype = _RTATTR.unpack_from(data, off)
        if alen < _RTATTR.size:
            return
        yield atype, data[off + _RTATTR.size : off + alen]
        off += _align4(alen)


@dataclass(slots=True)
class LinkInfo:
    """Reference: openr::fbnl::Link (NetlinkTypes.h)."""

    if_index: int
    if_name: str
    flags: int

    @property
    def is_up(self) -> bool:
        return bool(self.flags & IFF_UP)


@dataclass(slots=True)
class AddrInfo:
    """Reference: openr::fbnl::IfAddress (NetlinkTypes.h)."""

    if_index: int
    family: int
    prefix: str  # CIDR
    is_valid: bool = True  # False for RTM_DELADDR


@dataclass(slots=True)
class NextHopInfo:
    """One path of a (possibly multipath) kernel route
    (reference: openr::fbnl::NextHop, NetlinkTypes.h:48).

    `push_labels` (IP routes): MPLS encap label stack (RTA_ENCAP).
    `swap_labels` (AF_MPLS routes): outgoing stack (RTA_NEWDST); an MPLS
    nexthop without swap_labels pops the top label (PHP/POP)."""

    gateway: Optional[str] = None  # ip address string
    if_index: int = 0
    weight: int = 1  # rtnh_hops + 1
    push_labels: tuple = ()  # lwtunnel MPLS encap (IP routes)
    swap_labels: tuple = ()  # RTA_NEWDST (MPLS routes)


@dataclass(slots=True)
class MplsRouteInfo:
    """Kernel AF_MPLS label route (reference: NetlinkRouteMessage MPLS
    parse/build, openr/nl/NetlinkRoute.h:41-176; label stacks in
    NetlinkTypes.h:48-285).  Nexthop gateways ride RTA_VIA."""

    label: int
    protocol: int = RTPROT_OPENR
    nexthops: list[NextHopInfo] = None  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.nexthops is None:
            self.nexthops = []


@dataclass(slots=True)
class RouteInfo:
    """Kernel unicast route (reference: openr::fbnl::Route,
    NetlinkTypes.h:141; message codec NetlinkRoute.h:41)."""

    dst: str  # CIDR
    family: int = socket.AF_INET6
    table: int = RT_TABLE_MAIN
    protocol: int = RTPROT_OPENR
    scope: int = RT_SCOPE_UNIVERSE
    rtype: int = RTN_UNICAST
    priority: Optional[int] = None
    nexthops: list[NextHopInfo] = None  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.nexthops is None:
            self.nexthops = []


@dataclass(slots=True)
class NeighborInfo:
    """Kernel neighbor entry (reference: NetlinkNeighborMessage,
    NetlinkRoute.h:255; openr::fbnl::Neighbor)."""

    if_index: int
    family: int
    dst: str
    lladdr: Optional[str] = None
    state: int = 0


@dataclass(slots=True)
class NetlinkMsg:
    msg_type: int
    link: Optional[LinkInfo] = None
    addr: Optional[AddrInfo] = None
    route: Optional[RouteInfo] = None
    mpls_route: Optional[MplsRouteInfo] = None
    neigh: Optional[NeighborInfo] = None
    error: int = 0
    # header identity, so request/reply correlation can reject stray or
    # late messages on shared request sockets (advisor r3)
    seq: int = 0
    pid: int = 0


def _parse_link(payload: bytes) -> LinkInfo:
    family, _type, index, flags, _change = _IFINFOMSG.unpack_from(payload, 0)
    name = ""
    for atype, adata in _walk_rtattrs(payload[_IFINFOMSG.size :]):
        if atype == IFLA_IFNAME:
            name = adata.rstrip(b"\x00").decode()
    return LinkInfo(if_index=index, if_name=name, flags=flags)


def _parse_addr(payload: bytes, deleted: bool) -> Optional[AddrInfo]:
    family, prefixlen, _flags, _scope, index = _IFADDRMSG.unpack_from(
        payload, 0
    )
    address: Optional[bytes] = None
    local: Optional[bytes] = None
    for atype, adata in _walk_rtattrs(payload[_IFADDRMSG.size :]):
        if atype == IFA_ADDRESS:
            address = adata
        elif atype == IFA_LOCAL:
            local = adata
    raw = local or address  # IFA_LOCAL is the interface address on v4 ptp
    if raw is None:
        return None
    try:
        ip = ipaddress.ip_address(raw)
    except ValueError:
        return None
    return AddrInfo(
        if_index=index,
        family=family,
        prefix=f"{ip}/{prefixlen}",
        is_valid=not deleted,
    )


def _rtattr(atype: int, payload: bytes) -> bytes:
    alen = _RTATTR.size + len(payload)
    return _RTATTR.pack(alen, atype) + payload + b"\x00" * (
        _align4(alen) - alen
    )


# -- MPLS label-stack wire format (RFC 3032 entries, linux/mpls.h) ----------


def pack_label_stack(labels: tuple) -> bytes:
    """Label stack entries, 32-bit BE each: label<<12 | tc<<9 | bos<<8 |
    ttl; bottom-of-stack set on the last entry (reference label encode:
    NetlinkRoute.cpp encodeLabel)."""
    out = b""
    for i, label in enumerate(labels):
        bos = 1 if i == len(labels) - 1 else 0
        out += struct.pack(">I", (int(label) << 12) | (bos << 8))
    return out


def unpack_label_stack(data: bytes) -> tuple:
    labels = []
    for off in range(0, len(data) - 3, 4):
        (entry,) = struct.unpack_from(">I", data, off)
        labels.append(entry >> 12)
        if entry & 0x100:  # bottom of stack
            break
    return tuple(labels)


def _pack_via(gateway: str) -> bytes:
    """struct rtvia: u16 family + packed address (RTA_VIA)."""
    ip = ipaddress.ip_address(gateway)
    family = socket.AF_INET if ip.version == 4 else socket.AF_INET6
    return struct.pack("=H", family) + ip.packed


def _unpack_via(data: bytes) -> Optional[str]:
    if len(data) < 2:
        return None
    try:
        return str(ipaddress.ip_address(data[2:]))
    except ValueError:
        return None


def _pack_mpls_encap(push_labels: tuple) -> bytes:
    """RTA_ENCAP_TYPE=MPLS + nested RTA_ENCAP{MPLS_IPTUNNEL_DST} — label
    PUSH on an IP route (reference: NetlinkRoute.cpp push encap)."""
    return _rtattr(
        RTA_ENCAP_TYPE, struct.pack("=H", LWTUNNEL_ENCAP_MPLS)
    ) + _rtattr(
        RTA_ENCAP, _rtattr(MPLS_IPTUNNEL_DST, pack_label_stack(push_labels))
    )


def _parse_mpls_encap(encap_type: Optional[int], encap: Optional[bytes]) -> tuple:
    if encap_type != LWTUNNEL_ENCAP_MPLS or not encap:
        return ()
    for satype, sadata in _walk_rtattrs(encap):
        if satype == MPLS_IPTUNNEL_DST:
            return unpack_label_stack(sadata)
    return ()


def _parse_route(payload: bytes) -> Optional[RouteInfo]:
    family, dst_len, _src_len, _tos, table, protocol, scope, rtype, _flags = (
        _RTMSG.unpack_from(payload, 0)
    )
    dst_bytes: Optional[bytes] = None
    gateway: Optional[bytes] = None
    oif = 0
    priority: Optional[int] = None
    multipath: list[NextHopInfo] = []
    encap_type: Optional[int] = None
    encap: Optional[bytes] = None
    for atype, adata in _walk_rtattrs(payload[_RTMSG.size :]):
        if atype == RTA_DST:
            dst_bytes = adata
        elif atype == RTA_GATEWAY:
            gateway = adata
        elif atype == RTA_OIF:
            (oif,) = struct.unpack("=i", adata)
        elif atype == RTA_PRIORITY:
            (priority,) = struct.unpack("=I", adata)
        elif atype == RTA_TABLE:
            (table,) = struct.unpack("=I", adata)
        elif atype == RTA_ENCAP_TYPE:
            (encap_type,) = struct.unpack_from("=H", adata, 0)
        elif atype == RTA_ENCAP:
            encap = adata
        elif atype == RTA_MULTIPATH:
            off = 0
            while off + _RTNEXTHOP.size <= len(adata):
                rlen, _rflags, hops, ifindex = _RTNEXTHOP.unpack_from(
                    adata, off
                )
                if rlen < _RTNEXTHOP.size:
                    break
                gw: Optional[str] = None
                sub_encap_type: Optional[int] = None
                sub_encap: Optional[bytes] = None
                for satype, sadata in _walk_rtattrs(
                    adata[off + _RTNEXTHOP.size : off + rlen]
                ):
                    if satype == RTA_GATEWAY:
                        try:
                            gw = str(ipaddress.ip_address(sadata))
                        except ValueError:
                            pass
                    elif satype == RTA_ENCAP_TYPE:
                        (sub_encap_type,) = struct.unpack_from(
                            "=H", sadata, 0
                        )
                    elif satype == RTA_ENCAP:
                        sub_encap = sadata
                multipath.append(
                    NextHopInfo(
                        gateway=gw,
                        if_index=ifindex,
                        weight=hops + 1,
                        push_labels=_parse_mpls_encap(
                            sub_encap_type, sub_encap
                        ),
                    )
                )
                off += _align4(rlen)
    if family not in (socket.AF_INET, socket.AF_INET6):
        return None  # AF_MPLS rides _parse_mpls_route
    if dst_bytes is not None:
        try:
            ip = ipaddress.ip_address(dst_bytes)
        except ValueError:
            return None
        dst = f"{ip}/{dst_len}"
    elif dst_len == 0:  # default route carries no RTA_DST
        dst = "0.0.0.0/0" if family == socket.AF_INET else "::/0"
    else:
        return None
    nexthops = multipath
    if not nexthops and (gateway is not None or oif):
        gw = None
        if gateway is not None:
            try:
                gw = str(ipaddress.ip_address(gateway))
            except ValueError:
                gw = None
        nexthops = [
            NextHopInfo(
                gateway=gw,
                if_index=oif,
                push_labels=_parse_mpls_encap(encap_type, encap),
            )
        ]
    return RouteInfo(
        dst=dst,
        family=family,
        table=table,
        protocol=protocol,
        scope=scope,
        rtype=rtype,
        priority=priority,
        nexthops=nexthops,
    )


def _parse_mpls_route(payload: bytes) -> Optional[MplsRouteInfo]:
    """Decode an AF_MPLS RTM_NEWROUTE: incoming label (RTA_DST label
    entry), per-nexthop RTA_VIA gateway + RTA_NEWDST outgoing stack
    (reference route parse: openr/nl/NetlinkRoute.h:41-176,
    parseRoute/parseNextHops MPLS branches)."""
    (
        family,
        _dst_len,
        _src_len,
        _tos,
        _table,
        protocol,
        _scope,
        _rtype,
        _flags,
    ) = _RTMSG.unpack_from(payload, 0)
    if family != AF_MPLS:
        return None
    label: Optional[int] = None
    via: Optional[str] = None
    oif = 0
    newdst: tuple = ()
    multipath: list[NextHopInfo] = []
    for atype, adata in _walk_rtattrs(payload[_RTMSG.size :]):
        if atype == RTA_DST:
            stack = unpack_label_stack(adata)
            label = stack[0] if stack else None
        elif atype == RTA_VIA:
            via = _unpack_via(adata)
        elif atype == RTA_OIF:
            (oif,) = struct.unpack("=i", adata)
        elif atype == RTA_NEWDST:
            newdst = unpack_label_stack(adata)
        elif atype == RTA_MULTIPATH:
            off = 0
            while off + _RTNEXTHOP.size <= len(adata):
                rlen, _rflags, hops, ifindex = _RTNEXTHOP.unpack_from(
                    adata, off
                )
                if rlen < _RTNEXTHOP.size:
                    break
                sub_via: Optional[str] = None
                sub_newdst: tuple = ()
                for satype, sadata in _walk_rtattrs(
                    adata[off + _RTNEXTHOP.size : off + rlen]
                ):
                    if satype == RTA_VIA:
                        sub_via = _unpack_via(sadata)
                    elif satype == RTA_NEWDST:
                        sub_newdst = unpack_label_stack(sadata)
                multipath.append(
                    NextHopInfo(
                        gateway=sub_via,
                        if_index=ifindex,
                        weight=hops + 1,
                        swap_labels=sub_newdst,
                    )
                )
                off += _align4(rlen)
    if label is None:
        return None
    nexthops = multipath or [
        NextHopInfo(gateway=via, if_index=oif, swap_labels=newdst)
    ]
    return MplsRouteInfo(label=label, protocol=protocol, nexthops=nexthops)


def build_mpls_route_request(
    msg_type: int, seq: int, route: MplsRouteInfo
) -> bytes:
    """RTM_NEWROUTE / RTM_DELROUTE for an AF_MPLS label route
    (reference: NetlinkRouteMessage MPLS build, NetlinkRoute.h:41-176).
    A nexthop with swap_labels emits RTA_NEWDST (SWAP); without, the
    kernel pops the top label (PHP/POP — POP_AND_LOOKUP is oif-only)."""
    if msg_type == RTM_NEWROUTE:
        flags = NLM_F_REQUEST | NLM_F_ACK | NLM_F_CREATE | NLM_F_REPLACE
    else:
        flags = NLM_F_REQUEST | NLM_F_ACK
    attrs = _rtattr(RTA_DST, pack_label_stack((route.label,)))

    def nh_attrs(nh: NextHopInfo) -> bytes:
        sub = b""
        if nh.gateway is not None:
            sub += _rtattr(RTA_VIA, _pack_via(nh.gateway))
        if nh.swap_labels:
            sub += _rtattr(RTA_NEWDST, pack_label_stack(nh.swap_labels))
        return sub

    if len(route.nexthops) == 1:
        nh = route.nexthops[0]
        attrs += nh_attrs(nh)
        if nh.if_index:
            attrs += _rtattr(RTA_OIF, struct.pack("=i", nh.if_index))
    elif len(route.nexthops) > 1:
        blob = b""
        for nh in route.nexthops:
            sub = nh_attrs(nh)
            rlen = _RTNEXTHOP.size + len(sub)
            blob += (
                _RTNEXTHOP.pack(rlen, 0, max(nh.weight, 1) - 1, nh.if_index)
                + sub
            )
        attrs += _rtattr(RTA_MULTIPATH, blob)
    body = _RTMSG.pack(
        AF_MPLS,
        20,  # dst_len: one 20-bit label
        0,
        0,
        RT_TABLE_MAIN,
        route.protocol,
        RT_SCOPE_UNIVERSE,
        RTN_UNICAST,
        0,
    ) + attrs
    length = _NLMSGHDR.size + len(body)
    return _NLMSGHDR.pack(length, msg_type, flags, seq, 0) + body


def build_neigh_request(
    msg_type: int,
    seq: int,
    if_index: int,
    dst: str,
    lladdr: Optional[str] = None,
    state: int = 0x80,  # NUD_PERMANENT
) -> bytes:
    """RTM_NEWNEIGH / RTM_DELNEIGH (reference: NetlinkNeighborMessage,
    openr/nl/NetlinkRoute.h:255; NetlinkTypes.h:48-285)."""
    ip = ipaddress.ip_address(dst)
    family = socket.AF_INET if ip.version == 4 else socket.AF_INET6
    if msg_type == RTM_NEWNEIGH:
        flags = NLM_F_REQUEST | NLM_F_ACK | NLM_F_CREATE | NLM_F_REPLACE
    else:
        flags = NLM_F_REQUEST | NLM_F_ACK
        state = 0
    body = _NDMSG.pack(family, if_index, state, 0, 0) + _rtattr(
        NDA_DST, ip.packed
    )
    if lladdr is not None and msg_type == RTM_NEWNEIGH:
        body += _rtattr(
            NDA_LLADDR, bytes(int(b, 16) for b in lladdr.split(":"))
        )
    length = _NLMSGHDR.size + len(body)
    return _NLMSGHDR.pack(length, msg_type, flags, seq, 0) + body


def _parse_neigh(payload: bytes) -> Optional[NeighborInfo]:
    family, ifindex, state, _flags, _ntype = _NDMSG.unpack_from(payload, 0)
    dst: Optional[str] = None
    lladdr: Optional[str] = None
    for atype, adata in _walk_rtattrs(payload[_NDMSG.size :]):
        if atype == NDA_DST:
            try:
                dst = str(ipaddress.ip_address(adata))
            except ValueError:
                return None
        elif atype == NDA_LLADDR:
            lladdr = ":".join(f"{b:02x}" for b in adata)
    if dst is None:
        return None
    return NeighborInfo(
        if_index=ifindex, family=family, dst=dst, lladdr=lladdr, state=state
    )


def build_addr_request(
    msg_type: int, seq: int, if_index: int, prefix: str
) -> bytes:
    """RTM_NEWADDR / RTM_DELADDR for `prefix` (CIDR interface address)
    on interface `if_index` (reference: NetlinkAddrMessage,
    openr/nl/NetlinkRoute.h:214 — the PrefixAllocator's address-sync
    path)."""
    iface = ipaddress.ip_interface(prefix)
    family = socket.AF_INET if iface.version == 4 else socket.AF_INET6
    flags = (
        NLM_F_REQUEST | NLM_F_ACK | NLM_F_CREATE | NLM_F_REPLACE
        if msg_type == RTM_NEWADDR
        else NLM_F_REQUEST | NLM_F_ACK
    )
    packed = iface.ip.packed
    body = (
        _IFADDRMSG.pack(family, iface.network.prefixlen, 0, 0, if_index)
        + _rtattr(IFA_LOCAL, packed)
        + _rtattr(IFA_ADDRESS, packed)
    )
    length = _NLMSGHDR.size + len(body)
    return _NLMSGHDR.pack(length, msg_type, flags, seq, 0) + body


def build_route_request(
    msg_type: int, seq: int, route: RouteInfo, flags: Optional[int] = None
) -> bytes:
    """RTM_NEWROUTE / RTM_DELROUTE with RTA_DST and either a single
    RTA_GATEWAY/RTA_OIF or an RTA_MULTIPATH of rtnexthop entries
    (reference: NetlinkRouteMessage::init + addNextHops,
    openr/nl/NetlinkRoute.cpp:70-310)."""
    if flags is None:
        flags = (
            NLM_F_REQUEST | NLM_F_ACK | NLM_F_CREATE | NLM_F_REPLACE
            if msg_type == RTM_NEWROUTE
            else NLM_F_REQUEST | NLM_F_ACK
        )
    net = ipaddress.ip_network(route.dst)
    family = socket.AF_INET if net.version == 4 else socket.AF_INET6
    attrs = _rtattr(RTA_DST, net.network_address.packed)
    if route.table >= 256:
        # rtm_table is 8-bit; larger ids ride the RTA_TABLE attribute
        # with rtm_table = RT_TABLE_UNSPEC (rtnetlink convention)
        attrs += _rtattr(RTA_TABLE, struct.pack("=I", route.table))
    if route.priority is not None:
        attrs += _rtattr(RTA_PRIORITY, struct.pack("=I", route.priority))
    if len(route.nexthops) == 1:
        nh = route.nexthops[0]
        if nh.gateway is not None:
            attrs += _rtattr(
                RTA_GATEWAY, ipaddress.ip_address(nh.gateway).packed
            )
        if nh.if_index:
            attrs += _rtattr(RTA_OIF, struct.pack("=i", nh.if_index))
        if nh.push_labels:
            attrs += _pack_mpls_encap(nh.push_labels)
    elif len(route.nexthops) > 1:
        blob = b""
        for nh in route.nexthops:
            sub = b""
            if nh.gateway is not None:
                sub = _rtattr(
                    RTA_GATEWAY, ipaddress.ip_address(nh.gateway).packed
                )
            if nh.push_labels:
                sub += _pack_mpls_encap(nh.push_labels)
            rlen = _RTNEXTHOP.size + len(sub)
            blob += (
                _RTNEXTHOP.pack(rlen, 0, max(nh.weight, 1) - 1, nh.if_index)
                + sub
            )
        attrs += _rtattr(RTA_MULTIPATH, blob)
    body = _RTMSG.pack(
        family,
        net.prefixlen,
        0,
        0,
        route.table if route.table < 256 else 0,  # 0 + RTA_TABLE above
        route.protocol,
        route.scope,
        route.rtype,
        0,
    ) + attrs
    length = _NLMSGHDR.size + len(body)
    return _NLMSGHDR.pack(length, msg_type, flags, seq, 0) + body


def parse_messages(data: bytes) -> Iterator[NetlinkMsg]:
    """Parse a datagram of (possibly multipart) netlink messages."""
    off = 0
    while off + _NLMSGHDR.size <= len(data):
        mlen, mtype, _flags, seq, pid = _NLMSGHDR.unpack_from(data, off)
        if mlen < _NLMSGHDR.size or off + mlen > len(data):
            return
        payload = data[off + _NLMSGHDR.size : off + mlen]
        if mtype == NLMSG_DONE:
            yield NetlinkMsg(msg_type=NLMSG_DONE, seq=seq, pid=pid)
        elif mtype == NLMSG_ERROR:
            (errno_neg,) = struct.unpack_from("=i", payload, 0)
            yield NetlinkMsg(
                msg_type=NLMSG_ERROR, error=-errno_neg, seq=seq, pid=pid
            )
        elif mtype in (RTM_NEWLINK, RTM_DELLINK):
            yield NetlinkMsg(msg_type=mtype, link=_parse_link(payload))
        elif mtype in (RTM_NEWADDR, RTM_DELADDR):
            addr = _parse_addr(payload, deleted=mtype == RTM_DELADDR)
            if addr is not None:
                yield NetlinkMsg(msg_type=mtype, addr=addr)
        elif mtype in (RTM_NEWROUTE, RTM_DELROUTE):
            if payload[:1] == bytes([AF_MPLS]):
                mr = _parse_mpls_route(payload)
                if mr is not None:
                    yield NetlinkMsg(msg_type=mtype, mpls_route=mr)
            else:
                route = _parse_route(payload)
                if route is not None:
                    yield NetlinkMsg(msg_type=mtype, route=route)
        elif mtype in (RTM_NEWNEIGH, RTM_DELNEIGH):
            neigh = _parse_neigh(payload)
            if neigh is not None:
                yield NetlinkMsg(msg_type=mtype, neigh=neigh)
        off += _align4(mlen)


def build_dump_request(msg_type: int, seq: int, family: int = 0) -> bytes:
    """RTM_GETLINK / RTM_GETADDR full-dump request
    (reference: NetlinkLinkMessage::init dump flags)."""
    length = _NLMSGHDR.size + _GENMSG.size
    return _NLMSGHDR.pack(
        length, msg_type, NLM_F_REQUEST | NLM_F_DUMP, seq, 0
    ) + _GENMSG.pack(family)


class NetlinkProtocolSocket(OpenrEventBase):
    """Kernel link/address mirror + event subscription
    (reference: NetlinkProtocolSocket, NetlinkProtocolSocket.h:96; owned
    by its own event base per Main.cpp:330-343).

    Pushes LinkEvent/AddrEvent into `netlink_events_queue` — first a full
    synthetic replay of current kernel state (so LinkMonitor starts from
    truth), then live kernel multicast events."""

    def __init__(
        self,
        netlink_events_queue: Optional[ReplicateQueue] = None,
        groups: int = RTMGRP_LINK | RTMGRP_IPV4_IFADDR | RTMGRP_IPV6_IFADDR,
    ) -> None:
        super().__init__(name="netlink")
        self.netlink_events_queue = netlink_events_queue
        self._groups = groups
        self._sock: Optional[socket.socket] = None
        self._req_sock: Optional[socket.socket] = None
        self._seq = 0
        self.links: dict[int, LinkInfo] = {}  # kernel mirror by ifindex
        self.counters: dict[str, int] = {}

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    # -- synchronous dump API (reference: getAllLinks/getAllIfAddresses) ----

    def _dump(self, msg_type: int, family: int = 0) -> list[NetlinkMsg]:
        """One blocking dump request/response on a throwaway socket."""
        self._seq += 1
        sock = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW, NETLINK_ROUTE)
        try:
            sock.bind((0, 0))
            sock.settimeout(5.0)
            sock.send(build_dump_request(msg_type, self._seq, family))
            out: list[NetlinkMsg] = []
            while True:
                data = sock.recv(65536)
                done = False
                for msg in parse_messages(data):
                    if msg.msg_type == NLMSG_DONE:
                        done = True
                        break
                    if msg.msg_type == NLMSG_ERROR and msg.error:
                        raise NetlinkError(msg.error, "netlink dump error")
                    out.append(msg)
                if done:
                    return out
        finally:
            sock.close()

    def get_all_links(self) -> list[LinkInfo]:
        return [m.link for m in self._dump(RTM_GETLINK) if m.link]

    def get_all_addresses(self) -> list[AddrInfo]:
        return [m.addr for m in self._dump(RTM_GETADDR) if m.addr]

    def get_all_neighbors(self) -> list[NeighborInfo]:
        """Reference: NetlinkProtocolSocket::getAllNeighbors
        (NetlinkProtocolSocket.h:96 surface)."""
        return [m.neigh for m in self._dump(RTM_GETNEIGH) if m.neigh]

    def get_routes(
        self,
        protocol: Optional[int] = RTPROT_OPENR,
        table: Optional[int] = RT_TABLE_MAIN,
    ) -> list[RouteInfo]:
        """Full route-table dump, filtered client-side by protocol/table
        (reference: NetlinkProtocolSocket::getRoutes / getAllRoutes;
        getRouteTableByClient reads back exactly the openr-protocol
        routes, openr/platform/NetlinkFibHandler.h)."""
        out = []
        for m in self._dump(RTM_GETROUTE):
            r = m.route
            if r is None:
                continue
            if protocol is not None and r.protocol != protocol:
                continue
            if table is not None and r.table != table:
                continue
            out.append(r)
        return out

    def get_mpls_routes(
        self, protocol: Optional[int] = RTPROT_OPENR
    ) -> list[MplsRouteInfo]:
        """AF_MPLS label-route dump, protocol-filtered — the kernel
        readback behind get_mpls_route_table_by_client (reference:
        NetlinkProtocolSocket::getMplsRoutes,
        openr/platform/NetlinkFibHandler.cpp getMplsRouteTableByClient)."""
        out = []
        for m in self._dump(RTM_GETROUTE, family=AF_MPLS):
            r = m.mpls_route
            if r is None:
                continue
            if protocol is not None and r.protocol != protocol:
                continue
            out.append(r)
        return out

    # -- synchronous route programming (reference: NetlinkRouteMessage
    # -- add/delete with ACK, openr/nl/NetlinkRoute.cpp) -------------------

    def _request_sock(self) -> socket.socket:
        """Persistent request socket for route transactions (the
        reference keeps one request fd too; a 1k-route sync must not pay
        1k socket setup/teardown cycles)."""
        if self._req_sock is None:
            sock = socket.socket(
                socket.AF_NETLINK, socket.SOCK_RAW, NETLINK_ROUTE
            )
            sock.bind((0, 0))
            sock.settimeout(5.0)
            self._req_sock = sock
        return self._req_sock

    def _transact(self, request: bytes) -> None:
        """Send one ACK-flagged request and wait for ITS NLMSG_ERROR
        (error 0 == ACK); raises NetlinkError on kernel rejection.

        Replies are matched on nlmsg_seq (and pid, when the kernel
        stamps one) against the outstanding request — a stray or late
        message on the persistent socket must not be misattributed as
        this request's verdict (advisor r3)."""
        sock = self._request_sock()
        own_pid = sock.getsockname()[0]
        try:
            sock.send(request)
            while True:
                data = sock.recv(65536)
                for msg in parse_messages(data):
                    if msg.msg_type != NLMSG_ERROR:
                        continue
                    if msg.seq != self._seq or (
                        msg.pid not in (0, own_pid)
                    ):
                        continue  # not ours: late reply from a prior seq
                    if msg.error:
                        raise NetlinkError(
                            msg.error, "netlink route request rejected"
                        )
                    return
        except NetlinkError:
            raise  # clean kernel rejection: the socket is still in sync
        except OSError:
            # timeout/desync: drop the socket so the next transact starts
            # from a clean fd + sequence space
            try:
                sock.close()
            finally:
                self._req_sock = None
            raise

    def add_route(self, route: RouteInfo) -> None:
        self._seq += 1
        self._transact(build_route_request(RTM_NEWROUTE, self._seq, route))
        self._bump("netlink.routes_added")

    def del_route(self, route: RouteInfo) -> None:
        self._seq += 1
        self._transact(build_route_request(RTM_DELROUTE, self._seq, route))
        self._bump("netlink.routes_deleted")

    def add_mpls_route(self, route: MplsRouteInfo) -> None:
        self._seq += 1
        self._transact(
            build_mpls_route_request(RTM_NEWROUTE, self._seq, route)
        )
        self._bump("netlink.mpls_routes_added")

    def del_mpls_route(self, route: MplsRouteInfo) -> None:
        self._seq += 1
        self._transact(
            build_mpls_route_request(RTM_DELROUTE, self._seq, route)
        )
        self._bump("netlink.mpls_routes_deleted")

    def add_neighbor(
        self, if_index: int, dst: str, lladdr: str, state: int = 0x80
    ) -> None:
        """Program a kernel neighbor entry (RTM_NEWNEIGH; default state
        NUD_PERMANENT).  Reference: NetlinkNeighborMessage,
        openr/nl/NetlinkRoute.h:255, and the neighbor type of
        openr/nl/NetlinkTypes.h:48-285."""
        self._seq += 1
        self._transact(
            build_neigh_request(
                RTM_NEWNEIGH, self._seq, if_index, dst, lladdr, state
            )
        )
        self._bump("netlink.neighbors_added")

    def del_neighbor(self, if_index: int, dst: str) -> None:
        self._seq += 1
        self._transact(
            build_neigh_request(RTM_DELNEIGH, self._seq, if_index, dst)
        )
        self._bump("netlink.neighbors_deleted")

    def close_request_socket(self) -> None:
        """Release the persistent request fd (for codec-only users that
        never run the event base and so never hit stop())."""
        if self._req_sock is not None:
            try:
                self._req_sock.close()
            finally:
                self._req_sock = None

    def add_addr(self, if_index: int, prefix: str) -> None:
        """Assign an interface address (reference: NetlinkAddrMessage /
        PrefixAllocator address sync)."""
        self._seq += 1
        self._transact(
            build_addr_request(RTM_NEWADDR, self._seq, if_index, prefix)
        )
        self._bump("netlink.addrs_added")

    def del_addr(self, if_index: int, prefix: str) -> None:
        self._seq += 1
        self._transact(
            build_addr_request(RTM_DELADDR, self._seq, if_index, prefix)
        )
        self._bump("netlink.addrs_deleted")

    # -- event subscription --------------------------------------------------

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        self.run_in_event_base_thread(self._setup).result()

    # reference: kNetlinkSockRecvBuf (NetlinkProtocolSocket.cpp:111-114)
    # — a large receive buffer so link/addr event storms don't overflow
    # the socket before the event loop drains it
    RCVBUF_SIZE = 1 << 20

    def _setup(self) -> None:
        sock = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW, NETLINK_ROUTE)
        # SO_RCVBUFFORCE (=33, not in the socket module) needs
        # CAP_NET_ADMIN; fall back to the rlimit-capped SO_RCVBUF
        try:
            sock.setsockopt(socket.SOL_SOCKET, 33, self.RCVBUF_SIZE)
        except OSError:
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_RCVBUF, self.RCVBUF_SIZE
            )
        sock.bind((0, self._groups))
        sock.setblocking(False)
        self._sock = sock

        self._resync()
        self._loop.add_reader(sock.fileno(), self._on_readable)

    def _resync(self) -> None:
        """Full kernel-state replay: links first, then addresses
        (LinkMonitor needs the link before its addresses; reference does
        the same ordered bootstrap).  Also the ENOBUFS recovery path —
        when the kernel drops events the mirror is stale, so re-dump and
        replay everything (LinkEvent/AddrEvent replays are idempotent
        downstream, same as the initial bootstrap)."""
        self.links = {}
        for link in self.get_all_links():
            self.links[link.if_index] = link
            self._push(LinkEvent(link.if_name, link.if_index, link.is_up))
            self._bump("netlink.links")
        for addr in self.get_all_addresses():
            link = self.links.get(addr.if_index)
            if link is None:
                continue
            self._push(AddrEvent(link.if_name, addr.prefix, addr.is_valid))
            self._bump("netlink.addrs")

    def _on_readable(self) -> None:
        try:
            data = self._sock.recv(65536)
        except BlockingIOError:
            return
        except OSError as exc:
            if exc.errno == errno.ENOBUFS:
                # kernel dropped events: the mirror may have missed
                # link/addr transitions — discard whatever stale
                # pre-overflow events are still queued (they would
                # otherwise be applied on top of the fresh dump), then
                # resynchronize from a full dump (reference enlarges the
                # buffer and logs; we additionally recover the lost state)
                self._bump("netlink.enobufs")
                while True:
                    try:
                        self._sock.recv(65536)
                    except OSError:
                        break
                self._resync()
            return
        for msg in parse_messages(data):
            self._bump("netlink.events")
            if msg.link is not None:
                link = msg.link
                if msg.msg_type == RTM_DELLINK:
                    self.links.pop(link.if_index, None)
                    self._push(LinkEvent(link.if_name, link.if_index, False))
                else:
                    prev = self.links.get(link.if_index)
                    self.links[link.if_index] = link
                    if prev is None or prev.is_up != link.is_up:
                        self._push(
                            LinkEvent(link.if_name, link.if_index, link.is_up)
                        )
            elif msg.addr is not None:
                link = self.links.get(msg.addr.if_index)
                if link is None:
                    continue
                self._push(
                    AddrEvent(link.if_name, msg.addr.prefix, msg.addr.is_valid)
                )

    def _push(self, event) -> None:
        if self.netlink_events_queue is not None:
            self.netlink_events_queue.push(event)

    def stop(self) -> None:  # type: ignore[override]
        if self._sock is not None and self._loop is not None:
            sock = self._sock

            def _close():
                try:
                    self._loop.remove_reader(sock.fileno())
                finally:
                    sock.close()

            try:
                self.run_in_event_base_thread(_close).result(timeout=5)
            except Exception:
                pass
            self._sock = None
        super().stop()
