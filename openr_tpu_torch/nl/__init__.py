"""Netlink library: real rtnetlink codec + AF_NETLINK socket feeding
kernel link/address events into the daemon (port of `openr_tpu.nl`;
reference: openr/nl/ — NetlinkProtocolSocket, NetlinkMessage codecs)."""

from .netlink import (  # noqa: F401
    AddrInfo,
    LinkInfo,
    NetlinkError,
    NetlinkProtocolSocket,
    parse_messages,
)
