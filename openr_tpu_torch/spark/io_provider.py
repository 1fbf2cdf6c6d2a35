"""IoProvider: the Spark packet transport seam (port of
`openr_tpu.spark.io_provider`).

The reference virtualizes raw socket syscalls (openr/spark/IoProvider.h:27)
so Spark I/O can be mocked.  Here the seam sits one level higher — at
message granularity — which keeps Spark itself transport-agnostic:

- `MockIoProvider` is an in-process fabric with per-link latency and
  dynamic connectivity (functional equivalent of
  openr/tests/mocks/MockIoProvider.h:41, the backbone of clusterless
  multi-node tests).
- `UdpIoProvider` sends/receives over IPv6 link-local multicast (ff02::1)
  UDP like the real daemon.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional, Protocol

log = logging.getLogger(__name__)

MCAST_GROUP = "ff02::1"
DEFAULT_UDP_PORT = 6666  # reference: Constants::kUdpPort

# SOL_SOCKET option/cmsg id for nanosecond kernel receive timestamps
# (linux: SO_TIMESTAMPNS_OLD; cmsg SCM_TIMESTAMPNS carries a timespec);
# prefer the stdlib constant where exposed — 35 is the mainstream-Linux
# value only
SO_TIMESTAMPNS = getattr(socket, "SO_TIMESTAMPNS", 35)
_TIMESPEC = struct.Struct("@qq")  # tv_sec, tv_nsec


def _realtime_us() -> int:
    """The RxPacket timestamp domain is CLOCK_REALTIME microseconds —
    the clock kernel SO_TIMESTAMPNS stamps arrive on (Spark's send
    stamps use the same clock; see spark.send_hello)."""
    return int(time.clock_gettime(time.CLOCK_REALTIME) * 1e6)


@dataclass(slots=True)
class RxPacket:
    if_name: str  # interface the packet arrived on
    data: bytes
    src_addr: str  # sender's link-local address
    recv_ts_us: int  # kernel/fabric receive timestamp (RTT measurement)


class IoProvider(Protocol):
    def attach(self, node_name: str) -> None:
        """Register this endpoint (called once by Spark)."""
        ...

    def add_interface(self, if_name: str) -> None: ...

    def remove_interface(self, if_name: str) -> None: ...

    def send(self, if_name: str, data: bytes) -> None:
        """Multicast `data` out of `if_name`."""
        ...

    async def recv(self) -> RxPacket: ...

    def close(self) -> None: ...


class MockIoProvider:
    """In-process fabric.  connect_pairs maps (nodeA, ifA) <-> (nodeB, ifB)
    with a latency; packets sent on an interface are delivered to every
    connected interface after that latency."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (node, if) -> endpoint
        self._endpoints: dict[tuple[str, str], "_MockEndpoint"] = {}
        # (node, if) -> list of ((node, if), latency_s)
        self._links: dict[tuple[str, str], list[tuple[tuple[str, str], float]]] = {}

    def endpoint(self, node_name: str) -> "_MockEndpoint":
        return _MockEndpoint(self, node_name)

    def connect(
        self,
        node_a: str,
        if_a: str,
        node_b: str,
        if_b: str,
        latency_s: float = 0.0,
    ) -> None:
        with self._lock:
            self._links.setdefault((node_a, if_a), []).append(
                ((node_b, if_b), latency_s)
            )
            self._links.setdefault((node_b, if_b), []).append(
                ((node_a, if_a), latency_s)
            )

    def disconnect(self, node_a: str, if_a: str, node_b: str, if_b: str) -> None:
        with self._lock:
            self._links[(node_a, if_a)] = [
                l
                for l in self._links.get((node_a, if_a), [])
                if l[0] != (node_b, if_b)
            ]
            self._links[(node_b, if_b)] = [
                l
                for l in self._links.get((node_b, if_b), [])
                if l[0] != (node_a, if_a)
            ]

    def _register(self, node: str, if_name: str, ep: "_MockEndpoint") -> None:
        with self._lock:
            self._endpoints[(node, if_name)] = ep

    def _unregister(self, node: str, if_name: str) -> None:
        with self._lock:
            self._endpoints.pop((node, if_name), None)

    def _deliver(self, src: tuple[str, str], data: bytes) -> None:
        with self._lock:
            targets = [
                (self._endpoints.get(dst), dst, latency)
                for dst, latency in self._links.get(src, [])
            ]
        for ep, dst, latency in targets:
            if ep is None:
                continue
            ep._enqueue_after(latency, dst[1], data, f"fe80::{src[0]}")


class _MockEndpoint:
    """Per-node view of the mock fabric (implements IoProvider)."""

    def __init__(self, fabric: MockIoProvider, node_name: str) -> None:
        self._fabric = fabric
        self.node_name = node_name
        self._interfaces: set[str] = set()
        self._queue: asyncio.Queue[RxPacket] = asyncio.Queue()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._closed = False

    def attach(self, node_name: str) -> None:
        self.node_name = node_name
        self._loop = asyncio.get_running_loop()

    def add_interface(self, if_name: str) -> None:
        self._interfaces.add(if_name)
        self._fabric._register(self.node_name, if_name, self)

    def remove_interface(self, if_name: str) -> None:
        self._interfaces.discard(if_name)
        self._fabric._unregister(self.node_name, if_name)

    def send(self, if_name: str, data: bytes) -> None:
        if if_name in self._interfaces:
            self._fabric._deliver((self.node_name, if_name), data)

    def _enqueue_after(
        self, latency_s: float, if_name: str, data: bytes, src_addr: str
    ) -> None:
        loop = self._loop
        if loop is None or self._closed or loop.is_closed():
            return
        # stamp NOW (+ simulated wire latency), not when the receiver's
        # event loop gets around to the callback — the fabric models the
        # KERNEL timestamping point (SO_TIMESTAMPNS), so receiver-side
        # scheduler load must not inflate RTTs
        arrival_ts_us = _realtime_us() + int(latency_s * 1e6)

        def _put() -> None:
            if self._closed or if_name not in self._interfaces:
                return
            self._queue.put_nowait(
                RxPacket(
                    if_name=if_name,
                    data=data,
                    src_addr=src_addr,
                    recv_ts_us=arrival_ts_us,
                )
            )

        if latency_s > 0:
            loop.call_soon_threadsafe(lambda: loop.call_later(latency_s, _put))
        else:
            loop.call_soon_threadsafe(_put)

    async def recv(self) -> RxPacket:
        return await self._queue.get()

    def close(self) -> None:
        self._closed = True
        for if_name in list(self._interfaces):
            self.remove_interface(if_name)


class UdpIoProvider:
    """Real IPv6 link-local multicast transport.

    ONE wildcard-bound socket with IPV6_RECVPKTINFO: the kernel reports the
    arrival interface per datagram (ancillary IPV6_PKTINFO), so packets are
    attributed to the right interface — per-interface wildcard binds would
    collide (EADDRINUSE) and attribute datagrams arbitrarily.  ff02::1 is
    joined per tracked interface; sends pin the egress interface via
    sendmsg ancillary pktinfo.  Reference: openr/spark/IoProvider.h
    syscalls + SparkWrapper socket setup."""

    def __init__(self, port: int = DEFAULT_UDP_PORT) -> None:
        self.port = port
        self.send_failures = 0
        self._sock: Optional[socket.socket] = None
        self._if_index: dict[str, int] = {}  # name -> index
        self._if_name: dict[int, str] = {}  # index -> name
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queue: asyncio.Queue[RxPacket] = asyncio.Queue()
        self.node_name = ""

    def attach(self, node_name: str) -> None:
        self.node_name = node_name
        self._loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET6, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_RECVPKTINFO, 1)
        sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_LOOP, 0)
        # kernel rx timestamps: RTTs measured from the moment the packet
        # hit the host, not when the event loop drained it (reference:
        # Spark.cpp:447-448 SO_TIMESTAMPNS + recvmsg cmsg)
        try:
            sock.setsockopt(socket.SOL_SOCKET, SO_TIMESTAMPNS, 1)
        except OSError:
            pass  # stamped in userspace below
        sock.bind(("::", self.port))
        sock.setblocking(False)
        self._sock = sock
        self._loop.add_reader(sock.fileno(), self._on_readable)

    def _on_readable(self) -> None:
        assert self._sock is not None
        while True:
            try:
                data, ancdata, _flags, addr = self._sock.recvmsg(
                    65535,
                    socket.CMSG_SPACE(20) + socket.CMSG_SPACE(_TIMESPEC.size),
                )
            except BlockingIOError:
                return
            if_index = 0
            recv_ts_us = 0
            for level, ctype, cdata in ancdata:
                if (
                    level == socket.IPPROTO_IPV6
                    and ctype == socket.IPV6_PKTINFO
                    and len(cdata) >= 20
                ):
                    if_index = struct.unpack_from("@I", cdata, 16)[0]
                elif (
                    level == socket.SOL_SOCKET
                    and ctype == SO_TIMESTAMPNS  # SCM_TIMESTAMPNS
                    and len(cdata) >= _TIMESPEC.size
                ):
                    sec, nsec = _TIMESPEC.unpack_from(cdata, 0)
                    recv_ts_us = sec * 1_000_000 + nsec // 1_000
            if_name = self._if_name.get(if_index)
            if if_name is None:
                continue  # not a tracked interface
            self._queue.put_nowait(
                RxPacket(
                    if_name=if_name,
                    data=data,
                    src_addr=addr[0],
                    recv_ts_us=recv_ts_us or _realtime_us(),
                )
            )

    def add_interface(self, if_name: str) -> None:
        if if_name in self._if_index or self._sock is None:
            return
        if_index = socket.if_nametoindex(if_name)
        mreq = socket.inet_pton(socket.AF_INET6, MCAST_GROUP) + struct.pack(
            "@I", if_index
        )
        self._sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_JOIN_GROUP, mreq)
        self._if_index[if_name] = if_index
        self._if_name[if_index] = if_name

    def remove_interface(self, if_name: str) -> None:
        if_index = self._if_index.pop(if_name, None)
        if if_index is None or self._sock is None:
            return
        self._if_name.pop(if_index, None)
        mreq = socket.inet_pton(socket.AF_INET6, MCAST_GROUP) + struct.pack(
            "@I", if_index
        )
        try:
            self._sock.setsockopt(
                socket.IPPROTO_IPV6, socket.IPV6_LEAVE_GROUP, mreq
            )
        except OSError:
            pass

    def send(self, if_name: str, data: bytes) -> None:
        if_index = self._if_index.get(if_name)
        if if_index is None or self._sock is None:
            return
        try:
            self._sock.sendto(data, (MCAST_GROUP, self.port, 0, if_index))
        except OSError as exc:
            # transient interface conditions (IPv6 DAD still running,
            # link-down race) make multicast sends fail with
            # EADDRNOTAVAIL/ENETDOWN; a raised send would unwind Spark's
            # timer callback and permanently stop the hello chain.  The
            # reference IoProvider surfaces errno and Spark logs+continues
            # (the next periodic hello retries) — match that.
            self.send_failures += 1
            if self.send_failures % 16 == 1:  # rate-limited: DAD spams
                log.warning(
                    "spark udp send on %s failing (%d so far): %s",
                    if_name,
                    self.send_failures,
                    exc,
                )

    async def recv(self) -> RxPacket:
        return await self._queue.get()

    def close(self) -> None:
        if self._sock is not None:
            if self._loop is not None and not self._loop.is_closed():
                try:
                    self._loop.remove_reader(self._sock.fileno())
                except (ValueError, OSError):
                    pass
            self._sock.close()
            self._sock = None
        self._if_index.clear()
        self._if_name.clear()
