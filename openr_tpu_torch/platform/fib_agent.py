"""Standalone FibService platform agent.

Port of `openr_tpu.platform.fib_agent`.  The reference ships
`platform_linux` (LinuxPlatformMain.cpp), a separate process whose
NetlinkFibHandler (openr/platform/NetlinkFibHandler.h) implements the
thrift FibService (openr/if/Platform.thrift:71-160) and programs the
Linux kernel via netlink.  This keeps the same process boundary and API
surface with two backends:

- SimulatedRouteTable (default): in-process table for clusterless tests
  (the MockNetlinkFibHandler pattern).
- KernelRouteTable (`--kernel`): programs REAL kernel routes through the
  from-scratch rtnetlink codec (openr_tpu_torch.nl.netlink RTM_NEWROUTE /
  DELROUTE incl. RTA_MULTIPATH), with the reference's client->protocol
  mapping (Platform.thrift:58 clientIdtoProtocolId) and read-back via
  protocol-filtered route dumps (getRouteTableByClient,
  openr/platform/NetlinkFibHandler.h).  Requires CAP_NET_ADMIN.

The daemon's Fib module talks to it over the NDJSON-RPC wire transport
(`TcpFibAgent`), and `breeze fib validate` audits daemon state against
the agent's table.  A `syncFib` is one JSON line of every route, so the
server reads request lines up to `ctrl.client.WIRE_LINE_LIMIT` as the
ctrl server does; a longer line gets the protocol's error before the
server hangs up (asyncio's 64 KiB default dropped any sync of more than
a few hundred routes).

The agent computes nothing and takes no device.

Run standalone:  python -m openr_tpu_torch.platform.fib_agent --port 60100 [--kernel] [--route-table T]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import socket
import threading
import time
from typing import Any, Iterable, Optional

from ..ctrl.client import WIRE_LINE_LIMIT
from ..serializer import from_wire, to_wire
from ..types import MplsAction, MplsActionCode, MplsRoute, NextHop, UnicastRoute

log = logging.getLogger(__name__)


class SimulatedRouteTable:
    """The agent-side route store (reference: NetlinkFibHandler's kernel
    programming + per-client route tracking; simulated kernel).

    Thread-safe: the server may run handlers from multiple connections."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # millisecond resolution: a sub-second supervisor restart must
        # still change aliveSince or Fib's keepalive never resyncs
        # (MockFibAgent.restart makes the same guarantee)
        self._alive_since = int(time.time() * 1000)
        self.unicast: dict[int, dict[str, UnicastRoute]] = {}
        self.mpls: dict[int, dict[int, MplsRoute]] = {}
        self.counters: dict[str, int] = {}

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    # -- FibService API (Platform.thrift:71-160) -----------------------------

    def add_unicast_routes(
        self, client_id: int, routes: list[UnicastRoute]
    ) -> None:
        with self._lock:
            table = self.unicast.setdefault(client_id, {})
            for route in routes:
                table[route.dest] = route
            self._bump("fibagent.add_unicast", len(routes))

    def delete_unicast_routes(
        self, client_id: int, prefixes: list[str]
    ) -> None:
        with self._lock:
            table = self.unicast.setdefault(client_id, {})
            for prefix in prefixes:
                table.pop(prefix, None)
            self._bump("fibagent.del_unicast", len(prefixes))

    def add_mpls_routes(self, client_id: int, routes: list[MplsRoute]) -> None:
        with self._lock:
            table = self.mpls.setdefault(client_id, {})
            for route in routes:
                table[route.top_label] = route
            self._bump("fibagent.add_mpls", len(routes))

    def delete_mpls_routes(self, client_id: int, labels: list[int]) -> None:
        with self._lock:
            table = self.mpls.setdefault(client_id, {})
            for label in labels:
                table.pop(label, None)
            self._bump("fibagent.del_mpls", len(labels))

    def sync_fib(self, client_id: int, routes: list[UnicastRoute]) -> None:
        with self._lock:
            self.unicast[client_id] = {r.dest: r for r in routes}
            self._bump("fibagent.sync_fib")

    def sync_mpls_fib(self, client_id: int, routes: list[MplsRoute]) -> None:
        with self._lock:
            self.mpls[client_id] = {r.top_label: r for r in routes}
            self._bump("fibagent.sync_mpls_fib")

    def get_route_table_by_client(self, client_id: int) -> list[UnicastRoute]:
        with self._lock:
            return sorted(
                self.unicast.get(client_id, {}).values(),
                key=lambda r: r.dest,
            )

    def get_mpls_route_table_by_client(self, client_id: int) -> list[MplsRoute]:
        with self._lock:
            return sorted(
                self.mpls.get(client_id, {}).values(),
                key=lambda r: r.top_label,
            )

    def alive_since(self) -> int:
        return self._alive_since

    def get_counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counters)


# reference: Platform.thrift:58 — kernel route protocol per FibService
# client (rtnetlink rtm_protocol must be < 254)
CLIENT_ID_TO_PROTOCOL = {786: 99, 0: 253}
DEFAULT_PROTOCOL = 99


class KernelRouteTable:
    """FibService backend programming REAL kernel routes
    (reference: NetlinkFibHandler, openr/platform/NetlinkFibHandler.h).

    Unicast v4/v6 incl. multipath ride RTM_NEWROUTE/DELROUTE through the
    nl codec; per-client separation uses the kernel protocol id exactly
    like the reference (clientIdtoProtocolId).  MPLS label routes are
    programmed as AF_MPLS kernel routes (RTA_VIA + RTA_NEWDST) and READ
    BACK from the kernel — get_mpls_route_table_by_client and
    sync_mpls_fib diff against kernel truth, so they survive an agent
    restart (reference: getMplsRouteTableByClient,
    openr/platform/NetlinkFibHandler.cpp).  On kernels without AF_MPLS
    support (mpls_router not loaded) the first programming attempt trips
    a fallback to in-process tracking, logged once.
    """

    def __init__(self, table_id: Optional[int] = None) -> None:
        from ..nl.netlink import NetlinkProtocolSocket, RT_TABLE_MAIN

        self._lock = threading.Lock()
        self._alive_since = int(time.time() * 1000)
        self.nl = NetlinkProtocolSocket()
        self.table_id = RT_TABLE_MAIN if table_id is None else table_id
        # in-process MPLS mirror: authoritative ONLY when the kernel
        # lacks AF_MPLS (self._mpls_kernel is False)
        self.mpls: dict[int, dict[int, MplsRoute]] = {}
        self._mpls_kernel: Optional[bool] = None  # None = not yet probed
        self.counters: dict[str, int] = {}
        self._if_index: dict[str, int] = {}

    def _bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    @staticmethod
    def _protocol(client_id: int) -> int:
        proto = CLIENT_ID_TO_PROTOCOL.get(client_id)
        if proto is None:
            # the reference rejects unknown clients (getProtocol ->
            # ENOTSUPPORTED); silently aliasing them onto openr's
            # protocol would let a stray client wipe openr's FIB
            raise ValueError(f"unknown FibService client id {client_id}")
        return proto

    def _ifindex(self, if_name: Optional[str]) -> int:
        if not if_name:
            return 0
        idx = self._if_index.get(if_name)
        if idx is None:
            self._if_index = {
                l.if_name: l.if_index for l in self.nl.get_all_links()
            }
            # negative-cache misses: a vanished interface must not cost a
            # full link dump per route.  The entry self-heals: any
            # add_route failure drops negative entries so an interface
            # that appears later is picked up (_drop_negative_ifcache).
            idx = self._if_index.setdefault(if_name, 0)
        return idx

    def _drop_negative_ifcache(self, route: UnicastRoute) -> bool:
        """Invalidate negative (index 0) cache entries named by `route`'s
        nexthops; True when any was dropped (retry is worthwhile)."""
        dropped = False
        for nh in route.next_hops:
            if nh.if_name and self._if_index.get(nh.if_name) == 0:
                del self._if_index[nh.if_name]
                dropped = True
        return dropped

    def _add_route(self, client_id: int, route: UnicastRoute) -> None:
        """add_route with negative-ifindex self-healing: a failure whose
        route referenced a negatively-cached interface re-dumps the link
        map and retries once — a newly-appeared interface must not stay
        invisible until an unrelated cache miss (advisor r3).  Only
        errnos a missing OIF can cause trigger the retry (EINVAL: v6
        link-local gateway without device; ENODEV): unrelated failures
        must not pay a link dump + doomed resend per route."""
        import errno as _errno

        from ..nl.netlink import NetlinkError

        try:
            self.nl.add_route(self._to_route_info(client_id, route))
        except NetlinkError as exc:
            if exc.errno not in (_errno.EINVAL, _errno.ENODEV):
                raise
            if not self._drop_negative_ifcache(route):
                raise
            self.nl.add_route(self._to_route_info(client_id, route))

    def _to_route_info(self, client_id: int, route: UnicastRoute):
        from ..nl.netlink import NextHopInfo, RouteInfo

        nexthops = [
            NextHopInfo(
                gateway=nh.address or None,
                if_index=self._ifindex(nh.if_name),
                weight=max(nh.weight, 1),
                # SR label PUSH rides the MPLS lwtunnel encap
                push_labels=(
                    tuple(nh.mpls_action.push_labels)
                    if nh.mpls_action is not None
                    and nh.mpls_action.action == MplsActionCode.PUSH
                    and nh.mpls_action.push_labels
                    else ()
                ),
            )
            for nh in route.next_hops
        ]
        return RouteInfo(
            dst=route.dest,
            table=self.table_id,
            protocol=self._protocol(client_id),
            nexthops=nexthops,
        )

    # -- FibService API ------------------------------------------------------

    def add_unicast_routes(
        self, client_id: int, routes: list[UnicastRoute]
    ) -> None:
        with self._lock:
            for route in routes:
                self._add_route(client_id, route)
            self._bump("fibagent.kernel.add_unicast", len(routes))

    def delete_unicast_routes(
        self, client_id: int, prefixes: list[str]
    ) -> None:
        from ..nl.netlink import NetlinkError, RouteInfo

        with self._lock:
            for prefix in prefixes:
                try:
                    self.nl.del_route(
                        RouteInfo(
                            dst=prefix,
                            table=self.table_id,
                            protocol=self._protocol(client_id),
                        )
                    )
                except NetlinkError as exc:
                    import errno as _errno

                    if exc.errno != _errno.ESRCH:  # already gone: idempotent
                        raise
            self._bump("fibagent.kernel.del_unicast", len(prefixes))

    # -- MPLS: kernel AF_MPLS programming with readback -----------------------

    def _to_mpls_route_info(self, client_id: int, route: MplsRoute):
        from ..nl.netlink import MplsRouteInfo, NextHopInfo

        nexthops = []
        for nh in route.next_hops:
            act = nh.mpls_action
            swap: tuple = ()
            gateway = nh.address or None
            if act is not None:
                # `is not None`: swap to label 0 (explicit null) is legal
                # and must not degrade to a pop
                if (
                    act.action == MplsActionCode.SWAP
                    and act.swap_label is not None
                ):
                    swap = (act.swap_label,)
                elif act.action == MplsActionCode.PUSH and act.push_labels:
                    swap = tuple(act.push_labels)
                elif act.action == MplsActionCode.POP_AND_LOOKUP:
                    gateway = None  # oif-only: kernel pops + looks up
            nexthops.append(
                NextHopInfo(
                    gateway=gateway,
                    if_index=self._ifindex(nh.if_name),
                    weight=max(nh.weight, 1),
                    swap_labels=swap,
                )
            )
        return MplsRouteInfo(
            label=route.top_label,
            protocol=self._protocol(client_id),
            nexthops=nexthops,
        )

    def _mpls_try_kernel(self, op) -> bool:
        """Run an AF_MPLS netlink op; returns False (and latches the
        in-process fallback) when the kernel has no MPLS support."""
        import errno as _errno

        from ..nl.netlink import NetlinkError

        if self._mpls_kernel is False:
            return False
        try:
            op()
            self._mpls_kernel = True
            return True
        except NetlinkError as exc:
            if self._mpls_kernel is None and exc.errno in (
                _errno.EAFNOSUPPORT,
                getattr(_errno, "EPFNOSUPPORT", _errno.EAFNOSUPPORT),
                _errno.EPROTONOSUPPORT,
                _errno.EOPNOTSUPP,
            ):
                log.warning(
                    "kernel has no AF_MPLS support (%s); falling back to "
                    "in-process MPLS route tracking",
                    exc,
                )
                self._mpls_kernel = False
                return False
            raise

    def add_mpls_routes(self, client_id: int, routes: list[MplsRoute]) -> None:
        with self._lock:
            for route in routes:
                info = self._to_mpls_route_info(client_id, route)
                if not self._mpls_try_kernel(
                    lambda info=info: self.nl.add_mpls_route(info)
                ):
                    self.mpls.setdefault(client_id, {})[
                        route.top_label
                    ] = route
            self._bump("fibagent.kernel.add_mpls", len(routes))

    def delete_mpls_routes(self, client_id: int, labels: list[int]) -> None:
        import errno as _errno

        from ..nl.netlink import MplsRouteInfo, NetlinkError

        with self._lock:
            for label in labels:
                info = MplsRouteInfo(
                    label=label, protocol=self._protocol(client_id)
                )
                try:
                    programmed = self._mpls_try_kernel(
                        lambda info=info: self.nl.del_mpls_route(info)
                    )
                except NetlinkError as exc:
                    if exc.errno != _errno.ESRCH:  # already gone
                        raise
                    programmed = True
                if not programmed:
                    self.mpls.setdefault(client_id, {}).pop(label, None)
            self._bump("fibagent.kernel.del_mpls", len(labels))

    def sync_fib(self, client_id: int, routes: list[UnicastRoute]) -> None:
        """Full-state sync: program everything advertised, withdraw every
        kernel route of this client's protocol not in the set (reference:
        NetlinkFibHandler::future_syncFib keep/add/remove diff)."""
        import ipaddress

        with self._lock:
            # canonical prefix strings: the kernel readback is normalized
            # (e.g. "2001:0DB8::/64" comes back "2001:db8::/64"), so the
            # diff must compare canonical forms or syncs churn
            wanted = {
                str(ipaddress.ip_network(r.dest)): r for r in routes
            }
            current = {
                r.dst
                for r in self.nl.get_routes(
                    protocol=self._protocol(client_id), table=self.table_id
                )
            }
            # collect per-route failures and STILL run the stale-route
            # deletion pass: one bad add must not leave this client's
            # stale kernel routes behind until the next sync (advisor
            # r3; mirrors the reference's keep/add/remove diff)
            from ..nl.netlink import NetlinkError, RouteInfo

            errors: list[str] = []
            for route in routes:
                try:
                    self._add_route(client_id, route)
                except NetlinkError as exc:
                    errors.append(f"{route.dest}: {exc}")
            for dst in current - set(wanted):
                try:
                    self.nl.del_route(
                        RouteInfo(
                            dst=dst,
                            table=self.table_id,
                            protocol=self._protocol(client_id),
                        )
                    )
                except NetlinkError as exc:
                    errors.append(f"del {dst}: {exc}")
            self._bump("fibagent.kernel.sync_fib")
            if errors:
                raise RuntimeError(
                    f"sync_fib: {len(errors)} route(s) failed: "
                    + "; ".join(errors[:8])
                )

    def sync_mpls_fib(self, client_id: int, routes: list[MplsRoute]) -> None:
        """Full MPLS sync diffed against KERNEL readback (not in-process
        state), so a restarted agent still withdraws stale label routes —
        the round-3 gap this closes (reference: future_syncMplsFib,
        openr/platform/NetlinkFibHandler.cpp)."""
        from ..nl.netlink import MplsRouteInfo, NetlinkError

        with self._lock:
            wanted = {r.top_label for r in routes}
            proto = self._protocol(client_id)
            current: set[int] = set()
            dump_ok = False
            if self._mpls_kernel is not False:
                try:
                    current = {
                        r.label for r in self.nl.get_mpls_routes(proto)
                    }
                    # a successful dump does NOT prove AF_MPLS support
                    # (the kernel answers dumps for unregistered families
                    # with an empty set) — only a successful ADD latches
                    # _mpls_kernel=True, via _mpls_try_kernel below
                    dump_ok = True
                except OSError:
                    # transient dump failure (ENOBUFS, timeout) or
                    # no-MPLS kernel; the adds below decide which
                    pass
            errors: list[str] = []
            kernel_mode = True
            for route in routes:
                info = self._to_mpls_route_info(client_id, route)
                try:
                    if not self._mpls_try_kernel(
                        lambda info=info: self.nl.add_mpls_route(info)
                    ):
                        kernel_mode = False
                        break
                except NetlinkError as exc:
                    errors.append(f"label {route.top_label}: {exc}")
            if not kernel_mode or self._mpls_kernel is False:
                self.mpls[client_id] = {r.top_label: r for r in routes}
            elif dump_ok:
                for label in current - wanted:
                    try:
                        self.nl.del_mpls_route(
                            MplsRouteInfo(label=label, protocol=proto)
                        )
                    except NetlinkError as exc:
                        errors.append(f"del label {label}: {exc}")
            else:
                # stale-route withdrawal NEEDS the readback; skipping it
                # silently would leave stale labels while reporting
                # success — surface it so Fib's backoff retries the sync
                errors.append(
                    "kernel MPLS readback failed; stale-route deletion "
                    "skipped"
                )
            self._bump("fibagent.kernel.sync_mpls_fib")
            if errors:
                raise RuntimeError(
                    f"sync_mpls_fib: {len(errors)} route(s) failed: "
                    + "; ".join(errors[:8])
                )

    def get_route_table_by_client(self, client_id: int) -> list[UnicastRoute]:
        with self._lock:
            index_name = {
                l.if_index: l.if_name for l in self.nl.get_all_links()
            }
            out = []
            for r in self.nl.get_routes(
                protocol=self._protocol(client_id), table=self.table_id
            ):
                out.append(
                    UnicastRoute(
                        dest=r.dst,
                        next_hops=[
                            NextHop(
                                address=nh.gateway or "",
                                if_name=index_name.get(nh.if_index),
                                weight=nh.weight,
                            )
                            for nh in r.nexthops
                        ],
                    )
                )
            return sorted(out, key=lambda r: r.dest)

    def get_mpls_route_table_by_client(self, client_id: int) -> list[MplsRoute]:
        """Kernel readback of this client's AF_MPLS routes, with nexthop
        actions inferred from the wire form (RTA_NEWDST stack -> SWAP/
        PUSH, bare via -> PHP, oif-only -> POP_AND_LOOKUP); in-process
        table only on no-MPLS kernels.

        Wire-fidelity caveat: a single-label PUSH and a SWAP are the SAME
        kernel route (one-entry RTA_NEWDST), so readback reports SWAP for
        both; programmed weight 0 reads back as 1 (rtnh_hops).  Consumers
        must not full-equality-diff readback against intent —
        sync_mpls_fib correctly diffs by label only."""
        with self._lock:
            if self._mpls_kernel is False:
                return sorted(
                    self.mpls.get(client_id, {}).values(),
                    key=lambda r: r.top_label,
                )
            try:
                kernel_routes = self.nl.get_mpls_routes(
                    self._protocol(client_id)
                )
            except OSError:
                if self._mpls_kernel is True:
                    # kernel mode is established: a transient dump
                    # failure must surface, not read back as an empty
                    # table (the in-process dict is empty in this mode)
                    raise
                # unprobed kernel: may simply lack AF_MPLS
                return sorted(
                    self.mpls.get(client_id, {}).values(),
                    key=lambda r: r.top_label,
                )
            index_name = {
                l.if_index: l.if_name for l in self.nl.get_all_links()
            }
            out = []
            for r in kernel_routes:
                hops = []
                for nh in r.nexthops:
                    if nh.swap_labels and len(nh.swap_labels) == 1:
                        act = MplsAction(
                            MplsActionCode.SWAP,
                            swap_label=nh.swap_labels[0],
                        )
                    elif nh.swap_labels:
                        act = MplsAction(
                            MplsActionCode.PUSH,
                            push_labels=tuple(nh.swap_labels),
                        )
                    elif nh.gateway is not None:
                        act = MplsAction(MplsActionCode.PHP)
                    else:
                        act = MplsAction(MplsActionCode.POP_AND_LOOKUP)
                    hops.append(
                        NextHop(
                            address=nh.gateway or "",
                            if_name=index_name.get(nh.if_index),
                            weight=nh.weight,
                            mpls_action=act,
                        )
                    )
                out.append(MplsRoute(top_label=r.label, next_hops=hops))
            return sorted(out, key=lambda r: r.top_label)

    def alive_since(self) -> int:
        return self._alive_since

    def get_counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counters)


class FibAgentServer:
    """NDJSON-RPC server fronting a SimulatedRouteTable or a
    KernelRouteTable — the process boundary the reference crosses with
    thrift (Fib -> platform agent).  Request lines may be up to
    WIRE_LINE_LIMIT long (a syncFib carries every route in one line)."""

    def __init__(
        self,
        table: Any = None,  # SimulatedRouteTable | KernelRouteTable
        host: str = "::1",
        port: int = 0,
    ) -> None:
        self.table = table or SimulatedRouteTable()
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    # method table: wire name (Platform.thrift) -> handler
    def _dispatch(self, method: str, p: dict) -> Any:
        t = self.table
        if method == "addUnicastRoutes":
            return t.add_unicast_routes(p["clientId"], p["routes"])
        if method == "deleteUnicastRoutes":
            return t.delete_unicast_routes(p["clientId"], p["prefixes"])
        if method == "addMplsRoutes":
            return t.add_mpls_routes(p["clientId"], p["routes"])
        if method == "deleteMplsRoutes":
            return t.delete_mpls_routes(p["clientId"], p["topLabels"])
        if method == "syncFib":
            return t.sync_fib(p["clientId"], p["routes"])
        if method == "syncMplsFib":
            return t.sync_mpls_fib(p["clientId"], p["routes"])
        if method == "getRouteTableByClient":
            return t.get_route_table_by_client(p["clientId"])
        if method == "getMplsRouteTableByClient":
            return t.get_mpls_route_table_by_client(p["clientId"])
        if method == "aliveSince":
            return t.alive_since()
        if method == "getCounters":
            return t.get_counters()
        raise ValueError(f"unknown method {method!r}")

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                try:
                    line = await reader.readline()
                except ValueError:  # over WIRE_LINE_LIMIT: say so, hang up
                    writer.write(
                        json.dumps(
                            {"id": None, "error": "request line too long"}
                        ).encode()
                        + b"\n"
                    )
                    await writer.drain()
                    return
                if not line:
                    return
                try:
                    msg = json.loads(line)
                except ValueError:
                    msg = None  # malformed line: error reply with no id
                msg_id = msg.get("id") if isinstance(msg, dict) else None
                try:
                    if not isinstance(msg, dict):
                        raise ValueError("malformed request")
                    result = self._dispatch(
                        msg.get("method", ""), from_wire(msg.get("params")) or {}
                    )
                    reply = {"id": msg_id, "result": to_wire(result)}
                except Exception as exc:  # surfaced to the client
                    reply = {
                        "id": msg_id,
                        "error": f"{type(exc).__name__}: {exc}",
                    }
                writer.write(json.dumps(reply).encode() + b"\n")
                await writer.drain()
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def _serve(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port, limit=WIRE_LINE_LIMIT
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def start(self) -> None:
        """Serve in a background thread (for in-process tests); the
        standalone entry point uses run_forever() instead."""

        def _run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._serve())
            except asyncio.CancelledError:
                pass
            finally:
                self._loop.close()

        self._thread = threading.Thread(
            target=_run, name="fib-agent", daemon=True
        )
        self._thread.start()
        assert self._started.wait(10), "fib agent failed to start"

    def stop(self) -> None:
        if self._loop is not None:

            def _stop():
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()

            self._loop.call_soon_threadsafe(_stop)
        if self._thread is not None:
            self._thread.join(5)

    def run_forever(self) -> None:
        asyncio.run(self._serve())


class TcpFibAgent:
    """Client side: implements the Fib module's FibAgent protocol over the
    agent's wire transport (reference: Fib::createFibClient, Fib.h:68).

    Synchronous (called from the Fib event-base thread); one persistent
    connection, reconnected on failure — a failed call raises, which drives
    Fib's retry/backoff + full-resync machinery exactly like a thrift
    transport error does in the reference."""

    def __init__(self, host: str = "::1", port: int = 60100, timeout_s: float = 5.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._file = None
        self._next_id = 0

    def _connect(self) -> None:
        if self._sock is not None:
            return
        info = socket.getaddrinfo(
            self.host, self.port, type=socket.SOCK_STREAM
        )[0]
        sock = socket.socket(info[0], info[1])
        sock.settimeout(self.timeout_s)
        sock.connect(info[4])
        self._sock = sock
        self._file = sock.makefile("rwb")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._file = None

    def _call(self, method: str, params: dict) -> Any:
        self._connect()
        self._next_id += 1
        request = {
            "id": self._next_id,
            "method": method,
            "params": to_wire(params),
        }
        try:
            self._file.write(json.dumps(request).encode() + b"\n")
            self._file.flush()
            line = self._file.readline()
        except OSError:
            self.close()
            raise
        if not line:
            self.close()
            raise ConnectionError("fib agent closed connection")
        msg = json.loads(line)
        if "error" in msg:
            raise RuntimeError(f"fib agent error: {msg['error']}")
        return from_wire(msg.get("result"))

    # -- FibAgent protocol ---------------------------------------------------

    def add_unicast_routes(
        self, client_id: int, routes: list[UnicastRoute]
    ) -> None:
        self._call("addUnicastRoutes", {"clientId": client_id, "routes": routes})

    def delete_unicast_routes(
        self, client_id: int, prefixes: list[str]
    ) -> None:
        self._call(
            "deleteUnicastRoutes", {"clientId": client_id, "prefixes": prefixes}
        )

    def add_mpls_routes(self, client_id: int, routes: list[MplsRoute]) -> None:
        self._call("addMplsRoutes", {"clientId": client_id, "routes": routes})

    def delete_mpls_routes(self, client_id: int, labels: list[int]) -> None:
        self._call(
            "deleteMplsRoutes", {"clientId": client_id, "topLabels": labels}
        )

    def sync_fib(self, client_id: int, routes: list[UnicastRoute]) -> None:
        self._call("syncFib", {"clientId": client_id, "routes": routes})

    def sync_mpls_fib(self, client_id: int, routes: list[MplsRoute]) -> None:
        self._call("syncMplsFib", {"clientId": client_id, "routes": routes})

    def get_route_table_by_client(self, client_id: int) -> list[UnicastRoute]:
        return self._call("getRouteTableByClient", {"clientId": client_id})

    def get_mpls_route_table_by_client(self, client_id: int) -> list[MplsRoute]:
        return self._call("getMplsRouteTableByClient", {"clientId": client_id})

    def alive_since(self) -> int:
        return int(self._call("aliveSince", {}))

    def get_counters(self) -> dict[str, int]:
        return self._call("getCounters", {})


def main(argv: Optional[Iterable[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Standalone FibService platform agent "
        "(reference: platform_linux / LinuxPlatformMain.cpp)"
    )
    parser.add_argument("--host", default="::1")
    parser.add_argument("--port", type=int, default=60100)
    parser.add_argument(
        "--kernel",
        action="store_true",
        help="program REAL kernel routes via rtnetlink (needs "
        "CAP_NET_ADMIN); default is the simulated table",
    )
    parser.add_argument(
        "--route-table",
        type=int,
        default=None,
        help="kernel routing table id (default: main/254)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(list(argv) if argv is not None else None)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    table = (
        KernelRouteTable(table_id=args.route_table) if args.kernel else None
    )
    server = FibAgentServer(table=table, host=args.host, port=args.port)
    print(f"fib-agent listening on [{args.host}]:{args.port}", flush=True)
    try:
        server.run_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
