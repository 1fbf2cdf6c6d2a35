"""Thrift-binary wire shim: a stock-openr-shaped listener over the
daemon's modules.

Port of `openr_tpu.interop.shim`.  A client speaking the thrift Binary
protocol over framed transport (what `thrift.TBinaryProtocol` /
`TFramedTransport` produce — the encoding a stock openr tool emits when
pointed at a plain thrift-binary endpoint) can call

    getMyNodeName()                                -> string
    getOpenrVersion()                              -> OpenrVersions
    getKvStoreKeyVals(1: list<string> filterKeys)  -> Publication
    getKvStoreKeyValsArea(1: filterKeys, 2: area)  -> Publication
    getKvStoreKeyValsFiltered[Area](1: filter, ..) -> Publication
    getKvStoreHashFiltered[Area](1: filter, ..)    -> Publication
    getKvStorePeers[Area](..)                      -> PeersMap
    setKvStoreKeyVals(1: KeySetParams, 2: area)    -> void
    longPollKvStoreAdj[Area](.., snapshot)         -> bool
    getRouteDb() / getRouteDbComputed(1: node)     -> RouteDatabase
    getUnicastRoutes[Filtered] / getMplsRoutes[Filtered]
    getCounters() / getRegexCounters(1: regex)     -> map<string, i64>
    queryPathsBatched(1: sources, 2: area)         -> map<src, map<dst, i64>>

against this daemon (reference signatures:
openr/if/OpenrCtrl.thrift:298-492, 560, 612; fb303 for the counters).
`getRouteDbComputed` answers from the card Decision and
`queryPathsBatched` from the daemon's QueryScheduler on the card.  A
method that fails, and an unknown method, get a TApplicationException,
exactly as a thrift server would answer; no method answers empty for a
failure.

This deliberately does NOT implement fbthrift's rocket/header transport
(the reference's default in-fleet transport); the shim covers the
stable, documented thrift Binary+framed stack that thrift-generated
clients in any language can select.
"""

from __future__ import annotations

import asyncio
import logging
import struct as _s
from typing import Optional

from .. import types as T
from ..runtime.eventbase import OpenrEventBase
from . import thrift_binary as tb

log = logging.getLogger(__name__)

MAX_FRAME = 64 * 1024 * 1024
# getRegexCounters patterns run on the event loop against every counter
# key — cap what one client can submit (generous: fb303 regexes in the
# wild are tens of chars)
MAX_COUNTER_REGEX_LEN = 1024

# argument StructSpecs (module constants: the shim decodes at wire rate)
_GET_ARGS = tb.StructSpec(
    "getKvStoreKeyVals_args",
    None,
    (
        tb.Field(
            1,
            "filter_keys",
            ("list", tb.T_STRING),
            dec=lambda xs: [x.decode() for x in xs],
            default=[],
        ),
    ),
)
_GET_AREA_ARGS = tb.StructSpec(
    "getKvStoreKeyValsArea_args",
    None,
    _GET_ARGS.fields
    + (
        tb.Field(
            2, "area", tb.T_STRING, dec=lambda b: b.decode(), default="0"
        ),
    ),
)
_SET_ARGS = tb.StructSpec(
    "setKvStoreKeyVals_args",
    None,
    (
        tb.Field(1, "set_params", ("struct", tb.KEY_SET_PARAMS)),
        tb.Field(
            2, "area", tb.T_STRING, dec=lambda b: b.decode(), default="0"
        ),
    ),
)
_EMPTY_ARGS = tb.StructSpec("empty_args", None, ())
_FILTER_ARGS = tb.StructSpec(
    "filtered_args",
    None,
    (
        tb.Field(1, "filter", ("struct", tb.KEY_DUMP_PARAMS)),
        tb.Field(
            2, "area", tb.T_STRING, dec=lambda b: b.decode(), default="0"
        ),
    ),
)
_AREA_ARGS = tb.StructSpec(
    "area_args",
    None,
    (
        tb.Field(
            1, "area", tb.T_STRING, dec=lambda b: b.decode(), default="0"
        ),
    ),
)
_PEERS_MAP = ("map", tb.T_STRING, ("struct", tb.PEER_SPEC))
# OpenrCtrl.thrift:313 getRouteDbComputed(1: string nodeName)
_NODE_ARGS = tb.StructSpec(
    "node_args",
    None,
    (
        tb.Field(
            1, "node_name", tb.T_STRING, dec=lambda b: b.decode(), default=""
        ),
    ),
)
# OpenrCtrl.thrift:322 getUnicastRoutesFiltered(1: list<string> prefixes)
_PREFIXES_ARGS = tb.StructSpec(
    "prefixes_args",
    None,
    (
        tb.Field(
            1,
            "prefixes",
            ("list", tb.T_STRING),
            dec=lambda xs: [x.decode() for x in xs],
            default=[],
        ),
    ),
)
# OpenrCtrl.thrift:335 getMplsRoutesFiltered(1: list<i32> labels)
_LABELS_ARGS = tb.StructSpec(
    "labels_args",
    None,
    (tb.Field(1, "labels", ("list", tb.T_I32), default=[]),),
)
# fb303 getRegexCounters(1: string regex)
_REGEX_ARGS = tb.StructSpec(
    "regex_args",
    None,
    (
        tb.Field(
            1, "regex", tb.T_STRING, dec=lambda b: b.decode(), default=".*"
        ),
    ),
)
# OpenrCtrl.thrift:430 longPollKvStoreAdjArea(1: area, 2: KeyVals snapshot)
# and the deprecated area-less longPollKvStoreAdj(1: KeyVals snapshot)
_SNAPSHOT_SPEC = ("map", tb.T_STRING, ("struct", tb.VALUE))
_LONG_POLL_ARGS = tb.StructSpec(
    "longPollKvStoreAdj_args",
    None,
    (
        tb.Field(
            1,
            "snapshot",
            _SNAPSHOT_SPEC,
            dec=lambda m: {k.decode(): v for k, v in m.items()},
            default={},
        ),
    ),
)
_LONG_POLL_AREA_ARGS = tb.StructSpec(
    "longPollKvStoreAdjArea_args",
    None,
    (
        tb.Field(
            1, "area", tb.T_STRING, dec=lambda b: b.decode(), default="0"
        ),
        tb.Field(
            2,
            "snapshot",
            _SNAPSHOT_SPEC,
            dec=lambda m: {k.decode(): v for k, v in m.items()},
            default={},
        ),
    ),
)
# serving: queryPathsBatched(1: list<string> sources, 2: string area)
# -> map<source, map<dest, i64 distance>> (new capability, no reference
# RPC; rides the QueryScheduler's admission/coalescing pipeline)
_QUERY_PATHS_ARGS = tb.StructSpec(
    "queryPathsBatched_args",
    None,
    (
        tb.Field(
            1,
            "sources",
            ("list", tb.T_STRING),
            dec=lambda xs: [x.decode() for x in xs],
            default=[],
        ),
        tb.Field(
            2, "area", tb.T_STRING, dec=lambda b: b.decode(), default="0"
        ),
    ),
)
_DISTANCES_MAP = ("map", tb.T_STRING, ("map", tb.T_STRING, tb.T_I64))


class ThriftBinaryShim(OpenrEventBase):
    """Framed thrift-binary listener fronting a KvStore instance (and,
    when given, the daemon's Decision, Fib, QueryScheduler and counters)."""

    def __init__(
        self,
        kvstore,
        host: str = "::1",
        port: int = 0,
        node_name: str = "",
        decision=None,
        fib=None,
        serving=None,
        counters_fn=None,
        kvstore_updates_queue=None,
        long_poll_timeout_s: float = 20.0,
        query_timeout_s: float = 60.0,
    ) -> None:
        super().__init__(name="thrift-shim")
        self.kvstore = kvstore
        self.host = host
        self.port = port
        self.node_name = node_name
        self.decision = decision
        self.fib = fib
        # QueryScheduler (serving/): queryPathsBatched submits
        # into its admission queue; sheds answer as thrift exceptions
        self.serving = serving
        self.query_timeout_s = query_timeout_s
        # () -> dict[str, int]: the daemon passes the ctrl server's
        # merged per-module counter dump (fb303 getCounters semantics)
        self.counters_fn = counters_fn
        # ReplicateQueue[Publication]: longPollKvStoreAdj blocks on it
        # (same wiring as the native ctrl server's _long_poll_adj)
        self.kvstore_updates_queue = kvstore_updates_queue
        self.long_poll_timeout_s = long_poll_timeout_s
        self._server: Optional[asyncio.AbstractServer] = None

    def _fib(self):
        if self.fib is None:
            raise RuntimeError("fib module not attached")
        return self.fib

    def run(self) -> None:
        super().run()
        self.wait_until_running()
        self.run_coroutine(self._start()).result(timeout=10)

    async def _start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, host=self.host, port=self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    def stop(self) -> None:
        if self._server is not None and self._loop is not None:
            server, self._server = self._server, None

            def _close() -> None:
                server.close()

            try:
                self.run_in_event_base_thread(_close).result(timeout=5)
            except Exception:
                pass
        super().stop()

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            while True:
                head = await reader.readexactly(4)
                (length,) = _s.unpack("!i", head)
                if not 0 < length <= MAX_FRAME:
                    raise tb.ThriftError(f"bad frame length {length}")
                msg = await reader.readexactly(length)
                name, mtype, seqid, r = tb.decode_message(msg)
                if mtype == tb.MSG_CALL and name in (
                    "longPollKvStoreAdj",
                    "longPollKvStoreAdjArea",
                ):
                    # long poll blocks on the kvstore updates queue: keep
                    # it on the loop (async queue reader) rather than
                    # parking an executor thread for up to the timeout
                    reply = await self._long_poll_adj(name, seqid, r)
                else:
                    # the KvStore calls block on a cross-thread Future
                    # with no timeout; off the loop thread so one
                    # busy/stopped KvStore cannot wedge every other shim
                    # connection (and stop()'s _close, which runs on this
                    # same loop)
                    reply = await asyncio.get_running_loop().run_in_executor(
                        None, self._serve, msg
                    )
                writer.write(tb.frame(reply))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except tb.ThriftError as exc:
            log.warning("thrift shim: %s", exc)
        finally:
            writer.close()

    # -- long poll (reference: longPollKvStoreAdjArea,
    #    OpenrCtrl.thrift:430 / OpenrCtrlHandler.h:269) --------------------

    async def _long_poll_adj(self, name: str, seqid: int, r) -> bytes:
        """Resolve True when any adj: key moves beyond the client's
        version snapshot, False on timeout — the native ctrl server's
        _long_poll_adj semantics on the thrift-binary wire."""
        from ..runtime.queue import QueueClosedError
        from ..types import ADJ_MARKER

        try:
            if name == "longPollKvStoreAdjArea":
                args = tb.read_struct(r, _LONG_POLL_AREA_ARGS)
            else:
                args = tb.read_struct(r, _LONG_POLL_ARGS)
            area = args.get("area", "0")
            snapshot = {
                key: val.version
                for key, val in (args.get("snapshot") or {}).items()
            }
            queue = self.kvstore_updates_queue
            if queue is None:
                raise RuntimeError("kvstore updates queue not attached")
            loop = asyncio.get_running_loop()
            # the reader is registered BEFORE the snapshot comparison so a
            # publication racing the dump is never lost
            q_reader = queue.get_reader()
            try:
                current = await loop.run_in_executor(
                    None,
                    lambda: self.kvstore.dump_all(
                        area, key_prefixes=[ADJ_MARKER]
                    ),
                )
                changed = any(
                    snapshot.get(key) != val.version
                    for key, val in current.key_vals.items()
                )
                deadline = loop.time() + self.long_poll_timeout_s
                while not changed:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        return self._reply(name, seqid, tb.T_BOOL, False)
                    try:
                        pub = await asyncio.wait_for(
                            q_reader.aget(), timeout
                        )
                    except (asyncio.TimeoutError, QueueClosedError):
                        return self._reply(name, seqid, tb.T_BOOL, False)
                    if pub.area != area:
                        continue
                    changed = any(
                        key.startswith(ADJ_MARKER)
                        and snapshot.get(key) != val.version
                        for key, val in pub.key_vals.items()
                    ) or any(
                        key.startswith(ADJ_MARKER)
                        for key in pub.expired_keys
                    )
                return self._reply(name, seqid, tb.T_BOOL, True)
            finally:
                queue.close_reader(q_reader)
        except tb.ThriftError:
            raise
        except Exception as exc:
            log.warning("thrift shim %s failed: %s", name, exc)
            return tb.encode_application_exception(name, seqid, str(exc))

    # -- dispatch ------------------------------------------------------------

    def _serve(self, msg: bytes) -> bytes:
        name, mtype, seqid, r = tb.decode_message(msg)
        if mtype != tb.MSG_CALL:
            return tb.encode_application_exception(
                name, seqid, f"unexpected message type {mtype}"
            )
        try:
            if name == "getMyNodeName":
                tb.read_struct(r, _EMPTY_ARGS)
                return self._reply(name, seqid, tb.T_STRING, self.node_name)
            if name == "getOpenrVersion":
                from ..ctrl.server import (
                    OPENR_LOWEST_SUPPORTED_VERSION,
                    OPENR_VERSION,
                )

                tb.read_struct(r, _EMPTY_ARGS)
                return self._reply(
                    name,
                    seqid,
                    ("struct", tb.OPENR_VERSIONS),
                    {
                        "version": OPENR_VERSION,
                        "lowest_supported_version": (
                            OPENR_LOWEST_SUPPORTED_VERSION
                        ),
                    },
                )
            if name == "getKvStoreKeyVals":
                args = tb.read_struct(r, _GET_ARGS)
                pub = self.kvstore.get_key_vals("0", args["filter_keys"])
                return self._reply(name, seqid, ("struct", tb.PUBLICATION), pub)
            if name == "getKvStoreKeyValsArea":
                args = tb.read_struct(r, _GET_AREA_ARGS)
                pub = self.kvstore.get_key_vals(
                    args["area"], args["filter_keys"]
                )
                return self._reply(name, seqid, ("struct", tb.PUBLICATION), pub)
            if name in (
                "getKvStoreKeyValsFiltered",
                "getKvStoreKeyValsFilteredArea",
                "getKvStoreHashFiltered",
                "getKvStoreHashFilteredArea",
            ):
                args = tb.read_struct(r, _FILTER_ARGS)
                filt = args["filter"]
                # the deprecated prefix field is COMMA-SEPARATED (the
                # reference folly::split's it, KvStore.cpp:649; legacy
                # breeze joins multiple --prefix args into it)
                prefixes = filt.get("keys") or [
                    p for p in (filt.get("prefix") or "").split(",") if p
                ]
                originators = filt.get("originator_ids") or []
                # FilterOperator (Types.thrift:639): OR=1 (default), AND=2
                match_all = filt.get("oper") == 2
                hash_only = bool(filt.get("do_not_publish_value"))
                if "Hash" in name:
                    pub = self.kvstore.dump_hashes(
                        args["area"], prefixes, originators
                    )
                elif match_all or hash_only:
                    # display-oriented variants (same routing as the ctrl
                    # server's _kvstore_dump_filtered): AND semantics /
                    # values withheld
                    pub = self.kvstore.dump_all(
                        args["area"],
                        key_prefixes=prefixes,
                        originator_ids=originators,
                        match_all=match_all,
                        do_not_publish_value=hash_only,
                    )
                else:
                    # the peer full-sync path: 3-way diff when the caller
                    # sent its key_val_hashes, remaining-TTL adjustment
                    # always (a dump_all here would re-arm full TTLs on
                    # the remote side every sync)
                    from ..kvstore.kvstore import KeyDumpParams

                    pub = self.kvstore.process_full_dump(
                        args["area"],
                        KeyDumpParams(
                            keys=prefixes,
                            originator_ids=originators,
                            key_val_hashes=filt.get("key_val_hashes"),
                        ),
                    )
                return self._reply(name, seqid, ("struct", tb.PUBLICATION), pub)
            if name in ("getKvStorePeers", "getKvStorePeersArea"):
                args = tb.read_struct(r, _AREA_ARGS)
                peers = self.kvstore.dump_peers(args["area"])
                wire = {
                    nm: {
                        "peer_addr": ps.peer_addr,
                        "ctrl_port": ps.ctrl_port,
                        "state": int(ps.state),
                    }
                    for nm, ps in peers.items()
                }
                return self._reply(name, seqid, _PEERS_MAP, wire)
            if name in ("getCounters", "getRegexCounters"):
                # fb303 base-service surface stock monitoring tooling
                # polls (map<string, i64>)
                import re as _re

                if name == "getRegexCounters":
                    args = tb.read_struct(r, _REGEX_ARGS)
                    regex = args.get("regex") or ""
                    # the pattern runs on the daemon event loop against
                    # every counter key: bound what one client can make
                    # it cost.  Length-capped patterns over short keys
                    # bound re backtracking; compile/match errors answer
                    # as a thrift application exception instead of
                    # killing the connection handler.
                    if len(regex) > MAX_COUNTER_REGEX_LEN:
                        raise RuntimeError(
                            "counter regex longer than "
                            f"{MAX_COUNTER_REGEX_LEN} chars"
                        )
                    try:
                        pat = _re.compile(regex)
                    except _re.error as exc:
                        raise RuntimeError(f"bad counter regex: {exc}")
                else:
                    tb.read_struct(r, _EMPTY_ARGS)
                    pat = None
                if self.counters_fn is None:
                    raise RuntimeError("counters source not attached")

                def _matches(key: str) -> bool:
                    if pat is None:
                        return True
                    try:
                        return pat.search(key) is not None
                    except Exception:  # e.g. RecursionError on
                        return False  # pathological nesting
                counters = {
                    k: int(v)
                    for k, v in self.counters_fn().items()
                    if _matches(k)
                }
                return self._reply(
                    name, seqid, ("map", tb.T_STRING, tb.T_I64), counters
                )
            if name == "getRouteDb":
                # reference: routes as tracked by the FIB module
                # (OpenrCtrl.thrift:298)
                tb.read_struct(r, _EMPTY_ARGS)
                unicast, mpls = self._fib().get_route_db()
                db = T.RouteDatabase(
                    this_node_name=self.node_name,
                    unicast_routes=unicast,
                    mpls_routes=mpls,
                )
                return self._reply(
                    name, seqid, ("struct", tb.ROUTE_DATABASE), db
                )
            if name == "getRouteDbComputed":
                # Decision-computed, any node's perspective
                # (OpenrCtrl.thrift:313, Decision.cpp:1510-1530); empty
                # nodeName = this node — served from the fleet product
                # when a warm view covers the target
                args = tb.read_struct(r, _NODE_ARGS)
                if self.decision is None:
                    raise RuntimeError("decision module not attached")
                rib = self.decision.get_route_db(args["node_name"])
                db = T.RouteDatabase(
                    this_node_name=args["node_name"] or self.node_name,
                    unicast_routes=[
                        e.to_unicast_route()
                        for e in rib.unicast_routes.values()
                    ],
                    mpls_routes=[
                        e.to_mpls_route() for e in rib.mpls_routes.values()
                    ],
                )
                return self._reply(
                    name, seqid, ("struct", tb.ROUTE_DATABASE), db
                )
            if name in ("getUnicastRoutes", "getUnicastRoutesFiltered"):
                args = (
                    tb.read_struct(r, _PREFIXES_ARGS)
                    if name.endswith("Filtered")
                    else (tb.read_struct(r, _EMPTY_ARGS) or {"prefixes": []})
                )
                routes = self._fib().get_unicast_routes(
                    args.get("prefixes") or None
                )
                return self._reply(
                    name,
                    seqid,
                    ("list", ("struct", tb.UNICAST_ROUTE)),
                    routes,
                )
            if name in ("getMplsRoutes", "getMplsRoutesFiltered"):
                args = (
                    tb.read_struct(r, _LABELS_ARGS)
                    if name.endswith("Filtered")
                    else (tb.read_struct(r, _EMPTY_ARGS) or {"labels": []})
                )
                mpls = self._fib().get_route_db()[1]
                labels = set(args.get("labels") or [])
                if labels:
                    mpls = [m for m in mpls if m.top_label in labels]
                return self._reply(
                    name, seqid, ("list", ("struct", tb.MPLS_ROUTE)), mpls
                )
            if name == "queryPathsBatched":
                # one submit per source: the scheduler's coalescer groups
                # them into one engine dispatch (same epoch, same op), so
                # an N-source call costs one device batch, not N
                args = tb.read_struct(r, _QUERY_PATHS_ARGS)
                if self.serving is None:
                    raise RuntimeError("serving module not attached")
                futs = [
                    (src, self.serving.submit(
                        "paths", area=args["area"], sources=(src,)
                    ))
                    for src in args["sources"]
                ]
                wire: dict[str, dict[str, int]] = {}
                for src, fut in futs:
                    res = fut.result(timeout=self.query_timeout_s)
                    spf = res.value.get(src, {})
                    wire[src] = {
                        dest: int(nr.metric) for dest, nr in spf.items()
                    }
                return self._reply(name, seqid, _DISTANCES_MAP, wire)
            if name == "setKvStoreKeyVals":
                args = tb.read_struct(r, _SET_ARGS)
                params = args["set_params"]
                self.kvstore.set_key_vals(
                    args["area"],
                    params["key_vals"],
                    node_ids=params.get("node_ids"),
                    flood_root_id=params.get("flood_root_id"),
                )
                return self._reply(name, seqid, None, None)
        except tb.ThriftError:
            raise
        except Exception as exc:  # surfaced as a thrift exception
            log.warning("thrift shim %s failed: %s", name, exc)
            return tb.encode_application_exception(name, seqid, str(exc))
        return tb.encode_application_exception(
            name, seqid, f"unknown method {name!r}"
        )

    @staticmethod
    def _reply(name: str, seqid: int, success_spec, value) -> bytes:
        """Reply payload: struct with the success value at field 0 (void
        replies carry an empty struct)."""
        w = tb._Writer()
        if success_spec is not None:
            w.u8(tb._ttype_of(success_spec))
            w.i16(0)
            tb._write_value(w, success_spec, value)
        w.u8(tb.T_STOP)
        return tb.encode_message(name, tb.MSG_REPLY, seqid, w.getvalue())
