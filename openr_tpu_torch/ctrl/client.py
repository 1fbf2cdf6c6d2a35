"""Ctrl clients: synchronous (CLI) and the TCP KvStore peer transport.

Port of `openr_tpu.ctrl.client`, on the same wire, so a port client
talks to a reference server and the reverse.  Reference equivalents:
openr/py/openr/clients/openr_client.py (CLI thrift client) and the
KvStore thrift peer client (KvStore.h:429-453).
"""

from __future__ import annotations

import asyncio
import json
import socket
import threading
from typing import Any, Iterator, Optional

from ..serializer import from_wire, to_wire
from ..types import PeerSpec, Publication

# Longest JSON line either end of an asyncio connection accepts.  A full
# or 3-way KvStore sync carries the whole dump (or every key's hash) as
# one line, far past asyncio's 64 KiB default for any real topology.
WIRE_LINE_LIMIT = 1 << 30


class CtrlClient:
    """Blocking NDJSON-RPC client (one TCP connection, serial requests)."""

    def __init__(
        self,
        host: str = "::1",
        port: int = 2018,
        timeout_s: float = 10.0,
        tls=None,  # Optional[tls.TlsConfig] — client cert for mTLS
    ) -> None:
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.tls = tls
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._next_id = 0
        self._lock = threading.Lock()

    def _connect(self) -> None:
        if self._sock is not None:
            return
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        if self.tls is not None:
            from .tls import client_context, verify_peer

            try:
                sock = client_context(self.tls).wrap_socket(sock)
                verify_peer(self.tls, sock)
            except Exception:
                sock.close()  # don't leak the raw fd on handshake failure
                raise
        self._sock = sock
        self._rfile = self._sock.makefile("rb")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._rfile = None

    def __enter__(self) -> "CtrlClient":
        self._connect()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def call(self, method: str, **params: Any) -> Any:
        with self._lock:
            self._connect()
            self._next_id += 1
            msg_id = self._next_id
            request = {"id": msg_id, "method": method, "params": to_wire(params)}
            self._sock.sendall(json.dumps(request).encode() + b"\n")
            while True:
                line = self._rfile.readline()
                if not line:
                    raise ConnectionError("ctrl server closed connection")
                msg = json.loads(line)
                if msg.get("id") != msg_id:
                    continue  # stale stream frame from a prior subscription
                if "error" in msg:
                    raise RuntimeError(msg["error"])
                return from_wire(msg.get("result"))

    def stream(
        self, method: str, **params: Any
    ) -> Iterator[Any]:
        """Server-stream iterator (subscribeKvStore / subscribeFib)."""
        with self._lock:
            self._connect()
            self._next_id += 1
            msg_id = self._next_id
            request = {"id": msg_id, "method": method, "params": to_wire(params)}
            self._sock.sendall(json.dumps(request).encode() + b"\n")

        def _iter() -> Iterator[Any]:
            while True:
                line = self._rfile.readline()
                if not line:
                    return
                msg = json.loads(line)
                if msg.get("id") != msg_id:
                    continue
                if "error" in msg:
                    raise RuntimeError(msg["error"])
                if "stream" in msg:
                    yield from_wire(msg["stream"])
                elif "result" in msg:
                    yield from_wire(msg["result"])
                    return

        return _iter()

    def cancel_streams(self) -> None:
        self.close()


class TcpKvStoreTransport:
    """KvStore peer transport over peers' ctrl servers (the reference's
    thrift peer-sync path).  Async, used from the KvStore event base; one
    short-lived connection per request (reconnect cost is absorbed by the
    peer FSM's backoff)."""

    def __init__(
        self,
        default_port: int = 2018,
        timeout_s: float = 10.0,
        tls=None,  # Optional[tls.TlsConfig] — peers require our cert too
    ) -> None:
        self.default_port = default_port
        self.timeout_s = timeout_s
        self.tls = tls
        # built eagerly: cert loading is blocking disk I/O that must not
        # run on the KvStore event loop, and bad paths should fail here
        self._ssl_ctx = None
        if tls is not None:
            from .tls import client_context

            self._ssl_ctx = client_context(tls)

    async def _call(self, peer: PeerSpec, method: str, params: dict) -> Any:
        host = peer.peer_addr
        port = peer.ctrl_port or self.default_port
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(
                host, port, ssl=self._ssl_ctx, limit=WIRE_LINE_LIMIT
            ),
            self.timeout_s,
        )
        if self._ssl_ctx is not None:
            from .tls import verify_peer

            try:
                verify_peer(self.tls, writer.get_extra_info("ssl_object"))
            except Exception:
                writer.close()
                raise
        try:
            request = {"id": 1, "method": method, "params": to_wire(params)}
            writer.write(json.dumps(request).encode() + b"\n")
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(), self.timeout_s)
            if not line:
                raise ConnectionError("peer closed connection")
            msg = json.loads(line)
            if "error" in msg:
                raise RuntimeError(msg["error"])
            return from_wire(msg.get("result"))
        finally:
            writer.close()

    async def full_dump(self, peer: PeerSpec, area: str, params) -> Publication:
        result = await self._call(
            peer,
            "getKvStoreKeyValsFilteredArea",
            {
                "area": area,
                "prefixes": list(params.keys),
                "originators": list(params.originator_ids),
                "key_val_hashes": params.key_val_hashes,
            },
        )
        assert isinstance(result, Publication), type(result)
        return result

    async def key_set(self, peer: PeerSpec, area: str, params) -> None:
        await self._call(
            peer,
            "setKvStoreKeyVals",
            {
                "area": area,
                "key_vals": params.key_vals,
                "node_ids": params.node_ids,
                "flood_root_id": params.flood_root_id,
            },
        )

    async def dual_messages(self, peer: PeerSpec, area: str, msgs) -> None:
        await self._call(
            peer,
            "processKvStoreDualMessage",
            {"area": area, "messages": msgs},
        )

    async def flood_topo_set(self, peer: PeerSpec, area: str, params) -> None:
        await self._call(
            peer,
            "updateFloodTopologyChild",
            {"area": area, "params": params},
        )
