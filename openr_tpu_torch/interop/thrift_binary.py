"""Thrift Binary-protocol codec for the KvStore- and route-facing wire
structs.

Port of `openr_tpu.interop.thrift_binary`.  The reference's control
plane speaks fbthrift binary RPC (openr/if/OpenrCtrl.thrift:204); this
build's native framing is NDJSON-RPC.  This module is a table-driven
*thrift Binary protocol* encoder/decoder for the structs a stock KvStore
peer or client touches (Value, Publication, the key get/set/dump
params, PeerSpec, OpenrVersions, PerfEvents, Adjacency and
AdjacencyDatabase) and for the route structs of the Decision/Fib query
surface (IpPrefix, MplsAction, NextHopThrift, UnicastRoute, MplsRoute,
RouteDatabase), plus the strict message envelope and framed transport,
so the daemon can answer thrift-binary calls on the wire
(interop.shim).  Its bytes equal the reference's for equal values.

Field ids and types are transcribed from the reference IDL (cited per
spec below).

Thrift Binary protocol (the stable, documented wire format):
  field   = [ttype:u8][field-id:i16 BE][value]; struct ends with 0x00
  i16/i32/i64 = big-endian two's complement; bool = u8; double = BE f64
  string/binary = [len:i32][bytes]
  map  = [ktype:u8][vtype:u8][count:i32][k v ...]
  set/list = [etype:u8][count:i32][elems...]
  strict message = [0x8001:u16][0x00][mtype:u8][name:string][seqid:i32]
Framed transport = [frame-len:i32 BE][message bytes].
"""

from __future__ import annotations

import dataclasses
import ipaddress
import struct as _s
from io import BytesIO
from typing import Any, Optional

from .. import types as T

# thrift type ids
T_STOP = 0
T_BOOL = 2
T_BYTE = 3
T_DOUBLE = 4
T_I16 = 6
T_I32 = 8
T_I64 = 10
T_STRING = 11
T_STRUCT = 12
T_MAP = 13
T_SET = 14
T_LIST = 15

# message types
MSG_CALL = 1
MSG_REPLY = 2
MSG_EXCEPTION = 3

_STRICT_VERSION = 0x80010000


class ThriftError(ValueError):
    pass


# ---------------------------------------------------------------------------
# primitive writer / reader
# ---------------------------------------------------------------------------


class _Writer:
    def __init__(self) -> None:
        self.b = BytesIO()

    def u8(self, v: int) -> None:
        self.b.write(_s.pack("!B", v))

    def i16(self, v: int) -> None:
        self.b.write(_s.pack("!h", v))

    def i32(self, v: int) -> None:
        self.b.write(_s.pack("!i", v))

    def u32(self, v: int) -> None:
        self.b.write(_s.pack("!I", v))

    def i64(self, v: int) -> None:
        self.b.write(_s.pack("!q", v))

    def double(self, v: float) -> None:
        self.b.write(_s.pack("!d", v))

    def binary(self, v: bytes) -> None:
        self.i32(len(v))
        self.b.write(v)

    def string(self, v: str) -> None:
        self.binary(v.encode("utf-8"))

    def getvalue(self) -> bytes:
        return self.b.getvalue()


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.b = BytesIO(data)

    def _read(self, n: int) -> bytes:
        out = self.b.read(n)
        if len(out) != n:
            raise ThriftError("truncated thrift payload")
        return out

    def u8(self) -> int:
        return _s.unpack("!B", self._read(1))[0]

    def i16(self) -> int:
        return _s.unpack("!h", self._read(2))[0]

    def i32(self) -> int:
        return _s.unpack("!i", self._read(4))[0]

    def i64(self) -> int:
        return _s.unpack("!q", self._read(8))[0]

    def double(self) -> float:
        return _s.unpack("!d", self._read(8))[0]

    def binary(self) -> bytes:
        return self._read(self.i32())

    def string(self) -> str:
        return self.binary().decode("utf-8")


# ---------------------------------------------------------------------------
# type specs (table-driven: ("map", kspec, vspec), ("list", espec),
# ("struct", StructSpec), or a primitive ttype int)
# ---------------------------------------------------------------------------


def _ttype_of(spec) -> int:
    if isinstance(spec, int):
        return spec
    kind = spec[0]
    return {"map": T_MAP, "list": T_LIST, "set": T_SET, "struct": T_STRUCT}[
        kind
    ]


@dataclasses.dataclass(frozen=True)
class Field:
    fid: int
    name: str  # attribute on our dataclass
    spec: Any
    optional: bool = False  # unset (None) optionals are not emitted
    # encode/decode value adapters (e.g. string IP <-> BinaryAddress)
    enc: Any = None
    dec: Any = None
    default: Any = None  # value when the field is absent on decode


@dataclasses.dataclass(frozen=True)
class StructSpec:
    name: str
    cls: Any  # our dataclass (or None: decode to dict)
    fields: tuple[Field, ...]

    def field_by_id(self, fid: int) -> Optional[Field]:
        for f in self.fields:
            if f.fid == fid:
                return f
        return None


def _write_value(w: _Writer, spec, v) -> None:
    if isinstance(spec, int):
        if spec == T_BOOL:
            w.u8(1 if v else 0)
        elif spec == T_BYTE:
            w.u8(v & 0xFF)
        elif spec == T_I16:
            w.i16(v)
        elif spec == T_I32:
            w.i32(int(v))
        elif spec == T_I64:
            w.i64(int(v))
        elif spec == T_DOUBLE:
            w.double(v)
        elif spec == T_STRING:
            if isinstance(v, bytes):
                w.binary(v)
            else:
                w.string(v)
        else:
            raise ThriftError(f"unsupported ttype {spec}")
        return
    kind = spec[0]
    if kind == "struct":
        write_struct(w, spec[1], v)
    elif kind == "list" or kind == "set":
        espec = spec[1]
        w.u8(_ttype_of(espec))
        items = sorted(v) if kind == "set" else list(v)
        w.i32(len(items))
        for item in items:
            _write_value(w, espec, item)
    elif kind == "map":
        kspec, vspec = spec[1], spec[2]
        w.u8(_ttype_of(kspec))
        w.u8(_ttype_of(vspec))
        w.i32(len(v))
        for key in sorted(v):
            _write_value(w, kspec, key)
            _write_value(w, vspec, v[key])
    else:
        raise ThriftError(f"unsupported spec {spec!r}")


def _read_value(r: _Reader, spec):
    if isinstance(spec, int):
        if spec == T_BOOL:
            return r.u8() != 0
        if spec == T_BYTE:
            return r.u8()
        if spec == T_I16:
            return r.i16()
        if spec == T_I32:
            return r.i32()
        if spec == T_I64:
            return r.i64()
        if spec == T_DOUBLE:
            return r.double()
        if spec == T_STRING:
            return r.binary()
        raise ThriftError(f"unsupported ttype {spec}")
    kind = spec[0]
    if kind == "struct":
        return read_struct(r, spec[1])
    if kind in ("list", "set"):
        espec = spec[1]
        etype = r.u8()
        if etype != _ttype_of(espec):
            raise ThriftError("list element type mismatch")
        n = r.i32()
        out = [_read_value(r, espec) for _ in range(n)]
        return set(out) if kind == "set" else out
    if kind == "map":
        kspec, vspec = spec[1], spec[2]
        ktype, vtype = r.u8(), r.u8()
        if (ktype, vtype) != (_ttype_of(kspec), _ttype_of(vspec)):
            raise ThriftError("map key/value type mismatch")
        n = r.i32()
        out = {}
        for _ in range(n):
            k = _read_value(r, kspec)
            out[k] = _read_value(r, vspec)
        return out
    raise ThriftError(f"unsupported spec {spec!r}")


def _skip(r: _Reader, ttype: int) -> None:
    """Skip an unknown field (forward compatibility)."""
    if ttype == T_BOOL or ttype == T_BYTE:
        r.u8()
    elif ttype == T_I16:
        r.i16()
    elif ttype == T_I32:
        r.i32()
    elif ttype in (T_I64, T_DOUBLE):
        r.i64()
    elif ttype == T_STRING:
        r.binary()
    elif ttype == T_STRUCT:
        while True:
            ft = r.u8()
            if ft == T_STOP:
                return
            r.i16()
            _skip(r, ft)
    elif ttype in (T_LIST, T_SET):
        et = r.u8()
        for _ in range(r.i32()):
            _skip(r, et)
    elif ttype == T_MAP:
        kt, vt = r.u8(), r.u8()
        for _ in range(r.i32()):
            _skip(r, kt)
            _skip(r, vt)
    else:
        raise ThriftError(f"cannot skip ttype {ttype}")


def write_struct(w: _Writer, spec: StructSpec, obj) -> None:
    for f in spec.fields:
        v = obj.get(f.name) if isinstance(obj, dict) else getattr(obj, f.name)
        if v is None:
            # mirror the decode side: a declared default fills an omitted
            # non-optional field (decoded-domain value, so before enc)
            v = f.default
        if v is not None and f.enc is not None:
            v = f.enc(v)
        if v is None:
            if f.optional:
                continue
            raise ThriftError(f"{spec.name}.{f.name} is required")
        w.u8(_ttype_of(f.spec))
        w.i16(f.fid)
        _write_value(w, f.spec, v)
    w.u8(T_STOP)


def read_struct(r: _Reader, spec: StructSpec):
    values: dict[str, Any] = {}
    while True:
        ttype = r.u8()
        if ttype == T_STOP:
            break
        fid = r.i16()
        f = spec.field_by_id(fid)
        if f is None or _ttype_of(f.spec) != ttype:
            _skip(r, ttype)
            continue
        v = _read_value(r, f.spec)
        if f.dec is not None:
            v = f.dec(v)
        values[f.name] = v
    for f in spec.fields:
        if f.name not in values and f.default is not None:
            d = f.default
            # copy container defaults: the Field objects are shared module
            # constants, and consumers mutate decoded structs in place
            # (e.g. pub.expired_keys.append) — aliasing the spec's default
            # would poison every later decode
            if isinstance(d, (list, set, dict)):
                d = type(d)(d)
            values[f.name] = d
    if spec.cls is None:
        return values
    return spec.cls(**values)


def encode_struct(spec: StructSpec, obj) -> bytes:
    w = _Writer()
    write_struct(w, spec, obj)
    return w.getvalue()


def decode_struct(spec: StructSpec, data: bytes):
    return read_struct(_Reader(data), spec)


# ---------------------------------------------------------------------------
# struct specs for the KvStore-facing types (field ids from the
# reference IDL, cited per struct)
# ---------------------------------------------------------------------------


def _ip_to_binary_addr(ip: Optional[str]) -> Optional[dict]:
    if not ip:
        return None
    return {"addr": ipaddress.ip_address(ip).packed, "if_name": None}


def _binary_addr_to_ip(v) -> str:
    addr = v["addr"] if isinstance(v, dict) else v.addr
    return str(ipaddress.ip_address(addr)) if addr else ""


# openr/if/Network.thrift:56 BinaryAddress {1: binary addr,
# 3: optional string ifName} — decoded to a plain dict
BINARY_ADDRESS = StructSpec(
    "BinaryAddress",
    None,
    (
        Field(1, "addr", T_STRING),
        Field(3, "if_name", T_STRING, optional=True, dec=lambda b: b.decode()),
    ),
)

# openr/if/Types.thrift:555 Value — NOTE the IDL's field-id order
# (1: version, 3: originatorId, 2: optional value, 4: ttl,
# 5: ttlVersion, 6: optional hash); our ttl_ms == thrift `ttl`
VALUE = StructSpec(
    "Value",
    T.Value,
    (
        Field(1, "version", T_I64),
        Field(3, "originator_id", T_STRING, dec=lambda b: b.decode()),
        Field(2, "value", T_STRING, optional=True),
        Field(4, "ttl_ms", T_I64),
        Field(5, "ttl_version", T_I64, default=0),
        Field(6, "hash", T_I64, optional=True),
    ),
)

# openr/if/Types.thrift:897 Publication
PUBLICATION = StructSpec(
    "Publication",
    T.Publication,
    (
        Field(
            2,
            "key_vals",
            ("map", T_STRING, ("struct", VALUE)),
            dec=lambda m: {k.decode(): v for k, v in m.items()},
        ),
        Field(
            3,
            "expired_keys",
            ("list", T_STRING),
            dec=lambda xs: [x.decode() for x in xs],
            default=[],
        ),
        Field(
            4,
            "node_ids",
            ("list", T_STRING),
            optional=True,
            dec=lambda xs: [x.decode() for x in xs],
        ),
        Field(
            5,
            "tobe_updated_keys",
            ("list", T_STRING),
            optional=True,
            dec=lambda xs: [x.decode() for x in xs],
        ),
        Field(6, "flood_root_id", T_STRING, optional=True, dec=lambda b: b.decode()),
        Field(7, "area", T_STRING, dec=lambda b: b.decode(), default="0"),
    ),
)

# openr/if/Types.thrift:683 KeyGetParams {1: list<string> keys}
KEY_GET_PARAMS = StructSpec(
    "KeyGetParams",
    None,
    (
        Field(
            1,
            "keys",
            ("list", T_STRING),
            dec=lambda xs: [x.decode() for x in xs],
            default=[],
        ),
    ),
)

# openr/if/Types.thrift:647 KeySetParams
KEY_SET_PARAMS = StructSpec(
    "KeySetParams",
    None,
    (
        Field(
            2,
            "key_vals",
            ("map", T_STRING, ("struct", VALUE)),
            dec=lambda m: {k.decode(): v for k, v in m.items()},
        ),
        Field(3, "solicit_response", T_BOOL, default=True),
        Field(
            5,
            "node_ids",
            ("list", T_STRING),
            optional=True,
            dec=lambda xs: [x.decode() for x in xs],
        ),
        Field(6, "flood_root_id", T_STRING, optional=True, dec=lambda b: b.decode()),
        Field(7, "timestamp_ms", T_I64, optional=True),
    ),
)

# openr/if/Types.thrift:691 KeyDumpParams
KEY_DUMP_PARAMS = StructSpec(
    "KeyDumpParams",
    None,
    (
        Field(1, "prefix", T_STRING, dec=lambda b: b.decode(), default=""),
        Field(
            3,
            "originator_ids",
            ("set", T_STRING),
            optional=True,
            dec=lambda xs: {x.decode() for x in xs},
        ),
        Field(6, "ignore_ttl", T_BOOL, default=True),
        Field(7, "do_not_publish_value", T_BOOL, default=False),
        Field(
            2,
            "key_val_hashes",
            ("map", T_STRING, ("struct", VALUE)),
            optional=True,
            dec=lambda m: {k.decode(): v for k, v in m.items()},
        ),
        Field(4, "oper", T_I32, optional=True),
        Field(
            5,
            "keys",
            ("list", T_STRING),
            optional=True,
            dec=lambda xs: [x.decode() for x in xs],
        ),
    ),
)

# openr/if/Types.thrift:753 PeerSpec {1: peerAddr, 2: cmdUrl,
# 4: ctrlPort, 5: state}
PEER_SPEC = StructSpec(
    "PeerSpec",
    None,
    (
        Field(1, "peer_addr", T_STRING, dec=lambda b: b.decode(), default=""),
        Field(2, "cmd_url", T_STRING, optional=True, dec=lambda b: b.decode()),
        Field(4, "ctrl_port", T_I32, default=0),
        Field(5, "state", T_I32, optional=True),
    ),
)

# openr/if/Types.thrift:1254 OpenrVersions {1: version,
# 2: lowestSupportedVersion} (OpenrVersion = i32)
OPENR_VERSIONS = StructSpec(
    "OpenrVersions",
    None,
    (
        Field(1, "version", T_I32, default=0),
        Field(2, "lowest_supported_version", T_I32, default=0),
    ),
)

# openr/if/Types.thrift:29 PerfEvent {1: nodeName, 2: eventDescr,
# 3: unixTs}
PERF_EVENT = StructSpec(
    "PerfEvent",
    T.PerfEvent,
    (
        Field(1, "node_name", T_STRING, dec=lambda b: b.decode()),
        Field(2, "event_name", T_STRING, dec=lambda b: b.decode()),
        Field(3, "unix_ts_ms", T_I64),
    ),
)

# openr/if/Types.thrift:47 PerfEvents {1: list<PerfEvent> events}
PERF_EVENTS = StructSpec(
    "PerfEvents",
    T.PerfEvents,
    (Field(1, "events", ("list", ("struct", PERF_EVENT)), default=[]),),
)

# openr/if/Types.thrift:74 Adjacency — our string next-hops map to
# BinaryAddress on the wire
ADJACENCY = StructSpec(
    "Adjacency",
    T.Adjacency,
    (
        Field(1, "other_node_name", T_STRING, dec=lambda b: b.decode()),
        Field(2, "if_name", T_STRING, dec=lambda b: b.decode()),
        Field(
            3,
            "next_hop_v6",
            ("struct", BINARY_ADDRESS),
            enc=_ip_to_binary_addr,
            dec=_binary_addr_to_ip,
            optional=True,
        ),
        Field(
            5,
            "next_hop_v4",
            ("struct", BINARY_ADDRESS),
            enc=_ip_to_binary_addr,
            dec=_binary_addr_to_ip,
            optional=True,
        ),
        Field(4, "metric", T_I32),
        Field(6, "adj_label", T_I32, default=0),
        Field(7, "is_overloaded", T_BOOL, default=False),
        Field(8, "rtt_us", T_I32, default=0),
        Field(9, "timestamp_s", T_I64, default=0),
        Field(10, "weight", T_I64, default=1),
        Field(11, "other_if_name", T_STRING, dec=lambda b: b.decode(), default=""),
    ),
)

# openr/if/Types.thrift:144 AdjacencyDatabase
ADJACENCY_DATABASE = StructSpec(
    "AdjacencyDatabase",
    T.AdjacencyDatabase,
    (
        Field(1, "this_node_name", T_STRING, dec=lambda b: b.decode()),
        Field(2, "is_overloaded", T_BOOL, default=False),
        Field(3, "adjacencies", ("list", ("struct", ADJACENCY)), default=[]),
        Field(4, "node_label", T_I32, default=0),
        Field(5, "perf_events", ("struct", PERF_EVENTS), optional=True),
        Field(6, "area", T_STRING, dec=lambda b: b.decode(), default="0"),
        # soft-drain increment (Types.thrift field 9); peers that predate
        # the field simply omit it and decode to 0 (undrained)
        Field(9, "node_metric_increment_val", T_I32, default=0),
    ),
)


# ---------------------------------------------------------------------------
# route structs (Network.thrift / Types.thrift RouteDatabase) — the
# Decision/Fib query surface (round-5 shim extension)
# ---------------------------------------------------------------------------


def _pack_addr(s: str) -> bytes:
    """BinaryAddress.addr is plain `binary` on the wire
    (Network.thrift:57).  Real IPs pack to 4/16 bytes; non-IP transport
    addresses (test fabrics, in-process meshes) ride as raw UTF-8."""
    if not s:
        return b""
    try:
        return ipaddress.ip_address(s).packed
    except ValueError:
        return s.encode("utf-8")


def _unpack_addr(b: bytes) -> str:
    if not b:
        return ""
    if len(b) in (4, 16):
        return str(ipaddress.ip_address(b))
    return b.decode("utf-8", errors="replace")


def _cidr_to_ip_prefix(cidr: str) -> dict:
    net = ipaddress.ip_network(cidr, strict=False)
    return {
        "prefix_address": {"addr": net.network_address.packed, "if_name": None},
        "prefix_length": net.prefixlen,
    }


def _ip_prefix_to_cidr(v) -> str:
    addr = v["prefix_address"]["addr"]
    return f"{ipaddress.ip_address(addr)}/{v['prefix_length']}"


# openr/if/Network.thrift:61 IpPrefix {1: BinaryAddress prefixAddress,
# 2: i16 prefixLength}
IP_PREFIX = StructSpec(
    "IpPrefix",
    None,
    (
        Field(1, "prefix_address", ("struct", BINARY_ADDRESS)),
        Field(2, "prefix_length", T_I16),
    ),
)

# openr/if/Network.thrift:48 MplsAction {1: MplsActionCode action,
# 2: optional swapLabel, 3: optional pushLabels (bottom of stack first)}
MPLS_ACTION = StructSpec(
    "MplsAction",
    None,
    (
        Field(1, "action", T_I32),
        Field(2, "swap_label", T_I32, optional=True),
        Field(3, "push_labels", ("list", T_I32), optional=True),
    ),
)

# openr/if/Network.thrift:66 NextHopThrift {1: BinaryAddress address,
# 2: weight, 3: optional mplsAction, 51: metric, 53: optional area,
# 54: optional neighborNodeName} — wire dict form; the repo NextHop
# carries address/if_name separately and they merge into BinaryAddress
NEXT_HOP = StructSpec(
    "NextHopThrift",
    None,
    (
        Field(1, "address", ("struct", BINARY_ADDRESS)),
        Field(2, "weight", T_I32, default=0),
        Field(3, "mpls_action", ("struct", MPLS_ACTION), optional=True),
        Field(51, "metric", T_I32, default=0),
        Field(53, "area", T_STRING, optional=True, dec=lambda b: b.decode()),
        Field(
            54,
            "neighbor_node_name",
            T_STRING,
            optional=True,
            dec=lambda b: b.decode(),
        ),
    ),
)


def _nh_to_wire(nh) -> dict:
    action = None
    if nh.mpls_action is not None:
        action = {
            "action": int(nh.mpls_action.action),
            "swap_label": nh.mpls_action.swap_label,
            "push_labels": (
                list(nh.mpls_action.push_labels)
                if nh.mpls_action.push_labels is not None
                else None
            ),
        }
    return {
        "address": {
            "addr": _pack_addr(nh.address),
            "if_name": nh.if_name,
        },
        "weight": nh.weight,
        "mpls_action": action,
        "metric": nh.metric,
        "area": nh.area,
        "neighbor_node_name": nh.neighbor_node_name,
    }


def _wire_to_nh(v):
    addr = v["address"]["addr"]
    action = None
    if v.get("mpls_action") is not None:
        a = v["mpls_action"]
        action = T.MplsAction(
            action=T.MplsActionCode(a["action"]),
            swap_label=a.get("swap_label"),
            push_labels=(
                tuple(a["push_labels"])
                if a.get("push_labels") is not None
                else None
            ),
        )
    return T.NextHop(
        address=_unpack_addr(addr),
        if_name=v["address"].get("if_name"),
        metric=v.get("metric", 0),
        weight=v.get("weight", 0),
        area=v.get("area"),
        neighbor_node_name=v.get("neighbor_node_name"),
        mpls_action=action,
    )


def _nhs_enc(nhs):
    return [_nh_to_wire(nh) for nh in nhs]


def _nhs_dec(ws):
    return [_wire_to_nh(w) for w in ws]


# openr/if/Network.thrift:122 UnicastRoute {1: IpPrefix dest,
# 4: list<NextHopThrift> nextHops}
UNICAST_ROUTE = StructSpec(
    "UnicastRoute",
    T.UnicastRoute,
    (
        Field(
            1,
            "dest",
            ("struct", IP_PREFIX),
            enc=_cidr_to_ip_prefix,
            dec=_ip_prefix_to_cidr,
        ),
        Field(
            4,
            "next_hops",
            ("list", ("struct", NEXT_HOP)),
            enc=_nhs_enc,
            dec=_nhs_dec,
            default=[],
        ),
    ),
)

# openr/if/Network.thrift:99 MplsRoute {1: i32 topLabel,
# 4: list<NextHopThrift> nextHops}
MPLS_ROUTE = StructSpec(
    "MplsRoute",
    T.MplsRoute,
    (
        Field(1, "top_label", T_I32),
        Field(
            4,
            "next_hops",
            ("list", ("struct", NEXT_HOP)),
            enc=_nhs_enc,
            dec=_nhs_dec,
            default=[],
        ),
    ),
)

# openr/if/Types.thrift:1003 RouteDatabase {1: thisNodeName,
# 3: optional perfEvents, 4: unicastRoutes, 5: mplsRoutes}
ROUTE_DATABASE = StructSpec(
    "RouteDatabase",
    T.RouteDatabase,
    (
        Field(1, "this_node_name", T_STRING, dec=lambda b: b.decode(), default=""),
        Field(3, "perf_events", ("struct", PERF_EVENTS), optional=True),
        Field(
            4,
            "unicast_routes",
            ("list", ("struct", UNICAST_ROUTE)),
            default=[],
        ),
        Field(
            5,
            "mpls_routes",
            ("list", ("struct", MPLS_ROUTE)),
            default=[],
        ),
    ),
)


# ---------------------------------------------------------------------------
# strict message envelope + framed transport
# ---------------------------------------------------------------------------


def encode_message(name: str, mtype: int, seqid: int, payload: bytes) -> bytes:
    w = _Writer()
    w.u32(_STRICT_VERSION | mtype)  # top bit set: unsigned on the wire
    w.string(name)
    w.i32(seqid)
    return w.getvalue() + payload


def decode_message(data: bytes) -> tuple[str, int, int, _Reader]:
    r = _Reader(data)
    head = r.i32() & 0xFFFFFFFF
    if head & 0xFFFF0000 != 0x80010000:
        raise ThriftError("not a strict thrift binary message")
    mtype = head & 0xFF
    name = r.string()
    seqid = r.i32()
    return name, mtype, seqid, r


def frame(message: bytes) -> bytes:
    return _s.pack("!i", len(message)) + message


def encode_application_exception(name: str, seqid: int, text: str) -> bytes:
    """TApplicationException: {1: string message, 2: i32 type}."""
    w = _Writer()
    w.u8(T_STRING)
    w.i16(1)
    w.string(text)
    w.u8(T_I32)
    w.i16(2)
    w.i32(0)  # UNKNOWN
    w.u8(T_STOP)
    return encode_message(name, MSG_EXCEPTION, seqid, w.getvalue())
