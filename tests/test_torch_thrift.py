"""The port's Thrift-binary codec and shim (`openr_tpu_torch.interop`)
against `openr_tpu.interop`.

- Codec: the golden vectors and round trips of tests/test_thrift_binary.py
  on the port, each encoding equal to the reference's bytes for equal
  values, and decoding across packages; then seeded random
  Publications, adjacency databases and route databases, byte for byte.
- Shim: a port daemon pair and a reference daemon pair, converged to
  the same routes, each with its daemon-wired shim
  (`thrift_shim_port=-1`).  Every method answers the same call with
  byte-equal frames, errors included; two things are compared apart:
  remaining TTLs (times), and counter values and families (each package
  exports its own engine's).
- The vendored generated client of tests/test_thrift_interop_client.py
  against a port shim.
- `queryPathsBatched` on a port daemon ring equals the daemon's
  QueryScheduler's own paths answer.

No tolerance: the subject is wire bytes.
"""

from __future__ import annotations

import socket
import struct as _s
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import serializer, types
        from openr_tpu_torch.interop import thrift_binary
    else:
        from openr_tpu import serializer, types
        from openr_tpu.interop import thrift_binary
    return SimpleNamespace(name=name, T=types, tb=thrift_binary, serializer=serializer)


P = {name: pkg(name) for name in ("port", "ref")}
TB = P["port"].tb


def both(make):
    """`make(p)` in both packages."""
    return {n: make(p) for n, p in P.items()}


def enc_equal(spec_name: str, make):
    """Encode `make(p)` with each package's `spec_name`: the bytes are
    equal, and each package decodes the other's bytes to its own value."""
    vals = both(make)
    data = {n: p.tb.encode_struct(getattr(p.tb, spec_name), vals[n]) for n, p in P.items()}
    assert data["port"] == data["ref"]
    for n, p in P.items():
        back = p.tb.decode_struct(getattr(p.tb, spec_name), data["ref" if n == "port" else "port"])
        assert back == vals[n], n
    return data["port"]


# -- codec -------------------------------------------------------------------------------


def test_value_golden_vector():
    want = bytes.fromhex(
        "0a0001" "0000000000000005" "0b0003" "00000002" "6e31" "0b0002" "00000002" "6162"
        "0a0004" "000000000036ee80" "0a0005" "0000000000000002" "00")
    got = enc_equal("VALUE", lambda p: p.T.Value(version=5, originator_id="n1", value=b"ab",
                                                 ttl_ms=3_600_000, ttl_version=2))
    assert got == want


def test_key_get_params_golden_and_envelope():
    want = bytes.fromhex("0f0001" "0b" "00000002" "00000001" "61" "00000002" "6262" "00")
    assert enc_equal("KEY_GET_PARAMS", lambda p: {"keys": ["a", "bb"]}) == want
    msgs = both(lambda p: p.tb.encode_message("ping", p.tb.MSG_CALL, 7, b"\x00"))
    assert msgs["port"] == msgs["ref"] == bytes.fromhex(
        "80010001" "00000004" "70696e67" "00000007" "00")
    assert TB.decode_message(msgs["port"])[:3] == ("ping", TB.MSG_CALL, 7)
    frames = both(lambda p: p.tb.frame(msgs["port"]))
    assert frames["port"] == frames["ref"]
    exc = both(lambda p: p.tb.encode_application_exception("getX", 9, "boom"))
    assert exc["port"] == exc["ref"]


def test_ip_prefix_golden():
    want = (b"\x0c\x00\x01" b"\x0c\x00\x01" b"\x0b\x00\x01\x00\x00\x00\x04\x0a\x01\x02\x00"
            b"\x00" b"\x06\x00\x02\x00\x18" b"\x00" b"\x0f\x00\x04\x0c\x00\x00\x00\x00" b"\x00")
    assert enc_equal("UNICAST_ROUTE", lambda p: p.T.UnicastRoute(dest="10.1.2.0/24")) == want


def publication(p):
    V = p.T.Value
    return p.T.Publication(
        key_vals={"adj:n1": V(2, "n1", b"payload", 300_000, 1),
                  "prefix:[n2]": V(9, "n2", None, -1, 0, hash=77)},
        expired_keys=["gone"], node_ids=["n1", "n2"], area="spine",
    )


def adjacency_db(p):
    T = p.T
    return T.AdjacencyDatabase(
        this_node_name="r1",
        adjacencies=[T.Adjacency(other_node_name="r2", if_name="eth0", metric=10,
                                 adj_label=50001, next_hop_v6="fe80::2", next_hop_v4="10.0.0.2",
                                 other_if_name="eth9", rtt_us=1200, weight=1),
                     T.Adjacency(other_node_name="r3", if_name="eth1", metric=7,
                                 is_overloaded=True, timestamp_s=99)],
        is_overloaded=True, node_label=101, area="0",
        perf_events=T.PerfEvents(events=[T.PerfEvent("r1", "ADJ_UP", 123)]),
        node_metric_increment_val=5,
    )


def route_db(p):
    T = p.T
    A = T.MplsActionCode
    return T.RouteDatabase(
        this_node_name="nodeA",
        unicast_routes=[
            T.UnicastRoute(dest="fc00:1::/64", next_hops=[
                T.NextHop(address="fe80::1", if_name="eth0", metric=20, weight=0, area="0",
                          neighbor_node_name="peer-1",
                          mpls_action=T.MplsAction(action=A.PUSH, push_labels=(100, 200))),
                T.NextHop(address="fe80::2", metric=30)]),
            T.UnicastRoute(dest="192.168.0.0/16", next_hops=[
                T.NextHop(address="10.0.0.1", metric=1)]),
            T.UnicastRoute(dest="fc00:2::/64", next_hops=[
                T.NextHop(address="fe80::rshim-1", if_name="veth0", metric=1)]),
        ],
        mpls_routes=[
            T.MplsRoute(top_label=5, next_hops=[T.NextHop(address="10.0.0.2")]),
            T.MplsRoute(top_label=1201, next_hops=[T.NextHop(
                address="fe80::9", if_name="po1", mpls_action=T.MplsAction(A.SWAP, swap_label=77))]),
            T.MplsRoute(top_label=1202, next_hops=[T.NextHop(
                address="fe80::9", if_name="po1", mpls_action=T.MplsAction(A.PHP))]),
        ],
    )


@pytest.mark.parametrize("spec,make", [
    ("PUBLICATION", publication),
    ("ADJACENCY_DATABASE", adjacency_db),
    ("ROUTE_DATABASE", route_db),
    ("PERF_EVENTS", lambda p: p.T.PerfEvents(events=[p.T.PerfEvent("a", "b", 1)])),
    ("UNICAST_ROUTE", lambda p: route_db(p).unicast_routes[0]),
    ("MPLS_ROUTE", lambda p: route_db(p).mpls_routes[1]),
], ids=["publication", "adjacency_db", "route_db", "perf_events", "unicast", "mpls"])
def test_struct_round_trips_equal(spec, make):
    enc_equal(spec, make)


@pytest.mark.parametrize("spec,value", [
    ("KEY_SET_PARAMS", {"key_vals": {"k": ("v", 1)}, "solicit_response": True,
                        "node_ids": ["me"], "flood_root_id": None, "timestamp_ms": None}),
    ("KEY_SET_PARAMS", {"key_vals": {"k": ("v", 1)}}),
    ("KEY_DUMP_PARAMS", {"prefix": "adj:", "originator_ids": {"n1", "n2"}, "ignore_ttl": False,
                         "do_not_publish_value": True, "key_val_hashes": None, "oper": None,
                         "keys": ["adj:n1"]}),
    ("KEY_DUMP_PARAMS", {"key_val_hashes": {"a": ("h", 3)}, "oper": 2}),
    ("PEER_SPEC", {"peer_addr": "fe80::1", "cmd_url": None, "ctrl_port": 2018, "state": 2}),
    ("OPENR_VERSIONS", {"version": 20, "lowest_supported_version": 20}),
], ids=["set", "set_defaults", "dump", "dump_hashes", "peer_spec", "versions"])
def test_param_structs_equal(spec, value):
    def make(p):
        out = dict(value)
        for k in ("key_vals", "key_val_hashes"):
            if out.get(k):
                out[k] = {key: p.T.Value(v, "me", b"x" if tag == "v" else None, -1, 0,
                                         hash=None if tag == "v" else 123)
                          for key, (tag, v) in out[k].items()}
        return out

    data = {n: p.tb.encode_struct(getattr(p.tb, spec), make(p)) for n, p in P.items()}
    assert data["port"] == data["ref"]
    back = {n: plain(p.tb.decode_struct(getattr(p.tb, spec), data["port"]))
            for n, p in P.items()}
    assert back["port"] == back["ref"]
    want = plain({k: v for k, v in make(P["ref"]).items() if v is not None})
    assert {k: back["port"][k] for k in want} == want


def plain(x):
    """Decoded params as plain data (Values as field tuples)."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted(x)
    if isinstance(x, list):
        return [plain(v) for v in x]
    if hasattr(x, "__dataclass_fields__"):
        return tuple(plain(getattr(x, f)) for f in x.__dataclass_fields__)
    return x


def test_unknown_fields_skipped_and_truncation_raises():
    for p in P.values():
        w = p.tb._Writer()
        w.u8(p.tb.T_I32)
        w.i16(99)
        w.i32(1234)
        body = w.getvalue() + p.tb.encode_struct(p.tb.VALUE, p.T.Value(1, "x", b"y", -1, 0))
        assert p.tb.decode_struct(p.tb.VALUE, body) == p.T.Value(1, "x", b"y", -1, 0)
    data = TB.encode_struct(TB.ROUTE_DATABASE, route_db(P["port"]))
    for cut in range(len(data)):
        errs = {}
        for n, p in P.items():
            try:
                p.tb.decode_struct(p.tb.ROUTE_DATABASE, data[:cut])
                errs[n] = None
            except Exception as exc:
                errs[n] = (type(exc).__name__, str(exc))
        assert errs["port"] == errs["ref"], cut
        assert errs["port"] is not None


def random_values(p, rng, n_keys: int):
    out = {}
    for i in range(n_keys):
        value = None if rng.random() < 0.2 else rng.bytes(int(rng.integers(0, 40)))
        out[f"k{i}:{int(rng.integers(0, 1 << 30))}"] = p.T.Value(
            version=int(rng.integers(0, 1 << 40)), originator_id=f"node-{int(rng.integers(0, 99))}",
            value=value, ttl_ms=int(rng.integers(-1, 1 << 31)),
            ttl_version=int(rng.integers(0, 9)),
            hash=None if rng.random() < 0.5 else int(rng.integers(-(1 << 62), 1 << 62)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_structs_equal(seed):
    data = {}
    for n, p in P.items():
        rng = np.random.default_rng(seed)
        T = p.T
        pub = T.Publication(key_vals=random_values(p, rng, 40),
                            expired_keys=[f"e{i}" for i in range(int(rng.integers(0, 5)))],
                            node_ids=None if rng.random() < 0.5 else ["a", "b"],
                            area=str(int(rng.integers(0, 3))))
        adjs = [T.Adjacency(other_node_name=f"n{j}", if_name=f"if{j}",
                            metric=int(rng.integers(1, 1 << 16)),
                            next_hop_v6=f"fe80::{j + 1:x}", next_hop_v4=f"10.0.{j}.1",
                            adj_label=int(rng.integers(0, 1 << 20)),
                            rtt_us=int(rng.integers(0, 1 << 20)),
                            other_if_name=f"if{j}p") for j in range(int(rng.integers(0, 12)))]
        adb = T.AdjacencyDatabase(this_node_name="me", adjacencies=adjs,
                                  node_label=int(rng.integers(0, 1 << 20)), area="0")
        A = T.MplsActionCode
        unicast = []
        for j in range(int(rng.integers(1, 30))):
            hops = []
            for k in range(int(rng.integers(1, 4))):
                act = None
                if rng.random() < 0.3:
                    act = T.MplsAction(A.PUSH, push_labels=tuple(
                        int(x) for x in rng.integers(16, 1 << 20, size=2)))
                hops.append(T.NextHop(address=f"fe80::{k + 1}", if_name=f"eth{k}",
                                      metric=int(rng.integers(0, 1 << 20)),
                                      weight=int(rng.integers(0, 5)),
                                      neighbor_node_name=f"n{k}", area="0", mpls_action=act))
            unicast.append(T.UnicastRoute(dest=f"fc00:{j:x}::/64", next_hops=hops))
        rdb = T.RouteDatabase(this_node_name="me", unicast_routes=unicast, mpls_routes=[
            T.MplsRoute(top_label=16 + j, next_hops=[T.NextHop(
                address="fe80::1", mpls_action=T.MplsAction(A.SWAP, swap_label=j))])
            for j in range(int(rng.integers(0, 10)))])
        data[n] = [p.tb.encode_struct(p.tb.PUBLICATION, pub),
                   p.tb.encode_struct(p.tb.ADJACENCY_DATABASE, adb),
                   p.tb.encode_struct(p.tb.ROUTE_DATABASE, rdb)]
    assert data["port"] == data["ref"]
    specs = ("PUBLICATION", "ADJACENCY_DATABASE", "ROUTE_DATABASE")
    for spec, blob in zip(specs, data["port"]):
        got = {n: p.serializer.dumps(p.tb.decode_struct(getattr(p.tb, spec), blob))
               for n, p in P.items()}
        assert got["port"] == got["ref"], spec


# -- the shim, port against reference ---------------------------------------------------------


def thrift_call(port: int, name: str, seqid: int, args: bytes, mtype: int = 1) -> bytes:
    """One framed strict-binary call over TCP; the reply frame's bytes."""
    msg = TB.encode_message(name, mtype, seqid, args)
    with socket.create_connection(("::1", port), timeout=30) as sock:
        sock.sendall(TB.frame(msg))
        head = b""
        while len(head) < 4:
            chunk = sock.recv(4 - len(head))
            if not chunk:
                return head
            head += chunk
        (length,) = _s.unpack("!i", head)
        data = b""
        while len(data) < length:
            data += sock.recv(length - len(data))
    return data


def args(*fields, **values) -> bytes:
    """An args struct: `fields` are (fid, name, spec)."""
    spec = TB.StructSpec("args", None, tuple(TB.Field(f, n, s) for f, n, s in fields))
    return TB.encode_struct(spec, values)


def result(frame: bytes, success_spec, dec=None):
    name, mtype, seqid, r = TB.decode_message(frame)
    assert mtype == TB.MSG_REPLY, (name, frame)
    spec = TB.StructSpec("result", None, (TB.Field(0, "success", success_spec, dec=dec),))
    return TB.read_struct(r, spec).get("success")


class Pair:
    """tests/test_thrift_binary.py's TestShimRouteExchange pair in package
    `p`: two daemons on mock fabrics, daemon 0 with its shim."""

    def __init__(self, name: str) -> None:
        from tests.test_torch_daemon import P as DP, make_config, table, wait_for

        p = DP[name]
        fabric = p.MockIoProvider()
        kv = p.InProcessTransport()
        self.daemons = []
        for node in ("rshim-0", "rshim-1"):
            cfg = make_config(p, node)
            if node == "rshim-0":
                cfg.thrift_shim_port = -1
            addr = f"fe80::{node}"
            d = p.main.OpenrDaemon(cfg, io_provider=fabric.endpoint(node),
                                   kvstore_transport=kv.bind(addr), spark_v6_addr=addr,
                                   **p.kwargs)
            kv.register(addr, d.kvstore)
            self.daemons.append(d)
        for d in self.daemons:
            d.start()
        fabric.connect("rshim-0", "veth0", "rshim-1", "veth1")
        self.daemons[0].netlink_events_queue.push(p.T.LinkEvent("veth0", 1, True))
        self.daemons[1].netlink_events_queue.push(p.T.LinkEvent("veth1", 1, True))
        self.daemons[1].prefix_manager.advertise_prefixes(
            p.T.PrefixType.LOOPBACK, [p.T.PrefixEntry(prefix="fc01::/64"),
                                      p.T.PrefixEntry(prefix="10.9.0.0/16")])
        assert wait_for(lambda: {"fc01::/64", "10.9.0.0/16"} <= set(table(self.daemons[0]))
                        and self.daemons[0].serving is not None, timeout=60)
        self.shim = self.daemons[0].thrift_shim
        self.shim.long_poll_timeout_s = 0.3
        self.port = self.shim.port

    def stop(self) -> None:
        for d in self.daemons:
            d.stop()


@pytest.fixture(scope="module")
def pairs():
    before = set(threading.enumerate())
    made = {}
    try:
        for name in P:
            made[name] = Pair(name)
        yield made
    finally:
        for pair in made.values():
            pair.stop()
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, [t.name for t in left]


STR_LIST = ("list", TB.T_STRING)
FILTER = (1, "filter", ("struct", TB.KEY_DUMP_PARAMS))
AREA2 = (2, "area", TB.T_STRING)
VALUE_MAP = ("map", TB.T_STRING, ("struct", TB.VALUE))

# (name, args bytes): every method, answered byte for byte alike
CALLS = [
    ("getMyNodeName", b"\x00"),
    ("getOpenrVersion", b"\x00"),
    ("getKvStoreKeyVals", args((1, "k", STR_LIST), k=["snoop:k1", "snoop:none"])),
    ("getKvStoreKeyValsArea", args((1, "k", STR_LIST), AREA2, k=["snoop:k1"], area="0")),
    ("getKvStoreKeyValsFiltered", args(FILTER, filter={"prefix": "nomatch:,snoop:"})),
    ("getKvStoreKeyValsFilteredArea", args(FILTER, AREA2, filter={"keys": ["snoop:"]},
                                           area="0")),
    ("getKvStoreKeyValsFiltered", args(FILTER, filter={
        "keys": ["snoop:"], "do_not_publish_value": True})),
    ("getKvStoreKeyValsFiltered", args(FILTER, filter={
        "keys": ["snoop:"], "originator_ids": {"ext"}, "oper": 2})),
    ("getKvStoreHashFiltered", args(FILTER, filter={"keys": ["snoop:"]})),
    ("getKvStoreHashFilteredArea", args(FILTER, AREA2, filter={"keys": ["snoop:k"]},
                                        area="0")),
    ("getKvStorePeers", b"\x00"),
    ("getKvStorePeersArea", args((1, "a", TB.T_STRING), a="0")),
    ("getRouteDb", b"\x00"),
    ("getRouteDbComputed", args((1, "n", TB.T_STRING), n="rshim-1")),
    ("getRouteDbComputed", args((1, "n", TB.T_STRING), n="")),
    ("getUnicastRoutes", b"\x00"),
    ("getUnicastRoutesFiltered", args((1, "p", STR_LIST), p=[
        "fc01:0:0:0::/64", "fc01::1/128", "not-a-prefix", "fc02::/64", "10.9.1.1/32"])),
    ("getMplsRoutes", b"\x00"),
    ("getMplsRoutesFiltered", args((1, "l", ("list", TB.T_I32)), l=[1, 2])),
    ("queryPathsBatched", args((1, "s", STR_LIST), AREA2, s=["rshim-0", "rshim-1", "nope"],
                               area="0")),
    ("longPollKvStoreAdj", args((1, "s", VALUE_MAP), s={})),
    ("getRegexCounters", args((1, "r", TB.T_STRING), r="(" * 50)),
    ("getRegexCounters", args((1, "r", TB.T_STRING), r="a" * 1025)),
    ("noSuchRpc", b"\x00"),
    ("queryPathsBatched", args((1, "s", STR_LIST), AREA2, s=["rshim-0"], area="no-area")),
    ("getKvStoreKeyValsArea", args((1, "k", STR_LIST), AREA2, k=["x"], area="no-area")),
    ("setKvStoreKeyVals", args((1, "p", ("struct", TB.KEY_SET_PARAMS)), AREA2,
                               p={"key_vals": {"snoop:set": TB.VALUE.cls(
                                   4, "ext", b"over-thrift", -1, 0)}}, area="0")),
    ("getKvStoreKeyVals", args((1, "k", STR_LIST), k=["snoop:set"])),
]


def seed_keys(pair, name: str) -> None:
    T = P[name].T
    kv = pair.daemons[0].kvstore
    kv.set_key_vals("0", {"snoop:k1": T.Value(1, "ext", b"a", -1, 0),
                          "snoop:k2": T.Value(3, "rshim-0", b"bb", -1, 0)})


def test_every_method_answers_as_the_reference(pairs):
    frames = {}
    for name, pair in pairs.items():
        seed_keys(pair, name)
        frames[name] = [thrift_call(pair.port, m, i + 1, a) for i, (m, a) in enumerate(CALLS)]
    for (method, _), got, want in zip(CALLS, frames["port"], frames["ref"]):
        assert got == want, (method, TB.decode_message(got)[:3], got[:200], want[:200])
    # and the answers are the expected ones, not empty
    got = dict(zip([m for m, _ in CALLS], frames["port"]))
    assert result(got["getMyNodeName"], TB.T_STRING) == b"rshim-0"
    db = result(frames["port"][12], ("struct", TB.ROUTE_DATABASE))
    assert {r.dest for r in db.unicast_routes} == {"fc01::/64", "10.9.0.0/16"}
    paths = result(frames["port"][19], ("map", TB.T_STRING, ("map", TB.T_STRING, TB.T_I64)))
    assert paths[b"rshim-0"] == {b"rshim-0": 0, b"rshim-1": 1}
    assert paths[b"nope"] == {}
    for i in (21, 22, 23, 24, 25):
        assert TB.decode_message(frames["port"][i])[1] == TB.MSG_EXCEPTION, CALLS[i][0]
    assert pairs["port"].daemons[0].kvstore.get_key_vals(
        "0", ["snoop:set"]).key_vals["snoop:set"].value == b"over-thrift"


def test_ttl_dump_answers_as_the_reference_but_its_time(pairs):
    """The peer full-sync dump hands back remaining TTLs: equal but for
    the ms left."""
    got = {}
    for name, pair in pairs.items():
        T = P[name].T
        pair.daemons[0].kvstore.set_key_vals("0", {"snoop:ttl": T.Value(1, "rshim-0", b"t",
                                                                        30000, 1)})
        frame = thrift_call(pair.port, "getKvStoreKeyValsFilteredArea", 7,
                            args(FILTER, AREA2, filter={"keys": ["snoop:ttl"]}, area="0"))
        pub = result(frame, ("struct", TB.PUBLICATION))
        ttl = pub.key_vals["snoop:ttl"].ttl_ms
        assert 0 < ttl <= 30000
        pub.key_vals["snoop:ttl"].ttl_ms = 0
        got[name] = TB.encode_struct(TB.PUBLICATION, pub)
    assert got["port"] == got["ref"]


def test_long_poll_answers_as_the_reference(pairs):
    """A stale snapshot answers true at once, a current one false after
    the poll window; the frames are the reference's."""
    got = {}
    for name, pair in pairs.items():
        kv = pair.daemons[0].kvstore
        current = kv.dump_all("0", key_prefixes=["adj:"]).key_vals
        assert current
        snap = {k: TB.VALUE.cls(v.version, v.originator_id, None, -1, 0)
                for k, v in current.items()}
        stale = {k: TB.VALUE.cls(v.version + 9, v.originator_id, None, -1, 0)
                 for k, v in current.items()}
        spec = ((1, "a", TB.T_STRING), (2, "s", VALUE_MAP))
        t0 = time.monotonic()
        frames = [thrift_call(pair.port, "longPollKvStoreAdjArea", 1, args(*spec, a="0", s=stale)),
                  thrift_call(pair.port, "longPollKvStoreAdjArea", 2, args(*spec, a="0", s=snap))]
        assert time.monotonic() - t0 >= 0.3
        assert [result(f, TB.T_BOOL) for f in frames] == [True, False]
        got[name] = frames
    assert got["port"] == got["ref"]


def test_counters_over_the_wire(pairs):
    """getCounters / getRegexCounters: each package's families, values
    listed apart; the regex narrows server side."""
    keys = {}
    for name, pair in pairs.items():
        counters = result(thrift_call(pair.port, "getCounters", 1, b"\x00"),
                          ("map", TB.T_STRING, TB.T_I64),
                          dec=lambda m: {k.decode(): v for k, v in m.items()})
        filtered = result(thrift_call(pair.port, "getRegexCounters", 2,
                                      args((1, "r", TB.T_STRING), r="^decision\\.")),
                          ("map", TB.T_STRING, TB.T_I64),
                          dec=lambda m: {k.decode(): v for k, v in m.items()})
        assert counters["decision.adj_db_update"] >= 1
        assert filtered and set(filtered) == {k for k in counters if k.startswith("decision.")}
        keys[name] = counters
    port = keys["port"]
    assert port["decision.route_rebuild_failures"] == 0
    assert "device.engine.queries" in port
    # the port's ported module families are the reference's
    for family in ("decision.", "fib.", "kvstore.", "link_monitor.", "spark.", "serving."):
        assert any(k.startswith(family) for k in port), family


def test_bad_frames_hang_up_alike(pairs):
    """A frame length out of range or a non-strict message: the shim
    closes the connection without an answer, in both packages."""
    for pair in pairs.values():
        for blob in (_s.pack("!i", 0), _s.pack("!i", (64 << 20) + 1),
                     TB.frame(b"\x00\x00\x00\x01garbage")):
            with socket.create_connection(("::1", pair.port), timeout=10) as sock:
                sock.sendall(blob)
                assert sock.recv(16) == b""
        # and the shim serves on
        assert result(thrift_call(pair.port, "getMyNodeName", 1, b"\x00"), TB.T_STRING) == \
            b"rshim-0"


def test_reply_message_type_is_refused(pairs):
    frames = {n: thrift_call(pair.port, "getMyNodeName", 3, b"\x00", mtype=TB.MSG_REPLY)
              for n, pair in pairs.items()}
    assert frames["port"] == frames["ref"]
    assert TB.decode_message(frames["port"])[1] == TB.MSG_EXCEPTION


# -- the generated client of tests/test_thrift_interop_client.py ------------------------------


def generated_client(port: int):
    from tests.test_thrift_interop_client import OpenrCtrlClient, make_client_stack

    transport, protocol = make_client_stack("vendored", "::1", port)
    transport.open()
    return transport, OpenrCtrlClient(protocol)


def test_generated_client_kvstore_roundtrip(pairs):
    from tests.test_thrift_interop_client import KeySetParams_, TApplicationException, Value_

    pair = pairs["port"]
    transport, client = generated_client(pair.port)
    try:
        client.setKvStoreKeyVals(KeySetParams_(keyVals={"interop:gen": Value_(
            version=7, originatorId="thrift-client", value=b"generated-bytes", ttl=-1)}), "0")
        pub = pair.daemons[0].kvstore.get_key_vals("0", ["interop:gen"])
        assert pub.key_vals["interop:gen"].value == b"generated-bytes"
        out = client.getKvStoreKeyVals(["interop:gen"])
        got = out.keyVals["interop:gen"]
        assert (got.version, got.originatorId, got.value, got.ttl, out.area) == (
            7, "thrift-client", b"generated-bytes", -1, "0")
        assert client.getKvStoreKeyVals(["interop:no-such-key"]).keyVals == {}
        with pytest.raises(TApplicationException):
            client.getUnsupportedThing()
    finally:
        transport.close()


def test_generated_client_routes_and_counters(pairs):
    pair = pairs["port"]
    transport, client = generated_client(pair.port)
    try:
        db = client.getRouteDb()
        assert db.thisNodeName == "rshim-0"
        routes = {r.dest.cidr(): r for r in db.unicastRoutes}
        assert set(routes) == {"fc01::/64", "10.9.0.0/16"}
        nh = routes["fc01::/64"].nextHops[0]
        assert nh.neighborNodeName == "rshim-1" and nh.address.addr == b"fe80::rshim-1"
        other = client.getRouteDbComputed("rshim-1")
        assert other.thisNodeName == "rshim-1"
        assert all(r.dest.cidr() != "fc01::/64" for r in other.unicastRoutes)
        counters = client.getCounters()
        assert all(isinstance(v, int) for v in counters.values())
        family = client.getRegexCounters(r"device\.engine\.")
        assert family and set(family) == {k for k in counters if k.startswith("device.engine.")}
    finally:
        transport.close()


# -- queryPathsBatched against the scheduler ---------------------------------------------------


def test_query_paths_batched_equals_the_scheduler():
    """On a port ring of three (metrics raised on one link), the shim's
    distances are the metrics of the daemon's QueryScheduler's own paths
    answer for each source."""
    from tests.test_torch_daemon import P as DP, Ring, table, wait_for

    from openr_tpu_torch.interop.shim import ThriftBinaryShim

    p = DP["port"]
    ring = Ring(p)
    try:
        for i in range(3):
            ring.advertise(i)
        assert wait_for(lambda: all(len(table(d)) == 2 for d in ring.daemons), timeout=60)
        ring.daemons[0].link_monitor.set_link_metric("if-0-1", 25)
        d0 = ring.daemons[0]
        assert wait_for(lambda: table(d0).get("fc00:1::/64") == ["openr-2"], timeout=60)
        shim = ThriftBinaryShim(d0.kvstore, port=0, node_name="openr-0", serving=d0.serving)
        shim.run()
        try:
            sources = ["openr-0", "openr-1", "openr-2"]
            got = result(thrift_call(shim.port, "queryPathsBatched", 1,
                                     args((1, "s", STR_LIST), AREA2, s=sources, area="0")),
                         ("map", TB.T_STRING, ("map", TB.T_STRING, TB.T_I64)))
            for src in sources:
                res = d0.serving.submit("paths", area="0", sources=(src,)).result(30)
                want = {dest.encode(): int(nr.metric) for dest, nr in res.value[src].items()}
                assert got[src.encode()] == want, src
            assert got[b"openr-0"][b"openr-1"] == 2  # around the raised link
        finally:
            shim.stop()
            shim.wait_until_stopped(5)
    finally:
        ring.stop()
