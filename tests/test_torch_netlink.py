"""The port's rtnetlink codec and socket (`openr_tpu_torch.nl.netlink`)
against `openr_tpu.nl.netlink`.

- Every request encoder (`build_*_request`) gives the reference's bytes
  for the same arguments: dumps, unicast routes with and without RTA_MULTIPATH (v4,
  v6, default, priority, a table id above 255, MPLS push encap), AF_MPLS
  routes (swap, pop, push stacks, multipath), addresses and neighbors,
  new and delete; then the same on seeded random routes.
- `parse_messages` and the link / address / route / MPLS-route /
  neighbor parsers give equal messages on the same byte strings: hand
  built kernel replies (oracles tests/test_netlink.py::TestCodec,
  tests/test_netlink_routes.py::TestRouteCodec and ::TestMplsCodec,
  whose assertions run here on both packages), multipart datagrams,
  every truncation of one, and seeded byte corruptions.
- The reference's live-kernel tests, mirrored on the port with the
  reference's own gate (`tests/test_netlink.NET_ADMIN`, read only when
  such a test runs): they create veth pairs, routes, addresses and
  neighbors, so they run only where the reference's do.

No tolerance: the subject is wire bytes.
"""

from __future__ import annotations

import dataclasses
import ipaddress
import socket
import struct
import subprocess
import time
import uuid
from types import SimpleNamespace

import numpy as np
import pytest


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch.nl import netlink as nl
        from openr_tpu_torch.runtime.queue import ReplicateQueue
        from openr_tpu_torch import types as T
    else:
        from openr_tpu.nl import netlink as nl
        from openr_tpu.runtime.queue import ReplicateQueue
        from openr_tpu import types as T
    return SimpleNamespace(name=name, nl=nl, ReplicateQueue=ReplicateQueue, T=T)


P = {name: pkg(name) for name in ("port", "ref")}
BOTH = pytest.mark.parametrize("p", list(P.values()), ids=list(P))
NL = P["port"].nl  # constants are equal in both (checked below)


def _nlmsg(msg_type: int, payload: bytes, flags: int = 0, seq: int = 1) -> bytes:
    hdr = struct.pack("=IHHII", 16 + len(payload), msg_type, flags, seq, 0)
    return hdr + payload


def _rtattr(atype: int, data: bytes) -> bytes:
    alen = 4 + len(data)
    pad = (-alen) % 4
    return struct.pack("=HH", alen, atype) + data + b"\x00" * pad


def nh(p, **kw):
    return p.nl.NextHopInfo(**kw)


def route(p, dst, nexthops=(), **kw):
    return p.nl.RouteInfo(dst=dst, nexthops=[nh(p, **n) for n in nexthops], **kw)


def mpls_route(p, label, nexthops=(), **kw):
    return p.nl.MplsRouteInfo(label=label, nexthops=[nh(p, **n) for n in nexthops], **kw)


def as_plain(obj):
    """A parsed message (or a list of them) as plain data."""
    if isinstance(obj, list):
        return [as_plain(o) for o in obj]
    return dataclasses.asdict(obj)


def parsed(p, data: bytes):
    """`parse_messages` as plain data, or the exception it raised."""
    try:
        return as_plain(list(p.nl.parse_messages(data)))
    except Exception as exc:  # compared by type and text
        return ("raised", type(exc).__name__, str(exc))


def test_constants_equal():
    names = [n for n in dir(P["ref"].nl) if n.isupper() and not n.startswith("_")]
    assert len(names) > 50
    for n in names:
        assert getattr(P["port"].nl, n) == getattr(P["ref"].nl, n), n


# -- request encoders ----------------------------------------------------------------

ROUTES = {
    "v6_single": ("2001:db8:1::/64", [dict(gateway="fe80::1", if_index=7)], dict(priority=10)),
    "v4_multipath": ("10.1.0.0/16", [dict(gateway="10.0.0.1", if_index=3, weight=2),
                                     dict(gateway="10.0.0.2", if_index=4, weight=1)], {}),
    "v6_default": ("::/0", [], {}),
    "v4_default_gw": ("0.0.0.0/0", [dict(gateway="10.0.0.1")], {}),
    "oif_only": ("2001:db8:2::/64", [dict(if_index=9)], {}),
    "big_table": ("2001:db8:3::/64", [dict(gateway="fe80::3", if_index=2)],
                  dict(table=1000, protocol=98, scope=253)),
    "push_single": ("2001:db8:9::/64", [dict(gateway="fe80::9", if_index=5,
                                             push_labels=(100, 200))], {}),
    "push_multipath": ("2001:db8:a::/64", [dict(gateway="fe80::1", if_index=5, push_labels=(77,)),
                                           dict(gateway="fe80::2", if_index=6)], {}),
    "weight_zero": ("2001:db8:b::/64", [dict(gateway="fe80::1", if_index=1, weight=0),
                                        dict(gateway="fe80::2", if_index=1, weight=7)], {}),
}

MPLS_ROUTES = {
    "swap": (100, [dict(gateway="fe80::1", if_index=7, swap_labels=(200,))]),
    "php": (101, [dict(gateway="fe80::2", if_index=3)]),
    "pop_and_lookup": (400, [dict(if_index=1)]),
    "push_stack": (102, [dict(gateway="10.0.0.1", if_index=2, swap_labels=(5, 6, 7))]),
    "multipath": (300, [dict(gateway="fe80::1", if_index=3, swap_labels=(301,)),
                        dict(gateway="fe80::2", if_index=4, weight=3)]),
    "no_nexthop": (103, []),
}


@pytest.mark.parametrize("msg_type", ["RTM_NEWROUTE", "RTM_DELROUTE"])
@pytest.mark.parametrize("case", list(ROUTES))
def test_route_request_bytes_equal(case, msg_type):
    dst, hops, kw = ROUTES[case]
    out = {
        n: p.nl.build_route_request(getattr(p.nl, msg_type), 11, route(p, dst, hops, **kw))
        for n, p in P.items()
    }
    assert out["port"] == out["ref"]
    assert parsed(P["port"], out["port"]) == parsed(P["ref"], out["ref"])


def test_route_request_explicit_flags_equal():
    out = {
        n: p.nl.build_route_request(p.nl.RTM_NEWROUTE, 3, route(p, "fc00::/64"), flags=0x5)
        for n, p in P.items()
    }
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("msg_type", ["RTM_NEWROUTE", "RTM_DELROUTE"])
@pytest.mark.parametrize("case", list(MPLS_ROUTES))
def test_mpls_route_request_bytes_equal(case, msg_type):
    label, hops = MPLS_ROUTES[case]
    out = {
        n: p.nl.build_mpls_route_request(getattr(p.nl, msg_type), 12, mpls_route(p, label, hops))
        for n, p in P.items()
    }
    assert out["port"] == out["ref"]
    assert parsed(P["port"], out["port"]) == parsed(P["ref"], out["ref"])


@pytest.mark.parametrize("prefix", ["2001:db8:51::1/64", "10.9.8.7/24", "fe80::5/128"])
@pytest.mark.parametrize("msg_type", ["RTM_NEWADDR", "RTM_DELADDR"])
def test_addr_request_bytes_equal(prefix, msg_type):
    out = {
        n: p.nl.build_addr_request(getattr(p.nl, msg_type), 5, 17, prefix) for n, p in P.items()
    }
    assert out["port"] == out["ref"]
    assert parsed(P["port"], out["port"]) == parsed(P["ref"], out["ref"])


@pytest.mark.parametrize("args", [
    ("RTM_NEWNEIGH", 3, "2001:db8::9", "02:00:00:00:00:02", 0x80),
    ("RTM_NEWNEIGH", 4, "10.0.0.9", None, 0x02),
    ("RTM_DELNEIGH", 3, "2001:db8::9", "02:00:00:00:00:02", 0x80),
], ids=["new_v6", "new_v4_no_lladdr", "del"])
def test_neigh_request_bytes_equal(args):
    msg_type, if_index, dst, lladdr, state = args
    out = {
        n: p.nl.build_neigh_request(getattr(p.nl, msg_type), 7, if_index, dst, lladdr, state)
        for n, p in P.items()
    }
    assert out["port"] == out["ref"]
    assert parsed(P["port"], out["port"]) == parsed(P["ref"], out["ref"])


@pytest.mark.parametrize("msg_type,family", [
    ("RTM_GETLINK", 0), ("RTM_GETADDR", 0), ("RTM_GETROUTE", 0), ("RTM_GETROUTE", 28),
    ("RTM_GETNEIGH", 0),
])
def test_dump_request_bytes_equal(msg_type, family):
    out = {n: p.nl.build_dump_request(getattr(p.nl, msg_type), 9, family) for n, p in P.items()}
    assert out["port"] == out["ref"]


def test_label_stacks_equal():
    for stack in ((), (100,), (100, 200), (16, 17, 1048575), (0,)):
        packed = {n: p.nl.pack_label_stack(stack) for n, p in P.items()}
        assert packed["port"] == packed["ref"]
        assert P["port"].nl.unpack_label_stack(packed["port"]) == stack


def random_route_specs(seed: int, n: int):
    """Seeded random unicast and MPLS route specs (v4 and v6, 0-4
    next hops, optional gateways, weights, push / swap label stacks)."""
    rng = np.random.default_rng(seed)

    def labels():
        return tuple(int(x) for x in rng.integers(16, 1 << 20, size=int(rng.integers(0, 4))))

    def hops(v6: bool):
        out = []
        for _ in range(int(rng.integers(0, 5))):
            gw = None
            if rng.random() < 0.8:
                gw = (f"fe80::{int(rng.integers(1, 1 << 16)):x}" if v6
                      else f"10.{int(rng.integers(0, 256))}.{int(rng.integers(0, 256))}.1")
            out.append(dict(gateway=gw, if_index=int(rng.integers(0, 64)),
                            weight=int(rng.integers(1, 9))))
        return out

    specs = []
    for _ in range(n):
        v6 = bool(rng.random() < 0.6)
        if v6:
            plen = int(rng.integers(0, 129))
            addr = int(rng.integers(0, 1 << 62)) << 66
            dst = str(ipaddress.ip_network((addr, plen), strict=False))
        else:
            plen = int(rng.integers(0, 33))
            dst = str(ipaddress.ip_network((int(rng.integers(0, 1 << 32)), plen), strict=False))
        rh = hops(v6)
        for h in rh:
            h["push_labels"] = labels()
        kw = {}
        if rng.random() < 0.3:
            kw["priority"] = int(rng.integers(0, 1 << 31))
        if rng.random() < 0.2:
            kw["table"] = int(rng.integers(1, 5000))
        mh = hops(True)
        for h in mh:
            h["swap_labels"] = labels()
        specs.append(((dst, rh, kw), (int(rng.integers(16, 1 << 20)), mh)))
    return specs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_requests_equal(seed):
    blob = {n: b"" for n in P}
    for i, ((dst, rh, kw), (label, mh)) in enumerate(random_route_specs(seed, 60)):
        for n, p in P.items():
            a = p.nl.build_route_request(p.nl.RTM_NEWROUTE, i, route(p, dst, rh, **kw))
            b = p.nl.build_mpls_route_request(p.nl.RTM_NEWROUTE, i, mpls_route(p, label, mh))
            blob[n] += a + b
        assert blob["port"] == blob["ref"], i
    # one multipart datagram of every request parses to equal messages
    assert parsed(P["port"], blob["port"]) == parsed(P["ref"], blob["ref"])
    assert len(parsed(P["port"], blob["port"])) == 120


# -- parsers ---------------------------------------------------------------------------


def kernel_replies() -> dict[str, bytes]:
    """Kernel-shaped replies: links, addresses, routes, neighbors, errors."""
    ifinfo = struct.pack("=BxHiII", socket.AF_UNSPEC, 1, 42, NL.IFF_UP, 0)
    link = _nlmsg(NL.RTM_NEWLINK, ifinfo + _rtattr(NL.IFLA_IFNAME, b"eth-test\x00"))
    dellink = _nlmsg(NL.RTM_DELLINK, struct.pack("=BxHiII", 0, 1, 43, 0, 0)
                     + _rtattr(NL.IFLA_IFNAME, b"gone\x00"))
    v6addr = _nlmsg(NL.RTM_NEWADDR, struct.pack("=BBBBi", socket.AF_INET6, 64, 0, 0, 42)
                    + _rtattr(NL.IFA_ADDRESS, socket.inet_pton(socket.AF_INET6, "fc99::1")))
    v4ptp = _nlmsg(NL.RTM_NEWADDR, struct.pack("=BBBBi", socket.AF_INET, 32, 0, 0, 42)
                   + _rtattr(NL.IFA_ADDRESS, socket.inet_aton("10.0.0.2"))
                   + _rtattr(NL.IFA_LOCAL, socket.inet_aton("10.0.0.1")))
    deladdr = _nlmsg(NL.RTM_DELADDR, struct.pack("=BBBBi", socket.AF_INET6, 64, 0, 0, 42)
                     + _rtattr(NL.IFA_ADDRESS, socket.inet_pton(socket.AF_INET6, "fc99::1")))
    badaddr = _nlmsg(NL.RTM_NEWADDR, struct.pack("=BBBBi", socket.AF_INET6, 64, 0, 0, 42)
                     + _rtattr(NL.IFA_ADDRESS, b"\x01\x02\x03"))
    noaddr = _nlmsg(NL.RTM_NEWADDR, struct.pack("=BBBBi", socket.AF_INET6, 64, 0, 0, 42))
    rtmsg = struct.pack("=BBBBBBBBI", socket.AF_INET6, 64, 0, 0, 254, 99, 0, 1, 0)
    rt = _nlmsg(NL.RTM_NEWROUTE, rtmsg
                + _rtattr(NL.RTA_DST, socket.inet_pton(socket.AF_INET6, "2001:db8:a::"))
                + _rtattr(NL.RTA_GATEWAY, socket.inet_pton(socket.AF_INET6, "2001:db8:fe::2"))
                + _rtattr(NL.RTA_OIF, struct.pack("=i", 5))
                + _rtattr(NL.RTA_TABLE, struct.pack("=I", 254))
                + _rtattr(NL.RTA_PRIORITY, struct.pack("=I", 1024)))
    dflt = _nlmsg(NL.RTM_NEWROUTE, struct.pack("=BBBBBBBBI", socket.AF_INET, 0, 0, 0,
                                               254, 3, 0, 1, 0)
                  + _rtattr(NL.RTA_GATEWAY, socket.inet_aton("10.0.0.254"))
                  + _rtattr(NL.RTA_OIF, struct.pack("=i", 2)))
    nodst = _nlmsg(NL.RTM_NEWROUTE, struct.pack("=BBBBBBBBI", socket.AF_INET, 8, 0, 0,
                                                254, 3, 0, 1, 0))
    neigh = _nlmsg(NL.RTM_NEWNEIGH, struct.pack("=BxxxiHBB", socket.AF_INET6, 3, 0x80, 0, 0)
                   + _rtattr(NL.NDA_DST, socket.inet_pton(socket.AF_INET6, "2001:db8:fe::99"))
                   + _rtattr(NL.NDA_LLADDR, bytes.fromhex("020000000001")))
    neigh_nodst = _nlmsg(NL.RTM_NEWNEIGH, struct.pack("=BxxxiHBB", socket.AF_INET6, 3, 2, 0, 0))
    error = _nlmsg(NL.NLMSG_ERROR, struct.pack("=i", -17) + b"\x00" * 16, seq=4)
    ack = _nlmsg(NL.NLMSG_ERROR, struct.pack("=i", 0) + b"\x00" * 16, seq=5)
    done = _nlmsg(NL.NLMSG_DONE, struct.pack("=i", 0), seq=6)
    noop = _nlmsg(NL.NLMSG_NOOP, b"")
    return dict(link=link, dellink=dellink, v6addr=v6addr, v4ptp=v4ptp, deladdr=deladdr,
                badaddr=badaddr, noaddr=noaddr, route=rt, default=dflt, nodst=nodst,
                neigh=neigh, neigh_nodst=neigh_nodst, error=error, ack=ack, done=done,
                noop=noop)


@pytest.mark.parametrize("case", list(kernel_replies()))
def test_kernel_reply_parses_equal(case):
    data = kernel_replies()[case]
    assert parsed(P["port"], data) == parsed(P["ref"], data)


def multipart() -> bytes:
    """One datagram of every kernel reply and every built request."""
    data = b"".join(kernel_replies().values())
    ref = P["ref"].nl
    for i, (dst, hops, kw) in enumerate(ROUTES.values()):
        data += ref.build_route_request(ref.RTM_NEWROUTE, i, route(P["ref"], dst, hops, **kw))
    for i, (label, hops) in enumerate(MPLS_ROUTES.values()):
        data += ref.build_mpls_route_request(ref.RTM_NEWROUTE, i, mpls_route(P["ref"], label, hops))
    return data


def test_multipart_parses_equal():
    data = multipart()
    got = parsed(P["port"], data)
    assert got == parsed(P["ref"], data)
    assert len(got) > 25


def test_every_truncation_parses_equal():
    data = multipart()
    for cut in range(len(data) + 1):
        assert parsed(P["port"], data[:cut]) == parsed(P["ref"], data[:cut]), cut


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_corrupted_bytes_parse_equal(seed):
    """Seeded byte flips inside the datagram: both parsers give the same
    messages, or raise the same exception."""
    rng = np.random.default_rng(seed)
    data = bytearray(multipart())
    for _ in range(200):
        bad = bytearray(data)
        for pos in rng.integers(0, len(bad), size=int(rng.integers(1, 6))):
            bad[int(pos)] = int(rng.integers(0, 256))
        assert parsed(P["port"], bytes(bad)) == parsed(P["ref"], bytes(bad))


# -- the reference's codec assertions, on both packages -------------------------------


@BOTH
def test_dump_request_shape(p):
    req = p.nl.build_dump_request(p.nl.RTM_GETLINK, seq=7)
    length, mtype, flags, seq, _pid = struct.unpack_from("=IHHII", req)
    assert (length, mtype, flags, seq) == (len(req), p.nl.RTM_GETLINK, 0x301, 7)


@BOTH
def test_parse_newlink_and_newaddr(p):
    msgs = list(p.nl.parse_messages(kernel_replies()["link"]))
    assert msgs[0].link == p.nl.LinkInfo(if_index=42, if_name="eth-test", flags=p.nl.IFF_UP)
    assert msgs[0].link.is_up
    addr = next(p.nl.parse_messages(kernel_replies()["v6addr"])).addr
    assert addr.prefix == "fc99::1/64" and addr.is_valid
    assert next(p.nl.parse_messages(kernel_replies()["v4ptp"])).addr.prefix == "10.0.0.1/32"


@BOTH
def test_truncated_garbage_is_dropped(p):
    assert list(p.nl.parse_messages(b"\x01\x02\x03")) == []
    bad = struct.pack("=IHHII", 4096, p.nl.RTM_NEWLINK, 0, 1, 0)
    assert list(p.nl.parse_messages(bad)) == []


@BOTH
def test_route_roundtrips(p):
    nl = p.nl
    back = next(nl.parse_messages(nl.build_route_request(
        nl.RTM_NEWROUTE, 1, route(p, *ROUTES["v6_single"][:2], **ROUTES["v6_single"][2])))).route
    assert (back.dst, back.protocol, back.priority) == ("2001:db8:1::/64", nl.RTPROT_OPENR, 10)
    assert [(n.gateway, n.if_index) for n in back.nexthops] == [("fe80::1", 7)]
    back = next(nl.parse_messages(nl.build_route_request(
        nl.RTM_NEWROUTE, 2, route(p, *ROUTES["v4_multipath"][:2])))).route
    assert back.family == socket.AF_INET
    assert [(n.gateway, n.if_index, n.weight) for n in back.nexthops] == [
        ("10.0.0.1", 3, 2), ("10.0.0.2", 4, 1)]
    raw = nl.build_route_request(nl.RTM_DELROUTE, 3, route(p, "10.2.0.0/16"))
    flags = struct.unpack_from("=IHHII", raw, 0)[2]
    assert not flags & 0x400 and flags & 0x04
    assert next(nl.parse_messages(nl.build_route_request(
        nl.RTM_NEWROUTE, 4, route(p, "::/0")))).route.dst == "::/0"
    back = next(nl.parse_messages(nl.build_route_request(
        nl.RTM_NEWROUTE, 5, route(p, *ROUTES["push_multipath"][:2])))).route
    assert [n.push_labels for n in back.nexthops] == [(77,), ()]


@BOTH
def test_mpls_roundtrips(p):
    nl = p.nl
    back = next(nl.parse_messages(nl.build_mpls_route_request(
        nl.RTM_NEWROUTE, 1, mpls_route(p, *MPLS_ROUTES["swap"])))).mpls_route
    assert (back.label, back.protocol) == (100, nl.RTPROT_OPENR)
    assert [(n.gateway, n.if_index, n.swap_labels) for n in back.nexthops] == [
        ("fe80::1", 7, (200,))]
    back = next(nl.parse_messages(nl.build_mpls_route_request(
        nl.RTM_NEWROUTE, 2, mpls_route(p, *MPLS_ROUTES["multipath"])))).mpls_route
    assert [(n.gateway, n.swap_labels) for n in back.nexthops] == [
        ("fe80::1", (301,)), ("fe80::2", ())]
    back = next(nl.parse_messages(nl.build_mpls_route_request(
        nl.RTM_NEWROUTE, 3, mpls_route(p, *MPLS_ROUTES["pop_and_lookup"])))).mpls_route
    assert (back.nexthops[0].gateway, back.nexthops[0].if_index,
            back.nexthops[0].swap_labels) == (None, 1, ())
    neigh = next(nl.parse_messages(nl.build_neigh_request(
        nl.RTM_NEWNEIGH, 7, 3, "2001:db8::9", "02:00:00:00:00:02"))).neigh
    assert (neigh.if_index, neigh.dst, neigh.lladdr, neigh.state) == (
        3, "2001:db8::9", "02:00:00:00:00:02", 0x80)


# -- the socket, read only --------------------------------------------------------------


def stable_reads(read, attempts: int = 20):
    """`read()` twice in a row with equal results (tests that run beside
    this one may add and remove interfaces)."""
    for _ in range(attempts):
        first = read()
        if read() == first:
            return first
        time.sleep(0.05)
    raise AssertionError("the kernel's links kept changing")


def test_socket_dumps_links_read_only():
    """A port socket's link and address dumps equal the reference's on
    this machine (they read; nothing is changed), and the link names are
    the kernel's interface names."""

    def read():
        out = {}
        for n, p in P.items():
            sock = p.nl.NetlinkProtocolSocket()
            out[n] = (
                sorted((l.if_index, l.if_name) for l in sock.get_all_links()),
                sorted((a.if_index, a.family, a.prefix) for a in sock.get_all_addresses()),
            )
        out["names"] = sorted(name for _, name in socket.if_nameindex())
        return out

    got = stable_reads(read)
    assert got["port"] == got["ref"]
    assert sorted(name for _, name in got["port"][0]) == got["names"]
    assert "lo" in got["names"]


def test_socket_replays_links_into_the_queue():
    """`run()` replays the kernel's links (then addresses) into the
    netlink-events queue, as the reference's does; `stop()` ends it."""
    before = set(socket.if_nameindex())
    events = {}
    for n, p in P.items():
        queue = p.ReplicateQueue()
        reader = queue.get_reader()
        sock = p.nl.NetlinkProtocolSocket(queue)
        sock.run()
        try:
            want = {name for _, name in before}
            seen = {}
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not want <= set(seen):
                e = reader.get(timeout=5)
                if isinstance(e, p.T.LinkEvent):
                    seen[e.if_name] = (e.if_index, e.is_up)
            events[n] = seen
            assert sock.counters["netlink.links"] >= 1
        finally:
            queue.close()
            sock.stop()
            sock.wait_until_stopped(5)
        assert not sock.is_running
    # the links present throughout, with the kernel's indexes
    stable = before & set(socket.if_nameindex())
    for n in P:
        assert {(i, name) for name, (i, _) in events[n].items()} >= stable, n
    assert events["port"]["lo"] == events["ref"]["lo"]
    assert events["port"]["lo"][1]


# -- live kernel (the reference's gate) ------------------------------------------------


# the kernel routing table the port's live tests program (never main)
KERNEL_TABLE = 10013


@pytest.fixture
def net_admin():
    """The reference's gate (tests/test_netlink.py:96-99), read only here:
    its probe creates and deletes a veth pair."""
    from tests.test_netlink import NET_ADMIN

    if not NET_ADMIN:
        pytest.skip("needs NET_ADMIN (veth creation)")


@pytest.fixture
def veth(net_admin):
    name = f"pt{uuid.uuid4().hex[:8]}"
    subprocess.run(["ip", "link", "add", name, "type", "veth", "peer", "name", f"{name}p"],
                   check=True)
    try:
        for dev in (name, f"{name}p"):
            subprocess.run(["ip", "link", "set", dev, "up"], check=True)
        subprocess.run(["ip", "addr", "add", "2001:db8:fe::1/64", "dev", name], check=True)
        yield name
    finally:
        subprocess.run(["ip", "link", "del", name], capture_output=True)


def _drain_until(reader, pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            event = reader.get(timeout=max(0.05, deadline - time.monotonic()))
        except Exception:
            break
        if pred(event):
            return event
    return None


class TestKernelSocket:
    """tests/test_netlink.py::TestRealKernel on the port."""

    def test_link_and_addr_events(self, veth):
        from openr_tpu_torch.types import AddrEvent, LinkEvent

        p = P["port"]
        queue = p.ReplicateQueue()
        reader = queue.get_reader()
        sock = p.nl.NetlinkProtocolSocket(queue)
        sock.run()
        try:
            assert _drain_until(reader, lambda e: isinstance(e, LinkEvent) and e.if_name == "lo")
            assert _drain_until(reader, lambda e: isinstance(e, LinkEvent) and e.if_name == veth
                                and e.is_up)
            subprocess.run(["ip", "link", "set", veth, "down"], check=True)
            assert _drain_until(reader, lambda e: isinstance(e, LinkEvent) and e.if_name == veth
                                and not e.is_up)
            subprocess.run(["ip", "link", "set", veth, "up"], check=True)
            subprocess.run(["ip", "addr", "add", "fc98::1/64", "dev", veth], check=True)
            assert _drain_until(reader, lambda e: isinstance(e, AddrEvent) and e.if_name == veth
                                and e.prefix == "fc98::1/64" and e.is_valid)
            subprocess.run(["ip", "addr", "del", "fc98::1/64", "dev", veth], check=True)
            assert _drain_until(reader, lambda e: isinstance(e, AddrEvent) and e.if_name == veth
                                and e.prefix == "fc98::1/64" and not e.is_valid)
            assert veth in {l.if_name for l in sock.get_all_links()}
        finally:
            queue.close()
            sock.stop()
            sock.wait_until_stopped(5)

    def test_routes_add_read_delete(self, veth):
        """In a table of its own (KERNEL_TABLE): the reference's kernel
        tests, which may run beside these, program and sync the main one."""
        nl = P["port"].nl
        sock = nl.NetlinkProtocolSocket()
        idx = {l.if_name: l.if_index for l in sock.get_all_links()}[veth]
        r = route(P["port"], "2001:db8:5b::/64", [dict(gateway="2001:db8:fe::2", if_index=idx),
                                                  dict(gateway="2001:db8:fe::3", if_index=idx)],
                  table=KERNEL_TABLE)
        sock.add_route(r)
        try:
            back = [x for x in sock.get_routes(table=KERNEL_TABLE)
                    if x.dst == "2001:db8:5b::/64"]
            assert back[0].protocol == nl.RTPROT_OPENR
            assert sorted(n.gateway for n in back[0].nexthops) == [
                "2001:db8:fe::2", "2001:db8:fe::3"]
        finally:
            sock.del_route(nl.RouteInfo(dst="2001:db8:5b::/64", table=KERNEL_TABLE))
            sock.close_request_socket()
        assert not [x for x in sock.get_routes(table=KERNEL_TABLE) if x.dst == "2001:db8:5b::/64"]

    def test_addresses_and_neighbors(self, veth):
        nl = P["port"].nl
        sock = nl.NetlinkProtocolSocket()
        idx = {l.if_name: l.if_index for l in sock.get_all_links()}[veth]
        try:
            sock.add_addr(idx, "2001:db8:51::1/64")
            assert [a.prefix for a in sock.get_all_addresses()
                    if a.if_index == idx and a.prefix.startswith("2001:db8:51:")] == [
                "2001:db8:51::1/64"]
            sock.del_addr(idx, "2001:db8:51::1/64")
            sock.add_neighbor(idx, "2001:db8:fe::57", "02:00:00:00:00:03")
            got = [n for n in sock.get_all_neighbors()
                   if n.if_index == idx and n.dst == "2001:db8:fe::57"]
            assert len(got) == 1 and got[0].lladdr == "02:00:00:00:00:03"
            sock.del_neighbor(idx, "2001:db8:fe::57")
            assert not [n for n in sock.get_all_neighbors()
                        if n.if_index == idx and n.dst == "2001:db8:fe::57"]
        finally:
            sock.close_request_socket()

    def test_daemon_link_monitor_sees_kernel_interfaces(self, veth):
        """tests/test_netlink.py::TestDaemonWithNetlink on a port daemon."""
        from tests.test_torch_daemon import P as DP, make_config, wait_for

        from openr_tpu_torch.main import OpenrDaemon
        from openr_tpu_torch.spark import MockIoProvider

        cfg = make_config(DP["port"], "nld-0")
        cfg.enable_netlink = True
        cfg.link_monitor_config.include_interface_regexes = [f"^{veth}$"]
        daemon = OpenrDaemon(cfg, io_provider=MockIoProvider().endpoint("nld-0"),
                             spark_v6_addr="::1", device="cpu")
        daemon.start()
        try:
            assert wait_for(lambda: any(
                info.if_name == veth and info.is_up
                for info in daemon.link_monitor.get_interfaces().values()), timeout=15)
        finally:
            daemon.stop()
