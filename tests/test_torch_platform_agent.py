"""The port's FIB platform agent (`openr_tpu_torch.platform.fib_agent`)
against `openr_tpu.platform.fib_agent`.

- The reference's wire tests (tests/test_platform_agent.py::TestAgentWire)
  for a port client against a port server, a port client against a
  reference server and a reference client against a port server: each
  call's answer (or error) equals what a reference client gets from a
  reference server.  The tables are small: the reference's server drops
  a request line over 64 KiB (F5, ROADMAP queue 3).
- F5: a port `TcpFibAgent` syncs 3 000 two-next-hop routes (a request
  line of about 1 MB) into a port `FibAgentServer` and reads them all
  back equal; a line over the server's limit gets the wire's error
  before the server hangs up, and the client's next call reconnects.
- Two processes, as tests/test_platform_agent.py::TestTwoProcessSystem:
  a port daemon (`device="cpu"`) programs a `python -m
  openr_tpu_torch.platform.fib_agent` process; `breeze fib validate`
  passes, reports a planted difference exactly as the reference's breeze
  reports it against the same daemon and agent, and passes again after
  the agent process is killed and restarted and the daemon's Fib
  resynced it.  No agent process and no daemon thread outlives the test.
- The kernel backend (`KernelRouteTable`): the requests it builds for
  `UnicastRoute`s and `MplsRoute`s are the reference's bytes; its
  live-kernel tests (tests/test_netlink_routes.py::TestKernelRoutes and
  TestKernelAddresses) are mirrored with the reference's own gate, which
  they need: they program the kernel.

Ports come from the kernel (bind to port 0); every wait polls against a
deadline.  No tolerance: the subject is host code and wire bytes.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import uuid
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENT = 786


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import serializer, types
        from openr_tpu_torch.cli import breeze
        from openr_tpu_torch.nl import netlink as nl
        from openr_tpu_torch.platform import fib_agent
    else:
        from openr_tpu import serializer, types
        from openr_tpu.cli import breeze
        from openr_tpu.nl import netlink as nl
        from openr_tpu.platform import fib_agent
    return SimpleNamespace(name=name, T=types, serializer=serializer, breeze=breeze,
                           fa=fib_agent, nl=nl)


P = {name: pkg(name) for name in ("port", "ref")}


def free_port() -> int:
    with socket.socket(socket.AF_INET6, socket.SOCK_STREAM) as s:
        s.bind(("::1", 0))
        return s.getsockname()[1]


def wait_for(cond, timeout=30.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def route(p, dest: str, *nbrs: str):
    return p.T.UnicastRoute(
        dest=dest,
        next_hops=[p.T.NextHop(address="::1", if_name=f"if-{n}", neighbor_node_name=n)
                   for n in nbrs],
    )


# -- the wire tests: every pairing of client and server -------------------------------


def sc_unicast_roundtrip(p, c):
    c.add_unicast_routes(CLIENT, [route(p, "fc00::/64", "a")])
    c.add_unicast_routes(CLIENT, [route(p, "fc00:1::/64", "a", "b")])
    first = c.get_route_table_by_client(CLIENT)
    assert [r.dest for r in first] == ["fc00:1::/64", "fc00::/64"]
    c.delete_unicast_routes(CLIENT, ["fc00::/64", "fc00:9::/64"])
    return [first, c.get_route_table_by_client(CLIENT)]


def sc_sync_replaces_table(p, c):
    c.add_unicast_routes(CLIENT, [route(p, "fc00::/64", "a")])
    c.sync_fib(CLIENT, [route(p, "fc00:2::/64", "b"), route(p, "fc00:3::/64", "b", "c")])
    got = c.get_route_table_by_client(CLIENT)
    assert [r.dest for r in got] == ["fc00:2::/64", "fc00:3::/64"]
    return [got]


def sc_mpls_roundtrip(p, c):
    T = p.T
    routes = [
        T.MplsRoute(top_label=100, next_hops=[T.NextHop(address="::1")]),
        T.MplsRoute(top_label=101, next_hops=[T.NextHop(
            address="fe80::1", if_name="po1",
            mpls_action=T.MplsAction(T.MplsActionCode.SWAP, swap_label=7))]),
    ]
    c.add_mpls_routes(CLIENT, routes)
    first = c.get_mpls_route_table_by_client(CLIENT)
    c.delete_mpls_routes(CLIENT, [100])
    second = c.get_mpls_route_table_by_client(CLIENT)
    c.sync_mpls_fib(CLIENT, routes[:1])
    return [first, second, c.get_mpls_route_table_by_client(CLIENT)]


def sc_clients_isolated(p, c):
    c.add_unicast_routes(1, [route(p, "fc00::/64", "a")])
    return [c.get_route_table_by_client(2), c.get_route_table_by_client(1)]


def sc_alive_since_and_counters(p, c):
    alive = c.alive_since()
    assert 0 < alive <= int(time.time() * 1000)
    c.add_unicast_routes(CLIENT, [route(p, "fc00::/64", "a")])
    c.sync_fib(CLIENT, [])
    c.delete_mpls_routes(CLIENT, [5, 6])
    counters = c.get_counters()
    assert counters["fibagent.add_unicast"] == 1
    return [counters]


def sc_unknown_method_is_error(p, c):
    out = []
    for method, params in (("nope", {}), ("syncFib", {}), ("getRouteTableByClient", {})):
        with pytest.raises(RuntimeError) as err:
            c._call(method, params)
        out.append(str(err.value))
    assert "unknown method" in out[0]
    # the connection serves on after an error reply
    out.append(c.get_route_table_by_client(CLIENT))
    return out


SCENARIOS = {name[3:]: fn for name, fn in globals().items() if name.startswith("sc_")}


@contextlib.contextmanager
def agent_pair(client: str, server: str):
    srv = P[server].fa.FibAgentServer()
    srv.start()
    cli = P[client].fa.TcpFibAgent(port=srv.port)
    try:
        yield cli
    finally:
        cli.close()
        srv.stop()


def transcript(client: str, server: str, scenario: str) -> list:
    p = P[client]
    with agent_pair(client, server) as cli:
        return [r if isinstance(r, str) else p.serializer.dumps(r)
                for r in SCENARIOS[scenario](p, cli)]


@pytest.mark.parametrize("client,server", [("port", "port"), ("port", "ref"), ("ref", "port")],
                         ids=["port-port", "port-ref", "ref-port"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_agent_wire_equals_reference(scenario, client, server):
    assert transcript(client, server, scenario) == transcript("ref", "ref", scenario)


@pytest.mark.parametrize("name", ["port", "ref"])
def test_connection_failure_raises(name):
    cli = P[name].fa.TcpFibAgent(port=free_port(), timeout_s=0.5)
    with pytest.raises(OSError):
        cli.alive_since()


def test_restart_changes_alive_since():
    """A restarted table reports a later aliveSince (ms), which is what
    Fib's keepalive compares."""
    first = P["port"].fa.SimulatedRouteTable().alive_since()
    time.sleep(0.005)
    assert P["port"].fa.SimulatedRouteTable().alive_since() > first


# -- F5: long request lines -----------------------------------------------------------


def big_routes(p, n: int):
    T = p.T
    return [
        T.UnicastRoute(dest=f"fc00:{i >> 16:x}:{i & 0xFFFF:x}::/64", next_hops=[
            T.NextHop(address=f"fe80::{k + 1}", if_name=f"if-{k}", metric=10 + k,
                      neighbor_node_name=f"node-{i % 97}-{k}", area="0")
            for k in range(2)])
        for i in range(n)
    ]


def test_sync_of_3000_routes_reads_back_equal():
    """F5: a syncFib line of 3 000 routes (about 1 MB, past asyncio's
    64 KiB default) is taken whole, and every route reads back equal."""
    p = P["port"]
    routes = big_routes(p, 3000)
    line = json.dumps({"id": 1, "method": "syncFib",
                       "params": p.serializer.to_wire({"clientId": CLIENT, "routes": routes})})
    assert len(line) > 16 * (1 << 16)
    labels = [p.T.MplsRoute(top_label=16 + i, next_hops=r.next_hops)
              for i, r in enumerate(routes)]
    with agent_pair("port", "port") as cli:
        cli.sync_fib(CLIENT, routes)
        cli.sync_mpls_fib(CLIENT, labels)
        assert cli.get_route_table_by_client(CLIENT) == sorted(routes, key=lambda r: r.dest)
        assert cli.get_mpls_route_table_by_client(CLIENT) == labels
        cli.add_unicast_routes(CLIENT, big_routes(p, 3500)[3000:])
        assert len(cli.get_route_table_by_client(CLIENT)) == 3500
        assert cli.get_counters()["fibagent.sync_fib"] == 1


def test_line_over_the_limit_gets_the_wire_error(monkeypatch):
    """Past the server's line limit the client gets the protocol's error
    reply, not a reset; its next call reconnects and is served."""
    p = P["port"]
    monkeypatch.setattr(p.fa, "WIRE_LINE_LIMIT", 4096)
    with agent_pair("port", "port") as cli:
        with pytest.raises(RuntimeError, match="request line too long"):
            cli.sync_fib(CLIENT, big_routes(p, 100))
        with pytest.raises(ConnectionError):
            cli.alive_since()  # the server hung up after its error
        cli.sync_fib(CLIENT, big_routes(p, 3))
        assert len(cli.get_route_table_by_client(CLIENT)) == 3


# -- two processes: a port daemon programs a port agent process --------------------------


def start_agent(port: int) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-m", "openr_tpu_torch.platform.fib_agent", "--port", str(port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    probe = P["port"].fa.TcpFibAgent(port=port, timeout_s=0.5)

    def up() -> bool:
        try:
            probe.alive_since()
            return True
        except OSError:
            assert proc.poll() is None, proc.stdout.read()
            return False

    try:
        assert wait_for(up, timeout=30), "agent did not come up"
    finally:
        probe.close()
    return proc


def stop_agent(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.terminate()
    proc.wait(10)
    proc.stdout.close()


def validate(p, ctrl_port: int, agent_port: int):
    """`breeze fib validate` of package `p`: (exit code, output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            rc = p.breeze.main(["-p", str(ctrl_port), "fib", "validate",
                                "--agent-port", str(agent_port)])
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


@pytest.fixture
def agent_system():
    """Two port daemons on a mock fabric; daemon 0's Fib programs an agent
    process.  Stops all; no agent process or daemon thread outlives it."""
    from tests.test_torch_daemon import P as DP, make_config

    p = DP["port"]
    before = set(threading.enumerate())
    agent_port = free_port()
    procs = [start_agent(agent_port)]
    fabric = p.MockIoProvider()
    daemons = []
    ctrl_port = free_port()
    try:
        for i, port in enumerate((ctrl_port, free_port())):
            cfg = make_config(p, f"pa-{i}", ctrl_port=port)
            if i == 0:
                cfg.fib_agent_port = agent_port
            d = p.main.OpenrDaemon(cfg, io_provider=fabric.endpoint(f"pa-{i}"),
                                   spark_v6_addr="::1", device="cpu")
            d.start()
            daemons.append(d)
        fabric.connect("pa-0", "veth0", "pa-1", "veth1")
        daemons[0].netlink_events_queue.push(p.T.LinkEvent("veth0", 1, True))
        daemons[1].netlink_events_queue.push(p.T.LinkEvent("veth1", 1, True))
        yield SimpleNamespace(daemons=daemons, ctrl_port=ctrl_port, agent_port=agent_port,
                              procs=procs, p=p)
    finally:
        for d in daemons:
            d.stop()
        for proc in procs:
            stop_agent(proc)
    assert all(proc.returncode is not None for proc in procs)
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, [t.name for t in left]


def agent_table(port: int) -> dict:
    probe = P["port"].fa.TcpFibAgent(port=port, timeout_s=2)
    try:
        return {r.dest: r for r in probe.get_route_table_by_client(CLIENT)}
    except OSError:
        return {}
    finally:
        probe.close()


def test_daemon_programs_an_agent_process(agent_system):
    s = agent_system
    d0, d1 = s.daemons
    assert type(d0.fib_agent).__module__ == "openr_tpu_torch.platform.fib_agent"
    d1.prefix_manager.advertise_prefixes(
        s.p.T.PrefixType.LOOPBACK, [s.p.T.PrefixEntry(prefix="fc03::/64")])
    assert wait_for(lambda: "fc03::/64" in agent_table(s.agent_port)), \
        "route never reached the agent process"
    # the agent holds exactly what the daemon's Fib programmed
    assert wait_for(lambda: agent_table(s.agent_port) == {
        r.dest: r for r in d0.fib.get_route_db()[0]})
    rc, out = validate(P["port"], s.ctrl_port, s.agent_port)
    assert rc == 0 and out.splitlines()[-1] == "PASS", out
    assert validate(P["ref"], s.ctrl_port, s.agent_port) == (rc, out)

    # plant differences: an extra route, a changed next hop, a lost route
    T = s.p.T
    probe = P["port"].fa.TcpFibAgent(port=s.agent_port)
    try:
        probe.add_unicast_routes(CLIENT, [route(P["port"], "fd99::/64", "x")])
        nh = agent_table(s.agent_port)["fc03::/64"].next_hops[0]
        probe.add_unicast_routes(CLIENT, [T.UnicastRoute(
            dest="fc03::/64", next_hops=[T.NextHop(address=nh.address, if_name="elsewhere")])])
        d1.prefix_manager.advertise_prefixes(
            T.PrefixType.LOOPBACK, [T.PrefixEntry(prefix="fc04::/64")])
        assert wait_for(lambda: "fc04::/64" in agent_table(s.agent_port))
        probe.delete_unicast_routes(CLIENT, ["fc04::/64"])
    finally:
        probe.close()
    rc, out = validate(P["port"], s.ctrl_port, s.agent_port)
    assert rc == 1, out
    assert "FAIL [unicast] extra in agent: fd99::/64" in out
    assert "FAIL [unicast] nexthop mismatch: fc03::/64" in out
    assert "FAIL [unicast] missing from agent: fc04::/64" in out
    assert out.splitlines()[-1] == "FAIL"
    assert validate(P["ref"], s.ctrl_port, s.agent_port) == (rc, out)

    # the agent process is killed and a new one takes its port: empty
    # table, new aliveSince; the daemon's keepalive resyncs it
    s.procs[0].kill()
    s.procs[0].wait(10)
    restarts = d0.fib.get_counters().get("fib.agent_restarts", 0)
    s.procs.append(start_agent(s.agent_port))
    assert wait_for(lambda: d0.fib.get_counters().get("fib.agent_restarts", 0) > restarts)
    want = {r.dest: r for r in d0.fib.get_route_db()[0]}
    assert {"fc03::/64", "fc04::/64"} <= set(want)
    assert wait_for(lambda: agent_table(s.agent_port) == want), \
        "daemon did not resync after the agent restart"
    rc, out = validate(P["port"], s.ctrl_port, s.agent_port)
    assert rc == 0 and out.splitlines()[-1] == "PASS", out


def test_validate_unreachable_agent_exits_1(agent_system):
    s = agent_system
    for name in ("port", "ref"):
        rc, out = validate(P[name], s.ctrl_port, free_port())
        assert rc == 1 and out.startswith("cannot reach fib agent at"), out


# -- the kernel backend --------------------------------------------------------------------


class FixedLinks:
    """A netlink socket stand-in that answers link dumps and records the
    requests it is asked to send (nothing reaches the kernel)."""

    def __init__(self, p, links: dict) -> None:
        self.p = p
        self.links = links
        self.sent: list[bytes] = []
        self._seq = 0

    def get_all_links(self):
        return [self.p.nl.LinkInfo(if_index=i, if_name=n, flags=1) for n, i in self.links.items()]

    def add_route(self, info):
        self._seq += 1
        self.sent.append(self.p.nl.build_route_request(self.p.nl.RTM_NEWROUTE, self._seq, info))

    def add_mpls_route(self, info):
        self._seq += 1
        self.sent.append(
            self.p.nl.build_mpls_route_request(self.p.nl.RTM_NEWROUTE, self._seq, info))

    def del_route(self, info):
        self._seq += 1
        self.sent.append(self.p.nl.build_route_request(self.p.nl.RTM_DELROUTE, self._seq, info))


def kernel_table(p):
    table = p.fa.KernelRouteTable.__new__(p.fa.KernelRouteTable)
    table._lock = threading.Lock()
    table.nl = FixedLinks(p, {"eth0": 3, "po1": 7})
    table.table_id = 254
    table.mpls = {}
    table._mpls_kernel = None
    table.counters = {}
    table._if_index = {}
    return table


def kernel_routes(p):
    T = p.T
    A = T.MplsActionCode
    unicast = [
        T.UnicastRoute(dest="2001:db8:10::/64", next_hops=[
            T.NextHop(address="2001:db8:fe::2", if_name="eth0")]),
        T.UnicastRoute(dest="10.1.0.0/16", next_hops=[
            T.NextHop(address="10.0.0.1", if_name="eth0", weight=2),
            T.NextHop(address="10.0.0.2", if_name="po1", weight=0),
            T.NextHop(address="10.0.0.3", if_name="gone")]),
        T.UnicastRoute(dest="2001:db8:11::/64", next_hops=[
            T.NextHop(address="fe80::1", if_name="po1",
                      mpls_action=T.MplsAction(A.PUSH, push_labels=(100, 200))),
            T.NextHop(address="fe80::2", if_name="eth0",
                      mpls_action=T.MplsAction(A.SWAP, swap_label=9))]),
    ]
    mpls = [
        T.MplsRoute(top_label=100, next_hops=[T.NextHop(
            address="fe80::1", if_name="eth0", mpls_action=T.MplsAction(A.SWAP, swap_label=0))]),
        T.MplsRoute(top_label=101, next_hops=[T.NextHop(
            address="fe80::2", if_name="po1", mpls_action=T.MplsAction(A.PHP))]),
        T.MplsRoute(top_label=102, next_hops=[T.NextHop(
            address="fe80::3", if_name="po1",
            mpls_action=T.MplsAction(A.POP_AND_LOOKUP))]),
        T.MplsRoute(top_label=103, next_hops=[
            T.NextHop(address="fe80::4", if_name="eth0", weight=3,
                      mpls_action=T.MplsAction(A.PUSH, push_labels=(1, 2, 3))),
            T.NextHop(address="10.0.0.9", if_name="po1",
                      mpls_action=T.MplsAction(A.SWAP, swap_label=44))]),
    ]
    return unicast, mpls


@pytest.mark.parametrize("client_id", [786, 0])
def test_kernel_table_requests_equal(client_id):
    """The bytes `KernelRouteTable` sends for routes and label routes
    (through `_to_route_info` / `_to_mpls_route_info` and the request
    encoders) are the reference's."""
    sent = {}
    for name, p in P.items():
        table = kernel_table(p)
        unicast, mpls = kernel_routes(p)
        table.add_unicast_routes(client_id, unicast)
        table.add_mpls_routes(client_id, mpls)
        table.delete_unicast_routes(client_id, ["2001:db8:10::/64"])
        sent[name] = table.nl.sent
    assert sent["port"] == sent["ref"]
    assert len(sent["port"]) == 8


@pytest.mark.parametrize("name", ["port", "ref"])
def test_kernel_table_refuses_unknown_clients(name):
    table = kernel_table(P[name])
    with pytest.raises(ValueError, match="unknown FibService client id 5"):
        table.add_unicast_routes(5, kernel_routes(P[name])[0])


@pytest.fixture
def net_admin():
    """The reference's gate (tests/test_netlink.py:96-99), read only here:
    its probe creates and deletes a veth pair."""
    from tests.test_netlink import NET_ADMIN

    if not NET_ADMIN:
        pytest.skip("needs NET_ADMIN (veth creation)")


@pytest.fixture
def veth(net_admin):
    name = f"pk{uuid.uuid4().hex[:8]}"
    subprocess.run(["ip", "link", "add", name, "type", "veth", "peer", "name", f"{name}p"],
                   check=True)
    try:
        for dev in (name, f"{name}p"):
            subprocess.run(["ip", "link", "set", dev, "up"], check=True)
        subprocess.run(["ip", "addr", "add", "2001:db8:fe::1/64", "dev", name], check=True)
        yield name
    finally:
        subprocess.run(["ip", "link", "del", name], capture_output=True)


# the kernel routing table the port's live tests program: a sync
# withdraws every route of its client in its table, and the reference's
# kernel tests, which may run beside these, sync the main table
KERNEL_TABLE = 10014


class TestKernelRouteTable:
    """tests/test_netlink_routes.py::TestKernelRoutes and
    TestKernelAddresses on the port, in a table of their own."""

    def test_kernel_agent_add_sync_delete(self, veth):
        fa, T = P["port"].fa, P["port"].T
        agent = fa.KernelRouteTable(table_id=KERNEL_TABLE)

        def r(i):
            return T.UnicastRoute(dest=f"2001:db8:{i:x}::/64", next_hops=[
                T.NextHop(address="2001:db8:fe::2", if_name=veth)])

        try:
            agent.add_unicast_routes(CLIENT, [r(0x510), r(0x511)])
            got = agent.get_route_table_by_client(CLIENT)
            assert [x.dest for x in got] == ["2001:db8:510::/64", "2001:db8:511::/64"]
            assert got[0].next_hops[0].if_name == veth
            agent.sync_fib(CLIENT, [r(0x511), r(0x512)])
            assert [x.dest for x in agent.get_route_table_by_client(CLIENT)] == [
                "2001:db8:511::/64", "2001:db8:512::/64"]
            agent.delete_unicast_routes(CLIENT, ["2001:db8:511::/64", "2001:db8:511::/64"])
            assert [x.dest for x in agent.get_route_table_by_client(CLIENT)] == [
                "2001:db8:512::/64"]
        finally:
            agent.sync_fib(CLIENT, [])
            agent.nl.close_request_socket()

    def test_kernel_agent_over_wire_scale_1k(self, veth):
        fa, T = P["port"].fa, P["port"].T
        server = fa.FibAgentServer(table=fa.KernelRouteTable(table_id=KERNEL_TABLE))
        server.start()
        client = fa.TcpFibAgent(port=server.port)
        routes = [T.UnicastRoute(dest=f"2001:db8:6{i >> 8:x}:{i & 0xFF:x}::/80", next_hops=[
            T.NextHop(address="2001:db8:fe::2", if_name=veth)]) for i in range(1000)]
        try:
            client.sync_fib(CLIENT, routes)
            assert len(client.get_route_table_by_client(CLIENT)) == 1000
            client.sync_fib(CLIENT, [])
            assert client.get_route_table_by_client(CLIENT) == []
        finally:
            client.close()
            server.stop()

    def test_prefix_allocator_assigns_address(self, veth):
        """The port allocator's elected prefix lands on the interface and
        moves with the allocation (reference: syncIfaceAddrs)."""
        import ipaddress

        from openr_tpu_torch.allocators.prefix_allocator import PrefixAllocator

        alloc = PrefixAllocator.__new__(PrefixAllocator)
        alloc.assign_to_interface = veth
        alloc._nl = None
        alloc._addr_sync_lock = threading.Lock()
        alloc._addr_pending = None
        alloc._addr_worker_busy = False
        alloc._addr_stopped = False
        alloc.seed = ipaddress.ip_network("2001:db8:53::/48")
        alloc.node_name = "t"
        nl = P["port"].nl.NetlinkProtocolSocket()
        idx = {l.if_name: l.if_index for l in nl.get_all_links()}[veth]
        nl.add_addr(idx, "2001:db8:53:f::1/64")

        def mine():
            return [a.prefix for a in nl.get_all_addresses()
                    if a.if_index == idx and a.prefix.startswith("2001:db8:53:")]

        try:
            for prefix, expect in (("2001:db8:53:1::/64", ["2001:db8:53:1::1/64"]),
                                   ("2001:db8:53:2::/64", ["2001:db8:53:2::1/64"]),
                                   (None, [])):
                alloc._sync_iface_addr(prefix)
                assert wait_for(lambda: mine() == expect, timeout=10), mine()
        finally:
            nl.close_request_socket()
