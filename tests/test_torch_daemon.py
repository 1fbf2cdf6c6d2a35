"""The port's daemon (`openr_tpu_torch.main.OpenrDaemon`, `main`) and its
breeze CLI against `openr_tpu`'s.

- Rings of three daemons on mock fabrics (oracle tests/test_system.py:
  71-233), one of each package per scenario, DUAL flooding off and on:
  both converge to the same Fib tables, reroute a cut link and divert
  around a drained node the same way, and build the same SPT.  Every
  thread a port daemon starts ends with its `stop()`.
- Two daemons over real TCP driven by breeze (oracle tests/test_system.py:
  236-320): the port's breeze against a port pair prints what the
  reference's breeze prints against a reference pair, apart from the
  lines `DIFFERENCES` lists with the reason.
- The reference's examples (tests/test_examples.py) against port
  daemons: as they are where they speak the ctrl wire, and with their
  imports pointed at the port where they share queues with the daemon.
- The parts a config asks for are built: the rtnetlink socket, a TCP
  FIB agent, the Thrift shim and the allocator's interface address sync
  start with the daemon and end with its `stop()`; no module docstring
  calls any of them unported.  `breeze fib validate` against no agent
  exits 1 as the reference's does; `main()` raises without CUDA.

Ports come from the kernel (bind to port 0); every wait polls converged
state against a deadline.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import socket
import sys
import threading
import time
import types as pytypes
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("port", "ref")
FIB_CLIENT = 786


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import config, main, types
        from openr_tpu_torch.cli import breeze
        from openr_tpu_torch.kvstore import InProcessTransport
        from openr_tpu_torch.spark import MockIoProvider

        kwargs = {"device": "cpu"}
    else:
        from openr_tpu import config, main, types
        from openr_tpu.cli import breeze
        from openr_tpu.kvstore import InProcessTransport
        from openr_tpu.spark import MockIoProvider

        kwargs = {}
    return SimpleNamespace(
        name=name, config=config, main=main, T=types, breeze=breeze,
        InProcessTransport=InProcessTransport, MockIoProvider=MockIoProvider,
        kwargs=kwargs,
    )


P = {name: pkg(name) for name in PACKAGES}


def wait_for(cond, timeout=30.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


def free_port() -> int:
    """A port the kernel just handed out (a daemon's Spark advertises its
    ctrl port before the server binds, so TCP peers need it up front)."""
    with socket.socket(socket.AF_INET6, socket.SOCK_STREAM) as sock:
        sock.bind(("::1", 0))
        return sock.getsockname()[1]


def make_config(p, name: str, ctrl_port: int = 0, flood_optimization: bool = False):
    c = p.config
    return c.OpenrConfig(
        node_name=name, areas=[c.AreaConf()], openr_ctrl_port=ctrl_port,
        spark_config=c.SparkConf(hello_time_s=0.3, fastinit_hello_time_ms=20,
                                 keepalive_time_s=0.05, hold_time_s=0.5,
                                 graceful_restart_time_s=1.0),
        decision_config=c.DecisionConf(debounce_min_ms=5, debounce_max_ms=20),
        kvstore_config=c.KvStoreConf(enable_flood_optimization=flood_optimization),
        enable_watchdog=False, node_label=0,
    ).validate()


def table(daemon) -> dict:
    """prefix -> sorted next-hop neighbors programmed at `daemon`."""
    return {
        dest: sorted(nh.neighbor_node_name for nh in route.next_hops)
        for dest, route in daemon.fib_agent.unicast.get(FIB_CLIENT, {}).items()
    }


class Ring:
    """tests/test_system.py's RingFixture in package `p`."""

    def __init__(self, p, n: int = 3, flood_optimization: bool = False):
        self.p = p
        self.spark_fabric = p.MockIoProvider()
        kv_fabric = p.InProcessTransport()
        self.daemons = []
        for i in range(n):
            name, addr = f"openr-{i}", f"fe80::openr-{i}"
            d = p.main.OpenrDaemon(
                make_config(p, name, flood_optimization=flood_optimization),
                io_provider=self.spark_fabric.endpoint(name),
                kvstore_transport=kv_fabric.bind(addr), spark_v6_addr=addr, **p.kwargs,
            )
            kv_fabric.register(addr, d.kvstore)
            self.daemons.append(d)
        # with DUAL flooding, each peered pair stays partitioned until
        # both ends have added each other: DUAL traffic then reaches a
        # store only from a known peer, in both packages (F3's race: the
        # reference floods a peer heard from before the peering outside
        # the SPT; see test_torch_kvstore.peer_pairs)
        kv_pairs = [(f"fe80::openr-{i}", f"fe80::openr-{(i + 1) % n}") for i in range(n)]
        if flood_optimization:
            for pair in kv_pairs:
                kv_fabric.set_partitioned(*pair, True)
        for d in self.daemons:
            d.start()
        for i in range(n):
            j = (i + 1) % n
            self.spark_fabric.connect(f"openr-{i}", f"if-{i}-{j}", f"openr-{j}", f"if-{j}-{i}")
        for i, d in enumerate(self.daemons):
            d.netlink_events_queue.push(p.T.LinkEvent(f"if-{i}-{(i + 1) % n}", 1, True))
            d.netlink_events_queue.push(p.T.LinkEvent(f"if-{i}-{(i - 1) % n}", 2, True))
        if flood_optimization:
            peered = wait_for(lambda: all(
                len(d.kvstore.dump_peers("0")) == min(2, n - 1) for d in self.daemons))
            for pair in kv_pairs:
                kv_fabric.set_partitioned(*pair, False)
            assert peered, [sorted(d.kvstore.dump_peers("0")) for d in self.daemons]

    def advertise(self, i: int):
        T = self.p.T
        self.daemons[i].prefix_manager.advertise_prefixes(
            T.PrefixType.LOOPBACK, [T.PrefixEntry(prefix=f"fc00:{i}::/64")])

    def tables(self):
        return [table(d) for d in self.daemons]

    def stop(self):
        for d in self.daemons:
            d.stop()


@pytest.fixture
def rings():
    """make(flood_optimization) -> {package: Ring}; stopped after the
    test, and no thread a port daemon started outlives its stop()."""
    made = []
    before = set(threading.enumerate())

    def make(flood_optimization=False):
        made.append({n: Ring(p, flood_optimization=flood_optimization) for n, p in P.items()})
        return made[-1]

    yield make
    for pair in made:
        for ring in pair.values():
            ring.stop()
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, [t.name for t in left]


def settle_both(pair, cond, timeout=30.0):
    """`cond(ring)` holds for both packages' rings; their tables."""
    for name, ring in pair.items():
        assert wait_for(lambda: cond(ring), timeout), (name, ring.tables())
    return {name: ring.tables() for name, ring in pair.items()}


@pytest.mark.parametrize("flood_optimization", [False, True], ids=["full_mesh", "spt"])
def test_ring_converges_equally(rings, flood_optimization):
    pair = rings(flood_optimization)
    for ring in pair.values():
        for i in range(3):
            ring.advertise(i)
    want = [{f"fc00:{j}::/64".replace(":0::", "::"): [f"openr-{j}"] for j in range(3) if j != i}
            for i in range(3)]
    got = settle_both(pair, lambda r: r.tables() == want)
    assert got["port"] == got["ref"] == want
    if flood_optimization:
        def spt(ring):
            infos = [d.kvstore.get_flood_topo("0") for d in ring.daemons]
            return [(t.flood_root_id, sorted(t.flood_peers),
                     t.infos["openr-0"].parent if "openr-0" in t.infos else None)
                    for t in infos]

        # converged: every store is rooted at openr-0 and hangs off it
        # directly (the one-hop path; a two-hop parent is a transient
        # DUAL passes through while the partitioned peerings heal)
        for ring in pair.values():
            assert wait_for(lambda r=ring: all(s[0] == s[2] == "openr-0" for s in spt(r))
                            and sum(len(s[1]) for s in spt(r)) == 4)
        assert spt(pair["port"]) == spt(pair["ref"])


# node 1's prefix on the converged ring, before any failure: a route
# to it alone can be a transient one over the long way round
CONVERGED_ON_1 = [{"fc00:1::/64": ["openr-1"]}, {}, {"fc00:1::/64": ["openr-1"]}]


@pytest.mark.parametrize("flood_optimization", [False, True], ids=["full_mesh", "spt"])
def test_link_failure_reroutes_equally(rings, flood_optimization):
    pair = rings(flood_optimization)
    for ring in pair.values():
        ring.advertise(1)
    settle_both(pair, lambda r: r.tables() == CONVERGED_ON_1)
    for ring in pair.values():
        ring.spark_fabric.disconnect("openr-0", "if-0-1", "openr-1", "if-1-0")
    want = [{"fc00:1::/64": ["openr-2"]}, {}, {"fc00:1::/64": ["openr-1"]}]
    got = settle_both(pair, lambda r: r.tables() == want)
    assert got["port"] == got["ref"] == want


@pytest.mark.parametrize("flood_optimization", [False, True], ids=["full_mesh", "spt"])
def test_drain_diverts_equally(rings, flood_optimization):
    """Node 2 first reaches node 1 over node 0 (its direct link raised to
    metric 10); node 0's drain diverts it to the direct link."""
    pair = rings(flood_optimization)
    for ring in pair.values():
        ring.advertise(1)
    settle_both(pair, lambda r: r.tables() == CONVERGED_ON_1)
    for ring in pair.values():
        ring.daemons[2].link_monitor.set_link_metric("if-2-1", 10)
    settle_both(pair, lambda r: table(r.daemons[2]).get("fc00:1::/64") == ["openr-0"])
    for ring in pair.values():
        ring.daemons[0].link_monitor.set_node_overload(True)
    want = [{"fc00:1::/64": ["openr-1"]}, {}, {"fc00:1::/64": ["openr-1"]}]
    got = settle_both(pair, lambda r: r.tables() == want)
    assert got["port"] == got["ref"] == want


# -- two daemons over TCP, driven by breeze -------------------------------------

SESSION = [
    (0, ["kvstore", "peers"]),
    (0, ["kvstore", "keys"]),
    (0, ["kvstore", "keyvals", "adj:tcp-1"]),
    (0, ["kvstore", "summary"]),
    (0, ["kvstore", "floodtopo"]),
    (0, ["decision", "routes"]),
    (0, ["decision", "routes", "--node", "tcp-1"]),
    (0, ["decision", "fleet-routes"]),
    (0, ["decision", "fleet-routes", "--summary"]),
    (0, ["decision", "adj"]),
    (0, ["decision", "received-routes"]),
    (0, ["decision", "path", "tcp-1"]),
    (0, ["decision", "what-if", "tcp-0/tcp-1"]),
    (0, ["decision", "what-if", "--each", "tcp-0/tcp-1", "tcp-1/tcp-0"]),
    (0, ["decision", "tilfa", "tcp-0", "-v"]),
    (0, ["fib", "routes"]),
    (0, ["fib", "mpls"]),
    (0, ["fib", "perf"]),
    (0, ["spark", "neighbors"]),
    (0, ["monitor", "counters"]),
    (0, ["monitor", "counters", "--regex", "^kvstore\\.num_"]),
    (0, ["monitor", "traces"]),
    (0, ["monitor", "histograms"]),
    (0, ["version"]),
    (0, ["config", "show"]),
    (1, ["prefixmgr", "view"]),
    (1, ["prefixmgr", "originated"]),
    (0, ["prefixmgr", "advertise", "fd00::/64"]),
    (0, ["prefixmgr", "withdraw", "fd00::/64"]),
    (0, ["prefixmgr", "withdraw-by-type", "--type", "BREEZE"]),
    (0, ["lm", "set-link-metric", "veth0", "5"]),
    (0, ["lm", "unset-link-metric", "veth0"]),
    (0, ["lm", "set-link-overload", "veth0"]),
    (0, ["lm", "unset-link-overload", "veth0"]),
    (0, ["lm", "set-node-overload"]),
    (0, ["lm", "links"]),
    (0, ["lm", "unset-node-overload"]),
]

PORT_RE = re.compile(r"\b(2[0-9]{4}|[3-6][0-9]{4}|1[0-9]{4})\b")
COUNTER_FAMILIES = ("decision.", "fib.", "kvstore.", "link_monitor.", "monitor.",
                    "prefix_manager.", "spark.", "queue.", "serving.", "te.", "obs.",
                    "snapshot.")

# lines that may differ between the two sessions, and why
DIFFERENCES = {
    "monitor counters": "counter values are event counts and timings; "
    "the reference also exports its fuzzing and schedule-exploration "
    "families and its JAX engine's (compile, bucket, Pallas "
    "and mesh) counters, the port its CUDA engine's (kernel launches, ELL "
    "sweeps, masked batches); a counter appears on its first bump, which "
    "follows the timing of events: the ported modules' counter families "
    "printed are compared",
    "monitor histograms": "latency percentiles are timings",
    "fib perf": "convergence times are wall-clock times and the number of "
    "convergences follows the debounce's batching: the event names are compared",
    "kvstore keys": "a TTL column counts down (the ms left)",
    "kvstore summary": "keyValsBytes sums the values' bytes, and an "
    "adjacency value holds its measured RTT: each package's is held to "
    "its own store's bytes",
    "kvstore keyvals": "as kvstore keys, and an adjacency's RTT is measured",
    "spark neighbors": "RTTs are measured",
    "kvstore peers": "the ctrl ports are the kernel's",
    "config show": "the ctrl ports are the kernel's",
}


def normalize(argv: list, out: str) -> list:
    """A command's output lines with the listed differences taken out."""
    cmd = " ".join(argv[:2])
    lines = out.splitlines()
    if cmd == "monitor counters":
        return sorted({line.split(".")[0] for line in lines
                       if line.startswith(COUNTER_FAMILIES)})
    if cmd == "monitor histograms":
        return [line.split()[0] for line in lines]
    if cmd == "fib perf":
        return sorted({line.split()[0] for line in lines})
    if cmd in ("kvstore keys", "spark neighbors"):
        lines = [re.sub(r"\s+-?\d+\s*$", "", line) for line in lines]
    if cmd == "kvstore keyvals":
        lines = [re.sub(r'"(ttl_ms|rtt_us)": \d+', r'"\1": <n>', line) for line in lines]
    if cmd == "kvstore summary":
        lines = [re.sub(r'"keyValsBytes": \d+', '"keyValsBytes": <n>', line) for line in lines]
    return [PORT_RE.sub("<port>", line) for line in lines]


def summary_matches_store(p, port: int, daemon) -> bool:
    """`kvstore summary`'s keyValsBytes equals the value bytes the
    daemon's store holds (read again if an RTT update lands between)."""
    def once() -> bool:
        printed = re.search(r'"keyValsBytes": (\d+)', breeze_out(p, port, ["kvstore", "summary"]))
        held = sum(len(v.value or b"") for v in daemon.kvstore.dump_all("0").key_vals.values())
        return printed is not None and int(printed.group(1)) == held

    return wait_for(once, timeout=10)


def breeze_out(p, port: int, argv: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = p.breeze.main(["-p", str(port), *argv])
    assert rc == 0, (p.name, argv, out.getvalue())
    return out.getvalue()


@pytest.fixture
def tcp_pairs():
    """Two daemons over TCP in each package."""
    pairs = {}
    try:
        for name, p in P.items():
            fabric = p.MockIoProvider()
            ports = (free_port(), free_port())
            daemons = []
            pairs[name] = (daemons, ports)
            for i, port in enumerate(ports):
                cfg = make_config(p, f"tcp-{i}", ctrl_port=port)
                cfg.enable_rib_policy = True  # the RibPolicy example needs it
                d = p.main.OpenrDaemon(cfg,
                                       io_provider=fabric.endpoint(f"tcp-{i}"),
                                       spark_v6_addr="::1", **p.kwargs)
                d.start()
                daemons.append(d)
            fabric.connect("tcp-0", "veth0", "tcp-1", "veth1")
            daemons[0].netlink_events_queue.push(p.T.LinkEvent("veth0", 1, True))
            daemons[1].netlink_events_queue.push(p.T.LinkEvent("veth1", 1, True))
            daemons[1].prefix_manager.advertise_prefixes(
                p.T.PrefixType.LOOPBACK, [p.T.PrefixEntry(prefix="fc01::/64")])
        for name, (daemons, _) in pairs.items():
            assert wait_for(lambda: all(
                {"adj:tcp-0", "adj:tcp-1", "prefix:[tcp-1]:[0]:[fc01::/64]"}
                <= set(d.kvstore.dump_all("0").key_vals) for d in daemons)
                and "fc01::/64" in table(daemons[0]), timeout=60), name
        yield pairs
    finally:
        for daemons, _ in pairs.values():
            for d in daemons:
                d.stop()


def test_breeze_session_prints_as_the_reference(tcp_pairs):
    differing = {}
    for node, argv in SESSION:
        outs = {}
        for name, (daemons, ports) in tcp_pairs.items():
            if argv[0] == "lm" and argv[1] == "links":
                assert wait_for(lambda d=daemons[0]: d.link_monitor.get_state().is_overloaded)
            outs[name] = breeze_out(P[name], ports[node], argv)
            if argv == ["kvstore", "summary"]:
                assert summary_matches_store(P[name], ports[node], daemons[node]), name
        cmd = " ".join(argv[:2])
        if outs["port"] != outs["ref"]:
            differing[cmd] = DIFFERENCES.get(cmd, "UNLISTED")
        assert normalize(argv, outs["port"]) == normalize(argv, outs["ref"]), (
            argv, outs["port"], outs["ref"])
    assert "UNLISTED" not in differing.values(), differing
    # the listed differences are real ones: these commands did differ
    assert {"monitor counters", "kvstore peers"} <= set(differing)
    # and the session checks tests/test_system.py makes hold
    out = breeze_out(P["port"], tcp_pairs["port"][1][0], ["decision", "routes"])
    assert "fc01::/64" in out


def test_breeze_against_the_other_packages_daemon(tcp_pairs):
    """The port's breeze against a reference daemon, and the reverse,
    print what each package's own breeze prints."""
    for cli, server in (("port", "ref"), ("ref", "port")):
        port = tcp_pairs[server][1][0]
        for argv in (["decision", "routes"], ["decision", "adj"], ["spark", "neighbors"],
                     ["fib", "routes"], ["version"]):
            assert breeze_out(P[cli], port, argv) == breeze_out(P[server], port, argv), argv


def test_breeze_fib_validate_refuses(tcp_pairs):
    """With no agent listening, `fib validate` refuses to pass: it exits 1
    and prints what the reference's breeze prints against its daemon."""
    agent_port = free_port()
    outs = {}
    for name, p in P.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_:
            p.breeze.main(["-p", str(tcp_pairs[name][1][0]), "fib", "validate",
                           "--agent-port", str(agent_port)])
        assert exit_.value.code == 1
        outs[name] = out.getvalue()
    assert outs["port"].startswith(f"cannot reach fib agent at [::1]:{agent_port}: ")
    assert outs["port"] == outs["ref"]


def test_breeze_unreachable(capsys):
    rc = P["port"].breeze.main(["-p", "1", "version"])
    assert rc == 1 and "cannot reach ctrl server" in capsys.readouterr().out


# -- the reference's examples against port daemons ----------------------------------


def port_example(name: str):
    """examples/<name>.py with its imports pointed at the port, as module
    `port_examples.<name>` (so a daemon's `plugin_module` finds it)."""
    full = f"port_examples.{name}"
    if full in sys.modules:
        return sys.modules[full]
    sys.modules.setdefault("port_examples", pytypes.ModuleType("port_examples"))
    with open(os.path.join(ROOT, "examples", f"{name}.py")) as f:
        source = re.sub(r"\bopenr_tpu\b", "openr_tpu_torch", f.read())
    module = pytypes.ModuleType(full)
    module.__file__ = f"<port example {name}>"
    sys.modules[full] = module
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    return module


def ref_example(name: str):
    sys.path.insert(0, ROOT)
    try:
        return __import__(f"examples.{name}", fromlist=["_"])
    finally:
        sys.path.remove(ROOT)


def test_kvstore_agents_across_a_port_ring(rings):
    agent_mod = port_example("kvstore_agent")
    ring = Ring(P["port"])
    agents = []
    try:
        for d in ring.daemons:
            agent = agent_mod.KvStoreAgent(f"agent-{d.config.node_name}", d.kvstore,
                                           d.kvstore_updates_queue.get_reader(),
                                           change_interval_s=0.1)
            agent.start()
            agents.append(agent)
        assert wait_for(lambda: all(len(a.peer_data) == 2 for a in agents)), [
            sorted(a.peer_data) for a in agents]
        keys = [k for k in ring.daemons[0].kvstore.dump_all("0").key_vals
                if k.startswith(agent_mod.AGENT_KEY_PREFIX)]
        assert len(keys) == 3
    finally:
        for agent in agents:
            agent.stop()
        ring.stop()


@pytest.mark.parametrize("flavor", ["reference", "port"])
def test_poller_and_rib_policy_examples(tcp_pairs, flavor):
    """The poller and the RibPolicy example over the ctrl wire: the
    reference's as they are, and pointed at the port."""
    load = ref_example if flavor == "reference" else port_example
    poller, policy = load("kvstore_poller"), load("set_rib_policy")
    daemons, ports = tcp_pairs["port"]
    result = poller.poll([("::1", p) for p in ports])
    tables = list(result.values())
    assert all(t is not None for t in tables), result
    assert "adj:tcp-0" in tables[0] and "adj:tcp-0" in tables[1]
    assert list(poller.poll([("::1", 1)]).values()) == [None]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = policy.main(["--port", str(ports[0]), "--prefix", "fc01::/64"])
    assert rc == 0 and "example-statement" in out.getvalue()
    assert daemons[0].decision.get_rib_policy().statements[0].name == "example-statement"


def test_route_injector_plugin_on_port_daemons():
    """plugin_module names the port-pointed route injector: its BGP prefix
    reaches the other daemon's Fib, and it sees route updates."""
    plugin = port_example("route_injector_plugin")
    p = P["port"]
    fabric = p.MockIoProvider()
    daemons = []
    try:
        for i in range(2):
            cfg = make_config(p, f"pl-{i}", ctrl_port=free_port())
            if i == 0:
                cfg.plugin_module = "port_examples.route_injector_plugin"
            d = p.main.OpenrDaemon(cfg, io_provider=fabric.endpoint(f"pl-{i}"),
                                   spark_v6_addr="::1", device="cpu")
            d.start()
            daemons.append(d)
        fabric.connect("pl-0", "p0", "pl-1", "p1")
        daemons[0].netlink_events_queue.push(p.T.LinkEvent("p0", 1, True))
        daemons[1].netlink_events_queue.push(p.T.LinkEvent("p1", 1, True))
        assert daemons[0]._plugin_handle is not None
        want = p.T.normalize_prefix(plugin.INJECTED_PREFIX)
        assert wait_for(lambda: want in table(daemons[1]), timeout=60), table(daemons[1])
        assert wait_for(lambda: daemons[0]._plugin_handle.seen_route_updates > 0)
    finally:
        for d in daemons:
            d.stop()


@pytest.mark.parametrize("module", ["examples.no_such_plugin", "json"])
def test_bad_plugin_module_fails_loudly(module):
    p = P["port"]
    cfg = make_config(p, "pl-bad")
    cfg.plugin_module = module
    d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("pl-bad"),
                           spark_v6_addr="::1", device="cpu")
    with pytest.raises(ImportError):
        d.start()
    d.stop()


# -- the parts a config asks for --------------------------------------------------------


@pytest.mark.parametrize("field,value,part", [
    ("enable_netlink", True, "rtnetlink socket"),
    ("fib_agent_port", 60100, "TCP FIB agent"),
    ("thrift_shim_port", -1, "Thrift shim"),
])
def test_unported_parts_refuse_at_construction(field, value, part):
    """Each part a config asks for is built and started with the daemon,
    serves, and ends with its `stop()` (the test keeps the name it had
    while the port refused these parts)."""
    from openr_tpu_torch.ctrl import CtrlClient
    from openr_tpu_torch.platform import FibAgentServer, TcpFibAgent

    p = P["port"]
    before = set(threading.enumerate())
    agent = None
    cfg = make_config(p, "part")
    if field == "fib_agent_port":
        agent = FibAgentServer()
        agent.start()
        value = agent.port  # the kernel's port for the parametrized 60100
    setattr(cfg, field, value)
    d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("part"), device="cpu")
    try:
        d.start()
        if field == "enable_netlink":
            assert type(d.netlink).__name__ == "NetlinkProtocolSocket"
            assert d.netlink.is_running
            with CtrlClient("::1", d.ctrl_port) as client:
                assert client.call("getCounters")["netlink.links"] >= 1
        elif field == "fib_agent_port":
            assert isinstance(d.fib_agent, TcpFibAgent) and d.fib_agent.port == value
            assert wait_for(lambda: agent.table.get_counters().get("fibagent.sync_fib", 0) >= 1)
            # Fib counts the sync once the agent's reply is back
            assert wait_for(lambda: d.fib.get_counters().get("fib.sync_fib_calls", 0) >= 1)
        else:
            from openr_tpu_torch.interop import thrift_binary as tb

            port = d.thrift_shim.port
            assert port > 0
            with socket.create_connection(("::1", port), timeout=10) as sock:
                sock.sendall(tb.frame(tb.encode_message("getMyNodeName", tb.MSG_CALL, 1,
                                                        b"\x00")))
                reply = sock.recv(4096)
            assert reply[4:] == tb.encode_message("getMyNodeName", tb.MSG_REPLY, 1,
                                                  b"\x0b\x00\x00\x00\x00\x00\x04part\x00")
    finally:
        d.stop()
        if agent is not None:
            agent.stop()
    assert d.netlink is None
    if d.thrift_shim is not None:
        assert not d.thrift_shim.is_running
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, [t.name for t in left]


def test_allocated_prefix_on_an_interface_refuses():
    """`assign_to_interface` is taken (the test keeps the name it had
    while the port refused it): the daemon allocates, and the allocator's
    address sync runs through the rtnetlink socket.  The interface does
    not exist, so the sync only reads the kernel's links."""
    p = P["port"]
    cfg = make_config(p, "assign")
    cfg.prefix_allocation_config = p.config.PrefixAllocationConf(
        seed_prefix="2001:db8::/48", allocate_prefix_len=64,
        assign_to_interface="openr-no-such-if")
    d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("assign"),
                           device="cpu")
    d.start()
    try:
        alloc = d.prefix_allocator
        assert alloc.assign_to_interface == "openr-no-such-if"
        assert wait_for(lambda: alloc.get_my_prefix() is not None)
        assert wait_for(lambda: alloc._nl is not None and not alloc._addr_worker_busy)
        assert type(alloc._nl).__module__ == "openr_tpu_torch.nl.netlink"
    finally:
        d.stop()
    assert alloc._nl is None  # stop() released the socket


def test_no_part_of_the_daemon_is_left_unported():
    """No module of the port says a part of the daemon is not ported."""
    hits = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "openr_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                text = open(path).read()
                for phrase in ("queue 1 item 3", "does not have yet"):
                    if phrase in text:
                        hits.append((os.path.relpath(path, ROOT), phrase))
    assert not hits, hits


def test_explicit_fib_agent_overrides_the_port_as_in_the_reference():
    """The reference builds a TCP agent only when none is given; so the
    port refuses only then."""
    p = P["port"]
    from openr_tpu_torch.fib import MockFibAgent

    cfg = make_config(p, "agent")
    cfg.fib_agent_port = 60100
    agent = MockFibAgent()
    d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("agent"),
                           fib_agent=agent, device="cpu")
    assert d.fib_agent is agent
    d.stop()


@pytest.fixture
def cuda_available():
    import torch

    return torch.cuda.is_available()


def test_main_needs_the_card(cuda_available, tmp_path):
    """Without CUDA `main()` raises before it reads a flag; with a card it
    goes on to the flags (which `[]` fails)."""
    p = P["port"]
    if cuda_available:
        with pytest.raises(SystemExit):
            p.main.main([])
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            p.main.main([])
        cfg = tmp_path / "c.json"
        cfg.write_text('{"node_name": "n"}')
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            p.main.main(["--config", str(cfg)])


def test_daemon_defaults_to_the_card(cuda_available):
    p = P["port"]
    cfg = make_config(p, "card")
    if cuda_available:
        d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("card"))
        assert d.decision.spf_solver.engine.device.type == "cuda"
        d.stop()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("card"))


# -- the daemon's own surfaces --------------------------------------------------------


def test_watchdog_and_monitor_in_a_daemon():
    """A daemon with its watchdog on: every module is watched, the
    watchdog's and Monitor's counters ride getCounters, a route change
    reaches Monitor's event log, and every thread ends with stop()."""
    from openr_tpu_torch.ctrl import CtrlClient

    p = P["port"]
    before = set(threading.enumerate())
    cfg = make_config(p, "wd")
    cfg.enable_watchdog = True
    cfg.watchdog_config = p.config.WatchdogConf(interval_s=1, max_memory_mb=1 << 20)
    d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("wd"), device="cpu")
    d.start()
    try:
        assert len(d.watchdog._evbs) == 9
        d.prefix_manager.advertise_prefixes(
            p.T.PrefixType.LOOPBACK, [p.T.PrefixEntry(prefix="fc09::/64")])
        with CtrlClient("::1", d.ctrl_port) as client:
            counters = client.call("getCounters")
            assert counters["watchdog.fired"] == 0
            assert "monitor.uptime_s" in counters
            assert client.call("getRunningConfig")["watchdog_config"]["interval_s"] == 1
    finally:
        d.stop()
    assert d.watchdog.fired is None
    left = [t for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, [t.name for t in left]


def test_daemon_prefix_allocation_equal():
    """Prefix allocation through the full daemon wiring elects the same
    subprefix in both packages and advertises it."""
    got = {}
    for name, p in P.items():
        cfg = make_config(p, "alloc-d0")
        cfg.prefix_allocation_config = p.config.PrefixAllocationConf(
            seed_prefix="2001:db8:60::/48", allocate_prefix_len=64)
        d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("alloc-d0"),
                               spark_v6_addr="::1", **p.kwargs)
        d.start()
        try:
            assert wait_for(lambda: d.prefix_allocator.get_my_prefix() is not None)
            prefix = d.prefix_allocator.get_my_prefix()
            assert wait_for(lambda: any(
                e.prefix == prefix
                for e in d.prefix_manager.get_prefixes(p.T.PrefixType.PREFIX_ALLOCATOR)))
            got[name] = prefix
        finally:
            d.stop()
    assert got["port"] == got["ref"]


def test_persistent_store_survives_a_daemon_restart(tmp_path):
    """The daemon's config store: a drain set through the ctrl API is
    back after a restart on the same store file, which the reference's
    daemon reads too."""
    path = str(tmp_path / "store.bin")
    p = P["port"]
    cfg = make_config(p, "persist")
    cfg.persistent_config_store_path = path
    d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("persist"),
                           device="cpu")
    d.start()
    try:
        d.link_monitor.set_node_overload(True)
    finally:
        d.stop()
    for name, q in P.items():
        cfg = make_config(q, "persist")
        cfg.persistent_config_store_path = path
        again = q.main.OpenrDaemon(cfg, io_provider=q.MockIoProvider().endpoint("persist"),
                                   **q.kwargs)
        again.start()
        try:
            assert again.link_monitor.get_state().is_overloaded, name
        finally:
            again.stop()


def test_flag_parser_and_overrides_reach_the_daemon(tmp_path):
    """`python -m openr_tpu_torch.main`'s flags over a config file give
    the daemon its name, port and drain state (main() itself needs the
    card; its parts run here)."""
    p = P["port"]
    path = tmp_path / "c.json"
    path.write_text('{"node_name": "file-node", "enable_watchdog": false}')
    args = p.main.build_flag_parser().parse_args(
        ["--config", str(path), "--node-name", "flag-node", "--openr-ctrl-port", "0",
         "--assume-drained"])
    cfg = p.config.load_config(str(path))
    p.main.apply_flag_overrides(cfg, args)
    cfg.validate()
    d = p.main.OpenrDaemon(cfg, io_provider=p.MockIoProvider().endpoint("x"), device="cpu")
    d.start()
    try:
        assert d.ctrl_server.handler.node_name == "flag-node"
        assert d.ctrl_port > 0
        assert d.link_monitor.get_state().is_overloaded
    finally:
        d.stop()
