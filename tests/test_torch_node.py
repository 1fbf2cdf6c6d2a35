"""The node's control plane of both packages, composed as the daemon
composes it, on a 3-node ring.

The reference's `RingFixture` (`tests/test_system.py`) without the
daemon: three nodes on one `MockIoProvider` and one
`InProcessTransport`, each with KvStore, Spark on the reference tests'
fast timers, LinkMonitor fed `LinkEvent`s, a `KvStoreClientInternal` on
LinkMonitor's event base, PrefixManager advertising a loopback, and
Decision → Fib → `MockFibAgent` (the port's Decision on
`device="cpu"`), wired as `openr_tpu/main.py` wires them.  The ring is
built once per package and driven through the reference's checks:
convergence, a link failure that reroutes, the link restored, and a
drain; then a ring with flood optimization on, holding the SPT that
`tests/test_system.py` asserts.  After every step each node's
programmed table is the expected one (shortest paths over the ring's
live links, drained nodes carrying no transit), and each node's Fib
table bytes and Decision route DB (`torch_parity.normalized_routes`)
are equal between the packages.

Every wait is deadline-bound polling on converged state.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

from torch_parity import normalized_routes

PACKAGES = ("port", "ref")
FIB_CLIENT = 786
N = 3


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import serializer, types
        from openr_tpu_torch.decision.decision import Decision
        from openr_tpu_torch.fib import Fib, MockFibAgent
        from openr_tpu_torch.kvstore import InProcessTransport, KvStore, KvStoreClientInternal
        from openr_tpu_torch.link_monitor import LinkMonitor
        from openr_tpu_torch.prefix_manager import PrefixManager
        from openr_tpu_torch.runtime.queue import ReplicateQueue
        from openr_tpu_torch.spark import AreaConfig, MockIoProvider, Spark, SparkConfig

        extra = {"device": "cpu"}
    else:
        from openr_tpu import serializer, types
        from openr_tpu.decision.decision import Decision
        from openr_tpu.fib import Fib, MockFibAgent
        from openr_tpu.kvstore import InProcessTransport, KvStore, KvStoreClientInternal
        from openr_tpu.link_monitor import LinkMonitor
        from openr_tpu.prefix_manager import PrefixManager
        from openr_tpu.runtime.queue import ReplicateQueue
        from openr_tpu.spark import AreaConfig, MockIoProvider, Spark, SparkConfig

        extra = {}
    return SimpleNamespace(
        types=types, serializer=serializer, Decision=Decision, Fib=Fib,
        MockFibAgent=MockFibAgent, InProcessTransport=InProcessTransport,
        KvStore=KvStore, KvStoreClientInternal=KvStoreClientInternal,
        LinkMonitor=LinkMonitor, PrefixManager=PrefixManager,
        ReplicateQueue=ReplicateQueue, AreaConfig=AreaConfig,
        MockIoProvider=MockIoProvider, Spark=Spark, SparkConfig=SparkConfig,
        extra=extra,
    )


P = {name: pkg(name) for name in PACKAGES}


def wait_for(cond, timeout=20.0, interval=0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class RingNode:
    """One node's modules and queues (openr_tpu/main.py:114-356)."""

    def __init__(self, p, name, spark_fabric, kv_fabric, flood_optimization):
        self.p, self.name = p, name
        Q = p.ReplicateQueue
        (self.kvstore_updates, self.kvstore_sync_events, self.interface_updates,
         self.neighbor_updates, self.peer_updates, self.prefix_updates,
         self.route_updates, self.static_routes, self.fib_updates,
         self.netlink_events) = self.queues = [Q() for _ in range(10)]
        addr = f"fe80::{name}"
        self.kvstore = p.KvStore(
            name, self.kvstore_updates, self.kvstore_sync_events,
            self.peer_updates.get_reader(), transport=kv_fabric.bind(addr),
            enable_flood_optimization=flood_optimization, is_flood_root=True,
        )
        kv_fabric.register(addr, self.kvstore)
        # tests/test_system.py's FAST_SPARK
        self.spark = p.Spark(
            name, self.interface_updates.get_reader(), self.neighbor_updates,
            spark_fabric.endpoint(name),
            config=p.SparkConfig(
                hello_time_s=0.3, fastinit_hello_time_s=0.02, keepalive_time_s=0.05,
                hold_time_s=0.5, graceful_restart_time_s=1.0,
            ),
            areas=[p.AreaConfig()], ctrl_port=0, v6_addr=addr,
        )
        self.link_monitor = p.LinkMonitor(
            name,
            interface_updates_queue=self.interface_updates,
            peer_updates_queue=self.peer_updates,
            prefix_updates_queue=self.prefix_updates,
            neighbor_updates=self.neighbor_updates.get_reader(),
            kvstore_sync_events=self.kvstore_sync_events.get_reader(),
            netlink_events=self.netlink_events.get_reader(),
        )
        self.decision = p.Decision(
            name, self.kvstore_updates.get_reader(), self.static_routes.get_reader(),
            self.route_updates, debounce_min_s=0.005, debounce_max_s=0.02, **p.extra,
        )
        self.agent = p.MockFibAgent()
        self.fib = p.Fib(
            name, self.route_updates.get_reader(), self.agent,
            fib_updates_queue=self.fib_updates,
        )
        self.client = self.prefix_manager = None

    def start(self):
        for module in (self.kvstore, self.spark, self.link_monitor):
            module.run()
        self.client = self.p.KvStoreClientInternal(
            self.link_monitor, self.name, self.kvstore, self.kvstore_updates.get_reader()
        )
        self.link_monitor.kvstore_client = self.client
        self.prefix_manager = self.p.PrefixManager(
            self.name, self.client, prefix_updates=self.prefix_updates.get_reader(),
            route_updates=self.route_updates.get_reader(), areas=("0",),
        )
        self.prefix_manager.run()
        self.decision.run()
        self.fib.run()

    def table(self) -> dict:
        """prefix -> sorted next-hop neighbors of the programmed table."""
        routes = self.agent.unicast.get(FIB_CLIENT, {})
        return {
            dest: sorted(nh.neighbor_node_name for nh in r.next_hops)
            for dest, r in routes.items()
        }

    def table_bytes(self) -> bytes:
        T = self.p.types
        return self.p.serializer.dumps(T.RouteDatabase(
            self.name,
            unicast_routes=sorted(self.agent.unicast.get(FIB_CLIENT, {}).values(),
                                  key=lambda r: r.dest),
            mpls_routes=sorted(self.agent.mpls.get(FIB_CLIENT, {}).values(),
                               key=lambda r: r.top_label),
        ))

    def stop(self):
        for q in self.queues:
            q.close()
        if self.client is not None:
            self.client.stop()
        modules = [self.fib, self.decision, self.prefix_manager, self.link_monitor,
                   self.spark, self.kvstore]
        for module in modules:
            if module is not None:
                module.stop()
        for module in modules:
            if module is not None:
                module.wait_until_stopped(10)


class Ring:
    """RingFixture without the daemon: ring links on the mock fabric and
    netlink link events per ring link."""

    def __init__(self, p, flood_optimization=False):
        self.p = p
        self.spark_fabric = p.MockIoProvider()
        self.kv_fabric = p.InProcessTransport()
        self.nodes = [
            RingNode(p, f"openr-{i}", self.spark_fabric, self.kv_fabric, flood_optimization)
            for i in range(N)
        ]
        self.links = {frozenset((i, (i + 1) % N)) for i in range(N)}
        self.drained: set[int] = set()
        for node in self.nodes:
            node.start()
        for i in range(N):
            j = (i + 1) % N
            self.spark_fabric.connect(f"openr-{i}", f"if-{i}-{j}", f"openr-{j}", f"if-{j}-{i}")
        for i in range(N):
            j, k = (i + 1) % N, (i - 1) % N
            push = self.nodes[i].netlink_events.push
            push(p.types.LinkEvent(f"if-{i}-{j}", 1, True))
            push(p.types.LinkEvent(f"if-{i}-{k}", 2, True))

    def set_link(self, i, j, up: bool):
        args = (f"openr-{i}", f"if-{i}-{j}", f"openr-{j}", f"if-{j}-{i}")
        if up:
            self.spark_fabric.connect(*args)
            self.links.add(frozenset((i, j)))
        else:
            self.spark_fabric.disconnect(*args)
            self.links.discard(frozenset((i, j)))

    def expected(self, i) -> dict:
        """Node i's table: each other node's loopback through the first
        hops of its shortest paths over the live links (unit metrics),
        no transit through a drained node."""
        dist = {i: 0}
        first = {i: set()}
        frontier = [i]
        while frontier:
            nxt = []
            for u in frontier:
                if u != i and u in self.drained:
                    continue
                for link in self.links:
                    if u not in link:
                        continue
                    (v,) = link - {u}
                    hops = {v} if u == i else first[u]
                    if v not in dist:
                        dist[v] = dist[u] + 1
                        first[v] = set(hops)
                        nxt.append(v)
                    elif dist[v] == dist[u] + 1:
                        first[v] |= hops
            frontier = nxt
        return {
            self.p.types.normalize_prefix(f"fc00:{j}::/64"): sorted(
                f"openr-{h}" for h in first[j]
            )
            for j in dist if j != i
        }

    def converged(self) -> bool:
        return all(n.table() == self.expected(i) for i, n in enumerate(self.nodes))

    def record(self) -> dict:
        assert wait_for(self.converged), [n.table() for n in self.nodes]
        return {
            n.name: (
                n.table_bytes(),
                normalized_routes(n.decision.run_in_event_base_thread(
                    lambda d=n.decision: d.route_db).result()),
            )
            for n in self.nodes
        }

    def stop(self):
        for node in self.nodes:
            node.stop()


def advertise(ring):
    for i, node in enumerate(ring.nodes):
        node.prefix_manager.advertise_prefixes(
            ring.p.types.PrefixType.LOOPBACK, [ring.p.types.PrefixEntry(prefix=f"fc00:{i}::/64")]
        )


def test_ring_converges_reroutes_and_drains():
    records = {}
    for name in PACKAGES:
        ring = Ring(P[name])
        try:
            advertise(ring)
            steps = {"converged": ring.record()}
            ring.set_link(0, 1, False)
            steps["link_failed"] = ring.record()
            ring.set_link(0, 1, True)
            steps["link_restored"] = ring.record()
            ring.nodes[0].link_monitor.set_node_overload(True)
            ring.drained.add(0)
            steps["drained"] = ring.record()
            records[name] = steps
        finally:
            ring.stop()
    assert records["port"] == records["ref"]


def test_ring_with_spt_flooding():
    """Every node a flood root: each root's SPT is the star of its two
    ring neighbors, openr-0 (the smallest) is the flood root and the SPT
    over 3 nodes has 2 edges, 4 directed flood slots.  The SPTs are equal
    between the packages; the port floods exactly its SPT peers, the
    reference its SPT peers and any peer whose DUAL traffic came before
    the peering (F3 in tests/test_torch_kvstore.py)."""
    names = [f"openr-{i}" for i in range(N)]
    records = {}
    for name in PACKAGES:
        ring = Ring(P[name], flood_optimization=True)
        try:
            advertise(ring)
            routes = ring.record()

            def topo():
                return [n.kvstore.get_flood_topo("0") for n in ring.nodes]

            def spt_done():
                return all(
                    t.flood_root_id == "openr-0"
                    and all(
                        info.parent == root
                        and info.children == (sorted(set(names) - {root}) if me == root else [])
                        for root, info in t.infos.items()
                    )
                    and len(t.infos) == N
                    for me, t in zip(names, topo())
                )

            assert wait_for(spt_done), topo()
            spt_peers = [["openr-1", "openr-2"], ["openr-0"], ["openr-0"]]
            flood_peers = [t.flood_peers for t in topo()]
            if name == "port":
                assert flood_peers == spt_peers
            assert all(set(want) <= set(got) for want, got in zip(spt_peers, flood_peers))
            records[name] = {
                "routes": routes,
                "spt": [
                    (t.flood_root_id, sorted(
                        (root, i.passive, i.cost, i.parent, i.children)
                        for root, i in t.infos.items()))
                    for t in topo()
                ],
            }
        finally:
            ring.stop()
    assert records["port"] == records["ref"]
