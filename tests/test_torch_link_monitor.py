"""The port's LinkMonitor and PrefixManager against `openr_tpu`'s.

Each package gets the same node: a KvStore, a LinkMonitor fed netlink,
neighbor and KvStore-sync events pushed by hand (as
`tests/test_link_monitor.py` does), a `KvStoreClientInternal` on
LinkMonitor's event base, and a PrefixManager on the same client.  The
same events go into both; after each step the advertised keys (the
`adj:` key, every `prefix:` key, as `serializer.dumps` bytes of the
Value, version and originator included), the interface databases sent
to Spark, the peer events sent to KvStore and the prefix requests of
the redistribution are equal between the packages.  Adjacencies carry
the RTT the events fix, and `timestamp_s` and `perf_events` stay unset,
so the bytes are compared whole.

Threaded runs wait with deadline-bound polling and compare converged
state only.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

PACKAGES = ("port", "ref")


def pkg(name: str) -> SimpleNamespace:
    if name == "port":
        from openr_tpu_torch import serializer, types
        from openr_tpu_torch.decision import rib
        from openr_tpu_torch.kvstore import InProcessTransport, KvStore, KvStoreClientInternal
        from openr_tpu_torch.link_monitor import LinkMonitor
        from openr_tpu_torch.link_monitor import link_monitor as lm_mod
        from openr_tpu_torch.prefix_manager import OriginatedPrefixConfig, PrefixManager
        from openr_tpu_torch.runtime.queue import ReplicateQueue
    else:
        from openr_tpu import serializer, types
        from openr_tpu.decision import rib
        from openr_tpu.kvstore import InProcessTransport, KvStore, KvStoreClientInternal
        from openr_tpu.link_monitor import LinkMonitor
        from openr_tpu.link_monitor import link_monitor as lm_mod
        from openr_tpu.prefix_manager import OriginatedPrefixConfig, PrefixManager
        from openr_tpu.runtime.queue import ReplicateQueue
    return SimpleNamespace(
        name=name, T=types, ser=serializer, rib=rib, lm_mod=lm_mod,
        InProcessTransport=InProcessTransport, KvStore=KvStore,
        KvStoreClientInternal=KvStoreClientInternal, LinkMonitor=LinkMonitor,
        PrefixManager=PrefixManager, OriginatedPrefixConfig=OriginatedPrefixConfig,
        ReplicateQueue=ReplicateQueue,
    )


P = {name: pkg(name) for name in PACKAGES}


def wait_for(cond, timeout=10.0, interval=0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return False


class DictStore:
    """The config store's duck type: load / store of bytes by key."""

    def __init__(self, data=None) -> None:
        self.data = dict(data or {})

    def load(self, key):
        return self.data.get(key)

    def store(self, key, value) -> None:
        self.data[key] = value


class Node:
    """One package's node1: KvStore, LinkMonitor, client, PrefixManager
    (tests/test_link_monitor.py's Harness with PrefixManager added)."""

    def __init__(self, p, areas=("0",), lm_kwargs=None, pm_kwargs=None) -> None:
        self.p = p
        Q = p.ReplicateQueue
        self.queues = [Q() for _ in range(9)]
        (self.kv_updates, self.kv_syncs, self.peer_events, self.if_updates,
         self.nbr_events, self.sync_events, self.nl_events, self.prefix_updates,
         self.route_updates) = self.queues
        self.if_reader = self.if_updates.get_reader()
        self.peer_reader = self.peer_events.get_reader()
        self.prefix_reader = self.prefix_updates.get_reader()
        self.fabric = p.InProcessTransport()
        self.kvstore = p.KvStore(
            "node1", self.kv_updates, self.kv_syncs, self.peer_events.get_reader(),
            transport=self.fabric.bind("node1"), areas=areas,
        )
        self.fabric.register("node1", self.kvstore)
        self.kvstore.run()
        self.lm = p.LinkMonitor(
            "node1",
            interface_updates_queue=self.if_updates,
            peer_updates_queue=self.peer_events,
            prefix_updates_queue=self.prefix_updates,
            neighbor_updates=self.nbr_events.get_reader(),
            kvstore_sync_events=self.sync_events.get_reader(),
            netlink_events=self.nl_events.get_reader(),
            areas=areas,
            **(lm_kwargs or {}),
        )
        self.lm.run()
        self.client = p.KvStoreClientInternal(
            self.lm, "node1", self.kvstore, self.kv_updates.get_reader(),
            check_persist_interval_s=60,
        )
        self.lm.kvstore_client = self.client
        self.pm = p.PrefixManager(
            "node1", self.client, prefix_updates=self.prefix_updates.get_reader(),
            route_updates=self.route_updates.get_reader(), areas=areas,
            **(pm_kwargs or {}),
        )
        self.pm.run()
        self.areas = areas

    def neighbor(self, etype, node, if_name="if1", area="0", rtt_us=1000):
        T = self.p.T
        return T.NeighborEvent(
            event_type=T.NeighborEventType[etype], node_name=node, if_name=if_name,
            remote_if_name=f"{if_name}-r", area=area,
            neighbor_addr_v6=f"fe80::{node}", ctrl_port=2018, rtt_us=rtt_us,
        )

    def keys(self) -> dict:
        """Every advertised key of every area as bytes of its Value, a
        finite TTL as 1."""
        out = {}
        for area in self.areas:
            for key, val in sorted(self.kvstore.dump_all(area).key_vals.items()):
                if val.ttl_ms != -1:
                    val.ttl_ms = 1
                out[f"{area}/{key}"] = self.p.ser.dumps(val)
        return out

    def withdrawn(self, area, key) -> bool:
        """Whether `key` holds a delete_prefix tombstone."""
        raw = self.kvstore.get_key_vals(area, [key]).key_vals.get(key)
        return raw is not None and self.p.ser.loads(raw.value).delete_prefix

    def adj_db(self):
        raw = self.kvstore.get_key_vals("0", ["adj:node1"]).key_vals.get("adj:node1")
        return None if raw is None else self.p.ser.loads(raw.value)

    def take(self, reader) -> list:
        out = []
        while reader.size():
            out.append(self.p.ser.dumps(reader.get(timeout=1)))
        return out

    def stop(self):
        for q in self.queues:
            q.close()
        self.client.stop()
        for module in (self.pm, self.lm, self.kvstore):
            module.stop()
        for module in (self.pm, self.lm, self.kvstore):
            module.wait_until_stopped(5)


def in_both(scenario, **node_kwargs) -> dict:
    """`scenario(node)` on each package's node; the records must be
    equal.  A callable keyword argument is called with the package."""
    records = {}
    for name in PACKAGES:
        p = P[name]
        kwargs = {k: v(p) if callable(v) else v for k, v in node_kwargs.items()}
        node = Node(p, **kwargs)
        try:
            records[name] = scenario(node)
        finally:
            node.stop()
    assert records["port"] == records["ref"]
    return records["port"]


def adj_steps(n, *steps):
    """Run each (action, condition) pair: act, wait for the condition on
    the advertised AdjacencyDatabase, record every key's bytes."""
    out = []
    for act, cond in steps:
        act()
        assert wait_for(lambda: (db := n.adj_db()) is not None and cond(db)), n.adj_db()
        out.append(n.keys())
    return out


def up_and_synced(n, node="node2", if_name="if1", rtt_us=1000):
    n.nbr_events.push(n.neighbor("NEIGHBOR_UP", node, if_name, rtt_us=rtt_us))
    assert wait_for(lambda: n.peer_reader.size() >= 1)
    n.sync_events.push(n.p.T.KvStoreSyncEvent(node, "0"))


def test_link_and_addr_events_feed_spark():
    """Link up; a flap (down, up held back by the 1 s backoff, then up);
    an address added and removed: the same interface databases."""

    def scenario(n):
        T = n.p.T
        dbs = []

        def expect(cond):
            db = n.if_reader.get(timeout=10)
            dbs.append(n.p.ser.dumps(db))
            assert cond(db.interfaces["if1"])

        n.nl_events.push(T.LinkEvent("if1", 1, True))
        expect(lambda i: i.is_up)
        n.nl_events.push(T.LinkEvent("if1", 1, False))
        expect(lambda i: not i.is_up)
        n.nl_events.push(T.LinkEvent("if1", 1, True))
        expect(lambda i: not i.is_up)
        expect(lambda i: i.is_up)
        n.nl_events.push(T.AddrEvent("if1", "fc00::1/128", True))
        expect(lambda i: i.networks == ["fc00::1/128"])
        n.nl_events.push(T.AddrEvent("if1", "fc00::1/128", False))
        expect(lambda i: i.networks == [])
        return dbs

    assert len(in_both(scenario)) == 6


def test_neighbor_up_gated_on_sync_then_down():
    def scenario(n):
        n.nbr_events.push(n.neighbor("NEIGHBOR_UP", "node2"))
        peers = [n.p.ser.dumps(n.peer_reader.get(timeout=10))]
        time.sleep(0.2)
        gated = n.adj_db() is None
        steps = adj_steps(
            n,
            (lambda: n.sync_events.push(n.p.T.KvStoreSyncEvent("node2", "0")),
             lambda db: [a.other_node_name for a in db.adjacencies] == ["node2"]),
            (lambda: n.nbr_events.push(n.neighbor("NEIGHBOR_DOWN", "node2")),
             lambda db: not db.adjacencies),
        )
        peers.append(n.p.ser.dumps(n.peer_reader.get(timeout=10)))
        return {"gated": gated, "peers": peers, "steps": steps}

    rec = in_both(scenario)
    assert rec["gated"] is True


def test_drain_and_metric_overrides():
    def scenario(n):
        up_and_synced(n)
        lm = n.lm
        adj0 = lambda db: db.adjacencies[0]  # noqa: E731
        steps = adj_steps(
            n,
            (lambda: None, lambda db: len(db.adjacencies) == 1),
            (lambda: lm.set_node_overload(True), lambda db: db.is_overloaded),
            (lambda: lm.set_link_overload("if1", True), lambda db: adj0(db).is_overloaded),
            (lambda: lm.set_link_metric("if1", 42), lambda db: adj0(db).metric == 42),
            (lambda: lm.set_adj_metric("if1", "node2", 77), lambda db: adj0(db).metric == 77),
            (lambda: lm.set_node_metric_increment(5), lambda db: db.node_metric_increment_val == 5),
            (lambda: lm.set_node_label(9), lambda db: db.node_label == 9),
            (lambda: (lm.set_adj_metric("if1", "node2", None), lm.set_link_metric("if1", None),
                      lm.set_link_overload("if1", False), lm.set_node_overload(False)),
             lambda db: adj0(db).metric == 1 and not db.is_overloaded
             and not adj0(db).is_overloaded),
        )
        state = lm.get_state()
        return {"steps": steps, "state": (
            state.is_overloaded, sorted(state.overloaded_links),
            state.node_label, state.node_metric_increment_val)}

    rec = in_both(scenario)
    assert rec["state"] == (False, [], 9, 5)


def test_parallel_links_rtt_metric_and_restart():
    """Two links to node2 are two adjacencies; RTT-derived metrics follow
    NEIGHBOR_RTT_CHANGE; the peer goes only with the last link."""

    def scenario(n):
        up_and_synced(n, rtt_us=2500)
        steps = adj_steps(
            n,
            (lambda: None, lambda db: len(db.adjacencies) == 1 and db.adjacencies[0].metric == 25),
            (lambda: n.nbr_events.push(n.neighbor("NEIGHBOR_UP", "node2", "if2", rtt_us=4000)),
             lambda db: len(db.adjacencies) == 2),
            (lambda: n.nbr_events.push(n.neighbor("NEIGHBOR_RTT_CHANGE", "node2", "if1", rtt_us=10_000)),
             lambda db: db.adjacencies[0].metric == 100),
            (lambda: (n.nbr_events.push(n.neighbor("NEIGHBOR_RESTARTING", "node2", "if2")),
                      n.nbr_events.push(n.neighbor("NEIGHBOR_RESTARTED", "node2", "if2", rtt_us=5000))),
             lambda db: len(db.adjacencies) == 2),
            (lambda: n.nbr_events.push(n.neighbor("NEIGHBOR_DOWN", "node2", "if1")),
             lambda db: [a.if_name for a in db.adjacencies] == ["if2"]),
            (lambda: n.nbr_events.push(n.neighbor("NEIGHBOR_DOWN", "node2", "if2")),
             lambda db: not db.adjacencies),
        )
        assert wait_for(lambda: n.peer_reader.size() >= 3)
        return {"steps": steps, "peers": n.take(n.peer_reader)}

    rec = in_both(scenario, lm_kwargs={"enable_rtt_metric": True, "node_label": 101})
    # a peer add per link, one delete with the last
    assert len(rec["peers"]) == 3


def test_persisted_state_and_redistribution():
    """The drain state goes to the config store and a second LinkMonitor
    starts drained from it; addresses on a redistributed interface become
    PrefixManager requests, advertised as prefix keys and withdrawn."""
    saved = {}

    def scenario(n):
        T = n.p.T
        up_and_synced(n)
        n.lm.set_node_overload(True)
        n.lm.set_link_metric("if1", 33)
        blob = n.lm.config_store.data[n.p.lm_mod.CONFIG_KEY]
        again = n.p.LinkMonitor(
            "node1", interface_updates_queue=n.p.ReplicateQueue(),
            peer_updates_queue=n.p.ReplicateQueue(),
            neighbor_updates=n.p.ReplicateQueue().get_reader(),
            config_store=DictStore({n.p.lm_mod.CONFIG_KEY: blob}),
        )
        restored = (again.state.is_overloaded, dict(again.state.link_metric_overrides))
        n.nl_events.push(T.LinkEvent("lo0", 1, True))
        n.nl_events.push(T.AddrEvent("lo0", "fc00:1::1/128", True))
        assert wait_for(lambda: any(k.startswith("0/prefix:") for k in n.keys()))
        with_prefix = n.keys()
        n.nl_events.push(T.AddrEvent("lo0", "fc00:1::1/128", False))
        assert wait_for(lambda: n.withdrawn("0", "prefix:[node1]:[0]:[fc00:1::1/128]"))
        saved[n.p.name] = blob
        return {"restored": restored, "with_prefix": with_prefix,
                "withdrawn": n.keys(), "requests": n.take(n.prefix_reader)}

    rec = in_both(
        scenario,
        lm_kwargs=lambda p: {"config_store": DictStore(), "redistribute_if_regexes": ("lo.*",)},
    )
    assert saved["port"] == saved["ref"]
    assert rec["restored"] == (True, {"if1": 33})


def test_prefix_manager_advertise_withdraw_and_types():
    """tests/test_prefix_manager_allocators.py's cases: advertise and
    withdraw (a tombstone), the best type wins one key, sync by type,
    and a queued request, with the same key bytes after each."""
    pfx = "::1:0/112"

    def scenario(n):
        T, pm = n.p.T, n.pm
        out = []
        pm.advertise_prefixes(T.PrefixType.LOOPBACK, [T.PrefixEntry(prefix=pfx)])
        out.append(n.keys())
        pm.advertise_prefixes(T.PrefixType.BGP, [T.PrefixEntry(prefix=pfx, type=T.PrefixType.BGP)])
        out.append(n.keys())
        pm.withdraw_prefixes(T.PrefixType.BGP, [pfx])
        out.append(n.keys())
        pm.withdraw_prefixes(T.PrefixType.LOOPBACK, [pfx])
        out.append(n.keys())
        pm.advertise_prefixes(
            T.PrefixType.CONFIG, [T.PrefixEntry(prefix="::1:0/112"), T.PrefixEntry(prefix="::2:0/112")]
        )
        pm.sync_prefixes_by_type(
            T.PrefixType.CONFIG, [T.PrefixEntry(prefix="::2:0/112"), T.PrefixEntry(prefix="::3:0/112")]
        )
        out.append(n.keys())
        n.prefix_updates.push(T.PrefixUpdateRequest(
            prefixes_to_add=[T.PrefixEntry(prefix="fc00:9::/64")], type=T.PrefixType.LOOPBACK))
        assert wait_for(lambda: any("fc00:9::/64" in k for k in n.keys()))
        pm.withdraw_prefixes_by_type(T.PrefixType.CONFIG)
        out.append(n.keys())
        return {"keys": out, "prefixes": sorted(e.prefix for e in pm.get_prefixes())}

    rec = in_both(scenario)
    assert rec["prefixes"] == ["fc00:9::/64"]


def test_prefix_manager_redistribution_and_aggregation():
    """A route learned in area a is redistributed into b but not back
    into a or into c (already in its area stack); an originated
    aggregate is advertised at two supporting routes and withdrawn at
    one."""

    def scenario(n):
        rib, T = n.p.rib, n.p.T
        nh = frozenset({T.NextHop(address="fe80::1")})

        def push(*prefixes, delete=(), best=None):
            u = rib.DecisionRouteUpdate()
            for p in prefixes:
                u.add_route_to_update(rib.RibUnicastEntry(
                    prefix=p, nexthops=nh, best_prefix_entry=best and best(p), best_area="a"))
            u.unicast_routes_to_delete.extend(delete)
            n.route_updates.push(u)

        push("fd00::/64", best=lambda p: T.PrefixEntry(prefix=p, area_stack=("c",)))
        assert wait_for(lambda: "b/prefix:[node1]:[b]:[fd00::/64]" in n.keys())
        redistributed = n.keys()
        push("fc00:1::/32")
        assert wait_for(lambda: n.pm.get_originated_prefixes()["fc00::/16"] == (1, False))
        push("fc00:2::/32")
        assert wait_for(lambda: n.pm.get_originated_prefixes()["fc00::/16"] == (2, True))
        aggregated = n.keys()
        push(delete=["fc00:2::/32", "fd00::/64"])
        assert wait_for(lambda: n.pm.get_originated_prefixes()["fc00::/16"] == (1, False))
        assert wait_for(lambda: n.withdrawn("b", "prefix:[node1]:[b]:[fd00::/64]"))
        return {"redistributed": redistributed, "aggregated": aggregated, "after": n.keys()}

    rec = in_both(
        scenario,
        areas=("a", "b", "c"),
        pm_kwargs=lambda p: {"originated_prefixes": [
            p.OriginatedPrefixConfig(prefix="fc00::/16", minimum_supporting_routes=2)]},
    )
    keys = rec["redistributed"]
    assert not any("fd00::/64" in k for k in keys if k[0] in "ac")
